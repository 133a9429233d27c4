// K1's bf16 mainloop on the Hopper tensor cores (wgmma), for Cin and Cout
// multiples of 8; the design is in fused_conv.cu.

#include "fused_conv.cuh"

namespace ggan {
namespace k1 {
namespace {

template <int BM, int BN>
constexpr int wgmma_smem_bytes() {
  // the stages, 1024 bytes to align them, the row table
  return WG_STAGES * (BM * WG_BK * 2 + WG_BK * BN * 2) + 1024 + BM * 16;
}

// A shared-memory matrix descriptor with the 128-byte swizzle (layout type
// 1): start address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}

// d[64 x BN] += A[64 x 16] (K-major) * B[16 x BN] (MN-major, transpose bit
// set), f32 accumulate; generated operand lists, one per BN.
__device__ __forceinline__ void wgmma_m64n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_k16(float* d, uint64_t da, uint64_t db) {
  if constexpr (BN == 64) {
    wgmma_m64n64(d, da, db);
  } else {
    wgmma_m64n128(d, da, db);
  }
}

// Pins the accumulators after a wait: the compiler may not move their reads
// above it (the asm statements name them).
template <int N>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int BM, int BN>
__global__ void __launch_bounds__(2 * BM)
conv_k1_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     const __nv_bfloat16* __restrict__ bias,
                     __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
                     Conv s, int act, int per) {
  constexpr int THREADS = 2 * BM;       // BM / 64 warpgroups
  constexpr int A_BYTES = BM * WG_BK * 2;
  constexpr int ATOM = WG_BK * 128;     // one 64-column swizzled W atom
  constexpr int STAGE = A_BYTES + WG_BK * BN * 2;
  constexpr int NACC = BN / 2;          // f32 accumulators per thread
  constexpr int W_CH = BN / 8;          // 16-byte chunks per W row
  constexpr int W_PASS = THREADS / W_CH;
  static_assert(THREADS % W_CH == 0 && WG_BK % W_PASS == 0, "W tile passes");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  // the swizzle pattern repeats every 1024 bytes: tiles start on one
  const uint32_t tiles = (raw + 1023u) & ~1023u;
  RowInfo* rows =
      reinterpret_cast<RowInfo*>(smem_raw + (tiles - raw) + WG_STAGES * STAGE);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  fill_rows(rows, s, m0, BM);
  __syncthreads();
  const KRange kr = k_range(s, WG_BK, per);

  // A: chunk column a_c (8 channels of one tap), rows a_row + i*BM/4.
  // W: chunk column w_j (8 output channels), reduction rows w_row + i*W_PASS.
  // Each call loads the next K step of the block's range.
  const int a_c = tid % 8;
  const int a_row = tid / 8;
  const int w_j = tid % W_CH;
  const int w_row = tid / W_CH;
  RowInfo ri[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) ri[i] = rows[a_row + i * (BM / 4)];
  TapWalk walk;
  walk.init(s, kr.step0 * WG_BK + a_c * 8);
  int wr = kr.step0 * WG_BK + w_row;  // W row of pass 0
  const bool wn = n0 + w_j * 8 < s.Cout;
  const __nv_bfloat16* wp = w + int64_t(wr) * s.Cout + n0 + w_j * 8;
  auto load = [&](int buf) {
    const uint32_t a_tile = tiles + buf * STAGE;
    const uint32_t b_tile = a_tile + A_BYTES;
    const int toff = walk.toff(s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = a_row + i * (BM / 4);
      const int off = x_offset(s, ri[i], walk, toff, kr.kend);
      // row `row`, chunk a_c lands at chunk a_c ^ (row % 8): the swizzle
      cp_async16(a_tile + row * 128 + ((a_c ^ (row & 7)) << 4),
                 x + (off < 0 ? 0 : off), off >= 0);
    }
#pragma unroll
    for (int i = 0; i < WG_BK / W_PASS; ++i) {
      const int row = w_row + i * W_PASS;
      const bool ok = wn && wr + i * W_PASS < kr.kend;
      cp_async16(b_tile + (w_j >> 3) * ATOM + row * 128 +
                     (((w_j & 7) ^ (row & 7)) << 4),
                 ok ? wp + int64_t(i) * W_PASS * s.Cout : w, ok);
    }
    walk.advance(s, WG_BK);
    wr += WG_BK;
    wp += int64_t(WG_BK) * s.Cout;
  };

  const int wg = tid / 128;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;

#pragma unroll
  for (int st = 0; st < WG_STAGES - 1; ++st) {
    if (st < kr.steps) load(st);
    cp_async_commit();
  }
  for (int kt = 0; kt < kr.steps; ++kt) {
    cp_async_wait<WG_STAGES - 2>();
    // this thread's copies of step kt are done; make them visible to the
    // async proxy that wgmma reads through, then to the other threads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t a_tile = tiles + (kt % WG_STAGES) * STAGE;
    const uint32_t b_tile = a_tile + A_BYTES;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      // A: this warpgroup's 64 rows, K columns 16*kk..: 32 bytes along the
      // swizzled row; 8-row groups 1024 bytes apart (SBO)
      const uint64_t da = smem_desc(a_tile + wg * 64 * 128 + kk * 32, 16, 1024);
      // B: K rows 16*kk..: 16 rows of 128 bytes; 8-row groups 1024 bytes
      // apart (SBO), 64-column atoms ATOM bytes apart (LBO)
      const uint64_t db = smem_desc(b_tile + kk * 16 * 128, ATOM, 1024);
      wgmma_k16<BN>(acc, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // refill the buffer of step kt-1: every warpgroup finished its products
    // before this step's barrier; the copies overlap this step's products
    const int next = kt + WG_STAGES - 1;
    if (next < kr.steps) load(next % WG_STAGES);
    cp_async_commit();
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc<NACC>(acc);
  }

  // accumulator layout of m64nBN: thread (warp, lane) holds rows
  // 16*warp + lane/4 (+8), columns 8*j + 2*(lane%4) (+1)
  const bool split = gridDim.z > 1;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int row0 = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * (lane % 4);
    if (n >= s.Cout) continue;
    const float b0 = split ? 0.0f : to_f32(bias[n]);
    const float b1 = split ? 0.0f : to_f32(bias[n + 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row0 + 8 * h;
      if (m >= s.M) continue;
      const float v0 = acc[4 * j + 2 * h];
      const float v1 = acc[4 * j + 2 * h + 1];
      if (split) {
        *reinterpret_cast<float2*>(ws + (int64_t(blockIdx.z) * s.M + m) * s.Cout + n) =
            make_float2(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(y + int64_t(m) * s.Cout + n) =
            __floats2bfloat162_rn(apply_act(v0 + b0, act), apply_act(v1 + b1, act));
      }
    }
  }
}

template <int BM, int BN>
cudaError_t launch_wgmma(const Args& a) {
  using T = __nv_bfloat16;
  constexpr int bytes = wgmma_smem_bytes<BM, BN>();
  const cudaError_t e = allow_smem(conv_k1_wgmma_kernel<BM, BN>, bytes);
  if (e != cudaSuccess) return e;
  conv_k1_wgmma_kernel<BM, BN><<<a.grid, 2 * BM, bytes, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w),
      static_cast<const T*>(a.bias), static_cast<T*>(a.y), a.ws, a.s, a.act, a.per);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_wgmma_tile(const Args& a, int bm, int bn) {
  if (bm == 64 && bn == 64) return launch_wgmma<64, 64>(a);
  if (bm == 64 && bn == 128) return launch_wgmma<64, 128>(a);
  if (bm == 128 && bn == 64) return launch_wgmma<128, 64>(a);
  if (bm == 128 && bn == 128) return launch_wgmma<128, 128>(a);
  return cudaErrorInvalidValue;
}

}  // namespace k1
}  // namespace ggan
