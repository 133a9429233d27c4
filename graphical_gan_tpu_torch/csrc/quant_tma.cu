// Q2's wgmma route: the int8 implicit-GEMM convolution of quant.cu's note
// (ggan_int8_conv_tma), for Cin % 32 == 0. Its design is in that note; in
// short:
//   A  a 4-D im2col tensor map over x [B, H, W, Cin] uint8: bk channels a
//      pixel (bk = 128, 64 or 32, the largest dividing Cin), BM pixels a
//      column, one tap (kw, kh) a load, the swizzle of a bk-byte row; a dense
//      layer (a 1x1 conv over [M, 1, 1, K]) takes a tiled map over [M, K]
//      instead. TMA zero-fills padding taps and rows past M.
//   W  a tiled map over the K-major filter [n_rows, R]: box (bk, BN), the
//      same swizzle, so both operands sit K-major in shared memory, as
//      8-bit wgmma reads them (it has no transpose for 8-bit types).
//   A ring of `stages` stages, each with a full and an empty mbarrier; one
//   thread arms a stage with its bytes and issues its two loads; the
//   warpgroups (BM / 64 of them) issue wgmma.mma_async m64nBNk32 s32.s8.s8,
//   bk / 32 of them a step, keep one step's group in flight
//   (wait_group 1) and release a stage once its products are done.
//   Split K (gridDim.z > 1): each split adds its int32 sums into the
//   workspace ws [M, Cout] with atomics (exact in any order), then counts
//   itself in the tile's counter (ws + M * Cout); the last split reads the
//   sums back and alone runs the epilogue.
//   Epilogue: each thread loads its columns' factor and bias once, makes
//   its outputs (quant.cuh: q2_value), writes them into a shared tile
//   (padded rows: no bank conflicts), and the block copies the tile out in
//   16-byte stores where the row allows, else 8, 4 or 2.

#include <cuda.h>

#include "quant.cuh"
#include "tma.cuh"

namespace ggan {
namespace q2 {
namespace {

constexpr int MAX_STAGES = 4;
constexpr int BAR_BYTES = 128;  // the barriers, ahead of the 1024-aligned tiles

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A K-major shared-memory matrix descriptor: rows of `swz` bytes (the
// swizzle's width: 128, 64 or 32; layout types 1, 2, 3), 8-row groups
// 8 * swz bytes apart (SBO); the leading offset is unused for swizzled
// K-major operands (16 bytes).
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr, int swz) {
  const uint64_t layout = swz == 128 ? 1 : (swz == 64 ? 2 : 3);
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t((8 * swz) >> 4) << 32) | (layout << 62);
}

// d[64 x N] += A[64 x 32] * B[32 x N], both K-major, int8 -> int32;
// generated operand lists, one per N.
__device__ __forceinline__ void wgmma_s8_n16(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n32(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n64(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n128(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db) {
  if constexpr (BN == 16) {
    wgmma_s8_n16(d, da, db);
  } else if constexpr (BN == 32) {
    wgmma_s8_n32(d, da, db);
  } else if constexpr (BN == 64) {
    wgmma_s8_n64(d, da, db);
  } else {
    wgmma_s8_n128(d, da, db);
  }
}

// Pins the accumulators after a wait: the compiler may not move their reads
// above it.
template <int N>
__device__ __forceinline__ void fence_acc(int* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Bytes of one row of the staged output tile: the row padded so that a
// warp's stores of 8 rows hit distinct banks.
__host__ __device__ __forceinline__ int out_pitch(int bn, int out) {
  return out == kOutBF16 ? bn * 2 + 16 : bn * 4 + 32;
}

__host__ __device__ __forceinline__ int smem_bytes(int bm, int bn, int bk, int stages,
                                                   int out) {
  const int ring = stages * (bm + bn) * bk;
  const int staging = bm * out_pitch(bn, out);
  return BAR_BYTES + 1024 + (ring > staging ? ring : staging);
}

// Two blocks an SM (at most 128 registers a thread at BM 128): one block's
// epilogue then runs under the other's mainloop. At BM 128 x BN 128 that
// costs a few spills in the epilogue and still ran Generator.3 at B 256
// faster than one block an SM at 158 registers, on the H100.
template <int BM, int BN>
__global__ void __launch_bounds__(2 * BM, 2)
    int8_conv_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap, void* __restrict__ y,
                         int* __restrict__ ws, QConv g, QEpi e, int dense, int bk,
                         int stages, int per) {
  constexpr int THREADS = 2 * BM;  // BM / 64 warpgroups
  constexpr int NACC = BN / 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ int last_split;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t full = raw;
  const uint32_t empty = raw + 8 * MAX_STAGES;
  // the swizzles repeat every 8 rows (at most 1024 bytes): tiles start on one
  const uint32_t tiles = (raw + BAR_BYTES + 1023u) & ~1023u;
  uint8_t* const tile_ptr = smem_raw + (tiles - raw);
  const int a_bytes = BM * bk;
  const int stage_bytes = (BM + BN) * bk;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int csteps = g.Cin / bk;
  const int nk = g.KH * g.KW * csteps;
  const int step0 = blockIdx.z * per;
  const int steps = min(nk, step0 + per) - step0;

  if (tid == 0) {
    prefetch_tensormap(&xmap);
    prefetch_tensormap(&wmap);
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, THREADS);
    }
    // the barriers' initialisation visible to the TMA unit
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the tile's first output pixel as its window's input coordinate
  int wx = 0, hx = 0, bx = 0;
  if (!dense) {
    const int t0 = m0 / g.OW;
    wx = (m0 - t0 * g.OW) * g.stride - g.pad_w;
    hx = (t0 % g.OH) * g.stride - g.pad_h;
    bx = t0 / g.OH;
  }
  // step s: tap s / csteps (kh, kw), channel block s % csteps; W's columns
  // from tap * Cin + block * bk (HWIO order)
  auto issue = [&](int stage, int step) {
    const int tap = step / csteps;
    const int cb = step - tap * csteps;
    const int kh = tap / g.KW;
    const int kw = tap - kh * g.KW;
    const uint32_t a_tile = tiles + stage * stage_bytes;
    const uint32_t bar = full + 8 * stage;
    mbar_arrive_tx(bar, stage_bytes);
    if (dense)
      tma_tile2d(a_tile, &xmap, bar, cb * bk, m0);
    else
      tma_im2col(a_tile, &xmap, bar, cb * bk, wx, hx, bx, static_cast<uint16_t>(kw),
                 static_cast<uint16_t>(kh));
    tma_tile2d(a_tile + a_bytes, &wmap, bar, tap * g.Cin + cb * bk, n0);
  };
  if (tid == 0)
    for (int st = 0; st < stages && st < steps; ++st) issue(st, step0 + st);

  const int wg = tid / 128;
  int acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0;
  const int ksub = bk / 32;

  for (int kt = 0; kt < steps; ++kt) {
    const int stage = kt % stages;
    mbar_wait(full + 8 * stage, (kt / stages) & 1);
    __syncwarp();  // the wgmma below are warp-aligned: converge after the spin
    const uint32_t a_tile = tiles + stage * stage_bytes + wg * 64 * bk;
    const uint32_t b_tile = tiles + stage * stage_bytes + a_bytes;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int kk = 0; kk < ksub; ++kk)
      wgmma_s8<BN>(acc, desc_kmajor(a_tile + kk * 32, bk), desc_kmajor(b_tile + kk * 32, bk));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // step kt-1's products are done once at most this step's group is in
    // flight: release its stage, and refill it with step kt-1+stages
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (kt > 0) {
      const int prev = kt - 1;
      mbar_arrive(empty + 8 * (prev % stages));
      if (tid == 0 && prev + stages < steps) {
        mbar_wait(empty + 8 * (prev % stages), (prev / stages) & 1);
        issue(prev % stages, step0 + prev + stages);
      }
      __syncwarp();
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc<NACC>(acc);

  // accumulator layout of m64nBN: thread (warp, lane) of warpgroup wg holds
  // rows wg*64 + 16*warp + lane/4 (+8), columns 8*j + 2*(lane%4) (+1):
  // acc[4*j + 2*h + c]
  const int t = tid % 128;
  const int lane = t % 32;
  const int r_loc = wg * 64 + (t / 32) * 16 + lane / 4;
  const int c_loc = 2 * (lane % 4);

  if (gridDim.z > 1) {
    int* const counters = ws + static_cast<long long>(g.M) * g.Cout;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int row = m0 + r_loc + 8 * h;
          const int col = n0 + 8 * j + c_loc + c;
          if (row < g.M && col < g.Cout)
            atomicAdd(ws + static_cast<long long>(row) * g.Cout + col, acc[4 * j + 2 * h + c]);
        }
    __threadfence();
    __syncthreads();
    if (tid == 0)
      last_split = atomicAdd(counters + blockIdx.y * gridDim.x + blockIdx.x, 1) ==
                   static_cast<int>(gridDim.z) - 1;
    __syncthreads();
    if (!last_split) return;
    __threadfence();
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int row = m0 + r_loc + 8 * h;
          const int col = n0 + 8 * j + c_loc + c;
          if (row < g.M && col < g.Cout)
            acc[4 * j + 2 * h + c] = __ldcg(ws + static_cast<long long>(row) * g.Cout + col);
        }
  }

  // the ring becomes the output tile once every warpgroup is done with it
  __syncthreads();
  const int pitch = out_pitch(BN, e.out);
  const int esize = e.out == kOutBF16 ? 2 : 4;
  const bool has_bias = e.bias != nullptr;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int cl = 8 * j + c_loc;
    const int col = n0 + cl;
    if (col >= g.Cout) continue;
    const bool second = col + 1 < g.Cout;
    float f0 = 0.0f, f1 = 0.0f, b0 = 0.0f, b1 = 0.0f;
    if (e.out != kOutInt32) {
      f0 = e.factor[col];
      f1 = second ? e.factor[col + 1] : 0.0f;
      if (has_bias) {
        b0 = q2_bias(e, col);
        b1 = second ? q2_bias(e, col + 1) : 0.0f;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int a0 = acc[4 * j + 2 * h];
      const int a1 = acc[4 * j + 2 * h + 1];
      uint8_t* p = tile_ptr + (r_loc + 8 * h) * pitch + cl * esize;
      if (e.out == kOutInt32) {
        *reinterpret_cast<int2*>(p) = make_int2(a0, a1);
      } else {
        const float v0 = q2_value(a0, f0, b0, has_bias, e.out, e.act, e.leak);
        const float v1 = q2_value(a1, f1, b1, has_bias, e.out, e.act, e.leak);
        if (e.out == kOutF32)
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  __syncthreads();

  // copy the tile's valid rows and columns out, in the widest chunk that
  // divides the row's bytes, the output's row stride and the tile's offset
  const int rows = min(BM, g.M - m0);
  const int rb = min(BN, g.Cout - n0) * esize;
  const int gstride = g.Cout * esize;
  int chunk = 16;
  while (chunk > esize && ((rb | gstride | (n0 * esize)) & (chunk - 1))) chunk >>= 1;
  const int per_row = rb / chunk;
  uint8_t* const ybase =
      static_cast<uint8_t*>(y) + (static_cast<long long>(m0) * g.Cout + n0) * esize;
  for (int i = tid; i < rows * per_row; i += THREADS) {
    const int r = i / per_row;
    const int o = (i - r * per_row) * chunk;
    const uint8_t* src = tile_ptr + r * pitch + o;
    uint8_t* dst = ybase + static_cast<long long>(r) * gstride + o;
    if (chunk == 16)
      *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
    else if (chunk == 8)
      *reinterpret_cast<int2*>(dst) = *reinterpret_cast<const int2*>(src);
    else if (chunk == 4)
      *reinterpret_cast<int*>(dst) = *reinterpret_cast<const int*>(src);
    else
      *reinterpret_cast<short*>(dst) = *reinterpret_cast<const short*>(src);
  }
}

template <int BM, int BN>
cudaError_t launch(const CUtensorMap& xm, const CUtensorMap& wm, void* y, int* ws,
                   const QConv& g, const QEpi& e, int dense, int bk, int stages, int splits,
                   int per, cudaStream_t st) {
  const int bytes = smem_bytes(BM, BN, bk, stages, e.out);
  const cudaError_t err = cudaFuncSetAttribute(
      int8_conv_tma_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.M + BM - 1) / BM, (g.Cout + BN - 1) / BN, splits);
  int8_conv_tma_kernel<BM, BN><<<grid, 2 * BM, bytes, st>>>(xm, wm, y, ws, g, e, dense, bk,
                                                            stages, per);
  return cudaGetLastError();
}

cudaError_t launch_tile(const CUtensorMap& xm, const CUtensorMap& wm, void* y, int* ws,
                        const QConv& g, const QEpi& e, int dense, int bm, int bn, int bk,
                        int stages, int splits, int per, cudaStream_t st) {
#define GGAN_Q2_TILE(M_, N_)                                                          \
  if (bm == M_ && bn == N_)                                                           \
    return launch<M_, N_>(xm, wm, y, ws, g, e, dense, bk, stages, splits, per, st);
  GGAN_Q2_TILE(64, 16)
  GGAN_Q2_TILE(64, 32)
  GGAN_Q2_TILE(64, 64)
  GGAN_Q2_TILE(64, 128)
  GGAN_Q2_TILE(128, 16)
  GGAN_Q2_TILE(128, 32)
  GGAN_Q2_TILE(128, 64)
  GGAN_Q2_TILE(128, 128)
#undef GGAN_Q2_TILE
  return cudaErrorInvalidValue;
}

CUtensorMapSwizzle swizzle_of(int bk) {
  return bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                   : (bk == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
}

}  // namespace
}  // namespace q2
}  // namespace ggan

// Q2 on the wgmma route (ops/kernels/quant.py: q2_plan's "tma"). x [B, H,
// W, Cin] int8 contiguous (a dense layer: [M, 1, 1, K] with dense = 1); wk
// the K-major filter [n_rows][R], R = KH*KW*Cin; factor, bias, y, out, act
// and leak as ggan_int8_conv's; pads (pad_h, pad_h_hi), (pad_w, pad_w_hi).
// The plan's tile bm x bn, bk channels a step (Cin % bk == 0), `stages`
// ring stages and `splits` K ranges of `per` steps; with splits > 1, ws is
// an int32 workspace of M * Cout sums and one counter per output tile, all
// zero. Returns cudaGetLastError() after the launch,
// cudaErrorInvalidValue for arguments it has no kernel for, or one of
// tma.cuh's codes.
extern "C" int ggan_int8_conv_tma(const void* x, const void* wk, const void* factor,
                                  const void* bias, void* y, void* ws, int out, int act,
                                  float leak, int B, int H, int W, int Cin, int KH, int KW,
                                  int Cout, int n_rows, int OH, int OW, int stride, int pad_h,
                                  int pad_h_hi, int pad_w, int pad_w_hi, int dense, int bm,
                                  int bn, int bk, int stages, int splits, int per,
                                  void* stream) {
  using namespace ggan;
  const int R = KH * KW * Cin;
  const int nk = KH * KW * (bk > 0 ? Cin / bk : 0);
  if ((bk != 32 && bk != 64 && bk != 128) || Cin % bk != 0 || n_rows < Cout ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(wk) % 16 != 0 ||
      stages < 1 || stages > q2::MAX_STAGES || splits < 1 || per < 1 ||
      int64_t(splits) * per < nk || int64_t(splits - 1) * per >= nk ||
      (splits > 1 && ws == nullptr) || out < kOutF32 || out > kOutInt32 ||
      (out == kOutInt32 && (bias != nullptr || act != kActNone)) ||
      (dense && (KH != 1 || KW != 1 || H != 1 || W != 1 || stride != 1)))
    return static_cast<int>(cudaErrorInvalidValue);

  EncodeIm2col encode_im2col;
  EncodeTiled encode_tiled;
  if (!tensor_map_encoders(&encode_im2col, &encode_tiled)) return kNoEncoder;
  const CUtensorMapSwizzle swz = q2::swizzle_of(bk);
  const int M = B * OH * OW;
  CUtensorMap xm, wm;
  CUresult r;
  if (dense) {
    const cuuint64_t dims[2] = {cuuint64_t(Cin), cuuint64_t(M)};
    const cuuint64_t strides[1] = {cuuint64_t(Cin)};
    const cuuint32_t box[2] = {cuuint32_t(bk), cuuint32_t(bm)};
    const cuuint32_t elem[2] = {1, 1};
    r = encode_tiled(&xm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(x), dims,
                     strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const cuuint64_t dims[4] = {cuuint64_t(Cin), cuuint64_t(W), cuuint64_t(H), cuuint64_t(B)};
    const cuuint64_t strides[3] = {cuuint64_t(Cin), cuuint64_t(W) * Cin,
                                   cuuint64_t(H) * W * Cin};
    const int lower[2] = {-pad_w, -pad_h};
    const int upper[2] = {pad_w_hi - (KW - 1), pad_h_hi - (KH - 1)};
    const cuuint32_t elem[4] = {1, cuuint32_t(stride), cuuint32_t(stride), 1};
    r = encode_im2col(&xm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), dims,
                      strides, lower, upper, cuuint32_t(bk), cuuint32_t(bm), elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  if (r != CUDA_SUCCESS) return kEncodeX + static_cast<int>(r);
  {
    const cuuint64_t dims[2] = {cuuint64_t(R), cuuint64_t(n_rows)};
    const cuuint64_t strides[1] = {cuuint64_t(R)};
    const cuuint32_t box[2] = {cuuint32_t(bk), cuuint32_t(bn)};
    const cuuint32_t elem[2] = {1, 1};
    r = encode_tiled(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(wk), dims,
                     strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  if (r != CUDA_SUCCESS) return kEncodeW + static_cast<int>(r);

  const QConv g{B, H, W, Cin, KH, KW, Cout, OH, OW, stride, pad_h, pad_w, M, R, n_rows};
  const QEpi e{static_cast<const float*>(factor), bias, out, act, leak};
  return static_cast<int>(q2::launch_tile(xm, wm, y, static_cast<int*>(ws), g, e, dense, bm,
                                          bn, bk, stages, splits, per,
                                          static_cast<cudaStream_t>(stream)));
}
