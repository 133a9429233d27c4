// K1's bf16 mainloop on the Hopper tensor cores (wgmma), for Cin and Cout
// multiples of 8; the design is in fused_conv.cu.

#include "fused_conv.cuh"
#include "wgmma.cuh"

namespace ggan {
namespace k1 {
namespace {

template <int BM, int BN>
constexpr int wgmma_smem_bytes() {
  // the stages, 1024 bytes to align them, the row table
  return WG_STAGES * (BM * WG_BK * 2 + WG_BK * BN * 2) + 1024 + BM * 16;
}

template <int BM, int BN>
__global__ void __launch_bounds__(2 * BM)
conv_k1_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     const __nv_bfloat16* __restrict__ bias,
                     __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
                     Conv s, int act, float leak, int per) {
  constexpr int THREADS = 2 * BM;       // BM / 64 warpgroups
  constexpr int A_BYTES = BM * WG_BK * 2;
  constexpr int ATOM = WG_BK * 128;     // one 64-column swizzled W atom
  static_assert(WG_BK == 64, "wgmma_step takes 64 columns a step");
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
    wgmma_step<BN>(acc, a_tile, b_tile, wg);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // refill the buffer of step kt-1: every warpgroup finished its products
    // before this step's barrier; the copies overlap this step's products
    const int next = kt + WG_STAGES - 1;
    if (next < kr.steps) load(next % WG_STAGES);
    cp_async_commit();
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc<NACC>(acc);
  }

  store_tile<BN>(acc, y, ws, bias, s, act, leak, m0 + wg * 64, n0, tid % 128);
}

template <int BM, int BN>
cudaError_t launch_wgmma(const Args& a) {
  using T = __nv_bfloat16;
  constexpr int bytes = wgmma_smem_bytes<BM, BN>();
  const cudaError_t e = allow_smem(conv_k1_wgmma_kernel<BM, BN>, bytes);
  if (e != cudaSuccess) return e;
  conv_k1_wgmma_kernel<BM, BN><<<a.grid, 2 * BM, bytes, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w),
      static_cast<const T*>(a.bias), static_cast<T*>(a.y), a.ws, a.s, a.act, a.leak,
      a.per);
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
