// K3a: conv_gemm's "taps" variant -- a SAME k x k conv at stride s, + bias,
// + where(y >= 0, y, leak*y) when leak is set, over NHWC x and HWIO w; f32
// accumulation, bias in f32, one rounding to bf16. This file is its bf16
// mainloop for Cin % 8 == 0 and Cout % 8 == 0; every other shape, and K3b
// ("im2col") always, runs K1's mainloops (fused_conv*.cu) through K1's
// plan(), as ops/kernels/conv_gemm.py routes them.
//
// Replaces graphical_gan_tpu/ops/pallas/conv_gemm.py:conv_gemm, variant
// "taps" (pallas_call at :206, body _kernel :82-98): the K loop runs tap by
// tap, each tap ceil(Cin/64) steps of one tap's run of 64 channels.
//
// Bound on the H100. At the bench shapes (5x5, stride 2, Cin 64 or 128, Cout
// 128 or 256) the function needs 2*Cin*Cout FLOPs per in-bounds tap and
// pixel, about 400 per byte moved, above the bf16 ridge of 989 TFLOP/s /
// 3.35 TB/s = 295: bound by the tensor cores.
//
// Design. K1's wgmma mainloop gathers its A tile with 16-byte cp.async
// copies whose addresses every thread computes per K step (the row table,
// the tap walk, the padding masks); here the Tensor Memory Accelerator
// (TMA) produces the same tiles with no per-thread address arithmetic:
//   A  a 4-D im2col tensor map over x [B, H, W, Cin]: 64 channels (128
//      bytes) per pixel, BM pixels per column, traversal strides
//      {1, s, s, 1}, a bounding box from -pad_lo to pad_hi - (k - 1) on each
//      spatial axis (its corners), 128-byte swizzle. One load names the
//      tile's first output pixel by its window's input coordinate
//      (ow*s - pad_w, oh*s - pad_h, b), the channel block c0, and the tap
//      (kw, kh) as the im2col offsets; the hardware walks BM pixels
//      W -> H -> B, writes the K-major swizzled rows K1's A descriptor reads,
//      and zero-fills padding taps, pixels past the last image (rows past M)
//      and channels past Cin.
//   W  a tiled 3-D map over [k*k, Cin, Cout], box (1, 64, 64), 128-byte
//      swizzle: the 64-column atom K1 reads MN-major, rows past Cin zero, so
//      a tap's channel tail multiplies zeros by zeros.
// The parameters of both maps are a pure function of the shapes
// (conv_gemm.py: tma_geometry), which the wrapper packs and this file
// encodes with cuTensorMapEncodeIm2col / cuTensorMapEncodeTiled.
//
// Ring. 4 stages, each with a full and an empty mbarrier. One elected thread
// (thread 0) arms a stage with its transaction bytes (the whole boxes, zero
// fill included) and issues its A and W loads; every thread waits on the
// stage's full barrier, the warpgroup(s) issue wgmma m64nBNk16 as K1 does,
// wait for them, and arrive on the stage's empty barrier. Thread 0 refills
// the stage of step kt-1 between issuing step kt's products and waiting for
// them (K1 issues its copies there too), once all threads have released it.
// No producer warp: thread 0 also computes.
//
// Tiles and splits: K1's plan() rules over k*k*ceil(Cin/64) steps, chosen
// by the wrapper; split K writes f32 partials to the workspace and K1's
// reduce kernel sums them in split order (no atomics: one input, one set of
// bits). Where Cin % 64 == 0 the steps are K1's flattened steps in the same
// order, so K3a, K3b and K1 under one plan give the same bits.

#include <cuda.h>

#include "fused_conv.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace ggan {
namespace k3 {
namespace {

using k1::Args;
using k1::Conv;

constexpr int BK = 64;      // channels per K step: one 128-byte swizzle row
constexpr int STAGES = 4;   // ring depth: 3 steps of loads in flight
constexpr int ATOM = BK * 128;  // one 64-column W box

template <int BM, int BN>
constexpr int tma_smem_bytes() {
  // the stages, 1024 bytes to align them, the full and empty barriers
  return STAGES * (BM + BN) * 128 + 1024 + 2 * STAGES * 8;
}

template <int BM, int BN>
__global__ void __launch_bounds__(2 * BM)
conv_k3_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const __nv_bfloat16* __restrict__ bias,
                   __nv_bfloat16* __restrict__ y, float* __restrict__ ws, Conv s,
                   int csteps, int act, float leak, int per) {
  constexpr int THREADS = 2 * BM;  // BM / 64 warpgroups
  constexpr int A_BYTES = BM * 128;
  constexpr int STAGE = (BM + BN) * 128;
  constexpr int NACC = BN / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = k1::smem_u32(smem_raw);
  // TMA's 128-byte swizzle and wgmma's repeat every 1024 bytes: tiles start
  // on one
  const uint32_t tiles = (raw + 1023u) & ~1023u;
  const uint32_t full = tiles + STAGES * STAGE;
  const uint32_t empty = full + STAGES * 8;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nk = s.KH * s.KH * csteps;
  const int step0 = blockIdx.z * per;
  const int steps = min(nk, step0 + per) - step0;

  if (tid == 0) {
    prefetch_tensormap(&xmap);
    prefetch_tensormap(&wmap);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, THREADS);
    }
    // the barriers' initialisation visible to the TMA unit
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0's producer state: the tile's first output pixel as its window's
  // input coordinate, and the next step's tap (kh, kw) and channel block cb,
  // walked with adds.
  const int ow0 = m0 % s.OW;
  const int t0 = m0 / s.OW;
  const int wx = ow0 * s.stride - s.pad_w;
  const int hx = (t0 % s.OH) * s.stride - s.pad_h;
  const int bx = t0 / s.OH;
  const int tap0 = step0 / csteps;
  int cb = step0 - tap0 * csteps;
  int kh = tap0 / s.KH;
  int kw = tap0 - kh * s.KH;
  auto issue = [&](int stage) {
    const uint32_t a_tile = tiles + stage * STAGE;
    const uint32_t bar = full + 8 * stage;
    mbar_arrive_tx(bar, STAGE);
    tma_im2col(a_tile, &xmap, bar, cb * BK, wx, hx, bx, static_cast<uint16_t>(kw),
               static_cast<uint16_t>(kh));
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      tma_tile3d(a_tile + A_BYTES + j * ATOM, &wmap, bar, n0 + 64 * j, cb * BK,
                 kh * s.KH + kw);
    if (++cb == csteps) {
      cb = 0;
      if (++kw == s.KH) {
        kw = 0;
        ++kh;
      }
    }
  };

  if (tid == 0)
    for (int st = 0; st < STAGES && st < steps; ++st) issue(st);

  const int wg = tid / 128;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < steps; ++kt) {
    const int stage = kt % STAGES;
    const uint32_t parity = (kt / STAGES) & 1;
    mbar_wait(full + 8 * stage, parity);
    __syncwarp();  // the wgmma below are warp-aligned: converge after the spin
    const uint32_t a_tile = tiles + stage * STAGE;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    k1::wgmma_step<BN>(acc, a_tile, a_tile + A_BYTES, wg);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // while the products run, refill the stage of step kt-1 with step
    // kt-1+STAGES once every thread has released it
    const int prev = kt - 1;
    if (tid == 0 && prev >= 0 && prev + STAGES < steps) {
      mbar_wait(empty + 8 * (prev % STAGES), (prev / STAGES) & 1);
      issue(prev % STAGES);
    }
    __syncwarp();
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    k1::fence_acc<NACC>(acc);
    // this thread's products of the stage are done: release it
    mbar_arrive(empty + 8 * stage);
  }

  k1::store_tile<BN>(acc, y, ws, bias, s, act, leak, m0 + wg * 64, n0, tid % 128);
}

template <int BM, int BN>
cudaError_t launch_tma(const CUtensorMap& xm, const CUtensorMap& wm, const Args& a,
                       int csteps) {
  using T = __nv_bfloat16;
  constexpr int bytes = tma_smem_bytes<BM, BN>();
  const cudaError_t e = k1::allow_smem(conv_k3_tma_kernel<BM, BN>, bytes);
  if (e != cudaSuccess) return e;
  conv_k3_tma_kernel<BM, BN><<<a.grid, 2 * BM, bytes, a.stream>>>(
      xm, wm, static_cast<const T*>(a.bias), static_cast<T*>(a.y), a.ws, a.s, csteps,
      a.act, a.leak, a.per);
  return cudaGetLastError();
}

cudaError_t launch_tma_tile(const CUtensorMap& xm, const CUtensorMap& wm,
                            const Args& a, int csteps, int bm, int bn) {
  if (bm == 64 && bn == 64) return launch_tma<64, 64>(xm, wm, a, csteps);
  if (bm == 64 && bn == 128) return launch_tma<64, 128>(xm, wm, a, csteps);
  if (bm == 128 && bn == 64) return launch_tma<128, 64>(xm, wm, a, csteps);
  if (bm == 128 && bn == 128) return launch_tma<128, 128>(xm, wm, a, csteps);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace k3
}  // namespace ggan

// One K3a call on the TMA path. geo holds the maps' parameters in the order
// of conv_gemm.py: TmaGeometry.packed():
//   [0:4]   x dims (Cin, W, H, B), innermost first
//   [4:7]   x strides in bytes of dims 1-3
//   [7:9]   the bounding box's lower corner (W, H)
//   [9:11]  its upper corner (W, H)
//   [11]    channels per pixel, [12] pixels per column (= bm)
//   [13:17] traversal strides (1, s, s, 1)
//   [17:20] w dims (Cout, Cin, k*k), [20:22] w strides in bytes, [22:25] box
// The plan's tile bm x bn and `splits` K ranges of `per` steps (with
// splits > 1, ws is the f32 workspace [splits, M, Cout] and K1's reduce
// kernel follows); act 0 (none) or 2 (leaky, slope `leak`); pad_h / pad_w
// are the low-side pads. Returns cudaGetLastError() after the launches,
// cudaErrorInvalidValue for arguments it has no kernel for, or one of
// tma.cuh's codes (kEncodeX, kEncodeW, kNoEncoder).
extern "C" int ggan_conv_gemm_tma(const void* x, const void* w, const void* bias,
                                  void* y, void* ws, const long long* geo, int B,
                                  int H, int W, int Cin, int K, int Cout, int OH,
                                  int OW, int stride, int pad_h, int pad_w, int act,
                                  float leak, int bm, int bn, int splits, int per,
                                  void* stream) {
  using namespace ggan::k3;
  const int csteps = (Cin + BK - 1) / BK;
  const int nk = K * K * csteps;
  if (Cin % 8 != 0 || Cout % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || geo[12] != bm || splits < 1 ||
      per < 1 || int64_t(splits) * per < nk || int64_t(splits - 1) * per >= nk ||
      (splits > 1 && ws == nullptr) || (act != ggan::kActNone && act != ggan::kActLeaky))
    return static_cast<int>(cudaErrorInvalidValue);

  ggan::EncodeIm2col encode_im2col;
  ggan::EncodeTiled encode_tiled;
  if (!ggan::tensor_map_encoders(&encode_im2col, &encode_tiled)) return ggan::kNoEncoder;

  CUtensorMap xm, wm;
  const cuuint64_t xdims[4] = {cuuint64_t(geo[0]), cuuint64_t(geo[1]),
                               cuuint64_t(geo[2]), cuuint64_t(geo[3])};
  const cuuint64_t xstrides[3] = {cuuint64_t(geo[4]), cuuint64_t(geo[5]),
                                  cuuint64_t(geo[6])};
  const int lower[2] = {int(geo[7]), int(geo[8])};
  const int upper[2] = {int(geo[9]), int(geo[10])};
  const cuuint32_t xelem[4] = {cuuint32_t(geo[13]), cuuint32_t(geo[14]),
                               cuuint32_t(geo[15]), cuuint32_t(geo[16])};
  CUresult r = encode_im2col(
      &xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), xdims, xstrides,
      lower, upper, cuuint32_t(geo[11]), cuuint32_t(geo[12]), xelem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ggan::kEncodeX + static_cast<int>(r);
  const cuuint64_t wdims[3] = {cuuint64_t(geo[17]), cuuint64_t(geo[18]),
                               cuuint64_t(geo[19])};
  const cuuint64_t wstrides[2] = {cuuint64_t(geo[20]), cuuint64_t(geo[21])};
  const cuuint32_t box[3] = {cuuint32_t(geo[22]), cuuint32_t(geo[23]),
                             cuuint32_t(geo[24])};
  const cuuint32_t welem[3] = {1, 1, 1};
  r = encode_tiled(&wm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w),
                   wdims, wstrides, box, welem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ggan::kEncodeW + static_cast<int>(r);

  const Conv s{B,  H,  W,      Cin,   K,     K,           Cout,
               OH, OW, stride, pad_h, pad_w, B * OH * OW, K * K * Cin};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{x,   w,    bias, y, splits > 1 ? static_cast<float*>(ws) : nullptr,
               s,   act,  per,  leak,
               dim3((s.M + bm - 1) / bm, (Cout + bn - 1) / bn, splits), st};
  cudaError_t e = launch_tma_tile(xm, wm, a, csteps, bm, bn);
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  return static_cast<int>(ggan::k1::launch_splitk_reduce(a, splits));
}
