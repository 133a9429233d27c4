// K1: act(conv2d(x, w, stride, SAME|VALID) + bias), NHWC input, HWIO weight,
// NHWC output, f32 accumulation; f32 or bf16 in and out.
//
// Replaces graphical_gan_tpu/ops/pallas/fused_conv.py:_forward_pallas (the
// Pallas implicit GEMM behind fused_conv2d_bias_act).
//
// Design. A direct implicit GEMM: C[M, N] = A[M, R] @ W[R, N] with
// M = B*OH*OW output pixels, N = Cout and R = KH*KW*Cin in HWIO order, so the
// weight is already the row-major [R, N] matrix. The TPU kernel split the
// padded input by stride phase because Mosaic needs static slices; here each
// A element's input coordinate ih = oh*s - pad_lo + kh is computed directly
// and masked when it falls in the padding, so no padded or phase-split copy
// is ever written to device memory. The grid tiles M x N in 64 x 64 blocks
// (not one batch item per program: E.3 has only 16 pixels per item); each
// k-step stages a 64 x 16 input patch and a 16 x 64 weight tile in shared
// memory (double-buffered, with the next tile prefetched into registers while
// the current one is multiplied), and each of the 256 threads accumulates a
// 4 x 4 output tile in f32 registers with FMAs. Bias and activation run in
// the epilogue and the NHWC output is written once.
//
// Bound on the H100. The kernel issues 2*M*N*R FLOPs, but taps that land in
// the padding multiply zeros: the function needs only the in-bounds taps,
// 93%, 86% and 72% of them at E.1, E.2 and E.3 (SAME pads (1, 2), k5 s2).
// In f32 at those shapes that is about 29, 220 and 305 needed FLOPs per byte
// moved, all above the f32 ridge of 67 TFLOP/s / 3.35 TB/s = 20, so f32 is
// bound by the operations. In bf16 (989 TFLOP/s on the tensor cores, ridge
// 295) E.1 is bound by its bytes. This kernel uses plain FMAs (no wgmma/TMA
// yet), so its ceiling is the 67 TFLOP/s non-tensor f32 rate, and bf16
// inputs are widened to f32 before the FMAs; the tensor-core path is later
// work.

#include "common.cuh"

namespace ggan {
namespace {

constexpr int BM = 64;       // output pixels per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 16;       // reduction depth per k-step
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int APAD = 4;      // keeps As rows 16-byte aligned, halves bank conflicts

struct ConvShape {
  int B, H, W, Cin, KH, KW, Cout, OH, OW, stride, pad_h, pad_w;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv2d_bias_act_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const T* __restrict__ bias, T* __restrict__ y,
                       ConvShape s, int act) {
  __shared__ __align__(16) float As[2][BK][BM + APAD];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int M = s.B * s.OH * s.OW;
  const int R = s.KH * s.KW * s.Cin;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A loads: each thread owns one reduction column (a_k) and four pixels
  // (a_m + 16*i); the pixel decomposition is fixed for the whole k loop.
  const int a_k = tid % BK;
  const int a_m = tid / BK;
  int a_b[4], a_ih0[4], a_iw0[4];
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + a_m + 16 * i;
    a_ok[i] = m < M;
    const int mm = a_ok[i] ? m : 0;
    const int ow = mm % s.OW;
    const int t = mm / s.OW;
    const int oh = t % s.OH;
    a_b[i] = t / s.OH;
    a_ih0[i] = oh * s.stride - s.pad_h;
    a_iw0[i] = ow * s.stride - s.pad_w;
  }
  // W loads: each thread owns one output channel and four reduction rows.
  const int b_n = tid % BN;
  const int b_k = tid / BN;
  const bool b_ok = n0 + b_n < s.Cout;

  float a_reg[4], b_reg[4];
  auto load = [&](int k0) {
    const int r = k0 + a_k;
    const bool rk = r < R;
    int ci = 0, kw = 0, kh = 0;
    if (rk) {
      ci = r % s.Cin;
      const int t = r / s.Cin;
      kw = t % s.KW;
      kh = t / s.KW;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ih = a_ih0[i] + kh;
      const int iw = a_iw0[i] + kw;
      const bool ok = rk && a_ok[i] && ih >= 0 && ih < s.H && iw >= 0 && iw < s.W;
      a_reg[i] = ok ? to_f32(x[((int64_t(a_b[i]) * s.H + ih) * s.W + iw) * s.Cin + ci])
                    : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rr = k0 + b_k + 4 * j;
      b_reg[j] = (b_ok && rr < R) ? to_f32(w[int64_t(rr) * s.Cout + n0 + b_n]) : 0.0f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[buf][a_k][a_m + 16 * i] = a_reg[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) Bs[buf][b_k + 4 * j][b_n] = b_reg[j];
  };

  const int ty = tid / 16;
  const int tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const int nk = (R + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // The other buffer was last read in iteration kt-1, which every thread
    // finished before the barrier that closed it.
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx * 4 + j;
    if (n >= s.Cout) continue;
    const float bj = to_f32(bias[n]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
      if (m < M) y[int64_t(m) * s.Cout + n] = from_f32<T>(apply_act(acc[i][j] + bj, act));
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, const void* bias, void* y,
            const ConvShape& s, int act, cudaStream_t stream) {
  const int M = s.B * s.OH * s.OW;
  dim3 grid((M + BM - 1) / BM, (s.Cout + BN - 1) / BN);
  conv2d_bias_act_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(y), s, act);
}

}  // namespace
}  // namespace ggan

// pad_h / pad_w are the low-side pads (TF SAME puts the extra pad on the high
// side, which the bounds mask covers). Returns cudaGetLastError() after the
// launch; the Python wrapper raises when it is not cudaSuccess.
extern "C" int ggan_conv2d_bias_act(const void* x, const void* w, const void* bias,
                                    void* y, int dtype, int B, int H, int W,
                                    int Cin, int KH, int KW, int Cout, int OH,
                                    int OW, int stride, int pad_h, int pad_w,
                                    int act, void* stream) {
  const ggan::ConvShape s{B, H, W, Cin, KH, KW, Cout, OH, OW, stride, pad_h, pad_w};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ggan::kFloat32) {
    ggan::launch<float>(x, w, bias, y, s, act, st);
  } else if (dtype == ggan::kBFloat16) {
    ggan::launch<__nv_bfloat16>(x, w, bias, y, s, act, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
