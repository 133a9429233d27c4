// K1: act(conv2d(x, w, stride, SAME|VALID) + bias), NHWC input, HWIO weight,
// NHWC output, f32 accumulation; f32 or bf16 in and out.
//
// Replaces graphical_gan_tpu/ops/pallas/fused_conv.py:_forward_pallas (the
// Pallas implicit GEMM behind fused_conv2d_bias_act).
//
// The function. An implicit GEMM C[M, N] = A[M, R] @ W[R, N] with
// M = B*OH*OW output pixels, N = Cout and R = KH*KW*Cin in HWIO order, so the
// weight is already the row-major [R, N] matrix. A's element (m, r) is
// x[b, oh*s - pad_h + kh, ow*s - pad_w + kw, ci] for r = (kh*KW + kw)*Cin + ci,
// and zero where that falls in the padding: the TPU kernel's padded,
// phase-split copy is never written to device memory. The products
// accumulate in f32, bias and activation are applied in f32, and the result
// is rounded once to x's dtype, as the Pallas kernel does
// (fused_conv.py:89-102).
//
// Bound on the H100, counting only the taps inside the input (as
// chip_smoke.py does). f32 is bound by its operations at every model shape:
// 29-305 needed FLOPs per byte, above the FMA ridge of 67 TFLOP/s /
// 3.35 TB/s = 20. bf16 on the tensor cores (ridge 989 / 3.35 = 295) is bound
// by its operations at Cin >= 64 and by its bytes at Cin = 1 or 3 (the first
// stage of every encoder and critic), where writing the output dominates.
//
// Design. The wrapper's plan() (ops/kernels/fused_conv.py) picks from the
// shape alone one of three mainloops, the tile BM x BN, the depth BK of one
// K step and the number of K splits, and passes them here. The tile is the
// largest whose count fills 9/10 of the 132 SMs (a sweep on the H100 found
// it fastest). Every gather walks its reduction column by BK with adds
// (fused_conv.cuh: TapWalk): the K loops issue no integer division.
//   wgmma (fused_conv_wgmma.cu; bf16, Cin % 8 == 0 and Cout % 8 == 0): one
//     (BM = 64) or two (BM = 128) warpgroups issue wgmma.mma_async
//     m64nBNk16 from shared memory. BK = 64 bf16 = 128 bytes, one 128-byte
//     swizzle row. Each 8-channel run of an input pixel is one 16-byte
//     cp.async that writes straight into the swizzled K-major A tile the
//     descriptor names (src-size 0 zero-fills padding taps and rows past
//     M). The [BK, BN] tile of the row-major weight is copied the same way
//     into 64-column swizzled atoms that wgmma reads MN-major (its transpose
//     bit), so W is never transposed in device memory. A ring of 4 stages
//     of cp.async groups keeps 3 K steps of loads in flight under the
//     products.
//   mma (this file; bf16 otherwise: Cin 1 or 3, R = 25 or 75): element
//     gathers into a K tile padded with zeros to BK = 32, mma.sync
//     m16n8k16. These shapes are bound by their bytes, not the tensor cores.
//   fma (fused_conv_fma.cu; f32): plain FMAs, no TF32, from a 3-stage
//     cp.async ring (16-byte copies when Cin % 4 == 0 and Cout % 4 == 0,
//     4-byte ones otherwise). Each output is one fmaf chain over
//     r = 0..R-1 in order: the order of PyTorch's f32 CPU convolution at
//     Cin >= 2, so there the card's f32 outputs equal the CPU's bit for bit
//     (Cin = 1 takes another CPU algorithm), which the f32 card-against-CPU
//     training checks lean on: a split sum is more accurate but agrees with
//     the CPU on only ~4% of the outputs, and a mask or sign that flips
//     between the two devices then shows up in the trained state (mnist
//     wali-gp's Adam moments moved 5.4% of a leaf's largest where the check
//     allows 5%). So f32 is never split over K; small M gets small tiles
//     instead, 256 threads each: 8 x 8 outputs per thread on 128 x 128
//     tiles, 4 x 4 on 64 x 64, 2 x 4 on 32 x 64.
// Split K (bf16). Where even 64 x 64 tiles would not fill a wave (E.3 at
// B <= 64: 64 tiles for a K loop of 50 steps), the K steps are cut into
// equal ranges on multiples of BK, enough for three blocks per SM where
// each range keeps 4 steps or more: block z accumulates its range and
// writes the f32 partial tile to the workspace [splits, M, N];
// conv_k1_splitk_reduce_kernel then sums splits 0..S-1 in that fixed order,
// adds the bias, applies the activation and rounds once. No atomics, so the
// same inputs give the same bits. With one split the epilogue stays in the
// mainloop kernel.

#include <algorithm>

#include "fused_conv.cuh"

namespace ggan {
namespace k1 {
namespace {

enum Path : int { kPathFma = 0, kPathMma = 1, kPathWgmma = 2 };

// ---------------------------------------------------------------------------
// mma: bf16 with element gathers (Cin or Cout not a multiple of 8)

constexpr int MMA_BM = 64;
constexpr int MMA_BN = 64;
constexpr int MMA_BK = 32;
constexpr int MMA_THREADS = 128;  // 2 x 2 warps of 32 x 32 outputs
constexpr int MMA_PAD = 8;        // row padding (bf16) against bank conflicts

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(MMA_THREADS)
conv_k1_mma_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   const __nv_bfloat16* __restrict__ bias,
                   __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
                   Conv s, int act, float leak, int per) {
  using T = __nv_bfloat16;
  // As[m][k] and Bs[n][k]: k contiguous, the layouts the fragments read
  __shared__ __align__(16) T As[2][MMA_BM][MMA_BK + MMA_PAD];
  __shared__ __align__(16) T Bs[2][MMA_BN][MMA_BK + MMA_PAD];
  __shared__ RowInfo rows[MMA_BM];
  constexpr int NE = MMA_BM * MMA_BK / MMA_THREADS;  // elements per thread: 16

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * MMA_BM;
  const int n0 = blockIdx.y * MMA_BN;
  fill_rows(rows, s, m0, MMA_BM);
  __syncthreads();
  const KRange kr = k_range(s, MMA_BK, per);

  // A: column a_k, rows a_m + 4*i; W: output channel w_n, rows w_k + 2*i
  const int a_k = tid % MMA_BK;
  const int a_m = tid / MMA_BK;
  const int w_n = tid % MMA_BN;
  const int w_k = tid / MMA_BN;
  const T zero = __float2bfloat16(0.0f);
  T av[NE], wv[NE];
  TapWalk walk;
  walk.init(s, kr.step0 * MMA_BK + a_k);
  // each call loads the next K step of the block's range
  auto load = [&]() {
    const int toff = walk.toff(s);
#pragma unroll
    for (int i = 0; i < NE; ++i) {
      const int off = x_offset(s, rows[a_m + 4 * i], walk, toff, kr.kend);
      av[i] = off >= 0 ? x[off] : zero;
    }
    const int n = n0 + w_n;
    const int k0 = walk.r - a_k;
#pragma unroll
    for (int i = 0; i < NE; ++i) {
      const int rr = k0 + w_k + 2 * i;
      wv[i] = (rr < kr.kend && n < s.Cout) ? w[int64_t(rr) * s.Cout + n] : zero;
    }
    walk.advance(s, MMA_BK);
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < NE; ++i) As[buf][a_m + 4 * i][a_k] = av[i];
#pragma unroll
    for (int i = 0; i < NE; ++i) Bs[buf][w_n][w_k + 2 * i] = wv[i];
  };

  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;
  const int gr = lane / 4;        // fragment row / column group
  const int gc = (lane % 4) * 2;  // fragment k pair
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  if (kr.steps > 0) {
    load();
    store(0);
  }
  __syncthreads();
  for (int kt = 0; kt < kr.steps; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < kr.steps) load();
#pragma unroll
    for (int k16 = 0; k16 < MMA_BK; k16 += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const T* r0 = &As[cur][wm + 16 * i + gr][k16 + gc];
        const T* r8 = &As[cur][wm + 16 * i + gr + 8][k16 + gc];
        a[i][0] = *reinterpret_cast<const uint32_t*>(r0);
        a[i][1] = *reinterpret_cast<const uint32_t*>(r8);
        a[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
        a[i][3] = *reinterpret_cast<const uint32_t*>(r8 + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const T* c0 = &Bs[cur][wn + 8 * j + gr][k16 + gc];
        b[j][0] = *reinterpret_cast<const uint32_t*>(c0);
        b[j][1] = *reinterpret_cast<const uint32_t*>(c0 + 8);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
    // the other buffer was last read in step kt-1, which every thread
    // finished before the barrier that closed it
    if (kt + 1 < kr.steps) store(cur ^ 1);
    __syncthreads();
  }

  // c0,c1: row gr, columns gc, gc+1; c2,c3: row gr+8, the same columns
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n = n0 + wn + 8 * j + gc + q;
      if (n >= s.Cout) continue;
      const float bn = split ? 0.0f : to_f32(bias[n]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm + 16 * i + gr + 8 * h;
          if (m >= s.M) continue;
          const float v = acc[i][j][2 * h + q];
          if (split)
            ws[(int64_t(blockIdx.z) * s.M + m) * s.Cout + n] = v;
          else
            y[int64_t(m) * s.Cout + n] = from_f32<T>(apply_act(v + bn, act, leak));
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// split-K reduce (bf16): splits 0..S-1 summed in that order, + bias, act,
// one rounding

__global__ void __launch_bounds__(256)
conv_k1_splitk_reduce_kernel(const float* __restrict__ ws, int splits,
                             int64_t mn, int cout,
                             const __nv_bfloat16* __restrict__ bias,
                             __nv_bfloat16* __restrict__ y, int act, float leak) {
  for (int64_t i = int64_t(blockIdx.x) * 256 + threadIdx.x; i < mn;
       i += int64_t(gridDim.x) * 256) {
    float v = ws[i];
    for (int z = 1; z < splits; ++z) v += ws[z * mn + i];
    y[i] = __float2bfloat16(apply_act(v + to_f32(bias[i % cout]), act, leak));
  }
}

// ---------------------------------------------------------------------------
// launch

cudaError_t launch_main(const Args& a, int dtype, int path, int bm, int bn,
                        int bk, int stages, int vec) {
  const Conv& s = a.s;
  if (path == kPathWgmma) {
    if (dtype != kBFloat16 || !vec || bk != WG_BK || stages != WG_STAGES ||
        s.Cin % 8 != 0 || s.Cout % 8 != 0)
      return cudaErrorInvalidValue;
    return launch_wgmma_tile(a, bm, bn);
  }
  if (path == kPathMma) {
    if (dtype != kBFloat16 || vec || bm != MMA_BM || bn != MMA_BN ||
        bk != MMA_BK || stages != 2)
      return cudaErrorInvalidValue;
    using T = __nv_bfloat16;
    conv_k1_mma_kernel<<<a.grid, MMA_THREADS, 0, a.stream>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.w),
        static_cast<const T*>(a.bias), static_cast<T*>(a.y), a.ws, a.s, a.act,
        a.leak, a.per);
    return cudaGetLastError();
  }
  if (path == kPathFma) {
    if (dtype != kFloat32 || bk != FMA_BK || stages != FMA_STAGES ||
        a.grid.z != 1)
      return cudaErrorInvalidValue;
    if (vec && (s.Cin % 4 != 0 || s.Cout % 4 != 0)) return cudaErrorInvalidValue;
    return launch_fma_tile(a, bm, bn, vec);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t launch_splitk_reduce(const Args& a, int splits) {
  const int64_t mn = int64_t(a.s.M) * a.s.Cout;
  const int blocks = static_cast<int>(std::min<int64_t>((mn + 255) / 256, 132 * 8));
  conv_k1_splitk_reduce_kernel<<<blocks, 256, 0, a.stream>>>(
      a.ws, splits, mn, a.s.Cout, static_cast<const __nv_bfloat16*>(a.bias),
      static_cast<__nv_bfloat16*>(a.y), a.act, a.leak);
  return cudaGetLastError();
}

}  // namespace k1
}  // namespace ggan

// One K1 call as the wrapper's plan() chose it: path (0 fma, 1 mma,
// 2 wgmma), tile bm x bn, depth bk, ring stages, 16-byte copies (vec), and
// `splits` K ranges of `per` steps each; act's slope is `leak` (K1 passes
// 0.2 for leaky_relu, K3b its own). With splits > 1, ws is the f32
// workspace [splits, M, Cout] and a reduce kernel follows the mainloop.
// pad_h / pad_w are the low-side pads (TF SAME puts the extra pad on the
// high side, which the bounds mask covers). Returns cudaGetLastError()
// after the launches, or cudaErrorInvalidValue for a plan K1 has no kernel
// for; the Python wrapper raises when it is not cudaSuccess.
extern "C" int ggan_conv2d_bias_act(const void* x, const void* w, const void* bias,
                                    void* y, void* ws, int dtype, int B, int H,
                                    int W, int Cin, int KH, int KW, int Cout,
                                    int OH, int OW, int stride, int pad_h,
                                    int pad_w, int act, float leak, int path,
                                    int bm, int bn, int bk, int stages, int vec,
                                    int splits, int per, void* stream) {
  const ggan::k1::Conv s{B,  H,  W,      Cin,   KH,    KW,          Cout,
                         OH, OW, stride, pad_h, pad_w, B * OH * OW, KH * KW * Cin};
  const int nk = bk > 0 ? (s.R + bk - 1) / bk : 0;
  // a tile, and every K step in exactly one split, none empty
  if (bm <= 0 || bn <= 0 || bk <= 0 || splits < 1 || per < 1 ||
      int64_t(splits) * per < nk || int64_t(splits - 1) * per >= (nk > 0 ? nk : 1) ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ggan::k1::Args a{x,  w,   bias, y, splits > 1 ? static_cast<float*>(ws) : nullptr,
                         s,  act, per,  leak,
                         dim3((s.M + bm - 1) / bm, (Cout + bn - 1) / bn, splits), st};
  cudaError_t e = ggan::k1::launch_main(a, dtype, path, bm, bn, bk, stages, vec);
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  return static_cast<int>(ggan::k1::launch_splitk_reduce(a, splits));
}
