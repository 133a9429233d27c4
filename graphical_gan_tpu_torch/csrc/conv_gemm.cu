// K3: conv_gemm -- SAME k x k conv at stride s, + bias, + LeakyReLU(leak) when
// has_leak, over NHWC x and HWIO w; f32 accumulation, bias added in f32, one
// rounding to x's dtype; f32 or bf16 in and out.
//
// Replaces graphical_gan_tpu/ops/pallas/conv_gemm.py:conv_gemm, both of its
// variants: K3a "taps" (pallas_call at :206) and K3b "im2col" (:186).
//
// Design. An implicit GEMM C[M, N] = A[M, R] @ W[R, N] with M = B*OH*OW (the
// whole batch rides M, as on the TPU), N = Cout and R = K*K*Cin in HWIO order,
// so W is the weight as stored, row-major [R, N]. Blocks tile M x N by
// 64 x 64; the K loop takes BK = 32 reduction columns a step, double-buffered
// in shared memory, with the next step's tiles prefetched into registers
// while the current step is multiplied. The two kernels differ only in that
// loop, as the TPU variants do:
//   K3a (taps):   step s covers tap s / ceil(Cin/BK) and its channels
//                 [c0, c0 + BK); each row of the A tile reads one input
//                 pixel's contiguous channels, and channels past Cin are
//                 zeros. The taps' products accumulate into one f32 tile.
//   K3b (im2col): step s covers columns [s*BK, s*BK + BK) of the flattened
//                 tap-major K*K*Cin axis, so one step may span two taps; each
//                 column finds its own tap (r / Cin) and channel (r % Cin).
// Neither kernel writes the TPU's phase_stack copy or an im2col buffer to
// device memory (those are VMEM layout devices of Mosaic): the A tile is
// gathered from x with ih = oh*s - pad_top + kh and iw = ow*s - pad_left + kw,
// each spatial axis on its own (so H != W is right), and the padding is
// masked. Eight consecutive columns move as one 16-byte (bf16) or two
// 16-byte (f32) loads when Cin (for A) and Cout (for W) are multiples of 8
// and the pointers are aligned; otherwise one element at a time.
//
// Products. bf16: warp-level tensor-core mma.sync m16n8k16 (bf16 in, f32
// accumulate), 4 warps of 32 x 32 outputs each. f32: plain FMAs, 256 threads
// of 4 x 4 outputs each (no TF32: the f32 result holds to the f32 reference).
//
// Bound on the H100. At the bench shapes (5x5, stride 2, Cin 64 or 128, Cout
// 128 or 256) the function needs 2*Cin*Cout FLOPs per in-bounds tap and
// pixel, about 400 per byte moved in bf16, above the bf16 ridge of
// 989 TFLOP/s / 3.35 TB/s = 295: bound by the operations. mma.sync with
// register-staged loads reaches a fraction of the wgmma rate; wgmma, TMA and
// split-K (for the small-M shapes) are later work.

#include "common.cuh"

namespace ggan {
namespace {

constexpr int BM = 64;  // output pixels per block
constexpr int BN = 64;  // output channels per block
constexpr int BK = 32;  // reduction columns per step
constexpr int CHUNKS = BM * BK / 8;  // 8-column chunks per A (and W) tile: 256
static_assert(BK * BN / 8 == CHUNKS, "A and W tiles have the same chunk count");

struct Geo {
  int B, H, W, Cin, K, Cout, OH, OW, stride, pad_h, pad_w;
  int M, R, csteps;  // csteps = ceil(Cin / BK), K3a's steps per tap
};

template <typename T>
__device__ __forceinline__ T zero() { return from_f32<T>(0.0f); }

// 8 contiguous elements from 16-byte-aligned global memory.
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ p, T* v) {
  constexpr int words = 8 * int(sizeof(T)) / 16;
#pragma unroll
  for (int i = 0; i < words; ++i)
    reinterpret_cast<uint4*>(v)[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
}

// Where one output pixel's window starts; ok is false past M.
struct Pixel {
  int b, ih0, iw0;
  bool ok;
};

__device__ __forceinline__ Pixel pixel_of(const Geo& g, int m) {
  Pixel p;
  p.ok = m < g.M;
  const int mm = p.ok ? m : 0;
  const int ow = mm % g.OW;
  const int t = mm / g.OW;
  p.b = t / g.OH;
  p.ih0 = (t % g.OH) * g.stride - g.pad_h;
  p.iw0 = ow * g.stride - g.pad_w;
  return p;
}

// The input element of pixel p at tap t, channel ci; zero in the padding.
template <typename T>
__device__ __forceinline__ T x_at(const T* __restrict__ x, const Geo& g,
                                  const Pixel& p, int t, int ci) {
  const int ih = p.ih0 + t / g.K;
  const int iw = p.iw0 + t % g.K;
  if (!p.ok || ih < 0 || ih >= g.H || iw < 0 || iw >= g.W) return zero<T>();
  return x[((int64_t(p.b) * g.H + ih) * g.W + iw) * g.Cin + ci];
}

// A chunk: columns [col, col + 8) of step `step` for pixel p. K3a's columns
// are channels c0 + col.. of one tap; K3b's are flattened indices r0 + col..
template <typename T, bool kTaps>
__device__ __forceinline__ void gather_a(const T* __restrict__ x, const Geo& g,
                                         const Pixel& p, int step, int col,
                                         bool vec, T* v) {
  int t, ci;  // tap and channel of the chunk's first column
  if (kTaps) {
    t = step / g.csteps;
    ci = (step % g.csteps) * BK + col;
  } else {
    const int r = step * BK + col;
    t = r / g.Cin;
    ci = r - t * g.Cin;
  }
  if (vec) {
    // Cin % 8 == 0: the 8 columns are one tap's contiguous channels, all in
    // range or all past it
    const bool in_range = kTaps ? ci < g.Cin : t < g.K * g.K;
    const int ih = p.ih0 + t / g.K;
    const int iw = p.iw0 + t % g.K;
    if (in_range && p.ok && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W) {
      load8(x + ((int64_t(p.b) * g.H + ih) * g.W + iw) * g.Cin + ci, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = zero<T>();
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    int tj = t, cj = ci + j;
    if (!kTaps && cj >= g.Cin) {  // K3b: the column crossed into later taps
      tj = t + cj / g.Cin;
      cj = cj % g.Cin;
    }
    const bool in_range = kTaps ? cj < g.Cin : tj < g.K * g.K;
    v[j] = in_range ? x_at(x, g, p, tj, cj) : zero<T>();
  }
}

// W chunk: output channels [n, n + 8) of reduction row `row` of step `step`.
template <typename T, bool kTaps>
__device__ __forceinline__ void gather_w(const T* __restrict__ w, const Geo& g,
                                         int step, int row, int n, bool vec,
                                         T* v) {
  int r;
  bool in_range;
  if (kTaps) {
    const int ci = (step % g.csteps) * BK + row;
    r = (step / g.csteps) * g.Cin + ci;
    in_range = ci < g.Cin;
  } else {
    r = step * BK + row;
    in_range = r < g.R;
  }
  const T* src = w + int64_t(r) * g.Cout + n;
  if (vec && in_range && n < g.Cout) {  // Cout % 8 == 0: all 8 in range
    load8(src, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = (in_range && n + j < g.Cout) ? src[j] : zero<T>();
}

__device__ __forceinline__ float epilogue(float acc, float bias, int has_leak,
                                          float leak) {
  const float v = acc + bias;
  // jnp.where(y >= 0, y, leak * y): a NaN takes the leak branch and stays NaN
  return (has_leak && !(v >= 0.0f)) ? leak * v : v;
}

__device__ __forceinline__ int steps_of(const Geo& g, bool taps) {
  return taps ? g.K * g.K * g.csteps : (g.R + BK - 1) / BK;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync m16n8k16 (row.col, f32 accumulate)

constexpr int MMA_THREADS = 128;  // 2 x 2 warps, 32 x 32 outputs each
constexpr int SPAD = 8;           // row padding (bf16): conflict-free fragment loads

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool kTaps>
__global__ void __launch_bounds__(MMA_THREADS)
conv_gemm_mma_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     const __nv_bfloat16* __restrict__ bias,
                     __nv_bfloat16* __restrict__ y, Geo g, int has_leak,
                     float leak, int vec_a, int vec_w) {
  using T = __nv_bfloat16;
  // As[m][k] and Bs[n][k]: k contiguous, the layouts the fragments read
  __shared__ __align__(16) T As[2][BM][BK + SPAD];
  __shared__ __align__(16) T Bs[2][BN][BK + SPAD];
  constexpr int NC = CHUNKS / MMA_THREADS;  // chunks per thread: 2

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A chunk i: row tid/4 + 32*i, columns (tid%4)*8..; W chunk i: reduction
  // row tid/8 + 16*i, output channels (tid%8)*8..
  const int a_col = (tid % 4) * 8;
  Pixel px[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) px[i] = pixel_of(g, m0 + tid / 4 + 32 * i);
  const int w_n = (tid % 8) * 8;

  alignas(16) T av[NC][8];
  alignas(16) T wv[NC][8];
  auto load = [&](int step) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      gather_a<T, kTaps>(x, g, px[i], step, a_col, vec_a, av[i]);
      gather_w<T, kTaps>(w, g, step, tid / 8 + 16 * i, n0 + w_n, vec_w, wv[i]);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      *reinterpret_cast<uint4*>(&As[buf][tid / 4 + 32 * i][a_col]) =
          *reinterpret_cast<const uint4*>(av[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) Bs[buf][w_n + j][tid / 8 + 16 * i] = wv[i][j];
    }
  };

  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;
  const int gr = lane / 4;       // fragment row / column group
  const int gc = (lane % 4) * 2;  // fragment k pair
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  const int nk = steps_of(g, kTaps);
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load(kt + 1);
#pragma unroll
    for (int k16 = 0; k16 < BK; k16 += 16) {
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
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }

  // c0,c1: row gr, columns gc, gc+1; c2,c3: row gr+8, the same columns
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n = n0 + wn + 8 * j + gc + q;
      if (n >= g.Cout) continue;
      const float bn = to_f32(bias[n]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm + 16 * i + gr + 8 * h;
          if (m < g.M)
            y[int64_t(m) * g.Cout + n] =
                from_f32<T>(epilogue(acc[i][j][2 * h + q], bn, has_leak, leak));
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: plain FMAs, 16 x 16 threads of 4 x 4 outputs

constexpr int FMA_THREADS = 256;
constexpr int APAD = 4;  // keeps As rows 16-byte aligned, halves bank conflicts

template <bool kTaps>
__global__ void __launch_bounds__(FMA_THREADS)
conv_gemm_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ y,
                     Geo g, int has_leak, float leak, int vec_a, int vec_w) {
  // As[k][m] and Bs[k][n]: m and n contiguous, read as float4 by the FMAs
  __shared__ __align__(16) float As[2][BK][BM + APAD];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  // one A chunk (row tid/4, columns (tid%4)*8..) and one W chunk (reduction
  // row tid/8, output channels (tid%8)*8..) per thread
  const int a_row = tid / 4;
  const int a_col = (tid % 4) * 8;
  const Pixel px = pixel_of(g, m0 + a_row);
  const int w_row = tid / 8;
  const int w_n = (tid % 8) * 8;

  alignas(16) float av[8];
  alignas(16) float wv[8];
  auto load = [&](int step) {
    gather_a<float, kTaps>(x, g, px, step, a_col, vec_a, av);
    gather_w<float, kTaps>(w, g, step, w_row, n0 + w_n, vec_w, wv);
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 8; ++j) As[buf][a_col + j][a_row] = av[j];
    *reinterpret_cast<float4*>(&Bs[buf][w_row][w_n]) =
        *reinterpret_cast<const float4*>(wv);
    *reinterpret_cast<float4*>(&Bs[buf][w_row][w_n + 4]) =
        *reinterpret_cast<const float4*>(wv + 4);
  };

  const int ty = tid / 16;
  const int tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const int nk = steps_of(g, kTaps);
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load(kt + 1);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      const float avv[4] = {a.x, a.y, a.z, a.w};
      const float bvv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(avv[i], bvv[j], acc[i][j]);
    }
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx * 4 + j;
    if (n >= g.Cout) continue;
    const float bn = bias[n];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
      if (m < g.M) y[int64_t(m) * g.Cout + n] = epilogue(acc[i][j], bn, has_leak, leak);
    }
  }
}

template <bool kTaps>
void launch(const void* x, const void* w, const void* bias, void* y, int dtype,
            const Geo& g, int has_leak, float leak, int vec_a, int vec_w,
            cudaStream_t stream) {
  const dim3 grid((g.M + BM - 1) / BM, (g.Cout + BN - 1) / BN);
  if (dtype == kBFloat16) {
    conv_gemm_mma_kernel<kTaps><<<grid, MMA_THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y), g,
        has_leak, leak, vec_a, vec_w);
  } else {
    conv_gemm_fma_kernel<kTaps><<<grid, FMA_THREADS, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(y), g, has_leak,
        leak, vec_a, vec_w);
  }
}

}  // namespace
}  // namespace ggan

// variant 0 launches K3a (taps), 1 K3b (im2col). pad_h / pad_w are the SAME
// low-side pads of each axis (the high side is covered by the bounds mask).
// vec_a / vec_w allow the 8-wide loads of x / w (the wrapper sets them when
// Cin / Cout are multiples of 8 and the pointers 16-byte aligned). Returns
// cudaGetLastError() after the launch.
extern "C" int ggan_conv_gemm(const void* x, const void* w, const void* bias,
                              void* y, int dtype, int variant, int B, int H,
                              int W, int Cin, int K, int Cout, int OH, int OW,
                              int stride, int pad_h, int pad_w, int has_leak,
                              float leak, int vec_a, int vec_w, void* stream) {
  if ((dtype != ggan::kFloat32 && dtype != ggan::kBFloat16) ||
      (variant != 0 && variant != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  ggan::Geo g{B, H, W, Cin, K, Cout, OH, OW, stride, pad_h, pad_w,
              B * OH * OW, K * K * Cin, (Cin + ggan::BK - 1) / ggan::BK};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 0)
    ggan::launch<true>(x, w, bias, y, dtype, g, has_leak, leak, vec_a, vec_w, st);
  else
    ggan::launch<false>(x, w, bias, y, dtype, g, has_leak, leak, vec_a, vec_w, st);
  return static_cast<int>(cudaGetLastError());
}
