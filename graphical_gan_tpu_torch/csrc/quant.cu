// Q1 and Q2: the int8 serving path (post-training quantization).
//
// These replace no Pallas kernel. The JAX package runs its int8 path
// (graphical_gan_tpu/ops/quant.py) through XLA: the rounding is
// jnp.round/clip (ops/quant.py:103 _q8) and the contractions are
// lax.conv_general_dilated, lax.conv_transpose and lax.dot_general with
// preferred_element_type=int32 (ops/quant.py:117-170). PyTorch has no CUDA
// int8 convolution, and torch._int_mm covers only a 2-D product with shape
// limits the serving buckets break, so the port writes both by hand.
//
// Q1 ggan_quantize_int8: q = int8(clip(rint(f32(x) / s), -127, 127)), x f32
//     or bf16, one scale s for the tensor (an activation) or one per channel
//     (a weight's output channel: channel (i / inner) % C of element i). The
//     division is IEEE (no fast math in build.py's flags), rint rounds half
//     to even, as jnp.round and torch.round do. Bound by its bytes: 5 (f32)
//     or 3 (bf16) bytes an element; 4 elements a thread where the tensor is
//     16-byte aligned and a multiple of 4 long.
//
// Q2 ggan_int8_conv: an implicit-GEMM convolution of int8 NHWC x with int8
//     HWIO w, stride s, explicit per-axis pads, the products summed in int32
//     (exact: the wrapper refuses K * 127^2 >= 2^31). The epilogue writes
//     either the int32 sums themselves (dtype 2) or f32(acc) * factor[n]
//     rounded to x's dtype (f32 or bf16), factor = f32(s_x) * s_w[n] from the
//     wrapper: JAX's out.astype(f32) * (s_x * s_w) then .astype(x.dtype).
//     A linear layer is a 1x1 conv over [M, 1, 1, K]; a stride-2 transposed
//     conv is a stride-1 conv to 4*O channels on the phase-decomposed filter
//     (ops/phase_deconv.py), its integer products regrouped, so int32 keeps
//     it exact.
//
//     C[M, N] = A[M, R] @ W[R, N], M = B*OH*OW, N = Cout, R = KH*KW*Cin in
//     HWIO order. Tiles of 64 x 64 outputs, 4 warps of 32 x 32, K steps of 32
//     bytes: each warp issues 2 x 4 mma.sync.aligned.m16n8k32.row.col.s32.s8.
//     s8.s32 a step from shared memory. A is gathered by the block (16 bytes
//     a thread, one int4 load where Cin % 16 == 0, bytes otherwise; padding
//     taps, rows past M and columns past R are zeros, never reads); W's
//     [32, 64] tile is read row by row and written transposed, N-major, so
//     that a B fragment is one 32-bit word. Two shared buffers: the next
//     tile's global loads are in registers while the current one is
//     multiplied. Bound by its operations at the wide layers (2*M*N*R over
//     1,979e12 int8 ops/s) and by its bytes at the narrow ones; this simple
//     kernel reaches neither (PERF.md): wgmma with s8 and TMA loads are later
//     work.

#include <cstring>

#include "common.cuh"

namespace ggan {

enum QuantOut : int { kOutF32 = 0, kOutBF16 = 1, kOutInt32 = 2 };

// ---------------------------------------------------------------------------
// Q1

__device__ __forceinline__ int8_t q8(float v, float s) {
  float r = rintf(__fdiv_rn(v, s));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(r));
}

template <typename T>
__global__ void quantize_int8_kernel(const T* __restrict__ x, const float* __restrict__ scales,
                                     float scalar, int C, long long inner,
                                     int8_t* __restrict__ q, long long n) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const float s = scales ? scales[(i / inner) % C] : scalar;
    q[i] = q8(to_f32(x[i]), s);
  }
}

// four elements a thread, one scale for the tensor
template <typename T>
__global__ void quantize_int8_vec4_kernel(const T* __restrict__ x, float s,
                                          char4* __restrict__ q, long long n4) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += step) {
    const T* p = x + 4 * i;
    char4 o;
    o.x = q8(to_f32(p[0]), s);
    o.y = q8(to_f32(p[1]), s);
    o.z = q8(to_f32(p[2]), s);
    o.w = q8(to_f32(p[3]), s);
    q[i] = o;
  }
}

inline int q1_grid(long long items) {
  long long blocks = (items + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

// ---------------------------------------------------------------------------
// Q2

constexpr int QBM = 64;
constexpr int QBN = 64;
constexpr int QBK = 32;
constexpr int QTHREADS = 128;
constexpr int QSROW = QBK + 16;  // 48-byte rows: fragment reads hit 32 banks

struct ConvGeo {
  int B, H, W, Cin, KH, KW, Cout, OH, OW, stride, pad_h, pad_w;
  long long M;
  int R;
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes of A's row `row` (one output pixel) at reduction columns
// [r0, r0 + 16): zero where a column is past R or its tap in the padding.
template <bool VEC>
__device__ __forceinline__ int4 gather_a(const int8_t* __restrict__ x, const ConvGeo& g,
                                         bool row_ok, int b, int ih0, int iw0, int r0) {
  int4 out = make_int4(0, 0, 0, 0);
  if (!row_ok) return out;
  if (VEC) {  // Cin % 16 == 0: the 16 columns share one tap
    if (r0 >= g.R) return out;
    const int tap = r0 / g.Cin;
    const int ci = r0 - tap * g.Cin;
    const int kh = tap / g.KW;
    const int ih = ih0 + kh;
    const int iw = iw0 + (tap - kh * g.KW);
    if (ih < 0 || ih >= g.H || iw < 0 || iw >= g.W) return out;
    return *reinterpret_cast<const int4*>(
        x + ((static_cast<long long>(b) * g.H + ih) * g.W + iw) * g.Cin + ci);
  }
  int8_t v[16];
  int tap = r0 / g.Cin;
  int ci = r0 - tap * g.Cin;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    int8_t e = 0;
    if (r0 + j < g.R) {
      const int kh = tap / g.KW;
      const int ih = ih0 + kh;
      const int iw = iw0 + (tap - kh * g.KW);
      if (ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
        e = x[((static_cast<long long>(b) * g.H + ih) * g.W + iw) * g.Cin + ci];
    }
    v[j] = e;
    if (++ci == g.Cin) {
      ci = 0;
      ++tap;
    }
  }
  int4 o;
  memcpy(&o, v, 16);
  return o;
}

// 16 bytes of W's row r (columns [n, n + 16)): zero past R or Cout.
template <bool VEC>
__device__ __forceinline__ int4 load_w(const int8_t* __restrict__ w, const ConvGeo& g, int r,
                                       int n) {
  int4 out = make_int4(0, 0, 0, 0);
  if (r >= g.R || n >= g.Cout) return out;
  const int8_t* p = w + static_cast<long long>(r) * g.Cout + n;
  if (VEC) return *reinterpret_cast<const int4*>(p);  // Cout % 16 == 0
  int8_t v[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) v[j] = n + j < g.Cout ? p[j] : static_cast<int8_t>(0);
  memcpy(&out, v, 16);
  return out;
}

template <int OUT, bool AVEC, bool WVEC>
__global__ void __launch_bounds__(QTHREADS)
    int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ factor, void* __restrict__ y, ConvGeo g) {
  __shared__ __align__(16) int8_t sA[2][QBM * QSROW];
  __shared__ __align__(16) int8_t sB[2][QBN * QSROW];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;  // groupID of the mma fragments
  const int tig = lane & 3;   // thread in group
  const long long m0 = static_cast<long long>(blockIdx.x) * QBM;
  const int n0 = blockIdx.y * QBN;

  // this thread's A row (an output pixel) and its 16-byte half of a K step
  const int a_row = tid >> 1;
  const int a_half = tid & 1;
  const long long m = m0 + a_row;
  const bool row_ok = m < g.M;
  int b = 0, ih0 = 0, iw0 = 0;
  if (row_ok) {
    const long long ohw = static_cast<long long>(g.OH) * g.OW;
    b = static_cast<int>(m / ohw);
    const int rem = static_cast<int>(m - b * ohw);
    const int oh = rem / g.OW;
    ih0 = oh * g.stride - g.pad_h;
    iw0 = (rem - oh * g.OW) * g.stride - g.pad_w;
  }
  // this thread's W row of a K step and its 16 columns
  const int w_row = tid >> 2;
  const int w_col = (tid & 3) * 16;

  const int steps = (g.R + QBK - 1) / QBK;
  int4 ra = gather_a<AVEC>(x, g, row_ok, b, ih0, iw0, a_half * 16);
  int4 rb = load_w<WVEC>(w, g, w_row, n0 + w_col);

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  const int wm = (warp >> 1) * 32;  // the warp's 32 x 32 quarter of the tile
  const int wn = (warp & 1) * 32;

  for (int s = 0; s < steps; ++s) {
    int8_t* A = sA[s & 1];
    int8_t* Bt = sB[s & 1];
    *reinterpret_cast<int4*>(A + a_row * QSROW + a_half * 16) = ra;
    {
      int8_t v[16];
      memcpy(v, &rb, 16);
#pragma unroll
      for (int j = 0; j < 16; ++j) Bt[(w_col + j) * QSROW + w_row] = v[j];
    }
    __syncthreads();
    if (s + 1 < steps) {  // the next tile's loads fly under this step's mma
      const int k1 = (s + 1) * QBK;
      ra = gather_a<AVEC>(x, g, row_ok, b, ih0, iw0, k1 + a_half * 16);
      rb = load_w<WVEC>(w, g, k1 + w_row, n0 + w_col);
    }
    uint32_t af[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int8_t* p = A + (wm + i * 16 + gid) * QSROW + tig * 4;
      af[i][0] = *reinterpret_cast<const uint32_t*>(p);
      af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * QSROW);
      af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * QSROW + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* p = Bt + (wn + j * 8 + gid) * QSROW + tig * 4;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 16);
#pragma unroll
      for (int i = 0; i < 2; ++i) mma_s8(acc[i][j], af[i], b0, b1);
    }
  }

  // epilogue: c0, c1 at row gid, columns 2*tig and 2*tig + 1; c2, c3 at row
  // gid + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = m0 + wm + i * 16 + gid + h * 8;
        if (row >= g.M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + j * 8 + tig * 2 + e;
          if (col >= g.Cout) continue;
          const int a = acc[i][j][h * 2 + e];
          const long long o = row * g.Cout + col;
          if (OUT == kOutInt32) {
            static_cast<int*>(y)[o] = a;
          } else {
            const float v = static_cast<float>(a) * factor[col];
            if (OUT == kOutF32)
              static_cast<float*>(y)[o] = v;
            else
              static_cast<__nv_bfloat16*>(y)[o] = __float2bfloat16(v);
          }
        }
      }
    }
  }
}

template <int OUT>
cudaError_t launch_int8_conv(const void* x, const void* w, const float* factor, void* y,
                             const ConvGeo& g, bool avec, bool wvec, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((g.M + QBM - 1) / QBM),
                  static_cast<unsigned>((g.Cout + QBN - 1) / QBN));
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(w);
  if (avec && wvec)
    int8_conv_kernel<OUT, true, true><<<grid, QTHREADS, 0, st>>>(xi, wi, factor, y, g);
  else if (avec)
    int8_conv_kernel<OUT, true, false><<<grid, QTHREADS, 0, st>>>(xi, wi, factor, y, g);
  else if (wvec)
    int8_conv_kernel<OUT, false, true><<<grid, QTHREADS, 0, st>>>(xi, wi, factor, y, g);
  else
    int8_conv_kernel<OUT, false, false><<<grid, QTHREADS, 0, st>>>(xi, wi, factor, y, g);
  return cudaGetLastError();
}

}  // namespace ggan

// Q1. x is contiguous, `dtype` f32 (0) or bf16 (1); scales null takes
// `scalar` for every element, else element i takes scales[(i / inner) % C].
// vec 4 (scalar scale, n % 4 == 0, x 16-byte aligned for f32 / 8 for bf16,
// q 4-byte aligned) or 1.
extern "C" int ggan_quantize_int8(const void* x, const void* scales, float scalar, int C,
                                  long long inner, void* q, int dtype, long long n, int vec,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  int8_t* qo = static_cast<int8_t*>(q);
  if (vec == 4 && sc == nullptr && n % 4 == 0) {
    const long long n4 = n / 4;
    if (dtype == ggan::kFloat32)
      ggan::quantize_int8_vec4_kernel<float><<<ggan::q1_grid(n4), 256, 0, st>>>(
          static_cast<const float*>(x), scalar, reinterpret_cast<char4*>(qo), n4);
    else if (dtype == ggan::kBFloat16)
      ggan::quantize_int8_vec4_kernel<__nv_bfloat16><<<ggan::q1_grid(n4), 256, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), scalar, reinterpret_cast<char4*>(qo), n4);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (vec == 1) {
    if (dtype == ggan::kFloat32)
      ggan::quantize_int8_kernel<float><<<ggan::q1_grid(n), 256, 0, st>>>(
          static_cast<const float*>(x), sc, scalar, C, inner, qo, n);
    else if (dtype == ggan::kBFloat16)
      ggan::quantize_int8_kernel<__nv_bfloat16><<<ggan::q1_grid(n), 256, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), sc, scalar, C, inner, qo, n);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Q2. x [B, H, W, Cin] and w [KH, KW, Cin, Cout] int8, contiguous; factor
// [Cout] f32 (unused for int32 output); y [B, OH, OW, Cout] in `out` (0 f32,
// 1 bf16, 2 int32). avec: Cin % 16 == 0 and x 16-byte aligned; wvec:
// Cout % 16 == 0 and w 16-byte aligned.
extern "C" int ggan_int8_conv(const void* x, const void* w, const void* factor, void* y,
                              int out, int B, int H, int W, int Cin, int KH, int KW, int Cout,
                              int OH, int OW, int stride, int pad_h, int pad_w, int avec,
                              int wvec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ggan::ConvGeo g{B, H, W, Cin, KH, KW, Cout, OH, OW, stride, pad_h, pad_w,
                  static_cast<long long>(B) * OH * OW, KH * KW * Cin};
  const float* f = static_cast<const float*>(factor);
  cudaError_t err;
  if (out == ggan::kOutF32)
    err = ggan::launch_int8_conv<ggan::kOutF32>(x, w, f, y, g, avec, wvec, st);
  else if (out == ggan::kOutBF16)
    err = ggan::launch_int8_conv<ggan::kOutBF16>(x, w, f, y, g, avec, wvec, st);
  else if (out == ggan::kOutInt32)
    err = ggan::launch_int8_conv<ggan::kOutInt32>(x, w, f, y, g, avec, wvec, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
