// Q1 and Q2: the int8 serving path (post-training quantization).
//
// These replace no Pallas kernel. The JAX package runs its int8 path
// (graphical_gan_tpu/ops/quant.py) through XLA: the rounding is
// jnp.round/clip (ops/quant.py:103 _q8) and the contractions are
// lax.conv_general_dilated, lax.conv_transpose and lax.dot_general with
// preferred_element_type=int32 (ops/quant.py:117-170). PyTorch has no CUDA
// int8 convolution, and torch._int_mm covers only a 2-D product with shape
// limits the serving buckets break, so the port writes both by hand.
// Q2's wgmma route is quant_tma.cu; its shared pieces are quant.cuh.
//
// Q1 ggan_quantize_int8: q = int8(clip(rint(f32(x) / s), -127, 127)), x f32
//     or bf16, one scale s for the tensor (an activation) or one per channel
//     (a weight's output channel: channel (i / inner) % C of element i). The
//     division is IEEE (no fast math in build.py's flags), rint rounds half
//     to even, as jnp.round and torch.round do. Bound by its bytes: 5 (f32)
//     or 3 (bf16) bytes an element; 4 elements a thread where the tensor is
//     16-byte aligned and a multiple of 4 long. Its launches are small and
//     each rereads an activation its producer wrote a moment before, so
//     where that producer is the BN apply (K2b), ops/quant.py takes the
//     int8 copy K2b writes in the same pass instead (fused_norm.cu:
//     ggan_bn_apply_q8); the latents and inputs without a BN before them
//     keep this launch.
//
// Q2: an implicit-GEMM convolution of int8 NHWC x with an int8 filter,
//     stride s, explicit per-axis pads, the products summed in int32
//     (exact: the wrapper refuses K * 127^2 >= 2^31). The epilogue writes
//     either the int32 sums themselves (dtype 2) or f32(acc) * factor[n]
//     rounded to x's dtype (f32 or bf16), factor = f32(s_x) * s_w[n] from
//     the wrapper (JAX's out.astype(f32) * (s_x * s_w) then
//     .astype(x.dtype)), then, where the wrapper passes them, + bias and
//     relu or leaky in that dtype, each step rounded to it (quant.cuh:
//     q2_value; JAX's ops/conv.py:114-126 order). A linear layer is a 1x1
//     conv over [M, 1, 1, K]; a stride-2 transposed conv is a stride-1 conv
//     to 4*O channels on the phase-decomposed filter (ops/phase_deconv.py),
//     its integer products regrouped, so int32 keeps it exact.
//
//     C[M, N] = A[M, R] @ W[R, N], M = B*OH*OW, N = Cout, R = KH*KW*Cin in
//     HWIO order. The filter is quantized once per sampler and kept
//     K-major, wk[n][r] (ops/kernels/quant.py: pack_filter), rows up to the
//     N tile zero: both routes read it as it lies.
//
//     Bound. At the cifar10 int8 sampler (DIM 64, z 128) at B 256 with f32
//     output every layer is bound by its bytes over 3.35 TB/s (x and the
//     filter read once, y written once; the phase filter's fixed zero taps
//     are no work): the dense layer (256 x 4096 x 128) 1.42 us, Generator.2
//     (4096 x 512 x 2304) 3.17 us, Generator.3 (16384 x 256 x 1152) 5.72
//     us, Generator.5 (65536 x 12 x 576) 2.19 us, 12.5 us in all, most of
//     it the f32 output; the products the function needs take 2.45 and 2.90
//     us at the two wide layers over 1,979e12 int8 ops/s. At B 8 every
//     layer is under 0.5 us of bytes: there the card's latency and its
//     fill set the pace.
//
//     Two routes, chosen by ops/kernels/quant.py: q2_plan:
//     - tma (quant_tma.cu), where Cin % 32 == 0 and the operands are
//       16-byte aligned: every cifar10, mnist and GMGAN layer but
//       Generator.Input at K 158 (GMGAN), and SSGAN's K 16 and 146 dense
//       layers. What held the first kernel (this file's mma route) back, and
//       what the route does about it: (1) 64 x 64 tiles of mma.sync with a
//       __syncthreads every 32-byte K step -> wgmma.mma_async m64nNk32
//       s32.s8.s8 from shared memory, 128-byte K steps (4 wgmma a
//       warpgroup), a ring of TMA loads on mbarriers with one step's
//       products in flight, two blocks an SM; (2) the filter transposed
//       byte by byte on every step -> the K-major filter, made once, read
//       by a tiled tensor map (8-bit wgmma reads both operands K-major);
//       (3) no split K -> where the tiles fill under a wave (B 8: 16 tiles
//       at Generator.2) the K loop is split, int32 partials added with
//       atomics (exact in any order) and the last split alone dequantizes;
//       (4) N 64 whatever the layer -> N tiles of 16-128 (16 for
//       Generator.5's 12 channels); (5) scattered 4-byte stores and a
//       factor load per element, bias and act as later aten passes -> a
//       column's factor and bias loaded once, bias and act fused, the tile
//       staged in shared memory and stored 16 bytes a thread where the
//       row allows.
//     - mma (this file), every other shape: tiles of 64 x 64 outputs, 4
//       warps of 32 x 32, K steps of 32 bytes: each warp issues 2 x 4
//       mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 a step from shared
//       memory. A is gathered by the block (16 bytes a thread, one int4
//       load where Cin % 16 == 0, bytes otherwise; padding taps, rows past
//       M and columns past R are zeros, never reads); W's [64, 32] tile
//       comes row by row from the K-major filter, as the B fragments read
//       it. Two shared buffers: the next tile's global loads are in
//       registers while the current one is multiplied.

#include <cstring>

#include "quant.cuh"

namespace ggan {

// ---------------------------------------------------------------------------
// Q1 (q8: common.cuh)

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
__device__ __forceinline__ int4 gather_a(const int8_t* __restrict__ x, const QConv& g,
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

// 16 bytes of the K-major filter's row n (output channel n) at reduction
// columns [r0, r0 + 16): zero past R or the filter's rows.
template <bool VEC>
__device__ __forceinline__ int4 load_wk(const int8_t* __restrict__ wk, const QConv& g, int n,
                                        int r0) {
  int4 out = make_int4(0, 0, 0, 0);
  if (n >= g.n_rows || r0 >= g.R) return out;
  const int8_t* p = wk + static_cast<long long>(n) * g.R + r0;
  if (VEC) return *reinterpret_cast<const int4*>(p);  // R % 16 == 0
  int8_t v[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) v[j] = r0 + j < g.R ? p[j] : static_cast<int8_t>(0);
  memcpy(&out, v, 16);
  return out;
}

template <bool AVEC, bool WVEC>
__global__ void __launch_bounds__(QTHREADS)
    int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wk,
                     void* __restrict__ y, QConv g, QEpi e) {
  __shared__ __align__(16) int8_t sA[2][QBM * QSROW];
  __shared__ __align__(16) int8_t sB[2][QBN * QSROW];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;  // groupID of the mma fragments
  const int tig = lane & 3;   // thread in group
  const long long m0 = static_cast<long long>(blockIdx.x) * QBM;
  const int n0 = blockIdx.y * QBN;

  // this thread's A row (an output pixel), W row (an output channel) and
  // its 16-byte half of a K step in each
  const int a_row = tid >> 1;
  const int half = tid & 1;
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
  const int w_row = tid >> 1;

  const int steps = (g.R + QBK - 1) / QBK;
  int4 ra = gather_a<AVEC>(x, g, row_ok, b, ih0, iw0, half * 16);
  int4 rb = load_wk<WVEC>(wk, g, n0 + w_row, half * 16);

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
    // both tiles K-major, as the filter already is: no transposing
    *reinterpret_cast<int4*>(A + a_row * QSROW + half * 16) = ra;
    *reinterpret_cast<int4*>(Bt + w_row * QSROW + half * 16) = rb;
    __syncthreads();
    if (s + 1 < steps) {  // the next tile's loads fly under this step's mma
      const int k1 = (s + 1) * QBK;
      ra = gather_a<AVEC>(x, g, row_ok, b, ih0, iw0, k1 + half * 16);
      rb = load_wk<WVEC>(wk, g, n0 + w_row, k1 + half * 16);
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
  const bool has_bias = e.bias != nullptr;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = n0 + wn + j * 8 + tig * 2 + c;
      if (col >= g.Cout) continue;
      const float f = e.out == kOutInt32 ? 0.0f : e.factor[col];
      const float bv = has_bias ? q2_bias(e, col) : 0.0f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = m0 + wm + i * 16 + gid + h * 8;
          if (row >= g.M) continue;
          const int a = acc[i][j][h * 2 + c];
          const long long o = row * g.Cout + col;
          if (e.out == kOutInt32) {
            static_cast<int*>(y)[o] = a;
          } else {
            const float v = q2_value(a, f, bv, has_bias, e.out, e.act, e.leak);
            if (e.out == kOutF32)
              static_cast<float*>(y)[o] = v;
            else
              static_cast<__nv_bfloat16*>(y)[o] = __float2bfloat16(v);
          }
        }
      }
    }
  }
}

cudaError_t launch_int8_conv(const void* x, const void* wk, void* y, const QConv& g,
                             const QEpi& e, bool avec, bool wvec, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((g.M + QBM - 1) / QBM),
                  static_cast<unsigned>((g.Cout + QBN - 1) / QBN));
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(wk);
  if (avec && wvec)
    int8_conv_kernel<true, true><<<grid, QTHREADS, 0, st>>>(xi, wi, y, g, e);
  else if (avec)
    int8_conv_kernel<true, false><<<grid, QTHREADS, 0, st>>>(xi, wi, y, g, e);
  else if (wvec)
    int8_conv_kernel<false, true><<<grid, QTHREADS, 0, st>>>(xi, wi, y, g, e);
  else
    int8_conv_kernel<false, false><<<grid, QTHREADS, 0, st>>>(xi, wi, y, g, e);
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

// Q2 on the mma.sync route. x [B, H, W, Cin] int8 contiguous; wk the
// K-major filter [n_rows][KH*KW*Cin] int8 (rows past Cout zero); factor
// [Cout] f32 (unused for int32 output); bias [Cout] in the output dtype or
// null; y [B, OH, OW, Cout] in `out` (0 f32, 1 bf16, 2 int32); act 0, 1 or
// 2 (slope `leak`). avec: Cin % 16 == 0 and x 16-byte aligned; wvec:
// R % 16 == 0 and wk 16-byte aligned.
extern "C" int ggan_int8_conv(const void* x, const void* wk, const void* factor,
                              const void* bias, void* y, int out, int act, float leak,
                              int B, int H, int W, int Cin, int KH, int KW, int Cout,
                              int n_rows, int OH, int OW, int stride, int pad_h, int pad_w,
                              int avec, int wvec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out < ggan::kOutF32 || out > ggan::kOutInt32 || n_rows < Cout ||
      (out == ggan::kOutInt32 && (bias != nullptr || act != ggan::kActNone)))
    return static_cast<int>(cudaErrorInvalidValue);
  const ggan::QConv g{B,  H,  W,      Cin,   KH,    KW,          Cout, OH, OW,
                      stride, pad_h, pad_w, B * OH * OW, KH * KW * Cin, n_rows};
  const ggan::QEpi e{static_cast<const float*>(factor), bias, out, act, leak};
  return static_cast<int>(ggan::launch_int8_conv(x, wk, y, g, e, avec, wvec, st));
}
