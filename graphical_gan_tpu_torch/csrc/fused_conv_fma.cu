// K1's f32 mainloop on plain FMAs (one in-order chain per output, never
// split over K); the design is in fused_conv.cu.

#include "fused_conv.cuh"

namespace ggan {
namespace k1 {
namespace {

constexpr int FMA_AST = FMA_BK + 4;  // A row pitch (floats): 16-byte aligned

template <int BM, int BN>
constexpr int fma_smem_bytes() {
  return FMA_STAGES * (BM * FMA_AST + FMA_BK * BN) * 4 + BM * 16;
}

template <int I>
__device__ __forceinline__ float lane_of(const float4& v) {
  if constexpr (I == 0) return v.x;
  if constexpr (I == 1) return v.y;
  if constexpr (I == 2) return v.z;
  return v.w;
}

// Each output is one fmaf chain over r = 0..R-1 in order, then + bias:
// the order of PyTorch's f32 CPU convolution at Cin >= 2, whose results
// this kernel's then equal bit for bit (so f32 is never split over K).
template <int BM, int BN, int TM, int TN, bool VEC>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
conv_k1_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ y,
                   Conv s, int act, float leak) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  constexpr int CH = TN / 4;  // float4 column chunks per thread
  static_assert((TM == 2 || TM == 4 || TM == 8) && (TN == 4 || TN == 8),
                "micro-tile");
  extern __shared__ __align__(16) float fsm[];
  float* As = fsm;                             // [STAGES][BM][AST], k contiguous
  float* Bs = As + FMA_STAGES * BM * FMA_AST;  // [STAGES][BK][BN], n contiguous
  RowInfo* rows = reinterpret_cast<RowInfo*>(Bs + FMA_STAGES * FMA_BK * BN);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  fill_rows(rows, s, m0, BM);
  __syncthreads();
  const int steps = (s.R + FMA_BK - 1) / FMA_BK;

  // Each call loads the next K step: A's column c (a 4-channel chunk with
  // VEC, else one channel) for rows a0 + i*A_PASS; W's column chunk (4
  // output channels with VEC, else one) for rows b0 + i*W_PASS.
  constexpr int A_W = VEC ? 4 : 1;  // channels per A copy and W copy
  constexpr int A_CH = FMA_BK / A_W;
  constexpr int A_PASS = THREADS / A_CH;
  constexpr int W_CH = BN / A_W;
  constexpr int W_PASS = THREADS / W_CH;
  static_assert((BM % A_PASS == 0 || A_PASS % BM == 0) &&
                FMA_BK % W_PASS == 0, "passes");
  const int a0 = tid / A_CH;
  const int b0 = tid / W_CH;
  const int nj = n0 + (tid % W_CH) * A_W;
  TapWalk walk;
  walk.init(s, (tid % A_CH) * A_W);
  int wr = b0;  // W row of pass 0
  const float* wp = w + int64_t(b0) * s.Cout + nj;
  auto load = [&](int buf) {
    float* at = As + buf * BM * FMA_AST + (tid % A_CH) * A_W;
    float* bt = Bs + buf * FMA_BK * BN + (tid % W_CH) * A_W;
    const int toff = walk.toff(s);
#pragma unroll
    for (int i = 0; i < (BM + A_PASS - 1) / A_PASS; ++i) {
      const int row = a0 + i * A_PASS;
      if (A_PASS > BM && row >= BM) break;  // more threads than copies
      const int off = x_offset(s, rows[row], walk, toff, s.R);
      const float* src = x + (off < 0 ? 0 : off);
      if constexpr (VEC)
        cp_async16(smem_u32(at + row * FMA_AST), src, off >= 0);
      else
        cp_async4(smem_u32(at + row * FMA_AST), src, off >= 0);
    }
#pragma unroll
    for (int i = 0; i < FMA_BK / W_PASS; ++i) {
      const int row = b0 + i * W_PASS;
      const bool ok = nj < s.Cout && wr + i * W_PASS < s.R;
      const float* src = ok ? wp + int64_t(i) * W_PASS * s.Cout : w;
      if constexpr (VEC)
        cp_async16(smem_u32(bt + row * BN), src, ok);
      else
        cp_async4(smem_u32(bt + row * BN), src, ok);
    }
    walk.advance(s, FMA_BK);
    wr += FMA_BK;
    wp += int64_t(FMA_BK) * s.Cout;
  };

  // thread (tx, ty): rows TM*ty.., columns 4*tx.. of each of the CH column
  // chunks BN/CH apart (lanes read neighbouring 16-byte words)
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int st = 0; st < FMA_STAGES - 1; ++st) {
    if (st < steps) load(st);
    cp_async_commit();
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<FMA_STAGES - 2>();
    __syncthreads();
    // refill the buffer of step kt-1, which every thread finished before
    // the barrier above
    const int next = kt + FMA_STAGES - 1;
    if (next < steps) load(next % FMA_STAGES);
    cp_async_commit();
    const float* at = As + (kt % FMA_STAGES) * BM * FMA_AST + TM * ty * FMA_AST;
    const float* bt = Bs + (kt % FMA_STAGES) * FMA_BK * BN + 4 * tx;
#pragma unroll
    for (int k4 = 0; k4 < FMA_BK / 4; ++k4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(at + i * FMA_AST + 4 * k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* brow = bt + (4 * k4 + kk) * BN;
        float bv[TN];
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const float4 b = *reinterpret_cast<const float4*>(brow + c * (BN / CH));
          bv[4 * c] = b.x;
          bv[4 * c + 1] = b.y;
          bv[4 * c + 2] = b.z;
          bv[4 * c + 3] = b.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          float av;
          if (kk == 0) av = lane_of<0>(a[i]);
          else if (kk == 1) av = lane_of<1>(a[i]);
          else if (kk == 2) av = lane_of<2>(a[i]);
          else av = lane_of<3>(a[i]);
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + TM * ty + i;
    if (m >= s.M) continue;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int n = n0 + c * (BN / CH) + 4 * tx;
      if (n >= s.Cout) continue;
      float v[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        v[jj] = n + jj < s.Cout
                    ? apply_act(acc[i][4 * c + jj] + bias[n + jj], act, leak)
                    : 0.0f;
      float* dst = y + int64_t(m) * s.Cout + n;
      if (VEC) {  // Cout % 4 == 0: all four in range, 16-byte aligned
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (n + jj < s.Cout) dst[jj] = v[jj];
      }
    }
  }
}

template <int BM, int BN, int TM, int TN, bool VEC>
cudaError_t launch_fma(const Args& a) {
  constexpr int bytes = fma_smem_bytes<BM, BN>();
  const cudaError_t e = allow_smem(conv_k1_fma_kernel<BM, BN, TM, TN, VEC>, bytes);
  if (e != cudaSuccess) return e;
  conv_k1_fma_kernel<BM, BN, TM, TN, VEC>
      <<<a.grid, (BM / TM) * (BN / TN), bytes, a.stream>>>(
          static_cast<const float*>(a.x), static_cast<const float*>(a.w),
          static_cast<const float*>(a.bias), static_cast<float*>(a.y), a.s, a.act,
          a.leak);
  return cudaGetLastError();
}

// the f32 tiles and their micro-tiles, 256 threads each: 8 x 8 outputs per
// thread on the large tile, 4 x 4 and 2 x 4 on the small ones
template <bool VEC>
cudaError_t launch_fma_vec(const Args& a, int bm, int bn) {
  if (bm == 128 && bn == 128) return launch_fma<128, 128, 8, 8, VEC>(a);
  if (bm == 64 && bn == 64) return launch_fma<64, 64, 4, 4, VEC>(a);
  if (bm == 32 && bn == 64) return launch_fma<32, 64, 2, 4, VEC>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t launch_fma_tile(const Args& a, int bm, int bn, bool vec) {
  return vec ? launch_fma_vec<true>(a, bm, bn) : launch_fma_vec<false>(a, bm, bn);
}

}  // namespace k1
}  // namespace ggan
