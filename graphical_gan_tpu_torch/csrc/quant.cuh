// Q2's pieces shared by its two routes (quant.cu: the mma.sync kernel;
// quant_tma.cu: the wgmma kernel fed by TMA): the conv's geometry and the
// epilogue of one output element.
#pragma once

#include "common.cuh"

namespace ggan {

enum QuantOut : int { kOutF32 = 0, kOutBF16 = 1, kOutInt32 = 2 };

// C[M, N] = A[M, R] @ W[R, N] of an NHWC conv: M = B*OH*OW, N = Cout,
// R = KH*KW*Cin in HWIO order. The filter comes K-major, wk[n][r] with
// rows of R bytes, n_rows >= Cout of them (the rows past Cout zero).
struct QConv {
  int B, H, W, Cin, KH, KW, Cout, OH, OW, stride, pad_h, pad_w;
  int M, R, n_rows;
};

// The epilogue's operands: factor[n] = f32(s_x) * s_w[n]; bias [Cout] in
// the output dtype or null; act 0 (none), 1 (relu) or 2 (leaky, slope
// `leak` already rounded to the output dtype).
struct QEpi {
  const float* factor;
  const void* bias;
  int out, act;
  float leak;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// One output element from its int32 sum, as ops/quant.py computes it and
// in its order of roundings: v = f32(acc) * factor rounded to the output
// dtype, then v + bias rounded to it, then relu (v < 0 ? 0 : v) or leaky
// (max(v * leak rounded to it, v)). Products and sums are written out so
// that none is contracted into an FMA. The value returned is exact in the
// output dtype.
__device__ __forceinline__ float q2_value(int acc, float factor, float bias, bool has_bias,
                                          int out, int act, float leak) {
  const bool bf = out == kOutBF16;
  float v = __fmul_rn(static_cast<float>(acc), factor);
  if (bf) v = round_bf16(v);
  if (has_bias) {
    v = __fadd_rn(v, bias);
    if (bf) v = round_bf16(v);
  }
  if (act == kActRelu) {
    v = v < 0.0f ? 0.0f : v;
  } else if (act == kActLeaky) {
    float t = __fmul_rn(v, leak);
    if (bf) t = round_bf16(t);
    v = t > v ? t : v;
  }
  return v;
}

__device__ __forceinline__ float q2_bias(const QEpi& e, int n) {
  if (e.out == kOutBF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(e.bias)[n]);
  return static_cast<const float*>(e.bias)[n];
}

}  // namespace ggan
