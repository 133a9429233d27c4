// Shared device helpers for the port's kernels: dtype conversion through the
// bf16 intrinsics and the activation epilogue (codes match
// graphical_gan_tpu_torch/ops/kernels/build.py: 0 none, 1 relu, 2 leaky).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ggan {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };
enum Act : int { kActNone = 0, kActRelu = 1, kActLeaky = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// relu is max(v, 0) and leaky is where(v >= 0, v, leak*v), the reference's
// LeakyReLU (LEAKY_ALPHA = 0.2 unless the caller gives K3's `leak`); written
// as selects so that a NaN passes through as it does in jnp.maximum and
// torch. v < 0 ? leak*v : v agrees with the where() on every input: a NaN
// fails both comparisons and leak*NaN is NaN; -0.0 is not < 0 and is >= 0,
// so both return it unchanged.
__device__ __forceinline__ float apply_act(float v, int act, float leak = 0.2f) {
  if (act == kActRelu) return v < 0.0f ? 0.0f : v;
  if (act == kActLeaky) return v < 0.0f ? leak * v : v;
  return v;
}

// Q1's rounding, int8(clip(rint(v / s), -127, 127)): IEEE division (no fast
// math in build.py's flags), rint half to even, as jnp.round and torch.round
// do. K2b's int8 output (fused_norm.cu) rounds with it too.
__device__ __forceinline__ int8_t q8(float v, float s) {
  float r = rintf(__fdiv_rn(v, s));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(r));
}

}  // namespace ggan
