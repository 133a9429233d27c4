// K2: batch-statistics batch norm + activation over channels-last x viewed
// as [R, C] (R = product of the leading dims), f32 statistics; f32 or bf16
// in and out. Four kernels, each behind its own C entry point:
//
// K2a ggan_bn_stats: per-channel mean, biased variance and
//     inv = 1 / sqrt(var + eps). Replaces
//     graphical_gan_tpu/ops/pallas/fused_norm.py:_stats (_stats_kernel).
// K2b ggan_bn_apply: y = act((x - mean) * (inv * scale) + offset) in x's
//     dtype. Replaces fused_norm.py:_fwd (_apply_kernel).
// K2c ggan_bn_bwd_reduce: per channel [Σgz, Σgz·xhat] in f32, with
//     xhat = (x - mean) * inv and gz = g * act'(y), y recomputed from x as
//     K2b computes it. Replaces fused_norm.py:_bwd's first pallas_call
//     (_bwd_reduce_kernel).
// K2d ggan_bn_bwd_apply: dx = (gz - Σgz/R - xhat * Σ(gz·xhat)/R) * inv *
//     scale in x's dtype. Replaces _bwd's second pallas_call
//     (_bwd_apply_kernel).
//
// Design. The TPU kernel carries Σx and Σx² across its sequential grid in a
// VMEM scratch; blocks on the GPU run in no order, so the statistics run in
// two stages and no atomics (the JAX package audits bit-identity, and a fixed
// reduction order keeps this kernel deterministic too):
//   stage 1: block (channel tile of 32, row block) walks its rows with
//            Welford's update per thread, merges its 8 row lanes in a fixed
//            order with Chan's formula and writes (mean, M2) to a scratch
//            that the wrapper allocates with torch.empty;
//   stage 2: one warp per channel merges the row blocks' partials in a fixed
//            order (Chan's formula again) into mean, var and inv.
// The (mean, M2) form avoids the E[x²] - mean² cancellation of the TPU
// kernel for inputs whose mean is large against their spread, and follows
// the JAX default path (jnp.var) more closely. Both stages work on
// x - x[0, c], the column shifted by its first value, so that the rounding
// of a large running mean does not leak into M2 either. The row split
// depends only on the shape, so a given input always gives the same bits.
// Apply is one elementwise pass; when C is a multiple of 4 each thread moves
// 4 contiguous channels with one vector load and one vector store.
//
// The backward follows the same two shapes. K2c is K2a's two stages with
// plain f32 sums in place of Welford: stage 1 (channel tile of 32, row
// block) sums gz and gz·xhat over its rows per thread and adds its 8 row
// lanes in a fixed order; stage 2 adds the row blocks' partials in a fixed
// order, one warp per channel. The row split is K2a's (stats_split), so it
// depends on the shape alone and the sums are deterministic without atomics.
// As on the TPU, xhat and act'(y) are recomputed from x (remat): y is not
// saved by the forward, and act'(y) comes from the same expression K2b
// evaluated, so the mask matches the forward's output. K2d is K2b's
// vectorised elementwise pass over g and x.
//
// Bound on the H100. All four kernels do a few operations per element, far
// below the ridge, so they are bound by bytes: stats reads x once, apply
// reads x and writes y once, K2c reads g and x once, K2d reads g and x and
// writes dx once. The design keeps every pass at that one read (or read and
// write) and keeps the loads coalesced along the contiguous channel axis;
// what it does not yet do is fuse passes, so x is read twice forward and
// g and x twice backward.

#include "common.cuh"

namespace ggan {
namespace {

constexpr int ST_CT = 32;  // channels per stats block (one warp wide)
constexpr int ST_RY = 8;   // row lanes per stats block

// Chan et al.: merge (nb, mb, Mb) into (na, ma, Ma).
__device__ __forceinline__ void chan_merge(float& na, float& ma, float& Ma,
                                           float nb, float mb, float Mb) {
  if (nb == 0.0f) return;
  const float n = na + nb;
  const float d = mb - ma;
  const float fb = nb / n;
  ma = ma + d * fb;
  Ma = Ma + Mb + d * d * na * fb;
  na = n;
}

template <typename T>
__global__ void __launch_bounds__(ST_CT * ST_RY)
bn_stats_partial_kernel(const T* __restrict__ x, float* __restrict__ pmean,
                        float* __restrict__ pm2, int R, int C, int rows_per_block) {
  __shared__ float sn[ST_RY][ST_CT];
  __shared__ float sm[ST_RY][ST_CT];
  __shared__ float s2[ST_RY][ST_CT];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int c = blockIdx.x * ST_CT + tx;
  const int rb = blockIdx.y;
  const int r0 = rb * rows_per_block;
  const int r1 = min(r0 + rows_per_block, R);

  float n = 0.0f, mean = 0.0f, m2 = 0.0f;
  if (c < C) {
    const float shift = to_f32(x[c]);
    for (int r = r0 + ty; r < r1; r += ST_RY) {
      const float v = to_f32(x[int64_t(r) * C + c]) - shift;
      n += 1.0f;
      const float d = v - mean;
      mean += d / n;
      m2 = fmaf(d, v - mean, m2);
    }
  }
  sn[ty][tx] = n;
  sm[ty][tx] = mean;
  s2[ty][tx] = m2;
  __syncthreads();
  if (ty == 0 && c < C) {
    for (int k = 1; k < ST_RY; ++k) chan_merge(n, mean, m2, sn[k][tx], sm[k][tx], s2[k][tx]);
    pmean[int64_t(rb) * C + c] = mean;
    pm2[int64_t(rb) * C + c] = m2;
  }
}

template <typename T>
__global__ void bn_stats_merge_kernel(const T* __restrict__ x,
                                      const float* __restrict__ pmean,
                                      const float* __restrict__ pm2,
                                      float* __restrict__ mean_out,
                                      float* __restrict__ var_out,
                                      float* __restrict__ inv_out, int R, int C,
                                      int rows_per_block, int n_row_blocks, float eps) {
  const int lane = threadIdx.x % 32;
  const int c = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (c >= C) return;  // whole warps leave together: c is uniform in a warp
  float n = 0.0f, mean = 0.0f, m2 = 0.0f;
  for (int rb = lane; rb < n_row_blocks; rb += 32) {
    const float nb = float(min(rows_per_block, R - rb * rows_per_block));
    chan_merge(n, mean, m2, nb, pmean[int64_t(rb) * C + c], pm2[int64_t(rb) * C + c]);
  }
  // fixed-shape tree over the lanes: lane 0 ends with the total
  for (int off = 16; off > 0; off >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, n, off);
    const float mb = __shfl_down_sync(0xffffffffu, mean, off);
    const float Mb = __shfl_down_sync(0xffffffffu, m2, off);
    chan_merge(n, mean, m2, nb, mb, Mb);
  }
  if (lane == 0) {
    const float var = m2 / float(R);
    mean_out[c] = to_f32(x[c]) + mean;  // undo stage 1's shift
    var_out[c] = var;
    inv_out[c] = 1.0f / sqrtf(var + eps);
  }
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
bn_apply_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                const float* __restrict__ inv, const float* __restrict__ scale,
                const float* __restrict__ offset, T* __restrict__ y,
                int64_t n_packs, int C, int act) {
  const Pack<T, VEC>* xp = reinterpret_cast<const Pack<T, VEC>*>(x);
  Pack<T, VEC>* yp = reinterpret_cast<Pack<T, VEC>*>(y);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n_packs; i += stride) {
    const int c0 = int((i * VEC) % C);  // C % VEC == 0: a pack never wraps a row
    const Pack<T, VEC> in = xp[i];
    Pack<T, VEC> out;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int c = c0 + k;
      const float a = inv[c] * scale[c];
      const float v = (to_f32(in.v[k]) - mean[c]) * a + offset[c];
      out.v[k] = from_f32<T>(apply_act(v, act));
    }
    yp[i] = out;
  }
}

int apply_grid(int64_t n_packs) {
  const int64_t blocks = (n_packs + 255) / 256;
  return int(blocks < 132 * 32 ? (blocks > 0 ? blocks : 1) : 132 * 32);
}

template <typename T>
void launch_stats(const void* x, float* pmean, float* pm2, float* mean, float* var,
                  float* inv, int R, int C, int rows_per_block, int n_row_blocks,
                  float eps, cudaStream_t st) {
  dim3 grid1((C + ST_CT - 1) / ST_CT, n_row_blocks);
  dim3 block1(ST_CT, ST_RY);
  bn_stats_partial_kernel<T><<<grid1, block1, 0, st>>>(static_cast<const T*>(x), pmean,
                                                       pm2, R, C, rows_per_block);
  constexpr int kWarps = 8;
  bn_stats_merge_kernel<T><<<(C + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
      static_cast<const T*>(x), pmean, pm2, mean, var, inv, R, C, rows_per_block,
      n_row_blocks, eps);
}

template <typename T, int VEC>
void launch_apply(const void* x, const float* mean, const float* inv, const float* scale,
                  const float* offset, void* y, int64_t numel, int C, int act,
                  cudaStream_t st) {
  const int64_t n_packs = numel / VEC;
  bn_apply_kernel<T, VEC><<<apply_grid(n_packs), 256, 0, st>>>(
      static_cast<const T*>(x), mean, inv, scale, offset, static_cast<T*>(y), n_packs, C,
      act);
}

// d act(u)/du at the forward's pre-activation y: relu 1 or 0, leaky 1 or 0.2
// (y > 0 picks the slope, as fused_norm.py:_act_grad does).
__device__ __forceinline__ float act_grad(float y, int act) {
  if (act == kActRelu) return y > 0.0f ? 1.0f : 0.0f;
  if (act == kActLeaky) return y > 0.0f ? 1.0f : 0.2f;
  return 1.0f;
}

template <typename T>
__global__ void __launch_bounds__(ST_CT * ST_RY)
bn_bwd_reduce_partial_kernel(const T* __restrict__ g, const T* __restrict__ x,
                             const float* __restrict__ mean,
                             const float* __restrict__ inv,
                             const float* __restrict__ scale,
                             const float* __restrict__ offset,
                             float* __restrict__ psum, float* __restrict__ pdot, int R,
                             int C, int rows_per_block, int act) {
  __shared__ float s0[ST_RY][ST_CT];
  __shared__ float s1[ST_RY][ST_CT];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int c = blockIdx.x * ST_CT + tx;
  const int rb = blockIdx.y;
  const int r0 = rb * rows_per_block;
  const int r1 = min(r0 + rows_per_block, R);

  float a0 = 0.0f, a1 = 0.0f;
  if (c < C) {
    const float m = mean[c];
    const float iv = inv[c];
    const float a = iv * scale[c];
    const float of = offset[c];
    for (int r = r0 + ty; r < r1; r += ST_RY) {
      const int64_t i = int64_t(r) * C + c;
      const float d = to_f32(x[i]) - m;
      const float gz = to_f32(g[i]) * act_grad(d * a + of, act);
      a0 += gz;
      a1 = fmaf(gz, d * iv, a1);
    }
  }
  s0[ty][tx] = a0;
  s1[ty][tx] = a1;
  __syncthreads();
  if (ty == 0 && c < C) {
    for (int k = 1; k < ST_RY; ++k) {
      a0 += s0[k][tx];
      a1 += s1[k][tx];
    }
    psum[int64_t(rb) * C + c] = a0;
    pdot[int64_t(rb) * C + c] = a1;
  }
}

__global__ void bn_bwd_reduce_merge_kernel(const float* __restrict__ psum,
                                           const float* __restrict__ pdot,
                                           float* __restrict__ sum_out,
                                           float* __restrict__ dot_out, int C,
                                           int n_row_blocks) {
  const int lane = threadIdx.x % 32;
  const int c = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (c >= C) return;  // whole warps leave together: c is uniform in a warp
  float a0 = 0.0f, a1 = 0.0f;
  for (int rb = lane; rb < n_row_blocks; rb += 32) {
    a0 += psum[int64_t(rb) * C + c];
    a1 += pdot[int64_t(rb) * C + c];
  }
  // fixed-shape tree over the lanes: lane 0 ends with the total
  for (int off = 16; off > 0; off >>= 1) {
    a0 += __shfl_down_sync(0xffffffffu, a0, off);
    a1 += __shfl_down_sync(0xffffffffu, a1, off);
  }
  if (lane == 0) {
    sum_out[c] = a0;
    dot_out[c] = a1;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
bn_bwd_apply_kernel(const T* __restrict__ g, const T* __restrict__ x,
                    const float* __restrict__ mean, const float* __restrict__ inv,
                    const float* __restrict__ scale, const float* __restrict__ offset,
                    const float* __restrict__ red_sum, const float* __restrict__ red_dot,
                    T* __restrict__ dx, int64_t n_packs, int C, float rows, int act) {
  const Pack<T, VEC>* gp = reinterpret_cast<const Pack<T, VEC>*>(g);
  const Pack<T, VEC>* xp = reinterpret_cast<const Pack<T, VEC>*>(x);
  Pack<T, VEC>* dp = reinterpret_cast<Pack<T, VEC>*>(dx);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n_packs; i += stride) {
    const int c0 = int((i * VEC) % C);  // C % VEC == 0: a pack never wraps a row
    const Pack<T, VEC> gin = gp[i];
    const Pack<T, VEC> xin = xp[i];
    Pack<T, VEC> out;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int c = c0 + k;
      const float iv = inv[c];
      const float d = to_f32(xin.v[k]) - mean[c];
      const float gz = to_f32(gin.v[k]) * act_grad(d * (iv * scale[c]) + offset[c], act);
      const float v = (gz - red_sum[c] / rows - d * iv * (red_dot[c] / rows)) * iv * scale[c];
      out.v[k] = from_f32<T>(v);
    }
    dp[i] = out;
  }
}

template <typename T>
void launch_bwd_reduce(const void* g, const void* x, const float* mean, const float* inv,
                       const float* scale, const float* offset, float* psum, float* pdot,
                       float* sum_out, float* dot_out, int R, int C, int rows_per_block,
                       int n_row_blocks, int act, cudaStream_t st) {
  dim3 grid1((C + ST_CT - 1) / ST_CT, n_row_blocks);
  dim3 block1(ST_CT, ST_RY);
  bn_bwd_reduce_partial_kernel<T><<<grid1, block1, 0, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), mean, inv, scale, offset, psum,
      pdot, R, C, rows_per_block, act);
  constexpr int kWarps = 8;
  bn_bwd_reduce_merge_kernel<<<(C + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
      psum, pdot, sum_out, dot_out, C, n_row_blocks);
}

template <typename T, int VEC>
void launch_bwd_apply(const void* g, const void* x, const float* mean, const float* inv,
                      const float* scale, const float* offset, const float* red_sum,
                      const float* red_dot, void* dx, int64_t numel, int C, int R, int act,
                      cudaStream_t st) {
  const int64_t n_packs = numel / VEC;
  bn_bwd_apply_kernel<T, VEC><<<apply_grid(n_packs), 256, 0, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), mean, inv, scale, offset, red_sum,
      red_dot, static_cast<T*>(dx), n_packs, C, float(R), act);
}

}  // namespace
}  // namespace ggan

// K2a. part_mean / part_m2 are [n_row_blocks, C] f32 scratch; mean, var and
// inv are [C] f32 outputs. rows_per_block * n_row_blocks must cover R.
extern "C" int ggan_bn_stats(const void* x, void* part_mean, void* part_m2, void* mean,
                             void* var, void* inv, int dtype, int R, int C,
                             int rows_per_block, int n_row_blocks, float eps,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pm = static_cast<float*>(part_mean);
  float* p2 = static_cast<float*>(part_m2);
  float* mo = static_cast<float*>(mean);
  float* vo = static_cast<float*>(var);
  float* io = static_cast<float*>(inv);
  if (dtype == ggan::kFloat32) {
    ggan::launch_stats<float>(x, pm, p2, mo, vo, io, R, C, rows_per_block, n_row_blocks,
                              eps, st);
  } else if (dtype == ggan::kBFloat16) {
    ggan::launch_stats<__nv_bfloat16>(x, pm, p2, mo, vo, io, R, C, rows_per_block,
                                      n_row_blocks, eps, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2b. mean, inv, scale and offset are [C] f32; y has x's dtype and shape.
// vec is 4 (C % 4 == 0 and 16-byte aligned x and y) or 1.
extern "C" int ggan_bn_apply(const void* x, const void* mean, const void* inv,
                             const void* scale, const void* offset, void* y, int dtype,
                             long long numel, int C, int act, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(inv);
  const float* sc = static_cast<const float*>(scale);
  const float* of = static_cast<const float*>(offset);
  if (dtype == ggan::kFloat32 && vec == 4) {
    ggan::launch_apply<float, 4>(x, m, iv, sc, of, y, numel, C, act, st);
  } else if (dtype == ggan::kFloat32 && vec == 1) {
    ggan::launch_apply<float, 1>(x, m, iv, sc, of, y, numel, C, act, st);
  } else if (dtype == ggan::kBFloat16 && vec == 4) {
    ggan::launch_apply<__nv_bfloat16, 4>(x, m, iv, sc, of, y, numel, C, act, st);
  } else if (dtype == ggan::kBFloat16 && vec == 1) {
    ggan::launch_apply<__nv_bfloat16, 1>(x, m, iv, sc, of, y, numel, C, act, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2c. g and x are [R, C] in one dtype; mean, inv, scale and offset are [C]
// f32; part_sum / part_dot are [n_row_blocks, C] f32 scratch; red_sum
// (Σgz) and red_dot (Σgz·xhat) are [C] f32 outputs.
extern "C" int ggan_bn_bwd_reduce(const void* g, const void* x, const void* mean,
                                  const void* inv, const void* scale, const void* offset,
                                  void* part_sum, void* part_dot, void* red_sum,
                                  void* red_dot, int dtype, int R, int C,
                                  int rows_per_block, int n_row_blocks, int act,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(inv);
  const float* sc = static_cast<const float*>(scale);
  const float* of = static_cast<const float*>(offset);
  float* ps = static_cast<float*>(part_sum);
  float* pd = static_cast<float*>(part_dot);
  float* rs = static_cast<float*>(red_sum);
  float* rd = static_cast<float*>(red_dot);
  if (dtype == ggan::kFloat32) {
    ggan::launch_bwd_reduce<float>(g, x, m, iv, sc, of, ps, pd, rs, rd, R, C,
                                   rows_per_block, n_row_blocks, act, st);
  } else if (dtype == ggan::kBFloat16) {
    ggan::launch_bwd_reduce<__nv_bfloat16>(g, x, m, iv, sc, of, ps, pd, rs, rd, R, C,
                                           rows_per_block, n_row_blocks, act, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2d. red_sum and red_dot are K2c's outputs over the same R rows; dx has
// x's dtype and shape. vec is 4 (C % 4 == 0 and 16-byte aligned g, x and
// dx) or 1.
extern "C" int ggan_bn_bwd_apply(const void* g, const void* x, const void* mean,
                                 const void* inv, const void* scale, const void* offset,
                                 const void* red_sum, const void* red_dot, void* dx,
                                 int dtype, long long numel, int C, int R, int act, int vec,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(inv);
  const float* sc = static_cast<const float*>(scale);
  const float* of = static_cast<const float*>(offset);
  const float* rs = static_cast<const float*>(red_sum);
  const float* rd = static_cast<const float*>(red_dot);
  if (dtype == ggan::kFloat32 && vec == 4) {
    ggan::launch_bwd_apply<float, 4>(g, x, m, iv, sc, of, rs, rd, dx, numel, C, R, act, st);
  } else if (dtype == ggan::kFloat32 && vec == 1) {
    ggan::launch_bwd_apply<float, 1>(g, x, m, iv, sc, of, rs, rd, dx, numel, C, R, act, st);
  } else if (dtype == ggan::kBFloat16 && vec == 4) {
    ggan::launch_bwd_apply<__nv_bfloat16, 4>(g, x, m, iv, sc, of, rs, rd, dx, numel, C, R,
                                             act, st);
  } else if (dtype == ggan::kBFloat16 && vec == 1) {
    ggan::launch_bwd_apply<__nv_bfloat16, 1>(g, x, m, iv, sc, of, rs, rd, dx, numel, C, R,
                                             act, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
