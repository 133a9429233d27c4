// K2: batch-statistics batch norm + activation over channels-last x viewed
// as [R, C] (R = product of the leading dims), f32 statistics; f32 or bf16
// in and out. Three kernels, each behind its own C entry point:
//
// K2a ggan_bn_stats: per-channel mean, biased variance and
//     inv = 1 / sqrt(var + eps). Replaces
//     graphical_gan_tpu/ops/pallas/fused_norm.py:_stats (_stats_kernel).
// K2b ggan_bn_apply: y = act((x - mean) * (inv * scale) + offset) in x's
//     dtype. Replaces fused_norm.py:_fwd (_apply_kernel).
// K2c+K2d ggan_bn_bwd: the whole backward in one launch. Per channel
//     red = [Σgz, Σgz·xhat] in f32, with xhat = (x - mean) * inv and
//     gz = g * act'(y), y recomputed from x as K2b computes it, and
//     dx = (gz - Σgz/R - xhat * Σ(gz·xhat)/R) * inv * scale in x's dtype.
//     Replaces both pallas_calls of fused_norm.py:_bwd (_bwd_reduce_kernel
//     and _bwd_apply_kernel).
//
// Forward design. The TPU kernel carries Σx and Σx² across its sequential
// grid in a VMEM scratch; blocks on the GPU run in no order, so the
// statistics run in two stages and no atomics (the JAX package audits
// bit-identity, and a fixed reduction order keeps this kernel
// deterministic too):
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
// Backward design. The TPU runs a reduce pass and an apply pass, each
// reading g and x from HBM. Here one cooperative launch does both, with one
// grid-wide barrier between them, and reads g and x from HBM once:
//   - [R, C] is cut into units (row block x channel tile) by a plan that
//     depends on the shape alone (fused_norm.py:bn_bwd_plan): about one
//     unit per SM, channel tiles 64 bytes wide or more, so that the row
//     blocks, and with them the partials each block merges, stay few;
//   - blocks take units in a fixed assignment (unit blockIdx.x + k * grid);
//     the plan's grid is one block per SM (132 on the H100) or one per
//     unit where the units are fewer, so a block takes at most the plan's
//     `slots` units; where there is more than one row block, the plan's
//     units are no more than the SMs, and a block takes one;
//   - a block has 512 threads (256 where a thread holds 8 bf16 channels);
//   - phase 1: a thread walks rows ty, ty + TY, ... of its unit with
//     16-byte loads of g and x (4 f32 or 8 bf16 channels; scalar where C or
//     a pointer is not aligned for that), 4 rows in flight, sums gz and
//     gz·xhat in f32 in row order, and stores the packs it read into shared
//     memory; the block adds its row lanes in a fixed order (a butterfly in
//     the warp, then the warps in order) and writes the unit's partials;
//   - barrier (cooperative_groups::this_grid().sync());
//   - phase 2: each block merges the partials of its unit's channel tile
//     in row-block order, coalesced across channels (every block of a tile
//     merges the same values in the same order, so all agree to the bit,
//     and the block of row block 0 writes red), then writes dx from the
//     g and x it kept. Where a unit's rows do not fit in shared memory the
//     rest is read again, mostly from the 50 MB L2 (the plan's `onchip`).
//     A plan with one row block (G.BN1's [B, 4096]) needs no merge: each
//     block writes dx right after phase 1, and the barrier is skipped.
// No float atomics: red and dx are bit-identical from call to call and do
// not depend on the grid size.
//
// Bound on the H100. All three kernels do a few operations per element, far
// below the ridge, so they are bound by bytes: stats reads x once, apply
// reads x and writes y once, and the backward reads g and x once and writes
// dx once (K2d's bytes alone; the fused kernel's floor). The backward at the
// cifar10 shapes moves 1-16 MB, so its launch and barrier are a large part
// of its time; one launch in place of three is what the design buys there.

#include <cooperative_groups.h>

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

// threads per block (ops/kernels/fused_norm.py: bn_bwd_plan): 256 where a
// thread holds 8 bf16 channels, 512 otherwise (at 512 a thread has at most
// 128 registers, and 8 channels' sums, statistics and packs spill there)
template <int VEC>
constexpr int kBwdThreads = VEC > 4 ? 256 : 512;
constexpr int BWD_UNROLL = 4;  // rows a thread has in flight per step

// The kernel's tensors and the plan of ops/kernels/fused_norm.py:bn_bwd_plan.
template <typename T>
struct BwdArgs {
  const T* g;
  const T* x;
  const float* mean;
  const float* inv;
  const float* scale;
  const float* offset;
  float* part;  // [n_rb, 2, C]: each unit's [Σgz, Σgz·xhat] over its rows
  float* red;   // [2, C]
  T* dx;
  int R, C;
  int tx;          // lanes across a unit's channels (a power of two)
  int n_ct;        // channel tiles of tx * VEC channels
  int rows, n_rb;  // rows per row block, row blocks
  int units;       // n_ct * n_rb; unit u is (row block u / n_ct, tile u % n_ct)
  int slots;       // units a block keeps on chip
  int cache_rows;  // rows of a unit kept on chip (the rest is read again)
  int act;
};

// Sums s0[k], s1[k] of the threads that share tx over the block's row lanes,
// in a fixed order: a butterfly over the row lanes of a warp, then the
// warps' totals in warp order. Thread t < 2·CT ends with out[t] (Σgz for
// t < CT, Σgz·xhat for t >= CT, channel t % CT of the tile). `scratch` is
// [groups + 1][2·CT] floats; the last row receives `out`.
template <int VEC>
__device__ __forceinline__ void bwd_block_sum(float (&s0)[VEC], float (&s1)[VEC],
                                              float* scratch, int tx, int ty, int TX) {
  const int TY = kBwdThreads<VEC> / TX;
  const int CT = TX * VEC;
  const int wy = TX < 32 ? 32 / TX : 1;  // row lanes in one warp
  const int groups = TY / wy;
  for (int off = 16; off >= TX; off >>= 1) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      s0[k] += __shfl_xor_sync(0xffffffffu, s0[k], off);
      s1[k] += __shfl_xor_sync(0xffffffffu, s1[k], off);
    }
  }
  if (ty % wy == 0) {
    float* row = scratch + (ty / wy) * 2 * CT;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      row[tx * VEC + k] = s0[k];
      row[CT + tx * VEC + k] = s1[k];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 2 * CT; t += kBwdThreads<VEC>) {
    float v = scratch[t];
#pragma unroll 8
    for (int q = 1; q < groups; ++q) v += scratch[q * 2 * CT + t];
    scratch[groups * 2 * CT + t] = v;
  }
  __syncthreads();
}

// A channel's mean, inv, sa = inv * scale (K2b's slope, so that y and its
// activation mask are the forward's) and offset.
template <typename T, int VEC>
__device__ __forceinline__ void bwd_load_params(const BwdArgs<T>& a, int c0, float (&m)[VEC],
                                                float (&iv)[VEC], float (&sa)[VEC],
                                                float (&of)[VEC]) {
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    m[q] = a.mean[c0 + q];
    iv[q] = a.inv[c0 + q];
    sa[q] = iv[q] * a.scale[c0 + q];
    of[q] = a.offset[c0 + q];
  }
}

// The end of a unit once its channels' sums are in block_red: red (by the
// block of row block 0), then dx of the unit's rows from the g and x kept
// in `slot` (rows past cache_rows read again).
template <typename T, int VEC, int UNROLL>
__device__ __forceinline__ void bwd_finish_unit(const BwdArgs<T>& a, const Pack<T, VEC>* slot,
                                                int rb, int ct, int c0, int r0, int r1, int tx,
                                                int ty, int TX, const float* block_red,
                                                const float (&m)[VEC], const float (&iv)[VEC],
                                                const float (&sa)[VEC],
                                                const float (&of)[VEC]) {
  using P = Pack<T, VEC>;
  const int TY = kBwdThreads<VEC> / TX;
  const int CT = TX * VEC;
  const int64_t C = a.C;
  if (rb == 0) {
    for (int t = threadIdx.x; t < 2 * CT; t += kBwdThreads<VEC>) {
      const int c = ct * CT + t % CT;
      if (c < a.C) a.red[(t / CT) * C + c] = block_red[t];
    }
  }
  if (c0 >= a.C) return;
  const float rows_f = float(a.R);
  // dx = (gz - Σgz/R - d·inv·Σ(gz·xhat)/R)·inv·scale, as mg and ivm below
  float mg[VEC], ivm[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    mg[q] = block_red[tx * VEC + q] / rows_f;
    ivm[q] = iv[q] * (block_red[CT + tx * VEC + q] / rows_f);
  }
  for (int r = r0 + ty; r < r1; r += TY * UNROLL) {
    P gp[UNROLL], xp[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int rr = r + j * TY;
      if (rr < r1) {
        if (rr - r0 < a.cache_rows) {
          gp[j] = slot[(rr - r0) * 2 * TX + tx];
          xp[j] = slot[(rr - r0) * 2 * TX + TX + tx];
        } else {
          gp[j] = *reinterpret_cast<const P*>(a.g + rr * C + c0);
          xp[j] = *reinterpret_cast<const P*>(a.x + rr * C + c0);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int rr = r + j * TY;
      if (rr >= r1) break;
      P out;
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const float d = to_f32(xp[j].v[q]) - m[q];
        const float gz = to_f32(gp[j].v[q]) * act_grad(d * sa[q] + of[q], a.act);
        const float v = (gz - mg[q] - d * ivm[q]) * sa[q];
        out.v[q] = from_f32<T>(v);
      }
      *reinterpret_cast<P*>(a.dx + rr * C + c0) = out;
    }
  }
}

// K2c+K2d in one cooperative launch. Phase 1: each unit (row block x channel
// tile) of the block sums gz and gz·xhat over its rows per thread, keeping
// the g and x it reads in shared memory, and writes the unit's sums. One
// grid-wide barrier. Phase 2: the block, which has one unit here, merges the
// unit's channel tile over all row blocks in row-block order (every block
// of that tile merges the same partials in the same order, so all get the
// same bits) and writes dx from the g and x it kept (rows past cache_rows
// are read again, from L2 where they still are). Where the plan has one
// row block (n_rb == 1, e.g. G.BN1's [B, 4096]), a unit's sums are its
// channels' totals already: the block writes dx right after phase 1, and no
// block waits at the barrier.
template <typename T, int VEC>
__global__ void __launch_bounds__(kBwdThreads<VEC>, 1) bn_bwd_fused_kernel(const BwdArgs<T> a) {
  using P = Pack<T, VEC>;
  constexpr int UNROLL = BWD_UNROLL;
  extern __shared__ __align__(16) unsigned char smem[];
  const int TX = a.tx;
  const int TY = kBwdThreads<VEC> / TX;
  const int CT = TX * VEC;
  const int groups = TY / (TX < 32 ? 32 / TX : 1);
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  float* scratch = reinterpret_cast<float*>(smem);
  const float* block_red = scratch + groups * 2 * CT;
  P* cache = reinterpret_cast<P*>(smem + (groups + 1) * 2 * CT * sizeof(float));
  const int64_t C = a.C;

  for (int k = 0, u = blockIdx.x; u < a.units; ++k, u += gridDim.x) {
    const int ct = u % a.n_ct;
    const int rb = u / a.n_ct;
    const int c0 = ct * CT + tx * VEC;
    const int r0 = rb * a.rows;
    const int r1 = min(r0 + a.rows, a.R);
    P* slot = cache + int64_t(k) * a.cache_rows * 2 * TX;
    float s0[VEC], s1[VEC], m[VEC], iv[VEC], sa[VEC], of[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) s0[q] = s1[q] = 0.0f;
    if (c0 < a.C) {
      bwd_load_params<T, VEC>(a, c0, m, iv, sa, of);
      for (int r = r0 + ty; r < r1; r += TY * UNROLL) {
        P gp[UNROLL], xp[UNROLL];
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
          const int rr = r + j * TY;
          if (rr < r1) {
            gp[j] = *reinterpret_cast<const P*>(a.g + rr * C + c0);
            xp[j] = *reinterpret_cast<const P*>(a.x + rr * C + c0);
          }
        }
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
          const int rr = r + j * TY;
          if (rr >= r1) break;
          if (rr - r0 < a.cache_rows) {
            slot[(rr - r0) * 2 * TX + tx] = gp[j];
            slot[(rr - r0) * 2 * TX + TX + tx] = xp[j];
          }
#pragma unroll
          for (int q = 0; q < VEC; ++q) {
            const float d = to_f32(xp[j].v[q]) - m[q];
            const float gz = to_f32(gp[j].v[q]) * act_grad(d * sa[q] + of[q], a.act);
            s0[q] += gz;
            s1[q] = fmaf(gz, d * iv[q], s1[q]);
          }
        }
      }
    }
    bwd_block_sum<VEC>(s0, s1, scratch, tx, ty, TX);
    if (a.n_rb == 1) {
      bwd_finish_unit<T, VEC, UNROLL>(a, slot, rb, ct, c0, r0, r1, tx, ty, TX, block_red, m, iv,
                                      sa, of);
    } else {
      for (int t = threadIdx.x; t < 2 * CT; t += kBwdThreads<VEC>) {
        const int c = ct * CT + t % CT;
        if (c < a.C) a.part[(int64_t(rb) * 2 + t / CT) * C + c] = block_red[t];
      }
    }
    __syncthreads();  // scratch and block_red are rewritten by the next unit
  }
  if (a.n_rb == 1) return;  // the same for every block: none reaches the barrier

  cooperative_groups::this_grid().sync();

  // units <= grid here (run_bwd checks it): the block's unit is its first
  const int u = blockIdx.x;
  const int ct = u % a.n_ct;
  const int rb = u / a.n_ct;
  const int c0 = ct * CT + tx * VEC;
  const int r0 = rb * a.rows;
  const int r1 = min(r0 + a.rows, a.R);
  float s0[VEC], s1[VEC], m[VEC], iv[VEC], sa[VEC], of[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) s0[q] = s1[q] = 0.0f;
  if (c0 < a.C) {
    // issued with the partials' loads, so that both wait on one trip
    bwd_load_params<T, VEC>(a, c0, m, iv, sa, of);
    // the partials were written in this launch: read them through L2
    // (__ldcg), not the read-only path
    for (int p = ty; p < a.n_rb; p += TY) {
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        s0[q] += __ldcg(a.part + (int64_t(p) * 2) * C + c0 + q);
        s1[q] += __ldcg(a.part + (int64_t(p) * 2 + 1) * C + c0 + q);
      }
    }
  }
  bwd_block_sum<VEC>(s0, s1, scratch, tx, ty, TX);
  bwd_finish_unit<T, VEC, UNROLL>(a, cache, rb, ct, c0, r0, r1, tx, ty, TX, block_red, m, iv,
                                  sa, of);
}

// Shared memory of a launch: the block sums' scratch, then `slots` units of
// cache_rows rows of g and x. Must equal the plan's `smem`.
template <typename T, int VEC>
size_t bwd_smem(int tx, int slots, int cache_rows) {
  const int groups = (kBwdThreads<VEC> / tx) / (tx < 32 ? 32 / tx : 1);
  return size_t(groups + 1) * 2 * tx * VEC * sizeof(float) +
         size_t(slots) * cache_rows * 2 * tx * sizeof(Pack<T, VEC>);
}

// One cooperative launch of the plan's grid. Where the grid cannot be
// co-resident at this shared memory size, the launch returns
// cudaErrorCooperativeLaunchTooLarge.
template <typename T, int VEC>
int launch_bwd(BwdArgs<T> a, int grid, size_t smem, cudaStream_t st) {
  auto kern = bn_bwd_fused_kernel<T, VEC>;
  // asked at every launch, since the current device may change
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(grid),
                                  dim3(kBwdThreads<VEC>), args, smem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int run_bwd(const void* g, const void* x, const float* mean, const float* inv,
            const float* scale, const float* offset, float* part, float* red, void* dx,
            int R, int C, int tx, int rows, int n_rb, int slots, int cache_rows,
            long long smem, int grid, int act, cudaStream_t st) {
  const int CT = tx * VEC;
  const int n_ct = (C + CT - 1) / CT;
  const int units = n_ct * n_rb;
  // every block keeps its units in `slots` slots; with more than one row
  // block, phase 2 takes one unit per block
  if (tx < 1 || tx > kBwdThreads<VEC> || (tx & (tx - 1)) || int64_t(rows) * n_rb < R ||
      int64_t(rows) * (n_rb - 1) >= R || cache_rows > rows || grid < 1 || grid > units ||
      int64_t(grid) * slots < units || (n_rb > 1 && grid != units) ||
      (VEC > 1 && C % VEC) || bwd_smem<T, VEC>(tx, slots, cache_rows) != size_t(smem))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs<T> a{static_cast<const T*>(g), static_cast<const T*>(x), mean, inv, scale,
               offset, part, red, static_cast<T*>(dx), R, C, tx, n_ct, rows, n_rb,
               units, slots, cache_rows, act};
  return launch_bwd<T, VEC>(a, grid, size_t(smem), st);
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

// K2c+K2d. g and x are [R, C] in one dtype; mean, inv, scale and offset are
// [C] f32; part is [n_rb, 2, C] f32 scratch; red ([Σgz; Σgz·xhat], [2, C])
// is f32 and dx has x's dtype and shape. vec is 16 / sizeof(dtype) (C a
// multiple of it, 16-byte aligned g, x and dx) or 1; tx, rows, n_rb, slots,
// cache_rows, smem and grid come from ops/kernels/fused_norm.py:bn_bwd_plan.
// A grid that cannot be co-resident returns cudaErrorCooperativeLaunchTooLarge.
extern "C" int ggan_bn_bwd(const void* g, const void* x, const void* mean, const void* inv,
                           const void* scale, const void* offset, void* part, void* red,
                           void* dx, int dtype, int R, int C, int vec, int tx, int rows,
                           int n_rb, int slots, int cache_rows, long long smem, int grid,
                           int act, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(inv);
  const float* sc = static_cast<const float*>(scale);
  const float* of = static_cast<const float*>(offset);
  float* pt = static_cast<float*>(part);
  float* rd = static_cast<float*>(red);
  if (dtype == ggan::kFloat32 && vec == 4) {
    return ggan::run_bwd<float, 4>(g, x, m, iv, sc, of, pt, rd, dx, R, C, tx, rows, n_rb,
                                   slots, cache_rows, smem, grid, act, st);
  } else if (dtype == ggan::kFloat32 && vec == 1) {
    return ggan::run_bwd<float, 1>(g, x, m, iv, sc, of, pt, rd, dx, R, C, tx, rows, n_rb,
                                   slots, cache_rows, smem, grid, act, st);
  } else if (dtype == ggan::kBFloat16 && vec == 8) {
    return ggan::run_bwd<__nv_bfloat16, 8>(g, x, m, iv, sc, of, pt, rd, dx, R, C, tx, rows,
                                           n_rb, slots, cache_rows, smem, grid, act, st);
  } else if (dtype == ggan::kBFloat16 && vec == 1) {
    return ggan::run_bwd<__nv_bfloat16, 1>(g, x, m, iv, sc, of, pt, rd, dx, R, C, tx, rows,
                                           n_rb, slots, cache_rows, smem, grid, act, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
