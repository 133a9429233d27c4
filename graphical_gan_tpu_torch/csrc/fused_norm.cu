// K2: batch-statistics batch norm + activation over channels-last x viewed
// as [R, C] (R = product of the leading dims), f32 statistics; f32 or bf16
// in and out. Three kernels, each behind its own C entry point:
//
// K2a ggan_bn_stats: per-channel mean, biased variance and
//     inv = 1 / sqrt(var + eps), in one launch. Replaces
//     graphical_gan_tpu/ops/pallas/fused_norm.py:_stats (_stats_kernel).
// K2b ggan_bn_apply: y = act((x - mean) * (inv * scale) + offset) in x's
//     dtype. Replaces fused_norm.py:_fwd (_apply_kernel). ggan_bn_apply_q8
//     also writes y's int8 copy for the int8 layer that reads it (Q1 folded
//     into its producer: ops/quant.py), in the same pass, 1 more byte an
//     element.
// K2c+K2d ggan_bn_bwd: the whole backward in one launch. Per channel
//     red = [Σgz, Σgz·xhat] in f32, with xhat = (x - mean) * inv and
//     gz = g * act'(y), y recomputed from x as K2b computes it, and
//     dx = (gz - Σgz/R - xhat * Σ(gz·xhat)/R) * inv * scale in x's dtype.
//     Replaces both pallas_calls of fused_norm.py:_bwd (_bwd_reduce_kernel
//     and _bwd_apply_kernel).
//
// Split modes, for batch statistics over the rows of several ranks (a grid
// barrier cannot wait for another process): K2a's is ggan_bn_stats_local
// (the rank's f64 (n, mean, M2) in one thread-block-cluster launch, written
// into the rank's slot of the ranks' exchange buffer, which one all_reduce
// then fills) and ggan_bn_apply_split (K2b with the finalize, Chan's merge
// over the ranks' triples, folded in: two launches and the all_reduce for a
// BN forward); K2c+K2d's is ggan_bn_bwd_local (the rank's [Σgz, Σgz·xhat]
// in one cluster launch, into the rank's slot of a [W, 2, C] exchange
// buffer) and ggan_bn_bwd_apply_split (dx, with the ranks' sums added in
// rank order folded in): two launches and the all_reduce for a BN backward.
//
// K2a and K2c+K2d share one plan of work units (fused_norm.py:_unit_tiling,
// a function of the shape alone) and one block shape:
//   - [R, C] is cut into units (row block x channel tile): about one unit
//     per SM, channel tiles 64 bytes wide or more, so that the row blocks,
//     and with them the partials a merge reads, stay few;
//   - blocks take units in a fixed assignment (unit blockIdx.x + k * grid);
//     the grid is one block per SM (132 on the H100) or one per unit where
//     the units are fewer; where there is more than one row block, the
//     units are no more than the SMs, and a block takes one;
//   - a block has 512 threads (256 where a thread holds 8 bf16 channels); a
//     thread walks rows ty, ty + TY, ... of its unit with 16-byte loads (4
//     f32 or 8 bf16 channels; scalar where C or a pointer is not aligned
//     for that) and sums in row order;
//   - the block adds its row lanes in a fixed order (block_sum: a butterfly
//     in the warp, then the warps in order) and writes the unit's partials;
//   - one grid-wide barrier (cooperative_groups::this_grid().sync()), then a
//     merge of a channel tile's partials in row-block order. A plan with one
//     row block (G.BN1's [B, 4096]) needs no merge: the units' sums are the
//     totals, and no block waits at the barrier.
// No float atomics: every output is bit-identical from call to call and
// does not depend on the grid size.
//
// K2a design. The TPU kernel carries Σx and Σx² across its sequential grid
// in a VMEM scratch and takes var = E[x²] - mean², which cancels where the
// mean is large against the spread. Here x is read once, 64 KB of packs a
// block in flight (8 rows a thread, 16 at 256 threads), and each thread
// sums d = x - x[0, c] and d² in f64: d is exact there, and the sums keep
// about 16 digits, so Σd² - (Σd)²/n loses nothing that shows in f32 for any
// mean up to some 10^4 spreads (the shift takes the mean out first). Each
// unit's (mean, M2) of d goes to a partials buffer; after the barrier the
// block of row block 0 of each channel tile stages the tile's partials in
// shared memory and merges them per channel in row-block order with Chan's
// formula in f64, weighted by each row block's rows (the last may be
// ragged; the weights depend on the plan alone, so the block computes them
// side by side first and the chain of dependent merges holds no divide).
// mean and var are then rounded once to f32: they are the f32 roundings of
// the exact statistics up to an f64 rounding, so the bits hardly depend on
// the summation order (a two-pass f32 variance in the same kernel, and
// PyTorch's own f32 reductions, put near-zero pre-activations of mnist
// wali-gp on the other side of 0 from the CPU's; see PERF.md, PR 7). inv =
// 1 / sqrt(var + eps) in f32 from the rounded var. A block sum of f64
// values costs twice the shuffles of f32 ones; the f64 arithmetic (a
// conversion, a subtract, an add and a fused multiply-add a value) stays
// under the byte time.
//
// K2c+K2d design. The TPU runs a reduce pass and an apply pass, each
// reading g and x from HBM. Here phase 1 sums gz and gz·xhat per unit in
// f32, 4 rows in flight, keeping the g and x it reads in the unit's
// shared-memory slot (rows past the plan's cache_rows are read again,
// mostly from the 50 MB L2), and after the barrier every block merges its
// unit's channel tile (every block of a tile merges the same partials in
// the same order, so all agree to the bit, and the block of row block 0
// writes red), then writes dx from the g and x it kept.
//
// Apply is one elementwise pass; when C is a multiple of 4 each thread moves
// 4 contiguous channels with one vector load and one vector store.
//
// Bound on the H100. All three kernels do a few operations per element, far
// below the ridge, so they are bound by bytes: stats reads x once, apply
// reads x and writes y once, and the backward reads g and x once and writes
// dx once. The cifar10 shapes move 1-16 MB a call, so a launch and a
// barrier are a large part of the time; one launch per call, x or g and x
// read from HBM once, is what the shared design buys.
//
// Split forward design. A rank's rows move under 2 MB a call, so the chain
// of launches, not bytes, bounds it: the rank's statistics are one
// non-cooperative launch of thread-block clusters (up to 16 blocks over a
// channel tile's rows, merged through distributed shared memory: no grid
// barrier, no partials in device memory, attributes set once, capturable
// by a CUDA graph), and the finalize over the ranks' 3·C triples rides in
// the apply, whose blocks each merge their tile's W triples again
// (bn_apply_split_plan keeps those reads under a tenth of x's bytes).
//
// Split backward design, the same shape: the rank's sums are one cluster
// launch (bn_bwd_local_kernel: the blocks store their sums into block 0's
// shared memory through distributed shared memory once the cluster's
// blocks have all started, and block 0 adds them in block order after a
// cluster barrier), and the apply adds the W ranks' 2·C sums in rank
// order in each block before its tile's dx (bn_bwd_apply_split_plan keeps those reads
// under a tenth of g's and x's bytes). The one-launch K2c+K2d is the only
// cooperative launch of the backward, and it runs on one card alone.

#include <cooperative_groups.h>

#include <atomic>

#include "common.cuh"

namespace ggan {
namespace {

// Chan et al.: merge (mb, Mb) of nb rows into (ma, Ma) of na rows, given
// fb = nb / (na + nb) and nafb = na * fb (they depend on the plan alone, so
// they stay out of the chain of dependent merges).
__device__ __forceinline__ void chan_merge(double& ma, double& Ma, double mb, double Mb,
                                           double fb, double nafb) {
  const double d = mb - ma;
  ma = ma + d * fb;
  Ma = Ma + Mb + d * d * nafb;
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// The pre-activation y = (x - mean)·(inv·scale) + offset from d = x - mean
// and a = inv·scale, rounded after the product and again after the sum, as
// the plain versions round it, and not contracted into one FMA: at a y
// within rounding of 0 the activation's side (and in K2c+K2d its slope)
// then agrees with theirs.
__device__ __forceinline__ float pre_act(float d, float a, float offset) {
  return __fadd_rn(__fmul_rn(d, a), offset);
}

// Q8 adds K2b's int8 output: q = q8(y, qs) of each y as rounded to T, the
// value a consumer's Q1 would quantize (ops/quant.py pairs the two).
template <typename T, int VEC, bool Q8 = false>
__global__ void __launch_bounds__(256)
bn_apply_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                const float* __restrict__ inv, const float* __restrict__ scale,
                const float* __restrict__ offset, T* __restrict__ y,
                int64_t n_packs, int C, int act, int8_t* __restrict__ q = nullptr,
                float qs = 1.0f) {
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
      const float v = pre_act(to_f32(in.v[k]) - mean[c], a, offset[c]);
      out.v[k] = from_f32<T>(apply_act(v, act));
    }
    yp[i] = out;
    if constexpr (Q8) {
      Pack<int8_t, VEC> qo;
#pragma unroll
      for (int k = 0; k < VEC; ++k) qo.v[k] = q8(to_f32(out.v[k]), qs);
      reinterpret_cast<Pack<int8_t, VEC>*>(q)[i] = qo;
    }
  }
}

int apply_grid(int64_t n_packs) {
  const int64_t blocks = (n_packs + 255) / 256;
  return int(blocks < 132 * 32 ? (blocks > 0 ? blocks : 1) : 132 * 32);
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

template <typename T, int VEC>
void launch_apply_q8(const void* x, const float* mean, const float* inv, const float* scale,
                     const float* offset, void* y, void* q, float qs, int64_t numel, int C,
                     int act, cudaStream_t st) {
  const int64_t n_packs = numel / VEC;
  bn_apply_kernel<T, VEC, true><<<apply_grid(n_packs), 256, 0, st>>>(
      static_cast<const T*>(x), mean, inv, scale, offset, static_cast<T*>(y), n_packs, C,
      act, static_cast<int8_t*>(q), qs);
}

// d act(u)/du at the forward's pre-activation y: relu 1 or 0, leaky 1 or 0.2
// (y > 0 picks the slope, as fused_norm.py:_act_grad does).
__device__ __forceinline__ float act_grad(float y, int act) {
  if (act == kActRelu) return y > 0.0f ? 1.0f : 0.0f;
  if (act == kActLeaky) return y > 0.0f ? 1.0f : 0.2f;
  return 1.0f;
}

// threads per block of K2a and K2c+K2d (ops/kernels/fused_norm.py:
// _unit_tiling): 256 where a thread holds 8 bf16 channels, 512 otherwise (at
// 512 a thread has at most 128 registers, and the backward's 8 channels'
// sums, statistics and packs spill there)
template <int VEC>
constexpr int kThreads = VEC > 4 ? 256 : 512;
constexpr int BWD_UNROLL = 4;  // rows a K2c+K2d thread has in flight per step
// and a K2a thread, which loads x alone: 64 KB of packs a block at 16 bytes
// a pack (8 rows at 512 threads, 16 at 256)
template <int VEC>
constexpr int STATS_UNROLL = VEC > 4 ? 16 : 8;
constexpr int STAGE_LOADS = 16;  // partials a K2a thread stages per trip

// Row lanes in one warp for TX lanes across a channel tile.
__host__ __device__ constexpr int warp_rows(int tx) { return tx < 32 ? 32 / tx : 1; }

// Sums s[j][k] of the threads that share tx over the block's row lanes, in
// a fixed order: a butterfly over the row lanes of a warp, then the warps'
// totals in warp order. Afterwards value j of channel k of the tile is at
// total[j·CT + k], where total is the last row of `scratch`
// ([groups + 1][NS·CT] values; f32 in K2c+K2d, f64 in K2a).
template <int VEC, int NS, typename A>
__device__ __forceinline__ void block_sum(A (&s)[NS][VEC], A* scratch, int tx, int ty, int TX) {
  const int TY = kThreads<VEC> / TX;
  const int CT = TX * VEC;
  const int wy = warp_rows(TX);
  const int groups = TY / wy;
  for (int off = 16; off >= TX; off >>= 1) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) s[j][k] += __shfl_xor_sync(0xffffffffu, s[j][k], off);
    }
  }
  if (ty % wy == 0) {
    A* row = scratch + (ty / wy) * NS * CT;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) row[j * CT + tx * VEC + k] = s[j][k];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < NS * CT; t += kThreads<VEC>) {
    A v = scratch[t];
#pragma unroll 8
    for (int q = 1; q < groups; ++q) v += scratch[q * NS * CT + t];
    scratch[groups * NS * CT + t] = v;
  }
  __syncthreads();
}

// Launches a kernel of the shared plan as one cooperative launch, through
// cudaLaunchKernelEx with the cooperative attribute, which stream capture
// takes into a CUDA graph (the trainer's step graph, train/graph.py). Where
// the grid cannot be co-resident at this shared memory size, the launch
// returns cudaErrorCooperativeLaunchTooLarge.
template <typename Args>
int launch_cooperative(void (*kern)(Args), Args a, int grid, int threads, size_t smem,
                       cudaStream_t st) {
  // asked at every launch, since the current device may change
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(grid));
  cfg.blockDim = dim3(unsigned(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The plan's numbers that the kernels' C entry points check: rows and n_rb
// cover R with no empty row block, the grid takes every unit, and with more
// than one row block each block takes one unit.
template <int VEC>
bool plan_ok(int R, int C, int tx, int rows, int n_rb, int cache_rows, int grid, int units) {
  return tx >= 1 && tx <= kThreads<VEC> && !(tx & (tx - 1)) && rows >= 1 &&
         int64_t(rows) * n_rb >= R && int64_t(rows) * (n_rb - 1) < R && cache_rows >= 0 &&
         cache_rows <= rows && grid >= 1 && grid <= units && (n_rb == 1 || grid == units) &&
         !(VEC > 1 && C % VEC);
}

// ---------------------------------------------------------------------------
// K2a

// The kernel's tensors and the plan of ops/kernels/fused_norm.py:bn_stats_plan.
template <typename T>
struct StatsArgs {
  const T* x;
  double* part;  // [n_rb, 2, C]: each unit's (mean, M2) of x - x[0, c]
  float* out;    // [3, C]: mean, var, inv
  int R, C;
  int tx;          // lanes across a unit's channels (a power of two)
  int n_ct;        // channel tiles of tx * VEC channels
  int rows, n_rb;  // rows per row block, row blocks
  int units;       // n_ct * n_rb; unit u is (row block u / n_ct, tile u % n_ct)
  float eps;
};

// Shared memory of a K2a launch: the block sum's scratch (two f64 values a
// channel) and, where there is more than one row block, the staged
// partials of one channel tile and the merge's weights. Must equal
// bn_stats_plan's `smem`.
template <int VEC>
size_t stats_smem(int tx, int n_rb) {
  const int ct = tx * VEC;
  const int groups = (kThreads<VEC> / tx) / warp_rows(tx);
  return (size_t(groups + 1) * 2 * ct + (n_rb > 1 ? size_t(n_rb) * 2 * (ct + 1) : 0)) *
         sizeof(double);
}

// mean, var and inv of channel c from the shift (x[0, c]), the mean of
// x - shift and M2 over all R rows, each rounded once to f32; inv in f32
// from the rounded var.
__device__ __forceinline__ void stats_write(float* out, int64_t C, int c, int R, double shift,
                                            double mean_d, double m2, float eps) {
  const float var = float(m2 / double(R));
  out[c] = float(shift + mean_d);
  out[C + c] = var;
  out[2 * C + c] = 1.0f / sqrtf(var + eps);
}

// Phase 1 of a K2a unit, per thread: the shift x[0, c] of its VEC channels
// from c0 and, over rows r0 + ty, r0 + ty + TY, ... below r1 in row order,
// s[0] = Σd and s[1] = Σd² of d = x - shift in f64 (d is exact there), U
// rows' loads in flight. A thread whose channels lie past C sums nothing.
template <typename T, int VEC>
__device__ __forceinline__ void stats_rows(const T* __restrict__ x, int64_t C, int c0, int r0,
                                           int r1, int ty, int TY, double (&s)[2][VEC],
                                           double (&shift)[VEC]) {
  using P = Pack<T, VEC>;
  constexpr int U = STATS_UNROLL<VEC>;
#pragma unroll
  for (int q = 0; q < VEC; ++q) s[0][q] = s[1][q] = shift[q] = 0.0;
  if (c0 >= C) return;
  const P first = *reinterpret_cast<const P*>(x + c0);
#pragma unroll
  for (int q = 0; q < VEC; ++q) shift[q] = to_f32(first.v[q]);
  for (int r = r0 + ty; r < r1; r += TY * U) {
    P xp[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int rr = r + j * TY;
      if (rr < r1) xp[j] = *reinterpret_cast<const P*>(x + rr * C + c0);
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (r + j * TY >= r1) break;
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const double d = double(to_f32(xp[j].v[q])) - shift[q];
        s[0][q] += d;
        s[1][q] = fma(d, d, s[1][q]);
      }
    }
  }
}

// K2a in one cooperative launch. Phase 1, per unit of the block: each
// thread sums d = x - x[0, c] and d² over its rows in row order, in f64 (d
// is exact there); a block sum gives the unit's n, Σd, Σd², and so its
// (mean, M2) of d, written to `part` (or, with one row block, mean, var and
// inv to `out`). One grid-wide barrier. Phase 2: the block of row block 0
// of each channel tile merges the tile's partials in row-block order
// (Chan's formula, in f64) and writes mean, var and inv.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads<VEC>, 1) bn_stats_fused_kernel(const StatsArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int TX = a.tx;
  const int TY = kThreads<VEC> / TX;
  const int CT = TX * VEC;
  const int groups = TY / warp_rows(TX);
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  double* scratch = reinterpret_cast<double*>(smem);
  const double* total = scratch + groups * 2 * CT;
  // where n_rb > 1: [n_rb][2][CT] partials, then [n_rb][2] weights
  double* staged = scratch + (groups + 1) * 2 * CT;
  double* weights = staged + a.n_rb * 2 * CT;
  const int64_t C = a.C;

  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    const int ct = u % a.n_ct;
    const int rb = u / a.n_ct;
    const int c0 = ct * CT + tx * VEC;
    const int r0 = rb * a.rows;
    const int r1 = min(r0 + a.rows, a.R);
    double s[2][VEC], shift[VEC];
    stats_rows<T, VEC>(a.x, C, c0, r0, r1, ty, TY, s, shift);
    block_sum<VEC, 2>(s, scratch, tx, ty, TX);
    if (ty == 0 && c0 < a.C) {
      const double n_u = double(r1 - r0);
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const double sd = total[tx * VEC + q];
        const double mean_d = sd / n_u;
        const double m2 = fmax(total[CT + tx * VEC + q] - sd * mean_d, 0.0);
        if (a.n_rb == 1) {
          stats_write(a.out, C, c0 + q, a.R, shift[q], mean_d, m2, a.eps);
        } else {
          a.part[int64_t(rb) * 2 * C + c0 + q] = mean_d;
          a.part[(int64_t(rb) * 2 + 1) * C + c0 + q] = m2;
        }
      }
    }
    // the next unit's block sum overwrites `total` only after a barrier
    // that the writers above reach once they are done
  }
  if (a.n_rb == 1) return;  // the same for every block: none reaches the barrier

  cooperative_groups::this_grid().sync();

  // units == grid here (run_stats checks it): the block's unit is
  // blockIdx.x, and the blocks of row block 0 (units 0 .. n_ct - 1) merge
  const int ct = blockIdx.x;
  if (ct >= a.n_ct) return;
  // the partials were written in this launch: read them through L2
  // (__ldcg), not the read-only path, coalesced across channels, STAGE_LOADS
  // a thread in flight. The block's threads are a multiple of CT here
  // (run_stats checks it): thread t stages channel t % CT of rows
  // t / CT, t / CT + dq, ... of the [2 n_rb][CT] partials.
  {
    const int k = threadIdx.x % CT;
    const int dq = kThreads<VEC> / CT;
    const int c = ct * CT + k;
    for (int q0 = threadIdx.x / CT; q0 < 2 * a.n_rb; q0 += dq * STAGE_LOADS) {
      double v[STAGE_LOADS];
#pragma unroll
      for (int j = 0; j < STAGE_LOADS; ++j) {
        const int q = q0 + j * dq;
        v[j] = q < 2 * a.n_rb && c < a.C ? __ldcg(a.part + int64_t(q) * C + c) : 0.0;
      }
#pragma unroll
      for (int j = 0; j < STAGE_LOADS; ++j) {
        const int q = q0 + j * dq;
        if (q < 2 * a.n_rb) staged[q * CT + k] = v[j];
      }
    }
  }
  // row block p merges its rows (nb, the last row block's may be ragged)
  // into the p * rows before it
  for (int p = threadIdx.x; p < a.n_rb; p += kThreads<VEC>) {
    const double na = double(p) * a.rows;
    const double nb = double(min(a.rows, a.R - p * a.rows));
    const double fb = nb / (na + nb);
    weights[2 * p] = fb;
    weights[2 * p + 1] = na * fb;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < CT; k += kThreads<VEC>) {
    const int c = ct * CT + k;
    if (c >= a.C) break;
    double mean_d = staged[k], m2 = staged[CT + k];
#pragma unroll 8
    for (int p = 1; p < a.n_rb; ++p) {
      chan_merge(mean_d, m2, staged[p * 2 * CT + k], staged[(p * 2 + 1) * CT + k],
                 weights[2 * p], weights[2 * p + 1]);
    }
    stats_write(a.out, C, c, a.R, to_f32(a.x[c]), mean_d, m2, a.eps);
  }
}

// ---------------------------------------------------------------------------
// K2a's split mode: the rank's statistics (bn_stats_local_kernel) and the
// finalize folded into a split-mode K2b (bn_apply_split_kernel)

// Chan's merge of the ranks' (n, mean, M2) of channel c in rank order, [W,
// 3, C] f64: rank r's rows merge into the rows of the ranks before it
// (the weights of chan_merge from the counts); mean and var rounded once
// to f32 and inv = 1 / sqrt(var + eps) in f32 from the rounded var, as
// stats_write rounds them.
__device__ __forceinline__ void merge_ranks(const double* __restrict__ parts, int64_t C, int c,
                                            int W, float eps, float& mean_f, float& var_f,
                                            float& inv_f) {
  const int64_t stride = 3 * C;
  double n = parts[c], mean = parts[C + c], m2 = parts[2 * C + c];
#pragma unroll 4
  for (int r = 1; r < W; ++r) {
    const double nb = parts[r * stride + c];
    const double tot = n + nb;
    const double fb = nb / tot;
    chan_merge(mean, m2, parts[r * stride + C + c], parts[r * stride + 2 * C + c], fb, n * fb);
    n = tot;
  }
  var_f = float(m2 / n);
  mean_f = float(mean);
  inv_f = 1.0f / sqrtf(var_f + eps);
}

constexpr int kMaxCluster = 16;  // blocks of a cluster, with the non-portable size allowed

// The rank's statistics of one channel tile in one thread-block cluster:
// cluster block p sums rows [p·rows, (p+1)·rows) of the tile as a K2a unit
// does (stats_rows, block_sum) and keeps its (mean, M2) of d = x - x[0, c]
// in its shared memory; after cluster.sync() block 0 copies the others'
// through distributed shared memory into its own, all at once, and after a
// second cluster.sync() (every block's shared memory stays until block 0
// has read it) merges them per channel in block order by Chan's formula
// in f64 (the weights from the plan alone), then writes the rank's
// unshifted (n, mean, M2) into slot `index` of the [W, 3, C] f64 exchange
// buffer and zeros into the other slots, so that an all_reduce(SUM) of the
// buffer is the ranks' triples stacked (x + 0 is exact). No grid barrier,
// no partials in device memory.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads<VEC>, 1)
bn_stats_local_kernel(const T* __restrict__ x, double* __restrict__ out, int R, int C, int tx,
                      int rows, int index, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int TY = kThreads<VEC> / tx;
  const int CT = tx * VEC;
  const int groups = TY / warp_rows(tx);
  const int lane = threadIdx.x % tx;
  const int ty = threadIdx.x / tx;
  const int n_blocks = int(cluster.num_blocks());
  double* scratch = reinterpret_cast<double*>(smem);
  const double* total = scratch + groups * 2 * CT;
  // [n_blocks][2][CT]: row 0 this block's (mean, M2) of d; in block 0 the
  // others' copied in after the first cluster.sync()
  double* staged = scratch + (groups + 1) * 2 * CT;
  double* shift_s = staged + n_blocks * 2 * CT;  // [CT]: x[0, c]
  double* weights = shift_s + CT;                // [n_blocks][2]
  const int64_t C64 = C;
  const int p = int(cluster.block_rank());
  const int ct = blockIdx.x / n_blocks;
  const int c0 = ct * CT + lane * VEC;
  const int r0 = p * rows;
  const int r1 = min(r0 + rows, R);
  double s[2][VEC], shift[VEC];
  stats_rows<T, VEC>(x, C64, c0, r0, r1, ty, TY, s, shift);
  block_sum<VEC, 2>(s, scratch, lane, ty, tx);
  if (ty == 0 && c0 < C) {
    const double n_p = double(r1 - r0);
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      const int k = lane * VEC + q;
      const double sd = total[k];
      const double mean_d = sd / n_p;
      staged[k] = mean_d;
      staged[CT + k] = fmax(total[CT + k] - sd * mean_d, 0.0);
      shift_s[k] = shift[q];
    }
  }
  if (p == 0) {
    for (int b = threadIdx.x; b < n_blocks; b += kThreads<VEC>) {
      const double na = double(b) * rows;
      const double nb = double(min(rows, R - b * rows));
      const double fb = nb / (na + nb);
      weights[2 * b] = fb;
      weights[2 * b + 1] = na * fb;
    }
  }
  cluster.sync();
  if (p == 0) {
    for (int t = threadIdx.x; t < (n_blocks - 1) * 2 * CT; t += kThreads<VEC>) {
      const int b = 1 + t / (2 * CT);
      staged[b * 2 * CT + t % (2 * CT)] = cluster.map_shared_rank(staged, b)[t % (2 * CT)];
    }
  }
  cluster.sync();
  if (p != 0) return;
  for (int k = threadIdx.x; k < CT; k += kThreads<VEC>) {
    const int c = ct * CT + k;
    if (c >= C) break;
    double mean_d = staged[k], m2 = staged[CT + k];
    for (int b = 1; b < n_blocks; ++b) {
      chan_merge(mean_d, m2, staged[b * 2 * CT + k], staged[(b * 2 + 1) * CT + k],
                 weights[2 * b], weights[2 * b + 1]);
    }
    const double mean = shift_s[k] + mean_d;
    for (int w = 0; w < W; ++w) {
      double* slot = out + int64_t(w) * 3 * C64;
      const bool own = w == index;
      slot[c] = own ? double(R) : 0.0;
      slot[C64 + c] = own ? mean : 0.0;
      slot[2 * C64 + c] = own ? m2 : 0.0;
    }
  }
}

// Shared memory of a bn_stats_local launch: the block sum's scratch (two f64
// values a channel), the cluster's (mean, M2) of the tile, the shift and
// the merge's weights. Must equal ops/kernels/fused_norm.py:
// bn_stats_local_plan's `smem`.
template <int VEC>
size_t local_smem(int tx, int cluster) {
  const size_t ct = size_t(tx) * VEC;
  const size_t groups = (kThreads<VEC> / tx) / warp_rows(tx);
  return ((groups + 1) * 2 * ct + size_t(cluster) * 2 * ct + ct + 2 * size_t(cluster)) *
         sizeof(double);
}

// A kernel's function attributes, set once per device: the opt-in shared
// memory up to the H100's 227 KB a block and, for the cluster kernel, the
// non-portable cluster size 16. A race between two first launches sets them
// twice, which is harmless.
constexpr int kMaxDevices = 64;
template <typename K>
int configure_once(K kern, std::atomic<bool> (&done)[kMaxDevices], bool cluster16) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (done[dev].load(std::memory_order_acquire)) return 0;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (e == cudaSuccess && cluster16)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  done[dev].store(true, std::memory_order_release);
  return 0;
}

// The two halves of a cluster barrier, for a phase that orders no memory
// (cluster.sync() is both halves with release and acquire): every thread
// of the cluster arrives once, then waits until all the others have.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Launches a kernel of thread-block clusters of `cluster` blocks along x
// (a block alone is a cluster of one) through cudaLaunchKernelEx, not
// cooperatively.
template <typename... Params, typename... Args>
int launch_clusters(void (*kern)(Params...), int grid, int threads, int cluster, size_t smem,
                    cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(grid));
  cfg.blockDim = dim3(unsigned(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int run_stats_local(const void* x, double* out, int R, int C, int tx, int rows, int cluster,
                    long long smem, int index, int W, cudaStream_t st) {
  const int n_ct = (C + tx * VEC - 1) / (tx * VEC);
  if (tx < 1 || tx > kThreads<VEC> || (tx & (tx - 1)) || rows < 1 || cluster < 1 ||
      cluster > kMaxCluster || int64_t(rows) * cluster < R ||
      int64_t(rows) * (cluster - 1) >= R || W < 1 || index < 0 || index >= W ||
      (VEC > 1 && C % VEC) || local_smem<VEC>(tx, cluster) != size_t(smem))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = bn_stats_local_kernel<T, VEC>;
  static std::atomic<bool> done[kMaxDevices];
  const int code = configure_once(kern, done, true);
  if (code) return code;
  return launch_clusters(kern, n_ct * cluster, kThreads<VEC>, cluster, size_t(smem), st,
                         static_cast<const T*>(x), out, R, C, tx, rows, index, W);
}

constexpr int APPLY_UNROLL = 4;  // rows a bn_apply_split thread has in flight

// K2b in the split mode, with K2a's finalize folded in: block (tile,
// row range) merges its tile's channels over the W ranks' triples
// (merge_ranks) into shared memory, the blocks of row range 0 write the
// [3, C] f32 (mean, var, inv) the backward saves, and then every block
// applies to its rows as bn_apply_kernel does, with the same roundings
// (inv·scale, x - mean, pre_act), so y is K2b's at those statistics to the
// bit; Q8 adds the int8 copy as bn_apply_kernel<T, VEC, true> writes it.
// Blocks have 256 threads: tx lanes of VEC channels across the tile, the
// rest row lanes. A thread's first APPLY_UNROLL rows of x are loaded
// before the merge, so the triples' trip and x's overlap.
template <typename T, int VEC, bool Q8>
__global__ void __launch_bounds__(256)
bn_apply_split_kernel(const T* __restrict__ x, const double* __restrict__ parts,
                      const float* __restrict__ scale, const float* __restrict__ offset,
                      T* __restrict__ y, float* __restrict__ stats, int R, int C, int W, int tx,
                      int rows, float eps, int act, int8_t* __restrict__ q, float qs) {
  using P = Pack<T, VEC>;
  constexpr int U = APPLY_UNROLL;
  extern __shared__ __align__(16) unsigned char smem[];
  const int CT = tx * VEC;
  const int TY = 256 / tx;
  float* s_mean = reinterpret_cast<float*>(smem);  // [CT] each
  float* s_a = s_mean + CT;                        // inv·scale
  float* s_off = s_a + CT;
  const int ct = blockIdx.x;
  const int64_t C64 = C;
  const int k0 = (threadIdx.x % tx) * VEC;
  const int c0 = ct * CT + k0;
  const int r0 = blockIdx.y * rows;
  const int r1 = min(r0 + rows, R);
  const int rs = r0 + int(threadIdx.x / tx);
  P xp[U];
  if (c0 < C) {
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int rr = rs + j * TY;
      if (rr < r1) xp[j] = *reinterpret_cast<const P*>(x + int64_t(rr) * C64 + c0);
    }
  }
  for (int k = threadIdx.x; k < CT; k += 256) {
    const int c = ct * CT + k;
    if (c >= C) break;
    float mean, var, inv;
    merge_ranks(parts, C64, c, W, eps, mean, var, inv);
    s_mean[k] = mean;
    s_a[k] = inv * scale[c];
    s_off[k] = offset[c];
    if (blockIdx.y == 0) {
      stats[c] = mean;
      stats[C64 + c] = var;
      stats[2 * C64 + c] = inv;
    }
  }
  __syncthreads();
  if (c0 >= C) return;
  for (int r = rs; r < r1; r += U * TY) {
    if (r != rs) {
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int rr = r + j * TY;
        if (rr < r1) xp[j] = *reinterpret_cast<const P*>(x + int64_t(rr) * C64 + c0);
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int rr = r + j * TY;
      if (rr >= r1) break;
      const int64_t i = int64_t(rr) * C64 + c0;
      P out;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float v =
            pre_act(to_f32(xp[j].v[k]) - s_mean[k0 + k], s_a[k0 + k], s_off[k0 + k]);
        out.v[k] = from_f32<T>(apply_act(v, act));
      }
      *reinterpret_cast<P*>(y + i) = out;
      if constexpr (Q8) {
        Pack<int8_t, VEC> qo;
#pragma unroll
        for (int k = 0; k < VEC; ++k) qo.v[k] = q8(to_f32(out.v[k]), qs);
        *reinterpret_cast<Pack<int8_t, VEC>*>(q + i) = qo;
      }
    }
  }
}

template <typename T, int VEC, bool Q8>
int run_apply_split(const void* x, const double* parts, const float* scale,
                    const float* offset, void* y, float* stats, void* q, float qs, int R, int C,
                    int W, int tx, int rows, int n_rr, long long smem, float eps, int act,
                    cudaStream_t st) {
  const int CT = tx * VEC;
  if (tx < 1 || tx > 256 || (tx & (tx - 1)) || rows < 1 || n_rr < 1 || n_rr > 65535 ||
      int64_t(rows) * n_rr < R || int64_t(rows) * (n_rr - 1) >= R || W < 1 ||
      (VEC > 1 && C % VEC) || size_t(smem) != 3 * size_t(CT) * sizeof(float) ||
      (Q8 && q == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((C + CT - 1) / CT, n_rr);
  bn_apply_split_kernel<T, VEC, Q8><<<grid, 256, size_t(smem), st>>>(
      static_cast<const T*>(x), parts, scale, offset, static_cast<T*>(y), stats, R, C, W, tx,
      rows, eps, act, static_cast<int8_t*>(q), qs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int run_stats(const void* x, double* part, float* out, int R, int C, int tx, int rows,
              int n_rb, long long smem, int grid, float eps, cudaStream_t st) {
  const int n_ct = (C + tx * VEC - 1) / (tx * VEC);
  const int units = n_ct * n_rb;
  // the merge stages a channel tile's partials with threads that keep one
  // channel each
  if (!plan_ok<VEC>(R, C, tx, rows, n_rb, 0, grid, units) ||
      (n_rb > 1 && kThreads<VEC> % (tx * VEC)) || stats_smem<VEC>(tx, n_rb) != size_t(smem))
    return static_cast<int>(cudaErrorInvalidValue);
  StatsArgs<T> a{static_cast<const T*>(x), part, out, R, C, tx, n_ct, rows, n_rb, units, eps};
  return launch_cooperative(bn_stats_fused_kernel<T, VEC>, a, grid, kThreads<VEC>, size_t(smem),
                            st);
}

// ---------------------------------------------------------------------------
// K2c+K2d

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
  const int TY = kThreads<VEC> / TX;
  const int CT = TX * VEC;
  const int64_t C = a.C;
  if (rb == 0) {
    for (int t = threadIdx.x; t < 2 * CT; t += kThreads<VEC>) {
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
        const float gz = to_f32(gp[j].v[q]) * act_grad(pre_act(d, sa[q], of[q]), a.act);
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
__global__ void __launch_bounds__(kThreads<VEC>, 1) bn_bwd_fused_kernel(const BwdArgs<T> a) {
  using P = Pack<T, VEC>;
  constexpr int UNROLL = BWD_UNROLL;
  extern __shared__ __align__(16) unsigned char smem[];
  const int TX = a.tx;
  const int TY = kThreads<VEC> / TX;
  const int CT = TX * VEC;
  const int groups = TY / warp_rows(TX);
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
    float s[2][VEC], m[VEC], iv[VEC], sa[VEC], of[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) s[0][q] = s[1][q] = 0.0f;
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
            const float gz = to_f32(gp[j].v[q]) * act_grad(pre_act(d, sa[q], of[q]), a.act);
            s[0][q] += gz;
            s[1][q] = fmaf(gz, d * iv[q], s[1][q]);
          }
        }
      }
    }
    block_sum<VEC, 2>(s, scratch, tx, ty, TX);
    if (a.n_rb == 1) {
      bwd_finish_unit<T, VEC, UNROLL>(a, slot, rb, ct, c0, r0, r1, tx, ty, TX, block_red, m,
                                      iv, sa, of);
    } else {
      for (int t = threadIdx.x; t < 2 * CT; t += kThreads<VEC>) {
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
  float s[2][VEC], m[VEC], iv[VEC], sa[VEC], of[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) s[0][q] = s[1][q] = 0.0f;
  if (c0 < a.C) {
    // issued with the partials' loads, so that both wait on one trip
    bwd_load_params<T, VEC>(a, c0, m, iv, sa, of);
    // the partials were written in this launch: read them through L2
    // (__ldcg), not the read-only path
    for (int p = ty; p < a.n_rb; p += TY) {
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        s[0][q] += __ldcg(a.part + (int64_t(p) * 2) * C + c0 + q);
        s[1][q] += __ldcg(a.part + (int64_t(p) * 2 + 1) * C + c0 + q);
      }
    }
  }
  block_sum<VEC, 2>(s, scratch, tx, ty, TX);
  bwd_finish_unit<T, VEC, UNROLL>(a, cache, rb, ct, c0, r0, r1, tx, ty, TX, block_red, m, iv,
                                  sa, of);
}

// Shared memory of a K2c+K2d launch: the block sums' scratch, then `slots`
// units of cache_rows rows of g and x. Must equal bn_bwd_plan's `smem`.
template <typename T, int VEC>
size_t bwd_smem(int tx, int slots, int cache_rows) {
  const int groups = (kThreads<VEC> / tx) / warp_rows(tx);
  return size_t(groups + 1) * 2 * tx * VEC * sizeof(float) +
         size_t(slots) * cache_rows * 2 * tx * sizeof(Pack<T, VEC>);
}

template <typename T, int VEC>
int run_bwd(const void* g, const void* x, const float* mean, const float* inv,
            const float* scale, const float* offset, float* part, float* red, void* dx,
            int R, int C, int tx, int rows, int n_rb, int slots, int cache_rows,
            long long smem, int grid, int act, cudaStream_t st) {
  const int CT = tx * VEC;
  const int n_ct = (C + CT - 1) / CT;
  const int units = n_ct * n_rb;
  // every block keeps its units in `slots` slots
  if (!plan_ok<VEC>(R, C, tx, rows, n_rb, cache_rows, grid, units) ||
      int64_t(grid) * slots < units || bwd_smem<T, VEC>(tx, slots, cache_rows) != size_t(smem))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs<T> a{static_cast<const T*>(g), static_cast<const T*>(x), mean, inv, scale,
               offset, part, red, static_cast<T*>(dx), R, C, tx, n_ct, rows, n_rb,
               units, slots, cache_rows, act};
  return launch_cooperative(bn_bwd_fused_kernel<T, VEC>, a, grid, kThreads<VEC>, size_t(smem),
                            st);
}

// ---------------------------------------------------------------------------
// K2c+K2d's split mode: the rank's sums (bn_bwd_local_kernel) and dx with
// the ranks' sums added in rank order folded in (bn_bwd_apply_split_kernel)

// The rank's [Σgz, Σgz·xhat] of one channel tile in one thread-block
// cluster: cluster block p sums rows [p·rows, (p+1)·rows) of the tile per
// thread in row order, with the one-launch kernel's arithmetic (gz =
// g·act'(pre_act(d, inv·scale, offset)), Σgz·xhat as fmaf(gz, d·inv, ·)),
// BWD_UNROLL rows' loads of g and x in flight, then a block_sum; each
// block but 0 stores its sums into its row of block 0's shared memory
// through distributed shared memory; after one cluster.sync() (its release
// and acquire order those stores before block 0's reads) the other blocks
// are done, and block 0 adds their sums to its own in block order and
// writes the rank's [2, C] into slot `index` of the [W, 2, C] f32 exchange
// buffer and zeros into the other slots, so that an all_reduce(SUM) of the
// buffer is the ranks' sums stacked (x + 0 is exact). Distributed shared
// memory may be touched only once every block of the cluster has started
// and only until its owner exits: every thread arrives on the cluster
// barrier at entry and waits on it just before the stores (the wait
// overlaps the row loop), and block 0 reads after the cluster.sync() that
// the others pass before they exit. No grid barrier, no partials in device
// memory.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads<VEC>, 1)
bn_bwd_local_kernel(const T* __restrict__ g, const T* __restrict__ x,
                    const float* __restrict__ mean, const float* __restrict__ inv,
                    const float* __restrict__ scale, const float* __restrict__ offset,
                    float* __restrict__ out, int R, int C, int tx, int rows, int act, int index,
                    int W) {
  using P = Pack<T, VEC>;
  constexpr int UNROLL = BWD_UNROLL;
  extern __shared__ __align__(16) unsigned char smem[];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster_arrive_relaxed();  // this block has started: waited on before the stores
  const int TY = kThreads<VEC> / tx;
  const int CT = tx * VEC;
  const int groups = TY / warp_rows(tx);
  const int lane = threadIdx.x % tx;
  const int ty = threadIdx.x / tx;
  const int n_blocks = int(cluster.num_blocks());
  float* scratch = reinterpret_cast<float*>(smem);
  float* block_red = scratch + groups * 2 * CT;  // [2][CT]: the block's sums
  // in block 0: [n_blocks][2][CT], block b's sums in row b (row 0 unused)
  float* gathered = block_red + 2 * CT;
  const int64_t C64 = C;
  const int p = int(cluster.block_rank());
  const int ct = blockIdx.x / n_blocks;
  const int c0 = ct * CT + lane * VEC;
  const int r0 = p * rows;
  const int r1 = min(r0 + rows, R);
  float s[2][VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) s[0][q] = s[1][q] = 0.0f;
  if (c0 < C) {
    float m[VEC], iv[VEC], sa[VEC], of[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      m[q] = mean[c0 + q];
      iv[q] = inv[c0 + q];
      sa[q] = iv[q] * scale[c0 + q];
      of[q] = offset[c0 + q];
    }
    for (int r = r0 + ty; r < r1; r += TY * UNROLL) {
      P gp[UNROLL], xp[UNROLL];
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        const int rr = r + j * TY;
        if (rr < r1) {
          gp[j] = *reinterpret_cast<const P*>(g + rr * C64 + c0);
          xp[j] = *reinterpret_cast<const P*>(x + rr * C64 + c0);
        }
      }
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        if (r + j * TY >= r1) break;
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          const float d = to_f32(xp[j].v[q]) - m[q];
          const float gz = to_f32(gp[j].v[q]) * act_grad(pre_act(d, sa[q], of[q]), act);
          s[0][q] += gz;
          s[1][q] = fmaf(gz, d * iv[q], s[1][q]);
        }
      }
    }
  }
  block_sum<VEC, 2>(s, scratch, lane, ty, tx);
  cluster_wait();  // every block of the cluster has started
  if (p != 0) {
    float* row = cluster.map_shared_rank(gathered, 0) + p * 2 * CT;
    for (int t = threadIdx.x; t < 2 * CT; t += kThreads<VEC>) row[t] = block_red[t];
  }
  cluster.sync();
  if (p != 0) return;
  for (int t = threadIdx.x; t < 2 * CT; t += kThreads<VEC>) {
    const int c = ct * CT + t % CT;
    if (c >= C) continue;
    float v = block_red[t];
    for (int b = 1; b < n_blocks; ++b) v += gathered[b * 2 * CT + t];
    float* dst = out + int64_t(t / CT) * C64 + c;
    for (int w = 0; w < W; ++w) dst[int64_t(w) * 2 * C64] = w == index ? v : 0.0f;
  }
}

// Shared memory of a bn_bwd_local launch: the block sum's scratch (two f32
// values a channel) and the cluster's sums of the tile (block 0 gathers the
// others'). Must equal ops/kernels/fused_norm.py: bn_bwd_local_plan's
// `smem`.
template <int VEC>
size_t bwd_local_smem(int tx, int cluster) {
  const size_t groups = (kThreads<VEC> / tx) / warp_rows(tx);
  return (groups + 1 + size_t(cluster)) * 2 * size_t(tx) * VEC * sizeof(float);
}

template <typename T, int VEC>
int run_bwd_local(const void* g, const void* x, const float* mean, const float* inv,
                  const float* scale, const float* offset, float* out, int R, int C, int tx,
                  int rows, int cluster, long long smem, int act, int index, int W,
                  cudaStream_t st) {
  const int n_ct = (C + tx * VEC - 1) / (tx * VEC);
  if (tx < 1 || tx > kThreads<VEC> || (tx & (tx - 1)) || rows < 1 || cluster < 1 ||
      cluster > kMaxCluster || int64_t(rows) * cluster < R ||
      int64_t(rows) * (cluster - 1) >= R || W < 1 || index < 0 || index >= W ||
      (VEC > 1 && C % VEC) || bwd_local_smem<VEC>(tx, cluster) != size_t(smem))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = bn_bwd_local_kernel<T, VEC>;
  static std::atomic<bool> done[kMaxDevices];
  const int code = configure_once(kern, done, true);
  if (code) return code;
  return launch_clusters(kern, n_ct * cluster, kThreads<VEC>, cluster, size_t(smem), st,
                         static_cast<const T*>(g), static_cast<const T*>(x), mean, inv, scale,
                         offset, out, R, C, tx, rows, act, index, W);
}

// K2d in the split mode, with the ranks' sums added in rank order folded
// in: block (tile, row range) adds its tile's channels over the W slots of
// the exchange buffer in rank order from slot 0 (as collectives.py:
// sum_in_rank_order adds them) and puts mean, inv·scale, offset, Σgz/N and
// inv·(Σgz·xhat/N) in shared memory, then writes dx of its rows with its
// roundings pinned by intrinsics, so that they do not depend on the
// compiler's contractions: gz = g·act'(pre_act(d, inv·scale, offset))
// rounded (a gz fused into the subtraction that follows differs at leaky
// ReLU's 0.2), then (gz - Σgz/N) - d·inv·(Σgz·xhat/N) as one fused
// multiply-add, times inv·scale. Blocks have 256 threads: tx lanes of VEC
// channels across the tile, the rest row lanes. A thread's first
// APPLY_UNROLL rows of g and x are loaded before the merge, so the sums'
// trip and theirs overlap.
template <typename T, int VEC>
__global__ void __launch_bounds__(256)
bn_bwd_apply_split_kernel(const T* __restrict__ g, const T* __restrict__ x,
                          const float* __restrict__ mean, const float* __restrict__ inv,
                          const float* __restrict__ scale, const float* __restrict__ offset,
                          const float* __restrict__ sums, T* __restrict__ dx, int R, int C, int W,
                          int tx, int rows, float n_rows, int act) {
  using P = Pack<T, VEC>;
  constexpr int U = APPLY_UNROLL;
  extern __shared__ __align__(16) unsigned char smem[];
  const int CT = tx * VEC;
  const int TY = 256 / tx;
  float* s_mean = reinterpret_cast<float*>(smem);  // [CT] each
  float* s_sa = s_mean + CT;                       // inv·scale
  float* s_off = s_sa + CT;
  float* s_mg = s_off + CT;                        // Σgz / N
  float* s_ivm = s_mg + CT;                        // inv·(Σgz·xhat / N)
  const int ct = blockIdx.x;
  const int64_t C64 = C;
  const int k0 = (threadIdx.x % tx) * VEC;
  const int c0 = ct * CT + k0;
  const int r0 = blockIdx.y * rows;
  const int r1 = min(r0 + rows, R);
  const int rs = r0 + int(threadIdx.x / tx);
  P gp[U], xp[U];
  if (c0 < C) {
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int rr = rs + j * TY;
      if (rr < r1) {
        gp[j] = *reinterpret_cast<const P*>(g + int64_t(rr) * C64 + c0);
        xp[j] = *reinterpret_cast<const P*>(x + int64_t(rr) * C64 + c0);
      }
    }
  }
  for (int k = threadIdx.x; k < CT; k += 256) {
    const int c = ct * CT + k;
    if (c >= C) break;
    float s0 = sums[c], s1 = sums[C64 + c];
    for (int w = 1; w < W; ++w) {
      s0 += sums[int64_t(w) * 2 * C64 + c];
      s1 += sums[(int64_t(w) * 2 + 1) * C64 + c];
    }
    const float iv = inv[c];
    s_mean[k] = mean[c];
    s_sa[k] = iv * scale[c];
    s_off[k] = offset[c];
    s_mg[k] = s0 / n_rows;
    s_ivm[k] = iv * (s1 / n_rows);
  }
  __syncthreads();
  if (c0 >= C) return;
  float m[VEC], sa[VEC], of[VEC], mg[VEC], ivm[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    m[q] = s_mean[k0 + q];
    sa[q] = s_sa[k0 + q];
    of[q] = s_off[k0 + q];
    mg[q] = s_mg[k0 + q];
    ivm[q] = s_ivm[k0 + q];
  }
  for (int r = rs; r < r1; r += U * TY) {
    if (r != rs) {
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int rr = r + j * TY;
        if (rr < r1) {
          gp[j] = *reinterpret_cast<const P*>(g + int64_t(rr) * C64 + c0);
          xp[j] = *reinterpret_cast<const P*>(x + int64_t(rr) * C64 + c0);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int rr = r + j * TY;
      if (rr >= r1) break;
      P out;
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const float d = to_f32(xp[j].v[q]) - m[q];
        const float gz = __fmul_rn(to_f32(gp[j].v[q]), act_grad(pre_act(d, sa[q], of[q]), act));
        out.v[q] = from_f32<T>(__fmul_rn(__fmaf_rn(-d, ivm[q], __fsub_rn(gz, mg[q])), sa[q]));
      }
      *reinterpret_cast<P*>(dx + int64_t(rr) * C64 + c0) = out;
    }
  }
}

template <typename T, int VEC>
int run_bwd_apply_split(const void* g, const void* x, const float* mean, const float* inv,
                        const float* scale, const float* offset, const float* sums, void* dx,
                        int R, int C, int W, int tx, int rows, int n_rr, long long smem,
                        float n_rows, int act, cudaStream_t st) {
  const int CT = tx * VEC;
  if (tx < 1 || tx > 256 || (tx & (tx - 1)) || rows < 1 || n_rr < 1 || n_rr > 65535 ||
      int64_t(rows) * n_rr < R || int64_t(rows) * (n_rr - 1) >= R || W < 1 ||
      (VEC > 1 && C % VEC) || size_t(smem) != 5 * size_t(CT) * sizeof(float) || !(n_rows > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((C + CT - 1) / CT, n_rr);
  bn_bwd_apply_split_kernel<T, VEC><<<grid, 256, size_t(smem), st>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), mean, inv, scale, offset, sums,
      static_cast<T*>(dx), R, C, W, tx, rows, n_rows, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace ggan

// K2a's split mode, the rank's statistics: x [R, C]; out [W, 3, C] f64 gets
// the rows' count, unshifted mean and M2 per channel in slot `index` and
// zeros in the others. vec is 16 / sizeof(dtype) (C a multiple of it, x
// 16-byte aligned) or 1; tx, rows, cluster and smem come from
// ops/kernels/fused_norm.py:bn_stats_local_plan. One cluster launch.
extern "C" int ggan_bn_stats_local(const void* x, void* out, int dtype, int R, int C, int vec,
                                   int tx, int rows, int cluster, long long smem, int index,
                                   int W, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* o = static_cast<double*>(out);
  if (dtype == ggan::kFloat32 && vec == 4) {
    return ggan::run_stats_local<float, 4>(x, o, R, C, tx, rows, cluster, smem, index, W, st);
  } else if (dtype == ggan::kFloat32 && vec == 1) {
    return ggan::run_stats_local<float, 1>(x, o, R, C, tx, rows, cluster, smem, index, W, st);
  } else if (dtype == ggan::kBFloat16 && vec == 8) {
    return ggan::run_stats_local<__nv_bfloat16, 8>(x, o, R, C, tx, rows, cluster, smem, index,
                                                   W, st);
  } else if (dtype == ggan::kBFloat16 && vec == 1) {
    return ggan::run_stats_local<__nv_bfloat16, 1>(x, o, R, C, tx, rows, cluster, smem, index,
                                                   W, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K2b in the split mode with K2a's finalize: x [R, C]; parts [W, 3, C] f64,
// the ranks' gathered (n, mean, M2); scale and offset [C] f32; y has x's
// dtype and shape; stats [3, C] f32 gets (mean, var, inv); q (int8 [R, C],
// Q8 only: nullptr for none) gets q8(y, qs). vec is 16 / sizeof(dtype) (C a
// multiple of it; x and y 16-byte aligned, q vec-byte aligned) or 1; tx,
// rows, n_rr and smem come from ops/kernels/fused_norm.py:
// bn_apply_split_plan.
extern "C" int ggan_bn_apply_split(const void* x, const void* parts, const void* scale,
                                   const void* offset, void* y, void* stats, void* q, float qs,
                                   int dtype, int R, int C, int W, int vec, int tx, int rows,
                                   int n_rr, long long smem, float eps, int act, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* pt = static_cast<const double*>(parts);
  const float* sc = static_cast<const float*>(scale);
  const float* of = static_cast<const float*>(offset);
  float* so = static_cast<float*>(stats);
#define GGAN_APPLY_SPLIT(T, V)                                                                 \
  return q ? ggan::run_apply_split<T, V, true>(x, pt, sc, of, y, so, q, qs, R, C, W, tx, rows,  \
                                               n_rr, smem, eps, act, st)                       \
           : ggan::run_apply_split<T, V, false>(x, pt, sc, of, y, so, q, qs, R, C, W, tx, rows, \
                                                n_rr, smem, eps, act, st)
  if (dtype == ggan::kFloat32 && vec == 4) {
    GGAN_APPLY_SPLIT(float, 4);
  } else if (dtype == ggan::kFloat32 && vec == 1) {
    GGAN_APPLY_SPLIT(float, 1);
  } else if (dtype == ggan::kBFloat16 && vec == 8) {
    GGAN_APPLY_SPLIT(__nv_bfloat16, 8);
  } else if (dtype == ggan::kBFloat16 && vec == 1) {
    GGAN_APPLY_SPLIT(__nv_bfloat16, 1);
  }
#undef GGAN_APPLY_SPLIT
  return static_cast<int>(cudaErrorInvalidValue);
}

// K2c's split mode, the rank's sums: g and x [R, C] in one dtype; mean,
// inv, scale and offset [C] f32; out [W, 2, C] f32 gets [Σgz, Σgz·xhat]
// per channel in slot `index` and zeros in the others. vec is
// 16 / sizeof(dtype) (C a multiple of it, g and x 16-byte aligned) or 1;
// tx, rows, cluster and smem come from ops/kernels/fused_norm.py:
// bn_bwd_local_plan. One cluster launch.
extern "C" int ggan_bn_bwd_local(const void* g, const void* x, const void* mean,
                                 const void* inv, const void* scale, const void* offset,
                                 void* out, int dtype, int R, int C, int vec, int tx, int rows,
                                 int cluster, long long smem, int act, int index, int W,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(inv);
  const float* sc = static_cast<const float*>(scale);
  const float* of = static_cast<const float*>(offset);
  float* o = static_cast<float*>(out);
#define GGAN_BWD_LOCAL(T, V)                                                                     \
  return ggan::run_bwd_local<T, V>(g, x, m, iv, sc, of, o, R, C, tx, rows, cluster, smem, act, \
                                   index, W, st)
  if (dtype == ggan::kFloat32 && vec == 4) {
    GGAN_BWD_LOCAL(float, 4);
  } else if (dtype == ggan::kFloat32 && vec == 1) {
    GGAN_BWD_LOCAL(float, 1);
  } else if (dtype == ggan::kBFloat16 && vec == 8) {
    GGAN_BWD_LOCAL(__nv_bfloat16, 8);
  } else if (dtype == ggan::kBFloat16 && vec == 1) {
    GGAN_BWD_LOCAL(__nv_bfloat16, 1);
  }
#undef GGAN_BWD_LOCAL
  return static_cast<int>(cudaErrorInvalidValue);
}

// K2d in the split mode with the ranks' sums added in rank order: g and x
// [R, C] in one dtype; mean, inv, scale and offset [C] f32; sums [W, 2, C]
// f32, the ranks' gathered [Σgz, Σgz·xhat]; n_rows the group's rows; dx
// has x's dtype and shape. vec is 16 / sizeof(dtype) (C a multiple of it;
// g, x and dx 16-byte aligned) or 1; tx, rows, n_rr and smem come from
// ops/kernels/fused_norm.py:bn_bwd_apply_split_plan.
extern "C" int ggan_bn_bwd_apply_split(const void* g, const void* x, const void* mean,
                                       const void* inv, const void* scale, const void* offset,
                                       const void* sums, void* dx, int dtype, int R, int C, int W,
                                       int vec, int tx, int rows, int n_rr, long long smem,
                                       float n_rows, int act, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(inv);
  const float* sc = static_cast<const float*>(scale);
  const float* of = static_cast<const float*>(offset);
  const float* su = static_cast<const float*>(sums);
#define GGAN_BWD_APPLY_SPLIT(T, V)                                                              \
  return ggan::run_bwd_apply_split<T, V>(g, x, m, iv, sc, of, su, dx, R, C, W, tx, rows, n_rr, \
                                         smem, n_rows, act, st)
  if (dtype == ggan::kFloat32 && vec == 4) {
    GGAN_BWD_APPLY_SPLIT(float, 4);
  } else if (dtype == ggan::kFloat32 && vec == 1) {
    GGAN_BWD_APPLY_SPLIT(float, 1);
  } else if (dtype == ggan::kBFloat16 && vec == 8) {
    GGAN_BWD_APPLY_SPLIT(__nv_bfloat16, 8);
  } else if (dtype == ggan::kBFloat16 && vec == 1) {
    GGAN_BWD_APPLY_SPLIT(__nv_bfloat16, 1);
  }
#undef GGAN_BWD_APPLY_SPLIT
  return static_cast<int>(cudaErrorInvalidValue);
}

// K2a. x is [R, C]; part is [n_rb, 2, C] f64 scratch; out is [3, C] f32:
// mean, var and inv. vec is 16 / sizeof(dtype) (C a multiple of it, x
// 16-byte aligned) or 1; tx, rows, n_rb, smem and grid come from
// ops/kernels/fused_norm.py:bn_stats_plan. A grid that cannot be co-resident
// returns cudaErrorCooperativeLaunchTooLarge.
extern "C" int ggan_bn_stats(const void* x, void* part, void* out, int dtype, int R, int C,
                             int vec, int tx, int rows, int n_rb, long long smem, int grid,
                             float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* pt = static_cast<double*>(part);
  float* o = static_cast<float*>(out);
  if (dtype == ggan::kFloat32 && vec == 4) {
    return ggan::run_stats<float, 4>(x, pt, o, R, C, tx, rows, n_rb, smem, grid, eps, st);
  } else if (dtype == ggan::kFloat32 && vec == 1) {
    return ggan::run_stats<float, 1>(x, pt, o, R, C, tx, rows, n_rb, smem, grid, eps, st);
  } else if (dtype == ggan::kBFloat16 && vec == 8) {
    return ggan::run_stats<__nv_bfloat16, 8>(x, pt, o, R, C, tx, rows, n_rb, smem, grid, eps,
                                             st);
  } else if (dtype == ggan::kBFloat16 && vec == 1) {
    return ggan::run_stats<__nv_bfloat16, 1>(x, pt, o, R, C, tx, rows, n_rb, smem, grid, eps,
                                             st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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

// K2b with its int8 copy: as ggan_bn_apply, and q [numel] int8 gets
// q8(y, qs) (Q1 at the scale qs of y's consumer) in the same pass; vec 4
// also needs q 4-byte aligned.
extern "C" int ggan_bn_apply_q8(const void* x, const void* mean, const void* inv,
                                const void* scale, const void* offset, void* y, void* q,
                                float qs, int dtype, long long numel, int C, int act,
                                int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(inv);
  const float* sc = static_cast<const float*>(scale);
  const float* of = static_cast<const float*>(offset);
  if (dtype == ggan::kFloat32 && vec == 4) {
    ggan::launch_apply_q8<float, 4>(x, m, iv, sc, of, y, q, qs, numel, C, act, st);
  } else if (dtype == ggan::kFloat32 && vec == 1) {
    ggan::launch_apply_q8<float, 1>(x, m, iv, sc, of, y, q, qs, numel, C, act, st);
  } else if (dtype == ggan::kBFloat16 && vec == 4) {
    ggan::launch_apply_q8<__nv_bfloat16, 4>(x, m, iv, sc, of, y, q, qs, numel, C, act, st);
  } else if (dtype == ggan::kBFloat16 && vec == 1) {
    ggan::launch_apply_q8<__nv_bfloat16, 1>(x, m, iv, sc, of, y, q, qs, numel, C, act, st);
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
