// K2: batch-statistics batch norm + activation over channels-last x viewed
// as [R, C] (R = product of the leading dims), f32 statistics; f32 or bf16
// in and out. Three kernels, each behind its own C entry point:
//
// K2a ggan_bn_stats: per-channel mean, biased variance and
//     inv = 1 / sqrt(var + eps), in one launch. Replaces
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

#include <cooperative_groups.h>

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
      const float v = pre_act(to_f32(in.v[k]) - mean[c], a, offset[c]);
      out.v[k] = from_f32<T>(apply_act(v, act));
    }
    yp[i] = out;
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

// Launches a kernel of the shared plan as one cooperative launch. Where the
// grid cannot be co-resident at this shared memory size, the launch returns
// cudaErrorCooperativeLaunchTooLarge.
template <typename Args>
int launch_cooperative(void (*kern)(Args), Args a, int grid, int threads, size_t smem,
                       cudaStream_t st) {
  // asked at every launch, since the current device may change
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(grid),
                                  dim3(threads), args, smem, st);
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

// K2a in one cooperative launch. Phase 1, per unit of the block: each
// thread sums d = x - x[0, c] and d² over its rows in row order, in f64 (d
// is exact there); a block sum gives the unit's n, Σd, Σd², and so its
// (mean, M2) of d, written to `part` (or, with one row block, mean, var and
// inv to `out`). One grid-wide barrier. Phase 2: the block of row block 0
// of each channel tile merges the tile's partials in row-block order
// (Chan's formula, in f64) and writes mean, var and inv.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads<VEC>, 1) bn_stats_fused_kernel(const StatsArgs<T> a) {
  using P = Pack<T, VEC>;
  constexpr int U = STATS_UNROLL<VEC>;
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
#pragma unroll
    for (int q = 0; q < VEC; ++q) s[0][q] = s[1][q] = shift[q] = 0.0;
    if (c0 < a.C) {
      const P first = *reinterpret_cast<const P*>(a.x + c0);
#pragma unroll
      for (int q = 0; q < VEC; ++q) shift[q] = to_f32(first.v[q]);
      for (int r = r0 + ty; r < r1; r += TY * U) {
        P xp[U];
#pragma unroll
        for (int j = 0; j < U; ++j) {
          const int rr = r + j * TY;
          if (rr < r1) xp[j] = *reinterpret_cast<const P*>(a.x + rr * C + c0);
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
  return launch_cooperative(bn_stats_fused_kernel<T, VEC>, a, grid, kThreads<VEC>,
                            size_t(smem), st);
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
      bwd_finish_unit<T, VEC, UNROLL>(a, slot, rb, ct, c0, r0, r1, tx, ty, TX, block_red, m, iv,
                                      sa, of);
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

}  // namespace
}  // namespace ggan

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
