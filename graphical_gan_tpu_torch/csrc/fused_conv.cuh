// Shared by K1's sources (fused_conv.cu, fused_conv_wgmma.cu,
// fused_conv_fma.cu, compiled in parallel) and K3a's (conv_gemm_tma.cu): the
// conv geometry, the row table and tap walk behind every gather, cp.async,
// and the launch arguments.
#pragma once

#include "common.cuh"

namespace ggan {
namespace k1 {

struct Conv {
  int B, H, W, Cin, KH, KW, Cout, OH, OW, stride, pad_h, pad_w;
  int M, R;
};

// One output row's window: the x offset of its top-left input element
// (which lies in the padding, before the row's data, when ih0 or iw0 is
// negative: only taps inside the input are read) and its top-left input
// coordinate. Rows past M get an ih0 that no tap brings inside.
struct RowInfo {
  int off0, ih0, iw0, unused;
};
constexpr int kRowPastM = -(1 << 29);

__device__ __forceinline__ void fill_rows(RowInfo* rows, const Conv& s, int m0,
                                          int bm) {
  for (int i = threadIdx.x; i < bm; i += blockDim.x) {
    const int m = m0 + i;
    RowInfo ri{0, kRowPastM, kRowPastM, 0};
    if (m < s.M) {
      const int ow = m % s.OW;
      const int t = m / s.OW;
      ri.ih0 = (t % s.OH) * s.stride - s.pad_h;
      ri.iw0 = ow * s.stride - s.pad_w;
      ri.off0 = (((t / s.OH) * s.H + ri.ih0) * s.W + ri.iw0) * s.Cin;
    }
    rows[i] = ri;
  }
}

// A thread's reduction column r = (kh*KW + kw)*Cin + ci, walked forward by
// BK each K step with adds: the gathers issue no division in the K loop.
struct TapWalk {
  int r, kh, kw, ci;

  __device__ __forceinline__ void init(const Conv& s, int r0) {
    const int t = r0 / s.Cin;
    r = r0;
    ci = r0 - t * s.Cin;
    kh = t / s.KW;
    kw = t - kh * s.KW;
  }
  __device__ __forceinline__ void advance(const Conv& s, int by) {
    r += by;
    ci += by;
    while (ci >= s.Cin) {
      ci -= s.Cin;
      if (++kw == s.KW) {
        kw = 0;
        ++kh;
      }
    }
  }
  // offset of the tap's element from a window's top-left element
  __device__ __forceinline__ int toff(const Conv& s) const {
    return (kh * s.W + kw) * s.Cin + ci;
  }
};

// The x offset of A's element (row ri, the column of walk p at offset
// toff), or -1 in the padding, past the block's columns (kend) or past M.
__device__ __forceinline__ int x_offset(const Conv& s, const RowInfo& ri,
                                        const TapWalk& p, int toff, int kend) {
  const bool in = p.r < kend && unsigned(ri.ih0 + p.kh) < unsigned(s.H) &&
                  unsigned(ri.iw0 + p.kw) < unsigned(s.W);
  return in ? ri.off0 + toff : -1;
}

// Block z's K steps [step0, step0 + steps) and its end column kend.
struct KRange {
  int step0, steps, kend;
};

__device__ __forceinline__ KRange k_range(const Conv& s, int bk, int per) {
  const int nk = (s.R + bk - 1) / bk;
  const int s0 = blockIdx.z * per;
  const int s1 = min(nk, s0 + per);
  return {s0, max(s1 - s0, 0), min(s.R, s1 * bk)};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (or 4) bytes; ok == false writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int WG_BK = 64;     // 64 bf16 = one 128-byte swizzle row
constexpr int WG_STAGES = 4;  // ring depth: 3 steps of loads in flight

constexpr int FMA_BK = 32;     // f32 K step: 32 floats
constexpr int FMA_STAGES = 3;  // ring depth: 2 steps of loads in flight

// Dynamic shared memory above 48 KB must be asked for, per kernel and
// device; asked at every launch, since the current device may change.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

struct Args {
  const void *x, *w, *bias;
  void* y;
  float* ws;
  Conv s;
  int act, per;
  float leak;  // the slope of act == kActLeaky: 0.2 for K1, K3's `leak`
  dim3 grid;
  cudaStream_t stream;
};

// the mainloops of fused_conv_wgmma.cu and fused_conv_fma.cu, by tile;
// cudaErrorInvalidValue for a tile they have no kernel for
cudaError_t launch_wgmma_tile(const Args& a, int bm, int bn);
cudaError_t launch_fma_tile(const Args& a, int bm, int bn, bool vec);
// split K's second kernel (fused_conv.cu): the partials of a.ws summed in
// split order, + bias, act, one rounding to bf16
cudaError_t launch_splitk_reduce(const Args& a, int splits);

}  // namespace k1
}  // namespace ggan
