// The Tensor Memory Accelerator pieces shared by K3a's mainloop
// (conv_gemm_tma.cu) and Q2's (quant_tma.cu): mbarriers, the bulk tensor
// loads (im2col and tiled boxes, completing on an mbarrier), and the
// tensor-map encoders of the CUDA API, found through
// cudaGetDriverEntryPoint so that the library links against nothing new.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ggan {

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// one arrival that also arms the barrier for `bytes` of transactions
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// The im2col box: pixels from (n, h, w) on, each at (h + oh, w + ow), the
// map's channels per pixel from c.
__device__ __forceinline__ void tma_im2col(uint32_t dst, const CUtensorMap* map,
                                           uint32_t bar, int c, int w, int h,
                                           int n, uint16_t ow, uint16_t oh) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(n),
      "h"(ow), "h"(oh)
      : "memory");
}

// The tiled box at (c0, c1), innermost first.
__device__ __forceinline__ void tma_tile2d(uint32_t dst, const CUtensorMap* map,
                                           uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The tiled box at (c0, c1, c2), innermost first.
__device__ __forceinline__ void tma_tile3d(uint32_t dst, const CUtensorMap* map,
                                           uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The tensor-map encoders (CUDA 12 signatures).
using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const int*, const int*, cuuint32_t, cuuint32_t,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

template <typename F>
bool entry_point(const char* name, F* fn) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
  if (cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q) != cudaSuccess ||
      q != cudaDriverEntryPointSuccess || p == nullptr)
    return false;
  *fn = reinterpret_cast<F>(p);
  return true;
}

// Both encoders, looked up once per process; false where the driver has
// neither.
inline bool tensor_map_encoders(EncodeIm2col* im2col, EncodeTiled* tiled) {
  static EncodeIm2col enc_im2col = nullptr;
  static EncodeTiled enc_tiled = nullptr;
  static const bool found = entry_point("cuTensorMapEncodeIm2col", &enc_im2col) &&
                            entry_point("cuTensorMapEncodeTiled", &enc_tiled);
  *im2col = enc_im2col;
  *tiled = enc_tiled;
  return found;
}

// Error codes beside cudaGetLastError()'s: a map's encoding failed
// (kEncodeX / kEncodeW + the CUresult), or no encoder was found.
constexpr int kEncodeX = 10000;
constexpr int kEncodeW = 20000;
constexpr int kNoEncoder = 30000;

}  // namespace ggan
