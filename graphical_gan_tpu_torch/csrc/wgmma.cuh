// The Hopper tensor-core pieces shared by K1's bf16 mainloop
// (fused_conv_wgmma.cu) and K3a's (conv_gemm_tma.cu): shared-memory matrix
// descriptors for the 128-byte swizzle, wgmma m64nBNk16 bf16 -> f32, and the
// epilogue that stores one warpgroup's m64nBN accumulators.
//
// Both mainloops keep the same tiles in shared memory: A [BM, 64] K-major,
// 128 bytes a row, 16-byte chunk c of row r at chunk c ^ (r % 8), on a
// 1024-byte aligned base; W [64, BN] as 64-column atoms of 64 rows x 128
// bytes, swizzled the same way and read MN-major (the transpose bit).
#pragma once

#include "fused_conv.cuh"

namespace ggan {
namespace k1 {

// A shared-memory matrix descriptor with the 128-byte swizzle (layout type
// 1): start address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}

// d[64 x BN] += A[64 x 16] (K-major) * B[16 x BN] (MN-major, transpose bit
// set), f32 accumulate; generated operand lists, one per BN.
__device__ __forceinline__ void wgmma_m64n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_k16(float* d, uint64_t da, uint64_t db) {
  if constexpr (BN == 64) {
    wgmma_m64n64(d, da, db);
  } else {
    wgmma_m64n128(d, da, db);
  }
}

// One K step of 64 columns on stage (a_tile, b_tile): 4 wgmma k16 into
// this warpgroup's accumulators. ATOM is the byte distance between W's
// 64-column atoms.
template <int BN>
__device__ __forceinline__ void wgmma_step(float* acc, uint32_t a_tile,
                                           uint32_t b_tile, int wg) {
  constexpr int ATOM = 64 * 128;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // A: this warpgroup's 64 rows, K columns 16*kk..: 32 bytes along the
    // swizzled row; 8-row groups 1024 bytes apart (SBO)
    const uint64_t da = smem_desc(a_tile + wg * 64 * 128 + kk * 32, 16, 1024);
    // B: K rows 16*kk..: 16 rows of 128 bytes; 8-row groups 1024 bytes
    // apart (SBO), 64-column atoms ATOM bytes apart (LBO)
    const uint64_t db = smem_desc(b_tile + kk * 16 * 128, ATOM, 1024);
    wgmma_k16<BN>(acc, da, db);
  }
}

// Pins the accumulators after a wait: the compiler may not move their reads
// above it (the asm statements name them).
template <int N>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Stores one warpgroup's accumulators (rows m0.., columns n0..; t is the
// thread's index in the warpgroup): with one split, + bias, act, one
// rounding to bf16 into y; with several, the f32 partial into split
// blockIdx.z of the workspace [splits, M, Cout].
template <int BN>
__device__ __forceinline__ void store_tile(const float* acc,
                                           __nv_bfloat16* __restrict__ y,
                                           float* __restrict__ ws,
                                           const __nv_bfloat16* __restrict__ bias,
                                           const Conv& s, int act, float leak,
                                           int m0, int n0, int t) {
  // accumulator layout of m64nBN: thread (warp, lane) holds rows
  // 16*warp + lane/4 (+8), columns 8*j + 2*(lane%4) (+1)
  const bool split = gridDim.z > 1;
  const int warp = t / 32;
  const int lane = t % 32;
  const int row0 = m0 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * (lane % 4);
    if (n >= s.Cout) continue;
    const float b0 = split ? 0.0f : to_f32(bias[n]);
    const float b1 = split ? 0.0f : to_f32(bias[n + 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row0 + 8 * h;
      if (m >= s.M) continue;
      const float v0 = acc[4 * j + 2 * h];
      const float v1 = acc[4 * j + 2 * h + 1];
      if (split) {
        *reinterpret_cast<float2*>(ws + (int64_t(blockIdx.z) * s.M + m) * s.Cout + n) =
            make_float2(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(y + int64_t(m) * s.Cout + n) =
            __floats2bfloat162_rn(apply_act(v0 + b0, act, leak),
                                  apply_act(v1 + b1, act, leak));
      }
    }
  }
}

}  // namespace k1
}  // namespace ggan
