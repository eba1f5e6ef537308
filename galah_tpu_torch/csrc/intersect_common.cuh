// Pieces shared by the two intersection-count kernels
// (packed_popcount.cu, K1, and popcount_screen.cu, K2):
//   out[i][j] = sum_k popcount(a[i][k] & b[j][k])
// over row-major uint32 rows a (m, w) and b (n, w), out (m, n) int32.
//
// Both stage K-panels of a 128-row tile of each operand into shared
// memory with cp.async and split W across the grid's z axis: block z
// counts words [z * split_words, min(w, (z + 1) * split_words)). With
// more than one split, the partial counts are added into an `out` the
// caller zeroed, with int32 atomics: integer addition is exact in any
// order, so the counts are bit-for-bit those of one pass.
//
// Loads are 16-byte copies when both bases are 16-byte aligned and w is
// a multiple of 4 words (the screens' rows always are); otherwise each
// word is its own 4-byte copy (odd w, or a row slice at an odd offset).
// Rows past the operand's edge and words past the split's end are
// zero-filled by the copy itself, so they add nothing and the caller
// pads nothing.

#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace galah {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies `src_bytes` (0..16) of src to dst and zero-fills the rest of 16;
// through L1 (.ca) when kL1, else L2 only (.cg).
template <bool kL1>
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  if (kL1) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
  }
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Stages words [k, k + 4) of row `row` of a (rows, w) operand into the 16
// bytes at dst; words at or past k_hi, and rows at or past `rows`, are 0.
// kL1 keeps the rest of the row's sector in L1 for the next panel.
template <bool kVec, bool kL1>
__device__ __forceinline__ void stage_chunk(uint32_t dst,
                                            const uint32_t* __restrict__ x,
                                            int row, int rows, int k,
                                            int k_hi, int w) {
  const bool live = row < rows;
  const uint32_t* src = x + (live ? static_cast<size_t>(row) * w : 0);
  if (kVec) {
    // k and k_hi are multiples of 4 here: the chunk is in or out whole.
    const bool in = live && k < k_hi;
    cp_async_16<kL1>(dst, src + (in ? k : 0), in ? 16 : 0);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = live && k + j < k_hi;
      cp_async_4(dst + 4 * j, src + (in ? k + j : 0), in ? 4 : 0);
    }
  }
}

// Byte offset of 16-byte chunk `chunk` (0..7) of row `row` in a tile of
// 128-byte rows, XOR-swizzled so that 8 consecutive rows at one chunk
// fall on 8 different bank groups. It is the 128-byte swizzle that the
// tensor cores' shared-memory descriptors name (SWIZZLE_128B), so a tile
// whose base is 1024-byte aligned can feed wgmma directly.
__device__ __forceinline__ uint32_t swizzle128(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// Writes one count, or adds it when the grid splits W (out was zeroed).
__device__ __forceinline__ void put_count(int32_t* __restrict__ out, int m,
                                          int n, int r, int c, int v,
                                          bool split) {
  if (r >= m || c >= n) return;
  int32_t* p = out + static_cast<size_t>(r) * n + c;
  if (!split) {
    *p = v;
  } else if (v != 0) {
    atomicAdd(p, v);
  }
}

// True when both operands can be staged with 16-byte copies.
inline bool vector_loads_ok(const void* a, const void* b, int w) {
  return w % 4 == 0 && (reinterpret_cast<uintptr_t>(a) % 16) == 0 &&
         (reinterpret_cast<uintptr_t>(b) % 16) == 0;
}

// Checks the launch arguments shared by both entries; fills the grid.
inline cudaError_t count_grid(int m, int n, int w, int split_words,
                              int panel_words, int tile, dim3* grid) {
  if (m < 0 || n < 0 || w < 0 || split_words <= 0 ||
      split_words % panel_words != 0) {
    return cudaErrorInvalidValue;
  }
  const int splits = w > 0 ? (w - 1) / split_words + 1 : 1;
  *grid = dim3((n + tile - 1) / tile, (m + tile - 1) / tile, splits);
  return cudaSuccess;
}

}  // namespace galah
