// Intersection counts for the popcount screen:
//   out[i][j] = sum_k popcount(a[i][k] & b[j][k])
// over row-major uint32 rows a (m, w) and b (n, w); out is (m, n) int32.
//
// Replaces galah_tpu/ops/popcount_screen.py::_popcount_kernel, the Pallas
// kernel that walks (8 x 128)-row tiles on the TPU's vector unit, one
// query row at a time against 128 column rows, AND + population_count
// over 512-word chunks held in VMEM. Its screen has long rows (w = 4096
// words at 2^17 bits, 8192 at the default 2^18) and square tiles of up to
// 2048 x 2048 rows, so this kernel is laid out along w instead:
//
// - one block of 8 warps per 8 query rows x 32 columns; each warp owns 4
//   columns, so each lane accumulates 8 x 4 = 32 partial counts;
// - the block's 8 query rows are staged through shared memory 512 words
//   at a time (16 KB), coalesced, and read back conflict-free (lane l
//   reads word l of a 32-word step);
// - the lanes of a warp stride along w: each step loads 32 consecutive
//   words of each of its 4 column rows (one 128-byte transaction each)
//   and does 8 x 4 AND + __popc against the staged query words, so every
//   word read from memory feeds 8 popcounts;
// - after the sweep along w, __reduce_add_sync folds the 32 lanes'
//   partial sums, and lane r * 4 + c writes out[row0 + r][col + c];
// - ragged m, n and w are masked inside: query rows and words past the
//   edge stage as 0, column rows past n are clamped to row n - 1 and
//   their results are not written, so the caller pads nothing.
//
// What bounds it: integer-ALU POPC throughput (a quarter of the integer rate
// on sm_90): m * n * w popcounts, 1.7e10 at 2048 x 2048 x 4096. Memory
// traffic is m / 8 column sweeps of n * w words, mostly from L2.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;                       // query rows per block
constexpr int kWarps = 8;                      // warps per block
constexpr int kColsPerWarp = 4;                // columns per warp
constexpr int kCols = kWarps * kColsPerWarp;   // columns per block
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 512;                    // query words staged per step
static_assert(kRows * kColsPerWarp == 32, "one output per lane");

__global__ void __launch_bounds__(kThreads)
popcount_screen_kernel(const uint32_t* __restrict__ a,
                       const uint32_t* __restrict__ b,
                       int32_t* __restrict__ out, int m, int n, int w) {
  __shared__ uint32_t q_s[kRows][kChunk];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.y * kRows;
  const int col0 = blockIdx.x * kCols + warp * kColsPerWarp;

  const uint32_t* bcol[kColsPerWarp];
#pragma unroll
  for (int c = 0; c < kColsPerWarp; ++c) {
    const int j = min(col0 + c, n - 1);
    bcol[c] = b + static_cast<size_t>(j) * w;
  }

  int acc[kRows][kColsPerWarp];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c) acc[r][c] = 0;
  }

  for (int k0 = 0; k0 < w; k0 += kChunk) {
    __syncthreads();  // the previous chunk's readers are done
    for (int idx = threadIdx.x; idx < kRows * kChunk; idx += kThreads) {
      const int r = idx / kChunk;
      const int c = idx % kChunk;
      const int i = row0 + r;
      const int k = k0 + c;
      q_s[r][c] = (i < m && k < w) ? a[static_cast<size_t>(i) * w + k] : 0u;
    }
    __syncthreads();

    const int kn = min(kChunk, w - k0);
#pragma unroll 2
    for (int kk = lane; kk < kn; kk += 32) {
      uint32_t bv[kColsPerWarp];
#pragma unroll
      for (int c = 0; c < kColsPerWarp; ++c) bv[c] = __ldg(bcol[c] + k0 + kk);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const uint32_t q = q_s[r][kk];
#pragma unroll
        for (int c = 0; c < kColsPerWarp; ++c) acc[r][c] += __popc(q & bv[c]);
      }
    }
  }

  int mine = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < kColsPerWarp; ++c) {
      const int s = __reduce_add_sync(0xffffffffu, acc[r][c]);
      if (lane == r * kColsPerWarp + c) mine = s;
    }
  }
  const int i = row0 + lane / kColsPerWarp;
  const int j = col0 + lane % kColsPerWarp;
  if (i < m && j < n) out[static_cast<size_t>(i) * n + j] = mine;
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Rows are row-major and contiguous; a and b may alias.
extern "C" int galah_popcount_screen(const uint32_t* a, const uint32_t* b,
                                     int32_t* out, int m, int n, int w,
                                     cudaStream_t stream) {
  if (m < 0 || n < 0 || w < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n + kCols - 1) / kCols, (m + kRows - 1) / kRows);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  popcount_screen_kernel<<<grid, kThreads, 0, stream>>>(a, b, out, m, n, w);
  return static_cast<int>(cudaGetLastError());
}
