// Packed-bitmap intersection counts for the all-vs-all screen:
//   out[i][j] = sum_k popcount(a[i][k] & b[j][k])
// over row-major uint32 rows a (m, w) and b (n, w); out is (m, n) int32.
//
// Replaces galah_tpu/ops/packed_matmul.py::_fused_kernel, the Pallas
// kernel that unpacks K-panels to int8 in VMEM and runs an int8 x int8 ->
// int32 dot on the TPU's matrix unit. This kernel computes the same
// function without the unpack: it reads the packed words directly, so
// the counts are exact and independent of any bit order.
//
// Design (the simple, right first version):
// - one block per 64 x 64 output tile, 256 threads, a 4 x 4 register
//   accumulator per thread (rows ty + 16*i, columns tx + 16*j);
// - K is staged through shared memory 32 words at a time for A and B,
//   with a row stride of 33 words so neither the staging stores nor the
//   column reads of B conflict on banks;
// - each product is __popc(x & y), accumulated in int32;
// - ragged m, n and w edges are masked inside the kernel (out-of-range
//   words load as 0, which adds nothing), so the caller pads nothing.
//
// What bounds it: integer-ALU popc throughput (POPC issues at a quarter
// of the integer rate on sm_90), well below the card's int8 tensor-core
// peak. The later versions that make it fast are an s8 wgmma path (unpack
// a K-panel to int8 in shared memory, as the TPU kernel does, and feed
// the tensor cores) or an mma.sync b1 .and.popc path that reads the
// packed words directly; plus fusing the screen's epilogue
// (collision-corrected containment, cutoff and diagonal mask) so that only
// hits leave a tile.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;             // output tile edge, rows and columns
constexpr int kThreads = 256;         // 16 x 16 threads
constexpr int kPerThread = 4;         // 4 x 4 outputs per thread
constexpr int kKWords = 32;           // K words staged per step
constexpr int kStride = kKWords + 1;  // padded shared-memory row stride

__global__ void __launch_bounds__(kThreads)
packed_popcount_kernel(const uint32_t* __restrict__ a,
                       const uint32_t* __restrict__ b,
                       int32_t* __restrict__ out, int m, int n, int w) {
  __shared__ uint32_t a_s[kTile * kStride];
  __shared__ uint32_t b_s[kTile * kStride];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  int acc[kPerThread][kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) acc[i][j] = 0;
  }

  for (int k0 = 0; k0 < w; k0 += kKWords) {
    // Stage a 64 x 32-word panel of A and of B: consecutive threads read
    // consecutive words of one row (coalesced).
#pragma unroll
    for (int l = 0; l < (kTile * kKWords) / kThreads; ++l) {
      const int idx = tid + l * kThreads;
      const int r = idx / kKWords;
      const int c = idx % kKWords;
      const int k = k0 + c;
      const int ga = row0 + r;
      const int gb = col0 + r;
      a_s[r * kStride + c] =
          (ga < m && k < w) ? a[static_cast<size_t>(ga) * w + k] : 0u;
      b_s[r * kStride + c] =
          (gb < n && k < w) ? b[static_cast<size_t>(gb) * w + k] : 0u;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kKWords; ++kk) {
      uint32_t av[kPerThread];
      uint32_t bv[kPerThread];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        av[i] = a_s[(ty + 16 * i) * kStride + kk];
      }
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        bv[j] = b_s[(tx + 16 * j) * kStride + kk];
      }
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          acc[i][j] += __popc(av[i] & bv[j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < n) out[static_cast<size_t>(r) * n + c] = acc[i][j];
    }
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Rows are row-major and contiguous; a and b may alias.
extern "C" int galah_packed_popcount(const uint32_t* a, const uint32_t* b,
                                     int32_t* out, int m, int n, int w,
                                     cudaStream_t stream) {
  if (m < 0 || n < 0 || w < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  packed_popcount_kernel<<<grid, kThreads, 0, stream>>>(a, b, out, m, n, w);
  return static_cast<int>(cudaGetLastError());
}
