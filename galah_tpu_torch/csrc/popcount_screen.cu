// Intersection counts for the popcount screen:
//   out[i][j] = sum_k popcount(a[i][k] & b[j][k])
// over row-major uint32 rows a (m, w) and b (n, w); out is (m, n) int32.
//
// Replaces galah_tpu/ops/popcount_screen.py::_popcount_kernel, the Pallas
// kernel that walks (8 x 128)-row tiles on the TPU's vector unit, AND +
// population_count over 512-word chunks held in VMEM. On Hopper the same
// AND + population count is a tensor-core product: the single-bit
// `mma.sync.m16n8k256.row.col.s32.b1.b1.s32.and.popc` takes a 16 x 256-bit
// tile of query rows and an 8 x 256-bit tile of column rows as the packed
// words are, and adds popc(a & b) over the 256 bits into int32
// accumulators. Nothing is unpacked and no bit order is chosen: the
// fragment registers of A and B hold the same words of their rows.
//
// Design:
// - one block of 8 warps per 128 x 128 output tile; warp (wm, wn) of a
//   2 x 4 grid owns 64 x 32 outputs: 4 x 4 m16n8 tiles, 64 int32
//   accumulators per lane;
// - K-panels of 32 words (one 128-byte row per operand row, 32 KiB per
//   stage for both operands) arrive in a 3-stage shared-memory ring by
//   cp.async, 128-byte swizzled so that ldmatrix reads without bank
//   conflicts; ldmatrix.x4 builds each fragment (4 per A tile, 2 per B
//   tile pair);
// - each panel is 4 k256 steps of 16 mma per warp;
// - W is split across blockIdx.z when the output tiles alone cannot fill
//   the card's 132 SMs (the wrapper's launch planner picks the split);
//   partial counts then meet in int32 atomics (intersect_common.cuh).
//
// What bounds it: the b1 tensor-core rate, which NVIDIA does not publish
// for the H100 (its data sheet gives int8: 1,979 TOP/s). On an H100 80GB
// HBM3 at 700 W (chip_smoke.py) it counts 2048^2 x W4096 in 0.23 ms,
// 2.4x the int8 peak in bit operations (2 m n 32w), so the int8 bound of
// the same counts does not bound it; its byte bound is 0.025 ms. Shared
// memory serves 96 KiB of ldmatrix reads per 32-word panel per block.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "intersect_common.cuh"

namespace {

constexpr int kTile = 128;                          // output rows and columns
constexpr int kThreads = 256;                       // 8 warps, 2 x 4
constexpr int kPanelWords = 32;                     // words per row per stage
constexpr int kRowBytes = kPanelWords * 4;          // 128
constexpr int kStages = 3;
constexpr int kOperandBytes = kTile * kRowBytes;    // 16 KiB
constexpr int kStageBytes = 2 * kOperandBytes;      // A then B
constexpr int kSmemBytes = kStages * kStageBytes;   // 96 KiB
constexpr int kChunksPerThread = 2 * kTile * (kRowBytes / 16) / kThreads;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += popc(a & b) over one 16 x 8 x 256-bit tile.
__device__ __forceinline__ void mma_and_popc(int (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stages words [k0, k0 + 32) of the block's 128 A rows and 128 B rows:
// 8 consecutive threads copy one row's 128 bytes (coalesced).
template <bool kVec>
__device__ __forceinline__ void load_panel(uint32_t stage,
                                           const uint32_t* __restrict__ a,
                                           const uint32_t* __restrict__ b,
                                           int row0, int col0, int m, int n,
                                           int w, int k0, int k_hi) {
#pragma unroll
  for (int i = 0; i < kChunksPerThread; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 3;
    const int c = idx & 7;
    if (r < kTile) {
      galah::stage_chunk<kVec, false>(stage + galah::swizzle128(r, c), a,
                                      row0 + r, m, k0 + 4 * c, k_hi, w);
    } else {
      galah::stage_chunk<kVec, false>(
          stage + kOperandBytes + galah::swizzle128(r - kTile, c), b,
          col0 + r - kTile, n, k0 + 4 * c, k_hi, w);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
popcount_screen_kernel(const uint32_t* __restrict__ a,
                       const uint32_t* __restrict__ b,
                       int32_t* __restrict__ out, int m, int n, int w,
                       int split_words) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = galah::smem_addr(smem);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2;  // 0..1: 64-row half
  const int wn = warp & 3;   // 0..3: 32-column quarter
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int k_lo = blockIdx.z * split_words;
  const int k_hi = min(w, k_lo + split_words);
  const int panels = k_hi > k_lo ? (k_hi - k_lo + kPanelWords - 1) / kPanelWords
                                 : 0;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    }
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < panels) {
      load_panel<kVec>(base + s * kStageBytes, a, b, row0, col0, m, n, w,
                       k_lo + s * kPanelWords, k_hi);
    }
    galah::cp_async_commit();
  }

  for (int p = 0; p < panels; ++p) {
    galah::cp_async_wait<kStages - 2>();
    // Panel p has landed for every thread, and every warp is done with
    // the slot that the next copy overwrites (panel p - 1's).
    __syncthreads();
    const int q = p + kStages - 1;
    if (q < panels) {
      load_panel<kVec>(base + (q % kStages) * kStageBytes, a, b, row0, col0,
                       m, n, w, k_lo + q * kPanelWords, k_hi);
    }
    galah::cp_async_commit();

    const uint32_t sa = base + (p % kStages) * kStageBytes;
    const uint32_t sb = sa + kOperandBytes;
#pragma unroll
    for (int kk = 0; kk < kRowBytes / 32; ++kk) {  // k256 steps: 2 chunks
      uint32_t af[4][4];
      uint32_t bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // Matrices: rows 0-7 / 8-15 of the m16 tile, chunk 2kk / 2kk+1.
        const int r = wm * 64 + i * 16 + (lane & 15);
        ldmatrix_x4(af[i], sa + galah::swizzle128(r, 2 * kk + (lane >> 4)));
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // Matrices: (n8 tile 2j, chunk 2kk), (2j, 2kk+1), (2j+1, 2kk),
        // (2j+1, 2kk+1).
        const int r = wn * 32 + j * 16 + (lane & 7) + ((lane >> 4) << 3);
        uint32_t t[4];
        ldmatrix_x4(t, sb + galah::swizzle128(r, 2 * kk + ((lane >> 3) & 1)));
        bf[2 * j][0] = t[0];
        bf[2 * j][1] = t[1];
        bf[2 * j + 1][0] = t[2];
        bf[2 * j + 1][1] = t[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_and_popc(acc[i][j], af[i], bf[j][0], bf[j][1]);
        }
      }
    }
  }

  // Accumulator e of an m16n8 tile: row g (+8 for e >= 2), column
  // 2 * (lane % 4) + (e & 1), with g = lane / 4.
  const bool split = gridDim.z > 1;
  const int g = lane >> 2;
  const int cq = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row0 + wm * 64 + i * 16 + g;
      const int c = col0 + wn * 32 + j * 8 + cq;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        galah::put_count(out, m, n, r + 8 * (e >> 1), c + (e & 1),
                         acc[i][j][e], split);
      }
    }
  }
}

template <bool kVec>
cudaError_t launch(const uint32_t* a, const uint32_t* b, int32_t* out, int m,
                   int n, int w, int split_words, dim3 grid,
                   cudaStream_t stream) {
  // Per launch: the attribute belongs to the current device's context.
  const cudaError_t attr = cudaFuncSetAttribute(
      popcount_screen_kernel<kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return attr;
  popcount_screen_kernel<kVec><<<grid, kThreads, kSmemBytes, stream>>>(
      a, b, out, m, n, w, split_words);
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Rows are row-major and contiguous; a and b may alias.
// split_words (a multiple of 32) is the W range of each blockIdx.z; with
// more than one range, `out` must hold zeros.
extern "C" int galah_popcount_screen(const uint32_t* a, const uint32_t* b,
                                     int32_t* out, int m, int n, int w,
                                     int split_words, cudaStream_t stream) {
  dim3 grid;
  cudaError_t err =
      galah::count_grid(m, n, w, split_words, kPanelWords, kTile, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  err = galah::vector_loads_ok(a, b, w)
            ? launch<true>(a, b, out, m, n, w, split_words, grid, stream)
            : launch<false>(a, b, out, m, n, w, split_words, grid, stream);
  return static_cast<int>(err);
}
