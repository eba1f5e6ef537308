// Packed-bitmap intersection counts for the all-vs-all screen:
//   out[i][j] = sum_k popcount(a[i][k] & b[j][k])
// over row-major uint32 rows a (m, w) and b (n, w); out is (m, n) int32.
//
// Replaces galah_tpu/ops/packed_matmul.py::_fused_kernel, the Pallas
// kernel that unpacks K-panels to int8 in VMEM and runs an int8 x int8 ->
// int32 dot on the TPU's matrix unit. This kernel keeps that formulation
// on Hopper's tensor cores: packed K-panels are unpacked to int8 0/1 in
// shared memory and multiplied by `wgmma.mma_async.m64n128k32.s32.s8.s8`.
// The unpacked form never reaches device memory (32x the packed bytes).
//
// Design:
// - one block of two warpgroups per 128 x 128 output tile; warpgroup g
//   owns rows 64g..64g+63 against all 128 columns (64 int32 accumulators
//   per thread);
// - K-panels of 4 words (128 bits) per row, 16 bytes, arrive in a 4-stage
//   ring by cp.async through L1 (the row's other sector half is the next
//   panel's);
// - each thread unpacks one row of the panel (threads 0-127 the A rows,
//   128-255 the B rows) into a 128-byte int8 row of a double-buffered
//   tile, in the 128-byte swizzled K-major layout that the wgmma
//   descriptors name. Any bit permutation shared by both operands gives
//   the same counts, so the unpack is cheap: (x >> s) & 0x01010101 puts
//   bits s, s+8, s+16, s+24 of word x into 4 int8 lanes, and the 8 shifts
//   of a word fill its 32 bytes of K;
// - each panel is 4 wgmma k32 steps per warpgroup, issued asynchronously,
//   so the unpack of panel p + 1 overlaps the tensor cores on panel p;
// - W is split across blockIdx.z when the output tiles alone cannot fill
//   the card's 132 SMs (the wrapper's launch planner picks the split);
//   partial counts then meet in int32 atomics (intersect_common.cuh).
//
// What bounds it: the unpack. Per 128-bit panel a block does 128 x 128 x
// 128 int8 MACs (512 tensor-core cycles of an SM at the int8 peak),
// writes 32 KiB of unpacked int8 (256 rows) and its wgmma reads 48 KiB of
// shared memory. Built with -DGALAH_TIMING_VARIANTS, the library also
// has galah_packed_popcount_variant, which times the unpack alone and the
// tensor-core product alone (galah_tpu_torch/tools/k1_split_timing.py).

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "intersect_common.cuh"

namespace {

constexpr int kTile = 128;                            // output rows, columns
constexpr int kThreads = 256;                         // two warpgroups
constexpr int kPanelWords = 4;                        // 128 bits of K
constexpr int kStages = 4;                            // packed-panel ring
constexpr int kRowBytes = kPanelWords * 32;           // unpacked: 128 int8
constexpr int kOperandBytes = kTile * kRowBytes;      // 16 KiB
constexpr int kUnpackedBytes = 2 * kOperandBytes;     // A then B
constexpr int kPackedBytes = 2 * kTile * 16;          // 4 KiB per stage
constexpr int kSmemBytes =
    2 * kUnpackedBytes + kStages * kPackedBytes + 1024;  // + alignment slack

// What a launch runs: the kernel, or one half of it for timing (only
// under GALAH_TIMING_VARIANTS).
enum Mode { kFull = 0, kUnpackOnly = 1, kMmaOnly = 2 };

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  // K-major operand with 128-byte swizzle: 8-row atoms of 128-byte rows,
  // atoms 1024 bytes apart (SBO); the leading offset is unused here.
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += A (64 x 32 int8, at desc_a) . B (128 x 32 int8, at desc_b)^T.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// Thread t stages words [k0, k0 + 4) of its row: A row t, or B row t - 128.
template <bool kVec>
__device__ __forceinline__ void load_panel(uint32_t slot,
                                           const uint32_t* __restrict__ a,
                                           const uint32_t* __restrict__ b,
                                           int row0, int col0, int m, int n,
                                           int w, int k0, int k_hi) {
  const int t = threadIdx.x;
  const uint32_t dst = slot + 16 * t;
  if (t < kTile) {
    galah::stage_chunk<kVec, true>(dst, a, row0 + t, m, k0, k_hi, w);
  } else {
    galah::stage_chunk<kVec, true>(dst, b, col0 + t - kTile, n, k0, k_hi, w);
  }
}

// Thread t expands its row's 4 packed words into 128 int8 0/1 values:
// 16-byte chunk 2q + h holds (x_q >> (4h + s)) & 0x01010101, s = 0..3.
__device__ __forceinline__ void unpack_row(uint32_t slot, uint32_t tile) {
  const int t = threadIdx.x;
  uint32_t x[4];
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
               : "r"(slot + 16 * t)
               : "memory");
  const int r = t & (kTile - 1);
  const uint32_t row = tile + (t < kTile ? 0 : kOperandBytes);
  constexpr uint32_t kLanes = 0x01010101u;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t v = x[q] >> (4 * h);
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                   :: "r"(row + galah::swizzle128(r, 2 * q + h)),
                      "r"(v & kLanes), "r"((v >> 1) & kLanes),
                      "r"((v >> 2) & kLanes), "r"((v >> 3) & kLanes)
                   : "memory");
    }
  }
}

template <bool kVec, int kMode>
__global__ void __launch_bounds__(kThreads, 2)
packed_popcount_kernel(const uint32_t* __restrict__ a,
                       const uint32_t* __restrict__ b,
                       int32_t* __restrict__ out, int m, int n, int w,
                       int split_words) {
  extern __shared__ __align__(1024) uint8_t smem[];
  // The swizzled tiles need 1024-byte aligned bases.
  const uint32_t base = (galah::smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t unpacked = base;                      // 2 x (A, B)
  const uint32_t packed = base + 2 * kUnpackedBytes;   // kStages slots

  const int t = threadIdx.x;
  const int wg = t >> 7;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int k_lo = blockIdx.z * split_words;
  const int k_hi = min(w, k_lo + split_words);
  const int panels = k_hi > k_lo ? (k_hi - k_lo + kPanelWords - 1) / kPanelWords
                                 : 0;

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  if (kMode != kMmaOnly) {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < panels) {
        load_panel<kVec>(packed + s * kPackedBytes, a, b, row0, col0, m, n, w,
                         k_lo + s * kPanelWords, k_hi);
      }
      galah::cp_async_commit();
    }
  }

  for (int p = 0; p < panels; ++p) {
    const uint32_t tile = unpacked + (p & 1) * kUnpackedBytes;
    if (kMode != kMmaOnly) {
      galah::cp_async_wait<kStages - 2>();
      // Panel p has landed for every thread; every warpgroup has waited
      // out its product on panel p - 2, whose tile this unpack reuses;
      // the slot the next copy overwrites (panel p - 1's) is unpacked.
      __syncthreads();
      const int q = p + kStages - 1;
      if (q < panels) {
        load_panel<kVec>(packed + (q % kStages) * kPackedBytes, a, b, row0,
                         col0, m, n, w, k_lo + q * kPanelWords, k_hi);
      }
      galah::cp_async_commit();
      unpack_row(packed + (p % kStages) * kPackedBytes, tile);
      // Make the generic-proxy stores visible to the tensor cores.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();
    if (kMode != kUnpackOnly) {
      const uint64_t da = smem_desc(tile + wg * 64 * kRowBytes);
      const uint64_t db = smem_desc(tile + kOperandBytes);
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kRowBytes / 32; ++kk) {
        // A k32 step is 32 bytes along the swizzled row: 2 in 16-byte units.
        wgmma_s8(acc, da + 2 * kk, db + 2 * kk);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(acc);
    }
  }
  if (kMode != kUnpackOnly) {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
  }

  // Accumulator 4j + e of warp v of the warpgroup: row 16v + g (+8 for
  // e >= 2), column 8j + 2 (lane % 4) + (e & 1), with g = lane / 4.
  const bool split = gridDim.z > 1;
  const int lane = t & 31;
  const int r = row0 + wg * 64 + ((t & 127) >> 5) * 16 + (lane >> 2);
  const int c = col0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      galah::put_count(out, m, n, r + 8 * (e >> 1), c + 8 * j + (e & 1),
                       acc[4 * j + e], split);
    }
  }
}

template <bool kVec, int kMode>
cudaError_t launch(const uint32_t* a, const uint32_t* b, int32_t* out, int m,
                   int n, int w, int split_words, dim3 grid,
                   cudaStream_t stream) {
  // Per launch: the attribute belongs to the current device's context.
  const cudaError_t attr = cudaFuncSetAttribute(
      packed_popcount_kernel<kVec, kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return attr;
  packed_popcount_kernel<kVec, kMode><<<grid, kThreads, kSmemBytes, stream>>>(
      a, b, out, m, n, w, split_words);
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Rows are row-major and contiguous; a and b may alias.
// split_words (a multiple of 4) is the W range of each blockIdx.z; with
// more than one range, `out` must hold zeros.
extern "C" int galah_packed_popcount(const uint32_t* a, const uint32_t* b,
                                     int32_t* out, int m, int n, int w,
                                     int split_words, cudaStream_t stream) {
  dim3 grid;
  cudaError_t err =
      galah::count_grid(m, n, w, split_words, kPanelWords, kTile, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  err = galah::vector_loads_ok(a, b, w)
            ? launch<true, kFull>(a, b, out, m, n, w, split_words, grid,
                                  stream)
            : launch<false, kFull>(a, b, out, m, n, w, split_words, grid,
                                   stream);
  return static_cast<int>(err);
}

#ifdef GALAH_TIMING_VARIANTS
// The same launch with half of the kernel, for timing only: mode 1 stages
// and unpacks every panel but runs no product (out gets zeros), mode 2
// runs every product on whatever the tiles hold (out gets garbage).
// Needs the 16-byte-aligned layout.
extern "C" int galah_packed_popcount_variant(const uint32_t* a,
                                             const uint32_t* b, int32_t* out,
                                             int m, int n, int w,
                                             int split_words, int mode,
                                             cudaStream_t stream) {
  dim3 grid;
  cudaError_t err =
      galah::count_grid(m, n, w, split_words, kPanelWords, kTile, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  if (!galah::vector_loads_ok(a, b, w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (mode) {
    case kUnpackOnly:
      err = launch<true, kUnpackOnly>(a, b, out, m, n, w, split_words, grid,
                                      stream);
      break;
    case kMmaOnly:
      err = launch<true, kMmaOnly>(a, b, out, m, n, w, split_words, grid,
                                   stream);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
#endif  // GALAH_TIMING_VARIANTS
