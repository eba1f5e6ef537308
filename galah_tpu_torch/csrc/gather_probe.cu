// The gather probe's two kernels:
//   out[0][:] = XOR over i < ns of table[idx[i]][:]
// over int32 indices idx (ns,) and a row-major uint32 table (wt, 8); out
// is (1, 8) uint32 and must be zeroed by the caller (the kernels XOR their
// partial results into it).
//
// galah_gather_xor replaces benchmarks/pallas_gather_probe.py::
// pallas_gather (K3), the Pallas kernel that walks the indices from SMEM
// and XORs each row of a VMEM-resident table into ONE accumulator, with
// `unroll` rows per loop step: a serial dependence chain on the TPU's
// scalar unit. Here each thread keeps one accumulator as well and loads
// `unroll` indices per step before XORing their rows in order.
//
// galah_gather_xor_chains replaces pallas_gather_chains (K4), which keeps
// `unroll` independent accumulators, combined once at the end. Here each
// thread keeps `unroll` accumulators, one per index of its step.
//
// Layout, both kernels:
// - two lanes per table row: lane parity picks the row's first or second
//   16 bytes, so a lane pair reads one whole 32-byte sector and a warp 16
//   rows per step;
// - a grid-stride loop over the indices, `unroll` indices per lane pair
//   and step, at strides of the grid's lane-pair count so neighbouring
//   pairs read neighbouring indices;
// - after the loop: __shfl_xor_sync folds the lanes of each parity across
//   the warp, shared memory folds the warps, and 8 threads of each block
//   atomicXor the block's 8 words into out.
// An index outside [0, wt) is never read: the kernel traps, which the
// host sees as a CUDA error, as it would a device-side assert from torch's
// own indexing.
//
// What bounds it: memory. Each index costs one 4-byte index load and one
// 32-byte row sector; the XORs are 8 integer operations per index. At the
// probe's reference shape (2^17 indices into 2^17 rows, 4 MiB) the table
// sits in the 50 MB L2 and the bound is 4.5 MiB of index and row reads,
// ~1.4 us at 3.35 TB/s, so launch and tail dominate. With a table larger
// than L2 (2^23 rows, 256 MiB) the rows come from HBM as random 32-byte
// sectors, and that sector rate is what sizes the verify programs' word
// gathers.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPairsPerBlock = kThreads / 2;
constexpr int kWarps = kThreads / 32;
constexpr int kRowWords = 8;  // the uint32 words of a row
constexpr int kMaxBlocks = 132 * 16;

__device__ __forceinline__ void xor_into(uint4& acc, const uint4& v) {
  acc.x ^= v.x;
  acc.y ^= v.y;
  acc.z ^= v.z;
  acc.w ^= v.w;
}

// kChains false: one accumulator (K3); true: kUnroll accumulators (K4).
template <int kUnroll, bool kChains>
__global__ void __launch_bounds__(kThreads)
gather_xor_kernel(const int32_t* __restrict__ idx,
                  const uint4* __restrict__ table,
                  uint32_t* __restrict__ out, int ns, int wt) {
  __shared__ uint4 warp_acc[kWarps][2];

  const int half = threadIdx.x & 1;
  const long long pair =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 1;
  const long long npairs =
      static_cast<long long>(gridDim.x) * kPairsPerBlock;

  uint4 acc[kChains ? kUnroll : 1];
#pragma unroll
  for (int u = 0; u < (kChains ? kUnroll : 1); ++u)
    acc[u] = make_uint4(0u, 0u, 0u, 0u);

  for (long long base = pair; base < ns; base += npairs * kUnroll) {
    int ix[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * npairs;
      ix[u] = i < ns ? __ldg(idx + i) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * npairs >= ns) continue;
      if (static_cast<unsigned>(ix[u]) >= static_cast<unsigned>(wt)) __trap();
      const uint4 row =
          __ldg(table + static_cast<size_t>(ix[u]) * 2 + half);
      xor_into(acc[kChains ? u : 0], row);
    }
  }

  uint4 mine = acc[0];
#pragma unroll
  for (int u = 1; u < (kChains ? kUnroll : 1); ++u) xor_into(mine, acc[u]);

  // Fold the lanes of each parity: lanes 0 and 1 end with their halves.
#pragma unroll
  for (int off = 16; off >= 2; off >>= 1) {
    mine.x ^= __shfl_xor_sync(0xffffffffu, mine.x, off);
    mine.y ^= __shfl_xor_sync(0xffffffffu, mine.y, off);
    mine.z ^= __shfl_xor_sync(0xffffffffu, mine.z, off);
    mine.w ^= __shfl_xor_sync(0xffffffffu, mine.w, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane < 2) warp_acc[warp][lane] = mine;
  __syncthreads();
  if (threadIdx.x < kRowWords) {
    const int h = threadIdx.x / 4;
    const int k = threadIdx.x % 4;
    uint32_t word = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      word ^= reinterpret_cast<const uint32_t*>(&warp_acc[w][h])[k];
    atomicXor(out + threadIdx.x, word);
  }
}

template <bool kChains>
int launch(const int32_t* idx, const uint32_t* table, uint32_t* out, int ns,
           int wt, int unroll, cudaStream_t stream) {
  if (ns < 0 || wt <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (ns == 0) return static_cast<int>(cudaSuccess);
  const long long per_block = static_cast<long long>(kPairsPerBlock) * unroll;
  const long long want = (ns + per_block - 1) / per_block;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  const auto* rows = reinterpret_cast<const uint4*>(table);
  switch (unroll) {
#define GALAH_GATHER_CASE(U)                                             \
  case U:                                                                \
    gather_xor_kernel<U, kChains>                                        \
        <<<blocks, kThreads, 0, stream>>>(idx, rows, out, ns, wt);       \
    break;
    GALAH_GATHER_CASE(1)
    GALAH_GATHER_CASE(4)
    GALAH_GATHER_CASE(8)
    GALAH_GATHER_CASE(16)
    GALAH_GATHER_CASE(32)
#undef GALAH_GATHER_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 on success).
// idx is contiguous int32, table row-major (wt, 8) uint32 and 16-byte
// aligned, out 8 zeroed uint32 words; unroll is 1, 4, 8, 16 or 32.
extern "C" int galah_gather_xor(const int32_t* idx, const uint32_t* table,
                                uint32_t* out, int ns, int wt, int unroll,
                                cudaStream_t stream) {
  return launch<false>(idx, table, out, ns, wt, unroll, stream);
}

extern "C" int galah_gather_xor_chains(const int32_t* idx,
                                       const uint32_t* table, uint32_t* out,
                                       int ns, int wt, int unroll,
                                       cudaStream_t stream) {
  return launch<true>(idx, table, out, ns, wt, unroll, stream);
}
