// The gather probe's kernel:
//   out[0][:] = XOR over i < ns of table[idx[i]][:]
// over int32 indices idx (ns,) and a row-major uint32 table (wt, 8) of
// 32-byte rows; out is (1, 8) uint32 and must be zeroed by the caller
// (the blocks XOR their partial results into it).
//
// They replace benchmarks/pallas_gather_probe.py::pallas_gather (K3, one
// accumulator, `unroll` rows a loop step) and pallas_gather_chains (K4,
// `unroll` independent accumulators). On the TPU the two differ because
// one scalar unit walks the indices: K3's single accumulator is a serial
// dependence chain, K4 exposes `unroll` chains to the scheduler. Here
// thousands of threads each walk their own indices, every load of a step
// is issued before any XOR uses it, and an XOR costs one LOP3 of a 32-
// byte row's 8 words: a chain of dependent XORs never limits either.
// So K3 and K4 are one kernel, with their own C entries and `unroll`,
// which is the number of 16-byte row loads a thread keeps in flight
// (rounded up to an even number: a lane pair reads a whole row).
//
// Layout: each warp loads 32 indices at a time, one a lane (coalesced,
// each once), and lane pairs read the 32 rows, 16 bytes a lane, the
// index shuffled to the pair, so one warp load instruction asks for 16
// whole 32-byte sectors. Rows and indices are read with
// ld.global.nc.L1::no_allocate: a random row is not read again, and none
// evicts another from L1. The grid is persistent: as many blocks as are
// resident at once on every SM, each walking the indices at a stride of
// the grid's warps, so there is no second wave and no tail. After the
// loop, __shfl_xor_sync folds the lanes of each parity across the warp,
// shared memory folds the warps, and 8 threads of each block atomicXor
// the block's 8 words into out.
//
// What bounds it on an H100: device memory, and for a table larger than
// L2 the rate of random accesses to it, not the bytes. A random 32-byte
// row costs a DRAM access of the L2 fetch size (64 bytes); the probe's
// index patterns (tools/gather_probe.py, run_patterns) show the same
// kernel 2x faster on the same indices sorted, and streaming all the
// table's rows (twice as many) in less time than the random half, so its
// issue rate does not hold it.
// A partitioned route that grouped the indices by 112 KiB tile (a stable
// counting partition) and streamed each tile through shared memory by
// TMA was measured against this one at the probe's 256 MiB table and
// lost (PERF.md, "Drafts not kept").
//
// An index outside [0, wt) is never read: the kernel traps, which the
// host sees as a CUDA error, as it would a device-side assert from
// torch's own indexing.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRowWords = 8;  // the uint32 words of a row
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void xor_into(uint4& acc, const uint4& v) {
  acc.x ^= v.x;
  acc.y ^= v.y;
  acc.z ^= v.z;
  acc.w ^= v.w;
}

__device__ __forceinline__ int load_index(const int32_t* p) {
  int v;
  asm volatile("ld.global.nc.L1::no_allocate.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p));
  return v;
}

__device__ __forceinline__ uint4 load_row_half(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// kGroups groups of 32 indices a warp step: 2 * kGroups 16-byte row loads
// in flight a thread.
template <int kGroups>
__global__ void __launch_bounds__(kThreads)
gather_xor_kernel(const int32_t* __restrict__ idx,
                  const uint4* __restrict__ table,
                  uint32_t* __restrict__ out, int ns, int wt) {
  __shared__ uint4 warp_acc[kWarps][2];

  const int lane = threadIdx.x & 31;
  const int half = lane & 1;
  const int pair = lane >> 1;
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  const long long ngroups = (static_cast<long long>(ns) + 31) / 32;

  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  for (long long g0 = warp; g0 < ngroups; g0 += nwarps * kGroups) {
    int ix[kGroups];
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const long long i = (g0 + u * nwarps) * 32 + lane;
      ix[u] = -1;
      if (i < ns) {
        ix[u] = load_index(idx + i);
        if (static_cast<unsigned>(ix[u]) >= static_cast<unsigned>(wt))
          __trap();
      }
    }
    uint4 row[2 * kGroups];
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int r = __shfl_sync(0xffffffffu, ix[u], s * 16 + pair);
        row[2 * u + s] =
            r >= 0 ? load_row_half(table + static_cast<size_t>(r) * 2 + half)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int k = 0; k < 2 * kGroups; ++k) xor_into(acc, row[k]);
  }
  // Fold the lanes of each parity: lanes 0 and 1 end with their halves.
#pragma unroll
  for (int off = 16; off >= 2; off >>= 1) {
    acc.x ^= __shfl_xor_sync(0xffffffffu, acc.x, off);
    acc.y ^= __shfl_xor_sync(0xffffffffu, acc.y, off);
    acc.z ^= __shfl_xor_sync(0xffffffffu, acc.z, off);
    acc.w ^= __shfl_xor_sync(0xffffffffu, acc.w, off);
  }
  if (lane < 2) warp_acc[threadIdx.x >> 5][lane] = acc;
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

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

template <int kGroups>
int launch_groups(const int32_t* idx, const uint32_t* table, uint32_t* out,
                  int ns, int wt, cudaStream_t stream) {
  // Blocks resident at once on the current device, asked on every launch
  // (a few microseconds) so that no cached value outlives a device switch.
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gather_xor_kernel<kGroups>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int resident = per_sm * sm_count();
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long groups = (static_cast<long long>(ns) + 31) / 32;
  const long long per_block = static_cast<long long>(kWarps) * kGroups;
  const long long want = (groups + per_block - 1) / per_block;
  const int blocks = static_cast<int>(want < resident ? want : resident);
  gather_xor_kernel<kGroups><<<blocks, kThreads, 0, stream>>>(
      idx, reinterpret_cast<const uint4*>(table), out, ns, wt);
  return static_cast<int>(cudaGetLastError());
}

int launch(const int32_t* idx, const uint32_t* table, uint32_t* out, int ns,
           int wt, int unroll, cudaStream_t stream) {
  if (ns < 0 || wt <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (ns == 0) return static_cast<int>(cudaSuccess);
  switch (unroll) {
    case 1:
      return launch_groups<1>(idx, table, out, ns, wt, stream);
    case 4:
      return launch_groups<2>(idx, table, out, ns, wt, stream);
    case 8:
      return launch_groups<4>(idx, table, out, ns, wt, stream);
    case 16:
      return launch_groups<8>(idx, table, out, ns, wt, stream);
    case 32:
      return launch_groups<16>(idx, table, out, ns, wt, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Every entry launches on `stream` and returns cudaGetLastError() (0 on
// success). idx is contiguous int32, table row-major (wt, 8) uint32 and
// 16-byte aligned, out 8 zeroed uint32 words.

// unroll is 1, 4, 8, 16 or 32.
extern "C" int galah_gather_xor(const int32_t* idx, const uint32_t* table,
                                uint32_t* out, int ns, int wt, int unroll,
                                cudaStream_t stream) {
  return launch(idx, table, out, ns, wt, unroll, stream);
}

extern "C" int galah_gather_xor_chains(const int32_t* idx,
                                       const uint32_t* table, uint32_t* out,
                                       int ns, int wt, int unroll,
                                       cudaStream_t stream) {
  return launch(idx, table, out, ns, wt, unroll, stream);
}

