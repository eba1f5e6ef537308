// The verify's shared parts, for K7 (pair_table_verify.cu) and K8
// (grouped_verify.cu): a target bitmap row held on chip by a thread-block
// cluster, a round of fragments counted against it, and the epilogue that
// turns a fragment's count into its identity.
//
// The row on chip. A row of `bits` bits is split into `blocks` slices of
// 2^shift bits, one in each block of a cluster: one block up to 2^20 bits
// (128 KiB), 2 blocks at 2^21 and 4 at 2^22 (ops/pair_table.py::
// verify_launch_plan, whose numbers the C entries take). Thread 0 stages
// its block's slice with TMA bulk copies (cp.async.bulk) that complete on
// an mbarrier; a thread waits on that barrier before its first read. Each
// bit test then reads shared memory, where the previous design read a
// random 32-byte L2 sector of a 512 KiB row (~135 G tests/s on the H100).
// (K7 reads rows of up to 2^20 bits through L1 instead, which holds
// them: pair_table_verify.cu.)
//
// A round is up to kMaxRound fragments of one query stream. The block
// copies their bounds into shared memory and sets its run in each
// (plan_round); a subgroup of lanes counts a run's hits, kUnroll stream
// loads in flight a lane (count_round). With a cluster, the blocks then
// synchronise and block 0 adds their counts through distributed shared
// memory (round_count); block 0 runs the epilogue. A block of a cluster
// tests only the hashes of its own slice: their run in each fragment lies
// around where uniform buckets put the slice's bounds, which the warp
// reads for the whole group at once (slice_runs, with a full search when
// a bound is not there). The stream must ascend within each fragment, as
// every producer writes it (np.unique of fragment * bits + bucket, K5's
// sort). (Two other ways were timed and dropped, PERF.md §6: a block
// reading every hash and testing those of its slice, and a fragment a
// block reading each word from the block that holds it.)
//
// The epilogue is the float32 arithmetic of the port's plain versions
// (ops/pair_table.py::_pair_table_plain, ops/fragment_ani.py::
// _ani_af_from_counts; the JAX package's galah_tpu/ops/pair_table.py
// :299-305 and fragment_ani.py:137) in their order, one rounding a torch
// operation:
//   p     = popcount * (1 / bits)      torch on the card multiplies by the
//                                      reciprocal of a host scalar divisor;
//                                      exact, since bits is a power of two
//   c     = (m - M * p) / max(1 - p, 1e-6), clamped to [0, M]
//   cont  = c / max(M, 1)
//   ident = powf(max(cont, 1e-30), 1 / k)
//   usable = M >= min_hashes, aligned = usable && ident >= min_ident
// Products and differences are written with round-to-nearest intrinsics,
// so nvcc cannot contract M * p and the subtraction into an FMA; powf is
// the libdevice function torch's pow kernel calls for float32, with the
// float32 exponent torch receives (the caller passes it). The sources are
// built without --use_fast_math.

#pragma once

#include <climits>
#include <cstdint>
#include <mutex>
#include <vector>

#include <cuda_runtime.h>

namespace galah_verify {

constexpr int kMaxRound = 1024;      // fragments a round, at most
constexpr uint32_t kCopyBytes = 1u << 15;  // bytes a bulk copy
constexpr int kGroupMax = 4;         // fragments a warp bounds at once
constexpr int kUnroll = 16;          // stream loads in flight a lane
constexpr int kWindow = 64;          // positions read around a slice bound
// torch.clamp's results for finite x (a NaN passes, as in torch).
__device__ __forceinline__ float floor_at(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float ceil_at(float x, float hi) {
  return x > hi ? hi : x;
}

struct Fragment {
  bool usable;
  bool aligned;
  float ident;
};

// One fragment of M hashes with m of them set in a bitmap of popcount
// density p.
__device__ __forceinline__ Fragment fragment_epilogue(int m, int M, float p,
                                                      float inv_k,
                                                      int min_hashes,
                                                      float min_ident) {
  const float mf = __int2float_rn(m);
  const float Mf = __int2float_rn(M);
  float c = __fdiv_rn(__fsub_rn(mf, __fmul_rn(Mf, p)),
                      floor_at(__fsub_rn(1.0f, p), 1e-6f));
  c = ceil_at(floor_at(c, 0.0f), Mf);
  const float cont = __fdiv_rn(c, floor_at(Mf, 1.0f));
  const float ident = powf(floor_at(cont, 1e-30f), inv_k);
  Fragment out;
  out.usable = M >= min_hashes;
  out.aligned = out.usable && ident >= min_ident;
  out.ident = ident;
  return out;
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_blocks() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return static_cast<int>(n);
}

// Every thread of every block of the cluster: what each wrote to shared
// memory before is seen by all after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The 32-bit word at shared address `addr` of the cluster's block `rank`.
__device__ __forceinline__ uint32_t ld_cluster(uint32_t addr, uint32_t rank) {
  uint32_t remote, v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(remote));
  return v;
}

struct Slice {
  const uint32_t* words;  // this block's slice of the row, shared memory
  uint32_t base;          // its shared address
  uint32_t mask;          // words a slice - 1
  uint32_t bar;           // shared address of the staging mbarrier
  int shift;              // log2 of a slice's bits
  int row_shift;          // log2 of a row's bits
  int rank;               // this block's rank in its cluster
  int blocks;             // the cluster's blocks
};

// Thread 0: an mbarrier at shared address `bar` that completes once
// `bytes` have landed, for every thread after a __syncthreads.
__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

// Thread 0: TMA bulk copies of `bytes` (a multiple of 16) from `src` to
// shared address `dst`, both 16-byte aligned, completing on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  const char* from = static_cast<const char*>(src);
  for (uint32_t off = 0; off < bytes; off += kCopyBytes) {
    const uint32_t n = bytes - off < kCopyBytes ? bytes - off : kCopyBytes;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        ::"r"(dst + off), "l"(from + off), "r"(n), "r"(bar)
        : "memory");
  }
}

// Returns once the bulk copies on mbarrier `bar` have landed.
__device__ __forceinline__ void wait_bytes(uint32_t bar) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar) : "memory");
  } while (!done);
}

// Stages this block's slice of `row` (2^shift bits from bit rank 2^shift)
// into `smem`: thread 0 sets the mbarrier and issues the bulk copies;
// every thread returns the block's Slice after a __syncthreads. The slice
// is readable after wait_staged.
__device__ __forceinline__ Slice stage_slice(uint32_t* smem, uint64_t* bar,
                                             const uint32_t* row, int shift) {
  Slice s;
  s.words = smem;
  s.base = shared_addr(smem);
  s.mask = (1u << (shift - 5)) - 1u;
  s.bar = shared_addr(bar);
  s.shift = shift;
  s.rank = cluster_rank();
  s.blocks = cluster_blocks();
  s.row_shift = shift;
  while ((1 << (s.row_shift - shift)) < s.blocks) ++s.row_shift;
  if (threadIdx.x == 0) {
    const uint32_t bytes = 1u << (shift - 3);
    expect_bytes(s.bar, bytes);
    bulk_copy(s.base, reinterpret_cast<const char*>(row) +
                          static_cast<size_t>(s.rank) * bytes,
              bytes, s.bar);
  }
  __syncthreads();
  return s;
}

// Returns once the slice's bulk copies have landed.
__device__ __forceinline__ void wait_staged(const Slice& s) {
  wait_bytes(s.bar);
}

__device__ __forceinline__ int bit_of(uint32_t word, int32_t b) {
  return static_cast<int>((word >> (b & 31)) & 1u);
}

// The first position of stream[lo, hi), ascending there, whose bucket is
// at least v, found by the warp together: each round reads 32 evenly
// spaced candidates and keeps the stretch between the last one below v
// and the first one at or above it. Warp-uniform.
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ stream,
                                           int lo, int hi, int32_t v) {
  const int lane = threadIdx.x & 31;
  for (;;) {
    const int n = hi - lo;
    const int step = n > 32 ? (n + 31) >> 5 : 1;
    const int p = lo + lane * step;
    const int32_t x = p < hi ? __ldg(stream + p) : INT_MAX;
    const int c = __popc(__ballot_sync(0xffffffffu, x < v));
    if (n <= 32) return lo + c;
    const int next = c > 0 ? lo + (c - 1) * step + 1 : lo;
    hi = min(hi, lo + c * step);
    lo = next;
  }
}

// Narrows each fragment [lo, hi) of a group to its run in this block's
// slice, the stream ascending there. Uniform buckets put the slice's
// bound v at lo + (hi - lo) * v / bits, within a few sqrt(hi - lo) of it:
// the warp reads kWindow positions around each guess, for every fragment
// of the group at once, and searches a fragment's whole range
// (lower_bound) only when a bound lies outside its window.
__device__ __forceinline__ void slice_runs(const int32_t* __restrict__ stream,
                                           int (&lo)[kGroupMax],
                                           int (&hi)[kGroupMax],
                                           const Slice& s) {
  const int lane = threadIdx.x & 31;
  int start[kGroupMax][2];
  int32_t w[kGroupMax][2][2];
#pragma unroll
  for (int f = 0; f < kGroupMax; ++f) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool needed = e == 0 ? s.rank > 0 : s.rank + 1 < s.blocks;
      const int64_t v = static_cast<int64_t>(s.rank + e) << s.shift;
      const int guess = lo[f] + static_cast<int>(
          (static_cast<int64_t>(hi[f] - lo[f]) * v) >> s.row_shift);
      start[f][e] = max(lo[f], min(guess - kWindow / 2, hi[f] - kWindow));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = start[f][e] + lane + 32 * h;
        w[f][e][h] = needed && p < hi[f] ? __ldg(stream + p) : INT_MAX;
      }
    }
  }
#pragma unroll
  for (int f = 0; f < kGroupMax; ++f) {
    int bound[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int32_t v = (s.rank + e) << s.shift;
      const int c = __popc(__ballot_sync(0xffffffffu, w[f][e][0] < v)) +
                    __popc(__ballot_sync(0xffffffffu, w[f][e][1] < v));
      const int end = min(hi[f], start[f][e] + kWindow);
      if (e == 0 && s.rank == 0) {
        bound[e] = lo[f];
      } else if (e == 1 && s.rank + 1 == s.blocks) {
        bound[e] = hi[f];
      } else if ((start[f][e] == lo[f] || c > 0) &&
                 (end == hi[f] || c < end - start[f][e])) {
        bound[e] = start[f][e] + c;
      } else {
        bound[e] = lower_bound(stream, lo[f], hi[f], v);
      }
    }
    lo[f] = bound[0];
    hi[f] = bound[1];
  }
}

// A round's arrays in shared memory, after the block's slice.
struct Round {
  int* offs;  // [round + 1] the fragments' bounds in the stream
  int* lo;    // [round] this block's run of each fragment
  int* hi;    // [round]
  int* part;  // [round] this block's hits in each run
};

// 32-bit words of shared memory a Round of `round` fragments takes.
__host__ __device__ constexpr int round_words(int round) {
  return 4 * round + 1;
}

__device__ __forceinline__ Round round_at(uint32_t* words, int round) {
  Round r;
  r.offs = reinterpret_cast<int*>(words);
  r.lo = r.offs + round + 1;
  r.hi = r.lo + round;
  r.part = r.hi + round;
  return r;
}

// Every thread of the block's cluster (kSliced) or of the block: what each
// wrote to shared memory before is seen by all after.
template <bool kSliced>
__device__ __forceinline__ void sync_blocks() {
  if (kSliced) {
    cluster_sync();
  } else {
    __syncthreads();
  }
}

// Copies offsets[0..nf] into r.offs and sets each fragment's run: with a
// cluster this block's slice of it (slice_runs, a warp bounding up to
// kGroupMax fragments at once), else the whole fragment. Every thread of
// the block; ends in __syncthreads.
template <bool kSliced>
__device__ __forceinline__ void plan_round(const int32_t* __restrict__ stream,
                                           const int32_t* __restrict__ offsets,
                                           int nf, const Slice& s,
                                           const Round& r) {
  for (int i = threadIdx.x; i <= nf; i += blockDim.x) r.offs[i] = offsets[i];
  __syncthreads();
  if (kSliced) {
    const int warps = blockDim.x >> 5;
    const int per = nf / warps;
    const int size = per < 1 ? 1 : per > kGroupMax ? kGroupMax : per;
    for (int j0 = (threadIdx.x >> 5) * size; j0 < nf; j0 += warps * size) {
      const int nj = min(size, nf - j0);
      int lo[kGroupMax], hi[kGroupMax];
#pragma unroll
      for (int f = 0; f < kGroupMax; ++f) {
        lo[f] = f < nj ? r.offs[j0 + f] : 0;
        hi[f] = f < nj ? r.offs[j0 + f + 1] : 0;
      }
      slice_runs(stream, lo, hi, s);
      if ((threadIdx.x & 31) == 0) {
#pragma unroll
        for (int f = 0; f < kGroupMax; ++f) {
          if (f < nj) {
            r.lo[j0 + f] = lo[f];
            r.hi[j0 + f] = hi[f];
          }
        }
      }
    }
  } else {
    for (int j = threadIdx.x; j < nf; j += blockDim.x) {
      r.lo[j] = r.offs[j];
      r.hi[j] = r.offs[j + 1];
    }
  }
  __syncthreads();
}

// This block's hits in each run of the round into r.part: a subgroup of
// `lanes` lanes a run (the round's mean run over kUnroll, 4 to 32), each
// lane every lanes-th position with kUnroll stream loads in flight
// (coalesced within the subgroup), then the bit tests in the block's
// slice in shared memory, summed over the subgroup. `staged` is set once the slice has been waited for.
__device__ __forceinline__ void count_round(const int32_t* __restrict__ stream,
                                            int nf, const Slice& s,
                                            bool& staged, const Round& r) {
  const int lane = threadIdx.x & 31;
  const int mean = (r.offs[nf] - r.offs[0]) / max(1, nf * s.blocks);
  int lanes = 4;
  while (lanes < 32 && lanes * kUnroll < mean) lanes <<= 1;
  const int subs = 32 / lanes;
  const int sub = lane / lanes;
  const int idx = lane & (lanes - 1);
  const int stride = (blockDim.x >> 5) * subs;
  for (int base = (threadIdx.x >> 5) * subs; base < nf; base += stride) {
    const int j = base + sub;
    const int lo = j < nf ? r.lo[j] : 0;
    const int len = j < nf ? r.hi[j] - lo : 0;
    const int most = __reduce_max_sync(0xffffffffu, len);
    int hits = 0;
    for (int k0 = 0; k0 < most; k0 += lanes * kUnroll) {
      int32_t b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + idx + lanes * u;
        b[u] = k < len ? __ldg(stream + lo + k) : -1;
      }
      if (!staged) {
        wait_staged(s);
        staged = true;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (b[u] >= 0) {
          hits += bit_of(s.words[static_cast<uint32_t>(b[u]) >> 5 & s.mask],
                         b[u]);
        }
      }
    }
    for (int o = lanes >> 1; o > 0; o >>= 1) {
      hits += __shfl_xor_sync(0xffffffffu, hits, o);
    }
    if (idx == 0 && j < nf) r.part[j] = hits;
  }
}

// Fragment j's count after count_round and sync_blocks, read by block 0:
// its own part[j] without a cluster, else the sum of every block's.
template <bool kSliced>
__device__ __forceinline__ int round_count(const Round& r, int j,
                                           const Slice& s) {
  if (!kSliced) return r.part[j];
  const uint32_t addr = shared_addr(r.part + j);
  int m = 0;
  for (int q = 0; q < s.blocks; ++q) {
    m += static_cast<int>(ld_cluster(addr, q));
  }
  return m;
}

// A refused launch leaves its error as the runtime's last error; it is
// taken here, so that a later launch by torch does not report it.
inline int launch_error(cudaError_t err) {
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

// Launches `kernel` on a 1-D grid of clusters of `cluster` blocks with
// `smem` bytes of dynamic shared memory a block; returns the CUDA error
// of the attribute, the launch or the last error (0 on success).
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), long long grid, int threads,
                    int smem, int cluster, cudaStream_t stream,
                    Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return launch_error(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return launch_error(err);
  return launch_error(cudaGetLastError());
}

// How many clusters of `cluster` blocks of `threads` threads and `smem`
// bytes of dynamic shared memory the current card holds at once, into
// *out; the CUDA error. The answer depends only on these and the card, so
// it is asked of the runtime once and kept.
template <typename... Params>
int resident_clusters(void (*kernel)(Params...), int threads, int smem,
                      int cluster, int* out) {
  struct Known {
    void (*kernel)(Params...);
    int device, threads, smem, cluster, resident;
  };
  static std::mutex mu;
  static std::vector<Known> known;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return launch_error(err);
  {
    std::lock_guard<std::mutex> lock(mu);
    for (const Known& k : known) {
      if (k.kernel == kernel && k.device == device && k.threads == threads &&
          k.smem == smem && k.cluster == cluster) {
        *out = k.resident;
        return 0;
      }
    }
  }
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return launch_error(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int resident = 0;
  err = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
  if (err != cudaSuccess) return launch_error(err);
  std::lock_guard<std::mutex> lock(mu);
  known.push_back({kernel, device, threads, smem, cluster, resident});
  *out = resident;
  return 0;
}

// Whether (cluster, slice_bits, smem) is a plan the kernels take for rows
// of `words` 32-bit words: a power-of-two slice of at least one 16-byte
// copy, dynamic shared memory that holds it, and as many slices as the
// row has. The card may still refuse it (shared memory, cluster size).
inline bool plan_fits(long long words, int cluster, int slice_bits,
                      int smem) {
  return cluster >= 1 && slice_bits >= 128 &&
         (slice_bits & (slice_bits - 1)) == 0 && smem >= slice_bits / 8 &&
         words == static_cast<long long>(cluster) * (slice_bits / 32);
}

inline int log2_of(int x) {
  int s = 0;
  while ((1 << s) < x) ++s;
  return s;
}

}  // namespace galah_verify
