// K8, the grouped verify with word gathers: one query's fragment stream
// against R reference bitmaps, each bucket tested with one bit of each
// reference's row:
//   per (reference, fragment)  m = hits, M = hashes, the epilogue of
//                              verify_common.cuh
//   per reference              n_aligned, n_usable (int32) and the float32
//                              sum of the aligned fragments' identities;
//                              ani = sum / max(n_aligned, 1) * 100
//                              af  = n_aligned / max(n_usable, 1)
//
// Replaces the JAX package's device program
// galah_tpu/ops/fragment_ani.py::_forward_kernel (:1023; its epilogue
// _ani_af_from_counts :137, its counts _per_fragment_hits :160), which
// XLA fused into one program a dispatch.
//
// Design: two launches, no atomics, deterministic.
// - grouped_verify_clusters, a 1-D grid of clusters, one a (reference,
//   chunk of fragments), the reference the slow index so that the
//   clusters running together stage one row from L2. A cluster stages the
//   reference's row in its blocks' shared memory with TMA bulk copies
//   (verify_common.cuh: 4 blocks of 128 KiB at 2^22 bits, one block up to
//   2^20) and counts its chunk in rounds of up to 1,024 fragments: a
//   block finds its slice's run in each fragment and a subgroup of lanes
//   counts a run's hits (count_round); block 0 adds the cluster's counts,
//   runs the epilogue a thread a fragment, and a thread a group of kGroup
//   fragments adds the group's aligned identities in fragment order and
//   writes the group's partial (identity sum, n_aligned, n_usable);
// - grouped_verify_reduce, a block a reference: each thread adds a
//   strided run of group partials in index order, then a fixed tree over
//   the threads, and thread 0 writes the reference's ani and af.
// The chunks hold whole groups, and their count only fills whole waves of
// clusters (chunk_frags_for, from R and the clusters the card holds): the
// sums run in the same order at every chunk size, so a reference gets the
// same bits at every R, on every run and on every shard. The counts are
// exact, so AF equals the plain version's (ops/fragment_ani.py::
// _forward_plain) bit for bit; the identity sum is in another order than
// torch.sum's, so ANI differs from it by float32 rounding only. R is
// bounded only by the grid (R x chunks x cluster blocks < 2^31).
//
// What bounds it: bytes, the stream and its offsets read once and the R
// rows once. On the card a cluster reads its chunk of the stream (from L2
// after the first reference) and stages its row; the R x N bit tests are
// shared-memory reads.

#include <cstdint>

#include <cuda_runtime.h>

#include "verify_common.cuh"

namespace {

using galah_verify::kMaxRound;

constexpr int kThreads = 1024;
constexpr int kGroup = 32;  // fragments a partial
constexpr int kReduceThreads = 256;

struct Partial {
  float ident;
  int aligned;
  int usable;
};
static_assert(sizeof(Partial) == 12, "a partial is three 32-bit words");

// Dynamic shared memory a block: its slice of the row (slice_bytes), then
// a round's arrays and its identities and flags (round each).
int shared_bytes(int slice_bytes, int round) {
  return slice_bytes + 4 * (galah_verify::round_words(round) + 2 * round);
}

// kSliced: the row is split over a cluster of several blocks.
template <bool kSliced>
__global__ void __launch_bounds__(kThreads)
    grouped_verify_clusters(const int32_t* __restrict__ buckets,
                            const int32_t* __restrict__ offsets, int frags,
                            const uint32_t* __restrict__ pool, int64_t words,
                            int shift, const int64_t* __restrict__ rows,
                            const float* __restrict__ popcounts,
                            int chunk_frags, int chunks, float inv_bits,
                            float inv_k, int min_hashes, float min_ident,
                            Partial* __restrict__ partials) {
  extern __shared__ __align__(128) uint32_t slice[];
  __shared__ uint64_t bar;
  const int round = min(chunk_frags, kMaxRound);
  const galah_verify::Round r =
      galah_verify::round_at(slice + (1 << (shift - 5)), round);
  float* ident = reinterpret_cast<float*>(r.part + round);
  int* flags = reinterpret_cast<int*>(ident + round);  // 1 aligned, 2 usable
  const int cluster = kSliced ? blockIdx.x / galah_verify::cluster_blocks()
                              : blockIdx.x;
  const int ref = cluster / chunks;
  const int f_begin = (cluster % chunks) * chunk_frags;
  const int f_end = min(frags, f_begin + chunk_frags);
  const int groups = (frags + kGroup - 1) / kGroup;
  const galah_verify::Slice s = galah_verify::stage_slice(
      slice, &bar, pool + rows[ref] * words, shift);
  bool staged = false;
  const float p = __fmul_rn(popcounts[ref], inv_bits);
  Partial* out = partials + static_cast<int64_t>(ref) * groups;
  for (int f0 = f_begin; f0 < f_end; f0 += round) {
    const int nf = min(round, f_end - f0);
    galah_verify::plan_round<kSliced>(buckets, offsets + f0, nf, s, r);
    galah_verify::count_round(buckets, nf, s, staged, r);
    galah_verify::sync_blocks<kSliced>();
    if (s.rank == 0) {
      for (int j = threadIdx.x; j < nf; j += blockDim.x) {
        const galah_verify::Fragment fr = galah_verify::fragment_epilogue(
            galah_verify::round_count<kSliced>(r, j, s),
            r.offs[j + 1] - r.offs[j], p, inv_k, min_hashes, min_ident);
        // adding 0.0f for a fragment that is not aligned leaves the sum's
        // bits as they are
        ident[j] = fr.aligned ? fr.ident : 0.0f;
        flags[j] = (fr.aligned ? 1 : 0) | (fr.usable ? 2 : 0);
      }
      __syncthreads();
      for (int g = threadIdx.x; g * kGroup < nf; g += blockDim.x) {
        Partial t = {0.0f, 0, 0};
        const int end = min(nf, (g + 1) * kGroup);
        for (int q = g * kGroup; q < end; ++q) {
          t.ident = __fadd_rn(t.ident, ident[q]);
          t.aligned += flags[q] & 1;
          t.usable += flags[q] >> 1;
        }
        out[f0 / kGroup + g] = t;
      }
    }
    galah_verify::sync_blocks<kSliced>();
  }
  if (!staged && threadIdx.x == 0) galah_verify::wait_staged(s);
}

__global__ void __launch_bounds__(kReduceThreads)
    grouped_verify_reduce(const Partial* __restrict__ partials, int groups,
                          float* __restrict__ ani, float* __restrict__ af) {
  __shared__ float ident[kReduceThreads];
  __shared__ int aligned[kReduceThreads];
  __shared__ int usable[kReduceThreads];
  const int ref = blockIdx.x;
  const Partial* mine = partials + static_cast<int64_t>(ref) * groups;
  float si = 0.0f;
  int sa = 0, su = 0;
  for (int b = threadIdx.x; b < groups; b += kReduceThreads) {
    si = __fadd_rn(si, mine[b].ident);
    sa += mine[b].aligned;
    su += mine[b].usable;
  }
  ident[threadIdx.x] = si;
  aligned[threadIdx.x] = sa;
  usable[threadIdx.x] = su;
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      ident[threadIdx.x] =
          __fadd_rn(ident[threadIdx.x], ident[threadIdx.x + half]);
      aligned[threadIdx.x] += aligned[threadIdx.x + half];
      usable[threadIdx.x] += usable[threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int na = aligned[0];
    const int nu = usable[0];
    ani[ref] = __fmul_rn(__fdiv_rn(ident[0], __int2float_rn(na > 1 ? na : 1)),
                         100.0f);
    af[ref] = __fdiv_rn(__int2float_rn(na), __int2float_rn(nu > 1 ? nu : 1));
  }
}

// Fragments a cluster takes, a whole number of groups. The clusters run
// in waves of `resident`; a chunk of 1/c of the stream costs a cluster
// about 1/c of the stream's work plus a fixed part (staging its row and
// the rounds' barriers), so c is the one of 1..64 with the fewest
// waves x (kFixed + 1/c). On the H100 the fixed part measured 0.06-0.15
// of a whole stream's work, and chunks that only filled one wave ran
// 1.36x / 1.17x slower at R = 32 / 64 (PERF.md §6, tools/verify_profile.py
// --kernels).
constexpr double kFixed = 0.125;

int chunk_frags_for(int frags, int refs, int resident) {
  const long long groups = (frags + kGroup - 1) / kGroup;
  const long long slots = resident > 0 ? resident : 1;
  long long best = 1;
  double best_cost = 0.0;
  for (long long c = 1; c <= 64 && c <= groups; ++c) {
    const long long waves = (refs * c + slots - 1) / slots;
    const double cost = static_cast<double>(waves) * (kFixed + 1.0 / c);
    if (c == 1 || cost < best_cost) {
      best = c;
      best_cost = cost;
    }
  }
  return static_cast<int>((groups + best - 1) / best) * kGroup;
}

}  // namespace

// The int32 words of scratch K8 needs for `frags` fragments against
// `refs` references (three a group partial).
extern "C" long long galah_grouped_verify_scratch_words(int frags, int refs) {
  const long long groups = (frags + kGroup - 1) / kGroup;
  return 3 * groups * refs;
}

// Launches K8 on `stream` and returns the CUDA error of each launch (0 on
// success; nothing is launched for 0 references; cudaErrorInvalidValue
// for arguments it does not take). buckets (N,) int32 and offsets
// (frags + 1,) int32 are the query's stream, ascending within each
// fragment, and its fragment offsets into it; pool (C, words) int32 the
// bitmap rows, rows (refs,) int64 the references' rows of it and
// popcounts (refs,) float32 theirs; ani and af (refs,) float32 are
// written; scratch holds scratch_words int32 words
// (galah_grouped_verify_scratch_words). cluster, slice_bits and smem are
// the launch plan (ops/pair_table.py::verify_launch_plan). inv_bits is
// 1.0f / bits and inv_k the float32 exponent 1 / k.
extern "C" int galah_grouped_verify(
    const int32_t* buckets, const int32_t* offsets, int frags,
    const int32_t* pool, long long words, const int64_t* rows,
    const float* popcounts, int refs, int cluster, int slice_bits, int smem,
    float inv_bits, float inv_k, int min_hashes, float min_ident, float* ani,
    float* af, int32_t* scratch, long long scratch_words,
    cudaStream_t stream) {
  if (frags < 0 || refs < 0 ||
      !galah_verify::plan_fits(words, cluster, slice_bits, smem) ||
      scratch_words < galah_grouped_verify_scratch_words(frags, refs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (refs == 0) return static_cast<int>(cudaSuccess);
  const int groups = (frags + kGroup - 1) / kGroup;
  Partial* partials = reinterpret_cast<Partial*>(scratch);
  if (groups > 0) {
    // Clusters the card holds at the largest round (a smaller chunk only
    // frees memory).
    auto* kernel = cluster > 1 ? grouped_verify_clusters<true>
                               : grouped_verify_clusters<false>;
    int resident = 0;
    const int err = galah_verify::resident_clusters(
        kernel, kThreads, shared_bytes(smem, kMaxRound), cluster, &resident);
    if (err != 0) return err;
    const int chunk_frags = chunk_frags_for(frags, refs, resident);
    const int chunks = (frags + chunk_frags - 1) / chunk_frags;
    const long long grid = static_cast<long long>(refs) * chunks * cluster;
    if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const int rc = galah_verify::launch_clusters(
        kernel, grid, kThreads,
        shared_bytes(smem, min(chunk_frags, kMaxRound)), cluster, stream,
        buckets, offsets, frags, reinterpret_cast<const uint32_t*>(pool),
        static_cast<int64_t>(words), galah_verify::log2_of(slice_bits), rows,
        popcounts, chunk_frags, chunks, inv_bits, inv_k, min_hashes,
        min_ident, partials);
    if (rc != 0) return rc;
  }
  grouped_verify_reduce<<<refs, kReduceThreads, 0, stream>>>(partials, groups,
                                                             ani, af);
  return galah_verify::launch_error(cudaGetLastError());
}
