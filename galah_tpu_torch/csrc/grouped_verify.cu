// K8, the grouped verify with word gathers: one query's fragment stream
// against R reference bitmaps, each bucket tested with one word gathered
// from each reference's row:
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
// XLA fused into one program a dispatch; the port ran it as an (R, N)
// int64 index matrix, a gather, an (R, N + 1) prefix sum and ~20
// elementwise launches.
//
// Design: two launches, no atomics, deterministic.
// - grouped_verify_blocks, a grid of (fragment blocks, R) with the
//   reference the slow index, so that the blocks running together gather
//   from one bitmap row and keep it in L2: a warp a fragment (each warp
//   takes kFragsPerBlock / kWarps fragments in turn), lanes over its
//   hashes (warp_hits); lane 0 runs the epilogue and sums its warp's
//   identities in fragment order; thread 0 adds the warps in order and
//   writes the block's partial (identity sum, n_aligned, n_usable);
// - grouped_verify_reduce, a block a reference: each thread adds a
//   strided run of partials in index order, then a fixed tree over the
//   threads, and thread 0 writes the reference's ani and af.
// The counts are exact, so AF equals the plain version's
// (ops/fragment_ani.py::_forward_plain) bit for bit; the identity sum is
// in another order than torch.sum's, so ANI differs from it by float32
// rounding only, and the same input gives the same bits on every run.
//
// What bounds it: bytes, the stream and its offsets read once and the R
// rows' words the stream picks. The rows are read from L2 after their
// first touch; the stream (4 bytes a hash) is read once a reference,
// mostly from L2 as well.

#include <cstdint>

#include <cuda_runtime.h>

#include "verify_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFragsPerBlock = 32;
constexpr int kReduceThreads = 256;

struct Partial {
  float ident;
  int aligned;
  int usable;
};
static_assert(sizeof(Partial) == 12, "a partial is three 32-bit words");

__global__ void __launch_bounds__(kThreads)
    grouped_verify_blocks(const int32_t* __restrict__ buckets,
                          const int32_t* __restrict__ offsets, int frags,
                          const uint32_t* __restrict__ pool, int64_t words,
                          const int64_t* __restrict__ rows,
                          const float* __restrict__ popcounts, float inv_bits,
                          float inv_k, int min_hashes, float min_ident,
                          Partial* __restrict__ partials) {
  __shared__ Partial warp_sums[kWarps];
  const int ref = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t* row = pool + rows[ref] * words;
  const float p = __fmul_rn(popcounts[ref], inv_bits);
  const int f0 = blockIdx.x * kFragsPerBlock;
  const int f1 = min(frags, f0 + kFragsPerBlock);
  Partial s = {0.0f, 0, 0};
  for (int f = f0 + warp; f < f1; f += kWarps) {
    const int lo = offsets[f];
    const int hi = offsets[f + 1];
    const int m = galah_verify::warp_hits(buckets, lo, hi, row);
    if (lane == 0) {
      const galah_verify::Fragment fr = galah_verify::fragment_epilogue(
          m, hi - lo, p, inv_k, min_hashes, min_ident);
      s.usable += fr.usable ? 1 : 0;
      if (fr.aligned) {
        s.aligned += 1;
        s.ident = __fadd_rn(s.ident, fr.ident);
      }
    }
  }
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    Partial t = warp_sums[0];
    for (int w = 1; w < kWarps; ++w) {
      t.ident = __fadd_rn(t.ident, warp_sums[w].ident);
      t.aligned += warp_sums[w].aligned;
      t.usable += warp_sums[w].usable;
    }
    partials[static_cast<int64_t>(ref) * gridDim.x + blockIdx.x] = t;
  }
}

__global__ void __launch_bounds__(kReduceThreads)
    grouped_verify_reduce(const Partial* __restrict__ partials, int blocks,
                          float* __restrict__ ani, float* __restrict__ af) {
  __shared__ float ident[kReduceThreads];
  __shared__ int aligned[kReduceThreads];
  __shared__ int usable[kReduceThreads];
  const int ref = blockIdx.x;
  const Partial* mine = partials + static_cast<int64_t>(ref) * blocks;
  float si = 0.0f;
  int sa = 0, su = 0;
  for (int b = threadIdx.x; b < blocks; b += kReduceThreads) {
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

}  // namespace

// The int32 words of scratch K8 needs for `frags` fragments against
// `refs` references (three a partial).
extern "C" long long galah_grouped_verify_scratch_words(int frags, int refs) {
  const long long blocks = (frags + kFragsPerBlock - 1) / kFragsPerBlock;
  return 3 * blocks * refs;
}

// Launches K8 on `stream` and returns cudaGetLastError() after each
// launch (0 on success; nothing is launched for 0 references). buckets
// (N,) int32 and offsets (frags + 1,) int32 are the query's stream and
// its fragment offsets into it; pool (C, words) int32 the bitmap rows,
// rows (refs,) int64 the references' rows of it and popcounts (refs,)
// float32 theirs; ani and af (refs,) float32 are written; scratch holds
// scratch_words int32 words (galah_grouped_verify_scratch_words). inv_bits
// is 1.0f / bits and inv_k the float32 exponent 1 / k.
extern "C" int galah_grouped_verify(
    const int32_t* buckets, const int32_t* offsets, int frags,
    const int32_t* pool, long long words, const int64_t* rows,
    const float* popcounts, int refs, float inv_bits, float inv_k,
    int min_hashes, float min_ident, float* ani, float* af, int32_t* scratch,
    long long scratch_words, cudaStream_t stream) {
  if (frags < 0 || refs < 0 || refs > 65535 || words < 0 ||
      scratch_words < galah_grouped_verify_scratch_words(frags, refs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (refs == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (frags + kFragsPerBlock - 1) / kFragsPerBlock;
  Partial* partials = reinterpret_cast<Partial*>(scratch);
  if (blocks > 0) {
    grouped_verify_blocks<<<dim3(blocks, refs), kThreads, 0, stream>>>(
        buckets, offsets, frags, reinterpret_cast<const uint32_t*>(pool),
        static_cast<int64_t>(words), rows, popcounts, inv_bits, inv_k,
        min_hashes, min_ident, partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  grouped_verify_reduce<<<refs, kReduceThreads, 0, stream>>>(partials, blocks,
                                                             ani, af);
  return static_cast<int>(cudaGetLastError());
}
