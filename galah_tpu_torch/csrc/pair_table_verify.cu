// K7, the pair-table verify: for each directed pair (source, target) of a
// batch, the source's fragment streams are tested bit by bit in the
// target's member bitmap, and the per-fragment hits become the pair's ANI
// and AF:
//   per fragment   m = hits, M = hashes, the epilogue of verify_common.cuh
//   per pair       n_aligned, n_usable and the identities of the aligned
//                  fragments summed in 2^-14 fixed point (rintf, half to
//                  even, as torch.round), all in int32;
//                  ani = (isum / 16384) / max(n_aligned, 1) * 100
//                  af  = n_aligned / max(n_usable, 1)
//
// Replaces the JAX package's device program
// galah_tpu/ops/pair_table.py::_pair_table_kernel (:193), which XLA fused
// into one program a batch.
//
// Inputs are the plain version's descriptors, read in place: the stream
// arena's streams and global fragment offsets, the bitmap pool with a row
// a pair, the batch's popcounts and the per-pair fragment starts. Every
// sum is an integer until the last step, so K7 equals its plain version
// (ops/pair_table.py::_pair_table_plain) bit for bit, however a pair's
// fragments are split between blocks.
//
// Design: one launch a batch of one of two kernels, chosen by the row's
// width; no atomics, no scratch:
// - rows over 2^20 bits (the main path's 2^22), where a row is too large
//   for L1 and each bit test was a random L2 sector: a cluster a pair,
//   each of its 4 blocks holding a 128 KiB slice of the pair's row,
//   staged with TMA bulk copies (verify_common.cuh). The pair's
//   fragments go in rounds (the batch's mean fragments a pair, 32 to
//   1,024): the block copies a round's bounds into shared memory, finds
//   its slice's run in each fragment and a subgroup of lanes counts a
//   run's hits (count_round); block 0 adds the cluster's counts, runs the
//   epilogue a thread a fragment and keeps the three sums, adds them over
//   its warps, and thread 0 writes the pair's two floats;
// - rows of up to 2^20 bits (the contig path's 2^16): the earlier design,
//   a block a pair reading the row through L1 (pair_table_verify_l1).
// A block has as many warps as the batch's mean fragments a pair rounded
// up to a power of two, 2 to 32: a 1 Mb genome has ~330 fragments, a 5 kb
// contig ~5.
//
// What bounds it: bytes. Each pair reads its source stream (the pairs of
// one source read it again, from L2 mostly) and its target's row, which
// the pairs of one target share in L2; the byte bound counts each
// distinct source's stream and offsets and each distinct row once.

#include <cstdint>

#include <cuda_runtime.h>

#include "verify_common.cuh"

namespace {

using galah_verify::kMaxRound;

constexpr int kMaxWarps = 32;
constexpr float kFxOne = 16384.0f;  // 2^14, the fixed-point scale

// The pair's ANI and AF from its three sums.
__device__ __forceinline__ void write_pair(int pair, int n_aligned,
                                           int n_usable, int isum,
                                           float* __restrict__ ani,
                                           float* __restrict__ af) {
  const float sum_ident = __fmul_rn(__int2float_rn(isum), 1.0f / kFxOne);
  ani[pair] = __fmul_rn(
      __fdiv_rn(sum_ident, __int2float_rn(n_aligned > 1 ? n_aligned : 1)),
      100.0f);
  af[pair] = __fdiv_rn(__int2float_rn(n_aligned),
                       __int2float_rn(n_usable > 1 ? n_usable : 1));
}

// Dynamic shared memory a block of a cluster: its slice of the row
// (slice_bytes), then a round's arrays.
int shared_bytes(int slice_bytes, int round) {
  return slice_bytes + 4 * galah_verify::round_words(round);
}

// K7 for rows over 2^20 bits, a cluster a pair: each block stages its
// slice of the pair's row and counts its share of the pair's fragments in
// rounds; block 0 adds the cluster's counts and runs the epilogue. A
// block has the SM to itself (its slice fills the shared memory), and its
// count is bound by the loads it keeps in flight: up to 32 warps.
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    pair_table_verify(const int32_t* __restrict__ ustream,
                      const int32_t* __restrict__ ufrag_offsets,
                      const uint32_t* __restrict__ pool, int64_t words,
                      int shift, int round,
                      const float* __restrict__ popcounts,
                      const int32_t* __restrict__ pair_ufrag_start,
                      const int32_t* __restrict__ pair_fragflat_start,
                      const int64_t* __restrict__ pair_ref,
                      const int64_t* __restrict__ pair_row, float inv_bits,
                      float inv_k, int min_hashes, float min_ident,
                      float* __restrict__ ani, float* __restrict__ af) {
  extern __shared__ __align__(128) uint32_t slice[];
  __shared__ int sums[3][kMaxWarps];
  __shared__ uint64_t bar;
  const galah_verify::Round r =
      galah_verify::round_at(slice + (1 << (shift - 5)), round);
  const int pair = blockIdx.x / galah_verify::cluster_blocks();
  const galah_verify::Slice s = galah_verify::stage_slice(
      slice, &bar, pool + pair_row[pair] * words, shift);
  bool staged = false;
  const int nfrag = pair_fragflat_start[pair + 1] - pair_fragflat_start[pair];
  const int32_t* offsets = ufrag_offsets + pair_ufrag_start[pair];
  const float p = __fmul_rn(popcounts[pair_ref[pair]], inv_bits);
  int n_aligned = 0, n_usable = 0, isum = 0;
  for (int f0 = 0; f0 < nfrag; f0 += round) {
    const int nf = min(round, nfrag - f0);
    galah_verify::plan_round<true>(ustream, offsets + f0, nf, s, r);
    galah_verify::count_round(ustream, nf, s, staged, r);
    galah_verify::cluster_sync();
    if (s.rank == 0) {
      for (int j = threadIdx.x; j < nf; j += blockDim.x) {
        const galah_verify::Fragment fr = galah_verify::fragment_epilogue(
            galah_verify::round_count<true>(r, j, s),
            r.offs[j + 1] - r.offs[j], p, inv_k, min_hashes, min_ident);
        n_usable += fr.usable ? 1 : 0;
        if (fr.aligned) {
          n_aligned += 1;
          isum += static_cast<int>(rintf(__fmul_rn(fr.ident, kFxOne)));
        }
      }
    }
    galah_verify::cluster_sync();
  }
  if (!staged && threadIdx.x == 0) galah_verify::wait_staged(s);
  if (s.rank != 0) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  n_aligned = __reduce_add_sync(0xffffffffu, n_aligned);
  n_usable = __reduce_add_sync(0xffffffffu, n_usable);
  isum = __reduce_add_sync(0xffffffffu, isum);
  if (lane == 0) {
    sums[0][warp] = n_aligned;
    sums[1][warp] = n_usable;
    sums[2][warp] = isum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) {
      n_aligned += sums[0][w];
      n_usable += sums[1][w];
      isum += sums[2][w];
    }
    write_pair(pair, n_aligned, n_usable, isum, ani, af);
  }
}

// K7 for rows of up to 2^20 bits, the earlier design: a block a pair, a warp
// a fragment (warps stride over the pair's fragments), lanes over its
// hashes with four stream loads in flight a lane and the row's words read
// through L1, which holds a row this small (the contig path's is 8 KiB);
// lane 0 runs the epilogue and keeps its warp's three sums, and thread 0
// adds them and writes the pair's two floats. Staging such a row in
// shared memory moves the same bytes and was slower at the contig batch
// (2^16 bits), and at 2^18 and 2^20 bits staged over a cluster of 2 ran
// 2.8x and 2.3x slower (PERF.md §6); so was this loop with its sum
// written otherwise.
__global__ void __launch_bounds__(kMaxWarps * 32)
    pair_table_verify_l1(const int32_t* __restrict__ ustream,
                         const int32_t* __restrict__ ufrag_offsets,
                         const uint32_t* __restrict__ pool, int64_t words,
                         const float* __restrict__ popcounts,
                         const int32_t* __restrict__ pair_ufrag_start,
                         const int32_t* __restrict__ pair_fragflat_start,
                         const int64_t* __restrict__ pair_ref,
                         const int64_t* __restrict__ pair_row,
                         float inv_bits, float inv_k, int min_hashes,
                         float min_ident, float* __restrict__ ani,
                         float* __restrict__ af) {
  __shared__ int sums[3][kMaxWarps];
  const int pair = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int nfrag = pair_fragflat_start[pair + 1] - pair_fragflat_start[pair];
  const int32_t* offsets = ufrag_offsets + pair_ufrag_start[pair];
  const uint32_t* row = pool + pair_row[pair] * words;
  const float p = __fmul_rn(popcounts[pair_ref[pair]], inv_bits);
  int n_aligned = 0, n_usable = 0, isum = 0;
  for (int f = warp; f < nfrag; f += warps) {
    const int lo = offsets[f];
    const int hi = offsets[f + 1];
    int hits = 0;
    int i = lo + lane;
    for (; i + 96 < hi; i += 128) {
      const int32_t b0 = __ldg(ustream + i);
      const int32_t b1 = __ldg(ustream + i + 32);
      const int32_t b2 = __ldg(ustream + i + 64);
      const int32_t b3 = __ldg(ustream + i + 96);
      const uint32_t w0 = __ldg(row + (b0 >> 5));
      const uint32_t w1 = __ldg(row + (b1 >> 5));
      const uint32_t w2 = __ldg(row + (b2 >> 5));
      const uint32_t w3 = __ldg(row + (b3 >> 5));
      hits += static_cast<int>(((w0 >> (b0 & 31)) & 1u) +
                               ((w1 >> (b1 & 31)) & 1u) +
                               ((w2 >> (b2 & 31)) & 1u) +
                               ((w3 >> (b3 & 31)) & 1u));
    }
    for (; i < hi; i += 32) {
      const int32_t b = __ldg(ustream + i);
      hits += static_cast<int>((__ldg(row + (b >> 5)) >> (b & 31)) & 1u);
    }
    const int m = __reduce_add_sync(0xffffffffu, hits);
    if (lane == 0) {
      const galah_verify::Fragment fr = galah_verify::fragment_epilogue(
          m, hi - lo, p, inv_k, min_hashes, min_ident);
      n_usable += fr.usable ? 1 : 0;
      if (fr.aligned) {
        n_aligned += 1;
        isum += static_cast<int>(rintf(__fmul_rn(fr.ident, kFxOne)));
      }
    }
  }
  if (lane == 0) {
    sums[0][warp] = n_aligned;
    sums[1][warp] = n_usable;
    sums[2][warp] = isum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < warps; ++w) {
      n_aligned += sums[0][w];
      n_usable += sums[1][w];
      isum += sums[2][w];
    }
    write_pair(pair, n_aligned, n_usable, isum, ani, af);
  }
}

}  // namespace

// Launches K7 on `stream` for `pairs` directed pairs and returns its CUDA
// error (0 on success; nothing is launched for 0 pairs; cudaErrorInvalidValue
// for arguments it does not take). ustream (U,) int32 and ufrag_offsets
// (UF+1,) int32 are the streams, ascending within each fragment, and their
// global fragment offsets; pool (C, words) int32 the bitmap rows; popcounts
// (G,) float32; pair_ufrag_start (P,) and pair_fragflat_start (P+1,) int32;
// pair_ref (P,) int64 rows of popcounts and pair_row (P,) int64 rows of
// pool; ani and af (P,) float32 are written. flat_frags is the batch's
// fragment count, which sizes the block and a round. cluster, slice_bits
// and smem are the launch plan (ops/pair_table.py::verify_launch_plan): a
// row is cluster slices of slice_bits bits, smem bytes of shared memory
// for a slice; with one slice the row is read through L1. inv_bits is
// 1.0f / bits and inv_k the float32 exponent 1 / k.
extern "C" int galah_pair_table_verify(
    const int32_t* ustream, const int32_t* ufrag_offsets, const int32_t* pool,
    long long words, const float* popcounts, const int32_t* pair_ufrag_start,
    const int32_t* pair_fragflat_start, const int64_t* pair_ref,
    const int64_t* pair_row, int pairs, int flat_frags, int cluster,
    int slice_bits, int smem, float inv_bits, float inv_k, int min_hashes,
    float min_ident, float* ani, float* af, cudaStream_t stream) {
  if (pairs < 0 || flat_frags < 0 ||
      !galah_verify::plan_fits(words, cluster, slice_bits, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pairs == 0) return static_cast<int>(cudaSuccess);
  const int mean = (flat_frags + pairs - 1) / pairs;
  const uint32_t* rows = reinterpret_cast<const uint32_t*>(pool);
  const int shift = galah_verify::log2_of(slice_bits);
  int warps = 2;
  while (warps < mean && warps < kMaxWarps) warps <<= 1;
  if (cluster == 1) {
    pair_table_verify_l1<<<pairs, warps * 32, 0, stream>>>(
        ustream, ufrag_offsets, rows, static_cast<int64_t>(words), popcounts,
        pair_ufrag_start, pair_fragflat_start, pair_ref, pair_row, inv_bits,
        inv_k, min_hashes, min_ident, ani, af);
    return galah_verify::launch_error(cudaGetLastError());
  }
  int round = 32;
  while (round < mean && round < kMaxRound) round <<= 1;
  return galah_verify::launch_clusters(
      pair_table_verify, static_cast<long long>(pairs) * cluster, warps * 32,
      shared_bytes(smem, round), cluster, stream, ustream, ufrag_offsets,
      rows, static_cast<int64_t>(words), shift, round, popcounts,
      pair_ufrag_start, pair_fragflat_start, pair_ref, pair_row, inv_bits,
      inv_k, min_hashes, min_ident, ani, af);
}
