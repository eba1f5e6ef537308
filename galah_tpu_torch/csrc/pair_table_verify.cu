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
// into one program a batch; the port ran it as ~35 torch launches over
// flat (pair-duplicated) intermediates of up to 2^23 elements.
//
// Inputs are the plain version's descriptors, read in place: the stream
// arena's streams and global fragment offsets, the bitmap pool with a row
// a pair, the batch's popcounts and the per-pair fragment starts. Every
// sum is an integer until the last step, so K7 equals its plain version
// (ops/pair_table.py::_pair_table_plain) bit for bit.
//
// Design: one block a pair, a warp a fragment (warps stride over the
// pair's fragments), lanes over the fragment's hashes (warp_hits); lane 0
// runs the epilogue and keeps its warp's three sums; the block adds them
// and thread 0 writes the pair's two floats. One launch a batch, no
// atomics, no scratch. The block has as many warps as the batch's mean
// fragments a pair rounded up to a power of two, 2 to 32: a 1 Mb genome
// has ~330 fragments, a 5 kb contig one or two.
//
// What bounds it: bytes. Each pair reads its source stream once (the
// pairs that share a source read it again, from L2 mostly) and gathers
// one bitmap word a hash from its target's row, which the pairs of one
// target share; the byte bound counts each distinct source's stream and
// offsets and each distinct row once.

#include <cstdint>

#include <cuda_runtime.h>

#include "verify_common.cuh"

namespace {

constexpr int kMaxWarps = 32;
constexpr float kFxOne = 16384.0f;  // 2^14, the fixed-point scale

__global__ void __launch_bounds__(kMaxWarps * 32)
    pair_table_verify(const int32_t* __restrict__ ustream,
                      const int32_t* __restrict__ ufrag_offsets,
                      const uint32_t* __restrict__ pool, int64_t words,
                      const float* __restrict__ popcounts,
                      const int32_t* __restrict__ pair_ufrag_start,
                      const int32_t* __restrict__ pair_fragflat_start,
                      const int64_t* __restrict__ pair_ref,
                      const int64_t* __restrict__ pair_row, float inv_bits,
                      float inv_k, int min_hashes, float min_ident,
                      float* __restrict__ ani, float* __restrict__ af) {
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
    const int m = galah_verify::warp_hits(ustream, lo, hi, row);
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
    const float sum_ident = __fmul_rn(__int2float_rn(isum), 1.0f / kFxOne);
    ani[pair] = __fmul_rn(
        __fdiv_rn(sum_ident, __int2float_rn(n_aligned > 1 ? n_aligned : 1)),
        100.0f);
    af[pair] = __fdiv_rn(__int2float_rn(n_aligned),
                         __int2float_rn(n_usable > 1 ? n_usable : 1));
  }
}

}  // namespace

// Launches K7 on `stream` for `pairs` directed pairs and returns
// cudaGetLastError() (0 on success; nothing is launched for 0 pairs).
// ustream (U,) int32 and ufrag_offsets (UF+1,) int32 are the streams and
// their global fragment offsets; pool (C, words) int32 the bitmap rows;
// popcounts (G,) float32; pair_ufrag_start (P,) and pair_fragflat_start
// (P+1,) int32; pair_ref (P,) int64 rows of popcounts and pair_row (P,)
// int64 rows of pool; ani and af (P,) float32 are written. flat_frags is
// the batch's fragment count, which sizes the block. inv_bits is
// 1.0f / bits and inv_k the float32 exponent 1 / k.
extern "C" int galah_pair_table_verify(
    const int32_t* ustream, const int32_t* ufrag_offsets, const int32_t* pool,
    long long words, const float* popcounts, const int32_t* pair_ufrag_start,
    const int32_t* pair_fragflat_start, const int64_t* pair_ref,
    const int64_t* pair_row, int pairs, int flat_frags, float inv_bits,
    float inv_k, int min_hashes, float min_ident, float* ani, float* af,
    cudaStream_t stream) {
  if (pairs < 0 || flat_frags < 0 || words < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pairs == 0) return static_cast<int>(cudaSuccess);
  const int mean = (flat_frags + pairs - 1) / pairs;
  int warps = 2;
  while (warps < mean && warps < kMaxWarps) warps <<= 1;
  pair_table_verify<<<pairs, warps * 32, 0, stream>>>(
      ustream, ufrag_offsets, reinterpret_cast<const uint32_t*>(pool),
      static_cast<int64_t>(words), popcounts, pair_ufrag_start,
      pair_fragflat_start, pair_ref, pair_row, inv_bits, inv_k, min_hashes,
      min_ident, ani, af);
  return static_cast<int>(cudaGetLastError());
}
