// K5: FracMinHash sketching of a batch of units (genomes, or single
// contigs in contig mode), one pass over their raw sequence bytes.
//
// Replaces the XLA program galah_tpu/ops/device_sketch.py::
// _sketch_batch_kernel (its _sketch_one with _hash_front and mix64_pair).
// Per k-mer start position of a unit:
//   decode (ACGT/acgt -> 0..3, any other byte invalid) -> canonical k-mer
//   min(fwd, revcomp) -> splitmix64 -> FracMinHash selection
//   fsel = h < fragment_threshold, gsel = h < genome_threshold (uint64)
// and for a selected position:
//   fsel: bit h & (member_bits - 1) of the unit's member bitmap;
//   gsel: bit h & (prefilter_bits - 1) of its prefilter bitmap;
//   fsel inside a fragment: one key fragment * member_bits + bucket.
// Bit b of a bitmap is bit b & 31 of word b >> 5 (the host pack_indicator
// layout). Keys are appended in no particular order (the caller sorts and
// deduplicates them), through a warp-aggregated atomicAdd on one counter.
// The caller sizes the key buffer at one slot per k-mer start, so it
// cannot overflow, and zeroes both bitmaps and the counter.
//
// Layout of a batch: the units' bytes back to back (`seq`, unit u at
// [unit_off[u], unit_off[u+1]); a genome's contigs are joined by one
// separator byte, which no k-mer can span since it decodes invalid). Each
// thread walks one run of `run_len` k-mer starts of one unit (run_off[u]
// is the first run of unit u), after k-1 bytes of warm-up, keeping the
// forward and reverse-complement 2-bit windows and the position of the
// last invalid byte in registers. Every thread of a warp runs the same
// number of iterations (idle ones predicated off), so the key compaction
// uses the full-warp mask.
//
// Fragments: unit u's bins are [bin_off[u], bin_off[u+1]); bin i starts
// at bounds[i] (unit coordinates, ascending) and maps to the batch-global
// fragment bin2frag[i], -1 for separators, gaps and the tail. A k-mer
// belongs to the fragment holding its start. Each thread binary-searches
// its first position's bin once and then walks forward as its positions
// cross bin starts.
//
// Work: a position costs ~32 32-bit integer operations (window updates,
// the two 64-bit multiplies and shifts of splitmix64, two 64-bit
// compares) against 1 byte read. With the bitmaps ((member_bits +
// prefilter_bits) / 8 bytes a unit) and the 8-byte keys written once, the
// bytes moved outweigh the operations at the peak rates of an H100, so
// bytes bound it. The hash stays entirely in registers;
// a selected position adds one atomicOr into a bitmap that stays in L2
// (512 KiB per genome at 2^22 member bits). Each thread of a warp reads
// from its own run, so a warp's byte load touches 32 sectors: correctness
// first, coalesced staging is left for later.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t decode(uint8_t c) {
  const uint8_t u = c & 0xDF;  // upper case; only 'a'..'t' map onto 'A'..'T'
  return u == 'A' ? 0u : u == 'C' ? 1u : u == 'G' ? 2u : u == 'T' ? 3u : 4u;
}

__device__ __forceinline__ uint64_t mix64(uint64_t h) {
  h ^= h >> 30;
  h *= 0xBF58476D1CE4E5B9ULL;
  h ^= h >> 27;
  h *= 0x94D049BB133111EBULL;
  h ^= h >> 31;
  return h;
}

// The largest i in [lo, hi) with v[i] <= x; v[lo] <= x must hold.
__device__ __forceinline__ int last_at_most(const int32_t* __restrict__ v,
                                            int lo, int hi, int64_t x) {
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    if (v[mid] <= x) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void sketch_kernel(
    const uint8_t* __restrict__ seq, const int64_t* __restrict__ unit_off,
    const int32_t* __restrict__ run_off, const int32_t* __restrict__ bounds,
    const int32_t* __restrict__ bin2frag, const int32_t* __restrict__ bin_off,
    int g, int total_runs, int run_len, int k, uint64_t fthresh,
    uint64_t gthresh, int member_shift, int prefilter_shift,
    uint32_t* __restrict__ member, uint32_t* __restrict__ pref,
    long long* __restrict__ keys, unsigned long long* __restrict__ n_keys) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = t < total_runs;
  const uint32_t kmask = (1u << (2 * k)) - 1u;
  const int top = 2 * (k - 1);
  const uint32_t member_mask = (1u << member_shift) - 1u;
  const uint32_t pref_mask = (1u << prefilter_shift) - 1u;
  const size_t member_words = size_t(1) << (member_shift - 5);
  const size_t pref_words = size_t(1) << (prefilter_shift - 5);

  int u = 0;
  int p0 = 0;
  int p1 = 0;
  int bin = 0;
  int bin_end = 0;
  const uint8_t* s = seq;
  if (live) {
    u = last_at_most(run_off, 0, g, t);
    const int64_t base = unit_off[u];
    const int len = static_cast<int>(unit_off[u + 1] - base);
    s = seq + base;
    p0 = (t - run_off[u]) * run_len;
    p1 = min(p0 + run_len, len - k + 1);
    bin_end = bin_off[u + 1];
    bin = last_at_most(bounds, bin_off[u], bin_end, p0);
  }
  uint32_t fwd = 0;
  uint32_t rev = 0;
  int last_bad = p0 - 1;
  if (live) {
    for (int i = p0; i < p0 + k - 1; ++i) {
      uint32_t c = decode(__ldg(s + i));
      if (c > 3u) {
        last_bad = i;
        c = 0;
      }
      fwd = ((fwd << 2) | c) & kmask;
      rev = (rev >> 2) | ((3u - c) << top);
    }
  }
  uint32_t* const mrow = member + size_t(u) * member_words;
  uint32_t* const prow = pref + size_t(u) * pref_words;
  const int lane = threadIdx.x & 31;

  for (int it = 0; it < run_len; ++it) {
    const int p = p0 + it;
    bool has_key = false;
    long long key = 0;
    if (live && p < p1) {
      const int i = p + k - 1;
      uint32_t c = decode(__ldg(s + i));
      if (c > 3u) {
        last_bad = i;
        c = 0;
      }
      fwd = ((fwd << 2) | c) & kmask;
      rev = (rev >> 2) | ((3u - c) << top);
      if (last_bad < p) {
        const uint64_t h = mix64(static_cast<uint64_t>(min(fwd, rev)));
        if (h < fthresh) {
          const uint32_t b = static_cast<uint32_t>(h) & member_mask;
          atomicOr(mrow + (b >> 5), 1u << (b & 31));
          while (bin + 1 < bin_end && bounds[bin + 1] <= p) ++bin;
          const int f = bin2frag[bin];
          if (f >= 0) {
            has_key = true;
            key = (static_cast<long long>(f) << member_shift) | b;
          }
        }
        if (h < gthresh) {
          const uint32_t b = static_cast<uint32_t>(h) & pref_mask;
          atomicOr(prow + (b >> 5), 1u << (b & 31));
        }
      }
    }
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, has_key);
    if (ballot != 0u) {
      const int leader = __ffs(ballot) - 1;
      unsigned long long start = 0;
      if (lane == leader) {
        start = atomicAdd(n_keys,
                          static_cast<unsigned long long>(__popc(ballot)));
      }
      start = __shfl_sync(0xFFFFFFFFu, start, leader);
      if (has_key) keys[start + __popc(ballot & ((1u << lane) - 1u))] = key;
    }
  }
}

}  // namespace

// Launch K5 on `stream` with `threads` threads a block (a multiple of 32,
// at most 1024); returns the CUDA error of the launch (0 when accepted).
extern "C" int galah_device_sketch(
    const uint8_t* seq, const int64_t* unit_off, const int32_t* run_off,
    const int32_t* bounds, const int32_t* bin2frag, const int32_t* bin_off,
    int g, int total_runs, int run_len, int k, unsigned long long fthresh,
    unsigned long long gthresh, int member_shift, int prefilter_shift,
    uint32_t* member, uint32_t* pref, long long* keys,
    unsigned long long* n_keys, int threads, cudaStream_t stream) {
  if (total_runs == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (total_runs + threads - 1) / threads;
  sketch_kernel<<<blocks, threads, 0, stream>>>(
      seq, unit_off, run_off, bounds, bin2frag, bin_off, g, total_runs,
      run_len, k, fthresh, gthresh, member_shift, prefilter_shift, member,
      pref, keys, n_keys);
  return static_cast<int>(cudaGetLastError());
}
