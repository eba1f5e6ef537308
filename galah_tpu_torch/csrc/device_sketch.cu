// K5: FracMinHash sketching of a batch of units (genomes, or single
// contigs in contig mode), one pass over their raw sequence bytes, with
// each fragment's buckets sorted and deduplicated on chip.
//
// Replaces the XLA program galah_tpu/ops/device_sketch.py::
// _sketch_batch_kernel: its _sketch_one with _hash_front and mix64_pair,
// the per-fragment dedup included (the segmented sort of :266-314). Per
// k-mer start position of a unit:
//   decode (ACGT/acgt -> 0..3, any other byte invalid) -> canonical k-mer
//   min(fwd, revcomp) -> splitmix64 -> FracMinHash selection
//   fsel = h < fragment_threshold, gsel = h < genome_threshold (uint64)
// and for a selected position:
//   fsel: bit h & (member_bits - 1) of the unit's member bitmap, and,
//         inside a fragment, bucket h & (member_bits - 1) in that
//         fragment's list;
//   gsel: bit h & (prefilter_bits - 1) of its prefilter bitmap.
// Bit b of a bitmap is bit b & 31 of word b >> 5 (the host pack_indicator
// layout); the caller zeroes both bitmaps. Out: counts[f], the number of
// distinct buckets of fragment f, and those buckets in ascending order at
// scratch[frag_slot[f]...], where frag_slot is the host's exclusive sum
// of fragment lengths (a fragment has at most one distinct bucket per
// position). No output position is claimed with an atomic.
//
// Layout: the units' bytes back to back (`seq`, unit u at [unit_off[u],
// unit_off[u+1]); a genome's contigs are joined by one separator byte,
// which decodes invalid). The host cuts each unit into tiles of whole
// fragments (ops/device_sketch.py::plan_layout): tile t holds the start
// positions [tile_start[t], tile_end[t]) of unit tile_unit[t] (unit
// coordinates) and the fragments [tile_frag[t], tile_frag[t+1]), fragment
// f covering the starts [frag_start[f], frag_end[f]). A k-mer belongs to
// the fragment holding its start, so a tile reads k - 1 bytes past its
// end (the halo). `seq` must be readable 16 bytes past its last byte.
//
// One block a tile, in two instances by member width (at most 2^16 bits,
// contig mode's width, a tile that holds its whole unit builds the member
// bitmap in shared memory and writes it once; wider ones go to device
// memory):
// 1. stage the tile's bytes and halo in shared memory with 16-byte loads
//    from the 16-byte boundary at or below its first byte (neighbouring
//    threads, neighbouring addresses), decoding 4 bytes at a time;
// 2. each thread walks an odd-length run of starts out of shared memory
//    after k - 1 codes of warm-up, keeping the forward and
//    reverse-complement 2-bit windows and the last invalid position in
//    registers, hashing with native 64-bit products, and writes each
//    start's entry (its bucket, or none) to its position of a list in
//    shared memory, without branches; a fragment never selects more
//    buckets than it has positions, so nothing can overflow;
// 3. the block sets the bitmap bits of every selected start (atomicOr),
//    neighbouring threads on neighbouring positions;
// 4. warp w takes fragments w, w + 8, ...: it reads a fragment's entries
//    32 at a time and compacts the selected buckets to the front of the
//    fragment's own positions (a ballot ranks them) while counting them
//    into 256 radix bins by their top bits (in the room of the staged
//    bytes), scatters them bin by bin and sorts each bin by insertion
//    (about m / 256 random hashes a bin), and a ballot writes the first
//    of each run of equal buckets out, in order. A list over 1024
//    entries (a repeat) takes a bitonic sort in shared memory instead.
//
// What bounds it on an H100: integer instructions. A start costs one
// byte read from shared memory and ~40 instructions (window updates,
// splitmix64's two 64-bit products and shifts, the 64-bit threshold
// compare), most of them logic, shift and compare operations on the
// integer ALU pipe (64 lanes an SM), the IMADs on the FMA pipe beside it;
// the bytes in and out (1 byte a start, the bitmaps, 4 bytes a distinct
// bucket) take less time at 3.35 TB/s. tools/k5_profile.py counts the
// instructions a start from the SASS by pipe, and chip_smoke.py takes
// K5's bound from that count. The design keeps every byte load coalesced
// and every hash in registers, dedups fragments in shared memory, and
// leaves device memory only for the bitmaps and the compacted buckets.
// Step 4, one warp a fragment with a chain of dependent shared-memory
// operations, takes longer than the hashing (PERF.md).

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 256;
// Member widths of at most 2^16 bits (8 KiB, contig mode's width) get a
// bitmap in shared memory: a tile that holds its whole unit builds the
// unit's member bitmap there and writes it once.
constexpr int kSharedMemberShift = 16;
// The per-fragment sort's radix bins: a warp counts a fragment's buckets
// by their top kBinBits bits in kBins int32 words of its own.
constexpr int kBinBits = 8;
constexpr int kBins = 1 << kBinBits;
constexpr int kBinsPerLane = kBins / kWarp;

// Timing cuts (python -m galah_tpu_torch.tools.k5_profile --cuts): built
// with -DGALAH_K5_STOP_AFTER=2 the kernel returns after step 2, with =3
// after step 3. The library the wrappers load is built without it, and
// both returns compile away. They sit in the kernel itself because a stop
// between two steps can only be written there, and a cut must time the
// very code the wrappers launch up to that point: it is how PERF.md
// splits K5's time between hashing, bitmaps and the per-fragment dedup.
#ifndef GALAH_K5_STOP_AFTER
#define GALAH_K5_STOP_AFTER 0
#endif

// Four bytes at once: ACGT/acgt -> 0..3 (A, C, G, T), any other byte -> 4.
// u = c & 0xDF folds lower case onto upper case (and nothing else onto
// A, C, G or T); bits 1-2 of u give the code once bit 2 is folded into
// bit 0 (A 0x41, C 0x43, G 0x47, T 0x54).
__device__ __forceinline__ uint32_t decode4(uint32_t x) {
  const uint32_t u = x & 0xDFDFDFDFu;
  const uint32_t code = ((u >> 1) & 0x03030303u) ^ ((u >> 2) & 0x01010101u);
  const uint32_t ok = __vcmpeq4(u, 0x41414141u) | __vcmpeq4(u, 0x43434343u) |
                      __vcmpeq4(u, 0x47474747u) | __vcmpeq4(u, 0x54545454u);
  return (code & ok) | (~ok & 0x04040404u);
}

__device__ __forceinline__ uint4 decode16(uint4 v) {
  return make_uint4(decode4(v.x), decode4(v.y), decode4(v.z), decode4(v.w));
}

// splitmix64 of a canonical k-mer: x < 2^30 (k <= 15), so the finalizer's
// first step, x ^= x >> 30, leaves it as it is.
__device__ __forceinline__ uint64_t mix64_kmer(uint32_t x) {
  uint64_t h = static_cast<uint64_t>(x) * 0xBF58476D1CE4E5B9ULL;
  h ^= h >> 27;
  h *= 0x94D049BB133111EBULL;
  h ^= h >> 31;
  return h;
}

// Bytes of shared memory that hold a tile's staged sequence: its starts,
// the k - 1 halo and up to 15 bytes before it to the 16-byte boundary,
// rounded up to 16-byte vectors.
__host__ __device__ __forceinline__ int staged_bytes(int tile_cap, int k) {
  return ((tile_cap + k + 30) / 16) * 16;
}

// Bytes at the front of dynamic shared memory: the staged sequence, and
// once it is hashed, the warps' radix bins in the same room.
__host__ __device__ __forceinline__ int front_bytes(int tile_cap, int k) {
  const int bins = kMaxThreads / kWarp * kBins * 4;
  const int staged = staged_bytes(tile_cap, k);
  return staged > bins ? staged : bins;
}

// Where slot s of the list of a fragment `len` positions long lives: XOR
// swizzled within each whole block of 32 slots (s ^ (s / 32 % 32)), so a
// warp that reads slot lane * R + r for one r (R <= 32) reads 32 distinct
// banks; a block that runs past the fragment's end stays unswizzled,
// inside the fragment's own positions.
__device__ __forceinline__ int swz(int s, int len) {
  return (s | 31) < len ? s ^ ((s >> 5) & 31) : s;
}

// Sort the list a[0, m) of a fragment `len` positions long (slots
// swizzled), one warp, when it is too long for registers: a bitonic sort
// in place in shared memory over the next power of two p >= m, whose
// padding above m is virtual (+inf: a pair reaching past m is a no-op),
// then a ballot marks the first of each run of equal values, written in
// order to `out`; returns how many.
__device__ int dedup_shared(int32_t* a, int m, int len, int lane,
                            int32_t* out) {
  int p = 1;
  while (p < m) p <<= 1;
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int q = lane; q < (p >> 1); q += kWarp) {
        const int i = ((q & ~(stride - 1)) << 1) | (q & (stride - 1));
        const int j = stride == (size >> 1) ? (i ^ (size - 1)) : i + stride;
        if (j < m) {
          const int si = swz(i, len);
          const int sj = swz(j, len);
          const int32_t x = a[si];
          const int32_t y = a[sj];
          if (x > y) {
            a[si] = y;
            a[sj] = x;
          }
        }
      }
      __syncwarp();
    }
  }
  int total = 0;
  for (int c = 0; c < m; c += kWarp) {
    const int i = c + lane;
    const int32_t v = i < m ? a[swz(i, len)] : 0;
    const bool first = i < m && (i == 0 || a[swz(i - 1, len)] != v);
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, first);
    if (first) out[total + __popc(ballot & ((1u << lane) - 1u))] = v;
    total += __popc(ballot);
  }
  return total;
}

// Sort and deduplicate the m buckets a[0, m) of a fragment `len`
// positions long (slots swizzled), one warp, whose `bins` count them by
// bucket >> shift; write the distinct buckets in order to `out` and
// return how many. Needs m <= 32 * R: each lane holds R buckets in
// registers while a scan gives each bin its room and the buckets are
// scattered into a[0, m) bin by bin; each lane then sorts its own bins by
// insertion (a bin holds about m / kBins random hashes, and equal ones
// move nothing), and a ballot keeps the first of each run.
template <int R>
__device__ int dedup_radix(int32_t* a, int m, int len, int lane, int shift,
                           int32_t* bins, int32_t* __restrict__ out) {
  int32_t v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = lane * R + r;
    v[r] = e < m ? a[swz(e, len)] : 0;
  }
  int32_t* const mine = bins + lane * kBinsPerLane;
  int lo[kBinsPerLane];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kBinsPerLane; ++i) {
    lo[i] = sum;
    sum += mine[i];
  }
  int upto = sum;  // inclusive sum over lanes
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, upto, d);
    if (lane >= d) upto += y;
  }
#pragma unroll
  for (int i = 0; i < kBinsPerLane; ++i) {
    lo[i] += upto - sum;
    mine[i] = lo[i];
  }
  __syncwarp();  // every lane has read `a` and placed its bins
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane * R + r < m) a[atomicAdd(bins + (v[r] >> shift), 1)] = v[r];
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kBinsPerLane; ++i) {
    const int hi = mine[i];
    for (int x = lo[i] + 1; x < hi; ++x) {
      const int32_t val = a[x];
      int y = x - 1;
      for (; y >= lo[i] && a[y] > val; --y) a[y + 1] = a[y];
      a[y + 1] = val;
    }
  }
  __syncwarp();
  int total = 0;
  for (int c = 0; c < m; c += kWarp) {
    const int i = c + lane;
    const int32_t val = i < m ? a[i] : 0;
    const bool first = i < m && (i == 0 || a[i - 1] != val);
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, first);
    if (first) out[total + __popc(ballot & ((1u << lane) - 1u))] = val;
    total += __popc(ballot);
  }
  return total;
}

// Sort and deduplicate the m buckets a[0, m) of a fragment (see
// dedup_radix), one warp, into `out`; returns how many are distinct.
__device__ int dedup_fragment(int32_t* a, int m, int len, int lane, int shift,
                              int32_t* bins, int32_t* __restrict__ out) {
  if (m <= 32) return dedup_radix<1>(a, m, len, lane, shift, bins, out);
  if (m <= 64) return dedup_radix<2>(a, m, len, lane, shift, bins, out);
  if (m <= 128) return dedup_radix<4>(a, m, len, lane, shift, bins, out);
  if (m <= 256) return dedup_radix<8>(a, m, len, lane, shift, bins, out);
  if (m <= 512) return dedup_radix<16>(a, m, len, lane, shift, bins, out);
  if (m <= 1024) return dedup_radix<32>(a, m, len, lane, shift, bins, out);
  return dedup_shared(a, m, len, lane, out);
}

// A start's entry in the tile's list: -1 when it selects nothing, else
// its member bucket with bit 31 set when it also selects for the
// prefilter (buckets are under 2^28, so an entry is never -1).
constexpr int32_t kNone = -1;
constexpr uint32_t kGenomeSelected = 0x80000000u;
constexpr uint32_t kBucket = 0x7FFFFFFFu;

// The bitmap bits of a selected entry v (see kNone): its member bucket,
// and its prefilter bucket, the low bits of the member bucket, when it
// also selects for the prefilter.
__device__ __forceinline__ void set_bits(int32_t v, uint32_t* mrow,
                                         uint32_t* __restrict__ prow,
                                         uint32_t pref_mask) {
  const uint32_t b = static_cast<uint32_t>(v) & kBucket;
  atomicOr(mrow + (b >> 5), 1u << (b & 31));
  if (v < 0) atomicOr(prow + ((b & pref_mask) >> 5), 1u << (b & 31));
}

// kNarrow: member widths of at most 2^kSharedMemberShift bits, whose
// bitmap a tile that holds its whole unit builds in shared memory.
template <bool kNarrow>
__global__ void __launch_bounds__(kMaxThreads, kNarrow ? 6 : 4)
    sketch_tile_kernel(
        const uint8_t* __restrict__ seq,
        const int64_t* __restrict__ unit_off,
        const int32_t* __restrict__ tile_unit,
        const int32_t* __restrict__ tile_start,
        const int32_t* __restrict__ tile_end,
        const int32_t* __restrict__ tile_frag,
        const int32_t* __restrict__ frag_start,
        const int32_t* __restrict__ frag_end,
        const int32_t* __restrict__ frag_slot, int tile_cap, int max_frags,
        int bitmap_chunks, int k, uint64_t fthresh, uint64_t gthresh,
        int member_shift, int prefilter_shift, uint32_t* __restrict__ member,
        uint32_t* __restrict__ pref, int32_t* __restrict__ counts,
        int32_t* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* const codes = smem;
  uint32_t* const mbits =
      reinterpret_cast<uint32_t*>(smem + front_bytes(tile_cap, k));
  int32_t* const list = reinterpret_cast<int32_t*>(mbits + 4 * bitmap_chunks);
  int32_t* const fs = list + tile_cap;  // fragment starts, tile offsets
  int32_t* const fe = fs + max_frags;   // fragment ends

  const int t = blockIdx.x;
  const int u = tile_unit[t];
  const int ts = tile_start[t];
  const int n = tile_end[t] - ts;
  const int64_t ubase = unit_off[u];
  const int ulen = static_cast<int>(unit_off[u + 1] - ubase);
  const int f0 = tile_frag[t];
  const int nf = tile_frag[t + 1] - f0;
  const int member_words = 1 << (member_shift - 5);
  uint32_t* const mrow = member + static_cast<size_t>(u) * member_words;
  uint32_t* const prow =
      pref + (static_cast<size_t>(u) << (prefilter_shift - 5));
  // A tile that is its whole unit builds a narrow member bitmap in shared
  // memory and writes it once.
  const bool own_bits = kNarrow && ts == 0 && n == ulen;

  for (int j = threadIdx.x; j < nf; j += blockDim.x) {
    fs[j] = frag_start[f0 + j] - ts;
    fe[j] = frag_end[f0 + j] - ts;
  }
  uint4* const b4 = reinterpret_cast<uint4*>(mbits);
  for (int c = threadIdx.x; c < bitmap_chunks; c += blockDim.x) {
    b4[c] = make_uint4(0, 0, 0, 0);
  }
  // 1. Stage bytes [ts, min(ts + n + k - 1, ulen)) of the unit, decoded
  // to 2-bit codes (4 for an invalid byte).
  const int64_t gb = ubase + ts;
  const int64_t ge = ubase + min(ts + n + k - 1, ulen);
  const int64_t a0 = gb & ~static_cast<int64_t>(15);
  const int nvec = static_cast<int>((ge - a0 + 15) >> 4);
  const uint4* const src = reinterpret_cast<const uint4*>(seq + a0);
  uint4* const dst = reinterpret_cast<uint4*>(codes);
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    dst[v] = decode16(__ldg(src + v));
  }
  __syncthreads();

  // 2. Hash and select: each start's entry at list[p], without branches.
  // Starts at or past ulen - k + 1 have no k-mer.
  const uint8_t* const s = codes + (gb - a0);
  const int nvalid = min(n, ulen - k + 1 - ts);
  const int run = nvalid > 0 ? ((nvalid + blockDim.x - 1) / blockDim.x) | 1 : 0;
  const int p0 = threadIdx.x * run;
  const int p1 = min(p0 + run, nvalid);
  if (p0 < p1) {
    const uint32_t kmask = (1u << (2 * k)) - 1u;
    const int top = 2 * (k - 1);
    const uint32_t member_mask = (1u << member_shift) - 1u;
    uint32_t fwd = 0;
    uint32_t rev = 0;
    int last_bad = p0 - 1;
    for (int i = p0; i < p0 + k - 1; ++i) {
      const uint32_t c = s[i];
      if (c > 3u) last_bad = i;
      fwd = ((fwd << 2) | (c & 3u)) & kmask;
      rev = (rev >> 2) | ((3u - (c & 3u)) << top);
    }
    for (int p = p0; p < p1; ++p) {
      const int i = p + k - 1;
      const uint32_t c = s[i];
      if (c > 3u) last_bad = i;
      fwd = ((fwd << 2) | (c & 3u)) & kmask;
      rev = (rev >> 2) | ((3u - (c & 3u)) << top);
      const uint64_t h = mix64_kmer(min(fwd, rev));
      const uint32_t e = (static_cast<uint32_t>(h) & member_mask) |
                         (h < gthresh ? kGenomeSelected : 0u);
      list[p] = last_bad < p && h < fthresh ? static_cast<int32_t>(e)
                                             : kNone;
    }
  }
  __syncthreads();
  if (GALAH_K5_STOP_AFTER == 2) return;

  // 3. The bitmaps' bits from every selected start, the block over
  // neighbouring positions (gsel is a subset of fsel, and a prefilter
  // bucket is the low bits of the member bucket).
  const uint32_t pref_mask = (1u << prefilter_shift) - 1u;
  for (int p = threadIdx.x; p < nvalid; p += blockDim.x) {
    const int32_t v = list[p];
    if (v == kNone) continue;
    if (own_bits) {  // shared-memory atomics
      set_bits(v, mbits, prow, pref_mask);
    } else {
      set_bits(v, mrow, prow, pref_mask);
    }
  }
  __syncthreads();
  if (GALAH_K5_STOP_AFTER == 3) return;

  // 4. Each fragment's distinct buckets in order. Warp w takes fragments
  // w, w + nwarps, ...: it reads a fragment's entries 32 at a time,
  // compacts the selected buckets to the front of the fragment's own
  // positions (a ballot ranks them; a slot is never past the position
  // read) while counting them into its radix bins, which the staged bytes
  // no longer need, and sorts and deduplicates them into the fragment's
  // slots of `scratch`.
  const int lane = threadIdx.x & (kWarp - 1);
  const unsigned below = (1u << lane) - 1u;
  const int shift = member_shift > kBinBits ? member_shift - kBinBits : 0;
  int32_t* const bins =
      reinterpret_cast<int32_t*>(codes) + threadIdx.x / kWarp * kBins;
  for (int j = threadIdx.x / kWarp; j < nf; j += blockDim.x / kWarp) {
    int32_t* const a = list + fs[j];
    const int len = fe[j] - fs[j];
    const int end = min(fe[j], nvalid) - fs[j];
    for (int b = lane; b < kBins; b += kWarp) bins[b] = 0;
    __syncwarp();
    int m = 0;
    for (int c = 0; c < end; c += kWarp) {
      const int i = c + lane;
      const int32_t v = i < end ? a[i] : kNone;
      const bool sel = v != kNone;
      const int32_t b = v & kBucket;
      if (sel) atomicAdd(bins + (b >> shift), 1);
      // Every lane has read its entry before any lane passes the ballot.
      const unsigned ballot = __ballot_sync(0xFFFFFFFFu, sel);
      if (sel) a[swz(m + __popc(ballot & below), len)] = b;
      m += __popc(ballot);
    }
    __syncwarp();
    const int total = dedup_fragment(a, m, len, lane, shift, bins,
                                     scratch + frag_slot[f0 + j]);
    if (lane == 0) counts[f0 + j] = total;
    __syncwarp();  // the bins are read before the next fragment clears them
  }

  // A member bitmap built in shared memory goes out once.
  if (own_bits) {
    for (int c = threadIdx.x; c < bitmap_chunks; c += blockDim.x) {
      const uint4 x = b4[c];
      if (4 * c + 4 <= member_words) {
        reinterpret_cast<uint4*>(mrow)[c] = x;
      } else {  // a row of under 4 words
        const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
        for (int q = 0; q < member_words; ++q) mrow[q] = xs[q];
      }
    }
  }
}

// 16-byte chunks of a member bitmap in shared memory: its width's, for
// widths of at most 2^kSharedMemberShift bits, else none.
int bitmap_chunks_for(int member_shift) {
  return member_shift <= kSharedMemberShift
             ? ((1 << (member_shift - 5)) + 3) / 4
             : 0;
}

// Dynamic shared memory of one block: the staged bytes (or the radix
// bins), the member bitmap, one list entry a start of the longest tile,
// two words a fragment of the tile that holds the most.
size_t shared_bytes(int tile_cap, int max_frags, int k, int bitmap_chunks) {
  return static_cast<size_t>(front_bytes(tile_cap, k)) +
         16 * static_cast<size_t>(bitmap_chunks) +
         4 * static_cast<size_t>(tile_cap) + 8 * static_cast<size_t>(max_frags);
}

}  // namespace

// What galah_device_sketch launches for these arguments: returns the
// dynamic shared memory of a block in bytes and sets *narrow to 1 when
// it takes the instance with the member bitmap in shared memory.
extern "C" long long galah_device_sketch_shared(int tile_cap, int max_frags,
                                                int k, int member_shift,
                                                int* narrow) {
  const int chunks = bitmap_chunks_for(member_shift);
  *narrow = chunks > 0;
  return static_cast<long long>(shared_bytes(tile_cap, max_frags, k, chunks));
}

// Launch K5 on `stream`, one block of `threads` threads (a multiple of
// 32, at most kMaxThreads) a tile; returns the CUDA error of the launch
// (0 when accepted; a block that needs more shared memory than the card
// has is refused here). tile_cap is the batch's longest tile in starts,
// max_frags its most fragments in one tile. Member widths of at most
// 2^kSharedMemberShift bits get a bitmap in shared memory.
extern "C" int galah_device_sketch(
    const uint8_t* seq, const int64_t* unit_off, const int32_t* tile_unit,
    const int32_t* tile_start, const int32_t* tile_end,
    const int32_t* tile_frag, const int32_t* frag_start,
    const int32_t* frag_end, const int32_t* frag_slot, int n_tiles,
    int tile_cap, int max_frags, int k, unsigned long long fthresh,
    unsigned long long gthresh, int member_shift, int prefilter_shift,
    uint32_t* member, uint32_t* pref, int32_t* counts, int32_t* scratch,
    int threads, cudaStream_t stream) {
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  const int bitmap_chunks = bitmap_chunks_for(member_shift);
  const size_t smem = shared_bytes(tile_cap, max_frags, k, bitmap_chunks);
  const auto kernel = bitmap_chunks > 0 ? sketch_tile_kernel<true>
                                        : sketch_tile_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_tiles, threads, smem, stream>>>(
      seq, unit_off, tile_unit, tile_start, tile_end, tile_frag, frag_start,
      frag_end, frag_slot, tile_cap, max_frags, bitmap_chunks, k, fthresh,
      gthresh, member_shift, prefilter_shift, member, pref, counts, scratch);
  return static_cast<int>(cudaGetLastError());
}
