// The verify's per-fragment work, shared by K7 (pair_table_verify.cu) and
// K8 (grouped_verify.cu): a warp counts one fragment's hashes that are set
// in a target bitmap row, and lane 0 turns that count into the fragment's
// identity.
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

#include <cstdint>

namespace galah_verify {

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

// The number of stream[lo, hi) buckets whose bit is set in `row`, summed
// over the warp and returned to every lane. Lanes stride over the range,
// four loads in flight a lane: the stream words (read once, coalesced)
// and then the bitmap words they pick (random within the row; a row is
// 512 KiB at 2^22 bits, so the blocks reading it together keep it in L2).
__device__ __forceinline__ int warp_hits(const int32_t* __restrict__ stream,
                                         int lo, int hi,
                                         const uint32_t* __restrict__ row) {
  const int lane = threadIdx.x & 31;
  int hits = 0;
  int i = lo + lane;
  for (; i + 96 < hi; i += 128) {
    const int32_t b0 = __ldg(stream + i);
    const int32_t b1 = __ldg(stream + i + 32);
    const int32_t b2 = __ldg(stream + i + 64);
    const int32_t b3 = __ldg(stream + i + 96);
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
    const int32_t b = __ldg(stream + i);
    hits += static_cast<int>((__ldg(row + (b >> 5)) >> (b & 31)) & 1u);
  }
  return __reduce_add_sync(0xffffffffu, hits);
}

}  // namespace galah_verify
