// The one multiply-shift hash family of the port, for CUDA kernels.
//
// Device spelling of src/repro_torch/kernels/hashing.py (and of the JAX
// package's kernels/hashing.py): odd uint32 multiplier, uint32 offset,
// wrap-around mod 2^32, xorshift finalizer.  On native uint32_t the wrap is
// defined, so these are the same bits as the torch version, which holds
// uint32 values in int64 and masks.  Count-Sketch (count_sketch.cu) and the
// l0 sampler (l0_sampler.cu) both include this header; the kernels'
// library names hash it with their sources, so an edit here rebuilds both.

#pragma once

#include <stdint.h>

namespace repro_hash {

constexpr uint32_t kAvalanche = 0x7FEB352Du;

// h = a*x + c (mod 2^32), xorshift-finalized.  a must be odd.
__device__ __forceinline__ uint32_t mix32(uint32_t a, uint32_t c, uint32_t x) {
  const uint32_t h = a * x + c;
  return h ^ (h >> 16);
}

// Count-Sketch column: the mixed value mod the bucket count.
__device__ __forceinline__ int32_t bucket32(uint32_t h, uint32_t n_buckets) {
  return (int32_t)(h % n_buckets);
}

// Count-Sketch sign: +1 when the top bit is clear, else -1.
__device__ __forceinline__ float sign32(uint32_t h) {
  return (h >> 31) == 0u ? 1.0f : -1.0f;
}

// h = a_x*x + a_y*y + c (mod 2^32), xorshift, odd avalanche multiply,
// xorshift: the l0 sampler's edge hash.
__device__ __forceinline__ uint32_t mix32_pair(uint32_t a_x, uint32_t a_y,
                                               uint32_t c, uint32_t x,
                                               uint32_t y) {
  uint32_t h = a_x * x + a_y * y + c;
  h ^= h >> 16;
  h *= kAvalanche;
  return h ^ (h >> 15);
}

// Geometric level min(clz(h), L-1).  __clz(0) is 32, so h == 0 lands on
// L-1 (below every threshold of the reference's compare-based sum), and
// L == 1 gives 0.
__device__ __forceinline__ int32_t level_from_hash(uint32_t h, int32_t n_levels) {
  const int32_t z = __clz((int)h);
  return z < n_levels - 1 ? z : n_levels - 1;
}

}  // namespace repro_hash
