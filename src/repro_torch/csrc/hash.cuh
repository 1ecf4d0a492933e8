// Counter-hash pairwise secure-aggregation streams (eq. 23), device side.
//
// Replaces the device functions of the Pallas kernels in
// src/repro/kernels/secure_agg.py: _hash_u32, pair_stream and the pair
// enumeration of net_mask_stream.  The arithmetic is uint32 with wrapping
// multiplies and logical shifts, so the streams are bit-identical to the
// reference's (and to the plain torch version in
// repro_torch/kernels/secure_agg.py).
#pragma once
#include <cstdint>

namespace gfl {

// Murmur3 finalizer on uint32.
__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The per-(pair, seed) half of pair_stream: it does not depend on the
// feature index, so a block computes it once per pair.
__device__ __forceinline__ uint32_t pair_key(uint32_t pid, uint32_t seed) {
  return hash_u32(pid * 0x9E3779B9u + seed);
}

// Uniform(-scale, scale) value of a pair's stream at feature idx: the top
// 24 bits of the hash times 2^-24 give u in [0, 1) exactly in float32.
__device__ __forceinline__ float pair_value(uint32_t key, uint32_t idx,
                                            float scale) {
  const uint32_t h = hash_u32(idx ^ key);
  const float u = static_cast<float>(h >> 8) * (1.0f / 16777216.0f);
  return __fmul_rn(__fsub_rn(__fmul_rn(2.0f, u), 1.0f), scale);
}

// Row-major (a < b) pair id: a(2L - a - 1)/2 + (b - a - 1).
__device__ __forceinline__ int pair_id(int a, int b, int L) {
  return (a * (2 * L - a - 1)) / 2 + (b - a - 1);
}

// Inverse of pair_id: the pair (a, b) with id pid.
__device__ __forceinline__ void pair_of(int pid, int L, int* a, int* b) {
  int r = 0;
  while (r + 1 < L && pair_id(r + 1, r + 2, L) <= pid) ++r;
  *a = r;
  *b = pid - pair_id(r, r + 1, L) + r + 1;
}

}  // namespace gfl
