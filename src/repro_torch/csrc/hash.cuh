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

// x ^ (x >> 16), the Murmur3 finalizer's first step.  It distributes over
// xor, premix(a ^ b) = premix(a) ^ premix(b), so the idx ^ key of a stream
// can be premixed half by half: each key once, each feature index once.
__device__ __forceinline__ uint32_t premix(uint32_t x) { return x ^ (x >> 16); }

// The Murmur3 finalizer after its first step.
__device__ __forceinline__ uint32_t hash_tail(uint32_t x) {
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Murmur3 finalizer on uint32.
__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  return hash_tail(premix(x));
}

// The per-(pair, seed) half of pair_stream: it does not depend on the
// feature index, so a block computes it once per pair.
__device__ __forceinline__ uint32_t pair_key(uint32_t pid, uint32_t seed) {
  return hash_u32(pid * 0x9E3779B9u + seed);
}

// The Uniform(-scale, scale) value of a stream's hash h: with u = (h >> 8)
// 2^-24, the top 24 bits of h, exactly in float32, it is (2u - 1) scale.
// 2u - 1 = (h >> 8) 2^-23 - 1 is exact in float32, so the reference's
// (2u - 1) * scale rounds once; the fma (h >> 8) (scale 2^-23) - scale
// rounds the same exact value once, so the two agree bit for bit while
// scale 2^-23 is a normal float (at scale 0, up to the sign of a zero).
__device__ __forceinline__ float stream_value(uint32_t h, float scale) {
  return __fmaf_rn(static_cast<float>(h >> 8), scale * (1.0f / 8388608.0f),
                   -scale);
}

// Uniform(-scale, scale) value of a pair's stream at feature idx.
__device__ __forceinline__ float pair_value(uint32_t key, uint32_t idx,
                                            float scale) {
  return stream_value(hash_u32(idx ^ key), scale);
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

// The row a of pair id pid among n items (the largest a with
// pair_id(a, a + 1, n) <= pid), by bisection: O(log n).
__device__ __forceinline__ int pair_row(int pid, int n) {
  int lo = 0, hi = n - 2;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pair_id(mid, mid + 1, n) <= pid) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Walks the pairs (i < j) of n items whose ids pair_id(i, j, n) lie in
// [lo, hi), row by row, calling f(pid - lo, i, j) for each; the calling
// thread takes cells tid, tid + nthreads, ... of the walk.  The rows that
// hold [lo, hi) are walked as a grid of cells, row i0's length wide, so a
// pair's (i, j) is read off its cell and no id is inverted by a search;
// cells past a row's end or outside [lo, hi) are skipped.  Every id in
// [lo, hi) is visited exactly once.
template <typename F>
__device__ __forceinline__ void walk_pairs(int n, int lo, int hi, int tid,
                                           int nthreads, F f) {
  const int i0 = pair_row(lo, n), i1 = pair_row(hi - 1, n) + 1;
  const int width = n - 1 - i0;
  const int cells = (i1 - i0) * width;
  for (int t = tid; t < cells; t += nthreads) {
    const int r = t / width;
    const int i = i0 + r, j = i + 1 + (t - r * width);
    if (j >= n) continue;
    const int pid = pair_id(i, j, n);
    if (pid >= lo && pid < hi) f(pid - lo, i, j);
  }
}

}  // namespace gfl
