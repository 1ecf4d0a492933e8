// The counter-hash pair streams of hash.cuh written out, for checking.
//
// The device functions in hash.cuh replace src/repro/kernels/secure_agg.py
// _hash_u32 / pair_stream / the pair enumeration of net_mask_stream, and
// run inside fold_apply's mask mode.  This kernel writes every pair's
// stream, out[pid, d] = pair_stream(pid, d, seed, scale), so that the
// device arithmetic can be held bit for bit against the plain torch
// version.  It is a check, not a step of the round.
//
// Bound on the H100: bytes written (npairs * D floats); two hashes per
// element.
#include <cuda_runtime.h>
#include <cstdint>

#include "hash.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pair_streams_kernel(uint32_t seed, float scale, float* __restrict__ out,
                    int64_t D) {
  const uint32_t pid = blockIdx.y;
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (d >= D) return;
  const uint32_t key = gfl::pair_key(pid, seed);
  out[pid * D + d] = gfl::pair_value(key, static_cast<uint32_t>(d), scale);
}

}  // namespace

// out: [npairs, D] f32.
extern "C" int gfl_pair_streams(uint32_t seed, float scale, float* out,
                                int npairs, int64_t D, cudaStream_t stream) {
  if (npairs <= 0 || npairs > 65535 || D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((D + kThreads - 1) / kThreads),
                  npairs);
  pair_streams_kernel<<<grid, kThreads, 0, stream>>>(seed, scale, out, D);
  return static_cast<int>(cudaGetLastError());
}
