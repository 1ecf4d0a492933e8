// K6 clip_accum, pass 2: clip each client's gradient to the B-ball and
// take the mean over clients.
//
// Replaces the Pallas kernel src/repro/kernels/clip_accum.py:clip_accum
// (_scale_mean_kernel; its first pass, _sumsq_kernel, is K1 fold_norms at
// P = 1 and is launched as that kernel by the wrapper).  Per feature d:
//
//   out[d] = (sum_k coef_k * g[k, d]) / L,
//   coef_k = min(1, B / max(sqrt(sq_k), 1e-12)),
//
// with sq [L] the f32 squared norms from pass 1, g [L, D] f32/bf16 summed
// in f32, and out cast once to g's dtype.
//
// Bound on the H100: HBM bytes.  This pass reads g once and writes out;
// with pass 1 the op reads g twice (the bound counts each input byte once).
//
// Design.  One thread owns one feature and walks the clients in order, so
// the mean needs no cross-thread reduction, no atomics, and is bitwise
// equal from run to run; neighbouring threads read neighbouring d, so every
// row of g is read coalesced.  Each block first turns the L squared norms
// into clip coefficients in shared memory; the norms never leave the
// device, so there is no host sync between the passes.  Ragged D is masked
// by the thread's bound; nothing is padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
clip_mean(const T* __restrict__ g, const float* __restrict__ sq, float bound,
          T* __restrict__ out, int L, int64_t D) {
  extern __shared__ float s_coef[];
  for (int k = threadIdx.x; k < L; k += kThreads) {
    const float nrm = sqrtf(sq[k]);
    s_coef[k] = fminf(1.0f, bound / fmaxf(nrm, 1e-12f));
  }
  __syncthreads();
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (d >= D) return;
  float acc = 0.0f;
  for (int k = 0; k < L; ++k)
    acc += to_f32(g[static_cast<int64_t>(k) * D + d]) * s_coef[k];
  store(&out[d], acc / static_cast<float>(L));
}

}  // namespace

// g: [L, D] float (bf16 = 0) or bf16 (bf16 = 1); sq: [L] f32 squared norms
// (pass 1); out: [D] in g's dtype.
extern "C" int gfl_clip_accum(const void* g, int bf16, const float* sq,
                              float bound, void* out, int L, int64_t D,
                              cudaStream_t stream) {
  if (L <= 0 || D <= 0 || L > 12288)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((D + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(L) * sizeof(float);
  if (bf16)
    clip_mean<__nv_bfloat16><<<blocks, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(g), sq, bound,
        static_cast<__nv_bfloat16*>(out), L, D);
  else
    clip_mean<float><<<blocks, kThreads, smem, stream>>>(
        static_cast<const float*>(g), sq, bound, static_cast<float*>(out), L,
        D);
  return static_cast<int>(cudaGetLastError());
}
