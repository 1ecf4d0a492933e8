// K3 graph_combine: fused graph-homomorphic server combination (eq. 8 + 24).
//
// Replaces the Pallas kernel src/repro/kernels/graph_combine.py:
// graph_combine (_combine_kernel).  Per feature d:
//
//   psi_eff[m] = gate[m] * psi[m] + (1 - gate[m]) * cache[m]   (gated)
//   out[p]     = sum_m a_t[p, m] * (psi_eff[m] + g[m]) - g[p]    (with g)
//   out[p]     = sum_m a_t[p, m] * psi_eff[m]                    (g = None)
//
// with a_t = A^T [P, P] f32 and psi, g, cache, out [P, D] f32 or bf16,
// mixed in f32 with plain FMAs (no TF32).
//
// Bound on the H100: HBM bytes.  P is at most a few tens, so the P x P mix
// costs 2P operations per byte read, well under the card's ratio; the
// kernel reads psi and g (and cache) once and writes out once.
//
// Design.  A block owns 128 consecutive features; each thread stages its
// column of psi_eff (+ g) in shared memory, then forms the P outputs of
// its column from the shared A^T.  Reads and writes are coalesced along D,
// each output is one thread's fixed-order sum (bitwise repeatable), and
// ragged D is masked by the thread's bound.  The reference pads P to 8
// and D to the tile for the TPU; this kernel pads nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxP = 64;

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
combine_kernel(const float* __restrict__ a_t, const T* __restrict__ psi,
               const T* __restrict__ g, const T* __restrict__ cache,
               const float* __restrict__ gate, T* __restrict__ out, int P,
               int64_t D) {
  extern __shared__ float smem[];
  float* s_a = smem;                  // [P, P]
  float* s_x = smem + P * P;          // [P, kThreads]
  for (int i = threadIdx.x; i < P * P; i += kThreads) s_a[i] = a_t[i];
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = d < D;
  if (active) {
    for (int m = 0; m < P; ++m) {
      float x = to_f32(psi[m * D + d]);
      if (gate != nullptr) {
        const float gm = gate[m];
        x = gm * x + (1.0f - gm) * to_f32(cache[m * D + d]);
      }
      if (g != nullptr) x += to_f32(g[m * D + d]);
      s_x[m * kThreads + threadIdx.x] = x;
    }
  }
  __syncthreads();
  if (!active) return;
  for (int p = 0; p < P; ++p) {
    float acc = 0.0f;
    for (int m = 0; m < P; ++m)
      acc = fmaf(s_a[p * P + m], s_x[m * kThreads + threadIdx.x], acc);
    if (g != nullptr) acc -= to_f32(g[p * D + d]);
    store(&out[p * D + d], acc);
  }
}

}  // namespace

// a_t: [P, P] f32; psi, g, cache, out: [P, D] of float/bf16 (bf16 flag);
// gate: [P] f32.  g, cache and gate may be null (cache and gate together).
extern "C" int gfl_graph_combine(const float* a_t, const void* psi,
                                 const void* g, const void* cache,
                                 const float* gate, void* out, int bf16,
                                 int P, int64_t D, cudaStream_t stream) {
  if (P <= 0 || P > kMaxP || D <= 0 || ((cache == nullptr) != (gate == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((D + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(P) * (P + kThreads) * sizeof(float);
  if (bf16)
    combine_kernel<__nv_bfloat16><<<blocks, kThreads, smem, stream>>>(
        a_t, static_cast<const __nv_bfloat16*>(psi),
        static_cast<const __nv_bfloat16*>(g),
        static_cast<const __nv_bfloat16*>(cache), gate,
        static_cast<__nv_bfloat16*>(out), P, D);
  else
    combine_kernel<float><<<blocks, kThreads, smem, stream>>>(
        a_t, static_cast<const float*>(psi), static_cast<const float*>(g),
        static_cast<const float*>(cache), gate, static_cast<float*>(out), P,
        D);
  return static_cast<int>(cudaGetLastError());
}
