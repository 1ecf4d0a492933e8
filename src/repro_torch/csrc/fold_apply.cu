// K2 fold_apply: fused scale -> update -> privatize -> fold (eqs. 6-7, 23).
//
// Replaces the Pallas kernel src/repro/kernels/round_fold.py:fold_apply
// (_fold_kernel).  Per server p and feature d:
//
//   psi[p, d] = sum_k fw[p,k] * (w[p,(k),d] - ss[p,k] * g[p,k,d]) + noise
//
//   mode 0 "none":    no noise term;
//   mode 1 "laplace": + sum_k nw[p,k] * noise[p,k,d] (pre-drawn);
//   mode 2 "mask":    + sum_k nw[p,k] * mask_k[d], the net pairwise
//                     counter-hash mask of client k over alive peers.
//
// w is [P, D] (shared base) or [P, L, D] (per-client bases); g and noise
// are f32 or bf16 and are summed in f32; psi comes back in w's dtype.
//
// Bound on the H100: HBM bytes for modes none and laplace (one read of g,
// noise and w, one write of psi).  Mask mode adds L(L-1)/2 hashes per
// element, which stay cheap at the main path's L=50, D=2 and reach the
// integer roof only at wide D.
//
// Design.  One thread owns one (p, d) and walks the clients in order, so
// the fold needs no cross-thread reduction and is bitwise repeatable; the
// neighbouring threads read neighbouring d, so every g row is read
// coalesced.  The [P, L] weights sit in shared memory.  In mask mode each
// pair (a < b) enters the fold twice in the reference, +s with weight
// nw[a] in a's net mask and -s with weight nw[b] in b's; the kernel hashes
// each alive pair once and adds (nw[a] - nw[b]) * s, which is the same sum
// regrouped (exactly zero for uniform weights, as eq. 23 says).  The
// feature-independent half of the hash is computed once per pair per
// block into shared memory, in chunks, so L is not capped by shared
// memory.  Ragged D is masked by the thread's bound; nothing is padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPairChunk = 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename W, typename G>
__global__ void __launch_bounds__(kThreads)
fold_apply_kernel(const W* __restrict__ w, int per_client_base,
                  const G* __restrict__ g, const float* __restrict__ ss,
                  const float* __restrict__ fw, const float* __restrict__ nw,
                  int mode, float sigma, const uint32_t* __restrict__ seeds,
                  const G* __restrict__ noise, W* __restrict__ out, int L,
                  int64_t D) {
  extern __shared__ float smem[];
  float* s_ss = smem;
  float* s_fw = smem + L;
  float* s_nw = smem + 2 * L;
  __shared__ uint32_t s_key[kPairChunk];
  __shared__ float s_coef[kPairChunk];
  __shared__ unsigned char s_live[kPairChunk];

  const int p = blockIdx.y;
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = d < D;
  for (int k = threadIdx.x; k < L; k += kThreads) {
    s_ss[k] = ss[p * L + k];
    s_fw[k] = fw[p * L + k];
    s_nw[k] = nw[p * L + k];
  }
  __syncthreads();

  float acc = 0.0f;
  float nacc = 0.0f;
  if (active) {
    const int64_t row0 = static_cast<int64_t>(p) * L;
    const float w_shared = per_client_base ? 0.0f : to_f32(w[p * D + d]);
    for (int k = 0; k < L; ++k) {
      const float wb = per_client_base ? to_f32(w[(row0 + k) * D + d])
                                       : w_shared;
      const float upd = wb - s_ss[k] * to_f32(g[(row0 + k) * D + d]);
      acc = fmaf(s_fw[k], upd, acc);
    }
    if (mode == 1) {
      for (int k = 0; k < L; ++k)
        nacc = fmaf(s_nw[k], to_f32(noise[(row0 + k) * D + d]), nacc);
    }
  }
  if (mode == 2) {
    const uint32_t seed = seeds[p];
    const uint32_t idx = static_cast<uint32_t>(d);
    const int npairs = L * (L - 1) / 2;
    for (int base = 0; base < npairs; base += kPairChunk) {
      const int n = npairs - base < kPairChunk ? npairs - base : kPairChunk;
      __syncthreads();
      for (int t = threadIdx.x; t < n; t += kThreads) {
        int a, b;
        gfl::pair_of(base + t, L, &a, &b);
        s_key[t] = gfl::pair_key(static_cast<uint32_t>(base + t), seed);
        s_coef[t] = s_nw[a] - s_nw[b];
        s_live[t] = (s_nw[a] > 0.0f) && (s_nw[b] > 0.0f);
      }
      __syncthreads();
      if (active) {
        for (int i = 0; i < n; ++i)
          if (s_live[i])
            nacc = fmaf(s_coef[i], gfl::pair_value(s_key[i], idx, sigma),
                        nacc);
      }
    }
  }
  if (active) store(&out[p * D + d], acc + nacc);
}

template <typename W, typename G>
cudaError_t launch(const void* w, int per_client_base, const void* g,
                   const float* ss, const float* fw, const float* nw,
                   int mode, float sigma, const uint32_t* seeds,
                   const void* noise, void* out, int P, int L, int64_t D,
                   cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((D + kThreads - 1) / kThreads), P);
  const size_t smem = 3 * static_cast<size_t>(L) * sizeof(float);
  fold_apply_kernel<W, G><<<grid, kThreads, smem, stream>>>(
      static_cast<const W*>(w), per_client_base, static_cast<const G*>(g), ss,
      fw, nw, mode, sigma, seeds, static_cast<const G*>(noise),
      static_cast<W*>(out), L, D);
  return cudaGetLastError();
}

}  // namespace

// w: [P, D] or [P, L, D] (per_client_base) of float/bf16 (w_bf16);
// g, noise: [P, L, D] of float/bf16 (g_bf16); ss, fw, nw: [P, L] f32;
// seeds: [P] uint32 (mode 2); out: [P, D] in w's dtype.
extern "C" int gfl_fold_apply(const void* w, int w_bf16, int per_client_base,
                              const void* g, int g_bf16, const float* ss,
                              const float* fw, const float* nw, int mode,
                              float sigma, const uint32_t* seeds,
                              const void* noise, void* out, int P, int L,
                              int64_t D, cudaStream_t stream) {
  if (P <= 0 || L <= 0 || D <= 0 || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (w_bf16 && g_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(w, per_client_base, g, ss, fw,
                                               nw, mode, sigma, seeds, noise,
                                               out, P, L, D, stream);
  else if (w_bf16)
    err = launch<__nv_bfloat16, float>(w, per_client_base, g, ss, fw, nw,
                                       mode, sigma, seeds, noise, out, P, L,
                                       D, stream);
  else if (g_bf16)
    err = launch<float, __nv_bfloat16>(w, per_client_base, g, ss, fw, nw,
                                       mode, sigma, seeds, noise, out, P, L,
                                       D, stream);
  else
    err = launch<float, float>(w, per_client_base, g, ss, fw, nw, mode, sigma,
                               seeds, noise, out, P, L, D, stream);
  return static_cast<int>(err);
}
