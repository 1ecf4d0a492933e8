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
// noise and w, one write of psi).  Mask mode adds one hash per alive pair
// and feature, which bounds it by the INT32 lanes at wide D.
//
// Mask mode regroups the reference's sum.  Each alive pair (a < b) enters
// the reference's fold twice, +s with weight nw[a] in a's net mask and -s
// with weight nw[b] in b's; the kernel hashes each alive pair once and adds
// (nw[a] - nw[b]) * s (exactly zero for uniform weights, as eq. 23 says).
// A block first lists the alive clients in order (a warp ballot), then
// builds the alive pairs' keys and coefficients in shared memory, in
// chunks, walking the rows of the pairs (hash.cuh: walk_pairs) in pair-id
// order: dead pairs never enter the list, so the hot loop has no branch.
//
// Layout (kernels/round_fold.py: fold_layout picks it from the shape).  A
// block of 256 threads is F feature columns x S slices (F S = 256), and a
// thread owns kFpt features of its column, F apart:
//   D < 256: F is the next power of two >= D and S = 256 / F.  Slice s
//            folds clients s, s + S, ... and alive pairs s, s + S, ... of
//            every chunk into one register in index order; a fixed-order
//            shared-memory tree then adds the S slices of each feature.
//            The main path's D = 2 gives 2 x 128 (the old layout left 254
//            of 256 threads idle there).
//   wide D:  F = 256, S = 1: one thread walks every client and pair in
//            order, the loads of several clients in flight.  In mask mode
//            it owns 2 or 4 features (kFpt), so each shared-memory key and
//            coefficient serves all of them.
// Each mode and layout is its own instantiation, and shared memory is
// sized to what the mode uses, so modes none and laplace carry nothing of
// the mask path.  No atomics: reruns are bitwise equal.  Ragged D is masked by each
// feature's bound; nothing is padded.  Seeds are read as stored, int32 or
// int64, and their low 32 bits taken: the uint32 value in both cases.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPairChunk = 2048;   // alive pairs in shared memory at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Shared memory, all dynamic: ss, fw, nw and the alive list ([L] each),
// then the chunk's pair keys and coefficients (mask mode), whose room the
// slices' tree reuses once they are read.
size_t smem_words(int L, int mode, bool sliced, int chunk) {
  const int pairs = mode == 2 ? 2 * chunk : 0;
  const int tree = sliced ? kThreads : 0;
  return 4 * static_cast<size_t>(L) + (pairs > tree ? pairs : tree);
}

// kMode: 0 none, 1 laplace, 2 mask.  kSliced: F = 2^f_log2 columns x
// S = 256 / F slices; else F = 256, S = 1, and the loops over clients
// have a unit stride the compiler unrolls, keeping loads in flight.
template <typename W, typename G, int kMode, int kFpt, bool kSliced>
__global__ void __launch_bounds__(kThreads)
fold_apply_kernel(const W* __restrict__ w, const G* __restrict__ g,
                  const float* __restrict__ ss, const float* __restrict__ fw,
                  const float* __restrict__ nw,
                  const void* __restrict__ aux, W* __restrict__ out, int L,
                  int64_t D, float sigma, int per_client, int seeds64,
                  int f_log2, int chunk) {
  extern __shared__ float smem[];
  float* s_ss = smem;
  float* s_fw = smem + L;
  float* s_nw = smem + 2 * L;
  int* s_alive = reinterpret_cast<int*>(smem + 3 * L);
  uint32_t* s_key = reinterpret_cast<uint32_t*>(smem + 4 * L);
  float* s_coef = smem + 4 * L + chunk;
  __shared__ int s_nalive;

  const int tid = threadIdx.x;
  const int F = kSliced ? 1 << f_log2 : kThreads;
  const int S = kSliced ? kThreads >> f_log2 : 1;
  const int slice = kSliced ? tid >> f_log2 : 0;
  const int p = blockIdx.y;
  const int64_t d0 =
      static_cast<int64_t>(blockIdx.x) * F * kFpt + (tid & (F - 1));
  const int64_t row0 = static_cast<int64_t>(p) * L;
  for (int k = tid; k < L; k += kThreads) {
    s_ss[k] = ss[row0 + k];
    s_fw[k] = fw[row0 + k];
    s_nw[k] = nw[row0 + k];
  }
  __syncthreads();

  bool in[kFpt];
  float acc[kFpt], nacc[kFpt], w_shared[kFpt];
#pragma unroll
  for (int q = 0; q < kFpt; ++q) {
    const int64_t d = d0 + q * F;
    in[q] = d < D;
    acc[q] = nacc[q] = 0.0f;
    w_shared[q] = in[q] && !per_client ? to_f32(w[p * D + d]) : 0.0f;
  }
#pragma unroll 4
  for (int k = slice; k < L; k += S) {
#pragma unroll
    for (int q = 0; q < kFpt; ++q) {
      if (!in[q]) continue;
      const int64_t e = (row0 + k) * D + d0 + q * F;
      const float wb = per_client ? to_f32(w[e]) : w_shared[q];
      acc[q] = fmaf(s_fw[k], wb - s_ss[k] * to_f32(g[e]), acc[q]);
    }
  }
  if (kMode == 1) {
    const G* __restrict__ noise = static_cast<const G*>(aux);
#pragma unroll 4
    for (int k = slice; k < L; k += S) {
#pragma unroll
      for (int q = 0; q < kFpt; ++q)
        if (in[q])
          nacc[q] = fmaf(s_nw[k],
                         to_f32(noise[(row0 + k) * D + d0 + q * F]), nacc[q]);
    }
  }
  if (kMode == 2) {
    // the alive clients in order: warp 0 ballots 32 at a time
    if (tid < 32) {
      int count = 0;
      for (int base = 0; base < L; base += 32) {
        const int k = base + tid;
        const bool live = k < L && s_nw[k] > 0.0f;
        const unsigned m = __ballot_sync(0xffffffffu, live);
        if (live) s_alive[count + __popc(m & ((1u << tid) - 1u))] = k;
        count += __popc(m);
      }
      if (tid == 0) s_nalive = count;
    }
    __syncthreads();
    const int A = s_nalive;
    const int npairs = A * (A - 1) / 2;
    const uint32_t seed =                              // the low word
        static_cast<const uint32_t*>(aux)[seeds64 ? 2 * p : p];
    uint32_t idx[kFpt];
#pragma unroll
    for (int q = 0; q < kFpt; ++q) idx[q] = static_cast<uint32_t>(d0 + q * F);
    for (int lo = 0; lo < npairs; lo += chunk) {
      const int n = npairs - lo < chunk ? npairs - lo : chunk;
      __syncthreads();   // the previous chunk is read
      gfl::walk_pairs(A, lo, lo + n, tid, kThreads, [&](int c, int i, int j) {
        const int ka = s_alive[i], kb = s_alive[j];
        s_key[c] = gfl::pair_key(
            static_cast<uint32_t>(gfl::pair_id(ka, kb, L)), seed);
        s_coef[c] = s_nw[ka] - s_nw[kb];
      });
      __syncthreads();
      for (int c = slice; c < n; c += S) {
        const uint32_t key = s_key[c];
        const float coef = s_coef[c];
#pragma unroll
        for (int q = 0; q < kFpt; ++q)
          nacc[q] = fmaf(coef, gfl::pair_value(key, idx[q], sigma), nacc[q]);
      }
    }
  }

  if (!kSliced) {
#pragma unroll
    for (int q = 0; q < kFpt; ++q)
      if (in[q]) store(&out[p * D + d0 + q * F], acc[q] + nacc[q]);
    return;
  }
  // the slices of each feature added by a fixed tree: the halves h >= F
  // keep a thread's column
  float* s_red = smem + 4 * L;
  __syncthreads();   // the last chunk is read
  s_red[tid] = acc[0] + nacc[0];
  for (int h = kThreads >> 1; h >= F; h >>= 1) {
    __syncthreads();
    if (tid < h) s_red[tid] += s_red[tid + h];
  }
  if (tid < F && in[0]) store(&out[p * D + d0], s_red[tid]);
}

struct Launch {
  const void* w;
  const void* g;
  const float* ss;
  const float* fw;
  const float* nw;
  const void* aux;
  void* out;
  int P, L;
  int64_t D;
  float sigma;
  int per_client, seeds64, f_log2;
};

template <typename W, typename G, int kMode, int kFpt, bool kSliced>
cudaError_t launch(const Launch& a, cudaStream_t stream) {
  const int chunk =
      kMode == 2 ? (a.L * (a.L - 1) / 2 < kPairChunk ? a.L * (a.L - 1) / 2
                                                      : kPairChunk)
                 : 0;
  const size_t smem =
      smem_words(a.L, kMode, kSliced, chunk) * sizeof(float);
  auto kernel = fold_apply_kernel<W, G, kMode, kFpt, kSliced>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t per_block = (static_cast<int64_t>(1) << a.f_log2) * kFpt;
  const dim3 grid(static_cast<unsigned>((a.D + per_block - 1) / per_block),
                  a.P);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const W*>(a.w), static_cast<const G*>(a.g), a.ss, a.fw,
      a.nw, a.aux, static_cast<W*>(a.out), a.L, a.D, a.sigma, a.per_client,
      a.seeds64, a.f_log2, chunk);
  return cudaGetLastError();
}

// the layouts fold_layout gives: sliced below 256 features; at wide D one
// feature a thread, or 2 or 4 in mask mode
template <typename W, typename G>
cudaError_t dispatch(const Launch& a, int mode, int fpt_log2,
                     cudaStream_t stream) {
  const bool sliced = a.f_log2 < 8;
  if (mode == 0)
    return sliced ? launch<W, G, 0, 1, true>(a, stream)
                  : launch<W, G, 0, 1, false>(a, stream);
  if (mode == 1)
    return sliced ? launch<W, G, 1, 1, true>(a, stream)
                  : launch<W, G, 1, 1, false>(a, stream);
  if (sliced) return launch<W, G, 2, 1, true>(a, stream);
  if (fpt_log2 == 2) return launch<W, G, 2, 4, false>(a, stream);
  if (fpt_log2 == 1) return launch<W, G, 2, 2, false>(a, stream);
  return launch<W, G, 2, 1, false>(a, stream);
}

}  // namespace

// w: [P, D] or [P, L, D] of float/bf16; g, noise: [P, L, D] of float/bf16;
// ss, fw, nw: [P, L] f32; aux: the noise (mode 1) or the seeds [P] int32 or
// int64 (mode 2), else null; out: [P, D] in w's dtype.  `shape` packs P
// (bits 0-15) and L (bits 16-31); `flags` the mode (bits 0-1), w bf16 (2),
// g bf16 (3), per-client w (4), int64 seeds (5), log2 F (6-9) and log2
// features a thread (10-11) of kernels/round_fold.py's fold_layout.
extern "C" int gfl_fold_apply(const void* w, const void* g, const float* ss,
                              const float* fw, const float* nw,
                              const void* aux, void* out, int shape,
                              int flags, int64_t D, float sigma,
                              cudaStream_t stream) {
  const int P = shape & 0xFFFF, L = (shape >> 16) & 0xFFFF;
  const int mode = flags & 3, f_log2 = (flags >> 6) & 15;
  const int fpt_log2 = (flags >> 10) & 3;
  if (P <= 0 || L <= 0 || D <= 0 || D > 0xFFFFFFFFll || mode > 2 ||
      f_log2 > 8 || fpt_log2 > 2 || (fpt_log2 > 0 && (f_log2 != 8 ||
                                                      mode != 2)) ||
      (mode > 0 && aux == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch a{w, g, ss, fw, nw, aux, out, P, L, D, sigma,
                 (flags >> 4) & 1, (flags >> 5) & 1, f_log2};
  const bool w_bf16 = (flags >> 2) & 1, g_bf16 = (flags >> 3) & 1;
  cudaError_t err;
  if (w_bf16 && g_bf16)
    err = dispatch<__nv_bfloat16, __nv_bfloat16>(a, mode, fpt_log2, stream);
  else if (w_bf16)
    err = dispatch<__nv_bfloat16, float>(a, mode, fpt_log2, stream);
  else if (g_bf16)
    err = dispatch<float, __nv_bfloat16>(a, mode, fpt_log2, stream);
  else
    err = dispatch<float, float>(a, mode, fpt_log2, stream);
  return static_cast<int>(err);
}
