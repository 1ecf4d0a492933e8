// K5 secure_agg_mean: the single-server masked client mean (eq. 7 + 23),
// with the pairwise masks generated in the kernel.
//
// Replaces the Pallas kernel src/repro/kernels/secure_agg.py
// :secure_agg_mean (_secure_agg_kernel).  Per feature d:
//
//   out[d] = (sum_k upd[k, d] + sum_k mask_k[d]) / L,
//   mask_k = sum_{j<k} -PRG(pair(j,k)) + sum_{j>k} +PRG(pair(k,j)),
//
// with the counter-hash streams of hash.cuh, upd [L, D] f32/bf16 summed in
// f32, the seed a uint32 read from device memory (as the Pallas kernel
// reads seed_ref; the host never reads it), and out cast once to upd's
// dtype.  Each pair's stream enters the sum twice with opposite signs, so
// the masks cancel up to f32 rounding.
//
// Pair ids follow the true L.  The reference's ops.secure_agg_mean pads
// only D, so its pair numbering is the true L's too, and the L-padding
// discrepancy of fold_apply's mask mode (ROADMAP queue 3) does not arise.
//
// Bound on the H100: the INT32 lanes.  The function needs L(L-1)/2
// streams a feature, each a Murmur3 finalizer (three shift-xor pairs and
// two multiplies), the idx ^ key xor, a shift and an int-to-float
// conversion: 11 integer and conversion instructions per stream against 4
// bytes or fewer of HBM traffic per client and feature.  This kernel, as
// the Pallas one, evaluates each pair's stream twice (once in each of its
// two clients' net masks), L(L-1) streams a feature: redundant work,
// which keeps the reference's per-client order of the f32 adds.
//
// Design.  One thread owns one feature: it sums the L updates in order,
// then adds each client's net mask in net_mask_stream's order (client k,
// its peers j ascending), then divides by L, so the result needs no
// cross-thread reduction and is bitwise equal from run to run.  The
// feature-independent half of each pair's hash, hash(pid * 0x9E3779B9 +
// seed), is computed once per block into shared memory; peers j > k have
// contiguous pair ids and peers j < k are walked with a running offset, so
// no pair id is recomputed per feature.  Ragged D is masked by the
// thread's bound; nothing is padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "hash.cuh"

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
secure_agg_mean_kernel(const T* __restrict__ upd,
                       const uint32_t* __restrict__ seed_ref, float scale,
                       T* __restrict__ out, int L, int64_t D) {
  extern __shared__ uint32_t s_key[];
  const int npairs = L * (L - 1) / 2;
  const uint32_t seed = seed_ref[0];
  for (int p = threadIdx.x; p < npairs; p += kThreads)
    s_key[p] = gfl::pair_key(static_cast<uint32_t>(p), seed);
  __syncthreads();

  const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (d >= D) return;
  const uint32_t idx = static_cast<uint32_t>(d);
  float acc = 0.0f;
  for (int k = 0; k < L; ++k) acc += to_f32(upd[static_cast<int64_t>(k) * D + d]);
  for (int k = 0; k < L; ++k) {
    float m = 0.0f;
    int pid = k - 1;                       // pair(0, k)
    for (int j = 0; j < k; ++j) {          // peers j < k: -PRG(pair(j, k))
      m -= gfl::pair_value(s_key[pid], idx, scale);
      pid += L - j - 2;                    // pair(j + 1, k)
    }
    const int base = gfl::pair_id(k, k + 1, L);
    for (int j = k + 1; j < L; ++j)        // peers j > k: +PRG(pair(k, j))
      m += gfl::pair_value(s_key[base + (j - k - 1)], idx, scale);
    acc += m;
  }
  store(&out[d], acc / static_cast<float>(L));
}

template <typename T>
cudaError_t launch(const void* upd, const uint32_t* seed, float scale,
                   void* out, int L, int64_t D, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(L) * (L - 1) / 2 * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        secure_agg_mean_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = static_cast<unsigned>((D + kThreads - 1) / kThreads);
  secure_agg_mean_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(upd), seed, scale, static_cast<T*>(out), L, D);
  return cudaGetLastError();
}

}  // namespace

// upd: [L, D] float (bf16 = 0) or bf16 (bf16 = 1); seed: [1] uint32 on the
// device; out: [D] in upd's dtype.  L <= 256 (the pair keys, L(L-1)/2
// words, sit in shared memory).
extern "C" int gfl_secure_agg_mean(const void* upd, int bf16,
                                   const uint32_t* seed, float scale,
                                   void* out, int L, int64_t D,
                                   cudaStream_t stream) {
  if (L <= 0 || L > 256 || D <= 0 || D > 0xFFFFFFFFll)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(upd, seed, scale, out, L, D, stream)
           : launch<float>(upd, seed, scale, out, L, D, stream);
  return static_cast<int>(err);
}
