// K5 secure_agg_mean: the single-server masked client mean (eq. 7 + 23),
// with the pairwise masks generated in the kernel.
//
// Replaces the Pallas kernel src/repro/kernels/secure_agg.py
// :secure_agg_mean (_secure_agg_kernel).  Per feature d:
//
//   acc    = sum_k upd[k, d]                      (clients in order)
//   acc    = (acc + s_p[d]) - s_p[d]              (each pair p in order)
//   out[d] = acc / L,
//
// with s_p the counter-hash stream of pair p (hash.cuh), pair ids in
// row-major (a < b) order over the true L, upd [L, D] f32/bf16 summed in
// f32, the seed a uint32 read from device memory (as the Pallas kernel
// reads seed_ref; the host never reads it), and out cast once to upd's
// dtype.  This is the order of the reference's own `ref` backend,
// secure_agg_mean_ref (src/repro/kernels/ref.py), which the port's plain
// version follows: each pair's stream is hashed once a feature, added and
// taken away, so the masks cancel up to f32 rounding.  The add and the
// subtraction are __fadd_rn / __fsub_rn, so nvcc can neither contract nor
// drop them: the masks are generated and applied.  (The Pallas kernel adds
// every client's net mask instead, which hashes each pair twice.)
//
// Bound on the H100: the INT32 lanes.  The function needs L(L-1)/2 streams
// a feature, against 4 bytes or fewer of HBM traffic per client and
// feature.  A stream is hash(idx ^ key), the Murmur3 finalizer, then a
// shift, an int-to-float conversion and the scaling; the finalizer's first
// shift-xor distributes over idx ^ key (hash.cuh premix), so the keys in
// shared memory are premixed once a block and each thread premixes its
// feature indices once.  What is left a stream: the xor, two multiplies,
// two shift-xor pairs, the >> 8 and the conversion (9 integer and
// conversion instructions), one fma for the value and the add and
// subtraction.
//
// Design.  A thread owns `fpt` neighbouring features (8: two 16-byte loads
// of each f32 row, one of each bf16 row, when the rows are 16-byte
// aligned; fewer, with fewer threads a block, when D is too small to fill
// the card: the plan of kernels/secure_agg.py); eight f32 features a
// thread ran faster than four at (8, 2^22) on an H100.  The 16-byte build
// runs only when D is a multiple of a thread's features, so no thread's
// vectors reach past D: the plan takes four f32 features a thread, one
// vector, when D is not a multiple of eight, and the launcher takes the
// element build for any D that is not a multiple of its features.  The
// feature-independent half of each pair's hash, hash(pid * 0x9E3779B9 +
// seed), premixed, is computed once per block into shared memory; each key
// is then read once, as a warp-uniform broadcast, and serves the thread's
// fpt streams.  No cross-thread reduction, so the result is bitwise equal
// from run to run.  Ragged D is masked by the thread's bound; nothing is
// padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "hash.cuh"

namespace {

constexpr int kMaxClients = 256;   // kernels/secure_agg.py MAX_CLIENTS
constexpr int kMaxThreads = 256;

template <typename T>
using Raw = std::conditional_t<sizeof(T) == 4, uint32_t, uint16_t>;

__device__ __forceinline__ float to_f32(uint32_t bits, float) {
  return __uint_as_float(bits);
}
__device__ __forceinline__ float to_f32(uint16_t bits, __nv_bfloat16) {
  return __bfloat162float(__ushort_as_bfloat16(bits));
}
__device__ __forceinline__ uint32_t from_f32(float v, float) {
  return __float_as_uint(v);
}
__device__ __forceinline__ uint16_t from_f32(float v, __nv_bfloat16) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

// kFpt features a thread; kVector: they are whole 16-byte vectors of each
// row (kFpt * sizeof(T) a multiple of 16, the rows 16-byte aligned and D a
// multiple of kFpt, so that every vector lies below D).
template <typename T, int kFpt, bool kVector>
__global__ void __launch_bounds__(kMaxThreads)
secure_agg_mean_kernel(const T* __restrict__ upd,
                       const uint32_t* __restrict__ seed_ref, float scale,
                       T* __restrict__ out, int L, int64_t D) {
  constexpr int kVecs = (kFpt * sizeof(T) + 15) / 16;
  static_assert(!kVector || kFpt * sizeof(T) % 16 == 0, "whole vectors");
  union Group {
    uint4 u[kVecs];
    Raw<T> e[kFpt];
  };
  extern __shared__ uint32_t s_key[];
  const int npairs = L * (L - 1) / 2;
  const uint32_t seed = seed_ref[0];
  for (int p = threadIdx.x; p < npairs; p += blockDim.x)
    s_key[p] = gfl::premix(gfl::pair_key(static_cast<uint32_t>(p), seed));
  __syncthreads();

  const int64_t d0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kFpt;
  if (d0 >= D) return;
  const Raw<T>* src = reinterpret_cast<const Raw<T>*>(upd);
  float acc[kFpt];
#pragma unroll
  for (int j = 0; j < kFpt; ++j) acc[j] = 0.0f;
  for (int k = 0; k < L; ++k) {
    const int64_t row = static_cast<int64_t>(k) * D + d0;
    Group v;
    if (kVector) {
#pragma unroll
      for (int i = 0; i < kVecs; ++i)
        v.u[i] = __ldg(reinterpret_cast<const uint4*>(src + row) + i);
    } else {
#pragma unroll
      for (int j = 0; j < kFpt; ++j)
        v.e[j] = d0 + j < D ? src[row + j] : Raw<T>(0);
    }
#pragma unroll
    for (int j = 0; j < kFpt; ++j) acc[j] += to_f32(v.e[j], T());
  }
  uint32_t idx[kFpt];                    // premixed feature indices
#pragma unroll
  for (int j = 0; j < kFpt; ++j)
    idx[j] = gfl::premix(static_cast<uint32_t>(d0 + j));
  for (int p = 0; p < npairs; ++p) {
    const uint32_t key = s_key[p];
#pragma unroll
    for (int j = 0; j < kFpt; ++j) {
      const float s =
          gfl::stream_value(gfl::hash_tail(idx[j] ^ key), scale);
      acc[j] = __fsub_rn(__fadd_rn(acc[j], s), s);
    }
  }
  const float n_clients = static_cast<float>(L);
  Group o;
#pragma unroll
  for (int j = 0; j < kFpt; ++j) o.e[j] = from_f32(acc[j] / n_clients, T());
  Raw<T>* dst = reinterpret_cast<Raw<T>*>(out);
  if (kVector) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i)
      reinterpret_cast<uint4*>(dst + d0)[i] = o.u[i];
  } else {
#pragma unroll
    for (int j = 0; j < kFpt; ++j)
      if (d0 + j < D) dst[d0 + j] = o.e[j];
  }
}

template <typename T, int kFpt, bool kVector>
int launch(const void* upd, const uint32_t* seed, float scale, void* out,
           int L, int64_t D, int threads, cudaStream_t stream) {
  auto kernel = secure_agg_mean_kernel<T, kFpt, kVector>;
  const size_t smem = static_cast<size_t>(L) * (L - 1) / 2 * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    // the pair keys of L > 157 clients: raise this instantiation's limit
    // to the most any L <= kMaxClients needs, once a device
    static bool raised[64] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (!raised[dev]) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMaxClients * (kMaxClients - 1) / 2 *
              static_cast<int>(sizeof(uint32_t)));
      if (err != cudaSuccess) return static_cast<int>(err);
      raised[dev] = true;
    }
  }
  const int64_t per_block = static_cast<int64_t>(threads) * kFpt;
  const unsigned blocks = static_cast<unsigned>((D + per_block - 1) / per_block);
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(upd), seed, scale, static_cast<T*>(out), L, D);
  return static_cast<int>(cudaGetLastError());
}

// The build for kFpt features a thread: the 16-byte one when the plan gives
// a whole vector a thread and the rows are aligned.
template <typename T, int kFpt>
int launch_fpt(const void* upd, const uint32_t* seed, float scale, void* out,
               int L, int64_t D, int threads, bool aligned,
               cudaStream_t stream) {
  if constexpr (kFpt * sizeof(T) % 16 == 0) {
    if (aligned)
      return launch<T, kFpt, true>(upd, seed, scale, out, L, D, threads,
                                   stream);
  }
  return launch<T, kFpt, false>(upd, seed, scale, out, L, D, threads, stream);
}

template <typename T>
int launch_type(const void* upd, const uint32_t* seed, float scale,
                void* out, int L, int64_t D, int fpt, int threads,
                bool aligned, cudaStream_t stream) {
  switch (fpt) {
    case 1:
      return launch_fpt<T, 1>(upd, seed, scale, out, L, D, threads, aligned,
                              stream);
    case 2:
      return launch_fpt<T, 2>(upd, seed, scale, out, L, D, threads, aligned,
                              stream);
    case 4:
      return launch_fpt<T, 4>(upd, seed, scale, out, L, D, threads, aligned,
                              stream);
    default:
      return launch_fpt<T, 8>(upd, seed, scale, out, L, D, threads, aligned,
                              stream);
  }
}

}  // namespace

// upd: [L, D] float or bf16; seed: [1] uint32 on the device (an int32, or
// an int64's low word); out: [D] in upd's dtype.  `plan` packs
// kernels/secure_agg.py's plan: bit 0 bf16, bits 2-3 log2 features a
// thread, bits 4-7 log2 threads a block, bits 8+ L (<= 256: the pair keys,
// L(L-1)/2 words, sit in shared memory).
extern "C" int gfl_secure_agg_mean(const void* upd, const uint32_t* seed,
                                   float scale, void* out, int64_t D,
                                   int plan, cudaStream_t stream) {
  const int bf16 = plan & 1, fpt = 1 << ((plan >> 2) & 3);
  const int threads = 1 << ((plan >> 4) & 15), L = plan >> 8;
  if (L <= 0 || L > kMaxClients || D <= 0 || D > 0xFFFFFFFFll ||
      threads < 32 || threads > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = bf16 ? 8 : 4;                  // elements in 16 bytes
  // whole vectors of every row, none past D: D a multiple of the vector
  // and of the thread's features
  const bool aligned = D % (fpt > vec ? fpt : vec) == 0 &&
                       reinterpret_cast<uintptr_t>(upd) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return bf16 ? launch_type<__nv_bfloat16>(upd, seed, scale, out, L, D, fpt,
                                           threads, aligned, stream)
              : launch_type<float>(upd, seed, scale, out, L, D, fpt, threads,
                                   aligned, stream);
}
