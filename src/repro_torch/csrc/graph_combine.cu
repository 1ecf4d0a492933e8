// K3 graph_combine: fused graph-homomorphic server combination (eq. 8 + 24).
//
// Replaces the Pallas kernel src/repro/kernels/graph_combine.py:
// graph_combine (_combine_kernel).  Per feature d:
//
//   psi_eff[m] = gate[m] * psi[m] + (1 - gate[m]) * cache[m]   (gated)
//   out[p]     = sum_m a_t[p, m] * (psi_eff[m] + g[m]) - g[p]    (with g)
//   out[p]     = sum_m a_t[p, m] * psi_eff[m]                    (g = None)
//
// with a_t = A^T, read through A [P, P] f32 as the engines store it (so
// nothing is transposed or copied), and psi, g, cache, out [P, D] f32 or
// bf16, mixed in f32 with plain FMAs (no TF32).
//
// Bound on the H100: HBM bytes.  P is at most a few tens, so the P x P mix
// costs 2P operations per byte read, well under the card's ratio; the
// kernel reads psi and g (and cache) once and writes out once.
//
// Design.  The features are cut into units: 16 bytes (4 f32 or 8 bf16)
// when D and every pointer allow it, single elements otherwise (a ragged
// D, a misaligned operand).  A block owns NU consecutive units of every
// row and its P x NU outputs, in three steps with a barrier after each:
//   1. A^T into shared memory, and the block's P x NU units of psi (and g,
//      cache) copied in with 16-byte cp.async, every copy in flight at
//      once and no register held for them (element-wise copies on the
//      other path);
//   2. x = psi_eff + g formed in f32 in shared memory (over psi's own
//      bytes in f32), g kept there in its own type for the final
//      subtraction, so g is read from memory once;
//   3. the P x NU outputs spread over the threads, one unit each
//      (p = i / nu): a fixed-order P-term sum from shared memory, so
//      repeats are bitwise equal.
// At the main path's D = 2 that is one thread per (p, d) rather than a
// P-output serial chain on two threads; at wide D every thread has its
// share of the block's loads in flight together, and a block stays within
// 48 KB of shared memory, so several fit on an SM and keep the memory busy
// while one computes.  The host sizes NU from the unit count and P (at
// most 64, which beat 32 and 128 at (10, 2^22) on an H100) so that small
// D still spreads over several blocks.  The
// reference pads P to 8 and D to the tile for the TPU; this kernel pads
// nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxP = 64;
constexpr int kMaxUnits = 64;              // units of each row a block owns
constexpr size_t kSmem = 48 * 1024;        // a block's shared memory, most

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float from_f32(float x, float) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float x, __nv_bfloat16) {
  return __float2bfloat16(x);
}

// one unit from global into shared memory: a 16-byte cp.async, or a plain
// element copy
template <typename U>
__device__ __forceinline__ void copy_unit(U* dst, const U* src) {
  if constexpr (sizeof(U) == 16) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  } else {
    *dst = *src;
  }
}

struct Args {
  const float* a;       // A [P, P] as stored: a_t[p, m] = a[m * P + p]
  const void* psi;
  const void* g;        // may be null
  const void* cache;    // null iff gate is
  const float* gate;
  void* out;
  int P;
  int64_t units;        // units per row (D / kVec)
  int nu;               // units per block per row
};

// shared memory of one unit of every row: psi (x over it in f32), g, cache,
// and x apart when T is narrower than f32
template <typename T, typename U, bool kGate>
size_t unit_bytes(int P, bool has_g) {
  constexpr int kVec = sizeof(U) / sizeof(T);
  const size_t x = sizeof(T) == sizeof(float) ? 0 : kVec * sizeof(float);
  return static_cast<size_t>(P) *
         (sizeof(U) + (has_g ? sizeof(U) : 0) + (kGate ? sizeof(U) : 0) + x);
}

// U: uint4 (16-byte units) or T (single elements).  kGate: the cached-psi
// re-announce (cache and gate given).
template <typename T, typename U, bool kGate>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const Args a) {
  constexpr int kVec = sizeof(U) / sizeof(T);
  constexpr bool kInPlace = sizeof(T) == sizeof(float);
  const int P = a.P, NU = a.nu, tid = threadIdx.x;
  const int64_t u0 = static_cast<int64_t>(blockIdx.x) * NU;
  const int nu = static_cast<int>(min(static_cast<int64_t>(NU), a.units - u0));
  const int n = P * nu;                   // units of this block, per input
  const U* psi = static_cast<const U*>(a.psi);
  const U* g = static_cast<const U*>(a.g);
  const U* cache = static_cast<const U*>(a.cache);

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_a = reinterpret_cast<float*>(smem);                // [P, P]
  U* s_psi = reinterpret_cast<U*>(s_a + (P * P + 3) / 4 * 4); // [P, NU]
  U* s_g = s_psi + P * NU;                                    // [P, NU]
  U* s_c = s_g + (g != nullptr ? P * NU : 0);                 // [P, NU]
  // [P, NU, kVec]: over psi in f32, else after the cache, 16-byte aligned
  const uintptr_t tail =
      reinterpret_cast<uintptr_t>(s_c + (kGate ? P * NU : 0));
  float* s_x = kInPlace ? reinterpret_cast<float*>(s_psi)
                        : reinterpret_cast<float*>((tail + 15) & ~uintptr_t(15));

  for (int i = tid; i < P * P; i += kThreads) {
    const int p = i / P, m = i - p * P;
    s_a[i] = a.a[m * P + p];
  }
  for (int i = tid; i < n; i += kThreads) {
    const int m = i / nu, j = i - m * nu;
    const int64_t at = m * a.units + u0 + j;
    copy_unit(s_psi + m * NU + j, psi + at);
    if (g != nullptr) copy_unit(s_g + m * NU + j, g + at);
    if constexpr (kGate) copy_unit(s_c + m * NU + j, cache + at);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  for (int i = tid; i < n; i += kThreads) {
    const int m = i / nu, j = i - m * nu;
    const U pu = s_psi[m * NU + j];
    const T* pe = reinterpret_cast<const T*>(&pu);
    float x[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) x[e] = to_f32(pe[e]);
    if constexpr (kGate) {
      const float gm = a.gate[m];
      const U cu = s_c[m * NU + j];
      const T* ce = reinterpret_cast<const T*>(&cu);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        x[e] = gm * x[e] + (1.0f - gm) * to_f32(ce[e]);
    }
    if (g != nullptr) {
      const U gu = s_g[m * NU + j];
      const T* ge = reinterpret_cast<const T*>(&gu);
#pragma unroll
      for (int e = 0; e < kVec; ++e) x[e] += to_f32(ge[e]);
    }
    float* xs = s_x + (m * NU + j) * kVec;
#pragma unroll
    for (int e = 0; e < kVec; ++e) xs[e] = x[e];
  }
  __syncthreads();

  U* out = static_cast<U*>(a.out);
  for (int i = tid; i < n; i += kThreads) {
    const int p = i / nu, j = i - p * nu;
    float acc[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = 0.0f;
    const float* ap = s_a + p * P;
    for (int m = 0; m < P; ++m) {
      const float am = ap[m];
      const float* x = s_x + (m * NU + j) * kVec;
      if constexpr (kVec % 4 == 0) {
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          const float4 x4 = *reinterpret_cast<const float4*>(x + e);
          acc[e] = fmaf(am, x4.x, acc[e]);
          acc[e + 1] = fmaf(am, x4.y, acc[e + 1]);
          acc[e + 2] = fmaf(am, x4.z, acc[e + 2]);
          acc[e + 3] = fmaf(am, x4.w, acc[e + 3]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] = fmaf(am, x[e], acc[e]);
      }
    }
    U o;
    T* oe = reinterpret_cast<T*>(&o);
    if (g != nullptr) {
      const U gu = s_g[p * NU + j];
      const T* ge = reinterpret_cast<const T*>(&gu);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        oe[e] = from_f32(acc[e] - to_f32(ge[e]), T());
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) oe[e] = from_f32(acc[e], T());
    }
    out[p * a.units + u0 + j] = o;
  }
}

template <typename T, typename U, bool kGate>
int launch(Args a, cudaStream_t stream) {
  const int P = a.P;
  const size_t per_unit = unit_bytes<T, U, kGate>(P, a.g != nullptr);
  // A^T, and 16 bytes to align x
  const size_t fixed =
      static_cast<size_t>((P * P + 3) / 4 * 4) * sizeof(float) + 16;
  int64_t nu = std::min<int64_t>(kMaxUnits, (kSmem - fixed) / per_unit);
  // at least 256 blocks before a block takes more than one unit a row
  nu = std::max<int64_t>(1, std::min<int64_t>(nu, (a.units + 255) / 256));
  a.nu = static_cast<int>(nu);
  const size_t smem = fixed + static_cast<size_t>(nu) * per_unit;
  const int64_t blocks = (a.units + nu - 1) / nu;
  combine_kernel<T, U, kGate>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename U>
int launch_variant(const Args& a, cudaStream_t stream) {
  return a.cache != nullptr ? launch<T, U, true>(a, stream)
                            : launch<T, U, false>(a, stream);
}

}  // namespace

// a: A [P, P] f32, contiguous, as stored (the kernel reads its transpose);
// psi, g, cache, out: [P, D] contiguous float/bf16; gate: [P] f32.  g,
// cache and gate may be null (cache and gate together).  meta = P | bf16
// << 8, one argument for two: the caller's ctypes converts every argument
// on every call, which the main path's D = 2 pays in host time.
extern "C" int gfl_graph_combine(const float* a, const void* psi,
                                 const void* g, const void* cache,
                                 const float* gate, void* out, int meta,
                                 int64_t D, cudaStream_t stream) {
  const int P = meta & 0xff, bf16 = (meta >> 8) & 1;
  if (P <= 0 || P > kMaxP || D <= 0 || ((cache == nullptr) != (gate == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = bf16 ? 8 : 4;  // elements in 16 bytes
  const uintptr_t addr = reinterpret_cast<uintptr_t>(psi) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(cache) |
                         reinterpret_cast<uintptr_t>(out);
  const bool vectors = D % vec == 0 && addr % 16 == 0;
  const Args args{a, psi, g, cache, gate, out, P, vectors ? D / vec : D, 0};
  if (bf16)
    return vectors ? launch_variant<__nv_bfloat16, uint4>(args, stream)
                   : launch_variant<__nv_bfloat16, __nv_bfloat16>(args, stream);
  return vectors ? launch_variant<float, uint4>(args, stream)
                 : launch_variant<float, float>(args, stream);
}
