// K8 swa_decode: one-token decode attention over a (ring) KV cache.
//
// Replaces the Pallas kernel src/repro/kernels/swa_decode.py:
// swa_decode_attention (_swa_decode_kernel), with the GQA head mapping of
// src/repro/kernels/ops.py:424 done by indexing instead of repeating K/V.
// For every sequence b and query head h = kv * G + g (G = H / KV):
//
//   s[c] = (q[b, h] . k[b, c, kv]) * scale   if c < nvalid, else -1e30
//   out  = sum_c softmax(s)[c] * v[b, c, kv]
//
// with q, out [B, H, Dh] and k, v [B, C, KV, Dh] in f32 or bf16.  k and v
// are one layer's slice of the [L, B, C, KV, Dh] cache, read in place
// through their batch and slot strides.  nvalid is an int32 on the device,
// read by the kernel, so the decode loop never waits on the host.  All
// math is f32; the output is cast once.
//
// Bound on the H100: HBM bytes.  Each cached K/V element feeds 2 G flops,
// far below the card's operations-per-byte ratio, so the least time is
// the K/V bytes of the live slots over 3.35 TB/s.
//
// Design.  One block per (KV head, sequence) serves that head's G query
// heads, so each K/V row is read once for the group.  The block walks the
// live slots, min(nvalid, C), in tiles of TC slots; with nvalid < 1 every
// slot is masked and it walks all C, which gives the plain mean, as the
// Pallas kernel does.  The next tile's loads (16-byte vectors when the
// layout allows, single elements otherwise) are in flight in registers
// while the current tile is scored from shared memory.  A flash-style
// online softmax keeps the running max, denominator and weighted V in f32
// across tiles.  The tail tile is ragged: C = 2047 is odd, where the
// Pallas tile loop falls back to tiles of one slot.  Every sum runs in a
// fixed order and nothing is atomic, so repeats are bitwise equal.
// Split-C flash-decoding, TMA and wgmma are left to a later PR.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroup = kThreads / 32;   // one warp per query head
constexpr int kMaxDh = 256;
constexpr int kMaxAcc = kMaxGroup * kMaxDh / kThreads;  // outputs a thread
constexpr int kMaxTile = 64;               // slots per tile
constexpr int kMaxSmem = 48 * 1024;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// butterfly: lanes i and i^o add the same two values, so every lane ends
// with the same bits, run after run
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* nvalid;
  void* out;
  int H, KV, C, Dh;
  int64_t stride_b, stride_c;  // of k and v, in elements
  float scale;
  int tile;  // TC, slots per tile
  int ld;    // shared-memory row stride, in elements
};

// A unit is what one thread moves per load: a 16-byte vector (U = uint4)
// or a single element (U = T).  A thread stages kStage units per tile.
template <typename T, typename U>
struct Unit {
  static constexpr int kVec = sizeof(U) / sizeof(T);
  static constexpr int kStage = sizeof(U) == 16 ? 8 : 16;
};

template <typename T, typename U>
__global__ void __launch_bounds__(kThreads)
swa_decode_kernel(const Args a) {
  constexpr int kVec = Unit<T, U>::kVec;
  constexpr int kStage = Unit<T, U>::kStage;
  const int kvh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int G = a.H / a.KV, Dh = a.Dh, TC = a.tile, ld = a.ld;
  const int upr = Dh / kVec;   // units per cached row
  const int units = TC * upr;  // units per tensor per tile

  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);                    // [TC, ld]
  T* sV = sK + TC * ld;                                  // [TC, ld]
  float* sQ = reinterpret_cast<float*>(sV + TC * ld);    // [G, Dh]
  float* sS = sQ + G * Dh;                               // [G, kMaxTile]
  float* sM = sS + G * kMaxTile;                         // running max [G]
  float* sL = sM + G;                                    // denominator [G]
  float* sA = sL + G;                                    // rescale [G]

  const T* qp = static_cast<const T*>(a.q) +
                (static_cast<int64_t>(b) * a.H + static_cast<int64_t>(kvh) * G) * Dh;
  for (int i = tid; i < G * Dh; i += kThreads) sQ[i] = to_f32(qp[i]);
  if (tid < G) {
    sM[tid] = kNegInf;
    sL[tid] = 0.0f;
  }

  const int nv = *a.nvalid;
  const int n_live = nv >= 1 ? min(nv, a.C) : a.C;
  const int n_tiles = (n_live + TC - 1) / TC;
  const int64_t head = static_cast<int64_t>(b) * a.stride_b +
                       static_cast<int64_t>(kvh) * Dh;
  const T* kb = static_cast<const T*>(a.k) + head;
  const T* vb = static_cast<const T*>(a.v) + head;

  U stage[kStage];
  auto load = [&](int t) {
    const int c0 = t * TC;
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int u = tid + i * kThreads;
      if (u < 2 * units) {
        const bool is_v = u >= units;
        const int uu = is_v ? u - units : u;
        const int r = uu / upr;
        const int slot = c0 + r;
        if (slot < n_live) {
          const T* row = (is_v ? vb : kb) + static_cast<int64_t>(slot) * a.stride_c;
          stage[i] = reinterpret_cast<const U*>(row)[uu - r * upr];
        }
      }
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int u = tid + i * kThreads;
      if (u < 2 * units) {
        const bool is_v = u >= units;
        const int uu = is_v ? u - units : u;
        const int r = uu / upr;
        reinterpret_cast<U*>((is_v ? sV : sK) + r * ld)[uu - r * upr] = stage[i];
      }
    }
  };

  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.0f;

  load(0);
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();  // the last tile's readers are done
    store_tile();
    __syncthreads();
    if (t + 1 < n_tiles) load(t + 1);  // in flight while this tile computes
    const int c0 = t * TC;
    const int n = min(TC, n_live - c0);

    // scores: one thread per (query head, slot), a fixed-order dot product
    for (int idx = tid; idx < G * n; idx += kThreads) {
      const int g = idx / n, c = idx - g * n;
      const U* kr = reinterpret_cast<const U*>(sK + c * ld);
      const float* qg = sQ + g * Dh;
      float part[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) part[j] = 0.0f;
      for (int u = 0; u < upr; ++u) {
        const U w = kr[u];
        const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          part[j] = fmaf(qg[u * kVec + j], to_f32(e[j]), part[j]);
      }
#pragma unroll
      for (int half = kVec / 2; half > 0; half >>= 1)
#pragma unroll
        for (int j = 0; j < half; ++j) part[j] += part[j + half];
      sS[g * kMaxTile + c] = c0 + c < nv ? part[0] * a.scale : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per query head
    const int warp = tid >> 5, lane = tid & 31;
    if (warp < G) {
      float* s = sS + warp * kMaxTile;
      float mx = kNegInf;
      for (int c = lane; c < n; c += 32) mx = fmaxf(mx, s[c]);
      mx = warp_max(mx);
      const float m_old = sM[warp];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int c = lane; c < n; c += 32) {
        const float p = expf(s[c] - m_new);
        s[c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sA[warp] = alpha;
        sL[warp] = sL[warp] * alpha + sum;
        sM[warp] = m_new;
      }
    }
    __syncthreads();

    // weighted V: one thread per (query head, feature)
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < G * Dh) {
        const int g = idx / Dh, d = idx - g * Dh;
        const float* p = sS + g * kMaxTile;
        const T* vc = sV + d;
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
        int c = 0;
        for (; c + 4 <= n; c += 4) {
          s0 = fmaf(p[c], to_f32(vc[c * ld]), s0);
          s1 = fmaf(p[c + 1], to_f32(vc[(c + 1) * ld]), s1);
          s2 = fmaf(p[c + 2], to_f32(vc[(c + 2) * ld]), s2);
          s3 = fmaf(p[c + 3], to_f32(vc[(c + 3) * ld]), s3);
        }
        for (; c < n; ++c) s0 = fmaf(p[c], to_f32(vc[c * ld]), s0);
        acc[i] = acc[i] * sA[g] + ((s0 + s1) + (s2 + s3));
      }
    }
  }

  T* op = static_cast<T*>(a.out) +
          (static_cast<int64_t>(b) * a.H + static_cast<int64_t>(kvh) * G) * Dh;
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < G * Dh) store(&op[idx], acc[i] / fmaxf(sL[idx / Dh], 1e-30f));
  }
}

template <typename T, typename U>
int launch(Args a, int B, cudaStream_t stream) {
  constexpr int kVec = Unit<T, U>::kVec;
  constexpr int kStage = Unit<T, U>::kStage;
  const int upr = a.Dh / kVec;
  // rows an odd number of 16-byte units apart: a quarter-warp reading one
  // vector from each of 8 consecutive rows hits 8 distinct bank groups
  if (kVec > 1)
    a.ld = upr % 2 == 0 ? a.Dh + kVec : a.Dh;
  else
    a.ld = a.Dh + 1;
  // as many slots as the staged loads hold, at most kMaxTile
  a.tile = std::min({kThreads * kStage / (2 * upr), kMaxTile, a.C});
  if (a.tile < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int G = a.H / a.KV;
  const size_t smem =
      2 * static_cast<size_t>(a.tile) * a.ld * sizeof(T) +
      (static_cast<size_t>(G) * (a.Dh + kMaxTile) + 3 * G) * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(a.KV), static_cast<unsigned>(B));
  swa_decode_kernel<T, U><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: [B, H, Dh]; k, v: [B, C, KV, Dh] with the last two dims dense and
// the given batch / slot strides (elements), float or bf16 (bf16 flag);
// nvalid: one int32 on the device; scale = 1 / sqrt(Dh).
extern "C" int gfl_swa_decode(const void* q, const void* k, const void* v,
                              const int* nvalid, void* out, int bf16, int B,
                              int H, int KV, int C, int Dh, int64_t stride_b,
                              int64_t stride_c, float scale,
                              cudaStream_t stream) {
  if (B <= 0 || B > 65535 || KV <= 0 || H % KV != 0 ||
      H / KV > kMaxGroup || C <= 0 || Dh <= 0 || Dh > kMaxDh)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, nvalid, out, H, KV, C, Dh, stride_b, stride_c, scale,
               0, 0};
  const int vec = bf16 ? 8 : 4;  // elements in 16 bytes
  const bool vectors = Dh % vec == 0 && stride_b % vec == 0 &&
                       stride_c % vec == 0 &&
                       reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(v) % 16 == 0;
  if (bf16)
    return vectors ? launch<__nv_bfloat16, uint4>(a, B, stream)
                   : launch<__nv_bfloat16, __nv_bfloat16>(a, B, stream);
  return vectors ? launch<float, uint4>(a, B, stream)
                 : launch<float, float>(a, B, stream);
}
