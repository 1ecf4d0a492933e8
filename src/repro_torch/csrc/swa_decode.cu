// K8 swa_decode: one-token decode attention over a (ring) KV cache, as
// split-C flash-decoding.
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
// read by the kernel, so the decode loop never waits on the host.  With
// nvalid < 1 every slot is masked and the result is the plain mean over
// all C slots, as the Pallas kernel gives.  All math is f32; the output is
// cast once.
//
// Bound on the H100: HBM bytes.  Each cached K/V element feeds 2 G flops,
// far below the card's operations-per-byte ratio, so the least time is
// the K/V bytes of the live slots over 3.35 TB/s.
//
// Design.  The grid is (KV, B, S): a block serves one KV head of one
// sequence over one of S splits of the slot range, each a fixed,
// tile-aligned range of `chunk` slots, so that the blocks fill the card;
// the host picks the tile and S from the shape and the SM count alone
// (kernels/swa_decode.py: plan), never from nvalid, so a CUDA graph
// captured at one nvalid replays right at another.  A block clips its
// range to the live slots [0, n_live).  Each of its four warps owns a
// quarter of every tile's slots and streams its own K and V rows through
// a private double-buffered ring of 16-byte cp.async copies in shared memory
// (with an L2 128-byte prefetch hint): no block barrier inside the loop,
// so one warp's score and softmax latency hides behind the others' copies
// and math.  A warp keeps its own online-softmax state (running max m,
// denominator l, weighted V) for the G query heads: the lanes of a slot
// split Dh and reduce the dot product by shuffles, and each lane owns a
// slice of Dh in the V sum.  At the end the block merges its warps in warp
// order, then:
//   S = 1: writes the output;
//   S > 1: writes its partials (m, l, acc[Dh] per query head, f32) into
//          the workspace, takes an integer ticket (__threadfence +
//          atomicAdd), and the last block of each (b, kv) combines the
//          S partials in split order, M = max m_s, out = sum acc_s
//          e^(m_s - M) / max(sum l_s e^(m_s - M), 1e-30), and resets the
//          ticket, so repeats and graph replays start from zero.
// A split, or a warp, that saw no live slot carries m = -inf, l = 0 and
// acc = 0; the merges weigh it by exactly 0 and never form -inf - -inf.
// Every sum runs in a fixed order and no float is atomic, so repeats are
// bitwise equal.  The slot groups' butterfly shuffles leave the same bits
// in every lane.  Layouts that do not allow 16-byte copies (Dh, a stride
// or a base not a multiple of 16 bytes) take the same kernel with
// element-wise synchronous copies.  Tensor cores (mma for bf16 with
// G >= 2) and TMA are left to a later PR.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;  // each warp's cp.async ring: double buffered,
                            // which timed best on an H100 against 3, 4
                            // and 6 stages at both of phi3's decode shapes
constexpr int kMaxGroup = 8;
constexpr int kMaxDh = 256;
constexpr int kFeatures = kMaxDh / 32;      // V-sum features a lane owns
constexpr int kMaxSmem = 227 * 1024 - 64;   // opt-in limit less static
constexpr float kMasked = -1e30f;           // a slot >= nvalid (Pallas)
constexpr float kEmpty = -INFINITY;         // m of a state with no slot
constexpr int kIssue = 8;       // 16-byte copies a lane issues a tile, most
constexpr int kIsV = 1 << 20;               // marks a V unit's column
constexpr int kNoRow = 1 << 30;             // a unit past the tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// two consecutive elements (an aligned pair) as floats
__device__ __forceinline__ float2 pair_f32(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_f32(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// weight of a state with running max m in a merge whose max is M: exactly
// 0 for a state that saw no slot (m = -inf), even when M = -inf too
__device__ __forceinline__ float merge_weight(float m, float M) {
  return m == kEmpty ? 0.0f : expf(m - M);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* nvalid;
  void* out;
  float* ws;      // S > 1: [B * KV, S, G * (Dh + 2)] partials
  int* tickets;   // S > 1: [B * KV], zero between launches
  int H, KV, C, Dh, G;
  int64_t stride_b, stride_c;  // of k and v, in elements
  float scale;
  int tile;    // slots per tile, a power of two in [8, 64]
  int ld;      // shared-memory stride of one K or V row, in elements
  int chunk;   // slots per split, a multiple of tile
  int splits;  // S
};

// kG: a compile-time bound on G (1, 2, 4 or 8), so that the per-head state
// lives in registers.  U: uint4 (16-byte units) or T (single elements).
template <typename T, typename U, int kG>
__global__ void __launch_bounds__(kThreads, 4)
swa_decode_kernel(const Args a) {
  constexpr int kVec = sizeof(U) / sizeof(T);
  constexpr bool kVector = sizeof(U) == 16;
  constexpr int kPair = kVector ? 2 : 1;           // features a V read
  constexpr int kReads = kFeatures / kPair;        // V reads a slot, a lane
  const int b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = a.G, Dh = a.Dh, TC = a.tile, ld = a.ld;
  const int upr = Dh / kVec;         // units of a cached row
  const int SPW = TC / kWarps;       // slots a warp a tile
  const int TL = 32 / SPW;           // lanes a slot in the scores
  const unsigned full = 0xffffffffu;

  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);              // [G, Dh]
  T* ring = reinterpret_cast<T*>(sQ + G * Dh);             // [warps, ...]
  // this warp's own ring: [stages, 2 (K, V), SPW slots, ld]
  T* wring = ring + warp * (kStages * 2 * SPW * ld);

  const int64_t bkv = static_cast<int64_t>(b) * a.KV + blockIdx.x;
  const T* qp = static_cast<const T*>(a.q) + bkv * G * Dh;  // h = kv * G + g
  for (int i = tid; i < G * Dh; i += kThreads) sQ[i] = to_f32(qp[i]);

  const int nv = *a.nvalid;
  const int n_live = nv >= 1 ? min(nv, a.C) : a.C;
  const int lo = split * a.chunk;
  const int hi = min(lo + a.chunk, n_live);
  const int n_tiles = hi > lo ? (hi - lo + TC - 1) / TC : 0;
  const int w_lo = warp * SPW;              // this warp's first tile slot
  // this head's rows, from the warp's first slot of a tile on
  const int64_t head = static_cast<int64_t>(b) * a.stride_b +
                       static_cast<int64_t>(blockIdx.x) * Dh +
                       static_cast<int64_t>(w_lo) * a.stride_c;
  const T* kb = static_cast<const T*>(a.k) + head;
  const T* vb = static_cast<const T*>(a.v) + head;

  // 16-byte path: this lane's units of the warp's rows of a full tile, the
  // same in every tile, so the loop issues its copies with no division:
  // the row, and the element column plus kIsV for a V row; kNoRow past
  // the rows
  int urow[kIssue], ucol[kIssue];
  if constexpr (kVector) {
#pragma unroll
    for (int i = 0; i < kIssue; ++i) {
      const int u = lane + i * 32, units = SPW * upr;
      urow[i] = kNoRow;
      if (u < 2 * units) {
        const bool is_v = u >= units;
        const int uu = is_v ? u - units : u;
        urow[i] = uu / upr;
        ucol[i] = (uu - urow[i] * upr) * kVec + (is_v ? kIsV : 0);
      }
    }
  }

  // the live ones of the warp's rows of tile t into its ring stage
  // t % kStages
  auto issue = [&](int t) {
    const int c0 = lo + t * TC;                 // the tile's first slot
    const int n = min(SPW, hi - c0 - w_lo);     // the warp's live rows
    T* sk = wring + (t % kStages) * 2 * SPW * ld;
    if constexpr (kVector) {
#pragma unroll
      for (int i = 0; i < kIssue; ++i) {
        if (urow[i] < n) {
          const bool is_v = ucol[i] >= kIsV;
          const int col = ucol[i] & (kIsV - 1);
          cp_async16(sk + (is_v ? SPW * ld : 0) + urow[i] * ld + col,
                     (is_v ? vb : kb) +
                         static_cast<int64_t>(c0 + urow[i]) * a.stride_c +
                         col);
        }
      }
    } else {
      const int units = max(n, 0) * upr;
      for (int u = lane; u < 2 * units; u += 32) {
        const bool is_v = u >= units;
        const int uu = is_v ? u - units : u;
        const int r = uu / upr, col = uu - r * upr;
        sk[(is_v ? SPW * ld : 0) + r * ld + col] =
            (is_v ? vb : kb)[static_cast<int64_t>(c0 + r) * a.stride_c + col];
      }
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }

  // this warp's online-softmax state, the same bits in every lane
  float m[kG], l[kG], acc[kG][kFeatures];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = kEmpty;
    l[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < kFeatures; ++i) acc[g][i] = 0.0f;
  }
  const int my_slot = lane / TL;            // the warp row this lane scores
  const int part = lane % TL;               // its share of the row's units
  const bool masked = nv < 1;
  __syncthreads();                          // q is in shared memory

  // each warp streams its own rows: no block barrier inside the loop
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncwarp();  // tile t landed for every lane; all are done with t - 1
    if (t + kStages - 1 < n_tiles) issue(t + kStages - 1);
    cp_async_commit();
    const int n = min(SPW, hi - (lo + t * TC) - w_lo);
    if (n <= 0) continue;                   // no live slot for this warp
    const T* sk = wring + (t % kStages) * 2 * SPW * ld;
    const T* sv = sk + SPW * ld;
#ifdef SWA_PROBE_LOADS_ONLY
    continue;  // timing probe: the copies alone, the output is meaningless
#endif

    // scores: the TL lanes of a slot split its row, then a butterfly; two
    // partial sums a head shorten the dependent chain
    float s[kG], s2[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) s[g] = s2[g] = 0.0f;
    const U* kr = reinterpret_cast<const U*>(sk + my_slot * ld);
#pragma unroll 4
    for (int u = part; u < upr; u += TL) {
      const U w = kr[u];
      const T* e = reinterpret_cast<const T*>(&w);
      float kf[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) kf[j] = to_f32(e[j]);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (g < G) {
          const float* qg = sQ + g * Dh + u * kVec;
          if constexpr (kVec % 4 == 0) {
#pragma unroll
            for (int j = 0; j < kVec; j += 4) {
              const float4 q4 = *reinterpret_cast<const float4*>(qg + j);
              s[g] = fmaf(q4.x, kf[j], s[g]);
              s2[g] = fmaf(q4.y, kf[j + 1], s2[g]);
              s[g] = fmaf(q4.z, kf[j + 2], s[g]);
              s2[g] = fmaf(q4.w, kf[j + 3], s2[g]);
            }
          } else {
#pragma unroll
            for (int j = 0; j < kVec; ++j) s[g] = fmaf(qg[j], kf[j], s[g]);
          }
        }
      }
    }
    const bool live = my_slot < n;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g < G) {
        s[g] += s2[g];
        for (int o = TL / 2; o > 0; o >>= 1)
          s[g] += __shfl_xor_sync(full, s[g], o);
        s[g] = !live ? kEmpty : (masked ? kMasked : s[g] * a.scale);
        // the warp has a live slot, so m_new is finite and no exp below
        // sees -inf - -inf
        float mx = s[g];
        for (int o = TL; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(full, mx, o));
        const float m_new = fmaxf(m[g], mx);
        const float alpha = expf(m[g] - m_new);
        s[g] = expf(s[g] - m_new);          // p; 0 for a dead slot
        float ps = s[g];
        for (int o = TL; o < 32; o <<= 1) ps += __shfl_xor_sync(full, ps, o);
        l[g] = l[g] * alpha + ps;
        m[g] = m_new;
#pragma unroll
        for (int i = 0; i < kFeatures; ++i) acc[g][i] *= alpha;
      }
    }

    // weighted V: every lane owns features (lane + 32 r) * kPair + [0, kPair)
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const T* vr = sv + j * ld;
      float p[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) p[g] = __shfl_sync(full, s[g], j * TL);
#pragma unroll
      for (int r = 0; r < kReads; ++r) {
        const int d = (r * 32 + lane) * kPair;
        if (d < Dh) {
          float2 x;
          if constexpr (kPair == 2)
            x = pair_f32(vr + d);
          else
            x = make_float2(to_f32(vr[d]), 0.0f);
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            if (g < G) {
              acc[g][r * kPair] = fmaf(p[g], x.x, acc[g][r * kPair]);
              if constexpr (kPair == 2)
                acc[g][r * kPair + 1] = fmaf(p[g], x.y, acc[g][r * kPair + 1]);
            }
          }
        }
      }
    }
  }

  // merge the warps in warp order (the ring is free after the barrier)
  __syncthreads();
  float* sWm = reinterpret_cast<float*>(ring);    // [kWarps, G]
  float* sWl = sWm + kWarps * G;                  // [kWarps, G]
  float* sWa = sWl + kWarps * G;                  // [kWarps, G, Dh]
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (g < G) {
      if (lane == 0) {
        sWm[warp * G + g] = m[g];
        sWl[warp * G + g] = l[g];
      }
#pragma unroll
      for (int r = 0; r < kReads; ++r) {
        const int d = (r * 32 + lane) * kPair;
        if (d < Dh) {
          sWa[(warp * G + g) * Dh + d] = acc[g][r * kPair];
          if constexpr (kPair == 2)
            sWa[(warp * G + g) * Dh + d + 1] = acc[g][r * kPair + 1];
        }
      }
    }
  }
  __syncthreads();

  // each query head: the warps merged in warp order, then the output
  // (S = 1) or this split's partial
  T* op = static_cast<T*>(a.out) + bkv * G * Dh;
  const int S = a.splits;
  const int stride = G * (Dh + 2);              // floats of one partial
  float* part_base = S == 1 ? nullptr : a.ws + bkv * S * stride;
  for (int idx = tid; idx < G * Dh; idx += kThreads) {
    const int g = idx / Dh;
    float M = kEmpty;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sWm[w * G + g]);
    float ls = 0.0f, as = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = merge_weight(sWm[w * G + g], M);
      ls += sWl[w * G + g] * e;
      as += sWa[w * G * Dh + idx] * e;
    }
    if (S == 1) {
      store(op + idx, as / fmaxf(ls, 1e-30f));
    } else {
      float* mine = part_base + split * stride;
      mine[idx] = as;
      if (idx - g * Dh == 0) {
        mine[G * Dh + g] = M;
        mine[G * Dh + G + g] = ls;
      }
    }
  }
  if (S == 1) return;

  // the last split of this (b, kv) to finish combines all S in split order
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(a.tickets + bkv, 1) == S - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // every split's m and l into shared memory at once, each head's max M,
  // then m turned into the split's weight e^(m - M): the S-term sums below
  // read nothing from memory but their acc terms
  float* sw = reinterpret_cast<float*>(ring);    // [S, G]: m, then weight
  float* sl = sw + S * G;                        // [S, G]
  float* sM = sl + S * G;                        // [G]
  for (int i = tid; i < S * G; i += kThreads) {
    const float* p = part_base + (i / G) * stride + G * Dh + i % G;
    sw[i] = __ldcg(p);
    sl[i] = __ldcg(p + G);
  }
  __syncthreads();
  if (tid < G) {
    float M = kEmpty;
    for (int sp = 0; sp < S; ++sp) M = fmaxf(M, sw[sp * G + tid]);
    sM[tid] = M;
  }
  __syncthreads();
  for (int i = tid; i < S * G; i += kThreads)
    sw[i] = merge_weight(sw[i], sM[i % G]);
  __syncthreads();
  for (int idx = tid; idx < G * Dh; idx += kThreads) {
    const int g = idx / Dh;
    float ls = 0.0f, as = 0.0f;
#pragma unroll 8
    for (int sp = 0; sp < S; ++sp) {
      const float e = sw[sp * G + g];
      ls += sl[sp * G + g] * e;
      as += __ldcg(part_base + sp * stride + idx) * e;
    }
    store(op + idx, as / fmaxf(ls, 1e-30f));
  }
  if (tid == 0) a.tickets[bkv] = 0;
}

template <typename T, typename U, int kG>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t ring =
      static_cast<size_t>(kStages) * 2 * a.tile * a.ld * sizeof(T);
  const size_t merge =
      static_cast<size_t>(kWarps) * a.G * (a.Dh + 2) * sizeof(float);
  const size_t combine =
      (2 * static_cast<size_t>(a.splits) + 1) * a.G * sizeof(float);
  const size_t smem =
      static_cast<size_t>(a.G) * a.Dh * sizeof(float) +
      std::max({ring, merge, combine});
  // the 16-byte path issues at most kIssue copies a lane a tile
  if (sizeof(U) == 16 &&
      2 * a.tile * (a.Dh / static_cast<int>(sizeof(U) / sizeof(T))) >
          kIssue * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = swa_decode_kernel<T, U, kG>;
  if (smem > 48 * 1024) {
    // the opt-in limit less the kernel's static shared memory is the most
    // a launch may ask for: raise this instantiation's limit to what this
    // launch needs, once a device and size
    static size_t raised[64] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (raised[dev] < smem) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      raised[dev] = smem;
    }
  }
  const dim3 grid(static_cast<unsigned>(a.KV), static_cast<unsigned>(B),
                  static_cast<unsigned>(a.splits));
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename U>
int launch_group(const Args& a, int B, cudaStream_t stream) {
  if (a.G <= 1) return launch<T, U, 1>(a, B, stream);
  if (a.G <= 2) return launch<T, U, 2>(a, B, stream);
  if (a.G <= 4) return launch<T, U, 4>(a, B, stream);
  return launch<T, U, 8>(a, B, stream);
}

}  // namespace

// q, out: [B, H, Dh]; k, v: [B, C, KV, Dh] with the last two dims dense and
// the given batch / slot strides (elements), float or bf16 (bf16 flag);
// nvalid: one int32 on the device; scale = 1 / sqrt(Dh).  tile, ld and
// splits come from kernels/swa_decode.py (its plan); with splits > 1,
// ws holds B * KV * splits * G * (Dh + 2) floats and tickets B * KV ints
// that are zero.
extern "C" int gfl_swa_decode(const void* q, const void* k, const void* v,
                              const int* nvalid, void* out, float* ws,
                              int* tickets, int bf16, int B, int H, int KV,
                              int C, int Dh, int64_t stride_b,
                              int64_t stride_c, float scale, int tile,
                              int ld, int splits,
                              cudaStream_t stream) {
  if (B <= 0 || B > 65535 || KV <= 0 || H % KV != 0 ||
      H / KV > kMaxGroup || C <= 0 || Dh <= 0 || Dh > kMaxDh ||
      ld < Dh ||
      (tile != 8 && tile != 16 && tile != 32 && tile != 64) ||
      splits <= 0 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (C + tile - 1) / tile;
  const int chunk = (n_tiles + splits - 1) / splits * tile;
  // every split starts inside [0, C) and together they cover it
  if (static_cast<int64_t>(splits - 1) * chunk >= C ||
      (splits > 1 && (ws == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, nvalid, out, ws, tickets, H, KV, C, Dh, H / KV,
               stride_b, stride_c, scale, tile, ld, chunk, splits};
  const int vec = bf16 ? 8 : 4;  // elements in 16 bytes
  const bool vectors = Dh % vec == 0 && ld % vec == 0 &&
                       stride_b % vec == 0 && stride_c % vec == 0 &&
                       reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(v) % 16 == 0;
  if (bf16)
    return vectors ? launch_group<__nv_bfloat16, uint4>(a, B, stream)
                   : launch_group<__nv_bfloat16, __nv_bfloat16>(a, B, stream);
  return vectors ? launch_group<float, uint4>(a, B, stream)
                 : launch_group<float, float>(a, B, stream);
}
