// K6 clip_accum: clip each client's gradient to the B-ball and take the
// mean over clients, both passes in one cooperative launch.
//
// Replaces the Pallas kernel src/repro/kernels/clip_accum.py:clip_accum
// (_sumsq_kernel, then _scale_mean_kernel).  For g [L, D] f32/bf16:
//
//   sq_k   = sum_d g[k, d]^2,
//   coef_k = min(1, B / max(sqrt(sq_k), 1e-12)),
//   out[d] = (sum_k coef_k * g[k, d]) / L,
//
// summed in f32 and cast once to g's dtype.
//
// Bound on the H100: HBM bytes.  The function needs g read once and out
// written once (an fma per element in each pass, far below the compute
// roof).  The second pass needs every clip coefficient, and so every
// client's whole norm, before it can start: g is read twice, unless it is
// still on chip when the second pass comes to it.
//
// Design.  One kernel, launched with cudaLaunchCooperativeKernel on a grid
// no larger than the blocks that can be resident together (the wrapper
// reads cudaOccupancyMaxActiveBlocksPerMultiprocessor; a grid that cannot
// be resident is refused, never hung).  The row's elements fall into tiles
// of 256 x 16 bytes (one 16-byte vector a thread); block b owns tiles b,
// b + grid, b + 2 grid, ... of every row (kernels/clip_accum.py: plan).
//
//   phase 1  The block walks its tiles in order, eight rows at a time
//            (eight 16-byte loads in flight a thread), and sums each row's
//            squares.  Its first `resident` tiles of every row are kept in
//            its dynamic shared memory (up to 110 KB a block, two blocks an
//            SM: about 28 MB of g over 132 SMs); each thread keeps the
//            vectors it loaded, so no thread reads another's and the tiles
//            need no barrier of their own.  The eight rows' sums go through
//            a fixed shuffle tree and the warps in order, and the block
//            writes its L partials to the workspace.
//   barrier  A grid-wide barrier: an integer arrival counter and a
//            generation word.  The last block to arrive resets the counter
//            and bumps the generation, which the others wait on, so the
//            workspace is left clean for reruns and CUDA-graph replays.  No
//            float is atomic.
//   coefs    Every block adds each client's grid partials in the same
//            fixed order (a warp a client: lane l adds partials l, l + 32,
//            ... in order, then a shuffle tree), so every block holds
//            bitwise the same coefficients, in shared memory.
//   phase 2  The block forms the client mean of each of its tiles, clients
//            in order, and casts it once.  Resident tiles are read from
//            shared memory; the rest again from HBM, walked in the reverse
//            of phase 1's order, so the tiles read last in phase 1, the
//            ones still in the 50 MB L2, are read first.
//
// Every sum runs in a fixed order, so results are bitwise equal from run to
// run.  Rows that are not 16-byte aligned (D not a multiple of 16 bytes, or
// g off a 16-byte boundary) take element loads into the same vectors;
// ragged D is masked; nothing is padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                // rows a step: loads in flight
constexpr int kBlocksPerSm = 2;         // kernels/clip_accum.py BLOCKS_PER_SM
constexpr int kMaxSmem = 112640;        // kernels/clip_accum.py SMEM_BLOCK
constexpr int kMaxClients = 12288;      // kernels/clip_accum.py MAX_CLIENTS

// the raw bits of one element
template <typename T>
using Raw = std::conditional_t<sizeof(T) == 4, uint32_t, uint16_t>;

template <typename T>
union Vec {
  uint4 u;
  Raw<T> e[16 / sizeof(T)];
};

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

// The 16 bytes of a row at element `col`: one vector load, or element
// loads; zeros past D.
template <typename T, bool kAligned>
__device__ __forceinline__ uint4 load16(const T* __restrict__ row,
                                        int64_t col, int64_t D) {
  constexpr int kVec = 16 / sizeof(T);
  Vec<T> v;
  v.u = make_uint4(0u, 0u, 0u, 0u);
  if (kAligned) {
    if (col < D) v.u = __ldg(reinterpret_cast<const uint4*>(row + col));
  } else {
    const Raw<T>* src = reinterpret_cast<const Raw<T>*>(row);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (col + j < D) v.e[j] = src[col + j];
  }
  return v.u;
}

template <typename T>
__device__ __forceinline__ float sumsq16(const uint4& u, float acc) {
  Vec<T> v;
  v.u = u;
#pragma unroll
  for (int j = 0; j < 16 / static_cast<int>(sizeof(T)); ++j) {
    const float x = to_f32(v.e[j], T());
    acc = fmaf(x, x, acc);
  }
  return acc;
}

template <typename T>
__device__ __forceinline__ void axpy16(const uint4& u, float c, float* acc) {
  Vec<T> v;
  v.u = u;
#pragma unroll
  for (int j = 0; j < 16 / static_cast<int>(sizeof(T)); ++j)
    acc[j] = fmaf(to_f32(v.e[j], T()), c, acc[j]);
}

// Grid-wide barrier on bar[0] (arrivals) and bar[1] (generation); every
// block of a cooperative launch calls it once.  The last block to arrive
// resets the count, so the next launch finds it at zero.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned seen = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == seen) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
clip_accum_kernel(const T* __restrict__ g, T* __restrict__ out,
                  float* __restrict__ partial, unsigned* bar, float bound,
                  int L, int64_t D, int resident) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int64_t kTile = static_cast<int64_t>(kThreads) * kVec;
  extern __shared__ uint4 s_dyn[];
  __shared__ float s_red[kWarps][kRows];
  float* s_coef = reinterpret_cast<float*>(s_dyn);
  uint4* s_res = s_dyn + (L + 3) / 4;    // slot (i, k): [(i L + k) 256 + t]

  const int grid = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int64_t n_tiles = (D + kTile - 1) / kTile;
  const int mine = static_cast<int>((n_tiles - b + grid - 1) / grid);
  const int64_t stride = static_cast<int64_t>(grid) * kTile;
  const int64_t col0 = static_cast<int64_t>(b) * kTile +
                       static_cast<int64_t>(tid) * kVec;

  // phase 1: each row's partial sum of squares over this block's tiles
  for (int k0 = 0; k0 < L; k0 += kRows) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    for (int i = 0; i < mine; ++i) {
      const int64_t col = col0 + i * stride;
      uint4 v[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        v[r] = k0 + r < L
                   ? load16<T, kAligned>(g + static_cast<int64_t>(k0 + r) * D,
                                         col, D)
                   : make_uint4(0u, 0u, 0u, 0u);
      if (i < resident) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (k0 + r < L)
            s_res[(static_cast<int64_t>(i) * L + k0 + r) * kThreads + tid] =
                v[r];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = sumsq16<T>(v[r], acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float s = acc[r];
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) s_red[warp][r] = s;
    }
    __syncthreads();
    if (tid < kRows && k0 + tid < L) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += s_red[w][tid];
      partial[static_cast<int64_t>(k0 + tid) * grid + b] = s;
    }
    __syncthreads();
  }

  grid_barrier(bar);

  // every block: each client's norm from the grid partials, same order
  for (int k = warp; k < L; k += kWarps) {
    const float* p = partial + static_cast<int64_t>(k) * grid;
    float s = 0.0f;
    for (int j = lane; j < grid; j += 32) s += __ldcg(p + j);
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) s_coef[k] = fminf(1.0f, bound / fmaxf(sqrtf(s), 1e-12f));
  }
  __syncthreads();

  // phase 2: the clipped client mean of each tile, tiles in reverse
  const float n_clients = static_cast<float>(L);
  for (int i = mine - 1; i >= 0; --i) {
    const int64_t col = col0 + i * stride;
    float acc[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
    for (int k0 = 0; k0 < L; k0 += kRows) {
      uint4 v[kRows];
      if (i < resident) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (k0 + r < L)
            v[r] = s_res[(static_cast<int64_t>(i) * L + k0 + r) * kThreads +
                         tid];
      } else {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (k0 + r < L)
            v[r] = load16<T, kAligned>(
                g + static_cast<int64_t>(k0 + r) * D, col, D);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (k0 + r < L) axpy16<T>(v[r], s_coef[k0 + r], acc);
    }
    if (col >= D) continue;
    Vec<T> o;
#pragma unroll
    for (int j = 0; j < kVec; ++j) o.e[j] = from_f32(acc[j] / n_clients, T());
    if (kAligned) {
      *reinterpret_cast<uint4*>(out + col) = o.u;
    } else {
      Raw<T>* dst = reinterpret_cast<Raw<T>*>(out);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        if (col + j < D) dst[col + j] = o.e[j];
    }
  }
}

// dynamic shared memory: the L coefficients, then the resident tiles
size_t smem_bytes(int L, int resident) {
  return static_cast<size_t>((L + 3) / 4) * 16 +
         static_cast<size_t>(resident) * L * kThreads * 16;
}

// Raises the instantiation's dynamic shared memory limit to kMaxSmem, once
// a device.
template <typename T, bool kAligned>
cudaError_t allow_smem() {
  static bool raised[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (raised[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      clip_accum_kernel<T, kAligned>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) raised[dev] = true;
  return err;
}

template <typename T, bool kAligned>
int blocks_per_sm(int L, int resident) {
  cudaError_t err = allow_smem<T, kAligned>();
  if (err != cudaSuccess) return -static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, clip_accum_kernel<T, kAligned>, kThreads,
      smem_bytes(L, resident));
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

template <typename T, bool kAligned>
int launch(const void* g, void* out, void* ws, float bound, int L,
           int64_t D, int resident, int grid, cudaStream_t stream) {
  const cudaError_t err = allow_smem<T, kAligned>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* g_ = static_cast<const T*>(g);
  T* out_ = static_cast<T*>(out);
  float* partial = static_cast<float*>(ws);
  unsigned* bar =
      reinterpret_cast<unsigned*>(partial + static_cast<int64_t>(L) * grid);
  void* args[] = {&g_, &out_, &partial, &bar, &bound, &L, &D, &resident};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(clip_accum_kernel<T, kAligned>),
      dim3(static_cast<unsigned>(grid)), dim3(kThreads), args,
      smem_bytes(L, resident), stream));
}

template <typename T>
int blocks_per_sm_both(int L, int resident) {
  const int a = blocks_per_sm<T, true>(L, resident);
  const int b = blocks_per_sm<T, false>(L, resident);
  return a < 0 ? a : b < 0 ? b : a < b ? a : b;
}

}  // namespace

// `plan` packs kernels/clip_accum.py's plan: bit 0 bf16, bits 2-7 the
// resident tiles a block, bits 8+ the grid.  Returns the blocks of that
// plan an SM holds at once (the fewer of the aligned and element-load
// builds), or minus a CUDA error.
extern "C" int gfl_clip_accum_blocks_per_sm(int plan, int L) {
  const int resident = (plan >> 2) & 63;
  if (L <= 0 || L > kMaxClients ||
      smem_bytes(L, resident) > static_cast<size_t>(kMaxSmem))
    return -static_cast<int>(cudaErrorInvalidValue);
  return (plan & 1) ? blocks_per_sm_both<__nv_bfloat16>(L, resident)
                    : blocks_per_sm_both<float>(L, resident);
}

// g: [L, D] float or bf16; out: [D] in g's dtype; ws: L * grid floats of
// partials, then two unsigned ints (the barrier's count and generation)
// that start at zero and are left at a zero count.
extern "C" int gfl_clip_accum(const void* g, void* out, void* ws,
                              float bound, int L, int64_t D, int plan,
                              cudaStream_t stream) {
  const int bf16 = plan & 1, resident = (plan >> 2) & 63, grid = plan >> 8;
  const int esize = bf16 ? 2 : 4;
  const int64_t tile = static_cast<int64_t>(kThreads) * (16 / esize);
  if (L <= 0 || L > kMaxClients || D <= 0 || grid <= 0 || ws == nullptr ||
      grid > (D + tile - 1) / tile ||
      smem_bytes(L, resident) > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = D % (16 / esize) == 0 &&
                       reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (bf16)
    return aligned ? launch<__nv_bfloat16, true>(g, out, ws, bound, L, D,
                                                 resident, grid, stream)
                   : launch<__nv_bfloat16, false>(g, out, ws, bound, L, D,
                                                  resident, grid, stream);
  return aligned ? launch<float, true>(g, out, ws, bound, L, D, resident,
                                       grid, stream)
                 : launch<float, false>(g, out, ws, bound, L, D, resident,
                                        grid, stream);
}
