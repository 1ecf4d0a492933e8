// K1 fold_norms: per-(server, client) squared gradient norms.
//
// Replaces the Pallas kernel src/repro/kernels/round_fold.py:fold_norms
// (_norms_kernel): grads [P, L, D] f32/bf16 -> sq [P, L] f32, summed in f32.
//
// Bound on the H100: HBM bytes.  The kernel reads each gradient once
// (P*L*D*itemsize) and writes P*L floats; there is one multiply-add per
// element, far below the card's compute roof.
//
// Design.  One launch at every D, in one of two layouts that the host
// picks from the shape (kernels/round_fold.py: norms_plan):
//
//   rows   (small D): a group of `lanes` threads (a warp or fewer, a power
//          of two) sums one row, several rows a block; each lane walks its
//          strided elements with four independent accumulators, then the
//          group adds by a fixed shuffle tree.  Blocks are sized so the
//          grid spreads over the SMs (tens of blocks at (10, 50, 2), not
//          one a row).
//   split  (wide D): a block of 256 threads sums one of `nsplit` splits
//          of a row with 16-byte loads (float4, or 8 bf16), four in flight
//          a thread into four accumulators.  The row's whole vectors fall
//          into pieces of 256, dealt to the splits in turn, so the blocks
//          of a row that run at once read neighbouring memory (a
//          contiguous slice a split timed slower on an H100); the scalar head
//          before the row's first 16-byte boundary and the tail after its
//          last whole vector go to the first and the last split.  nsplit
//          is chosen so the grid is at most four waves of the 132 SMs at
//          four blocks each.  With nsplit > 1 each block writes its
//          partial, takes an integer ticket (__threadfence + atomicAdd),
//          and the last block of the row adds the nsplit partials in split
//          order, writes the norm and resets the ticket, so repeats and
//          CUDA-graph replays start from zero.
//
// Every sum runs in a fixed order and no float is atomic, so results are
// bitwise equal from run to run.  Ragged and unaligned rows are masked by
// the loop bounds; nothing is padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kLoads = 4;          // loads in flight a thread
constexpr int kBlocksPerSm = 4;    // split layout: resident blocks an SM

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// acc + the squares of the 16 bytes in v, in element order.
__device__ __forceinline__ float sumsq16(const uint4& v, float acc, float) {
  const float* x = reinterpret_cast<const float*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc = fmaf(x[i], x[i], acc);
  return acc;
}
__device__ __forceinline__ float sumsq16(const uint4& v, float acc,
                                         __nv_bfloat16) {
  const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float f = __bfloat162float(x[i]);
    acc = fmaf(f, f, acc);
  }
  return acc;
}

// Fixed-order block sum: warp shuffles, then warp 0 over the warp sums;
// the total lands in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0.0f;
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
norms_rows(const T* __restrict__ g, float* __restrict__ out, int64_t rows,
           int64_t D, int lanes_log2) {
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const int64_t row = static_cast<int64_t>(blockIdx.x) *
                          (blockDim.x >> lanes_log2) +
                      (threadIdx.x >> lanes_log2);
  float acc[kLoads] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (row < rows) {
    const T* src = g + row * D;
    int64_t d = lane;
    for (; d + (kLoads - 1) * lanes < D; d += kLoads * lanes) {
      float x[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) x[u] = to_f32(src[d + u * lanes]);
#pragma unroll
      for (int u = 0; u < kLoads; ++u) acc[u] = fmaf(x[u], x[u], acc[u]);
    }
    for (; d < D; d += lanes) {
      const float x = to_f32(src[d]);
      acc[0] = fmaf(x, x, acc[0]);
    }
  }
  float v = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  // every lane of the warp shuffles; rows past the end carry 0
  for (int off = lanes >> 1; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off, lanes);
  if (lane == 0 && row < rows) out[row] = v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
norms_split(const T* __restrict__ g, float* __restrict__ out,
            float* __restrict__ partial, int* __restrict__ tickets,
            int64_t D, int nsplit) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t row = blockIdx.x / nsplit;
  const int split = static_cast<int>(blockIdx.x - row * nsplit);
  const T* src = g + row * D;
  // the row's elements before its first 16-byte boundary, its whole
  // vectors, and the tail after them
  int64_t head = static_cast<int64_t>(
      ((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) / sizeof(T));
  if (head > D) head = D;
  const int64_t nvec = (D - head) / kVec;
  const int64_t tail = head + nvec * kVec;
  const uint4* body = reinterpret_cast<const uint4*>(src + head);

  // pieces of kThreads vectors, dealt to the splits in turn: the blocks
  // of a row that run together read neighbouring pieces
  const int64_t stride = static_cast<int64_t>(nsplit) * kThreads;
  float acc[kLoads] = {0.0f, 0.0f, 0.0f, 0.0f};
  int64_t v = static_cast<int64_t>(split) * kThreads + threadIdx.x;
  for (; v + (kLoads - 1) * stride < nvec; v += kLoads * stride) {
    uint4 r[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) r[u] = body[v + u * stride];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) acc[u] = sumsq16(r[u], acc[u], T());
  }
  for (; v < nvec; v += stride) acc[0] = sumsq16(body[v], acc[0], T());
  if (split == 0) {
    for (int64_t d = threadIdx.x; d < head; d += kThreads) {
      const float x = to_f32(src[d]);
      acc[1] = fmaf(x, x, acc[1]);
    }
  }
  if (split == nsplit - 1) {
    for (int64_t d = tail + threadIdx.x; d < D; d += kThreads) {
      const float x = to_f32(src[d]);
      acc[2] = fmaf(x, x, acc[2]);
    }
  }
  const float sum = block_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
  if (nsplit == 1) {
    if (threadIdx.x == 0) out[row] = sum;
    return;
  }

  // the last split of this row to finish adds all nsplit in split order
  __shared__ int s_last;
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = sum;
    __threadfence();
    s_last = atomicAdd(tickets + row, 1) == nsplit - 1;
  }
  __syncthreads();
  if (!s_last || threadIdx.x >= 32) return;
  __threadfence();
  const float* mine = partial + row * nsplit;
  float s = 0.0f;
  for (int b = threadIdx.x; b < nsplit; b += 32) s += __ldcg(mine + b);
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  if (threadIdx.x == 0) {
    out[row] = s;
    tickets[row] = 0;
  }
}

template <typename T>
cudaError_t launch(const void* g, float* out, float* ws, int64_t rows,
                   int64_t D, int lanes_log2, int threads_log2, int nsplit,
                   cudaStream_t stream) {
  if (nsplit == 0) {
    const int threads = 1 << threads_log2;
    const int64_t per_block = threads >> lanes_log2;
    norms_rows<T><<<static_cast<unsigned>((rows + per_block - 1) / per_block),
                    threads, 0, stream>>>(static_cast<const T*>(g), out, rows,
                                          D, lanes_log2);
  } else {
    int* tickets =
        nsplit > 1 ? reinterpret_cast<int*>(ws + rows * nsplit) : nullptr;
    norms_split<T><<<static_cast<unsigned>(rows * nsplit), kThreads, 0,
                     stream>>>(static_cast<const T*>(g), out, ws, tickets, D,
                               nsplit);
  }
  return cudaGetLastError();
}

}  // namespace

// g: [rows, D] (rows = P*L) of float or bf16; out: [rows] f32.  `plan`
// packs the layout of kernels/round_fold.py's norms_plan: bit 0 bf16,
// bits 1-3 log2 lanes a row and bits 4-7 log2 threads a block (rows
// layout), bits 8+ nsplit (0: the rows layout).  With nsplit > 1, ws holds
// rows * nsplit floats of partials, then rows int tickets that are zero.
extern "C" int gfl_fold_norms(const void* g, float* out, float* ws,
                              int64_t rows, int64_t D, int plan,
                              cudaStream_t stream) {
  const int bf16 = plan & 1, lanes_log2 = (plan >> 1) & 7;
  const int threads_log2 = (plan >> 4) & 15, nsplit = plan >> 8;
  if (rows <= 0 || D <= 0 || lanes_log2 > 5 || threads_log2 < 5 ||
      threads_log2 > 8 || lanes_log2 > threads_log2 ||
      rows * (nsplit > 0 ? nsplit : 1) > 0x7FFFFFFFll ||
      (nsplit > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      bf16 ? launch<__nv_bfloat16>(g, out, ws, rows, D, lanes_log2,
                                   threads_log2, nsplit, stream)
           : launch<float>(g, out, ws, rows, D, lanes_log2, threads_log2,
                           nsplit, stream));
}
