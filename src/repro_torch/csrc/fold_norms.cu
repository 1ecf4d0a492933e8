// K1 fold_norms: per-(server, client) squared gradient norms.
//
// Replaces the Pallas kernel src/repro/kernels/round_fold.py:fold_norms
// (_norms_kernel): grads [P, L, D] f32/bf16 -> sq [P, L] f32, summed in f32.
//
// Bound on the H100: HBM bytes.  The kernel reads each gradient once
// (P*L*D*itemsize) and writes P*L floats; there is one multiply-add per
// element, far below the card's compute roof.
//
// Design.  The Pallas grid walks the D tiles of one row in order and adds
// into one output block; CUDA blocks run in parallel and in no order, and
// fp32 atomics would make the sum change from run to run.  So the sum is
// taken in two fixed-order stages: grid (nsplit, rows), block b of row r
// sums its CHUNK-wide slice of D (per-thread strided loop, then a fixed
// warp-shuffle and shared-memory tree) into partial[r, b]; a second
// launch adds the nsplit partials of each row in index order.  With one
// split the first stage writes the output directly.  Ragged D is masked
// by the loop bound; nothing is padded.  Results are bitwise equal from
// run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Fixed-order block sum: warp shuffles, then warp 0 over the warp sums.
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
norms_partial(const T* __restrict__ g, float* __restrict__ dst, int64_t D,
              int64_t chunk, int nsplit) {
  const int64_t row = blockIdx.y;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t hi = lo + chunk < D ? lo + chunk : D;
  const T* src = g + row * D;
  float acc = 0.0f;
  for (int64_t d = lo + threadIdx.x; d < hi; d += kThreads) {
    const float x = to_f32(src[d]);
    acc = fmaf(x, x, acc);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) dst[row * nsplit + blockIdx.x] = acc;
}

__global__ void norms_finish(const float* __restrict__ partial,
                             float* __restrict__ out, int rows, int nsplit) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const float* p = partial + static_cast<int64_t>(row) * nsplit;
  float acc = 0.0f;
  for (int b = 0; b < nsplit; ++b) acc += p[b];
  out[row] = acc;
}

}  // namespace

// g: [rows, D] (rows = P*L) of float (g_bf16 = 0) or bf16 (g_bf16 = 1);
// out: [rows] f32; partial: [rows, nsplit] f32 scratch, used when
// nsplit > 1, with nsplit = ceil(D / chunk).
extern "C" int gfl_fold_norms(const void* g, int g_bf16, float* out,
                              float* partial, int rows, int64_t D,
                              int64_t chunk, int nsplit,
                              cudaStream_t stream) {
  if (rows <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  float* dst = nsplit > 1 ? partial : out;
  const dim3 grid(nsplit, rows);
  if (g_bf16)
    norms_partial<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(g), dst, D, chunk, nsplit);
  else
    norms_partial<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(g), dst, D, chunk, nsplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  norms_finish<<<(rows + 127) / 128, 128, 0, stream>>>(partial, out, rows,
                                                       nsplit);
  return static_cast<int>(cudaGetLastError());
}
