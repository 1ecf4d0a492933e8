// K7 laplace_transform: uniform u in (-1/2, 1/2) -> Laplace(0, b) samples.
//
// Replaces the Pallas kernel src/repro/kernels/laplace.py:laplace_transform
// (_laplace_kernel): out = -b * sign(u) * log1p(-2|u|), elementwise over
// u [P, D] f32/bf16, computed in f32 and cast once to u's dtype.  b =
// sigma / sqrt(2) is computed by the caller in double and passed as a
// float, as the reference does.
//
// Bound on the H100: HBM bytes (one read of u, one write of out); log1pf
// is some twenty instructions an element, far below the fp32 roof.
//
// Design.  [P, D] is contiguous, so the kernel walks it as one flat array
// of P*D elements, grid-stride: 16-byte loads and stores (4 floats or 8
// bf16) when both pointers are 16-byte aligned, then a scalar tail.  A
// ragged P or D is masked by that tail; nothing is padded (the reference
// pads D to its tile and P to 8).  The expression is evaluated in the
// reference's order, (-b * sign(u)) * log1p(-2 * |u|), with the accurate
// log1pf: no fast-math, since the reference holds this op to atol 1e-6.
// sign(0) = 0, so u = 0 gives 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float lap(float u, float neg_b) {
  const float sgn = u > 0.0f ? 1.0f : (u < 0.0f ? -1.0f : 0.0f);
  return (neg_b * sgn) * log1pf(-2.0f * fabsf(u));
}

__global__ void __launch_bounds__(kThreads)
laplace_f32(const float* __restrict__ u, float* __restrict__ out, int64_t n,
            float neg_b, int vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t nv = n / 4;
    const float4* u4 = reinterpret_cast<const float4*>(u);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int64_t i = t0; i < nv; i += stride) {
      const float4 x = u4[i];
      o4[i] = make_float4(lap(x.x, neg_b), lap(x.y, neg_b), lap(x.z, neg_b),
                          lap(x.w, neg_b));
    }
    done = nv * 4;
  }
  for (int64_t i = done + t0; i < n; i += stride) out[i] = lap(u[i], neg_b);
}

__global__ void __launch_bounds__(kThreads)
laplace_bf16(const __nv_bfloat16* __restrict__ u,
             __nv_bfloat16* __restrict__ out, int64_t n, float neg_b,
             int vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t nv = n / 8;
    const uint4* u8 = reinterpret_cast<const uint4*>(u);
    uint4* o8 = reinterpret_cast<uint4*>(out);
    for (int64_t i = t0; i < nv; i += stride) {
      uint4 x = u8[i];
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&x);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = __float2bfloat16(lap(__bfloat162float(e[j]), neg_b));
      o8[i] = x;
    }
    done = nv * 8;
  }
  for (int64_t i = done + t0; i < n; i += stride)
    out[i] = __float2bfloat16(lap(__bfloat162float(u[i]), neg_b));
}

}  // namespace

// u, out: n = P*D contiguous elements of float (bf16 = 0) or bf16
// (bf16 = 1); b = sigma / sqrt(2).
extern "C" int gfl_laplace_transform(const void* u, void* out, int bf16,
                                     int64_t n, float b,
                                     cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = ((reinterpret_cast<uintptr_t>(u) |
                         reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  const int64_t per_block = static_cast<int64_t>(kThreads) * (bf16 ? 8 : 4);
  int64_t blocks = (n + per_block - 1) / per_block;
  // enough blocks to fill the card several times over; the grid-stride
  // loop covers the rest
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (bf16)
    laplace_bf16<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(u),
        static_cast<__nv_bfloat16*>(out), n, -b, aligned ? 1 : 0);
  else
    laplace_f32<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const float*>(u), static_cast<float*>(out), n, -b,
        aligned ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
