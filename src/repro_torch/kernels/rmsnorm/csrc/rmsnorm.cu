// RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the Pallas TPU kernel rmsnorm_pallas of
// src/repro/kernels/rmsnorm/kernel.py. x (M, d) in f32 or bf16, scale (d,)
// in f32, y (M, d) in x's type; the mean square, the reciprocal root and
// both products are f32, in the order the JAX package writes them
// ((x * r) * scale, r = 1 / sqrt(sum / d + eps), IEEE sqrt and division).
// Any M: the TPU kernel asserts M % bm == 0, and the serve plane's decode
// step has M = 8 rows.
//
// What bounds it on the H100. The function reads x and scale once and
// writes y once: at prefill (M = 4608, d = 3072, bf16) 57 MB, about 17 us
// at 3.35 TB/s; the flops (4 per element) are nothing beside that. At
// decode (M = 8) the bytes take 0.03 us and the launch itself bounds it.
//
// Design. One thread block of 256 threads per row: a strided f32 sum of
// squares, a warp-shuffle then shared-memory reduction, and a second strided
// pass that scales and stores. The second pass re-reads the row the block
// just read (6 KB at d = 3072, bf16), which the L1/L2 still hold, so device
// memory sees x about once. A row per block keeps all 8 decode rows on
// separate SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) rmsnorm_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    T* __restrict__ y, int d, float eps) {
  __shared__ float partial[THREADS / 32];
  __shared__ float inv_rms;
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;

  float ss = 0.f;
  for (int c = threadIdx.x; c < d; c += THREADS) {
    const float v = to_f32(xr[c]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < THREADS / 32 ? partial[threadIdx.x] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      t += __shfl_xor_sync(0xffffffffu, t, off);
    if (threadIdx.x == 0) inv_rms = 1.f / sqrtf(t / (float)d + eps);
  }
  __syncthreads();
  const float r = inv_rms;
  for (int c = threadIdx.x; c < d; c += THREADS)
    yr[c] = from_f32<T>(to_f32(xr[c]) * r * scale[c]);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it neither allocates nor synchronises.
extern "C" int rmsnorm_launch(int dtype, const void* x, const void* scale,
                              void* y, int M, int d, float eps,
                              void* stream) {
  if (M < 1 || d < 1 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    rmsnorm_kernel<float><<<M, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<float*>(y), d, eps);
  } else {
    rmsnorm_kernel<__nv_bfloat16><<<M, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), d,
        eps);
  }
  return static_cast<int>(cudaGetLastError());
}
