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
// writes y once: 4 operations an element against 4 bytes of x and y in
// bf16, so device memory bounds it. At the serve paths' first prefill
// chunk (M = 4608, d = 3072, bf16) that is 57 MB, 16.91 us at 3.35 TB/s.
// At decode (M = 8) the bytes take 0.03 us, and one HBM round trip and the
// launch bound it.
//
// Design: the vector kernel, one pass over device memory. A row is split
// into 16-byte vectors (8 bf16 or 4 f32) over `threads` threads; each
// thread issues all `K` of its loads before it uses any, keeps them in
// registers through the reduction (warp shuffles, then one shared-memory
// step, in f32), then scales them and stores 16-byte vectors: x is read
// once. Threads per row and K are chosen by the wrapper from d and M,
// with up to 8 vectors a thread (d <= 8192, the row in registers). With
// rows enough to share the SMs (prefill), device memory bounds the call:
// each thread takes the most vectors that leave no thread idle with at
// least 128 threads a row (d = 3072 bf16: 128 threads x 3 vectors; d =
// 2560: 160 x 2), and ten to twelve blocks are resident an SM
// (chip_smoke.py logs the occupancy query): room for up to 60 KB of
// loads issued at once an SM, if every resident thread has all its loads
// out (a capacity, not a reading). With fewer rows than
// SMs (decode, M = 8), one row's latency bounds it: each thread takes one
// vector (384 and 320 threads), so a row's loads leave in one wave. A row
// of at least 128 threads is a block, so the decode step's 8 rows take 8
// SMs; narrower rows share a block. scale is read as float4 through the
// read-only path; its 12 KB stays in L1 and L2 across rows.
//
// Cache hints. x is loaded with ld.global.cs (evict first): x is read
// once here, and under chip_smoke.py's L2-cold timer the hint cut the
// bf16 prefill rows by 3-11% (4608 x 3072: 20.98 -> 19.16 us; 4608 x
// 2560: 17.05 -> 15.20 us) and left f32 and M = 8 as they were. y is
// stored with the default policy: streaming its stores too read 1-3%
// faster in that timer in most runs, but the next op reads y at once,
// and an evict-first y would leave the L2 before it does, a cost the
// isolated timer cannot see. Both choices are fixed here; the variants
// they were read against are not built.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W; CUDA graphs
// over L2-cold inputs): bf16 4608 x 3072 19.16 us (88% of its 16.91 us
// bound; F.rms_norm 24.70 us), 3584 x 3072 14.50 us, 4608 x 2560
// 15.20 us, 3584 x 2560 12.31 us; M = 8: 2.44 us at d = 3072 and 2.40 us
// at 2560 (F.rms_norm 5.47 and 4.84 us), against an empty kernel's
// 1.00 and 0.80 us on the same launch shapes.
//
// The general kernel takes what the vector one cannot: d not a multiple of
// 16 bytes, x, y or scale not 16-byte aligned, or d > 8192. It is the
// first port's kernel: one 256-thread block per row, strided scalar loads,
// and a second pass that reads the row again (from L1/L2) to scale it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int GENERAL_THREADS = 256;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_VECS = 8;      // 16-byte vectors a thread keeps

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(GENERAL_THREADS) rmsnorm_general_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    T* __restrict__ y, int d, float eps) {
  __shared__ float partial[GENERAL_THREADS / 32];
  __shared__ float inv_rms;
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;

  float ss = 0.f;
  for (int c = threadIdx.x; c < d; c += GENERAL_THREADS) {
    const float v = to_f32(xr[c]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < GENERAL_THREADS / 32 ? partial[threadIdx.x] : 0.f;
    t = warp_sum(t);
    if (threadIdx.x == 0) inv_rms = 1.f / sqrtf(t / (float)d + eps);
  }
  __syncthreads();
  const float r = inv_rms;
  for (int c = threadIdx.x; c < d; c += GENERAL_THREADS)
    yr[c] = from_f32<T>(to_f32(xr[c]) * r * scale[c]);
}

// 16 bytes of x as f32 values, and back.
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// A block of blockDim.y rows, blockDim.x threads (a multiple of 32) a row;
// each thread holds the row's vectors c = threadIdx.x + k * blockDim.x.
template <typename T, int K>
__global__ void __launch_bounds__(MAX_THREADS) rmsnorm_vec_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    T* __restrict__ y, int M, int d, float eps) {
  constexpr int E = 16 / sizeof(T);          // elements in a vector
  __shared__ float partial[MAX_THREADS / 32];
  const int nvec = d / E;
  const int tx = threadIdx.x;
  const int nt = blockDim.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * blockDim.y +
                     threadIdx.y;
  const bool live = row < static_cast<size_t>(M);
  const uint4* xr = reinterpret_cast<const uint4*>(x) + row * nvec;

  uint4 v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = tx + k * nt;
    v[k] = (live && c < nvec) ? __ldcs(xr + c)
                              : make_uint4(0u, 0u, 0u, 0u);
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float f[E];
    unpack(v[k], f);
#pragma unroll
    for (int i = 0; i < E; ++i) ss = fmaf(f[i], f[i], ss);
  }
  ss = warp_sum(ss);
  const int warp = (threadIdx.y * nt + tx) / 32;
  if (tx % 32 == 0) partial[warp] = ss;
  __syncthreads();
  // every thread of the row sums its row's warps in the same order
  const int wpr = nt / 32;
  const float* part = partial + threadIdx.y * wpr;
  float t = 0.f;
  for (int i = 0; i < wpr; ++i) t += part[i];
  const float r = 1.f / sqrtf(t / (float)d + eps);
  if (!live) return;

  uint4* yr = reinterpret_cast<uint4*>(y) + row * nvec;
  const float4* sc = reinterpret_cast<const float4*>(scale);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = tx + k * nt;
    if (c < nvec) {
      float f[E];
      unpack(v[k], f);
#pragma unroll
      for (int j = 0; j < E / 4; ++j) {
        const float4 s = __ldg(sc + c * (E / 4) + j);
        f[4 * j] = (f[4 * j] * r) * s.x;
        f[4 * j + 1] = (f[4 * j + 1] * r) * s.y;
        f[4 * j + 2] = (f[4 * j + 2] * r) * s.z;
        f[4 * j + 3] = (f[4 * j + 3] * r) * s.w;
      }
      yr[c] = pack(f);
    }
  }
}

__global__ void rmsnorm_empty_kernel() {}

template <typename T>
const void* vec_kernel(int vecs) {
  switch (vecs) {
    case 1:
      return reinterpret_cast<const void*>(rmsnorm_vec_kernel<T, 1>);
    case 2:
      return reinterpret_cast<const void*>(rmsnorm_vec_kernel<T, 2>);
    case 3:
      return reinterpret_cast<const void*>(rmsnorm_vec_kernel<T, 3>);
    case 4:
      return reinterpret_cast<const void*>(rmsnorm_vec_kernel<T, 4>);
    case 5:
      return reinterpret_cast<const void*>(rmsnorm_vec_kernel<T, 5>);
    case 6:
      return reinterpret_cast<const void*>(rmsnorm_vec_kernel<T, 6>);
    case 7:
      return reinterpret_cast<const void*>(rmsnorm_vec_kernel<T, 7>);
    case 8:
      return reinterpret_cast<const void*>(rmsnorm_vec_kernel<T, 8>);
    default: return nullptr;
  }
}

// The vector kernel of (dtype, vecs) if the launch shape is one it takes,
// else nullptr.
const void* pick(int dtype, int d, int threads, int vecs, int rows) {
  const int elems = dtype == 0 ? 4 : 8;
  if (threads < 32 || threads % 32 != 0 || rows < 1 ||
      threads * rows > MAX_THREADS || vecs < 1 || vecs > MAX_VECS ||
      d % elems != 0 || static_cast<long>(threads) * vecs * elems < d) {
    return nullptr;
  }
  if (dtype == 0) return vec_kernel<float>(vecs);
  if (dtype == 1) return vec_kernel<__nv_bfloat16>(vecs);
  return nullptr;
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. route: 0 the general kernel (threads,
// vecs and rows unused); 1 the vector kernel with `threads` threads and
// `vecs` 16-byte vectors a row's thread and `rows` rows a block, which
// needs 16-byte-aligned x, y and scale. Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a call
// the route does not take; it neither allocates nor synchronises.
extern "C" int rmsnorm_launch(int dtype, int route, const void* x,
                              const void* scale, void* y, int M, int d,
                              float eps, int threads, int vecs, int rows,
                              void* stream) {
  if (M < 1 || d < 1 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    if (dtype == 0) {
      rmsnorm_general_kernel<float><<<M, GENERAL_THREADS, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(scale),
          static_cast<float*>(y), d, eps);
    } else {
      rmsnorm_general_kernel<__nv_bfloat16><<<M, GENERAL_THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y),
          d, eps);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (route != 1) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = pick(dtype, d, threads, vecs, rows);
  if (fn == nullptr || !aligned16(x) || !aligned16(y) || !aligned16(scale)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* args[] = {&x, &scale, &y, &M, &d, &eps};
  const dim3 grid((M + rows - 1) / rows), block(threads, rows);
  cudaError_t err = cudaLaunchKernel(fn, grid, block, args, 0, s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// Resident blocks an SM of the vector kernel at a launch shape, into
// *blocks; returns the CUDA error (cudaErrorInvalidValue for a shape the
// kernel does not take).
extern "C" int rmsnorm_occupancy(int dtype, int d, int threads, int vecs,
                                 int rows, int* blocks) {
  const void* fn = pick(dtype, d, threads, vecs, rows);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, threads * rows, 0));
}

// The empty kernel on `blocks` blocks of `threads` threads: graph-timed at
// a launch shape, it is the launch floor that a decode-sized call (M = 8)
// is read against. Returns cudaGetLastError().
extern "C" int rmsnorm_empty_launch(int blocks, int threads, void* stream) {
  rmsnorm_empty_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
