// Fused ZOO client fan-out for Hopper (sm_90a): the clean product and every
// perturbed lane of the two-point estimator in ONE launch.
//
// Replaces the three Pallas TPU kernels of
// src/repro/kernels/zoo_dual_matmul/kernel.py:
//   * zoo_dual_matmul_stacked_bias_relu_pallas  (epilogue variant, EPI=true)
//   * zoo_dual_matmul_stacked_pallas            (EPI=false)
//   * zoo_dual_matmul_pallas                    (EPI=false, q = 1, R = 1)
//
// Computes, for every block row r < R (the engine's activated clients) and
// every lane l < q:
//     y[r]        = relu(x[r] W[r] + b[r])                       (EPI)
//     y_hat[r, l] = relu(x[r] W[r] + mu x[r] U[r, l] + b[r] + mu ub[r, l])
// and without the epilogue y = xW, y_hat_l = xW + mu xU_l.
// x (R, M, K), W (R, K, N), U (R, q, K, N) in f32 or bf16; b (R, N) and
// ub (R, q, N) in f32; outputs in x's dtype. All arithmetic is f32 FMA on
// the CUDA cores: no TF32, no tensor cores, so the f32 result holds the
// plain PyTorch version to 1e-4.
//
// What bounds it on the H100. At the main path's shapes (R = 1, M = 64,
// K = 196, N = 128, q = 1, f32) the function is 2*M*K*N*(1+q) = 6.4 MFLOP
// and moves about 317 KB (x, W, U, b, ub read once; y, y_hat written once):
// about 0.1 us against 67 TFLOP/s f32 and 3.35 TB/s. Neither the arithmetic
// nor the bytes bound it; the launch does (microseconds on the host).
//
// What the design does about that. The whole client block and all q lanes
// are one launch, where the JAX engine ran one kernel per client under vmap
// and the unfused path runs two products plus a separate epilogue. Each
// thread block owns one BM x BN output tile of one block row: it forms the
// xW tile once, keeps it in registers, and reuses it for every lane l, so
// the bias+ReLU epilogue runs on values that never leave the SM. Every
// thread block is independent (no sequential grid axis as on the TPU); the
// K loop runs inside the block over shared-memory tiles, and ragged edges
// (K = 196 at paper width) are masked with zero fill. Making it fast at
// large shapes (wgmma, TMA, a lane-parallel grid) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 32;          // output rows per thread block
constexpr int BN = 32;          // output columns per thread block
constexpr int BK = 32;          // reduction depth per shared-memory tile
constexpr int TX = 16;          // threads along N
constexpr int TY = 16;          // threads along M
constexpr int THREADS = TX * TY;
// each thread owns a 2 x 2 micro-tile: rows ty, ty + 16; columns tx, tx + 16

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

// acc[i][j] += sum_k a[m0 + ty + 16 i, k] * bmat[k, n0 + tx + 16 j] over the
// full K, through shared-memory tiles; out-of-range rows, columns and depth
// read as zero. a is (M, K) and bmat (K, N), both row-major.
template <typename T>
__device__ __forceinline__ void tile_product(
    const T* __restrict__ a, const T* __restrict__ bmat, int M, int K, int N,
    int m0, int n0, float (*as)[BK + 1], float (*bs)[BN], float (&acc)[2][2]) {
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      as[r][c] = (gm < M && gk < K) ? to_f32(a[(size_t)gm * K + gk]) : 0.f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = n0 + c;
      bs[r][c] = (gk < K && gn < N) ? to_f32(bmat[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      const float a0 = as[ty][k], a1 = as[ty + TY][k];
      const float b0 = bs[k][tx], b1 = bs[k][tx + TX];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }
}

template <typename T, bool EPI>
__global__ void __launch_bounds__(THREADS) zoo_dual_matmul_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ us,
    const float* __restrict__ b, const float* __restrict__ ub, float mu,
    T* __restrict__ y, T* __restrict__ y_hat, int M, int K, int N, int q) {
  __shared__ float as[BM][BK + 1];   // +1: rows ty and ty + 1 on other banks
  __shared__ float bs[BK][BN];
  const int r = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const T* xr = x + (size_t)r * M * K;

  // the raw xW tile: formed once, kept in registers for every lane below
  float accw[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  tile_product(xr, w + (size_t)r * K * N, M, K, N, m0, n0, as, bs, accw);

  float bias[2] = {0.f, 0.f};
  if (EPI) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + tx + j * TX;
      if (n < N) bias[j] = b[(size_t)r * N + n];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + ty + i * TY;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + tx + j * TX;
      if (m < M && n < N) {
        float v = accw[i][j];
        if (EPI) v = fmaxf(v + bias[j], 0.f);
        y[((size_t)r * M + m) * N + n] = from_f32<T>(v);
      }
    }
  }

  for (int l = 0; l < q; ++l) {
    const size_t rl = (size_t)r * q + l;
    float accu[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    tile_product(xr, us + rl * K * N, M, K, N, m0, n0, as, bs, accu);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + ty + i * TY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = n0 + tx + j * TX;
        if (m < M && n < N) {
          float v = accw[i][j] + mu * accu[i][j];
          if (EPI) v = fmaxf(v + (bias[j] + mu * ub[rl * N + n]), 0.f);
          y_hat[(rl * M + m) * N + n] = from_f32<T>(v);
        }
      }
    }
  }
}

template <typename T, bool EPI>
void launch(const void* x, const void* w, const void* us, const void* b,
            const void* ub, float mu, void* y, void* y_hat, int R, int M,
            int K, int N, int q, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, R);
  zoo_dual_matmul_kernel<T, EPI><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(us), static_cast<const float*>(b),
      static_cast<const float*>(ub), mu, static_cast<T*>(y),
      static_cast<T*>(y_hat), M, K, N, q);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. epilogue: 0 = none, 1 = bias + ReLU
// (b and ub must then be non-null). Launches on `stream` and returns
// cudaGetLastError() (0 on success); it neither allocates nor synchronises.
extern "C" int zoo_dual_matmul_launch(int dtype, int epilogue, const void* x,
                                      const void* w, const void* us,
                                      const void* b, const void* ub, float mu,
                                      void* y, void* y_hat, int R, int M,
                                      int K, int N, int q, void* stream) {
  if (R < 1 || M < 1 || K < 1 || N < 1 || q < 1 || R > 65535 ||
      (M + BM - 1) / BM > 65535 || (dtype != 0 && dtype != 1) ||
      (epilogue && (b == nullptr || ub == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (epilogue) {
      launch<float, true>(x, w, us, b, ub, mu, y, y_hat, R, M, K, N, q, s);
    } else {
      launch<float, false>(x, w, us, b, ub, mu, y, y_hat, R, M, K, N, q, s);
    }
  } else {
    if (epilogue) {
      launch<__nv_bfloat16, true>(x, w, us, b, ub, mu, y, y_hat, R, M, K, N,
                                  q, s);
    } else {
      launch<__nv_bfloat16, false>(x, w, us, b, ub, mu, y, y_hat, R, M, K, N,
                                   q, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
