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
// and without the epilogue y = xW, y_hat_l = xW + mu xU_l. xW is formed
// once and shared by the lanes; it is not folded into x (W + mu U_l),
// because the estimator divides y_hat - y by mu. x (R, M, K), W (R, K, N),
// U (R, q, K, N) in f32 or bf16; b (R, N) and ub (R, q, N) in f32; outputs
// in x's dtype. All arithmetic is f32 FMA on the CUDA cores: no TF32, no
// tensor cores, so the f32 result holds the plain PyTorch version to 1e-4.
//
// What bounds it on the H100. At the main path's shapes (R = 1, M = 64,
// K = 196, N = 128, q = 1, f32) the function is 2*M*K*N*(1+q) = 6.4 MFLOP
// and moves about 317 KB (x, W, U, b, ub read once; y, y_hat written once):
// about 0.1 us against 67 TFLOP/s f32 and 3.35 TB/s. Neither bounds it:
// latency does, the launch and the serial chain of memory round trips and
// dependent FMAs inside a block.
//
// What the design does about that.
// - Small output tiles, BM x BN = 8 x 16, so the main path spreads over 64
//   blocks (SMs), not 8.
// - A block issues all of its operand panels at once with 16-byte
//   cp.async (x: BM x K; W: K x BN; U_l: K x BN for each lane of the pass;
//   zero fill past K, M and N) and waits once, then runs the whole K loop
//   out of shared memory: one memory round trip instead of one per K
//   tile. Where the panels of all lanes exceed a 96 KB stage (large K or
//   q), K is cut into chunks and the lanes into passes of QB, and the
//   chunks stream through a ring of two stages: chunk i + 2 is in flight
//   while chunk i + 1 waits and chunk i computes.
// - Eight warps split the K loop (so shared-memory latency hides behind
//   other warps) and reduce through shared memory at the end of each
//   pass. Each thread of the first warp owns one row and 4 adjacent
//   columns of the tile and keeps the xW values of its outputs in
//   registers across every lane pass, so the bias+ReLU epilogue runs on
//   values that never leave the SM.
// - Rows that are not 16-byte multiples (K or N not a multiple of 16
//   bytes) take plain loads of the same panels instead of cp.async.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 8;           // output rows per thread block
constexpr int BN = 16;          // output columns per thread block
constexpr int TPG = BM * BN / 4;   // threads per K group: 4 outputs each
constexpr int KG = 8;           // groups of threads (warps) that split K
constexpr int THREADS = TPG * KG;
// thread (g, t) = (tid / TPG, tid % TPG): row t / 4, columns 4 (t % 4) + c
// of the tile, over the K indices g, g + KG, ...
constexpr int QB = 4;           // lanes per pass over K
constexpr int KALIGN = 8;       // K chunks are multiples of 8 elements
constexpr size_t STAGE_BUDGET = 96 * 1024;   // bytes of one ring stage

// x rows in shared memory are padded so that the 8 rows a warp reads sit
// on different banks (a stride of 4 mod 8 words) and stay 16-byte aligned
template <typename T>
__host__ __device__ constexpr int x_stride(int kc) {
  return sizeof(T) == 4 ? kc + 4 : kc + (kc % 16 == 0 ? 8 : 16);
}

// elements of one stage: x [BM][x_stride], W [KC][BN], U [qb][KC][BN]
template <typename T>
__host__ __device__ constexpr size_t stage_elems(int kc, int qb) {
  return size_t(BM) * x_stride<T>(kc) + size_t(1 + qb) * kc * BN;
}

// f32 partial sums of the K groups 1.. for the reduction into group 0:
// [KG - 1][1 + qb][BM * BN]
__host__ __device__ constexpr size_t red_bytes(int qb) {
  return size_t(KG - 1) * (1 + qb) * BM * BN * sizeof(float);
}

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

// four adjacent elements of a shared-memory row, as f32
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 zero-fills
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// dst [rows][dst_stride] <- src rows [r0, r0 + rows) x columns
// [c0, c0 + cols) of a (n_rows, n_cols) row-major matrix, zero outside it.
// vec: n_cols is a multiple of 16 bytes, so 16-byte groups are wholly in
// or out and cp.async can carry them; otherwise plain element loads.
template <typename T>
__device__ __forceinline__ void load_panel(T* dst, int dst_stride,
                                           const T* __restrict__ src,
                                           int n_rows, int n_cols, int r0,
                                           int c0, int rows, int cols,
                                           bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec) {
    const int groups = cols / VEC;   // cols is a multiple of 8 >= VEC
    for (int e = threadIdx.x; e < rows * groups; e += THREADS) {
      const int r = e / groups, c = (e % groups) * VEC;
      const int gr = r0 + r, gc = c0 + c;
      const bool in = gr < n_rows && gc < n_cols;
      cp_async16(dst + r * dst_stride + c,
                 in ? src + (size_t)gr * n_cols + gc : src, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
      const int r = e / cols, c = e % cols;
      const int gr = r0 + r, gc = c0 + c;
      dst[r * dst_stride + c] = (gr < n_rows && gc < n_cols)
                                    ? src[(size_t)gr * n_cols + gc]
                                    : from_f32<T>(0.f);
    }
  }
}

template <typename T, bool EPI>
__global__ void __launch_bounds__(THREADS) zoo_dual_matmul_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ us,
    const float* __restrict__ b, const float* __restrict__ ub, float mu,
    T* __restrict__ y, T* __restrict__ y_hat, int M, int K, int N, int q,
    int kc, int qb, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int r = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kg = threadIdx.x / TPG;        // the thread's K group
  const int t = threadIdx.x % TPG;
  const int ty = t / (BN / 4);             // its row of the tile
  const int tx = (t % (BN / 4)) * 4;       // its first of 4 columns
  const int xs = x_stride<T>(kc);
  const size_t stage = stage_elems<T>(kc, qb);
  const T* xr = x + (size_t)r * M * K;
  const T* wr = w + (size_t)r * K * N;

  const int n_chunks = (K + kc - 1) / kc;
  const int n_passes = (q + qb - 1) / qb;
  const int n_items = n_chunks * n_passes;   // item = (pass, K chunk)
  float* red = reinterpret_cast<float*>(
      smem_raw + (n_items > 1 ? 2 : 1) * stage * sizeof(T));

  // issue every panel of item it into stage it % 2
  auto issue = [&](int it) {
    const int pass = it / n_chunks, k0 = (it % n_chunks) * kc;
    T* st = smem + (it % 2) * stage;
    T* sx = st;
    T* sw = sx + BM * xs;
    T* su = sw + kc * BN;
    load_panel(sx, xs, xr, M, K, m0, k0, BM, kc, vec);
    if (pass == 0) load_panel(sw, BN, wr, K, N, k0, n0, kc, BN, vec);
    const int l_end = min(q, (pass + 1) * qb);
    for (int l = pass * qb; l < l_end; ++l) {
      const T* ul = us + ((size_t)r * q + l) * K * N;
      load_panel(su + (l - pass * qb) * kc * BN, BN, ul, K, N, k0, n0, kc, BN,
                 vec);
    }
  };

  float accw[4] = {0.f, 0.f, 0.f, 0.f};   // the raw xW of this thread
  float accu[QB][4];
  float bias[4] = {0.f, 0.f, 0.f, 0.f};
  if (EPI) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx + c;
      if (n < N) bias[c] = b[(size_t)r * N + n];
    }
  }

  issue(0);
  cp_async_commit();
  if (n_items > 1) issue(1);
  cp_async_commit();

  for (int it = 0; it < n_items; ++it) {
    const int pass = it / n_chunks, chunk = it % n_chunks;
    const int k0 = chunk * kc;
    const int nl = min(qb, q - pass * qb);   // lanes of this pass
    if (chunk == 0) {
#pragma unroll
      for (int li = 0; li < QB; ++li)
#pragma unroll
        for (int c = 0; c < 4; ++c) accu[li][c] = 0.f;
    }
    cp_async_wait_one();   // item it has landed (it + 1 may be in flight)
    __syncthreads();
    const T* sx = smem + (it % 2) * stage;
    const T* sw = sx + BM * xs;
    const T* su = sw + kc * BN;
    const int kn = min(kc, K - k0);
#pragma unroll 4
    for (int kk = kg; kk < kn; kk += KG) {
      const float a = to_f32(sx[ty * xs + kk]);
      float v[4];
      if (pass == 0) {
        load4(sw + kk * BN + tx, v);
#pragma unroll
        for (int c = 0; c < 4; ++c) accw[c] = fmaf(a, v[c], accw[c]);
      }
#pragma unroll
      for (int li = 0; li < QB; ++li) {
        if (li < nl) {
          load4(su + (li * kc + kk) * BN + tx, v);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            accu[li][c] = fmaf(a, v[c], accu[li][c]);
          }
        }
      }
    }
    __syncthreads();   // stage it % 2 is free again
    if (it + 2 < n_items) issue(it + 2);
    cp_async_commit();

    if (chunk == n_chunks - 1) {   // the pass is complete: its outputs
      // K groups 1.. hand their partial sums to group 0
      constexpr int TILE = BM * BN;
      if (kg > 0) {
        float* dst = red + (size_t)(kg - 1) * (1 + qb) * TILE + 4 * t;
        if (pass == 0) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(accw[0], accw[1], accw[2], accw[3]);
        }
#pragma unroll
        for (int li = 0; li < QB; ++li) {
          if (li < nl) {
            *reinterpret_cast<float4*>(dst + (1 + li) * TILE) = make_float4(
                accu[li][0], accu[li][1], accu[li][2], accu[li][3]);
          }
        }
      }
      __syncthreads();
      if (kg == 0) {
        for (int g = 1; g < KG; ++g) {
          const float* src = red + (size_t)(g - 1) * (1 + qb) * TILE + 4 * t;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (pass == 0) accw[c] += src[c];
#pragma unroll
            for (int li = 0; li < QB; ++li) {
              if (li < nl) accu[li][c] += src[(1 + li) * TILE + c];
            }
          }
        }
      }
      __syncthreads();   // the partial sums are read: red is free again
      const int m = m0 + ty;
      if (kg == 0 && m < M) {
        if (pass == 0) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int n = n0 + tx + c;
            if (n < N) {
              float val = accw[c];
              if (EPI) val = fmaxf(val + bias[c], 0.f);
              y[((size_t)r * M + m) * N + n] = from_f32<T>(val);
            }
          }
        }
#pragma unroll
        for (int li = 0; li < QB; ++li) {
          if (li < nl) {
            const size_t rl = (size_t)r * q + pass * qb + li;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int n = n0 + tx + c;
              if (n < N) {
                float val = accw[c] + mu * accu[li][c];
                if (EPI) {
                  val = fmaxf(val + (bias[c] + mu * ub[rl * N + n]), 0.f);
                }
                y_hat[(rl * M + m) * N + n] = from_f32<T>(val);
              }
            }
          }
        }
      }
    }
  }
}

template <typename T, bool EPI>
int launch(const void* x, const void* w, const void* us, const void* b,
           const void* ub, float mu, void* y, void* y_hat, int R, int M, int K,
           int N, int q, cudaStream_t stream) {
  constexpr int es = sizeof(T);
  const int qb = q < QB ? q : QB;
  // the whole K in one stage if it fits, else the largest chunk that does
  int kc = (K + KALIGN - 1) / KALIGN * KALIGN;
  if (stage_elems<T>(kc, qb) * es > STAGE_BUDGET) {
    kc = int((STAGE_BUDGET / es - size_t(BM) * 16) /
             (BM + size_t(1 + qb) * BN)) / KALIGN * KALIGN;
  }
  const int n_items = ((K + kc - 1) / kc) * ((q + qb - 1) / qb);
  const size_t smem =
      (n_items > 1 ? 2 : 1) * stage_elems<T>(kc, qb) * es + red_bytes(qb);
  // rows of 16-byte multiples: cp.async; the 16-byte alignment of the
  // bases holds for PyTorch's allocations and every row offset then
  const int vec = (K * es) % 16 == 0 && (N * es) % 16 == 0;
  // above 48 KB of shared memory only after opting in, per device; the
  // host call is made once per device and larger size
  static size_t opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || smem > opted_in[dev]) {
    err = cudaFuncSetAttribute(zoo_dual_matmul_kernel<T, EPI>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) opted_in[dev] = smem;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, R);
  zoo_dual_matmul_kernel<T, EPI><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(us), static_cast<const float*>(b),
      static_cast<const float*>(ub), mu, static_cast<T*>(y),
      static_cast<T*>(y_hat), M, K, N, q, kc, qb, vec);
  return static_cast<int>(cudaGetLastError());
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
    return epilogue
        ? launch<float, true>(x, w, us, b, ub, mu, y, y_hat, R, M, K, N, q, s)
        : launch<float, false>(x, w, us, b, ub, mu, y, y_hat, R, M, K, N, q,
                               s);
  }
  return epilogue
      ? launch<__nv_bfloat16, true>(x, w, us, b, ub, mu, y, y_hat, R, M, K, N,
                                    q, s)
      : launch<__nv_bfloat16, false>(x, w, us, b, ub, mu, y, y_hat, R, M, K,
                                     N, q, s);
}
