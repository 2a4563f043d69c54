// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ssd_chunk_pallas (body _ssd_kernel) of
// src/repro/kernels/ssd_chunk/kernel.py. Per batch b and SSM head h, the
// recurrence
//   S_t = a_t * S_{t-1} + dt_t * x_t (x) B_t      S (P, N), f32
//   y_t = S_t C_t                                 (P,)
// evaluated chunk by chunk, as the TPU kernel does it:
//   la = log(max(a, 1e-20)), cum = the in-chunk prefix sum of la;
//   intra: y_i  = sum_{j <= i} exp(cum_i - cum_j) * (C_i . B_j) * dt_j * x_j
//   inter: y_i += exp(cum_i) * (C_i . S^T)
//   state: S    = exp(cum_last) * S + sum_j (x_j * w_j) (x) B_j,
//          w_j  = exp(cum_last - cum_j) * dt_j.
// Pairs with j > i are never formed (their exp would overflow; the TPU
// kernel guards it with a double where). All math is f32: bf16 inputs
// convert on load, every product is an f32 FMA on the CUDA cores (no TF32,
// no tensor cores), exp and log are the accurate expf and logf. The prefix
// sum is sequential (thread i adds la_0 .. la_i in order), as a cumsum.
//
// Layout, the model's, read in place: x (B, S, H, P); a and dt (B, S, H),
// f32; B and C (B, S, N), shared by all H heads (a zero head stride: no
// (B*H, S, N) broadcast copy); y (B, S, H, P) in f32 or in x's type. The
// TPU kernel's (BH, S, P) / (BH, S) / (BH, S, N) layout is the H = 1 case.
// Beyond the TPU kernel, which starts from a zero state and drops the last
// one: an optional initial state (B, H, P, N) f32 (the decode state a
// chunked prefill starts from) and an optional final state out, same
// layout. Any chunk length from 1 to 128 with S % chunk == 0 (the serve
// path's chunks are 96 and 112); P and N up to 64.
//
// What bounds it on the H100. Per (b, h) and chunk of c rows the work is
// c (c + 1) / 2 (N + P) (intra, lower triangle) + 2 c P N (inter and
// state) multiply-adds; the bytes are x, a, dt, B, C and y once, and the
// state in and out. At the serve path's first prefill chunk (B = 8,
// H = 80, P = N = 64, S = 576, c = 96; x bf16, y f32) that is 10.6 GFLOP
// beside 167 MB: 50 us of bytes at 3.35 TB/s against 0.16 ms of f32 FMA at
// 67 TFLOP/s on the CUDA cores this kernel uses, so on these cores
// operations bound it; with the chunk products on bf16 tensor cores (later
// work) the bytes would.
//
// Design. One thread block of 256 threads per (b, h) walks the chunks in
// order (the TPU kernel's sequential chunk grid axis) and keeps the (P, N)
// state in shared memory across them. Per chunk it stages x, B, C, la and
// dt in shared memory as f32, forms the prefix sums, the c x c decay-
// weighted matrix M = exp(cum_i - cum_j) (C.B^T) dt_j (lower triangle,
// zero above), then y = M x + exp(cum) (C S^T), stores y, and updates the
// state. Thread (tx, ty) = (t % 16, t / 16) owns rows ty + 16 i and
// columns tx + 16 j of each product, so a warp reads two rows of the left
// operand (broadcasts) and 16 consecutive columns of the right one; the
// B, C and state tiles have a padded row stride (N + 1) so that reading
// them by column is free of bank conflicts. Shared memory: c P + 2 c (N+1)
// + c (c+1) + P (N+1) + 5 c floats, 185 KB at c = 128 and P = N = 64,
// above the default 48 KB and so opted into per launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CHUNK = 128;
constexpr int MAX_PN = 64;
constexpr int RY = MAX_CHUNK / 16;   // chunk rows per thread (8)
constexpr int CP = MAX_PN / 16;      // P or N columns per thread (4)

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

size_t smem_bytes(int c, int P, int N) {
  const size_t floats = (size_t)c * P + 2 * (size_t)c * (N + 1) +
                        (size_t)c * (c + 1) + (size_t)P * (N + 1) + 5 * c;
  return floats * sizeof(float);
}

template <typename T, typename O>
__global__ void __launch_bounds__(THREADS) ssd_chunk_kernel(
    const T* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ dt, const T* __restrict__ bm,
    const T* __restrict__ cm, const float* __restrict__ state0,
    O* __restrict__ y, float* __restrict__ state_out, int S, int H, int P,
    int N, int c) {
  extern __shared__ float smem[];
  const int Np = N + 1;
  float* sX = smem;                   // [c][P]
  float* sB = sX + c * P;             // [c][N + 1]
  float* sC = sB + c * Np;            // [c][N + 1]
  float* sM = sC + c * Np;            // [c][c + 1]
  float* sS = sM + c * (c + 1);       // [P][N + 1], the carried state
  float* sLa = sS + P * Np;           // [c] log a
  float* sDt = sLa + c;               // [c] dt
  float* sCum = sDt + c;              // [c] prefix sums of log a
  float* sEc = sCum + c;              // [c] exp(cum_i)
  float* sW = sEc + c;                // [c] exp(cum_last - cum_j) * dt_j

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.x;          // b * H + h
  const int b = bh / H;
  const int h = bh % H;
  const size_t state_base = (size_t)bh * P * N;

  for (int e = tid; e < P * N; e += THREADS) {
    sS[(e / N) * Np + e % N] = state0 != nullptr ? state0[state_base + e]
                                                 : 0.f;
  }

  const int n_chunks = S / c;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const size_t row0 = (size_t)b * S + (size_t)ci * c;   // (b, t0)
    __syncthreads();   // the last chunk's tiles are no longer read
    for (int e = tid; e < c * P; e += THREADS) {
      const int r = e / P, p = e % P;
      sX[e] = to_f32(x[((row0 + r) * H + h) * P + p]);
    }
    for (int e = tid; e < c * N; e += THREADS) {
      const int r = e / N, n = e % N;
      sB[r * Np + n] = to_f32(bm[(row0 + r) * N + n]);
      sC[r * Np + n] = to_f32(cm[(row0 + r) * N + n]);
    }
    if (tid < c) {
      const size_t g = (row0 + tid) * H + h;
      sLa[tid] = logf(fmaxf(a[g], 1e-20f));
      sDt[tid] = dt[g];
    }
    __syncthreads();

    // prefix sums, each in the order of a sequential cumsum
    float cum = 0.f;
    if (tid < c) {
      for (int k = 0; k <= tid; ++k) cum += sLa[k];
      sCum[tid] = cum;
    }
    __syncthreads();
    const float cum_last = sCum[c - 1];
    if (tid < c) {
      sEc[tid] = expf(cum);
      sW[tid] = expf(cum_last - cum) * sDt[tid];
    }

    // M[i][j] = exp(cum_i - cum_j) * (C_i . B_j) * dt_j for j <= i, else 0
    {
      float cb[RY][RY];
#pragma unroll
      for (int ii = 0; ii < RY; ++ii)
#pragma unroll
        for (int jj = 0; jj < RY; ++jj) cb[ii][jj] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[RY], bv[RY];
#pragma unroll
        for (int ii = 0; ii < RY; ++ii)
          cv[ii] = sC[min(ty + 16 * ii, c - 1) * Np + n];
#pragma unroll
        for (int jj = 0; jj < RY; ++jj)
          bv[jj] = sB[min(tx + 16 * jj, c - 1) * Np + n];
#pragma unroll
        for (int ii = 0; ii < RY; ++ii)
#pragma unroll
          for (int jj = 0; jj < RY; ++jj)
            cb[ii][jj] = fmaf(cv[ii], bv[jj], cb[ii][jj]);
      }
#pragma unroll
      for (int ii = 0; ii < RY; ++ii) {
        const int i = ty + 16 * ii;
        if (i >= c) continue;
#pragma unroll
        for (int jj = 0; jj < RY; ++jj) {
          const int j = tx + 16 * jj;
          if (j >= c) continue;
          sM[i * (c + 1) + j] =
              j <= i ? expf(sCum[i] - sCum[j]) * cb[ii][jj] * sDt[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // y = M x + exp(cum) (C S^T), rows ty + 16 ii, columns tx + 16 jj
    {
      float acc[RY][CP], inter[RY][CP];
#pragma unroll
      for (int ii = 0; ii < RY; ++ii)
#pragma unroll
        for (int jj = 0; jj < CP; ++jj) acc[ii][jj] = inter[ii][jj] = 0.f;
      for (int j = 0; j < c; ++j) {
        float xv[CP];
#pragma unroll
        for (int jj = 0; jj < CP; ++jj)
          xv[jj] = sX[j * P + min(tx + 16 * jj, P - 1)];
#pragma unroll
        for (int ii = 0; ii < RY; ++ii) {
          const float m = sM[min(ty + 16 * ii, c - 1) * (c + 1) + j];
#pragma unroll
          for (int jj = 0; jj < CP; ++jj)
            acc[ii][jj] = fmaf(m, xv[jj], acc[ii][jj]);
        }
      }
      for (int n = 0; n < N; ++n) {
        float sv[CP];
#pragma unroll
        for (int jj = 0; jj < CP; ++jj)
          sv[jj] = sS[min(tx + 16 * jj, P - 1) * Np + n];
#pragma unroll
        for (int ii = 0; ii < RY; ++ii) {
          const float cv = sC[min(ty + 16 * ii, c - 1) * Np + n];
#pragma unroll
          for (int jj = 0; jj < CP; ++jj)
            inter[ii][jj] = fmaf(cv, sv[jj], inter[ii][jj]);
        }
      }
#pragma unroll
      for (int ii = 0; ii < RY; ++ii) {
        const int i = ty + 16 * ii;
        if (i >= c) continue;
        O* yrow = y + ((row0 + i) * H + h) * P;
#pragma unroll
        for (int jj = 0; jj < CP; ++jj) {
          const int p = tx + 16 * jj;
          if (p < P) yrow[p] = from_f32<O>(acc[ii][jj] + sEc[i] * inter[ii][jj]);
        }
      }
    }
    __syncthreads();   // every read of the old state is done

    // S = exp(cum_last) S + sum_j (x_j w_j) (x) B_j; rows p = ty + 16 i,
    // columns n = tx + 16 jn
    {
      const float decay = expf(cum_last);
      float ds[CP][CP];
#pragma unroll
      for (int i = 0; i < CP; ++i)
#pragma unroll
        for (int jn = 0; jn < CP; ++jn) ds[i][jn] = 0.f;
      for (int j = 0; j < c; ++j) {
        const float w = sW[j];
        float xv[CP], bv[CP];
#pragma unroll
        for (int i = 0; i < CP; ++i)
          xv[i] = sX[j * P + min(ty + 16 * i, P - 1)] * w;
#pragma unroll
        for (int jn = 0; jn < CP; ++jn)
          bv[jn] = sB[j * Np + min(tx + 16 * jn, N - 1)];
#pragma unroll
        for (int i = 0; i < CP; ++i)
#pragma unroll
          for (int jn = 0; jn < CP; ++jn)
            ds[i][jn] = fmaf(xv[i], bv[jn], ds[i][jn]);
      }
#pragma unroll
      for (int i = 0; i < CP; ++i) {
        const int p = ty + 16 * i;
        if (p >= P) continue;
#pragma unroll
        for (int jn = 0; jn < CP; ++jn) {
          const int n = tx + 16 * jn;
          if (n < N) sS[p * Np + n] = sS[p * Np + n] * decay + ds[i][jn];
        }
      }
    }
  }

  if (state_out != nullptr) {
    __syncthreads();
    for (int e = tid; e < P * N; e += THREADS) {
      state_out[state_base + e] = sS[(e / N) * Np + e % N];
    }
  }
}

template <typename T, typename O>
int launch(const void* x, const void* a, const void* dt, const void* bm,
           const void* cm, const void* state0, void* y, void* state_out,
           int B, int S, int H, int P, int N, int c, cudaStream_t stream) {
  const size_t smem = smem_bytes(c, P, N);
  // above 48 KB of shared memory only after opting in (a host-side
  // attribute write, cheap, so on every launch)
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_kernel<T, O><<<B * H, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a),
      static_cast<const float*>(dt), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(state0),
      static_cast<O*>(y), static_cast<float*>(state_out), S, H, P, N, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in_dtype (x, B, C) and out_dtype (y): 0 = float32, 1 = bfloat16; the
// pairs (0, 0), (1, 0) and (1, 1). state0 and state_out may be null (a
// zero initial state; no final state). Launches on `stream` and returns
// cudaGetLastError() (0 on success); it neither allocates nor synchronises.
extern "C" int ssd_chunk_launch(int in_dtype, int out_dtype, const void* x,
                                const void* a, const void* dt,
                                const void* bm, const void* cm,
                                const void* state0, void* y, void* state_out,
                                int B, int S, int H, int P, int N, int chunk,
                                void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > MAX_PN || N < 1 ||
      N > MAX_PN || chunk < 1 || chunk > MAX_CHUNK || S % chunk != 0 ||
      (long long)B * H > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0) {
    return launch<float, float>(x, a, dt, bm, cm, state0, y, state_out, B, S,
                                H, P, N, chunk, s);
  }
  if (in_dtype == 1 && out_dtype == 0) {
    return launch<__nv_bfloat16, float>(x, a, dt, bm, cm, state0, y,
                                        state_out, B, S, H, P, N, chunk, s);
  }
  if (in_dtype == 1 && out_dtype == 1) {
    return launch<__nv_bfloat16, __nv_bfloat16>(
        x, a, dt, bm, cm, state0, y, state_out, B, S, H, P, N, chunk, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
