// Causal / sliding-window flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_pallas (body _flash_kernel)
// of src/repro/kernels/flash_attention/kernel.py. Computes, per batch b and
// query head h, softmax(q k^T * d^-1/2 + mask) v with the online softmax in
// f32, where query row i sits at position q_offset + i and key j at j:
//   causal:      key j visible to row i iff j <= q_offset + i
//   window > 0:  and j > q_offset + i - window
// q_offset = 0 is the TPU kernel's function; q_offset = cur_pos is the
// chunked-prefill form (mha_chunked(..., q_offset=cur_pos)): a chunk of
// queries attends over a KV cache whose slots past cur_pos + Sq are still
// zero, and the causal mask hides them.
//
// Layout: q (B, Sq, Hq, d), k and v (B, Skv, Hkv, d), o (B, Sq, Hq, d), all
// contiguous, f32 or bf16 (o in q's type). GQA reads KV head h / (Hq / Hkv)
// in place: no broadcast copy of the cache. The TPU kernel's (BH, S, d)
// form is the Hq = Hkv = 1 case. d is a multiple of 16 up to 128 (Phi-3's
// 96 included); Sq and Skv are any length (ragged tiles are masked, where
// the TPU kernel asserts S % bq == 0).
//
// Numerics as the TPU kernel: masked scores are -1e30 (not -inf), the
// denominator is max(l, 1e-30); bf16 inputs convert to f32 on load; every
// product is an f32 FMA on the CUDA cores (no TF32, no tensor cores), and
// exp is the accurate expf.
//
// What bounds it on the H100. At Phi-3-mini's prefill shapes (B = 8,
// H = 32, d = 96, a 1152-slot cache; chunks of 576 queries at offset 0 and
// 448 at offset 576) the work is 4 d flops per visible (query, key) pair:
// 16 and 35 GFLOP per layer, against 113 and 145 MB of q, o and the KV
// rows the masks reach. On the f32 CUDA cores this kernel uses, operations
// bound it (0.77 ms a layer at 67 TFLOP/s); were it bf16 on the tensor
// cores (989 TFLOP/s, later work with wgmma), the bytes would (77 us a
// layer at 3.35 TB/s).
//
// Design. One thread block per (b, h, tile of BQ = 64 queries), 128
// threads, an in-block loop over KV tiles of BK = 64 keys through shared
// memory (the TPU kernel's sequential kv grid axis), the running max,
// denominator and accumulator in registers. Only KV tiles that hold a
// visible key for some row of the block are visited: tiles wholly above
// the diagonal or before the window are never loaded. Thread (tx, ty) =
// (t % 16, t / 16) owns rows ty + 8i (i < 8); it computes the scores of
// columns tx + 16j (j < 4), and the output columns tx + 16jj (jj < d/16),
// so each row's max and sum reduce over the 16 lanes of one half-warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per KV tile
constexpr int THREADS = 128;
constexpr int RI = BQ / 8;       // rows per thread (8)
constexpr int CJ = BK / 16;      // score columns per thread (4)
constexpr int P_STRIDE = BK + 16;  // row ty and ty + 1 on other banks
constexpr float NEG_INF = -1e30f;

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

template <int D>
constexpr size_t smem_bytes() {
  // sQ [BQ][D], sK [BK][D + 1], sV [BK][D], sP [BQ][P_STRIDE], all f32
  return sizeof(float) *
         (BQ * D + BK * (D + 1) + BK * D + BQ * P_STRIDE);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Hq, int Hkv, int Sq, int Skv, int causal,
    int window, int q_offset, float scale) {
  constexpr int NJ = D / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                       // [BQ][D]
  float* sK = sQ + BQ * D;                // [BK][D + 1]
  float* sV = sK + BK * (D + 1);          // [BK][D]
  float* sP = sV + BK * D;                // [BQ][P_STRIDE]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.y * BQ;

  // q rows of this block, pre-scaled; rows past Sq read as zero
  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    const int gr = q0 + r;
    sQ[e] = gr < Sq
        ? to_f32(q[(((size_t)b * Sq + gr) * Hq + h) * D + c]) * scale
        : 0.f;
  }

  // the KV tiles holding a visible key for some row of the block
  const int last_row = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Skv, q_offset + last_row + 1) : Skv;
  int k_begin = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  float m[RI], l[RI], acc[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();   // the previous tile's sK, sV, sP are no longer read
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const int gk = kt + r;
      const size_t off = (((size_t)b * Skv + gk) * Hkv + hk) * D + c;
      sK[r * (D + 1) + c] = gk < Skv ? to_f32(k[off]) : 0.f;
      sV[e] = gk < Skv ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = sQ[(ty + 8 * i) * D + c];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = sK[(tx + 16 * j) * (D + 1) + c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q_offset + q0 + ty + 8 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kpos = kt + tx + 16 * j;
        bool visible = kpos < Skv;
        if (causal) visible = visible && kpos <= qpos;
        if (window > 0) visible = visible && kpos > qpos - window;
        if (!visible) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty + 8 * i) * P_STRIDE + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[NJ];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) vv[jj] = sV[kk * D + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float p = sP[(ty + 8 * i) * P_STRIDE + kk];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = fmaf(p, vv[jj], acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int gr = q0 + ty + 8 * i;
    if (gr >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + (((size_t)b * Sq + gr) * Hq + h) * D;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      orow[tx + 16 * jj] = from_f32<T>(acc[i][jj] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Skv, int causal, int window,
           int q_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // above 48 KB of shared memory only after opting in (per device, so on
  // every launch: it is a host-side attribute write)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * Hq, (Sq + BQ - 1) / BQ);
  flash_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv, causal,
      window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* o,
               int B, int Hq, int Hkv, int Sq, int Skv, int causal,
               int window, int q_offset, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, q_offset, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, q_offset, scale, s);
    case 48: return launch<T, 48>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, q_offset, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, q_offset, scale, s);
    case 80: return launch<T, 80>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, q_offset, scale, s);
    case 96: return launch<T, 96>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, q_offset, scale, s);
    case 112: return launch<T, 112>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, q_offset, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, q_offset, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. causal: 0 or 1; window: 0 = none.
// Launches on `stream` and returns cudaGetLastError() (0 on success); it
// neither allocates nor synchronises.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* o, int B, int Hq,
                                      int Hkv, int Sq, int Skv, int d,
                                      int causal, int window, int q_offset,
                                      float scale, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Skv < 1 ||
      window < 0 || q_offset < 0 || (Sq + BQ - 1) / BQ > 65535 ||
      (long long)B * Hq > 2147483647LL || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_d<float>(d, q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                             window, q_offset, scale, s);
  }
  return dispatch_d<__nv_bfloat16>(d, q, k, v, o, B, Hq, Hkv, Sq, Skv,
                                   causal, window, q_offset, scale, s);
}
