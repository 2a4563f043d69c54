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
// Pairs with j > i are never exponentiated (their exp would overflow; the
// TPU kernel guards it with a double where). exp and log are the accurate
// expf and logf.
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
// beside 167 MB: 50 us of bytes at 3.35 TB/s against 11 us of bf16
// tensor-core work at 989 TFLOP/s (22 us with the split operands below),
// so bytes bound it; on the CUDA cores (67 TFLOP/s f32) operations would.
//
// Two routes, chosen by the inputs' type; both take every shape above.
//
// float32 inputs: the CUDA cores (ssd_chunk_kernel). One block of 256
// threads per (b, h) walks the chunks in order and keeps the (P, N) state
// in shared memory; per chunk it stages x, B, C, la and dt as f32, forms
// the prefix sums, M = exp(cum_i - cum_j) (C.B^T) dt_j (lower triangle,
// zero above), y = M x + exp(cum) (C S^T), and the state update, every
// product an f32 FMA. Thread (tx, ty) = (t % 16, t / 16) owns rows
// ty + 16 i and columns tx + 16 j; B, C and the state have a padded row
// stride (N + 1). Shared memory: c P + 2 c (N+1) + c (c+1) + P (N+1) + 5 c
// floats, opted into per launch.
//
// bfloat16 inputs: the tensor cores, mma.sync m16n8k16 (bf16 operands,
// f32 accumulators), in two kernels a call. mma.sync over wgmma: its
// 16-row tiles fit the chunks of 96 and 112 rows (6 and 7 x 16) exactly,
// where wgmma's 64-row tiles would pad them to 128, and an accumulator
// feeds the next product from registers.
// - Precision. C.B^T has two bf16 operands: one bf16 product, exact in
//   its f32 sum. The other three products have an f32 operand (M, the
//   carried state S, and x w), which enters as two bf16 terms,
//   hi = bf16(v) and lo = bf16(v - hi), against the bf16 operand as it is
//   (v = hi + lo to 2^-16 |v|): f32-grade results at twice the
//   tensor-core work. The state stays f32 in shared memory. M's decay
//   uses __expf (ex2.approx; its argument cum_i - cum_j <= 0, a few ulp).
// - Pre-pass (ssd_prep_kernel), per (b, chunk): C.B^T once for all H
//   heads (B and C are shared by the heads), the lower triangle of 16 x 16
//   tiles in accumulator order; and per (b, h, chunk) the warp-shuffle
//   prefix sums of log a and exp(cum), w = exp(cum_last - cum) dt, dt and
//   exp(cum_last), written as one contiguous run (a and dt are read at a
//   stride of H once, here). Scratch: c16 (c16 + 1) / 2 KB per (b, chunk)
//   and (4 c16 + 4) floats per (b, h, chunk) (c16 = c rounded up to 16):
//   7.0 MB in all at S = 576, c = 96 and 5.5 MB at S = 448, c = 112 (the
//   serve shapes), written once and read once.
// - Scan (ssd_tc_kernel), one block per (b, h) walking the chunks: warp w
//   owns chunk rows [16 w, 16 w + 16), and up to two more warps (8 at
//   most) take only state-update tasks. Per chunk: acc = C S^T (S from its
//   hi / lo tiles), scaled by exp(cum_i) per row; += M x over j tiles
//   0 .. w, M built in registers from the pre-pass's C.B^T tile (read one
//   tile ahead), the decay and dt, in A-fragment order; y stored from the
//   accumulators; then S = exp(cum_last) S + (x w)^T B in 8 tasks of
//   16 x 32 (p, n), given to the warps with the least M x work (the
//   task-only warps first), which write S in f32 and as hi / lo tiles for
//   the next chunk.
// - Loads overlap compute: cp.async (16-byte copies into XOR-swizzled
//   tiles) brings chunk ci + 1's B, x and vectors (two stages) from chunk
//   ci's start and its C (one stage: read at the chunk's start) once chunk
//   ci's C S^T is formed. A row or column count off the 16-byte grid (P or
//   N not a multiple of 8) takes plain loads into the same tiles.
// - Ragged shapes: chunk rows past c, and P or N columns past their
//   extent up to the next 16, are zero in the tiles (zeroed once; no load
//   writes them), carry no dt, and are never stored.
// - Shared memory: 16 KB of f32 state, its 16 KB hi / lo tiles, 5 tiles
//   of c16 x 128 bytes and two stages of vectors: 95.0 KB at c = 96 and
//   105.5 KB at c = 112, so two blocks of 8 warps fit on an SM (grid
//   B H = 640).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CHUNK = 128;
constexpr int MAX_PN = 64;
constexpr int RY = MAX_CHUNK / 16;   // chunk rows per thread (8)
constexpr int CP = MAX_PN / 16;      // P or N columns per thread (4)

__device__ __forceinline__ float to_f32(float v) { return v; }

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


// ---------------------------------------------------------------------------
// The bf16 route: the chunk products on the tensor cores (mma.sync
// m16n8k16, bf16 operands, f32 accumulators), in two kernels: a pre-pass
// over (b, chunk) and the scan over (b, h).

constexpr int TC_MAX_THREADS = 256;  // 8 warps: chunk rows up to 128
constexpr int TILE_BYTES_ROW = 128;  // a bf16 tile row: 64 columns
constexpr int PREP_HEADS = 16;       // heads a pre-pass block scans

__host__ __device__ inline int tc_rows(int c) { return (c + 15) / 16 * 16; }

// 16 x 16 tiles of the lower triangle of a chunk's C.B^T
__host__ __device__ inline int tc_tiles(int c) {
  const int c16 = tc_rows(c) / 16;
  return c16 * (c16 + 1) / 2;
}

// floats of one (b, h, chunk)'s vectors: cum, exp(cum), w and dt (rows
// each; past c: cum_last, exp(cum_last), 0, 0), then exp(cum_last) and 3
// floats of padding
__host__ __device__ inline int tc_vec_floats(int c) {
  return 4 * tc_rows(c) + 4;
}

// The scratch (floats): C.B^T per (b, chunk), tc_tiles(c) tiles of 32
// lanes x 8 floats in mma accumulator order, then the vectors per
// (b, h, chunk).
__host__ __device__ inline size_t tc_cb_floats(int B, int S, int c) {
  return (size_t)B * (S / c) * tc_tiles(c) * 256;
}
__host__ __device__ inline size_t tc_scratch_bytes(int B, int S, int H,
                                                   int c) {
  return 4 * (tc_cb_floats(B, S, c) +
              (size_t)B * H * (S / c) * tc_vec_floats(c));
}

// the scan kernel's threads: a warp for each 16 chunk rows and up to two
// more (at most 8 warps) that take only state-update tasks
__host__ __device__ inline int tc_scan_threads(int c) {
  const int warps = tc_rows(c) / 16 + 2;
  return 32 * (warps < TC_MAX_THREADS / 32 ? warps : TC_MAX_THREADS / 32);
}

struct TcLayout {       // byte offsets into the scan kernel's shared memory
  int rows;             // c rounded up to a multiple of 16
  size_t state, s_hi, s_lo, c_tile, b_tile, x_tile, vec, total;
};

__host__ __device__ inline TcLayout tc_layout(int c) {
  TcLayout L;
  L.rows = tc_rows(c);
  const size_t tile = (size_t)L.rows * TILE_BYTES_ROW;
  size_t o = 0;
  L.state = o;  o += (size_t)MAX_PN * MAX_PN * 4;       // f32
  L.s_hi = o;   o += (size_t)MAX_PN * TILE_BYTES_ROW;   // bf16 [p][n]
  L.s_lo = o;   o += (size_t)MAX_PN * TILE_BYTES_ROW;
  L.c_tile = o; o += tile;                              // C, one stage
  L.b_tile = o; o += 2 * tile;                          // B, two stages
  L.x_tile = o; o += 2 * tile;                          // x, two stages
  L.vec = o;    o += 2 * (size_t)tc_vec_floats(c) * 4;  // two stages
  L.total = o;
  return L;
}

// the pre-pass: two tiles (C.B^T blocks) or a and dt of PREP_HEADS heads
__host__ __device__ inline size_t tc_prep_smem(int c) {
  const size_t tiles = 2 * (size_t)tc_rows(c) * TILE_BYTES_ROW;
  const size_t scan = 2 * (size_t)(c + 1) * PREP_HEADS * 4;
  return tiles > scan ? tiles : scan;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of (row, 16-byte chunk) in a bf16 tile: the chunk is XORed
// with the row's low three bits, so the 8 rows of an ldmatrix 8 x 8 read
// land on 8 different bank groups
__device__ __forceinline__ uint32_t tile_off(int row, int chunk) {
  return row * TILE_BYTES_ROW + ((chunk ^ (row & 7)) << 4);
}

// the f32 (P, N) state, row stride 64: columns XORed with (p & 3) * 8
// (pairs stay together), so the fragment reads and writes, 8-byte pairs
// of 4 rows a half-warp, are free of bank conflicts
__device__ __forceinline__ int state_idx(int p, int n) {
  return p * MAX_PN + (n ^ ((p & 3) << 3));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until every copy of this thread has landed, committed or not
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two f32 values of adjacent columns -> (hi, lo) bf16 pairs with
// v = hi + lo to within 2^-16 |v|
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  hi = bf16x2_bits(v0, v1);
  const float2 h = unpack2(hi);
  lo = bf16x2_bits(v0 - h.x, v1 - h.y);
}

// rows [0, c) and columns [0, cols) of a bf16 matrix slice (row stride
// `stride` elements) into a swizzled tile, by threads t0, t0 + nt, ...:
// 16-byte cp.async when `vec` (cols % 8 == 0, 16-byte aligned rows), else
// plain loads and stores
__device__ __forceinline__ void load_tile(unsigned char* tile,
                                          const __nv_bfloat16* src,
                                          size_t stride, int c, int cols,
                                          bool vec, int t0, int nt) {
  if (vec) {
    const int chunks = cols / 8;
    for (int e = t0; e < c * chunks; e += nt) {
      const int r = chunks == 8 ? e >> 3 : e / chunks;
      const int ch = chunks == 8 ? e & 7 : e % chunks;
      cp_async16(smem_u32(tile + tile_off(r, ch)), src + r * stride + ch * 8);
    }
  } else {
    for (int e = t0; e < c * cols; e += nt) {
      const int r = e / cols, col = e % cols;
      *reinterpret_cast<__nv_bfloat16*>(tile + tile_off(r, col / 8) +
                                        (col % 8) * 2) = src[r * stride + col];
    }
  }
}

template <typename O>
__device__ __forceinline__ void store_pair(O* dst, int p, int P, float v0,
                                           float v1) {
  if (p + 1 < P) {
    if constexpr (std::is_same<O, float>::value) {
      if ((P & 1) == 0) {
        *reinterpret_cast<float2*>(dst + p) = make_float2(v0, v1);
        return;
      }
    }
    dst[p] = from_f32<O>(v0);
    dst[p + 1] = from_f32<O>(v1);
  } else if (p < P) {
    dst[p] = from_f32<O>(v0);
  }
}


// The state update's work is 8 tasks, (16 rows of p) x (32 columns of n);
// warp w < strips also has the M x product of its rows, w + 1 tiles of
// 16 x 16 x P, and the warps past them have nothing else. Tasks go, in
// order, to the warp with the least work so far (in units of half a j tile
// of M x, 8 mma; a task is rows / 16 of them): returns this warp's tasks
// as a bit mask.
__device__ __forceinline__ unsigned state_tasks(int warp, int nw,
                                                int strips, int rows) {
  int load[TC_MAX_THREADS / 32];
  for (int v = 0; v < nw; ++v) load[v] = v < strips ? 2 * (v + 1) : 0;
  unsigned mine = 0;
  for (int t = 0; t < 8; ++t) {
    int best = 0;
    for (int v = 1; v < nw; ++v)
      if (load[v] < load[best]) best = v;
    load[best] += rows / 16;
    if (best == warp) mine |= 1u << t;
  }
  return mine;
}

// Pre-pass, one block per (b, chunk) and group of PREP_HEADS heads, and
// one more per (b, chunk) for C.B^T. The C.B^T block forms the chunk's
// C.B^T once for all H heads (warp r the tiles j <= r of its 16 rows) and
// writes it in accumulator order. The other blocks scan log a for their
// heads (one warp a head, a shuffle scan over each 32 rows) and write
// cum, exp(cum), w = exp(cum_last - cum) dt, dt and exp(cum_last) as one
// contiguous run per (b, h, chunk).
__global__ void __launch_bounds__(TC_MAX_THREADS) ssd_prep_kernel(
    const float* __restrict__ a, const float* __restrict__ dt,
    const __nv_bfloat16* __restrict__ bm,
    const __nv_bfloat16* __restrict__ cm, float* __restrict__ scratch,
    int S, int H, int N, int c, int vec) {
  extern __shared__ __align__(128) unsigned char prep_smem[];
  const int rows = tc_rows(c), nc = S / c;
  const int bc = blockIdx.x, b = bc / nc, ci = bc % nc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const size_t row0 = (size_t)b * S + (size_t)ci * c;
  const unsigned FULL = 0xffffffffu;

  if (blockIdx.y == gridDim.y - 1) {
    unsigned char* sC = prep_smem;
    unsigned char* sB = sC + rows * TILE_BYTES_ROW;
    for (int e = tid * 16; e < 2 * rows * TILE_BYTES_ROW;
         e += blockDim.x * 16)
      *reinterpret_cast<uint4*>(prep_smem + e) = make_uint4(0, 0, 0, 0);
    __syncthreads();
    load_tile(sC, cm + row0 * N, N, c, N, vec, tid, blockDim.x);
    load_tile(sB, bm + row0 * N, N, c, N, vec, tid, blockDim.x);
    cp_wait_all();
    __syncthreads();
    const int r = warp;
    uint32_t cf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldsm_x4(cf[kk], smem_u32(sC + tile_off(
                          r * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                          kk * 2 + (lane >> 4))));
    float* out = scratch + ((size_t)bc * tc_tiles(c) + r * (r + 1) / 2) * 256;
    for (int jt = 0; jt <= r; ++jt) {
      float cb[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t bf[4];
        ldsm_x4(bf, smem_u32(sB + tile_off(
                        jt * 16 + (lane & 7) + (lane >> 4) * 8,
                        kk * 2 + ((lane >> 3) & 1))));
        mma_bf16(cb[0], cf[kk], bf[0], bf[1]);
        mma_bf16(cb[1], cf[kk], bf[2], bf[3]);
      }
      float4* o = reinterpret_cast<float4*>(out + jt * 256 + lane * 8);
      o[0] = make_float4(cb[0][0], cb[0][1], cb[0][2], cb[0][3]);
      o[1] = make_float4(cb[1][0], cb[1][1], cb[1][2], cb[1][3]);
    }
    return;
  }

  // a and dt of the group's heads, [head][row] (row stride c + 1)
  float* sa = reinterpret_cast<float*>(prep_smem);
  float* sdt = sa + (c + 1) * PREP_HEADS;
  const int hq0 = blockIdx.y * PREP_HEADS;
  for (int e = tid; e < c * PREP_HEADS; e += blockDim.x) {
    const int r = e / PREP_HEADS, q = e % PREP_HEADS;
    if (hq0 + q < H) {
      cp_async4(smem_u32(sa + q * (c + 1) + r), a + (row0 + r) * H + hq0 + q);
      cp_async4(smem_u32(sdt + q * (c + 1) + r),
                dt + (row0 + r) * H + hq0 + q);
    }
  }
  cp_wait_all();
  __syncthreads();

  const size_t vec0 = tc_cb_floats(gridDim.x / nc, S, c);
  for (int q = warp; q < PREP_HEADS && hq0 + q < H; q += nw) {
    const int h = hq0 + q;
    constexpr int RPL = MAX_CHUNK / 32;
    // rows i * 32 + lane: a shuffle scan of each 32 rows, plus the carry
    float cum[RPL];
    float carry = 0.f;
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const int r = i * 32 + lane;
      float v = r < c ? logf(fmaxf(sa[q * (c + 1) + r], 1e-20f)) : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(FULL, v, off);
        if (lane >= off) v += u;
      }
      cum[i] = carry + v;
      carry = __shfl_sync(FULL, cum[i], 31);
    }
    const float cum_last = carry;
    float* v = scratch + vec0 +
               (((size_t)b * H + h) * nc + ci) * tc_vec_floats(c);
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const int r = i * 32 + lane;
      if (r < rows) {
        const float d = r < c ? sdt[q * (c + 1) + r] : 0.f;
        v[r] = cum[i];
        v[rows + r] = expf(cum[i]);
        v[2 * rows + r] = expf(cum_last - cum[i]) * d;
        v[3 * rows + r] = d;
      }
    }
    if (lane < 4) v[4 * rows + lane] = lane == 0 ? expf(cum_last) : 0.f;
  }
}

// The scan, one block per (b, h); warp w < strips owns chunk rows
// [16 w, 16 w + 16). See the header for the design.
template <typename O>
__global__ void __launch_bounds__(TC_MAX_THREADS, 2) ssd_tc_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ bm,
    const __nv_bfloat16* __restrict__ cm, const float* __restrict__ scratch,
    const float* __restrict__ state0, O* __restrict__ y,
    float* __restrict__ state_out, int S, int H, int P, int N, int c,
    int vec) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  unsigned char* smem = tc_smem;
  const TcLayout L = tc_layout(c);
  const size_t tile = (size_t)L.rows * TILE_BYTES_ROW;
  const int nvec = tc_vec_floats(c);
  float* sS = reinterpret_cast<float*>(smem + L.state);
  unsigned char* sSh = smem + L.s_hi;
  unsigned char* sSl = smem + L.s_lo;
  unsigned char* sC = smem + L.c_tile;
  unsigned char* sBt = smem + L.b_tile;
  unsigned char* sXt = smem + L.x_tile;
  float* sVec = reinterpret_cast<float*>(smem + L.vec);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int nc = S / c;
  const int strips = L.rows / 16;             // warps with chunk rows
  const bool has_rows = warp < strips;
  const unsigned my_tasks = state_tasks(warp, nw, strips, L.rows);
  const float* cb_all = scratch + (size_t)b * nc * tc_tiles(c) * 256;
  const float* vec_all = scratch + tc_cb_floats(gridDim.x / H, S, c) +
                         ((size_t)b * H + h) * nc * nvec;

  // S f32 and as hi + lo bf16 tiles [p][n] (the inter product's operand);
  // f32 (P, N) states write and read through state_idx
  auto put_state = [&](int p, int n, float v0, float v1) {
    *reinterpret_cast<float2*>(sS + state_idx(p, n)) = make_float2(v0, v1);
    uint32_t hi, lo;
    split2(v0, v1, hi, lo);
    const uint32_t off = tile_off(p, n / 8) + (n % 8) * 2;
    *reinterpret_cast<uint32_t*>(sSh + off) = hi;
    *reinterpret_cast<uint32_t*>(sSl + off) = lo;
  };

  // zero all of it: padded rows and columns of the tiles stay zero
  for (size_t e = (size_t)tid * 16; e < L.total; e += (size_t)blockDim.x * 16)
    *reinterpret_cast<uint4*>(smem + e) = make_uint4(0, 0, 0, 0);
  __syncthreads();
  if (state0 != nullptr) {
    const float* s0 = state0 + (size_t)blockIdx.x * P * N;
    for (int e = tid; e < P * ((N + 1) / 2); e += blockDim.x) {
      const int p = e / ((N + 1) / 2), n = (e % ((N + 1) / 2)) * 2;
      put_state(p, n, s0[p * N + n], n + 1 < N ? s0[p * N + n + 1] : 0.f);
    }
  }

  // copies of chunk ci by threads t0, t0 + nt, ...: C; B, x and the
  // vectors (the stage)
  auto issue_c = [&](int ci, int t0, int nt) {
    load_tile(sC, cm + ((size_t)b * S + (size_t)ci * c) * N, N, c, N, vec,
              t0, nt);
  };
  auto issue_stage = [&](int ci, int t0, int nt) {
    const size_t row0 = (size_t)b * S + (size_t)ci * c;
    load_tile(sBt + (ci & 1) * tile, bm + row0 * N, N, c, N, vec, t0, nt);
    load_tile(sXt + (ci & 1) * tile, x + (row0 * H + h) * P, (size_t)H * P,
              c, P, vec, t0, nt);
    float* dst = sVec + (ci & 1) * nvec;
    const float* src = vec_all + (size_t)ci * nvec;
    for (int e = t0 * 4; e < nvec; e += nt * 4) {
      if (vec) {
        cp_async16(smem_u32(dst + e), src + e);
      } else {
        for (int i = 0; i < 4; ++i) dst[e + i] = src[e + i];
      }
    }
  };

  // copy groups: [C 0, stage 0]; per chunk [stage ci + 1] at its start
  // (the slot's last readers were chunk ci - 1's) and [C ci + 1] once
  // chunk ci's C.S^T is formed; each chunk waits for all
  issue_c(0, tid, blockDim.x);
  issue_stage(0, tid, blockDim.x);
  cp_commit();

  const int strip = has_rows ? warp : 0;
  const int r0 = strip * 16 + (lane >> 2), r1 = r0 + 8;  // this thread's rows
  const float* cb_strip = cb_all + (size_t)(strip * (strip + 1) / 2) * 256 +
                          lane * 8;

  for (int ci = 0; ci < nc; ++ci) {
    const size_t row0 = (size_t)b * S + (size_t)ci * c;
    cp_wait_all();
    __syncthreads();   // chunk ci's tiles, vectors and last chunk's S are in
    if (ci + 1 < nc) issue_stage(ci + 1, tid, blockDim.x);
    cp_commit();
    const unsigned char* sB = sBt + (ci & 1) * tile;
    const unsigned char* sX = sXt + (ci & 1) * tile;
    const float* cum = sVec + (ci & 1) * nvec;
    const float* ec = cum + L.rows;
    const float* w = cum + 2 * L.rows;
    const float* dtv = cum + 3 * L.rows;
    const float decay = cum[4 * L.rows];
    const float* cbp = cb_strip + (size_t)ci * tc_tiles(c) * 256;
    float4 cbn0 = make_float4(0.f, 0.f, 0.f, 0.f), cbn1 = cbn0;
    if (has_rows) {                                          // tile j = 0
      cbn0 = *reinterpret_cast<const float4*>(cbp);
      cbn1 = *reinterpret_cast<const float4*>(cbp + 4);
    }

    // y = exp(cum_i) (C S^T) + M x, by the warps with rows; S and M enter
    // as hi + lo bf16
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (!has_rows || kk * 16 >= N) break;
      uint32_t cf[4];
      ldsm_x4(cf, smem_u32(sC + tile_off(
                      warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                      kk * 2 + (lane >> 4))));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np * 16 >= P) break;
        // S^T as the col operand: rows p of the S tiles, 16 bytes of n
        const uint32_t off = tile_off(np * 16 + (lane & 7) + (lane >> 4) * 8,
                                      kk * 2 + ((lane >> 3) & 1));
        uint32_t sh[4], sl[4];
        ldsm_x4(sh, smem_u32(sSh + off));
        ldsm_x4(sl, smem_u32(sSl + off));
        mma_bf16(acc[2 * np], cf, sh[0], sh[1]);
        mma_bf16(acc[2 * np], cf, sl[0], sl[1]);
        mma_bf16(acc[2 * np + 1], cf, sh[2], sh[3]);
        mma_bf16(acc[2 * np + 1], cf, sl[2], sl[3]);
      }
    }
    const float e0 = ec[r0], e1 = ec[r1];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      acc[nt][0] *= e0;
      acc[nt][1] *= e0;
      acc[nt][2] *= e1;
      acc[nt][3] *= e1;
    }
    __syncthreads();   // every warp is done with C and with S hi / lo
    if (ci + 1 < nc) issue_c(ci + 1, tid, blockDim.x);
    cp_commit();

    const float c0 = cum[r0], c1 = cum[r1];
#pragma unroll 2
    for (int jt = 0; has_rows && jt <= warp; ++jt) {
      // C.B^T tile (rows of this warp, columns j), read from the pre-pass
      // one tile ahead; M = exp(cum_i - cum_j) (C.B^T) dt_j for j <= i
      // (the guard on the diagonal tile), else 0, in A-fragment order;
      // cum_i - cum_j <= 0 there, where __expf is within a few ulp
      const float cbv[2][4] = {{cbn0.x, cbn0.y, cbn0.z, cbn0.w},
                               {cbn1.x, cbn1.y, cbn1.z, cbn1.w}};
      if (jt < warp) {
        cbn0 = *reinterpret_cast<const float4*>(cbp + (jt + 1) * 256);
        cbn1 = *reinterpret_cast<const float4*>(cbp + (jt + 1) * 256 + 4);
      }
      const int j = jt * 16 + (lane & 3) * 2;
      const float2 cj[2] = {*reinterpret_cast<const float2*>(cum + j),
                            *reinterpret_cast<const float2*>(cum + j + 8)};
      const float2 dj[2] = {*reinterpret_cast<const float2*>(dtv + j),
                            *reinterpret_cast<const float2*>(dtv + j + 8)};
      float arg[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        arg[t][0] = c0 - cj[t].x;
        arg[t][1] = c0 - cj[t].y;
        arg[t][2] = c1 - cj[t].x;
        arg[t][3] = c1 - cj[t].y;
      }
      if (jt == warp) {      // the diagonal tile: exp(-inf) = 0 for j > i
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j + t * 8 + (e & 1) > (e < 2 ? r0 : r1))
              arg[t][e] = __int_as_float(0xff800000);  // -inf
      }
      float m[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        m[t][0] = cbv[t][0] * dj[t].x * __expf(arg[t][0]);
        m[t][1] = cbv[t][1] * dj[t].y * __expf(arg[t][1]);
        m[t][2] = cbv[t][2] * dj[t].x * __expf(arg[t][2]);
        m[t][3] = cbv[t][3] * dj[t].y * __expf(arg[t][3]);
      }
      uint32_t mh[4], ml[4];
      split2(m[0][0], m[0][1], mh[0], ml[0]);
      split2(m[0][2], m[0][3], mh[1], ml[1]);
      split2(m[1][0], m[1][1], mh[2], ml[2]);
      split2(m[1][2], m[1][3], mh[3], ml[3]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np * 16 >= P) break;
        uint32_t xf[4];
        ldsm_x4_t(xf, smem_u32(sX + tile_off(
                          jt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                          np * 2 + (lane >> 4))));
        mma_bf16(acc[2 * np], mh, xf[0], xf[1]);
        mma_bf16(acc[2 * np], ml, xf[0], xf[1]);
        mma_bf16(acc[2 * np + 1], mh, xf[2], xf[3]);
        mma_bf16(acc[2 * np + 1], ml, xf[2], xf[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8 && has_rows; ++nt) {
      const int p = nt * 8 + (lane & 3) * 2;
      if (r0 < c)
        store_pair(y + ((row0 + r0) * H + h) * P, p, P, acc[nt][0],
                   acc[nt][1]);
      if (r1 < c)
        store_pair(y + ((row0 + r1) * H + h) * P, p, P, acc[nt][2],
                   acc[nt][3]);
    }

    // S = exp(cum_last) S + (x w)^T B: this warp's tasks of 16 rows of p
    // by 32 columns of n, written as f32 and as hi + lo (no barrier before:
    // every read of S hi / lo was before the one above); x w enters as
    // hi + lo bf16
    for (int task = 0; task < 8; ++task) {
      if (!(my_tasks >> task & 1u)) continue;
      const int pt = task >> 1, nh = task & 1;
      if (pt * 16 >= P || nh * 32 >= N) continue;
      float ds[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[t][e] = 0.f;
      for (int kt = 0; kt < L.rows / 16; ++kt) {
        uint32_t xa[4];
        ldsm_x4_t(xa, smem_u32(sX + tile_off(
                          kt * 16 + (lane & 7) + (lane >> 4) * 8,
                          pt * 2 + ((lane >> 3) & 1))));
        const int jA = kt * 16 + (lane & 3) * 2;
        const float w0 = w[jA], w1 = w[jA + 1], w2 = w[jA + 8],
                    w3 = w[jA + 9];
        uint32_t ah[4], al[4];
        float2 v = unpack2(xa[0]);
        split2(v.x * w0, v.y * w1, ah[0], al[0]);
        v = unpack2(xa[1]);
        split2(v.x * w0, v.y * w1, ah[1], al[1]);
        v = unpack2(xa[2]);
        split2(v.x * w2, v.y * w3, ah[2], al[2]);
        v = unpack2(xa[3]);
        split2(v.x * w2, v.y * w3, ah[3], al[3]);
#pragma unroll
        for (int nq = 0; nq < 2; ++nq) {
          uint32_t bf[4];
          ldsm_x4_t(bf, smem_u32(sB + tile_off(
                            kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                            nh * 4 + nq * 2 + (lane >> 4))));
          mma_bf16(ds[2 * nq], ah, bf[0], bf[1]);
          mma_bf16(ds[2 * nq], al, bf[0], bf[1]);
          mma_bf16(ds[2 * nq + 1], ah, bf[2], bf[3]);
          mma_bf16(ds[2 * nq + 1], al, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int n = nh * 32 + t * 8 + (lane & 3) * 2;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = pt * 16 + (lane >> 2) + half * 8;
          const float2 s = *reinterpret_cast<const float2*>(
              sS + state_idx(p, n));
          put_state(p, n, s.x * decay + ds[t][2 * half],
                    s.y * decay + ds[t][2 * half + 1]);
        }
      }
    }
  }

  if (state_out != nullptr) {
    __syncthreads();
    float* so = state_out + (size_t)blockIdx.x * P * N;
    for (int e = tid; e < P * N; e += blockDim.x) {
      const int p = e / N, n = e % N;
      so[e] = sS[state_idx(p, n)];
    }
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename O>
int launch_tc(const void* x, const void* a, const void* dt, const void* bm,
              const void* cm, const void* state0, void* y, void* state_out,
              void* scratch, long long scratch_bytes, int B, int S, int H,
              int P, int N, int c, cudaStream_t stream) {
  if (scratch == nullptr || !aligned(scratch, 16) ||
      scratch_bytes < (long long)tc_scratch_bytes(B, S, H, c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const TcLayout L = tc_layout(c);
  const int vec = P % 8 == 0 && N % 8 == 0 && aligned(x, 16) &&
                  aligned(bm, 16) && aligned(cm, 16);
  const size_t prep_smem = tc_prep_smem(c);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)prep_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_prep_kernel<<<dim3(B * (S / c), (H + PREP_HEADS - 1) / PREP_HEADS + 1),
                    tc_rows(c) / 16 * 32, prep_smem, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(dt),
      static_cast<const __nv_bfloat16*>(bm),
      static_cast<const __nv_bfloat16*>(cm), static_cast<float*>(scratch), S,
      H, N, c, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_tc_kernel<O>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_tc_kernel<O><<<B * H, tc_scan_threads(c), L.total, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(bm),
      static_cast<const __nv_bfloat16*>(cm),
      static_cast<const float*>(scratch), static_cast<const float*>(state0),
      static_cast<O*>(y), static_cast<float*>(state_out), S, H, P, N, c, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in_dtype (x, B, C) and out_dtype (y): 0 = float32, 1 = bfloat16; the
// pairs (0, 0) (the CUDA-core route) and (1, 0), (1, 1) (the tensor-core
// route). state0 and state_out may be null (a zero initial state; no
// final state). The tensor-core route needs `scratch`, 16-byte aligned,
// of at least ssd_chunk_scratch_bytes(1, B, S, H, chunk) bytes (the
// CUDA-core route ignores it). Launches on `stream` (the tensor-core route
// two kernels, in order) and returns cudaGetLastError() (0 on success);
// it neither allocates nor synchronises.
extern "C" int ssd_chunk_launch(int in_dtype, int out_dtype, const void* x,
                                const void* a, const void* dt,
                                const void* bm, const void* cm,
                                const void* state0, void* y, void* state_out,
                                void* scratch, long long scratch_bytes,
                                int B, int S, int H, int P, int N, int chunk,
                                void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > MAX_PN || N < 1 ||
      N > MAX_PN || chunk < 1 || chunk > MAX_CHUNK || S % chunk != 0 ||
      (long long)B * H > 2147483647LL ||
      (long long)B * (S / chunk) > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0) {
    return launch<float, float>(x, a, dt, bm, cm, state0, y, state_out, B, S,
                                H, P, N, chunk, s);
  }
  if (in_dtype == 1 && out_dtype == 0) {
    return launch_tc<float>(x, a, dt, bm, cm, state0, y, state_out, scratch,
                            scratch_bytes, B, S, H, P, N, chunk, s);
  }
  if (in_dtype == 1 && out_dtype == 1) {
    return launch_tc<__nv_bfloat16>(x, a, dt, bm, cm, state0, y, state_out,
                                    scratch, scratch_bytes, B, S, H, P, N,
                                    chunk, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of scratch a launch needs (0 on the CUDA-core route).
extern "C" long long ssd_chunk_scratch_bytes(int in_dtype, int B, int S,
                                             int H, int chunk) {
  if (in_dtype != 1 || chunk < 1 || chunk > MAX_CHUNK || S % chunk != 0) {
    return 0;
  }
  return (long long)tc_scratch_bytes(B, S, H, chunk);
}

// The launch shape of the scan kernel of a call, without launching: out[0]
// the grid, out[1] the threads a block, out[2] the dynamic shared memory a
// block (bytes), out[3] the blocks resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Returns a CUDA error
// code (0 on success).
extern "C" int ssd_chunk_occupancy(int in_dtype, int out_dtype, int B, int H,
                                   int chunk, int* out) {
  if (B < 1 || H < 1 || chunk < 1 || chunk > MAX_CHUNK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  int blocks = 0, threads;
  size_t smem;
  if (in_dtype == 0) {
    smem = smem_bytes(chunk, MAX_PN, MAX_PN);
    threads = THREADS;
    err = cudaFuncSetAttribute(ssd_chunk_kernel<float, float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, ssd_chunk_kernel<float, float>, threads, smem);
  } else {
    smem = tc_layout(chunk).total;
    threads = tc_scan_threads(chunk);
    const void* fn = out_dtype == 0
                         ? reinterpret_cast<const void*>(ssd_tc_kernel<float>)
                         : reinterpret_cast<const void*>(
                               ssd_tc_kernel<__nv_bfloat16>);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                          threads, smem);
  }
  out[0] = B * H;
  out[1] = threads;
  out[2] = (int)smem;
  out[3] = blocks;
  return static_cast<int>(err);
}
