// Causal / sliding-window flash attention for Hopper (sm_90a): two routes,
// one per dtype.
//
// Replaces the Pallas TPU kernel flash_attention_pallas (body _flash_kernel)
// of src/repro/kernels/flash_attention/kernel.py. Computes, per batch b and
// query head h, softmax(q k^T * d^-1/2 + mask) v with the online softmax in
// f32 (d is q's and k's head dim; v's, d_v, may differ: the scale never
// takes it), where query row i sits at position q_offset + i and key j at j:
//   causal:      key j visible to row i iff j <= q_offset + i
//   window > 0:  and j > q_offset + i - window
// q_offset = 0 is the TPU kernel's function; q_offset = cur_pos is the
// chunked-prefill form (mha_chunked(..., q_offset=cur_pos)): a chunk of
// queries attends over a KV cache whose slots past cur_pos + Sq are still
// zero, and the causal mask hides them.
//
// Layout: q (B, Sq, Hq, d), k (B, Skv, Hkv, d), v (B, Skv, Hkv, d_v), o (B,
// Sq, Hq, d_v), all contiguous, o in q's type. GQA reads KV head
// h / (Hq / Hkv) in place: no broadcast copy of the cache. The TPU kernel's
// (BH, S, d) form is the Hq = Hkv = 1, d_v = d case. Both routes are
// templates on the pair (d, d_v): d = d_v, a multiple of 16 up to 128
// (Phi-3's 96, Zamba2's 80, Qwen3's 128), and (192, 128), the pair of
// DeepSeek-V3's multi-head latent attention once its latent is expanded
// (q and k are [128 nope | 64 rope] columns, v 128; the TPU kernel takes
// one d and the JAX package's MLA never calls it). V is never padded to
// 192: that would cost half again the P V products and the V bytes. Sq and
// Skv are any length (ragged tiles are
// masked, where the TPU kernel asserts S % bq == 0). Numerics as the TPU
// kernel: masked scores are -1e30 (not -inf), the denominator is
// max(l, 1e-30), the softmax statistics are f32.
//
// What bounds it on the H100. At Phi-3-mini's prefill shapes (B = 8,
// H = 32, d = 96, a 1152-slot cache; chunks of 576 queries at offset 0 and
// 448 at offset 576) the work is 4 d flops per visible (query, key) pair:
// 16 and 35 GFLOP per layer, against 113 and 145 MB of q, o and the KV
// rows the masks reach. On the bf16 tensor cores (989 TFLOP/s) the bytes
// bound it (77 us a layer at 3.35 TB/s; the operations alone 52 us); on
// the f32 CUDA cores (67 TFLOP/s) the operations do (0.77 ms a layer). At
// DeepSeek-V3's chunk (B = 8, H = 128, (192, 128), 576 queries at offset
// 448 over 1024 keys) the work is 2 (d + d_v) flops a visible pair, 0.28
// TFLOP, against 1.05 GB of q, k, v and o: bytes (0.31 ms) and operations
// (0.28 ms) bound it about alike.
//
// Route 1, f32 (flash_attention_f32_kernel): CUDA-core FMA, because f32
// must hold the plain version to 1e-4, which TF32 cannot. One 128-thread
// block per (b, h, tile of 64 queries) loops over 64-key tiles through
// shared memory with the running max, denominator and accumulator in
// registers; expf is the accurate one. At (192, 128) its tiles take 151.8 KB
// of shared memory.
//
// Route 2, bf16 (flash_attention_wgmma_kernel): the tensor cores. One
// block per (b, h, tile of BQ = 128 queries): two consumer warpgroups of 64
// query rows each and one producer warp.
// - Loads. The producer's one thread loads the block's q tile once and
//   then streams the KV tiles (BK = 64 keys) with TMA
//   (cp.async.bulk.tensor over 4-D tensor maps of the model layout
//   (d, H, S, B): no copy, GQA by the head coordinate, rows past Sq or Skv
//   zero-filled) into a ring of STAGES = 4 shared-memory stages, each
//   completed on an mbarrier; the consumers release a stage on a second
//   mbarrier, so later tiles are in flight while one computes.
// - Products. A consumer warpgroup forms S = Q K^T with wgmma (both
//   operands in shared memory, f32 accumulators), runs the online softmax
//   in the accumulator's registers (a row's max and sum reduce over the 4
//   lanes that hold it; exp2f with the scale folded into log2 units), and
//   adds P V with wgmma (A from registers: the accumulator fragment is
//   wgmma's A-operand fragment; V in shared memory read N-major through
//   the transpose bit). The two warpgroups run out of step, so one's
//   softmax overlaps the other's products.
// - P in two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), two wgmmas a
//   step. P rounded to one bf16 (2^-9 relative) put errors of 0.25 on the
//   Phi-3 serve path's outputs (|o| to 55), beyond the bf16 tolerance
//   against the f32 plain version; the pair carries about 16 bits. It
//   costs half again the tensor-core work (S, P V hi, P V lo), no bytes.
// - Head dims that are not a multiple of 64 are kept in column panels of
//   64, 32 and 16 (96 = 64 + 32, 80 = 64 + 16), each with its own tensor
//   map, swizzle (128, 64, 32 bytes) and wgmma descriptors: nothing is
//   padded. q and k take d's panels, v and o d_v's, each operand's maps
//   with its own row stride. At (192, 128) Q K^T is 12 k16 steps over three
//   64-column panels and P V writes 128 columns; the q tile is 48 KB and a
//   stage 40 KB (K 24, V 16), so four stages take 208 KB of the 227.
// - Masks. Tiles wholly above the diagonal or before the window are never
//   loaded, a warpgroup skips the tiles that are masked for all of its
//   rows, and only tiles that cross the diagonal, the window edge or Skv
//   are masked. Blocks of the longest (bottom) query tiles launch first,
//   so the causal tail does not leave SMs idle.
// - The output is divided by l, rounded to bf16 and stored from
//   registers.

#include <cuda.h>           // CUtensorMap and its enums: types only, no link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------- route 1 --

constexpr int F_BQ = 64;           // query rows per block
constexpr int F_BK = 64;           // keys per KV tile
constexpr int F_THREADS = 128;
constexpr int F_RI = F_BQ / 8;     // rows per thread (8)
constexpr int F_CJ = F_BK / 16;    // score columns per thread (4)
constexpr int P_STRIDE = F_BK + 16;  // row ty and ty + 1 on other banks

template <int DQK, int DV>
constexpr size_t f32_smem_bytes() {
  // sQ [BQ][DQK], sK [BK][DQK + 1], sV [BK][DV], sP [BQ][P_STRIDE], all f32
  return sizeof(float) * (F_BQ * DQK + F_BK * (DQK + 1) + F_BK * DV +
                          F_BQ * P_STRIDE);
}

// Thread (tx, ty) = (t % 16, t / 16) owns rows ty + 8i (i < 8); it computes
// the scores of columns tx + 16j (j < 4), and the output columns tx + 16jj
// (jj < DV/16), so each row's max and sum reduce over one half-warp.
template <int DQK, int DV>
__global__ void __launch_bounds__(F_THREADS) flash_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int Hq, int Hkv,
    int Sq, int Skv, int causal, int window, int q_offset, float scale) {
  constexpr int NJ = DV / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                         // [BQ][DQK]
  float* sK = sQ + F_BQ * DQK;              // [BK][DQK + 1]
  float* sV = sK + F_BK * (DQK + 1);        // [BK][DV]
  float* sP = sV + F_BK * DV;               // [BQ][P_STRIDE]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.y * F_BQ;

  // q rows of this block, pre-scaled; rows past Sq read as zero
  for (int e = tid; e < F_BQ * DQK; e += F_THREADS) {
    const int r = e / DQK, c = e % DQK;
    const int gr = q0 + r;
    sQ[e] = gr < Sq ? q[(((size_t)b * Sq + gr) * Hq + h) * DQK + c] * scale
                    : 0.f;
  }

  // the KV tiles holding a visible key for some row of the block
  const int last_row = min(q0 + F_BQ, Sq) - 1;
  const int k_end = causal ? min(Skv, q_offset + last_row + 1) : Skv;
  int k_begin = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  k_begin = (k_begin / F_BK) * F_BK;

  float m[F_RI], l[F_RI], acc[F_RI][NJ];
#pragma unroll
  for (int i = 0; i < F_RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.f;
  }

  for (int kt = k_begin; kt < k_end; kt += F_BK) {
    __syncthreads();   // the previous tile's sK, sV, sP are no longer read
    for (int e = tid; e < F_BK * DQK; e += F_THREADS) {
      const int r = e / DQK, c = e % DQK;
      const int gk = kt + r;
      sK[r * (DQK + 1) + c] =
          gk < Skv ? k[(((size_t)b * Skv + gk) * Hkv + hk) * DQK + c] : 0.f;
    }
    for (int e = tid; e < F_BK * DV; e += F_THREADS) {
      const int r = e / DV, c = e % DV;
      const int gk = kt + r;
      sV[e] = gk < Skv ? v[(((size_t)b * Skv + gk) * Hkv + hk) * DV + c] : 0.f;
    }
    __syncthreads();

    float s[F_RI][F_CJ];
#pragma unroll
    for (int i = 0; i < F_RI; ++i)
#pragma unroll
      for (int j = 0; j < F_CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DQK; ++c) {
      float qv[F_RI], kv[F_CJ];
#pragma unroll
      for (int i = 0; i < F_RI; ++i) qv[i] = sQ[(ty + 8 * i) * DQK + c];
#pragma unroll
      for (int j = 0; j < F_CJ; ++j) kv[j] = sK[(tx + 16 * j) * (DQK + 1) + c];
#pragma unroll
      for (int i = 0; i < F_RI; ++i)
#pragma unroll
        for (int j = 0; j < F_CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < F_RI; ++i) {
      const int qpos = q_offset + q0 + ty + 8 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < F_CJ; ++j) {
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
      for (int j = 0; j < F_CJ; ++j) {
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
    for (int kk = 0; kk < F_BK; ++kk) {
      float vv[NJ];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) vv[jj] = sV[kk * DV + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < F_RI; ++i) {
        const float p = sP[(ty + 8 * i) * P_STRIDE + kk];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          acc[i][jj] = fmaf(p, vv[jj], acc[i][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < F_RI; ++i) {
    const int gr = q0 + ty + 8 * i;
    if (gr >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = o + (((size_t)b * Sq + gr) * Hq + h) * DV;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) orow[tx + 16 * jj] = acc[i][jj] * inv;
  }
}

template <int DQK, int DV>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int Hq, int Hkv, int Sq, int Skv, int causal, int window,
               int q_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<DQK, DV>();
  // above 48 KB of shared memory only after opting in (per device, so on
  // every launch: it is a host-side attribute write)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32_kernel<DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((Sq + F_BQ - 1) / F_BQ > 65535) return cudaErrorInvalidValue;
  const dim3 grid(B * Hq, (Sq + F_BQ - 1) / F_BQ);
  flash_attention_f32_kernel<DQK, DV><<<grid, F_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hq, Hkv, Sq, Skv,
      causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- route 2 --

constexpr int BQ = 128;                 // query rows per block
constexpr int BK = 64;                  // keys per KV tile: S is m64n64
constexpr int STAGES = 4;               // KV ring depth
constexpr int CONSUMERS = 256;          // two warpgroups of 64 query rows
constexpr int THREADS = CONSUMERS + 32; // and one producer warp
constexpr float LOG2E = 1.4426950408889634f;

// The head dim in column panels: D / 64 panels of 64, then one of 32 and
// one of 16 as D % 64 needs. Panel kinds index the tensor maps.
enum PanelKind { P64 = 0, P32 = 1, P16 = 2 };

template <int D>
struct Panels {
  static constexpr int N64 = D / 64;
  static constexpr bool HAS32 = (D % 64) >= 32;
  static constexpr bool HAS16 = (D % 32) == 16;
  static constexpr int COUNT = N64 + (HAS32 ? 1 : 0) + (HAS16 ? 1 : 0);
  __host__ __device__ static constexpr int kind(int p) {
    return p < N64 ? P64 : (p == N64 && HAS32) ? P32 : P16;
  }
  __host__ __device__ static constexpr int width(int p) {
    return kind(p) == P64 ? 64 : kind(p) == P32 ? 32 : 16;
  }
  __host__ __device__ static constexpr int col(int p) {   // first column
    return p < N64 ? 64 * p : (p == N64 ? 64 * N64 : 64 * N64 + 32);
  }
};

// wgmma shared-memory descriptor layout types for 128-, 64- and 32-byte
// swizzles (one panel row is 2 * width bytes, one swizzle span)
__host__ __device__ constexpr int layout_type(int kind) {
  return kind == P64 ? 1 : kind == P32 ? 2 : 3;
}

// One tensor map for each operand (q, k, v) and panel kind: 4-D over the
// model layout (d, H, S, B), box (width, 1, rows, 1).
struct TensorMaps {
  CUtensorMap m[3][3];
};

// ------------------------------------------------------------ primitives --

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the barrier completes the phase of this parity. A wait that
// has not completed after 2^35 clock cycles (about 20 s) traps, so a fault
// in the load protocol ends the launch with an error, not a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 35)) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// a wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle layout type
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Registers a wgmma writes asynchronously are read only after the wait: an
// empty asm that takes each one in and out keeps the compiler from moving
// a read of it above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a pair of f32 values as two bf16 pairs whose sum carries about 16 bits:
// hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// d (m64n64, f32) = [d +] A B: A and B in shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0, 32) (m64n64, f32) += A B: A from registers (bf16 pairs), B in
// shared memory MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float* d,
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0, 16) (m64n32, f32) += A B: A from registers (bf16 pairs), B in
// shared memory MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n32(float* d,
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0, 8) (m64n16, f32) += A B: A from registers (bf16 pairs), B in
// shared memory MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n16(float* d,
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int W>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (W == 64) {
    wgmma_rs_n64(d, a, db);
  } else if constexpr (W == 32) {
    wgmma_rs_n32(d, a, db);
  } else {
    wgmma_rs_n16(d, a, db);
  }
}

// ---------------------------------------------------------- route 2 body --

template <int DQK, int DV>
constexpr size_t wgmma_smem_bytes() {
  // q tile, STAGES x (K tile, V tile), 2 STAGES + 1 mbarriers, and the slack
  // that aligns the base to the 128-byte swizzle's 1024-byte span. Every
  // tile and panel offset is a multiple of 1024 bytes (a tile is 128 or 256
  // bytes a head-dim column, a panel of 64 columns starts 64 columns in).
  return size_t(BQ) * DQK * 2 + size_t(STAGES) * BK * (DQK + DV) * 2 +
         8 * (2 * STAGES + 1) + 1024;
}

template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ TensorMaps maps, __nv_bfloat16* __restrict__ o,
    int Hq, int Hkv, int Sq, int Skv, int causal, int window, int q_offset,
    float scale_log2, int n_qt) {
  using PK = Panels<DQK>;   // the q and k head dim's panels
  using PV = Panels<DV>;    // the v (and o) head dim's panels
  constexpr uint32_t Q_BYTES = BQ * DQK * 2;
  constexpr uint32_t K_BYTES = BK * DQK * 2;          // one K tile
  constexpr uint32_t V_BYTES = BK * DV * 2;           // one V tile
  constexpr uint32_t STAGE_BYTES = K_BYTES + V_BYTES;  // K, then V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + Q_BYTES;
  const uint32_t bars = sKV + STAGES * STAGE_BYTES;
  const uint32_t qbar = bars + 16u * STAGES;
  // full[s] at bars + 8 s (the producer's TMA bytes); empty[s] at
  // bars + 8 (STAGES + s) (every consumer thread's release)

  // longest query tiles first: block x runs tile n_qt - 1 - x / (B Hq)
  const int BH = gridDim.x / n_qt;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;

  // the KV tiles holding a visible key for some row of the block
  const int last_row = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Skv, q_offset + last_row + 1) : Skv;
  int k_begin = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8u * s, 1);
      mbar_init(bars + 8u * (STAGES + s), CONSUMERS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: one thread issues every copy ----
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(qbar, Q_BYTES);
#pragma unroll
      for (int p = 0; p < PK::COUNT; ++p)
        tma_load(sQ + BQ * PK::col(p) * 2, &maps.m[0][PK::kind(p)], qbar,
                 PK::col(p), h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        // the stage's previous tile (i - STAGES) has been released
        if (i >= STAGES) {
          mbar_wait(bars + 8u * (STAGES + s), ((i / STAGES) + 1) & 1);
        }
        const uint32_t full = bars + 8u * s;
        mbar_expect_tx(full, STAGE_BYTES);
        const int kt = k_begin + i * BK;
        const uint32_t sk = sKV + s * STAGE_BYTES, sv = sk + K_BYTES;
#pragma unroll
        for (int p = 0; p < PK::COUNT; ++p)
          tma_load(sk + BK * PK::col(p) * 2, &maps.m[1][PK::kind(p)], full,
                   PK::col(p), hk, kt, b);
#pragma unroll
        for (int p = 0; p < PV::COUNT; ++p)
          tma_load(sv + BK * PV::col(p) * 2, &maps.m[2][PV::kind(p)], full,
                   PV::col(p), hk, kt, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns block rows [64 wg, 64 wg + 64) ----
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int quad = lane % 4;
  // this thread's two rows of every accumulator fragment: row0, row0 + 8
  const int row0 = wg * 64 + ((threadIdx.x % 128) / 32) * 16 + lane / 4;
  const int wg_rows = min(64, Sq - (q0 + wg * 64));
  const int qlo = q_offset + q0 + wg * 64;   // first and last position
  const int qhi = qlo + wg_rows - 1;         // of the warpgroup's rows

  // o accumulator, fragment layout: o_acc[4 j + 2 i + c] is row row0 + 8 i,
  // column 8 j + 2 quad + c; v panel p is o_acc[PV::col(p) / 2, ...)
  float o_acc[DV / 2];
#pragma unroll
  for (int r = 0; r < DV / 2; ++r) o_acc[r] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};   // this thread's share; the quad sums it

  mbar_wait(qbar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const int kt = k_begin + i * BK;
    mbar_wait(bars + 8u * s, (i / STAGES) & 1);
    const bool active = wg_rows > 0 && (!causal || kt <= qhi) &&
                        (window <= 0 || kt + BK - 1 > qlo - window);
    if (active) {
      const uint32_t sk = sKV + s * STAGE_BYTES, sv = sk + K_BYTES;
      // S = Q K^T over the q/k head dim's panels, 16 columns a wgmma
      float s_acc[BK / 2];
#pragma unroll
      for (int r = 0; r < BK / 2; ++r) s_acc[r] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < PK::COUNT; ++p) {
        const uint32_t rb = 2 * PK::width(p);   // panel row bytes
        const int lt = layout_type(PK::kind(p));
        const uint32_t qa = sQ + BQ * PK::col(p) * 2 + wg * 64 * rb;
        const uint32_t ka = sk + BK * PK::col(p) * 2;
#pragma unroll
        for (int ks = 0; ks < PK::width(p) / 16; ++ks)
          wgmma_ss_n64(s_acc, make_desc(qa + 32 * ks, 16, 8 * rb, lt),
                       make_desc(ka + 32 * ks, 16, 8 * rb, lt), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s_acc);

      // online softmax in log2 units on the fragment: s_acc[4 j + 2 i + c]
      // is row row0 + 8 i, key kt + 8 j + 2 quad + c
      const bool need_mask = kt + BK > Skv || (causal && kt + BK - 1 > qlo) ||
                             (window > 0 && kt <= qhi - window);
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const int qpos = q_offset + q0 + row0 + 8 * i2;
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float x = s_acc[4 * j + 2 * i2 + c] * scale_log2;
            if (need_mask) {
              const int kpos = kt + 8 * j + 2 * quad + c;
              bool visible = kpos < Skv;
              if (causal) visible = visible && kpos <= qpos;
              if (window > 0) visible = visible && kpos > qpos - window;
              if (!visible) x = NEG_INF;
            }
            s_acc[4 * j + 2 * i2 + c] = x;
            mx = fmaxf(mx, x);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[i2], mx);
        const float alpha = exp2f(m_run[i2] - m_new);
        m_run[i2] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = exp2f(s_acc[4 * j + 2 * i2 + c] - m_new);
            s_acc[4 * j + 2 * i2 + c] = p;
            sum += p;
          }
        }
        l_run[i2] = l_run[i2] * alpha + sum;
#pragma unroll
        for (int j = 0; j < DV / 8; ++j) {
          o_acc[4 * j + 2 * i2] *= alpha;
          o_acc[4 * j + 2 * i2 + 1] *= alpha;
        }
      }

      // P as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi): the
      // accumulator fragment of keys [16 ks, 16 ks + 16) is the register A
      // fragment of the ks-th k16 step of O += P V
      uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          split_bf16(s_acc[8 * ks + 2 * r], s_acc[8 * ks + 2 * r + 1],
                     p_hi[ks][r], p_lo[ks][r]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
#pragma unroll
        for (int p = 0; p < PV::COUNT; ++p) {
          const uint32_t rb = 2 * PV::width(p);
          const int lt = layout_type(PV::kind(p));
          // V panel p, key rows [16 ks, 16 ks + 16): N-major (d contiguous),
          // 8-key groups rb * 8 bytes apart
          const uint64_t vd = make_desc(sv + BK * PV::col(p) * 2 + 16 * ks * rb,
                                        BK * rb, 8 * rb, lt);
          float* op = o_acc + PV::col(p) / 2;
          if (PV::kind(p) == P64) {
            wgmma_rs<64>(op, p_hi[ks], vd);
            wgmma_rs<64>(op, p_lo[ks], vd);
          } else if (PV::kind(p) == P32) {
            wgmma_rs<32>(op, p_hi[ks], vd);
            wgmma_rs<32>(op, p_lo[ks], vd);
          } else {
            wgmma_rs<16>(op, p_hi[ks], vd);
            wgmma_rs<16>(op, p_lo[ks], vd);
          }
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o_acc);
    }
    mbar_arrive(bars + 8u * (STAGES + s));   // release the stage
  }

  // epilogue: o = acc / max(l, 1e-30) in bf16, rows past Sq not stored
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    float l = l_run[i2];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int gr = q0 + row0 + 8 * i2;
    if (gr < Sq) {
      __nv_bfloat16* orow = o + (((size_t)b * Sq + gr) * Hq + h) * DV;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * quad) =
            pack_bf16(o_acc[4 * j + 2 * i2] * inv,
                      o_acc[4 * j + 2 * i2 + 1] * inv);
    }
  }
}

// ------------------------------------------------------------ route 2 host --

// cuTensorMapEncodeTiled through the entry point the CUDA runtime hands
// out: the library links no libcuda of its own
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A (d, H, S, B) bf16 tensor read in boxes of (width, 1, rows, 1), swizzled
// by the panel row's own bytes; boxes past S read as zero.
bool encode_map(CUtensorMap* map, const void* ptr, int width, int D, int H,
                int S, int B, int rows) {
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(S),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(D) * 2, cuuint64_t(H) * D * 2,
                                 cuuint64_t(S) * H * D * 2};
  const cuuint32_t box[4] = {cuuint32_t(width), 1, cuuint32_t(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      width == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
      : width == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the tensor maps of one operand: one for each panel kind of its head dim
template <int D>
bool encode_operand(CUtensorMap (&maps)[3], const void* ptr, int H, int S,
                    int B, int rows) {
  using PN = Panels<D>;
  for (int p = 0; p < PN::COUNT; ++p) {
    if (!encode_map(&maps[PN::kind(p)], ptr, PN::width(p), D, H, S, B, rows))
      return false;
  }
  return true;
}

template <int DQK, int DV>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int Hq, int Hkv, int Sq, int Skv, int causal, int window,
                 int q_offset, float scale, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  TensorMaps maps = {};
  // v's maps take v's own head dim, so its row stride is 2 DV bytes
  if (!encode_operand<DQK>(maps.m[0], q, Hq, Sq, B, BQ) ||
      !encode_operand<DQK>(maps.m[1], k, Hkv, Skv, B, BK) ||
      !encode_operand<DV>(maps.m[2], v, Hkv, Skv, B, BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr size_t smem = wgmma_smem_bytes<DQK, DV>();
  static_assert(smem <= 232448, "over the 227 KB of shared memory a block "
                "can use");
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (Sq + BQ - 1) / BQ;
  if ((long long)n_qt * B * Hq > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  flash_attention_wgmma_kernel<DQK, DV>
      <<<n_qt * B * Hq, THREADS, smem, stream>>>(
      maps, static_cast<__nv_bfloat16*>(o), Hq, Hkv, Sq, Skv, causal, window,
      q_offset, scale * LOG2E, n_qt);
  return static_cast<int>(cudaGetLastError());
}

using Launch = int (*)(const void*, const void*, const void*, void*, int, int,
                       int, int, int, int, int, int, float, cudaStream_t);

template <int DQK, int DV>
struct F32Route {
  static constexpr Launch fn = launch_f32<DQK, DV>;
};
template <int DQK, int DV>
struct Bf16Route {
  static constexpr Launch fn = launch_wgmma<DQK, DV>;
};

// The (d_qk, d_v) pairs instantiated: one d for q, k and v in multiples of
// 16 up to 128, and MLA's 192 / 128 (DeepSeek-V3: a 128 + 64 nope/rope
// query and key, a 128 value). Any other pair is refused.
template <template <int, int> class Route>
Launch by_head_dims(int d, int dv) {
  if (d == 192 && dv == 128) return Route<192, 128>::fn;
  if (d != dv) return nullptr;
  switch (d) {
    case 16: return Route<16, 16>::fn;
    case 32: return Route<32, 32>::fn;
    case 48: return Route<48, 48>::fn;
    case 64: return Route<64, 64>::fn;
    case 80: return Route<80, 80>::fn;
    case 96: return Route<96, 96>::fn;
    case 112: return Route<112, 112>::fn;
    case 128: return Route<128, 128>::fn;
    default: return nullptr;
  }
}

}  // namespace

// dtype: 0 = float32 (route 1, CUDA cores), 1 = bfloat16 (route 2, tensor
// cores; q, k, v and o 16-byte aligned). d is q's and k's head dim, d_v v's
// and o's (a pair of by_head_dims). causal: 0 or 1; window: 0 = none.
// Launches on `stream` and returns cudaGetLastError() (0 on success); it
// neither allocates nor synchronises.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* o, int B, int Hq,
                                      int Hkv, int Sq, int Skv, int d, int d_v,
                                      int causal, int window, int q_offset,
                                      float scale, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Skv < 1 ||
      window < 0 || q_offset < 0 || (long long)B * Hq > 2147483647LL ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t any_bits = reinterpret_cast<uintptr_t>(q) |
                             reinterpret_cast<uintptr_t>(k) |
                             reinterpret_cast<uintptr_t>(v) |
                             reinterpret_cast<uintptr_t>(o);
  if (dtype == 1 && any_bits % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const Launch fn = dtype == 0 ? by_head_dims<F32Route>(d, d_v)
                                : by_head_dims<Bf16Route>(d, d_v);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, q_offset, scale,
            static_cast<cudaStream_t>(stream));
}
