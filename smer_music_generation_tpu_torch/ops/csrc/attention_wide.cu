// The attention kernels at every head_dim above 128, for Hopper (sm_90a):
// one forward kernel and one backward pair, each a template over the element
// type (bf16, f32) and a mask policy, over (B, T|S, H, D) tensors with D any
// multiple of 64 (the wrappers zero-pad a head_dim to one and keep the scale
// 1/sqrt(head_dim)).
//
// Replaces, where head_dim > 128 (attention.cu, train_attention.cu,
// flash_train.cu and attention_f32.cu are built for 64 and 128, and take
// every narrower head_dim zero-padded):
//   MODE 0: the TPU kernel `fused_attention`
//     (smer_music_generation_tpu/ops/attention.py:115, body `_attn_kernel`
//     :55; twin `attention_reference` :35): s = q . k scale in f32, -1e30
//     where the key is at or past kv_valid_len[b] (or past the row when
//     causal), a softmax over the S keys (a row with no valid key weighs
//     every key alike), o = sum p v / sum p; bf16 or f32.
//   MODE 1: the TPU kernel `fused_dropout_attention`
//     (smer_music_generation_tpu/ops/train_attention.py:316, `_fwd_kernel`
//     :111, `_bwd_kernel` :163): s = bf16(q . k) scale, -1e30 where the key is
//     invalid (or past the row), e = exp(s - max s) on valid keys and 0
//     elsewhere, w = e / max(sum e, 1e-30), wd = keep ? bf16(bf16(w) / c) : 0
//     with c = bf16(1 - rate) and keep the counter hash of dropout_hash.cuh at
//     the global (b0 + b, h0 + h), o = wd . v; backward dv = wd^T g, dw = keep ?
//     (g v^T) / c : 0, ds = bf16(w (dw - sum_s w dw) scale), dq = ds k, dk =
//     ds^T q; bf16 only, S <= 1024 (JAX's gate).
//   MODE 2: the library flash kernel behind `attend_flash_vjp`
//     (smer_music_generation_tpu/models/transformer.py:360; forward
//     jax/experimental/pallas/ops/tpu/flash_attention.py:758, dkv :1121, dq
//     :1456): s = q . k scale plus -0.7 f32max where the key is invalid (or
//     past the row), keys in blocks of 128 (a causal row visits the blocks at
//     or below its own), m stepping by block, o = sum cast(p) v / l, at S =
//     128 sum cast(p / l) v; each row's m and l saved; backward p = exp(s -
//     m) / l, dv = cast(p)^T g, ds = cast((g v^T - sum(o g)) p scale), dq = ds
//     k, dk = ds^T q; bf16 or f32, T and S multiples of 128.
//
// Design.  Shared memory and registers do not grow with head_dim, so no new
// ceiling replaces 128: a block owns 64 rows (query rows, or keys in the keys
// kernels) and one 128-column chunk of the output (grid.z walks the chunks),
// and walks the tiles of 128 columns (keys, or query rows in the keys
// kernels).  A tile's 64 x 128 scores are summed over head_dim in chunks of
// 64 staged in shared memory as f32 (score_tile); the row statistics live in
// registers, each row's sixteen threads reducing it by shuffles; the 64 x 128
// weights (or ds) go through shared memory into the block's output chunk,
// 64 rows of the other operand at a time (product_tile).  Each block
// recomputes the scores and row statistics its chunk needs, so a head_dim of
// 2 chunks does the score products twice.  Every product runs on the FMA
// pipes in f32 (bf16 operands are exact in f32), a 4 x 8 micro-tile a thread.
// Backward (FlashAttention-2's deterministic two-kernel order, no atomics):
//   wide_rows_kernel: dq of its chunk; MODE 1 also recomputes m, l and delta
//     = sum_s w dw (pass 1: m and l online, u = sum e dw rescaled with l,
//     delta = u / max(l, 1e-30)) and writes them to the (3, B*H, T) stats;
//     MODE 2 reads the forward's m and l and writes di = sum_d o g;
//   wide_keys_kernel: dk and dv of its chunk from those statistics.
// What bounds it on an NVIDIA H100 (67 TFLOP/s f32 on the FMA pipes, 3.35
// TB/s at 700 W): the operations; at B=8, H=2, T=S=640, head_dim 256, the
// forward's two products are 6.7 GFLOP (0.1 ms at the FMA pipes' peak), the
// backward's five 16.8 GFLOP.  The recomputed chunks and the shared-memory
// operands keep it well below that peak: a simple kernel that is right first
// (the tensor cores are left for a later change).
//
// The launchers have a plain C interface and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

using namespace dropout_hash;

constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16 owns rows 4 ty .. + 3, tx columns tx + 16 j
constexpr int kBR = 64;        // a block's rows
constexpr int kBC = 128;       // a tile's columns
constexpr int kDC = 64;        // the head_dim chunk of a score product
constexpr int kOC = 128;       // a block's output columns
constexpr int kLdA = kDC + 1;  // a staged chunk's padded row
constexpr int kLdS = kBC + 1;  // the weight tile's padded row
constexpr int kModeFused = 0, kModeDrop = 1, kModeFlash = 2;
constexpr int kMaxKeys = 1024;  // JAX's MAX_KLEN: the gate of the TPU dropout kernel, kept
constexpr float kMasked = -1e30f;
// the library's DEFAULT_MASK_VALUE, -0.7 * f32 max taken in double, then f32
constexpr float kMaskValue = (float)(-0.7 * 3.4028234663852886e38);
constexpr float kLog2e = 1.4426950408889634f;
// dynamic shared memory: the two staged chunks (reused as the product's 64 x
// 128 operand), the weight tile, a tile's per-column statistics and flags
constexpr int kStageFloats = (kBR + kBC) * kLdA;
constexpr size_t kSmem =
    sizeof(float) * ((size_t)kStageFloats + kBR * kLdS + 4 * kBC + kBR);
static_assert(kStageFloats >= 64 * kOC, "the product's operand fits the staging buffers");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

template <class T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// a weight cast to the inputs' dtype, as the library's p.astype(v.dtype)
template <class T>
__device__ __forceinline__ float cast(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float ex2(float x) { return exp2f(x * kLog2e); }

// the sum or max of a value over the 16 threads of one row (a half warp)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o, 16);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o, 16));
  return v;
}

// rows r0 .. r0 + N - 1 (zeros at and past `limit`) of a row-major matrix of
// row stride ld, head_dim columns d0 .. d0 + 63, into dst[N][kLdA] as f32
template <class T, int N>
__device__ __forceinline__ void stage_chunk(float* dst, const T* __restrict__ m, size_t ld, int r0,
                                            int limit, int d0) {
  for (int e = threadIdx.x; e < N * kDC; e += kThreads) {
    const int r = e / kDC, c = e % kDC, row = r0 + r;
    dst[r * kLdA + c] = row < limit ? to_f(m[(size_t)row * ld + d0 + c]) : 0.f;
  }
}

// acc[i][j] = the f32 sum over head_dim of A[ra + 4 ty + i] . B[rb + tx + 16 j]
// (rows at and past na, nb read as zeros), in chunks of 64 head_dims, each
// chunk's 64 products summed in order.  Opens with a block barrier, so the
// caller may rewrite what the block read before it.
template <class T>
__device__ __forceinline__ void score_tile(float (&acc)[4][8], const T* __restrict__ A, int ra,
                                           int na, const T* __restrict__ B, int rb, int nb,
                                           size_t ld, int D, float* sA, float* sB) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += kDC) {
    __syncthreads();
    stage_chunk<T, kBR>(sA, A, ld, ra, na, d0);
    stage_chunk<T, kBC>(sB, B, ld, rb, nb, d0);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kDC; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[(4 * ty + i) * kLdA + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = sB[(tx + 16 * j) * kLdA + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// acc[i][j] += sum_n P[4 ty + i][n] M[m0 + n][c0 + tx + 16 j] over the tile's
// 128 columns n, P the weight tile in shared memory, M's rows (zeros at and
// past mlimit, and past the chunk's ncols columns) staged 64 at a time.
// Opens with a block barrier, after the caller's writes to sP.
template <class T>
__device__ __forceinline__ void product_tile(float (&acc)[4][8], const float* sP,
                                             const T* __restrict__ M, int m0, int mlimit,
                                             size_t ld, int c0, int ncols, float* sM) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int h = 0; h < kBC; h += 64) {
    __syncthreads();
    for (int e = threadIdx.x; e < 64 * kOC; e += kThreads) {
      const int r = e / kOC, c = e % kOC, row = m0 + h + r;
      sM[r * kOC + c] = row < mlimit && c < ncols ? to_f(M[(size_t)row * ld + c0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int n = 0; n < 64; ++n) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sP[(4 * ty + i) * kLdS + h + n];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = sM[n * kOC + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// the block's output chunk: rows r0 + 4 ty + i below `limit`, columns c0 + tx +
// 16 j below c0 + ncols, each acc times `mul[i]`
template <class T>
__device__ __forceinline__ void store_chunk(T* __restrict__ out, size_t ld, int r0, int limit,
                                            int c0, int ncols, const float (&acc)[4][8],
                                            const float (&mul)[4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    if (row >= limit) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (tx + 16 * j < ncols) out[(size_t)row * ld + c0 + tx + 16 * j] = from_f<T>(acc[i][j] * mul[i]);
  }
}

struct WideArgs {
  const void *q, *k, *v, *g, *o;  // (B, T|S, H, D); g and o in the backward only
  const int* lens;                 // MODE 0: (B,) or null
  const int* valid;                // MODES 1, 2: (B, S), nonzero = attendable
  const int* seeds;                // MODE 1: (4,)
  float* stats;                    // MODE 1: (3, B*H, T) m, l, delta; MODE 2: (2, B*H, T) m, l
  float* di;                       // MODE 2 backward: (B*H, T)
  void *out, *dq, *dk, *dv;
  int B, T, S, H, D, b0, h0, Hg, causal, drop_on;
  unsigned int thr;
  float c, scale;
};

// the keep hash's seed words and threshold (MODE 1; the others draw none)
template <int MODE>
__device__ __forceinline__ Drop drop_of(const WideArgs& a) {
  if (MODE != kModeDrop) return Drop{0u, 0u, 0u, 0, 1.f};
  return make_drop(a.seeds, a.thr, a.drop_on, a.c);
}

// whether key `col` is attendable from query `row` (col < S)
template <int MODE>
__device__ __forceinline__ bool key_ok(const WideArgs& a, int b, int row, int col) {
  const bool ok = MODE == kModeFused ? (a.lens == nullptr || col < a.lens[b]) : a.valid[(size_t)b * a.S + col] != 0;
  return ok && (!a.causal || col <= row);
}

// ---------------------------------------------------------------------------
// forward: a block per (64 query rows, b * H + h, 128 output columns)
// ---------------------------------------------------------------------------
template <class T, int MODE>
__global__ void __launch_bounds__(kThreads, 1) wide_fwd_kernel(const WideArgs a) {
  extern __shared__ float smem[];
  float* sA = smem;
  float* sB = sA + kBR * kLdA;
  float* sP = smem + kStageFloats;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int t0 = blockIdx.x * kBR, bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int c0 = blockIdx.z * kOC, ncols = min(kOC, a.D - c0);
  const size_t ld = (size_t)a.H * a.D;
  const T* q = static_cast<const T*>(a.q) + ((size_t)b * a.T * a.H + h) * a.D;
  const T* k = static_cast<const T*>(a.k) + ((size_t)b * a.S * a.H + h) * a.D;
  const T* v = static_cast<const T*>(a.v) + ((size_t)b * a.S * a.H + h) * a.D;
  const Drop dr = drop_of<MODE>(a);
  const uint32_t bhg = MODE == kModeDrop ? global_bh(b, h, a.b0, a.h0, a.Hg) : 0u;
  // the key tiles a row block visits: MODE 2 causal, the 128-key blocks at
  // or below its own; MODE 1 causal, those with a key at or below its last row
  int k_end = a.S;
  if (a.causal && MODE == kModeFlash) k_end = min(a.S, (t0 / kBC + 1) * kBC);
  if (a.causal && MODE == kModeDrop) k_end = min(a.S, t0 + kBR);
  float m[4], l[4], acc_o[4][8], s[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MODE == kModeDrop ? kMasked : -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_o[i][j] = 0.f;
  }
  const bool one_block = MODE == kModeFlash && a.S == kBC;  // the library's one-step kernel
  // MODE 1 makes a first pass for m and l; the others a single online pass
  for (int pass = MODE == kModeDrop ? 0 : 1; pass < 2; ++pass) {
    for (int k0 = 0; k0 < k_end; k0 += kBC) {
      score_tile<T>(s, q, t0, a.T, k, k0, a.S, ld, a.D, sA, sB);
      float tmax[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = t0 + 4 * ty + i;
        tmax[i] = MODE == kModeDrop ? kMasked : -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = k0 + tx + 16 * j;
          float x = -INFINITY;  // MODE 0: a column past S takes no part
          if (col < a.S) {
            const bool ok = key_ok<MODE>(a, b, row, col);
            if (MODE == kModeFused) x = ok ? s[i][j] * a.scale : kMasked;
            if (MODE == kModeDrop) x = ok ? bf16r(s[i][j]) * a.scale : -INFINITY;
            if (MODE == kModeFlash) x = s[i][j] * a.scale + (ok ? 0.f : kMaskValue);
          }
          s[i][j] = x;
          tmax[i] = fmaxf(tmax[i], x);
        }
        tmax[i] = row_max(tmax[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (MODE == kModeDrop && pass == 1) {  // w from the whole row's m and l
          const int row = t0 + 4 * ty + i;
          const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = k0 + tx + 16 * j;
            const float e = s[i][j] == -INFINITY ? 0.f : ex2(s[i][j] - m[i]);
            const float w16 = bf16r(e / den);
            float wd = w16;
            if (dr.on) wd = keep_at(dr, bhg, row, col) ? bf16r(w16 / dr.c) : 0.f;
            sP[(4 * ty + i) * kLdS + tx + 16 * j] = wd;
          }
          continue;
        }
        const float m_new = fmaxf(m[i], tmax[i]);
        const float alpha = ex2(m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p = s[i][j] == -INFINITY ? 0.f : ex2(s[i][j] - m_new);
          sum += p;
          s[i][j] = p;
        }
        l[i] = l[i] * alpha + row_sum(sum);
        m[i] = m_new;
        if (MODE == kModeDrop) continue;  // pass 0: m and l only
#pragma unroll
        for (int j = 0; j < 8; ++j) acc_o[i][j] *= alpha;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          sP[(4 * ty + i) * kLdS + tx + 16 * j] =
              MODE == kModeFused ? s[i][j] : cast<T>(one_block ? s[i][j] / l[i] : s[i][j]);
      }
      if (MODE == kModeDrop && pass == 0) continue;
      product_tile<T>(acc_o, sP, v, k0, a.S, ld, c0, ncols, sA);
    }
  }
  float mul[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (MODE == kModeFused) mul[i] = 1.f / l[i];
    if (MODE == kModeDrop || one_block) mul[i] = 1.f;
    if (MODE == kModeFlash && !one_block) mul[i] = 1.f / l[i];
  }
  T* out = static_cast<T*>(a.out) + ((size_t)b * a.T * a.H + h) * a.D;
  store_chunk<T>(out, ld, t0, a.T, c0, ncols, acc_o, mul);
  if (MODE == kModeFlash && blockIdx.z == 0 && tx == 0) {
    const size_t n = (size_t)a.B * a.H * a.T;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = t0 + 4 * ty + i;
      if (row < a.T) {
        a.stats[(size_t)bh * a.T + row] = m[i];
        a.stats[n + (size_t)bh * a.T + row] = l[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward, rows: a block per (64 query rows, b * H + h, 128 columns of dq)
// ---------------------------------------------------------------------------
template <class T, int MODE>
__global__ void __launch_bounds__(kThreads, 1) wide_rows_kernel(const WideArgs a) {
  extern __shared__ float smem[];
  float* sA = smem;
  float* sB = sA + kBR * kLdA;
  float* sP = smem + kStageFloats;
  float* sDi = sP + kBR * kLdS + 4 * kBC;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4, lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * kBR, bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int c0 = blockIdx.z * kOC, ncols = min(kOC, a.D - c0);
  const size_t ld = (size_t)a.H * a.D;
  const size_t qo = ((size_t)b * a.T * a.H + h) * a.D, ko = ((size_t)b * a.S * a.H + h) * a.D;
  const T* q = static_cast<const T*>(a.q) + qo;
  const T* g = static_cast<const T*>(a.g) + qo;
  const T* k = static_cast<const T*>(a.k) + ko;
  const T* v = static_cast<const T*>(a.v) + ko;
  const Drop dr = drop_of<MODE>(a);
  const uint32_t bhg = MODE == kModeDrop ? global_bh(b, h, a.b0, a.h0, a.Hg) : 0u;
  const size_t n = (size_t)a.B * a.H * a.T;
  int k_end = a.S;
  if (a.causal && MODE == kModeFlash) k_end = min(a.S, (t0 / kBC + 1) * kBC);
  if (a.causal && MODE == kModeDrop) k_end = min(a.S, t0 + kBR);
  float m[4], l[4], dl[4], s[4][8], dp[4][8], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  if (MODE == kModeFlash) {
    // di = sum_d o g per row, a warp a row; m and l from the forward
    const T* o = static_cast<const T*>(a.o) + qo;
    for (int r = warp; r < kBR; r += kThreads / 32) {
      const int row = t0 + r;
      float x = 0.f;
      if (row < a.T)
        for (int d = lane; d < a.D; d += 32)
          x = fmaf(to_f(o[(size_t)row * ld + d]), to_f(g[(size_t)row * ld + d]), x);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      if (lane == 0) {
        sDi[r] = x;
        if (blockIdx.z == 0 && row < a.T) a.di[(size_t)bh * a.T + row] = x;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = min(t0 + 4 * ty + i, a.T - 1);
      m[i] = a.stats[(size_t)bh * a.T + row];
      l[i] = 1.f / a.stats[n + (size_t)bh * a.T + row];  // the twin's p = exp(s - m) (1 / l)
      dl[i] = sDi[4 * ty + i];
    }
  } else {
    // pass 1: m and l online, and u = sum e dw rescaled with them
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = kMasked;
      l[i] = 0.f;
      dl[i] = 0.f;
    }
    for (int k0 = 0; k0 < k_end; k0 += kBC) {
      score_tile<T>(s, q, t0, a.T, k, k0, a.S, ld, a.D, sA, sB);
      score_tile<T>(dp, g, t0, a.T, v, k0, a.S, ld, a.D, sA, sB);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = t0 + 4 * ty + i;
        float tmax = kMasked;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = k0 + tx + 16 * j;
          s[i][j] = col < a.S && key_ok<MODE>(a, b, row, col) ? bf16r(s[i][j]) * a.scale : -INFINITY;
          tmax = fmaxf(tmax, s[i][j]);
        }
        const float m_new = fmaxf(m[i], row_max(tmax));
        const float alpha = ex2(m[i] - m_new);
        float se = 0.f, su = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (s[i][j] == -INFINITY) continue;
          const int col = k0 + tx + 16 * j;
          const float e = ex2(s[i][j] - m_new);
          float dw = dp[i][j];
          if (dr.on) dw = keep_at(dr, bhg, row, col) ? dw / dr.c : 0.f;
          se += e;
          su = fmaf(e, dw, su);
        }
        l[i] = l[i] * alpha + row_sum(se);
        dl[i] = dl[i] * alpha + row_sum(su);
        m[i] = m_new;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dl[i] /= fmaxf(l[i], 1e-30f);  // delta = sum_s w dw
      const int row = t0 + 4 * ty + i;
      if (blockIdx.z == 0 && tx == 0 && row < a.T) {
        a.stats[(size_t)bh * a.T + row] = m[i];
        a.stats[n + (size_t)bh * a.T + row] = l[i];
        a.stats[2 * n + (size_t)bh * a.T + row] = dl[i];
      }
      l[i] = fmaxf(l[i], 1e-30f);
    }
  }
  // dq += ds K, ds from the recomputed scores and g v^T
  for (int k0 = 0; k0 < k_end; k0 += kBC) {
    score_tile<T>(s, q, t0, a.T, k, k0, a.S, ld, a.D, sA, sB);
    score_tile<T>(dp, g, t0, a.T, v, k0, a.S, ld, a.D, sA, sB);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = t0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + tx + 16 * j;
        float ds = 0.f;
        if (col < a.S && row < a.T) {
          const bool ok = key_ok<MODE>(a, b, row, col);
          if (MODE == kModeDrop) {
            if (ok) {
              const float w = ex2(bf16r(s[i][j]) * a.scale - m[i]) / l[i];
              float dw = dp[i][j];
              if (dr.on) dw = keep_at(dr, bhg, row, col) ? dw / dr.c : 0.f;
              ds = bf16r(w * (dw - dl[i]) * a.scale);
            }
          } else {
            const float p = ex2(s[i][j] * a.scale + (ok ? 0.f : kMaskValue) - m[i]) * l[i];
            ds = cast<T>((dp[i][j] - dl[i]) * p * a.scale);
          }
        }
        sP[(4 * ty + i) * kLdS + tx + 16 * j] = ds;
      }
    }
    product_tile<T>(acc, sP, k, k0, a.S, ld, c0, ncols, sA);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_chunk<T>(static_cast<T*>(a.dq) + qo, ld, t0, a.T, c0, ncols, acc, one);
}

// ---------------------------------------------------------------------------
// backward, keys: a block per (64 keys, b * H + h, 128 columns of dk and dv)
// ---------------------------------------------------------------------------
template <class T, int MODE>
__global__ void __launch_bounds__(kThreads, 1) wide_keys_kernel(const WideArgs a) {
  extern __shared__ float smem[];
  float* sA = smem;
  float* sB = sA + kBR * kLdA;
  float* sP = smem + kStageFloats;
  float* sm = sP + kBR * kLdS;  // a tile's rows: m, 1 / l (MODE 2) or max(l, 1e-30), delta or di
  float* sl = sm + kBC;
  float* sd = sl + kBC;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int s0 = blockIdx.x * kBR, bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int c0 = blockIdx.z * kOC, ncols = min(kOC, a.D - c0);
  const size_t ld = (size_t)a.H * a.D;
  const size_t qo = ((size_t)b * a.T * a.H + h) * a.D, ko = ((size_t)b * a.S * a.H + h) * a.D;
  const T* q = static_cast<const T*>(a.q) + qo;
  const T* g = static_cast<const T*>(a.g) + qo;
  const T* k = static_cast<const T*>(a.k) + ko;
  const T* v = static_cast<const T*>(a.v) + ko;
  const Drop dr = drop_of<MODE>(a);
  const uint32_t bhg = MODE == kModeDrop ? global_bh(b, h, a.b0, a.h0, a.Hg) : 0u;
  const size_t n = (size_t)a.B * a.H * a.T;
  float p[4][8], dp[4][8], dk[4][8], dv[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dk[i][j] = dv[i][j] = 0.f;
  // causal: the query tiles with a row at or past the block's first key
  // (MODE 2: the 128-row blocks at or past its key block)
  const int t_begin = a.causal ? (s0 / kBC) * kBC : 0;
  for (int t0 = t_begin; t0 < a.T; t0 += kBC) {
    for (int r = threadIdx.x; r < kBC; r += kThreads) {
      const int row = min(t0 + r, a.T - 1);
      const size_t at = (size_t)bh * a.T + row;
      sm[r] = a.stats[at];
      sl[r] = MODE == kModeFlash ? 1.f / a.stats[n + at] : fmaxf(a.stats[n + at], 1e-30f);
      sd[r] = MODE == kModeFlash ? a.di[at] : a.stats[2 * n + at];
    }
    score_tile<T>(p, k, s0, a.S, q, t0, a.T, ld, a.D, sA, sB);  // p[i][j]: key i, query row j
    uint32_t keep = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = s0 + 4 * ty + i;  // the key
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = tx + 16 * j, row = t0 + r;
        float x = 0.f, wd = 0.f;
        if (col < a.S && row < a.T) {
          const bool ok = key_ok<MODE>(a, b, row, col);
          if (MODE == kModeDrop) {
            if (ok) {
              x = ex2(bf16r(p[i][j]) * a.scale - sm[r]) / sl[r];
              const bool kp = !dr.on || keep_at(dr, bhg, row, col);
              keep |= (kp ? 1u : 0u) << (8 * i + j);
              const float w16 = bf16r(x);
              wd = dr.on ? (kp ? bf16r(w16 / dr.c) : 0.f) : w16;
            }
          } else {
            x = ex2(p[i][j] * a.scale + (ok ? 0.f : kMaskValue) - sm[r]) * sl[r];
            wd = cast<T>(x);
          }
        }
        p[i][j] = x;
        sP[(4 * ty + i) * kLdS + r] = wd;
      }
    }
    product_tile<T>(dv, sP, g, t0, a.T, ld, c0, ncols, sA);
    score_tile<T>(dp, v, s0, a.S, g, t0, a.T, ld, a.D, sA, sB);  // (g v^T)^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = tx + 16 * j;
        float ds;
        if (MODE == kModeDrop) {
          float dw = dp[i][j];
          if (dr.on) dw = (keep >> (8 * i + j) & 1u) ? dw / dr.c : 0.f;
          ds = p[i][j] == 0.f ? 0.f : bf16r(p[i][j] * (dw - sd[r]) * a.scale);
        } else {
          ds = t0 + r < a.T ? cast<T>((dp[i][j] - sd[r]) * p[i][j] * a.scale) : 0.f;
        }
        sP[(4 * ty + i) * kLdS + r] = ds;
      }
    }
    product_tile<T>(dk, sP, q, t0, a.T, ld, c0, ncols, sA);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_chunk<T>(static_cast<T*>(a.dk) + ko, ld, s0, a.S, c0, ncols, dk, one);
  store_chunk<T>(static_cast<T*>(a.dv) + ko, ld, s0, a.S, c0, ncols, dv, one);
}

template <class Kernel>
cudaError_t launch(Kernel kernel, const WideArgs& a, int rows, cudaStream_t st) {
  // set on every launch: the attribute is per device
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((rows + kBR - 1) / kBR, a.B * a.H, (a.D + kOC - 1) / kOC);
  kernel<<<grid, kThreads, kSmem, st>>>(a);
  return cudaGetLastError();
}

bool bad_args(int mode, int bf16, int B, int T, int S, int H, int D) {
  if (B < 1 || T < 1 || S < 1 || H < 1 || D < kDC || D % kDC || B * H > 65535) return true;
  if (mode == kModeDrop && (!bf16 || S > kMaxKeys)) return true;
  if (mode == kModeFlash && (T % kBC || S % kBC)) return true;
  return mode < kModeFused || mode > kModeFlash;
}

WideArgs make_args(int B, int T, int S, int H, int D, int b0, int h0, int Hg, const void* q,
                   const void* k, const void* v, const void* lens, const void* valid,
                   const void* seeds, unsigned int thr, int drop_on, float c, int causal,
                   float scale) {
  WideArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.lens = static_cast<const int*>(lens);
  a.valid = static_cast<const int*>(valid);
  a.seeds = static_cast<const int*>(seeds);
  a.B = B;
  a.T = T;
  a.S = S;
  a.H = H;
  a.D = D;
  a.b0 = b0;
  a.h0 = h0;
  a.Hg = Hg;
  a.causal = causal;
  a.drop_on = drop_on;
  a.thr = thr;
  a.c = c;
  a.scale = scale;
  return a;
}

}  // namespace

extern "C" {

// The forward at head_dim D (a multiple of 64): q (B, T, H, D), k and v (B,
// S, H, D), out (B, T, H, D), contiguous, bf16 (bf16 = 1) or f32.  mode 0:
// lens (B,) int32 or null; mode 1 (bf16): valid (B, S) int32, seeds (4,) int32,
// thr the keep threshold, drop_on = rate > 0, c = bf16(1 - rate), the keep
// hash at the global (b0 + b, h0 + h) of Hg heads; mode 2: valid, and stats
// (2, B*H, T) f32 written (m, l).  scale = 1 / sqrt(head_dim).
int smer_wide_attn_fwd(int mode, int bf16, int B, int T, int S, int H, int D, int b0, int h0,
                       int Hg, const void* q, const void* k, const void* v, const void* lens,
                       const void* valid, const void* seeds, unsigned int thr, int drop_on,
                       float c, int causal, float scale, void* out, void* stats, void* stream) {
  if (bad_args(mode, bf16, B, T, S, H, D) || (mode != kModeFused && valid == nullptr) ||
      (mode == kModeDrop && seeds == nullptr) || (mode == kModeFlash && stats == nullptr))
    return (int)cudaErrorInvalidValue;
  WideArgs a = make_args(B, T, S, H, D, b0, h0, Hg, q, k, v, lens, valid, seeds, thr, drop_on, c,
                         causal, scale);
  a.out = out;
  a.stats = static_cast<float*>(stats);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  switch (mode * 2 + bf16) {
    case 0: return (int)launch(wide_fwd_kernel<float, kModeFused>, a, T, st);
    case 1: return (int)launch(wide_fwd_kernel<bf, kModeFused>, a, T, st);
    case 3: return (int)launch(wide_fwd_kernel<bf, kModeDrop>, a, T, st);
    case 4: return (int)launch(wide_fwd_kernel<float, kModeFlash>, a, T, st);
    case 5: return (int)launch(wide_fwd_kernel<bf, kModeFlash>, a, T, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward pair of modes 1 and 2: g (B, T, H, D) in q's dtype; mode 1:
// stats a (3, B*H, T) f32 scratch (m, l, delta, written by the rows kernel);
// mode 2: o the forward's output, stats its (2, B*H, T) m and l, di a (B*H,
// T) f32 scratch; dq, dk, dv in the layouts of q, k, v.
int smer_wide_attn_bwd(int mode, int bf16, int B, int T, int S, int H, int D, int b0, int h0,
                       int Hg, const void* q, const void* k, const void* v, const void* valid,
                       const void* seeds, unsigned int thr, int drop_on, float c, int causal,
                       float scale, const void* o, const void* g, void* stats, void* di, void* dq,
                       void* dk, void* dv, void* stream) {
  if (mode == kModeFused || bad_args(mode, bf16, B, T, S, H, D) || valid == nullptr ||
      stats == nullptr || (mode == kModeDrop && seeds == nullptr) ||
      (mode == kModeFlash && (o == nullptr || di == nullptr)))
    return (int)cudaErrorInvalidValue;
  WideArgs a = make_args(B, T, S, H, D, b0, h0, Hg, q, k, v, nullptr, valid, seeds, thr, drop_on,
                         c, causal, scale);
  a.o = o;
  a.g = g;
  a.stats = static_cast<float*>(stats);
  a.di = static_cast<float*>(di);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  cudaError_t e;
  switch (mode * 2 + bf16) {
    case 3:
      e = launch(wide_rows_kernel<bf, kModeDrop>, a, T, st);
      return (int)(e != cudaSuccess ? e : launch(wide_keys_kernel<bf, kModeDrop>, a, S, st));
    case 4:
      e = launch(wide_rows_kernel<float, kModeFlash>, a, T, st);
      return (int)(e != cudaSuccess ? e : launch(wide_keys_kernel<float, kModeFlash>, a, S, st));
    case 5:
      e = launch(wide_rows_kernel<bf, kModeFlash>, a, T, st);
      return (int)(e != cudaSuccess ? e : launch(wide_keys_kernel<bf, kModeFlash>, a, S, st));
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
