// Attention in f32 for Hopper (sm_90a): the forward of `fused_attention`
// and the forward and recomputing backward of flash training attention,
// over (B, T|S, H, HD) f32 tensors, HD = 64 or 128.  Every product of the
// three kernels runs on the tensor cores in split TF32.
//
// Replaces, for f32 inputs, the same TPU kernels as attention.cu and
// flash_train.cu: `fused_attention` (smer_music_generation_tpu/ops/
// attention.py:115, body `_attn_kernel` :55) and the library flash kernel
// behind `attend_flash_vjp` (models/transformer.py:360; jax/experimental/
// pallas/ops/tpu/flash_attention.py, pallas_call :758 forward, :1121 dkv,
// :1456 dq).  Both run in the inputs' dtype in JAX, so in f32 every product
// and sum is f32 and nothing is rounded to bf16 (the library casts p and ds
// to the inputs' dtype: here no rounding).  The two forwards share one body,
// a template of the mask semantics:
//   MODE 0 (`fused_attention`): scores q . k scale, keys at or past
//     kv_valid_len[b] (and past the row when causal) at -inf, so their
//     weight is 0; a batch row with no valid key weighs all S keys alike;
//     out = o / max(l, 1e-30);
//   MODE 1 (flash training): scores q . k scale plus -0.7 * f32 max where
//     the key is invalid or, when causal, past the row (added, so a row
//     with no attendable key weighs its keys alike); a causal row of
//     128-block qb visits the key blocks kb <= qb only; out = o / l, each
//     row's m and l written for the backward.
// In both, p = exp2f((s - m) log2(e)), the difference taken first, as the
// bf16 kernels and the twins take it.
// The backward is the library's two kernels (FlashAttention-2's
// deterministic pair: no atomics, so a recompute gives the same bits):
// p = exp(s - m) / l, di = sum_d out g, dv = p^T g, ds = (g v^T - di) p
// scale, dq = ds k, dk = ds^T q, all in f32.
//
// Split TF32.  Every product is mma.sync m16n8k8 TF32 with f32 sums.  Each
// operand x is split as hi = x rounded to TF32 (nearest, ties away from
// zero) and lo = x - hi (exact in f32; the tensor cores read its top 19
// bits), and a k8 step adds lo_a hi_b, hi_a lo_b, hi_a hi_b to the
// accumulator in that order (lo_a lo_b dropped).  Every sum is one
// accumulator chain: the products over head_dim, and the forward's o, the
// backward's dq, dk, dv over all their keys or rows, tile after tile
// (scheme (a) of scripts/f32_tc_probe.py, whose readings on an H100 chose
// it: at most 4.5e-6 relative norm from float64 at the backward's five
// products; with --forward, at most 1.08e-5 and 0.12 of atol 2e-5 + rtol
// 1e-4 at the forward's cases, the 1536-key chain the worst; JAX's f32
// bounds are 1e-4 relative norm and that atol + rtol).  One TF32 pass reads
// ~3e-4: outside them.
//
// Tiles are f32 rows padded from HD to HD + 4 floats: a fragment's 32
// lanes then read 32 banks, both as rows (the A operands and X Y^T's B, by
// ldmatrix.x4, an f32 taken as two b16) and as columns (P Y's B, rows 2 t
// and 2 t + 1).  S = X Y^T leaves each row's scores in C fragments (lane
// 4 g + t: rows g, g + 8, columns 8 j + 2 t, 8 j + 2 t + 1); P and ds go
// from there to the next product's A fragments in registers, the k8
// chunk's columns taken in the order 0 2 4 6 1 3 5 7 (a0 = c0, a1 = c2, a2
// = c1, a3 = c3), the B fragment reading rows 2 t and 2 t + 1 to match.
// A block of 4 warps owns 64 rows of one (b, h) (query rows in the forward
// and dq, keys in dk/dv), 16 a warp, and walks its whole reduction: no
// atomics, and each output written once.
//
// The launchers have a plain C interface and return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_tiles.cuh"

namespace {

constexpr int kRows = 64;        // rows a block owns, 16 a warp
constexpr int kTcThreads = 128;  // 4 warps
constexpr int kBlk = 128;        // the library's block (MODE 1)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;
constexpr float kMaskValue = (float)(-0.7 * 3.4028234663852886e38);

template <int HD>
constexpr int kLdF = HD + 4;  // padded row of an f32 tile
template <int HD>
constexpr int kTileF = kRows * kLdF<HD>;

// x rounded to TF32, nearest with ties away from zero: cvt.rna.tf32.f32's
// bits for every finite x (half an ulp added to the magnitude, the low 13
// bits cut; scripts/f32_tc_probe.py holds the two equal on every finite f32
// value).  ptxas expands cvt.rna into four or five instructions with checks
// for inf and NaN; this is two.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi rounded to TF32 (nearest, ties away), lo the exact rest
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in split TF32: lo_a hi_b, hi_a lo_b, hi_a hi_b
__device__ __forceinline__ void mma_split(float c[4], const uint32_t ah[4], const uint32_t al[4],
                                          float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// c[j] = X Y^T over head_dim for a warp's 16 rows of X (row-major at X,
// stride kLdF) and rows 8 j .. 8 j + 7 of Y (the same layout), j < NB.
// The fragments come by ldmatrix.x4, each f32 taken as two b16: lane 4 g +
// t receives row g, float t of each 8 x 4-float matrix, the m16n8k8 TF32
// layout; one ldmatrix gives a k8 step's A fragment, one the B fragments of
// two n-blocks (4 and 2 scalar loads a lane).  Both operands are split at
// each use.
template <int HD, int NB>
__device__ __forceinline__ void xyt_tc(float (&c)[NB][4], const float* X, const float* Y,
                                       int lane) {
  static_assert(NB % 2 == 0, "an ldmatrix gives the B fragments of two n-blocks");
  constexpr int ld = kLdF<HD>;
#pragma unroll
  for (int j = 0; j < NB; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
  // the row this lane addresses: matrices (rows 0-7 | 8-15) x (floats 0-3 |
  // 4-7) in the A fragment's order a0 a1 a2 a3; for B, n-block j's b0 b1,
  // then n-block j + 1's
  const float* x = X + ((lane & 7) + (lane & 8)) * ld + ((lane >> 4) << 2);
  const float* y = Y + ((lane & 7) + ((lane >> 4) << 3)) * ld + (((lane >> 3) & 1) << 2);
#pragma unroll
  for (int kk = 0; kk < HD; kk += 8) {
    uint32_t a[4], ah[4], al[4];
    attn_tiles::ldsm_x4(a, reinterpret_cast<const __nv_bfloat16*>(x + kk));
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]), ah[i], al[i]);
#pragma unroll
    for (int j = 0; j < NB; j += 2) {
      uint32_t b[4];
      attn_tiles::ldsm_x4(b, reinterpret_cast<const __nv_bfloat16*>(y + 8 * j * ld + kk));
      mma_split(c[j], ah, al, __uint_as_float(b[0]), __uint_as_float(b[1]));
      mma_split(c[j + 1], ah, al, __uint_as_float(b[2]), __uint_as_float(b[3]));
    }
  }
}

// acc += P Y: P a warp's 16 x 8 NB tile in C fragments, Y 8 NB rows of HD
// (row-major, stride kLdF); chunk j's columns in the order 0 2 4 6 1 3 5 7
template <int HD, int NB>
__device__ __forceinline__ void pv_tc(float (&acc)[HD / 8][4], const float (&p)[NB][4],
                                      const float* Y, int gq, int tq) {
  constexpr int ld = kLdF<HD>;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    uint32_t ah[4], al[4];
    split_tf32(p[j][0], ah[0], al[0]);
    split_tf32(p[j][2], ah[1], al[1]);
    split_tf32(p[j][1], ah[2], al[2]);
    split_tf32(p[j][3], ah[3], al[3]);
    const float* y = Y + (8 * j + 2 * tq) * ld + gq;
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) mma_split(acc[nb], ah, al, y[8 * nb], y[ld + 8 * nb]);
  }
}

// rows p0 .. p0 + ROWS - 1 of one head of a (B, L, H, HD) f32 tensor into a
// shared tile (stride kLdF) by 16-byte cp.async, every thread taking part;
// with GUARD, rows at or past `limit` zero-filled
template <int HD, int ROWS, bool GUARD = false>
__device__ __forceinline__ void load_rows_async(float* dst, const float* base, size_t stride,
                                                int p0, int limit = 0) {
  constexpr int kChunks = HD / 4;
  static_assert(ROWS * kChunks % kTcThreads == 0, "every thread copies as many chunks");
#pragma unroll
  for (int u = 0; u < ROWS * kChunks / kTcThreads; ++u) {
    const int i = threadIdx.x + u * kTcThreads, r = i / kChunks, c = 4 * (i % kChunks);
    const bool ok = !GUARD || p0 + r < limit;
    attn_tiles::cp_async16(dst + r * kLdF<HD> + c, ok ? base + (size_t)(p0 + r) * stride + c : base,
                           ok);
  }
}

// a warp's 16 x HD accumulator (C fragments) to rows p0 + gq, p0 + gq + 8
template <int HD>
__device__ __forceinline__ void store_acc(float* base, size_t stride, const float (&acc)[HD / 8][4],
                                          int p0, int gq, int tq) {
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    float* row = base + (size_t)(p0 + gq + 8 * hi) * stride + 2 * tq;
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb)
      *reinterpret_cast<float2*>(row + 8 * nb) = make_float2(acc[nb][2 * hi], acc[nb][2 * hi + 1]);
  }
}

// ---------------------------------------------------------------------------
// forward: a block per (64 query rows, b * H + h).  Replaces, for f32
// inputs, `fused_attention`'s `_attn_kernel` (MODE 0) and the library flash
// kernel's forward pallas_call (flash_attention.py:758; MODE 1).  Q stays;
// K and V (and, MODE 1, the keys' validity) stream.  Products: S = Q K^T,
// o += P V.
//
// What bounds it on an H100: 2 products of 2 HD flops a (row, visited key)
// pair, three TF32 passes each: at 495 TFLOP/s of TF32 that is 165 TFLOP/s
// of split products (67 on the FMA pipes); B8 H8 640x640 head_dim 64 is 6.7
// GFLOP, 0.041 ms at 165 (0.100 on the FMA pipes).  The HMMA stream and the
// splits that feed it bound it, as they bound the pair (one TF32 pass alone
// takes half its time); device memory does not (42 MB, 0.013 ms).
//
// Order of work, per warp and tile of kFwdBT keys: S's k8 steps over
// head_dim in order into a zeroed accumulator; the scores scaled and masked
// in f32 (per MODE); each row's max over the tile by a quad shuffle, m_new =
// max(m, that), alpha = exp2f((m - m_new) log2e), p = exp2f((s - m_new)
// log2e), this lane's partial l = alpha l + (its p summed in order); o
// scaled by alpha, then P V's k8 chunks (8 keys each, in order) into o's one
// chain (the probe's scheme (a)).  At the end l is summed over the quad and
// out = o / l (MODE 0: max(l, 1e-30)).
//
// Q's A fragments are read from shared memory by ldmatrix and split at each
// use; K and V come through a two-stage cp.async ring of 32-key tiles, one
// __syncthreads a tile, and every warp splits the B fragments it reads.
// 128 (head_dim 64) and 190-193 registers (128), no spill: four and three
// blocks an SM at head_dim 64 (MODE 0, MODE 1; 52 KB of shared memory a
// block), two at 128 (101 KB).  scripts/flash_train_variants.py --f32 times
// the alternatives as edits of this source: Q split once into registers at
// head_dim 64 (168 registers, MODE 1 spills: 12% slower in MODE 1, 1-3%
// faster in MODE 0), the block splitting each tile once into hi and lo
// copies behind a second __syncthreads (the same bits, 15-35% slower; one
// block an SM at 128), each tile's P V apart (scheme (b): 157-237
// registers, within 2% of the time), 16- or 64-key tiles and other blocks
// an SM (0-4% slower).  Causal blocks run from the last rows first, the
// longest first.
// ---------------------------------------------------------------------------
template <int HD>
constexpr int kFwdBT = 32;  // keys a streamed tile
template <int HD>
constexpr int kFwdMinBlocks = HD == 64 ? 3 : 2;  // blocks an SM that the registers must allow
template <int HD>
constexpr int kFwdTile = kFwdBT<HD> * kLdF<HD>;  // floats of a streamed tile
template <int HD>
constexpr int kFwdStage = 2 * kFwdTile<HD>;  // a ring stage: K's tile, then V's
template <int HD>
constexpr size_t kFwdSmemF =
    (kTileF<HD> + 2 * kFwdStage<HD>) * sizeof(float) + 2 * kFwdBT<HD> * sizeof(int);

template <int HD, int MODE>
__global__ void __launch_bounds__(kTcThreads, kFwdMinBlocks<HD>)
    attn_f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ keys, int causal,
                        float scale, float* __restrict__ out, float* __restrict__ stats, int T,
                        int S, int H) {
  constexpr int BT = kFwdBT<HD>, NB = BT / 8;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;
  float* ring = qs + kTileF<HD>;  // stage st at ring + st kFwdStage: K tile, then V
  int* kok = reinterpret_cast<int*>(ring + 2 * kFwdStage<HD>);  // MODE 1: [stage][BT], validity
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int t0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kRows;
  const int r0 = 16 * warp;  // the warp's rows within the block
  const size_t stride = (size_t)H * HD;
  const size_t qofs = (size_t)b * T * stride + h * HD;
  const float* kb = k + (size_t)b * S * stride + h * HD;
  const float* vb = v + (size_t)b * S * stride + h * HD;

  // the keys the block visits, and (MODE 0) how the row's keys are masked
  int n_keys, n_valid = S;
  bool uniform = false, clip = false;
  if (MODE == 0) {
    n_valid = min(keys != nullptr ? keys[b] : S, S);
    uniform = n_valid <= 0;  // every key masked: all weigh alike
    clip = causal && !uniform;
    n_keys = clip ? min(n_valid, t0 + kRows) : (uniform ? S : n_valid);
  } else {
    n_keys = causal ? min((t0 / kBlk + 1) * kBlk, S) : S;
  }
  const int n_tiles = (n_keys + BT - 1) / BT;

  auto load_tile = [&](int it) {
    float* ks = ring + (it % 2) * kFwdStage<HD>;
    load_rows_async<HD, BT, MODE == 0>(ks, kb, stride, it * BT, S);
    load_rows_async<HD, BT, MODE == 0>(ks + kFwdTile<HD>, vb, stride, it * BT, S);
    if (MODE == 1 && threadIdx.x < BT)
      attn_tiles::cp_async4(kok + (it % 2) * BT + threadIdx.x,
                            keys + (size_t)b * S + it * BT + threadIdx.x, true);
  };
  load_rows_async<HD, kRows, MODE == 0>(qs, q + qofs, stride, t0, T);
  load_tile(0);
  attn_tiles::cp_async_commit();
  attn_tiles::cp_async_wait<0>();
  __syncthreads();

  float o[HD / 8][4];
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  float m[2], l[2];  // each row's running max; this lane's partial sum over its columns
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    m[hi] = MODE == 0 ? kMasked : -INFINITY;
    l[hi] = 0.f;
  }
  for (int it = 0; it < n_tiles; ++it) {
    attn_tiles::cp_async_wait<0>();
    __syncthreads();  // tile it is in; every warp is past tile it - 1, whose stage the next load takes
    if (it + 1 < n_tiles) {
      load_tile(it + 1);
      attn_tiles::cp_async_commit();
    }
    const float* ks = ring + (it % 2) * kFwdStage<HD>;
    const float* vs = ks + kFwdTile<HD>;
    const int* ok = kok + (it % 2) * BT;
    const int k0 = it * BT;
    float s[NB][4];
    xyt_tc<HD, NB>(s, qs + r0 * kLdF<HD>, ks, lane);
    float alpha[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = t0 + r0 + gq + 8 * hi;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 2 * hi; e < 2 * hi + 2; ++e) {
          const int c = 8 * j + 2 * tq + (e & 1), col = k0 + c;
          float x = s[j][e];
          if (MODE == 0) {
            const bool masked = col >= n_valid || (clip && col > row);
            x = col >= S || (masked && !uniform) ? -INFINITY : (uniform ? 0.f : x * scale);
          } else {
            const bool keep = ok[c] != 0 && !(causal && col > row);
            x = fmaf(x, scale, keep ? 0.f : kMaskValue);
          }
          s[j][e] = x;
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m[hi], attn_tiles::quad_max(mx));
      alpha[hi] = exp2f((m[hi] - m_new) * kLog2e);
      m[hi] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 2 * hi; e < 2 * hi + 2; ++e) {
          const float p = exp2f((s[j][e] - m_new) * kLog2e);
          s[j][e] = p;
          sum += p;
        }
      l[hi] = fmaf(alpha[hi], l[hi], sum);
    }
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nb][e] *= alpha[e >> 1];
    pv_tc<HD, NB>(o, s, vs, gq, tq);
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int r = t0 + r0 + gq + 8 * hi;
    l[hi] = attn_tiles::quad_sum(l[hi]);
    const float inv = 1.f / (MODE == 0 ? fmaxf(l[hi], 1e-30f) : l[hi]);
    if (r < T) {
      float* row = out + qofs + (size_t)r * stride + 2 * tq;
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb)
        *reinterpret_cast<float2*>(row + 8 * nb) =
            make_float2(o[nb][2 * hi] * inv, o[nb][2 * hi + 1] * inv);
    }
    if (MODE == 1 && tq == 0) {
      const size_t at = (size_t)bh * T + r, BHT = (size_t)gridDim.y * T;
      stats[at] = m[hi];
      stats[BHT + at] = l[hi];
    }
  }
}

// ---------------------------------------------------------------------------
// backward: the pair
// ---------------------------------------------------------------------------
// Each product as the forward's (split TF32, one chain).  The two resident
// operands of a block (Q and g, or K and V) sit in shared memory and the
// other two stream through a two-stage cp.async ring of kBT-row tiles: tile
// it + 1 is in flight while tile it's products run, one __syncthreads a
// tile.
//
// What bounds it on an H100: 5 products of 2 HD flops a (row, key) pair
// (7 with the recomputed S and dP), three TF32 passes each: at 165 TFLOP/s
// of split products B8 H8 640x640 head_dim 64 is 16.8 GFLOP, 0.102 ms.
// Each warp splits every B operand it reads (3 instructions a float), so
// the pair is bound by its HMMA stream and the splits that feed it, not by
// device memory.  The streamed tiles are 32 rows at head_dim 64 (70 KB of
// shared memory a block, registers capped at 168: three blocks an SM) and
// 16 at head_dim 128 (101 KB: two); scripts/flash_train_variants.py --f32
// times the other shapes.  The grid is (64-row blocks) x B H: 640 blocks at
// B8 H8 640x640, 1.6 waves of 396 slots at head_dim 64, 320 blocks and 1.2
// waves of 264 at head_dim 128 (H4).

template <int HD>
constexpr int kBT = HD == 64 ? 32 : 16;  // rows of a streamed tile
template <int HD>
constexpr int kStages = 2;  // streamed tiles in flight (1: loaded after the last is read)
template <int HD>
constexpr int kMinBlocks = HD == 64 ? 3 : 2;  // blocks an SM that the registers must allow
template <int HD>
constexpr int kTileT = kBT<HD> * kLdF<HD>;  // floats of a streamed tile

// ---------------------------------------------------------------------------
// backward, dq: a block per (64 query rows, b * H + h); writes di for dk/dv.
// Replaces, for f32 inputs, the library flash kernel's dq pallas_call
// (jax/experimental/pallas/ops/tpu/flash_attention.py:1456).  Q and g stay
// in shared memory; K and V (and the keys' validity) stream.  Products: S =
// Q K^T, dP = g V^T, dq += ds K.
// ---------------------------------------------------------------------------
template <int HD>
constexpr size_t kDqSmemF =
    (2 * kTileF<HD> + 2 * kStages<HD> * kTileT<HD>) * sizeof(float) + kStages<HD> * kBT<HD> * sizeof(int);

template <int HD>
__global__ void __launch_bounds__(kTcThreads, kMinBlocks<HD>)
    flash_train_f32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const int* __restrict__ valid,
                              const float* __restrict__ out, const float* __restrict__ stats,
                              const float* __restrict__ g, int causal, float scale,
                              float* __restrict__ di_out, float* __restrict__ dq, int T, int S,
                              int H) {
  constexpr int BT = kBT<HD>, NB = BT / 8;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;
  float* gs = qs + kTileF<HD>;
  float* ring = gs + kTileF<HD>;  // stage st: K tile at ring + 2 st kTileT, V after it
  int* kok = reinterpret_cast<int*>(ring + 2 * kStages<HD> * kTileT<HD>);  // [stage][BT]: validity
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int t0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kRows;
  const int r0 = 16 * warp;  // the warp's rows within the block
  const size_t stride = (size_t)H * HD;
  const size_t qofs = (size_t)b * T * stride + h * HD;
  const float* kb = k + (size_t)b * S * stride + h * HD;
  const float* vb = v + (size_t)b * S * stride + h * HD;
  const int* vl = valid + (size_t)b * S;
  const int n_tiles = (causal ? min((t0 / kBlk + 1) * kBlk, S) : S) / BT;
  const size_t BHT = (size_t)gridDim.y * T;

  auto load_tile = [&](int it) {
    float* ks = ring + 2 * (it % kStages<HD>) * kTileT<HD>;
    load_rows_async<HD, BT>(ks, kb, stride, it * BT);
    load_rows_async<HD, BT>(ks + kTileT<HD>, vb, stride, it * BT);
    if (threadIdx.x < BT)
      attn_tiles::cp_async4(kok + (it % kStages<HD>) * BT + threadIdx.x, vl + it * BT + threadIdx.x,
                            true);
  };
  load_rows_async<HD, kRows>(qs, q + qofs, stride, t0);
  load_rows_async<HD, kRows>(gs, g + qofs, stride, t0);
  load_tile(0);
  attn_tiles::cp_async_commit();

  // di = sum_d out g of the warp's 16 rows, from device memory while the
  // tiles come in: HD / 4 lanes a row, a float4 each, then a lane shuffle
  constexpr int kLanesRow = HD / 4, kRowsIt = 32 / kLanesRow;
  float di[2] = {0.f, 0.f}, m[2], rl[2];
#pragma unroll
  for (int i = 0; i < 16; i += kRowsIt) {
    const size_t at = qofs + (size_t)(t0 + r0 + i + lane / kLanesRow) * stride + 4 * (lane % kLanesRow);
    const float4 o4 = __ldg(reinterpret_cast<const float4*>(out + at));
    const float4 g4 = __ldg(reinterpret_cast<const float4*>(g + at));
    float acc = fmaf(o4.w, g4.w, fmaf(o4.z, g4.z, fmaf(o4.y, g4.y, o4.x * g4.x)));
#pragma unroll
    for (int o = 1; o < kLanesRow; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
#pragma unroll
    for (int u = 0; u < kRowsIt; ++u) {
      const float row_di = __shfl_sync(0xffffffffu, acc, u * kLanesRow);
      if (i + u == gq) di[0] = row_di;
      if (i + u == gq + 8) di[1] = row_di;
    }
  }
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const size_t at = (size_t)bh * T + t0 + r0 + gq + 8 * hi;
    if (tq == 0) di_out[at] = di[hi];
    m[hi] = stats[at];
    rl[hi] = 1.f / stats[BHT + at];
  }

  float dqa[HD / 8][4];
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb) dqa[nb][0] = dqa[nb][1] = dqa[nb][2] = dqa[nb][3] = 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    attn_tiles::cp_async_wait<0>();
    __syncthreads();  // tile it is in; every warp is past tile it - 1, whose stage the next load takes
    if (kStages<HD> == 2 && it + 1 < n_tiles) {
      load_tile(it + 1);
      attn_tiles::cp_async_commit();
    }
    const float* ks = ring + 2 * (it % kStages<HD>) * kTileT<HD>;
    const float* vs = ks + kTileT<HD>;
    const int* ok = kok + (it % kStages<HD>) * BT;
    float s[NB][4], dp[NB][4];
    xyt_tc<HD, NB>(s, qs + r0 * kLdF<HD>, ks, lane);
    xyt_tc<HD, NB>(dp, gs + r0 * kLdF<HD>, vs, lane);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1, c = 8 * j + 2 * tq + (e & 1);
        const bool keep = ok[c] != 0 && !(causal && it * BT + c > t0 + r0 + gq + 8 * hi);
        const float sv = fmaf(s[j][e], scale, keep ? 0.f : kMaskValue);
        const float p = attn_tiles::exp2_ftz((sv - m[hi]) * kLog2e) * rl[hi];
        s[j][e] = (dp[j][e] - di[hi]) * p * scale;  // ds
      }
    pv_tc<HD, NB>(dqa, s, ks, gq, tq);
    if (kStages<HD> == 1 && it + 1 < n_tiles) {
      __syncthreads();  // every warp is done with the one stage
      load_tile(it + 1);
      attn_tiles::cp_async_commit();
    }
  }
  store_acc<HD>(dq + qofs, stride, dqa, t0 + r0, gq, tq);
}

// ---------------------------------------------------------------------------
// backward, dk and dv: a block per (64 keys, b * H + h).  Replaces, for f32
// inputs, the library flash kernel's dkv pallas_call (flash_attention.py:
// 1121).  K and V stay in shared memory; Q, g and each row's m, l, di
// stream, from the keys' 128-block on when causal.  Products: S^T = K Q^T,
// dP^T = V g^T, dv += p^T g, dk += ds^T Q.
// ---------------------------------------------------------------------------
template <int HD>
constexpr size_t kDkvSmemF =
    (2 * kTileF<HD> + 2 * kStages<HD> * kTileT<HD> + 3 * kStages<HD> * kBT<HD>) * sizeof(float);

template <int HD>
__global__ void __launch_bounds__(kTcThreads, kMinBlocks<HD>)
    flash_train_f32_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const int* __restrict__ valid,
                               const float* __restrict__ stats, const float* __restrict__ di_in,
                               const float* __restrict__ g, int causal, float scale,
                               float* __restrict__ dk, float* __restrict__ dv, int T, int S,
                               int H) {
  constexpr int BT = kBT<HD>, NB = BT / 8;
  extern __shared__ __align__(16) float fsm[];
  float* ks = fsm;
  float* vs = ks + kTileF<HD>;
  float* ring = vs + kTileF<HD>;  // stage st: Q tile at ring + 2 st kTileT, g after it
  float* rst = ring + 2 * kStages<HD> * kTileT<HD>;  // [stage][3][BT]: m, l, di of the tile's rows
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int c0 = blockIdx.x * kRows;
  const int r0 = 16 * warp;  // the warp's keys within the block
  const size_t stride = (size_t)H * HD;
  const size_t kofs = (size_t)b * S * stride + h * HD;
  const float* qb = q + (size_t)b * T * stride + h * HD;
  const float* gb = g + (size_t)b * T * stride + h * HD;
  // query rows: all, or those of the 128-blocks at or below the keys'
  const int first = causal ? (c0 / kBlk) * kBlk : 0;
  const int n_tiles = (T - first) / BT;
  const size_t BHT = (size_t)gridDim.y * T;

  auto load_tile = [&](int it) {
    const int p0 = first + it * BT;
    float* qs = ring + 2 * (it % kStages<HD>) * kTileT<HD>;
    load_rows_async<HD, BT>(qs, qb, stride, p0);
    load_rows_async<HD, BT>(qs + kTileT<HD>, gb, stride, p0);
    float* rs = rst + 3 * BT * (it % kStages<HD>);
    if (threadIdx.x < 3 * BT / 4) {
      const int a = threadIdx.x / (BT / 4), c = 4 * (threadIdx.x % (BT / 4));
      const size_t at = (size_t)bh * T + p0 + c;
      const float* src = a == 0 ? stats + at : (a == 1 ? stats + BHT + at : di_in + at);
      attn_tiles::cp_async16(rs + a * BT + c, src, true);
    }
  };
  load_rows_async<HD, kRows>(ks, k + kofs, stride, c0);
  load_rows_async<HD, kRows>(vs, v + kofs, stride, c0);
  load_tile(0);
  attn_tiles::cp_async_commit();
  float madd[2];
  int key[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    key[hi] = c0 + r0 + gq + 8 * hi;
    madd[hi] = valid[(size_t)b * S + key[hi]] != 0 ? 0.f : kMaskValue;
  }

  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int nb = 0; nb < HD / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nb][e] = dva[nb][e] = 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    attn_tiles::cp_async_wait<0>();
    __syncthreads();  // tile it is in; every warp is past tile it - 1, whose stage the next load takes
    if (kStages<HD> == 2 && it + 1 < n_tiles) {
      load_tile(it + 1);
      attn_tiles::cp_async_commit();
    }
    const float* qs = ring + 2 * (it % kStages<HD>) * kTileT<HD>;
    const float* gs = qs + kTileT<HD>;
    const float* rs = rst + 3 * BT * (it % kStages<HD>);
    const int p0 = first + it * BT;
    float sT[NB][4], dT[NB][4];  // row: one of the warp's keys; column: a query row of the tile
    xyt_tc<HD, NB>(sT, ks + r0 * kLdF<HD>, qs, lane);
    xyt_tc<HD, NB>(dT, vs + r0 * kLdF<HD>, gs, lane);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int c = 8 * j + 2 * tq + e2;
        const float mr = rs[c], rl = __frcp_rn(rs[BT + c]), dr = rs[2 * BT + c];
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int e = 2 * hi + e2;
          const float mk = causal && key[hi] > p0 + c ? kMaskValue : madd[hi];
          const float sv = fmaf(sT[j][e], scale, mk);
          const float p = attn_tiles::exp2_ftz((sv - mr) * kLog2e) * rl;
          sT[j][e] = p;
          dT[j][e] = (dT[j][e] - dr) * p * scale;  // ds
        }
      }
    pv_tc<HD, NB>(dva, sT, gs, gq, tq);
    pv_tc<HD, NB>(dka, dT, qs, gq, tq);
    if (kStages<HD> == 1 && it + 1 < n_tiles) {
      __syncthreads();  // every warp is done with the one stage
      load_tile(it + 1);
      attn_tiles::cp_async_commit();
    }
  }
  store_acc<HD>(dk + kofs, stride, dka, c0 + r0, gq, tq);
  store_acc<HD>(dv + kofs, stride, dva, c0 + r0, gq, tq);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// a kernel's dynamic shared memory, and the whole of the SM's shared memory
// preferred over L1, so that as many blocks as the registers allow fit an SM
template <class K>
cudaError_t smem_attributes(K* kernel, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return e;
}

template <int HD>
int launch_fwd_f32(int mode, int B, int T, int S, int H, const void* q, const void* k,
                   const void* v, const void* keys, int causal, float scale, void* out,
                   void* stats, cudaStream_t st) {
  auto kernel = mode == 0 ? &attn_f32_fwd_kernel<HD, 0> : &attn_f32_fwd_kernel<HD, 1>;
  const cudaError_t e = smem_attributes(kernel, kFwdSmemF<HD>);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((T + kRows - 1) / kRows, B * H), kTcThreads, kFwdSmemF<HD>, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(keys), causal, scale, static_cast<float*>(out),
      static_cast<float*>(stats), T, S, H);
  return (int)cudaGetLastError();
}

template <int HD>
int fwd_f32_blocks(int mode, int* blocks) {
  auto kernel = mode == 0 ? &attn_f32_fwd_kernel<HD, 0> : &attn_f32_fwd_kernel<HD, 1>;
  cudaError_t e = smem_attributes(kernel, kFwdSmemF<HD>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kTcThreads, kFwdSmemF<HD>);
  return (int)e;
}

// the pair's shared memory, so that two blocks of each fit an SM
template <int HD>
cudaError_t bwd_f32_attributes() {
  cudaError_t e = smem_attributes(flash_train_f32_dq_kernel<HD>, kDqSmemF<HD>);
  if (e == cudaSuccess) e = smem_attributes(flash_train_f32_dkv_kernel<HD>, kDkvSmemF<HD>);
  return e;
}

template <int HD>
int launch_bwd_f32(int B, int T, int S, int H, const void* q, const void* k, const void* v,
                   const void* valid, const void* out, const void* stats, const void* g,
                   int causal, float scale, void* di, void* dq, void* dk, void* dv,
                   cudaStream_t st) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* gf = static_cast<const float*>(g);
  const int* vl = static_cast<const int*>(valid);
  const auto* sf = static_cast<const float*>(stats);
  float* dib = static_cast<float*>(di);
  cudaError_t e = bwd_f32_attributes<HD>();
  if (e != cudaSuccess) return (int)e;
  flash_train_f32_dq_kernel<HD><<<dim3(T / kRows, B * H), kTcThreads, kDqSmemF<HD>, st>>>(
      qf, kf, vf, vl, static_cast<const float*>(out), sf, gf, causal, scale, dib,
      static_cast<float*>(dq), T, S, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_train_f32_dkv_kernel<HD><<<dim3(S / kRows, B * H), kTcThreads, kDkvSmemF<HD>, st>>>(
      qf, kf, vf, vl, sf, dib, gf, causal, scale, static_cast<float*>(dk), static_cast<float*>(dv),
      T, S, H);
  return (int)cudaGetLastError();
}

template <int HD>
int bwd_f32_blocks(int* dq_blocks, int* dkv_blocks) {
  cudaError_t e = bwd_f32_attributes<HD>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(dq_blocks, flash_train_f32_dq_kernel<HD>,
                                                      kTcThreads, kDqSmemF<HD>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(dkv_blocks, flash_train_f32_dkv_kernel<HD>,
                                                      kTcThreads, kDkvSmemF<HD>);
  return (int)e;
}

}  // namespace

extern "C" {

// The f32 forward: q (B, T, H, HD), k and v (B, S, H, HD), out (B, T, H,
// HD), f32, contiguous and 16-byte aligned, HD = head_dim 64 or 128.  mode 0
// (`fused_attention`): keys = kv_valid_len (B,) int32 or null; any T, S.
// mode 1 (flash training): keys = the validity (B, S) int32, T and S
// multiples of 128, stats (2, B*H, T) f32 receives each row's m and l.
int smer_attention_f32_fwd(int mode, int head_dim, int B, int T, int S, int H, const void* q,
                           const void* k, const void* v, const void* keys, int causal, float scale,
                           void* out, void* stats, void* stream) {
  if (B < 1 || T < 1 || S < 1 || H < 1 || B * H > 65535 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  if (mode == 1 && (keys == nullptr || stats == nullptr || T % kBlk || S % kBlk))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_fwd_f32<64>(mode, B, T, S, H, q, k, v, keys, causal, scale, out, stats, st);
    case 128:
      return launch_fwd_f32<128>(mode, B, T, S, H, q, k, v, keys, causal, scale, out, stats, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The f32 backward of mode 1: out and stats as the forward wrote them, g
// (B, T, H, HD) f32; di a (B*H, T) f32 scratch buffer; dq, dk, dv f32 in the
// layouts of q, k, v.
int smer_flash_train_bwd_f32(int head_dim, int B, int T, int S, int H, const void* q,
                             const void* k, const void* v, const void* valid, const void* out,
                             const void* stats, const void* g, int causal, float scale, void* di,
                             void* dq, void* dk, void* dv, void* stream) {
  if (B < 1 || H < 1 || T < kBlk || S < kBlk || T % kBlk || S % kBlk || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out) || !aligned16(g) ||
      !aligned16(stats) || !aligned16(di))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_bwd_f32<64>(B, T, S, H, q, k, v, valid, out, stats, g, causal, scale, di, dq,
                                dk, dv, st);
    case 128:
      return launch_bwd_f32<128>(B, T, S, H, q, k, v, valid, out, stats, g, causal, scale, di, dq,
                                 dk, dv, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Blocks of the forward of `mode` an SM holds at once (the occupancy
// calculator, with the launch's attributes set).
int smer_attention_f32_fwd_blocks(int head_dim, int mode, int* blocks) {
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  switch (head_dim) {
    case 64:
      return fwd_f32_blocks<64>(mode, blocks);
    case 128:
      return fwd_f32_blocks<128>(mode, blocks);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Blocks of the backward pair an SM holds at once (the occupancy
// calculator, with the launch's attributes set): dq then dk/dv.
int smer_flash_train_bwd_f32_blocks(int head_dim, int* dq_blocks, int* dkv_blocks) {
  switch (head_dim) {
    case 64:
      return bwd_f32_blocks<64>(dq_blocks, dkv_blocks);
    case 128:
      return bwd_f32_blocks<128>(dq_blocks, dkv_blocks);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
