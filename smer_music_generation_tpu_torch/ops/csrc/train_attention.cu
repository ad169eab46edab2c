// Training attention with weight dropout (scores -> softmax -> dropout -> V)
// and its recomputing backward, over (B, T|S, H, 64) bf16 tensors, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `fused_dropout_attention` of
// smer_music_generation_tpu/ops/train_attention.py:316: its forward
// `_fwd_kernel` (:111, pallas_call :263) becomes train_fwd_kernel, and its
// backward `_bwd_kernel` (:163, pallas_call :288) becomes the pair
// train_bwd_rows_kernel + train_bwd_keys_kernel.  The same function:
//   s  = bf16(q . k, f32 sums) * 1/sqrt(64), -1e30 where the key is invalid
//        (or past the query row when causal);
//   e  = exp(s - max s) on valid keys, 0 elsewhere; w = e / max(sum e, 1e-30)
//        (exact, not online: w is normalised before it is rounded);
//   wd = keep ? bf16(bf16(w) / bf16(1 - rate)) : 0, keep from the counter
//        hash of _hash_keep (:87) over (seed, b * H + h, absolute row, col);
//   out = bf16(wd . v, f32 sums).
// Backward, as _bwd_kernel: dv = wd^T g; dw = keep ? (g v^T) / bf16(1 - rate)
// : 0; ds = bf16(w (dw - sum_s w dw) * scale) from the f32 w; dq = ds k,
// dk = ds^T q, all summed in f32.  A row with no valid key has w = 0, so its
// output and its gradients are 0.
//
// What bounds it on an NVIDIA H100 (989 TFLOP/s dense bf16, 3.35 TB/s at
// 700 W): at the training step's encoder shape (B=8, H=8, T=S=640) the
// forward moves 21 MB (6 us) and does 2 products of 2*T*S*64 operations a
// head (6.7 GFLOP, 7 us); the backward moves 37 MB (11 us) and does 5 such
// products, the scores recomputed (17 us).
//
// Forward (train_fwd_kernel, on the tensor cores; helpers in
// attn_tiles.cuh).  A block of 4 warps owns 64 query rows of one (b, h),
// 16 a warp, their Q fragments loaded once into registers, and makes two
// passes over 64-key tiles that stream through a two-stage cp.async ring
// (K alone in pass 1, K and V in pass 2; pass 2's first tile is in flight
// during pass 1's last):
//   pass 1: QK^T by mma.sync (f32 sums over head_dim in k16 chunks 0..3),
//     rounded to bf16, masked, and a running max m and sum l of e per row,
//     l rescaled as m grows (quad shuffles for the row max, l summed over
//     the quad at the end);
//   pass 2: QK^T again by the same instruction sequence, so every s is
//     bit-identical to pass 1's; e, w = e / max(l, 1e-30), bf16, the keep
//     hash, bf16(w16 / c), packed straight into the bf16 A fragments of the
//     PV mma (wd is bf16 by definition, so one bf16 product is exact to the
//     function).
// The scale 1/8 is a power of two, so the scores stay bf16(q . k) and the
// scale folds exactly into the exponent: e = 2^(s log2(e) / 8 - m log2(e) /
// 8), one FFMA and one MUFU.EX2.  A key that is invalid, or past the row
// when causal, takes -inf: its e is exactly 0 (zeroed, not left to
// underflow) and it never raises m, so a row with no valid key keeps m =
// -1e30 and gives output 0.  Shared memory holds only the Q tile and the K/V
// ring (45 KB), the validity of the keys as bits, and no score row; 163
// registers a thread, three blocks an SM.  Key tiles past the block's last
// attendable key (past the last valid key, and wholly above the diagonal
// when causal) are skipped in both passes.  The hash's row and (b, h) terms
// are hoisted out of the key loop.  What limits it is the per-element work,
// not the products: a 64 x 64 tile is 1 MFLOP of mma.sync (300-400 cycles
// an SM) but 4,096 exp on the SFU (16 a cycle: 256 cycles) in each pass and
// ~20 integer operations of the keep hash an element (4,096 x 20 / 64 lanes
// ~ 1,300 cycles); at 640x640 that ALU floor is ~0.035 ms, 6x the
// bytes-and-products bound.  So mma.sync stays, and wgmma with TMA is left
// for later, if the products come out on top.  Measured at 640x640 (B=8,
// H=8, rate 0.1) on an NVIDIA H100 80GB HBM3, 700.00 W
// (scripts/torch_kernel_ab.py, chip_smoke.py phase 2g; PERF.md): 0.095 ms
// a call, beside 0.61-0.72 ms for the first version (32 rows a block, their
// f32 scores in shared memory, f32 FMA pipes) and 0.09-0.12 ms for torch's
// scaled_dot_product_attention with its own dropout.
//
// Backward (the first version, on the f32 FMA pipes): the TPU kernel holds
// a (128, S <= 1024) f32 score block in VMEM (512 KB); a Hopper block has
// 227 KB.  So a block takes 32 query rows and keeps their (32, S) f32
// scores in shared memory (128 KB at S = 1024) while K and V stream through
// in 64-key tiles staged as f32; eight warps, warp w owning rows 4w..4w+3,
// each lane two keys (or two output dims) of a tile, so the softmax of a row
// is one warp's reduction.
// The backward needs each row's max m, sum l and delta = sum_s w dw before any
// ds, and dk, dv sum over all rows; it takes no atomics:
//   train_bwd_rows_kernel, a block per (32 query rows, b * H + h): scores and
//     w as the forward, delta from a pass over V, then ds and dq from a pass
//     over K and V (g v^T recomputed rather than held); writes dq once and
//     m, l, delta to a (3, B*H, T) f32 buffer;
//   train_bwd_keys_kernel, a block per (64 keys, b * H + h): walks every
//     32-row query chunk (causal chunks wholly above the tile skipped),
//     recomputes s, w, the keep mask, wd and ds from m, l, delta, and sums
//     dk, dv in registers; writes them once.
// Deterministic, and no O(T*S) tensor reaches device memory.  The two
// backward kernels compute every score by the same sequential fmaf chain
// over the 64 dims, so their w agree bit for bit with each other; the
// forward sums its scores on the tensor cores in another order, so its w
// may differ from theirs by an f32 rounding (and its bf16 weights by one
// bf16 ulp).  The gradients do not read the forward's output: the backward
// recomputes w itself, so the tolerances of dq, dk and dv (chip_smoke's
// TA_REL) are untouched by the forward's design.  The hash is uint32
// wraparound arithmetic; the keep threshold is computed in double on the host;
// no --use_fast_math: the backward's `/` and expf are IEEE-rounded, and the
// forward divides by a rounded reciprocal and one FMA residual step (div_rn,
// rounded to nearest) and takes e^(s - m) as 2^(s log2(e) - m log2(e)) on the
// SFU (exp2_ftz): IEEE division and expf, per element, were the largest
// share of its time.
// smer_dropout_keep_mask writes the keep mask from the same __device__ hash
// so the card can show it bit-equal to dropout_mask_reference.
//
// The launchers have a plain C interface and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tiles.cuh"

namespace {

namespace tiles = attn_tiles;

constexpr int kHD = 64;        // head_dim
constexpr int kRows = 32;      // query rows a block (forward, backward rows)
constexpr int kKeys = 64;      // keys a staged tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kRowsPerWarp = kRows / (kThreads / 32);
constexpr int kLd = kHD + 1;   // padded row stride of a staged tile
constexpr float kMasked = -1e30f;
constexpr int kMaxKeys = 1024;  // the backward's limit (its score rows live in shared memory)

struct Drop {
  uint32_t s0, s1, thr;
  int on;   // rate > 0
  float c;  // bf16(1 - rate) as a float
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

constexpr uint32_t kRowMul = 0x9E3779B1u, kColMul = 0x85EBCA77u, kBhMul = 0xC2B2AE3Du;

// _hash_keep of the TPU kernel from its three terms: row_term = s0 + row *
// kRowMul, col_term = col * kColMul, bh_term = bh * kBhMul
__device__ __forceinline__ bool keep_terms(const Drop& dr, uint32_t row_term,
                                           uint32_t col_term, uint32_t bh_term) {
  uint32_t h = (row_term ^ col_term) + bh_term;
  h = fmix32(h ^ dr.s1);
  h = fmix32(h + dr.s0);
  return h < dr.thr;
}

// _hash_keep of the TPU kernel, one element: bh = b * H + h, row absolute
__device__ __forceinline__ bool keep_at(const Drop& dr, uint32_t bh, uint32_t row,
                                        uint32_t col) {
  return keep_terms(dr, dr.s0 + row * kRowMul, col * kColMul, bh * kBhMul);
}

__device__ __forceinline__ Drop make_drop(const int* seeds, uint32_t thr, int on,
                                          float c) {
  Drop dr;
  dr.s0 = (uint32_t)seeds[0] ^ (uint32_t)seeds[2];
  dr.s1 = (uint32_t)seeds[1] ^ (uint32_t)seeds[3];
  dr.thr = thr;
  dr.on = on;
  dr.c = c;
  return dr;
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// a / b rounded to nearest, given rb = 1 / b (itself rounded to nearest):
// one FMA residual step, the fast path of IEEE division without its range
// check (a and b here are finite, b >= 1e-30 or a bf16 constant near 1)
__device__ __forceinline__ float div_rn(float a, float b, float rb) {
  const float q = a * rb;
  return fmaf(fmaf(-q, b, a), rb, q);
}

// dropout of one bf16 weight: keep ? bf16(w16 / c) : 0
__device__ __forceinline__ float dropped(float w16, bool keep, const Drop& dr) {
  if (!dr.on) return w16;
  return keep ? bf16r(w16 / dr.c) : 0.f;
}

// Stage rows p0 .. p0 + n - 1 of one head of a (B, L, H, 64) bf16 tensor
// (base offset to (b, 0, h, 0)) into an f32 tile [n][kLd], zero past `limit`.
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* base,
                                      size_t stride, int p0, int n, int limit) {
  for (int i = threadIdx.x; i < n * kHD / 2; i += kThreads) {
    const int r = i / (kHD / 2);
    const int c = 2 * (i % (kHD / 2));
    const int p = p0 + r;
    float2 x = make_float2(0.f, 0.f);
    if (p < limit)
      x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(base + (size_t)p * stride + c));
    dst[r * kLd + c] = x.x;
    dst[r * kLd + c + 1] = x.y;
  }
}

// acc[i][j] = sum_d a[r0 + i][d] * b[lane + 32 j][d], d in order: the one
// dot-product chain every kernel here uses for a score (and for g . v)
__device__ __forceinline__ void dots(const float* a, int r0, const float* b, int lane,
                                     float acc[kRowsPerWarp][2]) {
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) acc[i][0] = acc[i][1] = 0.f;
#pragma unroll 8
  for (int d = 0; d < kHD; ++d) {
    const float b0 = b[lane * kLd + d];
    const float b1 = b[(lane + 32) * kLd + d];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float av = a[(r0 + i) * kLd + d];
      acc[i][0] = fmaf(av, b0, acc[i][0]);
      acc[i][1] = fmaf(av, b1, acc[i][1]);
    }
  }
}

__device__ __forceinline__ bool attendable(const int* valid, int causal, int row, int col) {
  return valid[col] != 0 && (!causal || col <= row);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Scores of this block's kRows query rows against all S keys into P
// [kRows][s_pad] (masked ones at -1e30); qs holds the staged query rows, ts
// is the K tile buffer.
__device__ void scores_into(float* P, int s_pad, const float* qs, float* ts,
                            const __nv_bfloat16* kb, size_t stride, const int* valid,
                            int causal, int t0, int S, float scale) {
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * kRowsPerWarp;
  for (int k0 = 0; k0 < S; k0 += kKeys) {
    __syncthreads();  // the previous tile is no longer read
    stage(ts, kb, stride, k0, kKeys, S);
    __syncthreads();
    float acc[kRowsPerWarp][2];
    dots(qs, r0, ts, lane, acc);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k0 + lane + 32 * j;
        if (col < S)
          P[(r0 + i) * s_pad + col] = attendable(valid, causal, t0 + r0 + i, col)
                                          ? bf16r(acc[i][j]) * scale
                                          : kMasked;
      }
  }
}

// The exact softmax of one warp's rows in place: P row -> f32 w.  Returns
// each row's (m, l) in m_out / l_out (lane-uniform).
__device__ void softmax_rows(float* P, int s_pad, const int* valid, int causal, int t0,
                             int S, float m_out[kRowsPerWarp], float l_out[kRowsPerWarp]) {
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * kRowsPerWarp;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    float* pr = P + (r0 + i) * s_pad;
    const int row = t0 + r0 + i;
    float m = kMasked;
    for (int c = lane; c < S; c += 32) m = fmaxf(m, pr[c]);
    m = warp_max(m);
    float l = 0.f;
    for (int c = lane; c < S; c += 32) {
      const float e = attendable(valid, causal, row, c) ? expf(pr[c] - m) : 0.f;
      pr[c] = e;
      l += e;
    }
    l = warp_sum(l);
    const float den = fmaxf(l, 1e-30f);
    for (int c = lane; c < S; c += 32) pr[c] = pr[c] / den;
    m_out[i] = m;
    l_out[i] = l;
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// forward: a block per (64 query rows, b * H + h), on the tensor cores
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(tiles::kThreads, 3)
    train_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const int* __restrict__ valid,
                     const int* __restrict__ seeds, uint32_t thr, int drop_on, float c,
                     int causal, __nv_bfloat16* __restrict__ out, int T, int S, int H,
                     float scale) {
  using namespace tiles;
  __shared__ __align__(16) __nv_bfloat16 qs[kTileElems];  // Q, then the output
  __shared__ __align__(16) __nv_bfloat16 ks[2][kTileElems];
  __shared__ __align__(16) __nv_bfloat16 vs[2][kTileElems];
  __shared__ uint32_t vbits[kMaxKeys / 32];  // bit c % 32 of word c / 32: key c valid

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int t0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kQTile;
  const size_t stride = (size_t)H * kHD;
  const __nv_bfloat16* kb = k + (size_t)b * S * stride + h * kHD;
  const __nv_bfloat16* vb = v + (size_t)b * S * stride + h * kHD;
  const Drop dr = make_drop(seeds, thr, drop_on, c);

  load_tile(qs, q + (size_t)b * T * stride + h * kHD, stride, t0, T);
  const int words = (S + 31) / 32;
  for (int wi = warp; wi < words; wi += kWarps) {
    const int col = 32 * wi + lane;
    const unsigned bits = __ballot_sync(0xffffffffu, col < S && valid[(size_t)b * S + col] != 0);
    if (lane == 0) vbits[wi] = bits;
  }
  __syncthreads();
  // the last valid key bounds the walk (and, when causal, the diagonal of
  // the block's last row): tiles past it are skipped in both passes
  int last = -1;
  if (lane < words && vbits[lane] != 0u) last = 32 * lane + 31 - __clz(vbits[lane]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
  const int n_keys = causal ? min(last + 1, t0 + kQTile) : last + 1;
  const int n_tiles = (n_keys + kKTile - 1) / kKTile;  // 0 when no key is valid
  const int steps = 2 * n_tiles;                      // pass 1, then pass 2
  if (steps > 0) load_tile(ks[0], kb, stride, 0, S);
  cp_async_commit();

  const int row0 = t0 + 16 * warp + g, row1 = row0 + 8;
  const uint32_t row_term[2] = {dr.s0 + (uint32_t)row0 * kRowMul,
                                dr.s0 + (uint32_t)row1 * kRowMul};
  const uint32_t bh_term = (uint32_t)bh * kBhMul;
  uint32_t qa[kKC][4];
  float o[kNB][4];
#pragma unroll
  for (int j = 0; j < kNB; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // Scores stay in units of bf16(q . k): the scale 1/8 is a power of two,
  // so it folds exactly into the exponent's factor sl2 = log2(e) / 8, and
  // e = 2^(s sl2 - m sl2) is one FFMA and one MUFU.EX2.  m and l are the
  // rows' running max (of bf16(q . k)) and sum; mb = m sl2.
  const float sl2 = scale * 1.4426950408889634f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f}, mb[2] = {0.f, 0.f};
  float den[2] = {1e-30f, 1e-30f}, rden[2] = {1e30f, 1e30f};  // max(l, 1e-30), its inverse
  const float rc = 1.f / dr.c;

  for (int i = 0; i < steps; ++i) {
    const bool pass2 = i >= n_tiles;
    const int k0 = (pass2 ? i - n_tiles : i) * kKTile;
    if (i + 1 < steps) {
      const int nk0 = (i + 1 < n_tiles ? i + 1 : i + 1 - n_tiles) * kKTile;
      load_tile(ks[(i + 1) & 1], kb, stride, nk0, S);
      if (i + 1 >= n_tiles) load_tile(vs[(i + 1) & 1], vb, stride, nk0, S);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this step's tiles (and Q) have landed
    __syncthreads();
    if (i == 0) load_q_frags(qa, qs, warp, lane);

    float s[kNB][4];
    qk_tile(s, qa, ks[i & 1], lane);
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      round_bf16x2(s[j][0], s[j][1]);
      round_bf16x2(s[j][2], s[j][3]);
    }
    // A key that is invalid, or past the row when causal, takes -inf: its e
    // is exactly 0 and it never raises m (so a row with no valid key keeps
    // m = -1e30 and gets e = 0 everywhere, l = 0, w = 0).  Masking runs only
    // on a tile some key of which is invalid, or past the diagonal of some
    // row of this warp: one branch a tile, selects per element.
    const uint32_t w0 = vbits[k0 / 32], w1 = k0 / 32 + 1 < words ? vbits[k0 / 32 + 1] : 0u;
    if ((w0 & w1) != 0xffffffffu || (causal && k0 + kKTile - 1 > t0 + 16 * warp)) {
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const bool ok = ((j < 4 ? w0 : w1) >> (col & 31) & 1u) &&
                          (!causal || col <= (e < 2 ? row0 : row1));
          s[j][e] = ok ? s[j][e] : -INFINITY;
        }
    }
    if (!pass2) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kMasked;
#pragma unroll
        for (int j = 0; j < kNB; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        const float m_new = fmaxf(m[r], quad_max(mx));
        const float mb_new = m_new * sl2;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kNB; ++j)
          sum += exp2_ftz(fmaf(s[j][2 * r], sl2, -mb_new)) +
                 exp2_ftz(fmaf(s[j][2 * r + 1], sl2, -mb_new));
        l[r] = l[r] * exp2_ftz((m[r] - m_new) * sl2) + sum;
        m[r] = m_new;
        mb[r] = mb_new;
      }
      if (i == n_tiles - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          den[r] = fmaxf(quad_sum(l[r]), 1e-30f);
          rden[r] = 1.f / den[r];
        }
      }
    } else {
      // the dropped bf16 weights as the bf16 pairs of PV's A fragments:
      // wd[j][r] holds row r's columns 8 j + 2 t, 8 j + 2 t + 1
      uint32_t wd[kNB][2];
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        const uint32_t col_term0 = (uint32_t)(k0 + 8 * j + 2 * t) * kColMul;
        const uint32_t col_term1 = col_term0 + kColMul;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float wa = div_rn(exp2_ftz(fmaf(s[j][2 * r], sl2, -mb[r])), den[r], rden[r]);
          float wb = div_rn(exp2_ftz(fmaf(s[j][2 * r + 1], sl2, -mb[r])), den[r], rden[r]);
          round_bf16x2(wa, wb);
          if (dr.on) {
            wa = keep_terms(dr, row_term[r], col_term0, bh_term) ? div_rn(wa, dr.c, rc) : 0.f;
            wb = keep_terms(dr, row_term[r], col_term1, bh_term) ? div_rn(wb, dr.c, rc) : 0.f;
          }
          wd[j][r] = pack_bf16(wa, wb);
        }
      }
#pragma unroll
      for (int kc = 0; kc < kKTile / 16; ++kc) {
        const uint32_t a[4] = {wd[2 * kc][0], wd[2 * kc][1], wd[2 * kc + 1][0],
                               wd[2 * kc + 1][1]};
        pv_chunk(o, a, vs[i & 1], kc, lane);
      }
    }
    __syncthreads();  // this stage is read; the next step refills it
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread's copies into the Q tile have landed

  stage_out(qs, o, 1.f, 1.f, warp, lane);
  __syncthreads();
  store_out(out + (size_t)b * T * stride + h * kHD, qs, stride, t0, T);
}

// ---------------------------------------------------------------------------
// backward, rows: a block per (32 query rows, b * H + h): m, l, delta and dq
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    train_bwd_rows_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const int* __restrict__ valid, const int* __restrict__ seeds,
                          const __nv_bfloat16* __restrict__ g, uint32_t thr, int drop_on,
                          float c, int causal, float* __restrict__ stats,
                          __nv_bfloat16* __restrict__ dq, int T, int S, int H, int s_pad,
                          float scale) {
  extern __shared__ float smem[];
  float* P = smem;                  // [kRows][s_pad]: scores, then f32 w
  float* qs = P + kRows * s_pad;    // [kRows][kLd]
  float* gs = qs + kRows * kLd;     // [kRows][kLd]
  float* dst = gs + kRows * kLd;    // [kRows][kLd]: bf16 ds of one key tile
  float* ks = dst + kRows * kLd;    // [kKeys][kLd]
  float* vs = ks + kKeys * kLd;     // [kKeys][kLd]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int t0 = blockIdx.x * kRows;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * kRowsPerWarp;
  const size_t stride = (size_t)H * kHD;
  const __nv_bfloat16* qb = q + (size_t)b * T * stride + h * kHD;
  const __nv_bfloat16* gb = g + (size_t)b * T * stride + h * kHD;
  const __nv_bfloat16* kb = k + (size_t)b * S * stride + h * kHD;
  const __nv_bfloat16* vb = v + (size_t)b * S * stride + h * kHD;
  const int* vrow = valid + (size_t)b * S;
  const Drop dr = make_drop(seeds, thr, drop_on, c);

  stage(qs, qb, stride, t0, kRows, T);
  stage(gs, gb, stride, t0, kRows, T);
  scores_into(P, s_pad, qs, ks, kb, stride, vrow, causal, t0, S, scale);
  float m[kRowsPerWarp], l[kRowsPerWarp];
  softmax_rows(P, s_pad, vrow, causal, t0, S, m, l);

  // dw of one (row, key) from its g . v
  auto dw_of = [&](float dwd, int row, int col) {
    if (!dr.on) return dwd;
    return keep_at(dr, bh, row, col) ? dwd / dr.c : 0.f;
  };

  // delta = sum_s w dw
  float delta[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) delta[i] = 0.f;
  for (int k0 = 0; k0 < S; k0 += kKeys) {
    __syncthreads();
    stage(vs, vb, stride, k0, kKeys, S);
    __syncthreads();
    float acc[kRowsPerWarp][2];
    dots(gs, r0, vs, lane, acc);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k0 + lane + 32 * j;
        if (col < S)
          delta[i] += P[(r0 + i) * s_pad + col] * dw_of(acc[i][j], t0 + r0 + i, col);
      }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) delta[i] = warp_sum(delta[i]);

  // ds = bf16(w (dw - delta) * scale), dq = ds k
  float dqa[kRowsPerWarp][2];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) dqa[i][0] = dqa[i][1] = 0.f;
  for (int k0 = 0; k0 < S; k0 += kKeys) {
    __syncthreads();
    stage(ks, kb, stride, k0, kKeys, S);
    stage(vs, vb, stride, k0, kKeys, S);
    __syncthreads();
    float acc[kRowsPerWarp][2];
    dots(gs, r0, vs, lane, acc);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = k0 + lane + 32 * j;
        float ds = 0.f;
        if (col < S) {
          const float w = P[(r0 + i) * s_pad + col];
          ds = bf16r((w * (dw_of(acc[i][j], t0 + r0 + i, col) - delta[i])) * scale);
        }
        dst[(r0 + i) * kLd + lane + 32 * j] = ds;
      }
    __syncwarp();
    const int n = min(kKeys, S - k0);
    for (int s = 0; s < n; ++s) {
      const float k0v = ks[s * kLd + lane];
      const float k1v = ks[s * kLd + lane + 32];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float p = dst[(r0 + i) * kLd + s];
        dqa[i][0] = fmaf(p, k0v, dqa[i][0]);
        dqa[i][1] = fmaf(p, k1v, dqa[i][1]);
      }
    }
  }

  const size_t BHT = (size_t)gridDim.y * T;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = t0 + r0 + i;
    if (row >= T) continue;
    __nv_bfloat16* o = dq + ((size_t)b * T + row) * stride + h * kHD;
    o[lane] = __float2bfloat16_rn(dqa[i][0]);
    o[lane + 32] = __float2bfloat16_rn(dqa[i][1]);
    if (lane == 0) {
      const size_t at = (size_t)bh * T + row;
      stats[at] = m[i];
      stats[BHT + at] = l[i];
      stats[2 * BHT + at] = delta[i];
    }
  }
}

// ---------------------------------------------------------------------------
// backward, keys: a block per (64 keys, b * H + h): dk and dv
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    train_bwd_keys_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const int* __restrict__ valid, const int* __restrict__ seeds,
                          const __nv_bfloat16* __restrict__ g, uint32_t thr, int drop_on,
                          float c, int causal, const float* __restrict__ stats,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                          int T, int S, int H, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                 // [kKeys][kLd]
  float* vs = ks + kKeys * kLd;     // [kKeys][kLd]
  float* qs = vs + kKeys * kLd;     // [kRows][kLd]
  float* gs = qs + kRows * kLd;     // [kRows][kLd]
  float* wdt = gs + kRows * kLd;    // [kRows][kLd]: dropped bf16 weights
  float* dst = wdt + kRows * kLd;   // [kRows][kLd]: bf16 ds

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int c0 = blockIdx.x * kKeys;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * kRowsPerWarp;
  const int kg = threadIdx.x / 16;  // keys c0 + 4 kg .. + 3 of the sums
  const int dd = threadIdx.x % 16;  // dims dd + 16 jj of the sums
  const size_t stride = (size_t)H * kHD;
  const __nv_bfloat16* qb = q + (size_t)b * T * stride + h * kHD;
  const __nv_bfloat16* gb = g + (size_t)b * T * stride + h * kHD;
  const __nv_bfloat16* kb = k + (size_t)b * S * stride + h * kHD;
  const __nv_bfloat16* vb = v + (size_t)b * S * stride + h * kHD;
  const int* vrow = valid + (size_t)b * S;
  const size_t BHT = (size_t)gridDim.y * T;
  const float* ms = stats + (size_t)bh * T;
  const float* ls = stats + BHT + (size_t)bh * T;
  const float* dls = stats + 2 * BHT + (size_t)bh * T;
  const Drop dr = make_drop(seeds, thr, drop_on, c);

  stage(ks, kb, stride, c0, kKeys, S);
  stage(vs, vb, stride, c0, kKeys, S);
  float dka[4][4], dva[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) dka[u][jj] = dva[u][jj] = 0.f;

  for (int tq0 = 0; tq0 < T; tq0 += kRows) {
    if (causal && tq0 + kRows - 1 < c0) continue;  // every row above every key
    __syncthreads();
    stage(qs, qb, stride, tq0, kRows, T);
    stage(gs, gb, stride, tq0, kRows, T);
    __syncthreads();
    float sa[kRowsPerWarp][2], ga[kRowsPerWarp][2];
    dots(qs, r0, ks, lane, sa);
    dots(gs, r0, vs, lane, ga);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = tq0 + r0 + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = c0 + lane + 32 * j;
        float wd = 0.f, ds = 0.f;
        if (row < T && col < S && attendable(vrow, causal, row, col)) {
          const float s = bf16r(sa[i][j]) * scale;
          const float w = expf(s - ms[row]) / fmaxf(ls[row], 1e-30f);
          const bool keep = dr.on ? keep_at(dr, bh, row, col) : true;
          wd = dropped(bf16r(w), keep, dr);
          const float dw = dr.on ? (keep ? ga[i][j] / dr.c : 0.f) : ga[i][j];
          ds = bf16r((w * (dw - dls[row])) * scale);
        }
        wdt[(r0 + i) * kLd + lane + 32 * j] = wd;
        dst[(r0 + i) * kLd + lane + 32 * j] = ds;
      }
    }
    __syncthreads();
    const int n = min(kRows, T - tq0);
    for (int r = 0; r < n; ++r) {
      float gq[4], qq[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        gq[jj] = gs[r * kLd + dd + 16 * jj];
        qq[jj] = qs[r * kLd + dd + 16 * jj];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float a = wdt[r * kLd + 4 * kg + u];
        const float e = dst[r * kLd + 4 * kg + u];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          dva[u][jj] = fmaf(a, gq[jj], dva[u][jj]);
          dka[u][jj] = fmaf(e, qq[jj], dka[u][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int key = c0 + 4 * kg + u;
    if (key >= S) continue;
    __nv_bfloat16* okb = dk + ((size_t)b * S + key) * stride + h * kHD;
    __nv_bfloat16* ovb = dv + ((size_t)b * S + key) * stride + h * kHD;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      okb[dd + 16 * jj] = __float2bfloat16_rn(dka[u][jj]);
      ovb[dd + 16 * jj] = __float2bfloat16_rn(dva[u][jj]);
    }
  }
}

__global__ void keep_mask_kernel(const int* __restrict__ seeds, uint32_t thr, int T, int S,
                                 size_t n, uint8_t* __restrict__ out) {
  const Drop dr = make_drop(seeds, thr, 1, 1.f);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const uint32_t col = (uint32_t)(i % S);
    const uint32_t row = (uint32_t)((i / S) % T);
    const uint32_t bh = (uint32_t)(i / ((size_t)S * T));
    out[i] = keep_at(dr, bh, row, col) ? 1 : 0;
  }
}

int s_pad_of(int S) { return (S + 31) / 32 * 32; }

size_t rows_smem(int S) {
  return sizeof(float) * ((size_t)kRows * s_pad_of(S) + 3 * kRows * kLd + 2 * kKeys * kLd);
}
size_t keys_smem() { return sizeof(float) * (2 * kKeys * kLd + 4 * kRows * kLd); }

bool bad_shape(int B, int T, int S, int H) {
  return B < 1 || T < 1 || S < 1 || H < 1 || S > kMaxKeys || B * H > 65535;
}

}  // namespace

extern "C" {

// q (B, T, H, 64), k and v (B, S, H, 64), out (B, T, H, 64): bf16, contiguous;
// valid (B, S) int32 (nonzero = attendable); seeds (4,) int32 on the device;
// thr the keep threshold, drop_on = rate > 0, c = bf16(1 - rate).
int smer_train_attn_fwd(int B, int T, int S, int H, const void* q, const void* k,
                        const void* v, const void* valid, const void* seeds,
                        unsigned int thr, int drop_on, float c, int causal, void* out,
                        void* stream) {
  if (bad_shape(B, T, S, H)) return (int)cudaErrorInvalidValue;
  if (!tiles::aligned16(q) || !tiles::aligned16(k) || !tiles::aligned16(v) ||
      !tiles::aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + tiles::kQTile - 1) / tiles::kQTile, B * H);
  train_fwd_kernel<<<grid, tiles::kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(valid),
      static_cast<const int*>(seeds), thr, drop_on, c, causal,
      static_cast<__nv_bfloat16*>(out), T, S, H, 0.125f);
  return (int)cudaGetLastError();
}

// The backward of smer_train_attn_fwd: g (B, T, H, 64) bf16; stats a
// (3, B*H, T) f32 scratch buffer; dq, dk, dv bf16 in the layouts of q, k, v.
int smer_train_attn_bwd(int B, int T, int S, int H, const void* q, const void* k,
                        const void* v, const void* valid, const void* seeds, const void* g,
                        unsigned int thr, int drop_on, float c, int causal, void* stats,
                        void* dq, void* dk, void* dv, void* stream) {
  if (bad_shape(B, T, S, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  const int* vl = static_cast<const int*>(valid);
  const int* sd = static_cast<const int*>(seeds);
  float* stt = static_cast<float*>(stats);
  const size_t smem_a = rows_smem(S), smem_b = keys_smem();
  cudaError_t e = cudaFuncSetAttribute(train_bwd_rows_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(train_bwd_keys_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_b);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_a((T + kRows - 1) / kRows, B * H);
  train_bwd_rows_kernel<<<grid_a, kThreads, smem_a, st>>>(
      qb, kb, vb, vl, sd, gb, thr, drop_on, c, causal, stt,
      static_cast<__nv_bfloat16*>(dq), T, S, H, s_pad_of(S), 0.125f);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_b((S + kKeys - 1) / kKeys, B * H);
  train_bwd_keys_kernel<<<grid_b, kThreads, smem_b, st>>>(
      qb, kb, vb, vl, sd, gb, thr, drop_on, c, causal, stt,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), T, S, H, 0.125f);
  return (int)cudaGetLastError();
}

// The keep mask of the kernels' hash: out (BH, T, S) uint8, 1 = keep.
int smer_dropout_keep_mask(int BH, int T, int S, const void* seeds, unsigned int thr,
                           void* out, void* stream) {
  if (BH < 1 || T < 1 || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)BH * T * S;
  const int blocks = (int)((n + 255) / 256 < 8192 ? (n + 255) / 256 : 8192);
  keep_mask_kernel<<<blocks, 256, 0, st>>>(static_cast<const int*>(seeds), thr, T, S, n,
                                           static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
