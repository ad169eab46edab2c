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
// 700 W): operations.  At the training step's encoder shape (B=8, H=8,
// T=S=640) the forward moves 21 MB (6 us) and does 2 products of 2*T*S*64
// operations a head (6.7 GFLOP, 7 us); the backward moves 37 MB (11 us) and
// does 5 such products, the scores recomputed (17 us).  This first version is
// simple and right, not fast: it runs on the f32 FMA pipes (67 TFLOP/s), not
// the tensor cores (wgmma and TMA are later work).
//
// Design.  The TPU kernel holds a (128, S <= 1024) f32 score block in VMEM
// (512 KB); a Hopper block has 227 KB.  So a block takes 32 query rows and
// keeps their (32, S) f32 scores in shared memory (128 KB at S = 1024) while
// K and V stream through in 64-key tiles staged as f32.  Eight warps, warp w
// owning rows 4w..4w+3 from the scores to the output, each lane two keys (or
// two output dims) of a tile, so the softmax of a row is one warp's
// reduction.  The forward makes two passes over the keys: the scores, then
// (after the exact softmax in shared memory) the product with V.
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
// Deterministic, and no O(T*S) tensor reaches device memory.  Every score is
// the same sequential fmaf chain over the 64 dims in all three kernels, so
// the backward's w is bit-identical to the forward's.  The hash is uint32
// wraparound arithmetic; the keep threshold is computed in double on the host;
// no --use_fast_math, so `/` and expf stay IEEE-rounded.
// smer_dropout_keep_mask writes the keep mask from the same __device__ hash
// so the card can show it bit-equal to dropout_mask_reference.
//
// The launchers have a plain C interface and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHD = 64;        // head_dim
constexpr int kRows = 32;      // query rows a block (forward, backward rows)
constexpr int kKeys = 64;      // keys a staged tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kRowsPerWarp = kRows / (kThreads / 32);
constexpr int kLd = kHD + 1;   // padded row stride of a staged tile
constexpr float kMasked = -1e30f;

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

// _hash_keep of the TPU kernel, one element: bh = b * H + h, row absolute
__device__ __forceinline__ bool keep_at(const Drop& dr, uint32_t bh, uint32_t row,
                                        uint32_t col) {
  uint32_t h = dr.s0 + row * 0x9E3779B1u;
  h ^= col * 0x85EBCA77u;
  h += bh * 0xC2B2AE3Du;
  h = fmix32(h ^ dr.s1);
  h = fmix32(h + dr.s0);
  return h < dr.thr;
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
// forward: a block per (32 query rows, b * H + h)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    train_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const int* __restrict__ valid,
                     const int* __restrict__ seeds, uint32_t thr, int drop_on, float c,
                     int causal, __nv_bfloat16* __restrict__ out, int T, int S, int H,
                     int s_pad, float scale) {
  extern __shared__ float smem[];
  float* P = smem;                    // [kRows][s_pad]
  float* qs = P + kRows * s_pad;      // [kRows][kLd]
  float* ts = qs + kRows * kLd;       // [kKeys][kLd]: K tiles, then V tiles

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int t0 = blockIdx.x * kRows;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * kRowsPerWarp;
  const size_t stride = (size_t)H * kHD;
  const __nv_bfloat16* qb = q + (size_t)b * T * stride + h * kHD;
  const __nv_bfloat16* kb = k + (size_t)b * S * stride + h * kHD;
  const __nv_bfloat16* vb = v + (size_t)b * S * stride + h * kHD;
  const int* vrow = valid + (size_t)b * S;
  const Drop dr = make_drop(seeds, thr, drop_on, c);

  stage(qs, qb, stride, t0, kRows, T);
  scores_into(P, s_pad, qs, ts, kb, stride, vrow, causal, t0, S, scale);
  float m[kRowsPerWarp], l[kRowsPerWarp];
  softmax_rows(P, s_pad, vrow, causal, t0, S, m, l);
  // w -> the dropped bf16 weight, in place
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    float* pr = P + (r0 + i) * s_pad;
    const uint32_t row = t0 + r0 + i;
    for (int col = lane; col < S; col += 32) {
      const bool keep = dr.on ? keep_at(dr, bh, row, col) : true;
      pr[col] = dropped(bf16r(pr[col]), keep, dr);
    }
  }

  float o[kRowsPerWarp][2];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) o[i][0] = o[i][1] = 0.f;
  for (int k0 = 0; k0 < S; k0 += kKeys) {
    __syncthreads();
    stage(ts, vb, stride, k0, kKeys, S);
    __syncthreads();
    const int n = min(kKeys, S - k0);
    for (int s = 0; s < n; ++s) {
      const float v0 = ts[s * kLd + lane];
      const float v1 = ts[s * kLd + lane + 32];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float p = P[(r0 + i) * s_pad + k0 + s];
        o[i][0] = fmaf(p, v0, o[i][0]);
        o[i][1] = fmaf(p, v1, o[i][1]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = t0 + r0 + i;
    if (row >= T) continue;
    __nv_bfloat16* ob = out + ((size_t)b * T + row) * stride + h * kHD;
    ob[lane] = __float2bfloat16_rn(o[i][0]);
    ob[lane + 32] = __float2bfloat16_rn(o[i][1]);
  }
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

constexpr int kMaxKeys = 1024;

int s_pad_of(int S) { return (S + 31) / 32 * 32; }

size_t fwd_smem(int S) { return sizeof(float) * ((size_t)kRows * s_pad_of(S) + (kRows + kKeys) * kLd); }
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = fwd_smem(S);
  cudaError_t e = cudaFuncSetAttribute(train_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + kRows - 1) / kRows, B * H);
  train_fwd_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(valid),
      static_cast<const int*>(seeds), thr, drop_on, c, causal,
      static_cast<__nv_bfloat16*>(out), T, S, H, s_pad_of(S), 0.125f);
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
