// Flash attention for training, with its recomputing backward, over
// (B, T|S, H, 64) bf16 tensors, for Hopper (sm_90a): the port of the
// library kernel the JAX model trains through with `flash_training`.
//
// Replaces `MultiHeadAttention.attend_flash_vjp`
// (smer_music_generation_tpu/models/transformer.py:360), which calls
// jax.experimental.pallas.ops.tpu.flash_attention: its forward
// `_flash_attention_kernel` (pallas_call :758 of that module) becomes
// flash_train_fwd_kernel, its `_flash_attention_dq_kernel` (:1456)
// flash_train_dq_kernel and its `_flash_attention_dkv_kernel` (:1121)
// flash_train_dkv_kernel.  The same function, with the model's arguments
// (q segment ids all ones, kv segment ids the key validity, sm_scale 1/8):
//   s = (q . k, f32 sums) / 8, plus DEFAULT_MASK_VALUE = -0.7 * f32 max
//       where the key is invalid or, when causal, past the row: the mask is
//       ADDED, so a row with no attendable key has every score at that value
//       and weighs its keys alike;
//   the keys in blocks of 128: when causal, a query row of block qb visits
//       the key blocks kb <= qb only (the library's `below_or_on_diag`);
//   an online softmax over the visited blocks: m = max(m, max s), p =
//       exp(s - m), l = exp(m_old - m) l + sum p, o = o exp(m_old - m) +
//       bf16(p) v (f32 sums); out = o / l in bf16; m and l kept per row
//       (when S is one block, as the library's one-step kernel: p / l is
//       rounded to bf16 and out = bf16(p / l) v);
//   backward, as the library's two kernels: p = exp(s - m) (1 / l), di =
//       sum_d out g (f32, from the bf16 output); dv = bf16(p)^T g; ds =
//       (g v^T - di) p / 8; dq = bf16(ds) k; dk = bf16(ds)^T q, all f32 sums.
// Every key a row visits takes part, masked or not: an invalid key's
// gradient is what the uniform rows (those with no attendable key) give it.
//
// What bounds it on an NVIDIA H100 (989 TFLOP/s dense bf16, 3.35 TB/s at
// 700 W): at the long training shape JAX documents for it (B=8, H=8,
// T=S=2048) the forward does 4 B H T S 64 = 68.7 GFLOP (0.069 ms) and
// moves 68 MB (0.020 ms); the backward's five products 172 GFLOP (0.174
// ms).  So operations bound it.  This first version is right and simple,
// on the mma.sync tiles of attn_tiles.cuh (bf16 operands, f32 sums), not
// yet wgmma with TMA: measured there on an NVIDIA H100 80GB HBM3, 700.00 W
// (chip_smoke.py phase 2j; PERF.md), 0.324 ms forward and 1.06-1.18 ms
// backward, beside 0.356 and 0.69-0.78 ms for torch's
// scaled_dot_product_attention with the same boolean mask.
//
// Forward (flash_train_fwd_kernel): a block of 4 warps owns 64 query rows
// of one (b, h), 16 a warp, their Q fragments loaded once into registers;
// 128-key blocks of K and V stream through a two-stage cp.async ring (the
// next block in flight while this one is used).  A warp takes its 16 x 128
// scores of a block by mma.sync, masks and scales them, updates its rows'
// m, l (a lane's partial sum over its 32 columns, rescaled as m grows, the
// quad's four added at the end) and 16 x 64 accumulator, and packs bf16(p)
// straight into the A fragments of the PV product.  m steps by the
// library's 128-key blocks, so every bf16(p) is rounded where the
// library rounds it.  Causal blocks run in reverse row order, the longest
// first.  Writes the output through the Q tile and m, l to a (2, B*H, T)
// f32 buffer.
//
// Backward (FlashAttention-2's deterministic two kernels on the same tiles,
// no atomics):
//   flash_train_dq_kernel, a block per (64 query rows, b * H + h): Q and g
//     held as A fragments, the O tile read once for di (a quad's four
//     partial dot products over 16 dims each), K and V blocks through the
//     ring; per 16-key chunk s and g V^T by mma.sync, p and ds, and dq +=
//     ds K with K's B fragments by ldmatrix.trans; writes dq and di;
//   flash_train_dkv_kernel, a block per (64 keys, b * H + h): K and V held
//     as A fragments, 64-row tiles of Q and g (and their m, 1 / l and di)
//     through the ring from the first row of the keys' 128-block when
//     causal; S^T = K Q^T and (g V^T)^T = V g^T by mma.sync, then dv +=
//     bf16(p)^T g and dk += bf16(ds)^T Q; writes dk and dv once.  Each
//     query tile's dv is summed by mma.sync into an accumulator of its own
//     and added to the running dv by FADD: on an H100 the tensor cores'
//     f32 accumulation does not round to nearest, and a chain of T / 16 of
//     them put dv 1.29e-4 (relative norm) from its twin at 2048x2048, where
//     the twin's f32 sum is 4.2e-5 from the float64 one; per tile it is
//     0.91e-4 (scripts/dv_order_probe.py), for 236 registers (2 blocks an
//     SM, not 3) and ~11% of the kernel's time.  What remains is the
//     mma's own sum of 16 terms of unlike size: a key that early causal
//     rows weigh 1, 1/2, 1/3 ... reads one bf16 ulp low (384x384 causal,
//     2.1e-4).
// exp is 2^((s - m) log2(e)) by exp2_ftz (one MUFU.EX2), the difference
// taken first: with the additive mask a uniform row has s = m exactly, and
// its p must be exactly 1 (2^(s log2(e) - m log2(e)) would take the
// rounding error of two products near 3e38).  On an H100 ex2.approx.ftz
// gives torch.exp2's bits wherever 2^x is a normal float
// (scripts/dv_order_probe.py: no difference over 2^24 values in [-60, 1]),
// so the twins' exp2 is the kernels' bit for bit.
//
// The launchers have a plain C interface and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tiles.cuh"

namespace {

using namespace attn_tiles;

constexpr int kBlk = 128;                   // the library's block: keys a softmax step
constexpr int kBlkNB = kBlk / 8;            // n-blocks of a warp's 16 x 128 scores
constexpr int kBlkElems = kBlk * kTileLd;  // a 128-row shared tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kScale = 0.125f;  // 1 / sqrt(64)
// the library's DEFAULT_MASK_VALUE, -0.7 * f32 max taken in double, then f32
constexpr float kMaskValue = (float)(-0.7 * 3.4028234663852886e38);

// rows p0 .. p0 + 127 of one head into a 128-row shared tile
__device__ __forceinline__ void load_block(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                           size_t stride, int p0, int limit) {
  load_tile(dst, base, stride, p0, limit);
  load_tile(dst + kTileElems, base, stride, p0 + 64, limit);
}

// The validity of one batch row's S keys as bits (S % 32 == 0); the caller
// places a block barrier before reading them.
__device__ __forceinline__ void key_bits(uint32_t* vbits, const int* valid, int S, int warp,
                                         int lane) {
  for (int wi = warp; wi < S / 32; wi += kWarps) {
    const unsigned bits = __ballot_sync(0xffffffffu, valid[32 * wi + lane] != 0);
    if (lane == 0) vbits[wi] = bits;
  }
}

// The library's scores from q . k: s / 8, plus kMaskValue where the key is
// invalid or, on the causal diagonal block, past the row.  s holds n-blocks
// j0 .. j0 + NJ - 1 of this warp's 16 rows (row0, row0 + 8) against the
// 128-key block at kb0; vw are the block's four validity words, each shifted
// right by 2 t, so key 8 j + 2 t + x of the block is bit 8 (j % 4) + x of
// word j / 4.
template <int NJ>
__device__ __forceinline__ void mask_scores(float s[][4], const uint32_t vw[4], int kb0, int j0,
                                            bool diag, int row0, int t) {
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + jj;
      bool ok = (vw[j >> 2] >> (8 * (j & 3) + (e & 1))) & 1u;
      if (diag && kb0 + 8 * j + 2 * t + (e & 1) > (e < 2 ? row0 : row0 + 8)) ok = false;
      s[jj][e] = s[jj][e] * kScale + (ok ? 0.f : kMaskValue);
    }
}

__device__ __forceinline__ void load_vw(uint32_t vw[4], const uint32_t* vbits, int blk, int t) {
#pragma unroll
  for (int u = 0; u < 4; ++u) vw[u] = vbits[4 * blk + u] >> (2 * t);
}

// ---------------------------------------------------------------------------
// forward: a block per (64 query rows, b * H + h)
// ---------------------------------------------------------------------------
constexpr size_t kFwdSmem = (kTileElems + 4 * kBlkElems) * sizeof(__nv_bfloat16);

__global__ void __launch_bounds__(kThreads, 2)
    flash_train_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, const int* __restrict__ valid,
                           int causal, __nv_bfloat16* __restrict__ out,
                           float* __restrict__ stats, int T, int S, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // Q, then the output
  __nv_bfloat16* ks = qs + kTileElems;                          // K ring, 2 stages
  __nv_bfloat16* vs = ks + 2 * kBlkElems;                       // V ring, 2 stages
  uint32_t* vbits = reinterpret_cast<uint32_t*>(vs + 2 * kBlkElems);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int t0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kQTile;
  const size_t stride = (size_t)H * kHD;
  const __nv_bfloat16* kb = k + (size_t)b * S * stride + h * kHD;
  const __nv_bfloat16* vb = v + (size_t)b * S * stride + h * kHD;
  // the key blocks the rows visit: all, or those at or below the diagonal
  const int n_blk = causal ? min(t0 / kBlk + 1, S / kBlk) : S / kBlk;
  const bool single = S == kBlk;

  load_tile(qs, q + (size_t)b * T * stride + h * kHD, stride, t0, T);
  load_block(ks, kb, stride, 0, S);
  load_block(vs, vb, stride, 0, S);
  cp_async_commit();
  key_bits(vbits, valid + (size_t)b * S, S, warp, lane);

  const int row0 = t0 + 16 * warp + g;
  uint32_t qa[kKC][4];
  float o[kNB][4];
#pragma unroll
  for (int j = 0; j < kNB; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int i = 0; i < n_blk; ++i) {
    if (i + 1 < n_blk) {
      load_block(ks + ((i + 1) & 1) * kBlkElems, kb, stride, (i + 1) * kBlk, S);
      load_block(vs + ((i + 1) & 1) * kBlkElems, vb, stride, (i + 1) * kBlk, S);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this block's tiles (and Q) have landed
    __syncthreads();
    if (i == 0) load_a_frags(qa, qs, warp, lane);
    const __nv_bfloat16* kt = ks + (i & 1) * kBlkElems;
    const __nv_bfloat16* vt = vs + (i & 1) * kBlkElems;

    float s[kBlkNB][4];
    qk_blocks<kBlkNB>(s, qa, kt, 0, lane);
    uint32_t vw[4];
    load_vw(vw, vbits, i, t);
    mask_scores<kBlkNB>(s, vw, i * kBlk, 0, causal && i == t0 / kBlk, row0, t);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBlkNB; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      const float m_new = fmaxf(m[r], quad_max(mx));
      const float alpha = exp2_ftz((m[r] - m_new) * kLog2e);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBlkNB; ++j) {
        s[j][2 * r] = exp2_ftz((s[j][2 * r] - m_new) * kLog2e);
        s[j][2 * r + 1] = exp2_ftz((s[j][2 * r + 1] - m_new) * kLog2e);
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      if (single) {  // the library's one-step kernel: p divided by l before the cast
        l[r] = quad_sum(sum);
#pragma unroll
        for (int j = 0; j < kBlkNB; ++j) {
          s[j][2 * r] = s[j][2 * r] / l[r];
          s[j][2 * r + 1] = s[j][2 * r + 1] / l[r];
        }
      } else {
        l[r] = __fmaf_rn(alpha, l[r], sum);
      }
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int kc = 0; kc < kBlk / 16; ++kc) {
      const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      pv_chunk(o, a, vt, kc, lane);
    }
    __syncthreads();  // this stage is read; the next step refills it
  }
  cp_async_wait<0>();
  __syncthreads();

  float inv[2] = {1.f, 1.f};
  if (!single) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      inv[r] = 1.f / l[r];
    }
  }
  stage_out(qs, o, inv[0], inv[1], warp, lane);
  __syncthreads();
  store_out(out + (size_t)b * T * stride + h * kHD, qs, stride, t0, T);
  if (t == 0) {
    const size_t BHT = (size_t)gridDim.y * T;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t at = (size_t)bh * T + row0 + 8 * r;
      stats[at] = m[r];
      stats[BHT + at] = l[r];
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dq: a block per (64 query rows, b * H + h)
// ---------------------------------------------------------------------------
constexpr size_t kDqSmem = (3 * kTileElems + 4 * kBlkElems) * sizeof(__nv_bfloat16);

__global__ void __launch_bounds__(kThreads, 2)
    flash_train_dq_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, const int* __restrict__ valid,
                          const __nv_bfloat16* __restrict__ o,
                          const float* __restrict__ stats, const __nv_bfloat16* __restrict__ g,
                          int causal, float* __restrict__ di_out,
                          __nv_bfloat16* __restrict__ dq, int T, int S, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // Q, then dq
  __nv_bfloat16* gs = qs + kTileElems;                          // g
  __nv_bfloat16* os = gs + kTileElems;                          // the output
  __nv_bfloat16* ks = os + kTileElems;                          // K ring, 2 stages
  __nv_bfloat16* vs = ks + 2 * kBlkElems;                       // V ring, 2 stages
  uint32_t* vbits = reinterpret_cast<uint32_t*>(vs + 2 * kBlkElems);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int t0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kQTile;
  const size_t stride = (size_t)H * kHD;
  const size_t qoff = (size_t)b * T * stride + h * kHD;
  const __nv_bfloat16* kb = k + (size_t)b * S * stride + h * kHD;
  const __nv_bfloat16* vb = v + (size_t)b * S * stride + h * kHD;
  const int n_blk = causal ? min(t0 / kBlk + 1, S / kBlk) : S / kBlk;

  load_tile(qs, q + qoff, stride, t0, T);
  load_tile(gs, g + qoff, stride, t0, T);
  load_tile(os, o + qoff, stride, t0, T);
  load_block(ks, kb, stride, 0, S);
  load_block(vs, vb, stride, 0, S);
  cp_async_commit();
  key_bits(vbits, valid + (size_t)b * S, S, warp, lane);

  const int row0 = t0 + 16 * warp + (lane >> 2);
  const size_t BHT = (size_t)gridDim.y * T;
  float m[2], rl[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t at = (size_t)bh * T + row0 + 8 * r;
    m[r] = stats[at];
    rl[r] = 1.f / stats[BHT + at];
  }
  uint32_t qa[kKC][4], ga[kKC][4];
  float dqa[kNB][4];
#pragma unroll
  for (int j = 0; j < kNB; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;

  for (int i = 0; i < n_blk; ++i) {
    if (i + 1 < n_blk) {
      load_block(ks + ((i + 1) & 1) * kBlkElems, kb, stride, (i + 1) * kBlk, S);
      load_block(vs + ((i + 1) & 1) * kBlkElems, vb, stride, (i + 1) * kBlk, S);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this block's tiles (and Q, g, O) have landed
    __syncthreads();
    if (i == 0) {
      load_a_frags(qa, qs, warp, lane);
      load_a_frags(ga, gs, warp, lane);
      // di = sum_d out g of this lane's two rows: lane t of the quad takes
      // dims 16 t .. 16 t + 15, the quad adds the four
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = 16 * warp + (lane >> 2) + 8 * r;
        float acc = 0.f;
#pragma unroll
        for (int d = 16 * t; d < 16 * t + 16; ++d)
          acc = __fmaf_rn(__bfloat162float(os[rr * kTileLd + d]),
                          __bfloat162float(gs[rr * kTileLd + d]), acc);
        di[r] = quad_sum(acc);
        if (t == 0) di_out[(size_t)bh * T + row0 + 8 * r] = di[r];
      }
    }
    const __nv_bfloat16* kt = ks + (i & 1) * kBlkElems;
    const __nv_bfloat16* vt = vs + (i & 1) * kBlkElems;
    uint32_t vw[4];
    load_vw(vw, vbits, i, t);
    const bool diag = causal && i == t0 / kBlk;
#pragma unroll
    for (int kc = 0; kc < kBlk / 16; ++kc) {
      float s[2][4], dp[2][4];
      qk_blocks<2>(s, qa, kt, 2 * kc, lane);
      qk_blocks<2>(dp, ga, vt, 2 * kc, lane);
      mask_scores<2>(s, vw, i * kBlk, 2 * kc, diag, row0, t);
      uint32_t a[4];  // A fragments of bf16(ds) for this chunk of keys
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float ds[2];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const float p = exp2_ftz((s[jj][2 * r + x] - m[r]) * kLog2e) * rl[r];
            ds[x] = (dp[jj][2 * r + x] - di[r]) * p * kScale;
          }
          a[2 * jj + r] = pack_bf16(ds[0], ds[1]);
        }
      pv_chunk(dqa, a, kt, kc, lane);
    }
    __syncthreads();  // this stage is read; the next step refills it
  }
  cp_async_wait<0>();
  __syncthreads();

  stage_out(qs, dqa, 1.f, 1.f, warp, lane);
  __syncthreads();
  store_out(dq + qoff, qs, stride, t0, T);
}

// ---------------------------------------------------------------------------
// backward, dk and dv: a block per (64 keys, b * H + h)
// ---------------------------------------------------------------------------
constexpr size_t kDkvSmem = 6 * kTileElems * sizeof(__nv_bfloat16) +
                            2 * (kQTile * sizeof(float4) + 3 * kQTile * sizeof(float));

// Rows r0 .. r0 + 63 of Q and g, and their m, l and di ([3][kQTile] f32),
// into one stage of the ring.  Thread i < 64 copies row i's three numbers
// itself, so once its own copies have landed it converts them without a
// block barrier.
__device__ __forceinline__ void load_rows(__nv_bfloat16* qt, __nv_bfloat16* gt, float* raw,
                                          const __nv_bfloat16* qb, const __nv_bfloat16* gb,
                                          size_t stride, const float* m_bh, const float* l_bh,
                                          const float* di_bh, int r0, int T) {
  load_tile(qt, qb, stride, r0, T);
  load_tile(gt, gb, stride, r0, T);
  if (threadIdx.x < kQTile) {
    const int r = r0 + threadIdx.x;
    cp_async4(raw + threadIdx.x, m_bh + r, true);
    cp_async4(raw + kQTile + threadIdx.x, l_bh + r, true);
    cp_async4(raw + 2 * kQTile + threadIdx.x, di_bh + r, true);
  }
}

// a stage's rows as the kernel uses them, one float4 a row: m, 1 / l, di
__device__ __forceinline__ void convert_rows(float4* st, const float* raw) {
  if (threadIdx.x < kQTile)
    st[threadIdx.x] = make_float4(raw[threadIdx.x], 1.f / raw[kQTile + threadIdx.x],
                                  raw[2 * kQTile + threadIdx.x], 0.f);
}

__global__ void __launch_bounds__(kThreads, 2)
    flash_train_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, const int* __restrict__ valid,
                           const float* __restrict__ stats, const float* __restrict__ di,
                           const __nv_bfloat16* __restrict__ g, int causal,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           int T, int S, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // K, then dk
  __nv_bfloat16* vs = ks + kTileElems;                          // V, then dv
  __nv_bfloat16* qs = vs + kTileElems;                          // Q ring, 2 stages
  __nv_bfloat16* gs = qs + 2 * kTileElems;                      // g ring, 2 stages
  float4* sts = reinterpret_cast<float4*>(gs + 2 * kTileElems);  // [2][kQTile] converted
  float* raw = reinterpret_cast<float*>(sts + 2 * kQTile);        // [2][3][kQTile]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int c0 = blockIdx.x * kKTile;
  const size_t stride = (size_t)H * kHD;
  const __nv_bfloat16* qb = q + (size_t)b * T * stride + h * kHD;
  const __nv_bfloat16* gb = g + (size_t)b * T * stride + h * kHD;
  const size_t BHT = (size_t)gridDim.y * T;
  const float* m_bh = stats + (size_t)bh * T;
  const float* l_bh = stats + BHT + (size_t)bh * T;
  const float* di_bh = di + (size_t)bh * T;

  // this lane's two keys (rows g and g + 8 of the warp's 16) and their
  // validity; when causal, the query rows from the first of the keys'
  // 128-block on (a row block visits the key blocks at or below it)
  const int key0 = c0 + 16 * warp + (lane >> 2), key1 = key0 + 8;
  const int* vrow = valid + (size_t)b * S;
  const bool okk[2] = {vrow[key0] != 0, vrow[key1] != 0};
  const int first = causal ? (c0 / kBlk) * (kBlk / kQTile) : 0;
  const int n_q = T / kQTile;

  load_tile(ks, k + (size_t)b * S * stride + h * kHD, stride, c0, S);
  load_tile(vs, v + (size_t)b * S * stride + h * kHD, stride, c0, S);
  if (first < n_q)
    load_rows(qs, gs, raw, qb, gb, stride, m_bh, l_bh, di_bh, first * kQTile, T);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  convert_rows(sts, raw);

  uint32_t ka[kKC][4], va[kKC][4];
  load_a_frags(ka, ks, warp, lane);
  load_a_frags(va, vs, warp, lane);
  float dka[kNB][4], dva[kNB][4];
#pragma unroll
  for (int j = 0; j < kNB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int i = first; i < n_q; ++i) {
    const int stg = (i - first) & 1, tq0 = i * kQTile;
    if (i + 1 < n_q)
      load_rows(qs + (stg ^ 1) * kTileElems, gs + (stg ^ 1) * kTileElems,
                raw + (stg ^ 1) * 3 * kQTile, qb, gb, stride, m_bh, l_bh, di_bh, tq0 + kQTile, T);
    cp_async_commit();
    cp_async_wait<1>();  // this step's tiles have landed
    __syncthreads();     // ... for every thread, and so have their converted rows
    const __nv_bfloat16* qt = qs + stg * kTileElems;
    const __nv_bfloat16* gt = gs + stg * kTileElems;
    const float4* st = sts + stg * kQTile;
    // some key of the warp may be past some row of the tile
    const bool diag = causal && tq0 < c0 + 16 * warp + 16;
    // this tile's dv in an accumulator of its own, added to dva by FADD
    // (the header says why)
    float dvt[kNB][4];
#pragma unroll
    for (int j = 0; j < kNB; ++j) dvt[j][0] = dvt[j][1] = dvt[j][2] = dvt[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kQTile / 16; ++kc) {
      // the transposed scores and g . v of rows 16 kc .. 16 kc + 15 of the
      // tile: row = this warp's key, column = a query row
      float sT[2][4], dT[2][4];
      qk_blocks<2>(sT, ka, qt, 2 * kc, lane);
      qk_blocks<2>(dT, va, gt, 2 * kc, lane);
      uint32_t aw[4], ad[4];  // A fragments of bf16(p)^T and bf16(ds)^T
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int rl = 8 * (2 * kc + jj) + 2 * t;  // the pair's first row in the tile
        const float4 rs[2] = {st[rl], st[rl + 1]};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float p[2], ds[2];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const bool ok = okk[r] && !(diag && (r ? key1 : key0) > tq0 + rl + x);
            const float s = sT[jj][2 * r + x] * kScale + (ok ? 0.f : kMaskValue);
            p[x] = exp2_ftz((s - rs[x].x) * kLog2e) * rs[x].y;
            ds[x] = (dT[jj][2 * r + x] - rs[x].z) * p[x] * kScale;
          }
          aw[2 * jj + r] = pack_bf16(p[0], p[1]);
          ad[2 * jj + r] = pack_bf16(ds[0], ds[1]);
        }
      }
      pv_chunk(dvt, aw, gt, kc, lane);
      pv_chunk(dka, ad, qt, kc, lane);
    }
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dva[j][e] += dvt[j][e];
    if (i + 1 < n_q) {  // the next stage's rows, converted while this one is done
      cp_async_wait<0>();
      convert_rows(sts + (stg ^ 1) * kQTile, raw + (stg ^ 1) * 3 * kQTile);
    }
    __syncthreads();  // this stage is read; the next step refills it
  }
  cp_async_wait<0>();
  __syncthreads();

  stage_out(ks, dka, 1.f, 1.f, warp, lane);
  stage_out(vs, dva, 1.f, 1.f, warp, lane);
  __syncthreads();
  store_out(dk + (size_t)b * S * stride + h * kHD, ks, stride, c0, S);
  store_out(dv + (size_t)b * S * stride + h * kHD, vs, stride, c0, S);
}

bool bad_shape(int B, int T, int S, int H) {
  return B < 1 || H < 1 || T < kBlk || S < kBlk || T % kBlk || S % kBlk || B * H > 65535;
}

}  // namespace

extern "C" {

// q (B, T, H, 64), k and v (B, S, H, 64), out (B, T, H, 64): bf16,
// contiguous; valid (B, S) int32 (nonzero = attendable); T and S multiples
// of 128; stats (2, B*H, T) f32 receives each row's m and l.
int smer_flash_train_fwd(int B, int T, int S, int H, const void* q, const void* k,
                         const void* v, const void* valid, int causal, void* out, void* stats,
                         void* stream) {
  if (bad_shape(B, T, S, H)) return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  const size_t smem = kFwdSmem + S / 8;
  cudaError_t e = cudaFuncSetAttribute(flash_train_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(T / kQTile, B * H);
  flash_train_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(valid), causal,
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(stats), T, S, H);
  return (int)cudaGetLastError();
}

// The backward of smer_flash_train_fwd: out and stats as it wrote them, g
// (B, T, H, 64) bf16; di a (B*H, T) f32 scratch buffer; dq, dk, dv bf16 in
// the layouts of q, k, v.
int smer_flash_train_bwd(int B, int T, int S, int H, const void* q, const void* k,
                         const void* v, const void* valid, const void* out, const void* stats,
                         const void* g, int causal, void* di, void* dq, void* dk, void* dv,
                         void* stream) {
  if (bad_shape(B, T, S, H)) return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out) || !aligned16(g) ||
      !aligned16(dq) || !aligned16(dk) || !aligned16(dv))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  const int* vl = static_cast<const int*>(valid);
  const float* stt = static_cast<const float*>(stats);
  float* dib = static_cast<float*>(di);
  const size_t smem_dq = kDqSmem + S / 8;
  cudaError_t e = cudaFuncSetAttribute(flash_train_dq_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_train_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kDkvSmem);
  if (e != cudaSuccess) return (int)e;
  flash_train_dq_kernel<<<dim3(T / kQTile, B * H), kThreads, smem_dq, st>>>(
      qb, kb, vb, vl, static_cast<const __nv_bfloat16*>(out), stt, gb, causal, dib,
      static_cast<__nv_bfloat16*>(dq), T, S, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_train_dkv_kernel<<<dim3(S / kKTile, B * H), kThreads, kDkvSmem, st>>>(
      qb, kb, vb, vl, stt, dib, gb, causal, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), T, S, H);
  return (int)cudaGetLastError();
}

}  // extern "C"
