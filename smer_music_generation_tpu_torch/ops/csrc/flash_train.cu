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
// ms), which the two kernels below do as seven (240 GFLOP, 0.243 ms: the
// scores and g V^T in both).  So operations bound both directions.
//
// Forward (flash_train_fwd_kernel), on the mma.sync tiles of attn_tiles.cuh
// (bf16 operands, f32 sums): a block of 4 warps owns 64 query rows
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
// Backward: FlashAttention-2's deterministic two kernels (no atomics, so a
// recompute gives the same bits), each warp-specialised for Hopper as
// FlashAttention-3 builds them (hopper.cuh): a block of three warpgroups,
// two consumers that run every product on wgmma (m64n64k16, f32 sums) and
// one producer whose first thread keeps TMA loads in flight into a
// four-stage ring of 64-row tiles (128-byte swizzle, completion on
// mbarriers; the consumers free a stage by an mbarrier arrival; with each
// tile's products waited for, two stages time the same,
// scripts/flash_train_variants.py); setmaxnreg gives the consumers 240
// registers and the producer 24.  The
// two consumers cover 128 rows: one library block, so the causal skip
// (query block qb visits key blocks kb <= qb) is whole tiles and only the
// diagonal block masks.  The elementwise work between the products (mask,
// p, ds) runs on the accumulators in registers, and p and ds reach the next
// products as bf16 A fragments in registers, never through shared memory.
// A tile's scores and g V^T are two wgmma groups, and p is computed while
// the second runs; the products that read p and ds are waited for before
// the next tile, because the compiler may hand an A fragment's registers
// to the next tile while an unfinished wgmma still reads them (overlapping
// them across tiles changed dq's bits).  Each thread keeps at most five
// 32-register accumulators live: the dk/dv kernel spills nothing; computing
// ds under dv's product instead kept six and spilled 208 bytes a thread.
//   flash_train_dq_kernel, a block per (128 query rows, b * H + h): Q, g and
//     the output of its rows by TMA once, Q and g into A fragments, di =
//     sum_d out g (f32, a quad's four partial dot products over 16 dims
//     each) written for the other kernel; 64-key tiles of K and V through
//     the ring; S = Q K^T and g V^T with K and V as K-major B, p and ds,
//     then dq += bf16(ds) K with K as MN-major B; writes dq once;
//   flash_train_dkv_kernel, a block per (128 keys, b * H + h): K and V of
//     its keys by TMA once, the A operands of S^T = K Q^T and (g V^T)^T =
//     V g^T from shared memory; 64-row tiles of Q and g and their rows'
//     m, l and di (bulk copies into the same stage) through the ring, from
//     the first row of the keys' block when causal (the producer
//     warpgroup's second warp turns each stage's l into 1 / l once); then
//     dv_tile = bf16(p)^T g and dk += bf16(ds)^T Q with g and Q as MN-major
//     B; writes dk and dv once.  Each query tile's dv is summed by wgmma into an
//     accumulator of its own (the first step overwrites it) and added to
//     the running dv by FADD: on an H100 the tensor cores' f32 accumulation
//     does not round to nearest, and a chain of T / 16 of them put dv
//     1.29e-4 (relative norm) from its twin at 2048x2048 where the twin's
//     f32 sum is 4.2e-5 from the float64 one, 0.91e-4 per tile
//     (scripts/dv_order_probe.py).  What remains is the tensor core's own
//     sum within a tile: a key that early causal rows weigh 1, 1/2, 1/3 ...
//     reads one bf16 ulp low (384x384 causal, ~2e-4).
// Both kernels use no atomics and no cross-block sums, so the pair is
// deterministic run to run.  Measured times, beside SDPA's and those of the
// earlier mma.sync pair, are in PERF.md (chip_smoke.py phase 2j,
// scripts/torch_kernel_ab.py).
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
#include "hopper.cuh"

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
// backward: warp-specialised blocks of three warpgroups on wgmma and TMA
// ---------------------------------------------------------------------------
constexpr int kBwdThreads = 384;          // consumer warpgroups 0 and 1, producer 2
constexpr int kConsumerThreads = 256;
constexpr int kStages = 4;                // the ring of 64-row tiles
constexpr int kBox = 64 * kHD;            // elements of one 64-row TMA box (8 KB)
constexpr uint32_t kBoxBytes = kBox * sizeof(__nv_bfloat16);

// the A fragments of rows row0 .. row0 + 15 (row0 a multiple of 16) of a
// 128-byte-swizzled tile, one per k16 chunk of head_dim
__device__ __forceinline__ void load_a_frags_b128(uint32_t a[kKC][4], const __nv_bfloat16* tile,
                                                  int row0, int lane) {
  const int r = row0 + (lane & 15);
  const unsigned char* row = reinterpret_cast<const unsigned char*>(tile) + r * 128;
#pragma unroll
  for (int kc = 0; kc < kKC; ++kc)
    ldsm_x4(a[kc], reinterpret_cast<const __nv_bfloat16*>(
                       row + (((2 * kc + (lane >> 4)) ^ (r & 7)) << 4)));
}

// the A fragment of k16 chunk kc from an accumulator: n-blocks 2 kc, 2 kc + 1
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float (&d)[32], int kc) {
  a[0] = pack_bf16(d[8 * kc], d[8 * kc + 1]);
  a[1] = pack_bf16(d[8 * kc + 2], d[8 * kc + 3]);
  a[2] = pack_bf16(d[8 * kc + 4], d[8 * kc + 5]);
  a[3] = pack_bf16(d[8 * kc + 6], d[8 * kc + 7]);
}

// a warpgroup's 64 x 64 f32 accumulator as bf16 into rows r0 .. r0 + 63 of
// one head of a (B, L, H, 64) tensor (`base` at that head's first row)
__device__ __forceinline__ void store_acc(__nv_bfloat16* base, size_t stride, const float (&d)[32],
                                          int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  __nv_bfloat16* r0 = base + (size_t)(16 * warp + g) * stride + 2 * t;
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(r0 + 8 * j) =
        __floats2bfloat162_rn(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<__nv_bfloat162*>(r0 + 8 * stride + 8 * j) =
        __floats2bfloat162_rn(d[4 * j + 2], d[4 * j + 3]);
  }
}

// the start of dynamic shared memory rounded up to 1024 bytes (the swizzle
// atom); launches ask for 1024 bytes more than they use
__device__ __forceinline__ unsigned char* smem_1024(unsigned char* raw) {
  const uint32_t a = hopper::smem_addr(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// ---------------------------------------------------------------------------
// backward, dq: a block per (128 query rows, b * H + h)
// ---------------------------------------------------------------------------
// shared: Q, g, O (2 boxes each) | K ring, V ring | key bits | barriers
constexpr size_t kDqTiles = (6 + 2 * kStages) * (size_t)kBoxBytes;

__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_train_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_o,
                          const __grid_constant__ CUtensorMap map_g, const int* __restrict__ valid,
                          const float* __restrict__ stats, int causal, float* __restrict__ di_out,
                          __nv_bfloat16* __restrict__ dq, int T, int S, int H) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // 128 rows each
  __nv_bfloat16* gs = qs + 2 * kBox;
  __nv_bfloat16* os = gs + 2 * kBox;
  __nv_bfloat16* kr = os + 2 * kBox;              // [kStages] 64-key tiles
  __nv_bfloat16* vr = kr + kStages * kBox;
  uint32_t* vbits = reinterpret_cast<uint32_t*>(smem + kDqTiles);
  uint64_t* bars = reinterpret_cast<uint64_t*>(vbits + S / 32);  // S % 128 == 0: 8-aligned
  uint64_t* qgo_bar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int qb = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // the longest first
  const int t0 = qb * kBlk;
  // 64-key tiles: all, or those of the 128-blocks at or below the diagonal
  const int n_kt = causal ? min(2 * (qb + 1), S / 64) : S / 64;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    hopper::mbar_init(qgo_bar, 1);
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(full + i, 1);
      hopper::mbar_init(empty + i, kConsumerThreads);
    }
    hopper::mbar_fence_init();
  }
  const int* vrow = valid + (size_t)b * S;
  for (int wi = warp; wi < S / 32; wi += kBwdThreads / 32) {
    const unsigned bits = __ballot_sync(0xffffffffu, vrow[32 * wi + lane] != 0);
    if (lane == 0) vbits[wi] = bits;
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {  // producer: one thread issues every load
    hopper::regs_producer();
    if (threadIdx.x == kConsumerThreads) {
      const int col = h * kHD, qrow = b * T + t0, krow = b * S;
      hopper::mbar_expect_tx(qgo_bar, 6 * kBoxBytes);
      for (int u = 0; u < 2; ++u) {
        hopper::tma_load_2d(qs + u * kBox, &map_q, col, qrow + 64 * u, qgo_bar);
        hopper::tma_load_2d(gs + u * kBox, &map_g, col, qrow + 64 * u, qgo_bar);
        hopper::tma_load_2d(os + u * kBox, &map_o, col, qrow + 64 * u, qgo_bar);
      }
      for (int it = 0; it < n_kt; ++it) {
        const int st = it % kStages;
        if (it >= kStages) hopper::mbar_wait(empty + st, (it / kStages - 1) & 1);
        hopper::mbar_expect_tx(full + st, 2 * kBoxBytes);
        hopper::tma_load_2d(kr + st * kBox, &map_k, col, krow + 64 * it, full + st);
        hopper::tma_load_2d(vr + st * kBox, &map_v, col, krow + 64 * it, full + st);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows wg * 64 .. + 63 of the block
  hopper::regs_consumer();
  const int wg = threadIdx.x / 128, w = warp % 4, g = lane >> 2, t = lane & 3;
  const int lr0 = wg * 64 + 16 * w + g;  // this thread's rows in the block: lr0, lr0 + 8
  hopper::mbar_wait(qgo_bar, 0);
  uint32_t qa[kKC][4], ga[kKC][4];
  load_a_frags_b128(qa, qs, wg * 64 + 16 * w, lane);
  load_a_frags_b128(ga, gs, wg * 64 + 16 * w, lane);
  const size_t BHT = (size_t)gridDim.y * T;
  float m[2], rl[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = lr0 + 8 * r;
    // di = sum_d out g: lane t of the quad takes dims 16 t .. 16 t + 15
    // (chunks 2 t, 2 t + 1 of the swizzled rows), the quad adds the four
    const unsigned char* orow = reinterpret_cast<const unsigned char*>(os) + lr * 128;
    const unsigned char* grow = reinterpret_cast<const unsigned char*>(gs) + lr * 128;
    float acc = 0.f;
#pragma unroll
    for (int c = 2 * t; c < 2 * t + 2; ++c) {
      const int off = (c ^ (lr & 7)) << 4;
      const uint4 ov = *reinterpret_cast<const uint4*>(orow + off);
      const uint4 gv = *reinterpret_cast<const uint4*>(grow + off);
      const __nv_bfloat16* o8 = reinterpret_cast<const __nv_bfloat16*>(&ov);
      const __nv_bfloat16* g8 = reinterpret_cast<const __nv_bfloat16*>(&gv);
#pragma unroll
      for (int x = 0; x < 8; ++x)
        acc = __fmaf_rn(__bfloat162float(o8[x]), __bfloat162float(g8[x]), acc);
    }
    di[r] = quad_sum(acc);
    const size_t at = (size_t)bh * T + t0 + lr;
    if (t == 0) di_out[at] = di[r];
    m[r] = stats[at];
    rl[r] = 1.f / stats[BHT + at];
  }

  float dqa[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dqa[i] = 0.f;
  for (int it = 0; it < n_kt; ++it) {
    const int st = it % kStages;
    hopper::mbar_wait(full + st, (it / kStages) & 1);
    const __nv_bfloat16* kt = kr + st * kBox;
    const __nv_bfloat16* vt = vr + st * kBox;
    const uint64_t dk_desc = hopper::desc_b128(kt), dv_desc = hopper::desc_b128(vt);
    float s[32], dp[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc)
      hopper::wgmma_rs<0>(s, qa[kc], dk_desc + kc * hopper::kDescK16KMajor, kc > 0);
    hopper::wgmma_commit();
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc)
      hopper::wgmma_rs<0>(dp, ga[kc], dv_desc + kc * hopper::kDescK16KMajor, kc > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // the scores are done; g V^T may still run
    hopper::fence_acc(s);
    // key 8 j + 2 t + x of the tile is bit 8 (j % 4) + x of word j / 4
    const uint32_t vw[2] = {vbits[2 * it] >> (2 * t), vbits[2 * it + 1] >> (2 * t)};
    const bool diag = causal && (it >> 1) == qb;
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, key = 64 * it + 8 * j + 2 * t + (e & 1);
        bool ok = (vw[j >> 2] >> (8 * (j & 3) + (e & 1))) & 1u;
        if (diag && key > t0 + lr0 + 8 * r) ok = false;
        // s / 8 + mask in one FFMA: s / 8 is exact
        const float sv = fmaf(s[4 * j + e], kScale, ok ? 0.f : kMaskValue);
        s[4 * j + e] = exp2_ftz((sv - m[r]) * kLog2e) * rl[r];  // p, under g V^T
      }
    hopper::wgmma_wait<0>();
    hopper::fence_acc(dp);
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[4 * j + e] = (dp[4 * j + e] - di[e >> 1]) * s[4 * j + e] * kScale;
    uint32_t da[kKC][4];  // bf16(ds), A fragments over the tile's keys
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc) acc_to_a(da[kc], s, kc);
    hopper::wgmma_fence();
    hopper::fence_acc(dqa);
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc)
      hopper::wgmma_rs<1>(dqa, da[kc], dk_desc + kc * hopper::kDescK16MnMajor, 1);
    hopper::wgmma_commit();
    // waited for here, not under the next tile's products: the compiler may
    // give da's registers to the next tile while this product still reads
    // them (a build that overlapped them gave other bits with 4 stages)
    hopper::wgmma_wait<0>();
    hopper::fence_acc(dqa);
    hopper::mbar_arrive(empty + st);  // this stage is read; the producer refills it
  }
  const size_t stride = (size_t)H * kHD;
  store_acc(dq + ((size_t)b * T + t0 + wg * 64) * stride + h * kHD, stride, dqa, w, lane);
}

// p = 2^((s / 8 + mask - m) log2(e)) (1 / l) in place over a dk/dv tile of
// transposed scores (row = key, column = query row of the tile); the rows'
// m from `rs`, 1 / l from `ri`; madd the keys' additive mask, and on the
// causal diagonal (DIAG) also the mask of a key past the row
template <bool DIAG>
__device__ __forceinline__ void p_tile(float (&sT)[32], const float* rs, const float* ri,
                                       const float madd[2], int key0, int tq0, int t) {
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    const int r0 = 8 * j + 2 * t;  // the pair's first row in the tile
    const float2 mm = *reinterpret_cast<const float2*>(rs + r0);
    const float2 rl = *reinterpret_cast<const float2*>(ri + r0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = e & 1;
      float mk = madd[e >> 1];
      if (DIAG && key0 + 8 * (e >> 1) > tq0 + r0 + x) mk = kMaskValue;
      const float sv = fmaf(sT[4 * j + e], kScale, mk);  // s / 8 is exact
      sT[4 * j + e] = exp2_ftz((sv - (x ? mm.y : mm.x)) * kLog2e) * (x ? rl.y : rl.x);
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dk and dv: a block per (128 keys, b * H + h)
// ---------------------------------------------------------------------------
// shared: K, V (2 boxes each) | Q ring, g ring | [kStages] m, l, di rows | [kStages] 1 / l |
// barriers
constexpr size_t kDkvTiles = (4 + 2 * kStages) * (size_t)kBoxBytes;
constexpr uint32_t kRowStatBytes = 3 * 64 * sizeof(float);

__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_train_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_g, const int* __restrict__ valid,
                           const float* __restrict__ stats, const float* __restrict__ di_in,
                           int causal, __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int T, int S, int H) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // 128 keys each
  __nv_bfloat16* vs = ks + 2 * kBox;
  __nv_bfloat16* qr = vs + 2 * kBox;  // [kStages] 64-row tiles
  __nv_bfloat16* gr = qr + kStages * kBox;
  float* rows = reinterpret_cast<float*>(smem + kDkvTiles);  // [kStages][3][64]: m, l, di
  float* rinv = rows + kStages * 3 * 64;                      // [kStages][64]: 1 / l
  uint64_t* bars = reinterpret_cast<uint64_t*>(rinv + kStages * 64);
  uint64_t* kv_bar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;
  uint64_t* conv = empty + kStages;  // a stage's 1 / l is written

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kb = blockIdx.x, c0 = kb * kBlk;
  // 64-row query tiles: all, or those of the 128-blocks at or below the keys'
  const int first = causal ? 2 * kb : 0;
  const int n_qt = max(T / 64 - first, 0);
  const size_t BHT = (size_t)gridDim.y * T;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_bar, 1);
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(full + i, 1);
      hopper::mbar_init(empty + i, kConsumerThreads);
      hopper::mbar_init(conv + i, 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {  // producer warpgroup
    hopper::regs_producer();
    if (threadIdx.x / 32 == kConsumerThreads / 32 + 1) {
      // its second warp turns each stage's l into 1 / l (rounded as 1.f / l)
      // once, off the consumers' path
      const int lane = threadIdx.x % 32;
      for (int it = 0; it < n_qt; ++it) {
        const int st = it % kStages;
        hopper::mbar_wait(full + st, (it / kStages) & 1);
        const float* l = rows + st * 3 * 64 + 64;
        rinv[st * 64 + lane] = __frcp_rn(l[lane]);
        rinv[st * 64 + 32 + lane] = __frcp_rn(l[32 + lane]);
        hopper::mbar_arrive(conv + st);
      }
    }
    if (threadIdx.x == kConsumerThreads) {
      const int col = h * kHD;
      hopper::mbar_expect_tx(kv_bar, 4 * kBoxBytes);
      for (int u = 0; u < 2; ++u) {
        hopper::tma_load_2d(ks + u * kBox, &map_k, col, b * S + c0 + 64 * u, kv_bar);
        hopper::tma_load_2d(vs + u * kBox, &map_v, col, b * S + c0 + 64 * u, kv_bar);
      }
      for (int it = 0; it < n_qt; ++it) {
        const int st = it % kStages, tq0 = (first + it) * 64;
        if (it >= kStages) hopper::mbar_wait(empty + st, (it / kStages - 1) & 1);
        hopper::mbar_expect_tx(full + st, 2 * kBoxBytes + kRowStatBytes);
        hopper::tma_load_2d(qr + st * kBox, &map_q, col, b * T + tq0, full + st);
        hopper::tma_load_2d(gr + st * kBox, &map_g, col, b * T + tq0, full + st);
        float* rs = rows + st * 3 * 64;
        const size_t at = (size_t)bh * T + tq0;
        hopper::bulk_load(rs, stats + at, 64 * sizeof(float), full + st);
        hopper::bulk_load(rs + 64, stats + BHT + at, 64 * sizeof(float), full + st);
        hopper::bulk_load(rs + 128, di_in + at, 64 * sizeof(float), full + st);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys c0 + wg * 64 .. + 63
  hopper::regs_consumer();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = threadIdx.x / 128, w = warp % 4, t = lane & 3;
  // this thread's two keys (rows g and g + 8 of the warp's 16) and their validity
  const int key0 = c0 + wg * 64 + 16 * w + (lane >> 2), key1 = key0 + 8;
  const int* vrow = valid + (size_t)b * S;
  const bool okk[2] = {vrow[key0] != 0, vrow[key1] != 0};
  hopper::mbar_wait(kv_bar, 0);
  // this warpgroup's 64 keys of K and V, the A operands of S^T and (g V^T)^T
  const uint64_t k_desc = hopper::desc_b128(ks + wg * kBox);
  const uint64_t v_desc = hopper::desc_b128(vs + wg * kBox);

  // the additive mask of this thread's two keys off the causal diagonal
  const float madd[2] = {okk[0] ? 0.f : kMaskValue, okk[1] ? 0.f : kMaskValue};

  float dka[32], dva[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;
  for (int it = 0; it < n_qt; ++it) {
    const int st = it % kStages, tq0 = (first + it) * 64;
    hopper::mbar_wait(full + st, (it / kStages) & 1);
    const uint64_t q_desc = hopper::desc_b128(qr + st * kBox);
    const uint64_t g_desc = hopper::desc_b128(gr + st * kBox);
    // the transposed scores and g . v: row = this warpgroup's key, column =
    // a query row of the tile
    float sT[32], dT[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc)
      hopper::wgmma_ss(sT, k_desc + kc * hopper::kDescK16KMajor,
                       q_desc + kc * hopper::kDescK16KMajor, kc > 0);
    hopper::wgmma_commit();
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc)
      hopper::wgmma_ss(dT, v_desc + kc * hopper::kDescK16KMajor,
                       g_desc + kc * hopper::kDescK16KMajor, kc > 0);
    hopper::wgmma_commit();
    hopper::mbar_wait(conv + st, (it / kStages) & 1);
    const float* rs = rows + st * 3 * 64;
    const float* ri = rinv + st * 64;
    hopper::wgmma_wait<1>();  // the scores are done; g V^T may still run
    hopper::fence_acc(sT);
    // p, under g V^T: some key of the block may be past some row of a tile
    // of the diagonal block
    if (causal && (tq0 >> 7) == kb)
      p_tile<true>(sT, rs, ri, madd, key0, tq0, t);
    else
      p_tile<false>(sT, rs, ri, madd, key0, tq0, t);
    hopper::wgmma_wait<0>();
    hopper::fence_acc(dT);
    // ds; then bf16(p)^T and bf16(ds)^T over the tile's rows.  dv's and dk's
    // products are waited for before the next tile: the compiler may give
    // pa's and da's registers to the next tile while they still read them
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      const float2 dd = *reinterpret_cast<const float2*>(rs + 128 + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dT[4 * j + e] = (dT[4 * j + e] - ((e & 1) ? dd.y : dd.x)) * sT[4 * j + e] * kScale;
    }
    uint32_t pa[kKC][4], da[kKC][4];
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc) {
      acc_to_a(pa[kc], sT, kc);
      acc_to_a(da[kc], dT, kc);
    }
    // this tile's dv in an accumulator of its own (the first step
    // overwrites it), added to dva by FADD: the header says why
    float dvt[32];
    hopper::wgmma_fence();
    hopper::fence_acc(dka);
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc)
      hopper::wgmma_rs<1>(dvt, pa[kc], g_desc + kc * hopper::kDescK16MnMajor, kc > 0);
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc)
      hopper::wgmma_rs<1>(dka, da[kc], q_desc + kc * hopper::kDescK16MnMajor, 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_acc(dvt);
    hopper::fence_acc(dka);
    hopper::mbar_arrive(empty + st);  // this stage is read; the producer refills it
#pragma unroll
    for (int i = 0; i < 32; ++i) dva[i] += dvt[i];
  }
  const size_t stride = (size_t)H * kHD;
  const size_t kofs = ((size_t)b * S + c0 + wg * 64) * stride + h * kHD;
  store_acc(dk + kofs, stride, dka, w, lane);
  store_acc(dv + kofs, stride, dva, w, lane);
}

constexpr int kMapRefused = 10000;  // + the CUresult of a tensor map the CUDA driver refuses

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
// the layouts of q, k, v.  Every pointer 16-byte aligned (TMA's and the
// bulk copies' requirement).  Returns a cudaError, or kMapRefused plus the
// CUDA driver's CUresult when it refuses a tensor map.
int smer_flash_train_bwd(int B, int T, int S, int H, const void* q, const void* k,
                         const void* v, const void* valid, const void* out, const void* stats,
                         const void* g, int causal, void* di, void* dq, void* dk, void* dv,
                         void* stream) {
  if (bad_shape(B, T, S, H)) return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out) || !aligned16(g) ||
      !aligned16(dq) || !aligned16(dk) || !aligned16(dv) || !aligned16(stats) || !aligned16(di))
    return (int)cudaErrorMisalignedAddress;
  const size_t smem_dq = 1024 + kDqTiles + S / 8 + (1 + 2 * kStages) * sizeof(uint64_t);
  const size_t smem_dkv = 1024 + kDkvTiles + kStages * (kRowStatBytes + 64 * sizeof(float)) +
                          (1 + 3 * kStages) * sizeof(uint64_t);
  // runtime calls first: they make the device's context current in this
  // thread (the backward may run on a thread of its own), which the CUDA driver
  // wants before it encodes a tensor map
  cudaError_t e = cudaFuncSetAttribute(flash_train_dq_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_train_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_dkv);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mq, mk, mv, mo, mg;
  int refused = hopper::head_map(&mq, q, (long long)B * T, H);
  if (!refused) refused = hopper::head_map(&mk, k, (long long)B * S, H);
  if (!refused) refused = hopper::head_map(&mv, v, (long long)B * S, H);
  if (!refused) refused = hopper::head_map(&mo, out, (long long)B * T, H);
  if (!refused) refused = hopper::head_map(&mg, g, (long long)B * T, H);
  if (refused) return kMapRefused + refused;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* vl = static_cast<const int*>(valid);
  const float* stt = static_cast<const float*>(stats);
  float* dib = static_cast<float*>(di);
  flash_train_dq_kernel<<<dim3(T / kBlk, B * H), kBwdThreads, smem_dq, st>>>(
      mq, mk, mv, mo, mg, vl, stt, causal, dib, static_cast<__nv_bfloat16*>(dq), T, S, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_train_dkv_kernel<<<dim3(S / kBlk, B * H), kBwdThreads, smem_dkv, st>>>(
      mq, mk, mv, mg, vl, stt, dib, causal, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), T, S, H);
  return (int)cudaGetLastError();
}

}  // extern "C"
