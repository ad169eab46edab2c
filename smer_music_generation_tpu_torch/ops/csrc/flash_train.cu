// Flash attention for training, with its recomputing backward, over
// (B, T|S, H, HD) bf16 tensors, HD = 64 or 128 (every kernel a template of
// it), for Hopper (sm_90a): the port of the library kernel the JAX model
// trains through with `flash_training`.  f32 inputs take the kernels of
// attention_f32.cu.
//
// Replaces `MultiHeadAttention.attend_flash_vjp`
// (smer_music_generation_tpu/models/transformer.py:360), which calls
// jax.experimental.pallas.ops.tpu.flash_attention: its forward
// `_flash_attention_kernel` (pallas_call :758 of that module) becomes
// flash_train_fwd_kernel, its `_flash_attention_dq_kernel` (:1456)
// flash_train_dq_kernel and its `_flash_attention_dkv_kernel` (:1121)
// flash_train_dkv_kernel.  The same function, with the model's arguments
// (q segment ids all ones, kv segment ids the key validity, sm_scale
// 1/sqrt(HD), which the kernels take from the caller):
//   s = (q . k, f32 sums) scale, plus DEFAULT_MASK_VALUE = -0.7 * f32 max
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
//       (g v^T - di) p scale; dq = bf16(ds) k; dk = bf16(ds)^T q, all f32 sums.
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
// Forward (flash_train_fwd_kernel), FlashAttention-3's forward on the
// building blocks of hopper.cuh: a block per (128 query rows, b * H + h) of
// three warpgroups, two consumers of 64 rows each and a producer whose first
// thread loads Q once and the 128-key blocks of K and V by TMA into rings of
// two stages each (128-byte swizzle, two boxes a row at head_dim 128; K and
// V on barriers of their own, so a block's K is freed once its scores are
// done and its V once its P V is); setmaxnreg gives the consumers 240
// registers.  128 rows are one library block, so the causal skip is whole
// blocks and only the diagonal block masks.  A consumer takes S = Q K^T of
// its 64 rows against the block's 128 keys as one m64n128 wgmma chain (Q
// and K both from shared memory, K-major), masks and scales the accumulator
// in registers, updates its rows' m, l (a lane's partial sum over its 32
// columns, rescaled as m grows, the quad's four added at the end) and its
// 64 x HD output accumulator, and packs bf16(p) straight from the
// accumulator into the A fragments of O += P V (V as the MN-major B, one
// m64n64 chain per 64 columns of head_dim).  The two consumers take turns
// to issue their products (named barriers: one's softmax runs under the
// other's products).  At head_dim 64, P_{i-1} V_{i-1} is issued right behind
// S_i and the scale 1/8 (a power of two) goes into the exponent's
// difference on a block with no mask; at 128, where S, O and P together
// would spill, P_i V_i follows block i's softmax.  Every PV product is
// waited for before P is packed again: a wgmma reads its register A
// fragments after it issues.  m steps by the library's 128-key blocks, so
// every bf16(p) is rounded where the library rounds it; the output and m,
// l have the bits of the mma.sync forward this kernel replaced.  Causal
// blocks run in reverse row order, the longest first.  Writes the output
// from the accumulator and m, l to a (2, B*H, T) f32 buffer.  What limits
// it at head_dim 64: the products and the pipeline alone take ~0.14 ms of
// ~0.20 at B8 H8 2048 x 2048 with every key valid; the softmax (one
// MUFU.EX2 and ~6 other instructions an element) is only partly hidden
// under them, and a block with a masked key costs more (PERF.md;
// scripts/flash_train_variants.py --forward measures each part).
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
// registers and the producer 24.  At head_dim 128 the ring has two stages
// (a 64-row tile is two boxes), the dq kernel reads Q and g as the A
// operands from shared memory instead of registers, and the dk/dv grid is
// doubled: one half of its blocks (blockIdx.z = 0) sums dk, the other dv,
// since dk, dv and a tile's dv at 64 x 128 would take 3 x 64 f32 registers
// a thread beside the scores.  The
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

constexpr int kBlk = 128;  // the library's block: keys a softmax step, rows a block
constexpr float kLog2e = 1.4426950408889634f;
// the library's DEFAULT_MASK_VALUE, -0.7 * f32 max taken in double, then f32
constexpr float kMaskValue = (float)(-0.7 * 3.4028234663852886e38);
// The backward pair's scale: at head_dim 64 the wrapper's 1 / sqrt(64) as a
// compile-time constant, else the scale the wrapper passes.  The entry point
// refuses any other scale at 64.  A runtime scale there gave each kernel's
// loop 32 more FMUL a 64-key tile and dk/dv 1-5% more time at B8 H8
// 2048x2048 (scripts/torch_kernel_ab.py; scripts/flash_train_variants.py
// bwd_runtime_scale); dq's time did not show it.
template <int HD>
__device__ __forceinline__ float fixed_scale(float scale) {
  return HD == 64 ? 0.125f : scale;
}

constexpr int kWsThreads = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int kConsumerThreads = 256;
constexpr int kBox = 64 * 64;    // elements of one TMA box: 64 rows x 64 columns (8 KB)
constexpr uint32_t kBoxBytes = kBox * sizeof(__nv_bfloat16);

// The validity of one batch row's S keys as bits (S % 32 == 0), every warp
// of the block taking part; the caller places a block barrier before reading.
__device__ __forceinline__ void key_bits(uint32_t* vbits, const int* valid, int S) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int wi = warp; wi < S / 32; wi += blockDim.x / 32) {
    const unsigned bits = __ballot_sync(0xffffffffu, valid[32 * wi + lane] != 0);
    if (lane == 0) vbits[wi] = bits;
  }
}

// the A fragments of rows row0 .. row0 + 15 (row0 a multiple of 16) of a
// 128-byte-swizzled tile at head_dim 64, one per k16 chunk
__device__ __forceinline__ void load_a_frags_b128(uint32_t a[kKC<64>][4],
                                                  const __nv_bfloat16* tile, int row0, int lane) {
  const int r = row0 + (lane & 15);
  const unsigned char* row = reinterpret_cast<const unsigned char*>(tile) + r * 128;
#pragma unroll
  for (int kc = 0; kc < kKC<64>; ++kc)
    ldsm_x4(a[kc], reinterpret_cast<const __nv_bfloat16*>(
                       row + (((2 * kc + (lane >> 4)) ^ (r & 7)) << 4)));
}

// the A fragment of k16 chunk kc from an accumulator: n-blocks 2 kc, 2 kc + 1
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float (&d)[N], int kc) {
  a[0] = pack_bf16(d[8 * kc], d[8 * kc + 1]);
  a[1] = pack_bf16(d[8 * kc + 2], d[8 * kc + 3]);
  a[2] = pack_bf16(d[8 * kc + 4], d[8 * kc + 5]);
  a[3] = pack_bf16(d[8 * kc + 6], d[8 * kc + 7]);
}

// a warpgroup's 64 x 64 f32 accumulator as bf16 into rows r0 .. r0 + 63 and
// 64 columns of a (B, L, H, HD) tensor (`base` at the first row and column)
__device__ __forceinline__ void store_acc(__nv_bfloat16* base, size_t stride, const float (&d)[32],
                                          int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  __nv_bfloat16* r0 = base + (size_t)(16 * warp + g) * stride + 2 * t;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
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

// The descriptor of k16 step kc of a K-major operand over head_dim whose
// 64-column halves lie `half_bytes` apart (steps 0-3 in the first half).
__device__ __forceinline__ uint64_t kmajor_step(const __nv_bfloat16* tile, int kc,
                                                uint32_t half_bytes) {
  return hopper::desc_b128(reinterpret_cast<const unsigned char*>(tile) + (kc / 4) * half_bytes) +
         (kc % 4) * hopper::kDescK16KMajor;
}

// ---------------------------------------------------------------------------
// forward: a block per (128 query rows, b * H + h), warp-specialised
// ---------------------------------------------------------------------------
// shared: Q (one 128-row tile) | K ring | V ring (128-key tiles) | key bits |
// barriers.  A 128-row tile is HD / 64 column halves of two 64-row boxes.
// K and V have rings (and barriers) of their own: block i's K is read once
// S_i is done, its V once P_i V_i is, a block later.
constexpr int kFwdStages = 2;
template <int HD>
constexpr uint32_t kBlkTileBytes = 2 * (HD / 64) * kBoxBytes;
template <int HD>
constexpr size_t kFwdTiles = (1 + 2 * kFwdStages) * (size_t)kBlkTileBytes<HD>;
constexpr int kFwdBars = 1 + 4 * kFwdStages;
// P_{i-1} V_{i-1} issued right behind S_i (true) or P_i V_i after block i's
// softmax (false): deferred is 6-8% faster at head_dim 64; at 128 it keeps
// S, O and P live at once (160 f32 registers), spills and is 21-62% slower
// (scripts/flash_train_variants.py --forward, PERF.md)
template <int HD>
constexpr bool kDeferPV = HD == 64;

// The library's scores and one online-softmax step over a 128-key block, in
// place on a consumer's 64 x 128 accumulator: s scale + mask in one FFMA
// (the product is the twin's, the mask adds exactly; key 8 j + 2 t + x of
// the block is bit 8 (j % 4) + x of word j / 4 of its validity, shifted
// right by 2 t; a block with no invalid key off the diagonal skips the
// test), then
// for rows lr0 (e = 0, 1) and lr0 + 8 (e = 2, 3): m steps once a block,
// p = 2^((s - m) log2(e)), l sums the unrounded p (a lane's partial over its
// 32 columns; the quad's four are added at the end) and alpha = 2^((m_old -
// m) log2(e)) is what the output takes before this block's P V; with S one
// block (`single`) p is divided by l before the cast, as the library's
// one-step kernel does.  FOLD (a power-of-two scale, 1/8 at head_dim 64):
// on a block with no mask the scale is applied inside the exponent's
// difference, fmaf(s, scale, -m): s scale is exact, so the difference is the
// same f32 value and one instruction an element goes.
template <bool FOLD>
__device__ __forceinline__ void fwd_softmax(float (&s)[64], float (&m)[2], float (&l)[2],
                                            float (&alpha)[2], const uint32_t* vbits, int i,
                                            bool diag, bool single, int lr0, int t, float scale) {
  const bool full = !diag && (vbits[4 * i] & vbits[4 * i + 1] & vbits[4 * i + 2] &
                              vbits[4 * i + 3]) == 0xffffffffu;
  const bool fold = FOLD && full;
  // what the raw scores still take inside the exponent: the scale when it
  // was folded, else 1 (fmaf(s, 1, -m) is s - m exactly)
  const float sc = fold ? scale : 1.f;
  if (full && !fold) {
#pragma unroll
    for (int e = 0; e < 64; ++e) s[e] = fmaf(s[e], scale, 0.f);
  } else if (!full) {
    uint32_t vw[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) vw[u] = vbits[4 * i + u] >> (2 * t);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool ok = (vw[j >> 2] >> (8 * (j & 3) + (e & 1))) & 1u;
        if (diag && 8 * j + 2 * t + (e & 1) > lr0 + 8 * (e >> 1)) ok = false;
        s[4 * j + e] = fmaf(s[4 * j + e], scale, ok ? 0.f : kMaskValue);
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = quad_max(mx);
    const float m_new = fmaxf(m[r], mx * sc);
    alpha[r] = exp2_ftz((m[r] - m_new) * kLog2e);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s[4 * j + 2 * r] = exp2_ftz(fmaf(s[4 * j + 2 * r], sc, -m_new) * kLog2e);
      s[4 * j + 2 * r + 1] = exp2_ftz(fmaf(s[4 * j + 2 * r + 1], sc, -m_new) * kLog2e);
      sum += s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
    }
    if (single) {
      l[r] = quad_sum(sum);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        s[4 * j + 2 * r] = s[4 * j + 2 * r] / l[r];
        s[4 * j + 2 * r + 1] = s[4 * j + 2 * r + 1] / l[r];
      }
    } else {
      l[r] = __fmaf_rn(alpha[r], l[r], sum);
    }
    m[r] = m_new;
  }
}

// O = O alpha, each register fenced: the multiplies happen here, while no
// product that writes O is in flight and away from the next products'
// fence (left to the compiler they may sink below a fence or behind S_i's
// issue, where ptxas injects a wait on the products in flight or
// serializes them)
template <int HD>
__device__ __forceinline__ void fwd_rescale(float (&o)[HD / 64][32], const float (&alpha)[2]) {
#pragma unroll
  for (int x = 0; x < HD / 64; ++x) {
#pragma unroll
    for (int e = 0; e < 32; ++e) o[x][e] *= alpha[(e >> 1) & 1];
    hopper::fence_acc(o[x]);
  }
}

// O += bf16(P) V over one block: one m64n64 chain a 64-column half of
// head_dim with V as the MN-major B, committed as one group that the caller
// waits for
template <int HD>
__device__ __forceinline__ void fwd_pv(float (&o)[HD / 64][32], uint32_t (&pa)[kBlk / 16][4],
                                       const __nv_bfloat16* vt) {
  hopper::wgmma_fence();
#pragma unroll
  for (int x = 0; x < HD / 64; ++x)
#pragma unroll
    for (int kc = 0; kc < kBlk / 16; ++kc)
      hopper::wgmma_rs<1>(o[x], pa[kc],
                          hopper::desc_b128(vt + 2 * x * kBox) + kc * hopper::kDescK16MnMajor, 1);
  hopper::wgmma_commit();
}

template <int HD>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_train_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v, const int* __restrict__ valid,
                           int causal, float scale, __nv_bfloat16* __restrict__ out,
                           float* __restrict__ stats, int T, int S, int H) {
  constexpr int kHalves = HD / 64, kTileBoxes = 2 * kHalves;
  constexpr uint32_t kHalfBytes = 2 * kBoxBytes;  // a half of a 128-row tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kr = qs + kTileBoxes * kBox;  // [kFwdStages] 128-key tiles
  __nv_bfloat16* vr = kr + kFwdStages * kTileBoxes * kBox;
  uint32_t* vbits = reinterpret_cast<uint32_t*>(smem + kFwdTiles<HD>);
  uint64_t* bars = reinterpret_cast<uint64_t*>(vbits + S / 32);  // S % 128 == 0: 8-aligned
  uint64_t* q_bar = bars;
  uint64_t* kfull = bars + 1;
  uint64_t* kempty = kfull + kFwdStages;
  uint64_t* vfull = kempty + kFwdStages;
  uint64_t* vempty = vfull + kFwdStages;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int qb = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // the longest first
  const int t0 = qb * kBlk;
  // the key blocks the rows visit: all, or those at or below the diagonal
  const int n_blk = causal ? min(qb + 1, S / kBlk) : S / kBlk;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int i = 0; i < kFwdStages; ++i) {
      hopper::mbar_init(kfull + i, 1);
      hopper::mbar_init(kempty + i, kConsumerThreads);
      hopper::mbar_init(vfull + i, 1);
      hopper::mbar_init(vempty + i, kConsumerThreads);
    }
    hopper::mbar_fence_init();
  }
  key_bits(vbits, valid + (size_t)b * S, S);
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {  // producer: one thread issues every load
    hopper::regs_producer();
    if (threadIdx.x == kConsumerThreads) {
      const int col = h * HD;
      hopper::mbar_expect_tx(q_bar, kBlkTileBytes<HD>);
      for (int x = 0; x < kHalves; ++x)
        for (int u = 0; u < 2; ++u)
          hopper::tma_load_2d(qs + (2 * x + u) * kBox, &map_q, col + 64 * x, b * T + t0 + 64 * u,
                              q_bar);
      for (int i = 0; i < n_blk; ++i) {
        const int st = i % kFwdStages, row = b * S + i * kBlk;
        if (i >= kFwdStages) hopper::mbar_wait(kempty + st, (i / kFwdStages - 1) & 1);
        hopper::mbar_expect_tx(kfull + st, kBlkTileBytes<HD>);
        for (int x = 0; x < kHalves; ++x)
          for (int u = 0; u < 2; ++u)
            hopper::tma_load_2d(kr + (st * kTileBoxes + 2 * x + u) * kBox, &map_k, col + 64 * x,
                                row + 64 * u, kfull + st);
        if (i >= kFwdStages) hopper::mbar_wait(vempty + st, (i / kFwdStages - 1) & 1);
        hopper::mbar_expect_tx(vfull + st, kBlkTileBytes<HD>);
        for (int x = 0; x < kHalves; ++x)
          for (int u = 0; u < 2; ++u)
            hopper::tma_load_2d(vr + (st * kTileBoxes + 2 * x + u) * kBox, &map_v, col + 64 * x,
                                row + 64 * u, vfull + st);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows wg * 64 .. + 63 of the block
  hopper::regs_consumer();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = threadIdx.x / 128, w = warp % 4, t = lane & 3;
  const int lr0 = wg * 64 + 16 * w + (lane >> 2);  // this thread's rows in the block: lr0, lr0 + 8
  const bool single = S == kBlk;
  float o[kHalves][32];
#pragma unroll
  for (int x = 0; x < kHalves; ++x)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[x][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2] = {0.f, 0.f};
  uint32_t pa[kBlk / 16][4];  // bf16(P) of the previous block, the A operand of its P V
  const __nv_bfloat16* qw = qs + wg * kBox;  // this warpgroup's 64 rows, first half
  // The two consumers take turns to issue their products (named barriers 1
  // and 2, FlashAttention-3's warp scheduler): one's softmax runs while the
  // other's products hold the tensor cores.  Warpgroup 1 hands the first
  // turn to warpgroup 0, and each hands the next to the other after it
  // issues (warpgroup 1 not after its last, so every arrival is waited on).
  if (wg == 1) hopper::named_arrive(1, kConsumerThreads);
  hopper::mbar_wait(q_bar, 0);

  // Block i: S_i = Q K_i^T, its softmax, P_i packed into A fragments, then
  // O = O alpha_i + P_i V_i; with kDeferPV the product P_{i-1} V_{i-1} is
  // issued right behind S_i instead (the two run back to back on the tensor
  // cores and are waited for together), which keeps S, O and P live at once.
  for (int i = 0; i < n_blk; ++i) {
    const int st = i % kFwdStages;
    const int pst = (i + kFwdStages - 1) % kFwdStages;  // the previous block's stage
    hopper::mbar_wait(kfull + st, (i / kFwdStages) & 1);
    hopper::named_sync(1 + wg, kConsumerThreads);
    float s[64];
    const __nv_bfloat16* kt = kr + st * kTileBoxes * kBox;
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc)
      hopper::wgmma_ss_n128(s, kmajor_step(qw, kc, kHalfBytes), kmajor_step(kt, kc, kHalfBytes),
                            kc > 0);
    hopper::wgmma_commit();
    if (kDeferPV<HD> && i > 0) {
      hopper::mbar_wait(vfull + pst, ((i - 1) / kFwdStages) & 1);
      fwd_pv<HD>(o, pa, vr + pst * kTileBoxes * kBox);
    }
    if (wg == 0 || i + 1 < n_blk) hopper::named_arrive(2 - wg, kConsumerThreads);
    hopper::wgmma_wait<0>();
    hopper::fence_acc(s);
    hopper::mbar_arrive(kempty + st);  // K_i is read; the producer refills its stage
    if (kDeferPV<HD> && i > 0) {
#pragma unroll
      for (int x = 0; x < kHalves; ++x) hopper::fence_acc(o[x]);
      hopper::fence_a(pa);
      hopper::mbar_arrive(vempty + pst);  // V_{i-1} is read
    }
    fwd_softmax<HD == 64>(s, m, l, alpha, vbits, i, causal && i == qb, single, lr0, t, scale);
#pragma unroll
    for (int kc = 0; kc < kBlk / 16; ++kc) acc_to_a(pa[kc], s, kc);
    if (kDeferPV<HD>) fwd_rescale<HD>(o, alpha);  // for P_i V_i, issued behind S_{i+1}
    if (!kDeferPV<HD>) {
      hopper::mbar_wait(vfull + st, (i / kFwdStages) & 1);
      fwd_rescale<HD>(o, alpha);
      fwd_pv<HD>(o, pa, vr + st * kTileBoxes * kBox);
      // waited for here: the A fragments' registers are read after the
      // instruction issues, and the next block would overwrite them
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int x = 0; x < kHalves; ++x) hopper::fence_acc(o[x]);
      hopper::fence_a(pa);
      hopper::mbar_arrive(vempty + st);  // V_i is read
    }
  }
  if (kDeferPV<HD>) {  // the last block's P V
    const int pst = (n_blk - 1) % kFwdStages;
    hopper::mbar_wait(vfull + pst, ((n_blk - 1) / kFwdStages) & 1);
    fwd_pv<HD>(o, pa, vr + pst * kTileBoxes * kBox);
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < kHalves; ++x) hopper::fence_acc(o[x]);
    hopper::fence_a(pa);
  }

  float inv[2] = {1.f, 1.f};
  if (!single) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      inv[r] = 1.f / l[r];
    }
  }
  const size_t stride = (size_t)H * HD;
  __nv_bfloat16* ob = out + ((size_t)b * T + t0 + wg * 64) * stride + h * HD;
#pragma unroll
  for (int x = 0; x < kHalves; ++x) {
#pragma unroll
    for (int e = 0; e < 32; ++e) o[x][e] *= inv[(e >> 1) & 1];
    store_acc(ob + 64 * x, stride, o[x], w, lane);
  }
  if (t == 0) {
    const size_t BHT = (size_t)gridDim.y * T;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t at = (size_t)bh * T + t0 + lr0 + 8 * r;
      stats[at] = m[r];
      stats[BHT + at] = l[r];
    }
  }
}

// ---------------------------------------------------------------------------
// backward: warp-specialised blocks of three warpgroups on wgmma and TMA
// ---------------------------------------------------------------------------
// the ring of 64-row tiles: four stages at head_dim 64, two at 128 (where a
// tile is two boxes and four would not fit beside the dq kernel's Q, g, O)
template <int HD>
constexpr int kStages = HD == 64 ? 4 : 2;

// ---------------------------------------------------------------------------
// backward, dq: a block per (128 query rows, b * H + h)
// ---------------------------------------------------------------------------
// shared: Q, g, O (128-row tiles) | K ring, V ring (64-row tiles) | key bits |
// barriers
template <int HD>
constexpr size_t kDqTiles = (6 + 2 * kStages<HD>) * (HD / 64) * (size_t)kBoxBytes;

template <int HD>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_train_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_o,
                          const __grid_constant__ CUtensorMap map_g, const int* __restrict__ valid,
                          const float* __restrict__ stats, int causal, float scale,
                          float* __restrict__ di_out, __nv_bfloat16* __restrict__ dq, int T, int S,
                          int H) {
  constexpr int kHalves = HD / 64, kSt = kStages<HD>;
  constexpr int kRowBoxes = 2 * kHalves;  // a 128-row tile
  constexpr uint32_t kHalfBytes = 2 * kBoxBytes;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // 128 rows each
  __nv_bfloat16* gs = qs + kRowBoxes * kBox;
  __nv_bfloat16* os = gs + kRowBoxes * kBox;
  __nv_bfloat16* kr = os + kRowBoxes * kBox;  // [kSt] 64-key tiles of kHalves boxes
  __nv_bfloat16* vr = kr + kSt * kHalves * kBox;
  uint32_t* vbits = reinterpret_cast<uint32_t*>(smem + kDqTiles<HD>);
  uint64_t* bars = reinterpret_cast<uint64_t*>(vbits + S / 32);  // S % 128 == 0: 8-aligned
  uint64_t* qgo_bar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kSt;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int qb = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;  // the longest first
  const int t0 = qb * kBlk;
  // 64-key tiles: all, or those of the 128-blocks at or below the diagonal
  const int n_kt = causal ? min(2 * (qb + 1), S / 64) : S / 64;

  const float sc = fixed_scale<HD>(scale);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    hopper::mbar_init(qgo_bar, 1);
    for (int i = 0; i < kSt; ++i) {
      hopper::mbar_init(full + i, 1);
      hopper::mbar_init(empty + i, kConsumerThreads);
    }
    hopper::mbar_fence_init();
  }
  key_bits(vbits, valid + (size_t)b * S, S);
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {  // producer: one thread issues every load
    hopper::regs_producer();
    if (threadIdx.x == kConsumerThreads) {
      const int col = h * HD, qrow = b * T + t0, krow = b * S;
      hopper::mbar_expect_tx(qgo_bar, 3 * kRowBoxes * kBoxBytes);
      for (int x = 0; x < kHalves; ++x)
        for (int u = 0; u < 2; ++u) {
          const int at = (2 * x + u) * kBox;
          hopper::tma_load_2d(qs + at, &map_q, col + 64 * x, qrow + 64 * u, qgo_bar);
          hopper::tma_load_2d(gs + at, &map_g, col + 64 * x, qrow + 64 * u, qgo_bar);
          hopper::tma_load_2d(os + at, &map_o, col + 64 * x, qrow + 64 * u, qgo_bar);
        }
      for (int it = 0; it < n_kt; ++it) {
        const int st = it % kSt;
        if (it >= kSt) hopper::mbar_wait(empty + st, (it / kSt - 1) & 1);
        hopper::mbar_expect_tx(full + st, 2 * kHalves * kBoxBytes);
        for (int x = 0; x < kHalves; ++x) {
          const int at = (st * kHalves + x) * kBox;
          hopper::tma_load_2d(kr + at, &map_k, col + 64 * x, krow + 64 * it, full + st);
          hopper::tma_load_2d(vr + at, &map_v, col + 64 * x, krow + 64 * it, full + st);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows wg * 64 .. + 63 of the block
  hopper::regs_consumer();
  const int wg = threadIdx.x / 128, w = warp % 4, t = lane & 3;
  const int lr0 = wg * 64 + 16 * w + (lane >> 2);  // this thread's rows in the block: lr0, lr0 + 8
  hopper::mbar_wait(qgo_bar, 0);
  // at head_dim 64 Q and g are held as A fragments in registers; at 128
  // they are read from shared memory by descriptor
  uint32_t qa[kKC<64>][4], ga[kKC<64>][4];
  if constexpr (HD == 64) {
    load_a_frags_b128(qa, qs, wg * 64 + 16 * w, lane);
    load_a_frags_b128(ga, gs, wg * 64 + 16 * w, lane);
  }
  const __nv_bfloat16* qw = qs + wg * kBox;  // this warpgroup's rows, first half
  const __nv_bfloat16* gw = gs + wg * kBox;
  const size_t BHT = (size_t)gridDim.y * T;
  float m[2], rl[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = lr0 + 8 * r;
    // di = sum_d out g: lane t of the quad takes dims HD t / 4 .. + HD / 4 - 1
    // (16-byte chunks HD t / 32 .. of the swizzled rows), the quad adds the four
    float acc = 0.f;
#pragma unroll
    for (int c = (HD / 32) * t; c < (HD / 32) * (t + 1); ++c) {
      const int off = (c / 8) * kHalfBytes + lr * 128 + (((c % 8) ^ (lr & 7)) << 4);
      const uint4 ov = *reinterpret_cast<const uint4*>(reinterpret_cast<const unsigned char*>(os) + off);
      const uint4 gv = *reinterpret_cast<const uint4*>(reinterpret_cast<const unsigned char*>(gs) + off);
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

  float dqa[kHalves][32];
#pragma unroll
  for (int x = 0; x < kHalves; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[x][i] = 0.f;
  for (int it = 0; it < n_kt; ++it) {
    const int st = it % kSt;
    hopper::mbar_wait(full + st, (it / kSt) & 1);
    const __nv_bfloat16* kt = kr + st * kHalves * kBox;
    const __nv_bfloat16* vt = vr + st * kHalves * kBox;
    float s[32], dp[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      if constexpr (HD == 64)
        hopper::wgmma_rs<0>(s, qa[kc], kmajor_step(kt, kc, kBoxBytes), kc > 0);
      else
        hopper::wgmma_ss(s, kmajor_step(qw, kc, kHalfBytes), kmajor_step(kt, kc, kBoxBytes), kc > 0);
    }
    hopper::wgmma_commit();
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      if constexpr (HD == 64)
        hopper::wgmma_rs<0>(dp, ga[kc], kmajor_step(vt, kc, kBoxBytes), kc > 0);
      else
        hopper::wgmma_ss(dp, kmajor_step(gw, kc, kHalfBytes), kmajor_step(vt, kc, kBoxBytes), kc > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // the scores are done; g V^T may still run
    hopper::fence_acc(s);
    // key 8 j + 2 t + x of the tile is bit 8 (j % 4) + x of word j / 4
    const uint32_t vw[2] = {vbits[2 * it] >> (2 * t), vbits[2 * it + 1] >> (2 * t)};
    const bool diag = causal && (it >> 1) == qb;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, key = 64 * it + 8 * j + 2 * t + (e & 1);
        bool ok = (vw[j >> 2] >> (8 * (j & 3) + (e & 1))) & 1u;
        if (diag && key > t0 + lr0 + 8 * r) ok = false;
        // s scale + mask in one FFMA (the mask adds exactly)
        const float sv = fmaf(s[4 * j + e], sc, ok ? 0.f : kMaskValue);
        s[4 * j + e] = exp2_ftz((sv - m[r]) * kLog2e) * rl[r];  // p, under g V^T
      }
    hopper::wgmma_wait<0>();
    hopper::fence_acc(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[4 * j + e] = (dp[4 * j + e] - di[e >> 1]) * s[4 * j + e] * sc;
    uint32_t da[kKTile / 16][4];  // bf16(ds), A fragments over the tile's keys
#pragma unroll
    for (int kc = 0; kc < kKTile / 16; ++kc) acc_to_a(da[kc], s, kc);
    hopper::wgmma_fence();
#pragma unroll
    for (int x = 0; x < kHalves; ++x) {
      hopper::fence_acc(dqa[x]);
#pragma unroll
      for (int kc = 0; kc < kKTile / 16; ++kc)
        hopper::wgmma_rs<1>(dqa[x], da[kc],
                            hopper::desc_b128(kt + x * kBox) + kc * hopper::kDescK16MnMajor, 1);
    }
    hopper::wgmma_commit();
    // waited for here, not under the next tile's products: the compiler may
    // give da's registers to the next tile while this product still reads
    // them (a build that overlapped them gave other bits with 4 stages)
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int x = 0; x < kHalves; ++x) hopper::fence_acc(dqa[x]);
    hopper::mbar_arrive(empty + st);  // this stage is read; the producer refills it
  }
  const size_t stride = (size_t)H * HD;
  __nv_bfloat16* dqb = dq + ((size_t)b * T + t0 + wg * 64) * stride + h * HD;
#pragma unroll
  for (int x = 0; x < kHalves; ++x) store_acc(dqb + 64 * x, stride, dqa[x], w, lane);
}

// p = 2^((s scale + mask - m) log2(e)) (1 / l) in place over a dk/dv tile of
// transposed scores (row = key, column = query row of the tile); the rows'
// m from `rs`, 1 / l from `ri`; madd the keys' additive mask, and on the
// causal diagonal (DIAG) also the mask of a key past the row
template <bool DIAG>
__device__ __forceinline__ void p_tile(float (&sT)[32], const float* rs, const float* ri,
                                       const float madd[2], int key0, int tq0, int t, float scale) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int r0 = 8 * j + 2 * t;  // the pair's first row in the tile
    const float2 mm = *reinterpret_cast<const float2*>(rs + r0);
    const float2 rl = *reinterpret_cast<const float2*>(ri + r0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = e & 1;
      float mk = madd[e >> 1];
      if (DIAG && key0 + 8 * (e >> 1) > tq0 + r0 + x) mk = kMaskValue;
      const float sv = fmaf(sT[4 * j + e], scale, mk);
      sT[4 * j + e] = exp2_ftz((sv - (x ? mm.y : mm.x)) * kLog2e) * (x ? rl.y : rl.x);
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dk and dv: a block per (128 keys, b * H + h); at head_dim 128 two
// blocks per (128 keys, b * H + h), blockIdx.z = 0 for dk and 1 for dv
// ---------------------------------------------------------------------------
// shared: K, V (128-row tiles) | Q ring, g ring (64-row tiles) | [kSt] m, l,
// di rows | [kSt] 1 / l | barriers
template <int HD>
constexpr size_t kDkvTiles = (4 + 2 * kStages<HD>) * (HD / 64) * (size_t)kBoxBytes;
constexpr uint32_t kRowStatBytes = 3 * 64 * sizeof(float);

// PART 0: dk alone, 1: dv alone, 2: both (head_dim 64, where a consumer
// thread holds dk, dv and a tile's dv in 3 x 32 registers; at 128 these
// would be 3 x 64, beside the scores: each half of the grid takes one)
template <int HD, int PART>
__device__ __forceinline__ void dkv_body(const CUtensorMap& map_q, const CUtensorMap& map_k,
                                         const CUtensorMap& map_v, const CUtensorMap& map_g,
                                         const int* __restrict__ valid,
                                         const float* __restrict__ stats,
                                         const float* __restrict__ di_in, int causal, float scale,
                                         __nv_bfloat16* __restrict__ dk,
                                         __nv_bfloat16* __restrict__ dv, int T, int S, int H) {
  constexpr int kHalves = HD / 64, kSt = kStages<HD>;
  constexpr int kRowBoxes = 2 * kHalves;
  constexpr uint32_t kHalfBytes = 2 * kBoxBytes;
  constexpr bool kDk = PART != 1, kDv = PART != 0;
  const float sc = fixed_scale<HD>(scale);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_1024(smem_raw);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // 128 keys each
  __nv_bfloat16* vs = ks + kRowBoxes * kBox;
  __nv_bfloat16* qr = vs + kRowBoxes * kBox;  // [kSt] 64-row tiles of kHalves boxes
  __nv_bfloat16* gr = qr + kSt * kHalves * kBox;
  float* rows = reinterpret_cast<float*>(smem + kDkvTiles<HD>);  // [kSt][3][64]: m, l, di
  float* rinv = rows + kSt * 3 * 64;                              // [kSt][64]: 1 / l
  uint64_t* bars = reinterpret_cast<uint64_t*>(rinv + kSt * 64);
  uint64_t* kv_bar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kSt;
  uint64_t* conv = empty + kSt;  // a stage's 1 / l is written

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kb = blockIdx.x, c0 = kb * kBlk;
  // 64-row query tiles: all, or those of the 128-blocks at or below the keys'
  const int first = causal ? 2 * kb : 0;
  const int n_qt = max(T / 64 - first, 0);
  const size_t BHT = (size_t)gridDim.y * T;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_bar, 1);
    for (int i = 0; i < kSt; ++i) {
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
        const int st = it % kSt;
        hopper::mbar_wait(full + st, (it / kSt) & 1);
        const float* l = rows + st * 3 * 64 + 64;
        rinv[st * 64 + lane] = __frcp_rn(l[lane]);
        rinv[st * 64 + 32 + lane] = __frcp_rn(l[32 + lane]);
        hopper::mbar_arrive(conv + st);
      }
    }
    if (threadIdx.x == kConsumerThreads) {
      const int col = h * HD;
      hopper::mbar_expect_tx(kv_bar, 2 * kRowBoxes * kBoxBytes);
      for (int x = 0; x < kHalves; ++x)
        for (int u = 0; u < 2; ++u) {
          const int at = (2 * x + u) * kBox;
          hopper::tma_load_2d(ks + at, &map_k, col + 64 * x, b * S + c0 + 64 * u, kv_bar);
          hopper::tma_load_2d(vs + at, &map_v, col + 64 * x, b * S + c0 + 64 * u, kv_bar);
        }
      for (int it = 0; it < n_qt; ++it) {
        const int st = it % kSt, tq0 = (first + it) * 64;
        if (it >= kSt) hopper::mbar_wait(empty + st, (it / kSt - 1) & 1);
        hopper::mbar_expect_tx(full + st, 2 * kHalves * kBoxBytes + kRowStatBytes);
        for (int x = 0; x < kHalves; ++x) {
          const int at = (st * kHalves + x) * kBox;
          hopper::tma_load_2d(qr + at, &map_q, col + 64 * x, b * T + tq0, full + st);
          hopper::tma_load_2d(gr + at, &map_g, col + 64 * x, b * T + tq0, full + st);
        }
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
  const __nv_bfloat16* kw = ks + wg * kBox;
  const __nv_bfloat16* vw = vs + wg * kBox;

  // the additive mask of this thread's two keys off the causal diagonal
  const float madd[2] = {okk[0] ? 0.f : kMaskValue, okk[1] ? 0.f : kMaskValue};

  float dka[kDk ? kHalves : 1][32], dva[kDv ? kHalves : 1][32];
#pragma unroll
  for (int x = 0; x < (kDk ? kHalves : 1); ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[x][i] = 0.f;
#pragma unroll
  for (int x = 0; x < (kDv ? kHalves : 1); ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) dva[x][i] = 0.f;
  for (int it = 0; it < n_qt; ++it) {
    const int st = it % kSt, tq0 = (first + it) * 64;
    hopper::mbar_wait(full + st, (it / kSt) & 1);
    const __nv_bfloat16* qt = qr + st * kHalves * kBox;
    const __nv_bfloat16* gt = gr + st * kHalves * kBox;
    // the transposed scores and g . v: row = this warpgroup's key, column =
    // a query row of the tile
    float sT[32], dT[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc)
      hopper::wgmma_ss(sT, kmajor_step(kw, kc, kHalfBytes), kmajor_step(qt, kc, kBoxBytes), kc > 0);
    hopper::wgmma_commit();
    if constexpr (kDk) {
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc)
        hopper::wgmma_ss(dT, kmajor_step(vw, kc, kHalfBytes), kmajor_step(gt, kc, kBoxBytes),
                         kc > 0);
      hopper::wgmma_commit();
    }
    hopper::mbar_wait(conv + st, (it / kSt) & 1);
    const float* rs = rows + st * 3 * 64;
    const float* ri = rinv + st * 64;
    hopper::wgmma_wait<kDk ? 1 : 0>();  // the scores are done; g V^T may still run
    hopper::fence_acc(sT);
    // p, under g V^T: some key of the block may be past some row of a tile
    // of the diagonal block
    if (causal && (tq0 >> 7) == kb)
      p_tile<true>(sT, rs, ri, madd, key0, tq0, t, sc);
    else
      p_tile<false>(sT, rs, ri, madd, key0, tq0, t, sc);
    uint32_t pa[4][4], da[4][4];
    if constexpr (kDk) {
      hopper::wgmma_wait<0>();
      hopper::fence_acc(dT);
      // ds; then bf16(ds)^T over the tile's rows
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dd = *reinterpret_cast<const float2*>(rs + 128 + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dT[4 * j + e] = (dT[4 * j + e] - ((e & 1) ? dd.y : dd.x)) * sT[4 * j + e] * sc;
      }
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) acc_to_a(da[kc], dT, kc);
    }
    if constexpr (kDv) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) acc_to_a(pa[kc], sT, kc);
    }
    // dv's and dk's products are waited for before the next tile: the
    // compiler may give pa's and da's registers to the next tile while they
    // still read them.  This tile's dv goes into an accumulator of its own
    // (the first step overwrites it), added to dva by FADD: the header says why
    float dvt[kDv ? kHalves : 1][32];
    hopper::wgmma_fence();
    if constexpr (kDv) {
#pragma unroll
      for (int x = 0; x < kHalves; ++x)
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          hopper::wgmma_rs<1>(dvt[x], pa[kc],
                              hopper::desc_b128(gt + x * kBox) + kc * hopper::kDescK16MnMajor,
                              kc > 0);
    }
    if constexpr (kDk) {
#pragma unroll
      for (int x = 0; x < kHalves; ++x) {
        hopper::fence_acc(dka[x]);
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          hopper::wgmma_rs<1>(dka[x], da[kc],
                              hopper::desc_b128(qt + x * kBox) + kc * hopper::kDescK16MnMajor, 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    if constexpr (kDv) {
#pragma unroll
      for (int x = 0; x < kHalves; ++x) hopper::fence_acc(dvt[x]);
    }
    if constexpr (kDk) {
#pragma unroll
      for (int x = 0; x < kHalves; ++x) hopper::fence_acc(dka[x]);
    }
    hopper::mbar_arrive(empty + st);  // this stage is read; the producer refills it
    if constexpr (kDv) {
#pragma unroll
      for (int x = 0; x < kHalves; ++x)
#pragma unroll
        for (int i = 0; i < 32; ++i) dva[x][i] += dvt[x][i];
    }
  }
  const size_t stride = (size_t)H * HD;
  const size_t kofs = ((size_t)b * S + c0 + wg * 64) * stride + h * HD;
#pragma unroll
  for (int x = 0; x < kHalves; ++x) {
    if constexpr (kDk) store_acc(dk + kofs + 64 * x, stride, dka[x], w, lane);
    if constexpr (kDv) store_acc(dv + kofs + 64 * x, stride, dva[x], w, lane);
  }
}

template <int HD>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_train_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_g, const int* __restrict__ valid,
                           const float* __restrict__ stats, const float* __restrict__ di_in,
                           int causal, float scale, __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int T, int S, int H) {
  if constexpr (HD == 64) {
    dkv_body<64, 2>(map_q, map_k, map_v, map_g, valid, stats, di_in, causal, scale, dk, dv, T, S, H);
  } else if (blockIdx.z == 0) {
    dkv_body<HD, 0>(map_q, map_k, map_v, map_g, valid, stats, di_in, causal, scale, dk, dv, T, S, H);
  } else {
    dkv_body<HD, 1>(map_q, map_k, map_v, map_g, valid, stats, di_in, causal, scale, dk, dv, T, S, H);
  }
}

constexpr int kMapRefused = 10000;  // + the CUresult of a tensor map the CUDA driver refuses

bool bad_shape(int B, int T, int S, int H) {
  return B < 1 || H < 1 || T < kBlk || S < kBlk || T % kBlk || S % kBlk || B * H > 65535;
}

template <int HD>
int launch_fwd(int B, int T, int S, int H, const void* q, const void* k, const void* v,
               const void* valid, int causal, float scale, void* out, void* stats,
               cudaStream_t st) {
  const size_t smem = 1024 + kFwdTiles<HD> + S / 8 + kFwdBars * sizeof(uint64_t);
  // a runtime call first: it makes the device's context current in this
  // thread, which the CUDA driver wants before it encodes a tensor map
  const cudaError_t e = cudaFuncSetAttribute(flash_train_fwd_kernel<HD>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mq, mk, mv;
  int refused = hopper::head_map(&mq, q, (long long)B * T, H, HD);
  if (!refused) refused = hopper::head_map(&mk, k, (long long)B * S, H, HD);
  if (!refused) refused = hopper::head_map(&mv, v, (long long)B * S, H, HD);
  if (refused) return kMapRefused + refused;
  flash_train_fwd_kernel<HD><<<dim3(T / kBlk, B * H), kWsThreads, smem, st>>>(
      mq, mk, mv, static_cast<const int*>(valid), causal, scale, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(stats), T, S, H);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd(int B, int T, int S, int H, const void* q, const void* k, const void* v,
               const void* valid, const void* out, const void* stats, const void* g, int causal,
               float scale, void* di, void* dq, void* dk, void* dv, cudaStream_t st) {
  const size_t smem_dq = 1024 + kDqTiles<HD> + S / 8 + (1 + 2 * kStages<HD>) * sizeof(uint64_t);
  const size_t smem_dkv = 1024 + kDkvTiles<HD> +
                          kStages<HD> * (kRowStatBytes + 64 * sizeof(float)) +
                          (1 + 3 * kStages<HD>) * sizeof(uint64_t);
  // runtime calls first: they make the device's context current in this
  // thread (the backward may run on a thread of its own), which the CUDA driver
  // wants before it encodes a tensor map
  cudaError_t e = cudaFuncSetAttribute(flash_train_dq_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_train_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_dkv);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mq, mk, mv, mo, mg;
  int refused = hopper::head_map(&mq, q, (long long)B * T, H, HD);
  if (!refused) refused = hopper::head_map(&mk, k, (long long)B * S, H, HD);
  if (!refused) refused = hopper::head_map(&mv, v, (long long)B * S, H, HD);
  if (!refused) refused = hopper::head_map(&mo, out, (long long)B * T, H, HD);
  if (!refused) refused = hopper::head_map(&mg, g, (long long)B * T, H, HD);
  if (refused) return kMapRefused + refused;
  const int* vl = static_cast<const int*>(valid);
  const float* stt = static_cast<const float*>(stats);
  float* dib = static_cast<float*>(di);
  flash_train_dq_kernel<HD><<<dim3(T / kBlk, B * H), kWsThreads, smem_dq, st>>>(
      mq, mk, mv, mo, mg, vl, stt, causal, scale, dib, static_cast<__nv_bfloat16*>(dq), T, S, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_train_dkv_kernel<HD><<<dim3(S / kBlk, B * H, HD / 64), kWsThreads, smem_dkv, st>>>(
      mq, mk, mv, mg, vl, stt, dib, causal, scale, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), T, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, T, H, HD), k and v (B, S, H, HD), out (B, T, H, HD): bf16,
// contiguous, every pointer 16-byte aligned (TMA's requirement), HD =
// head_dim 64 or 128; valid (B, S) int32 (nonzero = attendable); T and S
// multiples of 128; scale = 1 / sqrt(HD); stats (2, B*H, T) f32 receives
// each row's m and l.  Returns a cudaError, or kMapRefused plus the CUDA
// driver's CUresult when it refuses a tensor map.
int smer_flash_train_fwd(int head_dim, int B, int T, int S, int H, const void* q, const void* k,
                         const void* v, const void* valid, int causal, float scale, void* out,
                         void* stats, void* stream) {
  if (bad_shape(B, T, S, H)) return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_fwd<64>(B, T, S, H, q, k, v, valid, causal, scale, out, stats, st);
    case 128:
      return launch_fwd<128>(B, T, S, H, q, k, v, valid, causal, scale, out, stats, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The backward of smer_flash_train_fwd: out and stats as it wrote them, g
// (B, T, H, HD) bf16; di a (B*H, T) f32 scratch buffer; dq, dk, dv bf16 in
// the layouts of q, k, v; scale 1 / 8 at head_dim 64 (fixed_scale).  Every
// pointer 16-byte aligned (TMA's and the bulk copies' requirement).  Returns
// a cudaError, or kMapRefused plus the CUDA driver's CUresult when it
// refuses a tensor map.
int smer_flash_train_bwd(int head_dim, int B, int T, int S, int H, const void* q, const void* k,
                         const void* v, const void* valid, const void* out, const void* stats,
                         const void* g, int causal, float scale, void* di, void* dq, void* dk,
                         void* dv, void* stream) {
  if (bad_shape(B, T, S, H)) return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out) || !aligned16(g) ||
      !aligned16(dq) || !aligned16(dk) || !aligned16(dv) || !aligned16(stats) || !aligned16(di))
    return (int)cudaErrorMisalignedAddress;
  if (head_dim == 64 && scale != 0.125f) return (int)cudaErrorInvalidValue;  // fixed_scale
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_bwd<64>(B, T, S, H, q, k, v, valid, out, stats, g, causal, scale, di, dq, dk,
                            dv, st);
    case 128:
      return launch_bwd<128>(B, T, S, H, q, k, v, valid, out, stats, g, causal, scale, di, dq, dk,
                             dv, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
