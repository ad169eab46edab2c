// Training attention with weight dropout (scores -> softmax -> dropout -> V)
// and its recomputing backward, over (B, T|S, H, HD) bf16 tensors, HD = 64 or
// 128 (every kernel a template of it), for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_dropout_attention` of
// smer_music_generation_tpu/ops/train_attention.py:316: its forward
// `_fwd_kernel` (:111, pallas_call :263) becomes train_fwd_kernel, and its
// backward `_bwd_kernel` (:163, pallas_call :288) becomes the pair
// train_bwd_rows_kernel + train_bwd_keys_kernel.  The same function:
//   s  = bf16(q . k, f32 sums) * 1/sqrt(HD), -1e30 where the key is invalid
//        (or past the query row when causal);
//   e  = exp(s - max s) on valid keys, 0 elsewhere; w = e / max(sum e, 1e-30)
//        (exact, not online: w is normalised before it is rounded);
//   wd = keep ? bf16(bf16(w) / bf16(1 - rate)) : 0, keep from the counter
//        hash of _hash_keep (:87) over (seed, b * H + h, absolute row, col),
//        b and h global: a shard's launch passes its first row b0, its first
//        head h0 and the global head count;
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
// The scores stay bf16(q . k) and the scale folds into the exponent: e =
// 2^(s sl2 - m sl2) with sl2 = scale log2(e), one FFMA and one MUFU.EX2
// (exact to the twin's bf16(q . k) * scale at head_dim 64, where the scale
// 1/8 is a power of two; at 128 the two differ by the rounding of the
// product, far inside the tolerance).  A key that is invalid, or past the row
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
// At head_dim 128 the tiles double (87 KB of shared memory for the forward,
// 104 KB for each backward kernel: two blocks an SM), and the backward pair,
// which holds two 16 x 128 f32 accumulators (rows: dq; keys: dk and dv),
// reads its held A operands (Q and g; K and V) from the shared tile at each
// product (SmemA) rather than keeping them in registers.
//
// Backward (FlashAttention-2's deterministic two-kernel backward on the same
// tiles).  It needs each row's m, l and delta = sum_s w dw before any ds,
// and dk, dv sum over all rows; it takes no atomics:
//   train_bwd_rows_kernel, a block per (64 query rows, b * H + h), Q and g
//     held as A fragments, K and V tiles through the ring in two passes:
//     pass 1 runs the forward's pass 1 (the same score sequence, so m and l
//     and every w are bit-identical to the forward's), g V^T by mma.sync
//     beside it, and a running sum u of e dw rescaled with l, so delta =
//     u / max(l, 1e-30) at the end (JAX's sum_s w dw up to the f32
//     rounding of the summation order; tests/test_torch_attention_tiles.py
//     pins it), and keeps each thread's keep bits of the tile (one word) in
//     shared memory; pass 2 recomputes s and g V^T, w exactly, reads the
//     keep bits back, and packs ds = bf16(w (dw - delta) scale) straight into
//     A fragments for dq += ds K (K's B fragments by ldmatrix.trans); writes
//     dq once and m, l, delta to a (3, B*H, T) f32 buffer;
//   train_bwd_keys_kernel, a block per (64 keys, b * H + h), K and V held as
//     A fragments, 64-row tiles of Q and g (and their m, l, delta, turned
//     once a tile into m scale log2(e), max(l, 1e-30), its inverse and delta
//     scale) through the ring: S^T = K Q^T and (g V^T)^T = V g^T by mma.sync, w,
//     the keep hash, wd and ds (in the transposed tile a query row is a
//     column), then dv += wd^T g and dk += ds^T Q with g's and Q's B
//     fragments by ldmatrix.trans; writes dk and dv once.  An invalid key
//     is the row of its own dk and dv in every product, so it is not masked
//     per element: its dk and dv are set to 0 at the end.  Causal query
//     tiles wholly above the block's keys are skipped, and a block none of
//     whose keys is valid writes zeros.
// Pass 2 and the keys kernel take the scores and g V^T one k16 chunk (two
// n-blocks) at a time, so few are live at once: 168 registers a thread,
// three blocks an SM.  Deterministic: every sum runs in a fixed order, and
// no O(T*S) tensor reaches device memory.  The products a (row, key) pair
// costs are 9 (the rows kernel's 2 QK^T, 2 g V^T and ds K; the keys
// kernel's K Q^T, V g^T, wd^T g and ds^T Q), against the 5 the bound
// counts; the keep hash runs twice (rows pass 1, keys).  The keys kernel
// sums the same 64 bf16 products of a score with the operands' roles
// swapped; the gradients do not depend on that sum's last bit beyond
// TA_REL.  Measured at 640x640 (B=8, H=8, rate 0.1) on an NVIDIA H100 80GB
// HBM3, 700.00 W (scripts/torch_kernel_ab.py, chip_smoke.py phase 2g;
// PERF.md): 0.232 ms a call (rows 0.129, keys 0.101; 0.164 at rate 0),
// beside 2.11 ms for the first version (32 rows a block, f32 scores in
// shared memory, f32 FMA pipes) and 0.13-0.56 ms for the backward of
// torch's scaled_dot_product_attention.  What holds it: per-element ALU
// work (3,672 and 2,832 SASS instructions in the two kernels, static, of
// which 160 and 128 HMMA; the keep hash ~20 integer operations an
// element, ~0.07 ms of the 0.23), a second wave 62% full (640 blocks on
// 396 slots), and the operands re-read from L2 by every block; the
// products run at ~12% of the tensor cores' peak.
// The hash is uint32 wraparound arithmetic; the keep threshold is computed in
// double on the host; no --use_fast_math: a division is a rounded reciprocal
// and one FMA residual step (div_rn, rounded to nearest) and e^x is
// 2^(x log2(e)) on the SFU (exp2_ftz): IEEE division and expf, per element,
// were the largest share of the first versions' time.
// smer_dropout_keep_mask writes the keep mask from the same __device__ hash
// so the card can show it bit-equal to dropout_mask_reference.
//
// The launchers have a plain C interface and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attn_tiles.cuh"
#include "dropout_hash.cuh"

namespace {

using namespace attn_tiles;
using namespace dropout_hash;

constexpr float kMasked = -1e30f;
constexpr int kMaxKeys = 1024;  // JAX's MAX_KLEN: the gate of the TPU kernel, kept
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kQTile == kKTile, "the keys kernel skips causal query tiles by key-tile index");

// the A operands the backward kernels hold: in registers at head_dim 64, read
// from the shared tile at head_dim 128 (two 128-column accumulators beside
// them leave no room)
template <int HD>
using HeldA = std::conditional_t<HD == 64, RegA<HD>, SmemA<HD>>;

// dw of one (row, key) from its g . v: keep ? dwd / c : 0 (dwd itself at rate 0)
__device__ __forceinline__ float dropped_dw(float dwd, bool keep, const Drop& dr, float rc) {
  if (!dr.on) return dwd;
  return keep ? div_rn(dwd, dr.c, rc) : 0.f;
}

// The validity of one batch row's S keys as bits (bit c % 32 of word c / 32:
// key c valid); the caller places a block barrier before reading them.
__device__ __forceinline__ void key_bits(uint32_t* vbits, const int* valid, int S, int warp,
                                         int lane) {
  const int words = (S + 31) / 32;
  for (int wi = warp; wi < words; wi += kWarps) {
    const int col = 32 * wi + lane;
    const unsigned bits = __ballot_sync(0xffffffffu, col < S && valid[col] != 0);
    if (lane == 0) vbits[wi] = bits;
  }
}

// The last valid key (-1 when none), the same in every lane (words <= 32).
__device__ __forceinline__ int last_valid_key(const uint32_t* vbits, int words, int lane) {
  int last = -1;
  if (lane < words && vbits[lane] != 0u) last = 32 * lane + 31 - __clz(vbits[lane]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
  return last;
}

// s[jj] = bf16(q . k) of this warp's 16 query rows (row0 = its row of lane
// group g, row0 + 8) against keys k0 + 8 (j0 + jj) .. + 7 of the shared
// 64-key tile, jj < NJ, in units of bf16(q . k) (the scale lives in the
// exponent): the one score sequence of train_fwd_kernel and
// train_bwd_rows_kernel, so both give the same bits, whole tile or a few
// n-blocks at a time.  A key that is invalid, or past the row when causal,
// takes -inf.  Each mask runs only on a tile that needs it (some key
// invalid; some key past the diagonal of some row of this warp): one branch
// a tile, then a key's validity is one bit test of the lane's pre-shifted
// word for both rows.
template <int HD, int NJ, class A>
__device__ __forceinline__ void row_scores(float s[][4], const A& qa, const __nv_bfloat16* kt,
                                           const uint32_t* vbits, int words, int k0, int j0,
                                           int causal, int row0, int lane) {
  qk_blocks<HD, NJ>(s, qa, kt, j0, lane);
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    round_bf16x2(s[jj][0], s[jj][1]);
    round_bf16x2(s[jj][2], s[jj][3]);
  }
  const int t = lane & 3;
  const uint32_t w0 = vbits[k0 / 32], w1 = k0 / 32 + 1 < words ? vbits[k0 / 32 + 1] : 0u;
  if ((w0 & w1) != 0xffffffffu) {
    // bit 8 (j % 4) + x of (j < 4 ? b0 : b1): key k0 + 8 j + 2 t + x valid
    const uint32_t b0 = w0 >> (2 * t), b1 = w1 >> (2 * t);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int j = j0 + jj;
        const bool ok = ((j < 4 ? b0 : b1) >> (8 * (j % 4) + x)) & 1u;
        s[jj][x] = ok ? s[jj][x] : -INFINITY;
        s[jj][2 + x] = ok ? s[jj][2 + x] : -INFINITY;
      }
  }
  if (causal && k0 + kKTile - 1 > row0 - (lane >> 2)) {
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * (j0 + jj) + 2 * t + (e & 1) > (e < 2 ? row0 : row0 + 8)) s[jj][e] = -INFINITY;
  }
}

// Pass 1 of the forward and of the rows kernel on one tile, row half r: m =
// max(m, the tile's scores), mb = m sl2, and alpha = 2^((m_old - m) sl2),
// the factor the running sums take.  The callers then sum e = 2^(s sl2 - mb)
// as `sum += ea + eb` over the tile's n-blocks and set l = l alpha + sum, in
// the same expressions, so m, l and every w are bit-identical in both.
__device__ __forceinline__ float row_max(const float s[kNB][4], int r, float& m, float& mb,
                                         float sl2) {
  float mx = kMasked;
#pragma unroll
  for (int j = 0; j < kNB; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
  const float m_new = fmaxf(m, quad_max(mx));
  const float alpha = exp2_ftz((m - m_new) * sl2);
  m = m_new;
  mb = m_new * sl2;
  return alpha;
}

// ---------------------------------------------------------------------------
// forward: a block per (64 query rows, b * H + h), on the tensor cores
// ---------------------------------------------------------------------------
// Q (then the output), the K ring and the V ring, the keys' validity bits:
// dynamic shared memory at head_dim 128 (87 KB), static at 64
template <int HD>
constexpr size_t kFwdSmem =
    HD == 64 ? 0 : 5 * kTileElems<HD> * sizeof(__nv_bfloat16) + kMaxKeys / 8;

template <int HD>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 3 : 2)
    train_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const int* __restrict__ valid,
                     const int* __restrict__ seeds, uint32_t thr, int drop_on, float c,
                     int causal, __nv_bfloat16* __restrict__ out, int T, int S, int H,
                     int b0, int h0, int Hg, float scale) {
  constexpr int kHD = HD, kTE = kTileElems<HD>;
  __nv_bfloat16* qs;  // Q, then the output; then the K ring and the V ring, [2][kTE] each
  if constexpr (HD == 64) {  // 45 KB: static, as before head_dim 128
    __shared__ __align__(16) __nv_bfloat16 tiles[5 * kTE + kMaxKeys / 16];
    qs = tiles;
  } else {
    extern __shared__ __align__(16) unsigned char smem[];
    qs = reinterpret_cast<__nv_bfloat16*>(smem);
  }
  __nv_bfloat16* ks = qs + kTE;
  __nv_bfloat16* vs = ks + 2 * kTE;
  uint32_t* vbits = reinterpret_cast<uint32_t*>(vs + 2 * kTE);  // [kMaxKeys / 32]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int t0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kQTile;
  const size_t stride = (size_t)H * kHD;
  const __nv_bfloat16* kb = k + (size_t)b * S * stride + h * kHD;
  const __nv_bfloat16* vb = v + (size_t)b * S * stride + h * kHD;
  const Drop dr = make_drop(seeds, thr, drop_on, c);

  load_tile<HD>(qs, q + (size_t)b * T * stride + h * kHD, stride, t0, T);
  key_bits(vbits, valid + (size_t)b * S, S, warp, lane);
  __syncthreads();
  // the last valid key bounds the walk (and, when causal, the diagonal of
  // the block's last row): tiles past it are skipped in both passes
  const int words = (S + 31) / 32;
  const int last = last_valid_key(vbits, words, lane);
  const int n_keys = causal ? min(last + 1, t0 + kQTile) : last + 1;
  const int n_tiles = (n_keys + kKTile - 1) / kKTile;  // 0 when no key is valid
  const int steps = 2 * n_tiles;                      // pass 1, then pass 2
  if (steps > 0) load_tile<HD>(ks, kb, stride, 0, S);
  cp_async_commit();

  const int row0 = t0 + 16 * warp + g, row1 = row0 + 8;
  const uint32_t row_term[2] = {dr.s0 + (uint32_t)row0 * kRowMul,
                                dr.s0 + (uint32_t)row1 * kRowMul};
  const uint32_t bh_term = global_bh(b, h, b0, h0, Hg) * kBhMul;
  RegA<HD> qa;
  float o[kONB<HD>][4];
#pragma unroll
  for (int j = 0; j < kONB<HD>; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // Scores stay in units of bf16(q . k): the scale folds into the
  // exponent's factor sl2 = scale log2(e), and e = 2^(s sl2 - m sl2) is one
  // FFMA and one MUFU.EX2.  m and l are the
  // rows' running max (of bf16(q . k)) and sum; mb = m sl2.
  const float sl2 = scale * kLog2e;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f}, mb[2] = {0.f, 0.f};
  float den[2] = {1e-30f, 1e-30f}, rden[2] = {1e30f, 1e30f};  // max(l, 1e-30), its inverse
  const float rc = 1.f / dr.c;

  for (int i = 0; i < steps; ++i) {
    const bool pass2 = i >= n_tiles;
    const int k0 = (pass2 ? i - n_tiles : i) * kKTile;
    if (i + 1 < steps) {
      const int nk0 = (i + 1 < n_tiles ? i + 1 : i + 1 - n_tiles) * kKTile;
      load_tile<HD>(ks + ((i + 1) & 1) * kTE, kb, stride, nk0, S);
      if (i + 1 >= n_tiles) load_tile<HD>(vs + ((i + 1) & 1) * kTE, vb, stride, nk0, S);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this step's tiles (and Q) have landed
    __syncthreads();
    if (i == 0) qa.load(qs, warp, lane);

    float s[kNB][4];
    row_scores<HD, kNB>(s, qa, ks + (i & 1) * kTE, vbits, words, k0, 0, causal, row0, lane);
    if (!pass2) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float alpha = row_max(s, r, m[r], mb[r], sl2);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kNB; ++j)
          sum += exp2_ftz(fmaf(s[j][2 * r], sl2, -mb[r])) +
                 exp2_ftz(fmaf(s[j][2 * r + 1], sl2, -mb[r]));
        l[r] = l[r] * alpha + sum;
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
        pv_chunk<HD>(o, a, vs + (i & 1) * kTE, kc, lane);
      }
    }
    __syncthreads();  // this stage is read; the next step refills it
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread's copies into the Q tile have landed

  stage_out<HD>(qs, o, 1.f, 1.f, warp, lane);
  __syncthreads();
  store_out<HD>(out + (size_t)b * T * stride + h * kHD, qs, stride, t0, T);
}

// ---------------------------------------------------------------------------
// backward, rows: a block per (64 query rows, b * H + h): m, l, delta and dq
// ---------------------------------------------------------------------------
// K/V ring, Q, g, the keys' validity bits, and the keep bits of pass 1: one
// word a thread a key tile (bit 16 r + 2 j + x: row half r, n-block j, key x
// of the pair), read back by the same thread in pass 2
template <int HD>
constexpr size_t kRowsSmem = 6 * kTileElems<HD> * sizeof(__nv_bfloat16) + kMaxKeys / 8 +
                             (kMaxKeys / kKTile) * kThreads * sizeof(uint32_t);

template <int HD>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 3 : 2)
    train_bwd_rows_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const int* __restrict__ valid, const int* __restrict__ seeds,
                          const __nv_bfloat16* __restrict__ g, uint32_t thr, int drop_on,
                          float c, int causal, float* __restrict__ stats,
                          __nv_bfloat16* __restrict__ dq, int T, int S, int H, int b0,
                          int h0, int Hg, float scale) {
  constexpr int kHD = HD, kTE = kTileElems<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // Q, then dq
  __nv_bfloat16* gs = qs + kTE;                                 // g
  __nv_bfloat16* ks = gs + kTE;                                 // K ring, 2 stages
  __nv_bfloat16* vs = ks + 2 * kTE;                             // V ring, 2 stages
  uint32_t* vbits = reinterpret_cast<uint32_t*>(vs + 2 * kTE);
  uint32_t* kbits = vbits + kMaxKeys / 32;  // [kMaxKeys / kKTile][kThreads]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int t0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kQTile;
  const size_t stride = (size_t)H * kHD;
  const __nv_bfloat16* kb = k + (size_t)b * S * stride + h * kHD;
  const __nv_bfloat16* vb = v + (size_t)b * S * stride + h * kHD;
  const Drop dr = make_drop(seeds, thr, drop_on, c);

  load_tile<HD>(qs, q + (size_t)b * T * stride + h * kHD, stride, t0, T);
  load_tile<HD>(gs, g + (size_t)b * T * stride + h * kHD, stride, t0, T);
  key_bits(vbits, valid + (size_t)b * S, S, warp, lane);
  __syncthreads();
  const int words = (S + 31) / 32;
  const int last = last_valid_key(vbits, words, lane);
  const int n_keys = causal ? min(last + 1, t0 + kQTile) : last + 1;
  const int n_tiles = (n_keys + kKTile - 1) / kKTile;
  const int steps = 2 * n_tiles;
  if (steps > 0) {
    load_tile<HD>(ks, kb, stride, 0, S);
    load_tile<HD>(vs, vb, stride, 0, S);
  }
  cp_async_commit();

  const int row0 = t0 + 16 * warp + (lane >> 2), row1 = row0 + 8;
  const uint32_t row_term[2] = {dr.s0 + (uint32_t)row0 * kRowMul,
                                dr.s0 + (uint32_t)row1 * kRowMul};
  const uint32_t bh_term = global_bh(b, h, b0, h0, Hg) * kBhMul;
  HeldA<HD> qa, ga;
  float dqa[kONB<HD>][4];
#pragma unroll
  for (int j = 0; j < kONB<HD>; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;
  const float sl2 = scale * kLog2e;
  // m, l, mb as in the forward; u the running sum of e dw, rescaled with l
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f}, mb[2] = {0.f, 0.f};
  float den[2] = {1e-30f, 1e-30f}, rden[2] = {1e30f, 1e30f}, delta[2] = {0.f, 0.f};
  const float rc = 1.f / dr.c;

  for (int i = 0; i < steps; ++i) {
    const bool pass2 = i >= n_tiles;
    const int k0 = (pass2 ? i - n_tiles : i) * kKTile;
    if (i + 1 < steps) {
      const int nk0 = (i + 1 < n_tiles ? i + 1 : i + 1 - n_tiles) * kKTile;
      load_tile<HD>(ks + ((i + 1) & 1) * kTE, kb, stride, nk0, S);
      load_tile<HD>(vs + ((i + 1) & 1) * kTE, vb, stride, nk0, S);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this step's tiles (and Q, g) have landed
    __syncthreads();
    if (i == 0) {
      qa.load(qs, warp, lane);
      ga.load(gs, warp, lane);
    }
    const __nv_bfloat16* kt = ks + (i & 1) * kTE;
    const __nv_bfloat16* vt = vs + (i & 1) * kTE;
    // g . v and (pass 2) the scores, two n-blocks (one k16 chunk of keys)
    // at a time, so few of them are live at once
    if (!pass2) {
      float s[kNB][4];  // bf16(q . k), masked: the whole tile, for the row max
      row_scores<HD, kNB>(s, qa, kt, vbits, words, k0, 0, causal, row0, lane);
      float alpha[2], sum[2] = {0.f, 0.f}, us[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) alpha[r] = row_max(s, r, m[r], mb[r], sl2);
      uint32_t kw = 0u;  // this tile's keep bits, for pass 2
#pragma unroll
      for (int kc = 0; kc < kKTile / 16; ++kc) {
        float dp[2][4];
        qk_blocks<HD, 2>(dp, ga, vt, 2 * kc, lane);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * kc + jj;
          const uint32_t col_term0 = (uint32_t)(k0 + 8 * j + 2 * t) * kColMul;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float ea = exp2_ftz(fmaf(s[j][2 * r], sl2, -mb[r]));
            const float eb = exp2_ftz(fmaf(s[j][2 * r + 1], sl2, -mb[r]));
            sum[r] += ea + eb;
            const bool keep_a = dr.on && keep_terms(dr, row_term[r], col_term0, bh_term);
            const bool keep_b = dr.on && keep_terms(dr, row_term[r], col_term0 + kColMul, bh_term);
            kw |= (uint32_t)keep_a << (16 * r + 2 * j) | (uint32_t)keep_b << (16 * r + 2 * j + 1);
            us[r] = fmaf(ea, dropped_dw(dp[jj][2 * r], keep_a, dr, rc), us[r]);
            us[r] = fmaf(eb, dropped_dw(dp[jj][2 * r + 1], keep_b, dr, rc), us[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * alpha[r] + sum[r];
        u[r] = u[r] * alpha[r] + us[r];
      }
      if (dr.on) kbits[(k0 / kKTile) * kThreads + threadIdx.x] = kw;
      if (i == n_tiles - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] = quad_sum(l[r]);
          den[r] = fmaxf(l[r], 1e-30f);
          rden[r] = 1.f / den[r];
          delta[r] = div_rn(quad_sum(u[r]), den[r], rden[r]);
        }
      }
    } else {
      // ds = bf16(w (dw - delta) scale) as the bf16 pairs of the A fragments
      // of dq += ds K, one k16 chunk of keys at a time, taken as w (dw scale -
      // delta scale), one FFMA less (the same f32 value at head_dim 64, where
      // the scale is a power of two)
      const float d8[2] = {delta[0] * scale, delta[1] * scale};
      const uint32_t kw = dr.on ? kbits[(k0 / kKTile) * kThreads + threadIdx.x] : 0u;
#pragma unroll
      for (int kc = 0; kc < kKTile / 16; ++kc) {
        float s[2][4], dp[2][4];
        row_scores<HD, 2>(s, qa, kt, vbits, words, k0, 2 * kc, causal, row0, lane);
        qk_blocks<HD, 2>(dp, ga, vt, 2 * kc, lane);
        uint32_t a[4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * kc + jj;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float wa = div_rn(exp2_ftz(fmaf(s[jj][2 * r], sl2, -mb[r])), den[r], rden[r]);
            const float wb = div_rn(exp2_ftz(fmaf(s[jj][2 * r + 1], sl2, -mb[r])), den[r], rden[r]);
            const bool keep_a = (kw >> (16 * r + 2 * j)) & 1u;
            const bool keep_b = (kw >> (16 * r + 2 * j + 1)) & 1u;
            const float dwa = dropped_dw(dp[jj][2 * r], keep_a, dr, rc);
            const float dwb = dropped_dw(dp[jj][2 * r + 1], keep_b, dr, rc);
            a[2 * jj + r] = pack_bf16(wa * fmaf(dwa, scale, -d8[r]), wb * fmaf(dwb, scale, -d8[r]));
          }
        }
        pv_chunk<HD>(dqa, a, kt, kc, lane);
      }
    }
    __syncthreads();  // this stage is read; the next step refills it
  }
  cp_async_wait<0>();
  __syncthreads();

  stage_out<HD>(qs, dqa, 1.f, 1.f, warp, lane);
  __syncthreads();
  store_out<HD>(dq + (size_t)b * T * stride + h * kHD, qs, stride, t0, T);
  if (t == 0) {
    const size_t BHT = (size_t)gridDim.y * T;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row1 : row0;
      if (row >= T) continue;
      const size_t at = (size_t)bh * T + row;
      stats[at] = m[r];
      stats[BHT + at] = l[r];
      stats[2 * BHT + at] = delta[r];
    }
  }
}

// ---------------------------------------------------------------------------
// backward, keys: a block per (64 keys, b * H + h): dk and dv
// ---------------------------------------------------------------------------
template <int HD>
constexpr size_t kKeysSmem = 6 * kTileElems<HD> * sizeof(__nv_bfloat16) +
                             2 * (3 * kQTile * sizeof(float) + kQTile * sizeof(float4));

// Rows r0 .. r0 + 63 of Q and g, and their m, l and delta ([3][kQTile] f32),
// into one stage of the keys kernel's ring; rows at or past T zero-filled.
// Thread i < 64 copies row i's three stats itself, so once its own copies
// have landed it can convert them without a block barrier.
template <int HD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* qt, __nv_bfloat16* gt, float* raw,
                                          const __nv_bfloat16* qb, const __nv_bfloat16* gb,
                                          size_t stride, const float* stats_bh, size_t BHT,
                                          int r0, int T) {
  load_tile<HD>(qt, qb, stride, r0, T);
  load_tile<HD>(gt, gb, stride, r0, T);
  if (threadIdx.x < kQTile) {
    const int r = r0 + threadIdx.x;
#pragma unroll
    for (int which = 0; which < 3; ++which)
      cp_async4(raw + which * kQTile + threadIdx.x, r < T ? stats_bh + which * BHT + r : stats_bh,
                r < T);
  }
}

// A stage's row stats as the keys kernel uses them, one float4 a row: m sl2,
// den = max(l, 1e-30), 1 / den, delta scale (the rows kernel's own values, so
// w is the same f32 in both kernels).  Threads 0 .. 63 convert the rows they
// copied, after their own cp.async wait; the caller's next block barrier
// publishes the result.
__device__ __forceinline__ void convert_rows(float4* st, const float* raw, float sl2,
                                             float scale) {
  if (threadIdx.x < kQTile) {
    const float den = fmaxf(raw[kQTile + threadIdx.x], 1e-30f);
    st[threadIdx.x] = make_float4(raw[threadIdx.x] * sl2, den, 1.f / den,
                                  raw[2 * kQTile + threadIdx.x] * scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 3 : 2)
    train_bwd_keys_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const int* __restrict__ valid, const int* __restrict__ seeds,
                          const __nv_bfloat16* __restrict__ g, uint32_t thr, int drop_on,
                          float c, int causal, const float* __restrict__ stats,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                          int T, int S, int H, int b0, int h0, int Hg, float scale) {
  constexpr int kHD = HD, kTE = kTileElems<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // K, then dk
  __nv_bfloat16* vs = ks + kTE;                                 // V, then dv
  __nv_bfloat16* qs = vs + kTE;                                 // Q ring, 2 stages
  __nv_bfloat16* gs = qs + 2 * kTE;                             // g ring, 2 stages
  float4* sts = reinterpret_cast<float4*>(gs + 2 * kTE);        // [2][kQTile] converted
  float* raw = reinterpret_cast<float*>(sts + 2 * kQTile);        // [2][3][kQTile] m, l, delta

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int c0 = blockIdx.x * kKTile;
  const size_t stride = (size_t)H * kHD;
  const __nv_bfloat16* qb = q + (size_t)b * T * stride + h * kHD;
  const __nv_bfloat16* gb = g + (size_t)b * T * stride + h * kHD;
  const size_t BHT = (size_t)gridDim.y * T;
  const float* stats_bh = stats + (size_t)bh * T;
  const Drop dr = make_drop(seeds, thr, drop_on, c);
  const float sl2 = scale * kLog2e;

  // this lane's two keys (rows g and g + 8 of the warp's 16) and whether
  // each is attendable at all.  An invalid key is not masked per element:
  // it is the row of its own dk and dv in every product here, so whatever
  // its w and ds come to touches nothing else, and its dk and dv are set
  // to 0 at the end.
  const int key0 = c0 + 16 * warp + (lane >> 2), key1 = key0 + 8;
  const int* vrow = valid + (size_t)b * S;
  const bool ok[2] = {key0 < S && vrow[key0] != 0, key1 < S && vrow[key1] != 0};
  // a block none of whose keys is valid walks no query tile (dk = dv = 0);
  // causal query tiles wholly above the block's keys are skipped
  const int n_q = __syncthreads_or(ok[0] || ok[1]) ? (T + kQTile - 1) / kQTile : 0;
  const int first = causal ? blockIdx.x : 0;

  load_tile<HD>(ks, k + (size_t)b * S * stride + h * kHD, stride, c0, S);
  load_tile<HD>(vs, v + (size_t)b * S * stride + h * kHD, stride, c0, S);
  if (first < n_q) load_rows<HD>(qs, gs, raw, qb, gb, stride, stats_bh, BHT, first * kQTile, T);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  convert_rows(sts, raw, sl2, scale);

  const uint32_t col_term[2] = {(uint32_t)key0 * kColMul, (uint32_t)key1 * kColMul};
  const uint32_t bh_term = global_bh(b, h, b0, h0, Hg) * kBhMul;
  HeldA<HD> ka, va;
  ka.load(ks, warp, lane);
  va.load(vs, warp, lane);
  float dka[kONB<HD>][4], dva[kONB<HD>][4];
#pragma unroll
  for (int j = 0; j < kONB<HD>; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  const float rc = 1.f / dr.c;

  for (int i = first; i < n_q; ++i) {
    const int stg = (i - first) & 1, tq0 = i * kQTile;
    if (i + 1 < n_q)
      load_rows<HD>(qs + (stg ^ 1) * kTE, gs + (stg ^ 1) * kTE, raw + (stg ^ 1) * 3 * kQTile, qb,
                    gb, stride, stats_bh, BHT, tq0 + kQTile, T);
    cp_async_commit();
    cp_async_wait<1>();  // this step's tiles have landed
    __syncthreads();     // ... for every thread, and so have their converted stats
    const __nv_bfloat16* qt = qs + stg * kTE;
    const __nv_bfloat16* gt = gs + stg * kTE;
    const float4* st = sts + stg * kQTile;
    // rows past T (the last tile) and, when causal, keys past the row (the
    // tile on the block's diagonal) take -inf
    const bool edge = tq0 + kQTile > T || (causal && c0 + 16 * warp + 15 > tq0);
#pragma unroll
    for (int kc = 0; kc < kQTile / 16; ++kc) {
      // the transposed scores and g . v of rows 16 kc .. 16 kc + 15 of the
      // tile: row = this warp's key, column = a query row
      float sT[2][4], dT[2][4];
      qk_blocks<HD, 2>(sT, ka, qt, 2 * kc, lane);
      qk_blocks<HD, 2>(dT, va, gt, 2 * kc, lane);
      uint32_t aw[4], ad[4];  // A fragments of wd^T and ds^T for this chunk of rows
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int rl = 8 * (2 * kc + jj) + 2 * t;  // the pair's first row in the tile
        round_bf16x2(sT[jj][0], sT[jj][1]);
        round_bf16x2(sT[jj][2], sT[jj][3]);
        if (edge) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = tq0 + rl + (e & 1);
            if (row >= T || (causal && (e < 2 ? key0 : key1) > row)) sT[jj][e] = -INFINITY;
          }
        }
        const float4 rs[2] = {st[rl], st[rl + 1]};
        const uint32_t row_term0 = dr.s0 + (uint32_t)(tq0 + rl) * kRowMul;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float w[2], wd[2], dw[2];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            w[x] = div_rn(exp2_ftz(fmaf(sT[jj][2 * r + x], sl2, -rs[x].x)), rs[x].y, rs[x].z);
            wd[x] = w[x];
          }
          round_bf16x2(wd[0], wd[1]);
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const bool keep = dr.on && keep_terms(dr, row_term0 + x * kRowMul, col_term[r], bh_term);
            if (dr.on) wd[x] = keep ? div_rn(wd[x], dr.c, rc) : 0.f;
            dw[x] = dropped_dw(dT[jj][2 * r + x], keep, dr, rc);
          }
          aw[2 * jj + r] = pack_bf16(wd[0], wd[1]);
          // ds = bf16(w (dw - delta) scale), the scale folded as in the rows kernel
          ad[2 * jj + r] = pack_bf16(w[0] * fmaf(dw[0], scale, -rs[0].w),
                                     w[1] * fmaf(dw[1], scale, -rs[1].w));
        }
      }
      pv_chunk<HD>(dva, aw, gt, kc, lane);
      pv_chunk<HD>(dka, ad, qt, kc, lane);
    }
    if (i + 1 < n_q) {  // the next stage's stats, converted while this one is done
      cp_async_wait<0>();
      convert_rows(sts + (stg ^ 1) * kQTile, raw + (stg ^ 1) * 3 * kQTile, sl2, scale);
    }
    __syncthreads();  // this stage is read; the next step refills it
  }
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int j = 0; j < kONB<HD>; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dka[j][e] = ok[e >> 1] ? dka[j][e] : 0.f;
      dva[j][e] = ok[e >> 1] ? dva[j][e] : 0.f;
    }
  stage_out<HD>(ks, dka, 1.f, 1.f, warp, lane);
  stage_out<HD>(vs, dva, 1.f, 1.f, warp, lane);
  __syncthreads();
  store_out<HD>(dk + (size_t)b * S * stride + h * kHD, ks, stride, c0, S);
  store_out<HD>(dv + (size_t)b * S * stride + h * kHD, vs, stride, c0, S);
}

__global__ void keep_mask_kernel(const int* __restrict__ seeds, uint32_t thr, int T, int S,
                                 int H, int b0, int h0, int Hg, size_t n,
                                 uint8_t* __restrict__ out) {
  const Drop dr = make_drop(seeds, thr, 1, 1.f);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const uint32_t col = (uint32_t)(i % S);
    const uint32_t row = (uint32_t)((i / S) % T);
    const int bh = (int)(i / ((size_t)S * T));
    out[i] = keep_at(dr, global_bh(bh / H, bh % H, b0, h0, Hg), row, col) ? 1 : 0;
  }
}

bool bad_shape(int B, int T, int S, int H) {
  return B < 1 || T < 1 || S < 1 || H < 1 || S > kMaxKeys || B * H > 65535;
}

bool bad_shard(int b0, int h0, int Hg, int H) { return b0 < 0 || h0 < 0 || h0 + H > Hg; }

template <int HD>
int launch_fwd(int B, int T, int S, int H, int b0, int h0, int Hg, const void* q,
               const void* k, const void* v, const void* valid, const void* seeds,
               unsigned int thr, int drop_on, float c, int causal, float scale, void* out,
               cudaStream_t st) {
  if (kFwdSmem<HD> > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        train_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFwdSmem<HD>);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((T + kQTile - 1) / kQTile, B * H);
  train_fwd_kernel<HD><<<grid, kThreads, kFwdSmem<HD>, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(valid),
      static_cast<const int*>(seeds), thr, drop_on, c, causal,
      static_cast<__nv_bfloat16*>(out), T, S, H, b0, h0, Hg, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd(int B, int T, int S, int H, int b0, int h0, int Hg, const void* q,
               const void* k, const void* v, const void* valid, const void* seeds,
               const void* g, unsigned int thr,
               int drop_on, float c, int causal, float scale, void* stats, void* dq, void* dk,
               void* dv, cudaStream_t st) {
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  const int* vl = static_cast<const int*>(valid);
  const int* sd = static_cast<const int*>(seeds);
  float* stt = static_cast<float*>(stats);
  cudaError_t e = cudaFuncSetAttribute(train_bwd_rows_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kRowsSmem<HD>);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(train_bwd_keys_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kKeysSmem<HD>);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_a((T + kQTile - 1) / kQTile, B * H);
  train_bwd_rows_kernel<HD><<<grid_a, kThreads, kRowsSmem<HD>, st>>>(
      qb, kb, vb, vl, sd, gb, thr, drop_on, c, causal, stt, static_cast<__nv_bfloat16*>(dq), T,
      S, H, b0, h0, Hg, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid_b((S + kKTile - 1) / kKTile, B * H);
  train_bwd_keys_kernel<HD><<<grid_b, kThreads, kKeysSmem<HD>, st>>>(
      qb, kb, vb, vl, sd, gb, thr, drop_on, c, causal, stt, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), T, S, H, b0, h0, Hg, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, T, H, HD), k and v (B, S, H, HD), out (B, T, H, HD): bf16,
// contiguous, HD = head_dim 64 or 128; valid (B, S) int32 (nonzero =
// attendable); seeds (4,) int32 on the device; thr the keep threshold,
// drop_on = rate > 0, c = bf16(1 - rate); scale = 1 / sqrt(HD).  The keep
// hash reads the global (b0 + b, h0 + h) of Hg heads (0, 0, H unsharded).
int smer_train_attn_fwd(int head_dim, int B, int T, int S, int H, int b0, int h0, int Hg,
                        const void* q, const void* k, const void* v, const void* valid,
                        const void* seeds, unsigned int thr, int drop_on, float c, int causal,
                        float scale, void* out, void* stream) {
  if (bad_shape(B, T, S, H) || bad_shard(b0, h0, Hg, H)) return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_fwd<64>(B, T, S, H, b0, h0, Hg, q, k, v, valid, seeds, thr, drop_on, c,
                             causal, scale, out, st);
    case 128:
      return launch_fwd<128>(B, T, S, H, b0, h0, Hg, q, k, v, valid, seeds, thr, drop_on, c,
                             causal, scale, out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The backward of smer_train_attn_fwd: g (B, T, H, HD) bf16; stats a
// (3, B*H, T) f32 scratch buffer; dq, dk, dv bf16 in the layouts of q, k, v.
int smer_train_attn_bwd(int head_dim, int B, int T, int S, int H, int b0, int h0, int Hg,
                        const void* q, const void* k, const void* v, const void* valid,
                        const void* seeds, const void* g, unsigned int thr, int drop_on, float c,
                        int causal, float scale, void* stats, void* dq, void* dk, void* dv,
                        void* stream) {
  if (bad_shape(B, T, S, H) || bad_shard(b0, h0, Hg, H)) return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(g) || !aligned16(dq) ||
      !aligned16(dk) || !aligned16(dv))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_bwd<64>(B, T, S, H, b0, h0, Hg, q, k, v, valid, seeds, g, thr, drop_on,
                             c, causal, scale, stats, dq, dk, dv, st);
    case 128:
      return launch_bwd<128>(B, T, S, H, b0, h0, Hg, q, k, v, valid, seeds, g, thr, drop_on,
                             c, causal, scale, stats, dq, dk, dv, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The keep mask of the kernels' hash: out (B*H, T, S) uint8, 1 = keep, at
// the global (b0 + b, h0 + h) of Hg heads.
int smer_dropout_keep_mask(int B, int H, int T, int S, int b0, int h0, int Hg,
                           const void* seeds, unsigned int thr, void* out, void* stream) {
  if (B < 1 || H < 1 || T < 1 || S < 1 || bad_shard(b0, h0, Hg, H))
    return (int)cudaErrorInvalidValue;
  const int BH = B * H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)BH * T * S;
  const int blocks = (int)((n + 255) / 256 < 8192 ? (n + 255) / 256 : 8192);
  keep_mask_kernel<<<blocks, 256, 0, st>>>(static_cast<const int*>(seeds), thr, T, S, H, b0,
                                           h0, Hg, n, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
