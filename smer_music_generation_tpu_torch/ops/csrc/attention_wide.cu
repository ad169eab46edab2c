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
// Design rule: shared memory and registers do not grow with head_dim, so no
// new ceiling replaces 128.  A block owns 64 rows and one output chunk of at
// most 128 columns (grid.z walks the chunks), and recomputes the scores and
// row statistics its chunk needs: at head_dim 256 each score product runs
// twice, at 512 four times (sharing a tile's P between two chunks' blocks
// is not measured).  Backward: FlashAttention-2's deterministic
// two-kernel order, no atomics:
//   wide_rows_kernel: dq of its chunk; MODE 1 also recomputes m, l and delta
//     = sum_s w dw (pass 1: m and l online, u = sum e dw rescaled with l,
//     delta = u / max(l, 1e-30); JAX's delta takes the unrounded w, so it is
//     not FlashAttention's g . o) and writes them to the (3, B*H, T) stats;
//     MODE 2 reads the forward's m and l and writes di = sum_d o g;
//   wide_keys_kernel: dk or dv of its chunk from those statistics, a block
//     per 64 keys: grid.z is doubled, its first half dk blocks, its second
//     dv blocks, so that each holds one 64 x 128 accumulator.
//
// All three run every product on the tensor cores with mma.sync (the
// fragments, ldmatrix and cp.async helpers of attn_tiles.cuh): a block of 4
// warps, 16 query rows a warp, walks tiles of 64 keys (MODE 2's forward
// takes them in pairs, so its m steps by the library's 128-key block); the
// keys kernel swaps the roles, 16 keys a warp walking tiles of 64 queries.  A tile's scores (and in the rows kernel g V^T)
// are summed over head_dim in steps of one staged chunk (64 columns in bf16,
// 32 in f32) of Q (or g) and of K (or V): Q is not held whole but streamed
// with K, its A fragments read from the staged chunk at each use.  Every
// step's tiles come through a two-stage cp.async ring (rows padded so that
// ldmatrix is free of bank conflicts, one block barrier a step), and the
// tile's V (or, for dq, K) rows of the block's output chunk follow as steps
// of the same ring.  The scores stay in C fragments; each row's statistics
// are reduced by quad shuffles; P (or ds) goes from the C fragments to the
// A fragments of the output product in registers.  What does not fit beside
// the 64 x 128 output accumulator and a tile's scores waits in shared
// memory: MODE 2's first tile of a pair while the second is scored, and in
// the rows kernel w, e or p while g V^T is taken (a per-thread stash), and
// the ring's plan of the block's walk.  MODE 1's keep bits are hashed into
// one word a tile before its scores.  So the kernels fit 168 registers and
// three blocks an SM (wide_fwd_kernel<bf16, 0>, two): these kernels are
// bound by latency, not by the products, and the third block made the
// forwards 10-41% faster and each backward pair 6-9%
// (scripts/wide_variants.py; a 3- or 4-stage ring changed nothing).
//   bf16: mma.sync m16n8k16 with f32 sums.  MODE 0's P is f32 in JAX and in
//     the twin, and one bf16 rounding of it is not accurate enough for a
//     peaked softmax, so it goes through P V as bf16(P) plus bf16(P -
//     bf16(P)) into the same accumulator (attention.cu's route); MODE 1's wd
//     and ds and MODE 2's cast(p) and ds are bf16 values already, exact as
//     one bf16 operand.
//   f32: mma.sync m16n8k8 TF32 in split TF32, as attention_f32.cu takes it
//     (its helpers are copied below, so that scripts/flash_train_variants.py
//     keeps editing that file alone): hi = x rounded to TF32, lo = x - hi,
//     lo hi, hi lo, hi hi into one accumulator chain a sum (the scores over
//     head_dim, the output over every key); nothing is rounded to bf16.
// Every sum over head_dim runs in one chain in the same order in all three
// kernels (the keys kernel's S^T = K Q^T with split TF32's cross passes
// swapped), and the keys kernel takes w, p, dw and ds by the rows kernel's
// formulas, so that the weights behind dq and behind dk and dv are the same
// bits (scripts/wide_score_probe.py counts the scores that differ).
//
// What bounds them on an NVIDIA H100 (989 TFLOP/s dense bf16, 495 TF32, 3.35
// TB/s at 700 W): the operations; at B=8, H=2, T=S=640, head_dim 256 the
// forward's two products are 6.7 GFLOP (7 us at the bf16 peak; 41 us in
// split TF32 at a third of the TF32 rate), the backward's five 16.8 GFLOP.
// These kernels do more: the recomputed chunk (x2 at head_dim 256), MODE 0's
// P V twice, MODE 1's two passes, the keys kernel's S^T in both its dk and
// its dv blocks (8 full-size products a 64-key block at head_dim 256, not
// 4); and every block re-reads its operands from L2 for each tile and
// chunk.  Measured times are in PERF.md
// (chip_smoke.py phase 5e, scripts/torch_kernel_ab.py --attention).
//
// The launchers have a plain C interface and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tiles.cuh"
#include "dropout_hash.cuh"

namespace {

using namespace dropout_hash;
namespace tiles = attn_tiles;
using bf16 = __nv_bfloat16;

constexpr int kModeFused = 0, kModeDrop = 1, kModeFlash = 2;
constexpr int kMaxKeys = 1024;  // JAX's MAX_KLEN: the gate of the TPU dropout kernel, kept
constexpr float kMasked = -1e30f;
// the library's DEFAULT_MASK_VALUE, -0.7 * f32 max taken in double, then f32
constexpr float kMaskValue = (float)(-0.7 * 3.4028234663852886e38);
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDC = 64;   // head_dim comes in multiples of 64 (the wrappers pad to one)
constexpr int kOC = 128;  // a block's output columns (the last chunk may hold 64)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

template <class T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
// a weight cast to the inputs' dtype, as the library's p.astype(v.dtype)
template <class T>
__device__ __forceinline__ float cast(float x) { return to_f(from_f<T>(x)); }

// e^x on the SFU alone (MUFU.EX2): torch.exp2's bits of 2^(x log2 e)
// wherever that is a normal float (flash_train.cu), a subnormal result
// flushed to 0; 2^-inf = 0, so a key at -inf weighs exactly 0 (every
// running max is finite)
__device__ __forceinline__ float ex2_ftz(float x) { return attn_tiles::exp2_ftz(x * kLog2e); }

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

// ---------------------------------------------------------------------------
// split TF32 (attention_f32.cu's helpers): x = hi + lo, hi rounded to TF32
// (nearest, ties away: cvt.rna.tf32.f32's bits), lo the exact rest, which
// the tensor cores read as TF32; a k8 step adds lo_a hi_b, hi_a lo_b, hi_a
// hi_b to the accumulator in that order.  With SWAP (the keys kernel, whose
// A operand is the rows kernel's B) the first two swap, hi_a lo_b, lo_a
// hi_b, so that K Q^T adds lo_q hi_k, hi_q lo_k, hi hi as Q K^T does.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

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

template <bool SWAP = false>
__device__ __forceinline__ void mma_split(float c[4], const uint32_t ah[4], const uint32_t al[4],
                                          float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  if (SWAP) {
    mma_tf32(c, ah, bl0, bl1);
    mma_tf32(c, al, bh0, bh1);
  } else {
    mma_tf32(c, al, bh0, bh1);
    mma_tf32(c, ah, bl0, bl1);
  }
  mma_tf32(c, ah, bh0, bh1);
}

// ---------------------------------------------------------------------------
// the tensor-core kernels' tiles
// ---------------------------------------------------------------------------
constexpr int kTcThreads = 128;  // 4 warps
constexpr int kRows = 64;        // a block's query rows, 16 a warp (the keys kernel: a query tile)
constexpr int kKeys = 64;        // a key tile (MODE 2's forward takes them in pairs: its m step;
                                 // the keys kernel: a block's keys, 16 a warp)
constexpr int kNJ = kKeys / 8;   // n-blocks of a tile's scores
constexpr int kBlk = 128;        // the library's block (MODE 2)

// A score step stages one head_dim chunk of the block's own operand X (Q; g;
// in the keys kernel K; V) and of a tile's Y (K; V; in the keys kernel Q;
// g), rows padded to 144 bytes (72 bf16, 36 f32: the 8 rows of an ldmatrix
// phase on 8 distinct 16-byte bank groups), and after a tile's last chunk
// its keys' validity (the keys kernel: its queries' statistics).  An output
// step stages kOutKeys rows of V (K for dq; g for dv, Q for dk) over the
// block's output chunk, rows padded to 128 + 8 bf16 or 128 + 4 f32 (P Y's
// f32 B operand then reads 32 distinct banks).
template <class T>
struct Elem;
template <>
struct Elem<bf16> {
  static constexpr int kChunk = 64, kLdC = 72, kOutKeys = 64, kLdO = kOC + 8;
};
template <>
struct Elem<float> {
  static constexpr int kChunk = 32, kLdC = 36, kOutKeys = 32, kLdO = kOC + 4;
};
constexpr int kChunkBytes = 64 * 144;                // 64 rows of a staged chunk
constexpr int kValidOff = 2 * kChunkBytes;           // X, Y chunks; then the validity or statistics
constexpr int kStage = kValidOff + 2 * kRows * 4;    // 18,944 bytes: two statistics of a query tile
constexpr int kStages = 2;                           // the ring's depth
// each thread's stash of one tile's 32 C-fragment values (MODE 2's first
// scores of a pair in the forward; w, e or p beside g V^T in the rows
// kernel), word i at [i][threadIdx.x]: conflict-free, and read back only by
// the thread that wrote it
constexpr int kStashOff = kStages * kStage;
constexpr size_t kTcSmem = (size_t)kStashOff + 4 * kNJ * kTcThreads * sizeof(float);  // 54,272 bytes
static_assert(kRows * Elem<bf16>::kLdO * 2 <= kValidOff && 32 * Elem<float>::kLdO * 4 <= kValidOff,
              "an output step fits a stage");
static_assert(kStage % 16 == 0, "stages stay 16-byte aligned");

// rows r0 .. r0 + ROWS - 1 of one head of a (B, L, H, D) tensor (base at
// (b, 0, h, 0), ld elements between positions), columns c0 .. c0 + COLS - 1,
// into dst[ROWS][LD] by 16-byte cp.async, every thread taking part; rows at
// and past `limit` and columns at and past `ncols` (of the COLS) zero-filled.
// Offsets from base in 32 bits: a head's rows span H D L < 2^31 elements.
template <class T, int ROWS, int COLS, int LD>
__device__ __forceinline__ void stage_rows(T* dst, const T* base, int ld, int r0, int limit,
                                           int c0, int ncols) {
  constexpr int kPer = 16 / sizeof(T), kCpr = COLS / kPer, kN = ROWS * kCpr;
  static_assert(kN % kTcThreads == 0, "every thread copies as many chunks");
  const int c = kPer * (threadIdx.x % kCpr), r = threadIdx.x / kCpr;
#pragma unroll
  for (int u = 0; u < kN / kTcThreads; ++u) {
    const int ru = r + u * (kTcThreads / kCpr);
    const bool ok = r0 + ru < limit && c < ncols;
    tiles::cp_async16(dst + ru * LD + c, ok ? base + ((uint32_t)(r0 + ru) * (uint32_t)ld + c0 + c) : base,
                      ok);
  }
}

// keys k0 .. k0 + kKeys - 1 of a batch row's validity (zeros at and past S)
__device__ __forceinline__ void stage_valid(int* dst, const int* valid, int k0, int S) {
  if (threadIdx.x < kKeys) {
    const bool ok = k0 + (int)threadIdx.x < S;
    tiles::cp_async4(dst + threadIdx.x, ok ? valid + k0 + threadIdx.x : valid, ok);
  }
}

// s[j] += X Y^T over one staged chunk: X this warp's 16 rows of the stage's
// X chunk, Y rows 8 j .. 8 j + 7 of its Y chunk.  The k steps run in order,
// so with the chunks taken in order each n-block's sum is one chain over
// head_dim.  bf16: four k16 steps, two at a time for every n-block, X's A
// fragments and Y's B by ldmatrix (SWAP changes nothing: the products are
// exact).
template <bool SWAP = false>
__device__ __forceinline__ void score_step(float (&s)[kNJ][4], const bf16* xs, int warp,
                                           int lane) {
  constexpr int ld = Elem<bf16>::kLdC;
  const bf16* ys = xs + kChunkBytes / 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {  // k16 steps 2 half and 2 half + 1
    uint32_t a0[4], a1[4];
    tiles::ldsm_x4(a0, xs + (16 * warp + (lane & 15)) * ld + 32 * half + 8 * (lane >> 4));
    tiles::ldsm_x4(a1, xs + (16 * warp + (lane & 15)) * ld + 32 * half + 16 + 8 * (lane >> 4));
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      uint32_t b[4];
      tiles::ldsm_x4(b, ys + (8 * j + (lane & 7)) * ld + 32 * half + 8 * (lane >> 3));
      tiles::mma_bf16(s[j], a0, b[0], b[1]);
      tiles::mma_bf16(s[j], a1, b[2], b[3]);
    }
  }
}

// f32: four k8 steps in split TF32, both operands split at each use (SWAP:
// mma_split's order for the keys kernel); the fragments by ldmatrix.x4 with
// each f32 taken as two b16 (lane 4 g + t receives row g, float t of each 8
// x 4-float matrix: the m16n8k8 TF32 layout), as attention_f32.cu's xyt_tc
// reads them
template <bool SWAP = false>
__device__ __forceinline__ void score_step(float (&s)[kNJ][4], const float* xs, int warp,
                                           int lane) {
  constexpr int ld = Elem<float>::kLdC;
  const float* x = xs + (16 * warp + (lane & 7) + (lane & 8)) * ld + ((lane >> 4) << 2);
  const float* y = xs + kChunkBytes / 4 + ((lane & 7) + ((lane >> 4) << 3)) * ld +
                   (((lane >> 3) & 1) << 2);
#pragma unroll
  for (int kk = 0; kk < Elem<float>::kChunk; kk += 8) {
    uint32_t r[4], ah[4], al[4];
    tiles::ldsm_x4(r, reinterpret_cast<const bf16*>(x + kk));
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(r[i]), ah[i], al[i]);
#pragma unroll
    for (int j = 0; j < kNJ; j += 2) {
      uint32_t b[4];
      tiles::ldsm_x4(b, reinterpret_cast<const bf16*>(y + 8 * j * ld + kk));
      mma_split<SWAP>(s[j], ah, al, __uint_as_float(b[0]), __uint_as_float(b[1]));
      mma_split<SWAP>(s[j + 1], ah, al, __uint_as_float(b[2]), __uint_as_float(b[3]));
    }
  }
}

// o += P Y over one staged output step: P(j, e) the C-fragment value e of
// n-block j of this warp's 16 rows over the tile's keys, Y the step's rows of
// V (or K) over the block's output chunk, whose first nnb n-blocks are real.
// bf16: 64 keys, four k16 chunks, P's A fragments packed from the C layout
// (two n-blocks a chunk), Y's B by ldmatrix.trans; with SPLIT P goes as
// bf16(P) plus bf16(P - bf16(P)), each B fragment loaded once for both.
template <bool SPLIT, class P>
__device__ __forceinline__ void out_step(float (&o)[kOC / 8][4], P p, int sub, const bf16* ys,
                                         int lane, int nnb) {
  constexpr int ld = Elem<bf16>::kLdO;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = 2 * kc + (u >> 1), e = 2 * (u & 1);
      const float p0 = p(j, e), p1 = p(j, e + 1);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      ah[u] = *reinterpret_cast<const uint32_t*>(&hi);
      if (SPLIT) {
        const float2 hf = __bfloat1622float2(hi);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
        al[u] = *reinterpret_cast<const uint32_t*>(&lo);
      }
    }
#pragma unroll
    for (int jp = 0; jp < kOC / 16; ++jp) {
      if (2 * jp < nnb) {
        // matrices: rows 0-7 / 8-15 of the chunk, columns 16 jp .. + 7 / + 8 .. + 15
        uint32_t b[4];
        tiles::ldsm_x4_trans(b, ys + (16 * kc + (lane & 15)) * ld + 16 * jp + 8 * (lane >> 4));
        tiles::mma_bf16(o[2 * jp], ah, b[0], b[1]);
        tiles::mma_bf16(o[2 * jp + 1], ah, b[2], b[3]);
        if (SPLIT) {
          tiles::mma_bf16(o[2 * jp], al, b[0], b[1]);
          tiles::mma_bf16(o[2 * jp + 1], al, b[2], b[3]);
        }
      }
    }
  }
}

// f32: the tile's 32-key half `sub`, four k8 chunks in split TF32 (SPLIT is
// the split itself); the TF32 A fragment takes the chunk's columns in the
// order 0 2 4 6 1 3 5 7 (a0 = c0, a1 = c2, a2 = c1, a3 = c3), the B fragment
// rows 2 t and 2 t + 1 to match, as attention_f32.cu's pv_tc
template <bool SPLIT, class P>
__device__ __forceinline__ void out_step(float (&o)[kOC / 8][4], P p, int sub, const float* ys,
                                         int lane, int nnb) {
  constexpr int ld = Elem<float>::kLdO;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t ah[4], al[4];
    const int jn = 4 * sub + j;
    split_tf32(p(jn, 0), ah[0], al[0]);
    split_tf32(p(jn, 2), ah[1], al[1]);
    split_tf32(p(jn, 1), ah[2], al[2]);
    split_tf32(p(jn, 3), ah[3], al[3]);
    const float* y = ys + (8 * j + 2 * t) * ld + g;
#pragma unroll
    for (int nb = 0; nb < kOC / 8; ++nb)
      if (nb < nnb) mma_split(o[nb], ah, al, y[8 * nb], y[ld + 8 * nb]);
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// rows row0 and row0 + 8 of this warp's 16 x ncols accumulator (C fragments)
// into a (B, T, H, D) tensor (base at (b, 0, h, c0)), each row times mul[r]
template <class T>
__device__ __forceinline__ void store_rows(T* base, size_t ld, int row0, int n_rows, int nnb,
                                           const float (&acc)[kOC / 8][4], const float (&mul)[2],
                                           int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n_rows) continue;
    T* dst = base + (size_t)row * ld + 2 * t;
#pragma unroll
    for (int nb = 0; nb < kOC / 8; ++nb)
      if (nb < nnb) store2(dst + 8 * nb, acc[nb][2 * r] * mul[r], acc[nb][2 * r + 1] * mul[r]);
  }
}

// A block's walk over its steps, every one through the cp.async ring:
// fetch(i, stage) stages step i (nothing past the last) and commits one
// group; next() waits for the current step's group, takes one block barrier
// (so every warp is past the stage the next fetch refills), fetches the step
// kStages - 1 ahead and returns the current step's stage.
template <class Fetch>
struct Ring {
  unsigned char* smem;
  Fetch fetch;
  int step;
  __device__ __forceinline__ Ring(unsigned char* s, Fetch f) : smem(s), fetch(f), step(0) {
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) fetch(i, stage(i));
  }
  __device__ __forceinline__ unsigned char* stage(int i) const { return smem + (i % kStages) * kStage; }
  __device__ __forceinline__ const unsigned char* next() {
    tiles::cp_async_wait<kStages - 2>();
    __syncthreads();
    fetch(step + kStages - 1, stage(step + kStages - 1));
    return stage(step++);
  }
  // the validity staged with the step just taken (a tile's last chunk)
  __device__ __forceinline__ const int* valid() const {
    return reinterpret_cast<const int*>(stage(step - 1) + kValidOff);
  }
  // the keys kernel's: a query tile's statistics, kRows floats each
  __device__ __forceinline__ const float* stats() const {
    return reinterpret_cast<const float*>(stage(step - 1) + kValidOff);
  }
};

// What the ring's fetch needs of a block's walk, written once a block into
// shared memory and read back at each step: held in registers across the
// loop it would take some twenty that the tiles need (a kernel capped for
// three blocks an SM spilled)
struct Plan {
  const void* x[2];  // (b, 0, h, 0) of the block's own operands: q; g (the keys kernel: k; v)
  const void* y[2];  // of a tile's: k; v (the keys kernel: q; g)
  const void* o;     // of the output steps' rows: v (forward), k (dq), g (dv), q (dk)
  const int* valid;  // the batch row's key validity
  void* out;         // (b, 0, h, c0) of the output, or of dq, dk or dv
  float* stats;      // row 0 of (b * H + h) in the statistics: m; l and delta B H T apart
  const float* st[3];  // the keys kernel's rows of them: m, l, and delta (MODE 1) or di (MODE 2)
  Drop dr;           // MODE 1: the keep hash's words, threshold, rate flag and c
  uint32_t bhg;      // MODE 1: the hash's global b * H + h
  float rc;          // MODE 1: 1 / c
  int ld, t0, nsc, per, steps0, total, c0, ncols, n_valid, s0;
};

// the plan's base of one head of a (B, L, H, D) tensor
template <class T>
__device__ __forceinline__ const T* head(const void* p, int b, int L, int H, int h, int D) {
  return static_cast<const T*>(p) + ((size_t)b * L * H + h) * D;
}

// MODE 1: the keep bits of this thread's 32 C-fragment elements of the key
// tile at k0 (bit 4 j + e: row row0 + 8 (e >> 1), key k0 + 8 j + 2 t + (e & 1)),
// from the hash of dropout_hash.cuh; all set without dropout.  Taken while
// the tile's scores are not live, so that the hash's temporaries do not sit
// beside them.
__device__ __forceinline__ uint32_t keep_bits(const Plan& p, int row0, int k0, int t) {
  const Drop dr = p.dr;
  if (!dr.on) return ~0u;
  const uint32_t bh_term = p.bhg * kBhMul;
  uint32_t bits = 0u;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t row_term = dr.s0 + (uint32_t)(row0 + 8 * (e >> 1)) * kRowMul;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const uint32_t col = k0 + 8 * j + 2 * t + (e & 1);
      bits |= (keep_terms(dr, row_term, col * kColMul, bh_term) ? 1u : 0u) << (4 * j + e);
    }
  }
  return bits;
}

// ---------------------------------------------------------------------------
// forward: a block per (64 query rows, b * H + h, 128 output columns)
// ---------------------------------------------------------------------------
// step i of a forward block's walk: MODE 1's first pass (nsc score steps a
// tile), then a group's kG tiles' score steps and their output steps
template <class T, int MODE>
__device__ __forceinline__ void fetch_fwd(const WideArgs& a, const Plan& p, int i, unsigned char* st) {
  using E = Elem<T>;
  constexpr int kG = MODE == kModeFlash ? 2 : 1, kOut = kKeys / E::kOutKeys;
  if (i < p.total) {
    const int nsc = p.nsc;
    int tile, j;
    if (i < p.steps0) {
      tile = i / nsc;
      j = i % nsc;
    } else {
      const int r = i - p.steps0, grp = r / p.per, jg = r % p.per;
      tile = grp * kG + (jg < kG * nsc ? jg / nsc : (jg - kG * nsc) / kOut);
      j = jg < kG * nsc ? jg % nsc : nsc + (jg - kG * nsc) % kOut;
    }
    const int k0 = tile * kKeys;
    if (j < nsc) {
      stage_rows<T, kRows, E::kChunk, E::kLdC>(reinterpret_cast<T*>(st), static_cast<const T*>(p.x[0]),
                                               p.ld, p.t0, a.T, j * E::kChunk, E::kChunk);
      stage_rows<T, kKeys, E::kChunk, E::kLdC>(reinterpret_cast<T*>(st + kChunkBytes),
                                               static_cast<const T*>(p.y[0]), p.ld, k0, a.S,
                                               j * E::kChunk, E::kChunk);
      if (MODE != kModeFused && j == nsc - 1)
        stage_valid(reinterpret_cast<int*>(st + kValidOff), p.valid, k0, a.S);
    } else {
      stage_rows<T, E::kOutKeys, kOC, E::kLdO>(reinterpret_cast<T*>(st), static_cast<const T*>(p.o),
                                               p.ld, k0 + (j - nsc) * E::kOutKeys, a.S, p.c0, p.ncols);
    }
  }
  tiles::cp_async_commit();
}

// blocks an SM that the registers must allow: three (168 registers a
// thread), but two for MODE 0 in bf16, whose P V in two halves spilled 4
// bytes at 168 (scripts/wide_variants.py times both)
template <class T, int MODE>
constexpr int kFwdBlocks = 3;
template <>
constexpr int kFwdBlocks<bf16, kModeFused> = 2;

template <class T, int MODE>
__global__ void __launch_bounds__(kTcThreads, (kFwdBlocks<T, MODE>)) wide_fwd_kernel(const WideArgs a) {
  using E = Elem<T>;
  constexpr int kG = MODE == kModeFlash ? 2 : 1;  // tiles a group: MODE 2's m steps by 128 keys
  constexpr int kOut = kKeys / E::kOutKeys;       // output steps a tile
  extern __shared__ __align__(16) unsigned char smem[];
  float* stash = reinterpret_cast<float*>(smem + kStashOff) + threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int t0 = (a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kRows;  // longest first
  const int c0 = blockIdx.z * kOC, nnb = min(kOC, a.D - c0) / 8;
  const int row0 = t0 + 16 * warp + (lane >> 2);  // this lane's rows: row0, row0 + 8
  // the key tiles a row block visits: MODE 0, up to the last valid key (and
  // the block's last row when causal), every key when none is valid (they
  // weigh alike; past the last valid key a score is -1e30, whose weight is
  // exactly 0 once key 0 is seen); MODE 1 causal, up to the block's last
  // row; MODE 2 causal, the 128-key blocks at or below its own
  int k_end = a.S, n_valid = a.S;
  if (MODE == kModeFused) {
    n_valid = a.lens == nullptr ? a.S : min(a.lens[b], a.S);
    if (n_valid > 0) k_end = a.causal ? min(n_valid, t0 + kRows) : n_valid;
  }
  if (MODE == kModeDrop && a.causal) k_end = min(a.S, t0 + kRows);
  if (MODE == kModeFlash && a.causal) k_end = min(a.S, (t0 / kBlk + 1) * kBlk);
  const int n_groups = (k_end + kG * kKeys - 1) / (kG * kKeys), nsc = a.D / E::kChunk;
  __shared__ Plan plan;
  if (threadIdx.x == 0) {
    plan.x[0] = head<T>(a.q, b, a.T, a.H, h, a.D);
    plan.y[0] = head<T>(a.k, b, a.S, a.H, h, a.D);
    plan.o = head<T>(a.v, b, a.S, a.H, h, a.D);
    plan.valid = MODE == kModeFused ? nullptr : a.valid + (size_t)b * a.S;
    plan.out = static_cast<T*>(a.out) + ((size_t)b * a.T * a.H + h) * a.D + c0;
    plan.stats = a.stats + (size_t)bh * a.T;
    plan.dr = drop_of<MODE>(a);
    if (!plan.dr.on) plan.dr.c = 1.f;  // keep_bits sets every bit: w / 1
    plan.bhg = MODE == kModeDrop ? global_bh(b, h, a.b0, a.h0, a.Hg) : 0u;
    plan.rc = 1.f / plan.dr.c;
    plan.n_valid = n_valid;
    plan.ld = a.H * a.D;
    plan.t0 = t0;
    plan.nsc = nsc;
    plan.per = kG * (nsc + kOut);
    plan.steps0 = MODE == kModeDrop ? n_groups * nsc : 0;
    plan.total = plan.steps0 + n_groups * plan.per;
    plan.c0 = c0;
    plan.ncols = 8 * nnb;
  }
  __syncthreads();
  auto fetch = [&](int i, unsigned char* st) { fetch_fwd<T, MODE>(a, plan, i, st); };
  Ring<decltype(fetch)> ring(smem, fetch);

  float o[kOC / 8][4], m[2], l[2];
#pragma unroll
  for (int nb = 0; nb < kOC / 8; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = MODE == kModeDrop ? kMasked : -INFINITY;
    l[r] = 0.f;
  }
  const bool one_block = MODE == kModeFlash && a.S == kBlk;  // the library's one-step kernel
  // a tile's scores, scaled and masked (MODE 0: -1e30 on a masked key, -inf
  // past S; MODE 1: -inf on a masked key; MODE 2: the mask added), and each
  // row's max over them
  auto tile_scores = [&](float (&s)[kNJ][4], int k0, float (&mx)[2]) {
#pragma unroll
    for (int j = 0; j < kNJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int c = 0; c < nsc; ++c) score_step(s, reinterpret_cast<const T*>(ring.next()), warp, lane);
    const int* okv = ring.valid();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      mx[r] = MODE == kModeDrop ? kMasked : -INFINITY;
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const int cl = 8 * j + 2 * t + (e & 1), col = k0 + cl;
          float x = -INFINITY;
          if (col < a.S) {
            const bool ok = (MODE == kModeFused ? col < plan.n_valid : okv[cl] != 0) &&
                            (!a.causal || col <= row);
            if (MODE == kModeFused) x = ok ? s[j][e] * a.scale : kMasked;
            if (MODE == kModeDrop) x = ok ? bf16r(s[j][e]) * a.scale : -INFINITY;
            if (MODE == kModeFlash) x = s[j][e] * a.scale + (ok ? 0.f : kMaskValue);
          }
          s[j][e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      mx[r] = tiles::quad_max(mx[r]);
    }
  };
  auto regs = [](const float (&s)[kNJ][4]) {
    return [&s](int j, int e) { return s[j][e]; };
  };
  float s[kNJ][4], mx[2];
  // MODE 1's first pass: m and l
  if (MODE == kModeDrop) {
    for (int it = 0; it < n_groups; ++it) {
      tile_scores(s, it * kKeys, mx);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], mx[r]), alpha = ex2_ftz(m[r] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) sum += ex2_ftz(s[j][e] - m_new);
        l[r] = l[r] * alpha + tiles::quad_sum(sum);
        m[r] = m_new;
      }
    }
  }
  for (int it = 0; it < n_groups; ++it) {
    const int k0 = it * kG * kKeys;
    if (MODE == kModeDrop) {  // wd from the whole row's m and l
      const uint32_t keep = keep_bits(plan, row0, k0, t);
      tile_scores(s, k0, mx);
      const float c = plan.dr.c, rc = plan.rc;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float den = fmaxf(l[r], 1e-30f), rden = 1.f / den;
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float ex = ex2_ftz(s[j][e] - m[r]);
            const float w16 = bf16r(div_rn(ex, den, rden));
            // without dropout every bit is set and c = 1: bf16(w16 / 1) = w16
            s[j][e] = keep >> (4 * j + e) & 1u ? bf16r(div_rn(w16, c, rc)) : 0.f;
          }
      }
#pragma unroll
      for (int u = 0; u < kOut; ++u)
        out_step<false>(o, regs(s), u, reinterpret_cast<const T*>(ring.next()), lane, plan.ncols >> 3);
      continue;
    }
    float mx2[2] = {-INFINITY, -INFINITY};
    if (MODE == kModeFlash) {  // the pair's first tile, stashed while the second is scored
      tile_scores(s, k0, mx2);
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) stash[(4 * j + e) * kTcThreads] = s[j][e];
    }
    tile_scores(s, k0 + (kG - 1) * kKeys, mx);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], fmaxf(mx[r], mx2[r]));
      alpha[r] = ex2_ftz(m[r] - m_new);
      float sum = 0.f;
      if (MODE == kModeFlash)  // the first tile's p, back into the stash
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            float* at = stash + (4 * j + e) * kTcThreads;
            const float p = ex2_ftz(*at - m_new);
            sum += p;
            *at = p;
          }
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = ex2_ftz(s[j][e] - m_new);
          sum += p;
          s[j][e] = p;
        }
      l[r] = l[r] * alpha[r] + tiles::quad_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int nb = 0; nb < kOC / 8; ++nb) {
        o[nb][2 * r] *= alpha[r];
        o[nb][2 * r + 1] *= alpha[r];
      }
    }
    if (MODE == kModeFlash) {  // cast(p) (at S = 128 cast(p / l)) as bf16 operands or f32
      const float rl[2] = {one_block ? 1.f / l[0] : 1.f, one_block ? 1.f / l[1] : 1.f};
      auto first = [&](int j, int e) {
        const float p = stash[(4 * j + e) * kTcThreads];
        return cast<T>(one_block ? div_rn(p, l[e >> 1], rl[e >> 1]) : p);
      };
#pragma unroll
      for (int u = 0; u < kOut; ++u)
        out_step<false>(o, first, u, reinterpret_cast<const T*>(ring.next()), lane, plan.ncols >> 3);
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = cast<T>(one_block ? div_rn(s[j][e], l[e >> 1], rl[e >> 1]) : s[j][e]);
    }
#pragma unroll
    for (int u = 0; u < kOut; ++u)
      out_step<MODE == kModeFused>(o, regs(s), u, reinterpret_cast<const T*>(ring.next()), lane,
                                   plan.ncols >> 3);
  }
  tiles::cp_async_wait<0>();
  float mul[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) mul[r] = MODE == kModeDrop || one_block ? 1.f : 1.f / l[r];
  store_rows<T>(static_cast<T*>(plan.out), plan.ld, row0, a.T, plan.ncols >> 3, o, mul, t);
  if (MODE == kModeFlash && blockIdx.z == 0 && t == 0) {
    const size_t n = (size_t)a.B * a.H * a.T;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < a.T) {
        plan.stats[row] = m[r];
        plan.stats[n + row] = l[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward, rows: a block per (64 query rows, b * H + h, 128 columns of dq)
// ---------------------------------------------------------------------------
// step i of a rows block's walk: a tile's nsc chunks of Q and K, its nsc
// chunks of g and V, then (past MODE 1's first pass) its output steps
template <class T, int MODE>
__device__ __forceinline__ void fetch_rows(const WideArgs& a, const Plan& p, int i, unsigned char* st) {
  using E = Elem<T>;
  if (i < p.total) {
    const int nsc = p.nsc;
    int tile, j;
    if (i < p.steps0) {
      tile = i / (2 * nsc);
      j = i % (2 * nsc);
    } else {
      tile = (i - p.steps0) / p.per;
      j = (i - p.steps0) % p.per;
    }
    const int k0 = tile * kKeys;
    if (j < 2 * nsc) {  // a chunk of Q and K, or of g and V
      const int w = j < nsc ? 0 : 1, d0 = (j - w * nsc) * E::kChunk;
      stage_rows<T, kRows, E::kChunk, E::kLdC>(reinterpret_cast<T*>(st), static_cast<const T*>(p.x[w]),
                                               p.ld, p.t0, a.T, d0, E::kChunk);
      stage_rows<T, kKeys, E::kChunk, E::kLdC>(reinterpret_cast<T*>(st + kChunkBytes),
                                               static_cast<const T*>(p.y[w]), p.ld, k0, a.S, d0,
                                               E::kChunk);
      if (j == nsc - 1) stage_valid(reinterpret_cast<int*>(st + kValidOff), p.valid, k0, a.S);
    } else {  // K's rows over the dq chunk
      stage_rows<T, E::kOutKeys, kOC, E::kLdO>(reinterpret_cast<T*>(st), static_cast<const T*>(p.o),
                                               p.ld, k0 + (j - 2 * nsc) * E::kOutKeys, a.S, p.c0,
                                               p.ncols);
    }
  }
  tiles::cp_async_commit();
}

template <class T, int MODE>
__global__ void __launch_bounds__(kTcThreads, 3) wide_rows_kernel(const WideArgs a) {
  using E = Elem<T>;
  constexpr int kOut = kKeys / E::kOutKeys;  // output steps a tile
  extern __shared__ __align__(16) unsigned char smem[];
  float* stash = reinterpret_cast<float*>(smem + kStashOff) + threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int t0 = (a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kRows;
  const int c0 = blockIdx.z * kOC, nnb = min(kOC, a.D - c0) / 8;
  const int row0 = t0 + 16 * warp + gq;
  const int ld = a.H * a.D;
  const size_t qo = ((size_t)b * a.T * a.H + h) * a.D;
  int k_end = a.S;
  if (a.causal && MODE == kModeFlash) k_end = min(a.S, (t0 / kBlk + 1) * kBlk);
  if (a.causal && MODE == kModeDrop) k_end = min(a.S, t0 + kRows);
  const int nt = (k_end + kKeys - 1) / kKeys, nsc = a.D / E::kChunk;
  __shared__ Plan plan;
  if (threadIdx.x == 0) {
    plan.x[0] = head<T>(a.q, b, a.T, a.H, h, a.D);
    plan.x[1] = head<T>(a.g, b, a.T, a.H, h, a.D);
    plan.y[0] = plan.o = head<T>(a.k, b, a.S, a.H, h, a.D);
    plan.y[1] = head<T>(a.v, b, a.S, a.H, h, a.D);
    plan.valid = a.valid + (size_t)b * a.S;
    plan.out = static_cast<T*>(a.dq) + qo + c0;
    plan.stats = a.stats + (size_t)bh * a.T;
    plan.dr = drop_of<MODE>(a);
    if (!plan.dr.on) plan.dr.c = 1.f;  // keep_bits sets every bit: w / 1
    plan.bhg = MODE == kModeDrop ? global_bh(b, h, a.b0, a.h0, a.Hg) : 0u;
    plan.rc = 1.f / plan.dr.c;
    plan.ld = ld;
    plan.t0 = t0;
    plan.nsc = nsc;
    plan.per = 2 * nsc + kOut;
    plan.steps0 = MODE == kModeDrop ? nt * 2 * nsc : 0;
    plan.total = plan.steps0 + nt * plan.per;
    plan.c0 = c0;
    plan.ncols = 8 * nnb;
  }
  __syncthreads();
  auto fetch = [&](int i, unsigned char* st) { fetch_rows<T, MODE>(a, plan, i, st); };
  Ring<decltype(fetch)> ring(smem, fetch);
  // a tile's X Y^T over nsc chunk steps
  auto product = [&](float (&s)[kNJ][4]) {
#pragma unroll
    for (int j = 0; j < kNJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int c = 0; c < nsc; ++c) score_step(s, reinterpret_cast<const T*>(ring.next()), warp, lane);
  };

  float m[2], l[2], dl[2], s[kNJ][4];
  const size_t n = (size_t)a.B * a.H * a.T;
  if (MODE == kModeFlash) {
    // di = sum_d o g of the warp's 16 rows, lanes over head_dim, then a
    // butterfly; m and 1 / l from the forward
    const T* o = static_cast<const T*>(a.o) + qo;
    const T* g = static_cast<const T*>(a.g) + qo;
    for (int rr = 0; rr < 16; ++rr) {
      const int row = t0 + 16 * warp + rr;
      float x = 0.f;
      if (row < a.T)
        for (int d = lane; d < a.D; d += 32)
          x = fmaf(to_f(o[(size_t)row * ld + d]), to_f(g[(size_t)row * ld + d]), x);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      if (rr == gq) dl[0] = x;
      if (rr == gq + 8) dl[1] = x;
      if (lane == 0 && blockIdx.z == 0 && row < a.T) a.di[(size_t)bh * a.T + row] = x;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = min(row0 + 8 * r, a.T - 1);
      m[r] = plan.stats[row];
      l[r] = 1.f / plan.stats[n + row];  // the twin's p = exp(s - m) (1 / l)
    }
  } else {
    // pass 1: m and l online, and u = sum e dw rescaled with them; e waits
    // in the stash while g V^T is taken
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = kMasked;
      l[r] = dl[r] = 0.f;
    }
    for (int it = 0; it < nt; ++it) {
      const int k0 = it * kKeys;
      product(s);
      const int* okv = ring.valid();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        float mx = kMasked;
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const int cl = 8 * j + 2 * t + (e & 1), col = k0 + cl;
            const bool ok = col < a.S && okv[cl] != 0 && (!a.causal || col <= row);
            s[j][e] = ok ? bf16r(s[j][e]) * a.scale : -INFINITY;
            mx = fmaxf(mx, s[j][e]);
          }
        const float m_new = fmaxf(m[r], tiles::quad_max(mx)), alpha = ex2_ftz(m[r] - m_new);
        float se = 0.f;
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float ex = ex2_ftz(s[j][e] - m_new);
            se += ex;
            stash[(4 * j + e) * kTcThreads] = ex;
          }
        l[r] = l[r] * alpha + tiles::quad_sum(se);
        dl[r] *= alpha;  // u rescaled now; this tile's sum e dw follows g V^T
        m[r] = m_new;
      }
      const uint32_t keep = keep_bits(plan, row0, k0, t);
      product(s);  // g V^T
      const float c = plan.dr.c, rc = plan.rc;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float su = 0.f;
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            // without dropout every bit is set and c = 1: dw / 1 = dw
            const float dw = keep >> (4 * j + e) & 1u ? div_rn(s[j][e], c, rc) : 0.f;
            su = fmaf(stash[(4 * j + e) * kTcThreads], dw, su);
          }
        dl[r] += tiles::quad_sum(su);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dl[r] /= fmaxf(l[r], 1e-30f);  // delta = sum_s w dw
      const int row = row0 + 8 * r;
      if (blockIdx.z == 0 && t == 0 && row < a.T) {
        plan.stats[row] = m[r];
        plan.stats[n + row] = l[r];
        plan.stats[2 * n + row] = dl[r];
      }
      l[r] = fmaxf(l[r], 1e-30f);
    }
  }
  // dq += ds K: w (MODE 1) or p (MODE 2) from the recomputed scores waits in
  // the stash while g V^T is taken
  float acc[kOC / 8][4], rl[2];
#pragma unroll
  for (int nb = 0; nb < kOC / 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) rl[r] = 1.f / l[r];  // MODE 1: for w = e / l
  for (int it = 0; it < nt; ++it) {
    const int k0 = it * kKeys;
    product(s);
    const int* okv = ring.valid();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const int cl = 8 * j + 2 * t + (e & 1), col = k0 + cl;
          float w = 0.f;
          if (col < a.S && row < a.T) {
            const bool ok = okv[cl] != 0 && (!a.causal || col <= row);
            if (MODE == kModeDrop) {
              if (ok) w = div_rn(ex2_ftz(bf16r(s[j][e]) * a.scale - m[r]), l[r], rl[r]);
            } else {
              w = ex2_ftz(s[j][e] * a.scale + (ok ? 0.f : kMaskValue) - m[r]) * l[r];
            }
          }
          stash[(4 * j + e) * kTcThreads] = w;
        }
    }
    const uint32_t keep = MODE == kModeDrop ? keep_bits(plan, row0, k0, t) : 0u;
    product(s);  // g V^T
    const float c = plan.dr.c, rc = plan.rc;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float w = stash[(4 * j + e) * kTcThreads];
          float ds;
          if (MODE == kModeDrop) {  // w = 0 off the valid keys, so ds = 0 there
            const float dw = keep >> (4 * j + e) & 1u ? div_rn(s[j][e], c, rc) : 0.f;
            ds = bf16r(w * (dw - dl[r]) * a.scale);
          } else {
            ds = cast<T>((s[j][e] - dl[r]) * w * a.scale);
          }
          s[j][e] = ds;
        }
    }
    auto ds_of = [&s](int j, int e) { return s[j][e]; };
#pragma unroll
    for (int u = 0; u < kOut; ++u)
      out_step<false>(acc, ds_of, u, reinterpret_cast<const T*>(ring.next()), lane, plan.ncols >> 3);
  }
  tiles::cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  store_rows<T>(static_cast<T*>(plan.out), plan.ld, row0, a.T, plan.ncols >> 3, acc, one, t);
}

// ---------------------------------------------------------------------------
// backward, keys: a block per (64 keys, b * H + h, 128 columns of dk or of
// dv); grid.z's first half the dk blocks, the second the dv blocks
// ---------------------------------------------------------------------------
// MODE 1: keep_bits in the keys kernel's orientation: bit 4 j + e of this
// thread's C fragment is key key0 + 8 (e >> 1), query q0 + 8 j + 2 t + (e &
// 1), the hash taken at (row = the query, col = the key)
__device__ __forceinline__ uint32_t keep_bits_t(const Plan& p, int key0, int q0, int t) {
  const Drop dr = p.dr;
  if (!dr.on) return ~0u;
  const uint32_t bh_term = p.bhg * kBhMul;
  uint32_t bits = 0u;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t col_term = (uint32_t)(key0 + 8 * (e >> 1)) * kColMul;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const uint32_t row = q0 + 8 * j + 2 * t + (e & 1);
      bits |= (keep_terms(dr, dr.s0 + row * kRowMul, col_term, bh_term) ? 1u : 0u) << (4 * j + e);
    }
  }
  return bits;
}

// queries q0 .. q0 + kRows - 1 of two rows of the statistics (b null: one)
// into dst[0 .. kRows) and dst[kRows .. 2 kRows), zeros at and past T
__device__ __forceinline__ void stage_stats(float* dst, const float* a, const float* b, int q0, int T) {
  const float* src = threadIdx.x < kRows ? a : b;
  const int i = threadIdx.x % kRows;
  if (src != nullptr) {
    const bool ok = q0 + i < T;
    tiles::cp_async4(dst + threadIdx.x, ok ? src + q0 + i : src, ok);
  }
}

// step i of a keys block's walk: a query tile's nsc chunks of K and Q (the
// last with the tile's m and l), a dk block's nsc chunks of V and g (the
// last with delta or di), then the tile's output steps (g for dv, Q for dk)
template <class T>
__device__ __forceinline__ void fetch_keys(const WideArgs& a, const Plan& p, int i, unsigned char* st) {
  using E = Elem<T>;
  if (i < p.total) {
    const int nsc = p.nsc, j = i % p.per, q0 = p.t0 + (i / p.per) * kRows;
    if (j < p.steps0) {  // a chunk of K and Q, or of V and g
      const int w = j < nsc ? 0 : 1, d0 = (j - w * nsc) * E::kChunk;
      stage_rows<T, kKeys, E::kChunk, E::kLdC>(reinterpret_cast<T*>(st), static_cast<const T*>(p.x[w]),
                                               p.ld, p.s0, a.S, d0, E::kChunk);
      stage_rows<T, kRows, E::kChunk, E::kLdC>(reinterpret_cast<T*>(st + kChunkBytes),
                                               static_cast<const T*>(p.y[w]), p.ld, q0, a.T, d0,
                                               E::kChunk);
      float* sts = reinterpret_cast<float*>(st + kValidOff);
      if (j == nsc - 1) stage_stats(sts, p.st[0], p.st[1], q0, a.T);
      if (j == 2 * nsc - 1) stage_stats(sts, p.st[2], nullptr, q0, a.T);
    } else {
      stage_rows<T, E::kOutKeys, kOC, E::kLdO>(reinterpret_cast<T*>(st), static_cast<const T*>(p.o),
                                               p.ld, q0 + (j - p.steps0) * E::kOutKeys, a.T, p.c0,
                                               p.ncols);
    }
  }
  tiles::cp_async_commit();
}

// The rows kernel with the roles of rows and keys swapped: a warp's 16 keys
// are the fragments' rows, a tile's 64 queries their columns.  S^T = K Q^T
// (and a dk block's (g V^T)^T = V g^T) is summed in the rows kernel's order,
// the same chunks and k steps (split TF32's cross passes swapped), and w, p,
// dw and ds take its formulas, written out as there (so that the compiler
// contracts them alike), so that both kernels see the same bits.  A dv
// block sums wd^T g (MODE 1) or cast(p)^T g (MODE 2); a dk block ds^T Q,
// with w or p in the stash while V g^T is taken: each holds one 64 x 128
// accumulator beside one tile's scores.  The statistics are indexed by the
// fragment's column, so they are read from the staged tile at each use.
template <class T, int MODE>
__global__ void __launch_bounds__(kTcThreads, 3) wide_keys_kernel(const WideArgs a) {
  using E = Elem<T>;
  constexpr int kOut = kRows / E::kOutKeys;  // output steps a query tile
  extern __shared__ __align__(16) unsigned char smem[];
  float* stash = reinterpret_cast<float*>(smem + kStashOff) + threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int s0 = blockIdx.x * kKeys, bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int nz = gridDim.z / 2;
  const bool dk_block = (int)blockIdx.z < nz;
  const int c0 = (dk_block ? blockIdx.z : blockIdx.z - nz) * kOC, nnb = min(kOC, a.D - c0) / 8;
  const int key0 = s0 + 16 * warp + (lane >> 2);  // this lane's keys: key0, key0 + 8
  // causal: MODE 1 from the query tile that holds the block's first key;
  // MODE 2 from the key's 128-row library block (a row visits the blocks at
  // or below its own, where a masked key still weighs when none is valid)
  const int q_begin = !a.causal ? 0 : MODE == kModeFlash ? (s0 / kBlk) * kBlk : s0;
  const int nt = q_begin < a.T ? (a.T - q_begin + kRows - 1) / kRows : 0, nsc = a.D / E::kChunk;
  __shared__ Plan plan;
  if (threadIdx.x == 0) {
    const size_t n = (size_t)a.B * a.H * a.T;
    plan.x[0] = head<T>(a.k, b, a.S, a.H, h, a.D);
    plan.x[1] = head<T>(a.v, b, a.S, a.H, h, a.D);
    plan.y[0] = head<T>(a.q, b, a.T, a.H, h, a.D);
    plan.y[1] = head<T>(a.g, b, a.T, a.H, h, a.D);
    plan.o = plan.y[dk_block ? 0 : 1];
    plan.out = static_cast<T*>(dk_block ? a.dk : a.dv) + ((size_t)b * a.S * a.H + h) * a.D + c0;
    plan.st[0] = a.stats + (size_t)bh * a.T;
    plan.st[1] = plan.st[0] + n;
    plan.st[2] = MODE == kModeFlash ? a.di + (size_t)bh * a.T : plan.st[0] + 2 * n;
    plan.dr = drop_of<MODE>(a);
    if (!plan.dr.on) plan.dr.c = 1.f;  // keep_bits_t sets every bit: w / 1
    plan.bhg = MODE == kModeDrop ? global_bh(b, h, a.b0, a.h0, a.Hg) : 0u;
    plan.rc = 1.f / plan.dr.c;
    plan.ld = a.H * a.D;
    plan.t0 = q_begin;
    plan.s0 = s0;
    plan.nsc = nsc;
    plan.steps0 = (dk_block ? 2 : 1) * nsc;  // score steps a tile
    plan.per = plan.steps0 + kOut;
    plan.total = nt * plan.per;
    plan.c0 = c0;
    plan.ncols = 8 * nnb;
  }
  bool kv[2];  // the lane's keys' validity (none at and past S)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    kv[r] = key < a.S && a.valid[(size_t)b * a.S + key] != 0;
  }
  __syncthreads();
  auto fetch = [&](int i, unsigned char* st) { fetch_keys<T>(a, plan, i, st); };
  Ring<decltype(fetch)> ring(smem, fetch);
  auto product = [&](float (&s)[kNJ][4]) {
#pragma unroll
    for (int j = 0; j < kNJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int c = 0; c < nsc; ++c) score_step<true>(s, reinterpret_cast<const T*>(ring.next()), warp, lane);
  };

  float acc[kOC / 8][4], s[kNJ][4];
#pragma unroll
  for (int nb = 0; nb < kOC / 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  const float c = plan.dr.c, rc = plan.rc;
  for (int it = 0; it < nt; ++it) {
    const int q0 = q_begin + it * kRows;
    uint32_t keep = MODE == kModeDrop && !dk_block ? keep_bits_t(plan, key0, q0, t) : 0u;
    product(s);  // S^T
    const float* sts = ring.stats();  // m, then l (MODE 1) or the forward's l (MODE 2)
    // w (MODE 1) or p (MODE 2) by the rows kernel's formulas; 0 at and past T
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int cl = 8 * j + 2 * t + u, query = q0 + cl;
        const float m = sts[cl];
        const float l = MODE == kModeDrop ? fmaxf(sts[kRows + cl], 1e-30f) : sts[kRows + cl];
        const float rl = 1.f / l;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + u;
          const bool ok = kv[r] && (!a.causal || key0 + 8 * r <= query);
          float w = 0.f;
          if (query < a.T) {
            if (MODE == kModeDrop) {
              if (ok) w = div_rn(ex2_ftz(bf16r(s[j][e]) * a.scale - m), l, rl);
            } else {
              w = ex2_ftz(s[j][e] * a.scale + (ok ? 0.f : kMaskValue) - m) * rl;
            }
          }
          if (dk_block) {
            stash[(4 * j + e) * kTcThreads] = w;
          } else if (MODE == kModeDrop) {  // wd, the forward's formula
            s[j][e] = keep >> (4 * j + e) & 1u ? bf16r(div_rn(bf16r(w), c, rc)) : 0.f;
          } else {
            s[j][e] = cast<T>(w);
          }
        }
      }
    if (dk_block) {
      if (MODE == kModeDrop) keep = keep_bits_t(plan, key0, q0, t);
      product(s);  // (g V^T)^T
      const float* dst = ring.stats();  // delta (MODE 1) or di (MODE 2)
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = 8 * j + 2 * t + (e & 1);
          const float w = stash[(4 * j + e) * kTcThreads], dl = dst[cl];
          float ds = 0.f;
          if (q0 + cl < a.T) {
            if (MODE == kModeDrop) {  // w = 0 off the valid keys, so ds = 0 there
              const float dw = keep >> (4 * j + e) & 1u ? div_rn(s[j][e], c, rc) : 0.f;
              ds = bf16r(w * (dw - dl) * a.scale);
            } else {
              ds = cast<T>((s[j][e] - dl) * w * a.scale);
            }
          }
          s[j][e] = ds;
        }
    }
    auto weights = [&s](int j, int e) { return s[j][e]; };
#pragma unroll
    for (int u = 0; u < kOut; ++u)
      out_step<false>(acc, weights, u, reinterpret_cast<const T*>(ring.next()), lane, plan.ncols >> 3);
  }
  tiles::cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  store_rows<T>(static_cast<T*>(plan.out), plan.ld, key0, a.S, plan.ncols >> 3, acc, one, t);
}

// grid (blocks of 64 of `rows`, B * H, output chunks times zmul), 4 warps a
// block, preferring the whole of the SM's shared memory over L1, so that
// three blocks fit an SM (attributes are per device: set on every launch)
template <class Kernel>
cudaError_t set_attributes(Kernel kernel) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTcSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return e;
}

template <class Kernel>
cudaError_t launch(Kernel kernel, const WideArgs& a, int rows, int zmul, cudaStream_t st) {
  const cudaError_t e = set_attributes(kernel);
  if (e != cudaSuccess) return e;
  const dim3 grid((rows + kRows - 1) / kRows, a.B * a.H, zmul * ((a.D + kOC - 1) / kOC));
  kernel<<<grid, kTcThreads, kTcSmem, st>>>(a);
  return cudaGetLastError();
}

template <class Kernel>
cudaError_t launch_fwd(Kernel kernel, const WideArgs& a, cudaStream_t st) {
  return launch(kernel, a, a.T, 1, st);
}

// the rows kernel, then the keys kernel (a dk and a dv block a chunk)
template <class Rows, class Keys>
cudaError_t launch_bwd(Rows rows, Keys keys, const WideArgs& a, cudaStream_t st) {
  const cudaError_t e = launch(rows, a, a.T, 1, st);
  return e != cudaSuccess ? e : launch(keys, a, a.S, 2, st);
}

template <class Kernel>
int blocks_of(Kernel kernel, int* blocks) {
  cudaError_t e = set_attributes(kernel);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kTcThreads, kTcSmem);
  return (int)e;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool bad_args(int mode, int bf16_, int B, int T, int S, int H, int D) {
  if (B < 1 || T < 1 || S < 1 || H < 1 || D < kDC || D % kDC || B * H > 65535) return true;
  if ((int64_t)(T > S ? T : S) * H * D >= ((int64_t)1 << 31)) return true;  // stage_rows' offsets
  if (mode == kModeDrop && (!bf16_ || S > kMaxKeys)) return true;
  if (mode == kModeFlash && (T % kBlk || S % kBlk)) return true;
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
// S, H, D), out (B, T, H, D), contiguous and 16-byte aligned, bf16 (bf16 =
// 1) or f32.  mode 0: lens (B,) int32 or null; mode 1 (bf16): valid (B, S)
// int32, seeds (4,) int32, thr the keep threshold, drop_on = rate > 0, c =
// bf16(1 - rate), the keep hash at the global (b0 + b, h0 + h) of Hg heads;
// mode 2: valid, and stats (2, B*H, T) f32 written (m, l).  scale = 1 /
// sqrt(head_dim).
int smer_wide_attn_fwd(int mode, int bf16_, int B, int T, int S, int H, int D, int b0, int h0,
                       int Hg, const void* q, const void* k, const void* v, const void* lens,
                       const void* valid, const void* seeds, unsigned int thr, int drop_on,
                       float c, int causal, float scale, void* out, void* stats, void* stream) {
  if (bad_args(mode, bf16_, B, T, S, H, D) || (mode != kModeFused && valid == nullptr) ||
      (mode == kModeDrop && seeds == nullptr) || (mode == kModeFlash && stats == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  WideArgs a = make_args(B, T, S, H, D, b0, h0, Hg, q, k, v, lens, valid, seeds, thr, drop_on, c,
                         causal, scale);
  a.out = out;
  a.stats = static_cast<float*>(stats);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode * 2 + bf16_) {
    case 0: return (int)launch_fwd(wide_fwd_kernel<float, kModeFused>, a, st);
    case 1: return (int)launch_fwd(wide_fwd_kernel<bf16, kModeFused>, a, st);
    case 3: return (int)launch_fwd(wide_fwd_kernel<bf16, kModeDrop>, a, st);
    case 4: return (int)launch_fwd(wide_fwd_kernel<float, kModeFlash>, a, st);
    case 5: return (int)launch_fwd(wide_fwd_kernel<bf16, kModeFlash>, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward pair of modes 1 and 2: g (B, T, H, D) in q's dtype; mode 1:
// stats a (3, B*H, T) f32 scratch (m, l, delta, written by the rows kernel);
// mode 2: o the forward's output, stats its (2, B*H, T) m and l, di a (B*H,
// T) f32 scratch; dq, dk, dv in the layouts of q, k, v.
int smer_wide_attn_bwd(int mode, int bf16_, int B, int T, int S, int H, int D, int b0, int h0,
                       int Hg, const void* q, const void* k, const void* v, const void* valid,
                       const void* seeds, unsigned int thr, int drop_on, float c, int causal,
                       float scale, const void* o, const void* g, void* stats, void* di, void* dq,
                       void* dk, void* dv, void* stream) {
  if (mode == kModeFused || bad_args(mode, bf16_, B, T, S, H, D) || valid == nullptr ||
      stats == nullptr || (mode == kModeDrop && seeds == nullptr) ||
      (mode == kModeFlash && (o == nullptr || di == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(g))
    return (int)cudaErrorMisalignedAddress;
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
  switch (mode * 2 + bf16_) {
    case 3:
      return (int)launch_bwd(wide_rows_kernel<bf16, kModeDrop>, wide_keys_kernel<bf16, kModeDrop>, a, st);
    case 4:
      return (int)launch_bwd(wide_rows_kernel<float, kModeFlash>, wide_keys_kernel<float, kModeFlash>,
                             a, st);
    case 5:
      return (int)launch_bwd(wide_rows_kernel<bf16, kModeFlash>, wide_keys_kernel<bf16, kModeFlash>,
                             a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Blocks an SM of one instantiation (kernel 0: wide_fwd_kernel, 1:
// wide_rows_kernel, 2: wide_keys_kernel; mode and bf16_ as the launchers
// take them), at the launchers' shared memory and carveout.
int smer_wide_attn_blocks(int kernel, int mode, int bf16_, int* blocks) {
  switch (kernel * 8 + mode * 2 + bf16_) {
    case 0: return blocks_of(wide_fwd_kernel<float, kModeFused>, blocks);
    case 1: return blocks_of(wide_fwd_kernel<bf16, kModeFused>, blocks);
    case 3: return blocks_of(wide_fwd_kernel<bf16, kModeDrop>, blocks);
    case 4: return blocks_of(wide_fwd_kernel<float, kModeFlash>, blocks);
    case 5: return blocks_of(wide_fwd_kernel<bf16, kModeFlash>, blocks);
    case 11: return blocks_of(wide_rows_kernel<bf16, kModeDrop>, blocks);
    case 12: return blocks_of(wide_rows_kernel<float, kModeFlash>, blocks);
    case 13: return blocks_of(wide_rows_kernel<bf16, kModeFlash>, blocks);
    case 19: return blocks_of(wide_keys_kernel<bf16, kModeDrop>, blocks);
    case 20: return blocks_of(wide_keys_kernel<float, kModeFlash>, blocks);
    case 21: return blocks_of(wide_keys_kernel<bf16, kModeFlash>, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
