#!/usr/bin/env python3
"""Time design variants of the flash-train kernels on one CUDA card.

    python3 scripts/flash_train_variants.py [VARIANT ...]
    python3 scripts/flash_train_variants.py --forward [VARIANT ...]
    python3 scripts/flash_train_variants.py --f32 [VARIANT ...]

Each variant is ``ops/csrc/flash_train.cu`` with a few lines edited (the
edits are below, each checked to apply), built alone with nvcc into
``build/flash_train_variants/<name>/`` (all builds started together) and
bound with ctypes.  At B=8, H=8 and T=S=2048 and 640 (~10% of keys invalid,
one batch row with none, not causal, as chip_smoke's phase 2j), every
variant runs the forward once, then the backward (``flash_train_dq_kernel``
then ``flash_train_dkv_kernel``): the ms of 50 back-to-back calls by CUDA
events, each kernel's device µs by the profiler, and whether its dq, dk and
dv are bit-equal to the unedited source's.  Two rounds, in the order given.
With ``--forward`` the variants are the forward's (``FORWARD_VARIANTS``),
each timed alone (``flash_train_fwd_kernel``) at B=8, H=8, T=S=2048, head_dim
64 and 128, with ~10% of keys invalid and with every key valid, its output
and m, l compared bit for bit with the unedited source's.  With ``--f32`` the
variants are ``ops/csrc/attention_f32.cu``'s (``F32_VARIANTS``): the f32
forward (``attn_f32_fwd_kernel``) timed in MODE 1 at B=8, T=S=640 (~10% of
keys invalid, flash training's) and in MODE 0 at B=3, T=S=1536, key lengths
1536/1440/1344 (``fused_attention``'s, the served encoder shape), and the
backward pair (``flash_train_f32_dq_kernel`` then
``flash_train_f32_dkv_kernel``) at B=8, T=S=640, each at head_dim 64 (H=8)
and 128 (H=4); the outputs and dq, dk, dv against the unedited source's
(bit-equal, and the worst relative norm).

The variants say what each part of the design costs:
- ``two_stages``: a ring of two 64-row tiles, not four;
- ``no_converter``: the consumers take 1 / l themselves (16 a tile and
  thread) instead of the producer warpgroup's second warp;
- ``bwd_runtime_scale``: the scale at head_dim 64 read from the kernel's
  argument instead of the compile-time 1/8 (the same bits);
- ``dq_desc_once``: dq's K and V descriptors at head_dim 64 made once a tile,
  as the head_dim-64-only kernel made them (the same bits);
- ``dkv_no_elementwise`` / ``dq_no_elementwise``: the mask, p and ds left
  out (wrong results, timing only): the products and the pipeline alone.

The f32 kernels' (the forward's and the pair's):
- ``f32_one_pass``: hi hi alone, one TF32 pass a product (wrong results,
  ~5e-4: timing only): what the split's other two passes cost;
- ``f32_no_split``: each operand handed to all three passes as it is, no
  split instructions (wrong results: timing only): what the splits cost;
- ``f32_no_elementwise``: the mask, p and ds left out (timing only);
- ``f32_scalar_loads``: X Y^T's fragments by scalar loads (4 for A, 2 a
  B n-block) instead of ldmatrix (the same bits);
- ``f32_fwd_split_once``: the forward's K and V tiles split once a block
  into hi and lo copies, behind a second ``__syncthreads`` a tile, instead
  of by every warp at each use (the same bits; one block an SM at head_dim
  128), and ``f32_fwd_split_once_t16`` the same with 16-key tiles at head_dim
  128 (two blocks);
- ``f32_fwd_t16_b3``: 16-key tiles and three blocks an SM at head_dim 128;
- ``f32_fwd_t64_b2``: 64-key tiles and two blocks an SM at head_dim 64;
- ``f32_fwd_q_regs``: Q's A fragments split once into registers at head_dim
  64 (the same bits; 168 registers, the MODE 1 instantiation spills);
- ``f32_fwd_b4``: four blocks an SM at head_dim 64 (registers capped at 128);
- ``f32_fwd_scheme_b``: each tile's P V into a zeroed fragment, added to o
  by FMA (the probe's scheme (b); other bits);
- ``f32_t64_s2_b2__t16_s2_b2`` (the first split-TF32 build's),
  ``f32_t32_s2_b3__t32_s1_b2``, ``f32_t64_s1_b3__t64_s1_b1``,
  ``f32_t16_s2_b3__t32_s2_b1``: other (rows a streamed tile, stages,
  blocks an SM) at head_dim 64 / 128 than the source's (32, 2, 3) / (16,
  2, 2).

The forward's:
- ``fwd_defer_flipped``: ``kDeferPV`` the other way at each head_dim (block
  i-1's P V issued right behind S_i at 128, after block i's softmax at 64);
- ``fwd_no_pingpong``: the consumers issue their products without taking
  turns (no named barriers);
- ``fwd_defer_flipped_no_pingpong``: both;
- ``fwd_no_softmax``: the mask and softmax left out (wrong results, timing
  only): the products, the pipeline and the packing of P alone;
- ``fwd_no_mask``: every block takes the path of a block with no invalid key
  and off the diagonal (wrong results where a key is invalid; at head_dim
  64 only, where that path differs);
- ``fwd_no_fold``: the scale applied by its own instruction on every block
  at head_dim 64 too (the same bits);
- ``fwd_const_scale``: the compile-time 1/8 at head_dim 64, as the backward
  pair takes it (the same bits);
- ``fwd_three_stages``: rings of three 128-key tiles of K and of V, not two;
- ``fwd_no_reload``: K and V loaded for the first two blocks only, every
  later block reads those again (wrong results, timing only): the forward
  without its stream of K and V tiles.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from smer_music_generation_tpu_torch.ops import decode_step as ds  # noqa: E402

CSRC = ROOT / "smer_music_generation_tpu_torch" / "ops" / "csrc"
OUT = ROOT / "build" / "flash_train_variants"
VARIANTS = {
    "base": [],
    "two_stages": [("constexpr int kStages = HD == 64 ? 4 : 2;", "constexpr int kStages = 2;")],
    "no_converter": [
        ("    hopper::mbar_wait(conv + st, (it / kSt) & 1);\n", ""),
        ("    const float* ri = rinv + st * 64;", "    const float* ri = rs + 64;"),
        ("    const float2 rl = *reinterpret_cast<const float2*>(ri + r0);",
         "    float2 rl = *reinterpret_cast<const float2*>(ri + r0);\n"
         "    rl.x = __frcp_rn(rl.x);\n    rl.y = __frcp_rn(rl.y);"),
    ],
    "dkv_no_elementwise": [
        ("      p_tile<true>(sT, rs, ri, madd, key0, tq0, t, sc);", "      ;"),
        ("      p_tile<false>(sT, rs, ri, madd, key0, tq0, t, sc);", "      ;"),
        ("          dT[4 * j + e] = (dT[4 * j + e] - ((e & 1) ? dd.y : dd.x)) * sT[4 * j + e] * sc;",
         "          dT[4 * j + e] += dd.x;"),
    ],
    "bwd_runtime_scale": [("  return HD == 64 ? 0.125f : scale;", "  return scale;")],
    "dq_desc_once": [
        ("    float s[32], dp[32];\n    hopper::wgmma_fence();",
         "    float s[32], dp[32];\n    const uint64_t kd = hopper::desc_b128(kt), vd = hopper::desc_b128(vt);\n"
         "    hopper::wgmma_fence();"),
        ("hopper::wgmma_rs<0>(s, qa[kc], kmajor_step(kt, kc, kBoxBytes), kc > 0);",
         "hopper::wgmma_rs<0>(s, qa[kc], kd + kc * hopper::kDescK16KMajor, kc > 0);"),
        ("hopper::wgmma_rs<0>(dp, ga[kc], kmajor_step(vt, kc, kBoxBytes), kc > 0);",
         "hopper::wgmma_rs<0>(dp, ga[kc], vd + kc * hopper::kDescK16KMajor, kc > 0);"),
    ],
    "dq_no_elementwise": [
        ("        s[4 * j + e] = exp2_ftz((sv - m[r]) * kLog2e) * rl[r];  // p, under g V^T",
         "        s[4 * j + e] = sv;"),
        ("      for (int e = 0; e < 4; ++e) s[4 * j + e] = (dp[4 * j + e] - di[e >> 1]) * s[4 * j + e] * sc;",
         "      for (int e = 0; e < 4; ++e) s[4 * j + e] += dp[4 * j + e];"),
    ],
}
# the f32 kernels' (ops/csrc/attention_f32.cu)
_FWD_KERNEL = "template <int HD, int MODE>\n__global__"  # definitions a variant adds go before it
_FWD_S = "    xyt_tc<HD, NB>(s, qs + r0 * kLdF<HD>, ks, lane);\n    float alpha[2];\n"
_FWD_PV = "    pv_tc<HD, NB>(o, s, vs, gq, tq);\n"
# the forward's K and V split once a block into hi and lo copies of the
# tile (a stage K hi, K lo, V hi, V lo), behind a second __syncthreads
_SPLIT_ONCE = [
    ("constexpr int kFwdStage = 2 * kFwdTile<HD>;  // a ring stage: K's tile, then V's",
     "constexpr int kFwdStage = 4 * kFwdTile<HD>;  // K hi, K lo, V hi, V lo"),
    ("    load_rows_async<HD, BT, MODE == 0>(ks + kFwdTile<HD>, vb, stride, it * BT, S);",
     "    load_rows_async<HD, BT, MODE == 0>(ks + 2 * kFwdTile<HD>, vb, stride, it * BT, S);"),
    (_FWD_KERNEL, """\
__device__ __forceinline__ void mma3(float c[4], const uint32_t ah[4], const uint32_t al[4],
                                     uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

template <int HD>
__device__ __forceinline__ void split_stage(float* st) {
  constexpr int kVec = kFwdBT<HD> * HD / 4;
  static_assert(2 * kVec % kTcThreads == 0, "every thread splits as many");
#pragma unroll
  for (int u = 0; u < 2 * kVec / kTcThreads; ++u) {
    const int i = threadIdx.x + u * kTcThreads, w = i / kVec, j = i % kVec;
    float* x = st + 2 * w * kFwdTile<HD> + (j / (HD / 4)) * kLdF<HD> + 4 * (j % (HD / 4));
    const float4 f = *reinterpret_cast<const float4*>(x);
    uint4 hi, lo;
    split_tf32(f.x, hi.x, lo.x);
    split_tf32(f.y, hi.y, lo.y);
    split_tf32(f.z, hi.z, lo.z);
    split_tf32(f.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(x) = hi;
    *reinterpret_cast<uint4*>(x + kFwdTile<HD>) = lo;
  }
}

template <int HD, int NB>
__device__ __forceinline__ void xyt_hl(float (&c)[NB][4], const float* X, const float* Y,
                                       const float* YL, int lane) {
  constexpr int ld = kLdF<HD>;
#pragma unroll
  for (int j = 0; j < NB; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
  const float* x = X + ((lane & 7) + (lane & 8)) * ld + ((lane >> 4) << 2);
  const int yo = ((lane & 7) + ((lane >> 4) << 3)) * ld + (((lane >> 3) & 1) << 2);
#pragma unroll
  for (int kk = 0; kk < HD; kk += 8) {
    uint32_t a[4], ah[4], al[4];
    attn_tiles::ldsm_x4(a, reinterpret_cast<const __nv_bfloat16*>(x + kk));
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]), ah[i], al[i]);
#pragma unroll
    for (int j = 0; j < NB; j += 2) {
      uint32_t b[4], bl[4];
      attn_tiles::ldsm_x4(b, reinterpret_cast<const __nv_bfloat16*>(Y + yo + 8 * j * ld + kk));
      attn_tiles::ldsm_x4(bl, reinterpret_cast<const __nv_bfloat16*>(YL + yo + 8 * j * ld + kk));
      mma3(c[j], ah, al, b[0], b[1], bl[0], bl[1]);
      mma3(c[j + 1], ah, al, b[2], b[3], bl[2], bl[3]);
    }
  }
}

template <int HD, int NB>
__device__ __forceinline__ void pv_hl(float (&acc)[HD / 8][4], const float (&p)[NB][4],
                                      const float* Y, const float* YL, int gq, int tq) {
  constexpr int ld = kLdF<HD>;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    uint32_t ah[4], al[4];
    split_tf32(p[j][0], ah[0], al[0]);
    split_tf32(p[j][2], ah[1], al[1]);
    split_tf32(p[j][1], ah[2], al[2]);
    split_tf32(p[j][3], ah[3], al[3]);
    const int at = (8 * j + 2 * tq) * ld + gq;
    const float *y = Y + at, *z = YL + at;
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb)
      mma3(acc[nb], ah, al, __float_as_uint(y[8 * nb]), __float_as_uint(y[ld + 8 * nb]),
           __float_as_uint(z[8 * nb]), __float_as_uint(z[ld + 8 * nb]));
  }
}

""" + _FWD_KERNEL),
    ("    const float* ks = ring + (it % 2) * kFwdStage<HD>;\n    const float* vs = ks + kFwdTile<HD>;\n",
     "    float* ks = ring + (it % 2) * kFwdStage<HD>;\n    const float* vs = ks + 2 * kFwdTile<HD>;\n"
     "    split_stage<HD>(ks);\n    __syncthreads();  // the stage's hi and lo are in\n"),
    (_FWD_S, "    xyt_hl<HD, NB>(s, qs + r0 * kLdF<HD>, ks, ks + kFwdTile<HD>, lane);\n"
             "    float alpha[2];\n"),
    (_FWD_PV, "    pv_hl<HD, NB>(o, s, vs, vs + kFwdTile<HD>, gq, tq);\n"),
]
_FWD_T16 = ("constexpr int kFwdBT = 32;", "constexpr int kFwdBT = HD == 64 ? 32 : 16;")
# the probe's scheme (b): each tile's P V into a zeroed fragment, o = fma(o, alpha, pv)
_SCHEME_B = [(
    "#pragma unroll\n    for (int nb = 0; nb < HD / 8; ++nb)\n#pragma unroll\n"
    "      for (int e = 0; e < 4; ++e) o[nb][e] *= alpha[e >> 1];\n" + _FWD_PV,
    "    float pv[HD / 8][4];\n#pragma unroll\n"
    "    for (int nb = 0; nb < HD / 8; ++nb) pv[nb][0] = pv[nb][1] = pv[nb][2] = pv[nb][3] = 0.f;\n"
    "    pv_tc<HD, NB>(pv, s, vs, gq, tq);\n#pragma unroll\n    for (int nb = 0; nb < HD / 8; ++nb)\n"
    "#pragma unroll\n      for (int e = 0; e < 4; ++e) o[nb][e] = fmaf(o[nb][e], alpha[e >> 1], pv[nb][e]);\n")]
# Q's A fragments split once into registers at head_dim 64
_Q_REGS = [
    ("#include <stdint.h>\n", "#include <stdint.h>\n\n#include <type_traits>\n"),
    (_FWD_KERNEL, """\
template <int HD>
struct RegA {
  uint32_t h[HD / 8][4], l[HD / 8][4];
  __device__ __forceinline__ RegA(const float* X, int lane) {
    const float* x = X + ((lane & 7) + (lane & 8)) * kLdF<HD> + ((lane >> 4) << 2);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 8) {
      uint32_t a[4];
      attn_tiles::ldsm_x4(a, reinterpret_cast<const __nv_bfloat16*>(x + kk));
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]), h[kk / 8][i], l[kk / 8][i]);
    }
  }
};

struct NoA {
  __device__ __forceinline__ NoA(const float*, int) {}
};

template <int HD, int NB>
__device__ __forceinline__ void xyt_reg(float (&c)[NB][4], const RegA<HD>& xa, const float* Y,
                                        int lane) {
  constexpr int ld = kLdF<HD>;
#pragma unroll
  for (int j = 0; j < NB; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
  const float* y = Y + ((lane & 7) + ((lane >> 4) << 3)) * ld + (((lane >> 3) & 1) << 2);
#pragma unroll
  for (int kk = 0; kk < HD; kk += 8) {
#pragma unroll
    for (int j = 0; j < NB; j += 2) {
      uint32_t b[4];
      attn_tiles::ldsm_x4(b, reinterpret_cast<const __nv_bfloat16*>(y + 8 * j * ld + kk));
      mma_split(c[j], xa.h[kk / 8], xa.l[kk / 8], __uint_as_float(b[0]), __uint_as_float(b[1]));
      mma_split(c[j + 1], xa.h[kk / 8], xa.l[kk / 8], __uint_as_float(b[2]), __uint_as_float(b[3]));
    }
  }
}

""" + _FWD_KERNEL),
    ("  attn_tiles::cp_async_wait<0>();\n  __syncthreads();\n\n  float o[HD / 8][4];\n",
     "  attn_tiles::cp_async_wait<0>();\n  __syncthreads();\n"
     "  const std::conditional_t<HD == 64, RegA<HD>, NoA> qa(qs + r0 * kLdF<HD>, lane);\n\n"
     "  float o[HD / 8][4];\n"),
    (_FWD_S, "    if constexpr (HD == 64) xyt_reg<HD, NB>(s, qa, ks, lane);\n"
             "    else xyt_tc<HD, NB>(s, qs + r0 * kLdF<HD>, ks, lane);\n    float alpha[2];\n"),
]
_F32_ONE_PASS = [("  mma_tf32(c, al, bh0, bh1);\n  mma_tf32(c, ah, bl0, bl1);\n", "")]
F32_VARIANTS = {
    "base": [],
    "f32_one_pass": _F32_ONE_PASS,
    "f32_scalar_loads": [
        ("  const float* x = X + ((lane & 7) + (lane & 8)) * ld + ((lane >> 4) << 2);\n"
         "  const float* y = Y + ((lane & 7) + ((lane >> 4) << 3)) * ld + (((lane >> 3) & 1) << 2);",
         "  const float* x = X + (lane >> 2) * ld + (lane & 3);\n"
         "  const float* y = Y + (lane >> 2) * ld + (lane & 3);"),
        ("    attn_tiles::ldsm_x4(a, reinterpret_cast<const __nv_bfloat16*>(x + kk));",
         "    a[0] = __float_as_uint(x[kk]);\n    a[1] = __float_as_uint(x[8 * ld + kk]);\n"
         "    a[2] = __float_as_uint(x[kk + 4]);\n    a[3] = __float_as_uint(x[8 * ld + kk + 4]);"),
        ("      attn_tiles::ldsm_x4(b, reinterpret_cast<const __nv_bfloat16*>(y + 8 * j * ld + kk));",
         "      b[0] = __float_as_uint(y[8 * j * ld + kk]);\n"
         "      b[1] = __float_as_uint(y[8 * j * ld + kk + 4]);\n"
         "      b[2] = __float_as_uint(y[8 * (j + 1) * ld + kk]);\n"
         "      b[3] = __float_as_uint(y[8 * (j + 1) * ld + kk + 4]);")],
    "f32_no_split": [
        ("  hi = tf32_rna(x);\n  lo = __float_as_uint(x - __uint_as_float(hi));",
         "  hi = __float_as_uint(x);\n  lo = hi;")],
    "f32_no_elementwise": [
        ("        const float p = attn_tiles::exp2_ftz((sv - m[hi]) * kLog2e) * rl[hi];\n"
         "        s[j][e] = (dp[j][e] - di[hi]) * p * scale;  // ds",
         "        s[j][e] = sv + dp[j][e];"),
        ("          const float p = attn_tiles::exp2_ftz((sv - mr) * kLog2e) * rl;\n"
         "          sT[j][e] = p;\n"
         "          dT[j][e] = (dT[j][e] - dr) * p * scale;  // ds",
         "          sT[j][e] = sv + mr;\n          dT[j][e] += dr * rl;"),
    ],
    # (rows a streamed tile, stages, blocks an SM) at head_dim 64 / 128
    "f32_t64_s2_b2__t16_s2_b2": [
        ("constexpr int kBT = HD == 64 ? 32 : 16;", "constexpr int kBT = HD == 64 ? 64 : 16;"),
        ("constexpr int kMinBlocks = HD == 64 ? 3 : 2;", "constexpr int kMinBlocks = 2;")],
    "f32_t32_s2_b3__t32_s1_b2": [
        ("constexpr int kBT = HD == 64 ? 32 : 16;", "constexpr int kBT = 32;"),
        ("constexpr int kStages = 2;", "constexpr int kStages = HD == 64 ? 2 : 1;")],
    "f32_t64_s1_b3__t64_s1_b1": [
        ("constexpr int kBT = HD == 64 ? 32 : 16;", "constexpr int kBT = 64;"),
        ("constexpr int kStages = 2;", "constexpr int kStages = 1;"),
        ("constexpr int kMinBlocks = HD == 64 ? 3 : 2;", "constexpr int kMinBlocks = HD == 64 ? 3 : 1;")],
    "f32_fwd_split_once": _SPLIT_ONCE,
    "f32_fwd_split_once_t16": [*_SPLIT_ONCE, _FWD_T16],
    "f32_fwd_t16_b3": [_FWD_T16, ("constexpr int kFwdMinBlocks = HD == 64 ? 3 : 2;",
                                  "constexpr int kFwdMinBlocks = 3;")],
    "f32_fwd_t64_b2": [("constexpr int kFwdBT = 32;", "constexpr int kFwdBT = HD == 64 ? 64 : 32;"),
                       ("constexpr int kFwdMinBlocks = HD == 64 ? 3 : 2;",
                        "constexpr int kFwdMinBlocks = 2;")],
    "f32_fwd_q_regs": _Q_REGS,
    "f32_fwd_b4": [("constexpr int kFwdMinBlocks = HD == 64 ? 3 : 2;",
                    "constexpr int kFwdMinBlocks = HD == 64 ? 4 : 2;")],
    "f32_fwd_scheme_b": _SCHEME_B,
    "f32_t16_s2_b3__t32_s2_b1": [
        ("constexpr int kBT = HD == 64 ? 32 : 16;", "constexpr int kBT = HD == 64 ? 16 : 32;"),
        ("constexpr int kMinBlocks = HD == 64 ? 3 : 2;", "constexpr int kMinBlocks = HD == 64 ? 3 : 1;")],
}
_SYNC = "    hopper::named_sync(1 + wg, kConsumerThreads);\n"
_ARRIVE = "    if (wg == 0 || i + 1 < n_blk) hopper::named_arrive(2 - wg, kConsumerThreads);\n"
_FIRST = "  if (wg == 1) hopper::named_arrive(1, kConsumerThreads);\n"
_DEFER = ("constexpr bool kDeferPV = HD == 64;", "constexpr bool kDeferPV = HD != 64;")
FORWARD_VARIANTS = {
    "base": [],
    "fwd_defer_flipped": [_DEFER],
    "fwd_no_pingpong": [(_SYNC, ""), (_ARRIVE, ""), (_FIRST, "")],
    "fwd_defer_flipped_no_pingpong": [_DEFER, (_SYNC, ""), (_ARRIVE, ""), (_FIRST, "")],
    "fwd_no_softmax": [
        ("    fwd_softmax<HD == 64>(s, m, l, alpha, vbits, i, causal && i == qb, single, lr0, t, scale);\n",
         "")],
    "fwd_no_mask": [("  const bool fold = FOLD && full;", "  const bool fold = FOLD;")],
    "fwd_no_fold": [("    fwd_softmax<HD == 64>(", "    fwd_softmax<false>(")],
    "fwd_const_scale": [
        ("    fwd_softmax<HD == 64>(s, m, l, alpha, vbits, i, causal && i == qb, single, lr0, t, scale);\n",
         "    fwd_softmax<HD == 64>(s, m, l, alpha, vbits, i, causal && i == qb, single, lr0, t,\n"
         "                          fixed_scale<HD>(scale));\n")],
    "fwd_three_stages": [("constexpr int kFwdStages = 2;", "constexpr int kFwdStages = 3;")],
    "fwd_no_reload": [
        ("      for (int i = 0; i < n_blk; ++i) {\n        const int st = i % kFwdStages, row",
         "      for (int i = 0; i < min(n_blk, kFwdStages); ++i) {\n        const int st = i % kFwdStages, row"),
        ("    hopper::mbar_wait(kfull + st, (i / kFwdStages) & 1);",
         "    hopper::mbar_wait(kfull + st, 0);"),
        ("      hopper::mbar_wait(vfull + st, (i / kFwdStages) & 1);",
         "      hopper::mbar_wait(vfull + st, 0);"),
        ("      hopper::mbar_wait(vfull + pst, ((i - 1) / kFwdStages) & 1);",
         "      hopper::mbar_wait(vfull + pst, 0);"),
        ("    hopper::mbar_wait(vfull + pst, ((n_blk - 1) / kFwdStages) & 1);",
         "    hopper::mbar_wait(vfull + pst, 0);"),
    ],
}


def build(names, variants=VARIANTS, source_name="flash_train.cu"):
    """{name: ctypes library} of the variants, built in parallel."""
    source = (CSRC / source_name).read_text()
    jobs = {}
    for name in names:
        text = source
        for old, new in variants[name]:
            if old not in text:
                raise SystemExit(f"variant {name}: its edit no longer applies: {old!r}")
            text = text.replace(old, new)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / source_name).write_text(text)
        for header in ("attn_tiles.cuh", "hopper.cuh"):
            shutil.copy(CSRC / header, d)
        cmd = [ds._nvcc(), *ds.NVCC_FLAGS, "-shared", "-Xptxas", "-v", "-I", str(d), "-o",
               str(d / "lib.so"), str(d / source_name)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    i, p = ctypes.c_int, ctypes.c_void_p
    for name, proc in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{err[-3000:]}")
        facts = [ln.strip() for ln in err.splitlines() if "registers" in ln or "spill" in ln]
        print(f"{name}: " + " | ".join(facts), flush=True)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        f = ctypes.c_float
        if source_name == "flash_train.cu":
            lib.smer_flash_train_fwd.argtypes = [i, i, i, i, i, p, p, p, p, i, f, p, p, p]
            lib.smer_flash_train_bwd.argtypes = [i, i, i, i, i, p, p, p, p, p, p, p, i, f, p, p, p,
                                                 p, p]
        else:
            lib.smer_attention_f32_fwd.argtypes = [i, i, i, i, i, i, p, p, p, p, i, f, p, p, p]
            lib.smer_flash_train_bwd_f32.argtypes = [i, i, i, i, i, p, p, p, p, p, p, p, i, f, p, p,
                                                     p, p, p]
        libs[name] = lib
    return libs


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("flash_train_variants: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    mode = argv[0] if argv and argv[0] in ("--forward", "--f32") else None
    argv = argv[1:] if mode else argv
    variants = {"--forward": FORWARD_VARIANTS, "--f32": F32_VARIANTS}.get(mode, VARIANTS)
    names = argv or list(variants)
    if "base" not in names:
        names = ["base", *names]
    libs = build(names, variants, "attention_f32.cu" if mode == "--f32" else "flash_train.cu")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    if mode == "--forward":
        return time_forward(libs, names, dev, profile, ProfilerActivity)
    if mode == "--f32":
        return time_f32(libs, names, dev, profile, ProfilerActivity)
    B, H = 8, 8
    for T in (2048, 640):
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v, go = (torch.randn(B, T, H, 64, generator=g, device=dev).to(torch.bfloat16)
                       for _ in range(4))
        valid = (torch.rand(B, T, generator=g, device=dev) >= 0.1).to(torch.int32)
        valid[1] = 0
        out, stats = torch.empty_like(q), torch.empty(2, B * H, T, device=dev)
        di = torch.empty(B * H, T, device=dev)
        grads = [torch.empty_like(q) for _ in range(3)]
        stream = torch.cuda.current_stream(dev).cuda_stream
        want = None
        for rnd in range(2):
            for name in names:
                lib = libs[name]
                ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr())
                if lib.smer_flash_train_fwd(64, B, T, T, H, *ptrs, 0, 0.125, out.data_ptr(),
                                            stats.data_ptr(), stream):
                    raise SystemExit(f"{name}: forward launch failed")

                def bwd():
                    rc = lib.smer_flash_train_bwd(64, B, T, T, H, *ptrs, out.data_ptr(),
                                                  stats.data_ptr(), go.data_ptr(), 0, 0.125,
                                                  di.data_ptr(), *(t.data_ptr() for t in grads),
                                                  stream)
                    if rc:
                        raise SystemExit(f"{name}: backward launch failed: {rc}")

                for _ in range(5):
                    bwd()
                torch.cuda.synchronize()
                got = torch.cat([t.flatten() for t in grads])
                if name == "base":
                    want = got.clone()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(50):
                    bwd()
                end.record()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        bwd()
                    torch.cuda.synchronize()
                us = {kname: round(e.self_device_time_total / 10, 1) for e in prof.key_averages()
                      for kname in ("flash_train_dq_kernel", "flash_train_dkv_kernel")
                      if kname in e.key}
                print(f"T=S={T} round {rnd} {name:20s} {start.elapsed_time(end) / 50:.4f} ms a call, "
                      f"device us {us}, bit-equal to base: {torch.equal(got, want)}", flush=True)
    return 0


def time_forward(libs, names, dev, profile, ProfilerActivity) -> int:
    """The forward variants at B=8, H=8, T=S=2048, head_dim 64 and 128, ~10%
    of keys invalid (one batch row with none) and every key valid: ms a call
    (50 back-to-back calls, CUDA events), device µs by the profiler, and
    whether the output and m, l are bit-equal to the base's."""
    B, H, T = 8, 8, 2048
    stream = torch.cuda.current_stream(dev).cuda_stream
    for D in (64, 128):
        for masked in (True, False):
            g = torch.Generator(device=dev).manual_seed(0)
            q, k, v = (torch.randn(B, T, H, D, generator=g, device=dev).to(torch.bfloat16)
                       for _ in range(3))
            valid = (torch.rand(B, T, generator=g, device=dev) >= (0.1 if masked else 0.0))
            valid = valid.to(torch.int32)
            if masked:
                valid[1] = 0
            out, stats = torch.empty_like(q), torch.empty(2, B * H, T, device=dev)
            want = None
            for rnd in range(2):
                for name in names:
                    lib = libs[name]

                    def fwd():
                        rc = lib.smer_flash_train_fwd(D, B, T, T, H, q.data_ptr(), k.data_ptr(),
                                                      v.data_ptr(), valid.data_ptr(), 0, D ** -0.5,
                                                      out.data_ptr(), stats.data_ptr(), stream)
                        if rc:
                            raise SystemExit(f"{name}: forward launch failed: {rc}")

                    for _ in range(5):
                        fwd()
                    torch.cuda.synchronize()
                    got = (out.clone(), stats.clone())
                    if name == "base":
                        want = got
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    for _ in range(50):
                        fwd()
                    end.record()
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for _ in range(10):
                            fwd()
                        torch.cuda.synchronize()
                    us = [round(e.self_device_time_total / 10, 1) for e in prof.key_averages()
                          if "flash_train_fwd_kernel" in e.key]
                    same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                    print(f"head_dim {D} {'10% keys invalid' if masked else 'every key valid'} "
                          f"round {rnd} {name:24s} {start.elapsed_time(end) / 50:.4f} ms a call, "
                          f"device us {us}, bit-equal to base: {same}", flush=True)
    return 0


def time_f32(libs, names, dev, profile, ProfilerActivity) -> int:
    """The f32 variants at head_dim 64 (H=8) and 128 (H=4): the forward in
    MODE 1 at B=8, T=S=640 and in MODE 0 at B=3, T=S=1536 (key lengths
    1536/1440/1344), then the backward pair at B=8, T=S=640 (~10% of keys
    invalid, one batch row with none, not causal): ms a call (50
    back-to-back calls, CUDA events), each kernel's device µs by the
    profiler, and the outputs (out; dq, dk, dv) against the base's
    (bit-equal, and the worst relative norm)."""
    B, T = 8, 640
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernels = ("attn_f32_fwd_kernel", "flash_train_f32_dq_kernel", "flash_train_f32_dkv_kernel")
    for D, H in ((64, 8), (128, 4)):
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v, go = (torch.randn(B, T, H, D, generator=g, device=dev) for _ in range(4))
        valid = (torch.rand(B, T, generator=g, device=dev) >= 0.1).to(torch.int32)
        valid[1] = 0
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr())
        out, stats = torch.empty_like(q), torch.empty(2, B * H, T, device=dev)
        di = torch.empty(B * H, T, device=dev)
        grads = [torch.empty_like(q) for _ in range(3)]
        if libs["base"].smer_attention_f32_fwd(1, D, B, T, T, H, *ptrs, 0, D ** -0.5, out.data_ptr(),
                                               stats.data_ptr(), stream):
            raise SystemExit("the f32 forward launch failed")
        # MODE 0 at the served encoder shape
        q0, k0, v0 = (torch.randn(3, 1536, H, D, generator=g, device=dev) for _ in range(3))
        lens = torch.tensor([1536, 1440, 1344], dtype=torch.int32, device=dev)
        out1, stats1, out0 = torch.empty_like(q), torch.empty_like(stats), torch.empty_like(q0)
        want = {}
        for rnd in range(2):
            for name in names:
                lib = libs[name]

                def fwd1():
                    if lib.smer_attention_f32_fwd(1, D, B, T, T, H, *ptrs, 0, D ** -0.5, out1.data_ptr(),
                                                  stats1.data_ptr(), stream):
                        raise SystemExit(f"{name}: MODE 1 forward launch failed")

                def fwd0():
                    if lib.smer_attention_f32_fwd(0, D, 3, 1536, 1536, H, q0.data_ptr(), k0.data_ptr(),
                                                  v0.data_ptr(), lens.data_ptr(), 0, D ** -0.5,
                                                  out0.data_ptr(), None, stream):
                        raise SystemExit(f"{name}: MODE 0 forward launch failed")

                def bwd():
                    rc = lib.smer_flash_train_bwd_f32(D, B, T, T, H, *ptrs, out.data_ptr(),
                                                      stats.data_ptr(), go.data_ptr(), 0, D ** -0.5,
                                                      di.data_ptr(), *(t.data_ptr() for t in grads),
                                                      stream)
                    if rc:
                        raise SystemExit(f"{name}: backward launch failed: {rc}")

                for what, fn, res in (("forward MODE 1 B8 640x640", fwd1, [out1, stats1]),
                                      ("forward MODE 0 B3 1536x1536", fwd0, [out0]),
                                      ("backward pair B8 640x640", bwd, grads)):
                    for _ in range(5):
                        fn()
                    torch.cuda.synchronize()
                    got = [t.clone() for t in res]
                    if name == "base":
                        want[what] = got
                    rel = max(((a - b).norm() / b.norm()).item() for a, b in zip(got, want[what]))
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    for _ in range(50):
                        fn()
                    end.record()
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for _ in range(10):
                            fn()
                        torch.cuda.synchronize()
                    us = {kname: round(e.self_device_time_total / 10, 1) for e in prof.key_averages()
                          for kname in kernels if kname in e.key}
                    same = all(torch.equal(a, b) for a, b in zip(got, want[what]))
                    print(f"f32 head_dim {D} H={H} {what} round {rnd} {name:24s} "
                          f"{start.elapsed_time(end) / 50:.4f} ms a call, device us {us}, bit-equal to "
                          f"base: {same}, worst relative norm to base {rel:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
