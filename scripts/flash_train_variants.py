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
backward pair (``flash_train_f32_dq_kernel`` then
``flash_train_f32_dkv_kernel``) timed at B=8, T=S=640, head_dim 64 (H=8)
and 128 (H=4), its dq, dk, dv against the unedited source's (bit-equal, and
the worst relative norm).

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

The f32 pair's:
- ``f32_one_pass``: hi hi alone, one TF32 pass a product (wrong results,
  ~5e-4: timing only): what the split's other two passes cost;
- ``f32_no_split``: each operand handed to all three passes as it is, no
  split instructions (wrong results: timing only): what the splits cost;
- ``f32_no_elementwise``: the mask, p and ds left out (timing only);
- ``f32_scalar_loads``: X Y^T's fragments by scalar loads (4 for A, 2 a
  B n-block) instead of ldmatrix (the same bits);
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
# the f32 backward pair's (ops/csrc/attention_f32.cu)
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
    """The f32 backward pair's variants at B=8, T=S=640, head_dim 64 (H=8)
    and 128 (H=4), f32, ~10% of keys invalid (one batch row with none), not
    causal: ms a call (50 back-to-back calls, CUDA events), each kernel's
    device µs by the profiler, and dq, dk, dv against the base's (bit-equal,
    and the worst relative norm)."""
    B, T = 8, 640
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernels = ("flash_train_f32_dq_kernel", "flash_train_f32_dkv_kernel")
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
        want = None
        for rnd in range(2):
            for name in names:
                lib = libs[name]

                def bwd():
                    rc = lib.smer_flash_train_bwd_f32(D, B, T, T, H, *ptrs, out.data_ptr(),
                                                      stats.data_ptr(), go.data_ptr(), 0, D ** -0.5,
                                                      di.data_ptr(), *(t.data_ptr() for t in grads),
                                                      stream)
                    if rc:
                        raise SystemExit(f"{name}: backward launch failed: {rc}")

                for _ in range(5):
                    bwd()
                torch.cuda.synchronize()
                got = [t.clone() for t in grads]
                if name == "base":
                    want = got
                rel = max(((a - b).norm() / b.norm()).item() for a, b in zip(got, want))
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
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
                      for kname in kernels if kname in e.key}
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                print(f"f32 head_dim {D} H={H} {T}x{T} round {rnd} {name:24s} "
                      f"{start.elapsed_time(end) / 50:.4f} ms a call, device us {us}, bit-equal to base: "
                      f"{same}, worst relative norm to base {rel:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
