#!/usr/bin/env python3
"""Time design variants of the flash-train kernels on one CUDA card.

    python3 scripts/flash_train_variants.py [VARIANT ...]
    python3 scripts/flash_train_variants.py --forward [VARIANT ...]

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
and m, l compared bit for bit with the unedited source's.

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


def build(names, variants=VARIANTS):
    """{name: ctypes library} of the variants, built in parallel."""
    source = (CSRC / "flash_train.cu").read_text()
    jobs = {}
    for name in names:
        text = source
        for old, new in variants[name]:
            if old not in text:
                raise SystemExit(f"variant {name}: its edit no longer applies: {old!r}")
            text = text.replace(old, new)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "flash_train.cu").write_text(text)
        for header in ("attn_tiles.cuh", "hopper.cuh"):
            shutil.copy(CSRC / header, d)
        cmd = [ds._nvcc(), *ds.NVCC_FLAGS, "-shared", "-Xptxas", "-v", "-I", str(d), "-o",
               str(d / "lib.so"), str(d / "flash_train.cu")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    i, p = ctypes.c_int, ctypes.c_void_p
    for name, proc in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{err[-3000:]}")
        facts = [ln.strip() for ln in err.splitlines() if "registers" in ln or "spill" in ln]
        print(f"{name}: " + " | ".join(facts[:4]), flush=True)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        f = ctypes.c_float
        lib.smer_flash_train_fwd.argtypes = [i, i, i, i, i, p, p, p, p, i, f, p, p, p]
        lib.smer_flash_train_bwd.argtypes = [i, i, i, i, i, p, p, p, p, p, p, p, i, f, p, p, p, p, p]
        libs[name] = lib
    return libs


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("flash_train_variants: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    forward = bool(argv) and argv[0] == "--forward"
    argv = argv[1:] if forward else argv
    variants = FORWARD_VARIANTS if forward else VARIANTS
    names = argv or list(variants)
    if "base" not in names:
        names = ["base", *names]
    libs = build(names, variants)
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    if forward:
        return time_forward(libs, names, dev, profile, ProfilerActivity)
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


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
