#!/usr/bin/env python3
"""Time design variants of the flash-train backward pair on one CUDA card.

    python3 scripts/flash_train_variants.py [VARIANT ...]

Each variant is ``ops/csrc/flash_train.cu`` with a few lines edited (the
edits are below, each checked to apply), built alone with nvcc into
``build/flash_train_variants/<name>/`` (all builds started together) and
bound with ctypes.  At B=8, H=8 and T=S=2048 and 640 (~10% of keys invalid,
one batch row with none, not causal, as chip_smoke's phase 2j), every
variant runs the forward once, then the backward (``flash_train_dq_kernel``
then ``flash_train_dkv_kernel``): the ms of 50 back-to-back calls by CUDA
events, each kernel's device µs by the profiler, and whether its dq, dk and
dv are bit-equal to the unedited source's.  Two rounds, in the order given.

The variants say what each part of the design costs:
- ``two_stages``: a ring of two 64-row tiles, not four;
- ``no_converter``: the consumers take 1 / l themselves (16 a tile and
  thread) instead of the producer warpgroup's second warp;
- ``dkv_no_elementwise`` / ``dq_no_elementwise``: the mask, p and ds left
  out (wrong results, timing only): the products and the pipeline alone.
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
    "two_stages": [("constexpr int kStages = 4;", "constexpr int kStages = 2;")],
    "no_converter": [
        ("    hopper::mbar_wait(conv + st, (it / kStages) & 1);\n", ""),
        ("    const float* ri = rinv + st * 64;", "    const float* ri = rs + 64;"),
        ("    const float2 rl = *reinterpret_cast<const float2*>(ri + r0);",
         "    float2 rl = *reinterpret_cast<const float2*>(ri + r0);\n"
         "    rl.x = __frcp_rn(rl.x);\n    rl.y = __frcp_rn(rl.y);"),
    ],
    "dkv_no_elementwise": [
        ("      p_tile<true>(sT, rs, ri, madd, key0, tq0, t);", "      ;"),
        ("      p_tile<false>(sT, rs, ri, madd, key0, tq0, t);", "      ;"),
        ("        dT[4 * j + e] = (dT[4 * j + e] - ((e & 1) ? dd.y : dd.x)) * sT[4 * j + e] * kScale;",
         "        dT[4 * j + e] += dd.x;"),
    ],
    "dq_no_elementwise": [
        ("        s[4 * j + e] = exp2_ftz((sv - m[r]) * kLog2e) * rl[r];  // p, under g V^T",
         "        s[4 * j + e] = sv;"),
        ("      for (int e = 0; e < 4; ++e) s[4 * j + e] = (dp[4 * j + e] - di[e >> 1]) * s[4 * j + e] * kScale;",
         "      for (int e = 0; e < 4; ++e) s[4 * j + e] += dp[4 * j + e];"),
    ],
}


def build(names):
    """{name: ctypes library} of the variants, built in parallel."""
    source = (CSRC / "flash_train.cu").read_text()
    jobs = {}
    for name in names:
        text = source
        for old, new in VARIANTS[name]:
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
        lib.smer_flash_train_fwd.argtypes = [i, i, i, i, p, p, p, p, i, p, p, p]
        lib.smer_flash_train_bwd.argtypes = [i, i, i, i, p, p, p, p, p, p, p, i, p, p, p, p, p]
        libs[name] = lib
    return libs


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("flash_train_variants: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    names = argv or list(VARIANTS)
    if "base" not in names:
        names = ["base", *names]
    libs = build(names)
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
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
                if lib.smer_flash_train_fwd(B, T, T, H, *ptrs, 0, out.data_ptr(), stats.data_ptr(),
                                            stream):
                    raise SystemExit(f"{name}: forward launch failed")

                def bwd():
                    rc = lib.smer_flash_train_bwd(B, T, T, H, *ptrs, out.data_ptr(), stats.data_ptr(),
                                                  go.data_ptr(), 0, di.data_ptr(),
                                                  *(t.data_ptr() for t in grads), stream)
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


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
