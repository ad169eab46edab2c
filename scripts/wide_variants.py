#!/usr/bin/env python3
"""Time design variants of the wide attention kernels on one CUDA card.

    python3 scripts/wide_variants.py [VARIANT ...]

Each variant is ``ops/csrc/attention_wide.cu`` with a few lines edited (the
edits are below, each checked to apply), built alone with nvcc into
``build/wide_variants/<name>/`` (all builds started together) and bound with
ctypes in place of the port's library, so the wrappers of
``ops/attention_wide.py`` launch it.  At ``chip_smoke.WIDE_TIMED`` (B=8, H=2,
T=S=640, head_dim 256; time_wide's seeded inputs, ~10% of keys invalid, one
batch row with none; ``fused_attention``'s key lengths 640/320/1/640...), every
variant runs each wrapper of the wide kernels: ``fused_attention`` (MODE 0,
bf16 and f32), the dropout forward and backward pair (MODE 1, rate 0.1), the
flash-train forward and pair (MODE 2, bf16 and f32): the ms of 20
back-to-back calls by CUDA events after 3 warm-up calls, whether the
outputs are bit-equal to the unedited source's, and for each backward pair
its rows and keys kernels' device µs a call (profiler).  Two rounds, in the
order given (``base`` first).  The first lines print each variant's
registers and spills from ptxas.

The variants:
- ``stages3`` / ``stages4``: a cp.async ring of 3 or 4 stages, not 2 (the
  same bits);
- ``b2``: registers capped for two blocks an SM (255), not three (168);
  ``b2_stages3`` the same with a ring of 3 stages;
- ``m0_b3``: ``wide_fwd_kernel<bf16, 0>`` too capped for three blocks (it
  spills 4 bytes there);
- ``lo_after_hi``: MODE 0's P V takes bf16(P) over a k16 chunk's n-blocks,
  then forms bf16(P - bf16(P)) and loads V's fragments again for it (four
  registers fewer held; other bits).
- ``keys_b2``: ``wide_keys_kernel`` alone capped for two blocks an SM (255
  registers), not three (168); with ``stages3`` the keys kernel's ring of 3
  stages (every kernel's ring grows: the rows kernel's time moves too);
- ``keys_split``: the keys kernel of ``scripts/wide_keys_split.cuh``, 8 warps
  a block of 64 keys and a chunk of both dk and dv (warps 0-3 S^T and dv,
  warps 4-7 (g V^T)^T and dk, w or p through the stash), S^T once a chunk:
  capped for two blocks an SM (128 registers); ``keys_split_b1`` for one
  (255); ``keys_split_b1_stages3`` the same with a ring of 3 stages (the
  same bits as the shipped kernel wherever the split's order holds).
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

from chip_smoke import TA_SEEDS, WIDE_TIMED, device_split, flash_train_inputs  # noqa: E402
from smer_music_generation_tpu_torch.ops import attention as attn  # noqa: E402
from smer_music_generation_tpu_torch.ops import decode_step as ds  # noqa: E402
from smer_music_generation_tpu_torch.ops import flash_train as ft  # noqa: E402
from smer_music_generation_tpu_torch.ops import train_attention as ta  # noqa: E402

CSRC = ROOT / "smer_music_generation_tpu_torch" / "ops" / "csrc"
OUT = ROOT / "build" / "wide_variants"
SOURCE = "attention_wide.cu"
_STAGES = "constexpr int kStages = 2;                           // the ring's depth"
_B2 = [("constexpr int kFwdBlocks = 3;", "constexpr int kFwdBlocks = 2;"),
       ("__launch_bounds__(kTcThreads, 3) wide_rows_kernel", "__launch_bounds__(kTcThreads, 2) wide_rows_kernel")]


def _keys_split(blocks: int):
    """The edit that puts scripts/wide_keys_split.cuh in place of fetch_keys
    and wide_keys_kernel, capped for ``blocks`` blocks an SM."""
    def edit(text: str) -> str:
        first, last = "// step i of a keys block's walk", "// grid (blocks of 64 of `rows`"
        launch = "launch(keys, a, a.S, 2, st)"
        if first not in text or last not in text or launch not in text:
            raise SystemExit("variant keys_split: its anchors no longer match attention_wide.cu")
        body = (ROOT / "scripts" / "wide_keys_split.cuh").read_text().replace(
            "#define KEYS_SPLIT_BLOCKS 2", f"#define KEYS_SPLIT_BLOCKS {blocks}")
        text = text[:text.index(first)] + body + text[text.index(last):]
        return text.replace(launch, "launch_keys_split(keys, a, st)")
    return edit


VARIANTS = {
    "base": [],
    "stages3": [(_STAGES, _STAGES.replace("= 2", "= 3"))],
    "stages4": [(_STAGES, _STAGES.replace("= 2", "= 4"))],
    "b2": _B2,
    "b2_stages3": [*_B2, (_STAGES, _STAGES.replace("= 2", "= 3"))],
    "keys_b2": [("__launch_bounds__(kTcThreads, 3) wide_keys_kernel",
                 "__launch_bounds__(kTcThreads, 2) wide_keys_kernel")],
    "keys_split": [_keys_split(2)],
    "keys_split_b1": [_keys_split(1)],
    "keys_split_b1_stages3": [_keys_split(1), (_STAGES, _STAGES.replace("= 2", "= 3"))],
    "m0_b3": [("constexpr int kFwdBlocks<bf16, kModeFused> = 2;",
               "constexpr int kFwdBlocks<bf16, kModeFused> = 3;")],
    "lo_after_hi": [
        ("""      if (SPLIT) {
        const float2 hf = __bfloat1622float2(hi);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
        al[u] = *reinterpret_cast<const uint32_t*>(&lo);
      }
    }""", """    }"""),
        ("""        if (SPLIT) {
          tiles::mma_bf16(o[2 * jp], al, b[0], b[1]);
          tiles::mma_bf16(o[2 * jp + 1], al, b[2], b[3]);
        }
      }
    }
  }
}""", """      }
    }
    if (SPLIT) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 2 * kc + (u >> 1), e = 2 * (u & 1);
        const float p0 = p(j, e), p1 = p(j, e + 1);
        const float2 hf = __bfloat1622float2(__floats2bfloat162_rn(p0, p1));
        const __nv_bfloat162 lo = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
        al[u] = *reinterpret_cast<const uint32_t*>(&lo);
      }
#pragma unroll
      for (int jp = 0; jp < kOC / 16; ++jp) {
        if (2 * jp < nnb) {
          uint32_t b[4];
          tiles::ldsm_x4_trans(b, ys + (16 * kc + (lane & 15)) * ld + 16 * jp + 8 * (lane >> 4));
          tiles::mma_bf16(o[2 * jp], al, b[0], b[1]);
          tiles::mma_bf16(o[2 * jp + 1], al, b[2], b[3]);
        }
      }
    }
  }
}""")],
}


def build(names):
    """{name: ctypes library} of the variants, built in parallel."""
    source = (CSRC / SOURCE).read_text()
    jobs = {}
    for name in names:
        text = source
        for edit in VARIANTS[name]:
            if callable(edit):
                text = edit(text)
                continue
            old, new = edit
            if old not in text:
                raise SystemExit(f"variant {name}: its edit no longer applies: {old!r}")
            text = text.replace(old, new)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / SOURCE).write_text(text)
        for header in ("attn_tiles.cuh", "dropout_hash.cuh"):
            shutil.copy(CSRC / header, d)
        cmd = [ds._nvcc(), *ds.NVCC_FLAGS, "-shared", "-Xptxas", "-v", "-I", str(d), "-o",
               str(d / "lib.so"), str(d / SOURCE)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    i, p, f, u = ctypes.c_int, ctypes.c_void_p, ctypes.c_float, ctypes.c_uint
    for name, proc in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{err[-3000:]}")
        facts, entry, spill = [], None, ""
        for ln in err.splitlines():  # per entry: its name, then its spills, then its registers
            if "Compiling entry" in ln:
                entry = next((k for k in ("wide_fwd_kernel", "wide_rows_kernel", "wide_keys_kernel")
                              if k in ln), None)
                inst = ln.split(entry)[1].split("EEvNS")[0] if entry else ""
                spill = ""
            elif entry and "spill" in ln and not ln.strip().startswith("0 bytes stack frame, 0 bytes spill"):
                spill = f" ({ln.strip()})"
            elif entry and "registers" in ln:
                facts.append(f"{entry}{inst}: {ln.split('Used')[1].split(',')[0].strip()}{spill}")
        print(f"{name}: " + "; ".join(facts), flush=True)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.smer_wide_attn_fwd.argtypes = [i] * 10 + [p] * 6 + [u, i, f, i, f, p, p, p]
        lib.smer_wide_attn_bwd.argtypes = [i] * 10 + [p] * 5 + [u, i, f, i, f] + [p] * 8
        for fn in (lib.smer_wide_attn_fwd, lib.smer_wide_attn_bwd):
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def calls(dev):
    """{label: a no-argument call of a wrapper} at WIDE_TIMED."""
    B, T, S, H, D = WIDE_TIMED
    g = torch.Generator(device=dev).manual_seed(23)
    q, k, v, go, valid = flash_train_inputs(g, dev, T, S, H, D)
    valid = valid.to(torch.int32)
    lens = torch.tensor([S, S // 2, 1] + [S] * (B - 3), dtype=torch.int32, device=dev)
    seed = ta.seed_tensor(TA_SEEDS[0], dev)
    qf, kf, vf, gf = (t.float() for t in (q, k, v, go))
    out, stats = (t.contiguous() for t in ft.flash_train_fwd_reference(q, k, v, valid, False))
    outf, statsf = (t.contiguous() for t in ft.flash_train_fwd_reference(qf, kf, vf, valid, False))
    return {
        "fused_attention bf16": lambda: attn.fused_attention(q, k, v, lens),
        "fused_attention f32": lambda: attn.fused_attention(qf, kf, vf, lens),
        "dropout fwd bf16": lambda: ta.dropout_attention_fwd(q, k, v, valid, seed, 0.1, False),
        "dropout bwd bf16": lambda: ta.dropout_attention_bwd(q, k, v, valid, seed, go, 0.1, False),
        "flash fwd bf16": lambda: ft.flash_train_fwd(q, k, v, valid, False),
        "flash fwd f32": lambda: ft.flash_train_fwd(qf, kf, vf, valid, False),
        "flash bwd bf16": lambda: ft.flash_train_bwd(q, k, v, valid, out, stats, go, False),
        "flash bwd f32": lambda: ft.flash_train_bwd(qf, kf, vf, valid, outf, statsf, gf, False),
    }


def flat(x):
    if isinstance(x, torch.Tensor):
        return x.flatten().float()
    return torch.cat([flat(t) for t in x])


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("wide_variants: no CUDA device", file=sys.stderr)
        return 2
    names = argv or list(VARIANTS)
    if "base" not in names:
        names = ["base", *names]
    libs = build(names)
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    fns = calls(dev)
    want = {}
    for rnd in range(2):
        for name in names:
            ds._lib = libs[name]
            said = []
            for label, fn in fns.items():
                for _ in range(3):
                    got = fn()
                torch.cuda.synchronize()
                got = flat(got)
                want.setdefault(label, got)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    fn()
                end.record()
                torch.cuda.synchronize()
                same = "" if torch.equal(got, want[label]) else " (other bits)"
                if " bwd " in label:
                    split = device_split(fn) or {}
                    same += " [" + ", ".join(f"{k.split('_')[1]} {split.get(k, 0.0):.1f} us" for k in
                                             ("wide_rows_kernel", "wide_keys_kernel")) + "]"
                said.append(f"{label} {start.elapsed_time(end) / 20:.4f}{same}")
            print(f"round {rnd} {name:10s} ms a call: " + ", ".join(said), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
