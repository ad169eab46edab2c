#!/usr/bin/env python3
"""How close split-TF32 products on the tensor cores come to f32, on one
CUDA card, at the f32 flash-train backward's five products.

    python3 scripts/f32_tc_probe.py [--out build/f32_tc_probe.json]

Builds ``scripts/f32_tc_probe.cu`` with nvcc into ``build/torch_kernels/``
(named by a hash of the source) and, at phase 2j's f32 cases of
``chip_smoke.py`` (head_dim 64 at H=8 and 128 at H=4; T x S = 640x640,
384x384 causal, 384x640; B=8, its seeded inputs), forms the five products of
the backward as the twin does (``ops/flash_train.py``, f32): S = Q K^T, dP =
g V^T, dV = P^T g, dK = dS^T Q and dQ = dS K.  Each is taken by
``mma.sync`` m16n8k8 TF32 with each operand split as hi = tf32(x) and lo =
x - hi, lo rounded to TF32 (``rna``) or read as it is (``raw``), in two
schemes of accumulation: (a) one chain over the whole reduction, (b) a
zeroed accumulator for each 64 of the reduction added by FADD; and, for
contrast, one plain TF32 pass.  Each result's relative norm
||C - ref|| / ||ref|| is printed against the same product summed in
float64 and against cuBLAS's f32 product (TF32 off), and cuBLAS's own
against float64.  The last line names the cheapest variant whose worst
reading over every product and case is at most 2.5e-5 (a 4x margin under
``chip_smoke.F32_REL``), cheapest first: (a) raw, (a) rna, (b) raw, (b) rna;
or says that none is.  First it holds the integer rounding to TF32 that the
kernels use, ``(bits + 0x1000) & 0xffffe000``, against ``cvt.rna.tf32.f32``
on every finite f32 bit pattern.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import F32_REL, FT_WIDE, flash_train_inputs  # noqa: E402
from smer_music_generation_tpu_torch.ops import decode_step as ds  # noqa: E402
from smer_music_generation_tpu_torch.ops import flash_train as ft  # noqa: E402

SRC = Path(__file__).resolve().with_name("f32_tc_probe.cu")
MARGIN = 2.5e-5  # the chosen scheme's worst reading: F32_REL / 4
# (label, lo mode, scheme) in order of cost; the last is the contrast
VARIANTS = (("(a) chain, lo raw", 1, 0), ("(a) chain, lo rna", 0, 0),
            ("(b) tile64, lo raw", 1, 1), ("(b) tile64, lo rna", 0, 1), ("one TF32 pass", 0, 2))


def build() -> ctypes.CDLL:
    out_dir = Path(ds._BUILD_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    lib_path = out_dir / f"libf32_tc_probe_{digest}.so"
    if not lib_path.is_file():
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        subprocess.run([ds._nvcc(), *ds.NVCC_FLAGS, "-shared", "-o", str(tmp), str(SRC)], check=True)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.f32_tc_probe_launch.argtypes = [i, i, i, i, i, i, p, p, p, p]
    lib.f32_tc_rna_sweep.argtypes = [p, p, p]
    return lib


def rna_sweep(lib, dev, stream) -> dict:
    """cvt.rna.tf32.f32 against the kernels' (bits + 0x1000) & 0xffffe000
    on every finite f32 bit pattern."""
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    first = torch.full((1,), -1, dtype=torch.int32, device=dev)
    ds._check(lib.f32_tc_rna_sweep(counts.data_ptr(), first.data_ptr(), stream), "rna_sweep")
    torch.cuda.synchronize()
    differ, low = (int(x) for x in counts.tolist())
    return dict(finite_patterns=2 ** 32 - 2 ** 24, differ=differ, rna_low_bits_set=low,
                first_differing=None if differ == 0 else f"{int(first.item()) & 0xffffffff:#010x}")


def rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    return ((a.double() - ref).norm() / ref.norm()).item()


def operands(q, k, v, valid, go, causal):
    """The five products' operands (A (BH, M, K), Bt (BH, N, K)) as the twin
    forms P and dS in f32."""
    B, T, H, D = q.shape
    heads = lambda x: x.permute(0, 2, 1, 3).reshape(B * H, x.shape[1], D).contiguous()  # noqa: E731
    out, stats = ft.flash_train_fwd_reference(q, k, v, valid, causal)
    s = ft._masked_scores(q, k, valid, causal)
    m, l = (x.reshape(B, H, T, 1) for x in stats)
    p = ft._exp(s - m) * (1.0 / l)
    dp = torch.einsum("bthd,bshd->bhts", go, v)
    di = (out * go).sum(-1).transpose(1, 2)[..., None]
    dsc = (dp - di) * p * (1.0 / math.sqrt(D))
    qh, kh, vh, gh = (heads(x) for x in (q, k, v, go))
    P, dS = p.reshape(B * H, T, -1), dsc.reshape(B * H, T, -1)
    tr = lambda x: x.transpose(1, 2).contiguous()  # noqa: E731
    return {"S = Q K^T": (qh, kh), "dP = g V^T": (gh, vh), "dV = P^T g": (tr(P), tr(gh)),
            "dK = dS^T Q": (tr(dS), tr(qh)), "dQ = dS K": (dS.contiguous(), tr(kh))}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/f32_tc_probe.json",
                    help="where the readings go as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("f32_tc_probe needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    lib = build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    sweep = rna_sweep(lib, dev, stream)
    print(f"TF32 rounding: the kernels' integer form against cvt.rna.tf32.f32 on every finite f32 "
          f"pattern: {sweep['differ']} differ (first {sweep['first_differing']}); cvt.rna left low "
          f"bits on {sweep['rna_low_bits_set']}", flush=True)
    worst = {label: 0.0 for label, _, _ in VARIANTS}
    worst_cublas = 0.0
    rows = []
    g = torch.Generator(device=dev).manual_seed(23)
    for hd, heads, dtype, cases, _ in FT_WIDE:
        if dtype != torch.float32:
            continue
        for T, S, causal in cases:
            q, k, v, go, valid = flash_train_inputs(g, dev, T, S, heads, hd, dtype)
            for name, (A, Bt) in operands(q, k, v, valid.to(torch.int32), go, causal).items():
                ref = torch.bmm(A.double(), Bt.double().transpose(1, 2))
                cub = torch.bmm(A, Bt.transpose(1, 2))
                row = dict(head_dim=hd, T=T, S=S, causal=causal, product=name, reduction=A.shape[2],
                           cublas_vs_f64=rel(cub, ref))
                worst_cublas = max(worst_cublas, row["cublas_vs_f64"])
                for label, lo, scheme in VARIANTS:
                    C = torch.empty(A.shape[0], A.shape[1], Bt.shape[1], device=dev)
                    rc = lib.f32_tc_probe_launch(lo, scheme, A.shape[0], A.shape[1], Bt.shape[1],
                                                 A.shape[2], A.data_ptr(), Bt.data_ptr(), C.data_ptr(),
                                                 stream)
                    ds._check(rc, "f32_tc_probe")
                    torch.cuda.synchronize()
                    r64, rcub = rel(C, ref), rel(C, cub.double())
                    row[label] = dict(vs_f64=r64, vs_cublas=rcub)
                    worst[label] = max(worst[label], r64, rcub)
                rows.append(row)
                print(f"hd {hd} T={T} S={S} causal={causal} {name} (sum over {A.shape[2]}): cuBLAS f32 "
                      f"{row['cublas_vs_f64']:.3e} from float64; " +
                      "; ".join(f"{label} {row[label]['vs_f64']:.3e} / {row[label]['vs_cublas']:.3e}"
                                for label, _, _ in VARIANTS) + " (from float64 / from cuBLAS)",
                      flush=True)
            del q, k, v, go
            torch.cuda.empty_cache()
    chosen = next((label for label, _, scheme in VARIANTS if scheme != 2 and worst[label] <= MARGIN),
                  None)
    print("worst relative norm over every product and case: " +
          "; ".join(f"{label} {w:.3e}" for label, w in worst.items()) +
          f"; cuBLAS f32 from float64 {worst_cublas:.3e}", flush=True)
    summary = dict(card=card, margin=MARGIN, f32_rel=F32_REL, worst=worst, worst_cublas=worst_cublas,
                   chosen=chosen, rna_sweep=sweep, rows=rows)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(summary, indent=1))
    print(f"chosen: {chosen or 'none: split TF32 is out, the pair stays on the FMA pipes'} "
          f"(worst at most {MARGIN:g}; written to {args.out})", flush=True)


if __name__ == "__main__":
    main()
