#!/usr/bin/env python3
"""How close split-TF32 products on the tensor cores come to f32, on one
CUDA card, at the f32 flash-train backward's five products, or (with
``--forward``) at the f32 attention forward.

    python3 scripts/f32_tc_probe.py [--out build/f32_tc_probe.json]
    python3 scripts/f32_tc_probe.py --forward [--out build/f32_tc_probe_forward.json]

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

With ``--forward`` it runs the port's own ``attn_f32_fwd_kernel`` at both
schemes of accumulating the output o over the keys, S = Q K^T and P V in
split TF32 either way: (a) one chain, o scaled by alpha between key tiles,
the port's library as built from ``ops/csrc/``; (b) each tile's P V into a
zeroed accumulator, then o = fma(o, alpha, pv): that source with the
``f32_fwd_scheme_b`` edit of ``scripts/flash_train_variants.py``, built as
that script builds it.  Cases: phase 2f's f32 cases (``ATTN_WIDE_CASES``:
B3 1536x1536 with key lengths 1536/1440/1344, and B3 1000x777 causal with a
batch row of no valid key; MODE 0, ``fused_attention``) and phase 2j's f32
cases (B8 640x640, 384x384 causal, 384x640, flash_train's key masks; MODE
1), each at head_dim 64 (H=8) and 128 (H=4).  Each output is read against the function in float64 and
against the port's twin (f32): its relative norm and its worst
``|out - ref| / (F32_ATOL + F32_RTOL |ref|)``.  The last line names the
cheaper scheme, (a) before (b), whose worst reading over every case and
both references is at most 0.25 of that bound and 2.5e-5 in relative norm;
or says that neither is.
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from chip_smoke import (ATTN_WIDE_CASES, F32_ATOL, F32_REL, F32_RTOL, FT_WIDE,  # noqa: E402
                        flash_train_inputs)
from smer_music_generation_tpu_torch.ops import attention as attn  # noqa: E402
from smer_music_generation_tpu_torch.ops import decode_step as ds  # noqa: E402
from smer_music_generation_tpu_torch.ops import flash_train as ft  # noqa: E402

SRC = Path(__file__).resolve().with_name("f32_tc_probe.cu")
MARGIN = 2.5e-5  # the chosen scheme's worst reading: F32_REL / 4
FWD_SHARE = 0.25  # the forward's chosen scheme: at most this share of F32_ATOL + F32_RTOL |ref|
FWD_SCHEMES = ("(a) one chain", "(b) tile apart, FMA")  # cheaper first
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


def forward_libs() -> tuple:
    """The forward's libraries at schemes (a) and (b): the port's own, and
    its source with the ``f32_fwd_scheme_b`` edit."""
    from flash_train_variants import F32_VARIANTS
    from flash_train_variants import build as build_variants
    return ds.load_library(), build_variants(["f32_fwd_scheme_b"], F32_VARIANTS,
                                             "attention_f32.cu")["f32_fwd_scheme_b"]


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


def forward_f64(q, k, v, keys, causal: bool, mode: int) -> torch.Tensor:
    """The forward's function in float64 from the f32 inputs: MODE 0
    ``fused_attention`` (keys = the key lengths; masked scores at -1e30, so
    a row with none valid weighs all keys alike), MODE 1 the library flash
    kernel (keys = the validity; -0.7 f32 max added, the key blocks a causal
    row does not visit left out)."""
    B, T, H, D = q.shape
    S = k.shape[1]
    s = torch.einsum("bthd,bshd->bhts", q.double(), k.double()) / math.sqrt(D)
    tril = torch.ones(T, S, dtype=torch.bool, device=q.device).tril()[None, None]
    if mode == 0:
        ok = (torch.arange(S, device=q.device)[None, :] < keys[:, None])[:, None, None, :]
        s = torch.where(ok & tril if causal else ok, s, attn.NEG_INF)
    else:
        ok = keys.bool()[:, None, None, :]
        s = s + torch.where(ok & tril if causal else ok, 0.0, ft.MASK_VALUE)
        if causal:
            blocks = (torch.arange(S, device=q.device)[None, :] // ft.BLOCK
                      > torch.arange(T, device=q.device)[:, None] // ft.BLOCK)
            s = s.masked_fill(blocks[None, None], -math.inf)
    return torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), v.double())


def readings(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """The relative norm of out - ref and the worst |out - ref| over the f32
    bound F32_ATOL + F32_RTOL |ref|."""
    ref = ref.double()
    share = ((out.double() - ref).abs() / (F32_ATOL + F32_RTOL * ref.abs())).max().item()
    return dict(rel=rel(out, ref), share=share)


def forward_cases(dev):
    """(label, mode, q, k, v, keys, causal) at phase 2f's and 2j's f32
    cases, head_dim 64 (H=8) and 128 (H=4), seeded."""
    g = torch.Generator(device=dev).manual_seed(9)
    for hd, heads in ((64, 8), (128, 4)):
        for B, T, S, lens, causal in ATTN_WIDE_CASES:
            q, k, v = (torch.randn(B, n, heads, hd, generator=g, device=dev) for n in (T, S, S))
            yield (f"MODE 0 hd {hd} B={B} T={T} S={S} lens={lens} causal={causal}", 0, q, k, v,
                   torch.tensor(lens, dtype=torch.int32, device=dev), causal)
    for hd, heads, dtype, cases, _ in FT_WIDE:
        if dtype != torch.float32:
            continue
        for T, S, causal in cases:
            q, k, v, _, valid = flash_train_inputs(g, dev, T, S, heads, hd, dtype)
            yield (f"MODE 1 hd {hd} B={q.shape[0]} T={T} S={S} causal={causal}", 1, q, k, v,
                   valid.to(torch.int32), causal)


def probe_forward(dev, stream, card: str, out_path: str) -> None:
    """The port's f32 forward at schemes (a) and (b) against float64 and the
    twin at every case; names the cheaper scheme within the margin."""
    libs = forward_libs()
    worst = {label: dict(rel=0.0, share=0.0) for label in FWD_SCHEMES}
    rows = []
    for label, mode, q, k, v, keys, causal in forward_cases(dev):
        B, T, H, D = q.shape
        S = k.shape[1]
        ref64 = forward_f64(q, k, v, keys, causal, mode)
        twin = (attn.attention_reference(q, k, v, keys, causal) if mode == 0 else
                ft.flash_train_fwd_reference(q, k, v, keys, causal)[0])
        row = dict(case=label, twin_vs_f64=readings(twin, ref64))
        for scheme, name in enumerate(FWD_SCHEMES):
            out = torch.empty_like(q)
            stats = torch.empty(2, B * H, T, device=dev)
            ds._check(libs[scheme].smer_attention_f32_fwd(
                mode, D, B, T, S, H, q.data_ptr(), k.data_ptr(), v.data_ptr(), keys.data_ptr(),
                int(causal), D ** -0.5, out.data_ptr(), stats.data_ptr(), stream),
                "smer_attention_f32_fwd")
            torch.cuda.synchronize()
            if not torch.isfinite(out).all().item():
                raise SystemExit(f"{label} {name}: the forward's output is not finite")
            row[name] = dict(vs_f64=readings(out, ref64), vs_twin=readings(out, twin))
            for r in row[name].values():
                worst[name] = {m: max(worst[name][m], r[m]) for m in ("rel", "share")}
        rows.append(row)
        print(f"{label}: twin from float64 rel {row['twin_vs_f64']['rel']:.3e}, share "
              f"{row['twin_vs_f64']['share']:.3f}; " +
              "; ".join(f"{n} rel {row[n]['vs_f64']['rel']:.3e} / {row[n]['vs_twin']['rel']:.3e}, "
                        f"share {row[n]['vs_f64']['share']:.3f} / {row[n]['vs_twin']['share']:.3f}"
                        for n in FWD_SCHEMES) + " (from float64 / from the twin)", flush=True)
        del q, k, v, ref64, twin
        torch.cuda.empty_cache()
    chosen = next((n for n in FWD_SCHEMES
                   if worst[n]["rel"] <= MARGIN and worst[n]["share"] <= FWD_SHARE), None)
    print("worst over every case and both references: " +
          "; ".join(f"{n} rel {w['rel']:.3e}, share {w['share']:.3f}" for n, w in worst.items()),
          flush=True)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(json.dumps(dict(card=card, margin=MARGIN, share=FWD_SHARE, worst=worst,
                                              chosen=chosen, rows=rows), indent=1))
    print(f"chosen: {chosen or 'none: the forward stays on the FMA pipes (Design B)'} (relative norm "
          f"at most {MARGIN:g}, share at most {FWD_SHARE:g}; written to {out_path})", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--forward", action="store_true",
                    help="the f32 attention forward's schemes instead of the backward's products")
    ap.add_argument("--out", default=None, help="where the readings go as JSON (default "
                    "build/f32_tc_probe.json, with --forward build/f32_tc_probe_forward.json)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("f32_tc_probe needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if args.forward:
        probe_forward(dev, stream, card, args.out or "build/f32_tc_probe_forward.json")
        return
    args.out = args.out or "build/f32_tc_probe.json"
    lib = build()
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
