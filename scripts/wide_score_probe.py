#!/usr/bin/env python3
"""Whether the wide attention kernels' two orders of the scores agree, on one
CUDA card, at ``chip_smoke.WIDE_TIMED`` (B=8, H=2, T=S=640, head_dim 256).

    python3 scripts/wide_score_probe.py [--out build/wide_score_probe.json]

``wide_rows_kernel`` (and ``wide_fwd_kernel``, whose score sequence is the
same) sums s = Q K^T on the tensor cores, chunk after chunk of head_dim;
``wide_keys_kernel`` sums S^T = K Q^T in the same chunks and k steps, split
TF32's cross passes swapped so that each adds the same products.  Builds
``scripts/wide_score_probe.cu`` (which includes ``ops/csrc/attention_wide.cu``
for the kernels' own staging and score steps) with nvcc into
``build/torch_kernels/``, takes both orders on time_wide's seeded inputs
(bf16 and f32) and counts the scores that differ (bf16: also their bf16
roundings, which MODE 1 scales; over all pairs and the attendable ones),
with the largest |difference| and the largest relative to the row's largest
|s|.  Then the weights themselves, read out of the port's own wrappers at
head_dim 512 (B=2, H=2, T=S=256): q, k, v and g are [I | x] with x seeded,
so the scores are seeded and the first 256 columns of each output read one
weight each: dq[t, s] = ds[t, s] (``wide_rows_kernel``), dk[s, t] = ds[t, s]
and dv[s, t] = wd[t, s] (``wide_keys_kernel``), out[t, s] = wd[t, s]
(``wide_fwd_kernel``, MODE 1).  It counts the (t, s) where the two
backward kernels' ds differ (the dropout pair at rate 0.1, the flash pair in
bf16 and f32), and where the keys kernel's wd differs from the forward's.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import TA_SEEDS, WIDE_TIMED, flash_train_inputs  # noqa: E402
from smer_music_generation_tpu_torch.ops import decode_step as ds  # noqa: E402
from smer_music_generation_tpu_torch.ops import flash_train as ft  # noqa: E402
from smer_music_generation_tpu_torch.ops import train_attention as ta  # noqa: E402

SRC = Path(__file__).resolve().with_name("wide_score_probe.cu")


def build() -> ctypes.CDLL:
    out_dir = Path(ds._BUILD_DIR)
    out_dir.mkdir(parents=True, exist_ok=True)
    h = hashlib.sha256(SRC.read_bytes())
    h.update(ds.source_digest().encode())
    lib_path = out_dir / f"libwide_score_probe_{h.hexdigest()[:16]}.so"
    if not lib_path.is_file():
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        subprocess.run([ds._nvcc(), *ds.NVCC_FLAGS, "-I", str(ds._CSRC), "-shared", "-o", str(tmp),
                        str(SRC)], check=True)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.wide_score_probe.argtypes = [i, i, i, i, i, i, p, p, p, p, p]
    return lib


def readouts(dev) -> dict:
    """The (t, s) where the rows and keys kernels' ds differ, and the keys
    kernel's wd from the forward's (MODE 1), read out of [I | x] inputs."""
    B, H, T, D = 2, 2, 256, 512
    g = torch.Generator(device=dev).manual_seed(29)
    eye = torch.eye(T, device=dev)[None, :, None, :].expand(B, T, H, T)

    def mk(dtype):
        return torch.cat([eye, torch.randn(B, T, H, D - T, generator=g, device=dev)], -1).to(dtype).contiguous()

    valid = torch.ones(B, T, dtype=torch.int32, device=dev)
    seed = ta.seed_tensor(TA_SEEDS[1], dev)
    rows_of = lambda x: x[..., :T].permute(0, 2, 1, 3)  # (B, T, H, .) -> [b, h, t, s]  # noqa: E731
    keys_of = lambda x: x[..., :T].permute(0, 2, 3, 1)  # (B, S, H, .) -> [b, h, t, s]  # noqa: E731
    out = {}
    for tag, dtype in (("dropout bf16", torch.bfloat16), ("flash bf16", torch.bfloat16),
                       ("flash f32", torch.float32)):
        q, k, v, go = (mk(dtype) for _ in range(4))
        if tag.startswith("dropout"):
            o = ta.dropout_attention_fwd(q, k, v, valid, seed, 0.1, False)
            dq, dk, dv = ta.dropout_attention_bwd(q, k, v, valid, seed, go, 0.1, False)
            out["dropout bf16: wd, keys kernel vs forward"] = int((keys_of(dv) != rows_of(o)).sum())
        else:
            o, stats = ft.flash_train_fwd(q, k, v, valid, False)
            dq, dk, dv = ft.flash_train_bwd(q, k, v, valid, o, stats, go, False)
        out[f"{tag}: ds, keys kernel vs rows kernel"] = int((keys_of(dk) != rows_of(dq)).sum())
    out["pairs"] = B * H * T * T
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/wide_score_probe.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wide_score_probe: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    lib = build()
    B, T, S, H, D = WIDE_TIMED
    result = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                     capture_output=True, text=True).stdout.strip().splitlines()[0],
              "shape": dict(B=B, T=T, S=S, H=H, head_dim=D)}
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device=dev).manual_seed(23)  # time_wide's inputs
        q, k, _, _, valid = flash_train_inputs(g, dev, T, S, H, D, dtype=dtype)
        rows, keys = (torch.empty(B * H, T, S, dtype=torch.float32, device=dev) for _ in range(2))
        ds._check(lib.wide_score_probe(int(dtype == torch.bfloat16), B, T, S, H, D, q.data_ptr(),
                                       k.data_ptr(), rows.data_ptr(), keys.data_ptr(),
                                       torch.cuda.current_stream(dev).cuda_stream), "wide_score_probe")
        torch.cuda.synchronize()
        diff = (rows - keys).abs()
        row_max = rows.abs().amax(-1, keepdim=True).clamp(min=1e-30)
        ok = valid.bool()[:, None, None, :].expand(B, H, T, S).reshape(B * H, T, S)
        rec = dict(pairs=rows.numel(), attendable=int(ok.sum()), differ=int((diff != 0).sum()),
                   max_abs=diff.max().item(), max_rel_to_row=(diff / row_max).max().item())
        if dtype == torch.bfloat16:
            differ = rows.to(torch.bfloat16) != keys.to(torch.bfloat16)
            rec.update(bf16_roundings_differ=int(differ.sum()),
                       bf16_roundings_differ_attendable=int((differ & ok).sum()))
        result[str(dtype).split(".")[-1]] = rec
    result["readouts"] = readouts(dev)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
