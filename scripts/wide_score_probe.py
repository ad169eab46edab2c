#!/usr/bin/env python3
"""How far the wide attention kernels' two orders of the scores differ, on
one CUDA card, at ``chip_smoke.WIDE_TIMED`` (B=8, H=2, T=S=640, head_dim 256).

    python3 scripts/wide_score_probe.py [--out build/wide_score_probe.json]

``wide_rows_kernel`` (and ``wide_fwd_kernel``, whose score sequence is the
same) sums s = q . k on the tensor cores, chunk after chunk of head_dim;
``wide_keys_kernel`` sums it on the FMA pipes, one FMA a head_dim in order.
The keys kernel reads m, l and delta that the rows kernel (MODE 1) or the
forward (MODE 2) wrote from their scores, and in MODE 1 rounds s to bf16
before it scales it.  Builds ``scripts/wide_score_probe.cu`` (which includes
``ops/csrc/attention_wide.cu`` for the kernels' own staging and score
steps) with nvcc into ``build/torch_kernels/``, takes both orders on
time_wide's seeded inputs (bf16 and f32), and prints one JSON line: the
pairs compared, how many bf16 roundings of s differ (bf16; over all pairs
and over the attendable ones), the largest |difference| and the largest
relative to the row's largest |s|.
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

from chip_smoke import WIDE_TIMED, flash_train_inputs  # noqa: E402
from smer_music_generation_tpu_torch.ops import decode_step as ds  # noqa: E402

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
        tc, fma = (torch.empty(B * H, T, S, dtype=torch.float32, device=dev) for _ in range(2))
        ds._check(lib.wide_score_probe(int(dtype == torch.bfloat16), B, T, S, H, D, q.data_ptr(),
                                       k.data_ptr(), tc.data_ptr(), fma.data_ptr(),
                                       torch.cuda.current_stream(dev).cuda_stream), "wide_score_probe")
        torch.cuda.synchronize()
        diff = (tc - fma).abs()
        row_max = fma.abs().amax(-1, keepdim=True).clamp(min=1e-30)
        ok = valid.bool()[:, None, None, :].expand(B, H, T, S).reshape(B * H, T, S)
        rec = dict(pairs=tc.numel(), attendable=int(ok.sum()), exact_equal=int((diff == 0).sum()),
                   max_abs=diff.max().item(), max_rel_to_row=(diff / row_max).max().item())
        if dtype == torch.bfloat16:
            differ = tc.to(torch.bfloat16) != fma.to(torch.bfloat16)
            rec.update(bf16_roundings_differ=int(differ.sum()),
                       bf16_roundings_differ_attendable=int((differ & ok).sum()))
        result[str(dtype).split(".")[-1]] = rec
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
