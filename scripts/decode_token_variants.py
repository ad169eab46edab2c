#!/usr/bin/env python3
"""Write the design variants of the two ends of a decode token as checkouts
that ``scripts/torch_kernel_ab.py`` times in turns.

    python3 scripts/decode_token_variants.py [VARIANT ...]
    python scripts/torch_kernel_ab.py --decode build/parent . \\
        build/decode_token_variants/step1 build/decode_token_variants/step12 ...

Each variant is a copy of this checkout's ``smer_music_generation_tpu_torch``
under ``build/decode_token_variants/<name>/`` with text edits of the shipped
sources, each checked to apply, so the port carries no switch for a design
it did not keep.  The steps of the sampler's redesign
(``ops/csrc/decode_token.cu``), each measured against the one before:

- ``step1``: the short critical path alone: the sampler launched as a plain
  launch (no programmatic dependent launch) and no fold (``embed_pe_kernel``
  before every token, the sampler writing no input row);
- ``step12``: step 1 and the programmatic dependent launch, no fold.

The shipped checkout is all three steps.  With no argument it writes every
variant, and prints the roots it wrote.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = "smer_music_generation_tpu_torch"
OUT = ROOT / "build" / "decode_token_variants"

# (file under the package, old text, new text)
PLAIN_LAUNCH = [
    ("ops/csrc/decode_token.cu", "  cfg.numAttrs = 1;\n", "  cfg.numAttrs = 0;\n"),
]
NO_FOLD = [
    ("ops/decode_step.py",
     "    if embed_first:\n"
     "        _launch_embed_pe(lib, packed[\"emb\"], state, pos, x, stream=stream)\n"
     "    for t in range(1 if T is None else T):\n",
     "    for t in range(1 if T is None else T):\n"
     "        _launch_embed_pe(lib, packed[\"emb\"], state, pos, x, stream=stream, pos_offset=t)\n"),
    ("ops/decode_step.py",
     "                               out=out, emb=packed[\"emb\"], x=x, **skw)\n",
     "                               out=out, **skw)\n"),
]
VARIANTS = {
    "step1": PLAIN_LAUNCH + NO_FOLD,
    "step12": NO_FOLD,
}


def write(name: str) -> Path:
    """The variant's checkout: the package copied (no build output), then
    its edits applied; raises if an edit no longer applies."""
    root = OUT / name
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(ROOT / PKG, root / PKG, ignore=shutil.ignore_patterns("__pycache__"))
    for rel, old, new in VARIANTS[name]:
        path = root / PKG / rel
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: its edit of {rel} no longer applies: {old!r}")
        path.write_text(text.replace(old, new))
    return root


def main(argv) -> int:
    names = argv or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
    for name in names:
        print(write(name).relative_to(ROOT), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
