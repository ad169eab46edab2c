"""Weights for the PyTorch port: the committed flax snapshot, read without flax.

Port of the inference loaders of ``smer_music_generation_tpu/train/state.py``
(``default_flagship_snapshot`` and ``load_inference_model``, :227-290).  The
snapshot ``assets/flagship_params.msgpack`` is a flax msgpack file
(``flax.serialization.to_bytes``): nested maps whose leaves are msgpack ext
records of type 1 holding ``[shape, dtype name, raw C-order bytes]``.
:func:`read_flax_msgpack` decodes that format with ``struct`` and numpy
alone; bf16 leaves come back as ``uint16`` arrays of the same bits, which
``torch.from_numpy(a).view(torch.bfloat16)`` reinterprets.

Flax ``Dense.kernel`` is (in, out) and torch ``Linear.weight`` is
(out, in): :func:`params_from_flax` transposes once, at load, so the
modules hold torch's layout.  The decode-step packer transposes back to
the flax layout its kernels read (``ops/decode_step.py``).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models.transformer import ModelConfig, ScoreTransformer

BF16 = "bfloat16"


class _Reader:
    """A msgpack decoder for the subset flax writes: maps, arrays, str,
    bin, ext, nil, bools, ints and floats."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(">" + fmt, self.take(size))[0]

    def read(self):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.read_map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: ("bin", "B"), 0xC5: ("bin", "H"), 0xC6: ("bin", "I"),
            0xD9: ("str", "B"), 0xDA: ("str", "H"), 0xDB: ("str", "I"),
            0xDC: ("arr", "H"), 0xDD: ("arr", "I"),
            0xDE: ("map", "H"), 0xDF: ("map", "I"),
            0xC7: ("ext", "B"), 0xC8: ("ext", "H"), 0xC9: ("ext", "I"),
        }
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "arr":
                return [self.read() for _ in range(n)]
            if kind == "map":
                return self.read_map(n)
            return self.read_ext(self.unpack("b"), n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.read_ext(self.unpack("b"), fixext[b])
        scalars = {
            0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
            0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q",
        }
        if b in scalars:
            return self.unpack(scalars[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x} at {self.pos - 1}")

    def read_map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def read_ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code not in (1, 3):  # 1: ndarray, 3: numpy scalar
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype_name, buf = _Reader(payload).read()
        if isinstance(dtype_name, bytes):
            dtype_name = dtype_name.decode()
        dtype = np.dtype(np.uint16) if dtype_name == BF16 else np.dtype(dtype_name)
        arr = np.frombuffer(buf, dtype=dtype).reshape(shape)
        return arr if code == 1 else arr[()]


def read_flax_msgpack(path: str) -> Dict[str, Any]:
    """Decode a ``flax.serialization.to_bytes`` file into nested dicts of
    numpy arrays.  bf16 leaves are returned as ``uint16`` bit patterns."""
    with open(path, "rb") as fh:
        reader = _Reader(fh.read())
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    return tree


def params_from_flax(tree: Dict[str, Any], bf16_leaves_as_bits: bool = False) -> Dict[str, torch.Tensor]:
    """Flax params tree (numpy leaves) -> ``ScoreTransformer`` state dict (f32).

    Renames ``encoder_{i}``/``decoder_{i}`` to the ModuleLists' indices,
    ``scale`` to ``weight``, ``embedding.embedding`` to ``embedding.weight``,
    and transposes every Dense ``kernel`` (in, out) into a Linear ``weight``
    (out, in).  ``bf16_leaves_as_bits``: uint16 leaves are bf16 bit
    patterns, as :func:`read_flax_msgpack` returns them."""
    p = tree["params"] if "params" in tree else tree
    out: Dict[str, torch.Tensor] = {}

    def leaf(a) -> torch.Tensor:
        a = np.array(a)  # a writable copy
        if bf16_leaves_as_bits and a.dtype == np.uint16:
            return torch.from_numpy(a).view(torch.bfloat16).float()
        return torch.from_numpy(a.astype(np.float32))

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict):
                name = key
                for stack in ("encoder", "decoder"):
                    if key.startswith(stack + "_"):
                        name = f"{stack}_layers.{key.split('_')[1]}"
                walk(val, f"{prefix}{name}.")
                continue
            if key == "kernel":
                out[prefix + "weight"] = leaf(val).t().contiguous()
            elif key == "scale":
                out[prefix + "weight"] = leaf(val)
            elif key == "embedding":
                out[prefix + "weight"] = leaf(val)
            else:
                out[prefix + key] = leaf(val)

    walk(p, "")
    return out


def default_flagship_snapshot() -> str | None:
    """Path of the committed trained-flagship snapshot, if it exists."""
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "assets", "flagship_params.msgpack",
    )
    return path if os.path.isfile(path) else None


def check_sidecar(meta: Dict[str, Any], vocab_size: int, vocab_mode: int, path: str = "") -> None:
    """Raise when the snapshot's sidecar disagrees with the port's vocab."""
    for key, want in (("vocab_size", vocab_size), ("vocab_mode", vocab_mode)):
        if key in meta and int(meta[key]) != int(want):
            raise ValueError(
                f"snapshot {path} was trained with {key}={meta[key]}, but the "
                f"vocab built here has {key}={want}; pass the matching --config "
                "or '--checkpoint random'"
            )


def build_model(vocab_size: int, cfg, dtype: torch.dtype, final_norm: bool = True) -> ScoreTransformer:
    """The flagship architecture from an ``ExperimentConfig``."""
    return ScoreTransformer(ModelConfig(
        vocab_size=vocab_size, d_model=cfg.d_model, nhead=cfg.nhead,
        num_encoder_layers=cfg.num_layers, num_decoder_layers=cfg.num_layers,
        d_ff=cfg.d_ff, max_len=cfg.max_seq, dtype=dtype, final_norm=final_norm,
    ))


def load_inference_model(
    cfg, vocab_size: int, checkpoint: str | None, dtype: torch.dtype,
    device="cuda", seed: int = 0,
) -> Tuple[ScoreTransformer, int]:
    """Build the model and restore a ``.msgpack`` snapshot into it.

    ``checkpoint`` None gives random weights from ``seed``.  Orbax run
    directories are not read by the port (they need orbax); export them
    with ``scripts/export_params.py`` first.  Returns ``(model, epoch)``;
    epoch is -1 without a checkpoint."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    meta: Dict[str, Any] = {}
    if checkpoint:
        if not os.path.isfile(checkpoint):
            raise ValueError(
                f"{checkpoint}: the port reads params-only .msgpack snapshots; "
                "export an orbax run with scripts/export_params.py"
            )
        sidecar = checkpoint + ".json"
        if os.path.isfile(sidecar):
            with open(sidecar) as fh:
                meta = json.load(fh)
            check_sidecar(meta, vocab_size, cfg.vocab_mode, checkpoint)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_model(
            vocab_size, cfg, dtype, final_norm=bool(meta.get("final_norm", True))
        )
    epoch = -1
    if checkpoint:
        state = params_from_flax(read_flax_msgpack(checkpoint), bf16_leaves_as_bits=True)
        model.load_state_dict(state)
        epoch = int(meta.get("epoch", -1))
    return model.to(device).eval().requires_grad_(False), epoch
