"""A frozen copy of the flax msgpack reader, so that the benchmark and its
plain reference read a committed snapshot without the program.

``flax.serialization.to_bytes`` writes nested maps whose leaves are msgpack
ext records of type 1 holding ``[shape, dtype name, raw C-order bytes]``.
:func:`read_flax_msgpack` decodes that subset with ``struct`` and numpy;
bf16 leaves come back as ``uint16`` arrays of the same bits.
:func:`state_from_flax` renames the tree into the plain reference's names
(``encoder_layers.{i}.self_attn.q.weight``) with every Dense kernel
transposed from flax's (in, out) to (out, in), all in f32.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np
import torch

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
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

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
    """A ``flax.serialization.to_bytes`` file as nested dicts of numpy
    arrays; bf16 leaves as ``uint16`` bit patterns."""
    with open(path, "rb") as fh:
        reader = _Reader(fh.read())
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    return tree


def state_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The flax params tree as the reference's f32 state: ``encoder_{i}``
    becomes ``encoder_layers.{i}``, ``scale`` and ``embedding`` become
    ``weight``, and each Dense ``kernel`` (in, out) a ``weight`` (out, in)."""
    params = tree["params"] if "params" in tree else tree
    out: Dict[str, torch.Tensor] = {}

    def leaf(a) -> torch.Tensor:
        a = np.array(a)
        if a.dtype == np.uint16:
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
            elif key == "kernel":
                out[prefix + "weight"] = leaf(val).t().contiguous()
            elif key in ("scale", "embedding"):
                out[prefix + "weight"] = leaf(val)
            else:
                out[prefix + key] = leaf(val)

    walk(params, "")
    return out
