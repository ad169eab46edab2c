"""Checkpoints of the port's trainer, and the flax msgpack snapshot writer.

Port of ``smer_music_generation_tpu/train/checkpoint.py`` (all of it).  Orbax
becomes ``torch.save``/``torch.load``: a checkpoint is a directory
``checkpoint_<epoch>`` holding ``state.pt``, whose payload keeps JAX's
contract ``{params, opt_state, step, lr, epoch, loss}`` (``params`` the
model's state dict, ``opt_state`` the Adam optimizer's).

:func:`export_params_msgpack` writes the params-only bf16 snapshot in flax's
msgpack format (``flax.serialization.to_bytes``: nested maps whose leaves
are ext records of type 1 holding ``[shape, dtype name, raw C-order
bytes]``) with ``struct`` and numpy alone, plus the ``.json`` sidecar, so
the port's ``read_flax_msgpack`` and JAX's ``import_params_msgpack`` both
read it.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .state import TrainState, params_to_flax

STATE_FILE = "state.pt"


def save_checkpoint(directory: str, epoch: int, state: TrainState, loss: float,
                    full: Optional[Tuple[Dict[str, torch.Tensor], Dict[str, Any]]] = None) -> str:
    """Write ``<directory>/checkpoint_<epoch>/state.pt`` (JAX :28).  ``full``:
    the ``(params, opt_state)`` to write in place of the state's own, the
    full tensors a tensor-parallel state gathers
    (``parallel.tensor_parallel.full_train_state``)."""
    path = os.path.abspath(os.path.join(directory, f"checkpoint_{epoch}"))
    os.makedirs(path, exist_ok=True)
    params, opt_state = full if full is not None else (state.model.state_dict(),
                                                       state.optimizer.state_dict())
    payload = {
        "params": {k: v.detach().cpu() for k, v in params.items()},
        "opt_state": opt_state,
        "step": int(state.step),
        "lr": float(state.lr),
        "epoch": int(epoch),
        "loss": float(loss),
    }
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def is_checkpoint(path: str) -> bool:
    return os.path.isfile(os.path.join(path, STATE_FILE))


def _load(path: str) -> Dict[str, Any]:
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)


def checkpoint_has_final_norm(path: str) -> Optional[bool]:
    """Whether a saved checkpoint holds the final-LayerNorm parameters
    (``norm_e``/``norm_d``); None when it cannot be read (JAX :46)."""
    try:
        params = _load(path)["params"]
    except (OSError, RuntimeError, KeyError):
        return None
    return any(k.startswith(("norm_e.", "norm_d.")) for k in params)


def restore_checkpoint(path: str, state: TrainState) -> Tuple[TrainState, int, float]:
    """Restore into ``state``'s model and optimizer (JAX :66).  Raises a
    descriptive error when the checkpoint's ``final_norm`` layout disagrees
    with the model that built ``state``."""
    has_norm = checkpoint_has_final_norm(path)
    if has_norm is not None:
        state_has_norm = state.model.norm_e is not None
        if has_norm != state_has_norm:
            want = "final_norm=True" if has_norm else "final_norm=False"
            raise ValueError(
                f"checkpoint {path!r} was written with {want} but the model "
                f"was built with final_norm={state_has_norm}; rebuild the "
                f"model with ModelConfig({want}) (see "
                "checkpoint_has_final_norm) and restore again"
            )
    payload = _load(path)
    state.model.load_state_dict(payload["params"])
    state.optimizer.load_state_dict(payload["opt_state"])
    state.step = int(payload["step"])
    state.lr = float(payload["lr"])
    return state, int(payload["epoch"]), float(payload["loss"])


def restore_params_only(path: str) -> Tuple[Dict[str, torch.Tensor], int]:
    """Just ``(params, epoch)`` of a train checkpoint (JAX :105); the Adam
    moments are mapped from the file, not read."""
    payload = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                         weights_only=True, mmap=True)
    return payload["params"], int(payload["epoch"])


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    candidates = []
    for name in os.listdir(directory):
        if name.startswith("checkpoint_"):
            try:
                candidates.append((int(name.split("_")[-1]), name))
            except ValueError:
                continue
    if not candidates:
        return None
    return os.path.join(directory, max(candidates)[1])


# ----------------------------------------------------------------------
# the flax msgpack snapshot writer
# ----------------------------------------------------------------------
def _pack_uint(n: int) -> bytes:
    if n < 0x80:
        return struct.pack(">B", n)
    for tag, fmt, limit in ((0xCC, "B", 1 << 8), (0xCD, "H", 1 << 16), (0xCE, "I", 1 << 32)):
        if n < limit:
            return struct.pack(">B" + fmt, tag, n)
    return struct.pack(">BQ", 0xCF, n)


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    n = len(b)
    if n < 32:
        head = struct.pack(">B", 0xA0 | n)
    elif n < 1 << 8:
        head = struct.pack(">BB", 0xD9, n)
    elif n < 1 << 16:
        head = struct.pack(">BH", 0xDA, n)
    else:
        head = struct.pack(">BI", 0xDB, n)
    return head + b


def _pack_bin(b: bytes) -> bytes:
    n = len(b)
    if n < 1 << 8:
        return struct.pack(">BB", 0xC4, n) + b
    if n < 1 << 16:
        return struct.pack(">BH", 0xC5, n) + b
    return struct.pack(">BI", 0xC6, n) + b


def _pack_array_head(n: int) -> bytes:
    if n < 16:
        return struct.pack(">B", 0x90 | n)
    if n < 1 << 16:
        return struct.pack(">BH", 0xDC, n)
    return struct.pack(">BI", 0xDD, n)


def _pack_ext(code: int, data: bytes) -> bytes:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return struct.pack(">Bb", fixed[n], code) + data
    if n < 1 << 8:
        return struct.pack(">BBb", 0xC7, n, code) + data
    if n < 1 << 16:
        return struct.pack(">BHb", 0xC8, n, code) + data
    return struct.pack(">BIb", 0xC9, n, code) + data


def _pack_ndarray(a: np.ndarray, dtype_name: str) -> bytes:
    """flax's ndarray ext record: msgpack ``[shape, dtype name, bytes]``."""
    shape = _pack_array_head(len(a.shape)) + b"".join(_pack_uint(int(d)) for d in a.shape)
    body = _pack_array_head(3) + shape + _pack_str(dtype_name) + _pack_bin(
        np.ascontiguousarray(a).tobytes("C"))
    return _pack_ext(1, body)


def _pack_tree(node) -> bytes:
    if isinstance(node, dict):
        n = len(node)
        head = struct.pack(">B", 0x80 | n) if n < 16 else struct.pack(">BH", 0xDE, n)
        return head + b"".join(_pack_str(str(k)) + _pack_tree(v) for k, v in node.items())
    a = np.asarray(node)
    if a.dtype == np.float32:  # bf16 leaves: the round-to-nearest-even bits
        bits = torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).view(torch.int16)
        return _pack_ndarray(bits.numpy().view(np.uint16), "bfloat16")
    return _pack_ndarray(a, a.dtype.name)


def export_params_msgpack(path: str, params: Dict[str, torch.Tensor],
                          meta: Optional[dict] = None) -> str:
    """Write a params-only bf16 msgpack snapshot of a ``ScoreTransformer``
    state dict in flax's layout (JAX :145), and a ``<path>.json`` sidecar
    with ``meta`` when given.  Training cannot resume from it (no
    optimizer state)."""
    data = _pack_tree(params_to_flax(params))
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(data)
    if meta is not None:
        with open(path + ".json", "w") as fh:
            json.dump(meta, fh, indent=1, sort_keys=True)
    return path
