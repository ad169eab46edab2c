"""Train state, train and eval steps, the plateau schedule, and the weights:
the committed flax snapshot, read without flax, and the port's checkpoints.

Port of ``smer_music_generation_tpu/train/state.py``: ``TrainState`` (:29),
``make_optimizer`` (:46), ``make_train_step`` (:55), ``make_eval_step``
(:135), ``PlateauScheduler`` (:160), ``build_model`` (:189),
``default_flagship_snapshot`` and ``load_inference_model`` (:227-304).

The step runs eagerly: the model holds the f32 parameters, the optimizer
is ``torch.optim.Adam`` with optax's ``scale_by_adam`` defaults (b1 0.9, b2
0.999, eps 1e-8, no eps_root, no weight decay), its learning rate set from
the state before every step, and the update is made in place.  Dropout draws
come from the ``torch.Generator`` handed to the step.

The snapshot ``assets/flagship_params.msgpack`` is a flax msgpack file
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

import dataclasses
import json
import os
import re
import struct
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.transformer import ModelConfig, ScoreTransformer
from .loss import multihead_ce, per_class_accuracy

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


def params_to_flax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of :func:`params_from_flax`: a ``ScoreTransformer`` state dict
    -> the flax params tree ``{"params": ...}`` of f32 numpy arrays, each
    Linear ``weight`` (out, in) transposed back to a Dense ``kernel`` (in,
    out)."""
    tree: Dict[str, Any] = {}
    for name, t in state.items():
        parts = name.split(".")
        if parts[0] in ("encoder_layers", "decoder_layers"):
            parts = [f"{parts[0].split('_')[0]}_{parts[1]}"] + parts[2:]
        a = t.detach().cpu().float().numpy()
        last = parts[-1]
        if parts[0] == "embedding":
            last = "embedding"
        elif last == "weight" and a.ndim == 2:
            last, a = "kernel", np.ascontiguousarray(a.T)
        elif last == "weight":
            last = "scale"
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[last] = a
    return {"params": tree}


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


def build_model(
    vocab_size: int,
    d_model: int = 512,
    nhead: int = 8,
    num_layers: int = 4,
    d_ff: int = 2048,
    max_len: int = 2400,
    dropout: float = 0.1,
    dtype: torch.dtype = torch.float32,
    flash_training: bool = False,
    final_norm: bool = True,
    remat: bool = False,
    bf16_attn_residual: bool = True,
    fused_attn_bwd: bool = True,
    fused_attn_train: bool = False,
) -> ScoreTransformer:
    """The flagship config (reference ``config/config.yaml:26-43``)."""
    return ScoreTransformer(ModelConfig(
        vocab_size=vocab_size, d_model=d_model, nhead=nhead,
        num_encoder_layers=num_layers, num_decoder_layers=num_layers, d_ff=d_ff,
        max_len=max_len, dropout=dropout, pos_dropout=dropout, dtype=dtype,
        flash_training=flash_training, final_norm=final_norm, remat=remat,
        bf16_attn_residual=bf16_attn_residual, fused_attn_bwd=fused_attn_bwd,
        fused_attn_train=fused_attn_train,
    ))


def load_inference_model(
    cfg, vocab_size: int, checkpoint: str | None, dtype: torch.dtype,
    device="cuda", seed: int = 0,
) -> Tuple[ScoreTransformer, int]:
    """Build the model and restore ``checkpoint`` into it.

    ``checkpoint`` is a ``.msgpack`` snapshot (a file) or a checkpoint
    directory the port's trainer wrote (``train/checkpoint.py``); None gives
    random weights from ``seed``.  Orbax run directories are not read by the
    port (they need orbax); export them with ``scripts/export_params.py``
    first.  The ``final_norm`` layout comes from the snapshot's sidecar or
    the checkpoint's parameters.  Returns ``(model, epoch)``; epoch is -1
    without a checkpoint."""
    from . import checkpoint as ckpt

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    meta: Dict[str, Any] = {}
    final_norm = True
    if checkpoint and os.path.isdir(checkpoint):
        if not ckpt.is_checkpoint(checkpoint):
            raise ValueError(
                f"{checkpoint}: not a checkpoint of the port's trainer; the port reads "
                "those and params-only .msgpack snapshots (export an orbax run with "
                "scripts/export_params.py)"
            )
        final_norm = ckpt.checkpoint_has_final_norm(checkpoint)
    elif checkpoint:
        if not os.path.isfile(checkpoint):
            raise ValueError(
                f"{checkpoint}: the port reads params-only .msgpack snapshots and its "
                "own checkpoint directories; export an orbax run with scripts/export_params.py"
            )
        sidecar = checkpoint + ".json"
        if os.path.isfile(sidecar):
            with open(sidecar) as fh:
                meta = json.load(fh)
            check_sidecar(meta, vocab_size, cfg.vocab_mode, checkpoint)
        final_norm = bool(meta.get("final_norm", True))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_model(
            vocab_size, d_model=cfg.d_model, nhead=cfg.nhead, num_layers=cfg.num_layers,
            d_ff=cfg.d_ff, max_len=cfg.max_seq, dropout=0.0, dtype=dtype,
            final_norm=final_norm,
        )
    epoch = -1
    if checkpoint and os.path.isdir(checkpoint):
        params, epoch = ckpt.restore_params_only(checkpoint)
        model.load_state_dict(params)
    elif checkpoint:
        state = params_from_flax(read_flax_msgpack(checkpoint), bf16_leaves_as_bits=True)
        model.load_state_dict(state)
        epoch = int(meta.get("epoch", -1))
    return model.to(device).eval().requires_grad_(False), epoch


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------
def make_optimizer(params) -> torch.optim.Adam:
    """Adam with optax's ``scale_by_adam`` defaults; the learning rate is
    set from the state before each step (JAX injects it the same way)."""
    return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)


@dataclasses.dataclass
class TrainState:
    """JAX's ``TrainState`` (:29): the model holds the parameters, the
    optimizer their Adam moments; ``step`` counts updates, ``lr`` is the
    learning rate the next step applies."""

    model: ScoreTransformer
    optimizer: torch.optim.Adam
    step: int = 0
    lr: float = 1e-4
    # set by parallel.tensor_parallel.shard_train_state: each parameter's
    # spec, the tp-sharded parameters, and the column-parallel biases
    # whose gradient each tp rank holds a slice of
    specs: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    sharded: Tuple[str, ...] = ()
    tp_partial: Tuple[str, ...] = ()

    @classmethod
    def create(cls, model: ScoreTransformer, lr: float) -> "TrainState":
        return cls(model=model, optimizer=make_optimizer(model.parameters()), step=0, lr=float(lr))


def module_name(param_name: str) -> str:
    """A parameter's top-level flax module: ``encoder_layers.0.x`` ->
    ``encoder_0``, ``fc.weight`` -> ``fc``."""
    m = re.match(r"(encoder|decoder)_layers\.(\d+)\.", param_name)
    return f"{m.group(1)}_{m.group(2)}" if m else param_name.split(".")[0]


def _norms(named, state: "TrainState", ctx, prefix: str) -> Dict[str, torch.Tensor]:
    """The global L2 norm of the (name, tensor) pairs in f32 and each
    module's, from every tensor's own norm (summed over tp where the tensor
    is tp-sharded): ``{prefix_norm, prefix/<module>...}``."""
    from ..parallel.tensor_parallel import leaf_norms

    norms = leaf_norms(named, state.sharded, ctx)
    groups: Dict[str, list] = {}
    for (name, _), n in zip(named, norms):
        groups.setdefault(module_name(name), []).append(n)
    out = {f"{prefix}_norm": torch.stack(norms).norm()}
    out.update({f"{prefix}/{k}": torch.stack(v).norm() for k, v in groups.items()})
    return out


def _forward_batch(model: ScoreTransformer, batch: Dict[str, torch.Tensor], deterministic: bool,
                   generator: Optional[torch.Generator]):
    return model(
        batch["input"], batch["target_in"], src_pad_mask=batch["input_pad_mask"],
        tgt_pad_mask=batch["target_pad_mask"], deterministic=deterministic,
        generator=generator,
    )


class StepSkipped(Exception):
    """A train step failed before the optimizer touched the parameters (in
    the forward, the loss, the backward or the gradient norm): the
    gradients are cleared and the parameters, the optimizer's moments and
    ``state.step`` are as they were before the batch.  ``__cause__`` is the
    error.  The trainer skips such a batch, as JAX's ``train_epoch`` does
    (JAX ``train/loop.py:248-268``)."""


def make_train_step(
    model: ScoreTransformer,
    tables: Dict,
    dropout: bool = True,
    with_metrics: bool = True,
) -> Callable:
    """Returns ``step(state, batch, eos_weight, generator) -> (state,
    metrics)`` (JAX :55); the parameters and the optimizer are updated in
    place and ``metrics`` holds device tensors.  ``with_metrics=False`` is
    the lean variant (``gated_metrics``): the same update, and only the
    loss and the global gradient norm.  An error before the update raises
    :class:`StepSkipped` with the state untouched; one from the update on
    propagates as it is.

    Under sharded training (the model's ``shard`` set by
    ``parallel.tensor_parallel.shard_train_state``) the batch holds this
    rank's rows: the loss divides by the global denominator, the gradients
    are summed over the batch shards (and the column-parallel biases' over
    tp) before the update, the norms are global, and the loss and the
    accuracy counts are summed over the shards."""

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor], eos_weight, generator):
        ctx = model.shard
        named = [(n, p) for n, p in model.named_parameters()]
        metrics: Dict[str, Any] = {}
        try:
            if with_metrics:
                with torch.no_grad():
                    pn = _norms([(n, p.detach()) for n, p in named], state, ctx, "pnorm")
                    metrics["param_norm"] = pn.pop("pnorm_norm")
                    metrics.update(pn)
            logits, _ = _forward_batch(model, batch, not dropout, generator)
            total, per_head = multihead_ce(logits, batch["target_out"], tables, eos_weight,
                                           sum_denom=None if ctx is None else ctx.sum_rows_)
            state.optimizer.zero_grad(set_to_none=True)
            total.backward()
            if ctx is not None:
                from ..parallel.tensor_parallel import sync_grads_

                sync_grads_(state, ctx)
            grads = [(n, p.grad) for n, p in named if p.grad is not None]
            with torch.no_grad():
                gn = _norms(grads, state, ctx, "gnorm")
                metrics["grad_norm"] = gn.pop("gnorm_norm")
                if with_metrics:
                    metrics.update(gn)
        except Exception as exc:
            state.optimizer.zero_grad(set_to_none=True)
            raise StepSkipped(str(exc)) from exc
        for group in state.optimizer.param_groups:
            group["lr"] = state.lr
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            summed = _summed_metrics(ctx, logits.detach(), batch, tables, total.detach(),
                                     {k: v.detach() for k, v in per_head.items()}, with_metrics)
        metrics["loss"] = summed["loss"]
        if with_metrics:
            metrics.update(summed)
        return state, metrics

    return step_fn


def make_eval_step(model: ScoreTransformer, tables: Dict) -> Callable:
    """Returns ``eval(batch, eos_weight) -> metrics`` (JAX :135), a
    deterministic pass without gradients."""

    @torch.no_grad()
    def eval_fn(batch: Dict[str, torch.Tensor], eos_weight):
        ctx = model.shard
        logits, _ = _forward_batch(model, batch, True, None)
        total, per_head = multihead_ce(logits, batch["target_out"], tables, eos_weight,
                                       sum_denom=None if ctx is None else ctx.sum_rows_)
        return _summed_metrics(ctx, logits, batch, tables, total, per_head, True)

    return eval_fn


def _summed_metrics(ctx, logits, batch, tables, total, per_head, with_accuracy: bool):
    """The loss, the per-head losses and (``with_accuracy``) the accuracy
    counts of a step, each summed over the batch shards when ``ctx`` shards
    the rows (each shard's loss is its share of the global loss)."""
    if ctx is None:
        out = {"loss": total, **{f"loss/{k}": v for k, v in per_head.items()}}
        if with_accuracy:
            correct_pc, count_pc, total_correct, total_count = per_class_accuracy(
                logits, batch["target_out"], tables)
            out.update({"accuracy": total_correct / torch.clamp(total_count, min=1),
                        "correct_per_class": correct_pc, "count_per_class": count_pc})
        return out
    names = list(per_head)
    losses = ctx.sum_rows_(torch.stack([total] + [per_head[k] for k in names]))
    out = {"loss": losses[0], **{f"loss/{k}": losses[i + 1] for i, k in enumerate(names)}}
    if with_accuracy:
        correct_pc, count_pc, total_correct, total_count = per_class_accuracy(
            logits, batch["target_out"], tables)
        n = correct_pc.shape[0]
        acc = ctx.sum_rows_(torch.cat([correct_pc, count_pc,
                                       torch.stack([total_correct, total_count]).float()]))
        out.update({"accuracy": acc[2 * n] / torch.clamp(acc[2 * n + 1], min=1),
                    "correct_per_class": acc[:n], "count_per_class": acc[n : 2 * n]})
    return out


@dataclasses.dataclass
class PlateauScheduler:
    """Host-side ReduceLROnPlateau (patience 2, x0.5, min 1e-7; JAX :160).

    ``threshold`` is torch's default rel-mode threshold (1e-4): an epoch
    only counts as an improvement when loss < best * (1 - threshold).
    """

    patience: int = 2
    factor: float = 0.5
    min_lr: float = 1e-7
    threshold: float = 1e-4
    best: float = float("inf")
    bad_epochs: int = 0

    def update(self, lr: float, epoch_loss: float) -> float:
        if epoch_loss < self.best * (1.0 - self.threshold):
            self.best = epoch_loss
            self.bad_epochs = 0
            return lr
        self.bad_epochs += 1
        if self.bad_epochs > self.patience:
            self.bad_epochs = 0
            return max(lr * self.factor, self.min_lr)
        return lr
