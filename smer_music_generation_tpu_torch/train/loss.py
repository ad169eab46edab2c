"""Fused multi-head weighted cross-entropy and per-class accuracy.

Port of ``smer_music_generation_tpu/train/loss.py`` (all of it).  The
reference's 7 + k cross-entropy heads cover disjoint token-class ranges, so
their sum is ONE weighted cross-entropy whose per-token weight is the sum of
the heads' weights at the target:

    total = sum_t nll_t * W[target_t] / sum_t ce_all[target_t]

and the per-head scalars are segment sums of the same ``nll`` vector grouped
by target class.  The tables are numpy arrays, as in JAX; the functions copy
them to the logits' device once and keep the copies in the table dict.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..vocab import WordVocab

# head order mirrors the reference criteria list (train.py:602) + controls
BASE_HEADS = ("meta", "structure", "time_signature", "tempo", "program", "pitch", "duration")
CONTROL_HEAD_ORDER = ("key", "tensile", "density", "polyphony", "occupation")


def build_loss_tables(
    vocab: WordVocab, head_scales: Dict[str, float] | None = None
) -> Dict[str, np.ndarray]:
    """Precompute the (H, V) head-weight matrix and helpers (JAX :33).

    * ``head_weights[h, v]`` = 1 where vocab index v belongs to head h
      (meta = the eos index only);
    * ``ce_all`` = 1 everywhere except 0 at pad/mask/unk (the eos slot is
      patched at run time with the eos weight);
    * ``class_ids`` = token-class id per vocab index for accuracy grouping.

    ``head_scales``: optional per-head loss multipliers (e.g.
    ``{"tensile": 3.0}``).
    """
    V = vocab.vocab_size
    heads: List[str] = list(BASE_HEADS) + [
        name for name in CONTROL_HEAD_ORDER if name in vocab.control_indices
    ]
    H = len(heads)
    head_weights = np.zeros((H, V), dtype=np.float32)
    head_index = {name: i for i, name in enumerate(heads)}

    head_weights[head_index["meta"], vocab.eos_index] = 1.0
    head_weights[head_index["structure"], 3:7] = 1.0
    head_weights[head_index["time_signature"], 7:11] = 1.0
    head_weights[head_index["tempo"], 11:18] = 1.0
    head_weights[head_index["program"], 18:146] = 1.0
    head_weights[head_index["pitch"], 146:234] = 1.0
    head_weights[head_index["duration"], 234 : 234 + len(vocab.duration_indices)] = 1.0
    for name in CONTROL_HEAD_ORDER:
        if name in vocab.control_indices:
            idxs = vocab.control_indices[name]
            head_weights[head_index[name], idxs[0] : idxs[-1] + 1] = 1.0

    if head_scales:
        unknown = set(head_scales) - set(heads)
        if unknown:
            raise ValueError(f"head_scales for absent heads: {sorted(unknown)}")
        for name, scale in head_scales.items():
            head_weights[head_index[name]] *= float(scale)

    ce_all = np.ones(V, dtype=np.float32)
    ce_all[vocab.pad_index] = 0.0
    ce_all[vocab.mask_indices[0]] = 0.0
    ce_all[vocab.unk_index] = 0.0

    eos_onehot = np.zeros(V, dtype=np.float32)
    eos_onehot[vocab.eos_index] = 1.0

    n_classes = len(vocab.class_id_names)
    return {
        "heads": heads,
        "head_weights": head_weights,
        "ce_all": ce_all,
        "eos_onehot": eos_onehot,
        "class_ids": vocab.token_class_ids.astype(np.int32),
        "n_classes": n_classes,
        "class_names": vocab.class_id_names,
        "pad_index": vocab.pad_index,
    }


def _on(tables: Dict, name: str, device) -> torch.Tensor:
    """``tables[name]`` as a tensor on ``device``, copied once and kept."""
    key = ("_device", name, str(device))
    if key not in tables:
        tables[key] = torch.as_tensor(tables[name]).to(device)
    return tables[key]


def multihead_ce(
    logits: torch.Tensor,  # (B, T, V) f32
    targets: torch.Tensor,  # (B, T) int
    tables: Dict,
    eos_weight: float | torch.Tensor = 1.0,
    sum_denom=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Fused loss (JAX :98); returns (total, per-head scalars dict).
    ``sum_denom``: under data parallelism, sums the denominator over the
    batch shards in place, so that each shard's loss is its share of the
    global batch's loss (JAX's ``sum / denom`` over the global batch)."""
    dev = logits.device
    head_weights = _on(tables, "head_weights", dev)  # (H, V)
    ce_all = _on(tables, "ce_all", dev)
    eos_onehot = _on(tables, "eos_onehot", dev)

    # run-time eos weighting: the meta head scales its eos slot; ce_all too
    hw = torch.cat([head_weights[:1] * eos_weight, head_weights[1:]])
    ce = ce_all * (1.0 - eos_onehot) + eos_onehot * eos_weight

    V = logits.shape[-1]
    flat_logits = logits.reshape(-1, V)
    flat_targets = targets.reshape(-1).long()

    logp = torch.log_softmax(flat_logits, dim=-1)
    nll = -torch.gather(logp, 1, flat_targets[:, None])[:, 0]
    # torch CrossEntropyLoss(ignore_index=0): pad targets contribute nothing
    not_pad = flat_targets != tables["pad_index"]
    nll = torch.where(not_pad, nll, 0.0)

    denom = torch.where(not_pad, ce[flat_targets], 0.0).sum()
    if sum_denom is not None:
        denom = sum_denom(denom)
    denom = torch.clamp(denom, min=1e-8)

    target_head_w = hw.t()[flat_targets]  # (N, H)
    head_losses = (target_head_w * nll[:, None]).sum(dim=0) / denom  # (H,)
    total = head_losses.sum()

    per_head = {name: head_losses[i] for i, name in enumerate(tables["heads"])}
    return total, per_head


def soft_label_weights(
    vocab_size: int,
    target_index_range: Tuple[int, int],
    distance: str = "medium",
) -> np.ndarray:
    """Ordinal soft-label matrix over a contiguous token range (JAX :135):
    softmax over the negative pairwise distances of the in-range ordinal
    positions (|d| for 'small', d^2 for 'medium', 2 d^2 for 'large')."""
    lo, hi = target_index_range
    n = hi - lo + 1
    idx = np.arange(n, dtype=np.float64)
    diff = idx[:, None] - idx[None, :]
    if distance == "small":
        phi = np.abs(diff)
    elif distance == "large":
        phi = 2 * np.square(diff)
    else:
        phi = np.square(diff)
    w = np.exp(-phi)
    w = w / w.sum(axis=0, keepdims=True)
    out = np.zeros((vocab_size, vocab_size), dtype=np.float32)
    out[lo : hi + 1, lo : hi + 1] = w
    return out


def ordinal_loss(logits: torch.Tensor, targets: torch.Tensor, weights: np.ndarray) -> torch.Tensor:
    """Mean soft-label cross entropy (JAX :164)."""
    logp = torch.log_softmax(logits.reshape(-1, logits.shape[-1]), dim=-1)
    target_w = torch.as_tensor(weights).to(logits.device)[targets.reshape(-1).long()]
    return (-target_w * logp).sum(dim=1).mean()


def per_class_accuracy(
    logits: torch.Tensor, targets: torch.Tensor, tables: Dict
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vectorized per-class accuracy (JAX :175).

    Returns (correct_per_class, count_per_class, total_correct,
    total_count); pad targets are excluded.  Class ids follow
    ``tables['class_names']``.
    """
    class_ids = _on(tables, "class_ids", logits.device).long()
    n_classes = tables["n_classes"]
    pred = logits.argmax(dim=-1).reshape(-1)
    tgt = targets.reshape(-1).long()
    valid = tgt != tables["pad_index"]
    correct = (pred == tgt) & valid
    tgt_class = class_ids[tgt]
    # tokens whose class id is -1 (pad) route to a scratch bin
    tgt_class = torch.where(valid & (tgt_class >= 0), tgt_class, n_classes)
    correct_pc = torch.zeros(n_classes + 1, device=logits.device).index_add_(
        0, tgt_class, correct.float())[:-1]
    count_pc = torch.zeros(n_classes + 1, device=logits.device).index_add_(
        0, tgt_class, torch.ones_like(tgt, dtype=torch.float32))[:-1]
    return correct_pc, count_pc, correct.sum(), valid.sum()
