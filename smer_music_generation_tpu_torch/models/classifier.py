"""Encoder-only classifier (the auxiliary experiment model).

Port of ``smer_music_generation_tpu/models/classifier.py``
(``ClassifyTransformer`` :21): the shared embedding scaled by sqrt(d_model)
plus the sinusoidal positions, the position dropout, an encoder stack of the
port's ``EncoderLayer``, the optional final ``norm_e``, a masked mean over
time (denominator ``max(count, 1)``), an f32 128-d projection and
``n_heads_out`` binary heads, in JAX's order.  Dropout draws come from the
``torch.Generator`` the caller hands in, as in ``ScoreTransformer``.

The encoder runs the plain attention with a key mask, as JAX's does (it
passes no ``kv_valid_len``, so no kernel is on this path).  The module
names mirror the flax tree (``embedding``, ``encoder_{i}`` as
``encoder_layers.{i}``, ``norm_e``, ``project``, ``head_{i}``), so
:func:`classifier_params_from_flax` is ``train.state.params_from_flax``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from .transformer import Dense, EncoderLayer, LayerNorm, ModelConfig, dropout, sinusoidal_table


class ClassifyTransformer(nn.Module):
    def __init__(self, cfg: ModelConfig, hidden: int = 128, n_heads_out: int = 2,
                 n_classes: int = 2):
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Embedding(cfg.vocab_size, cfg.d_model)
        nn.init.xavier_normal_(self.embedding.weight)
        self.encoder_layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.num_encoder_layers))
        self.norm_e = LayerNorm(cfg.d_model) if cfg.final_norm else None
        self.project = Dense(cfg.d_model, hidden, torch.float32)
        self.n_heads_out = n_heads_out
        for i in range(n_heads_out):
            self.add_module(f"head_{i}", Dense(hidden, n_classes, torch.float32))
        self.register_buffer("pos_table", sinusoidal_table(cfg.max_len, cfg.d_model), persistent=False)

    def heads(self):
        return [getattr(self, f"head_{i}") for i in range(self.n_heads_out)]

    def forward(self, src: torch.Tensor, src_pad_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, ...]:
        """src (B, T) int; src_pad_mask (B, T) True = PAD.  Returns one
        (B, n_classes) f32 logit tensor a head."""
        c = self.cfg
        if not deterministic and generator is None and (c.dropout > 0 or c.pos_dropout > 0):
            raise ValueError("a train-mode pass needs a torch.Generator for its dropout draws")
        T = src.shape[-1]
        x = self.embedding.weight.to(c.dtype)[src] * math.sqrt(c.d_model)
        x = x + self.pos_table[:T].to(x.dtype)
        if not deterministic:
            x = dropout(x, c.pos_dropout, generator)
        mask = None if src_pad_mask is None else (~src_pad_mask)[:, None, None, :]
        for layer in self.encoder_layers:
            x = layer(x, mask, deterministic=deterministic, generator=generator)
        if self.norm_e is not None:
            x = self.norm_e(x)
        if src_pad_mask is not None:
            valid = (~src_pad_mask)[:, :, None].to(x.dtype)
            pooled = (x * valid).sum(dim=1) / torch.clamp(valid.sum(dim=1), min=1)
        else:
            pooled = x.mean(dim=1)
        h = self.project(pooled.float())
        return tuple(head(h) for head in self.heads())


def classifier_params_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX's classifier params (numpy leaves, ``{"params": ...}`` or the bare
    tree) -> a :class:`ClassifyTransformer` state dict: the
    ``ScoreTransformer`` mapping, since the names line up."""
    from ..train.state import params_from_flax

    return params_from_flax(tree)
