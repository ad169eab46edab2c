"""PyTorch encoder-decoder for masked-span music infilling (inference path).

Port of ``smer_music_generation_tpu/models/transformer.py``: the shared
embedding scaled by sqrt(d_model), the sinusoidal positions (:128), post-LN
encoder and decoder layers with a ReLU FFN, the final ``norm_e``/``norm_d``,
and the KV-cache decode path (``encode`` :560, ``init_cross_cache`` :673,
``init_self_cache`` :680, ``decode_step`` :686, ``decode_window`` :730, the
W-position cached decode that speculative decode verifies with).
``decode`` and the training paths are not ported yet (ROADMAP.md Queue 1
item 9).

Numerics follow the Flax model: parameters are held in f32 and every
projection runs in ``cfg.dtype`` (bf16 on the card), while softmax,
LayerNorm (eps 1e-6, Flax's mean-of-squares variance) and the output
projection run in f32.  Masked scores take ``finfo(f32).min`` and a query
row with no key to attend gets zero weights.

``ModelConfig.flash_encoder`` (JAX :59) sends the encoder's self-attention
through ``ops.attention.fused_attention`` (``attend_flash`` :349, the encoder
branch :433, ``kv_valid_len`` from the suffix padding :564-580): the CUDA
flash kernel on the card, its twin on the CPU.  As in JAX it is reached
through the config only.  The parameter names mirror
the Flax tree (``encoder_{i}`` becomes ``encoder_layers.{i}``) so that
``train.state.params_from_flax`` is a rename plus a transpose.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

LN_EPS = 1e-6
NEG = torch.finfo(torch.float32).min


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int
    d_model: int = 512
    nhead: int = 8
    num_encoder_layers: int = 4
    num_decoder_layers: int = 4
    d_ff: int = 2048
    max_len: int = 2400
    dtype: torch.dtype = torch.float32
    final_norm: bool = True
    # encoder self-attention through the flash kernel (ops/attention.py);
    # needs suffix padding, as the engine's bucketing gives
    flash_encoder: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.nhead


def sinusoidal_table(max_len: int, d_model: int, device=None) -> torch.Tensor:
    position = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
        * (-math.log(10000.0) / d_model)
    )
    pe = torch.zeros(max_len, d_model, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe


class Dense(nn.Linear):
    """``nn.Linear`` that computes in the model's dtype, as flax ``Dense(dtype=...)``."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype):
        super().__init__(d_in, d_out)
        self.compute_dtype = dtype
        nn.init.xavier_uniform_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(dtype=float32)``: var = E[x^2] - E[x]^2, eps 1e-6."""

    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + LN_EPS) * self.weight
        return (x - mean) * mul + self.bias


class MultiHeadAttention(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        D, dt = cfg.d_model, cfg.dtype
        self.q = Dense(D, D, dt)
        self.k = Dense(D, D, dt)
        self.v = Dense(D, D, dt)
        self.out = Dense(D, D, dt)

    def project_kv(self, kv_in: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, S, D) -> ((B, S, H, hd), (B, S, H, hd))."""
        c = self.cfg
        B, S, _ = kv_in.shape
        return (
            self.k(kv_in).reshape(B, S, c.nhead, c.head_dim),
            self.v(kv_in).reshape(B, S, c.nhead, c.head_dim),
        )

    def attend(self, q_in, k, v, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """q_in (B, T, D); k/v (B, S, H, hd); mask broadcastable to
        (B, H, T, S), True = attend."""
        c = self.cfg
        B, T, _ = q_in.shape
        q = self.q(q_in).reshape(B, T, c.nhead, c.head_dim)
        scores = torch.einsum("bthd,bshd->bhts", q, k).float() / math.sqrt(c.head_dim)
        if mask is not None:
            scores = torch.where(mask, scores, NEG)
        weights = torch.softmax(scores, dim=-1)
        if mask is not None:
            weights = torch.where(mask.any(dim=-1, keepdim=True), weights, 0.0)
        weights = weights.to(c.dtype)
        out = torch.einsum("bhts,bshd->bthd", weights, v).reshape(B, T, c.d_model)
        return self.out(out)

    def attend_flash(self, q_in, kv_in, kv_valid_len: torch.Tensor) -> torch.Tensor:
        """Self-attention through the flash kernel (JAX :349): keys at or
        past ``kv_valid_len[b]`` masked, no weights returned."""
        from ..ops.attention import fused_attention

        c = self.cfg
        B, T, _ = q_in.shape
        q = self.q(q_in).reshape(B, T, c.nhead, c.head_dim)
        k, v = self.project_kv(kv_in)
        out = fused_attention(q, k, v, kv_valid_len=kv_valid_len)
        return self.out(out.reshape(B, T, c.d_model))


class FeedForward(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.fc1 = Dense(cfg.d_model, cfg.d_ff, cfg.dtype)
        self.fc2 = Dense(cfg.d_ff, cfg.d_model, cfg.dtype)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.self_attn = MultiHeadAttention(cfg)
        self.ff = FeedForward(cfg)
        self.norm1 = LayerNorm(cfg.d_model)
        self.norm2 = LayerNorm(cfg.d_model)

    def forward(self, x, mask, kv_valid_len=None):
        if kv_valid_len is not None:  # flash_encoder (JAX :433)
            attn_out = self.self_attn.attend_flash(x, x, kv_valid_len)
        else:
            k, v = self.self_attn.project_kv(x)
            attn_out = self.self_attn.attend(x, k, v, mask)
        x = self.norm1(x + attn_out)
        return self.norm2(x + self.ff(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.self_attn = MultiHeadAttention(cfg)
        self.cross_attn = MultiHeadAttention(cfg)
        self.ff = FeedForward(cfg)
        self.norm1 = LayerNorm(cfg.d_model)
        self.norm2 = LayerNorm(cfg.d_model)
        self.norm3 = LayerNorm(cfg.d_model)

    def decode_step(self, x, self_k, self_v, self_mask, cross_k, cross_v, cross_mask):
        x = self.norm1(x + self.self_attn.attend(x, self_k, self_v, self_mask))
        x = self.norm2(x + self.cross_attn.attend(x, cross_k, cross_v, cross_mask))
        return self.norm3(x + self.ff(x))


class ScoreTransformer(nn.Module):
    """Seq2seq infilling model: the encoder and the cached decoder step."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Embedding(cfg.vocab_size, cfg.d_model)
        nn.init.xavier_normal_(self.embedding.weight)
        self.encoder_layers = nn.ModuleList(
            EncoderLayer(cfg) for _ in range(cfg.num_encoder_layers)
        )
        self.decoder_layers = nn.ModuleList(
            DecoderLayer(cfg) for _ in range(cfg.num_decoder_layers)
        )
        self.fc = nn.Linear(cfg.d_model, cfg.vocab_size)
        nn.init.xavier_uniform_(self.fc.weight)
        nn.init.zeros_(self.fc.bias)
        self.norm_e = LayerNorm(cfg.d_model) if cfg.final_norm else None
        self.norm_d = LayerNorm(cfg.d_model) if cfg.final_norm else None
        self.register_buffer(
            "pos_table", sinusoidal_table(cfg.max_len, cfg.d_model), persistent=False
        )

    @property
    def device(self) -> torch.device:
        return self.fc.weight.device

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        return self.embedding.weight.to(dt)[tokens] * math.sqrt(self.cfg.d_model)

    def encode(self, src: torch.Tensor, src_pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """src (B, S) int; src_pad_mask (B, S) True = PAD."""
        T = src.shape[-1]
        x = self.embed_tokens(src)
        x = x + self.pos_table[:T].to(x.dtype)
        mask = None if src_pad_mask is None else (~src_pad_mask)[:, None, None, :]
        kv_valid_len = None
        if self.cfg.flash_encoder:  # the valid keys of a suffix-padded row
            kv_valid_len = (
                torch.full((src.shape[0],), T, dtype=torch.int32, device=src.device)
                if src_pad_mask is None else (~src_pad_mask).sum(dim=1).to(torch.int32)
            )
        for layer in self.encoder_layers:
            x = layer(x, mask, kv_valid_len)
        if self.norm_e is not None:
            x = self.norm_e(x)
        return x

    def init_cross_cache(self, memory: torch.Tensor) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """Project encoder memory to per-layer cross K/V once per session."""
        return {
            f"layer_{i}": layer.cross_attn.project_kv(memory)
            for i, layer in enumerate(self.decoder_layers)
        }

    def init_self_cache(self, batch: int, max_len: int) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        c = self.cfg
        shape = (batch, max_len, c.nhead, c.head_dim)
        return {
            f"layer_{i}": (
                torch.zeros(shape, dtype=c.dtype, device=self.device),
                torch.zeros(shape, dtype=c.dtype, device=self.device),
            )
            for i in range(c.num_decoder_layers)
        }

    def decode_step(
        self,
        token: torch.Tensor,  # (B,) the token at position `index`
        index: int,
        self_cache: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
        cross_cache: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
        memory_pad_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """One autoregressive step; returns logits (B, V) f32.

        Unlike the JAX function, which returns an updated cache, the self
        cache is written in place at row ``index``."""
        x = self.embed_tokens(token[:, None])
        x = (x + self.pos_table[index : index + 1].to(x.dtype)).to(self.cfg.dtype)
        max_len = next(iter(self_cache.values()))[0].shape[1]
        self_mask = (torch.arange(max_len, device=x.device) <= index)[None, None, None, :]
        cross_mask = None
        if memory_pad_mask is not None:
            cross_mask = (~memory_pad_mask)[:, None, None, :]
        for i, layer in enumerate(self.decoder_layers):
            k_cache, v_cache = self_cache[f"layer_{i}"]
            k_new, v_new = layer.self_attn.project_kv(x)
            k_cache[:, index] = k_new[:, 0]
            v_cache[:, index] = v_new[:, 0]
            ck, cv = cross_cache[f"layer_{i}"]
            x = layer.decode_step(x, k_cache, v_cache, self_mask, ck, cv, cross_mask)
        if self.norm_d is not None:
            x = self.norm_d(x)
        return self.fc(x.float())[:, 0, :]

    def decode_window(
        self,
        tokens: torch.Tensor,  # (B, W) the tokens at positions index..index+W-1
        index: int,
        self_cache: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
        cross_cache: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
        memory_pad_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """W-position cached decode for draft verification (JAX :730);
        returns logits (B, W, V) f32.  Query row j (position index + j)
        attends cache positions <= index + j, so ``logits[:, j]`` is the
        next-token distribution after the prefix and ``tokens[:, :j + 1]``,
        as W sequential :meth:`decode_step` calls give it.  The K/V of all
        W positions are written into the cache in place; rows past an
        accepted prefix sit at positions the masks exclude until they are
        overwritten."""
        W = tokens.shape[1]
        # the embedding and the PE rows in one add, then the compute dtype
        x = self.embed_tokens(tokens)
        x = (x + self.pos_table[index : index + W].to(x.dtype)).to(self.cfg.dtype)
        max_len = next(iter(self_cache.values()))[0].shape[1]
        positions = torch.arange(max_len, device=x.device)[None, None, None, :]
        row_pos = index + torch.arange(W, device=x.device)[None, None, :, None]
        self_mask = positions <= row_pos  # (1, 1, W, max_len)
        cross_mask = None
        if memory_pad_mask is not None:
            cross_mask = (~memory_pad_mask)[:, None, None, :]
        for i, layer in enumerate(self.decoder_layers):
            k_cache, v_cache = self_cache[f"layer_{i}"]
            k_new, v_new = layer.self_attn.project_kv(x)
            k_cache[:, index : index + W] = k_new
            v_cache[:, index : index + W] = v_new
            ck, cv = cross_cache[f"layer_{i}"]
            x = layer.decode_step(x, k_cache, v_cache, self_mask, ck, cv, cross_mask)
        if self.norm_d is not None:
            x = self.norm_d(x)
        return self.fc(x.float())
