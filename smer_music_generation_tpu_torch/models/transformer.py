"""PyTorch encoder-decoder for masked-span music infilling.

Port of ``smer_music_generation_tpu/models/transformer.py``: the shared
embedding scaled by sqrt(d_model), the sinusoidal positions (:128), post-LN
encoder and decoder layers with a ReLU FFN, the final ``norm_e``/``norm_d``,
the KV-cache decode path (``init_cross_cache`` :673, ``init_self_cache``
:680, ``decode_step`` :686, ``decode_window`` :730, the W-position cached
decode that speculative decode verifies with) and the training forward:
``encode`` (:560) and ``decode`` (:588) in train mode and ``forward``
(``__call__`` :659), which returns ``(logits, cross weights or None)``.

Training follows JAX op for op.  Dropout (``dropout``, ``pos_dropout``) sits
on the positions (``embed`` :537), the attention weights, the FFN's hidden
layer and every residual branch; its draws come from a ``torch.Generator``
the caller hands in, in place of flax's ``rngs={"dropout": ...}``, so the
streams differ from JAX's and runs replay only in the port.  A kept value
is divided by (1 - rate) rounded to the compute dtype, as flax's weakly
typed scalar is.  Under bf16 with key length <= 1024 the attention takes
JAX's custom-VJP paths as ``torch.autograd.Function``s
(:class:`SoftmaxBf16Residual` :146, :class:`AttnWeightsDropoutMatmul`
:168): the softmax VJP reads the bf16-rounded weights.
``fused_attn_train`` (:112) sends all three attentions of a layer through
``ops.train_attention.fused_dropout_attention`` behind JAX's gate
(``_fused_train_ok`` :545).  ``flash_training`` (:71) sends them through
``ops.flash_train.flash_train_attention`` (``attend_flash_vjp`` :360, the
port of the library flash kernel JAX calls there) wherever the lengths are
multiples of 128 (encoder :566-580, decoder :599-621), on deterministic
passes too, ahead of ``flash_encoder`` and ``fused_attn_train``: no
attention-weight dropout and no cross weights there.  ``remat`` (:121,
:515-522) runs each layer under ``torch.utils.checkpoint``, replaying the
layer's draws from the explicit generator in the recompute.

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
from torch.utils.checkpoint import checkpoint

LN_EPS = 1e-6
NEG = torch.finfo(torch.float32).min
# static key-length ceiling of the bf16 softmax residual (JAX :143)
BF16_RESIDUAL_MAX_KLEN = 1024
KERNEL_HEAD_DIM = 64  # the head_dim the CUDA attention kernels of flash_encoder and the training options take


def _kernel_device(t: torch.Tensor) -> bool:
    """Whether ``t`` lies where the attention options launch CUDA kernels
    (and not their CPU twins, which take any head_dim and dtype)."""
    return t.device.type == "cuda"


def check_kernel_domain(option: str, t: torch.Tensor, head_dim: int, dtype: torch.dtype) -> None:
    """Refuse, before any attention call, a model that sends its attention
    through ``option``'s CUDA kernels at a head_dim or dtype they do not
    take (bf16 and head_dim 64 only; JAX's kernels take any).  Decided from
    ``t``'s device at call time; the CPU twins are not gated."""
    if _kernel_device(t) and (head_dim != KERNEL_HEAD_DIM or dtype != torch.bfloat16):
        raise NotImplementedError(
            f"attention kernels on CUDA take bf16 and head_dim {KERNEL_HEAD_DIM} only: {option} "
            f"got head_dim {head_dim} and {dtype}; f32 and head_dim 128 are ROADMAP Queue 3 item 4")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int
    d_model: int = 512
    nhead: int = 8
    num_encoder_layers: int = 4
    num_decoder_layers: int = 4
    d_ff: int = 2048
    max_len: int = 2400
    dropout: float = 0.1
    pos_dropout: float = 0.1
    dtype: torch.dtype = torch.float32
    final_norm: bool = True
    # encoder self-attention through the flash kernel (ops/attention.py);
    # needs suffix padding, as the engine's bucketing gives
    flash_encoder: bool = False
    # all training attention through the port of JAX's library flash
    # kernel (ops/flash_train.py) where the lengths are multiples of 128
    flash_training: bool = False
    # the bf16 softmax residual (JAX :84): active under bf16 compute with
    # key length <= 1024; the gradient reads the bf16-rounded weights
    bf16_attn_residual: bool = True
    # softmax -> pad-row zero -> cast -> dropout -> V in one Function that
    # saves the bf16 weights and the bool keep mask (JAX :95)
    fused_attn_bwd: bool = True
    # all training attention through the hand-written dropout-attention
    # kernels (ops/train_attention.py) behind JAX's gate (JAX :112)
    fused_attn_train: bool = False
    # per-layer rematerialisation in the backward pass (torch.utils.checkpoint,
    # the explicit generator's draws replayed)
    remat: bool = False

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


def _scalar(x: float, dtype: torch.dtype) -> torch.Tensor:
    """A Python scalar in ``dtype``, as JAX's weak typing rounds it: a 0-dim
    CPU tensor, which a CUDA op reads as a scalar (a copy to the device
    would wait for the stream)."""
    return torch.tensor(x, dtype=dtype)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, kept values
    divided by (1 - rate) in x's dtype, dropped ones 0."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / _scalar(1.0 - rate, x.dtype), 0.0).to(x.dtype)


class SoftmaxBf16Residual(torch.autograd.Function):
    """``softmax(scores, -1)`` whose backward reads a bf16 copy of the
    output instead of the f32 original (JAX ``_softmax_bf16_residual``
    :146): the forward value is the plain f32 softmax."""

    @staticmethod
    def forward(ctx, scores):
        w = torch.softmax(scores, dim=-1)
        ctx.save_for_backward(w.to(torch.bfloat16))
        return w

    @staticmethod
    def backward(ctx, g):
        (w16,) = ctx.saved_tensors
        w = w16.float()
        return w * (g - (w * g).sum(dim=-1, keepdim=True))


class AttnWeightsDropoutMatmul(torch.autograd.Function):
    """softmax -> pad-row zero -> cast -> dropout -> V in one Function (JAX
    ``_attn_weights_dropout_matmul`` :168): returns (out (B, T, H, hd),
    dropped weights (B, H, T, S) in ``dtype``).  It saves the weights in
    ``dtype``, v and the caller's bool keep mask (JAX regenerates the mask
    from the saved key; the port keeps the mask, one byte an element); the
    backward rebuilds the dropped weights with one select and takes the
    softmax VJP on the ``dtype``-rounded weights.  ``any_valid`` is 0/1 f32
    (B, 1, T, 1) marking query rows with a key to attend."""

    @staticmethod
    def forward(ctx, scores, v, keep, any_valid, rate, dtype):
        w = (torch.softmax(scores, dim=-1) * any_valid).to(dtype)
        c = _scalar(1.0 - rate, dtype)
        wd = torch.where(keep, w / c, 0.0).to(dtype)
        out = torch.einsum("bhts,bshd->bthd", wd, v)
        ctx.save_for_backward(w, v, keep)
        ctx.rate = rate
        ctx.set_materialize_grads(False)
        return out, wd

    @staticmethod
    def backward(ctx, g, g_wd):
        w, v, keep = ctx.saved_tensors
        c = _scalar(1.0 - ctx.rate, w.dtype)
        wd = torch.where(keep, w / c, 0.0).to(w.dtype)
        dv = None
        dwd = None
        if g is not None:
            g = g.to(w.dtype)
            dv = torch.einsum("bhts,bthd->bshd", wd, g)
            dwd = torch.einsum("bthd,bshd->bhts", g, v)
        if g_wd is not None:
            dwd = g_wd.to(w.dtype) if dwd is None else dwd + g_wd.to(w.dtype)
        if dwd is None:
            return None, dv, None, None, None, None
        # dropout-where VJP in the weights' dtype, then the cast back to f32
        dw = torch.where(keep, dwd / c, 0.0).to(w.dtype).float()
        w32 = w.float()
        ds = w32 * (dw - (w32 * dw).sum(dim=-1, keepdim=True))
        return ds, dv, None, None, None, None


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

    def attend(
        self,
        q_in,
        k,
        v,
        mask: Optional[torch.Tensor],
        deterministic: bool = True,
        kv_valid: Optional[torch.Tensor] = None,
        causal: bool = False,
        fused_train: bool = False,
        generator: Optional[torch.Generator] = None,
        need_weights: bool = False,
    ):
        """q_in (B, T, D); k/v (B, S, H, hd); mask broadcastable to
        (B, H, T, S), True = attend (JAX :253).  Returns the output, or
        ``(out, head-averaged f32 weights)`` when ``need_weights``.  With
        ``fused_train`` (the caller checked the gate) the dropout-attention
        kernels run, with a seed drawn from ``generator``, and the weights
        are None."""
        c = self.cfg
        B, T, _ = q_in.shape
        q = self.q(q_in).reshape(B, T, c.nhead, c.head_dim)
        if fused_train and kv_valid is not None:
            from ..ops.train_attention import fused_dropout_attention

            # a raw two-word key, like flax's make_rng("dropout")
            seed = torch.randint(-(2**31), 2**31, (2,), generator=generator,
                                 device=q.device, dtype=torch.int32)
            out = fused_dropout_attention(q, k, v, kv_valid, seed, c.dropout, causal)
            out = self.out(out.reshape(B, T, c.d_model))
            return (out, None) if need_weights else out
        scores = torch.einsum("bthd,bshd->bhts", q, k).float() / math.sqrt(c.head_dim)
        if mask is not None:
            scores = torch.where(mask, scores, NEG)
        train_drop = c.dropout > 0.0 and not deterministic
        bf16_residual_ok = (c.bf16_attn_residual and c.dtype == torch.bfloat16
                            and scores.shape[-1] <= BF16_RESIDUAL_MAX_KLEN)
        if bf16_residual_ok and c.fused_attn_bwd and train_drop:
            if mask is not None:
                any_valid = mask.any(dim=-1, keepdim=True).float()
            else:
                any_valid = torch.ones(1, 1, 1, 1, device=scores.device)
            keep = torch.rand(scores.shape, generator=generator, device=scores.device) < 1.0 - c.dropout
            out, weights = AttnWeightsDropoutMatmul.apply(scores, v, keep, any_valid, c.dropout, c.dtype)
        else:
            weights = SoftmaxBf16Residual.apply(scores) if bf16_residual_ok else torch.softmax(scores, dim=-1)
            # fully-masked query rows (all-pad) produce uniform weights; zero them
            if mask is not None:
                weights = torch.where(mask.any(dim=-1, keepdim=True), weights, 0.0)
            weights = weights.to(c.dtype)
            if train_drop:
                weights = dropout(weights, c.dropout, generator)
            out = torch.einsum("bhts,bshd->bthd", weights, v)
        out = self.out(out.reshape(B, T, c.d_model))
        if need_weights:
            return out, weights.float().mean(dim=1)
        return out

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

    def attend_flash_vjp(self, q_in, kv_in, kv_valid: torch.Tensor, causal: bool) -> torch.Tensor:
        """Differentiable flash attention (JAX :360): only keys are masked
        (``kv_valid`` (B, S), True = real token), no weight dropout, no
        weights returned."""
        from ..ops.flash_train import flash_train_attention

        c = self.cfg
        B, T, _ = q_in.shape
        q = self.q(q_in).reshape(B, T, c.nhead, c.head_dim)
        k, v = self.project_kv(kv_in)
        out = flash_train_attention(q, k, v, kv_valid, causal)
        return self.out(out.reshape(B, T, c.d_model))


class FeedForward(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.rate = cfg.dropout
        self.fc1 = Dense(cfg.d_model, cfg.d_ff, cfg.dtype)
        self.fc2 = Dense(cfg.d_ff, cfg.d_model, cfg.dtype)

    def forward(self, x, deterministic: bool = True, generator: Optional[torch.Generator] = None):
        h = torch.relu(self.fc1(x))
        if not deterministic:
            h = dropout(h, self.rate, generator)
        return self.fc2(h)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.self_attn = MultiHeadAttention(cfg)
        self.ff = FeedForward(cfg)
        self.norm1 = LayerNorm(cfg.d_model)
        self.norm2 = LayerNorm(cfg.d_model)

        self.rate = cfg.dropout

    def forward(self, x, mask, kv_valid_len=None, deterministic: bool = True,
                fused_train: bool = False, kv_valid=None,
                generator: Optional[torch.Generator] = None, flash: bool = False):
        """JAX :423.  ``flash`` with ``kv_valid`` takes the flash training
        kernels; ``kv_valid_len`` (deterministic passes only) the flash
        encoder; ``fused_train`` with ``kv_valid`` the dropout kernels."""
        if flash:  # flash_training (JAX :431)
            attn_out = self.self_attn.attend_flash_vjp(x, x, kv_valid, causal=False)
        elif kv_valid_len is not None:  # flash_encoder (JAX :433)
            attn_out = self.self_attn.attend_flash(x, x, kv_valid_len)
        else:
            k, v = self.self_attn.project_kv(x)
            attn_out = self.self_attn.attend(
                x, k, v, mask, deterministic, kv_valid=kv_valid, causal=False,
                fused_train=fused_train, generator=generator,
            )
        if deterministic:
            x = self.norm1(x + attn_out)
            return self.norm2(x + self.ff(x))
        x = self.norm1(x + dropout(attn_out, self.rate, generator))
        return self.norm2(x + dropout(self.ff(x, False, generator), self.rate, generator))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.self_attn = MultiHeadAttention(cfg)
        self.cross_attn = MultiHeadAttention(cfg)
        self.ff = FeedForward(cfg)
        self.norm1 = LayerNorm(cfg.d_model)
        self.norm2 = LayerNorm(cfg.d_model)
        self.norm3 = LayerNorm(cfg.d_model)
        self.rate = cfg.dropout

    def forward(self, x, memory, self_mask, cross_mask, deterministic: bool = True,
                fused_train: bool = False, tgt_valid=None, mem_valid=None,
                generator: Optional[torch.Generator] = None, flash: bool = False):
        """JAX :460: returns (x, head-averaged cross weights or None).
        ``flash`` takes the flash training kernels for both attentions
        (JAX :466-472)."""
        def drop(t):
            return t if deterministic else dropout(t, self.rate, generator)

        if flash:
            attn_out = self.self_attn.attend_flash_vjp(x, x, tgt_valid, causal=True)
            x = self.norm1(x + drop(attn_out))
            cross_out = self.cross_attn.attend_flash_vjp(x, memory, mem_valid, causal=False)
            x = self.norm2(x + drop(cross_out))
            x = self.norm3(x + drop(self.ff(x, deterministic, generator)))
            return x, None
        k, v = self.self_attn.project_kv(x)
        attn_out = self.self_attn.attend(
            x, k, v, self_mask, deterministic, kv_valid=tgt_valid, causal=True,
            fused_train=fused_train, generator=generator,
        )
        x = self.norm1(x + drop(attn_out))
        ck, cv = self.cross_attn.project_kv(memory)
        cross_out, cross_weights = self.cross_attn.attend(
            x, ck, cv, cross_mask, deterministic, kv_valid=mem_valid, causal=False,
            fused_train=fused_train, generator=generator, need_weights=True,
        )
        x = self.norm2(x + drop(cross_out))
        x = self.norm3(x + drop(self.ff(x, deterministic, generator)))
        return x, cross_weights

    def decode_step(self, x, self_k, self_v, self_mask, cross_k, cross_v, cross_mask):
        x = self.norm1(x + self.self_attn.attend(x, self_k, self_v, self_mask))
        x = self.norm2(x + self.cross_attn.attend(x, cross_k, cross_v, cross_mask))
        return self.norm3(x + self.ff(x))


class ScoreTransformer(nn.Module):
    """Seq2seq infilling model: the training forward, the encoder and the
    cached decoder step."""

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

    def embed(self, tokens: torch.Tensor, deterministic: bool = True,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Embedding x sqrt(d_model) plus the positions, then the position
        dropout in train mode (JAX :537)."""
        x = self.embed_tokens(tokens)
        x = x + self.pos_table[: tokens.shape[-1]].to(x.dtype)
        if deterministic:
            return x
        return dropout(x, self.cfg.pos_dropout, generator)

    def _fused_train_ok(self, deterministic: bool, T: int, S: int) -> bool:
        """JAX's static gate of the dropout-attention kernels (:545)."""
        from ..ops.train_attention import DEFAULT_BLK_Q, MAX_KLEN

        c = self.cfg
        return (
            c.fused_attn_train
            and not deterministic
            and c.dropout > 0.0
            and c.dtype == torch.bfloat16
            and T % DEFAULT_BLK_Q == 0
            and S % 128 == 0
            and S <= MAX_KLEN
        )

    def _layer(self, layer, generator, *args, **kw):
        """``layer(*args, generator=generator, **kw)``; under ``remat`` with
        gradients on, through ``torch.utils.checkpoint`` (JAX's ``nn.remat``
        :515-522): the layer's activations are recomputed in the backward
        pass.  The checkpoint keeps the global RNG states only, so the
        recompute replays the layer's draws from the generator's state
        before the layer, then puts back the state the generator had, so
        that the draws after it are unchanged."""
        if not (self.cfg.remat and torch.is_grad_enabled()):
            return layer(*args, generator=generator, **kw)
        before = None if generator is None else generator.get_state()
        ran = []

        def run(*a, **k):
            if not ran or generator is None:
                ran.append(True)
                return layer(*a, generator=generator, **k)
            now = generator.get_state()
            generator.set_state(before)
            try:
                return layer(*a, generator=generator, **k)
            finally:
                generator.set_state(now)

        # draws come from the explicit generator alone: no global RNG to stash
        return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False, **kw)

    def _check_generator(self, deterministic: bool, generator) -> None:
        if not deterministic and generator is None and (self.cfg.dropout > 0 or self.cfg.pos_dropout > 0):
            raise ValueError("a train-mode pass needs a torch.Generator for its dropout draws")

    def encode(self, src: torch.Tensor, src_pad_mask: Optional[torch.Tensor] = None,
               deterministic: bool = True, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """src (B, S) int; src_pad_mask (B, S) True = PAD (JAX :560)."""
        self._check_generator(deterministic, generator)
        T = src.shape[-1]
        x = self.embed(src, deterministic, generator)
        mask = None if src_pad_mask is None else (~src_pad_mask)[:, None, None, :]
        # the flash training kernels take 128-multiple lengths (JAX :566-568),
        # on deterministic passes too, ahead of the other two paths
        flash = self.cfg.flash_training and T % 128 == 0
        fused_train = self._fused_train_ok(deterministic, T, T)
        kv_valid = None
        if flash or fused_train:
            kv_valid = (torch.ones(src.shape, dtype=torch.bool, device=src.device)
                        if src_pad_mask is None else ~src_pad_mask)
        kv_valid_len = None
        if self.cfg.flash_encoder and deterministic and not flash:  # the valid keys of a suffix-padded row
            kv_valid_len = (
                torch.full((src.shape[0],), T, dtype=torch.int32, device=src.device)
                if src_pad_mask is None else (~src_pad_mask).sum(dim=1).to(torch.int32)
            )
        # the path the layers take (flash, then the flash encoder, then the
        # dropout kernels), refused on CUDA where its kernels cannot run it
        option = ("flash_training" if flash else "flash_encoder" if kv_valid_len is not None
                  else "fused_attn_train" if fused_train else None)
        if option is not None:
            check_kernel_domain(option, x, self.cfg.head_dim, self.cfg.dtype)
        for layer in self.encoder_layers:
            x = self._layer(layer, generator, x, mask, kv_valid_len, deterministic, fused_train,
                            kv_valid, flash=flash)
        if self.norm_e is not None:
            x = self.norm_e(x)
        return x

    def decode(self, tgt: torch.Tensor, memory: torch.Tensor,
               tgt_pad_mask: Optional[torch.Tensor] = None,
               memory_pad_mask: Optional[torch.Tensor] = None,
               deterministic: bool = True, generator: Optional[torch.Generator] = None):
        """Teacher-forced decoder over the whole target (JAX :588).  Returns
        (logits (B, T, V) f32, cross weights (B, L, T, S) or None when the
        kernels ran)."""
        self._check_generator(deterministic, generator)
        B, T = tgt.shape
        x = self.embed(tgt, deterministic, generator)
        causal = torch.ones(T, T, dtype=torch.bool, device=tgt.device).tril()[None, None]
        self_mask = causal if tgt_pad_mask is None else causal & (~tgt_pad_mask)[:, None, None, :]
        cross_mask = None if memory_pad_mask is None else (~memory_pad_mask)[:, None, None, :]
        # the decoder layer sends both its attentions through the kernels,
        # so self (S = T) and cross (S = memory) must both pass the gate:
        # the flash training kernels' (JAX :599-603), on deterministic
        # passes too, ahead of the dropout kernels'
        flash = self.cfg.flash_training and T % 128 == 0 and memory.shape[1] % 128 == 0
        fused_train = not flash and (self._fused_train_ok(deterministic, T, T)
                                     and self._fused_train_ok(deterministic, T, memory.shape[1]))
        if flash or fused_train:
            check_kernel_domain("flash_training" if flash else "fused_attn_train", x,
                                self.cfg.head_dim, self.cfg.dtype)
        tgt_valid = mem_valid = None
        if flash or fused_train:
            tgt_valid = (torch.ones(B, T, dtype=torch.bool, device=tgt.device)
                         if tgt_pad_mask is None else ~tgt_pad_mask)
            mem_valid = (torch.ones(memory.shape[:2], dtype=torch.bool, device=tgt.device)
                         if memory_pad_mask is None else ~memory_pad_mask)
        weights = []
        for layer in self.decoder_layers:
            x, w = self._layer(layer, generator, x, memory, self_mask, cross_mask, deterministic,
                               fused_train, tgt_valid, mem_valid, flash=flash)
            weights.append(w)
        if self.norm_d is not None:
            x = self.norm_d(x)
        logits = self.fc(x.float())
        if any(w is None for w in weights):
            return logits, None
        return logits, torch.stack(weights, dim=1)

    def forward(self, src: torch.Tensor, tgt: torch.Tensor,
                src_pad_mask: Optional[torch.Tensor] = None,
                tgt_pad_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True, generator: Optional[torch.Generator] = None):
        """The training forward (JAX ``__call__`` :659): (logits, cross
        weights or None)."""
        memory = self.encode(src, src_pad_mask, deterministic, generator)
        return self.decode(tgt, memory, tgt_pad_mask, src_pad_mask, deterministic, generator)

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
