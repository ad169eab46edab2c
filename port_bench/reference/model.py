"""The plain reference of the score transformer, its training loss and Adam,
in f32 with TF32 off.

An encoder-decoder of post-LN layers (Vaswani et al., "Attention is all you
need", 2017, with the LayerNorm after each residual sum): a shared
embedding scaled by sqrt(d_model) plus sinusoidal positions; encoder layers
of self-attention and a ReLU feed-forward; decoder layers of causal
self-attention, cross-attention over the encoder's output and the same
feed-forward; a LayerNorm after each stack (eps 1e-6, variance as
E[x^2] - E[x]^2); and the output projection.  Keys at padded positions take
no weight, and a query row with no key to attend gets none.

Training adds dropout at rate ``rate`` on the positions and on every
residual branch and feed-forward hidden layer (none on the attention
weights, as the flash training path has none).  Its uniforms come from the
generator handed in, one ``torch.rand`` of the tensor's shape per dropout,
in the order the model computes them: the source positions, then for each
encoder layer the attention branch, the hidden layer and the feed-forward
branch; the target positions, then for each decoder layer the
self-attention, the cross-attention, the hidden layer and the feed-forward
branch.  A kept value is divided by ``keep_scale`` (1 - rate, rounded to
the compute dtype as a weakly typed scalar is).

``quant="fp8"`` computes every matrix product, and in training each of its
gradients' products, in float8 e4m3 under one scale a tensor (its largest
magnitude to 448): its two operands and its result rounded to it.  That is
the precision below bf16 that a later change could be tempted by, used as
the control that the comparison has to fail.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

LN_EPS = 1e-6
NEG = torch.finfo(torch.float32).min
FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` of equal-rank operands computed in float8 e4m3: both operands
    and the product rounded to it, and its gradients the same way, as
    products of rounded operands rounded in turn (where the program holds
    a product's operands and result in bf16, the control holds them in
    float8)."""

    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = _fp8(a), _fp8(b)
        ctx.save_for_backward(a8, b8)
        return _fp8(a8 @ b8)

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = _fp8(g)
        return _fp8(g8 @ b8.transpose(-1, -2)), _fp8(a8.transpose(-1, -2) @ g8)


def sinusoid(n: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device) * (-math.log(10000.0) / d))
    pe = torch.zeros(n, d, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


class Reference:
    """The model over a state dict of f32 tensors (names as
    ``msgpack.state_from_flax`` gives them)."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: Dict, quant: str = "none"):
        self.p = params
        self.D, self.H = int(cfg["d_model"]), int(cfg["nhead"])
        self.n_enc, self.n_dec = int(cfg["num_encoder_layers"]), int(cfg["num_decoder_layers"])
        self.final_norm = bool(cfg.get("final_norm", True))
        self.quant = quant

    # -- pieces -----------------------------------------------------------
    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.quant == "fp8":
            return _Fp8Matmul.apply(x.reshape(-1, x.shape[-1]), w.t()).reshape(*x.shape[:-1], -1)
        return x @ w.t()

    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.mm(x, self.p[name + ".weight"]) + self.p[name + ".bias"]

    def norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp(min=0.0)
        return (x - mean) * torch.rsqrt(var + LN_EPS) * self.p[name + ".weight"] + self.p[name + ".bias"]

    def attention(self, name: str, x: torch.Tensor, kv: torch.Tensor, allow: torch.Tensor) -> torch.Tensor:
        """``allow`` (B, 1 or T, S) True where a query may attend a key."""
        B, T, D = x.shape
        S, H = kv.shape[1], self.H
        q = self.linear(name + ".q", x).reshape(B, T, H, D // H).transpose(1, 2)
        k = self.linear(name + ".k", kv).reshape(B, S, H, D // H).transpose(1, 2)
        v = self.linear(name + ".v", kv).reshape(B, S, H, D // H).transpose(1, 2)
        scores = self.mm_batched(q, k.transpose(-1, -2)) / math.sqrt(D // H)
        scores = torch.where(allow[:, None], scores, NEG)
        w = torch.softmax(scores, -1) * allow.any(-1, keepdim=True)[:, None]
        out = self.mm_batched(w, v).transpose(1, 2).reshape(B, T, D)
        return self.linear(name + ".out", out)

    def mm_batched(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _Fp8Matmul.apply(a, b) if self.quant == "fp8" else a @ b

    def ff(self, name: str, x: torch.Tensor, drop) -> torch.Tensor:
        return self.linear(name + ".fc2", drop(torch.relu(self.linear(name + ".fc1", x))))

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.p["embedding.weight"][tokens] * math.sqrt(self.D)
        return x + sinusoid(tokens.shape[1], self.D, tokens.device)

    # -- the model --------------------------------------------------------
    def encode(self, src: torch.Tensor, drop=None) -> torch.Tensor:
        """src (B, S), 0 = pad."""
        drop = drop or (lambda t: t)
        allow = (src != 0)[:, None, :]
        x = drop(self.embed(src))
        for i in range(self.n_enc):
            n = f"encoder_layers.{i}"
            x = self.norm(n + ".norm1", x + drop(self.attention(n + ".self_attn", x, x, allow)))
            x = self.norm(n + ".norm2", x + drop(self.ff(n + ".ff", x, drop)))
        return self.norm("norm_e", x) if self.final_norm else x

    def decode(self, tgt: torch.Tensor, memory: torch.Tensor, src: torch.Tensor,
               tgt_valid: Optional[torch.Tensor] = None, drop=None) -> torch.Tensor:
        """Teacher-forced logits (B, T, V) of the target stream ``tgt``."""
        drop = drop or (lambda t: t)
        T = tgt.shape[1]
        causal = torch.ones(T, T, dtype=torch.bool, device=tgt.device).tril()[None]
        self_allow = causal if tgt_valid is None else causal & tgt_valid[:, None, :]
        cross_allow = (src != 0)[:, None, :]
        x = drop(self.embed(tgt))
        for i in range(self.n_dec):
            n = f"decoder_layers.{i}"
            x = self.norm(n + ".norm1", x + drop(self.attention(n + ".self_attn", x, x, self_allow)))
            x = self.norm(n + ".norm2", x + drop(self.attention(n + ".cross_attn", x, memory, cross_allow)))
            x = self.norm(n + ".norm3", x + drop(self.ff(n + ".ff", x, drop)))
        if self.final_norm:
            x = self.norm("norm_d", x)
        return self.linear("fc", x)


def dropout_fn(generator: torch.Generator, rate: float, keep_scale: float):
    """The training dropout, drawing one uniform a value from ``generator``."""

    def drop(x: torch.Tensor) -> torch.Tensor:
        u = torch.rand(x.shape, generator=generator, device=x.device)
        return torch.where(u < 1.0 - rate, x / keep_scale, 0.0)

    return drop


def train_loss(ref: Reference, batch: Dict[str, torch.Tensor], scored: torch.Tensor, drop) -> torch.Tensor:
    """The mean negative log-likelihood over the targets the loss scores
    (``scored`` (V,) bool: all but pad, m_0 and unk), padded targets out."""
    src, tgt = batch["input"], batch["target_in"]
    src = torch.where(batch["input_pad_mask"], 0, src)
    memory = ref.encode(src, drop)
    logits = ref.decode(tgt, memory, src, ~batch["target_pad_mask"], drop)
    target = batch["target_out"]
    nll = -torch.log_softmax(logits, -1).gather(-1, target[..., None])[..., 0]
    weight = (scored[target] & ~batch["target_pad_mask"]).float()
    return (nll * weight).sum() / weight.sum().clamp(min=1e-8)


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected, no weight decay)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.lr, self.t = lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            params[k].sub_(self.lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + 1e-8))
