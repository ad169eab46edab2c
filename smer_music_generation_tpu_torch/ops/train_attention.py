"""Training attention with weight dropout: scores -> softmax -> dropout -> V,
through hand-written CUDA forward and backward kernels, each beside its plain
twin, joined by a ``torch.autograd.Function``.

Port of ``smer_music_generation_tpu/ops/train_attention.py``: the counter-hash
dropout (``_keep_threshold`` :65, ``_seed_words`` :70, ``_fmix32`` :77,
``_hash_keep`` :87), the test oracles ``dropout_mask_reference`` (:380) and
``attention_dropout_twin`` (:402), and the TPU kernel
``fused_dropout_attention`` (:316) with its forward ``_fwd_kernel`` (:111) and
its recomputing backward ``_bwd_kernel`` (:163), which become
``train_fwd_kernel``, ``train_bwd_rows_kernel`` and ``train_bwd_keys_kernel``
in ``csrc/train_attention.cu``.

``fused_dropout_attention(q, k, v, kv_valid, seed, rate, causal=False)`` takes
(B, T, H, D) bf16 queries and (B, S, H, D) bf16 keys and values (on the card
64 and 128 as they are, others up to 128 zero-padded to the next of them by
``attention.kernel_width``, and every D above 128 zero-padded to a multiple
of 64 for ``wide_fwd_kernel``, ``wide_rows_kernel`` and ``wide_keys_kernel``
of ``csrc/attention_wide.cu``, ``ops/attention_wide.py``), a (B, S)
key-validity mask (True = attendable) and the seed, and returns (B, T, H, D)
in q's dtype, as JAX's does.  ``seed`` is the four uint32 words of
``_seed_words`` or a raw two-word key, padded the same way, as a sequence of
ints or an integer tensor of bit patterns.  The forward saves q, k, v, the
mask and the seed words, and no O(T*S) tensor; the backward recomputes the
weights, regenerates the keep mask from the seed and returns dq, dk and dv in
the input dtype.

A tensor on the CPU goes to the twins (:func:`dropout_attention_fwd_reference`,
:func:`dropout_attention_bwd_reference`); a CUDA tensor launches the kernels
or raises.  The kernels are built with the decode kernels into one library at
first use (``ops.decode_step.load_library``).  The hash is plain uint32
arithmetic: here it runs on uint32 values held in int64 and masked to 32 bits
after every multiply and add, in the CUDA source on ``uint32_t``, so the two
and JAX's ``dropout_mask_reference`` agree bit for bit.  The kernels take the
scale 1/sqrt(D) from here.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import attention, attention_wide as aw
from .attention import KERNEL_HEAD_DIMS, kernel_width, pad_head
from .decode_step import _check, _check_tensors, load_library

NEG_INF = -1e30
DEFAULT_BLK_Q = 128
# the static gate of the TPU kernel, kept as JAX keeps it
# (models/transformer._fused_train_ok): the key length fits one block
MAX_KLEN = 1024
_M32 = 0xFFFFFFFF

Seed = Union[torch.Tensor, Sequence[int], np.ndarray]


def bf16_round(x: float) -> float:
    """A Python float rounded to the nearest bf16 value (ties to even)."""
    return float(torch.tensor(x, dtype=torch.float32).to(torch.bfloat16).float())


def keep_threshold(rate: float) -> int:
    """uint32 threshold t with P(bits < t) = 1 - rate, computed in double
    on the host (JAX :65)."""
    return int(min(round((1.0 - rate) * 2**32), 2**32 - 1))


def seed_words(seed: Seed) -> Tuple[int, int, int, int]:
    """A raw uint32 key (any length) -> its first four words as uint32 ints,
    zero-padded (JAX ``_seed_words`` :70, which keeps the bit patterns)."""
    if isinstance(seed, torch.Tensor):
        seed = seed.detach().cpu().reshape(-1).tolist()
    words = [int(w) & _M32 for w in np.asarray(seed).reshape(-1).tolist()]
    words = (words + [0, 0, 0, 0])[:4]
    return tuple(words)


def seed_tensor(seed: Seed, device) -> torch.Tensor:
    """The four seed words as a (4,) int32 tensor of their bit patterns on
    ``device``, the layout the kernels read.  A tensor already on the
    device stays there (no host round trip)."""
    if isinstance(seed, torch.Tensor) and seed.device == torch.device(device):
        if seed.dtype == torch.int32 and seed.dim() == 1 and seed.numel() <= 4:
            return torch.nn.functional.pad(seed, (0, 4 - seed.numel())) if seed.numel() < 4 else seed
        s = seed.reshape(-1)[:4].to(torch.int64) & _M32
        if s.numel() < 4:
            s = torch.cat([s, s.new_zeros(4 - s.numel())])
        return torch.where(s >= 2**31, s - 2**32, s).to(torch.int32)
    words = [w - 2**32 if w >= 2**31 else w for w in seed_words(seed)]
    return torch.tensor(words, dtype=torch.int32, device=device)


def dropout_mask_reference(seed: Seed, B: int, H: int, T: int, S: int, rate: float,
                           device=None, b0: int = 0, h0: int = 0,
                           H_global: Optional[int] = None) -> torch.Tensor:
    """The exact keep mask the kernels generate, as (B, H, T, S) bool (JAX
    :380, ``_hash_keep`` :87): keep where
    ``fmix32(fmix32(h ^ s1) + s0) < keep_threshold(rate)`` with
    ``h = (s0 + row * 0x9E3779B1) ^ (col * 0x85EBCA77) + bh * 0xC2B2AE3D``
    over the ABSOLUTE query row, ``bh = b * H + h``, ``s0 = w0 ^ w2`` and
    ``s1 = w1 ^ w3``.  ``b`` and ``h`` are global: a shard of the batch and
    the heads (rows from ``b0``, heads from ``h0`` of ``H_global``, by
    default the unsharded 0, 0, H) gets its slice of the unsharded mask.  Every product of two uint32 values is below 2^64,
    but int64 holds 2^63 at most: each multiply takes one factor's low and
    high 16 bits apart so no product leaves int64, then masks to 32 bits."""
    w = seed_words(seed)
    s0, s1 = w[0] ^ w[2], w[1] ^ w[3]
    rows = torch.arange(T, dtype=torch.int64, device=device)[None, :, None]
    cols = torch.arange(S, dtype=torch.int64, device=device)[None, None, :]
    Hg = H if H_global is None else H_global
    bs = torch.arange(b0, b0 + B, dtype=torch.int64, device=device)[:, None]
    hs = torch.arange(h0, h0 + H, dtype=torch.int64, device=device)[None, :]
    bhs = (bs * Hg + hs).reshape(-1)[:, None, None]
    h = (s0 + _mul32(rows, 0x9E3779B1)) & _M32
    h = h ^ _mul32(cols, 0x85EBCA77)
    h = (h + _mul32(bhs, 0xC2B2AE3D)) & _M32
    h = _fmix32(h ^ s1)
    h = _fmix32((h + s0) & _M32)
    return (h < keep_threshold(rate)).reshape(B, H, T, S)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for uint32 x held in int64 and a uint32 constant,
    without an int64 overflow: x * c_lo and x * c_hi each stay below 2^48."""
    lo = (x * (c & 0xFFFF)) & _M32
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64 (JAX :77)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _weights(q, k, kv_valid, causal, scale=None):
    """The f32 softmax weights of the kernels' math: scores as the f32
    product of q and k rounded to bf16, times ``scale`` (1/sqrt(D) by
    default); invalid keys (and causal ones) at -1e30; ``e = exp(s - m) *
    mask``, ``w = e / max(l, 1e-30)``, so a row with no valid key has
    all-zero weights.  Returns (w (B, H, T, S) f32, scale)."""
    B, T, H, D = q.shape
    S = k.shape[1]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    s = s.to(torch.bfloat16).float() * scale
    mask = kv_valid.to(torch.bool)[:, None, None, :].expand(B, H, T, S)
    if causal:
        cm = torch.ones(T, S, dtype=torch.bool, device=q.device).tril()
        mask = mask & cm[None, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m) * mask.float()
    l = e.sum(dim=-1, keepdim=True)
    return e / torch.clamp(l, min=1e-30), scale


def _dropped(w16: torch.Tensor, keep, rate: float) -> torch.Tensor:
    """bf16 weights after dropout: kept ones divided by bf16(1 - rate) and
    rounded to bf16, the rest 0."""
    if rate <= 0.0:
        return w16
    c = bf16_round(1.0 - rate)
    return torch.where(keep, (w16.float() / c).to(torch.bfloat16), torch.zeros_like(w16))


def attention_dropout_twin(q, k, v, kv_valid, keep_mask, rate: float, causal: bool = False,
                           scale=None):
    """Plain torch twin with an EXPLICIT keep mask (JAX :402): op for op the
    kernel math (bf16 score rounding, f32 softmax, bf16 dropout, f32
    V-accumulate); (B, T, H, D) in q's dtype."""
    w, _ = _weights(q, k, kv_valid, causal, scale)
    wd16 = _dropped(w.to(torch.bfloat16), keep_mask, rate)
    out = torch.einsum("bhts,bshd->bthd", wd16.float(), v.float())
    return out.to(q.dtype)


def dropout_attention_fwd_reference(q, k, v, kv_valid, seed: Seed, rate: float,
                                    causal: bool = False, shard=(0, 0, None),
                                    scale=None) -> torch.Tensor:
    """Twin of the forward kernel: the keep mask from
    :func:`dropout_mask_reference` (``shard`` its ``(b0, h0, H_global)``),
    then :func:`attention_dropout_twin` (``scale`` 1/sqrt(D) by default)."""
    dropout_attention_fwd_reference.calls += 1
    B, T, H, _ = q.shape
    keep = (dropout_mask_reference(seed, B, H, T, k.shape[1], rate, q.device, *shard)
            if rate > 0.0 else None)
    return attention_dropout_twin(q, k, v, kv_valid, keep, rate, causal, scale)


dropout_attention_fwd_reference.calls = 0


def dropout_attention_bwd_reference(q, k, v, kv_valid, seed: Seed, g, rate: float,
                                    causal: bool = False, shard=(0, 0, None), scale=None):
    """Twin of the backward kernels: the explicit math of JAX's
    ``_bwd_kernel`` (:163-244) over all query rows at once, not autograd
    through the forward.  ``g`` is rounded to q's dtype first (JAX :363).
    Then ``dv = wd16^T g``; ``dw = keep ? (g v^T) / bf16(1 - rate) : 0`` in
    f32; ``ds = bf16(w (dw - sum_s w dw) * scale)`` from the f32 w;
    ``dq = ds k``, ``dk = ds^T q``, all accumulated in f32.  Returns (dq,
    dk, dv) in the inputs' dtypes."""
    dropout_attention_bwd_reference.calls += 1
    B, T, H, _ = q.shape
    S = k.shape[1]
    g = g.to(q.dtype).float()
    w, scale = _weights(q, k, kv_valid, causal, scale)
    keep = (dropout_mask_reference(seed, B, H, T, S, rate, q.device, *shard)
            if rate > 0.0 else None)
    wd16 = _dropped(w.to(torch.bfloat16), keep, rate)
    dv = torch.einsum("bhts,bthd->bshd", wd16.float(), g)
    dwd = torch.einsum("bthd,bshd->bhts", g, v.float())
    dw = torch.where(keep, dwd / bf16_round(1.0 - rate), 0.0) if rate > 0.0 else dwd
    ds = w * (dw - (w * dw).sum(dim=-1, keepdim=True))
    ds16 = (ds * scale).to(torch.bfloat16).float()
    dq = torch.einsum("bhts,bshd->bthd", ds16, k.float())
    dk = torch.einsum("bhts,bthd->bshd", ds16, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


dropout_attention_bwd_reference.calls = 0


def _check_klen(S: int) -> None:
    if not 1 <= S <= MAX_KLEN:
        raise ValueError(f"the CUDA train-attention kernels take 1 <= S <= {MAX_KLEN}, got S={S}")


def _check_inputs(q, k, v, kv_valid, *extra):
    """What the kernels take (after padding): bf16, head_dim in
    KERNEL_HEAD_DIMS, S <= MAX_KLEN, contiguous."""
    B, T, H, D = q.shape
    S = k.shape[1]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA train-attention kernels take head_dim {KERNEL_HEAD_DIMS}, got {D}")
    _check_klen(S)
    bf16 = torch.bfloat16
    want = {"q": (q, bf16, (B, T, H, D)), "k": (k, bf16, (B, S, H, D)),
            "v": (v, bf16, (B, S, H, D)), "kv_valid": (kv_valid, torch.int32, (B, S))}
    for name, t in extra:
        want[name] = (t, bf16, (B, T, H, D))
    _check_tensors(q.device, want)
    return B, T, H, S


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _shard_args(shard, H: int) -> Tuple[int, int, int]:
    """``(b0, h0, H_global)`` with the unsharded default H_global = H."""
    b0, h0, Hg = shard
    Hg = H if Hg is None else int(Hg)
    if b0 < 0 or h0 < 0 or h0 + H > Hg:
        raise ValueError(f"shard (b0={b0}, h0={h0}, H_global={Hg}) does not hold {H} heads")
    return int(b0), int(h0), Hg


def dropout_attention_fwd(q, k, v, kv_valid, seed: Seed, rate: float,
                          causal: bool = False, shard=(0, 0, None)) -> torch.Tensor:
    """The forward: the twin for CPU tensors, ``train_fwd_kernel`` for CUDA
    ones (bf16, head_dim 64 or 128, contiguous, S <= 1024; above 128
    ``wide_fwd_kernel``) or an error.  ``shard`` = ``(b0, h0, H_global)``
    places the keep hash's (b, h)."""
    if attention.twin_device(q, "fused_dropout_attention"):
        return dropout_attention_fwd_reference(q, k, v, kv_valid, seed, rate, causal, shard)
    hd = q.shape[3]
    D = kernel_width(hd)  # a narrower head zero-padded; the hash reads no head_dim
    q, k, v = (pad_head(t, D) for t in (q, k, v))
    valid = kv_valid.to(torch.int32).contiguous()
    if aw.is_wide(D):
        _check_klen(k.shape[1])
        out = aw.dropout_fwd_wide(q, k, v, valid, seed_tensor(seed, q.device), keep_threshold(rate),
                                  rate > 0.0, bf16_round(1.0 - rate), causal,
                                  _shard_args(shard, q.shape[2]), 1.0 / math.sqrt(hd))
        return out if D == hd else out[..., :hd].contiguous()
    B, T, H, S = _check_inputs(q, k, v, valid)
    seeds = seed_tensor(seed, q.device)
    out = torch.empty_like(q)
    _check(load_library().smer_train_attn_fwd(
        D, B, T, S, H, *_shard_args(shard, H), q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        seeds.data_ptr(), keep_threshold(rate), int(rate > 0.0), bf16_round(1.0 - rate),
        int(causal), 1.0 / math.sqrt(hd), out.data_ptr(), _stream(q.device),
    ), "train_attn_fwd")
    dropout_attention_fwd.launches += 1
    return out if D == hd else out[..., :hd].contiguous()


dropout_attention_fwd.launches = 0


def dropout_attention_bwd(q, k, v, kv_valid, seed: Seed, g, rate: float,
                          causal: bool = False, shard=(0, 0, None)):
    """The backward: the twin for CPU tensors, the two backward kernels for
    CUDA ones or an error.  Returns (dq, dk, dv) in bf16."""
    if attention.twin_device(q, "fused_dropout_attention"):
        return dropout_attention_bwd_reference(q, k, v, kv_valid, seed, g, rate, causal, shard)
    hd = q.shape[3]
    D = kernel_width(hd)
    q, k, v, g = (pad_head(t, D) for t in (q, k, v, g.to(q.dtype)))
    valid = kv_valid.to(torch.int32).contiguous()
    g = g.contiguous()
    if aw.is_wide(D):
        _check_klen(k.shape[1])
        grads = aw.dropout_bwd_wide(q, k, v, valid, seed_tensor(seed, q.device), g,
                                    keep_threshold(rate), rate > 0.0, bf16_round(1.0 - rate), causal,
                                    _shard_args(shard, q.shape[2]), 1.0 / math.sqrt(hd))
        return grads if D == hd else tuple(t[..., :hd].contiguous() for t in grads)
    B, T, H, S = _check_inputs(q, k, v, valid, ("g", g))
    seeds = seed_tensor(seed, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # per-row m, l and delta = sum_s w dw, written by the row kernel and
    # read by the key kernel: 3 x (B*H, T) f32, no O(T*S) tensor
    stats = torch.empty(3, B * H, T, dtype=torch.float32, device=q.device)
    _check(load_library().smer_train_attn_bwd(
        D, B, T, S, H, *_shard_args(shard, H), q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        seeds.data_ptr(), g.data_ptr(), keep_threshold(rate), int(rate > 0.0),
        bf16_round(1.0 - rate), int(causal), 1.0 / math.sqrt(hd), stats.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _stream(q.device),
    ), "train_attn_bwd")
    dropout_attention_bwd.launches += 1
    if D != hd:
        dq, dk, dv = (t[..., :hd].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


dropout_attention_bwd.launches = 0


def dropout_keep_mask(seed: Seed, B: int, H: int, T: int, S: int, rate: float,
                      device, b0: int = 0, h0: int = 0, H_global: Optional[int] = None) -> torch.Tensor:
    """The keep mask from the kernels' own ``__device__`` hash
    (``smer_dropout_keep_mask``), as (B, H, T, S) bool, so the card can show
    it equals :func:`dropout_mask_reference` (with the same shard
    arguments).  CUDA only."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("dropout_keep_mask runs the CUDA hash; use dropout_mask_reference on the CPU")
    seeds = seed_tensor(seed, device)
    out = torch.empty(B, H, T, S, dtype=torch.uint8, device=device)
    _check(load_library().smer_dropout_keep_mask(
        B, H, T, S, *_shard_args((b0, h0, H_global), H), seeds.data_ptr(), keep_threshold(rate), out.data_ptr(), _stream(device),
    ), "dropout_keep_mask")
    return out.bool()


class _FusedDropoutAttention(torch.autograd.Function):
    """JAX's ``custom_vjp`` (:315-374): the forward saves q, k, v, the
    validity mask and the seed words; the backward recomputes."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, seed, rate, causal, shard):
        out = dropout_attention_fwd(q, k, v, kv_valid, seed, rate, causal, shard)
        ctx.save_for_backward(q, k, v, kv_valid, seed)
        ctx.rate, ctx.causal, ctx.shard = rate, causal, shard
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_valid, seed = ctx.saved_tensors
        dq, dk, dv = dropout_attention_bwd(q, k, v, kv_valid, seed, g, ctx.rate, ctx.causal,
                                           ctx.shard)
        return dq, dk, dv, None, None, None, None, None


def fused_dropout_attention(q, k, v, kv_valid, seed: Seed, rate: float,
                            causal: bool = False, b0: int = 0, h0: int = 0,
                            H_global: Optional[int] = None) -> torch.Tensor:
    """softmax(round_bf16(QK^T) / sqrt(D)) -> weight dropout -> V, with a
    recomputing backward (JAX :316).  Returns (B, T, H, D) in q's dtype.
    On a shard of the batch rows (from ``b0``) and of the heads (from
    ``h0`` of ``H_global``) the keep mask is the slice of the unsharded
    one, as JAX's masks are the same under any sharding."""
    seed = seed_tensor(seed, q.device)
    valid = kv_valid.to(torch.int32).contiguous()
    shard = _shard_args((b0, h0, H_global), q.shape[2])
    return _FusedDropoutAttention.apply(q, k, v, valid, seed, float(rate), bool(causal), shard)


def reset_counts() -> None:
    dropout_attention_fwd.launches = 0
    dropout_attention_bwd.launches = 0
    dropout_attention_fwd_reference.calls = 0
    dropout_attention_bwd_reference.calls = 0
