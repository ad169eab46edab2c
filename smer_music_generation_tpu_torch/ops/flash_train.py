"""Flash attention for training with its recomputing backward: hand-written
CUDA kernels, each beside its plain twin, joined by a
``torch.autograd.Function``.

Port of what ``MultiHeadAttention.attend_flash_vjp``
(``smer_music_generation_tpu/models/transformer.py:360``) calls: the library
kernel ``jax.experimental.pallas.ops.tpu.flash_attention`` with its custom
VJP, at the model's arguments (q segment ids all ones, kv segment ids the key
validity, ``sm_scale = 1/sqrt(64)``, default 128 blocks).  Its forward, dq
and dkv kernels become ``flash_train_fwd_kernel``, ``flash_train_dq_kernel``
and ``flash_train_dkv_kernel`` in ``csrc/flash_train.cu``.

``flash_train_attention(q, k, v, kv_valid, causal=False)`` takes (B, T, H,
64) queries and (B, S, H, 64) keys and values, T and S multiples of 128, and
a (B, S) key-validity mask (True = attendable); it returns (B, T, H, 64) in
q's dtype.  What it computes, as the library does:

- scores ``q . k * scale`` in f32, plus ``MASK_VALUE`` (-0.7 * f32 max)
  where the key is invalid or, when causal, past the row: the mask is
  added, so a row with no attendable key weighs its keys alike;
- keys in blocks of 128; when causal, query block qb visits the key blocks
  kb <= qb only, so such a row's output is the mean of V over those blocks;
- an online softmax over the visited blocks, ``bf16(p) v`` summed in f32
  (p cast to v's dtype), the per-row m and l saved for the backward;
- the backward recomputes ``p = exp(s - m) / l`` and gives ``dv =
  p^T g``, ``ds = (g v^T - di) p * scale`` with ``di = sum(out g)``,
  ``dq = ds k`` and ``dk = ds^T q``, p and ds cast to the inputs' dtype.

The exponent is ``2^((s - m) log2(e))``, the kernels' and the twins' alike.
A tensor on the CPU goes to the twins (:func:`flash_train_fwd_reference`,
:func:`flash_train_bwd_reference`); a CUDA tensor launches the kernels (bf16,
head_dim 64, contiguous) or raises.  The kernels are built with the port's
others into one library at first use (``ops.decode_step.load_library``).
"""

from __future__ import annotations

import math

import torch

from .decode_step import _check, _check_tensors, load_library

BLOCK = 128  # the library's block size (BlockSizes.get_default), every axis
HEAD_DIM = 64  # the head_dim the CUDA kernels take
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)  # the library's DEFAULT_MASK_VALUE
LOG2E = 1.4426950408889634


def _masked_scores(q, k, kv_valid, causal):
    """The library's scores (B, H, T, S) f32: ``q . k * scale`` plus
    MASK_VALUE where the key is invalid or past the row (causal), and -inf
    in the key blocks a causal row does not visit, which take no part."""
    B, T, H, D = q.shape
    S = k.shape[1]
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * (1.0 / math.sqrt(D))
    mask = kv_valid.to(torch.bool)[:, None, None, :]
    if causal:
        mask = mask & torch.ones(T, S, dtype=torch.bool, device=q.device).tril()[None, None]
    s = s + torch.where(mask, 0.0, MASK_VALUE)
    if causal:
        rows = torch.arange(T, device=q.device) // BLOCK
        cols = torch.arange(S, device=q.device) // BLOCK
        s = s.masked_fill((cols[None, :] > rows[:, None])[None, None], -torch.inf)
    return s


def _exp(x: torch.Tensor) -> torch.Tensor:
    """e^x as the kernels take it: 2^(x log2(e)), the product in f32."""
    return torch.exp2(x * torch.tensor(LOG2E, dtype=torch.float32, device=x.device))


def flash_train_fwd_reference(q, k, v, kv_valid, causal: bool = False):
    """Twin of the forward kernel: the online softmax over 128-key blocks
    (m and l per row, ``bf16(p) v`` summed in f32), the output ``o / l`` in
    q's dtype; when S is one block, the library's one-step kernel:
    ``bf16(p / l) v``.  Returns (out (B, T, H, D), stats (2, B*H, T) f32:
    m, l)."""
    flash_train_fwd_reference.calls += 1
    B, T, H, D = q.shape
    S = k.shape[1]
    s = _masked_scores(q, k, kv_valid, causal)
    if S == BLOCK:  # the library's one-step kernel: p divided by l before the cast
        m = s.amax(-1)
        p = _exp(s - m[..., None])
        l = p.sum(-1)
        p = p / l[..., None]
        out = torch.einsum("bhts,bshd->bthd", p.to(v.dtype).float(), v.float()).to(q.dtype)
        return out, torch.stack([m.reshape(B * H, T), l.reshape(B * H, T)])
    m = torch.full((B, H, T), -torch.inf, device=q.device)
    l = torch.zeros(B, H, T, device=q.device)
    acc = torch.zeros(B, H, T, D, device=q.device)
    for k0 in range(0, S, BLOCK):
        sb = s[..., k0:k0 + BLOCK]
        m_new = torch.maximum(m, sb.amax(-1))
        alpha = _exp(m - m_new)
        p = _exp(sb - m_new[..., None])
        l = alpha * l + p.sum(-1)
        pv = torch.einsum("bhts,bshd->bhtd", p.to(v.dtype).float(), v[:, k0:k0 + BLOCK].float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = (acc * (1.0 / l)[..., None]).transpose(1, 2).to(q.dtype)
    return out, torch.stack([m.reshape(B * H, T), l.reshape(B * H, T)])


flash_train_fwd_reference.calls = 0


def flash_train_bwd_reference(q, k, v, kv_valid, out, stats, g, causal: bool = False):
    """Twin of the backward kernels, the library's dq and dkv kernels over
    all rows at once: ``p = exp(s - m) * (1 / l)``, ``dv = cast(p)^T g``,
    ``ds = (g v^T - di) p * scale`` with ``di = sum(out g)`` in f32,
    ``dq = cast(ds) k``, ``dk = cast(ds)^T q``, all summed in f32.  ``g``
    is rounded to q's dtype first.  Returns (dq, dk, dv) in the inputs'
    dtypes."""
    flash_train_bwd_reference.calls += 1
    B, T, H, D = q.shape
    g = g.to(q.dtype)
    s = _masked_scores(q, k, kv_valid, causal)
    m, l = (x.reshape(B, H, T, 1) for x in stats)
    p = _exp(s - m) * (1.0 / l)
    gf = g.float()
    dv = torch.einsum("bhts,bthd->bshd", p.to(g.dtype).float(), gf)
    dp = torch.einsum("bthd,bshd->bhts", gf, v.float())
    di = (out.float() * gf).sum(-1).transpose(1, 2)[..., None]  # (B, H, T, 1)
    ds = ((dp - di) * p * (1.0 / math.sqrt(D))).to(g.dtype).float()
    dq = torch.einsum("bhts,bshd->bthd", ds, k.float())
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


flash_train_bwd_reference.calls = 0


def _check_inputs(q, k, v, kv_valid, *extra):
    B, T, H, D = q.shape
    S = k.shape[1]
    if D != HEAD_DIM:
        raise ValueError(f"the CUDA flash-train kernels take head_dim {HEAD_DIM}, got {D}")
    if T % BLOCK or S % BLOCK or T < BLOCK or S < BLOCK:
        raise ValueError(f"the CUDA flash-train kernels take T and S multiples of {BLOCK}, "
                         f"got T={T} S={S}")
    bf16 = torch.bfloat16
    want = {"q": (q, bf16, (B, T, H, D)), "k": (k, bf16, (B, S, H, D)),
            "v": (v, bf16, (B, S, H, D)), "kv_valid": (kv_valid, torch.int32, (B, S))}
    for name, t, dtype, shape in extra:
        want[name] = (t, dtype, shape)
    _check_tensors(q.device, want)
    return B, T, H, S


def _check_aligned(**tensors) -> None:
    """Every tensor's first element 16-byte aligned: the backward's TMA loads
    and bulk copies (and the forward's 16-byte vectors) need it; a view into
    a larger tensor may not be."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned for the flash-train kernels' "
                             f"TMA loads, got address {t.data_ptr():#x}")


def _device(q) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_train_attention runs on cuda or cpu, not {q.device}")


def flash_train_fwd(q, k, v, kv_valid, causal: bool = False):
    """The forward: the twin for CPU tensors, ``flash_train_fwd_kernel`` for
    CUDA ones or an error.  Returns (out, stats (2, B*H, T) f32)."""
    if q.device.type == "cpu":
        return flash_train_fwd_reference(q, k, v, kv_valid, causal)
    _device(q)
    valid = kv_valid.to(torch.int32).contiguous()
    B, T, H, S = _check_inputs(q, k, v, valid)
    _check_aligned(q=q, k=k, v=v)
    out = torch.empty_like(q)
    stats = torch.empty(2, B * H, T, dtype=torch.float32, device=q.device)
    _check(load_library().smer_flash_train_fwd(
        B, T, S, H, q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), int(causal),
        out.data_ptr(), stats.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream,
    ), "flash_train_fwd")
    flash_train_fwd.launches += 1
    return out, stats


flash_train_fwd.launches = 0


def flash_train_bwd(q, k, v, kv_valid, out, stats, g, causal: bool = False):
    """The backward: the twin for CPU tensors, ``flash_train_dq_kernel``
    then ``flash_train_dkv_kernel`` for CUDA ones or an error.  Returns
    (dq, dk, dv) in bf16."""
    if q.device.type == "cpu":
        return flash_train_bwd_reference(q, k, v, kv_valid, out, stats, g, causal)
    _device(q)
    valid = kv_valid.to(torch.int32).contiguous()
    g = g.to(q.dtype).contiguous()
    B, T, H, S = q.shape[0], q.shape[1], q.shape[2], k.shape[1]
    _check_inputs(q, k, v, valid, ("out", out, torch.bfloat16, q.shape),
                  ("g", g, torch.bfloat16, q.shape), ("stats", stats, torch.float32, (2, B * H, T)))
    _check_aligned(q=q, k=k, v=v, out=out, g=g, stats=stats)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    di = torch.empty(B * H, T, dtype=torch.float32, device=q.device)  # sum(out g), dq kernel to dkv
    _check(load_library().smer_flash_train_bwd(
        B, T, S, H, q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), out.data_ptr(),
        stats.data_ptr(), g.data_ptr(), int(causal), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream,
    ), "flash_train_bwd")
    flash_train_bwd.launches += 1
    return dq, dk, dv


flash_train_bwd.launches = 0


class _FlashTrainAttention(torch.autograd.Function):
    """The library's ``custom_vjp``: the forward saves q, k, v, the validity
    mask, the output and each row's m and l; the backward recomputes."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, causal):
        out, stats = flash_train_fwd(q, k, v, kv_valid, causal)
        ctx.save_for_backward(q, k, v, kv_valid, out, stats)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_valid, out, stats = ctx.saved_tensors
        dq, dk, dv = flash_train_bwd(q, k, v, kv_valid, out, stats, g, ctx.causal)
        return dq, dk, dv, None, None


def flash_train_attention(q, k, v, kv_valid, causal: bool = False) -> torch.Tensor:
    """Flash attention with a keys-only validity mask and an optional causal
    mask, as the library computes it for the model, with a recomputing
    backward.  Returns (B, T, H, D) in q's dtype."""
    valid = kv_valid.to(torch.int32).contiguous()
    return _FlashTrainAttention.apply(q, k, v, valid, bool(causal))


def reset_counts() -> None:
    flash_train_fwd.launches = 0
    flash_train_bwd.launches = 0
    flash_train_fwd_reference.calls = 0
    flash_train_bwd_reference.calls = 0
