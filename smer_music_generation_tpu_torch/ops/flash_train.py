"""Flash attention for training with its recomputing backward: hand-written
CUDA kernels, each beside its plain twin, joined by a
``torch.autograd.Function``.

Port of what ``MultiHeadAttention.attend_flash_vjp``
(``smer_music_generation_tpu/models/transformer.py:360``) calls: the library
kernel ``jax.experimental.pallas.ops.tpu.flash_attention`` with its custom
VJP, at the model's arguments (q segment ids all ones, kv segment ids the key
validity, ``sm_scale = 1/sqrt(D)``, default 128 blocks).  Its forward, dq
and dkv kernels become ``flash_train_fwd_kernel``, ``flash_train_dq_kernel``
and ``flash_train_dkv_kernel`` in ``csrc/flash_train.cu`` for bf16, and
``attn_f32_fwd_kernel``, ``flash_train_f32_dq_kernel`` and
``flash_train_f32_dkv_kernel`` in ``csrc/attention_f32.cu`` for f32 (the
library runs in the inputs' dtype).

``flash_train_attention(q, k, v, kv_valid, causal=False)`` takes (B, T, H,
D) queries and (B, S, H, D) keys and values, T and S multiples of 128, and
a (B, S) key-validity mask (True = attendable); it returns (B, T, H, D) in
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
:func:`flash_train_bwd_reference`); a CUDA tensor launches the kernels (bf16
or f32, head_dim in ``KERNEL_HEAD_DIMS`` or any other up to 128 zero-padded
to one of them, :func:`flash_kernel_width`, and every head_dim above 128
zero-padded to a multiple of 64 for ``wide_fwd_kernel``, ``wide_rows_kernel``
and ``wide_keys_kernel`` of ``csrc/attention_wide.cu``; contiguous) or
raises.  The kernels are built with the port's others into one library at
first use (``ops.decode_step.load_library``).
"""

from __future__ import annotations

import math

import torch

from . import attention, attention_wide as aw
from .attention import KERNEL_HEAD_DIMS, kernel_width, pad_head
from .decode_step import _check, _check_tensors, load_library

BLOCK = 128  # the library's block size (BlockSizes.get_default), every axis
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)  # the library's DEFAULT_MASK_VALUE
LOG2E = 1.4426950408889634


def _masked_scores(q, k, kv_valid, causal, scale=None):
    """The library's scores (B, H, T, S) f32: ``q . k * scale`` (1/sqrt(D)
    by default) plus MASK_VALUE where the key is invalid or past the row
    (causal), and -inf in the key blocks a causal row does not visit, which
    take no part."""
    B, T, H, D = q.shape
    S = k.shape[1]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
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


def flash_train_fwd_reference(q, k, v, kv_valid, causal: bool = False, scale=None):
    """Twin of the forward kernel: the online softmax over 128-key blocks
    (m and l per row, ``bf16(p) v`` summed in f32), the output ``o / l`` in
    q's dtype; when S is one block, the library's one-step kernel:
    ``bf16(p / l) v``.  Returns (out (B, T, H, D), stats (2, B*H, T) f32:
    m, l)."""
    flash_train_fwd_reference.calls += 1
    B, T, H, D = q.shape
    S = k.shape[1]
    s = _masked_scores(q, k, kv_valid, causal, scale)
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


def flash_train_bwd_reference(q, k, v, kv_valid, out, stats, g, causal: bool = False, scale=None):
    """Twin of the backward kernels, the library's dq and dkv kernels over
    all rows at once: ``p = exp(s - m) * (1 / l)``, ``dv = cast(p)^T g``,
    ``ds = (g v^T - di) p * scale`` with ``di = sum(out g)`` in f32,
    ``dq = cast(ds) k``, ``dk = cast(ds)^T q``, all summed in f32.  ``g``
    is rounded to q's dtype first.  Returns (dq, dk, dv) in the inputs'
    dtypes."""
    flash_train_bwd_reference.calls += 1
    B, T, H, D = q.shape
    g = g.to(q.dtype)
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    s = _masked_scores(q, k, kv_valid, causal, scale)
    m, l = (x.reshape(B, H, T, 1) for x in stats)
    p = _exp(s - m) * (1.0 / l)
    gf = g.float()
    dv = torch.einsum("bhts,bthd->bshd", p.to(g.dtype).float(), gf)
    dp = torch.einsum("bthd,bshd->bhts", gf, v.float())
    di = (out.float() * gf).sum(-1).transpose(1, 2)[..., None]  # (B, H, T, 1)
    ds = ((dp - di) * p * scale).to(g.dtype).float()
    dq = torch.einsum("bhts,bshd->bthd", ds, k.float())
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


flash_train_bwd_reference.calls = 0


def _check_blocks(T: int, S: int) -> None:
    if T % BLOCK or S % BLOCK or T < BLOCK or S < BLOCK:
        raise ValueError(f"the CUDA flash-train kernels take T and S multiples of {BLOCK}, "
                         f"got T={T} S={S}")


def _check_inputs(q, k, v, kv_valid, *extra):
    B, T, H, D = q.shape
    S = k.shape[1]
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA flash-train kernels take head_dim {KERNEL_HEAD_DIMS}, got {D}")
    _check_blocks(T, S)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the CUDA flash-train kernels take bf16 or f32, got {q.dtype}")
    dt = q.dtype
    want = {"q": (q, dt, (B, T, H, D)), "k": (k, dt, (B, S, H, D)),
            "v": (v, dt, (B, S, H, D)), "kv_valid": (kv_valid, torch.int32, (B, S))}
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


def flash_kernel_width(head_dim: int, dtype) -> int:
    """The width a head_dim runs at (``attention.kernel_width``), except
    that in bf16 every head_dim up to 128 but 64 pads to 128: the bf16
    pair's head_dim-64 instantiation folds the scale 1/8 into its constants
    (``fixed_scale`` in csrc/flash_train.cu), and a padded head keeps its
    own 1/sqrt(head_dim).  Above 128: the wide kernels' multiple of 64."""
    if dtype == torch.bfloat16 and head_dim != 64 and not aw.is_wide(head_dim):
        return kernel_width(head_dim, KERNEL_HEAD_DIMS[1:])
    return kernel_width(head_dim)


def flash_train_fwd(q, k, v, kv_valid, causal: bool = False):
    """The forward: the twin for CPU tensors, ``flash_train_fwd_kernel``
    (bf16) or ``attn_f32_fwd_kernel`` (f32) for CUDA ones, or an error.
    Returns (out, stats (2, B*H, T) f32)."""
    if attention.twin_device(q, "flash_train_attention"):
        return flash_train_fwd_reference(q, k, v, kv_valid, causal)
    hd = q.shape[3]
    D = flash_kernel_width(hd, q.dtype)
    q, k, v = (pad_head(t, D) for t in (q, k, v))
    valid = kv_valid.to(torch.int32).contiguous()
    if aw.is_wide(D):
        _check_blocks(q.shape[1], k.shape[1])
        out, stats = aw.flash_fwd_wide(q, k, v, valid, causal, 1.0 / math.sqrt(hd))
        return (out if D == hd else out[..., :hd].contiguous()), stats
    B, T, H, S = _check_inputs(q, k, v, valid)
    _check_aligned(q=q, k=k, v=v)
    out = torch.empty_like(q)
    stats = torch.empty(2, B * H, T, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), int(causal),
            1.0 / math.sqrt(hd), out.data_ptr(), stats.data_ptr(), stream)
    if q.dtype == torch.bfloat16:
        rc = load_library().smer_flash_train_fwd(D, B, T, S, H, *ptrs)
    else:
        rc = load_library().smer_attention_f32_fwd(1, D, B, T, S, H, *ptrs)
    _check(rc, "flash_train_fwd")
    flash_train_fwd.launches += 1
    return (out if D == hd else out[..., :hd].contiguous()), stats


flash_train_fwd.launches = 0


def flash_train_bwd(q, k, v, kv_valid, out, stats, g, causal: bool = False):
    """The backward: the twin for CPU tensors, the dq kernel then the dk/dv
    kernel for CUDA ones (``flash_train_dq_kernel`` and
    ``flash_train_dkv_kernel`` in bf16, their f32 counterparts in f32) or
    an error.  Returns (dq, dk, dv) in q's dtype."""
    if attention.twin_device(q, "flash_train_attention"):
        return flash_train_bwd_reference(q, k, v, kv_valid, out, stats, g, causal)
    hd = q.shape[3]
    D = flash_kernel_width(hd, q.dtype)
    q, k, v, out, g = (pad_head(t, D) for t in (q, k, v, out, g.to(q.dtype)))
    valid = kv_valid.to(torch.int32).contiguous()
    g = g.contiguous()
    if aw.is_wide(D):
        _check_blocks(q.shape[1], k.shape[1])
        grads = aw.flash_bwd_wide(q, k, v, valid, out, stats, g, causal, 1.0 / math.sqrt(hd))
        return grads if D == hd else tuple(t[..., :hd].contiguous() for t in grads)
    B, T, H, S = q.shape[0], q.shape[1], q.shape[2], k.shape[1]
    _check_inputs(q, k, v, valid, ("out", out, q.dtype, q.shape),
                  ("g", g, q.dtype, q.shape), ("stats", stats, torch.float32, (2, B * H, T)))
    _check_aligned(q=q, k=k, v=v, out=out, g=g, stats=stats)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    di = torch.empty(B * H, T, dtype=torch.float32, device=q.device)  # sum(out g), dq kernel to dkv
    args = (D, B, T, S, H, q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            out.data_ptr(), stats.data_ptr(), g.data_ptr(), int(causal), 1.0 / math.sqrt(hd),
            di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    lib = load_library()
    rc = (lib.smer_flash_train_bwd if q.dtype == torch.bfloat16 else lib.smer_flash_train_bwd_f32)(*args)
    _check(rc, "flash_train_bwd")
    flash_train_bwd.launches += 1
    if D != hd:
        dq, dk, dv = (t[..., :hd].contiguous() for t in (dq, dk, dv))
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
