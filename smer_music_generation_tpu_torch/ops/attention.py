"""Flash-attention forward through a hand-written CUDA kernel, beside its
plain twin.

Port of ``smer_music_generation_tpu/ops/attention.py``: ``attention_reference``
(:35) and the TPU kernel ``fused_attention`` (:115, body ``_attn_kernel`` :55),
which becomes ``flash_fwd_kernel`` in ``csrc/attention.cu``.  The encoder's
self-attention takes it when ``ModelConfig.flash_encoder`` is set.

``fused_attention(q, k, v, kv_valid_len=None, causal=False)`` takes (B, T, H,
HD) queries and (B, S, H, HD) keys and values, as JAX's does, and returns
(B, T, H, HD) in q's dtype: scores in f32 scaled by 1/sqrt(HD), keys at or
past ``kv_valid_len[b]`` masked with -1e30 (and keys past the query row when
``causal``), softmax in f32.  A tensor on the CPU goes to the twin
:func:`attention_reference`; a CUDA tensor launches a kernel (head_dim in
:data:`KERNEL_HEAD_DIMS`, or any other up to 128 zero-padded to the next of
them: :func:`kernel_width`; bf16 to ``flash_fwd_kernel``, f32 to
``attn_f32_fwd_kernel`` of ``csrc/attention_f32.cu``; a head_dim above 128
zero-padded to a multiple of 64 and sent to ``wide_fwd_kernel`` of
``csrc/attention_wide.cu``, ``ops/attention_wide.py``) or raises.  The
kernels are built with the decode kernels into one library at first use
(``ops.decode_step.load_library``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import attention_wide as aw
from .decode_step import _check, _check_tensors, load_library

NEG_INF = -1e30
# the head_dims the narrow CUDA attention kernels are built for (attention.cu,
# attention_f32.cu, train_attention.cu, flash_train.cu), in bf16 and, for
# this module's and flash_train's kernels, f32; any other head_dim up to the
# last runs on the next wider one, zero-padded, and every head_dim above it
# on the wide kernels of attention_wide.cu (:func:`kernel_width`)
KERNEL_HEAD_DIMS = (64, aw.NARROW_MAX)


def kernel_width(head_dim: int, widths=KERNEL_HEAD_DIMS) -> int:
    """The width a head_dim runs at: itself or the next wider one of
    ``widths`` (the narrow kernels), or above 128 the next multiple of 64
    (the wide kernels, ``attention_wide.wide_width``), with q, k and v
    zero-padded on the last axis (:func:`pad_head`) and the scale kept at
    1/sqrt(head_dim).  A zero column adds an exact zero to every score and
    every product, so the padded kernel computes the true head_dim's
    function, and its extra output and gradient columns are zeros, sliced
    off."""
    for w in widths:
        if head_dim <= w:
            return w
    return aw.wide_width(head_dim)


def twin_device(t: torch.Tensor, what: str) -> bool:
    """Where the attention wrappers (this module's, ``train_attention``'s and
    ``flash_train``'s) run their twins (a tensor on the CPU: True) and where
    they launch a kernel (CUDA: False); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")
    return False


def pad_head(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` (..., head_dim) zero-padded to ``width`` on its last axis (a new
    contiguous tensor), or ``t`` itself at that width."""
    hd = t.shape[-1]
    return t if hd == width else torch.nn.functional.pad(t, (0, width - hd)).contiguous()


def attention_reference(
    q: torch.Tensor,  # (B, T, H, HD)
    k: torch.Tensor,  # (B, S, H, HD)
    v: torch.Tensor,  # (B, S, H, HD)
    kv_valid_len: Optional[torch.Tensor] = None,  # (B,) valid key length
    causal: bool = False,
    scale: Optional[float] = None,  # the scores' 1/sqrt(HD) by default
) -> torch.Tensor:
    """Plain-torch twin of :func:`fused_attention` (JAX :35): the scores in
    f32 from the f32 values of q and k, masked to -1e30, a softmax over S,
    the weighted sum of v in f32, cast to q's dtype.  A row whose keys are
    all masked weighs every key alike."""
    attention_reference.calls += 1
    B, T, H, HD = q.shape
    S = k.shape[1]
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    scores = scores / math.sqrt(HD) if scale is None else scores * scale
    if kv_valid_len is not None:
        key_ok = torch.arange(S, device=q.device)[None, :] < kv_valid_len.to(q.device)[:, None]
        scores = torch.where(key_ok[:, None, None, :], scores, NEG_INF)
    if causal:
        cm = torch.ones(T, S, dtype=torch.bool, device=q.device).tril()
        scores = torch.where(cm[None, None], scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bshd->bthd", weights, v.float()).to(q.dtype)


attention_reference.calls = 0


def _check_inputs(q, k, v, kv_valid_len) -> None:
    """What the CUDA kernels take: head_dim in KERNEL_HEAD_DIMS (after
    padding), bf16 or f32 (q, k and v alike), contiguous tensors on q's
    device."""
    B, T, H, HD = q.shape
    S = k.shape[1]
    if HD not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA flash-attention kernels take head_dim {KERNEL_HEAD_DIMS}, got {HD}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the CUDA flash-attention kernels take bf16 or f32, got {q.dtype}")
    want = {"q": (q, q.dtype, (B, T, H, HD)), "k": (k, q.dtype, (B, S, H, HD)),
            "v": (v, q.dtype, (B, S, H, HD))}
    if kv_valid_len is not None:
        want["kv_valid_len"] = (kv_valid_len, torch.int32, (B,))
    _check_tensors(q.device, want)


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_valid_len: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Flash attention over (B, T|S, H, HD) tensors; returns (B, T, H, HD).
    On CUDA a head_dim up to 128 other than 64 and 128 runs on the next
    wider kernel, zero-padded, and one above 128 on the wide kernel
    (:func:`kernel_width`)."""
    if twin_device(q, "fused_attention"):
        return attention_reference(q, k, v, kv_valid_len, causal)
    B, T, H, hd = q.shape
    S = k.shape[1]
    HD = kernel_width(hd)
    q, k, v = (pad_head(t, HD) for t in (q, k, v))
    if aw.is_wide(HD):
        out = aw.fused_attention_wide(q, k, v, kv_valid_len, causal, 1.0 / math.sqrt(hd))
        return out if HD == hd else out[..., :hd].contiguous()
    _check_inputs(q, k, v, kv_valid_len)
    out = torch.empty_like(q)
    lens = kv_valid_len.data_ptr() if kv_valid_len is not None else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = load_library()
    scale = 1.0 / math.sqrt(hd)
    if q.dtype == torch.bfloat16:
        rc = lib.smer_flash_attention(HD, B, T, S, H, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                      lens, int(causal), scale, out.data_ptr(), stream)
    else:
        rc = lib.smer_attention_f32_fwd(0, HD, B, T, S, H, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                        lens, int(causal), scale, out.data_ptr(), None, stream)
    _check(rc, "flash_attention")
    fused_attention.launches += 1
    return out if HD == hd else out[..., :hd].contiguous()


fused_attention.launches = 0


def reset_counts() -> None:
    fused_attention.launches = 0
    attention_reference.calls = 0
    aw.reset_counts()
