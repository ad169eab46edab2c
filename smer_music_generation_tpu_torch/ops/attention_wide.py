"""The attention kernels at every head_dim above 128, beside the twins they
share with the narrow kernels.

``csrc/attention_wide.cu`` holds one forward kernel and one backward pair,
each a template over the element type and a mask policy (MODE 0:
``fused_attention``; 1: ``fused_dropout_attention``; 2: ``flash_training``'s
attention), over any head_dim that is a multiple of 64: shared memory and
registers do not grow with head_dim (the score products walk it in chunks,
the outputs are split into 128-column chunks over the grid, and each block
recomputes the row statistics of its chunk).  The forward and both kernels
of the backward, the rows kernel (dq) and the keys kernel (dk, dv), run on
the tensor cores (``mma.sync``: bf16, and f32 in split TF32).  The wrappers of
``ops/attention.py``, ``ops/train_attention.py`` and ``ops/flash_train.py``
send a CUDA tensor whose head_dim is above 128 here (:func:`is_wide`), after
zero-padding it to :func:`wide_width` with the scale kept at
1/sqrt(head_dim); on the CPU they run the twins, which take any head_dim.

Each launcher takes padded, contiguous CUDA tensors and counts one launch of
its kernel (or pair) in its ``launches``.  The kernels are built with the
port's others into one library at first use (``ops.decode_step.load_library``).
"""

from __future__ import annotations

import torch

from .decode_step import _check, _check_tensors, load_library

NARROW_MAX = 128  # the widest head_dim of the narrow kernels (attention.KERNEL_HEAD_DIMS)
CHUNK = 64  # head_dim's unit on the wide kernels (a bf16 score step's chunk)
MODE_FUSED, MODE_DROP, MODE_FLASH = 0, 1, 2


def is_wide(head_dim: int) -> bool:
    """Whether a head_dim runs on the wide kernels: above 128."""
    return head_dim > NARROW_MAX


def wide_width(head_dim: int) -> int:
    """The width a wide head_dim is zero-padded to: the next multiple of 64."""
    return -(-head_dim // CHUNK) * CHUNK


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _inputs(q, k, v, dtypes, **extra):
    """Checks q (B, T, H, D), k and v (B, S, H, D) in one of ``dtypes``, D a
    multiple of 64, and ``extra`` (name -> (tensor, dtype, shape)); all
    contiguous on q's device.  Returns (B, T, S, H, D)."""
    B, T, H, D = q.shape
    S = k.shape[1]
    if D % CHUNK or not is_wide(D):
        raise ValueError(f"the wide attention kernels take head_dim a multiple of {CHUNK} above "
                         f"{NARROW_MAX}, got {D}")
    if q.dtype not in dtypes:
        raise TypeError(f"the wide attention kernels take {dtypes} here, got {q.dtype}")
    want = {"q": (q, q.dtype, (B, T, H, D)), "k": (k, q.dtype, (B, S, H, D)),
            "v": (v, q.dtype, (B, S, H, D)), **extra}
    _check_tensors(q.device, want)
    return B, T, S, H, D


def fused_attention_wide(q, k, v, kv_valid_len, causal: bool, scale: float) -> torch.Tensor:
    """``wide_fwd_kernel`` MODE 0: ``attention_reference``'s function, bf16
    or f32; ``kv_valid_len`` (B,) int32 or None."""
    extra = {} if kv_valid_len is None else {"kv_valid_len": (kv_valid_len, torch.int32, q.shape[:1])}
    B, T, S, H, D = _inputs(q, k, v, (torch.bfloat16, torch.float32), **extra)
    out = torch.empty_like(q)
    _check(load_library().smer_wide_attn_fwd(
        MODE_FUSED, int(q.dtype == torch.bfloat16), B, T, S, H, D, 0, 0, H, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), None if kv_valid_len is None else kv_valid_len.data_ptr(),
        None, None, 0, 0, 1.0, int(causal), scale, out.data_ptr(), None, _stream(q.device),
    ), "wide attention forward")
    fused_attention_wide.launches += 1
    return out


fused_attention_wide.launches = 0


def dropout_fwd_wide(q, k, v, valid, seeds, thr: int, drop_on: bool, c: float, causal: bool,
                     shard, scale: float) -> torch.Tensor:
    """``wide_fwd_kernel`` MODE 1: ``dropout_attention_fwd_reference``'s
    function (bf16); ``valid`` (B, S) int32, ``seeds`` (4,) int32, ``shard``
    = (b0, h0, H_global)."""
    B, T, S, H, D = _inputs(q, k, v, (torch.bfloat16,), valid=(valid, torch.int32, (q.shape[0], k.shape[1])),
                            seeds=(seeds, torch.int32, (4,)))
    out = torch.empty_like(q)
    _check(load_library().smer_wide_attn_fwd(
        MODE_DROP, 1, B, T, S, H, D, *shard, q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
        valid.data_ptr(), seeds.data_ptr(), thr, int(drop_on), c, int(causal), scale,
        out.data_ptr(), None, _stream(q.device),
    ), "wide dropout attention forward")
    dropout_fwd_wide.launches += 1
    return out


dropout_fwd_wide.launches = 0


def dropout_bwd_wide(q, k, v, valid, seeds, g, thr: int, drop_on: bool, c: float, causal: bool,
                     shard, scale: float):
    """``wide_rows_kernel`` then ``wide_keys_kernel`` MODE 1: (dq, dk, dv) of
    ``dropout_attention_bwd_reference`` (bf16); ``g`` in q's layout."""
    B, T, S, H, D = _inputs(q, k, v, (torch.bfloat16,), valid=(valid, torch.int32, (q.shape[0], k.shape[1])),
                            seeds=(seeds, torch.int32, (4,)), g=(g, torch.bfloat16, q.shape))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty(3, B * H, T, dtype=torch.float32, device=q.device)  # m, l, delta
    _check(load_library().smer_wide_attn_bwd(
        MODE_DROP, 1, B, T, S, H, D, *shard, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        valid.data_ptr(), seeds.data_ptr(), thr, int(drop_on), c, int(causal), scale, None,
        g.data_ptr(), stats.data_ptr(), None, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _stream(q.device),
    ), "wide dropout attention backward")
    dropout_bwd_wide.launches += 1
    return dq, dk, dv


dropout_bwd_wide.launches = 0


def flash_fwd_wide(q, k, v, valid, causal: bool, scale: float):
    """``wide_fwd_kernel`` MODE 2: ``flash_train_fwd_reference``'s function,
    bf16 or f32, T and S multiples of 128.  Returns (out, stats (2, B*H, T)
    f32: m, l)."""
    B, T, S, H, D = _inputs(q, k, v, (torch.bfloat16, torch.float32),
                            valid=(valid, torch.int32, (q.shape[0], k.shape[1])))
    out = torch.empty_like(q)
    stats = torch.empty(2, B * H, T, dtype=torch.float32, device=q.device)
    _check(load_library().smer_wide_attn_fwd(
        MODE_FLASH, int(q.dtype == torch.bfloat16), B, T, S, H, D, 0, 0, H, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), None, valid.data_ptr(), None, 0, 0, 1.0, int(causal), scale,
        out.data_ptr(), stats.data_ptr(), _stream(q.device),
    ), "wide flash-train forward")
    flash_fwd_wide.launches += 1
    return out, stats


flash_fwd_wide.launches = 0


def flash_bwd_wide(q, k, v, valid, out, stats, g, causal: bool, scale: float):
    """``wide_rows_kernel`` then ``wide_keys_kernel`` MODE 2: (dq, dk, dv) of
    ``flash_train_bwd_reference``; ``out`` and ``stats`` the forward's, ``g``
    in q's dtype and layout."""
    B, T, S, H, D = _inputs(q, k, v, (torch.bfloat16, torch.float32),
                            valid=(valid, torch.int32, (q.shape[0], k.shape[1])),
                            out=(out, q.dtype, q.shape), g=(g, q.dtype, q.shape),
                            stats=(stats, torch.float32, (2, q.shape[0] * q.shape[2], q.shape[1])))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    di = torch.empty(B * H, T, dtype=torch.float32, device=q.device)  # sum(out g), rows to keys
    _check(load_library().smer_wide_attn_bwd(
        MODE_FLASH, int(q.dtype == torch.bfloat16), B, T, S, H, D, 0, 0, H, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), valid.data_ptr(), None, 0, 0, 1.0, int(causal), scale,
        out.data_ptr(), g.data_ptr(), stats.data_ptr(), di.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _stream(q.device),
    ), "wide flash-train backward")
    flash_bwd_wide.launches += 1
    return dq, dk, dv


flash_bwd_wide.launches = 0


def reset_counts() -> None:
    for fn in (fused_attention_wide, dropout_fwd_wide, dropout_bwd_wide, flash_fwd_wide,
               flash_bwd_wide):
        fn.launches = 0
