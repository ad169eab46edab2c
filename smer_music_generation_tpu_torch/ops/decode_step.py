"""One decoder step (v2), one whole token (v3), a chunk of tokens (v4) and
the W-row verify window of speculative decode through hand-written CUDA
kernels, each beside its plain twin, on a bf16 or an f32 model (the compute
dtype: the weights, the caches and the embedding in it), its decoder
weights in that dtype or int8.

Port of ``smer_music_generation_tpu/ops/decode_step.py``: ``quantize_columns``
(:50), the packers ``pack_decoder_weights`` (:66, ``quant="int8"`` included),
``stack_kv_cache`` (:154), ``vocab_pad`` (:551) and ``pack_sampling_tables``
(:571) with the ``ST_*`` / ``AUX_*`` / ``_CL_*`` constants (:563-568), and the
TPU kernels ``fused_decode_step`` (v2, :456), ``fused_decode_token`` (v3,
:796), ``fused_decode_tokens`` (v4, :1028) and ``fused_verify_window``
(:1368), with the int8 ``scale`` path of their layer body (:296-400), which
become the kernel sets in ``csrc/decode_step.cu`` and ``csrc/decode_token.cu``.

``fused_decode_step`` keeps the JAX signature and returns
``(logits (B, vpad) f32, new_kv (n_layers, B, 2D))``; ``fused_verify_window``
keeps it and returns ``(logits (W, vpad) f32, new_kv (n_layers, W, 2D))``;
``fused_decode_token``
keeps it without ``interpret`` and returns ``(new_state (6, B) int32,
new_kv)``; ``fused_decode_tokens`` returns ``(new_state, tokens (T_chunk, B)
int32, new_kv (n_layers, T_chunk, B, 2D))``.  A packed dict with a
``"scale"`` strip holds int8 matrices, and every wrapper takes it.  A tensor
on the CPU goes to the twin (:func:`fused_decode_step_reference`,
:func:`fused_decode_token_reference`, :func:`fused_decode_tokens_reference`,
:func:`fused_verify_window_reference`, :func:`rowvec_int8_reference`), the
same math in plain torch; a CUDA tensor
launches the kernels or raises.
There is no fallback from one to the other.  ``fused_decode_token`` and
``fused_decode_tokens`` take the position as a host int or as a (B,) int32
tensor on the device; their launch plan (:func:`launch_tokens`) reads it
only there, so ``decode_graph.DecodeGraph`` captures it once and replays it
at every position.  The kernels are built at first
use with ``nvcc`` into ``build/torch_kernels/`` (named by a hash over every
file of ``csrc/``, headers included) and bound with ``ctypes``; nothing is
built when this module is imported.

The compute dtype is the caches' (JAX :478, :821, :1050, :1395): an f32
model's step runs the f32 kernels (x unrounded, K|V written in f32), its
int8 weights too, as JAX casts the int8 blocks and x to it; a cache in one
dtype beside weights in another raises ``TypeError``.

Layouts follow the JAX packer: every packed weight keeps the flax
``(in, out)`` layout, K and V of a cache row are interleaved as lanes
``[0:D) = K`` and ``[D:2D) = V``.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..infer.grammar import allowed_mask_fast, update_bits
from ..infer.sampling import greedy_sample, masked_sample_gumbel, spec_accept_resample

LN_EPS = 1e-6
_CSRC = Path(__file__).resolve().parent / "csrc"
# one library for the port's kernels: the decode kernels here, the
# flash-attention forward of ``ops/attention.py``, the training attention
# of ``ops/train_attention.py`` and the flash training attention of
# ``ops/flash_train.py`` (their f32 kernels in ``attention_f32.cu``, and
# every head_dim above 128 in ``attention_wide.cu``, ``ops/attention_wide.py``);
# the attention kernels share the tensor-core tile helpers of
# ``csrc/attn_tiles.cuh``, the dropout ones the hash of ``dropout_hash.cuh``
_SOURCES = (_CSRC / "decode_step.cu", _CSRC / "decode_token.cu", _CSRC / "attention.cu",
            _CSRC / "train_attention.cu", _CSRC / "flash_train.cu", _CSRC / "attention_f32.cu",
            _CSRC / "attention_wide.cu")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-Xcompiler", "-fPIC",
)

# state rows carried through the v3 loop as one (6, B) int32 array
ST_TOKEN, ST_BITS, ST_STEPS, ST_SPAN, ST_DONE, ST_LEN = range(6)
# the carry of speculative decode's loop, one (SPEC_CARRY,) int32 vector:
# position, done, grammar bits, steps in span, span index, length
SPEC_POS, SPEC_DONE, SPEC_BITS, SPEC_STEPS, SPEC_SPAN, SPEC_LEN = range(6)
SPEC_CARRY = 8
MAX_BATCH = 8  # rows of the batched decode kernels (v2, v3, v4)
COMPUTE_DTYPES = (torch.bfloat16, torch.float32)  # the models the decode kernels take
# rowvec_kernel (csrc/decode_step.cu): rows a launch (more are launched in
# chunks of this many), output columns a tile, K rows a pass; a K-slice is
# 1-4 passes, chosen from K and N alone so that a row's sum never depends
# on the rows beside it
_ROWVEC_ROWS, _ROWVEC_COLS, _ROWVEC_PASS = 16, 64, 16
_ROWVEC_BLOCKS = 256  # the blocks a projection aims at
# attend_kernel: rows of the spliced sequence a split (block) owns
_ATTEND_SPLIT_ROWS = 64
# attend_kernel's source of self-attention rows past the cache's (RowSource)
_ROWS_CACHE_ONLY, _ROWS_CHUNK, _ROWS_WINDOW = range(3)
# aux rows (constants per session): (2, B) int32
AUX_NSPANS, AUX_NOWHOLE = range(2)
# class_mat columns
_CL_PITCH, _CL_DUR, _CL_SEP, _CL_REST, _CL_STEP, _CL_EOS, _CL_CONT = range(7)
_N_CLASSES = 8  # padded to 8 lanes
NEG = -1e9


def vocab_pad(vocab_size: int) -> int:
    return ((vocab_size + 127) // 128) * 128


def quantize_columns(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-column int8 quantization (JAX :50).

    ``w`` is (..., rows, cols) f32; each column gets one f32 scale
    ``max(amax, 1e-8) / 127`` and ``q = clamp(round(w / scale), -127, 127)``,
    rounding half to even as ``jnp.round`` does.  Returns ``(q int8, scale
    (..., 1, cols) f32)``."""
    w = w.float()
    amax = w.abs().amax(dim=-2, keepdim=True)
    scale = amax.clamp(min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def pack_decoder_weights(model, vpad: int, quant: str = "none") -> Dict[str, torch.Tensor]:
    """Stack per-layer decoder weights into layer-major packed tensors.

    Same layout as the JAX packer (D = d_model, F = d_ff), on the model's
    device, with the matrices in the model's compute dtype:

      w_attn (nl, D, 6D): [W_q | W_k | W_v | W_self_out | W_cross_q | W_cross_out]
      bias   (nl, 1, 7D + F) f32:
             [b_qkv (3D) | b_self_out | b_cross_q | b_cross_out | b_ff1 (F) | b_ff2]
      ln     (nl, 6, D) f32: norm{1,2,3} x {scale, bias}
      w_ff1  (nl, D, F), w_ff2 (nl, F, D)
      fin_ln (2, D) f32 when the model has ``norm_d``
      fc_w   (D, vpad) f32, fc_b (vpad,) f32, padded slots biased to -1e9
      emb    (vpad, D): the embedding table, zero rows past the vocab

    torch ``Linear.weight`` is (out, in); it is transposed here back to
    the flax (in, out) layout the kernels read.

    ``quant="int8"`` stores w_attn, w_ff1 and w_ff2 as int8
    (:func:`quantize_columns`) plus one f32 scale strip
    ``scale (nl, 1, 7D + F) = [s_attn (6D) | s_ff1 (F) | s_ff2 (D)]``.  They
    are quantized from the modules' f32 parameters, not from their copy in
    the compute dtype, as JAX quantizes from its f32 masters.
    """
    if quant not in ("none", "int8"):
        raise ValueError(f"unknown quant mode {quant!r}")
    # int8 quantizes the f32 masters; the compute dtype would round first
    dt = torch.float32 if quant == "int8" else model.cfg.dtype
    layers = list(model.decoder_layers)

    def kernel(lin):
        return lin.weight.detach().t()

    with torch.no_grad():
        packed = {
            "w_attn": torch.stack([
                torch.cat(
                    [kernel(getattr(lp.self_attn, m)) for m in ("q", "k", "v", "out")]
                    + [kernel(lp.cross_attn.q), kernel(lp.cross_attn.out)],
                    dim=1,
                )
                for lp in layers
            ]).to(dt).contiguous(),
            "bias": torch.stack([
                torch.cat(
                    [getattr(lp.self_attn, m).bias for m in ("q", "k", "v", "out")]
                    + [lp.cross_attn.q.bias, lp.cross_attn.out.bias,
                       lp.ff.fc1.bias, lp.ff.fc2.bias]
                )[None, :]
                for lp in layers
            ]).float().contiguous(),
            "ln": torch.stack([
                torch.stack([
                    lp.norm1.weight, lp.norm1.bias,
                    lp.norm2.weight, lp.norm2.bias,
                    lp.norm3.weight, lp.norm3.bias,
                ])
                for lp in layers
            ]).float().contiguous(),
            "w_ff1": torch.stack([kernel(lp.ff.fc1) for lp in layers]).to(dt).contiguous(),
            "w_ff2": torch.stack([kernel(lp.ff.fc2) for lp in layers]).to(dt).contiguous(),
        }
        if quant == "int8":
            scales = []
            for k in ("w_attn", "w_ff1", "w_ff2"):
                packed[k], sc = quantize_columns(packed[k])
                scales.append(sc)
            packed["scale"] = torch.cat(scales, dim=-1).contiguous()
        if model.norm_d is not None:
            packed["fin_ln"] = torch.stack(
                [model.norm_d.weight, model.norm_d.bias]
            ).float().contiguous()
        fc_w = kernel(model.fc).float()
        V = fc_w.shape[1]
        packed["fc_w"] = torch.nn.functional.pad(fc_w, (0, vpad - V)).contiguous()
        packed["fc_b"] = torch.nn.functional.pad(
            model.fc.bias.float(), (0, vpad - V), value=-1e9
        ).contiguous()
        packed["emb"] = torch.nn.functional.pad(
            model.embedding.weight.detach().to(model.cfg.dtype), (0, 0, 0, vpad - V)
        ).contiguous()
    return packed


def pack_sampling_tables(vocab, tables, fast_tables, vpad: int) -> Dict[str, np.ndarray]:
    """Host tables for the v3 token's grammar and sampling (JAX :571):
    state_masks_f (2 * N_SID, vpad) f32 (1 = allowed), class_mat (vpad, 8)
    f32 and sid_tbl (16,) int32, all from the fast grammar tables.  The
    decoder moves them to its device once."""
    state_masks, sid_from_bits, _ = fast_tables
    sm = np.asarray(state_masks, dtype=np.float32)  # (2, N_SID, V)
    two, n_sid, V = sm.shape
    out = np.zeros((two * n_sid, vpad), np.float32)
    out[:, :V] = sm.reshape(two * n_sid, V)
    cm = np.zeros((vpad, _N_CLASSES), np.float32)
    t = tables
    cm[:V, _CL_PITCH] = np.asarray(t.pitch, np.float32)
    cm[:V, _CL_DUR] = np.asarray(t.duration_only, np.float32)
    cm[:V, _CL_SEP] = np.asarray(t.sep, np.float32)
    cm[:V, _CL_REST] = np.asarray(t.rest, np.float32)
    cm[:V, _CL_STEP] = np.asarray(t.step, np.float32)
    cm[:V, _CL_EOS] = np.asarray(t.eos, np.float32)
    if t.continue_index >= 0:
        cm[t.continue_index, _CL_CONT] = 1.0
    return {
        "state_masks_f": out,
        "class_mat": cm,
        "sid_tbl": np.asarray(sid_from_bits, np.int32),
    }


def stack_kv_cache(cross_cache: Dict[str, Tuple[torch.Tensor, torch.Tensor]], n_layers: int) -> torch.Tensor:
    """Per-layer dict of ((B,S,H,hd), (B,S,H,hd)) -> (nl, B, S, 2D) interleaved."""
    rows = []
    for i in range(n_layers):
        k, v = cross_cache[f"layer_{i}"]
        B, S = k.shape[0], k.shape[1]
        rows.append(torch.cat([k.reshape(B, S, -1), v.reshape(B, S, -1)], dim=-1))
    return torch.stack(rows).contiguous()


# ---------------------------------------------------------------------------
# The plain twin: the kernel's math in torch (f32 softmax, LayerNorm and
# accumulation; bf16 operands stay bf16-valued)
# ---------------------------------------------------------------------------


def _layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


def _attend(q, kv, n_valid, H, extra_kv=None):
    """Softmax attention of one query row per batch element against the
    first ``n_valid[b]`` rows of an interleaved (B, L, 2D) K|V cache, plus
    an optional current row ``extra_kv = (k (B, D), v (B, D))``."""
    B, D = q.shape
    HD = D // H
    L = kv.shape[1]
    k = kv[..., :D].float().reshape(B, L, H, HD)
    v = kv[..., D:].float().reshape(B, L, H, HD)
    qh = q.reshape(B, H, HD)
    scores = torch.einsum("bhd,blhd->bhl", qh, k) / math.sqrt(HD)
    valid = torch.arange(L, device=q.device)[None, :] < n_valid[:, None]  # (B, L)
    scores = scores.masked_fill(~valid[:, None, :], -math.inf)
    v = v.masked_fill(~valid[:, :, None, None], 0.0)
    if extra_kv is not None:
        k_x, v_x = (t.reshape(B, 1, H, HD) for t in extra_kv)
        scores = torch.cat([scores, torch.einsum("bhd,blhd->bhl", qh, k_x) / math.sqrt(HD)], dim=-1)
        v = torch.cat([v, v_x], dim=1)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhl,blhd->bhd", w, v).reshape(B, D)


def host_position(index) -> int:
    """A position given as a host int or as a (B,) int32 position tensor
    (one equal entry a batch row, as the CUDA wrappers and the decode graph
    take it); the twins read it on the host."""
    if isinstance(index, torch.Tensor):
        return int(index.reshape(-1)[0])
    return int(index)


def fused_decode_step_reference(
    packed: Dict[str, torch.Tensor],
    x_emb: torch.Tensor,
    self_kv: torch.Tensor,
    cross_kv: torch.Tensor,
    index,
    cross_len: torch.Tensor,
    *,
    n_layers: int,
    d_model: int,
    nhead: int,
    d_ff: int,
    vpad: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of :func:`fused_decode_step`, on any device."""
    fused_decode_step_reference.calls += 1
    return _decode_step_math(
        packed, x_emb, self_kv, cross_kv, index, cross_len,
        n_layers=n_layers, d_model=d_model, nhead=nhead, d_ff=d_ff, vpad=vpad,
    )


def _rowvec_math(x, w, cdt, colscale=None):
    """x @ w with both operands rounded to the compute dtype ``cdt`` (exact
    for int8 |q| <= 127) and f32 sums; an int8 ``w`` then takes its column
    scales, as the TPU kernel's ``rescale(dot)``."""
    y = x.to(cdt).float() @ w.to(cdt).float()
    return y if colscale is None else y * colscale


def rowvec_int8_reference(x, q, scale, bias, *, relu: bool = False,
                          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain-torch twin of :func:`rowvec_int8`: ``act((x . q) * scale +
    bias)`` with x rounded to ``compute_dtype``, in f32."""
    rowvec_int8_reference.calls += 1
    y = _rowvec_math(x, q, compute_dtype, scale) + bias
    return torch.relu(y) if relu else y


rowvec_int8_reference.calls = 0


def _decode_step_math(packed, x_emb, self_kv, cross_kv, index, cross_len, *,
                      n_layers, d_model, nhead, d_ff, vpad):
    D, F = d_model, d_ff
    quant = "scale" in packed
    # int8 matrices run in the cache dtype, the model's compute dtype (JAX
    # casts the int8 blocks to it); otherwise in the weights' own dtype
    cdt = self_kv.dtype if quant else packed["w_attn"].dtype
    index = int(index)
    B = x_emb.shape[0]
    n_self = torch.full((B,), index, dtype=torch.int64, device=x_emb.device)
    cross_len = cross_len.to(torch.int64)

    x = x_emb.float()
    new_kv = []
    for i in range(n_layers):
        w = packed["w_attn"][i]
        b = packed["bias"][i, 0]
        ln = packed["ln"][i]
        sc = packed["scale"][i, 0] if quant else None

        def mm(a, wm, lo, hi):  # f32 sums of the rounded operands, then + bias
            return _rowvec_math(a, wm, cdt, None if sc is None else sc[lo:hi]) + b[lo:hi]

        qkv = mm(x, w[:, : 3 * D], 0, 3 * D)
        new_kv.append(qkv[:, D:].to(self_kv.dtype))
        att = _attend(
            qkv[:, :D], self_kv[i, :, :index], n_self, nhead,
            extra_kv=(qkv[:, D : 2 * D], qkv[:, 2 * D :]),
        )
        o = mm(att, w[:, 3 * D : 4 * D], 3 * D, 4 * D)
        x = _layernorm(x + o, ln[0], ln[1])
        qc = mm(x, w[:, 4 * D : 5 * D], 4 * D, 5 * D)
        att = _attend(qc, cross_kv[i], cross_len, nhead)
        o = mm(att, w[:, 5 * D : 6 * D], 5 * D, 6 * D)
        x = _layernorm(x + o, ln[2], ln[3])
        h = torch.relu(mm(x, packed["w_ff1"][i], 6 * D, 6 * D + F))
        y = mm(h, packed["w_ff2"][i], 6 * D + F, 7 * D + F)
        x = _layernorm(x + y, ln[4], ln[5])
    if "fin_ln" in packed:
        x = _layernorm(x, packed["fin_ln"][0], packed["fin_ln"][1])
    logits = x @ packed["fc_w"] + packed["fc_b"]
    return logits, torch.stack(new_kv)


fused_decode_step_reference.calls = 0


def pe_row(index, D: int, device=None) -> torch.Tensor:
    """The sinusoidal row of one position, (D,) f32, computed analytically
    as the TPU kernel's ``_pe_row`` (:604) does: lane l is sin (l even) or
    cos (l odd) of ``index * exp(-ln(1e4) * (l - l % 2) / D)``."""
    lane = torch.arange(D, device=device)
    freq = torch.exp((lane - lane % 2).float() * (-math.log(10000.0) / D))
    angle = torch.tensor(float(index), device=device) * freq
    return torch.where(lane % 2 == 0, torch.sin(angle), torch.cos(angle))


def embed_pe_reference(emb: torch.Tensor, tokens: torch.Tensor, index, D: int) -> torch.Tensor:
    """Plain-torch twin of ``embed_pe_kernel``: the input row (B, D) f32 of
    ``tokens`` (B,) at position ``index`` (a host int or a position
    tensor): the embedding row x sqrt(D) plus the analytic PE row, in f32
    (not rounded before the first layer, as the TPU kernel keeps ``x_s`` in
    f32)."""
    return (emb[tokens.long()].float() * math.sqrt(D)
            + pe_row(host_position(index), D, emb.device))


def sampling_scores(
    logits: torch.Tensor,  # (B, vpad) f32
    state: torch.Tensor,  # (6, B) int32
    aux: torch.Tensor,  # (2, B) int32
    span_types: torch.Tensor,  # (B, max_spans) int32
    noise_row: Optional[torch.Tensor],  # (B, vpad) f32 Gumbel row; None when greedy
    tables: Dict[str, torch.Tensor],
    *,
    mode: int,
    max_spans: int,
    nucleus_p,
    temperature: float,
    greedy: bool,
    n_sid: int,
):
    """The scores the v3 token takes its argmax over (JAX ``_sample_and_advance_b``
    :637-672, batched over B): the grammar row, masked logits over the
    temperature, the log-softmax, the nucleus rule and the Gumbel row.
    Returns ``(final (B, vpad), above (B, vpad) or None)``, where ``above``
    is the probability mass strictly above each lane's (nucleus only)."""
    B = logits.shape[0]
    rows = torch.arange(B, device=logits.device)
    bits = state[ST_BITS].long()
    steps = state[ST_STEPS].long()
    cur_type = span_types[rows, state[ST_SPAN].long().clamp(max=max_spans - 1)].long()
    is_start = steps == 1
    flag_sid = tables["sid_tbl"].long()[bits]
    start_sid = 5 + cur_type
    if mode == 1:
        sid = torch.where(is_start, start_sid, flag_sid)
    else:
        sid = torch.where(bits > 0, flag_sid, torch.where(is_start, start_sid, 0))
    allowed = tables["state_masks_f"][aux[AUX_NOWHOLE].long() * n_sid + sid]
    masked = torch.where(allowed > 0, logits, NEG) / temperature
    # jax.nn.log_softmax's formula, so both packages round alike
    shifted = masked - masked.amax(dim=-1, keepdim=True)
    logp = shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))
    if greedy:
        return logp, None
    above = None
    if nucleus_p is not None:
        probs = torch.exp(logp)
        above = torch.sum(probs[:, None, :] * (probs[:, None, :] > probs[:, :, None]), dim=-1)
        logp = torch.where(above < nucleus_p, logp, NEG)
    return logp + noise_row, above


def sample_and_advance_reference(
    logits, state, aux, span_types, noise, index, tables, *,
    mode: int, max_spans: int, span_cap: int, eos_index: int, mask_index: int,
    nucleus_p, temperature: float, greedy: bool, n_sid: int, span_body: int,
) -> torch.Tensor:
    """Plain-torch twin of ``sample_advance_kernel``: the sampled token and
    the (6, B) int32 state advance of JAX :673-722 for every row; ``index``
    a host int or a position tensor."""
    index = host_position(index)
    final, _ = sampling_scores(
        logits, state, aux, span_types, None if greedy else noise[index], tables,
        mode=mode, max_spans=max_spans, nucleus_p=nucleus_p,
        temperature=temperature, greedy=greedy, n_sid=n_sid,
    )
    sampled = torch.argmax(final, dim=-1)  # the first index on ties, as jnp.argmax
    B = logits.shape[0]
    rows = torch.arange(B, device=logits.device)
    bits = state[ST_BITS].long()
    steps = state[ST_STEPS].long()
    span_idx = state[ST_SPAN].long()
    done = state[ST_DONE] > 0
    cur_type = span_types[rows, span_idx.clamp(max=max_spans - 1)].long()
    fl = tables["class_mat"][sampled] > 0  # (B, 8)
    is_pitch, is_dur, is_sep, is_rest, is_step, is_cont = (
        fl[:, c] for c in (_CL_PITCH, _CL_DUR, _CL_SEP, _CL_REST, _CL_STEP, _CL_CONT)
    )
    b_sep, b_cont, b_pitch, b_rest = ((bits & m) > 0 for m in (8, 4, 2, 1))
    if mode == 1:
        n_sep = n_rest = torch.zeros_like(is_pitch)
        n_cont = torch.where(is_step, True, torch.where(is_pitch | is_dur, False, b_cont))
        n_pitch = torch.where(is_pitch, True, torch.where(is_step | is_dur, False, b_pitch))
    else:
        n_sep = torch.where(is_sep, True, torch.where(is_cont | is_pitch, False, b_sep))
        n_cont = torch.where(is_cont, True, torch.where(is_pitch, False, b_cont))
        n_pitch = torch.where(is_pitch, True, torch.where(is_dur, False, b_pitch))
        n_rest = torch.where(is_rest, True, torch.where(is_dur, False, b_rest))
    new_bits = n_sep.long() * 8 + n_cont.long() * 4 + n_pitch.long() * 2 + n_rest.long()

    control_done = (cur_type != span_body) & (steps >= 2)
    # the cap counts the introducing m_0 (reference generation.py:542)
    end_span = (sampled == eos_index) | (steps >= span_cap) | control_done
    new_span_idx = torch.where(end_span, span_idx + 1, span_idx)
    now_done = done | (new_span_idx >= aux[AUX_NSPANS].long())
    next_tok = torch.where(end_span, mask_index, sampled)
    next_tok = torch.where(now_done, 0, next_tok)  # now_done covers done
    new_bits = torch.where(end_span | done, 0, new_bits)
    new_steps = torch.where(end_span, 1, steps + 1)
    new_len = torch.where(next_tok != 0, index + 2, state[ST_LEN].long())
    return torch.stack(
        [next_tok, new_bits, new_steps, new_span_idx, now_done.long(), new_len]
    ).to(torch.int32)


def sample_advance_embed_reference(logits, state, aux, span_types, noise, index, tables, emb,
                                   **skw) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of ``sample_advance_kernel`` with its fold: the
    state advance of :func:`sample_and_advance_reference` and the next
    token's input row x (B, D) f32, :func:`embed_pe_reference` of the new
    state's token at position ``index + 1``."""
    new_state = sample_and_advance_reference(logits, state, aux, span_types, noise, index,
                                             tables, **skw)
    x = embed_pe_reference(emb, new_state[ST_TOKEN], host_position(index) + 1, emb.shape[1])
    return new_state, x


def fused_decode_token_reference(
    packed: Dict[str, torch.Tensor],
    tables: Dict[str, torch.Tensor],
    state: torch.Tensor,
    aux: torch.Tensor,
    span_types: torch.Tensor,
    noise: Optional[torch.Tensor],
    self_kv: torch.Tensor,
    cross_kv: torch.Tensor,
    index,
    cross_len: torch.Tensor,
    *,
    n_layers: int, d_model: int, nhead: int, d_ff: int, vpad: int,
    mode: int, max_spans: int, span_cap: int, eos_index: int, mask_index: int,
    nucleus_p, temperature: float, greedy: bool, n_sid: int, span_body: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of :func:`fused_decode_token`, on any device: the
    embedding row x sqrt(D) plus the analytic PE row, in f32 (not rounded
    before the first layer, as the TPU kernel keeps ``x_s`` in f32), then
    the v2 twin, then the sampler and state advance.  ``index`` is a host
    int or a position tensor."""
    fused_decode_token_reference.calls += 1
    return _decode_token_math(
        packed, tables, state, aux, span_types, noise, self_kv, cross_kv, index, cross_len,
        n_layers=n_layers, d_model=d_model, nhead=nhead, d_ff=d_ff, vpad=vpad,
        mode=mode, max_spans=max_spans, span_cap=span_cap, eos_index=eos_index,
        mask_index=mask_index, nucleus_p=nucleus_p, temperature=temperature,
        greedy=greedy, n_sid=n_sid, span_body=span_body,
    )


def _decode_token_math(packed, tables, state, aux, span_types, noise, self_kv, cross_kv,
                       index, cross_len, *, n_layers, d_model, nhead, d_ff, vpad, **skw):
    index = host_position(index)
    x = embed_pe_reference(packed["emb"], state[ST_TOKEN], index, d_model)
    logits, new_kv = _decode_step_math(
        packed, x, self_kv, cross_kv, index, cross_len,
        n_layers=n_layers, d_model=d_model, nhead=nhead, d_ff=d_ff, vpad=vpad,
    )
    new_state = sample_and_advance_reference(logits, state, aux, span_types, noise, index,
                                             tables, **skw)
    return new_state, new_kv


fused_decode_token_reference.calls = 0


def fused_decode_tokens_reference(
    packed: Dict[str, torch.Tensor],
    tables: Dict[str, torch.Tensor],
    state: torch.Tensor,
    aux: torch.Tensor,
    span_types: torch.Tensor,
    noise: Optional[torch.Tensor],
    self_kv: torch.Tensor,
    cross_kv: torch.Tensor,
    index,
    cross_len: torch.Tensor,
    *,
    n_layers: int, d_model: int, nhead: int, d_ff: int, vpad: int,
    mode: int, max_spans: int, span_cap: int, eos_index: int, mask_index: int,
    nucleus_p, temperature: float, greedy: bool, n_sid: int, span_body: int,
    T_chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-torch twin of :func:`fused_decode_tokens`: the v3 twin's token
    at positions ``index + t`` for t < T_chunk, token t attending the cache
    rows below ``index`` and the chunk's rows before t.  ``self_kv`` is not
    written.  ``index`` is a host int or a position tensor."""
    fused_decode_tokens_reference.calls += 1
    base = host_position(index)
    kw = dict(n_layers=n_layers, d_model=d_model, nhead=nhead, d_ff=d_ff, vpad=vpad,
              mode=mode, max_spans=max_spans, span_cap=span_cap, eos_index=eos_index,
              mask_index=mask_index, nucleus_p=nucleus_p, temperature=temperature,
              greedy=greedy, n_sid=n_sid, span_body=span_body)
    tokens, rows = [], []
    for t in range(T_chunk):
        cache = self_kv if t == 0 else torch.cat(
            [self_kv[:, :, :base], torch.stack(rows, dim=2)], dim=2)
        state, kv = _decode_token_math(packed, tables, state, aux, span_types, noise, cache,
                                       cross_kv, base + t, cross_len, **kw)
        rows.append(kv)
        tokens.append(state[ST_TOKEN])
    return state, torch.stack(tokens), torch.stack(rows, dim=1)


fused_decode_tokens_reference.calls = 0


def fused_verify_window_reference(
    packed: Dict[str, torch.Tensor],
    x_emb: torch.Tensor,
    self_kv: torch.Tensor,
    cross_kv: torch.Tensor,
    index,
    cross_len: torch.Tensor,
    *,
    n_layers: int,
    d_model: int,
    nhead: int,
    d_ff: int,
    vpad: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of :func:`fused_verify_window`: W sequential v2
    steps, row j at position ``index + j`` over the cache's first ``index``
    rows spliced with the window's K|V rows before j (in the cache dtype, as
    the kernel reads them back from ``new_kv``).  ``self_kv`` is not
    written."""
    fused_verify_window_reference.calls += 1
    if "scale" in packed:
        raise ValueError("the verify window does not take int8 weights")
    index = host_position(index)
    kw = dict(n_layers=n_layers, d_model=d_model, nhead=nhead, d_ff=d_ff, vpad=vpad)
    logits, rows = [], []
    for j in range(x_emb.shape[0]):
        cache = self_kv if j == 0 else torch.cat(
            [self_kv[:, :, :index], torch.stack(rows, dim=2)], dim=2)
        lg, kv = _decode_step_math(packed, x_emb[j : j + 1], cache, cross_kv, index + j,
                                   cross_len, **kw)
        logits.append(lg[0])
        rows.append(kv)
    return torch.stack(logits), torch.cat(rows, dim=1)


fused_verify_window_reference.calls = 0


def pack_spec_tables(fast_tables, vpad: int) -> Dict[str, np.ndarray]:
    """The grammar's ``next_bits`` (16, V) transition table padded to (16,
    vpad) int32, the one table ``spec_advance_kernel`` reads beside
    :func:`pack_sampling_tables`' (the decoder adds it to that dict)."""
    nb = np.asarray(fast_tables[2], np.int32)
    out = np.zeros((nb.shape[0], vpad), np.int32)
    out[:, : nb.shape[1]] = nb
    return {"next_bits": out}


def build_draft_reference(out: torch.Tensor, pos: int, src: torch.Tensor, K: int) -> torch.Tensor:
    """JAX ``build_draft`` (``infer/decode.py:509-534``): the K tokens that
    follow the latest match of the bigram (out[pos - 1], out[pos]) ending at
    1..pos-1 in the emitted stream ``out`` (L,), else its latest match in
    the source row ``src`` (S,) never at a padding id, else zeros."""
    L, S = out.shape[0], src.shape[0]
    key0, key1 = out[max(pos - 1, 0)], out[pos]
    jj_out = torch.arange(L, device=out.device)
    out_shift = torch.cat([out.new_zeros(1), out[:-1]])
    m_out = (out_shift == key0) & (out == key1) & (jj_out >= 1) & (jj_out <= pos - 1)
    j_out = int(torch.where(m_out, jj_out, -1).max())
    jj_src = torch.arange(S, device=src.device)
    src_shift = torch.cat([src.new_zeros(1), src[:-1]])
    m_src = (src_shift == key0) & (src == key1) & (jj_src >= 1) & (src != 0)
    j_src = int(torch.where(m_src, jj_src, -1).max())
    if j_out >= 0:
        start = max(min(j_out + 1, L - K), 0)
        return out[start : start + K].clone()
    if j_src >= 0:
        start = max(min(j_src + 1, S - K), 0)
        return src[start : start + K].to(out.dtype)
    return out.new_zeros(K)


def draft_tables_reference(out: torch.Tensor, pos: int, src: torch.Tensor, vpad: int) -> torch.Tensor:
    """The draft tables ``spec_advance_kernel`` keeps, as its ``prime``
    builds them at position ``pos``: (2, vpad, vpad) int32, [0][x, y] the
    latest j in 1..pos-1 with (out[j - 1], out[j]) = (x, y), [1][x, y] the
    latest j in 1..S-1 with (src[j - 1], src[j]) = (x, y) and src[j] != 0,
    -1 where none; a bigram with a token outside [0, vpad) is not kept."""
    tbl = torch.full((2, vpad * vpad), -1, dtype=torch.int32, device=out.device)

    def put(t, seq, end, ok=None):
        j = torch.arange(1, max(end, 1), device=seq.device)
        x, y = seq[j - 1].long(), seq[j].long()
        keep = (x >= 0) & (x < vpad) & (y >= 0) & (y < vpad)
        if ok is not None:
            keep &= ok[j]
        t.scatter_reduce_(0, (x * vpad + y)[keep], j[keep].to(torch.int32), reduce="amax")

    put(tbl[0], out, pos)
    put(tbl[1], src, src.shape[0], src != 0)
    return tbl.view(2, vpad, vpad)


def spec_window_rows(window, pos: int, emb, pos_table, emb_scale: float, compute_dtype):
    """The W verify rows of ``window`` at ``pos`` (JAX :471-474): the f32
    embedding x sqrt(D) plus the PE table's rows, rounded to the compute
    dtype, then f32.  A row past the table takes its last row (such a
    window is never verified)."""
    rows = (pos + torch.arange(window.shape[0], device=window.device)).clamp(
        max=pos_table.shape[0] - 1)
    e = torch.where((window >= 0)[:, None] & (window < emb.shape[0])[:, None],
                    emb[window.long().clamp(0, emb.shape[0] - 1)], 0.0)
    return (e * emb_scale + pos_table[rows]).to(compute_dtype).float()


def spec_slot_rows(carry, window, span_types, no_whole, fast_tables, *, mode: int,
                   max_spans: int, mask_index: int):
    """The state each of a window's W slots samples under (JAX
    :555-583): the assumed-emission chain over the K = W - 1 draft tokens
    (an emitted ``m_0`` ends a span and resets the state), and each slot's
    span type and grammar row.  Returns ``(states, steps, spans, cur_type,
    allowed (W, V) bool)``."""
    state_masks, sid_from_bits, next_bits = fast_tables
    dev = carry.device
    state, steps, span = (int(v) for v in carry[SPEC_BITS : SPEC_SPAN + 1].tolist())
    states, steps_w, spans_w = [state], [steps], [span]
    for w in window[1:].tolist():
        ended = w == mask_index
        states.append(0 if ended else int(next_bits[states[-1], w]))
        steps_w.append(1 if ended else steps_w[-1] + 1)
        spans_w.append(spans_w[-1] + int(ended))
    states, steps_w, spans_w = (torch.tensor(v, device=dev) for v in (states, steps_w, spans_w))
    cur_type = span_types[spans_w.clamp(max=max_spans - 1)].long()
    allowed = allowed_mask_fast(state_masks, sid_from_bits, states, steps_w == 1, cur_type,
                                no_whole, start_overrides=(mode == 1))
    return states, steps_w, spans_w, cur_type, allowed


def spec_advance_reference(
    logits: Optional[torch.Tensor],  # (W, vpad) f32, the verify's; None with prime
    carry: torch.Tensor,  # (SPEC_CARRY,) int32
    out: torch.Tensor,  # (L,) int32
    window: torch.Tensor,  # (W,) int32: [out[pos], draft]
    src: torch.Tensor,  # (S,) int32
    span_types: torch.Tensor,  # (max_spans,) int32
    aux: torch.Tensor,  # (2,) int32: n_spans, no_whole
    fast_tables,  # (state_masks (2, N_SID, V) bool, sid_from_bits (16,), next_bits (16, V))
    noise: Optional[torch.Tensor],  # (L, >= V) f32 Gumbel rows; None when greedy
    uniforms: Optional[torch.Tensor],  # (L,) f32; None when greedy
    emb: torch.Tensor,  # (V, D) f32
    pos_table: torch.Tensor,  # (max_len, D) f32
    *,
    mode: int, max_spans: int, span_cap: int, eos_index: int, mask_index: int,
    nucleus_p, temperature: float, greedy: bool, span_body: int, compute_dtype,
    prime: bool = False, n_sid: Optional[int] = None,  # the kernel's; the masks carry it here
) -> Dict[str, torch.Tensor]:
    """Plain-torch twin of ``spec_advance_kernel``: one iteration of JAX's
    ``_decode_v5`` after its verify (``infer/decode.py:539-651``, the tail
    :660-698 at W = 1), line by line, for W = len(window) slots and K = W - 1
    drafts; then the next draft (:func:`build_draft_reference`), window and
    input rows (:func:`spec_window_rows`).  An iteration whose carry is done
    or whose window no longer fits (pos + W >= L), or ``prime``, samples
    nothing and changes nothing but the next window and its rows.  Returns
    ``carry``, ``out``, ``window`` (new tensors), ``x`` (W, D) f32 and
    ``kv_rows`` (W,) int64, the cache rows the verify wrote (pos + j)."""
    spec_advance_reference.calls += 1
    state_masks, sid_from_bits, next_bits = fast_tables
    V = next_bits.shape[1]
    W, L = window.shape[0], out.shape[0]
    K = W - 1
    dev = carry.device
    pos, done, state, steps, span, length = (int(v) for v in carry[:6].tolist())
    n_spans, no_whole = int(aux[0]), bool(aux[1])
    carry, out = carry.clone(), out.clone()
    iota = torch.arange(W, device=dev)
    m = 0
    if not prime and not done and pos + W < L:
        draft = window[1:].long()
        states, steps_w, spans_w, cur_type, allowed = spec_slot_rows(
            carry, window, span_types, no_whole, fast_tables, mode=mode, max_spans=max_spans,
            mask_index=mask_index)
        # one batched sampling pass over all W slots
        lg = logits[:, :V]
        if greedy:
            sampled = greedy_sample(lg, allowed)
        else:
            g, u = noise[pos : pos + W, :V], uniforms[pos : pos + W]
            proposals = torch.cat([draft.clamp(min=0), draft.new_zeros(1)])
            spec_tok, _ = spec_accept_resample(u, g, lg, allowed, proposals, nucleus_p, temperature)
            plain_tok = masked_sample_gumbel(g, lg, allowed, nucleus_p, temperature)
            # slot K has no draft: a plain sample (the bonus token)
            sampled = torch.where(iota == K, plain_tok, spec_tok)
        # the plain loop's bookkeeping for each slot
        control_done = (cur_type != span_body) & (steps_w >= 2)
        end_span = (sampled == eos_index) | (steps_w >= span_cap) | control_done
        new_span = torch.where(end_span, spans_w + 1, spans_w)
        now_done = new_span >= n_spans
        next_tok = torch.where(end_span, mask_index, sampled)
        next_tok = torch.where(now_done, 0, next_tok)
        # the accepted prefix: slot i emits iff every earlier slot emitted its
        # window token and did not finish the session
        match = torch.cat([next_tok[:K] == draft, torch.zeros(1, dtype=torch.bool, device=dev)])
        keep = (match & ~now_done).long()
        emit = torch.cat([keep.new_ones(1), torch.cumprod(keep, 0)[:K]]).bool()
        m = int(emit.sum())
        out[pos + 1 : pos + 1 + W] = torch.where(emit, next_tok, 0).to(out.dtype)
        cand = torch.where(emit & (next_tok != 0), pos + iota + 2, 0)
        length = max(length, int(cand.max()))
        # the post-state of the last emitted slot becomes the carry
        st_post = torch.where(end_span, 0, update_bits(next_bits, states, sampled))
        steps_post = torch.where(end_span, 1, steps_w + 1)
        last = m - 1
        carry[:6] = torch.tensor([pos + m, int(now_done[last]), int(st_post[last]),
                                  int(steps_post[last]), int(new_span[last]), length],
                                 dtype=carry.dtype, device=dev)
    P = pos + m
    draft = build_draft_reference(out, P, src, K) if K > 0 else out.new_zeros(0)
    window = torch.cat([out[P : P + 1], draft.to(out.dtype)])
    x = spec_window_rows(window, P, emb, pos_table, math.sqrt(emb.shape[1]), compute_dtype)
    return dict(carry=carry, out=out, window=window, x=x, kv_rows=pos + iota.long())


spec_advance_reference.calls = 0


# ---------------------------------------------------------------------------
# The CUDA kernels: build, bind, launch
# ---------------------------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA decode kernels cannot be built")


def source_digest(csrc: Path = _CSRC) -> str:
    """A hash over every file under ``csrc`` (the ``.cu`` sources and the
    headers they include), each by its path relative to ``csrc`` and its
    bytes, taken in sorted path order: a changed header names a new
    library, and the order the directory lists its files in does not."""
    h = hashlib.sha256()
    for path in sorted(p for p in csrc.rglob("*") if p.is_file()):
        rel = path.relative_to(csrc).as_posix()
        data = path.read_bytes()
        h.update(f"{rel}\0{len(data)}\0".encode() + data)
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile ``csrc/*.cu`` into one shared library under
    ``build/torch_kernels/`` unless a library of the same
    :func:`source_digest` is there already.  One nvcc per source, all
    started together (``-I csrc`` for the shared headers), then one link.
    Raises with nvcc's stderr when a step fails."""
    digest = source_digest()
    out = _BUILD_DIR / f"libsmer_decode_{digest}.so"
    if out.is_file():
        BUILD_INFO.setdefault("path", str(out))
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("log", "(built before this process)")
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{digest}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in _SOURCES:
        obj = _BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-Xptxas", "-v", "-c", "-o", str(obj),
               str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )))
    logs = []
    for cmd, _, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        logs.append(err)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    for _, obj, _ in jobs:
        obj.unlink()
    BUILD_INFO.update(path=str(out), seconds=time.perf_counter() - t0, log="\n".join(logs))
    return out


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        i, p, f, ll, u = ctypes.c_int, ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong, ctypes.c_uint
        lib.smer_rowvec.argtypes = [i, i, i, p, i, p, i, p, p, p, i, p, i, i, i, i, i,
                                    p, i, p, p, p, p, f, p, p, p]
        lib.smer_attend.argtypes = [i, i, i, i, p, i, p, ll, i, i, p, i, i, p, ll, i, p, i, p, i, f,
                                    i, p, p, p]
        lib.smer_flash_attention.argtypes = [i, i, i, i, i, p, p, p, p, i, f, p, p]
        lib.smer_train_attn_fwd.argtypes = [i] * 8 + [p, p, p, p, p, u, i, f, i, f, p, p]
        lib.smer_train_attn_bwd.argtypes = [i] * 8 + [p, p, p, p, p, p, u, i, f, i, f, p, p, p,
                                                      p, p]
        lib.smer_dropout_keep_mask.argtypes = [i] * 7 + [p, u, p, p]
        lib.smer_flash_train_fwd.argtypes = [i, i, i, i, i, p, p, p, p, i, f, p, p, p]
        lib.smer_flash_train_bwd.argtypes = [i, i, i, i, i, p, p, p, p, p, p, p, i, f, p, p, p, p, p]
        lib.smer_attention_f32_fwd.argtypes = [i, i, i, i, i, i, p, p, p, p, i, f, p, p, p]
        lib.smer_flash_train_bwd_f32.argtypes = [i, i, i, i, i, p, p, p, p, p, p, p, i, f, p, p, p,
                                                 p, p]
        lib.smer_flash_train_bwd_f32_blocks.argtypes = [i, p, p]
        lib.smer_attention_f32_fwd_blocks.argtypes = [i, i, p]
        lib.smer_add_layernorm.argtypes = [i, i, p, p, p, p, p, f, p]
        lib.smer_embed_pe.argtypes = [i, i, p, p, i, i, f, p, i, f, p, p]
        lib.smer_sample_advance.argtypes = (
            [i, i] + [p] * 9 + [i, i, p] + [i] * 7 + [f, f, i, i] + [p, i, i, f, f, p, p]
        )
        lib.smer_spec_advance.argtypes = [p] * 17 + [i] * 16 + [f, f, f, i, i, i, p]
        lib.smer_wide_attn_fwd.argtypes = [i] * 10 + [p] * 6 + [u, i, f, i, f, p, p, p]
        lib.smer_wide_attn_bwd.argtypes = [i] * 10 + [p] * 5 + [u, i, f, i, f] + [p] * 8
        lib.smer_wide_attn_blocks.argtypes = [i, i, i, p]
        for fn in (lib.smer_rowvec, lib.smer_attend, lib.smer_add_layernorm,
                   lib.smer_embed_pe, lib.smer_sample_advance, lib.smer_flash_attention,
                   lib.smer_train_attn_fwd, lib.smer_train_attn_bwd, lib.smer_dropout_keep_mask,
                   lib.smer_flash_train_fwd, lib.smer_flash_train_bwd, lib.smer_attention_f32_fwd,
                   lib.smer_flash_train_bwd_f32, lib.smer_flash_train_bwd_f32_blocks,
                   lib.smer_attention_f32_fwd_blocks, lib.smer_spec_advance,
                   lib.smer_wide_attn_fwd, lib.smer_wide_attn_bwd, lib.smer_wide_attn_blocks):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {rc}")


def _check_compute_dtype(name: str, t: torch.Tensor) -> None:
    if t.dtype not in COMPUTE_DTYPES:
        raise TypeError(f"{name} must be in a compute dtype the kernels take "
                        f"({', '.join(map(str, COMPUTE_DTYPES))}), got {t.dtype}")


def _check_tensors(dev, want) -> None:
    """``want``: name -> (tensor, dtype, shape); each must lie on ``dev``,
    have that dtype and shape and be contiguous."""
    for name, (t, dtype, shape) in want.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_step_inputs(packed, B, dev, self_kv, cross_kv, cross_len, n_layers, D, H, F, vpad, index):
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"the CUDA decode step takes 1 <= B <= {MAX_BATCH}, got B={B}")
    _check_layer_inputs(packed, B, dev, self_kv, cross_kv, cross_len, n_layers, D, H, F, vpad)
    if not 0 <= index < self_kv.shape[2]:
        raise ValueError(f"index={index} outside the self cache of {self_kv.shape[2]} rows")


def _check_layer_inputs(packed, B, dev, self_kv, cross_kv, cross_len, n_layers, D, H, F, vpad):
    """The packed weights and the caches of ``B`` cache rows: the caches in
    the model's compute dtype (bf16 or f32, the self cache's), the
    matrices in it or int8."""
    if D % 64 or D // H not in (64, 128) or D % H:
        raise ValueError(f"d_model={D}, nhead={H}: need d_model % 64 == 0 and head_dim 64 or 128")
    if vpad % 2:
        raise ValueError(f"vpad={vpad} must be even")
    cdt, f32 = self_kv.dtype, torch.float32
    if cdt not in COMPUTE_DTYPES:
        raise TypeError(f"the decode kernels take a bf16 or an f32 model; the self cache is {cdt}")
    wdt = torch.int8 if "scale" in packed else cdt
    L, S = self_kv.shape[2], cross_kv.shape[2]
    want = {
        "self_kv": (self_kv, cdt, (n_layers, B, L, 2 * D)),
        "cross_kv": (cross_kv, cdt, (n_layers, B, S, 2 * D)),
        "cross_len": (cross_len, torch.int32, (B,)),
        "w_attn": (packed["w_attn"], wdt, (n_layers, D, 6 * D)),
        "w_ff1": (packed["w_ff1"], wdt, (n_layers, D, F)),
        "w_ff2": (packed["w_ff2"], wdt, (n_layers, F, D)),
        "bias": (packed["bias"], f32, (n_layers, 1, 7 * D + F)),
        "ln": (packed["ln"], f32, (n_layers, 6, D)),
        "fc_w": (packed["fc_w"], f32, (D, vpad)),
        "fc_b": (packed["fc_b"], f32, (vpad,)),
    }
    if "fin_ln" in packed:
        want["fin_ln"] = (packed["fin_ln"], f32, (2, D))
    if "scale" in packed:
        want["scale"] = (packed["scale"], f32, (n_layers, 1, 7 * D + F))
    _check_tensors(dev, want)


# the split partials and the tickets of rowvec_kernel and attend_kernel, one
# set a (device, stream): launches on one stream run one after another and
# each leaves its tickets at zero, so they share it; two streams never do
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(dev, stream: int, n_floats: int, n_tickets: int):
    key = (dev.index, stream)
    ws, tickets = _SCRATCH.get(key, (None, None))
    if ws is None or ws.numel() < n_floats:
        ws = torch.empty(max(n_floats, 1 << 20), device=dev, dtype=torch.float32)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(max(n_tickets, 1024), device=dev, dtype=torch.int32)
    _SCRATCH[key] = (ws, tickets)
    return ws, tickets


def rowvec_k_split(K: int, N: int) -> int:
    """K rows a block of ``rowvec_kernel`` sums, a function of (K, N)
    alone: 1-4 passes of 16 rows, as few as keep a projection near 256
    blocks (two an SM, all resident at once): the flagship's 512 x 512
    and 2048 x 512 take 32 slices of 16 and 64 rows, QKV 11 slices of 48,
    FFN up 8 of 64, the logits 32 of 16 (192 to 264 blocks)."""
    tiles = -(-N // _ROWVEC_COLS)
    passes = min(4, max(1, -(-K * tiles // (_ROWVEC_PASS * _ROWVEC_BLOCKS))))
    return _ROWVEC_PASS * passes


def _rowvec_kind(w_dtype, cdt) -> int:
    """``smer_rowvec``'s w_kind: W bf16 (0) or f32 (1) in a model of its
    own dtype ``cdt`` (the logits' f32 W in either), or int8 in a bf16 (2)
    or f32 (3) model."""
    if w_dtype == torch.int8:
        return {torch.bfloat16: 2, torch.float32: 3}[cdt]
    if cdt != w_dtype:
        raise TypeError(f"{w_dtype} weights in a {cdt} model")
    return {torch.bfloat16: 0, torch.float32: 1}[w_dtype]


def _launch_rowvec(lib, x, w, ldw, bias, y, *, stream, scratch, cdt, relu=False, kv_out=None,
                   ldkv=0, kv_col0=0, colscale=None, ln=None) -> None:
    """``rowvec_kernel``: ``y = act(x . w [* colscale] + bias)`` for the B
    rows of ``x``, one launch for every 16 rows; w may be bf16, f32 or int8
    (with its column scales ``colscale``), read through a row stride
    ``ldw``; ``scratch`` is the stream's (workspace, tickets) pointers.
    ``cdt``, the compute dtype (:func:`_rowvec_kind`): x is rounded to it
    and ``kv_out`` is in it.  ``ln = (res, gamma, beta, fin)``: the
    launch's LN tail, ``res = LN(res + y)`` in place on res (B, N) f32, then
    ``LN(res)`` with ``fin = (gamma2, beta2)`` unless fin is None (no
    ReLU)."""
    kind = _rowvec_kind(w.dtype, cdt)
    B, K = x.shape
    N = y.shape[1]
    k_split = rowvec_k_split(K, N)
    res, tail = None, (0, None, None, None, None, 0.0)
    if ln is not None:
        res, gamma, beta, fin = ln
        g2, b2 = (None, None) if fin is None else (fin[0].data_ptr(), fin[1].data_ptr())
        tail = (res.stride(0), gamma.data_ptr(), beta.data_ptr(), g2, b2, LN_EPS)

    def rows(t, r):  # a launch's rows of t, if any
        return None if t is None else t[r : r + _ROWVEC_ROWS].data_ptr()

    for r in range(0, B, _ROWVEC_ROWS):
        _check(lib.smer_rowvec(
            kind, int(relu), min(B - r, _ROWVEC_ROWS), rows(x, r), x.stride(0), w.data_ptr(),
            ldw, colscale.data_ptr() if colscale is not None else None, bias.data_ptr(),
            rows(y, r), y.stride(0), rows(kv_out, r), ldkv, kv_col0, K, N, k_split,
            rows(res, r), *tail, *scratch, stream,
        ), "rowvec")
        if kind >= 2:
            rowvec_int8.launches += 1


def _rowvec_need(K: int, N: int, B: int):
    """(workspace floats, tickets) of one ``rowvec_kernel`` launch: a
    counter a column tile, and one more for the launch's LN tail."""
    tiles = -(-N // _ROWVEC_COLS)
    return tiles * _ROWVEC_COLS * -(-K // rowvec_k_split(K, N)) * min(B, _ROWVEC_ROWS), tiles + 1


def _attend_splits(n_rows, lens, max_rows, source, n_chunk, B) -> int:
    """The grid's splits of 64 rows: enough for the most rows a (b, h) sees
    before its current row."""
    most = max_rows if lens is not None else min(n_rows, max_rows)
    most += n_chunk if source == _ROWS_CHUNK else (B - 1 if source == _ROWS_WINDOW else 0)
    return max(1, -(-most // _ATTEND_SPLIT_ROWS))


def _launch_attend(lib, q, kv, bstride, n_rows, lens, max_rows, source, rows, tstride, n_chunk,
                   extra, out, *, H, stream, scratch) -> None:
    """One ``attend_kernel`` launch: the B query rows of ``q`` over the K|V
    rows of ``kv`` (``lens`` (B,) or ``n_rows`` of them, at most
    ``max_rows``), then the ``source`` rows of ``rows`` (both in the
    compute dtype, bf16 or f32), then the current
    row at the pointer ``extra`` (None for none), into ``out`` (B, D) f32;
    ``scratch`` is the stream's (workspace, tickets) pointers."""
    B, D = out.shape
    HD = D // H
    splits = _attend_splits(n_rows, lens, max_rows, source, n_chunk, B)
    _check(lib.smer_attend(
        HD, int(kv.dtype == torch.float32), B, H, q.data_ptr(), q.shape[1], kv.data_ptr(),
        bstride, D, n_rows, lens.data_ptr() if lens is not None else None, max_rows, source,
        rows.data_ptr() if rows is not None else None, tstride, n_chunk,
        extra, 3 * D, out.data_ptr(), D, 1.0 / math.sqrt(HD), splits, *scratch, stream,
    ), "attend")


def _layer_work(B: int, D: int, F: int, device) -> Dict[str, torch.Tensor]:
    """The f32 temporaries of :func:`_launch_layers` for B rows."""
    f32 = dict(device=device, dtype=torch.float32)
    return dict(qkv=torch.empty(B, 3 * D, **f32), att=torch.empty(B, D, **f32),
                qc=torch.empty(B, D, **f32), o=torch.empty(B, D, **f32),
                h=torch.empty(B, F, **f32))


def _launch_layers(lib, packed, x, self_kv, cross_kv, index, cross_len, logits, new_kv,
                   *, n_layers, D, H, F, vpad, stream, chunk=None, window=False,
                   work=None) -> None:
    """The v2 launches on an f32 activation ``x`` (B, D), updated in place:
    8 a layer and the logits, each post-LN the tail of the projection
    before it and the final LN chained after the last layer's (the launch
    of FFN down).  Writes ``logits`` (B, vpad)
    f32 and ``new_kv`` (n_layers, B, 2D) (any layer stride, rows
    contiguous).  ``index`` is the host int of cached self rows, or a (B,)
    int32 position tensor on the device, which the self-attention reads as
    its per-row lengths, its splits sized from the cache's capacity: then no
    argument of any launch depends on the position.  ``chunk = (rows
    (n_layers, T, B, 2D), t)`` adds the first t chunk rows to the
    self-attention after the ``index`` cache rows (v4).
    ``window``: the B rows are one sequence's verify window over a cache of
    one batch row (batch stride 0 for the self and cross K|V, ``cross_len``
    (B,) repeating its length); row j attends the ``index`` cache rows,
    then rows 0..j-1 of ``new_kv``, then its own; a position tensor may
    then be (1,) (every row reads its first entry).
    With ``"scale"`` in ``packed`` the six matrices of a layer are int8.
    The compute dtype is the caches' (bf16 or f32): x is rounded to it as
    the matrices read it, and ``new_kv`` (and a chunk's rows) are in it.
    ``work``: the temporaries (:func:`_layer_work`), allocated here if None."""
    cdt = self_kv.dtype
    if cross_kv.dtype != cdt or new_kv.dtype != cdt:
        raise TypeError(f"the caches and new_kv must share the compute dtype: self {cdt}, "
                        f"cross {cross_kv.dtype}, new_kv {new_kv.dtype}")
    B, L, S = x.shape[0], self_kv.shape[2], cross_kv.shape[2]
    self_bstride = 0 if window else L * 2 * D
    cross_bstride = 0 if window else S * 2 * D
    if work is None:
        work = _layer_work(B, D, F, x.device)
    qkv, att, qc, o, h = (work[k] for k in ("qkv", "att", "qc", "o", "h"))
    lens = index if isinstance(index, torch.Tensor) else None
    n_rows = 0 if lens is not None else index
    # the stream's workspace, as large as the largest launch of the step needs
    source = _ROWS_CHUNK if chunk is not None else _ROWS_WINDOW if window else _ROWS_CACHE_ONLY
    splits = max(_attend_splits(n_rows, lens, L, source, chunk[1] if chunk else 0, B),
                 _attend_splits(0, cross_len, S, _ROWS_CACHE_ONLY, 0, B))
    shapes = ((D, 3 * D), (D, F), (F, D), (D, vpad))
    ws, tickets = _scratch(
        x.device, stream,
        max([B * H * splits * (2 + D // H)] + [_rowvec_need(K, N, B)[0] for K, N in shapes]),
        max([B * H] + [_rowvec_need(K, N, B)[1] for K, N in shapes]))
    scratch = (ws.data_ptr(), tickets.data_ptr())
    fin = (packed["fin_ln"][0], packed["fin_ln"][1]) if "fin_ln" in packed else None

    def attend(*args):
        _launch_attend(lib, *args, H=H, stream=stream, scratch=scratch)

    # the current token's K row inside the QKV output; its V row follows at +D
    k_new_ptr = qkv.data_ptr() + D * qkv.element_size()
    ldw = 6 * D
    for i in range(n_layers):
        w = packed["w_attn"][i]
        b = packed["bias"][i, 0]
        ln = packed["ln"][i]
        sc = packed["scale"][i, 0] if "scale" in packed else None

        def rowvec(xin, wm, ldm, lo, y, **kw):  # matrix columns from lo
            _launch_rowvec(lib, xin, wm, ldm, b[lo:], y, stream=stream, scratch=scratch,
                           colscale=None if sc is None else sc[lo:], cdt=cdt, **kw)

        rowvec(x, w, ldw, 0, qkv, kv_out=new_kv[i], ldkv=2 * D, kv_col0=D)
        if chunk is not None:  # the chunk's rows: (T, B, 2D) a layer
            rows = (_ROWS_CHUNK, chunk[0][i], B * 2 * D, chunk[1])
        elif window:  # the window's rows this launch just wrote: (B, 2D)
            rows = (_ROWS_WINDOW, new_kv[i], 2 * D, 0)
        else:
            rows = (_ROWS_CACHE_ONLY, None, 0, 0)
        attend(qkv, self_kv[i], self_bstride, n_rows, lens, L, *rows, k_new_ptr, att)
        rowvec(att, w[:, 3 * D :], ldw, 3 * D, o, ln=(x, ln[0], ln[1], None))
        rowvec(x, w[:, 4 * D :], ldw, 4 * D, qc)
        attend(qc, cross_kv[i], cross_bstride, 0, cross_len, S, _ROWS_CACHE_ONLY, None, 0, 0,
               None, att)
        rowvec(att, w[:, 5 * D :], ldw, 5 * D, o, ln=(x, ln[2], ln[3], None))
        rowvec(x, packed["w_ff1"][i], F, 6 * D, h, relu=True)
        rowvec(h, packed["w_ff2"][i], D, 6 * D + F, o,
               ln=(x, ln[4], ln[5], fin if i == n_layers - 1 else None))
    _launch_rowvec(lib, x, packed["fc_w"], vpad, packed["fc_b"], logits, stream=stream,
                   scratch=scratch, cdt=torch.float32)


def rowvec_int8(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                *, relu: bool = False, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The int8 row-vector product alone: ``act((c(x) . q) * scale +
    bias)`` for x (B, K) f32 rounded to the model's ``compute_dtype`` (bf16,
    or f32: unrounded), q (K, N) int8 (rows may be strided, as a column
    slice of a packed matrix), scale and bias (N,) f32; returns (B, N) f32.
    ``rowvec_kernel`` on CUDA tensors, whose every int8 launch (here and
    inside the decode wrappers) counts in ``rowvec_int8.launches``;
    :func:`rowvec_int8_reference` on CPU tensors."""
    if x.device.type == "cpu":
        return rowvec_int8_reference(x, q, scale, bias, relu=relu, compute_dtype=compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"rowvec_int8 runs on cuda or cpu, not {x.device}")
    B, K = x.shape
    N = q.shape[1]
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"rowvec_int8 takes 1 <= B <= {MAX_BATCH} rows, got {B}")
    if q.dtype != torch.int8 or tuple(q.shape) != (K, N) or q.stride(1) != 1:
        raise ValueError("q must be (K, N) int8 with unit column stride")
    _check_tensors(x.device, {"x": (x, torch.float32, (B, K)),
                              "scale": (scale, torch.float32, (N,)),
                              "bias": (bias, torch.float32, (N,))})
    if q.device != x.device:
        raise ValueError(f"q is on {q.device}, expected {x.device}")
    if compute_dtype not in COMPUTE_DTYPES:
        raise TypeError(f"rowvec_int8 computes in bf16 or f32, not {compute_dtype}")
    if N % 16 or q.stride(0) % 16 or q.data_ptr() % 16:
        raise ValueError("rowvec_kernel reads int8 W in 16-byte pieces: N and the row stride "
                         "must be multiples of 16 and q 16-byte aligned")
    y = torch.empty(B, N, device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ws, tickets = _scratch(x.device, stream, *_rowvec_need(K, N, B))
    _launch_rowvec(load_library(), x, q, q.stride(0), bias, y, relu=relu, colscale=scale,
                   stream=stream, scratch=(ws.data_ptr(), tickets.data_ptr()), cdt=compute_dtype)
    return y


rowvec_int8.launches = 0


def fused_decode_step(
    packed: Dict[str, torch.Tensor],
    x_emb: torch.Tensor,  # (B, D) compute-dtype embedded token (+PE)
    self_kv: torch.Tensor,  # (n_layers, B, L, 2D) interleaved K|V, in the compute dtype
    cross_kv: torch.Tensor,  # (n_layers, B, S, 2D)
    index,  # int: number of cached self rows (= position)
    cross_len: torch.Tensor,  # (B,) int32 valid memory rows
    *,
    n_layers: int,
    d_model: int,
    nhead: int,
    d_ff: int,
    vpad: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, vpad) f32, new_kv (n_layers, B, 2D))."""
    kw = dict(n_layers=n_layers, d_model=d_model, nhead=nhead, d_ff=d_ff, vpad=vpad)
    if x_emb.device.type == "cpu":
        return fused_decode_step_reference(packed, x_emb, self_kv, cross_kv, index, cross_len, **kw)
    if x_emb.device.type != "cuda":
        raise ValueError(f"fused_decode_step runs on cuda or cpu, not {x_emb.device}")
    index = int(index)
    B, D = x_emb.shape[0], d_model
    _check_step_inputs(packed, B, x_emb.device, self_kv, cross_kv, cross_len,
                       n_layers, D, nhead, d_ff, vpad, index)
    _check_tensors(x_emb.device, {"x_emb": (x_emb, self_kv.dtype, (B, D))})
    lib = load_library()
    stream = torch.cuda.current_stream(x_emb.device).cuda_stream
    x = x_emb.to(torch.float32, copy=True)  # a copy (f32 too): the launches update it in place
    logits = torch.empty(B, vpad, device=x.device, dtype=torch.float32)
    new_kv = torch.empty(n_layers, B, 2 * D, dtype=self_kv.dtype, device=x.device)
    _launch_layers(lib, packed, x, self_kv, cross_kv, index, cross_len, logits, new_kv,
                   n_layers=n_layers, D=D, H=nhead, F=d_ff, vpad=vpad, stream=stream)
    fused_decode_step.launches += 1
    return logits, new_kv


fused_decode_step.launches = 0


def fused_verify_window(
    packed: Dict[str, torch.Tensor],
    x_emb: torch.Tensor,  # (W, D) compute-dtype embedded window rows (+PE)
    self_kv: torch.Tensor,  # (n_layers, 1, L, 2D); rows below index are read
    cross_kv: torch.Tensor,  # (n_layers, 1, S, 2D)
    index,  # valid cached self rows (= position of window row 0): an int, or a (1,) int32 tensor
    cross_len: torch.Tensor,  # (1,) int32
    *,
    n_layers: int,
    d_model: int,
    nhead: int,
    d_ff: int,
    vpad: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced decode of W window rows of one sequence (the verify
    of speculative decode, JAX :1368): row j attends the cached
    prefix [0, index) and window rows 0..j, so ``logits[j]`` is the
    next-token distribution after the window's first j + 1 tokens.

    Returns (logits (W, vpad) f32, new_kv (n_layers, W, 2D)); ``self_kv``
    is not written, so the caller splices ``new_kv`` at ``index``.  On CUDA
    the v2 launches run once on all W rows, one weight stream a layer for
    every 16 rows (the row-vector kernel's launch); int8 weights are
    refused, as in JAX (:1397).  A position tensor on the device is read
    there (the self-attention's ``lens``, its splits sized from the cache's
    capacity) and not range-checked: the bits are those of the host int's."""
    kw = dict(n_layers=n_layers, d_model=d_model, nhead=nhead, d_ff=d_ff, vpad=vpad)
    if x_emb.device.type == "cpu":
        return fused_verify_window_reference(packed, x_emb, self_kv, cross_kv, index,
                                             cross_len, **kw)
    if x_emb.device.type != "cuda":
        raise ValueError(f"fused_verify_window runs on cuda or cpu, not {x_emb.device}")
    if "scale" in packed:
        raise ValueError("the verify window does not take int8 weights")
    W, D, dev = x_emb.shape[0], d_model, x_emb.device
    if W < 1:
        raise ValueError(f"the verify window takes at least one row, got W={W}")
    _check_layer_inputs(packed, 1, dev, self_kv, cross_kv, cross_len,
                        n_layers, D, nhead, d_ff, vpad)
    if isinstance(index, torch.Tensor):
        _check_tensors(dev, {"index": (index, torch.int32, (1,))})
    else:
        index = int(index)
        if not 0 <= index <= self_kv.shape[2]:
            raise ValueError(f"index={index} outside the self cache of {self_kv.shape[2]} rows")
    _check_tensors(dev, {"x_emb": (x_emb, self_kv.dtype, (W, D))})
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    x = x_emb.to(torch.float32, copy=True)  # a copy (f32 too): the launches update it in place
    logits = torch.empty(W, vpad, device=dev, dtype=torch.float32)
    new_kv = torch.empty(n_layers, W, 2 * D, dtype=self_kv.dtype, device=dev)
    _launch_layers(lib, packed, x, self_kv, cross_kv, index, cross_len.expand(W).contiguous(),
                   logits, new_kv, n_layers=n_layers, D=D, H=nhead, F=d_ff, vpad=vpad,
                   stream=stream, window=True)
    fused_verify_window.launches += 1
    return logits, new_kv


fused_verify_window.launches = 0


def _check_sampling_inputs(tables, state, aux, span_types, noise, index, vpad, *,
                           greedy, n_sid, max_spans, **_):
    """The sampler's tables and state; ``index`` the host's last position
    to sample (its noise row must exist), or None for a position that lies
    on the device, which the caller bounds."""
    B = state.shape[1]
    if vpad % 32 or not 32 <= vpad <= 1024:
        raise ValueError(f"vpad={vpad}: the sampling kernel needs a multiple of 32 in [32, 1024]")
    want = {
        "state": (state, torch.int32, (6, B)),
        "aux": (aux, torch.int32, (2, B)),
        "span_types": (span_types, torch.int32, (B, max_spans)),
        "state_masks_f": (tables["state_masks_f"], torch.float32, (2 * n_sid, vpad)),
        "class_mat": (tables["class_mat"], torch.float32, (vpad, _N_CLASSES)),
        "sid_tbl": (tables["sid_tbl"], torch.int32, (16,)),
    }
    if not greedy:
        want["noise"] = (noise, torch.float32, (noise.shape[0], B, vpad))
        if index is not None and not 0 <= index < noise.shape[0]:
            raise ValueError(f"index={index} outside the noise of {noise.shape[0]} rows")
    _check_tensors(state.device, want)


def _position(index, B: int, dev) -> torch.Tensor:
    """A private (B,) int32 position vector on ``dev``: filled from a host
    int, or a copy of a position tensor (which the launches then do not
    advance)."""
    if isinstance(index, torch.Tensor):
        _check_tensors(dev, {"index": (index, torch.int32, (B,))})
        return index.clone()
    return torch.full((B,), int(index), dtype=torch.int32, device=dev)


def _launch_embed_pe(lib, emb, state, pos, x, *, stream, pos_offset=0) -> None:
    """``embed_pe_kernel``: ``x`` (B, D) f32 <- the input row of the token
    in ``state`` (6, B) at position ``pos[b] + pos_offset``; ``emb`` (vpad,
    D) in the compute dtype."""
    B, D = x.shape
    tok_ptr = state.data_ptr() + ST_TOKEN * B * state.element_size()
    _check(lib.smer_embed_pe(
        B, D, tok_ptr, emb.data_ptr(), int(emb.dtype == torch.float32), emb.shape[0],
        math.sqrt(D), pos.data_ptr(), pos_offset,
        -math.log(10000.0) / D, x.data_ptr(), stream,
    ), "embed_pe")


def _launch_sample_advance(lib, logits, state, aux, span_types, noise, pos, tables, *,
                           stream, mode, max_spans, span_cap, eos_index, mask_index,
                           nucleus_p, temperature, greedy, n_sid, span_body,
                           pos_offset=0, advance=0, out=None, emb=None, x=None) -> None:
    """``sample_advance_kernel``: samples at position ``pos[b] +
    pos_offset`` and advances ``state`` in place, writes the next token to
    ``out`` (B, *) int32 at column position + 1 when given, adds
    ``advance`` to ``pos``, and, given ``x`` (B, D) f32 and the embedding
    ``emb`` (vpad, D) in the compute dtype, writes the next token's input
    row at position + 1 into ``x``.  A programmatic dependent launch: it may
    begin while the
    launch before it (the logits) runs, and reads its logits once that
    launch has finished.  So the launch just before it may write the
    logits and nothing else that it reads (``smer_sample_advance``'s
    rule)."""
    B, vpad = logits.shape
    use_nucleus = nucleus_p is not None and not greedy
    D = 0 if x is None else x.shape[1]
    _check(lib.smer_sample_advance(
        B, vpad, logits.data_ptr(), state.data_ptr(), aux.data_ptr(), span_types.data_ptr(),
        tables["sid_tbl"].data_ptr(), tables["state_masks_f"].data_ptr(),
        tables["class_mat"].data_ptr(), None if greedy else noise.data_ptr(), pos.data_ptr(),
        pos_offset, advance, out.data_ptr() if out is not None else None,
        out.stride(0) if out is not None else 0, mode, max_spans, span_cap, eos_index,
        mask_index, int(use_nucleus), float(nucleus_p) if use_nucleus else 0.0,
        float(temperature), n_sid, span_body, None if x is None else emb.data_ptr(),
        int(x is not None and emb.dtype == torch.float32), D,
        math.sqrt(D) if D else 0.0, -math.log(10000.0) / D if D else 0.0,
        None if x is None else x.data_ptr(), stream,
    ), "sample_advance")


def sample_and_advance(logits, state, aux, span_types, noise, index, tables, emb=None,
                       **skw):
    """The last stage of the v3 token alone: ``sample_advance_kernel`` on a
    CUDA tensor, :func:`sample_and_advance_reference` on a CPU one; with
    ``emb`` (vpad, D) the kernel's fold too, and then ``(new_state, x)``
    with x the next token's input row (:func:`sample_advance_embed_reference`
    on the CPU).  For holding the kernel against its twin on the same
    logits; the decoder never calls it, and it counts no launch."""
    if logits.device.type == "cpu":
        if emb is None:
            return sample_and_advance_reference(logits, state, aux, span_types, noise, index,
                                                tables, **skw)
        return sample_advance_embed_reference(logits, state, aux, span_types, noise, index,
                                              tables, emb, **skw)
    if logits.device.type != "cuda":
        raise ValueError(f"sample_and_advance runs on cuda or cpu, not {logits.device}")
    B, vpad = logits.shape
    host = None if isinstance(index, torch.Tensor) else int(index)
    want = {"logits": (logits, torch.float32, (B, vpad))}
    if emb is not None:
        _check_compute_dtype("emb", emb)
        want["emb"] = (emb, emb.dtype, (vpad, emb.shape[1]))
    _check_tensors(logits.device, want)
    _check_sampling_inputs(tables, state, aux, span_types, noise, host, vpad, **skw)
    new_state = state.clone()
    pos = _position(index, B, logits.device)
    x = None if emb is None else torch.empty(B, emb.shape[1], device=logits.device)
    # the launch just before the sampler writes only what it reads after
    # its wait, as the logits launch does on the decoder's path
    logits = logits.clone()
    _launch_sample_advance(load_library(), logits, new_state, aux, span_types, noise, pos,
                           tables, stream=torch.cuda.current_stream(logits.device).cuda_stream,
                           emb=emb, x=x, **skw)
    return new_state if emb is None else (new_state, x)


def embed_pe(emb: torch.Tensor, state: torch.Tensor, index) -> torch.Tensor:
    """The input row (B, D) f32 of the token in ``state`` (6, B) at
    ``index`` (a host int or a position tensor) alone: ``embed_pe_kernel``
    on a CUDA tensor, :func:`embed_pe_reference` on a CPU one.  For holding
    the kernel against its twin and the sampler's fold; it counts no
    launch."""
    if state.device.type == "cpu":
        return embed_pe_reference(emb, state[ST_TOKEN], index, emb.shape[1])
    if state.device.type != "cuda":
        raise ValueError(f"embed_pe runs on cuda or cpu, not {state.device}")
    B, (vpad, D), dev = state.shape[1], emb.shape, state.device
    _check_compute_dtype("emb", emb)
    _check_tensors(dev, {"state": (state, torch.int32, (6, B)),
                         "emb": (emb, emb.dtype, (vpad, D))})
    x = torch.empty(B, D, device=dev)
    _launch_embed_pe(load_library(), emb, state, _position(index, B, dev), x,
                     stream=torch.cuda.current_stream(dev).cuda_stream)
    return x


SPEC_VPADS = (128, 256, 384, 512)  # the vocab widths spec_advance_kernel is built for


def _launch_spec_advance(lib, logits, carry, out, window, x, kv_rows, aux, span_types, tables,
                         noise, uniforms, src, emb, pos_table, draft_tbl, *, stream, mode, max_spans,
                         span_cap, eos_index, mask_index, nucleus_p, temperature, greedy, n_sid,
                         span_body, round_bf16: bool, prime: bool = False) -> None:
    """``spec_advance_kernel`` on W = len(window) slots, in place on
    ``carry``, ``out``, ``window`` and the draft tables ``draft_tbl`` (2,
    vpad, vpad) int32 (all -1 before a ``prime``, which builds them:
    :func:`draft_tables_reference`), writing ``x`` and ``kv_rows``; a
    programmatic dependent launch behind the launch before it (the
    verify's logits), which may write the logits and nothing else it reads
    (``smer_spec_advance``'s rule), unless ``prime`` (no logits: the first
    window of a decode).  Counts one launch in ``spec_advance.launches``."""
    W, vpad = window.shape[0], tables["state_masks_f"].shape[1]
    use_nucleus = nucleus_p is not None and not greedy
    _check(lib.smer_spec_advance(
        None if prime else logits.data_ptr(), carry.data_ptr(), out.data_ptr(),
        window.data_ptr(), x.data_ptr(), kv_rows.data_ptr(), aux.data_ptr(),
        span_types.data_ptr(), tables["sid_tbl"].data_ptr(), tables["state_masks_f"].data_ptr(),
        tables["next_bits"].data_ptr(), None if greedy else noise.data_ptr(),
        None if greedy else uniforms.data_ptr(), src.data_ptr(), emb.data_ptr(),
        pos_table.data_ptr(), draft_tbl.data_ptr(), W, out.shape[0], src.shape[0], emb.shape[0],
        emb.shape[1], vpad,
        pos_table.shape[0], max_spans, n_sid, mode, span_cap, eos_index, mask_index, span_body,
        int(greedy), int(use_nucleus), float(nucleus_p) if use_nucleus else 0.0,
        float(temperature), math.sqrt(emb.shape[1]), int(round_bf16), int(prime), int(not prime),
        stream,
    ), "spec_advance")
    spec_advance.launches += 1


def _check_spec_inputs(carry, out, window, src, span_types, aux, tables, noise, uniforms, emb,
                       pos_table, *, greedy, n_sid, max_spans, **_) -> None:
    """The shapes, types and devices ``spec_advance_kernel`` takes."""
    dev, W, L, S = carry.device, window.shape[0], out.shape[0], src.shape[0]
    vpad = tables["state_masks_f"].shape[1]
    if vpad not in SPEC_VPADS:
        raise ValueError(f"spec_advance_kernel is built for vpad in {SPEC_VPADS}, got {vpad}")
    if W < 1 or S < W - 1:
        raise ValueError(f"a window of W={W} rows needs W >= 1 and a source of at least W - 1 "
                         f"ids, got S={S}")
    V, D = emb.shape
    if V > vpad:
        raise ValueError(f"the embedding's {V} rows exceed vpad={vpad}")
    if D % 4:
        raise ValueError(f"spec_advance_kernel writes the input rows four lanes at a time: d_model={D}")
    i32, f32 = torch.int32, torch.float32
    want = {
        "carry": (carry, i32, (SPEC_CARRY,)), "out": (out, i32, (L,)), "window": (window, i32, (W,)),
        "src": (src, i32, (S,)), "span_types": (span_types, i32, (max_spans,)),
        "aux": (aux, i32, (2,)), "sid_tbl": (tables["sid_tbl"], i32, (16,)),
        "state_masks_f": (tables["state_masks_f"], f32, (2 * n_sid, vpad)),
        "next_bits": (tables["next_bits"], i32, (16, vpad)), "emb": (emb, f32, (V, D)),
        "pos_table": (pos_table, f32, (pos_table.shape[0], D)),
    }
    if not greedy:
        want["noise"] = (noise, f32, (L, vpad))
        want["uniforms"] = (uniforms, f32, (L,))
    _check_tensors(dev, want)


def spec_advance(logits, carry, out, window, src, span_types, aux, tables, fast_tables, noise,
                 uniforms, emb, pos_table, *, compute_dtype, prime: bool = False, **skw):
    """One launch of ``spec_advance_kernel`` alone on new copies of the
    carry, output and window (CUDA tensors), or :func:`spec_advance_reference`
    (CPU tensors; it reads ``fast_tables``, the kernel ``tables`` with
    ``next_bits``): a dict of ``carry``, ``out``, ``window``, ``x`` and
    ``kv_rows``.  ``noise`` is (L, vpad) here (the twin reads its first V
    lanes).  For holding the kernel against its twin on the same inputs; the
    decoder never calls it, and it counts no launch."""
    if carry.device.type == "cpu":
        return spec_advance_reference(logits, carry, out, window, src, span_types, aux,
                                      fast_tables, noise, uniforms, emb, pos_table,
                                      compute_dtype=compute_dtype, prime=prime, **skw)
    if carry.device.type != "cuda":
        raise ValueError(f"spec_advance runs on cuda or cpu, not {carry.device}")
    _check_spec_inputs(carry, out, window, src, span_types, aux, tables, noise, uniforms, emb,
                       pos_table, **skw)
    W, vpad, dev = window.shape[0], tables["state_masks_f"].shape[1], carry.device
    if not prime:
        _check_tensors(dev, {"logits": (logits, torch.float32, (W, vpad))})
        # the launch just before the kernel writes only what it reads after its wait
        logits = logits.clone()
    res = dict(carry=carry.clone(), out=out.clone(), window=window.clone(),
               x=torch.empty(W, emb.shape[1], device=dev),
               kv_rows=torch.empty(W, dtype=torch.int64, device=dev))
    # the draft tables as the decode's earlier iterations leave them at this position
    draft_tbl = (torch.full((2, vpad, vpad), -1, dtype=torch.int32, device=dev) if prime else
                 draft_tables_reference(out, int(carry[SPEC_POS]), src, vpad))
    before = spec_advance.launches
    _launch_spec_advance(load_library(), logits, res["carry"], res["out"], res["window"], res["x"],
                         res["kv_rows"], aux, span_types, tables, noise, uniforms, src, emb,
                         pos_table, draft_tbl, stream=torch.cuda.current_stream(dev).cuda_stream,
                         round_bf16=compute_dtype == torch.bfloat16, prime=prime, **skw)
    spec_advance.launches = before
    return res


spec_advance.launches = 0


def token_work(B: int, D: int, F: int, vpad: int, n_layers: int, T, kv_dtype, device):
    """The buffers of :func:`launch_tokens` for B rows: ``x`` (B, D) f32,
    ``logits`` (B, vpad) f32, the layers' temporaries and ``new_kv``,
    (n_layers, B, 2D) for a token (``T`` None) or (n_layers, T, B, 2D) for a
    chunk."""
    work = _layer_work(B, D, F, device)
    work["x"] = torch.empty(B, D, device=device, dtype=torch.float32)
    work["logits"] = torch.empty(B, vpad, device=device, dtype=torch.float32)
    shape = (n_layers, B, 2 * D) if T is None else (n_layers, T, B, 2 * D)
    work["new_kv"] = torch.empty(shape, dtype=kv_dtype, device=device)
    return work


def launch_tokens(lib, packed, tables, state, aux, span_types, noise, self_kv, cross_kv, pos,
                  cross_len, work, *, T, stream, embed_first: bool, out=None, n_layers, d_model,
                  nhead, d_ff, vpad, **skw) -> None:
    """The launch plan of one v3 token (``T`` None) or of a v4 chunk of
    ``T`` tokens, 34 launches a token in stream order on ``stream``: for
    token t, the v2 launches (:func:`_launch_layers` on ``work["x"]``, the
    self-attention over ``pos`` cache rows plus, in a chunk, the chunk rows
    before t) and ``sample_advance_kernel``, which advances ``state`` (6,
    B) in place, writes the next token to ``out`` (B, *) int32 at column
    position + 1 when given, advances ``pos`` (B,) int32 by 1 (v3) or, at
    the chunk's last token, by ``T``, and writes the next token's input row
    into ``work["x"]``.  ``embed_first``: ``embed_pe_kernel`` writes the
    first token's row at position ``pos[b]`` first (an eager call); without
    it ``work["x"]`` holds that row already (a graph's body: the row of
    ``DecodeGraph.load``, then of each replay's last sampler).  K|V rows go
    to ``work["new_kv"]``.

    No argument of any launch depends on the position's value, so the plan
    may be captured once and replayed at every position (``decode_graph``);
    nothing here allocates (``work`` is :func:`token_work`'s) or reads a
    device value on the host."""
    D = d_model
    x, logits, new_kv = work["x"], work["logits"], work["new_kv"]
    kw = dict(n_layers=n_layers, D=D, H=nhead, F=d_ff, vpad=vpad, stream=stream, work=work)
    if embed_first:
        _launch_embed_pe(lib, packed["emb"], state, pos, x, stream=stream)
    for t in range(1 if T is None else T):
        if T is None:
            _launch_layers(lib, packed, x, self_kv, cross_kv, pos, cross_len, logits, new_kv, **kw)
        else:
            _launch_layers(lib, packed, x, self_kv, cross_kv, pos, cross_len, logits, new_kv[:, t],
                           chunk=(new_kv, t), **kw)
        last = T is None or t == T - 1
        _launch_sample_advance(lib, logits, state, aux, span_types, noise, pos, tables,
                               stream=stream, pos_offset=t, advance=(T or 1) if last else 0,
                               out=out, emb=packed["emb"], x=x, **skw)


def _check_token_inputs(packed, tables, state, aux, span_types, noise, self_kv, cross_kv, index,
                        cross_len, T, *, n_layers, d_model, nhead, d_ff, vpad, **skw) -> None:
    """Every shape, type and device check of a token or chunk, on the host;
    a host ``index`` is also range-checked (T tokens from it fit the cache
    and the noise), a position tensor only for its shape."""
    B, D, dev = state.shape[1], d_model, state.device
    n = 1 if T is None else T
    if n < 1:
        raise ValueError(f"T_chunk={T} must be at least 1")
    host = None if isinstance(index, torch.Tensor) else int(index)
    _check_step_inputs(packed, B, dev, self_kv, cross_kv, cross_len,
                       n_layers, D, nhead, d_ff, vpad, 0 if host is None else host)
    if host is not None and host + n > self_kv.shape[2]:
        raise ValueError(f"the chunk's rows {host}..{host + n - 1} do not fit a self cache "
                         f"of {self_kv.shape[2]} rows")
    _check_sampling_inputs(tables, state, aux, span_types, noise,
                           None if host is None else host + n - 1, vpad, **skw)
    _check_tensors(dev, {"emb": (packed["emb"], self_kv.dtype, (vpad, D))})


def fused_decode_token(
    packed: Dict[str, torch.Tensor],
    tables: Dict[str, torch.Tensor],
    state: torch.Tensor,  # (6, B) int32 - ST_* rows
    aux: torch.Tensor,  # (2, B) int32 - AUX_* rows
    span_types: torch.Tensor,  # (B, max_spans) int32
    noise: Optional[torch.Tensor],  # (L, B, vpad) f32 Gumbel rows; unused when greedy
    self_kv: torch.Tensor,  # (n_layers, B, L, 2D)
    cross_kv: torch.Tensor,  # (n_layers, B, S, 2D)
    index,  # int position, or a (B,) int32 position tensor on the state's device
    cross_len: torch.Tensor,  # (B,) int32
    *,
    n_layers: int, d_model: int, nhead: int, d_ff: int, vpad: int,
    mode: int, max_spans: int, span_cap: int, eos_index: int, mask_index: int,
    nucleus_p, temperature: float, greedy: bool, n_sid: int, span_body: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One full decode token: embed -> decoder layers -> sample -> advance.

    Returns (new_state (6, B) int32, new_kv (n_layers, B, 2D)).  On CUDA,
    the 1 + 34 launches of :func:`launch_tokens` in stream order with no
    host synchronisation; a position tensor is read on the device (and not
    changed), and is not range-checked."""
    kw = dict(n_layers=n_layers, d_model=d_model, nhead=nhead, d_ff=d_ff, vpad=vpad)
    skw = dict(mode=mode, max_spans=max_spans, span_cap=span_cap, eos_index=eos_index,
               mask_index=mask_index, nucleus_p=nucleus_p, temperature=temperature,
               greedy=greedy, n_sid=n_sid, span_body=span_body)
    if state.device.type == "cpu":
        return fused_decode_token_reference(packed, tables, state, aux, span_types, noise,
                                            self_kv, cross_kv, index, cross_len, **kw, **skw)
    if state.device.type != "cuda":
        raise ValueError(f"fused_decode_token runs on cuda or cpu, not {state.device}")
    B, dev = state.shape[1], state.device
    _check_token_inputs(packed, tables, state, aux, span_types, noise, self_kv, cross_kv, index,
                        cross_len, None, **kw, **skw)
    pos = _position(index, B, dev)
    new_state = state.clone()
    work = token_work(B, d_model, d_ff, vpad, n_layers, None, self_kv.dtype, dev)
    launch_tokens(load_library(), packed, tables, new_state, aux, span_types, noise, self_kv,
                  cross_kv, pos, cross_len, work, T=None, embed_first=True,
                  stream=torch.cuda.current_stream(dev).cuda_stream, **kw, **skw)
    fused_decode_token.launches += 1
    return new_state, work["new_kv"]


fused_decode_token.launches = 0


def fused_decode_tokens(
    packed: Dict[str, torch.Tensor],
    tables: Dict[str, torch.Tensor],
    state: torch.Tensor,  # (6, B) int32 - ST_* rows
    aux: torch.Tensor,  # (2, B) int32 - AUX_* rows
    span_types: torch.Tensor,  # (B, max_spans) int32
    noise: Optional[torch.Tensor],  # (Lp, B, vpad) f32 Gumbel rows; unused when greedy
    self_kv: torch.Tensor,  # (n_layers, B, Lp, 2D); rows below index are read
    cross_kv: torch.Tensor,  # (n_layers, B, S, 2D)
    index,  # int base position of the chunk, or a (B,) int32 position tensor
    cross_len: torch.Tensor,  # (B,) int32
    *,
    n_layers: int, d_model: int, nhead: int, d_ff: int, vpad: int,
    mode: int, max_spans: int, span_cap: int, eos_index: int, mask_index: int,
    nucleus_p, temperature: float, greedy: bool, n_sid: int, span_body: int,
    T_chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``T_chunk`` whole tokens at positions ``index + t`` in one call (v4).

    Returns (new_state (6, B) int32, tokens (T_chunk, B) int32, new_kv
    (n_layers, T_chunk, B, 2D)); ``self_kv`` is not written, so the caller
    splices ``new_kv`` at ``index``.  On CUDA, 1 + T_chunk x 34 launches
    (:func:`launch_tokens`) in stream order with no host synchronisation:
    each token's K|V rows go straight into ``new_kv``, which later tokens
    of the chunk attend; the tokens go to an output row of the cache's
    length and are gathered from it at the positions ``index + 1 + t``."""
    kw = dict(n_layers=n_layers, d_model=d_model, nhead=nhead, d_ff=d_ff, vpad=vpad)
    skw = dict(mode=mode, max_spans=max_spans, span_cap=span_cap, eos_index=eos_index,
               mask_index=mask_index, nucleus_p=nucleus_p, temperature=temperature,
               greedy=greedy, n_sid=n_sid, span_body=span_body)
    if state.device.type == "cpu":
        return fused_decode_tokens_reference(packed, tables, state, aux, span_types, noise,
                                             self_kv, cross_kv, index, cross_len, **kw, **skw,
                                             T_chunk=T_chunk)
    if state.device.type != "cuda":
        raise ValueError(f"fused_decode_tokens runs on cuda or cpu, not {state.device}")
    T = int(T_chunk)
    B, dev = state.shape[1], state.device
    _check_token_inputs(packed, tables, state, aux, span_types, noise, self_kv, cross_kv, index,
                        cross_len, T, **kw, **skw)
    pos = _position(index, B, dev)
    cols = torch.arange(1, T + 1, device=dev) + pos[:1]  # before the launches advance pos
    out = torch.zeros(B, self_kv.shape[2] + 1, dtype=torch.int32, device=dev)
    new_state = state.clone()
    work = token_work(B, d_model, d_ff, vpad, n_layers, T, self_kv.dtype, dev)
    launch_tokens(load_library(), packed, tables, new_state, aux, span_types, noise, self_kv,
                  cross_kv, pos, cross_len, work, T=T, out=out, embed_first=True,
                  stream=torch.cuda.current_stream(dev).cuda_stream, **kw, **skw)
    fused_decode_tokens.launches += 1
    return new_state, out.index_select(1, cols).T.contiguous(), work["new_kv"]


fused_decode_tokens.launches = 0


def reset_counts() -> None:
    fused_decode_step.launches = 0
    fused_decode_step_reference.calls = 0
    fused_decode_token.launches = 0
    fused_decode_token_reference.calls = 0
    fused_decode_tokens.launches = 0
    fused_decode_tokens_reference.calls = 0
    fused_verify_window.launches = 0
    fused_verify_window_reference.calls = 0
    rowvec_int8.launches = 0
    rowvec_int8_reference.calls = 0
    spec_advance.launches = 0
    spec_advance_reference.calls = 0
