"""Operations and bytes of the port's work from its shapes, and the chip's
peaks: the yardstick of every roofline share and ``mfu`` the benchmark
reports.

Peaks of one NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet, dense):
3.35 TB/s of HBM, 989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in
f32 outside them.  A least time is the larger of bytes over the bandwidth
and operations over the rate (``bound_s``).  Bytes count each input read
once and each output written once; where the work depends on the data,
what these inputs need (a decode row's tokens up to its own length, the
valid keys of a padded row).

The decode token's arithmetic is the one the repository's kernel smoke run
holds its kernels to (row 1a: ``rowvec_kernel``'s 25 launches a token at
B = 3, 0.0092 ms, bytes-bound), extended to every launch of a run.
"""

from __future__ import annotations

from typing import Dict, Sequence

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def bound_s(nbytes: float, flops: float, rate: float = BF16_FLOPS) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / rate)


def vocab_pad(V: int) -> int:
    return (V + 127) // 128 * 128


def _dims(cfg: Dict):
    return (int(cfg["d_model"]), int(cfg["d_ff"]), int(cfg["num_encoder_layers"]),
            int(cfg["num_decoder_layers"]), int(cfg["vocab_size"]))


def _elem(cfg: Dict) -> int:
    return 2 if cfg.get("dtype", "bfloat16") in ("bfloat16", "float16") else 4


def rowvec_token(cfg: Dict, B: int):
    """(bytes, operations) of ``rowvec_kernel``'s launches for one decode
    token of B rows: each decoder layer's QKV, self-out, cross-q, cross-out,
    FFN-up and FFN-down products (weights in the compute dtype) and the f32
    logits over the padded vocabulary; each reads its weight, B input rows
    and its bias and writes B output rows, all f32 but the weight."""
    D, F, _, nl, V = _dims(cfg)
    es = _elem(cfg)
    shapes = [(D, 3 * D, es), (D, D, es), (D, D, es), (D, D, es), (D, F, es), (F, D, es)] * nl
    shapes.append((D, vocab_pad(V), 4))
    nbytes = sum(K * N * e + 4 * (B * K + B * N + N) for K, N, e in shapes)
    flops = sum(2 * B * K * N for K, N, _ in shapes)
    return nbytes, flops


def attend_decode(cfg: Dict, lengths: Sequence[int], cross_lens: Sequence[int]):
    """(bytes, operations) of ``attend_kernel``'s launches over one decode:
    a row at position p reads its self cache up to p and its cross cache
    (keys and values of every decoder layer, in the compute dtype) and
    attends them (two products of D a key); a row is live for ``length``
    positions."""
    D, _, _, nl, _ = _dims(cfg)
    es = _elem(cfg)
    keys = sum(L * (L + 1) / 2 + L * c for L, c in zip(lengths, cross_lens))
    nbytes = nl * keys * 2 * D * es + nl * sum(lengths) * 2 * D * 4
    return nbytes, nl * keys * 4 * D


def encode_flops(cfg: Dict, s: int) -> float:
    """Model operations of one source of s tokens: the encoder's layers
    (projections, FFN, attention over the s keys) and the decoder's cross
    K/V projections of its output."""
    D, F, ne, nl, _ = _dims(cfg)
    return ne * s * (2 * (4 * D * D + 2 * D * F) + 4 * s * D) + nl * s * 4 * D * D


def decode_flops(cfg: Dict, n: int, s: int) -> float:
    """Model operations of n decode tokens (positions 0..n-1) against a
    source of s tokens: each layer's self and cross projections, the FFN and
    both attentions, then the output projection."""
    D, F, _, nl, V = _dims(cfg)
    per_token = nl * 2 * (6 * D * D + 2 * D * F) + 2 * D * V
    keys = n * (n + 1) / 2 + n * s
    return n * per_token + nl * 4 * D * keys


def train_flops(cfg: Dict, src_lens: Sequence[int], tgt_lens: Sequence[int]) -> float:
    """Model operations of one training step, forward and backward (three
    times the forward), over the rows' real tokens: the encoder over each
    source, the decoder's projections, causal self-attention, cross-attention
    over the source and the output projection over each target."""
    total = 0.0
    for s, t in zip(src_lens, tgt_lens):
        total += encode_flops(cfg, s) + decode_flops(cfg, t, s)
    return 3.0 * total


def flash_train_step(cfg: Dict, src_lens: Sequence[int], tgt_lens: Sequence[int]) -> float:
    """Operations the flash training attention needs in one step: for each
    of the encoder's self-attentions, the decoder's causal self-attentions
    and its cross-attentions, 2 head_dim operations for every (valid query,
    valid key) pair of every head and product: two products forward, five
    backward (the scores again, g v^T, p^T g, ds k, ds^T q)."""
    D, _, ne, nl, _ = _dims(cfg)
    pairs = 0.0
    for s, t in zip(src_lens, tgt_lens):
        pairs += ne * s * s + nl * (t * (t + 1) / 2 + t * s)
    return 2 * D * pairs * (2 + 5)
