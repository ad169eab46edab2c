"""The draft lookup of ``spec_advance_kernel``, replayed in plain torch on the
CPU against ``build_draft_reference`` (JAX ``build_draft``,
``infer/decode.py:509-534``).

The kernel keeps two device tables of "the latest j at which each bigram
ends" (``ops/csrc/decode_token.cu``): the source's, built once a decode by
its ``prime``, never at a padding id; the emitted stream's, which the prime
fills up to pos - 1 and every sampling iteration extends by the bigrams
ending at pos .. P - 1 once its W-slot write is in, so it never holds the
bigram ending at P.  ``ops.decode_step.draft_tables_reference`` builds the
tables as the prime does; ``draft_tables_insert`` and ``draft_from_tables``
below replay an iteration's inserts and lookup.  These tests walk whole
decodes through that algorithm, iteration
by iteration, with the stream written as the kernel writes it (the emitted
prefix, zeros past it), and require at every iteration the draft of
``build_draft_reference`` exactly and tables equal to a fresh prime's at the
new position: random streams and sources over a small vocabulary (so
bigrams repeat and their latest match moves), padding ids in the source,
matches near the ends (the ``L - K`` and ``S - K`` clamps), no-op
iterations after done, and a prime at a position past 0.
"""

import numpy as np
import pytest
import torch

from smer_music_generation_tpu_torch.ops import decode_step as ds

VPAD = 16


def draft_tables_insert(tables: torch.Tensor, out: torch.Tensor, pos: int, P: int) -> None:
    """A sampling iteration's inserts into the stream's table, in place:
    the bigrams ending at pos..P-1 (j >= 1) of ``out`` after the
    iteration's write, the latest kept; the bigram ending at P waits for
    the next iteration, as ``build_draft`` never matches there."""
    vpad = tables.shape[1]
    for j in range(max(pos, 1), P):
        x, y = int(out[j - 1]), int(out[j])
        if 0 <= x < vpad and 0 <= y < vpad:
            tables[0, x, y] = max(int(tables[0, x, y]), j)


def draft_from_tables(tables: torch.Tensor, out: torch.Tensor, P: int, src: torch.Tensor,
                      K: int) -> torch.Tensor:
    """``build_draft_reference``'s draft as ``spec_advance_kernel`` looks it
    up, once the iteration's inserts are in: the two tables' entries of the
    bigram (out[P - 1], out[P]), the stream's first, each continuation
    clamped as JAX's (``min(j + 1, L - K)`` then 0; ``S - K``), else zeros."""
    L, S, vpad = out.shape[0], src.shape[0], tables.shape[1]
    x, y = int(out[max(P - 1, 0)]), int(out[P])
    jo = js = -1
    if 0 <= x < vpad and 0 <= y < vpad:
        jo, js = int(tables[0, x, y]), int(tables[1, x, y])
    if jo >= 0:
        start = max(min(jo + 1, L - K), 0)
        return out[start : start + K].clone()
    if js >= 0:
        start = max(min(js + 1, S - K), 0)
        return src[start : start + K].to(out.dtype)
    return out.new_zeros(K)


def _write(out, pos, W, tokens, m):
    """The kernel's W-slot write: the emitted prefix's tokens, zeros past it."""
    for j in range(W):
        out[pos + 1 + j] = tokens[j] if j < m else 0


def _check(tables, out, P, src, K):
    want = ds.build_draft_reference(out, P, src, K)
    got = draft_from_tables(tables, out, P, src, K)
    assert torch.equal(got, want), (P, got.tolist(), want.tolist())
    assert torch.equal(tables, ds.draft_tables_reference(out, P, src, VPAD))
    return got


def _decode(rng, L, S, W, vocab, p0=0, pad=0.2):
    """A whole decode: the prime at p0, then sampling iterations that emit
    1..W tokens each while a window fits, then no-op iterations."""
    K = W - 1
    src = torch.from_numpy(rng.integers(1, vocab, S).astype(np.int32))
    src[torch.from_numpy(rng.random(S) < pad)] = 0  # padding ids
    out = torch.zeros(L, dtype=torch.int32)
    out[: p0 + 1] = torch.from_numpy(rng.integers(1, vocab, p0 + 1).astype(np.int32))
    tables = ds.draft_tables_reference(out, p0, src, VPAD)  # the prime
    pos, drafts = p0, []
    drafts.append(_check(tables, out, pos, src, K))
    while pos + W < L:
        m = int(rng.integers(1, W + 1))
        _write(out, pos, W, rng.integers(1, vocab, W), m)
        P = pos + m
        draft_tables_insert(tables, out, pos, P)
        drafts.append(_check(tables, out, P, src, K))
        pos = P
    for _ in range(3):  # replays past the end: nothing inserted, the same draft
        draft_tables_insert(tables, out, pos, pos)
        assert torch.equal(_check(tables, out, pos, src, K), drafts[-1])
    return drafts


@pytest.mark.parametrize("W", [1, 2, 5, 9, 25])
@pytest.mark.parametrize("vocab", [4, 7, 16])
def test_tables_replay_build_draft_over_whole_decodes(W, vocab):
    rng = np.random.default_rng(100 * W + vocab)
    for p0 in (0, 1, 12):
        drafts = _decode(rng, L=96 if W < 25 else 160, S=70, W=W, vocab=vocab, p0=p0)
        assert len(drafts) > 3


def test_latest_match_moves_and_the_bigram_at_P_is_never_matched():
    """The bigram (3, 4) ends at 2, then at 5: the draft follows the latest;
    the bigram ending at P itself is not a match of the stream."""
    src = torch.tensor([9, 9, 9, 9, 9, 9], dtype=torch.int32)
    out = torch.zeros(20, dtype=torch.int32)
    out[:3] = torch.tensor([1, 3, 4])
    tables = ds.draft_tables_reference(out, 2, src, VPAD)
    assert torch.equal(_check(tables, out, 2, src, 3), torch.zeros(3, dtype=torch.int32))
    _write(out, 2, 4, [7, 3, 4, 8], 3)  # out = 1 3 4 7 3 4, P = 5
    draft_tables_insert(tables, out, 2, 5)
    assert _check(tables, out, 5, src, 3).tolist() == [7, 3, 4]  # the match ending at 2
    _write(out, 5, 4, [5, 3, 4, 0], 3)  # out = 1 3 4 7 3 4 5 3 4, P = 8
    draft_tables_insert(tables, out, 5, 8)
    assert int(tables[0, 3, 4]) == 5  # the latest match before P moved from 2 to 5
    assert _check(tables, out, 8, src, 3).tolist() == [5, 3, 4]


def test_source_padding_and_clamps():
    """A source match never ends at a padding id; a match near the end of
    the source or of the stream takes the clamped start (S - K, L - K)."""
    K = 4
    src = torch.tensor([2, 5, 0, 5, 6, 1, 2, 5, 6], dtype=torch.int32)
    out = torch.zeros(12, dtype=torch.int32)
    out[:2] = torch.tensor([2, 5])
    tables = ds.draft_tables_reference(out, 1, src, VPAD)
    # (2, 5) ends at 1 and 7 in the source: the latest, 7, clamped to S - K = 5
    assert _check(tables, out, 1, src, K).tolist() == src[5:9].tolist()
    assert int(tables[1, 5, 0]) == -1  # the bigram ending at the padding id at 2
    out2 = torch.zeros(10, dtype=torch.int32)
    out2[:10] = torch.tensor([4, 8, 1, 1, 1, 1, 1, 1, 4, 8])
    tables2 = ds.draft_tables_reference(out2, 9, src, VPAD)
    # (4, 8) ends at 1 in the stream (the stream first, not the source): start 2
    assert _check(tables2, out2, 9, src, K).tolist() == out2[2:6].tolist()
    out3 = torch.tensor([1, 1, 1, 1, 4, 8, 3, 4, 8], dtype=torch.int32)
    tables3 = ds.draft_tables_reference(out3, 8, src, VPAD)
    # (4, 8) ends at 5; 5 + 1 = 6 clamped to L - K = 5
    assert _check(tables3, out3, 8, src, K).tolist() == out3[5:9].tolist()


def test_tokens_outside_the_table_match_nothing():
    """A token at or past vpad is kept in no table and looks nothing up:
    the kernel's domain is token ids in [0, vpad)."""
    out = torch.tensor([VPAD, 1, VPAD, 1, 0, 0], dtype=torch.int32)
    src = torch.tensor([VPAD, 1, VPAD], dtype=torch.int32)
    tables = ds.draft_tables_reference(out, 3, src, VPAD)
    assert (tables == -1).all()
    assert torch.equal(draft_from_tables(tables, out, 3, src, 2), torch.zeros(2, dtype=torch.int32))
