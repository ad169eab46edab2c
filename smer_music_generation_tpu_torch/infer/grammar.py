"""Grammar constraints for SMER/REMI decoding as dense boolean vocab masks.

Port of ``smer_music_generation_tpu/infer/grammar.py``.  The table builders
(``GrammarTables.build``, ``allowed_mask``, ``update_flags`` and
``build_fast_tables``, :232) are host numpy and are copied here as they
are, with ``numpy`` in place of ``jax.numpy``; the two lookups of the decode
loop, :func:`allowed_mask_fast` (:293) and :func:`update_bits` (:312), are
torch.

Conscious divergences from the reference, kept from the JAX package:
``<pad>`` and ``m_0`` are banned in every state, and the ``no_control``
flag actually bans control tokens.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..vocab import WordVocab

# span type codes (what each masked span must produce)
SPAN_BODY = 0  # 'r' — free-form track body
SPAN_DENSITY = 1  # 'd'
SPAN_OCCUPATION = 2  # 'o'
SPAN_POLYPHONY = 3  # 'p' (y_* tokens)
SPAN_TENSILE = 4  # 't'

SPAN_CODE = {"r": SPAN_BODY, "d": SPAN_DENSITY, "o": SPAN_OCCUPATION,
             "p": SPAN_POLYPHONY, "t": SPAN_TENSILE}


class GrammarState(NamedTuple):
    in_sep: np.ndarray
    in_continue: np.ndarray
    in_pitch: np.ndarray
    in_rest: np.ndarray

    @classmethod
    def zeros(cls, batch: int) -> "GrammarState":
        z = np.zeros((batch,), dtype=bool)
        return cls(z, z, z, z)


@dataclass
class GrammarTables:
    """Dense masks, host-side numpy; build once per vocab (both encodings)."""

    pitch: np.ndarray
    duration_only: np.ndarray
    whole: np.ndarray
    rest: np.ndarray
    sep: np.ndarray
    continue_: np.ndarray
    step: np.ndarray  # e_* onset tokens (mode 1 only; zeros in mode 0)
    eos: np.ndarray
    control: np.ndarray
    always_banned: np.ndarray  # program/structure/time-sig/tempo/pad/mask
    span_family: np.ndarray  # (5, V): allowed family per span code (row 0 unused)
    continue_index: int
    eos_index: int
    mask_index: int
    vocab_size: int
    mode: int  # 0 = SMER, 1 = REMI

    @classmethod
    def build(cls, vocab: WordVocab) -> "GrammarTables":
        m = vocab.class_masks
        V = vocab.vocab_size
        always = (
            m["program"] | m["structure"] | m["time_signature"] | m["tempo"]
        ).copy()
        always[vocab.pad_index] = True
        always[vocab.mask_index] = True

        fam = np.zeros((5, V), dtype=bool)
        for code, name in (
            (SPAN_DENSITY, "density"),
            (SPAN_OCCUPATION, "occupation"),
            (SPAN_POLYPHONY, "polyphony"),
            (SPAN_TENSILE, "tensile"),
        ):
            if name in m:
                fam[code] = m[name]
        zeros = np.zeros(V, bool)
        return cls(
            pitch=np.asarray(m["pitch"]),
            duration_only=np.asarray(m["duration_only"]),
            whole=np.asarray(m.get("whole_duration", zeros)),
            rest=np.asarray(m.get("rest", zeros) if vocab.mode == 0 else zeros),
            sep=np.asarray(m.get("sep", zeros) if vocab.mode == 0 else zeros),
            continue_=np.asarray(m.get("continue", zeros)),
            step=np.asarray(m.get("step", zeros)),
            eos=np.asarray(m["eos"]),
            control=np.asarray(m["control"]),
            always_banned=np.asarray(always),
            span_family=np.asarray(fam),
            continue_index=getattr(vocab, "continue_index", -1),
            eos_index=vocab.eos_index,
            mask_index=vocab.mask_index,
            vocab_size=V,
            mode=vocab.mode,
        )


def allowed_mask(
    t: GrammarTables,
    state: GrammarState,
    is_start: np.ndarray,  # (B,) bool: only m_0 emitted so far in span
    span_type: np.ndarray,  # (B,) int32 span code
    no_whole_duration,  # scalar or (B,) bool (time signature < 4/4)
    xp=np,
) -> np.ndarray:
    """(B, V) boolean mask, True = sampleable, per the dispatch priority."""
    B = state.in_sep.shape[0]
    V = t.vocab_size

    if t.mode == 1:
        return _allowed_mask_remi(t, state, is_start, span_type, xp=xp)

    no_whole = xp.broadcast_to(xp.asarray(no_whole_duration), (B,))
    whole_b = no_whole[:, None] & t.whole[None, :]  # (B, V)

    def bcast(mask):
        return xp.broadcast_to(mask[None, :], (B, V))

    dur = bcast(t.duration_only) & ~whole_b
    free = ~(bcast(t.always_banned | t.control) | whole_b)
    start_body = free & bcast(~t.duration_only)  # start: eos/pitch/rest/sep/continue
    in_sep = bcast(~(t.always_banned | t.control | t.rest | t.sep | t.eos | t.whole))
    in_continue = bcast(t.pitch)
    in_pitch = bcast(t.pitch) | dur
    in_rest = dur

    start_mask = xp.where(
        (span_type != SPAN_BODY)[:, None],
        xp.asarray(t.span_family)[span_type],
        start_body,
    )

    out = free
    out = xp.where(is_start[:, None], start_mask, out)
    out = xp.where(state.in_rest[:, None], in_rest, out)
    out = xp.where(state.in_pitch[:, None], in_pitch, out)
    out = xp.where(state.in_continue[:, None], in_continue, out)
    out = xp.where(state.in_sep[:, None], in_sep, out)
    return out


def _allowed_mask_remi(
    t: GrammarTables,
    state: GrammarState,
    is_start: np.ndarray,
    span_type: np.ndarray,
    xp=np,
) -> np.ndarray:
    """Mode-1 (REMI) grammar: a 3-state onset machine (reference
    ``evaluation.py:1150-1213`` + ``sampling_step_single/multi``):

    * A (default): expect an onset step ``e_*`` or ``<eos>``;
    * B (``in_continue`` bit): just emitted a step -> expect a pitch;
    * C (``in_pitch`` bit): in a pitch run -> pitch or ``n_*`` duration.
    """
    B = state.in_sep.shape[0]
    V = t.vocab_size

    state_a = t.step | t.eos
    state_b = t.pitch
    state_c = t.pitch | t.duration_only

    def bcast(mask):
        return xp.broadcast_to(mask[None, :], (B, V))

    start_mask = xp.where(
        (span_type != SPAN_BODY)[:, None],
        xp.asarray(t.span_family)[span_type],
        bcast(state_a),
    )
    out = bcast(state_a)
    out = xp.where(state.in_pitch[:, None], bcast(state_c), out)
    out = xp.where(state.in_continue[:, None], bcast(state_b), out)
    out = xp.where(is_start[:, None], start_mask, out)
    return out


# ---------------------------------------------------------------------------
# Table-driven fast path (decode hot loop)
#
# ``allowed_mask``/``update_flags`` above are the reference semantics: a
# chain of ~15 small broadcast/where ops per step.  The fast path collapses
# them to two gathers against tables built BY the reference functions
# themselves (so parity is by construction):
#
# * state id (sid): 0 free, 1 rest, 2 pitch, 3 continue, 4 sep,
#   5+span_type span-start rows; priority sep>continue>pitch>rest matches
#   the reference dispatch order, flags override span-start.
# * ``state_masks``: (2, N_SID, V) — axis 0 is the no_whole_duration bit.
# * ``next_bits``: (16, V) packed-bit transition table
#   (bits = sep<<3 | continue<<2 | pitch<<1 | rest).
# ---------------------------------------------------------------------------

N_SID = 10


def build_fast_tables(t: GrammarTables):
    """Returns (state_masks (2, N_SID, V) bool, sid_from_bits (16,) int32,
    next_bits (16, V) int32), host numpy; the decoder moves them to its
    device once."""
    V = t.vocab_size
    f = np.zeros((1,), bool)
    tr = np.ones((1,), bool)

    def state_for_sid(sid):
        bits = {1: (f, f, f, tr), 2: (f, f, tr, f), 3: (f, tr, f, f),
                4: (tr, f, f, f)}.get(sid, (f, f, f, f))
        return GrammarState(*bits)

    masks = np.zeros((2, N_SID, V), dtype=bool)
    for nw in (0, 1):
        for sid in range(N_SID):
            is_start = np.asarray([sid >= 5])
            span_type = np.asarray([max(sid - 5, 0)], np.int32)
            row = allowed_mask(
                t, state_for_sid(sid), is_start, span_type,
                np.asarray([nw == 1]), xp=np,
            )
            masks[nw, sid] = np.asarray(row)[0]

    sid_from_bits = np.zeros((16,), np.int32)
    for bits in range(16):
        if t.mode == 1:
            # REMI dispatch: continue > pitch; sep/rest bits are ignored
            if bits & 4:
                sid_from_bits[bits] = 3
            elif bits & 2:
                sid_from_bits[bits] = 2
        elif bits & 8:
            sid_from_bits[bits] = 4
        elif bits & 4:
            sid_from_bits[bits] = 3
        elif bits & 2:
            sid_from_bits[bits] = 2
        elif bits & 1:
            sid_from_bits[bits] = 1

    next_bits = np.zeros((16, V), np.int32)
    idx = np.arange(V, dtype=np.int32)
    for bits in range(16):
        st = GrammarState(
            np.full((V,), bool(bits & 8)),
            np.full((V,), bool(bits & 4)),
            np.full((V,), bool(bits & 2)),
            np.full((V,), bool(bits & 1)),
        )
        ns = update_flags(t, st, idx, xp=np)
        next_bits[bits] = (
            np.asarray(ns.in_sep).astype(np.int32) * 8
            + np.asarray(ns.in_continue) * 4
            + np.asarray(ns.in_pitch) * 2
            + np.asarray(ns.in_rest)
        )
    return masks, sid_from_bits, next_bits


def allowed_mask_fast(
    state_masks: torch.Tensor,  # (2, N_SID, V) bool
    sid_from_bits: torch.Tensor,  # (16,) int
    bits: torch.Tensor,  # (B,) int packed state
    is_start: torch.Tensor,  # (B,) bool
    span_type: torch.Tensor,  # (B,) int
    no_whole,  # bool, or (B,) bool
    start_overrides: bool = False,  # True for REMI (mode 1) dispatch order
) -> torch.Tensor:
    bits = bits.long()
    flag_sid = sid_from_bits.long()[bits]
    start_sid = 5 + span_type.long()
    if start_overrides:
        sid = torch.where(is_start, start_sid, flag_sid)
    else:
        sid = torch.where(
            bits > 0, flag_sid, torch.where(is_start, start_sid, torch.zeros_like(start_sid))
        )
    nw = torch.as_tensor(no_whole, device=sid.device).long()
    return state_masks[nw, sid]  # (B, V)


def update_bits(next_bits: torch.Tensor, bits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    V = next_bits.shape[1]
    return next_bits.reshape(-1)[bits.long() * V + idx.long()]


def update_flags(
    t: GrammarTables, state: GrammarState, idx: np.ndarray, xp=np
) -> GrammarState:
    """Transition on the sampled token (reference ``generation.py:654-671``;
    mode-1 transitions per ``evaluation.py:1150-1213``)."""
    is_pitch = xp.asarray(t.pitch)[idx]
    is_dur = xp.asarray(t.duration_only)[idx]
    if t.mode == 1:
        is_step = xp.asarray(t.step)[idx]
        false = xp.zeros_like(is_pitch)
        return GrammarState(
            in_sep=false,
            in_continue=xp.where(is_step, True, xp.where(is_pitch | is_dur, False, state.in_continue)),
            in_pitch=xp.where(is_pitch, True, xp.where(is_step | is_dur, False, state.in_pitch)),
            in_rest=false,
        )
    is_cont = idx == t.continue_index
    is_sep = xp.asarray(t.sep)[idx]
    is_rest = xp.asarray(t.rest)[idx]
    return GrammarState(
        in_sep=xp.where(is_sep, True, xp.where(is_cont | is_pitch, False, state.in_sep)),
        in_continue=xp.where(is_cont, True, xp.where(is_pitch, False, state.in_continue)),
        in_pitch=xp.where(is_pitch, True, xp.where(is_dur, False, state.in_pitch)),
        in_rest=xp.where(is_rest, True, xp.where(is_dur, False, state.in_rest)),
    )
