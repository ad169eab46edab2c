"""SMER <-> REMI ("step single", mode 1) conversion and REMI decode.

Reimplements reference ``data_convert.py:172-688``.  The reference performs
the conversion with in-place list surgery over the emitted token stream
(insert/delete around ``np.where`` hits); here the same semantics run over
a structured representation — each track body is a list of onset groups
``[step, pitches, duration]`` in 16th-note units — which makes the
``continue``-tie merging and equal-(step, duration) deduplication direct:

* SMER bodies are replayed with the cursor VM (``rest`` advances, ``sep``
  rewinds to the previous group's start);
* a ``continue`` group extends the matching pitch of the *previous* bar's
  same-track body (unmatched continues are dropped, as in the reference);
* merged durations are clipped at ``n_32`` (the REMI vocabulary maximum;
  the reference emits out-of-vocabulary ``n_33+`` tokens with a printed
  warning in this case);
* groups sharing (step, duration) merge into one ``e_step p.. n_dur`` run.

``remi_to_midi`` decodes mode-1 streams with per-track velocities
V0/V1/V2 (reference ``data_convert.py:604-688``).

Host copy of ``smer_music_generation_tpu/codec/remi.py`` for the PyTorch port,
which imports nothing of the JAX package.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

from ..vocab import CONTROL_TOKENS, V0, V1, V2, DURATION_MULTI
from .durations import duration_table_for_signature
from .midi import Instrument, Lyric, MidiScore, Note, TimeSignature
from .smer import _PITCH_LOOKUP, decode_tempo_token

_TRACK_RE = re.compile(r"track_\d$")
_PITCH_RE = re.compile(r"p_(\d+)$")
_STEP_RE = re.compile(r"e_(\d+)$")
_DUR_RE = re.compile(r"n_(\d+)$")

# duration-name -> 16th steps (tempo-independent)
_DUR_STEPS = {"whole": 16, "half": 8, "quarter": 4, "eighth": 2, "sixteenth": 1}

MAX_REMI_DURATION = 32

# exact token lookups for the hot decode/convert loops (every token the
# vocab can emit, sharing smer's pitch table; the regexes above remain
# the fallback for odd streams)
_STEP_LOOKUP = {f"e_{i}": i for i in range(16)}
_DUR_LOOKUP = {f"n_{i}": i for i in range(1, 64)}
_TRACK_SET = frozenset(f"track_{i}" for i in range(10))


class _Group:
    __slots__ = ("step", "pitches", "dur")

    def __init__(self, step: int, pitches: List[str], dur: int):
        self.step = step
        self.pitches = pitches
        self.dur = dur


def _parse_body(tokens: Sequence[str]) -> Tuple[List[_Group], List[_Group]]:
    """Replay a SMER track body into onset groups.

    Returns (groups_with_pitches, continue_groups); continue groups carry
    the tie pitches and the extension duration.
    """
    groups: List[_Group] = []
    cont_groups: List[_Group] = []
    current = 0
    prev_start = 0
    prev_dur = 0

    i = 0
    n = len(tokens)
    while i < n:
        tok = tokens[i]
        is_sep = False
        is_rest = False
        is_cont = False
        if tok == "sep":
            is_sep = True
            i += 1
        elif tok == "rest":
            is_rest = True
            i += 1
        elif tok == "continue":
            is_cont = True
            i += 1
        pitches: List[str] = []
        while i < n and (tokens[i] in _PITCH_LOOKUP or _PITCH_RE.match(tokens[i])):
            pitches.append(tokens[i])
            i += 1
        dur = 0
        while i < n and tokens[i] in _DUR_STEPS:
            dur += _DUR_STEPS[tokens[i]]
            i += 1
        if not (is_sep or is_rest or is_cont or pitches or dur):
            i += 1  # unknown token inside body; skip defensively
            continue
        start = prev_start if is_sep else current
        if is_cont:
            cont_groups.append(_Group(start, pitches, dur))
        elif pitches:
            groups.append(_Group(start, pitches, dur))
        current = start + dur
        prev_start = start
        prev_dur = dur
    return groups, cont_groups


def _merge_continue(prev_groups: List[_Group], cont: _Group) -> None:
    """Extend the previous bar's matching notes by the tie duration."""
    for pitch in cont.pitches:
        src = None
        for g in reversed(prev_groups):
            if pitch in g.pitches:
                src = g
                break
        if src is None:
            continue  # unmatched tie: dropped (reference behaviour)
        new_dur = min(src.dur + cont.dur, MAX_REMI_DURATION)
        src.pitches.remove(pitch)
        target = None
        for g in prev_groups:
            if g.step == src.step and g.dur == new_dur:
                target = g
                break
        if target is None:
            target = _Group(src.step, [], new_dur)
            idx = prev_groups.index(src)
            prev_groups.insert(idx + 1, target)
        target.pitches.append(pitch)
    # drop emptied groups
    prev_groups[:] = [g for g in prev_groups if g.pitches]


def _emit_body(groups: List[_Group]) -> List[str]:
    out: List[str] = []
    merged: List[_Group] = []
    for g in groups:
        if merged and merged[-1].step == g.step and merged[-1].dur == g.dur:
            merged[-1].pitches.extend(g.pitches)
        else:
            merged.append(g)
    for g in merged:
        if not g.pitches or g.dur <= 0:
            continue
        step = min(max(g.step, 0), 15)
        out.append(f"e_{step}")
        out.extend(g.pitches)
        out.append(f"n_{min(g.dur, MAX_REMI_DURATION)}")
    return out


def smer_to_remi(events: Sequence[str]) -> List[str]:
    """Convert a mode-0 stream (with or without controls) to mode 1."""
    # segment the stream: (passthrough tokens) and (bar, track) bodies
    segments: List[Tuple[str, object]] = []  # ("tok", str) | ("body", (bar, track, groups))
    bodies: dict = {}  # (bar_idx, track_name) -> groups list
    bar_idx = -1
    cur_track: Optional[str] = None
    body_tokens: List[str] = []
    body_key = None

    body_token_set = set(DURATION_MULTI) | {"rest", "sep", "continue"}

    def close_body():
        nonlocal body_tokens, body_key
        if body_key is None:
            # tokens accumulated with no open body (degenerate input, e.g.
            # body tokens after a mid-body control) must not leak into the
            # next track's body
            body_tokens = []
            return
        groups, cont_groups = _parse_body(body_tokens)
        bar_i, track = body_key
        prev = bodies.get((bar_i - 1, track))
        for cont in cont_groups:
            if bar_i >= 1 and prev is not None:
                _merge_continue(prev, cont)
            # first-bar continues are dropped (reference data_convert
            # `bar_num > 1` gate / remove_first_continue)
        bodies[body_key] = groups
        segments.append(("body", body_key))
        body_tokens = []
        body_key = None

    for tok in events:
        if tok == "bar":
            close_body()
            bar_idx += 1
            cur_track = None
            segments.append(("tok", tok))
        elif tok in _TRACK_SET:
            close_body()
            cur_track = tok
            body_key_candidate = (bar_idx, tok)
            body_key = body_key_candidate
            segments.append(("tok", tok))
        elif cur_track is not None and (
            tok in body_token_set or tok in _PITCH_LOOKUP or _PITCH_RE.match(tok)
        ):
            body_tokens.append(tok)
        else:
            # header / control / unk tokens pass through in place
            if body_key is not None and body_tokens:
                # control tokens inside a body (end copies) close it
                close_body()
                body_key = None
            segments.append(("tok", tok))
    close_body()

    out: List[str] = []
    for kind, payload in segments:
        if kind == "tok":
            out.append(payload)  # type: ignore[arg-type]
        else:
            out.extend(_emit_body(bodies[payload]))
    return out


def remove_first_continue(events: Sequence[str]) -> List[str]:
    """Strip ``continue`` tokens inside the first bar (reference
    ``data_convert.py:692-707``)."""
    out = []
    bar_count = 0
    for tok in events:
        if tok == "bar":
            bar_count += 1
        if tok == "continue" and bar_count == 1:
            continue
        out.append(tok)
    return out


def remi_to_midi(events: Sequence[str], tempo: Optional[float] = None) -> Optional[MidiScore]:
    """Decode a mode-1 stream to MIDI (reference ``remi_2midi``)."""
    events = [e for e in events if e not in set(CONTROL_TOKENS)]
    if len(events) < 3:
        return None
    if tempo is None:
        tempo = (
            decode_tempo_token(events[1]) if events[1].startswith("t_") else float(events[1])
        )
    try:
        numerator, denominator = (int(x) for x in events[0].split("/"))
    except (ValueError, IndexError):
        return None

    score = MidiScore(initial_tempo=tempo)
    score.time_signature_changes = [TimeSignature(numerator, denominator, 0.0)]
    programs = [e for e in events if e[:2] == "i_" and e[2:].isdigit()]
    track_names = sorted({e for e in events if e in _TRACK_SET})
    track_index = {name: i for i, name in enumerate(track_names)}
    for prog in programs:
        score.instruments.append(Instrument(program=int(prog.split("_")[-1])))

    table = duration_table_for_signature((numerator, denominator), tempo)
    sixteenth = table.name_to_time["sixteenth"]
    bar_duration = table.bar_duration
    n_bars = sum(1 for e in events if e == "bar")
    score.lyrics = [Lyric("end", n_bars * bar_duration)]

    curr_time = 0.0
    bar_start = 0.0
    bar_num = 0
    track = 0
    track_label = "track_0"
    pitch_list: List[int] = []
    for tok in events:
        if tok == "bar":
            curr_time = bar_num * bar_duration
            bar_start = curr_time
            bar_num += 1
        elif tok in track_index:
            curr_time = bar_start
            track_label = tok
            track = track_index[tok]
            pitch_list = []
        else:
            step = _STEP_LOOKUP.get(tok)
            if step is None:
                m = _STEP_RE.match(tok)
                step = int(m.group(1)) if m else None
            if step is not None:
                curr_time = bar_start + step * sixteenth
                continue
            pitch = _PITCH_LOOKUP.get(tok)
            if pitch is None:
                m = _PITCH_RE.match(tok)
                pitch = int(m.group(1)) if m else None
            if pitch is not None:
                pitch_list.append(pitch)
                continue
            dur = _DUR_LOOKUP.get(tok)
            if dur is None:
                m = _DUR_RE.match(tok)
                dur = int(m.group(1)) if m else None
            if dur is not None:
                end = curr_time + dur * sixteenth
                vel = {"track_0": V0, "track_1": V1}.get(track_label, V2)
                for pitch in pitch_list:
                    score.instruments[track].notes.append(
                        Note(velocity=vel, pitch=pitch, start=curr_time, end=end)
                    )
                pitch_list = []
    return score
