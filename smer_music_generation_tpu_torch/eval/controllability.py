"""Controllability evaluation harness.

Reimplements the measurement core of reference ``evaluation.py``: set a
control token to a new value, regenerate the affected spans, recompute the
*achieved* control of the regenerated music, and report the |set -
achieved| differences:

* :func:`recompute_track_controls` — ``cal_track_control``
  (``evaluation.py:169-290``);
* :func:`recompute_bar_track_control` — ``cal_bar_track_control``
  (``:128-166``);
* :func:`recompute_bar_tension` — ``cal_bar_tension`` (``:50-89``);
* :class:`ControllabilityEvaluator` — the driving loop
  (``:1681-2864``): tensile per masked bar, or one track's
  density / occupation / polyphony, with ``unk_mode`` ablations that blank
  bar-track controls to ``unk`` (``:1497-1516``; 1=one_unk, 2=bar_unk,
  3=all_unk — see :func:`apply_unk_mode`).

Results are plain dicts of diff lists, JSON-serializable (the reference
pickles raw Python lists, ``:2815-2864``).

Copy of ``smer_music_generation_tpu/eval/controllability.py`` for the
PyTorch port, which imports nothing of the JAX package.  One change: the
engine's sampling noise comes from one ``torch.Generator`` seeded from
``seed`` on the engine's device, which every decode of the sweep draws from
in turn, where JAX splits a ``PRNGKey`` per (window, kind) (``run``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..codec.remi import remi_to_midi
from ..codec.smer import bar_events_to_midi, events_to_midi
from ..codec.structure import (
    _is_track_token,
    bar_with_track_positions,
    split_track_events,
    track_names_of,
)
from ..features.controls import (
    bar_track_density,
    bar_track_occupation_polyphony_rate,
    note_density,
    occupation_polyphony_rate,
)
from ..features.tension import score_tension
from ..vocab import ALL_KEY_NAMES, CONTROL_BINS, WordVocab, to_category
from ..infer.engine import (
    TOTAL_TRACK_CONTROL_TYPES,
    InfillEngine,
    decode_headers,
    is_control_copy_run,
)


def _bar_sixteenths(time_signature: str) -> int:
    beats = int(time_signature[0])
    return beats * 4 if beats != 6 else beats // 2 * 4


_REMI_STEP = re.compile(r"e_\d+$")


def _is_remi(tokens: Sequence[str]) -> bool:
    """Mode-1 streams carry explicit 16th-step onset tokens ``e_*``."""
    return any(_REMI_STEP.match(t) for t in tokens)


def _decode_window(events: Sequence[str]):
    """events -> MidiScore via the codec matching the stream's encoding
    (reference dispatches on ``rest_multi``: ``event_2midi`` vs
    ``remi_2midi``, ``evaluation.py:2261-2293``)."""
    if _is_remi(events):
        return remi_to_midi(list(events))
    return events_to_midi(list(events))


def recompute_track_controls(events: Sequence[str]) -> Optional[Dict]:
    """Re-measure whole-window track controls of an event stream."""
    score = _decode_window(events)
    if score is None:
        return None
    bar_six = _bar_sixteenths(events[0])
    n_bars = sum(1 for e in events if e == "bar")
    track_events = split_track_events(events)
    total_densities, _ = note_density(track_events, bar_six, bar_six * n_bars)
    beat_time = score.get_beats()
    div = 4 if int(events[0][0]) != 6 else 6
    sixteenth_time = (beat_time[1] - beat_time[0]) / div
    occupation, polyphony, _, _ = occupation_polyphony_rate(
        score, bar_six, sixteenth_time, n_bars
    )
    return {
        "density": to_category(total_densities, CONTROL_BINS),
        "occupation": to_category(occupation, CONTROL_BINS),
        "polyphony": to_category(polyphony, CONTROL_BINS),
    }


def recompute_bar_track_control(
    track_tokens: Sequence[str], headers: Sequence[str]
) -> Tuple[int, int, int]:
    """Achieved (density, occupation, polyphony) of one bar-track body."""
    body = [t for t in track_tokens if t != "continue"]
    bar_six = _bar_sixteenths(headers[0])
    if _is_remi(body):
        score = remi_to_midi(list(headers[:3]) + ["bar", "track_0"] + list(body))
    else:
        score = bar_events_to_midi(["bar", "track_0"] + list(body), headers[:3])
    density = to_category([bar_track_density([body], bar_six)], CONTROL_BINS)[0]
    if score is None:
        return density, -1, -1
    beat = score.get_beats()
    div = 4 if int(headers[0][0]) != 6 else 6
    sixteenth_time = (beat[1] - beat[0]) / div
    occ, poly = bar_track_occupation_polyphony_rate(score, sixteenth_time)
    if occ < 0:
        return density, -1, -1
    return (
        density,
        to_category([occ], CONTROL_BINS)[0],
        to_category([poly], CONTROL_BINS)[0],
    )


def recompute_bar_tension(
    bar_tokens: Sequence[str], headers: Sequence[str], key_name: Optional[str] = None
) -> Optional[int]:
    """Achieved tensile-strain category of one regenerated bar."""
    body = [t for t in bar_tokens if t not in ("continue", "<eos>")]
    if _is_remi(body):
        score = remi_to_midi(list(headers) + ["bar"] + list(body))
    else:
        score = bar_events_to_midi(["bar"] + list(body), headers)
    if score is None:
        return None
    res = score_tension(score, key_names=[key_name] if key_name else None)
    if res is None or not res[0]:
        return None
    return int(res[0][0])


# ---------------------------------------------------------------------------

_KIND_PREFIX = {"density": "d", "occupation": "o", "polyphony": "y"}
_KIND_ORDER = ("density", "occupation", "polyphony")


def _bar_track_parts(
    events: Sequence[str], tracks_in_bar, track: int
) -> Tuple[List[str], List[str], Optional[List[str]], Optional[str]]:
    """(leading copies, body, trailing copies | None, at-end s token | None)
    of one bar-track segment.  Trailing copies exist only in control_mode-2
    streams (reference ``dataset.py:121-153`` end duplication); detected by
    token class so control_mode-1 streams return None."""
    track_start, track_end = tracks_in_bar[track]
    tensile_end = 1 if events[track_end - 1].startswith("s_") else 0
    if (
        not tensile_end
        and events[track_end - 1] == "unk"
        and is_control_copy_run(
            list(events[track_end - 1 - TOTAL_TRACK_CONTROL_TYPES : track_end - 1])
        )
    ):
        # corrupted at-end tensile ('unk' written by change_controls /
        # unk-mode blanking), preceded by end copies — same detection as
        # the engine's _body_bounds (infer/engine.py)
        tensile_end = 1
    lead = list(events[track_start : track_start + TOTAL_TRACK_CONTROL_TYPES])
    trail_lo = track_end - tensile_end - TOTAL_TRACK_CONTROL_TYPES
    trail = list(events[trail_lo : track_end - tensile_end])
    is_copy = (
        # a control-mode-1 track with an EMPTY body is exactly K tokens:
        # the trail slice re-reads the leading copies — require room for
        # lead AND trail so leads are never reported as predictions
        trail_lo - track_start >= TOTAL_TRACK_CONTROL_TYPES
        and is_control_copy_run(trail)
    )
    body_end = trail_lo if is_copy else track_end - tensile_end
    body = list(events[track_start + TOTAL_TRACK_CONTROL_TYPES : body_end])
    s_tok = events[track_end - 1] if tensile_end else None
    return lead, body, (trail if is_copy else None), s_tok


def _copy_value(copies: Optional[List[str]], kind: str) -> Optional[int]:
    """Parse one kind's value out of a (d, o, y) copy triplet; None when the
    slot is blanked/malformed (the reference's membership guards,
    ``evaluation.py:2733-2737``)."""
    if copies is None:
        return None
    tok = copies[_KIND_ORDER.index(kind)]
    if tok[:2] != _KIND_PREFIX[kind] + "_" or not tok[2:].isdigit():
        return None
    return int(tok[2:])


def _track_control_token_set(vocab: WordVocab) -> set:
    """d/o/y tokens only — the reference's ``track_control_tokens``
    (``vocab.py:105-110``); tension/key are never blanked by unk modes."""
    s: set = set()
    for kind in ("density", "occupation", "polyphony"):
        s.update(vocab.name_to_tokens.get(kind, []))
    return s


def _track_heads(events: Sequence[str]):
    """Yield (bar_i, track_pos, start, end) for every bar-track segment,
    INCLUDING one in a trailing partial bar — ``bar_with_track_positions``
    emits only complete bars, which would exempt a truncated final bar
    from the unk ablation."""
    bar_i = -1
    track_pos = -1
    cur: Optional[Tuple[int, int, int]] = None
    for i, e in enumerate(events):
        if e == "bar" or _is_track_token(e):
            if cur is not None:
                yield (*cur, i)
                cur = None
            if e == "bar":
                bar_i += 1
                track_pos = -1
            else:
                track_pos += 1
                cur = (bar_i, track_pos, i + 1)
    if cur is not None:
        yield (*cur, len(events))


def apply_unk_mode(
    events: List[str],
    vocab: WordVocab,
    unk_mode: int,
    mask_tracks: Optional[Sequence[int]] = None,
    mask_bars: Optional[Sequence[int]] = None,
    selected_kind: Optional[str] = None,
) -> List[str]:
    """Blank bar-track control tokens to ``unk`` per the ablation mode.

    Reference semantics (``evaluation.py:1497-1516`` flag matrix):

    * 1 ``one_unk``: the masked tracks' per-bar copies of the *selected*
      control kind only (``evaluation.py:2197-2210``); tensile runs skip
      this mode entirely (``:1682``).
    * 2 ``bar_unk``: all bar-track controls of the masked tracks
      (``:2190-2195``) — or, for a bar-mask (tensile) run, every track's
      controls within the masked bars (``:2083-2095``).
    * 3 ``all_unk``: every d/o/y token from the first bar onward
      (``:1959-1962``).

    Bar tension tokens themselves are never blanked (the reference's
    ``track_control_tokens`` excludes them, ``vocab.py:105-110``).
    """
    if unk_mode == 0:
        return events
    out = list(events)
    blankable = _track_control_token_set(vocab)
    if unk_mode == 3:
        _, bar_poses, _ = bar_with_track_positions(out)
        if len(bar_poses):
            for i in range(bar_poses[0], len(out)):
                if out[i] in blankable:
                    out[i] = "unk"
        return out
    if unk_mode == 1 and (selected_kind is None or mask_tracks is None):
        return out
    targets = (
        blankable
        if unk_mode == 2
        else set(vocab.name_to_tokens.get(selected_kind, []))
    )
    for bar_i, track_pos, start, end in _track_heads(out):
        if unk_mode == 2 and mask_bars is not None:
            if bar_i not in mask_bars:
                continue
        elif mask_tracks is not None and track_pos not in mask_tracks:
            continue
        # blank the leading-copy head only; a truncated final track can be
        # shorter than the control head
        for i in range(start, min(start + TOTAL_TRACK_CONTROL_TYPES, end)):
            if out[i] in targets:
                out[i] = "unk"
    return out


def select_window_indices(n_total: int, max_windows: int, py_rng) -> List[int]:
    """Deterministic (seeded) evaluation subset, in source order."""
    return sorted(
        py_rng.choice(n_total, size=max_windows, replace=False).tolist()
    )


@dataclass
class EvalResult:
    control: str
    diffs: List[int] = field(default_factory=list)
    failures: int = 0
    # secondary diff families, {family: {kind: [diffs]}} — the reference's
    # extra pickle dumps (evaluation.py:2815-2858):
    #   track runs:  changed_track_other (whole-window drift of the
    #     non-selected kinds on the regenerated track, :2546-2556, signed),
    #     target/other_original_calculated (per-bar calculated minus the
    #     leading control copy, :2600-2650, signed), target/other_
    #     predicted_calculated (per-bar calculated minus the model's at-end
    #     copy, :2752-2813, signed)
    #   tensile runs: bar_track_calculated_original / _predicted_calculated
    #     (masked bars' per-track d/o/y, :2380-2450, abs), tension_
    #     predicted_calculated (at-end s token vs measured, :2460-2478, abs)
    secondary: Dict[str, Dict[str, List[int]]] = field(default_factory=dict)

    def add_secondary(self, family: str, kind: str, diff: int) -> None:
        self.secondary.setdefault(family, {}).setdefault(kind, []).append(int(diff))

    def merge(self, other: "EvalResult") -> None:
        self.diffs.extend(other.diffs)
        self.failures += other.failures
        for fam, kinds in other.secondary.items():
            for kind, ds in kinds.items():
                self.secondary.setdefault(fam, {}).setdefault(kind, []).extend(ds)

    def summary(self) -> Dict:
        out = {
            "control": self.control,
            "n": len(self.diffs),
            "mean_abs_diff": float(np.mean(self.diffs)) if self.diffs else None,
            "failures": self.failures,
            "diffs": self.diffs,
        }
        if self.secondary:
            out["secondary"] = {
                fam: {
                    kind: {
                        "n": len(ds),
                        "mean": float(np.mean(ds)) if ds else None,
                        "mean_abs": float(np.mean(np.abs(ds))) if ds else None,
                        "diffs": ds,
                    }
                    for kind, ds in kinds.items()
                }
                for fam, kinds in self.secondary.items()
            }
        return out


class ControllabilityEvaluator:
    """Mutate one control, regenerate, measure |set - achieved|."""

    def __init__(self, engine: InfillEngine, vocab: WordVocab, unk_mode: int = 0,
                 correct_controls: bool = False):
        """``correct_controls``: run the engine in the reference's
        ``use_correct_control`` mode (in-decode substitution of measured
        controls, ``evaluation.py:1217-1288``)."""
        self.engine = engine
        self.vocab = vocab
        self.unk_mode = unk_mode
        self._cc = "in_decode" if correct_controls else False
        self.time_correct_list: List[int] = []
        self.failed_times_list: List[int] = []

    # ------------------------------------------------------------------
    def evaluate_tensile(
        self, events: Sequence[str], bars: Sequence[int], new_values: Sequence[int], rng
    ) -> EvalResult:
        """Set s_* of the chosen bars, regenerate those whole bars."""
        result = EvalResult("tensile")
        events = list(events)
        # achieved tension must be measured against the WINDOW's key, not a
        # key re-detected from one regenerated bar (the reference passes
        # [original_key_name], evaluation.py:1227,2310)
        window_key = (
            ALL_KEY_NAMES[int(events[2][2:])]
            if len(events) > 2 and events[2].startswith("k_") and events[2][2:].isdigit()
            else None
        )
        _, bar_poses, bars_pos = bar_with_track_positions(events)
        substituted: List[Tuple[int, int]] = []
        for bar, value in zip(bars, new_values):
            # a bar index beyond the COMPLETE bars (truncated trailing bar,
            # or a caller-supplied out-of-range index) has no regenerable
            # content — and its "bar" token may be the last stream token
            if bar >= len(bars_pos) or bar_poses[bar] + 1 >= len(events):
                result.failures += 1
                continue
            # only substitute a real tensile slot: a stream built without
            # tension controls has a track token at bar+1 and must not be
            # structurally corrupted by a blind write
            if events[bar_poses[bar] + 1].startswith("s_") or events[
                bar_poses[bar] + 1
            ] == "unk":
                events[bar_poses[bar] + 1] = f"s_{value}"
                substituted.append((bar, value))
            else:
                # no tensile slot: nothing was set, so |set - achieved|
                # would compare against a value the model never saw
                result.failures += 1
        if not substituted:
            return result
        events = apply_unk_mode(events, self.vocab, self.unk_mode, mask_bars=list(bars))
        track_names = track_names_of(events)
        gen = self.engine(
            events, [int(n[-1]) for n in track_names], list(bars), rng,
            correct_controls=self._cc, span_retries=True,
        )
        if gen is None:
            result.failures += 1
            return result
        self._note_time_stats(gen)
        headers = self._headers(gen.events)
        progs = [t for t in headers if t.startswith("i_")]
        _, out_bar_poses, out_bars = bar_with_track_positions(gen.events)
        for bar, value in substituted:
            lo = out_bar_poses[bar]
            hi = out_bar_poses[bar + 1] if bar + 1 < len(out_bar_poses) else len(gen.events)
            achieved = recompute_bar_tension(
                gen.events[lo + 1 : hi], headers, key_name=window_key
            )
            if achieved is None:
                result.failures += 1
            else:
                result.diffs.append(abs(int(value) - achieved))
            if bar >= len(out_bars):
                continue
            # masked bars' per-track d/o/y drift and at-end predictions
            # (reference evaluation.py:2380-2478, abs diffs)
            tracks_in_bar = out_bars[bar]
            for tr in range(len(tracks_in_bar)):
                lead, body, trail, s_tok = _bar_track_parts(
                    gen.events, tracks_in_bar, tr
                )
                hdr3 = [
                    gen.events[0],
                    gen.events[1],
                    progs[tr] if tr < len(progs) else "i_0",
                ]
                d, o, y = recompute_bar_track_control(body, hdr3)
                calc = {"density": d, "occupation": o, "polyphony": y}
                for k2 in _KIND_ORDER:
                    if calc[k2] < 0:
                        continue
                    if self.unk_mode != 2:  # skipped under bar_unk (:2387)
                        v = _copy_value(lead, k2)
                        if v is not None:
                            result.add_secondary(
                                "bar_track_calculated_original", k2,
                                abs(calc[k2] - v),
                            )
                    v = _copy_value(trail, k2)
                    if v is not None:
                        result.add_secondary(
                            "bar_track_predicted_calculated", k2,
                            abs(calc[k2] - v),
                        )
                if (
                    tr == len(tracks_in_bar) - 1
                    and s_tok is not None
                    and s_tok[2:].isdigit()
                    and achieved is not None
                ):
                    result.add_secondary(
                        "tension_predicted_calculated", "tensile",
                        abs(achieved - int(s_tok[2:])),
                    )
        return result

    def evaluate_track_control(
        self, events: Sequence[str], track: int, kind: str, new_value: int, rng,
        py_rng: Optional[np.random.Generator] = None,
    ) -> EvalResult:
        """Set one track's whole-window d/o/y control, regenerate the track.

        Matches the reference's mutation scheme (``evaluation.py:2165-2224``):
        the header control is set to the new value AND the masked track's
        per-bar-track copies of the same kind are rewritten to
        ``new_value + U{-1,0,1}`` clipped to [0, 9] (unk_mode 0) — the model
        conditions on the per-bar copies, so leaving them stale measures
        nothing."""
        assert kind in _KIND_ORDER
        prefix = _KIND_PREFIX[kind]
        result = EvalResult(kind)
        events = list(events)
        track_names = track_names_of(events)
        bar0 = next(i for i, t in enumerate(events) if t == "bar")
        header = events[:bar0]
        positions = [
            i for i, t in enumerate(header) if t.startswith(prefix + "_") and t[2:].isdigit()
        ]
        if track >= len(positions):
            result.failures += 1
            return result
        events[positions[track]] = f"{prefix}_{new_value}"
        if self.unk_mode == 0:
            py_rng = py_rng or np.random.default_rng(0)
            _, _, bars = bar_with_track_positions(events)
            for tracks_in_bar in bars:
                if track >= len(tracks_in_bar):
                    continue
                track_start, track_end = tracks_in_bar[track]
                for pos in list(range(track_start, track_start + TOTAL_TRACK_CONTROL_TYPES)) + list(
                    range(track_end - TOTAL_TRACK_CONTROL_TYPES - 1, track_end)
                ):
                    if 0 <= pos < len(events) and events[pos].startswith(prefix + "_"):
                        v = int(np.clip(new_value + py_rng.integers(-1, 2), 0, 9))
                        events[pos] = f"{prefix}_{v}"
        events = apply_unk_mode(
            events, self.vocab, self.unk_mode, mask_tracks=[track], selected_kind=kind
        )
        # complete bars only (a truncated trailing bar has no maskable
        # track segments; requesting it is at best a no-op)
        n_bars = len(bar_with_track_positions(list(events))[2])
        gen = self.engine(events, [int(track_names[track][-1])], list(range(n_bars)), rng,
                          correct_controls=self._cc, span_retries=True)
        if gen is None:
            result.failures += 1
            return result
        self._note_time_stats(gen)
        achieved = recompute_track_controls(gen.events)
        if achieved is None or track >= len(achieved[kind]):
            result.failures += 1
            return result
        result.diffs.append(abs(int(new_value) - int(achieved[kind][track])))
        self._track_secondary(result, gen.events, track, kind, achieved)
        return result

    def _track_secondary(
        self, result: EvalResult, events_out: Sequence[str], track: int,
        kind: str, achieved: Dict,
    ) -> None:
        """Secondary diff families of a track-control run (signed, matching
        the reference's conventions)."""
        bar0 = next(i for i, t in enumerate(events_out) if t == "bar")
        header = list(events_out[:bar0])
        progs = [t for t in header if t.startswith("i_")]
        # whole-window drift of the NON-selected kinds on the regenerated
        # track (reference :2546-2556, original minus achieved)
        for k2 in _KIND_ORDER:
            if k2 == kind:
                continue
            pos = [
                t for t in header
                if t[:2] == _KIND_PREFIX[k2] + "_" and t[2:].isdigit()
            ]
            if track < len(pos) and track < len(achieved[k2]):
                result.add_secondary(
                    "changed_track_other", k2,
                    int(pos[track][2:]) - int(achieved[k2][track]),
                )
        # per-bar copies on the masked track vs re-measured content
        # (reference :2600-2813, calculated minus copy)
        hdr3 = [
            events_out[0], events_out[1],
            progs[track] if track < len(progs) else "i_0",
        ]
        _, _, bars_out = bar_with_track_positions(list(events_out))
        for tracks_in_bar in bars_out:
            if track >= len(tracks_in_bar):
                continue
            lead, body, trail, _ = _bar_track_parts(events_out, tracks_in_bar, track)
            d, o, y = recompute_bar_track_control(body, hdr3)
            calc = {"density": d, "occupation": o, "polyphony": y}
            for k2 in _KIND_ORDER:
                if calc[k2] < 0:
                    continue
                fam = "target" if k2 == kind else "other"
                # original copies: skipped under bar_unk entirely and under
                # one_unk for the selected kind (:2600,:2610)
                if self.unk_mode != 2 and not (k2 == kind and self.unk_mode == 1):
                    v = _copy_value(lead, k2)
                    if v is not None:
                        result.add_secondary(
                            f"{fam}_original_calculated", k2, calc[k2] - v
                        )
                v = _copy_value(trail, k2)
                if v is not None:
                    result.add_secondary(
                        f"{fam}_predicted_calculated", k2, calc[k2] - v
                    )

    def _note_time_stats(self, gen) -> None:
        """Reference ``time_correct_list`` / ``failed_times_list``
        (evaluation.py:1319-1328) — re-decode attempts before the spans
        closed their bar durations, and whether forced repair was needed.
        Per-span-group granularity when the engine ran span retries."""
        per_span = getattr(gen, "time_corrections_per_span", None)
        if per_span is not None:
            self.time_correct_list.extend(int(c) for c in per_span)
            self.failed_times_list.extend(
                int(f) for f in gen.time_failed_per_span
            )
            return
        self.time_correct_list.append(int(getattr(gen, "time_corrections", 0)))
        self.failed_times_list.append(int(getattr(gen, "time_failed", False)))

    # ------------------------------------------------------------------
    @staticmethod
    def _headers(events: Sequence[str]) -> List[str]:
        # bar_events_to_midi needs [time_sig, tempo, programs...]
        return decode_headers(events)

    def run(
        self,
        test_windows: Sequence[Sequence[str]],
        control_kinds: Sequence[str] = ("tensile", "density", "occupation", "polyphony"),
        seed: int = 0,
        max_windows: Optional[int] = None,
    ) -> Dict[str, Dict]:
        """Sweep the test set; returns {control: summary} (reference dumps
        the same |set-achieved| lists, ``evaluation.py:2815-2864``)."""
        rng = torch.Generator(device=self.engine.decoder.device).manual_seed(seed)
        py_rng = np.random.default_rng(seed)
        self.time_correct_list = []
        self.failed_times_list = []
        results = {k: EvalResult(k) for k in control_kinds}
        windows = list(test_windows)
        if max_windows and max_windows < len(windows):
            # seeded random subset, NOT a prefix: packed batches order
            # short (single-track) windows first, so a prefix would bias
            # the measurement toward the easiest windows
            idx = select_window_indices(len(windows), max_windows, py_rng)
            windows = [windows[i] for i in idx]
        for events in windows:
            # COMPLETE bars only: a window truncated mid-bar still carries
            # the trailing "bar" token, but that bar has no maskable track
            # segments (the engine skips it) and may lack even a tensile
            # slot — selecting it would read past the stream end below and
            # measure |set−achieved| against content that was never
            # regenerated.  Complete windows: identical to the token count.
            _, bar_poses, complete_bars = bar_with_track_positions(list(events))
            n_bars = len(complete_bars)
            track_names = track_names_of(events)
            if n_bars == 0 or not track_names:
                # degenerate window (truncated inside its first bar, or no
                # track headers): nothing is maskable for any control kind
                continue
            for kind in control_kinds:
                if kind == "tensile" and self.unk_mode == 1:
                    # reference skips tensile under one_unk: there is no
                    # "selected track control" to blank (evaluation.py:1682)
                    continue
                if kind == "tensile":
                    n_mut = int(py_rng.integers(1, min(4, n_bars) + 1))
                    bars = sorted(py_rng.choice(n_bars, n_mut, replace=False).tolist())
                    # reference constraint: |original - new| <= 4
                    # (evaluation.py:2078), unreachable jumps are excluded
                    values = []
                    for b in bars:
                        tok = events[bar_poses[b] + 1]
                        orig = int(tok.split("_")[1]) if tok.startswith("s_") else 6
                        lo, hi = max(0, orig - 4), min(11, orig + 4)
                        values.append(int(py_rng.integers(lo, hi + 1)))
                    r = self.evaluate_tensile(events, bars, values, rng)
                else:
                    track = int(py_rng.integers(len(track_names)))
                    value = int(py_rng.integers(0, 10))
                    r = self.evaluate_track_control(
                        events, track, kind, value, rng, py_rng=py_rng
                    )
                results[kind].merge(r)
        out: Dict[str, Dict] = {k: v.summary() for k, v in results.items()}
        # reference time_correct_list / failed_times_list dumps (:2858-2864)
        out["time_stats"] = {
            "time_correct_list": list(self.time_correct_list),
            "failed_times_list": list(self.failed_times_list),
            "mean_corrections": (
                float(np.mean(self.time_correct_list))
                if self.time_correct_list
                else None
            ),
            "failed_rate": (
                float(np.mean(self.failed_times_list))
                if self.failed_times_list
                else None
            ),
        }
        return out
