"""Host-side infilling orchestration around the decode loop.

Port of ``smer_music_generation_tpu/infer/engine.py``: ``InfillEngine``
(``__init__``, ``prepare`` :425, ``run_batch`` :478 without its group padding
to B in {1, 4, 8}, ``_assemble`` :565, ``_finish_group`` :585 with its
bar-time retry loop, ``__call__`` :716) and copies of the host helpers
``fill_empty_bars`` (:41), ``mask_bar_and_track`` (:72),
``restore_marked_input`` (:154), ``check_track_total_time`` (:180),
``change_controls`` (:256) and ``_repair_durations`` (:1168).  Build the
masked source, run the decoder, splice results back, repair bar durations.

``quant="int8"`` (with the fused decoder) streams int8 decoder weights
through every batch: the kernels take any group of 1 to 8 rows, so no call
shape falls back to unquantized weights as JAX's can (:259-268).
``draft_k > 0`` decodes a group of one request by speculative decode (the
decoder's v5 loop); a larger group takes the batched loop, as in JAX.

Not ported yet (they raise ``NotImplementedError``): ``span_retries``
(ROADMAP.md Queue 1 item 5), ``correct_controls`` (Queue 1 item 7) and
``mesh`` (Queue 1 item 11).  Sampling noise comes from a
``torch.Generator``; a retry draws fresh noise from it where JAX folds a
new key.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..codec.durations import DurationTable, duration_table_for_signature
from ..codec.structure import bar_with_track_positions, track_names_of
from ..data.masking import copy_bar_controls_to_end
from ..vocab import WordVocab
from .decode import InfillDecoder, pad_to_bucket
from .grammar import SPAN_CODE

TOTAL_TRACK_CONTROL_TYPES = 3


def fill_empty_bars(
    events: List[str],
    generate_bar_number: int,
    table: DurationTable,
    mode: int = 0,
) -> List[str]:
    """Extend the song with placeholder bars to be infilled.

    Divergence from reference ``generation.py:230-245``: the reference
    emits legacy tokens (``a_0``, ``rest_e``) that are not in its own
    vocabulary; here the appended bars follow the live control-mode-2
    layout (``s_2`` tension slot, neutral ``d_0 o_0 y_0`` controls, full-bar
    rest) so every token is encodable.  Mode 1 (REMI) has no rest tokens —
    an empty bar is simply a track with no onsets.
    """
    bar_duration_list = (
        ["rest"] + table.time_to_names(table.bar_duration) if mode == 0 else []
    )
    track_names = track_names_of(events)
    for _ in range(generate_bar_number):
        events.append("bar")
        events.append("s_2")
        for name in track_names:
            events.append(name)
            events.extend(["d_0", "o_0", "y_0"])
            events.extend(bar_duration_list)
            events.extend(["d_0", "o_0", "y_0"])
        events.append("s_2")
    return events


def mask_bar_and_track(
    events: Sequence[str],
    vocab: WordVocab,
    mask_tracks: Sequence[int],
    mask_bars: Sequence[int],
) -> Optional[Tuple[np.ndarray, List[int], List[int], List[int]]]:
    """Replace (bar, track) bodies and their end-control slots with ``m_0``.

    Returns (src ids, span type codes, masked track ids, masked bar ids).
    Expects the control-mode-2 serving layout: per-track leading ``d o y``,
    trailing ``d o y`` copies, and a trailing tensile copy on the last
    track of each bar (reference ``generation.py:248-341``).
    """
    track_names, bar_poses, bars = bar_with_track_positions(events)
    masked_pairs: List[Tuple[int, int]] = []
    span_codes: List[int] = []
    mask_bar_names: List[int] = []
    mask_track_names: List[int] = []

    for bar_num in mask_bars:
        if bar_num >= len(bars):
            return None
        for track_pos, (track_start, track_end) in enumerate(bars[bar_num]):
            if track_pos not in mask_tracks:
                continue
            mask_bar_names.append(bar_num)
            mask_track_names.append(track_pos)
            head = list(events[track_start : track_start + TOTAL_TRACK_CONTROL_TYPES])
            if not is_control_copy_run(head):
                raise ValueError(
                    "bar-track segment lacks the 3-copy d/o/y control head "
                    f"the serving layout requires (got {head}); streams from "
                    "partial-control (-t 2/3/4) builds cannot drive "
                    "infilling — the reference engine hardcodes the same "
                    "layout (generation.py:248-341)."
                )
            token_start = track_start + TOTAL_TRACK_CONTROL_TYPES
            tensile_end = (
                1 if events[track_end - 1] in vocab.name_to_tokens.get("tensile", []) else 0
            )
            token_end = track_end - TOTAL_TRACK_CONTROL_TYPES - tensile_end
            masked_pairs.append((token_start, token_end))
            span_codes.append(SPAN_CODE["r"])
            for i, code in enumerate(["d", "o", "p", "t"][: TOTAL_TRACK_CONTROL_TYPES + tensile_end]):
                masked_pairs.append((token_end + i, token_end + 1 + i))
                span_codes.append(SPAN_CODE[code])

    if not masked_pairs:
        return None

    token_events = list(events)
    order = sorted(range(len(masked_pairs)), key=lambda i: masked_pairs[i][0])
    span_codes = [span_codes[i] for i in order]
    pairs_sorted = [masked_pairs[i] for i in order]
    for lo, hi in reversed(pairs_sorted):
        del token_events[lo:hi]
        token_events.insert(lo, "m_0")

    src = np.array([vocab.char2index(tok) for tok in token_events], dtype=np.int32)
    return src, span_codes, mask_track_names, mask_bar_names


def is_control_copy_run(c: Sequence[str]) -> bool:
    """True for an exact 3-token d/o/y control-copy run (any token possibly
    blanked to ``unk`` by ``change_controls`` / unk-mode corruption) — the
    per-track head/trail layout control-mode-2 serving streams carry
    (reference ``dataset.py:121-153``, ``generation.py:248-341``).  Shared
    by the engine's body-bounds/masking and the eval harness so their
    segment parses can never disagree."""
    return len(c) == TOTAL_TRACK_CONTROL_TYPES and all(
        t == "unk" or t[:2] in ("d_", "o_", "y_") for t in c
    )


def restore_marked_input(
    src_tokens: Sequence[str], generated_output: Sequence[str]
) -> List[str]:
    """Splice generated spans back into the masked source.

    ``generated_output`` is the decoder stream: spans concatenated, each
    introduced by ``m_0`` (reference ``generation.py:417-465``).
    """
    gen = list(generated_output)
    mask_positions = [i for i, tok in enumerate(gen) if tok == "m_0"]
    spans: List[List[str]] = []
    for i, start in enumerate(mask_positions):
        end = mask_positions[i + 1] if i + 1 < len(mask_positions) else len(gen)
        spans.append(gen[start + 1 : end])

    out: List[str] = []
    si = 0
    for tok in src_tokens:
        if tok == "m_0" and si < len(spans):
            out.extend(spans[si])
            si += 1
        else:
            out.append(tok)
    return out


def check_track_total_time(
    events: List[str], table: DurationTable
) -> Tuple[bool, List[str]]:
    """Verify a generated track body closes its bar exactly; repair if not.

    Simulates the event VM's cursor (``rest`` advances, ``sep`` rewinds to
    the previous group's start) and rewrites the final duration group so
    the track sums to the bar duration (reference ``generation.py:344-414``
    / ``evaluation.py:740-818``; those versions treat ``sep`` groups as
    plain advances via a dead legacy ``rest_s`` branch — this one accounts
    for the rewind, matching the decoder's actual timing).
    """
    bar_duration = table.bar_duration
    if len(events) == 0:
        parts = table.time_to_names(bar_duration)
        return False, ["rest"] + parts

    current = 0.0
    previous_duration = 0.0
    duration_list: List[str] = []
    in_duration = False
    is_sep = False
    new_events: List[str] = []
    last_group_time = 0.0
    truncated = False

    for i, event in enumerate(events):
        new_events.append(event)
        if in_duration and event not in table.name_to_time:
            last_group_time = table.total_duration(duration_list)
            start = current - previous_duration if is_sep else current
            current = start + last_group_time
            previous_duration = last_group_time
            in_duration = False
            is_sep = False
            if current >= bar_duration:
                truncated = i < len(events) - 1
                break
            duration_list = []
        if event in table.name_to_time:
            in_duration = True
            duration_list.append(event)
            continue
        if event == "sep":
            is_sep = True

    else:
        if duration_list:
            last_group_time = table.total_duration(duration_list)
            start = current - previous_duration if is_sep else current
            current = start + last_group_time

    while new_events and new_events[-1] not in table.name_to_time:
        new_events.pop()
    if abs(current - bar_duration) < 1e-9:
        # exact close; a truncated stream still needs the caller to adopt
        # the trimmed body
        return (not truncated), new_events
    if current == 0.0 or not new_events:
        parts = table.time_to_names(bar_duration)
        return False, ["rest"] + parts

    adjusted = last_group_time + (bar_duration - current)
    if adjusted <= 0:
        adjusted = table.sixteenth
    parts = table.time_to_names(adjusted)
    # Replace the final duration group = the trailing run of duration
    # tokens.  (Popping len(duration_list) is wrong when the stream was
    # cap-truncated mid-group: duration_list is empty then, but `current`
    # still includes the last CLOSED group, so it must be swapped out.)
    while new_events and new_events[-1] in table.name_to_time:
        new_events.pop()
    new_events.extend(parts)
    return False, new_events


def change_controls(original_event: List[str], controls: Dict, vocab: WordVocab) -> List[str]:
    """Rewrite control tokens from the UI dict then copy them to span ends
    (reference ``generation.py:698-877``)."""
    event = list(original_event)
    arr = np.array(event)
    track_names = track_names_of(event)
    track_nums = len(track_names)
    bar_poses = np.where(arr == "bar")[0]

    header = event[: bar_poses[0]]
    d_pos = [i for i, tok in enumerate(header) if tok.startswith("d_")]
    o_pos = [i for i, tok in enumerate(header) if tok.startswith("o_")]
    y_pos = [i for i, tok in enumerate(header) if tok.startswith("y_")]

    for t_num in range(track_nums):
        key = f"track_{track_names[t_num][-1]}_c"
        if key not in controls:
            continue
        if t_num < len(d_pos):
            event[d_pos[t_num]] = f"d_{controls[key]['density']}"
        if t_num < len(o_pos):
            event[o_pos[t_num]] = f"o_{controls[key]['occupation']}"
        if t_num < len(y_pos):
            event[y_pos[t_num]] = f"y_{controls[key]['polyphony']}"

    _, _, bars = bar_with_track_positions(event)

    if controls.get("bar_track") == 0:
        for bar_num, tracks_in_bar in enumerate(bars):
            for track_pos, (track_start, _) in enumerate(tracks_in_bar):
                name = track_names[track_pos]
                bd = controls["bar_density"][name][bar_num]
                bo = controls["bar_occupation"][name][bar_num]
                bp = controls["bar_polyphony"][name][bar_num]
                event[track_start] = "unk" if bd == 10 else f"d_{bd}"
                event[track_start + 1] = "unk" if bo == 10 else f"o_{bo}"
                event[track_start + 2] = "unk" if bp == 10 else f"y_{bp}"
    else:
        for bar_num, tracks_in_bar in enumerate(bars):
            if controls.get("s_bar", 0) <= bar_num <= controls.get("e_bar", len(bars)):
                for track_pos, (track_start, _) in enumerate(tracks_in_bar):
                    if controls.get(track_names[track_pos]) == 0:
                        event[track_start] = "unk"
                        event[track_start + 1] = "unk"
                        event[track_start + 2] = "unk"

    return copy_bar_controls_to_end(event, vocab, TOTAL_TRACK_CONTROL_TYPES, True)


# ---------------------------------------------------------------------------
# The infilling engine
# ---------------------------------------------------------------------------


@dataclass
class InfillResult:
    events: List[str]  # restored full stream
    generated: List[str]  # raw decoder stream (m_0-separated spans)
    mask_tracks: List[int]
    mask_bars: List[int]
    decode_steps: int
    time_corrections: int = 0  # re-decode attempts before spans closed
    time_failed: bool = False  # exhausted retries; forced repair applied


@dataclass
class PreparedRequest:
    """A masked infill request ready for (batched) device decode."""

    src: np.ndarray  # (S,) int32 masked source ids
    span_codes: List[int]
    mask_tracks: List[int]
    mask_bars: List[int]
    table: DurationTable
    no_whole_duration: bool


class InfillEngine:
    """One object holds the decoder; each call masks the requested
    (bar, track) slots, decodes them, restores the stream and repairs bar
    durations on the host (bounded retries around a fresh decode,
    reference ``evaluation.py:1300-1397``)."""

    def __init__(
        self,
        model,
        vocab: WordVocab,
        nucleus_p: Optional[float] = 0.9,
        temperature: float = 1.0,
        greedy: bool = False,
        max_tgt_len: int = 1024,
        max_time_fix_attempts: int = 10,
        quant: str = "none",
        mesh=None,
        draft_k: int = 0,
        fused: Optional[bool] = None,
        seed: int = 0,
    ):
        self.model = model
        self.vocab = vocab
        self.max_time_fix_attempts = max_time_fix_attempts
        self.decoder = InfillDecoder(
            model,
            vocab,
            max_tgt_len=max_tgt_len,
            nucleus_p=nucleus_p,
            temperature=temperature,
            greedy=greedy,
            quant=quant,
            mesh=mesh,
            draft_k=draft_k,
            fused=fused,
            seed=seed,
        )

    def _dispatch(self, src_b, span_types, n_spans, no_whole, generator):
        return self.decoder(src_b, span_types, n_spans, no_whole, generator=generator)

    def prepare(
        self,
        events: Sequence[str],
        tracks_to_generate: Sequence[int],
        bars_to_generate: Sequence[int],
    ) -> Optional["PreparedRequest"]:
        """Mask the requested slots; returns the device-ready request."""
        events = list(events)
        numerator = int(events[0].split("/")[0])
        denominator = int(events[0].split("/")[1])
        table = duration_table_for_signature((numerator, denominator), tempo=60.0)
        no_whole_duration = not (numerator >= 4 and denominator == 4)

        track_names = track_names_of(events)
        try:
            track_ids = [track_names.index(f"track_{t}") for t in tracks_to_generate]
        except ValueError:
            return None  # a requested track does not exist in this stream

        # the serving layout needs the trailing d/o/y copies and the
        # bar-end tensile; no-op on streams that already have them
        events = copy_bar_controls_to_end(
            events, self.vocab, TOTAL_TRACK_CONTROL_TYPES,
            "tensile" in self.vocab.class_names,
        )

        n_bars = len([e for e in events if e == "bar"])
        if bars_to_generate and bars_to_generate[-1] >= n_bars:
            events = fill_empty_bars(
                events, bars_to_generate[-1] - n_bars + 1, table,
                mode=self.vocab.mode,
            )

        result = mask_bar_and_track(events, self.vocab, track_ids, bars_to_generate)
        if result is None:
            return None
        src, span_codes, mask_track_names, mask_bar_names = result
        return PreparedRequest(
            src=src,
            span_codes=span_codes,
            mask_tracks=mask_track_names,
            mask_bars=mask_bar_names,
            table=table,
            no_whole_duration=no_whole_duration,
        )

    def run_batch(
        self,
        requests: Sequence["PreparedRequest"],
        generator: Optional[torch.Generator] = None,
        fix_durations: bool = True,
        correct_controls: bool = False,
    ) -> List[Optional[InfillResult]]:
        """Decode many infill requests as batched decoder sessions.

        Requests may differ in source length (padded to a common bucket),
        span structure and time signature.  With the kernel, more than 8
        requests run as groups of 8 and a last smaller group, as the JAX
        engine groups them; a group is never padded with dummy rows, since
        the CUDA kernels take any batch of 1 to 8 (JAX pads to 1, 4 or 8
        for a Mosaic tiling limit of the TPU, ``infer/decode.py:240-258``)."""
        if correct_controls:
            raise NotImplementedError(
                "correct_controls is not ported to PyTorch yet (ROADMAP.md Queue 1 item 7)"
            )
        if not requests:
            return []
        if generator is None:
            generator = self.decoder.generator
        group = 8 if self.decoder.fused else len(requests)
        pending = []
        for i in range(0, len(requests), group):
            grp = requests[i : i + group]
            asm = self._assemble(grp)
            out = self._dispatch(asm[0], asm[1], asm[2], asm[3], generator)
            pending.append((grp, asm, out))
        results: List[Optional[InfillResult]] = []
        for grp, asm, out in pending:
            results.extend(
                self._finish_group(grp, generator, asm, out, fix_durations=fix_durations)
            )
        return results

    def _assemble(self, requests: Sequence["PreparedRequest"]):
        """Pack requests into batch arrays."""
        B = len(requests)
        max_spans = self.decoder.max_spans
        max_src = max(len(r.src) for r in requests)
        src_b = np.zeros((B, max_src), dtype=np.int32)
        span_types = np.zeros((B, max_spans), dtype=np.int32)
        n_spans = np.zeros((B,), dtype=np.int32)
        no_whole = np.zeros((B,), dtype=bool)
        overflow = [i for i, r in enumerate(requests) if len(r.span_codes) > max_spans]
        for i, r in enumerate(requests):
            if i in overflow:
                continue  # decoded as a no-op; result reported as None below
            src_b[i, : len(r.src)] = r.src
            span_types[i, : len(r.span_codes)] = r.span_codes
            n_spans[i] = len(r.span_codes)
            no_whole[i] = r.no_whole_duration
        src_b = pad_to_bucket(src_b)
        return src_b, span_types, n_spans, no_whole, overflow

    def _finish_group(
        self,
        requests: Sequence["PreparedRequest"],
        generator: torch.Generator,
        asm,
        out0,
        fix_durations: bool,
    ) -> List[Optional[InfillResult]]:
        src_b, span_types, n_spans, no_whole, overflow = asm

        # Elements whose generated bars do not close their bar duration are
        # re-decoded with fresh noise (up to max_time_fix_attempts) before
        # the forced duration repair rewrites them.  Settled elements stay
        # in the batch with n_spans = 0.  Greedy decoding is deterministic,
        # so it goes straight to repair.
        retries = (
            self.max_time_fix_attempts
            if fix_durations and self.vocab.mode == 0 and not self.decoder.greedy
            else 0
        )
        live = n_spans.copy()
        settled: Dict[int, Tuple[List[str], List[str], int, int, bool]] = {}
        check_close = fix_durations and self.vocab.mode == 0
        src_tokens_all = [
            [self.vocab.index2char(int(t)) for t in r.src] for r in requests
        ]
        for attempt in range(1 + retries):
            out = (
                out0
                if attempt == 0
                else self._dispatch(src_b, span_types, live, no_whole, generator)
            )
            tokens_all = out.tokens.cpu().numpy()
            lengths = out.lengths.cpu().numpy()
            for i, r in enumerate(requests):
                if i in overflow or i in settled or live[i] == 0:
                    continue
                generated = [
                    self.vocab.index2char(int(t)) for t in tokens_all[i][: int(lengths[i])]
                ]
                restored = restore_marked_input(src_tokens_all[i], generated)
                last = attempt == retries
                closed = self._spans_close(restored, r) if check_close else True
                if last or closed:
                    settled[i] = (restored, generated, int(out.steps), attempt, closed)
                    live[i] = 0
            if not np.any(live):
                break

        results: List[Optional[InfillResult]] = []
        for i, r in enumerate(requests):
            if i in overflow:
                results.append(None)
                continue
            if i not in settled:  # n_spans was 0 from the start
                settled[i] = (list(src_tokens_all[i]), [], 0, 0, True)
            restored, generated, steps_i, attempts_i, closed_i = settled[i]
            if fix_durations and self.vocab.mode == 0:
                restored = self._repair_durations(restored, r.table)
            results.append(
                InfillResult(
                    events=restored,
                    generated=generated,
                    mask_tracks=r.mask_tracks,
                    mask_bars=r.mask_bars,
                    decode_steps=steps_i,
                    time_corrections=attempts_i,
                    time_failed=not closed_i,
                )
            )
        return results

    def _body_bounds(
        self, events: List[str], track_start: int, track_end: int
    ) -> Tuple[int, int]:
        """(body_start, body_end) of one bar-track segment; trailing control
        copies and the at-end tensile token are detected by token class."""
        tens = self.vocab.name_to_tokens.get("tensile", [])

        end = track_end
        if events[end - 1] in tens:
            end -= 1
        elif events[end - 1] == "unk" and is_control_copy_run(
            list(events[end - 1 - TOTAL_TRACK_CONTROL_TYPES : end - 1])
        ):
            end -= 1  # corrupted at-end tensile, preceded by end copies
        if is_control_copy_run(list(events[end - TOTAL_TRACK_CONTROL_TYPES : end])):
            end -= TOTAL_TRACK_CONTROL_TYPES
        return track_start + TOTAL_TRACK_CONTROL_TYPES, end

    def _spans_close(self, events: List[str], req: "PreparedRequest") -> bool:
        """True when every regenerated (bar, track) body already sums to the
        bar duration exactly."""
        try:
            _, _, bars = bar_with_track_positions(events)
        except (IndexError, ValueError):
            return False
        for bar_num, track_pos in zip(req.mask_bars, req.mask_tracks):
            if bar_num >= len(bars) or track_pos >= len(bars[bar_num]):
                return False
            track_start, track_end = bars[bar_num][track_pos]
            body_start, body_end = self._body_bounds(events, track_start, track_end)
            ok, _ = check_track_total_time(events[body_start:body_end], req.table)
            if not ok:
                return False
        return True

    def __call__(
        self,
        events: Sequence[str],
        tracks_to_generate: Sequence[int],
        bars_to_generate: Sequence[int],
        generator: Optional[torch.Generator] = None,
        fix_durations: bool = True,
        correct_controls=False,
        span_retries: bool = False,
    ) -> Optional[InfillResult]:
        if span_retries:
            raise NotImplementedError(
                "span_retries is not ported to PyTorch yet (ROADMAP.md Queue 1 item 5)"
            )
        req = self.prepare(events, tracks_to_generate, bars_to_generate)
        if req is None:
            return None
        return self.run_batch(
            [req], generator, fix_durations=fix_durations,
            correct_controls=correct_controls,
        )[0]

    def _repair_durations(self, events: List[str], table: DurationTable) -> List[str]:
        """Check every track body sums to the bar duration; rewrite tails."""
        _, _, bars = bar_with_track_positions(events)
        out = list(events)
        # walk bars in reverse so earlier indices stay valid after edits
        for tracks_in_bar in reversed(bars):
            for track_start, track_end in reversed(tracks_in_bar):
                body_start, body_end = self._body_bounds(out, track_start, track_end)
                if body_end <= body_start:
                    continue
                body = out[body_start:body_end]
                ok, fixed = check_track_total_time(body, table)
                # adopt the repaired body whenever it differs (the
                # reference assigns it unconditionally, evaluation.py:1304)
                if not ok or fixed != body:
                    out[body_start:body_end] = fixed
        return out
