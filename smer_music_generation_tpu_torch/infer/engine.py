"""Host-side infilling orchestration around the decode loop.

Port of ``smer_music_generation_tpu/infer/engine.py``: ``InfillEngine``
(``__init__``, ``prepare`` :425, ``run_batch`` :478 without its group padding
to B in {1, 4, 8}, ``_assemble`` :565, ``_finish_group`` :585 with its
bar-time retry loop and the post-hoc ``correct_controls`` rewrite,
``__call__`` :716, the span-retry settle loop ``run_with_span_retries``
:760-983 with its plain-loop ``_eval_decoder`` :987, and the in-decode
``run_with_correct_controls`` :1006-1166) and copies of the host helpers
``_split_spans`` (:30), ``fill_empty_bars`` (:41), ``mask_bar_and_track``
(:72), ``decode_headers`` (:146), ``restore_marked_input`` (:154),
``check_track_total_time`` (:180), ``change_controls`` (:256) and
``_repair_durations`` (:1168).  Build the masked source, run the decoder,
splice results back, repair bar durations.

``quant="int8"`` (with the fused decoder) streams int8 decoder weights
through every batch: the kernels take any group of 1 to 8 rows, so no call
shape falls back to unquantized weights as JAX's can (:259-268).
``draft_k > 0`` decodes a group of one request by speculative decode (the
decoder's v5 loop); a larger group takes the batched loop, as in JAX.

``mesh`` (a ``parallel.mesh.make_mesh`` mesh) places the model on every dp
device once and shards each group's rows over dp (``infer/decode.py``):
groups of ``8 * dp`` rows, each padded to a multiple of dp with
done-at-start dummies (JAX :504-533); quantized weights with a mesh raise,
as in JAX.  Sampling noise comes from a ``torch.Generator``: a retry,
and each decode of the settle loop, draws fresh noise from it in decode
order where JAX folds a new key (``fold_in(rng, i)``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..codec.durations import DurationTable, duration_table_for_signature
from ..codec.structure import bar_with_track_positions, track_names_of
from ..data.masking import copy_bar_controls_to_end
from ..vocab import ALL_KEY_NAMES, WordVocab
from .decode import InfillDecoder, pad_to_bucket
from .grammar import SPAN_CODE

TOTAL_TRACK_CONTROL_TYPES = 3


def _split_spans(generated: Sequence[str]) -> List[List[str]]:
    """Decoder output stream -> list of spans (split on ``m_0`` markers)."""
    spans: List[List[str]] = []
    for tok in generated:
        if tok == "m_0":
            spans.append([])
        elif spans:
            spans[-1].append(tok)
    return spans


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


def decode_headers(events: Sequence[str]) -> List[str]:
    """``[time_sig, tempo, i_* programs...]`` — the header slice
    ``bar_events_to_midi`` consumes when re-measuring decoded bars
    (reference ``preprocessing.py:755-958`` header parse)."""
    bar0 = next(i for i, t in enumerate(events) if t == "bar")
    return [events[0], events[1]] + [t for t in events[:bar0] if t.startswith("i_")]


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
    # per-span-group counts (the settle loop only) — the reference's
    # per-span time_correct_list granularity (evaluation.py:1319-1328)
    time_corrections_per_span: Optional[List[int]] = None
    time_failed_per_span: Optional[List[int]] = None


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
        self.mesh = mesh
        if mesh is not None and quant != "none":
            raise ValueError(
                "dp-sharded serving (mesh=...) does not support quantized "
                "weight streaming; drop quant or the mesh"
            )
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
        engine groups them; a group is not padded to JAX's 1, 4 or 8 rows,
        since the CUDA kernels take any batch of 1 to 8 (JAX pads for a
        Mosaic tiling limit of the TPU, ``infer/decode.py:240-258``).  Under
        a mesh a group is ``8 * dp`` rows, padded to a multiple of dp with
        done-at-start dummies (``n_spans`` 0) whose results are dropped.
        ``correct_controls`` rewrites each regenerated slot's control copies
        with the measured controls of its body after the decode."""
        if not requests:
            return []
        if generator is None:
            generator = self.decoder.generator
        dp = 1 if self.mesh is None else int(self.mesh.shape["dp"])
        group = 8 * dp if self.decoder.fused else len(requests)
        pending = []
        for i in range(0, len(requests), group):
            grp = list(requests[i : i + group])
            padded = grp + [replace(grp[-1], span_codes=[])] * (-len(grp) % dp)
            asm = self._assemble(padded)
            out = self._dispatch(asm[0], asm[1], asm[2], asm[3], generator)
            pending.append((grp, padded, asm, out))
        results: List[Optional[InfillResult]] = []
        for grp, padded, asm, out in pending:
            results.extend(self._finish_group(
                padded, generator, asm, out,
                fix_durations=fix_durations, correct_controls=correct_controls,
            )[: len(grp)])
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
        correct_controls: bool = False,
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
            if correct_controls:
                restored = self._correct_controls(restored, r.mask_bars, r.mask_tracks)
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
        """``correct_controls``: False, True (post-hoc rewrite of the
        restored stream) or ``"in_decode"`` (the reference's
        ``use_correct_control``: later spans condition on measured
        controls; see :meth:`run_with_correct_controls`).

        ``span_retries``: regenerate per span group with a teacher-forced
        settled prefix (the reference's eval retry loop,
        ``evaluation.py:1300-1397``) instead of re-decoding the whole
        request.  Both settle-loop modes run the plain forced-prefix loop
        (``_eval_decoder``); the rest goes through ``run_batch`` and the
        engine's own decoder (the v3 kernels on CUDA)."""
        req = self.prepare(events, tracks_to_generate, bars_to_generate)
        if req is None:
            return None
        if correct_controls == "in_decode":
            return self.run_with_correct_controls(req, generator, fix_durations=fix_durations)
        if (
            span_retries
            and fix_durations
            and self.vocab.mode == 0
            and not self.decoder.greedy
            and self.max_time_fix_attempts > 0
        ):
            result = self.run_with_span_retries(req, generator, fix_durations=True)
            if result is not None and correct_controls:
                result.events = self._correct_controls(
                    result.events, req.mask_bars, req.mask_tracks
                )
            return result
        return self.run_batch(
            [req], generator, fix_durations=fix_durations,
            correct_controls=correct_controls,
        )[0]

    def run_with_span_retries(
        self,
        req: "PreparedRequest",
        generator: Optional[torch.Generator] = None,
        fix_durations: bool = True,
    ) -> Optional[InfillResult]:
        """Per-span-group regeneration (reference ``evaluation.py:1300-1397``).

        Masked (bar, track) groups settle in source order: a group whose
        body closes the bar duration is accepted; otherwise it is re-decoded
        with fresh sampling noise while every already-settled group is
        teacher-forced, up to ``max_time_fix_attempts`` times, after which
        it is accepted as-is (and later rewritten by the forced duration
        repair) and the loop moves on (the reference's ``corrected_times >
        10, continue generation`` branch, ``:1326-1335``).  Unlike
        :meth:`run_batch`'s whole-request retry, each group retries on its
        own.
        """
        state = self._settle_loop(
            req, generator,
            check_close=True,
            retry_time=True,
            # terminates: every decode settles >= 1 group or increments the
            # current group's capped attempt counter
            max_decodes=self._n_groups(req) * (self.max_time_fix_attempts + 1),
            settle_fn=None,
            final_replay=False,
        )
        return self._settled_result(state, req, fix_durations)

    def _settled_result(
        self, state, req: "PreparedRequest", fix_durations: bool
    ) -> Optional[InfillResult]:
        """`_settle_loop` state -> InfillResult (shared by both eval paths)."""
        if state is None:
            return None
        generated, restored, corrections, failed = state
        if fix_durations and self.vocab.mode == 0:
            restored = self._repair_durations(restored, req.table)
        return InfillResult(
            events=restored,
            generated=generated,
            mask_tracks=req.mask_tracks,
            mask_bars=req.mask_bars,
            decode_steps=len(generated),
            time_corrections=sum(corrections),
            time_failed=any(failed),
            time_corrections_per_span=corrections,
            time_failed_per_span=failed,
        )

    @staticmethod
    def _span_groups(req: "PreparedRequest") -> List[List[int]]:
        """Span indices grouped per masked (bar, track): each SPAN_BODY
        opens a group; the control spans that follow belong to it."""
        groups: List[List[int]] = []
        for k, code in enumerate(req.span_codes):
            if code == SPAN_CODE["r"]:
                groups.append([k])
            elif groups:
                groups[-1].append(k)
        return groups

    def _n_groups(self, req: "PreparedRequest") -> int:
        return len(self._span_groups(req))

    def _settle_loop(
        self,
        req: "PreparedRequest",
        generator: Optional[torch.Generator],
        check_close: bool,
        retry_time: bool,
        max_decodes: int,
        settle_fn,
        final_replay: bool,
    ):
        """Shared per-group settle loop of the eval retry paths
        (reference ``evaluation.py:1217-1397``).

        Masked (bar, track) groups settle in source order.  A group whose
        body fails the bar-duration closure check is re-decoded with fresh
        noise (already-settled groups teacher-forced) up to
        ``max_time_fix_attempts`` times, then accepted as-is.  At settle
        time ``settle_fn(group, slot, spans, restored) -> {span_idx: token}``
        (``group`` = the group's span indices, ``slot`` = its
        ``(bar, track)``) may substitute tokens into later spans (the
        in-decode ``use_correct_control`` hook); a substitution forces the
        remainder to re-decode conditioned on it.  ``final_replay`` keeps
        looping after the last group settles so a trailing substitution is
        materialised by one fully-forced replay.  Each decode draws its
        noise from ``generator`` (the engine's when None), in decode order.

        Returns ``(generated, restored, corrections, failed)`` or None for
        empty/oversized requests.
        """
        decoder = self._eval_decoder
        if generator is None:
            generator = self.decoder.generator
        src_tokens = [self.vocab.index2char(int(t)) for t in req.src]
        span_codes = list(req.span_codes)
        n_spans = len(span_codes)
        if n_spans == 0 or n_spans > decoder.max_spans:
            return None

        groups = self._span_groups(req)
        group_slots = sorted(zip(req.mask_bars, req.mask_tracks))

        src_b = pad_to_bucket(np.asarray(req.src, np.int32)[None])
        span_types = np.zeros((1, decoder.max_spans), np.int32)
        span_types[0, :n_spans] = span_codes
        n_spans_b = np.asarray([n_spans], np.int32)
        no_whole = np.asarray([req.no_whole_duration])

        settled = 0
        attempts: Dict[int, int] = {}
        corrections: List[int] = []
        failed: List[int] = []
        forced_stream: List[str] = []
        generated: List[str] = []
        restored = src_tokens
        decode_i = 0
        while decode_i < max_decodes and (final_replay or settled < len(groups)):
            if forced_stream:
                forced_ids = np.asarray(
                    [[self.vocab.char2index(t) for t in forced_stream]], np.int32
                )
                forced_len = np.asarray([len(forced_stream)], np.int32)
            else:
                forced_ids = forced_len = None
            out = decoder(
                src_b, span_types, n_spans_b, no_whole, generator=generator,
                forced=forced_ids, forced_len=forced_len,
            )
            decode_i += 1
            tokens = out.tokens[0].cpu().numpy()
            generated = [self.vocab.index2char(int(t)) for t in tokens[: int(out.lengths[0])]]
            spans = _split_spans(generated)
            restored = restore_marked_input(src_tokens, generated)
            if len(spans) < n_spans:
                # token budget exhausted; keep the partial splice
                # (unfilled slots retain their m_0 markers)
                break

            substituted = False
            progressed = True
            while settled < len(groups) and progressed:
                gi = settled
                bar_num, track_pos = group_slots[gi]
                time_ok = not check_close or self._group_closes(
                    restored, req, bar_num, track_pos
                )
                if (
                    not time_ok
                    and retry_time
                    and attempts.get(gi, 0) < self.max_time_fix_attempts
                ):
                    attempts[gi] = attempts.get(gi, 0) + 1
                    progressed = False
                    break
                # time settled (closed or retries exhausted)
                subs = (
                    settle_fn(groups[gi], group_slots[gi], spans, restored)
                    if settle_fn
                    else None
                )
                if subs:
                    for si, tok in subs.items():
                        spans[si] = [tok]
                corrections.append(attempts.get(gi, 0))
                failed.append(0 if time_ok else 1)
                settled = gi + 1
                if subs:
                    # later spans must re-decode conditioned on the
                    # substituted value
                    substituted = True
                    progressed = False
            if settled >= len(groups) and not substituted:
                break
            last_span = groups[settled - 1][-1] if settled else -1
            forced_stream = []
            for si in range(last_span + 1):
                forced_stream.append("m_0")
                forced_stream.extend(spans[si])
            if forced_stream:
                # close the LAST forced span: the decoder ends a forced span
                # only on a forced m_0, so a body-terminal prefix would
                # otherwise resume sampling inside content that already
                # passed its closure check
                forced_stream.append("m_0")
            # if everything settled but the final substitution is not in
            # `generated` yet, the next iteration is a fully-forced replay
            # that materialises it, then breaks

        # groups left unsettled by an early break (token budget exhausted)
        # count as failed; the forced repair rewrites them downstream
        for gi in range(settled, len(groups)):
            corrections.append(attempts.get(gi, 0))
            failed.append(1)
        return generated, restored, corrections, failed

    def _group_closes(
        self, events: List[str], req: "PreparedRequest", bar_num: int, track_pos: int
    ) -> bool:
        """One (bar, track) group's body sums exactly to the bar duration."""
        try:
            _, _, bars = bar_with_track_positions(events)
        except (IndexError, ValueError):
            return False
        if bar_num >= len(bars) or track_pos >= len(bars[bar_num]):
            return False
        track_start, track_end = bars[bar_num][track_pos]
        body_start, body_end = self._body_bounds(events, track_start, track_end)
        ok, _ = check_track_total_time(events[body_start:body_end], req.table)
        return ok

    @property
    def _eval_decoder(self) -> InfillDecoder:
        """The plain-loop decoder (``fused=False``) that takes a forced
        prefix, on the engine model's device, built once; the kernel loops
        do not take a teacher-forced prefix (JAX :987-1004)."""
        dec = getattr(self, "_eval_decoder_cache", None)
        if dec is None:
            dec = InfillDecoder(
                self.model,
                self.vocab,
                max_tgt_len=self.decoder.max_tgt_len,
                max_spans=self.decoder.max_spans,
                nucleus_p=self.decoder.nucleus_p,
                temperature=self.decoder.temperature,
                greedy=self.decoder.greedy,
                fused=False,
            )
            self._eval_decoder_cache = dec
        return dec

    def run_with_correct_controls(
        self,
        req: "PreparedRequest",
        generator: Optional[torch.Generator] = None,
        fix_durations: bool = True,
        max_rounds: Optional[int] = None,
    ) -> Optional[InfillResult]:
        """In-decode ``use_correct_control`` (reference
        ``evaluation.py:1217-1288``): after each masked (bar, track) body
        decodes, its measured density/occupation/polyphony (and, on the last
        track of a bar, the bar's measured tensile strain) replace the
        sampled control tokens, so every later span conditions on measured
        values.  The seam is between decodes: decode the whole session,
        measure the earliest span group whose sampled controls disagree with
        the measured ones, substitute, teacher-force the stream up to that
        point and re-decode the remainder.  Like
        :meth:`run_with_span_retries`, a group only settles (and only then
        has its controls measured and substituted) once its body closes the
        bar duration or ``max_time_fix_attempts`` fresh samples were spent
        on it.
        """
        from ..eval.controllability import recompute_bar_track_control

        span_codes = list(req.span_codes)
        if not span_codes or len(span_codes) > self._eval_decoder.max_spans:
            # degenerate request (e.g. n_spans = 0 padding): bail before
            # parsing the header below
            return None
        src_tokens = [self.vocab.index2char(int(t)) for t in req.src]

        header = decode_headers(src_tokens)
        key_token = src_tokens[2] if src_tokens[2].startswith("k_") else None
        key_name = ALL_KEY_NAMES[int(key_token[2:])] if key_token is not None else None

        def measure_and_substitute(group, slot, spans, restored):
            """Measure the settled group's body; substitute its sampled
            control copies with the measured values."""
            bar_num = slot[0]
            body = spans[group[0]]
            subs: Dict[int, str] = {}
            d, o, y = recompute_bar_track_control(body, header)
            measured = {
                SPAN_CODE["d"]: f"d_{d}" if d >= 0 else None,
                SPAN_CODE["o"]: f"o_{o}" if o >= 0 else None,
                SPAN_CODE["p"]: f"y_{y}" if y >= 0 else None,
            }
            for si in group[1:]:
                code = span_codes[si]
                if code == SPAN_CODE["t"]:
                    want = self._measured_tensile(spans, src_tokens, bar_num, header, key_name)
                else:
                    want = measured.get(code)
                if want is not None and spans[si] and spans[si][0] != want:
                    subs[si] = want
            return subs

        check_close = fix_durations and self.vocab.mode == 0
        state = self._settle_loop(
            req, generator,
            check_close=check_close,
            retry_time=(
                check_close
                and not self.decoder.greedy  # fresh noise needs sampling
                and self.max_time_fix_attempts > 0
            ),
            # terminates: every decode either increments one group's attempt
            # counter (capped) or settles >= 1 group; a settled group can
            # force at most one extra replay (its control substitution)
            max_decodes=(
                max_rounds
                if max_rounds is not None
                else self._n_groups(req) * (self.max_time_fix_attempts + 2) + 1
            ),
            settle_fn=measure_and_substitute,
            final_replay=True,
        )
        return self._settled_result(state, req, fix_durations)

    def _measured_tensile(
        self,
        spans: List[List[str]],
        src_tokens: List[str],
        bar_num: int,
        header: List[str],
        key_name: Optional[str],
    ) -> Optional[str]:
        """True ``s_*`` of a bar, measured from the restored stream (the
        bar's tracks include unmasked source content)."""
        from ..eval.controllability import recompute_bar_tension

        flat: List[str] = []
        for s in spans:
            flat.append("m_0")
            flat.extend(s)
        restored = restore_marked_input(src_tokens, flat)
        try:
            _, bar_poses, _ = bar_with_track_positions(restored)
        except (IndexError, ValueError):
            return None
        if bar_num >= len(bar_poses):
            return None
        lo = bar_poses[bar_num]
        hi = bar_poses[bar_num + 1] if bar_num + 1 < len(bar_poses) else len(restored)
        cat = recompute_bar_tension(restored[lo + 1 : hi], header, key_name)
        return f"s_{cat}" if cat is not None else None

    def _correct_controls(
        self, events: List[str], mask_bars: List[int], mask_tracks: List[int]
    ) -> List[str]:
        """Rewrite each regenerated slot's control copies with the
        *measured* controls of the generated body (post-hoc approximation
        of the reference's ``use_correct_control``,
        ``evaluation.py:1217-1288``)."""
        from ..eval.controllability import recompute_bar_track_control

        out = list(events)
        header = decode_headers(out)
        _, _, bars = bar_with_track_positions(out)
        for bar_num, track_num in zip(mask_bars, mask_tracks):
            if bar_num >= len(bars) or track_num >= len(bars[bar_num]):
                continue
            track_start, track_end = bars[bar_num][track_num]
            tensile_end = (
                1
                if out[track_end - 1] in self.vocab.name_to_tokens.get("tensile", [])
                else 0
            )
            body = out[
                track_start + TOTAL_TRACK_CONTROL_TYPES
                : track_end - TOTAL_TRACK_CONTROL_TYPES - tensile_end
            ]
            d, o, y = recompute_bar_track_control(body, header)
            if o < 0:
                continue
            tokens = [f"d_{d}", f"o_{o}", f"y_{y}"]
            for k in range(TOTAL_TRACK_CONTROL_TYPES):
                out[track_start + k] = tokens[k]
                out[track_end - TOTAL_TRACK_CONTROL_TYPES - tensile_end + k] = tokens[k]
        return out

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
