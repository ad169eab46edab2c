"""On-the-fly masking: span corruption (pretraining) + bar/track infilling
masks (finetuning).

Reimplements reference ``dataset.py:166-777`` with an explicit
``np.random.Generator`` (the reference interleaves the global ``random`` and
``np.random`` state, ``dataset.py:25``; distributions are preserved, exact
RNG sequences are not — SURVEY.md §7 "RNG parity").

Produces (encoder_tokens, decoder_in, decoder_target) triples per sequence:

* pretraining: spans of length 3/1/2 (p = .5/.25/.25, total ratio .15) are
  replaced by ``m_0`` in the input; the decoder reconstructs
  ``m_0 <span> <eos>`` per span; 5% of control tokens corrupt to ``unk``;
* finetuning: whole (bar, track) bodies are masked in one of three modes —
  random tracks x random bars / whole tracks / whole bars — with per-mode
  control-corruption schedules and optional end-of-track control copies.

Host copy of ``smer_music_generation_tpu/data/masking.py`` for the PyTorch port,
which imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..codec.structure import bar_with_track_positions, track_names_of
from ..vocab import WordVocab

Triple = Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray]]

SPAN_LENGTHS = (3, 1, 2)
SPAN_RATIOS = (0.5, 0.25, 0.25)


def copy_bar_controls_to_end(
    event: List[str],
    vocab: WordVocab,
    total_track_control_types: int,
    tension_control: bool,
) -> List[str]:
    """Duplicate per-bar-track controls at the track end and the tensile
    token at the bar end (control-mode 2 layout, reference
    ``dataset.py:121-153``).  No-op if the stream already ends with a
    control token (idempotence guard, ``dataset.py:124``)."""
    if event and (
        event[-1] in vocab.control_tokens or event[-1] in vocab.corrupt_tokens
    ):
        return event
    arr = np.array(event)
    track_names = track_names_of(event)
    track_nums = len(track_names)
    bar_poses = set(np.where(arr == "bar")[0].tolist())

    track_poses: List[int] = []
    for name in track_names:
        track_poses.extend(np.where(arr == name)[0].tolist())
    track_poses.extend(bar_poses)
    all_pos = sorted(track_poses)
    all_pos.append(len(event))

    out = list(event)
    for back_pos in range(len(all_pos) - 1, -1, -1):
        if all_pos[back_pos] in bar_poses:
            if back_pos + track_nums + 1 >= len(all_pos) or any(
                all_pos[back_pos + t + 1] in bar_poses for t in range(track_nums)
            ):
                # truncated trailing bar (token-budget cut): fewer than
                # track_nums track segments follow — nothing to copy, and
                # indexing the full complement would run off all_pos
                continue
            next_bar_pos = all_pos[back_pos + track_nums + 1]
            if tension_control:
                out.insert(next_bar_pos, out[all_pos[back_pos] + 1])
            if total_track_control_types > 0:
                for t in range(track_nums):
                    track_start = all_pos[back_pos + t + 1] + total_track_control_types * t
                    insert_pos = all_pos[back_pos + t + 2] + total_track_control_types * t
                    controls = out[track_start + 1 : track_start + total_track_control_types + 1]
                    for c in controls[::-1]:
                        out.insert(insert_pos, c)
    return out


@dataclass
class MaskingConfig:
    total_mask_ratio: float = 0.15
    bar_track_control: bool = False  # control mode >= 1
    bar_control_at_end: bool = False  # control mode == 2
    control_corrupt_prob: float = 0.05  # pretraining unk corruption


class MaskingPipeline:
    """Stateful (seeded) masking over packed event groups."""

    def __init__(self, vocab: WordVocab, config: MaskingConfig, seed: int = 99):
        self.vocab = vocab
        self.config = config
        self.rng = np.random.default_rng(seed)
        control_types = vocab.class_names
        n = 0
        for name in ("density", "occupation", "polyphony"):
            if name in control_types:
                n += 1
        self.total_track_control_types = n
        self.tension_control = "tensile" in control_types
        self._control_set = set(vocab.control_tokens)
        self._basic_set = set(vocab.basic_tokens)

    # ------------------------------------------------------------------
    def prepare_group(self, events: Sequence[Sequence[str]]) -> List[List[str]]:
        """Filter out-of-vocab tokens; apply end-of-track control copies
        (reference ``dataset.py:84-153``)."""
        out = []
        for event in events:
            ev = [t for t in event if t in self._control_set or t in self._basic_set]
            if self.config.bar_track_control and self.config.bar_control_at_end:
                ev = copy_bar_controls_to_end(
                    ev, self.vocab, self.total_track_control_types, self.tension_control
                )
            out.append(ev)
        return out

    # ------------------------------------------------------------------
    # Pretraining span corruption (reference dataset.py:166-311)
    # ------------------------------------------------------------------
    def _control_indices_of(self, event: List[str]) -> List[int]:
        if not (self.config.bar_track_control and self.config.bar_control_at_end):
            return [i for i, t in enumerate(event) if t in self._control_set]
        # end-copy layout: a control counts if it directly follows a
        # bar/track position or continues a control run started there —
        # header controls (k_* and the song d/o/y block) are deliberately
        # NOT corrupted in this layout, matching the reference's anchored
        # scan (dataset.py:204-216; its else-branch corrupts all controls
        # for the other layouts, as below)
        arr = np.array(event)
        anchor = set()
        for name in track_names_of(event):
            anchor.update(np.where(arr == name)[0].tolist())
        anchor.update(np.where(arr == "bar")[0].tolist())
        out = []
        in_run = False
        for i, t in enumerate(event):
            if t in self._control_set:
                if i - 1 in anchor:
                    out.append(i)
                    in_run = True
                elif in_run:
                    out.append(i)
            else:
                in_run = False
        return out

    def random_word(self, events: Sequence[Sequence[str]]) -> Optional[Triple]:
        cfg = self.config
        vocab = self.vocab
        threshold = cfg.total_mask_ratio / float(np.dot(SPAN_RATIOS, SPAN_LENGTHS))
        accept_p = threshold * 1.5

        events = [list(e) for e in events]
        self.rng.shuffle(events)

        total_tokens, total_din, total_dtgt = [], [], []
        for event in events:
            event = list(event)
            for idx in self._control_indices_of(event):
                if self.rng.random() < cfg.control_corrupt_prob:
                    event[idx] = vocab.corrupt_tokens[0]

            tokens: List[int] = []
            din: List[int] = []
            dtgt: List[int] = []
            pos = 0
            masked_ratio = 0.0
            n = len(event)
            while masked_ratio < cfg.total_mask_ratio and pos < n:
                span = None
                p = self.rng.random()
                if p < SPAN_RATIOS[0]:
                    length = SPAN_LENGTHS[0]
                elif p < SPAN_RATIOS[0] + SPAN_RATIOS[1]:
                    length = SPAN_LENGTHS[1]
                else:
                    length = SPAN_LENGTHS[2]
                if pos + length <= n and self.rng.random() < accept_p:
                    span = event[pos : pos + length]
                if span:
                    tokens.append(vocab.mask_index)
                    masked_ratio += length / n
                    pos += length
                    din.append(vocab.mask_index)
                    for t in span:
                        din.append(vocab.char2index(t))
                        dtgt.append(vocab.char2index(t))
                    dtgt.append(vocab.eos_index)
                else:
                    tokens.append(vocab.char2index(event[pos]))
                    pos += 1
            while pos < n:
                tokens.append(vocab.char2index(event[pos]))
                pos += 1

            if din:
                total_tokens.append(np.array(tokens, dtype=np.int32))
                total_din.append(np.array(din, dtype=np.int32))
                total_dtgt.append(np.array(dtgt, dtype=np.int32))
        if not total_tokens:
            return None
        return total_tokens, total_din, total_dtgt

    # ------------------------------------------------------------------
    # Finetuning bar/track masking (reference dataset.py:314-777)
    # ------------------------------------------------------------------
    def _token_span(self, event, track_start, track_end):
        """Body span inside a track slice, excluding leading/trailing
        control copies (reference ``dataset.py:435-449``)."""
        cfg = self.config
        tensile_end = 0
        if cfg.bar_track_control:
            token_start = track_start + self.total_track_control_types
            if cfg.bar_control_at_end:
                if (
                    self.tension_control
                    and event[track_end - 1] in self.vocab.name_to_tokens["tensile"]
                ):
                    tensile_end = 1
                token_end = track_end - self.total_track_control_types - tensile_end
            else:
                token_end = track_end
        else:
            token_start, token_end = track_start, track_end
        return token_start, token_end, tensile_end

    def _append_span_pairs(self, pairs, event, track_start, track_end):
        token_start, token_end, tensile_end = self._token_span(event, track_start, track_end)
        pairs.append((token_start, token_end))
        if self.config.bar_control_at_end:
            for i in range(self.total_track_control_types + tensile_end):
                pairs.append((token_end + i, token_end + 1 + i))

    def _corrupt_track_controls(self, event, track_start, schedule: str):
        """Corrupt 0..3 track control tokens to ``unk``.

        ``schedule='sparse'``: 10%/10%/10% for 1/2/3 corruptions (modes 0/2);
        ``schedule='heavy'``: 40%/25%/10% (mode 1 whole-track).
        """
        if not self.config.bar_track_control:
            return
        k = self.total_track_control_types
        p = self.rng.random()
        if k == 3:
            if schedule == "sparse":
                if 0.2 < p < 0.3:
                    picks = self.rng.choice(3, 1, replace=False)
                elif 0.1 < p < 0.2:
                    picks = self.rng.choice(3, 2, replace=False)
                elif p < 0.1:
                    picks = range(3)
                else:
                    picks = []
            else:
                if p > 0.6:
                    picks = self.rng.choice(3, 1, replace=False)
                elif 0.35 < p <= 0.6:
                    picks = self.rng.choice(3, 2, replace=False)
                elif 0.25 < p <= 0.35:
                    picks = range(3)
                else:
                    picks = []
        elif k == 1:
            if schedule == "sparse":
                picks = [0] if 0.2 < p < 0.3 else []
            else:
                picks = [0] if p > 0.5 else []
        else:
            picks = []
        for i in picks:
            event[track_start + int(i)] = self.vocab.corrupt_tokens[0]

    def mask_bars(self, events: Sequence[Sequence[str]]) -> Optional[Triple]:
        vocab = self.vocab
        events = [list(e) for e in events]
        self.rng.shuffle(events)

        p = self.rng.random()
        if p > 0.6:
            mask_mode = 0  # random tracks in random bars
        elif p > 0.3:
            mask_mode = 1  # whole tracks
        else:
            mask_mode = 2  # whole bars

        total_tokens, total_din, total_dtgt = [], [], []
        for event in events:
            event = list(event)
            track_names, bar_poses, bars = bar_with_track_positions(event)
            track_nums = len(track_names)
            if track_nums == 0 or len(bars) == 0:
                continue
            n_bars = len(bar_poses)
            pairs: List[Tuple[int, int]] = []

            if mask_mode == 0:
                bar_weight = np.logspace(1, 2, num=n_bars)[::-1]
                bar_mask_number = (
                    self.rng.choice(n_bars, p=bar_weight / bar_weight.sum()) + 1
                )
                bar_mask_poses = np.sort(
                    self.rng.choice(n_bars, size=bar_mask_number, replace=False)
                )
                track_weight = {
                    1: [1], 2: [10, 1], 3: [10, 5, 1], 4: [10, 5, 3, 1], 5: [10, 5, 3, 2, 1],
                }[track_nums]
                tw = np.array(track_weight, dtype=float)
                for bar_mask_pos in bar_mask_poses:
                    track_mask_number = self.rng.choice(track_nums, p=tw / tw.sum()) + 1
                    track_mask_poses = np.sort(
                        self.rng.choice(track_nums, size=track_mask_number, replace=False)
                    )
                    for tp in track_mask_poses:
                        track_start, track_end = bars[bar_mask_pos][tp]
                        self._append_span_pairs(pairs, event, track_start, track_end)
                        self._corrupt_track_controls(event, track_start, "sparse")

            elif mask_mode == 1:
                track_weight = {1: [1], 2: [10, 1], 3: [10, 2, 1]}.get(
                    track_nums, [10, 2, 1, 1, 1][:track_nums]
                )
                tw = np.array(track_weight, dtype=float)
                track_mask_number = self.rng.choice(track_nums, p=tw / tw.sum()) + 1
                track_mask_poses = set(
                    np.sort(self.rng.choice(track_nums, size=track_mask_number, replace=False)).tolist()
                )
                for tracks_in_bar in bars:
                    for tp, (track_start, track_end) in enumerate(tracks_in_bar):
                        if tp in track_mask_poses:
                            self._append_span_pairs(pairs, event, track_start, track_end)
                if self.config.bar_track_control:
                    if self.rng.random() > 0.5:
                        bar_mask_number = n_bars
                    else:
                        bar_mask_number = int(self.rng.integers(n_bars))
                    bar_mask_poses = set(
                        np.sort(self.rng.choice(n_bars, size=bar_mask_number, replace=False)).tolist()
                    )
                    for bar_num, tracks_in_bar in enumerate(bars):
                        if bar_num in bar_mask_poses:
                            for tp, (track_start, _) in enumerate(tracks_in_bar):
                                if tp in track_mask_poses:
                                    self._corrupt_track_controls(event, track_start, "heavy")

            else:
                bar_weight = np.logspace(1, 2, num=n_bars)[::-1]
                bar_mask_number = (
                    self.rng.choice(n_bars, p=bar_weight / bar_weight.sum()) + 1
                )
                if self.rng.random() > 0.5:
                    start = int(self.rng.integers(0, n_bars - (bar_mask_number - 1)))
                    bar_mask_poses = range(start, start + bar_mask_number)
                else:
                    bar_mask_poses = np.sort(
                        self.rng.choice(n_bars, size=bar_mask_number, replace=False)
                    )
                for bar_mask_pos in bar_mask_poses:
                    tracks_in_bar = bars[bar_mask_pos]
                    for track_start, track_end in tracks_in_bar:
                        self._append_span_pairs(pairs, event, track_start, track_end)
                        self._corrupt_track_controls(event, track_start, "sparse")
                    if self.tension_control and self.rng.random() < 0.1:
                        event[tracks_in_bar[0][0] - 2] = vocab.corrupt_tokens[0]

            if not pairs:
                continue

            din: List[int] = []
            dtgt: List[int] = []
            for lo, hi in pairs:
                din.append(vocab.mask_index)
                for t in event[lo:hi]:
                    din.append(vocab.char2index(t))
                    dtgt.append(vocab.char2index(t))
                dtgt.append(vocab.eos_index)

            token_events = list(event)
            for lo, hi in sorted(pairs, key=lambda p: p[0], reverse=True):
                del token_events[lo:hi]
                token_events.insert(lo, "m_0")
            tokens = [vocab.char2index(t) for t in token_events]

            total_tokens.append(np.array(tokens, dtype=np.int32))
            total_din.append(np.array(din, dtype=np.int32))
            total_dtgt.append(np.array(dtgt, dtype=np.int32))

        if not total_tokens:
            return None
        return total_tokens, total_din, total_dtgt
