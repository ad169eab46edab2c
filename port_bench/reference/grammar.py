"""A frozen copy of the SMER / REMI vocabulary and decoding grammar, for the
plain reference.

The vocabulary's index layout (309 words in SMER, mode 0; 349 in REMI,
mode 1; every control family active) and the grammar the infill decoder
samples under: which words each state allows (``allowed``) and how a
sampled word moves the state (``advance``).  Written from the vocabulary
and grammar the repository's model was trained with, as plain Python and
numpy over one row at a time.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

SPAN_BODY, SPAN_DENSITY, SPAN_OCCUPATION, SPAN_POLYPHONY, SPAN_TENSILE = range(5)

_DENSITY = [f"d_{n}" for n in range(10)]
_OCCUPATION = [f"o_{n}" for n in range(10)]
_POLYPHONY = [f"y_{n}" for n in range(10)]
_KEY = [f"k_{n}" for n in range(24)]
_TENSILE = [f"s_{n}" for n in range(12)]


class Vocab:
    """Words, indices and word classes of one encoding mode."""

    def __init__(self, mode: int):
        self.mode = mode
        if mode == 0:
            self.duration_only = ["whole", "half", "quarter", "eighth", "sixteenth"]
            durations = self.duration_only + ["rest", "sep", "continue"]
            steps: List[str] = []
        else:
            self.duration_only = [f"n_{n}" for n in range(1, 33)]
            steps = [f"e_{n}" for n in range(16)]
            durations = steps + self.duration_only
        pitches = [f"p_{n}" for n in range(21, 109)]
        structure = ["bar"] + [f"track_{n}" for n in range(3)]
        time_sigs = ["4/4", "3/4", "2/4", "6/8"]
        tempos = [f"t_{i}" for i in range(7)]
        programs = [f"i_{n}" for n in range(128)]
        words = (["<pad>", "<eos>", "m_0"] + structure + time_sigs + tempos + programs + pitches
                 + durations + _DENSITY + _POLYPHONY + _OCCUPATION + _KEY + _TENSILE + ["unk"])
        self.words = words
        self.index: Dict[str, int] = {w: i for i, w in enumerate(words)}
        self.size = len(words)
        self.pad, self.eos, self.mask = 0, 1, 2
        self.unk = self.size - 1
        self.continue_index = self.index["continue"] if mode == 0 else -1

        def mask(names) -> np.ndarray:
            m = np.zeros(self.size, bool)
            m[[self.index[n] for n in names]] = True
            return m

        self.pitch = mask(pitches)
        self.dur = mask(self.duration_only)
        self.whole = mask(["whole"]) if mode == 0 else np.zeros(self.size, bool)
        self.rest = mask(["rest"]) if mode == 0 else np.zeros(self.size, bool)
        self.sep = mask(["sep"]) if mode == 0 else np.zeros(self.size, bool)
        self.step = mask(steps) if steps else np.zeros(self.size, bool)
        self.eos_mask = mask(["<eos>"])
        self.control = mask(_DENSITY + _OCCUPATION + _POLYPHONY + _KEY + _TENSILE)
        self.banned = mask(programs + structure + time_sigs + tempos + ["<pad>", "m_0"])
        self.family = {SPAN_DENSITY: mask(_DENSITY), SPAN_OCCUPATION: mask(_OCCUPATION),
                       SPAN_POLYPHONY: mask(_POLYPHONY), SPAN_TENSILE: mask(_TENSILE)}

    def ids(self, words) -> np.ndarray:
        return np.array([self.index[w] for w in words], np.int64)

    def scored(self) -> np.ndarray:
        """Targets the training loss scores: every word but pad, m_0 and unk."""
        m = np.ones(self.size, bool)
        m[[self.pad, self.mask, self.unk]] = False
        return m


class Grammar:
    """The decoder's grammar over one row: a state of four flags (sep,
    continue, pitch, rest; REMI uses continue and pitch as its onset
    machine's states), reset at each span's start."""

    def __init__(self, vocab: Vocab):
        self.v = vocab

    def allowed(self, flags, is_start: bool, span_type: int, no_whole: bool) -> np.ndarray:
        v = self.v
        in_sep, in_continue, in_pitch, in_rest = flags
        if v.mode == 1:
            state_a = v.step | v.eos_mask
            if is_start:
                return v.family[span_type] if span_type != SPAN_BODY else state_a
            if in_continue:
                return v.pitch
            if in_pitch:
                return v.pitch | v.dur
            return state_a
        whole = v.whole if no_whole else np.zeros(v.size, bool)
        dur = v.dur & ~whole
        free = ~(v.banned | v.control | whole)
        if in_sep:
            return ~(v.banned | v.control | v.rest | v.sep | v.eos_mask | v.whole)
        if in_continue:
            return v.pitch
        if in_pitch:
            return v.pitch | dur
        if in_rest:
            return dur
        if is_start:
            return v.family[span_type] if span_type != SPAN_BODY else free & ~v.dur
        return free

    def advance(self, flags, word: int):
        v = self.v
        in_sep, in_continue, in_pitch, in_rest = flags
        pitch, dur = bool(v.pitch[word]), bool(v.dur[word])
        if v.mode == 1:
            step = bool(v.step[word])
            cont = True if step else (False if pitch or dur else in_continue)
            in_p = True if pitch else (False if step or dur else in_pitch)
            return (False, cont, in_p, False)
        cont_word = word == v.continue_index
        return (
            True if v.sep[word] else (False if cont_word or pitch else in_sep),
            True if cont_word else (False if pitch else in_continue),
            True if pitch else (False if dur else in_pitch),
            True if v.rest[word] else (False if dur else in_rest),
        )


START = (False, False, False, False)
