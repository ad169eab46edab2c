"""Token vocabulary for the SMER / REMI music-infilling framework.

Single source of truth for the token universe (kills the reference's
``vocab.py`` / ``vocab_control.py`` byte-identical duplication, see
reference ``vocab.py:114-338``).  Two encodings share one vocabulary object:

* mode 0 ("SMER" / rest-multi): duration-name tokens (``whole..sixteenth``),
  ``rest``, ``sep`` (partial-overlap restart), ``continue`` (cross-bar tie).
* mode 1 ("REMI" / step-single): 16th-grid onset tokens ``e_0..e_15`` plus
  single duration tokens ``n_1..n_32``.

The *index layout* is a contract consumed by the loss-head ranges
(reference ``train.py:555-642``), the grammar-constrained sampler
(reference ``generation.py:41-95``) and the masking pipeline; it is
preserved exactly (mode 0 -> 309 tokens, mode 1 -> 349 tokens).

TPU-first additions over the reference: every token family is also exposed
as a precomputed boolean numpy mask of shape ``(vocab_size,)`` so that the
jitted decode loop and the fused multi-head loss consume ``(V,)`` /
``(H, V)`` arrays instead of Python index lists.

Host copy of ``smer_music_generation_tpu/vocab.py`` for the PyTorch port,
which imports nothing of the JAX package.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Token universe constants (reference vocab.py:20-112)
# ---------------------------------------------------------------------------

TRACK_0_RANGE = (21, 108)  # playable pitch range, reference vocab.py:6

MAX_TRACK = 3
# Per-track decode velocities, reference vocab.py:15-17
V0 = 120
V1 = 100
V2 = 60

PAD = "<pad>"
EOS = "<eos>"
MASK_TOKENS = ["m_0"]
SPECIAL_TOKENS = [PAD, EOS]

TIME_SIGNATURE_TOKENS = ["4/4", "3/4", "2/4", "6/8"]
PROGRAM_TOKENS = [f"i_{n}" for n in range(128)]
TEMPO_TOKENS = [f"t_{i}" for i in range(7)]
TRACK_NUM_TOKENS = [f"track_{n}" for n in range(3)]
STRUCTURE_TOKENS = ["bar"] + TRACK_NUM_TOKENS
SONG_TOKENS = TIME_SIGNATURE_TOKENS + TEMPO_TOKENS + PROGRAM_TOKENS

REST_TOKEN = "rest"
SEP_TOKEN = "sep"
CONTINUE_TOKEN = "continue"
STEP_TOKENS = [f"e_{n}" for n in range(16)]
DURATION_MULTI = ["whole", "half", "quarter", "eighth", "sixteenth"]
DURATION_SINGLE = [f"n_{n}" for n in range(1, 33)]

PITCH_TOKENS = [f"p_{n}" for n in range(21, 109)]

ALL_KEY_NAMES = [
    "C major", "G major", "D major", "A major",
    "E major", "B major", "F major", "B- major",
    "E- major", "A- major", "D- major", "G- major",
    "A minor", "E minor", "B minor", "F# minor",
    "C# minor", "G# minor", "D minor", "G minor",
    "C minor", "F minor", "B- minor", "E- minor",
]

ALL_MAJOR_NAMES = np.array([
    "C major", "D- major", "D major", "E- major",
    "E major", "F major", "G- major", "G major",
    "A- major", "A major", "B- major", "B major",
])

ALL_MINOR_NAMES = np.array([
    "A minor", "B- minor", "B minor", "C minor",
    "C# minor", "D minor", "E- minor", "E minor",
    "F minor", "F# minor", "G minor", "G# minor",
])

MAJOR_ENHARMONICS = {"C#": "D-", "D#": "E-", "F#": "G-", "G#": "A-", "A#": "B-"}
MINOR_ENHARMONICS = {"D-": "C#", "D#": "E-", "G-": "F#", "A-": "G#", "A#": "B-"}

KEY_TOKENS = [f"k_{n}" for n in range(len(ALL_KEY_NAMES))]
KEY_TO_TOKEN = {name: f"k_{i}" for i, name in enumerate(ALL_KEY_NAMES)}
TOKEN_TO_KEY = {v: k for k, v in KEY_TO_TOKEN.items()}

TRACK_NOTE_DENSITY_TOKENS = [f"d_{n}" for n in range(10)]
TRACK_OCCUPATION_RATE_TOKENS = [f"o_{n}" for n in range(10)]
TRACK_POLYPHONY_RATE_TOKENS = [f"y_{n}" for n in range(10)]
TENSILE_STRAIN_TOKENS = [f"s_{n}" for n in range(12)]

# Feature binning tables, reference vocab.py:96-103
CONTROL_BINS = np.arange(0, 1, 0.1)
TENSILE_BINS = np.arange(0, 2.1, 0.2).tolist() + [4]
DIAMETER_BINS = np.arange(0, 4.1, 0.4).tolist() + [5]
TEMPO_BINS = np.array([0] + list(range(60, 190, 30)) + [200])
TENSION_BIN = np.arange(0, 6.5, 0.5)
TENSION_BIN[-1] = 6.5

TRACK_CONTROL_TOKENS = (
    TRACK_NOTE_DENSITY_TOKENS
    + TRACK_OCCUPATION_RATE_TOKENS
    + TRACK_POLYPHONY_RATE_TOKENS
)
BAR_CONTROL_TOKENS = TENSILE_STRAIN_TOKENS
NO_CONTROL_TOKENS = ["unk"]
SONG_CONTROL_TOKENS = KEY_TOKENS
CONTROL_TOKENS = BAR_CONTROL_TOKENS + TRACK_CONTROL_TOKENS

ALL_CONTROL_NAMES = ("key", "density", "occupation", "polyphony", "tensile")

# The "-t" control-set experiment matrix (reference train.py:1393-1405).
CONTROL_SETS = {
    0: [],
    1: ["key", "tensile"],
    2: ["key", "density"],
    3: ["key", "polyphony"],
    4: ["key", "occupation"],
    5: ["key", "tensile", "density", "polyphony", "occupation"],
}


class WordVocab:
    """Vocabulary and per-class index geometry for one encoding mode.

    Parameters
    ----------
    mode:
        0 for SMER (rest-multi), 1 for REMI (step-single).
    control_list:
        subset of ``ALL_CONTROL_NAMES`` that are *active* controls (their
        tokens always exist in the vocabulary; activation only affects
        ``control_indices`` / loss heads), mirroring reference
        ``vocab.py:115-310``.
    """

    def __init__(self, mode: int, control_list: Sequence[str] = ()):  # noqa: C901
        self.mode = mode
        self.control_list = list(control_list)

        if mode == 0:
            duration_only = list(DURATION_MULTI)
            duration_tokens = duration_only + [REST_TOKEN, SEP_TOKEN, CONTINUE_TOKEN]
        else:
            duration_only = list(DURATION_SINGLE)
            duration_tokens = STEP_TOKENS + duration_only

        note_tokens = PITCH_TOKENS + duration_tokens
        basic_tokens = (
            SPECIAL_TOKENS + MASK_TOKENS + STRUCTURE_TOKENS + SONG_TOKENS + note_tokens
        )
        all_tokens = (
            basic_tokens
            + TRACK_NOTE_DENSITY_TOKENS
            + TRACK_POLYPHONY_RATE_TOKENS
            + TRACK_OCCUPATION_RATE_TOKENS
            + KEY_TOKENS
            + TENSILE_STRAIN_TOKENS
            + NO_CONTROL_TOKENS
        )

        self.pad_index = 0
        self.eos_index = 1
        self.char_lst = all_tokens
        self.basic_tokens = basic_tokens
        self.corrupt_tokens = list(NO_CONTROL_TOKENS)

        self._char2idx: Dict[str, int] = {PAD: 0, EOS: 1}
        for char in all_tokens:
            if char not in self._char2idx:
                self._char2idx[char] = len(self._char2idx)
        self._idx2char = {idx: char for char, idx in self._char2idx.items()}

        # ----- per-family index lists (contract with loss / sampler) -----
        self.structure_indices = self._indices(STRUCTURE_TOKENS)
        self.pitch_indices = self._indices(PITCH_TOKENS)
        self.mask_indices = self._indices(MASK_TOKENS)
        self.duration_indices = self._indices(duration_tokens)
        self.duration_only_indices = self._indices(duration_only)
        self.program_indices = self._indices(PROGRAM_TOKENS)
        self.tempo_indices = self._indices(TEMPO_TOKENS)
        self.time_signature_indices = self._indices(TIME_SIGNATURE_TOKENS)
        self.rest_indices: List[int] = []
        self.sep_indices: List[int] = []
        self.control_indices: Dict[str, List[int]] = {}
        self.control_tokens: List[str] = []
        self.unk_index = self.vocab_size - 1
        self.mask_index = self.mask_indices[0]

        if mode == 0:
            self.rest_indices = self._indices([REST_TOKEN])
            self.sep_indices = self._indices([SEP_TOKEN])
            self.continue_index = self._char2idx[CONTINUE_TOKEN]
        else:
            self.step_indices = self._indices(STEP_TOKENS)

        # ----- token-class map (reference vocab.py:159-310) -----
        self.token_class_ranges: Dict[int, str] = {}
        self.name_to_tokens: Dict[str, List[str]] = {}
        self._register("program", self.program_indices)
        self._register("rest", self.rest_indices)
        self._register("sep", self.sep_indices)
        self._register("tempo", self.tempo_indices)
        self._register("time_signature", self.time_signature_indices)
        self._register("structure", self.structure_indices)
        self._register("pitch", self.pitch_indices)
        self._register("duration", self.duration_indices)
        self.token_class_ranges[self.eos_index] = "eos"
        self.token_class_ranges[self.unk_index] = "unk"
        # a LIST like every other name_to_tokens entry (a bare string
        # makes `tok in name_to_tokens['eos']` match single characters)
        self.name_to_tokens["eos"] = [self._idx2char[self.eos_index]]

        family_tokens = {
            "key": KEY_TOKENS,
            "density": TRACK_NOTE_DENSITY_TOKENS,
            "occupation": TRACK_OCCUPATION_RATE_TOKENS,
            "polyphony": TRACK_POLYPHONY_RATE_TOKENS,
            "tensile": TENSILE_STRAIN_TOKENS,
        }
        for name in ("key", "density", "occupation", "polyphony", "tensile"):
            if name in self.control_list:
                idxs = self._indices(family_tokens[name])
                self.control_indices[name] = idxs
                self._register(name, idxs)
                self.control_tokens.extend(self.name_to_tokens[name])
        # convenience aliases used by the sampler (reference generation.py)
        if "key" in self.control_indices:
            self.key_indices = self.control_indices["key"]
        if "density" in self.control_indices:
            self.density_indices = self.control_indices["density"]
        if "occupation" in self.control_indices:
            self.occupation_indices = self.control_indices["occupation"]
        if "polyphony" in self.control_indices:
            self.polyphony_indices = self.control_indices["polyphony"]
        if "tensile" in self.control_indices:
            self.tensile_indices = self.control_indices["tensile"]

        self.class_names = set(self.token_class_ranges.values())

        # ----- dense boolean masks for device-side use -----
        V = self.vocab_size
        self.class_masks: Dict[str, np.ndarray] = {}
        for name, idxs in (
            ("pitch", self.pitch_indices),
            ("duration", self.duration_indices),
            ("duration_only", self.duration_only_indices),
            ("rest", self.rest_indices),
            ("sep", self.sep_indices),
            ("program", self.program_indices),
            ("structure", self.structure_indices),
            ("time_signature", self.time_signature_indices),
            ("tempo", self.tempo_indices),
        ):
            self.class_masks[name] = _mask(V, idxs)
        self.class_masks["eos"] = _mask(V, [self.eos_index])
        self.class_masks["mask"] = _mask(V, self.mask_indices)
        self.class_masks["unk"] = _mask(V, [self.unk_index])
        if mode == 0:
            self.class_masks["continue"] = _mask(V, [self.continue_index])
            self.class_masks["whole_duration"] = _mask(
                V, [self.duration_only_indices[0]]
            )
        else:
            self.class_masks["step"] = _mask(V, self.step_indices)
        for name, idxs in self.control_indices.items():
            self.class_masks[name] = _mask(V, idxs)
        self.class_masks["control"] = _mask(
            V, [i for idxs in self.control_indices.values() for i in idxs]
        )

        # integer class id per token (for per-class accuracy on device)
        self.class_id_names = sorted(self.class_names)
        self._class_name_to_id = {n: i for i, n in enumerate(self.class_id_names)}
        self.token_class_ids = np.full(V, -1, dtype=np.int32)
        for idx, cname in self.token_class_ranges.items():
            self.token_class_ids[idx] = self._class_name_to_id[cname]

    # ------------------------------------------------------------------
    def _indices(self, tokens: Sequence[str]) -> List[int]:
        return [self._char2idx[t] for t in tokens]

    def _register(self, name: str, indices: Sequence[int]) -> None:
        for index in indices:
            self.token_class_ranges[index] = name
            self.name_to_tokens.setdefault(name, []).append(self._idx2char[index])

    # ------------------------------------------------------------------
    # Reference-compatible API (vocab.py:312-329)
    # ------------------------------------------------------------------
    def char2index(self, token: str) -> int:
        idx = self._char2idx.get(token)
        if idx is None:
            raise KeyError(f"invalid token {token!r}")
        return idx

    def index2char(self, idx: int) -> str:
        return self._idx2char.get(int(idx))

    def get_token_classes(self, idx: int) -> str:
        return self.token_class_ranges[int(idx)]

    @property
    def vocab_size(self) -> int:
        return len(self._char2idx)

    # ------------------------------------------------------------------
    def encode(self, tokens: Sequence[str]) -> np.ndarray:
        """Vectorized token-string -> id conversion."""
        return np.array([self.char2index(t) for t in tokens], dtype=np.int32)

    def decode(self, ids: Sequence[int]) -> List[str]:
        return [self._idx2char[int(i)] for i in ids]

    # ------------------------------------------------------------------
    # Persistence: JSON (self-describing, no pickle-of-self)
    # ------------------------------------------------------------------
    def save_vocab(self, vocab_path: str) -> None:
        with open(vocab_path, "w") as f:
            json.dump({"mode": self.mode, "control_list": self.control_list}, f)

    @staticmethod
    def load_vocab(vocab_path: str) -> "WordVocab":
        with open(vocab_path) as f:
            spec = json.load(f)
        return WordVocab(spec["mode"], spec["control_list"])

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"WordVocab(mode={self.mode}, vocab_size={self.vocab_size}, "
            f"controls={self.control_list})"
        )


def _mask(size: int, indices: Sequence[int]) -> np.ndarray:
    m = np.zeros(size, dtype=bool)
    if len(indices):
        m[np.asarray(indices)] = True
    return m


def to_category(array, bins) -> List[int]:
    """Bin continuous values into category indices (reference encode.py:206-210).

    ``result[i] = max{j : array[i] >= bins[j]}``.
    """
    bins = np.asarray(bins)
    arr = np.asarray(array, dtype=float)
    # last index where (item - bins) >= 0
    cmp = (arr[:, None] - bins[None, :]) >= 0
    # guard: items below bins[0] would have no True; reference would IndexError,
    # our inputs are always >= 0 == bins[0]
    return np.argmax(np.where(cmp, np.arange(len(bins))[None, :], -1), axis=1).astype(int).tolist()
