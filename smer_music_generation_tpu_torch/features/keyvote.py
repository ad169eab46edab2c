"""Key estimation by pitch-class profile correlation; 4-way key vote.

Replaces the reference's dependency on three ``music21`` analyzers
(KrumhanslSchmuckler, TemperleyKostkaPayne, BellmanBudge — reference
``encode.py:1411-1468``, ``create_dataset.py:806-871``) with direct,
vectorized implementations of the same published key profiles: a
duration-weighted pitch-class distribution is correlated against all 24
rotated profiles and the best correlation wins.

The combined :func:`vote_key` reproduces the reference's Counter vote:
spiral-array key + the three profile keys, enharmonics normalized to the
vocabulary's canonical names.

Host copy of ``smer_music_generation_tpu/features/keyvote.py`` for the PyTorch port,
which imports nothing of the JAX package.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional, Tuple

import numpy as np

from ..codec.midi import MidiScore
from ..vocab import MAJOR_ENHARMONICS, MINOR_ENHARMONICS

# Published key profiles (the same tables music21's analyzers use).
PROFILES = {
    "krumhansl_schmuckler": (
        np.array([6.35, 2.23, 3.48, 2.33, 4.38, 4.09, 2.52, 5.19, 2.39, 3.66, 2.29, 2.88]),
        np.array([6.33, 2.68, 3.52, 5.38, 2.60, 3.53, 2.54, 4.75, 3.98, 2.69, 3.34, 3.17]),
    ),
    "temperley_kostka_payne": (
        np.array([0.748, 0.060, 0.488, 0.082, 0.670, 0.460, 0.096, 0.715, 0.104, 0.366, 0.057, 0.400]),
        np.array([0.712, 0.084, 0.474, 0.618, 0.049, 0.460, 0.105, 0.747, 0.404, 0.067, 0.133, 0.330]),
    ),
    "bellman_budge": (
        np.array([16.80, 0.86, 12.95, 1.41, 13.49, 11.93, 1.25, 20.28, 1.80, 8.04, 0.62, 10.57]),
        np.array([18.16, 0.69, 12.99, 13.34, 1.07, 11.15, 1.38, 21.07, 7.49, 1.53, 0.92, 10.21]),
    ),
}

# music21-style tonic spellings per chromatic index (sharp preference as
# produced by music21's KeySignature; normalized downstream anyway)
_TONIC_NAMES = ["C", "C#", "D", "E-", "E", "F", "F#", "G", "A-", "A", "B-", "B"]


def _build_rotations():
    """Per profile: (24, 12) matrix of all rotated profiles (major tonics
    0..11 then minor 0..11 — the scan order of the reference loop), centered
    rows + row norms precomputed so one matmul scores all 24 keys."""
    out = {}
    names = [f"{_TONIC_NAMES[t]} major" for t in range(12)] + [
        f"{_TONIC_NAMES[t]} minor" for t in range(12)
    ]
    for prof_name, (major, minor) in PROFILES.items():
        rows = np.stack(
            [np.roll(major, t) for t in range(12)]
            + [np.roll(minor, t) for t in range(12)]
        )
        centered = rows - rows.mean(axis=1, keepdims=True)
        norms = np.linalg.norm(centered, axis=1)
        out[prof_name] = (centered, norms)
    return out, names


_ROTATIONS, _KEY_ORDER = _build_rotations()


def pitch_class_distribution(score: MidiScore) -> np.ndarray:
    """Duration-weighted pitch-class histogram (12,)."""
    dist = np.zeros(12)
    for inst in score.instruments:
        if inst.is_drum:
            continue
        for note in inst.notes:
            dist[note.pitch % 12] += max(note.end - note.start, 0.0)
    return dist


def profile_key(score_or_dist, profile: str = "krumhansl_schmuckler") -> Optional[str]:
    """Best-correlating key, e.g. ``"C major"`` / ``"F# minor"``."""
    if isinstance(score_or_dist, MidiScore):
        dist = pitch_class_distribution(score_or_dist)
    else:
        dist = np.asarray(score_or_dist, dtype=float)
    if dist.sum() <= 0:
        return None
    # Pearson correlation of dist against all 24 rotated profiles in one
    # matmul (argmax keeps the reference scan order: major 0..11, minor
    # 0..11, first max wins — same as the strict `>` loop it replaces).
    d = dist - dist.mean()
    dn = np.linalg.norm(d)
    if dn == 0.0:  # constant distribution: every correlation is NaN
        return None
    centered, norms = _ROTATIONS[profile]
    r = (centered @ d) / (norms * dn)
    return _KEY_ORDER[int(np.argmax(r))]


def normalize_key_name(name: str) -> str:
    """Map enharmonic spellings onto the vocabulary's canonical key names
    (reference ``encode.py:845-886``)."""
    tonic, mode = name.split()
    tonic = tonic.upper() if len(tonic) == 1 else tonic[0].upper() + tonic[1:]
    table = MAJOR_ENHARMONICS if mode == "major" else MINOR_ENHARMONICS
    if tonic in table:
        tonic = table[tonic]
    return f"{tonic} {mode}"


def profile_keys(score: MidiScore) -> List[str]:
    dist = pitch_class_distribution(score)
    out = []
    for profile in ("krumhansl_schmuckler", "temperley_kostka_payne", "bellman_budge"):
        k = profile_key(dist, profile)
        if k is not None:
            out.append(normalize_key_name(k))
    return out


def vote_key(
    spiral_key: Optional[str], score: MidiScore, require_agreement: int = 0
) -> Optional[Tuple[str, int]]:
    """Counter vote over spiral key + 3 profile keys.

    Returns (winning key, vote count); ``None`` if ``require_agreement`` > 0
    and the winner has fewer votes (the dataset build requires >= 3,
    reference ``create_dataset.py:802-871``).
    """
    candidates: List[str] = []
    if spiral_key:
        candidates.append(spiral_key)
    candidates.extend(profile_keys(score))
    if not candidates:
        return None
    key, count = Counter(candidates).most_common()[0]
    if require_agreement and count < require_agreement:
        return None
    return key, count
