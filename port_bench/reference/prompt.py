"""The prompt an infill request asks for, worked out from the request alone:
the source the model has to see and the plan of its spans.

A request is a ``/generate`` payload: the event stream ``/encode`` returned,
the plugin's control dict, the tracks (by their number) and the bars (from
0) to infill.  The stream is ``header (bar lead* (track_i d o y body)*)*``,
the lead's first word being the bar's tension slot.  The prompt:

1. the controls written in: each track's density, occupation and polyphony
   in the header from ``track_<n>_c``; with ``bar_track`` 0 each bar-track's
   three from ``bar_density``, ``bar_occupation`` and ``bar_polyphony`` (10
   for "unknown"), otherwise, for the bars from ``s_bar`` to ``e_bar``, a
   locked track's three blanked;
2. the serving layout: each bar-track's three controls copied after its
   body, and the bar's tension slot after the last of them;
3. each requested bar-track's body replaced by one ``m_0`` (a body span) and
   each of its copied controls by one ``m_0`` (a density, occupation,
   polyphony span, and a tension span where the copy is a tension word).

The time signature (the first word) says whether whole notes are barred: in
any signature but n/4 with n >= 4.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .grammar import SPAN_BODY, SPAN_DENSITY, SPAN_OCCUPATION, SPAN_POLYPHONY, SPAN_TENSILE, Vocab

CONTROLS = (("d_", "density", "bar_density"), ("o_", "occupation", "bar_occupation"),
            ("y_", "polyphony", "bar_polyphony"))
COPY_SPANS = (SPAN_DENSITY, SPAN_OCCUPATION, SPAN_POLYPHONY)


def is_track(word: str) -> bool:
    return word.startswith("track_") and word[6:7].isdigit()


def parse(events: Sequence[str]):
    """(header, bars): each bar (lead words, [(track word, three controls,
    body), ...])."""
    first = events.index("bar")
    bars = []
    for word in events[first:]:
        if word == "bar":
            bars.append(([], []))
        elif is_track(word):
            bars[-1][1].append([word, []])
        elif bars[-1][1]:
            bars[-1][1][-1][1].append(word)
        else:
            bars[-1][0].append(word)
    shaped = []
    for lead, tracks in bars:
        shaped.append((lead, [(name, words[:3], words[3:]) for name, words in tracks]))
    return list(events[:first]), shaped


def controlled(header: List[str], bars, controls: Dict):
    """Step 1: the plugin's controls written into a parsed stream."""
    names = sorted({name for _, tracks in bars for name, _, _ in tracks})
    header = list(header)
    for prefix, key, _ in CONTROLS:
        slots = [i for i, w in enumerate(header) if w.startswith(prefix)]
        for slot, name in zip(slots, names):
            c = controls.get(f"track_{name[6:]}_c")
            if c is not None:
                header[slot] = f"{prefix}{c[key]}"
    out = []
    for b, (lead, tracks) in enumerate(bars):
        row = []
        for name, three, body in tracks:
            if controls.get("bar_track") == 0:
                three = ["unk" if controls[per][name][b] == 10 else f"{prefix}{controls[per][name][b]}"
                         for prefix, _, per in CONTROLS]
            elif (controls.get("s_bar", 0) <= b <= controls.get("e_bar", len(bars))
                  and controls.get(name) == 0):
                three = ["unk"] * 3
            row.append((name, list(three), body))
        out.append((lead, row))
    return header, out


def prompt(vocab: Vocab, events: Sequence[str], controls: Dict, tracks: Sequence[int],
           bars: Sequence[int]) -> Optional[Tuple[np.ndarray, List[int], bool]]:
    """(source ids, span codes, no whole notes) of a request, or None where
    it asks for a bar or a track the stream does not have."""
    header, parsed = controlled(*parse(events), controls)
    names = sorted({name for _, row in parsed for name, _, _ in row})
    wanted = {f"track_{t}" for t in tracks}
    if not wanted <= set(names) or any(b >= len(parsed) for b in bars):
        return None
    words, codes = list(header), []
    for b, (lead, row) in enumerate(parsed):
        words += ["bar"] + lead
        for i, (name, three, body) in enumerate(row):
            masked = b in bars and name in wanted
            words += [name] + three
            if masked:
                words.append("m_0")
                codes.append(SPAN_BODY)
                words += ["m_0"] * 3
                codes += list(COPY_SPANS)
            else:
                words += body + three
            if i == len(row) - 1 and lead:
                tension = lead[0]
                if masked and tension.startswith("s_"):
                    words.append("m_0")
                    codes.append(SPAN_TENSILE)
                else:
                    words.append(tension)
    num, den = (int(x) for x in events[0].split("/"))
    return vocab.ids(words), codes, not (num >= 4 and den == 4)
