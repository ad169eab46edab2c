"""The served-token comparison of the sampled infill decode.

The program samples each token as the argmax, over the nucleus of the
grammar-allowed words, of log-probability plus a row of Gumbel(0, 1) noise
it draws from the generator handed to it (Maddison et al., "A* sampling",
2014; Holtzman et al., "The curious case of neural text degeneration",
2020: the nucleus is every word the total probability strictly above which
is under ``p``).  The check draws that noise again from the generator's
state as the draw found it, runs the plain reference once over the request's
prompt with the tokens it served, and reads at each served position by how
much the served word's score (log-probability + noise, at the reference's
probabilities) lies below the best score among the words that are in the
nucleus wherever the served one is: 0 where the reference makes the same
draw.  Rounding may reorder two words whose log-probabilities lie within
``tie`` of each other, and move the nucleus's edge by ``slack`` of
probability, so a word counts as more likely than another only by more than
``tie``, and as surely in the nucleus only if it is even where every word
within ``tie`` of it counts as more likely and the edge lies ``slack`` lower.
A served word the grammar does not allow, or one outside the nucleus even
where words within ``tie`` of it count as less likely and the edge lies
``slack`` higher, reads infinite.  The control reads, at the same positions
with the same noise, the draw of the reference computed in a lower
precision.

The span rules follow the decoder's: a stream is spans, each opened by
``m_0``; a span ends on ``<eos>``, when it holds ``span_cap`` tokens (the
``m_0`` counted), or after a control span's one token, and the next span's
``m_0`` is written in the ended span's place.  Where a span ended on the cap
or on its one control token the token sampled there was not served, and
nothing is read.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .grammar import SPAN_BODY, START, Grammar, Vocab
from .model import Reference, no_tf32


@dataclass
class Served:
    """One finished request as the check needs it: the prompt the program
    was handed (the masked source ids and span codes, the time signature's
    no-whole flag), what it served (the decoder stream of words, ``m_0``
    first, and the restored event stream) and the noise it was sampled
    with: (generator state before the draw, the draw's shape, its row).
    ``exact``: the answer has to be the source with the spans spliced in."""

    src: np.ndarray
    span_codes: List[int]
    no_whole: bool
    generated: List[str]
    events: List[str]
    noise: Optional[Tuple[torch.Tensor, Tuple[int, ...], int]] = None
    exact: bool = False


def positions(vocab: Vocab, req: Served, span_cap: int):
    """(position, served word id, allowed mask) of every served token.  A
    stream cut at the decoder's length cap before its last span ended ends
    on no served token."""
    grammar = Grammar(vocab)
    stream = vocab.ids(req.generated)
    complete = int((stream == vocab.mask).sum()) == len(req.span_codes)
    out = []
    span, steps, flags = 0, 1, START
    for p in range(len(stream)):
        if span >= len(req.span_codes):
            break
        kind = req.span_codes[span]
        allowed = grammar.allowed(flags, steps == 1, kind, req.no_whole)
        nxt = int(stream[p + 1]) if p + 1 < len(stream) else None
        if nxt is None and not complete:
            break
        if nxt is None or nxt == vocab.mask:
            if not ((kind != SPAN_BODY and steps >= 2) or steps >= span_cap):
                out.append((p, vocab.eos, allowed))
            span, steps, flags = span + 1, 1, START
        else:
            out.append((p, nxt, allowed))
            flags = grammar.advance(flags, nxt)
            steps += 1
    return out


def grammar_faults(vocab: Vocab, req: Served, span_cap: int) -> int:
    """Served tokens of one request that the grammar does not allow."""
    try:
        return sum(not allowed[word] for _, word, allowed in positions(vocab, req, span_cap))
    except KeyError:  # a word outside the vocabulary
        return 1


def gumbel(noise, width: int, device) -> np.ndarray:
    """(L, width) Gumbel(0, 1) rows of one decode row, drawn again from the
    generator state: -log(-log(u)), u uniform, kept inside (0, 1)."""
    state, shape, row = noise
    gen = torch.Generator(device=device)
    gen.set_state(state)
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)[:, row, :width]
    u = u.clamp(min=torch.finfo(torch.float32).tiny, max=1.0 - 2 ** -24)
    return (-torch.log(-torch.log(u))).cpu().numpy()


def stream_logits(ref: Reference, vocab: Vocab, req: Served, device) -> np.ndarray:
    """(len(stream), V) f32 logits of the teacher-forced stream."""
    src = torch.as_tensor(np.asarray(req.src, np.int64), device=device)[None]
    tgt = torch.as_tensor(vocab.ids(req.generated), device=device)[None]
    with torch.no_grad():
        return ref.decode(tgt, ref.encode(src), src)[0].float().cpu().numpy()


def log_probs(logits: np.ndarray, allowed: np.ndarray, temperature: float):
    """Log-probabilities and probabilities over the allowed words."""
    x = np.where(allowed, logits.astype(np.float64) / temperature, -np.inf)
    logp = x - x.max() - np.log(np.exp(x - x.max()).sum())
    return logp, np.exp(logp)


def mass_above(logp: np.ndarray, prob: np.ndarray, margin: float) -> np.ndarray:
    """For each word, the total probability of the words whose
    log-probability exceeds its own by more than ``margin`` (less than 0:
    by more than ``margin``, the word itself left out)."""
    order = np.argsort(-logp, kind="stable")
    desc = logp[order]
    cum = np.concatenate([[0.0], np.cumsum(prob[order])])
    out = cum[np.searchsorted(-desc, -(logp + margin), side="left")]
    return out - (prob if margin < 0 else 0.0)


def reading(logp, prob, allowed, g, word: int, p: float, slack: float, tie: float) -> float:
    """By how much the served word's score lies below the best among the
    words that are surely in the nucleus with it (see the module's doc)."""
    if not allowed[word] or mass_above(logp, prob, tie)[word] >= p + slack:
        return float("inf")
    rivals = allowed & ((mass_above(logp, prob, -tie) < p - slack) | (logp > logp[word] + tie))
    rivals[word] = True
    score = logp + g
    return float(score[rivals].max() - score[word])


def draw(logits, allowed, g, p: float, temperature: float) -> int:
    """The word a sampler over ``logits`` draws with noise ``g``."""
    logp, prob = log_probs(logits, allowed, temperature)
    kept = allowed & (mass_above(logp, prob, 0.0) < p)
    return int(np.argmax(np.where(kept, logp + g, -np.inf)))


def sample_gaps(ref: Reference, vocab: Vocab, reqs: Sequence[Served], device, span_cap: int,
                p: float, temperature: float, slack: float, tie: float,
                control: Optional[Reference] = None) -> Tuple[np.ndarray, float]:
    """The reading of every served token of ``reqs`` (or, with ``control``,
    of the control's draw at the same positions), and the farthest an
    allowed word read lay outside the reference's nucleus, in probability,
    with no room for rounding."""
    no_tf32()
    out, outside = [], 0.0
    for req in reqs:
        if req.noise is None:  # no decode of its call served it
            out.append(float("inf"))
            continue
        logits = stream_logits(ref, vocab, req, device)
        other = None if control is None else stream_logits(control, vocab, req, device)
        g = gumbel(req.noise, vocab.size, device)
        for pos, word, allowed in positions(vocab, req, span_cap):
            logp, prob = log_probs(logits[pos], allowed, temperature)
            if other is not None:
                word = draw(other[pos], allowed, g[pos], p, temperature)
            if allowed[word]:
                outside = max(outside, float(mass_above(logp, prob, 0.0)[word]) - p)
            out.append(reading(logp, prob, allowed, g[pos], word, p, slack, tie))
    return np.asarray(out, np.float64), outside


def splice(src_words: Sequence[str], generated: Sequence[str]) -> List[str]:
    """The masked source with its i-th ``m_0`` replaced by the i-th span."""
    spans: List[List[str]] = []
    for w in generated:
        if w == "m_0":
            spans.append([])
        elif spans:
            spans[-1].append(w)
    out, i = [], 0
    for w in src_words:
        if w == "m_0" and i < len(spans):
            out.extend(spans[i])
            i += 1
        else:
            out.append(w)
    return out


def restore_fault(vocab: Vocab, req: Served, exact: bool) -> bool:
    """Whether a served answer does not restore its request: the stream
    must hold one span a masked slot, and the returned events must keep the
    source outside the masked slots (``exact``: be the source with the spans
    spliced in, where no duration repair follows)."""
    words = [vocab.words[int(i)] for i in req.src]
    if sum(w == "m_0" for w in req.generated) != len(req.span_codes) or "m_0" in req.events:
        return True
    if exact:
        return splice(words, req.generated) != list(req.events)
    first = words.index("m_0")
    last = len(words) - 1 - words[::-1].index("m_0")
    tail = words[last + 1:]
    return (list(req.events[:first]) != words[:first]
            or list(req.events[len(req.events) - len(tail):]) != tail)
