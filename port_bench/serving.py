"""The serving cells' request mix, their model and the served-token check.

Requests are made as the plugin sends them: a seeded score as the plugin's
note dict (``notes``), encoded once in set-up by the server's own
``ServingContext.handle_encode``, with every track unlocked as the plugin
does before ``/generate``.  Each request infills ``infill_bars`` contiguous
bars of one track of a score of ``bars`` bars and ``tracks`` tracks.  The
work a seed gets is fixed: the (bars, tracks, infill) combinations of the
mix come in whole shuffled rounds, and only the notes, the order, the track
and the first bar depend on the seed.
"""

from __future__ import annotations

import itertools
import time
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .harness import ROOT, Run
from .reference.grammar import Vocab
from .reference.model import Reference
from .reference.msgpack import read_flax_msgpack, state_from_flax
from .reference.prompt import prompt
from .reference.serve_check import (Served, grammar_faults, restore_fault,
                                       sample_gaps)

PROGRAMS = (0, 32, 48)  # the tracks' General MIDI programs


def score_notes(rng: np.random.Generator, bars: int, tracks: int, tempo: float = 100.0) -> Dict:
    """A 4/4 score of random sixteenth-grid notes and chords as the
    plugin's note dict: ``[pitch, start beat, beats]`` a note, the program
    plus one a track."""
    out: Dict = {"tempo": tempo, "numerator": 4, "denominator": 4}
    for t in range(tracks):
        notes = []
        for bar in range(bars):
            slot = 0
            while slot < 16:
                if rng.random() < 0.5:
                    length = min(int(rng.integers(1, 5)), 16 - slot)
                    start, beats = (bar * 16 + slot) / 4.0, length / 4.0
                    pitch = int(rng.integers(40, 90))
                    notes.append([pitch, start, beats])
                    if rng.random() < 0.3:
                        notes.append([min(pitch + 4, 108), start, beats])
                    slot += length
                else:
                    slot += 1
        out[f"track_{t}"] = notes
        out[f"track_{t}_program"] = PROGRAMS[t] + 1
    return out


def unlocked(controls: Dict) -> Dict:
    """The plugin's overwrite before ``/generate``: each track's control
    dict moves to ``track_N_c`` and ``track_N`` becomes the lock flag 0."""
    controls = dict(controls, bar_track=0, start_bar=1)
    for n in range(controls["track_nums"]):
        controls[f"track_{n}_c"] = controls[f"track_{n}"]
        controls[f"track_{n}"] = 0
    return controls


class Mix:
    """The seeded request stream of one run over encoded scores."""

    def __init__(self, run: Run, ctx):
        p = run.params
        self.rng = run.rng(1)
        self.combos = list(itertools.product(p["bars"], p["tracks"], p["infill_bars"]))
        self.scores = {}
        for bars, tracks in itertools.product(p["bars"], p["tracks"]):
            for variant in range(p["scores_each"]):
                enc = ctx.handle_encode({"notes": score_notes(self.rng, bars, tracks),
                                         "controls": {"start_bar": 1}})
                if "error" in enc:
                    raise RuntimeError(f"the server could not encode a {bars}-bar score: {enc}")
                self.scores[(bars, tracks, variant)] = (enc["events"], unlocked(enc["controls"]))
        self.variants = p["scores_each"]
        self.round: List = []

    def next(self) -> Dict:
        """The next request as a ``/generate`` payload."""
        if not self.round:
            self.round = [self.combos[i] for i in self.rng.permutation(len(self.combos))]
        bars, tracks, n = self.round.pop()
        events, controls = self.scores[(bars, tracks, int(self.rng.integers(self.variants)))]
        first = int(self.rng.integers(0, bars - n + 1))
        return {"events": events, "controls": controls, "tracks": [int(self.rng.integers(tracks))],
                "bars": list(range(first, first + n)), "tempo": 100}

    def warm_payloads(self) -> List[Dict]:
        """One request of every score, the widest infill: every source
        bucket the mix can reach."""
        n = max(self.combos[i][2] for i in range(len(self.combos)))
        out = []
        for (bars, tracks, variant), (events, controls) in sorted(self.scores.items()):
            out.append({"events": events, "controls": controls, "tracks": [tracks - 1],
                        "bars": list(range(min(n, bars))), "tempo": 100})
        return out


def program_config(cfg: Dict) -> SimpleNamespace:
    """The configuration as the program's loaders read it."""
    return SimpleNamespace(
        d_model=cfg["d_model"], nhead=cfg["nhead"], num_layers=cfg["num_encoder_layers"],
        d_ff=cfg["d_ff"], max_seq=cfg["max_seq"], vocab_mode=cfg["vocab_mode"])


def load_model(run: Run):
    """The served model: the configuration's committed snapshot through the
    program's own loader, in the configuration's dtype (on the CPU, for a
    rehearsal, a small model with seeded random weights)."""
    from smer_music_generation_tpu_torch.train.state import build_model, load_inference_model
    from smer_music_generation_tpu_torch.utils.config import ExperimentConfig
    from smer_music_generation_tpu_torch.vocab import WordVocab

    cfg = run.config
    vocab = WordVocab(cfg["vocab_mode"], ExperimentConfig().control_list)
    if vocab.vocab_size != cfg["vocab_size"]:
        raise RuntimeError(f"the program's vocabulary has {vocab.vocab_size} words, the "
                           f"configuration {cfg['vocab_size']}")
    if run.rehearse:
        model = build_model(vocab.vocab_size, d_model=cfg["d_model"], nhead=cfg["nhead"],
                            num_layers=cfg["num_encoder_layers"], d_ff=cfg["d_ff"],
                            max_len=cfg["max_seq"], dropout=0.0)
        params = random_state(model, run.torch_seed(7), run.device)
        model.load_state_dict(params)
        return vocab, model.to(run.device).eval().requires_grad_(False), params
    dtype = getattr(torch, cfg["dtype"])
    model, _ = load_inference_model(program_config(cfg), vocab.vocab_size,
                                    str(ROOT / cfg["weights"]), dtype, device=run.device)
    return vocab, model, None


def random_state(model, seed: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Seeded weights for ``model``'s parameters, made on ``device`` in one
    draw: matrices N(0, 1/fan_in), biases N(0, 0.02), LayerNorm scales 1 +
    N(0, 0.1)."""
    shapes = [(k, v.shape) for k, v in model.state_dict().items()]
    total = sum(int(np.prod(s)) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes:
        n = int(np.prod(shape))
        x = flat[at : at + n].view(shape)
        at += n
        if len(shape) == 2:
            x = x / float(np.sqrt(shape[1]))
        elif "norm" in name and name.endswith("weight"):
            x = 1.0 + 0.1 * x
        else:
            x = 0.02 * x
        out[name] = x.to(dtype)
    return out


def reference_params(run: Run, rehearsal_params) -> Dict[str, torch.Tensor]:
    """The reference's own reading of the weights: the committed snapshot
    through the frozen reader, or the rehearsal's seeded draw."""
    if rehearsal_params is not None:
        return {k: v.float() for k, v in rehearsal_params.items()}
    tree = read_flax_msgpack(str(ROOT / run.config["weights"]))
    return {k: v.to(run.device) for k, v in state_from_flax(tree).items()}


def sample(run: Run, served: Sequence[Served], tokens: int) -> List[int]:
    """The check's sample of delivered requests, drawn from the seed: the one
    that served most tokens, then others until ``tokens`` are reached."""
    if not served:
        return []
    order = [int(i) for i in run.rng(5).permutation(len(served))]
    longest = max(range(len(served)), key=lambda i: len(served[i].generated))
    picked, n = [longest], len(served[longest].generated)
    for i in order:
        if n >= tokens:
            break
        if i != longest:
            picked.append(i)
            n += len(served[i].generated)
    return picked


def collect(run: Run, log: "DecodeLog", delivered) -> Dict:
    """What the check reads of a window's answers, (payload, prepared
    request, result, (first, last) decode of its call) each: every answer
    as ``Served``, the payloads, and the seeded sample with its noise."""
    every = [served_record(run, req, res) for _, req, res, _ in delivered]
    vocab = Vocab(run.config["vocab_mode"])
    picked = []
    for i in sample(run, every, run.params["check_tokens"]):
        every[i].noise = log.noise(every[i], vocab, *delivered[i][3])
        picked.append(every[i])
    return dict(every=every, payloads=[x for x, *_ in delivered], picked=picked)


def check(run: Run, every: Sequence[Served], payloads: Sequence[Dict], picked: Sequence[Served],
          params) -> List[Dict]:
    """What the window served against the reference: the prompt of every
    delivered request, the grammar of every served token, the restore of
    every answer, and the sampled draws of a seeded sample of requests."""
    p = run.params
    vocab = Vocab(run.config["vocab_mode"])
    limits = run.cell["limits"]
    prompts = sum(not same_prompt(vocab, r, x) for r, x in zip(every, payloads))
    grammar = sum(grammar_faults(vocab, r, p["span_cap"]) for r in every)
    restore = sum(restore_fault(vocab, r, r.exact) for r in every)
    ref = Reference(reference_params(run, params), run.config)
    g, outside = sample_gaps(ref, vocab, picked, run.device, p["span_cap"], p["nucleus_p"],
                             p["temperature"], limits["nucleus_slack"], limits["tie"])
    return [
        dict(name="sample_gap", value=float(g.max()) if g.size else float("inf"),
             limit=limits["sample_gap"], tokens=int(g.size), requests=len(picked),
             outside=outside),
        dict(name="prompt_faults", value=float(prompts), limit=0.0, requests=len(every)),
        dict(name="grammar_faults", value=float(grammar), limit=0.0,
             tokens=sum(len(r.generated) for r in every)),
        dict(name="restore_faults", value=float(restore), limit=0.0),
    ]


def same_prompt(vocab: Vocab, served: Served, payload: Dict) -> bool:
    """Whether the program was handed the prompt the request asks for."""
    want = prompt(vocab, payload["events"], payload["controls"], payload["tracks"],
                  payload["bars"])
    return (want is not None and np.array_equal(want[0], served.src)
            and want[1] == served.span_codes and want[2] == served.no_whole)


def _copy(x):
    return x.clone() if torch.is_tensor(x) else np.array(x)


class DecodeLog:
    """Every decode the program's engine makes, with the Gumbel draw it made
    (the generator's state before it, and its shape), so that the check can
    draw the same noise again; ``noise`` matches a request's answer to its
    row among the decodes of its own call.  ``close`` puts the decoder's own
    draw back."""

    def __init__(self):
        from smer_music_generation_tpu_torch.infer import decode

        self.decodes: List[Dict] = []
        self.draws: List = []
        self.seen = 0
        self.module, self.real = decode, decode.gumbel_noise

        def gumbel_noise(shape, generator, device):
            self.draws.append((generator.get_state(), tuple(shape)))
            return self.real(shape, generator, device)

        decode.gumbel_noise = gumbel_noise

    def close(self) -> None:
        self.module.gumbel_noise = self.real

    def add(self, args, out) -> None:
        draws, self.seen = self.draws[self.seen:], len(self.draws)
        self.decodes.append(dict(src=_copy(args[0]), tokens=_copy(out.tokens),
                                 lengths=_copy(out.lengths), draw=draws[-1] if draws else None))

    def mark(self) -> int:
        return len(self.decodes)

    def clear(self) -> None:
        self.decodes.clear()
        self.draws.clear()
        self.seen = 0

    def noise(self, served: Served, vocab: Vocab, first: int, last: int):
        """(state, shape, row) of the first decode in ``[first, last)`` whose
        row holds the request's source and served stream."""
        ids = vocab.ids(served.generated)
        for d in self.decodes[first:last]:
            if d["draw"] is None:
                continue
            if "cpu" not in d:
                d["cpu"] = tuple(np.asarray(x.cpu()) if torch.is_tensor(x) else x
                                 for x in (d["src"], d["tokens"], d["lengths"]))
            src, tokens, lengths = d["cpu"]
            for row in range(src.shape[0]):
                n = len(served.src)
                if (int(lengths[row]) == len(ids) and np.array_equal(src[row, :n], served.src)
                        and not src[row, n:].any() and np.array_equal(tokens[row, :len(ids)], ids)):
                    return (d["draw"][0], d["draw"][1], row)
        return None


def bench_span(name: str):
    """A ``bench.<name>`` range in the trace, around a call into a layer."""
    return torch.profiler.record_function(f"bench.{name}")


def wrap(obj, attr: str, before=None, after=None):
    """Replace ``obj.attr`` (a bound method) by a timed call: ``after(args,
    result, seconds)``; returns the original."""
    real = getattr(obj, attr)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        with bench_span(attr.strip("_")):
            out = real(*args, **kwargs)
        if after is not None:
            after(args, out, time.perf_counter() - t0)
        return out

    setattr(obj, attr, timed)
    return real


def served_record(run: Run, prepared, result, events: Optional[Sequence[str]] = None) -> Served:
    """A request as the check reads it, from the program's prepared request
    (the prompt it was handed) and its result.  Its restore is judged exact
    where the engine repairs no durations (REMI) or found none to repair."""
    return Served(src=np.asarray(prepared.src, np.int64), span_codes=list(prepared.span_codes),
                  no_whole=bool(prepared.no_whole_duration), generated=list(result.generated),
                  events=list(events if events is not None else result.events),
                  exact=run.config["vocab_mode"] == 1 or not result.time_failed)
