#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives ``smer_music_generation_tpu_torch`` (nothing of JAX) through its
main path and prints one line per phase with the elapsed seconds:

0. card: ``nvidia-smi`` name and power limit;
1. build: the CUDA decode-step kernels (``ops/csrc/decode_step.cu``) with
   nvcc into ``build/torch_kernels/``;
2. kernel vs twin: ``fused_decode_step`` against its plain torch twin at
   the flagship width (4 decoder layers, d512, 8 heads, d_ff 2048) with
   random seeded bf16 weights and random biases and LayerNorm parameters
   (so that the packed bias strip, ``ln``, ``fin_ln`` and ``fc_b`` are
   read at their offsets), for B in {1, 4, 8}, L = 1024,
   S in {512, 1024, 1536}, index in {0, 1, 511, 512, 1023} and ragged cross
   lengths (S = 1536 is the served batch's source length); the kernel's
   and the twin's time (CUDA events) beside the bound (bytes over
   3.35 TB/s);
3. serve: the committed trained snapshot on the card in bf16, a seeded
   3-track 16-bar 4/4 score, ``generate_cli.main`` infilling 2 bars of one
   track (greedy), then ``InfillEngine.run_batch`` on 3 nucleus requests
   padded to 4; every result must restore, close its bars and write a MIDI
   file that reads back, and the main path must have launched the kernels
   and never called the twin;
4. kernel path vs twin path: one greedy request decoded through the
   kernels and through the twin on the card, and where they first differ;
   a difference at a step where the twin's margin between the two tokens
   exceeds what the phase-2 tolerance allows is a failure.

Then a JSON line describing the kernel, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero; without a
CUDA device it exits 2 before printing any result.
"""

from __future__ import annotations

import faulthandler
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from smer_music_generation_tpu_torch.codec.annotate import encode_midi
from smer_music_generation_tpu_torch.codec.midi import (
    Instrument,
    MidiScore,
    Note,
    TimeSignature,
    read_midi,
)
from smer_music_generation_tpu_torch.codec.smer import events_to_midi
from smer_music_generation_tpu_torch.infer import decode as decode_mod
from smer_music_generation_tpu_torch.infer import generate_cli
from smer_music_generation_tpu_torch.infer.decode import InfillDecoder
from smer_music_generation_tpu_torch.infer.engine import InfillEngine, change_controls
from smer_music_generation_tpu_torch.models.transformer import LayerNorm, ModelConfig, ScoreTransformer
from smer_music_generation_tpu_torch.ops import decode_step as ds
from smer_music_generation_tpu_torch.train.state import (
    default_flagship_snapshot,
    load_inference_model,
)
from smer_music_generation_tpu_torch.utils.config import ExperimentConfig
from smer_music_generation_tpu_torch.vocab import WordVocab

TIME_LIMIT_S = 1100
HBM_BYTES_PER_S = 3.35e12  # H100 SXM at its full 700 W (NVIDIA data sheet)
BF16_FLOPS = 989e12
NL, D, H, F, L = 4, 512, 8, 2048, 1024
# kernel vs twin: bf16 operands with f32 accumulation on both sides, summed
# in another order; an activation that lands on the other side of a bf16
# rounding boundary moves a downstream value by one bf16 ulp (2^-8
# relative), so the check is |kernel - twin| <= ATOL + RTOL * |twin|
ATOL, RTOL = 5e-2, 2e-2
REPORT_CASE = (4, 1536, 512)  # (B, S, index): the served batch's shape

T0 = time.perf_counter()


def say(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_split(fn, iters: int = 20):
    """Device time of one call, by kernel family, from torch.profiler; None
    when the profiler records no CUDA kernel on this machine."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0) or 0
        if us <= 0:
            continue
        family = next(
            (k for k in ("rowvec_kernel", "attend_kernel", "add_layernorm_kernel") if k in evt.key),
            "other",
        )
        split[family] = split.get(family, 0.0) + us / iters
    return split or None


def step_bound_ms(packed, B: int, index: int, cross_len) -> float:
    """Least time of one decoder step on the card: every packed weight,
    x_emb, the valid cache rows and the outputs moved once, against the
    bf16 operations of the step; bytes dominate by far."""
    weight_bytes = sum(t.numel() * t.element_size() for t in packed.values())
    vpad = packed["fc_w"].shape[1]
    rows = NL * (B * index + int(sum(cross_len)))
    cache_bytes = rows * 2 * D * 2
    io_bytes = B * D * 2 + B * vpad * 4 + NL * B * 2 * D * 2 + B * 4
    flops = 2 * B * NL * (6 * D * D + 2 * D * F) + 2 * B * D * vpad + 4 * D * rows
    return 1e3 * max((weight_bytes + cache_bytes + io_bytes) / HBM_BYTES_PER_S, flops / BF16_FLOPS)


def make_score(bars=16, tracks=3, tempo=100.0, seed=7) -> MidiScore:
    """A seeded 4/4 score of random sixteenth-grid notes and chords."""
    rng = np.random.default_rng(seed)
    s = MidiScore(initial_tempo=tempo)
    s.time_signature_changes = [TimeSignature(4, 4, 0.0)]
    sixteenth = 60.0 / tempo / 4
    for t in range(tracks):
        inst = Instrument(program=[0, 32, 48][t])
        for bar in range(bars):
            slot = 0
            while slot < 16:
                if rng.random() < 0.5:
                    length = min(int(rng.integers(1, 5)), 16 - slot)
                    start = (bar * 16 + slot) * sixteenth
                    pitch = int(rng.integers(40, 90))
                    inst.notes.append(Note(100, pitch, start, start + length * sixteenth))
                    if rng.random() < 0.3:
                        inst.notes.append(Note(100, min(pitch + 4, 108), start, start + length * sixteenth))
                    slot += length
                else:
                    slot += 1
        s.instruments.append(inst)
    return s


def phase_kernel_vs_twin(dev):
    torch.manual_seed(0)
    vocab = WordVocab(0, ExperimentConfig().control_list)
    model = ScoreTransformer(ModelConfig(
        vocab_size=vocab.vocab_size, d_model=D, nhead=H, num_encoder_layers=1,
        num_decoder_layers=NL, d_ff=F, dtype=torch.bfloat16,
    )).to(dev).eval()
    # a fresh model has zero biases and unit LayerNorms; make them random so
    # that a kernel that drops a bias or reads the wrong offset disagrees
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LayerNorm):
                m.weight.copy_(1.0 + 0.2 * torch.randn_like(m.weight))
            if isinstance(m, (LayerNorm, torch.nn.Linear)):
                m.bias.normal_(0.0, 0.5)
    vpad = ds.vocab_pad(vocab.vocab_size)
    packed = ds.pack_decoder_weights(model, vpad)
    kw = dict(n_layers=NL, d_model=D, nhead=H, d_ff=F, vpad=vpad)
    g = torch.Generator(device=dev).manual_seed(1)
    worst, report = 0.0, None
    for B in (1, 4, 8):
        for S in (512, 1024, 1536):
            x = torch.randn(B, D, generator=g, device=dev).to(torch.bfloat16)
            self_kv = torch.randn(NL, B, L, 2 * D, generator=g, device=dev).to(torch.bfloat16)
            cross_kv = torch.randn(NL, B, S, 2 * D, generator=g, device=dev).to(torch.bfloat16)
            cl_list = [S - (S // 16) * b for b in range(B)]
            cross_len = torch.tensor(cl_list, dtype=torch.int32, device=dev)
            for index in (0, 1, 511, 512, 1023):
                args = (packed, x, self_kv, cross_kv, index, cross_len)
                lg, kv = ds.fused_decode_step(*args, **kw)
                torch.cuda.synchronize()
                lr, kr = ds.fused_decode_step_reference(*args, **kw)
                V = vocab.vocab_size
                err = max((lg[:, :V] - lr[:, :V]).abs().max().item(),
                          (kv.float() - kr.float()).abs().max().item())
                ok = (
                    torch.allclose(lg[:, :V], lr[:, :V], atol=ATOL, rtol=RTOL)
                    and torch.allclose(kv.float(), kr.float(), atol=ATOL, rtol=RTOL)
                    and torch.isfinite(lg[:, :V]).all().item()
                )
                ms = cuda_ms(lambda: ds.fused_decode_step(*args, **kw), iters=20)
                plain_ms = cuda_ms(lambda: ds.fused_decode_step_reference(*args, **kw), iters=5)
                bound = step_bound_ms(packed, B, index, cl_list)
                say(f"  B={B} S={S} index={index:4d} cross_len={cl_list}: max|kernel-twin|={err:.3e} "
                    f"kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, bound {bound:.4f} ms")
                if not ok:
                    raise AssertionError(f"kernel disagrees with the twin at B={B} S={S} index={index}")
                worst = max(worst, err)
                if (B, S, index) == REPORT_CASE:
                    report = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound)
                    split = device_split(lambda: ds.fused_decode_step(*args, **kw))
                    if split is None:
                        say("    device time by kernel: not measured (the profiler saw no CUDA kernel)")
                    else:
                        busy = sum(split.values())
                        parts = ", ".join(f"{k} {v:.1f} us" for k, v in sorted(split.items()))
                        say(f"    device time per step: {parts}; total {busy:.1f} us of "
                            f"{1e3 * ms:.1f} us wall, device busy {busy / (1e3 * ms):.1%}")
    return worst, report


def phase_serve(dev, workdir):
    cfg = ExperimentConfig()
    vocab = WordVocab(cfg.vocab_mode, cfg.control_list)
    snapshot = default_flagship_snapshot()
    if snapshot is None:
        raise FileNotFoundError("assets/flagship_params.msgpack is missing")
    model, epoch = load_inference_model(cfg, vocab.vocab_size, snapshot, torch.bfloat16, device=dev)
    say(f"  loaded {snapshot} (epoch {epoch}) onto {dev} in bf16")
    score = make_score()
    midi_in = os.path.join(workdir, "in.mid")
    score.write(midi_in)

    ds.reset_counts()
    t = time.perf_counter()
    midi_out = os.path.join(workdir, "cli_out.mid")
    rc = generate_cli.main([
        "-i", midi_in, "-o", midi_out, "--bars", "3", "4", "--tracks", "1",
        "--greedy", "--device", str(dev),
    ])
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"generate_cli.main returned {rc}")
    if not read_midi(midi_out).instruments:
        raise AssertionError("the CLI's MIDI output has no instruments")
    say(f"  generate_cli (greedy, bars 3-4 of track 1): {time.perf_counter() - t:.2f} s, "
        f"kernel steps {ds.fused_decode_step.launches}, twin calls {ds.fused_decode_step_reference.calls}")
    cli_launches = ds.fused_decode_step.launches
    cli_twin = ds.fused_decode_step_reference.calls

    events, controls = encode_midi(score, controls={"key": None},
                                   track_names=["track_0", "track_1", "track_2"])
    controls["bar_track"] = 0
    for name in ("track_0", "track_1", "track_2"):
        controls[f"{name}_c"] = controls[name]
    events = change_controls(events, controls, vocab)
    engine = InfillEngine(model, vocab, nucleus_p=0.9, max_tgt_len=L, seed=0)
    reqs = [engine.prepare(events, [0], [2, 3]), engine.prepare(events, [1], [7]),
            engine.prepare(events, [2], [11, 12])]
    if any(r is None for r in reqs):
        raise AssertionError("a request could not be prepared")
    seen = []
    dispatch = engine._dispatch
    engine._dispatch = lambda src_b, *a: seen.append(src_b.shape) or dispatch(src_b, *a)

    ds.reset_counts()
    t = time.perf_counter()
    results = engine.run_batch(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches, twin_calls = ds.fused_decode_step.launches, ds.fused_decode_step_reference.calls
    if seen[0][0] != 4:
        raise AssertionError(f"3 requests were not padded to 4 (batches {seen})")
    tokens = 0
    for i, (req, res) in enumerate(zip(reqs, results)):
        if res is None or "m_0" in res.events:
            raise AssertionError(f"request {i} did not restore")
        if not engine._spans_close(res.events, req):
            raise AssertionError(f"request {i}: a masked bar does not close after the repair")
        out = events_to_midi(res.events, 100.0)
        path = os.path.join(workdir, f"req{i}.mid")
        out.write(path)
        if not read_midi(path).instruments:
            raise AssertionError(f"request {i}: written MIDI does not read back")
        tokens += len(res.generated)
        say(f"  request {i}: bars {req.mask_bars} tracks {req.mask_tracks}: "
            f"{len(res.generated)} tokens, {res.decode_steps} decode steps, "
            f"{res.time_corrections} retries")
    say(f"  run_batch: {len(seen)} decodes of batch {[s[0] for s in seen]}, src {seen[0][1]} ids, "
        f"{wall:.3f} s, {tokens / wall:.1f} tokens/s, {1e3 * wall / len(reqs):.1f} ms per request; "
        f"kernel steps {launches}, twin calls {twin_calls}")
    launches += cli_launches
    twin_calls += cli_twin
    if launches == 0 or twin_calls != 0:
        raise AssertionError(f"main path: kernel steps {launches}, twin calls {twin_calls}")
    return model, vocab, events, launches


def phase_kernel_vs_twin_path(model, vocab, events):
    """One greedy request through the kernels, then through the twin (the
    decoder's step patched to ``fused_decode_step_reference``).  Where the
    token streams first differ, the twin's logits are recomputed on the
    shared prefix: the two paths may part only where the twin's margin
    between its token and the kernel's is within the phase-2 tolerance on
    each of the two logits."""
    eng = InfillEngine(model, vocab, max_tgt_len=L)
    req = eng.prepare(events, [0], [5, 6])
    asm = eng._assemble([req])

    def run():
        dec = InfillDecoder(model, vocab, max_tgt_len=L, greedy=True, nucleus_p=None, fused=True)
        res = dec(*asm[:4])
        return res.tokens[0, : int(res.lengths[0])].cpu()

    a = run()
    with mock.patch.object(decode_mod, "fused_decode_step", ds.fused_decode_step_reference):
        b = run()
    n = min(len(a), len(b))
    diff = (a[:n] != b[:n]).nonzero()
    if len(diff) == 0 and len(a) == len(b):
        say(f"  kernel path and twin path: identical ({len(a)} tokens)")
        return
    p = int(diff[0]) if len(diff) else n
    src = torch.as_tensor(asm[0], dtype=torch.long, device=model.device)
    pad = src == 0
    cfg = model.cfg
    kw = dict(n_layers=cfg.num_decoder_layers, d_model=cfg.d_model, nhead=cfg.nhead,
              d_ff=cfg.d_ff, vpad=ds.vocab_pad(vocab.vocab_size))
    packed = ds.pack_decoder_weights(model, kw["vpad"])
    with torch.no_grad():
        cross_kv = ds.stack_kv_cache(model.init_cross_cache(model.encode(src, pad)), cfg.num_decoder_layers)
        cross_len = (~pad).sum(1).to(torch.int32)
        kv = torch.zeros(cfg.num_decoder_layers, 1, L, 2 * cfg.d_model, dtype=cfg.dtype, device=model.device)
        for pos in range(p):  # the step at p - 1 emits position p
            x = (model.embedding.weight[b[pos : pos + 1].to(model.device)] * math.sqrt(cfg.d_model)
                 + model.pos_table[pos]).to(cfg.dtype)
            logits, new_kv = ds.fused_decode_step_reference(packed, x, kv, cross_kv, pos, cross_len, **kw)
            kv[:, :, pos] = new_kv
    lg = logits[0, : vocab.vocab_size].float()

    def sampled(tokens):
        # the sampled token behind position p: m_0 (a new span) or padding
        # (the element is done) after a common prefix follows a sampled <eos>
        tok = int(tokens[p]) if p < len(tokens) else 0
        return vocab.eos_index if tok in (0, vocab.mask_index) else tok

    ta, tb = sampled(a), sampled(b)
    gap = (lg[tb] - lg[ta]).item()
    allowed = 2 * ATOL + RTOL * (abs(lg[ta].item()) + abs(lg[tb].item()))
    say(f"  kernel path and twin path first differ at position {p} of {n}: kernel "
        f"{vocab.index2char(ta)!r} vs twin {vocab.index2char(tb)!r}; twin logit gap "
        f"{gap:.4f}, tolerance {allowed:.4f}")
    if gap > allowed:
        raise AssertionError(
            f"kernel path departs from the twin at position {p} where the twin's margin "
            f"{gap:.4f} exceeds the tolerance {allowed:.4f}"
        )


def main() -> int:
    faulthandler.dump_traceback_later(TIME_LIMIT_S, exit=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(f"phase 0 card: {card}")
    print(card, flush=True)

    say("phase 1 build")
    ds.load_library()
    say(f"  built {ds.BUILD_INFO['path']} in {ds.BUILD_INFO['seconds']:.1f} s")
    for line in str(ds.BUILD_INFO["log"]).splitlines():
        if "registers" in line or "spill" in line:
            print("   ", line.strip(), flush=True)

    say("phase 2 kernel vs twin (random bf16 weights, flagship width)")
    worst, report = phase_kernel_vs_twin(dev)
    say(f"  all cases within atol {ATOL} + rtol {RTOL}; max |kernel - twin| {worst:.3e}")

    say("phase 3 serve with the trained snapshot")
    with tempfile.TemporaryDirectory() as workdir:
        model, vocab, events, launches = phase_serve(dev, workdir)

    say("phase 4 kernel path vs twin path (greedy)")
    phase_kernel_vs_twin_path(model, vocab, events)

    kernels = {"kernels": [{
        "name": "fused_decode_step",
        "route": "cuda",
        "source": "smer_music_generation_tpu_torch/ops/csrc/decode_step.cu",
        "replaces": "smer_music_generation_tpu/ops/decode_step.py:456",
        "launches": launches,
        "max_abs_err": worst,
        "ms": report["ms"],
        "plain_ms": report["plain_ms"],
        "bound_ms": report["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]}
    print(json.dumps(kernels), flush=True)
    say("done")
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
