"""A whole run on the CPU at a small size (the chip's look skipped) comes
out correct, and with the timed path broken underneath comes out not
correct: once for each fault a cell can have.  The cells run on one chip,
so no exchange between chips can be left out."""

import json

import pytest
import torch

from port_bench import run as bench_run


def result(capsys, cell, seed=2**31 + 7):
    assert bench_run.main(["--workload", cell, "--seed", str(seed), "--seconds", "1",
                           "--rehearse"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["smer.batch64", "smer.single", "smer.train2048"])
def test_sound_run_is_correct(capsys, cell):
    out = result(capsys, cell)
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "comparisons" and out["metrics"] == {}


@pytest.mark.parametrize("cell", ["smer.batch64", "smer.single"])
def test_token_altered_where_it_is_produced(capsys, monkeypatch, cell):
    from smer_music_generation_tpu_torch.infer.decode import InfillDecoder

    real = InfillDecoder.__call__

    def altered(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        live = out.lengths > 2
        out.tokens[live, 2] = 3  # "bar": a word the grammar never allows
        return out

    monkeypatch.setattr(InfillDecoder, "__call__", altered)
    out = result(capsys, cell)
    assert not out["correct"]
    for name in ("grammar_faults", "sample_gap"):
        assert out["comparisons"][name]["value"] > out["comparisons"][name]["limit"]


@pytest.mark.parametrize("cell", ["smer.batch64", "smer.single"])
def test_tokens_sampled_with_other_noise(capsys, monkeypatch, cell):
    from smer_music_generation_tpu_torch.infer import decode

    real = decode.gumbel_noise

    def other(shape, generator, device):
        return real(shape, torch.Generator(device=device).manual_seed(12345), device)

    monkeypatch.setattr(decode, "gumbel_noise", other)
    out = result(capsys, cell)
    assert not out["correct"]
    assert out["comparisons"]["sample_gap"]["value"] > out["comparisons"]["sample_gap"]["limit"]


@pytest.mark.parametrize("cell", ["smer.batch64", "smer.single"])
def test_prompt_span_kind_altered(capsys, monkeypatch, cell):
    from smer_music_generation_tpu_torch.infer import engine

    real = engine.mask_bar_and_track

    def short(events, vocab, tracks, bars):
        out = real(events, vocab, tracks, bars)
        return out if out is None else (out[0], out[1][:-1] + [out[1][-1] % 4 + 1], *out[2:])

    monkeypatch.setattr(engine, "mask_bar_and_track", short)
    out = result(capsys, cell)
    assert not out["correct"] and out["comparisons"]["prompt_faults"]["value"] > 0


def test_step_returns_its_state_unchanged(capsys, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    out = result(capsys, "smer.train2048")
    assert not out["correct"] and out["comparisons"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(capsys, monkeypatch):
    from smer_music_generation_tpu_torch.train import state

    real = state.multihead_ce

    def half(logits, targets, *args, **kwargs):
        n = logits.shape[0] // 2
        return real(logits[:n], targets[:n], *args, **kwargs)

    monkeypatch.setattr(state, "multihead_ce", half)
    out = result(capsys, "smer.train2048")
    assert not out["correct"]
