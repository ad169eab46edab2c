"""The traffic generators are deterministic under a seed, and every seed
gets the same work."""

import numpy as np
import pytest
import torch

from port_bench import harness, serving


def rehearsal_run(cell: str, seed: int) -> harness.Run:
    spec = harness.workload(cell)
    spec, cfg = harness.rehearsal(spec, harness.config(spec["config"]))
    return harness.Run(cell, seed, 1.0, False, True, cell=spec, config=cfg,
                       device=torch.device("cpu"))


def test_seeded_streams_are_deterministic_and_take_large_seeds():
    a, b = rehearsal_run("smer.batch64", 2**31 + 12345), rehearsal_run("smer.batch64", 2**31 + 12345)
    assert a.torch_seed(2) == b.torch_seed(2)
    assert a.torch_seed(2) != rehearsal_run("smer.batch64", 7).torch_seed(2)
    x = serving.score_notes(a.rng(1), 4, 2)
    assert x == serving.score_notes(b.rng(1), 4, 2)


@pytest.fixture(scope="module")
def encoder():
    from smer_music_generation_tpu_torch.serve.app import ServingContext

    run = rehearsal_run("smer.single", 1)
    vocab, model, _ = serving.load_model(run)
    return ServingContext(model, vocab, batch_window_ms=0)


def test_request_mix_deterministic_under_a_seed(encoder):
    def stream(seed, n=20):
        mix = serving.Mix(rehearsal_run("smer.single", seed), encoder)
        return [mix.next() for _ in range(n)]

    assert stream(11) == stream(11)
    assert stream(11) != stream(12)


def test_every_seed_gets_the_same_combinations(encoder):
    def combos(seed):
        run = rehearsal_run("smer.single", seed)
        mix = serving.Mix(run, encoder)
        n = len(mix.combos)
        out = []
        for _ in range(n):
            x = mix.next()
            bars = sum(e == "bar" for e in x["events"])
            out.append((bars, len(x["bars"])))
        return sorted(out)

    assert combos(3) == combos(4)


def test_train_pool_same_lengths_other_order():
    from port_bench.traffic.train import Driver

    def pool(seed):
        d = Driver(rehearsal_run("smer.train2048", seed))
        d.pool()
        return d

    a, b, c = pool(5), pool(5), pool(6)
    for x, y in zip(a.batches, b.batches):
        assert all(torch.equal(x[k], y[k]) for k in x)
    lens = lambda d: sorted(v for s, t in d.lens for v in s + t)  # noqa: E731
    assert lens(a) == lens(c)
    assert [s for s, _ in a.lens] != [s for s, _ in c.lens]
    batch = a.batches[0]
    real = (~batch["input_pad_mask"]).sum(1).tolist()
    assert real == a.lens[0][0] and (batch["input"][batch["input_pad_mask"]] == 0).all()
    assert np.all(np.asarray(a.lens[0][1]) <= a.p["tgt_len"])
