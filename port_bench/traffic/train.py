"""Retraining: ``make_train_step`` steps (the trainer's lean step) on a pool
of seeded batches, each step's loss read back as the trainer reads it.

Set-up makes the weights on the card from the seed, builds the step with
its model and Adam state, and drives it through its first steps on the
pool's first batches; the reference follows the first three from the same
weights and dropout draws, and the window goes on with that same object.
Every seed's pool holds the same multiset of row lengths, drawn evenly
from [S/2, S] and [T/2, T], in another order, over random words.

End to end: ``train_tokens_per_s``, the non-pad source and target tokens
of every step of the window over the window.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from .. import serving
from ..harness import Run
from ..reference import train_check
from ..reference.grammar import Vocab
from ..serving import bench_span


class Driver:
    def __init__(self, run: Run):
        self.run = run
        self.p = run.params

    def sync(self) -> None:
        if self.run.device.type == "cuda":
            torch.cuda.synchronize()

    def pool(self) -> None:
        """``pool`` batches of ``rows`` rows, suffix-padded, from the seed."""
        p, V, dev = self.p, self.run.config["vocab_size"], self.run.device
        rng = self.run.rng(3)
        B, S, T, n = p["rows"], p["src_len"], p["tgt_len"], p["pool"]
        src_lens = rng.permutation(np.linspace(S // 2, S, B * n).round().astype(int)).reshape(n, B)
        tgt_lens = rng.permutation(np.linspace(T // 2, T, B * n).round().astype(int)).reshape(n, B)
        self.batches, self.lens = [], []
        for i in range(n):
            src = rng.integers(3, V, (B, S))
            tgt = rng.integers(3, V, (B, T + 1))
            spm = np.arange(S)[None, :] >= src_lens[i][:, None]
            tpm = np.arange(T)[None, :] >= tgt_lens[i][:, None]
            tin, tout = tgt[:, :-1].copy(), tgt[:, 1:].copy()
            src[spm], tin[tpm], tout[tpm] = 0, 0, 0
            batch = {"input": src, "target_in": tin, "target_out": tout,
                     "input_pad_mask": spm, "target_pad_mask": tpm}
            self.batches.append({k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
            self.lens.append((src_lens[i].tolist(), tgt_lens[i].tolist()))

    def setup(self) -> None:
        from smer_music_generation_tpu_torch.train.loss import build_loss_tables
        from smer_music_generation_tpu_torch.train.state import (
            TrainState,
            build_model,
            make_train_step,
        )
        from smer_music_generation_tpu_torch.utils.config import ExperimentConfig
        from smer_music_generation_tpu_torch.vocab import WordVocab

        run, p, cfg, dev = self.run, self.p, self.run.config, self.run.device
        self.pool()
        vocab = WordVocab(cfg["vocab_mode"], ExperimentConfig().control_list)
        with torch.device(dev):
            model = build_model(vocab.vocab_size, d_model=cfg["d_model"], nhead=cfg["nhead"],
                                num_layers=cfg["num_encoder_layers"], d_ff=cfg["d_ff"],
                                max_len=cfg["max_seq"], dropout=p["dropout"],
                                dtype=getattr(torch, cfg["dtype"]),
                                flash_training=p["flash_training"])
        self.params0 = serving.random_state(model, run.torch_seed(7), dev)
        model.load_state_dict(self.params0)
        self.state = TrainState.create(model, lr=p["lr"])
        self.step = make_train_step(model, build_loss_tables(vocab), with_metrics=False)
        self.gen = torch.Generator(device=dev).manual_seed(run.torch_seed(4))
        self.gen_state0 = self.gen.get_state().clone()
        # the reference follows steps 1-3: the first gradient as Adam took
        # it (its first moment after one step is 0.1 g), then each leaf's
        # change after the third
        names = {id(q): n for n, q in model.named_parameters()}
        self.losses, self.first = [], None
        self.i = 0
        for _ in range(3):
            self.losses.append(self.one())
            if self.first is None:
                opt = self.state.optimizer
                self.first = {names[id(q)]: float(opt.state[q]["exp_avg"].double().norm() / 0.1)
                              if "exp_avg" in opt.state[q] else 0.0  # the optimizer got none
                              for g in opt.param_groups for q in g["params"]}
        self.change = {n: float((q.detach() - self.params0[n]).double().norm())
                       for n, q in model.named_parameters()}
        for _ in range(p["warm_steps"]):
            self.one()
        self.sync()

    def one(self) -> float:
        k = self.i % len(self.batches)
        self.i += 1
        with bench_span("train_step"):
            self.state, m = self.step(self.state, self.batches[k], 1.0, self.gen)
            return float(m["loss"])

    def window(self, tracer) -> None:
        p = self.p
        self.tokens, self.steps = 0, 0
        self.traced: List[int] = []  # the pool batch of each traced step
        self.order: List[int] = []  # of each step
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < self.run.seconds:
            if self.steps == p["trace_from_step"]:
                tracer.start()
            k = self.i % len(self.batches)
            if tracer.prof is not None and not tracer.done:
                self.traced.append(k)
            self.one()
            self.order.append(k)
            self.tokens += sum(self.lens[k][0]) + sum(self.lens[k][1])
            self.steps += 1
            if self.steps == p["trace_from_step"] + p["trace_steps"]:
                tracer.stop()
        self.sync()
        self.window_s = time.perf_counter() - t0
        self.attempted, self.failed = self.steps, 0

    def end_to_end(self) -> Dict[str, float]:
        return {"train_tokens_per_s": self.tokens / self.window_s}

    def record(self) -> Dict:
        return dict(window_s=self.window_s, steps=self.steps, lens=self.lens,
                    traced=self.traced, order=self.order)

    def release(self) -> None:
        del self.state, self.step
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, quant: str = "none", rows=None):
        cfg, p = self.run.config, self.p
        dt = getattr(torch, cfg["dtype"])
        keep = float(torch.tensor(1.0 - p["dropout"], dtype=dt))
        scored = torch.as_tensor(Vocab(cfg["vocab_mode"]).scored(), device=self.run.device)
        return train_check.follow(self.params0, cfg, self.batches[:3], self.gen_state0,
                                  self.run.device, scored, p["lr"], p["dropout"], keep,
                                  quant=quant, rows=rows)

    def check(self) -> List[Dict]:
        ref = self.reference()
        got = train_check.readings(self.losses, self.first, self.change, *ref, detail=True)
        limits = self.run.cell["limits"]
        return [dict(name=k, value=got[k], limit=v, median=got.get(k + "_median"))
                for k, v in limits.items()]
