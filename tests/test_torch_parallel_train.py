"""The port's sharded training against its single-process step and JAX's
sharded step, on the CPU.

- Train steps at dp2, dp2 x tp2 and dcn2 x dp2, each rank a ``spawn``
  process over ``gloo`` (a ``file://`` store under ``tmp_path``, so xdist
  workers share no port; a time limit a test, past which the processes are
  killed and the test fails): with dropout 0.1, loss within rtol 2e-5 and
  grad norm (and each module's) within 2e-4 of the port's single-process
  step, JAX's tolerances (the dropout bits are the single-process step's:
  a control with other bits lands outside); with dropout 0 and JAX's
  weights, the same against JAX's sharded step on as many virtual devices.
  At tp2 a model whose vocab divides by tp gathers its column-parallel
  logits within 1e-5 of the unsharded ones.
- ``Trainer`` on two processes at tp=2: its loss against the single-process
  Trainer's, and its checkpoint, written by rank 0 with the full tensors,
  loads into the unsharded model.
"""

import multiprocessing
import os
import queue
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smer_music_generation_tpu.parallel import mesh as jmesh
from smer_music_generation_tpu.train.loss import build_loss_tables as jbuild_loss_tables
from smer_music_generation_tpu.train.state import TrainState as JTrainState
from smer_music_generation_tpu.train.state import build_model as jbuild_model
from smer_music_generation_tpu.train.state import make_train_step as jmake_train_step
from smer_music_generation_tpu.vocab import CONTROL_SETS, WordVocab
from smer_music_generation_tpu_torch.train.checkpoint import restore_params_only
from smer_music_generation_tpu_torch.train.state import build_model, params_from_flax
from smer_music_generation_tpu_torch.vocab import WordVocab as TWordVocab
from tests import torch_parallel_workers as workers

TIME_LIMIT_S = 150  # a test's processes, spawn and import included


def _run_ranks(target, world, tmp_path, *args):
    """``target(rank, world, store, *args, queue)`` in ``world`` spawned
    processes; their results by rank.  A process that has not reported
    within the test's time limit fails the test, and every process still
    alive then is killed."""
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=target, args=(r, world, store, *args, q), daemon=True)
             for r in range(world)]
    deadline = time.monotonic() + TIME_LIMIT_S
    results = {}
    try:
        for p in procs:
            p.start()
        while len(results) < world:
            try:
                rank, status, value = q.get(timeout=2.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs if not p.is_alive()]
                if dead or time.monotonic() > deadline:
                    pytest.fail(f"ranks {sorted(set(range(world)) - set(results))} did not report "
                                f"within {TIME_LIMIT_S} s or exited first (exit codes {dead})")
                continue
            assert status == "ok", f"rank {rank}:\n{value}"
            results[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
            assert not p.is_alive(), "a rank did not exit"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return results


def _jax_sharded_step(world, tp, dcn, batch):
    """JAX's sharded train step (``tests/test_parallel.py::_run_step``) at
    dropout 0 on ``world`` virtual devices; returns (its metrics, its
    initial params as the port's state dict)."""
    vocab = WordVocab(0, CONTROL_SETS[5])
    jmodel = jbuild_model(vocab.vocab_size, dropout=0.0, **workers.DIMS)
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.ones((8, 64), jnp.int32),
                         jnp.ones((8, 32), jnp.int32))
    state = JTrainState.create(params, lr=1e-4)
    step_fn = jmake_train_step(jmodel, jbuild_loss_tables(vocab), dropout=True)
    m = jmesh.make_mesh(world, tp=tp, dcn_slices=dcn)
    state_shard = jmesh.train_state_shardings(m, state)
    data_shard = jmesh.batch_sharding(m)
    with m:
        jit_step = jax.jit(step_fn, in_shardings=(state_shard, {k: data_shard for k in batch}, None, None),
                           out_shardings=(state_shard, None))
        _, metrics = jit_step(jax.device_put(state, state_shard),
                              jax.device_put({k: np.asarray(v) for k, v in batch.items()}, data_shard),
                              jnp.float32(workers.EOS_WEIGHT), jax.random.PRNGKey(7))
    sd = params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    return jax.device_get(metrics), {k: v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize("world,tp,dcn", [(2, 1, 1), (4, 2, 1), (4, 1, 2)],
                         ids=["dp2", "dp2tp2", "dcn2xdp2"])
def test_sharded_train_step_matches_single_process(tmp_path, world, tp, dcn):
    batch = workers.make_batch()
    jmetrics, jparams = _jax_sharded_step(world, tp, dcn, batch)
    results = _run_ranks(workers.sharded_step, world, tmp_path, tp, dcn, jparams)
    torch.set_num_threads(1)
    ref = workers.run_step(workers.make_state(0.1), batch)
    for rank, out in results.items():
        got = out["dropout"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=2e-5)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=2e-4)
        gnorms = [k for k in ref if k.startswith("gnorm/")]
        assert len(gnorms) == 8  # embedding, 2 + 2 layers, fc, norm_e, norm_d
        for k in gnorms:
            np.testing.assert_allclose(got[k], ref[k], rtol=2e-4, err_msg=k)
        np.testing.assert_allclose(out["jax"]["loss"], float(jmetrics["loss"]), rtol=2e-5)
        np.testing.assert_allclose(out["jax"]["grad_norm"], float(jmetrics["grad_norm"]), rtol=2e-4)
        if tp > 1:
            assert out["logits_err"] < 1e-5
    # a control: other dropout bits land far outside the tolerance
    other = workers.run_step(workers.make_state(0.1), batch, gen_seed=8)
    assert abs(other["loss"] - ref["loss"]) > 1e-3 * ref["loss"]


def test_trainer_tp2_loss_and_full_checkpoint(tmp_path):
    """Two processes at tp=2 through ``Trainer``: the mean loss of two
    steps within rtol 2e-5 of the single-process Trainer's, and rank 0's
    checkpoint holds full tensors that load into the unsharded model,
    within two Adam steps (2 x lr) of the single-process Trainer's."""
    cfg_kw = dict(d_model=64, nhead=4, num_layers=1, d_ff=128, max_seq=128, tp=2)
    results = _run_ranks(workers.trainer_run, 2, tmp_path, 2, 1, cfg_kw, str(tmp_path / "tp2"))
    torch.set_num_threads(1)
    ref = workers.trainer_steps({**cfg_kw, "tp": 1}, str(tmp_path / "one"))
    assert results[0]["lead"] and not results[1]["lead"] and results[1]["path"] is None
    np.testing.assert_allclose(results[0]["loss"], ref["loss"], rtol=2e-5)
    got, epoch = restore_params_only(results[0]["path"])
    want, _ = restore_params_only(ref["path"])
    assert epoch == 0 and set(got) == set(want)
    model = build_model(TWordVocab(0, CONTROL_SETS[5]).vocab_size, d_model=64, nhead=4,
                        num_layers=1, d_ff=128, max_len=128)
    model.load_state_dict(got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=2e-4, err_msg=k)
    assert os.path.isfile(tmp_path / "tp2" / "metrics.jsonl")
