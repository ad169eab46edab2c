"""Worker processes of ``tests/test_torch_parallel.py``: sharded training of
the PyTorch port over ``torch.distributed`` with the ``gloo`` backend on the
CPU, one process a mesh device.

Imports no JAX (each worker starts from a fresh ``spawn`` import).  The
test process builds the single-process references with the same helpers.
Every worker joins a ``file://`` store of its test's own and reports
``(rank, "ok", result)`` or ``(rank, "error", traceback)`` on the queue.
"""

from __future__ import annotations

import traceback
from typing import Dict, Optional

import numpy as np
import torch

from smer_music_generation_tpu_torch.train.loss import build_loss_tables
from smer_music_generation_tpu_torch.train.state import TrainState, build_model, make_train_step
from smer_music_generation_tpu_torch.vocab import CONTROL_SETS, WordVocab

DIMS = dict(d_model=64, nhead=4, num_layers=2, d_ff=128, max_len=128)  # tests/test_parallel.py
B, S, T = 8, 64, 32
EOS_WEIGHT = 0.8
GEN_SEED = 7


def vocab() -> WordVocab:
    return WordVocab(0, CONTROL_SETS[5])


def make_batch(seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded tokens with rows of different lengths, so that the shards
    hold different numbers of real tokens (the global-denominator trap)."""
    rng = np.random.default_rng(seed)
    V = vocab().vocab_size
    src = rng.integers(3, V, size=(B, S)).astype(np.int32)
    tgt = rng.integers(3, V, size=(B, T + 1)).astype(np.int32)
    src_len = rng.integers(S // 4, S + 1, size=B)
    tgt_len = rng.integers(2, T + 1, size=B)
    src_pad = np.arange(S)[None, :] >= src_len[:, None]
    tgt_pad = np.arange(T)[None, :] >= tgt_len[:, None]
    src[src_pad] = 0
    t_in, t_out = tgt[:, :T].copy(), tgt[:, 1:].copy()
    t_in[tgt_pad] = 0
    t_out[tgt_pad] = 0
    return {"input": src, "target_in": t_in, "target_out": t_out,
            "input_pad_mask": src_pad, "target_pad_mask": tgt_pad}


def make_state(dropout: float, params: Optional[Dict[str, np.ndarray]] = None,
               seed: int = 0, **kw) -> TrainState:
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_model(vocab().vocab_size, dropout=dropout, **DIMS, **kw)
    if params is not None:
        model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    return TrainState.create(model, lr=1e-4)


def run_step(state: TrainState, batch: Dict[str, np.ndarray], ctx=None,
             gen_seed: int = GEN_SEED) -> Dict[str, object]:
    """One train step on ``batch`` (this rank's rows under ``ctx``): its
    loss, grad norm and per-module gradient norms as floats."""
    from smer_music_generation_tpu_torch.parallel.tensor_parallel import place_on_rows
    from smer_music_generation_tpu_torch.train.loop import pad_batch_rows

    if ctx is not None:
        batch = place_on_rows(pad_batch_rows(batch, ctx.row_shards), ctx)
    dev = state.model.device
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}
    step = make_train_step(state.model, build_loss_tables(vocab()), dropout=True)
    gen = torch.Generator(device=dev).manual_seed(gen_seed)
    _, m = step(state, tensors, EOS_WEIGHT, gen)
    return {k: float(v) for k, v in m.items() if v.dim() == 0}


def join_mesh(rank: int, world: int, store: str, tp: int, dcn: int):
    import torch.distributed as dist

    from smer_music_generation_tpu_torch.parallel.mesh import init_process_mesh
    from smer_music_generation_tpu_torch.parallel.tensor_parallel import ShardContext

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    return ShardContext(init_process_mesh(tp, dcn))


def sharded_step(rank, world, store, tp, dcn, jax_params, q):
    """The dropout-0.1 step of a seeded model, and the dropout-0 step of
    JAX's parameters, each on this rank's rows and tp part; rank 0 also
    reports the column-parallel logits check (``_gathered_logits``)."""
    import torch.distributed as dist

    try:
        ctx = join_mesh(rank, world, store, tp, dcn)
        from smer_music_generation_tpu_torch.parallel.tensor_parallel import shard_train_state

        batch = make_batch()
        out = {"dropout": run_step(shard_train_state(make_state(0.1), ctx), batch, ctx),
               "jax": run_step(shard_train_state(make_state(0.0, jax_params), ctx), batch, ctx)}
        if tp > 1:
            out["logits_err"] = _gathered_logits(ctx)
        q.put((rank, "ok", out))
    except BaseException:
        q.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _gathered_logits(ctx) -> float:
    """The largest |logit difference| of a model whose vocab divides by tp
    (so its logit ``fc`` is column-parallel, gathered) against the same
    model unsharded, over a deterministic forward."""
    from smer_music_generation_tpu_torch.models.transformer import ModelConfig, ScoreTransformer
    from smer_music_generation_tpu_torch.parallel.tensor_parallel import shard_train_state

    cfg = ModelConfig(vocab_size=64, d_model=64, nhead=4, num_encoder_layers=1,
                      num_decoder_layers=1, d_ff=128, max_len=64, dropout=0.0, pos_dropout=0.0)
    torch.manual_seed(3)
    full = ScoreTransformer(cfg)
    part = ScoreTransformer(cfg)
    part.load_state_dict(full.state_dict())
    st = shard_train_state(TrainState.create(part, lr=1e-4), ctx)
    assert part.fc.tp_mode == "col_gather" and "fc.weight" in st.sharded
    src = torch.randint(1, 64, (2, 16), generator=torch.Generator().manual_seed(1))
    want, _ = full(src, src)
    got, _ = part(src, src)
    return float((got - want).abs().max())


def trainer_run(rank, world, store, tp, dcn, cfg_kw, out_dir, q):
    """Two train steps through ``Trainer.train_epoch`` and a checkpoint
    through ``Trainer.save``, on a mesh of ``world`` processes."""
    import torch.distributed as dist

    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
        q.put((rank, "ok", trainer_steps(cfg_kw, out_dir)))
    except BaseException:
        q.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def trainer_steps(cfg_kw, out_dir) -> Dict[str, object]:
    """The Trainer's mean loss over two steps of one batch, and the path of
    the checkpoint it saves (None on a rank that does not write)."""
    from smer_music_generation_tpu_torch.train.loop import Trainer
    from smer_music_generation_tpu_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig(output_dir=out_dir, **cfg_kw)
    trainer = Trainer(cfg, device="cpu")
    batch = make_batch(1)
    loss = trainer.train_epoch([batch, batch], cfg.eos_weight, 0)
    return {"loss": loss, "path": trainer.save(0, 1.5), "lead": trainer.lead}
