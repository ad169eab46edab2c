"""Training loop: the ``train.py`` equivalent, on one CUDA device or many.

Port of ``smer_music_generation_tpu/train/loop.py`` (all of it):
``pad_batch_rows``, ``Trainer`` (``train_epoch``, ``evaluate``, ``run``,
``test``, the snapshot warm start of ``resume_from``) and ``main``.  The
reference call stack: 2 pretraining epochs (span corruption, eos weight 0.8)
then finetuning epochs (bar/track masks, eos weight 1.0), per-class losses
and accuracies every ``print_every`` steps, ReduceLROnPlateau on the epoch
train loss, a checkpoint per epoch, and a ``-x`` test mode computing loss
and accuracy on the held-out split.

    python -m smer_music_generation_tpu_torch.train.loop --train_batches ... \\
        --valid_batches ... [--device cpu]

The trainer runs on ``cuda`` unless ``--device cpu`` is given, in bf16 on
the card and f32 on the CPU (JAX computes in bf16 on the accelerator only).
It never moves to the CPU by itself: without a card it raises.  A step
that raises before the optimizer's update (forward, loss, backward,
gradient norm) is skipped and logged as ``step N failed: ...``, its batch
dropped and the state as it was, as JAX skips it; the port updates the
parameters in place, so an error from the update on propagates.

Multi-device training runs one process a device, as JAX's mesh of
``make_mesh(n_devices, tp, dcn_slices)`` (JAX :102-107, :152-158):

    torchrun --nproc_per_node N -m smer_music_generation_tpu_torch.train.loop \
        --n_devices N --tp T --dcn_slices K ...

The world size must equal the mesh's device count (``n_devices`` 0 means
every process of the world), or the Trainer raises.  Each rank builds the
same global batch, pads its rows to a multiple of ``dp * dcn`` and keeps its
own rows; tensor parallelism follows ``parallel.mesh._param_spec``
(``parallel/tensor_parallel.py``).  A process group started by the caller
is joined as it is (``nccl`` on the card, ``gloo`` on the CPU, or ``gloo``
with CUDA tensors); otherwise torchrun's environment starts one.  Rank 0
alone writes the log file, ``metrics.jsonl``, ``run.json``, ``config.json``
and the checkpoints, which hold the full (gathered) tensors.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from collections import defaultdict
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..data.loader import BatchLoader, LoaderConfig, Prefetcher
from ..data.masking import MaskingConfig
from ..data.pack import load_batches
from ..parallel.mesh import init_process_mesh, launched_world_size
from ..parallel.tensor_parallel import ShardContext, full_train_state, place_on_rows, shard_train_state
from ..utils.config import ExperimentConfig
from ..utils.logging import MetricsLogger, RunIdentity, logger_init
from ..utils.profiling import StepTimer
from ..vocab import WordVocab
from .checkpoint import restore_checkpoint, save_checkpoint
from .loss import build_loss_tables
from .state import (
    PlateauScheduler,
    StepSkipped,
    TrainState,
    build_model,
    make_eval_step,
    make_train_step,
    params_from_flax,
    read_flax_msgpack,
)


def pad_batch_rows(batch: Dict[str, np.ndarray], multiple: int) -> Dict[str, np.ndarray]:
    """Pad the batch (row) axis to a multiple of the data-parallel width;
    all-pad rows contribute nothing to the loss (pad targets are ignored)."""
    B = batch["input"].shape[0]
    target = int(np.ceil(B / multiple)) * multiple
    if target == B:
        return batch
    out = {}
    for k, v in batch.items():
        pad_val = True if v.dtype == bool else 0
        pad = np.full((target - B,) + v.shape[1:], pad_val, dtype=v.dtype)
        out[k] = np.concatenate([v, pad], axis=0)
    return out


def _to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """One device-to-host copy for a step's metrics: scalars as floats,
    vectors as numpy arrays."""
    scalars = [k for k, v in metrics.items() if v.dim() == 0]
    vectors = [k for k, v in metrics.items() if v.dim() > 0]
    flat = torch.cat([torch.stack([metrics[k].float() for k in scalars])]
                     + [metrics[k].float().reshape(-1) for k in vectors]).cpu().numpy()
    out: Dict[str, object] = {k: float(flat[i]) for i, k in enumerate(scalars)}
    at = len(scalars)
    for k in vectors:
        n = metrics[k].numel()
        out[k] = flat[at:at + n]
        at += n
    return out


def _mesh_world(cfg: ExperimentConfig) -> int:
    """The number of processes the configured mesh spans: 1 for one
    process, else the world, which must equal ``n_devices`` (0: all) and
    divide by ``tp * dcn_slices``."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else launched_world_size()
    n = cfg.n_devices or world
    if n != world:
        raise ValueError(
            f"the mesh asks for n_devices={n} devices, but the world has {world} processes: "
            f"launch one process a device (torchrun --nproc_per_node {n} ...)")
    if n % (cfg.tp * cfg.dcn_slices) != 0:
        raise ValueError(f"{n} devices not divisible by tp={cfg.tp} x dcn_slices={cfg.dcn_slices}")
    return n


class Trainer:
    def __init__(self, cfg: ExperimentConfig, logger=None, device="cuda"):
        import torch.distributed as dist

        world = _mesh_world(cfg)
        self.ctx = None
        if world > 1 or dist.is_initialized():
            if str(device) == "cuda":  # one card a process, by its local rank
                local = int(os.environ.get("LOCAL_RANK", "0"))
                if local >= torch.cuda.device_count():
                    raise RuntimeError(f"local rank {local} has no CUDA device "
                                       f"({torch.cuda.device_count()} visible)")
                device = f"cuda:{local}"
            self.ctx = ShardContext(init_process_mesh(
                cfg.tp, cfg.dcn_slices,
                backend="nccl" if torch.device(device).type == "cuda" else "gloo"))
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' (--device cpu) to train on the CPU")
        self.cfg = cfg
        self.lead = self.ctx is None or self.ctx.pm.rank == 0  # the rank that writes
        # append when re-entering an output_dir (resume or an existing run.json)
        self.logger = logger or logger_init(
            os.path.join(cfg.output_dir, "logging.log") if self.lead else None,
            append=bool(cfg.resume_from)
            or os.path.exists(os.path.join(cfg.output_dir, "run.json")),
        )
        run_id = None
        if self.lead:
            run_id = RunIdentity(cfg.output_dir, config=dataclasses.asdict(cfg),
                                 logger=self.logger).run_id
        self.metrics = MetricsLogger(
            os.path.join(cfg.output_dir, "metrics.jsonl") if self.lead else None, run_id=run_id)

        self.vocab = WordVocab(cfg.vocab_mode, cfg.control_list)
        dtype = torch.bfloat16 if cfg.bf16 and self.device.type == "cuda" else torch.float32
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            self.model = build_model(
                self.vocab.vocab_size,
                d_model=cfg.d_model,
                nhead=cfg.nhead,
                num_layers=cfg.num_layers,
                d_ff=cfg.d_ff,
                max_len=cfg.max_seq,
                dropout=cfg.dropout,
                dtype=dtype,
                flash_training=cfg.flash_training,
                remat=cfg.remat,
                bf16_attn_residual=cfg.bf16_attn_residual,
                fused_attn_bwd=cfg.fused_attn_bwd,
                fused_attn_train=cfg.fused_attn_train,
            )
        self.tables = build_loss_tables(
            self.vocab,
            head_scales=(
                {"tensile": cfg.tensile_weight}
                if cfg.tensile_weight != 1.0 else None
            ),
        )
        # the batch's rows pad to a multiple of the (dcn x dp) shards
        self.dp = 1 if self.ctx is None else self.ctx.row_shards
        self.start_epoch = 0
        if cfg.resume_from and os.path.isfile(cfg.resume_from):
            # params-only .msgpack snapshot: warm-start the weights with a
            # FRESH optimizer; the epoch always resets
            sidecar = cfg.resume_from + ".json"
            if os.path.isfile(sidecar):
                with open(sidecar) as fh:
                    snap_norm = json.load(fh).get("final_norm")
                model_norm = self.model.norm_e is not None
                if snap_norm is not None and bool(snap_norm) != model_norm:
                    raise ValueError(
                        f"snapshot {cfg.resume_from!r} was exported with "
                        f"final_norm={snap_norm} but the model was built "
                        f"with final_norm={model_norm}"
                    )
            self.model.load_state_dict(params_from_flax(
                read_flax_msgpack(cfg.resume_from), bf16_leaves_as_bits=True))
        self.model.to(self.device)
        self.state = TrainState.create(self.model, lr=cfg.lr)
        if cfg.resume_from and os.path.isfile(cfg.resume_from):
            self.logger.info(
                f"warm-started params from snapshot {cfg.resume_from} "
                "(fresh optimizer, epoch 0)"
            )
        elif cfg.resume_from:
            self.state, epoch, loss = restore_checkpoint(cfg.resume_from, self.state)
            self.start_epoch = 0 if cfg.reset_epoch else epoch + 1
            self.logger.info(f"resumed from {cfg.resume_from} (epoch {epoch}, loss {loss:.4f})")
        if self.ctx is not None:  # the full state, restored or fresh, placed on the mesh
            self.state = shard_train_state(self.state, self.ctx)

        self._train_step = make_train_step(self.model, self.tables, dropout=cfg.dropout > 0)
        # lean twin for non-logged steps under gated_metrics: same update,
        # no accuracy or per-module norms
        self._train_step_lean = (
            make_train_step(self.model, self.tables, dropout=cfg.dropout > 0, with_metrics=False)
            if cfg.gated_metrics
            else None
        )
        self._eval_step = make_eval_step(self.model, self.tables)
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 17)

    # ------------------------------------------------------------------
    def _device_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        batch = pad_batch_rows(batch, self.dp)
        if self.ctx is not None:
            batch = place_on_rows(batch, self.ctx)
        return {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device, non_blocking=True)
            for k, v in batch.items()
        }

    def make_loader(
        self, groups, pretraining: bool, seed_offset: int = 0,
        binned: bool = False,
    ) -> BatchLoader:
        cfg = self.cfg
        return BatchLoader(
            self.vocab,
            groups,
            LoaderConfig(
                batch_size=cfg.batch_size,
                max_src=cfg.max_seq,
                max_tgt=cfg.max_seq,
                pretraining=pretraining,
                bucket=cfg.seq_bucket,
                row_bucket=cfg.row_bucket,
                # binned batching applies to the train stream only: valid/
                # test keep the group-per-batch layout so their loss curves
                # stay comparable across runs
                bin_rows=binned,
                rows_per_batch=cfg.rows_per_batch,
            ),
            MaskingConfig(
                total_mask_ratio=cfg.total_mask_ratio,
                bar_track_control=cfg.bar_track_control,
                bar_control_at_end=cfg.bar_control_at_end,
            ),
            seed=cfg.seed + seed_offset,
        )

    # ------------------------------------------------------------------
    def train_epoch(self, loader: Iterable, eos_weight: float, epoch: int) -> float:
        self.model.train()
        losses = []
        grad_norms = []
        acc_correct = defaultdict(float)
        acc_count = defaultdict(float)
        names = self.tables["class_names"]
        timer = StepTimer("train_step")
        last_param_norm = float("nan")

        for step, batch in enumerate(Prefetcher(iter(loader), depth=2)):
            # logged steps must carry full metrics; everything else may
            # take the lean step (gated_metrics)
            logged = (
                step < 3
                or step % self.cfg.print_every == self.cfg.print_every - 1
            )
            step_fn = (
                self._train_step_lean
                if (self._train_step_lean is not None and not logged)
                else self._train_step
            )
            try:
                with timer:
                    self.state, m = step_fn(self.state, self._device_batch(batch), eos_weight,
                                            self._gen)
                    # the host copy waits for the device, so the timer brackets
                    # the step's execution, not its dispatch
                    m = _to_host(m)
            except StepSkipped as e:  # failure containment: skip the batch (JAX :262-266)
                err = e.__cause__
                self.logger.error(f"step {step} failed: {type(err).__name__}: {err}")
                continue
            losses.append(m["loss"])
            grad_norms.append(m["grad_norm"])
            if "param_norm" in m:
                last_param_norm = m["param_norm"]
                for n, c, k in zip(names, m["correct_per_class"], m["count_per_class"]):
                    acc_correct[n] += float(c)
                    acc_count[n] += float(k)
            if logged:
                record = {
                    "epoch": epoch,
                    "train_loss": float(np.mean(losses[-self.cfg.print_every:])),
                    "total_accuracy": m["accuracy"],
                    "lr": float(self.state.lr),
                }
                record.update({
                    k: float(v) for k, v in m.items()
                    if k.startswith(("loss/", "gnorm/", "pnorm/")) or k in ("grad_norm", "param_norm")
                })
                self.metrics.log(record, step=int(self.state.step))
                self.logger.info(
                    f"epoch {epoch + 1} step {step + 1}: loss {record['train_loss']:.4f} "
                    f"acc {record['total_accuracy']:.4f}"
                )
        for n in names:
            if acc_count[n] > 0:
                self.metrics.log(
                    {f"ave_epoch_train_{n}_acc": acc_correct[n] / acc_count[n], "epoch": epoch},
                    step=int(self.state.step),
                )
        if timer.durations:
            self.metrics.log({**timer.summary(), "epoch": epoch}, step=int(self.state.step))
        if grad_norms:
            self.metrics.log(
                {
                    "epoch_grad_norm_mean": float(np.mean(grad_norms)),
                    "epoch_grad_norm_max": float(np.max(grad_norms)),
                    "epoch_param_norm": last_param_norm,
                    "epoch": epoch,
                },
                step=int(self.state.step),
            )
        return float(np.mean(losses)) if losses else float("inf")

    def evaluate(self, loader: Iterable, eos_weight: float) -> Dict[str, float]:
        self.model.eval()
        losses = []
        head_losses = defaultdict(list)
        correct = defaultdict(float)
        count = defaultdict(float)
        names = self.tables["class_names"]
        # collation of batch k+1 proceeds while the device runs eval step k
        for batch in Prefetcher(iter(loader), depth=2):
            m = _to_host(self._eval_step(self._device_batch(batch), eos_weight))
            losses.append(m["loss"])
            for k, v in m.items():
                if k.startswith("loss/"):
                    head_losses[k].append(float(v))
            for n, c, k in zip(names, m["correct_per_class"], m["count_per_class"]):
                correct[n] += float(c)
                count[n] += float(k)
        out = {"total": float(np.mean(losses)) if losses else float("inf")}
        for k, v in head_losses.items():
            out[k.split("/", 1)[1]] = float(np.mean(v))
        for n in names:
            if count[n] > 0:
                out[f"{n}_accuracy"] = correct[n] / count[n]
        return out

    # ------------------------------------------------------------------
    def run(self, train_groups, valid_groups) -> None:
        cfg = self.cfg
        if self.lead:
            os.makedirs(cfg.output_dir, exist_ok=True)
            cfg.save(os.path.join(cfg.output_dir, "config.json"))
        scheduler = PlateauScheduler()

        for epoch in range(self.start_epoch, cfg.epochs):
            pretraining = epoch < cfg.pretraining_epochs
            eos_weight = cfg.eos_weight if pretraining else 1.0
            phase = "pretraining" if pretraining else "finetuning"
            self.logger.info(f"{phase} epoch {epoch + 1}/{cfg.epochs}")

            train_loader = self.make_loader(
                train_groups, pretraining, seed_offset=epoch,
                binned=cfg.binned_batching,
            )
            valid_loader = self.make_loader(valid_groups, pretraining, seed_offset=1000 + epoch)

            train_loss = self.train_epoch(train_loader, eos_weight, epoch)
            val = self.evaluate(valid_loader, eos_weight)
            for k, v in val.items():
                self.metrics.log({f"val_{k}": v, "epoch": epoch}, step=int(self.state.step))
            self.logger.info(
                f"epoch {epoch + 1}: train {train_loss:.4f} valid {val['total']:.4f}"
            )

            new_lr = scheduler.update(float(self.state.lr), train_loss)
            if new_lr != float(self.state.lr):
                self.logger.info(f"plateau: lr -> {new_lr}")
                self.state.lr = new_lr

            self.save(epoch, val["total"])

    def save(self, epoch: int, loss: float) -> Optional[str]:
        """Checkpoint the state as ``checkpoint_<epoch>``; under a mesh every
        rank gathers the full tensors (a collective) and rank 0 writes.
        Returns the path where this rank wrote, else None."""
        full = None if self.ctx is None else full_train_state(self.state, self.ctx)
        if not self.lead:
            return None
        path = save_checkpoint(os.path.join(self.cfg.output_dir, self.cfg.checkpoint_dir), epoch,
                               self.state, loss, full)
        self.logger.info(f"saved {path}")
        return path

    def test(self, test_groups) -> Dict[str, float]:
        loader = self.make_loader(test_groups, pretraining=False, seed_offset=31337)
        result = self.evaluate(loader, eos_weight=1.0)
        for k, v in result.items():
            self.logger.info(f"test {k}: {v:.4f}")
        return result


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; bf16 when --no_bf16 is not given) or cpu (f32)")
    args, rest = parser.parse_known_args(argv)
    cfg = ExperimentConfig.from_args(rest)
    trainer = Trainer(cfg, device=args.device)
    if cfg.is_test:
        groups, _ = load_batches(cfg.test_batches)
        trainer.test(groups)
    else:
        train_groups, _ = load_batches(cfg.train_batches)
        valid_groups, _ = load_batches(cfg.valid_batches)
        trainer.run(train_groups, valid_groups)


if __name__ == "__main__":
    main()
