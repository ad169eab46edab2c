"""The port's training path against the JAX package, on the CPU.

- The model and the step on a small f32 config (d_model 32, 4 heads, 2 + 2
  layers, random biases and LayerNorms) with the same weights, carried
  across by ``params_from_flax``: deterministic logits and cross weights of
  ``forward`` against ``model.apply`` (atol 1e-5: f32 sums in another
  order); at dropout 0 the loss (rtol 1e-6) and every gradient leaf against
  JAX's ``value_and_grad`` of the train step's loss (each leaf within 1e-5
  of the largest gradient of its leaf, 4.7e-6 observed, or 1e-7 absolute: the key
  projection's bias has a gradient that is zero in exact arithmetic and
  float noise on both sides); one Adam update fed the same gradients
  against optax's (rtol 1e-6); ``PlateauScheduler`` over the same losses;
  the loss tables and ``per_class_accuracy`` exactly.
- A bf16 config with ``fused_attn_train`` on and off (the twins on the
  CPU): deterministic logits equal, train-mode loss and gradients finite.
- The data path: ``process_song`` windows, ``pack_windows`` groups and
  ``BatchLoader`` batches (plain and binned) equal to JAX's for the same
  seeds.
- ``Trainer``: two tiny epochs through ``main`` on the CPU write checkpoints
  that restore (and refuse a final_norm mismatch); snapshots round-trip
  through JAX's ``import_params_msgpack`` and the port's loader; an
  overfit run on one batch lowers the loss.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from smer_music_generation_tpu.codec import midi as jmidi
from smer_music_generation_tpu.codec.smer import midi_to_events as jmidi_to_events
from smer_music_generation_tpu.data.build import process_song as jprocess_song
from smer_music_generation_tpu.data.loader import BatchLoader as JBatchLoader
from smer_music_generation_tpu.data.loader import LoaderConfig as JLoaderConfig
from smer_music_generation_tpu.data.masking import MaskingConfig as JMaskingConfig
from smer_music_generation_tpu.data.pack import pack_windows as jpack_windows
from smer_music_generation_tpu.models.transformer import ModelConfig as JModelConfig
from smer_music_generation_tpu.models.transformer import ScoreTransformer as JScoreTransformer
from smer_music_generation_tpu.train import loss as jloss
from smer_music_generation_tpu.train.checkpoint import import_params_msgpack
from smer_music_generation_tpu.train.state import PlateauScheduler as JPlateau
from smer_music_generation_tpu.vocab import CONTROL_SETS
from smer_music_generation_tpu.vocab import WordVocab as JWordVocab
from smer_music_generation_tpu_torch.codec import midi as pmidi
from smer_music_generation_tpu_torch.codec.smer import midi_to_events
from smer_music_generation_tpu_torch.data.build import process_song
from smer_music_generation_tpu_torch.data.loader import BatchLoader, LoaderConfig
from smer_music_generation_tpu_torch.data.masking import MaskingConfig
from smer_music_generation_tpu_torch.data.pack import pack_windows, save_batches
from smer_music_generation_tpu_torch.models.transformer import ModelConfig, ScoreTransformer
from smer_music_generation_tpu_torch.ops import train_attention as ta
from smer_music_generation_tpu_torch.train import loop
from smer_music_generation_tpu_torch.train import state as state_mod
from smer_music_generation_tpu_torch.train.checkpoint import (
    checkpoint_has_final_norm,
    export_params_msgpack,
    latest_checkpoint,
    restore_checkpoint,
    restore_params_only,
)
from smer_music_generation_tpu_torch.train.loss import build_loss_tables, multihead_ce, per_class_accuracy
from smer_music_generation_tpu_torch.train.state import (
    PlateauScheduler,
    TrainState,
    build_model,
    load_inference_model,
    make_eval_step,
    make_optimizer,
    make_train_step,
    params_from_flax,
    params_to_flax,
    read_flax_msgpack,
)
from smer_music_generation_tpu_torch.utils.config import ExperimentConfig
from smer_music_generation_tpu_torch.vocab import WordVocab
from tests.torch_port_helpers import perturb_affine

DIMS = dict(d_model=32, nhead=4, num_encoder_layers=2, num_decoder_layers=2, d_ff=64, max_len=512)


@pytest.fixture(scope="module")
def vocab():
    return WordVocab(0, CONTROL_SETS[5])


@pytest.fixture(scope="module")
def pair(vocab):
    """(jax model, jax params, port model) with the same f32 weights, dropout 0."""
    V = vocab.vocab_size
    jm = JScoreTransformer(JModelConfig(vocab_size=V, dropout=0.0, pos_dropout=0.0, **DIMS))
    params = perturb_affine(jm.init({"params": jax.random.PRNGKey(0)},
                                    jnp.ones((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32)), 0)
    tm = ScoreTransformer(ModelConfig(vocab_size=V, dropout=0.0, pos_dropout=0.0, **DIMS))
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _batch(V, B=3, S=40, T=24, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(3, V, (B, S)).astype(np.int32)
    tgt = rng.integers(3, V, (B, T)).astype(np.int32)
    spm = np.zeros((B, S), bool)
    spm[1, 30:] = True
    spm[2, 10:] = True
    tpm = np.zeros((B, T), bool)
    tpm[1, 20:] = True
    tout = rng.integers(3, V, (B, T)).astype(np.int32)
    tout[tpm] = 0
    src[spm] = 0
    tgt[tpm] = 0
    return {"input": src, "target_in": tgt, "target_out": tout,
            "input_pad_mask": spm, "target_pad_mask": tpm}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def test_forward_logits_and_cross_weights_against_jax(pair, vocab):
    jm, params, tm = pair
    b = _batch(vocab.vocab_size)
    jl, jw = jm.apply(params, b["input"], b["target_in"], src_pad_mask=b["input_pad_mask"],
                      tgt_pad_mask=b["target_pad_mask"], deterministic=True)
    t = _tb(b)
    with torch.no_grad():
        tl, tw = tm(t["input"], t["target_in"], t["input_pad_mask"], t["target_pad_mask"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)
    assert tw.shape == (3, 2, 24, 40)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)


def test_loss_and_gradients_at_dropout_0_against_jax(pair, vocab):
    jm, params, tm = pair
    b = _batch(vocab.vocab_size, seed=1)
    jt = jloss.build_loss_tables(JWordVocab(0, CONTROL_SETS[5]))

    def loss_fn(p):  # the loss of JAX's make_train_step (train/state.py:268-279)
        logits, _ = jm.apply(p, b["input"], b["target_in"], src_pad_mask=b["input_pad_mask"],
                             tgt_pad_mask=b["target_pad_mask"], deterministic=False,
                             rngs={"dropout": jax.random.PRNGKey(1)})
        return jloss.multihead_ce(logits, b["target_out"], jt, 0.8)[0]

    jl, jg = jax.value_and_grad(loss_fn)(params)

    model = ScoreTransformer(tm.cfg)
    model.load_state_dict(tm.state_dict())
    state = TrainState.create(model, lr=1e-4)
    step = make_train_step(model, build_loss_tables(vocab))
    state, m = step(state, _tb(b), 0.8, torch.Generator().manual_seed(0))
    assert state.step == 1
    np.testing.assert_allclose(float(m["loss"]), float(jl), rtol=1e-6)
    grads = params_to_flax({n: p.grad for n, p in model.named_parameters()})
    leaves = jax.tree_util.tree_leaves_with_path(jg)
    assert len(leaves) == len(list(model.parameters()))
    for path, a in leaves:
        a = np.asarray(a)
        got = _leaf(grads, path)
        np.testing.assert_allclose(got, a, rtol=0, atol=max(1e-5 * np.abs(a).max(), 1e-7),
                                   err_msg=str([k.key for k in path]))
    gn = np.sqrt(sum(float(np.sum(np.square(np.asarray(x)))) for x in jax.tree.leaves(jg)))
    np.testing.assert_allclose(float(m["grad_norm"]), gn, rtol=1e-5)
    assert set(k for k in m if k.startswith("gnorm/")) == {
        f"gnorm/{k}" for k in params["params"]}


def test_adam_update_against_optax():
    rng = np.random.default_rng(5)
    p0 = {"a": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) * s for k, v in p0.items()}
             for s in (1.0, 1e-3)]
    lr = 3e-4
    tx = optax.chain(optax.scale_by_adam(), optax.scale(-1.0))
    jp, opt = {k: jnp.asarray(v) for k, v in p0.items()}, None
    opt = tx.init(jp)
    tparams = [torch.nn.Parameter(torch.from_numpy(p0[k].copy())) for k in ("a", "b")]
    adam = make_optimizer(tparams)
    for g in grads:
        upd, opt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda u: u * lr, upd))
        for p, k in zip(tparams, ("a", "b")):
            p.grad = torch.from_numpy(g[k].copy())
        for group in adam.param_groups:
            group["lr"] = lr
        adam.step()
    for p, k in zip(tparams, ("a", "b")):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def test_plateau_scheduler_against_jax():
    losses = [5.0, 4.0, 4.0, 3.9999, 4.1, 4.2, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0]
    j, t = JPlateau(), PlateauScheduler()
    lj = lt = 1e-4
    for x in losses:
        lj, lt = j.update(lj, x), t.update(lt, x)
        assert lj == lt
    assert lt < 1e-4


def test_loss_tables_and_accuracy_against_jax(vocab):
    jt = jloss.build_loss_tables(JWordVocab(0, CONTROL_SETS[5]), head_scales={"tensile": 3.0})
    tt = build_loss_tables(vocab, head_scales={"tensile": 3.0})
    assert jt["heads"] == tt["heads"]
    for key in ("head_weights", "ce_all", "eos_onehot", "class_ids"):
        assert np.array_equal(jt[key], tt[key]), key
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 20, vocab.vocab_size)).astype(np.float32)
    targets = rng.integers(0, vocab.vocab_size, (3, 20)).astype(np.int32)
    targets[0, :5] = vocab.pad_index
    targets[1, 3] = int(np.argmax(logits[1, 3]))
    want = jloss.per_class_accuracy(jnp.asarray(logits), jnp.asarray(targets), jt)
    got = per_class_accuracy(torch.from_numpy(logits), torch.from_numpy(targets), tt)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy().astype(np.float32), np.asarray(b, np.float32))
    jl, jh = jloss.multihead_ce(jnp.asarray(logits), jnp.asarray(targets), jt, 0.8)
    tl, th = multihead_ce(torch.from_numpy(logits), torch.from_numpy(targets), tt, 0.8)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for k in jh:
        np.testing.assert_allclose(float(th[k]), float(jh[k]), rtol=1e-5, atol=1e-7)
    w = jloss.soft_label_weights(vocab.vocab_size, (146, 233))
    from smer_music_generation_tpu_torch.train.loss import ordinal_loss, soft_label_weights

    assert np.array_equal(soft_label_weights(vocab.vocab_size, (146, 233)), w)
    np.testing.assert_allclose(
        float(ordinal_loss(torch.from_numpy(logits), torch.from_numpy(targets), w)),
        float(jloss.ordinal_loss(jnp.asarray(logits), jnp.asarray(targets), w)), rtol=1e-6)


def test_bf16_model_with_fused_attn_train_on_and_off(vocab):
    """Mirrors tests/test_ops.py:658-705: deterministic logits are equal (the
    kernels are inert there); in train mode the fused model routes every
    attention through the twins (CPU) and its loss and gradients are finite."""
    V = 64
    base = ModelConfig(vocab_size=V, d_model=32, nhead=4, num_encoder_layers=2,
                       num_decoder_layers=2, d_ff=64, max_len=512, dropout=0.1,
                       pos_dropout=0.1, dtype=torch.bfloat16)
    rng = np.random.default_rng(2)
    src = torch.from_numpy(rng.integers(1, V, (2, 256))).long()
    tgt = torch.from_numpy(rng.integers(1, V, (2, 256))).long()
    spm = torch.zeros(2, 256, dtype=torch.bool)
    spm[:, 200:] = True
    tpm = torch.zeros(2, 256, dtype=torch.bool)
    tpm[:, 180:] = True
    torch.manual_seed(0)
    ref = ScoreTransformer(base)
    results = {}
    for fused in (True, False):
        m = ScoreTransformer(dataclasses.replace(base, fused_attn_train=fused))
        m.load_state_dict(ref.state_dict())
        with torch.no_grad():
            ld = (m(src, tgt, spm, tpm)[0] ** 2).mean()
        ta.reset_counts()
        logits, w = m(src, tgt, spm, tpm, deterministic=False,
                      generator=torch.Generator().manual_seed(7))
        loss = (logits ** 2).mean()
        loss.backward()
        calls = (ta.dropout_attention_fwd_reference.calls, ta.dropout_attention_bwd_reference.calls)
        assert calls == ((6, 6) if fused else (0, 0))
        assert (w is None) == fused
        gn = sum(float(p.grad.float().pow(2).sum()) for p in m.parameters())
        assert np.isfinite(gn) and gn > 0
        results[fused] = (loss.item(), ld.item())
    assert results[True][1] == results[False][1]
    assert abs(results[True][0] - results[False][0]) / results[False][0] < 0.05


def test_not_ported_options_raise():
    """The name is kept from when multi-device training raised.  It is
    ported (``tests/test_torch_parallel.py``): a mesh that a world of one
    process cannot hold raises the mismatch before any process group."""
    with pytest.raises(ValueError, match="not divisible by tp=2"):
        loop.Trainer(ExperimentConfig(tp=2), device="cpu")
    with pytest.raises(ValueError, match="world has 1 processes"):
        loop.Trainer(ExperimentConfig(n_devices=2), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            loop.Trainer(ExperimentConfig(d_model=32, nhead=4, num_layers=1, d_ff=64), device="cuda")
    m = ScoreTransformer(ModelConfig(vocab_size=16, d_model=8, nhead=2, d_ff=16))
    with pytest.raises(ValueError, match="Generator"):
        m(torch.ones(1, 4).long(), torch.ones(1, 4).long(), deterministic=False)


# ----------------------------------------------------------------------
# data
# ----------------------------------------------------------------------
def _score(mod, bars=32, tracks=2, seed=7, tempo=100.0):
    """A seeded 4/4 score of random sixteenth-grid notes and chords, built
    from one package's MIDI classes: ``chip_smoke.make_score``, whose
    32-bar, 2-track score phase 5 trains on."""
    rng = np.random.default_rng(seed)
    s = mod.MidiScore(initial_tempo=tempo)
    s.time_signature_changes = [mod.TimeSignature(4, 4, 0.0)]
    sixteenth = 60.0 / tempo / 4
    for t in range(tracks):
        inst = mod.Instrument(program=[0, 32, 48][t])
        for bar in range(bars):
            slot = 0
            while slot < 16:
                if rng.random() < 0.5:
                    length = min(int(rng.integers(1, 5)), 16 - slot)
                    start = (bar * 16 + slot) * sixteenth
                    pitch = int(rng.integers(40, 90))
                    inst.notes.append(mod.Note(100, pitch, start, start + length * sixteenth))
                    if rng.random() < 0.3:
                        inst.notes.append(mod.Note(100, min(pitch + 4, 108), start,
                                                   start + length * sixteenth))
                    slot += length
                else:
                    slot += 1
        s.instruments.append(inst)
    return s


@pytest.fixture(scope="module")
def windows():
    jw = jprocess_song(jmidi_to_events(_score(jmidi))[0], augment=True,
                       rng=np.random.default_rng(3))
    pw = process_song(midi_to_events(_score(pmidi))[0], augment=True,
                      rng=np.random.default_rng(3))
    return jw, pw


def test_process_song_and_pack_windows_against_jax(windows):
    jw, pw = windows
    assert len(pw) >= 3 and pw == jw
    jg, jl = jpack_windows(jw * 2, max_token_length=1500)
    pg, pl = pack_windows(pw * 2, max_token_length=1500)
    assert pg == jg and pl == jl


@pytest.mark.parametrize("binned", [False, True])
@pytest.mark.parametrize("pretraining", [True, False])
def test_batch_loader_against_jax(windows, vocab, binned, pretraining):
    groups, _ = pack_windows(windows[1] * 2, max_token_length=1500)
    kw = dict(batch_size=1, bucket=256, pretraining=pretraining, bin_rows=binned, rows_per_batch=2)
    jb = list(JBatchLoader(JWordVocab(0, CONTROL_SETS[5]), groups, JLoaderConfig(**kw),
                           JMaskingConfig(), seed=5))
    pb = list(BatchLoader(vocab, groups, LoaderConfig(**kw), MaskingConfig(), seed=5))
    assert len(pb) == len(jb) > 0
    for a, b in zip(pb, jb):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k


# ----------------------------------------------------------------------
# the trainer, checkpoints and snapshots
# ----------------------------------------------------------------------
def _tiny(tmp_path, **kw):
    return ExperimentConfig(
        d_model=32, nhead=4, num_layers=1, d_ff=64, max_seq=1408, epochs=2,
        pretraining_epochs=1, batch_size=1, print_every=1, output_dir=str(tmp_path),
        dropout=0.1, **kw,
    )


def test_trainer_main_two_epochs_checkpoints_and_restore(windows, tmp_path):
    groups, lengths = pack_windows(windows[1], max_token_length=1500)
    prefix = str(tmp_path / "data")
    save_batches(groups, lengths, prefix)
    out = tmp_path / "run"
    loop.main(["--device", "cpu", "--train_batches", prefix, "--valid_batches", prefix,
               "-e", "2", "--pretraining_epochs", "1", "--d_model", "32", "--nhead", "4",
               "--num_layers", "1", "--batch_size", "1", "--print_every", "1",
               "--output_dir", str(out)])
    ckpt_dir = out / "checkpoints"
    latest = latest_checkpoint(str(ckpt_dir))
    assert latest is not None and latest.endswith("checkpoint_1")
    assert os.path.isdir(ckpt_dir / "checkpoint_0")
    records = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert any("train_loss" in r for r in records) and any("val_total" in r for r in records)
    assert checkpoint_has_final_norm(latest) is True

    cfg = dataclasses.replace(ExperimentConfig.load(str(out / "config.json")), output_dir=str(tmp_path / "r2"))
    trainer = loop.Trainer(cfg, device="cpu")
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    state, epoch, loss = restore_checkpoint(latest, trainer.state)
    assert epoch == 1 and np.isfinite(loss) and state.step > 0
    params, epoch_po = restore_params_only(latest)
    assert epoch_po == 1
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, params[k])
    assert any(not torch.equal(before[k], params[k]) for k in before)
    # resuming a run starts at the next epoch with the optimizer's moments
    resumed = loop.Trainer(dataclasses.replace(cfg, resume_from=latest), device="cpu")
    assert resumed.start_epoch == 2 and resumed.state.optimizer.state

    # final_norm mismatch is a descriptive error
    no_norm = TrainState.create(build_model(trainer.vocab.vocab_size, d_model=32, nhead=4,
                                            num_layers=1, d_ff=64, max_len=1408,
                                            final_norm=False), lr=1e-4)
    with pytest.raises(ValueError, match="final_norm"):
        restore_checkpoint(latest, no_norm)

    # the checkpoint serves: load_inference_model reads the directory
    model, epoch = load_inference_model(cfg, trainer.vocab.vocab_size, latest, torch.float32,
                                        device="cpu")
    assert epoch == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, params[k])


def test_snapshot_round_trips_through_jax_and_the_port(pair, tmp_path):
    jm, params, tm = pair
    state = tm.state_dict()
    flax_tree = params_to_flax(state)
    back = params_from_flax(flax_tree)
    assert back.keys() == state.keys()
    for k in state:
        assert torch.equal(back[k], state[k]), k
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
                 flax_tree, jax.tree.map(np.asarray, params))

    snap = str(tmp_path / "snap.msgpack")
    export_params_msgpack(snap, state, meta={"epoch": 3, "final_norm": True})
    meta = json.load(open(snap + ".json"))
    assert meta == {"epoch": 3, "final_norm": True}
    want = jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)),
                        params)
    jback = import_params_msgpack(snap, jax.eval_shape(lambda: params))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b), jback, want)
    pback = params_from_flax(read_flax_msgpack(snap), bf16_leaves_as_bits=True)
    for k, v in params_from_flax(want).items():
        assert torch.equal(pback[k], v), k

    cfg = ExperimentConfig(d_model=32, nhead=4, num_layers=2, d_ff=64, max_seq=512)
    model, epoch = load_inference_model(cfg, tm.cfg.vocab_size, snap, torch.float32, device="cpu")
    assert epoch == 3
    for k, v in model.state_dict().items():
        assert torch.equal(v, pback[k])


def test_trainer_warm_starts_from_a_snapshot(pair, tmp_path):
    jm, params, tm = pair
    snap = str(tmp_path / "warm.msgpack")
    export_params_msgpack(snap, tm.state_dict(), meta={"epoch": 1, "final_norm": True})
    cfg = ExperimentConfig(d_model=32, nhead=4, num_layers=2, d_ff=64, max_seq=512,
                           output_dir=str(tmp_path / "run"), resume_from=snap)
    trainer = loop.Trainer(cfg, device="cpu")
    assert trainer.start_epoch == 0 and not trainer.state.optimizer.state
    want = params_from_flax(read_flax_msgpack(snap), bf16_leaves_as_bits=True)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, want[k])
    export_params_msgpack(snap, tm.state_dict(), meta={"final_norm": False})
    with pytest.raises(ValueError, match="final_norm"):
        loop.Trainer(cfg, device="cpu")


def test_overfit_one_batch_lowers_the_loss(vocab):
    torch.manual_seed(0)
    model = build_model(vocab.vocab_size, d_model=32, nhead=4, num_layers=1, d_ff=64, max_len=512)
    tables = build_loss_tables(vocab)
    state = TrainState.create(model, lr=3e-3)
    step = make_train_step(model, tables, with_metrics=False)
    batch = _tb(_batch(vocab.vocab_size, seed=4))
    gen = torch.Generator().manual_seed(1)
    losses = []
    for _ in range(30):
        state, m = step(state, batch, 1.0, gen)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < 0.5 * losses[0], losses
    ev = make_eval_step(model, tables)(batch, 1.0)
    assert float(ev["loss"]) < losses[0] and 0.0 <= float(ev["accuracy"]) <= 1.0


class _Recorder:
    """Stands in for the trainer's logger: keeps what it is given."""

    def __init__(self):
        self.errors = []

    def error(self, msg):
        self.errors.append(msg)

    def info(self, msg):
        pass


def _contained_trainer(tmp_path, name):
    cfg = ExperimentConfig(d_model=32, nhead=4, num_layers=1, d_ff=64, max_seq=512,
                           print_every=1, dropout=0.0, output_dir=str(tmp_path / name))
    trainer = loop.Trainer(cfg, device="cpu")
    trainer.logger = _Recorder()
    return trainer


def _train_state(trainer):
    opt = trainer.state.optimizer
    moments = [{k: v.clone() if torch.is_tensor(v) else v for k, v in opt.state[p].items()}
               for g in opt.param_groups for p in g["params"] if p in opt.state]
    return ({k: v.clone() for k, v in trainer.model.state_dict().items()}, moments,
            int(trainer.state.step))


def _assert_same_state(a, b):
    (pa, ma, sa), (pb, mb, sb) = a, b
    assert sa == sb
    assert pa.keys() == pb.keys() and all(torch.equal(pa[k], pb[k]) for k in pa)
    assert len(ma) == len(mb)
    for x, y in zip(ma, mb):
        assert x.keys() == y.keys()
        assert all(torch.equal(x[k], y[k]) if torch.is_tensor(x[k]) else x[k] == y[k] for k in x)


def test_a_step_that_fails_before_the_update_is_skipped(vocab, tmp_path, monkeypatch):
    """JAX's ``train_epoch`` skips a batch whose step raises and logs
    ``step N failed: ...`` (JAX ``train/loop.py:262-266``).  The port's
    forward raising on the second of three batches: the error is logged,
    the parameters, Adam's moments and ``state.step`` are those of a run
    that trained the first batch alone, and the third batch trains them to
    what a run that never saw the second gives."""
    V = vocab.vocab_size
    b1, bad, b3 = (_batch(V, seed=s) for s in (21, 22, 23))
    forward = state_mod._forward_batch

    def failing(model, batch, *a, **k):
        if torch.equal(batch["input"], torch.from_numpy(bad["input"])):
            raise RuntimeError("forward failed on purpose")
        return forward(model, batch, *a, **k)

    monkeypatch.setattr(state_mod, "_forward_batch", failing)
    hit, clean = _contained_trainer(tmp_path, "hit"), _contained_trainer(tmp_path, "clean")
    hit.train_epoch([b1, bad], eos_weight=0.8, epoch=0)
    clean.train_epoch([b1], eos_weight=0.8, epoch=0)
    assert hit.logger.errors == ["step 1 failed: RuntimeError: forward failed on purpose"]
    assert clean.logger.errors == []
    assert all(p.grad is None for p in hit.model.parameters())
    _assert_same_state(_train_state(hit), _train_state(clean))
    assert int(hit.state.step) == 1
    hit.train_epoch([b3], eos_weight=0.8, epoch=0)
    clean.train_epoch([b3], eos_weight=0.8, epoch=0)
    _assert_same_state(_train_state(hit), _train_state(clean))
    assert int(hit.state.step) == 2


def test_a_step_that_fails_in_the_update_propagates(vocab, tmp_path):
    """Once the optimizer has begun to update the parameters in place, the
    state cannot be given back: the error propagates and nothing is
    logged as skipped."""
    trainer = _contained_trainer(tmp_path, "update")
    update = trainer.state.optimizer.step

    def failing_update(*a, **k):
        update(*a, **k)
        raise RuntimeError("update failed on purpose")

    trainer.state.optimizer.step = failing_update
    with pytest.raises(RuntimeError, match="update failed on purpose"):
        trainer.train_epoch([_batch(vocab.vocab_size, seed=24)], eos_weight=0.8, epoch=0)
    assert trainer.logger.errors == []
