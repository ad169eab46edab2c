"""The port's checkpoint converter against JAX's, on a reference-layout
state dict built in memory.

Without the reference tree ``tests/test_convert.py`` skips its parity
cases.  Here a seeded state dict
under the reference's key names (``train/convert.py``'s table: the fused
``in_proj_weight`` of q, k and v, ``linear1/2``, ``norm1-3``, the final
encoder and decoder norms) goes through both converters: the port's
``infer_config`` equals JAX's, and the port's model on its converted state
dict gives the logits and cross weights of JAX's ``ScoreTransformer`` on
JAX's converted params (f32, within 1e-5: sums in another order).  Then the
CLI writes the port's checkpoint, ``restore_checkpoint`` reads it back, and
the restored weights drive a grammar-valid infill on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smer_music_generation_tpu.models.transformer import ScoreTransformer as JScoreTransformer
from smer_music_generation_tpu.train import convert as jconvert
from smer_music_generation_tpu_torch.infer.engine import InfillEngine
from smer_music_generation_tpu_torch.models.transformer import ScoreTransformer
from smer_music_generation_tpu_torch.train import convert
from smer_music_generation_tpu_torch.train.checkpoint import latest_checkpoint, restore_checkpoint
from smer_music_generation_tpu_torch.train.state import TrainState
from smer_music_generation_tpu_torch.vocab import WordVocab
from tests.torch_port_helpers import serving_events

torch.set_num_threads(1)


def reference_state_dict(vocab=309, d=64, d_ff=128, n_enc=2, n_dec=2, final_norm=True, seed=0):
    """Seeded f32 tensors under the reference's key names and shapes."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(name, *shape, scale=0.1):
        sd[name] = torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    def attn(p):
        put(f"{p}.in_proj_weight", 3 * d, d)
        put(f"{p}.in_proj_bias", 3 * d)
        put(f"{p}.out_proj.weight", d, d)
        put(f"{p}.out_proj.bias", d)

    def norm(p):
        sd[f"{p}.weight"] = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32))
        put(f"{p}.bias", d)

    put("embedding.weight", vocab, d, scale=1.0)
    put("fc.weight", vocab, d)
    put("fc.bias", vocab)
    for stack, n in (("encoder", n_enc), ("decoder", n_dec)):
        for i in range(n):
            p = f"transformer.{stack}.layers.{i}"
            attn(f"{p}.self_attn")
            if stack == "decoder":
                attn(f"{p}.multihead_attn")
            put(f"{p}.linear1.weight", d_ff, d)
            put(f"{p}.linear1.bias", d_ff)
            put(f"{p}.linear2.weight", d, d_ff)
            put(f"{p}.linear2.bias", d)
            for j in range(1, 4 if stack == "decoder" else 3):
                norm(f"{p}.norm{j}")
        if final_norm:
            norm(f"transformer.{stack}.norm")
    return sd


@pytest.mark.parametrize("final_norm", [True, False], ids=["final_norm", "no_final_norm"])
def test_converted_logits_match_jax(final_norm):
    sd = reference_state_dict(final_norm=final_norm)
    cfg = convert.infer_config(sd)
    jcfg = jconvert.infer_config(sd)
    fields = ("vocab_size", "d_model", "nhead", "num_encoder_layers", "num_decoder_layers",
              "d_ff", "max_len", "final_norm")
    assert {f: getattr(cfg, f) for f in fields} == {f: getattr(jcfg, f) for f in fields}
    assert (cfg.nhead, cfg.final_norm) == (1, final_norm)  # 64 // 64
    cfg, state = convert.torch_state_dict_to_params(sd, dataclasses.replace(cfg, nhead=4))
    jcfg, jparams = jconvert.torch_state_dict_to_params(sd, dataclasses.replace(jcfg, nhead=4))
    model = ScoreTransformer(cfg)
    model.load_state_dict(state)  # strict: every key of the port's model, no other
    rng = np.random.default_rng(1)
    B, S, T = 2, 24, 13
    src, tgt = rng.integers(1, 309, (B, S)), rng.integers(1, 309, (B, T))
    src_pad = np.zeros((B, S), bool)
    src_pad[0, 18:] = True
    tgt_pad = np.zeros((B, T), bool)
    tgt_pad[1, 10:] = True
    want, want_w = JScoreTransformer(jcfg).apply(
        jparams, jnp.asarray(src, jnp.int32), jnp.asarray(tgt, jnp.int32),
        src_pad_mask=jnp.asarray(src_pad), tgt_pad_mask=jnp.asarray(tgt_pad))
    with torch.no_grad():
        got, got_w = model(torch.as_tensor(src), torch.as_tensor(tgt), torch.as_tensor(src_pad),
                           torch.as_tensor(tgt_pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=1e-5)


def test_convert_cli_to_checkpoint_to_engine(tmp_path):
    """JAX's ``test_convert_cli_to_orbax_to_engine`` on the port: the CLI
    writes ``checkpoint_9`` from the training payload, it restores into a
    ``TrainState`` with the converted weights, epoch and loss, and the
    restored model infills a grammar-valid stream."""
    sd = reference_state_dict(d=64)
    ckpt = tmp_path / "checkpoint_9"
    torch.save({"model_state_dict": sd, "epoch": 9, "loss": 0.5}, str(ckpt))
    out_dir = tmp_path / "imported"
    assert convert.main([str(ckpt), str(out_dir), "--nhead", "4", "--max-len", "2048"]) == 0
    path = latest_checkpoint(str(out_dir))
    assert path is not None and path.endswith("checkpoint_9")
    cfg, params, meta = convert.load_torch_checkpoint(str(ckpt), nhead=4, max_len=2048)
    assert meta == {"epoch": 9, "loss": 0.5}
    bare = tmp_path / "bare.pt"
    torch.save(sd, str(bare))
    assert convert.load_torch_checkpoint(str(bare), nhead=4)[2] == {}
    model = ScoreTransformer(cfg)
    state, epoch, loss = restore_checkpoint(path, TrainState.create(model, lr=1e-4))
    assert (epoch, loss) == (9, 0.5)
    for k, v in params.items():
        assert torch.equal(model.state_dict()[k], v), k
    vocab = WordVocab(mode=0)
    assert vocab.vocab_size == 309
    engine = InfillEngine(model.eval().requires_grad_(False), vocab, nucleus_p=0.9, max_tgt_len=512,
                          max_time_fix_attempts=1, seed=5)
    result = engine(serving_events(vocab), tracks_to_generate=[0], bars_to_generate=[1])
    assert result is not None and "m_0" not in result.events
    vocab.encode(result.events)  # every token in the vocabulary
