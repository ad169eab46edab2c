"""The model's flash_training path at head_dim 128 (d256 with nhead 2)
against the JAX package's on the CPU, the library kernel in interpret mode;
held as ``tests/test_torch_flash_train.py`` holds it at head_dim 64 (logits
1e-4 absolute, loss and gradients 1e-4 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

from smer_music_generation_tpu.models.transformer import ModelConfig as JModelConfig
from smer_music_generation_tpu.models.transformer import ScoreTransformer as JScoreTransformer
from smer_music_generation_tpu_torch.models.transformer import ModelConfig, ScoreTransformer
from smer_music_generation_tpu_torch.ops import flash_train as ft
from smer_music_generation_tpu_torch.train.state import params_from_flax, params_to_flax

V = 50
KW = dict(vocab_size=V, d_model=256, nhead=2, num_encoder_layers=1, num_decoder_layers=1,
          d_ff=256, max_len=256, dropout=0.0, pos_dropout=0.0, flash_training=True)


def test_model_flash_path_at_head_dim_128_against_jax():
    """flash_training at d256/h2 (head_dim 128), src 256 / tgt 128: the
    port's logits, loss and gradients of mean(logits^2) against JAX's model
    with the same weights, the library kernel in interpret mode."""
    jm = JScoreTransformer(JModelConfig(**KW))
    rng = np.random.default_rng(9)
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.ones((1, 8), jnp.int32),
                     jnp.ones((1, 8), jnp.int32))
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        if p[-1].key == "bias" else np.asarray(a), params)
    tm = ScoreTransformer(ModelConfig(**KW))
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    src = rng.integers(3, V, (2, 256)).astype(np.int32)
    tgt = rng.integers(3, V, (2, 128)).astype(np.int32)
    spm, tpm = np.zeros((2, 256), bool), np.zeros((2, 128), bool)
    spm[1, 192:], tpm[1, 64:] = True, True
    src[spm], tgt[tpm] = 0, 0

    def loss_fn(p):
        logits, _ = jm.apply(p, src, tgt, src_pad_mask=spm, tgt_pad_mask=tpm)
        return jnp.mean(logits ** 2), logits

    with pltpu.force_tpu_interpret_mode():
        (jl, jlogits), jg = jax.value_and_grad(loss_fn, has_aux=True)(params)
    ft.reset_counts()
    logits, w = tm(*(torch.from_numpy(a) for a in (src, tgt, spm, tpm)))
    loss = (logits ** 2).mean()
    loss.backward()
    assert w is None
    assert (ft.flash_train_fwd_reference.calls, ft.flash_train_bwd_reference.calls) == (3, 3)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
    assert abs(loss.item() - float(jl)) / abs(float(jl)) < 1e-4
    grads = params_to_flax({n: p.grad for n, p in tm.named_parameters()})
    leaves = jax.tree_util.tree_leaves_with_path(jg)
    floor = 1e-3 * max(np.linalg.norm(np.asarray(a)) for _, a in leaves)
    for path, a in leaves:
        got = grads
        for key in path:
            got = got[key.key]
        a = np.asarray(a)
        assert np.linalg.norm(got - a) < 1e-4 * max(np.linalg.norm(a), floor), \
            [key.key for key in path]
