"""The port's ``ClassifyTransformer`` against JAX's, on the CPU.

The same f32 params (JAX init, the biases and LayerNorms seeded random by
``perturb_affine``) carried over by ``classifier_params_from_flax``: both
heads' logits within 1e-5 of JAX's (sums in another order), with and
without a padding mask, with and without the final ``norm_e``.  Then the
port's copy of JAX's ``test_classifier_learns_token_presence``: 150 Adam
steps fit two token-derivable binary labels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smer_music_generation_tpu.models.classifier import ClassifyTransformer as JClassifier
from smer_music_generation_tpu.models.transformer import ModelConfig as JModelConfig
from smer_music_generation_tpu_torch.models.classifier import (
    ClassifyTransformer,
    classifier_params_from_flax,
)
from smer_music_generation_tpu_torch.models.transformer import ModelConfig
from tests.torch_port_helpers import perturb_affine

torch.set_num_threads(1)

DIMS = dict(vocab_size=50, d_model=32, nhead=2, num_encoder_layers=2, d_ff=64, max_len=64,
            dropout=0.0, pos_dropout=0.0)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("final_norm", [True, False], ids=["final_norm", "no_final_norm"])
def test_classifier_matches_jax(masked, final_norm):
    jmodel = JClassifier(JModelConfig(final_norm=final_norm, **DIMS))
    rng = np.random.default_rng(3)
    src = rng.integers(1, 50, size=(3, 20)).astype(np.int32)
    mask = np.zeros((3, 20), bool)
    mask[0, 12:] = True
    mask[2, 5:] = True
    params = perturb_affine(jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(src)), 4)
    want = jmodel.apply(params, jnp.asarray(src), jnp.asarray(mask) if masked else None)
    model = ClassifyTransformer(ModelConfig(final_norm=final_norm, **DIMS))
    model.load_state_dict(classifier_params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = model(torch.as_tensor(src).long(), torch.as_tensor(mask) if masked else None)
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g.shape == (3, 2) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def test_classifier_train_mode_needs_a_generator():
    model = ClassifyTransformer(ModelConfig(**{**DIMS, "dropout": 0.1, "pos_dropout": 0.1}))
    src = torch.ones(2, 8).long()
    with pytest.raises(ValueError, match="Generator"):
        model(src, deterministic=False)
    a = model(src, deterministic=False, generator=torch.Generator().manual_seed(1))
    b = model(src, deterministic=False, generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_classifier_learns_token_presence():
    """JAX's test on the port: overfit the two binary heads on a
    token-derivable task (a gradient or pooling fault cannot reach it)."""
    torch.manual_seed(0)
    model = ClassifyTransformer(ModelConfig(vocab_size=30, d_model=32, nhead=2, num_encoder_layers=1,
                                            d_ff=64, max_len=32, dropout=0.0, pos_dropout=0.0))
    rng = np.random.default_rng(0)
    src = rng.integers(2, 30, size=(64, 16))
    # head 0: does token 7 appear; head 1: is the sequence mostly high tokens
    y = (torch.as_tensor((src == 7).any(axis=1)).long(),
         torch.as_tensor((src > 15).sum(axis=1) > 8).long())
    src = torch.as_tensor(src)
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)

    def loss_fn():
        return sum(torch.nn.functional.cross_entropy(l, t) for l, t in zip(model(src), y))

    with torch.no_grad():
        first = float(loss_fn())
    for _ in range(150):
        opt.zero_grad()
        loss_fn().backward()
        opt.step()
    with torch.no_grad():
        assert float(loss_fn()) < first * 0.2
    with torch.no_grad():
        for l, t in zip(model(src), y):
            assert float((l.argmax(-1) == t).float().mean()) >= 0.9
