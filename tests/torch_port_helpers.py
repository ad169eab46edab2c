"""Shared fixtures for the PyTorch port's parity tests.

Builds one small model twice, in the JAX package and in the port, with the
same weights (JAX init, carried over by ``params_from_flax``), and the
serving-shaped inputs both decoders take.
"""

from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np
import torch

from smer_music_generation_tpu.models.transformer import ModelConfig as JModelConfig
from smer_music_generation_tpu.models.transformer import ScoreTransformer as JScoreTransformer
from smer_music_generation_tpu_torch.models.transformer import ModelConfig, ScoreTransformer
from smer_music_generation_tpu_torch.train.state import params_from_flax, params_to_flax

# The port's CPU tests run beside JAX tests in several pytest-xdist workers;
# torch's intra-op thread pool then oversubscribes the cores and its idle
# threads spin, which slowed these files ~15x in a full run.  The shapes here
# are small, so one thread loses nothing.
torch.set_num_threads(1)

SMALL = dict(d_model=128, nhead=2, num_encoder_layers=2, num_decoder_layers=2, d_ff=256)


def perturb_affine(params, seed: int):
    """JAX init leaves every bias at 0 and every LayerNorm at scale 1, bias 0,
    so a layout that swaps or drops them would still match.  Give each bias
    and LayerNorm leaf seeded values: biases ~ N(0, 0.2), scales 1 + N(0, 0.2)."""
    rng = np.random.default_rng(seed + 1000)

    def leaf(path, a):
        name = path[-1].key
        a = np.asarray(a)
        if name == "bias":
            return (0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
        if name == "scale":
            return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(leaf, params)


def model_pair(vocab_size: int, seed: int = 0, max_len: int = 2048, **overrides):
    """(jax model, jax params, port model) with identical f32 weights; the
    biases and LayerNorm parameters are seeded random (``perturb_affine``)."""
    dims = {**SMALL, **overrides}
    jmodel = JScoreTransformer(JModelConfig(
        vocab_size=vocab_size, max_len=max_len, dropout=0.0, pos_dropout=0.0, **dims
    ))
    params = perturb_affine(jmodel.init(
        {"params": jax.random.PRNGKey(seed)},
        jnp.ones((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32),
    ), seed)
    tmodel = ScoreTransformer(ModelConfig(vocab_size=vocab_size, max_len=max_len, **dims))
    tmodel.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel.eval().requires_grad_(False)


def serving_events(vocab):
    """A control-mode-2 serving stream of the two-track test score, in the
    vocab's encoding (REMI streams are converted from SMER)."""
    from smer_music_generation_tpu_torch.codec.annotate import encode_midi
    from smer_music_generation_tpu_torch.codec.remi import smer_to_remi
    from smer_music_generation_tpu_torch.infer.engine import change_controls
    from tests.test_annotate import make_two_track_score

    events, controls = encode_midi(
        make_two_track_score(), controls={"key": None},
        track_names=["track_0", "track_1"],
    )
    if vocab.mode == 1:
        events = smer_to_remi(events)
    controls["bar_track"] = 0
    controls["track_0_c"] = controls["track_0"]
    controls["track_1_c"] = controls["track_1"]
    return change_controls(events, controls, vocab)


def to_torch(tree):
    """Nested dict of jax/numpy arrays -> the same dict of torch tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def flax_from_params(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of ``params_from_flax``: a state dict back to the flax
    params tree of f32 numpy arrays (``{"params": ...}``), by the port's
    own ``train.state.params_to_flax``."""
    return params_to_flax(state)
