"""Grammar lookups and samplers of the port equal the JAX package's exactly.

Random packed states, span starts, span types, logits, masks and Gumbel
noise (numpy seeds) go through both; the outputs must be identical, in
SMER (mode 0) and REMI (mode 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smer_music_generation_tpu.infer import grammar as jg
from smer_music_generation_tpu.infer import sampling as js
from smer_music_generation_tpu.vocab import CONTROL_SETS, WordVocab
from smer_music_generation_tpu_torch.infer import grammar as tg
from smer_music_generation_tpu_torch.infer import sampling as ts
from smer_music_generation_tpu_torch.vocab import WordVocab as TWordVocab

B = 16


@pytest.fixture(scope="module", params=[0, 1], ids=["smer", "remi"])
def tables(request):
    mode = request.param
    jt = jg.build_fast_tables(jg.GrammarTables.build(WordVocab(mode, CONTROL_SETS[5])))
    tt = tg.build_fast_tables(tg.GrammarTables.build(TWordVocab(mode, CONTROL_SETS[5])))
    return mode, jt, tt


def test_fast_tables_identical(tables):
    _, jt, tt = tables
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allowed_mask_and_update_bits_exact(tables, seed):
    mode, jt, tt = tables
    V = jt[0].shape[-1]
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 16, size=B).astype(np.int32)
    is_start = rng.random(B) < 0.3
    span_type = rng.integers(0, 5, size=B).astype(np.int32)
    no_whole = rng.random(B) < 0.5
    idx = rng.integers(0, V, size=B).astype(np.int32)

    want = jg.allowed_mask_fast(*jt[:2], jnp.asarray(bits), jnp.asarray(is_start),
                                jnp.asarray(span_type), jnp.asarray(no_whole),
                                start_overrides=(mode == 1))
    t_tables = [torch.from_numpy(a) for a in tt]
    got = tg.allowed_mask_fast(*t_tables[:2], torch.from_numpy(bits), torch.from_numpy(is_start),
                               torch.from_numpy(span_type), torch.from_numpy(no_whole),
                               start_overrides=(mode == 1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    want = jg.update_bits(jt[2], jnp.asarray(bits), jnp.asarray(idx))
    got = tg.update_bits(t_tables[2], torch.from_numpy(bits), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("p,temperature", [(None, 1.0), (0.9, 1.0), (0.5, 0.7)])
def test_samplers_exact(tables, seed, p, temperature):
    mode, jt, tt = tables
    state_masks = jt[0]
    V = state_masks.shape[-1]
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    allowed = state_masks[rng.integers(0, 2, size=B), rng.integers(0, tg.N_SID, size=B)]
    gumbel = rng.gumbel(size=(B, V)).astype(np.float32)
    tl, ta, tn = (torch.from_numpy(a) for a in (logits, allowed, gumbel))

    want = js.greedy_sample(jnp.asarray(logits), jnp.asarray(allowed))
    np.testing.assert_array_equal(ts.greedy_sample(tl, ta).numpy(), np.asarray(want))
    want = js.masked_sample_gumbel(jnp.asarray(gumbel), jnp.asarray(logits),
                                   jnp.asarray(allowed), p, temperature)
    got = ts.masked_sample_gumbel(tn, tl, ta, p, temperature)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the sample is always a legal token
    assert allowed[np.arange(B), got.numpy()].all()


def test_gumbel_noise_is_seeded_and_finite():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = ts.gumbel_noise((64, 2, 309), g1, "cpu")
    b = ts.gumbel_noise((64, 2, 309), g2, "cpu")
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert abs(a.mean().item() - 0.5772) < 0.02  # Euler-Mascheroni
