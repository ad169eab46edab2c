"""The v2 decoder step: the port's plain twin against the Pallas kernel.

The JAX side runs ``fused_decode_step(..., interpret=True)``, as
``tests/test_ops.py`` does.  Shapes: d_model 128, 2 heads (head_dim 64),
2 layers, L = S = 512.  Tolerance atol 1e-4 in f32: the two compute the
same f32 sums in another order (the Pallas kernel walks 512-row chunks
with an online softmax, the twin takes one softmax over all rows).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smer_music_generation_tpu.ops.decode_step import fused_decode_step as jax_step
from smer_music_generation_tpu.ops.decode_step import pack_decoder_weights as jax_pack
from smer_music_generation_tpu.vocab import CONTROL_SETS, WordVocab
from smer_music_generation_tpu_torch.ops.decode_step import (
    fused_decode_step,
    fused_decode_step_reference,
    pack_decoder_weights,
    stack_kv_cache,
    vocab_pad,
)
from tests.torch_port_helpers import model_pair, to_torch

ATOL = 1e-4
L = S = 512


@pytest.fixture(scope="module")
def setup():
    vocab = WordVocab(0, CONTROL_SETS[5])
    jmodel, params, tmodel = model_pair(vocab.vocab_size, seed=7)
    vpad = vocab_pad(vocab.vocab_size)
    return jmodel, params, tmodel, vpad


def _inputs(B, D, nl, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, D)).astype(np.float32)
    self_kv = rng.normal(size=(nl, B, L, 2 * D)).astype(np.float32)
    cross_kv = rng.normal(size=(nl, B, S, 2 * D)).astype(np.float32)
    cross_len = np.asarray([S - 97 * b for b in range(B)], np.int32)
    return x, self_kv, cross_kv, cross_len


def test_packer_matches_jax(setup):
    jmodel, params, tmodel, vpad = setup
    want = jax_pack(params, jmodel.cfg, vpad)
    got = pack_decoder_weights(tmodel, vpad)
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("index", [0, 7, 300])
def test_twin_matches_pallas_kernel(setup, B, index):
    jmodel, params, tmodel, vpad = setup
    cfg = jmodel.cfg
    nl, D = cfg.num_decoder_layers, cfg.d_model
    kw = dict(n_layers=nl, d_model=D, nhead=cfg.nhead, d_ff=cfg.d_ff, vpad=vpad)
    x, self_kv, cross_kv, cross_len = _inputs(B, D, nl, seed=100 * B + index)
    packed = jax_pack(params, cfg, vpad)
    jl, jkv = jax_step(
        packed, jnp.asarray(x), jnp.asarray(self_kv), jnp.asarray(cross_kv),
        jnp.int32(index), jnp.asarray(cross_len), interpret=True, **kw,
    )
    before = fused_decode_step_reference.calls
    tl, tkv = fused_decode_step(  # CPU tensors: the wrapper runs the twin
        to_torch(packed), torch.from_numpy(x), torch.from_numpy(self_kv),
        torch.from_numpy(cross_kv), index, torch.from_numpy(cross_len), **kw,
    )
    assert fused_decode_step_reference.calls == before + 1
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tkv.numpy(), np.asarray(jkv), atol=ATOL, rtol=0)
    # padded vocab lanes carry the -1e9 bias and can never win an argmax
    assert (tl[:, 309:] < -1e8).all()


def test_twin_matches_model_decode_step(setup):
    """Four positions of the fused loop body against the model's own
    decode_step, cache rows spliced in as the decoder does."""
    _, _, tmodel, vpad = setup
    cfg = tmodel.cfg
    nl, D, B = cfg.num_decoder_layers, cfg.d_model, 2
    kw = dict(n_layers=nl, d_model=D, nhead=cfg.nhead, d_ff=cfg.d_ff, vpad=vpad)
    rng = np.random.default_rng(11)
    src = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(B, 40)))
    pad = torch.zeros(B, 40, dtype=torch.bool)
    pad[1, 25:] = True
    with torch.no_grad():
        mem = tmodel.encode(src, pad)
        cross = tmodel.init_cross_cache(mem)
        cache = tmodel.init_self_cache(B, 16)
        packed = pack_decoder_weights(tmodel, vpad)
        cross_kv = stack_kv_cache(cross, nl)
        cross_len = (~pad).sum(1).to(torch.int32)
        kv = torch.zeros(nl, B, 16, 2 * D)
        for pos in range(4):
            tok = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(B,)))
            want = tmodel.decode_step(tok, pos, cache, cross, pad)
            x = tmodel.embedding.weight[tok] * D ** 0.5 + tmodel.pos_table[pos]
            got, new_kv = fused_decode_step_reference(packed, x, kv, cross_kv, pos, cross_len, **kw)
            kv[:, :, pos] = new_kv
            np.testing.assert_allclose(got[:, : cfg.vocab_size].numpy(), want.numpy(), atol=ATOL, rtol=0)


def test_cuda_wrapper_rejects_bad_inputs_without_a_card(setup):
    """Validation that runs before any launch: a non-CPU, non-CUDA device
    is refused, and the packer refuses a quant mode it does not know (int8
    is ported: tests/test_torch_quant.py)."""
    _, _, tmodel, vpad = setup
    with pytest.raises(ValueError, match="quant"):
        pack_decoder_weights(tmodel, vpad, quant="int4")
    assert pack_decoder_weights(tmodel, vpad, quant="int8")["w_attn"].dtype == torch.int8
    meta = torch.empty(1, 128, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_decode_step({}, meta, meta, meta, 0, meta, n_layers=2, d_model=128, nhead=2, d_ff=256, vpad=vpad)
