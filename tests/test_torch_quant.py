"""int8 weight streaming: the port's packer and twins against the JAX package.

The JAX side runs its Pallas kernels with ``interpret=True``, as
``tests/test_ops.py`` does.  Shapes: d_model 128, 2 heads (head_dim 64),
2 decoder layers, d_ff 256, f32 compute, L = S = 512, random biases and
LayerNorms (``tests/torch_port_helpers.model_pair``).  Inputs are made with
numpy from a seed.

Tolerances: ``quantize_columns``' int8 ``q`` and every packed leaf but the
scale strip are compared exactly, the scales to 1 f32 ulp; the v2 step's
logits and ``new_kv`` within atol 1e-4 (the two sum the same f32 products
in another order); the v3 state and the engine's greedy event lists
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smer_music_generation_tpu.infer import grammar as jg
from smer_music_generation_tpu.infer.engine import InfillEngine as JEngine
from smer_music_generation_tpu.ops import decode_step as jds
from smer_music_generation_tpu.vocab import CONTROL_SETS, WordVocab
from smer_music_generation_tpu_torch.infer import decode as decode_mod
from smer_music_generation_tpu_torch.infer.decode import InfillDecoder
from smer_music_generation_tpu_torch.infer.engine import InfillEngine
from smer_music_generation_tpu_torch.models.transformer import ModelConfig, ScoreTransformer
from smer_music_generation_tpu_torch.ops.decode_graph import open_graph
from smer_music_generation_tpu_torch.ops import decode_step as ds
from smer_music_generation_tpu_torch.vocab import WordVocab as TWordVocab
from tests.test_torch_decode_token import _random_state, _statics
from tests.torch_port_helpers import model_pair, serving_events

ATOL = 1e-4
L = S = 512


@pytest.fixture(scope="module")
def setup():
    vocab = WordVocab(0, CONTROL_SETS[5])
    tvocab = TWordVocab(0, CONTROL_SETS[5])
    jmodel, params, tmodel = model_pair(vocab.vocab_size, seed=61)
    vpad = ds.vocab_pad(vocab.vocab_size)
    return vocab, tvocab, jmodel, params, tmodel, vpad


def _assert_packed_equal(got, want):
    assert set(got) == set(want)
    for k, v in got.items():
        w = np.asarray(want[k])
        assert v.numpy().dtype == w.dtype, k
        if k == "scale":
            np.testing.assert_array_max_ulp(v.numpy(), w, maxulp=1)
        else:
            np.testing.assert_array_equal(v.numpy(), w, err_msg=k)


def test_quantize_columns_matches_jax():
    rng = np.random.default_rng(0)
    # columns of very different magnitudes, one all zero, values on .5 steps
    w = rng.normal(size=(2, 64, 96)) * np.exp(rng.normal(size=(1, 1, 96)))
    w[:, :, 5] = 0.0
    w[0, :, 7] = np.arange(64) - 31.5
    w = w.astype(np.float32)
    jq, js = jds.quantize_columns(jnp.asarray(w))
    tq, ts = ds.quantize_columns(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and tuple(ts.shape) == (2, 1, 96)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)


def test_int8_packer_matches_jax(setup):
    _, _, jmodel, params, tmodel, vpad = setup
    want = jds.pack_decoder_weights(params, jmodel.cfg, vpad, quant="int8")
    got = ds.pack_decoder_weights(tmodel, vpad, quant="int8")
    assert got["w_attn"].dtype == torch.int8
    D, F = jmodel.cfg.d_model, jmodel.cfg.d_ff
    assert tuple(got["scale"].shape) == (jmodel.cfg.num_decoder_layers, 1, 7 * D + F)
    _assert_packed_equal(got, want)


def test_int8_packer_quantizes_the_f32_masters():
    """A bf16-compute model holds f32 parameters: the scales come from them,
    not from their bf16 copies (which would give other scales)."""
    torch.manual_seed(0)
    vocab = TWordVocab(0, CONTROL_SETS[5])
    model = ScoreTransformer(ModelConfig(
        vocab_size=vocab.vocab_size, d_model=128, nhead=2, num_encoder_layers=1,
        num_decoder_layers=1, d_ff=256, dtype=torch.bfloat16,
    )).eval()
    packed = ds.pack_decoder_weights(model, 384, quant="int8")
    w = model.decoder_layers[0].ff.fc1.weight.detach().t()
    assert w.dtype == torch.float32
    q, s = ds.quantize_columns(w)
    np.testing.assert_array_equal(packed["w_ff1"][0].numpy(), q.numpy())
    D = 128
    np.testing.assert_array_equal(packed["scale"][0, 0, 6 * D : 6 * D + 256].numpy(), s[0].numpy())
    _, s_bf16 = ds.quantize_columns(w.to(torch.bfloat16))
    assert not torch.equal(s, s_bf16)
    assert packed["emb"].dtype == torch.bfloat16 and packed["fc_w"].dtype == torch.float32


def test_rowvec_int8_twin():
    """On CPU tensors the int8 row-vector wrapper runs its twin: x rounded to
    bf16, exact int8 operands, f32 sums, then the column scale and the bias."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32))
    q, s = ds.quantize_columns(torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32)))
    b = torch.from_numpy(rng.normal(size=(32,)).astype(np.float32))
    before = ds.rowvec_int8_reference.calls
    y = ds.rowvec_int8(x, q, s[0], b, relu=True)
    assert ds.rowvec_int8_reference.calls == before + 1
    want = (x.to(torch.bfloat16).double() @ q.double()) * s[0].double() + b.double()
    np.testing.assert_allclose(y.numpy(), want.clamp(min=0).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,index", [(1, 0), (4, 300)])
def test_v2_int8_twin_matches_pallas_kernel(setup, B, index):
    _, _, jmodel, params, tmodel, vpad = setup
    cfg = jmodel.cfg
    nl, D = cfg.num_decoder_layers, cfg.d_model
    kw = dict(n_layers=nl, d_model=D, nhead=cfg.nhead, d_ff=cfg.d_ff, vpad=vpad)
    jpacked = jds.pack_decoder_weights(params, cfg, vpad, quant="int8")
    tpacked = ds.pack_decoder_weights(tmodel, vpad, quant="int8")
    rng = np.random.default_rng(10 * B + index)
    x = rng.normal(size=(B, D)).astype(np.float32)
    self_kv = rng.normal(size=(nl, B, L, 2 * D)).astype(np.float32)
    cross_kv = rng.normal(size=(nl, B, S, 2 * D)).astype(np.float32)
    cross_len = np.asarray([S - 97 * b for b in range(B)], np.int32)
    jl, jkv = jds.fused_decode_step(
        jpacked, jnp.asarray(x), jnp.asarray(self_kv), jnp.asarray(cross_kv),
        jnp.int32(index), jnp.asarray(cross_len), interpret=True, **kw)
    tl, tkv = ds.fused_decode_step(
        tpacked, torch.from_numpy(x), torch.from_numpy(self_kv), torch.from_numpy(cross_kv),
        index, torch.from_numpy(cross_len), **kw)
    V = jmodel.cfg.vocab_size
    np.testing.assert_allclose(tl.numpy()[:, :V], np.asarray(jl)[:, :V], atol=ATOL, rtol=0)
    np.testing.assert_allclose(tkv.numpy(), np.asarray(jkv), atol=ATOL, rtol=0)


@pytest.mark.parametrize("B,greedy", [(1, True), (4, False)], ids=["B1-greedy", "B4-nucleus"])
def test_v3_int8_twin_matches_pallas_kernel(setup, B, greedy):
    vocab, tvocab, jmodel, params, tmodel, vpad = setup
    cfg = jmodel.cfg
    nl, D = cfg.num_decoder_layers, cfg.d_model
    kw = _statics(vocab, vpad, cfg, greedy, None if greedy else 0.9, 1.0)
    jt = jg.GrammarTables.build(vocab)
    jtables = jds.pack_sampling_tables(vocab, jt, jg.build_fast_tables(jt), vpad)
    ttables = {k: torch.from_numpy(np.asarray(v)) for k, v in jtables.items()}
    jpacked = jds.pack_decoder_weights(params, cfg, vpad, quant="int8")
    tpacked = ds.pack_decoder_weights(tmodel, vpad, quant="int8")
    index = 1 if greedy else 300
    rng = np.random.default_rng(20 + B)
    state, aux, span_types = _random_state(rng, B, vocab.vocab_size)
    noise = rng.gumbel(size=(L, B, vpad)).astype(np.float32)
    self_kv = rng.normal(size=(nl, B, L, 2 * D)).astype(np.float32)
    cross_kv = rng.normal(size=(nl, B, S, 2 * D)).astype(np.float32)
    cross_len = np.asarray([S - 97 * b for b in range(B)], np.int32)
    js, jkv = jds.fused_decode_token(
        jpacked, jtables, jnp.asarray(state), jnp.asarray(aux), jnp.asarray(span_types),
        jnp.asarray(noise), jnp.asarray(self_kv), jnp.asarray(cross_kv), jnp.int32(index),
        jnp.asarray(cross_len), interpret=True, **kw)
    ts, tkv = ds.fused_decode_token(
        tpacked, ttables, torch.from_numpy(state), torch.from_numpy(aux),
        torch.from_numpy(span_types), None if greedy else torch.from_numpy(noise),
        torch.from_numpy(self_kv), torch.from_numpy(cross_kv), index,
        torch.from_numpy(cross_len), **kw)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tkv.numpy(), np.asarray(jkv), atol=ATOL, rtol=0)


def test_quant_requires_fused(setup):
    _, tvocab, _, _, tmodel, _ = setup
    with pytest.raises(ValueError, match="fused"):
        InfillDecoder(tmodel, tvocab, max_tgt_len=L, fused=False, quant="int8")
    with pytest.raises(ValueError, match="fused"):
        InfillDecoder(tmodel, tvocab, max_tgt_len=L, quant="int8")  # the CPU default is plain
    with pytest.raises(ValueError, match="quant"):
        InfillDecoder(tmodel, tvocab, max_tgt_len=L, fused=True, quant="int4")
    with pytest.raises(ValueError, match="speculative"):
        InfillDecoder(tmodel, tvocab, max_tgt_len=L, fused=True, quant="int8", draft_k=2)
    dec = InfillDecoder(tmodel, tvocab, max_tgt_len=L, fused=True, quant="int8")
    assert dec.packed()["w_ff2"].dtype == torch.int8


def test_engine_int8_greedy_matches_jax_engine(setup):
    vocab, tvocab, jmodel, params, tmodel, _ = setup
    events = serving_events(tvocab)
    kw = dict(greedy=True, nucleus_p=None, max_tgt_len=L, max_time_fix_attempts=0, quant="int8")
    jeng = JEngine(jmodel, params, vocab, **kw)
    jeng.decoder.fused, jeng.decoder.interpret = True, True  # the int8 kernels, interpreted
    want = jeng(events, [0], [1], jax.random.PRNGKey(0))
    assert want.decode_steps > 0 and want.generated
    got = InfillEngine(tmodel, tvocab, fused=True, **kw)(events, [0], [1])
    assert got.generated == want.generated
    assert got.events == want.events
    assert got.decode_steps == want.decode_steps


def test_engine_int8_never_decodes_unquantized(setup):
    """JAX decodes unquantized, with a warning, when a call's shape falls off
    its kernel (:259-268).  The port's kernels take any group of 1 to 8 rows,
    so 9 requests run as groups of 8 and 1, each on the int8 weights."""
    _, tvocab, _, _, tmodel, _ = setup
    events = serving_events(tvocab)
    eng = InfillEngine(tmodel, tvocab, greedy=True, nucleus_p=None, max_tgt_len=64,
                       max_time_fix_attempts=0, quant="int8", fused=True)
    reqs = [eng.prepare(events, [b % 2], [b % 4]) for b in range(9)]
    seen = []

    def spy(graphs, packed, tables, state, *rest, **kw):  # the v3 loop's token steps
        seen.append((state.shape[1], packed["w_attn"].dtype, "scale" in packed))
        return open_graph(graphs, packed, tables, state, *rest, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(decode_mod, "open_graph", spy)
        results = eng.run_batch(reqs)
    assert len(results) == 9
    assert {s[0] for s in seen} == {8, 1}
    assert all(s[1] == torch.int8 and s[2] for s in seen)
