"""The v3 whole-token step: the port's plain twin against the Pallas kernel.

The JAX side runs ``fused_decode_token(..., interpret=True)``, as
``tests/test_ops.py`` runs its kernels.  Shapes: d_model 128, 2 heads
(head_dim 64), 2 decoder layers, d_ff 256, f32, L = S = 512, in SMER and
REMI.  Inputs, states and Gumbel noise are made with numpy from a seed.

Tolerances: ``new_state`` and the sampling tables are compared exactly;
``new_kv`` within atol 1e-4, as the v2 step (the two sum the same f32
products in another order).  The sampler's fold (the next token's input
row, the embedding x sqrt(D) plus the PE row at the next position) within
``x_atol(position)`` of JAX's: the two packages take the embedding and its
scale to the same bits, but their exp may part in the last bit of a
frequency (<= 1, an ulp 2^-24 or less), which the angle multiplies by the
position, and their sin and cos in the last bit of a value (up to ~40
here, an ulp ~4e-6): 1e-5 plus four ulps of a frequency times the position
(a PE row of the two packages parts by up to 4.5e-5 at positions up to
1100).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from smer_music_generation_tpu.infer import grammar as jg
from smer_music_generation_tpu.ops import decode_step as jds
from smer_music_generation_tpu.vocab import CONTROL_SETS, WordVocab
from smer_music_generation_tpu_torch.infer import grammar as tg
from smer_music_generation_tpu_torch.infer.sampling import greedy_sample, masked_sample_gumbel
from smer_music_generation_tpu_torch.ops import decode_step as ds
from smer_music_generation_tpu_torch.vocab import WordVocab as TWordVocab
from tests.torch_port_helpers import model_pair, to_torch

ATOL = 1e-4


def x_atol(position: int) -> float:
    return 1e-5 + 4 * 2.0 ** -24 * position

L = S = 512
MAX_SPANS = 16
SPAN_CAP = 40
SAMPLERS = [  # (greedy, nucleus_p, temperature)
    (True, None, 1.0),
    (False, 0.9, 1.0),
    (False, 0.9, 0.7),
]
SAMPLER_IDS = ["greedy", "nucleus-t1.0", "nucleus-t0.7"]


@pytest.fixture(scope="module", params=[0, 1], ids=["smer", "remi"])
def setup(request):
    mode = request.param
    vocab = WordVocab(mode, CONTROL_SETS[5])
    tvocab = TWordVocab(mode, CONTROL_SETS[5])
    jmodel, params, tmodel = model_pair(vocab.vocab_size, seed=41 + mode)
    vpad = ds.vocab_pad(vocab.vocab_size)
    jt = jg.GrammarTables.build(vocab)
    jtables = jds.pack_sampling_tables(vocab, jt, jg.build_fast_tables(jt), vpad)
    tt = tg.GrammarTables.build(tvocab)
    ttables = ds.pack_sampling_tables(tvocab, tt, tg.build_fast_tables(tt), vpad)
    return mode, vocab, jmodel, params, tmodel, vpad, jtables, ttables


def _sampler_kw(vocab, greedy, nucleus_p, temperature):
    return dict(
        mode=vocab.mode, max_spans=MAX_SPANS, span_cap=SPAN_CAP, eos_index=vocab.eos_index,
        mask_index=vocab.mask_index, nucleus_p=nucleus_p, temperature=temperature,
        greedy=greedy, n_sid=tg.N_SID, span_body=tg.SPAN_BODY,
    )


def _statics(vocab, vpad, cfg, greedy, nucleus_p, temperature):
    return dict(
        n_layers=cfg.num_decoder_layers, d_model=cfg.d_model, nhead=cfg.nhead,
        d_ff=cfg.d_ff, vpad=vpad, **_sampler_kw(vocab, greedy, nucleus_p, temperature),
    )


def _random_state(rng, B, V):
    """Valid (6, B) states: any token, bits 0-15 (0 in a third of the rows),
    steps 1..span_cap (1, a span start, in a third of the rows), a span index
    below n_spans, mixed done flags, span types of all five kinds, and
    (2, B) aux with mixed no_whole_duration."""
    n_spans = rng.integers(1, MAX_SPANS + 1, size=B)
    third = rng.random((2, B)) < 1 / 3
    state = np.stack([
        rng.integers(1, V, size=B),  # ST_TOKEN
        np.where(third[0], 0, rng.integers(0, 16, size=B)),  # ST_BITS
        np.where(third[1], 1, rng.integers(1, SPAN_CAP + 1, size=B)),  # ST_STEPS
        rng.integers(0, n_spans),  # ST_SPAN
        (rng.random(B) < 0.25).astype(np.int64),  # ST_DONE
        rng.integers(1, 200, size=B),  # ST_LEN
    ]).astype(np.int32)
    aux = np.stack([n_spans, rng.random(B) < 0.5]).astype(np.int32)
    # mostly bodies: a control span ends after one token and resets the bits
    body = rng.random((B, MAX_SPANS)) < 0.6
    span_types = np.where(body, 0, rng.integers(1, 5, size=(B, MAX_SPANS))).astype(np.int32)
    return state, aux, span_types


def test_sampling_tables_and_emb_match_jax(setup):
    _, _, jmodel, params, tmodel, vpad, jtables, ttables = setup
    assert set(ttables) == set(jtables)
    for k, v in ttables.items():
        assert v.dtype == np.asarray(jtables[k]).dtype, k
        np.testing.assert_array_equal(v, np.asarray(jtables[k]), err_msg=k)
    want = jds.pack_decoder_weights(params, jmodel.cfg, vpad)["emb"]
    got = ds.pack_decoder_weights(tmodel, vpad)["emb"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("greedy,nucleus_p,temperature", SAMPLERS, ids=SAMPLER_IDS)
@pytest.mark.parametrize("B", [1, 4])
def test_twin_matches_pallas_kernel(setup, B, greedy, nucleus_p, temperature):
    mode, vocab, jmodel, params, tmodel, vpad, jtables, ttables = setup
    cfg = jmodel.cfg
    nl, D = cfg.num_decoder_layers, cfg.d_model
    kw = _statics(vocab, vpad, cfg, greedy, nucleus_p, temperature)
    jpacked = jds.pack_decoder_weights(params, cfg, vpad)
    tpacked = to_torch(jpacked)
    ttab = {k: torch.from_numpy(v) for k, v in ttables.items()}
    for index in (0, 1, 300):
        rng = np.random.default_rng(1000 * mode + 100 * B + index)
        state, aux, span_types = _random_state(rng, B, vocab.vocab_size)
        noise = rng.gumbel(size=(L, B, vpad)).astype(np.float32)
        self_kv = rng.normal(size=(nl, B, L, 2 * D)).astype(np.float32)
        cross_kv = rng.normal(size=(nl, B, S, 2 * D)).astype(np.float32)
        cross_len = np.asarray([S - 97 * b for b in range(B)], np.int32)
        js, jkv = jds.fused_decode_token(
            jpacked, jtables, jnp.asarray(state), jnp.asarray(aux), jnp.asarray(span_types),
            jnp.asarray(noise), jnp.asarray(self_kv), jnp.asarray(cross_kv),
            jnp.int32(index), jnp.asarray(cross_len), interpret=True, **kw,
        )
        before = ds.fused_decode_token_reference.calls
        ts, tkv = ds.fused_decode_token(  # CPU tensors: the wrapper runs the twin
            tpacked, ttab, torch.from_numpy(state), torch.from_numpy(aux),
            torch.from_numpy(span_types), None if greedy else torch.from_numpy(noise),
            torch.from_numpy(self_kv), torch.from_numpy(cross_kv), index,
            torch.from_numpy(cross_len), **kw,
        )
        assert ds.fused_decode_token_reference.calls == before + 1
        assert ts.dtype == torch.int32 and tuple(ts.shape) == (6, B)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js), err_msg=f"index {index}")
        np.testing.assert_allclose(tkv.numpy(), np.asarray(jkv), atol=ATOL, rtol=0)


def test_embedding_and_pe_row_match_the_model(setup):
    """The twin's input row is the model's embedding x sqrt(D) plus its
    sinusoidal table row, computed analytically."""
    _, _, _, _, tmodel, vpad, _, _ = setup
    D = tmodel.cfg.d_model
    packed = ds.pack_decoder_weights(tmodel, vpad)
    for index in (0, 1, 300, 511):
        np.testing.assert_allclose(
            ds.pe_row(index, D).numpy(), tmodel.pos_table[index].numpy(), atol=1e-5, rtol=0
        )
    tok = torch.tensor([3, 100])
    np.testing.assert_array_equal(packed["emb"][tok].numpy(), tmodel.embedding.weight[tok].numpy())
    assert (packed["emb"][tmodel.cfg.vocab_size :] == 0).all()


@pytest.mark.parametrize("greedy,nucleus_p,temperature", SAMPLERS, ids=SAMPLER_IDS)
def test_twin_sampler_matches_v2_loop(setup, greedy, nucleus_p, temperature):
    """On the same logits and states the v3 twin's token is the token of the
    v2 loop's torch sampler (``allowed_mask_fast`` + ``masked_sample_gumbel``
    or ``greedy_sample``), with the noise over V lanes padded to vpad, and
    its state advance is the v2 loop's (``update_bits`` on the packed
    transition table, span end, done, next token, length)."""
    mode, vocab, _, _, _, vpad, _, ttables = setup
    V, B = vocab.vocab_size, 16
    ttab = {k: torch.from_numpy(v) for k, v in ttables.items()}
    fast = [torch.from_numpy(a) for a in tg.build_fast_tables(tg.GrammarTables.build(
        TWordVocab(mode, CONTROL_SETS[5])))]
    for seed in range(4):
        rng = np.random.default_rng(seed)
        state, aux, span_types = _random_state(rng, B, V)
        logits = torch.from_numpy((3 * rng.normal(size=(B, vpad))).astype(np.float32))
        logits[:, V:] = ds.NEG
        g = torch.from_numpy(rng.gumbel(size=(B, V)).astype(np.float32))
        final, _ = ds.sampling_scores(
            logits, torch.from_numpy(state), torch.from_numpy(aux), torch.from_numpy(span_types),
            None if greedy else torch.nn.functional.pad(g, (0, vpad - V)), ttab,
            mode=mode, max_spans=MAX_SPANS, nucleus_p=nucleus_p, temperature=temperature,
            greedy=greedy, n_sid=tg.N_SID,
        )
        got = torch.argmax(final, dim=-1)
        st = torch.from_numpy(state).long()
        cur_type = torch.from_numpy(span_types).long()[
            torch.arange(B), st[ds.ST_SPAN].clamp(max=MAX_SPANS - 1)]
        allowed = tg.allowed_mask_fast(
            fast[0], fast[1], st[ds.ST_BITS], st[ds.ST_STEPS] == 1, cur_type,
            torch.from_numpy(aux[ds.AUX_NOWHOLE] > 0), start_overrides=(mode == 1),
        )
        if greedy:
            want = greedy_sample(logits[:, :V] / temperature, allowed)
        else:
            want = masked_sample_gumbel(g, logits[:, :V], allowed, nucleus_p, temperature)
        np.testing.assert_array_equal(got.numpy(), want.numpy())

        index = 7
        noise = torch.zeros(index + 1, B, vpad)
        noise[index, :, :V] = g
        new_state = ds.sample_and_advance_reference(
            logits, torch.from_numpy(state), torch.from_numpy(aux), torch.from_numpy(span_types),
            noise, index, ttab, **_sampler_kw(vocab, greedy, nucleus_p, temperature))
        steps, span_idx, done = st[ds.ST_STEPS], st[ds.ST_SPAN], st[ds.ST_DONE] > 0
        end_span = ((want == vocab.eos_index) | (steps >= SPAN_CAP)
                    | ((cur_type != tg.SPAN_BODY) & (steps >= 2)))
        new_span = torch.where(end_span, span_idx + 1, span_idx)
        now_done = done | (new_span >= torch.from_numpy(aux[ds.AUX_NSPANS]).long())
        next_tok = torch.where(now_done, 0, torch.where(end_span, vocab.mask_index, want))
        expected = torch.stack([
            next_tok,
            torch.where(end_span | done, 0, tg.update_bits(fast[2], st[ds.ST_BITS], want)),
            torch.where(end_span, 1, steps + 1),
            new_span,
            now_done.long(),
            torch.where(next_tok != 0, index + 2, st[ds.ST_LEN]),
        ])
        np.testing.assert_array_equal(new_state.numpy(), expected.numpy())


def test_cuda_wrappers_refuse_other_devices(setup):
    """A tensor on neither the CPU nor a CUDA card is refused before any
    launch."""
    _, vocab, jmodel, _, _, vpad, _, _ = setup
    meta = torch.empty(6, 1, dtype=torch.int32, device="meta")
    kw = _statics(vocab, vpad, jmodel.cfg, True, None, 1.0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ds.fused_decode_token({}, {}, meta, meta, meta, None, meta, meta, 0, meta, **kw)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ds.sample_and_advance(torch.empty(1, vpad, device="meta"), meta, meta, meta, None, 0, {},
                              **_sampler_kw(vocab, True, None, 1.0))


@functools.lru_cache(maxsize=None)
def _jax_sampler(B, vpad, greedy, **kw):
    """JAX's ``_sample_and_advance_b`` (the v3 and v4 kernels' sampler and
    state advance) for B rows, in a Pallas call run in interpret mode, as
    the kernels run it: (position, state, aux, span_types, sid_tbl, masks,
    class_mat, logits (B, vpad), noise row (B, vpad)) -> new state (6, B)."""

    def kernel(scalars, state, aux, span_types, sid_tbl, masks, class_mat, logits, g, out):
        for b in range(B):
            jds._sample_and_advance_b(
                b, logits[b : b + 1, :], None if greedy else g[b : b + 1, :], scalars, state, aux,
                span_types, sid_tbl, masks, class_mat, out, greedy=greedy, vpad=vpad, **kw)

    return jax.jit(pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((6, B), jnp.int32),
                                  interpret=True))


FOLD_CASES = [  # (name, tokens, base position)
    ("v3", 1, 300),
    ("v4-T4", 4, 61),
]


@pytest.mark.parametrize("greedy,nucleus_p,temperature", SAMPLERS[:2], ids=SAMPLER_IDS[:2])
@pytest.mark.parametrize("name,T,base", FOLD_CASES, ids=[c[0] for c in FOLD_CASES])
def test_folded_sampler_matches_jax(setup, name, T, base, greedy, nucleus_p, temperature):
    """The twin of ``sample_advance_kernel`` with its fold
    (``sample_advance_embed_reference``) against JAX: the state advance of
    ``_sample_and_advance_b`` exactly, and the next token's input row
    within x_atol of JAX's own: the one-hot embedding of the new state's
    token x sqrt(D) plus ``_pe_row`` at the next position, as ``_kernel_v3``
    (and ``_kernel_v4`` at each token of a chunk) builds x.  Token t of a
    chunk samples at base + t and embeds at base + t + 1; each token starts
    from the state the one before left, on fresh logits."""
    mode, vocab, jmodel, params, tmodel, vpad, jtables, ttables = setup
    B, D = 4, jmodel.cfg.d_model
    kw = _sampler_kw(vocab, greedy, nucleus_p, temperature)
    jsample = _jax_sampler(B, vpad, greedy, **{k: v for k, v in kw.items() if k != "greedy"})
    jemb = jds.pack_decoder_weights(params, jmodel.cfg, vpad)["emb"]
    temb = torch.from_numpy(np.array(jemb))
    ttab = {k: torch.from_numpy(v) for k, v in ttables.items()}
    rng = np.random.default_rng(500 + 10 * mode + T)
    state, aux, span_types = _random_state(rng, B, vocab.vocab_size)
    noise = rng.gumbel(size=(base + T, B, vpad)).astype(np.float32)
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, vpad), 1)
    for t in range(T):
        index = base + t
        logits = (3 * rng.normal(size=(B, vpad))).astype(np.float32)
        logits[:, vocab.vocab_size:] = ds.NEG
        want = np.array(jsample(
            jnp.asarray([index], jnp.int32), jnp.asarray(state), jnp.asarray(aux),
            jnp.asarray(span_types), jnp.asarray(jtables["sid_tbl"]),
            jnp.asarray(jtables["state_masks_f"]), jnp.asarray(jtables["class_mat"]),
            jnp.asarray(logits), jnp.asarray(noise[index])))
        rows = [jnp.dot((lane == int(tok)).astype(jemb.dtype), jemb,
                        preferred_element_type=jnp.float32) for tok in want[ds.ST_TOKEN]]
        want_x = np.asarray(jnp.concatenate(rows, axis=0) * math.sqrt(D)
                            + jds._pe_row(jnp.int32(index + 1), D))
        got, x = ds.sample_and_advance(  # CPU tensors: the wrapper runs the twin
            torch.from_numpy(logits), torch.from_numpy(state), torch.from_numpy(aux),
            torch.from_numpy(span_types), None if greedy else torch.from_numpy(noise), index,
            ttab, emb=temb, **kw)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{name} token {t}")
        assert x.dtype == torch.float32 and tuple(x.shape) == (B, D)
        np.testing.assert_allclose(x.numpy(), want_x, atol=x_atol(index + 1), rtol=0,
                                   err_msg=f"{name} token {t}")
        state = want
