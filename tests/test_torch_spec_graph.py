"""Speculative decode's device-state loop on the CPU: the loop the card runs
as one CUDA-graph replay an iteration (``ops.decode_graph.SpecGraph``,
stepped by ``InfillDecoder._decode_v5`` with ``fused``), here with the
twins: the verify's (``fused_verify_window``) and the sampler's
(``ops.decode_step.spec_advance_reference``, the twin of
``spec_advance_kernel``).

(a) Whole decodes through that loop are token-exact with JAX's
    ``_decode_v5`` (its XLA verify): greedy, and nucleus with JAX's own
    ``split(rng)`` draws handed over; draft_k 4, 8 and 15; SMER and REMI;
    a session that hits the cap through the single-token tail.
(b) Planted iterations: ``spec_advance_reference`` on hand-built carries,
    streams and logits against a transcription of JAX's loop body
    (``infer/decode.py:539-651``, its tail :660-698 and ``build_draft``
    :509-534) on JAX's own grammar and sampling functions: a draft from the
    stream, from the source, no match; an ``m_0`` inside the draft;
    ``now_done`` mid-window; a window one short of the cap; the tail.
(c) The no-op rule: an iteration after ``done``, or one whose window no
    longer fits, changes nothing, at any number of replays, and the host
    loop steps once past the end of each phase and no more.

Shapes: d_model 128, 2 heads (head_dim 64), 2 layers, d_ff 256, f32; the
planted iterations take D 16.  Inputs are made with numpy from a seed.
Tolerance: none; tokens, carries, streams and input rows compare exactly.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smer_music_generation_tpu.infer import grammar as jg
from smer_music_generation_tpu.infer import sampling as js
from smer_music_generation_tpu.infer.decode import InfillDecoder as JDecoder
from smer_music_generation_tpu.vocab import CONTROL_SETS, WordVocab
from smer_music_generation_tpu_torch.infer import decode as decode_mod
from smer_music_generation_tpu_torch.infer import grammar as tg
from smer_music_generation_tpu_torch.infer.decode import InfillDecoder
from smer_music_generation_tpu_torch.infer.engine import InfillEngine
from smer_music_generation_tpu_torch.models.transformer import sinusoidal_table
from smer_music_generation_tpu_torch.ops import decode_graph as dg
from smer_music_generation_tpu_torch.ops import decode_step as ds
from smer_music_generation_tpu_torch.vocab import WordVocab as TWordVocab
from tests.torch_port_helpers import model_pair, serving_events

L = 256


@pytest.fixture(scope="module", params=[0, 1], ids=["smer", "remi"])
def setup(request):
    mode = request.param
    vocab = WordVocab(mode, CONTROL_SETS[5])
    tvocab = TWordVocab(mode, CONTROL_SETS[5])
    jmodel, params, tmodel = model_pair(vocab.vocab_size, seed=121 + mode)
    events = serving_events(tvocab)
    eng = InfillEngine(tmodel, tvocab, max_tgt_len=L, fused=False)
    reqs = [eng.prepare(events, [0], [1, 2]), eng.prepare(events, [1], [5, 6, 7])]
    src, span_types, n_spans, no_whole, _ = eng._assemble(reqs)
    return vocab, tvocab, jmodel, params, tmodel, (src, span_types, n_spans, no_whole)


# ----------------------------------------------------------------------
# (a) whole decodes against JAX
# ----------------------------------------------------------------------
LOOP_CASES = [  # (request, draft_k, greedy, span_cap, max_tgt_len)
    (0, 4, True, 40, L),
    (1, 8, False, 40, L),
    (0, 15, False, 40, L),
    (1, 8, True, 100, 96),  # hits the cap: the window loop, then the tail
    (1, 4, False, 100, 64),  # the same, nucleus
]


@pytest.mark.parametrize("req,k,greedy,cap,Lc", LOOP_CASES,
                         ids=[f"req{r}-k{k}-{'greedy' if g else 'nucleus'}-cap{c}-L{n}"
                              for r, k, g, c, n in LOOP_CASES])
def test_device_loop_token_exact_with_jax(setup, req, k, greedy, cap, Lc):
    vocab, tvocab, jmodel, params, tmodel, (src, span_types, n_spans, no_whole) = setup
    args = (src[req : req + 1], span_types[req : req + 1], n_spans[req : req + 1],
            no_whole[req : req + 1])
    kw = dict(max_tgt_len=Lc, span_cap=cap, greedy=greedy, nucleus_p=None if greedy else 0.9,
              draft_k=k)
    rng = jax.random.PRNGKey(29 + req)
    want = JDecoder(jmodel, vocab, fused=False, **kw)(params, *args, rng)
    draws = {}
    if not greedy:  # JAX v5's own draws (infer/decode.py:495-497)
        g_rng, u_rng = jax.random.split(rng)
        draws = dict(noise=np.asarray(jax.random.gumbel(g_rng, (Lc, vocab.vocab_size), jnp.float32)),
                     uniforms=np.asarray(jax.random.uniform(u_rng, (Lc,), jnp.float32)))
    ds.reset_counts()
    dg.reset_counts()
    got = InfillDecoder(tmodel, tvocab, fused=True, **kw)(*args, **draws)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert got.steps == int(want.steps)
    # the device-state loop ran: the sampler's twin, one verify a step
    assert ds.spec_advance_reference.calls == ds.fused_verify_window_reference.calls + 1
    if Lc < L:
        assert int(got.lengths[0]) == Lc and got.steps == Lc - 1


# ----------------------------------------------------------------------
# (b) planted iterations against a transcription of JAX's body
# ----------------------------------------------------------------------
D_PLANT, MAX_LEN, MAX_SPANS, SPAN_CAP = 16, 512, 16, 12


def jax_build_draft(out_row, pos, src_row, K):
    """JAX ``build_draft`` (infer/decode.py:509-534), as written there."""
    L, S = out_row.shape[0], src_row.shape[0]
    jj_out, jj_src = jnp.arange(L), jnp.arange(S)
    src_shift = jnp.concatenate([jnp.zeros((1,), jnp.int32), src_row[:-1]])
    key0 = out_row[jnp.maximum(pos - 1, 0)]
    key1 = out_row[pos]
    out_shift = jnp.concatenate([jnp.zeros((1,), jnp.int32), out_row[:-1]])
    m_out = (out_shift == key0) & (out_row == key1) & (jj_out >= 1) & (jj_out <= pos - 1)
    j_out = jnp.max(jnp.where(m_out, jj_out, -1))
    m_src = (src_shift == key0) & (src_row == key1) & (jj_src >= 1) & (src_row != 0)
    j_src = jnp.max(jnp.where(m_src, jj_src, -1))
    d_out = jax.lax.dynamic_slice(out_row, (jnp.clip(j_out + 1, 0, L - K),), (K,))
    d_src = jax.lax.dynamic_slice(src_row, (jnp.clip(j_src + 1, 0, S - K),), (K,))
    return jnp.where(j_out >= 0, d_out,
                     jnp.where(j_src >= 0, d_src, jnp.zeros((K,), jnp.int32)))


def jax_iteration(p, window, logits, g, u, greedy, nucleus_p=0.9, temperature=1.0):
    """One pass of JAX's loop body after the verify (:539-651; W = 1 is the
    tail's body :660-698), then the next window and its rows as the next
    pass builds them (:471-474, :541-542).  ``p``: the planted scenario."""
    t, (state_masks, sid_from_bits, next_bits) = p["jt"], p["jfast"]
    out, src = jnp.asarray(p["out"]), jnp.asarray(p["src"])
    pos, done, state, steps, span, lengths = (int(v) for v in p["carry"][:6])
    span_types, n_spans, no_whole = jnp.asarray(p["span_types"])[None], p["n_spans"], p["no_whole"]
    W, L = len(window), out.shape[0]
    K = W - 1
    logits_w = jnp.asarray(logits)[:, : t.vocab_size]
    W_iota = jnp.arange(W)
    if K > 0 and not done and pos + 1 + K < L:
        draft = jnp.asarray(window[1:])

        def chain(c, w):
            st, c_steps, c_span = c
            ended = w == t.mask_index
            st2 = jnp.where(ended, 0, jg.update_bits(next_bits, st[None], w[None])[0])
            steps2 = jnp.where(ended, 1, c_steps + 1)
            span2 = jnp.where(ended, c_span + 1, c_span)
            return (st2, steps2, span2), (st2, steps2, span2)

        _, (st_seq, steps_seq, span_seq) = jax.lax.scan(
            chain, (jnp.int32(state), jnp.int32(steps), jnp.int32(span)), draft)
        states = jnp.concatenate([jnp.int32(state)[None], st_seq])
        steps_w = jnp.concatenate([jnp.int32(steps)[None], steps_seq])
        spans_w = jnp.concatenate([jnp.int32(span)[None], span_seq])
        cur_type = span_types[0, jnp.minimum(spans_w, MAX_SPANS - 1)]
        allowed = jg.allowed_mask_fast(state_masks, sid_from_bits, states, steps_w == 1, cur_type,
                                       no_whole, start_overrides=(t.mode == 1))
        if greedy:
            sampled = js.greedy_sample(logits_w, allowed)
        else:
            proposals = jnp.concatenate([jnp.maximum(draft, 0), jnp.zeros((1,), jnp.int32)])
            spec_tok, _ = js.spec_accept_resample(u, g, logits_w, allowed, proposals, nucleus_p,
                                                  temperature)
            plain_tok = js.masked_sample_gumbel(g, logits_w, allowed, nucleus_p, temperature)
            sampled = jnp.where(W_iota == K, plain_tok, spec_tok)
        control_done = (cur_type != jg.SPAN_BODY) & (steps_w >= 2)
        end_span = (sampled == t.eos_index) | (steps_w >= SPAN_CAP) | control_done
        new_span = jnp.where(end_span, spans_w + 1, spans_w)
        now_done = new_span >= n_spans
        next_tok = jnp.where(end_span, t.mask_index, sampled)
        next_tok = jnp.where(now_done, 0, next_tok)
        match = jnp.concatenate([next_tok[:K] == draft, jnp.zeros((1,), bool)])
        keep = (match & ~now_done).astype(jnp.int32)
        prefix_ok = jnp.concatenate([jnp.ones((1,), jnp.int32), jnp.cumprod(keep)[:K]]).astype(bool)
        emit = prefix_ok
        m = int(jnp.sum(emit.astype(jnp.int32)))
        e = jnp.where(emit, next_tok, 0)
        out = jax.lax.dynamic_update_slice(out, e.astype(out.dtype), (pos + 1,))
        cand = jnp.where(emit & (next_tok != 0), pos + W_iota + 2, 0)
        lengths = int(jnp.maximum(lengths, jnp.max(cand)))
        st_post = jnp.where(end_span, 0, jg.update_bits(next_bits, states, sampled))
        steps_post = jnp.where(end_span, 1, steps_w + 1)
        last = max(m - 1, 0)
        pos, done = pos + m, bool(done | bool(now_done[last]))
        state, steps, span = int(st_post[last]), int(steps_post[last]), int(new_span[last])
    elif K == 0 and not done and pos + 1 < L:
        cur_type = span_types[0, jnp.minimum(span, MAX_SPANS - 1)]
        allowed = jg.allowed_mask_fast(
            state_masks, sid_from_bits, jnp.int32(state)[None], (jnp.int32(steps) == 1)[None],
            cur_type[None], no_whole, start_overrides=(t.mode == 1))
        if greedy:
            sampled = js.greedy_sample(logits_w, allowed)[0]
        else:
            sampled = js.masked_sample_gumbel(g, logits_w, allowed, nucleus_p, temperature)[0]
        control_done = (cur_type != jg.SPAN_BODY) & (steps >= 2)
        end_span = (sampled == t.eos_index) | (steps >= SPAN_CAP) | control_done
        new_span = jnp.where(end_span, span + 1, span)
        now_done = new_span >= n_spans
        next_tok = jnp.where(end_span, t.mask_index, sampled)
        next_tok = jnp.where(now_done, 0, next_tok)
        out = out.at[pos + 1].set(next_tok)
        lengths = int(jnp.where(next_tok != 0, pos + 2, lengths))
        state = int(jnp.where(end_span, 0, jg.update_bits(next_bits, jnp.int32(state)[None],
                                                          sampled[None])[0]))
        steps, span = int(jnp.where(end_span, 1, steps + 1)), int(new_span)
        pos, done = pos + 1, bool(done | bool(now_done))
    win = [int(out[pos])] + ([int(v) for v in jax_build_draft(out, pos, src, K)] if K else [])
    emb, pos_table = jnp.asarray(p["emb"]), jnp.asarray(p["pos_table"])
    x = emb[jnp.asarray(win)] * math.sqrt(D_PLANT) + jax.lax.dynamic_slice_in_dim(pos_table, pos, W, 0)
    return dict(carry=[pos, int(done), state, steps, span, lengths], out=np.asarray(out),
                window=win, x=np.asarray(x.astype(jnp.float32)))


def _allowed(p, state, steps, span):
    """The grammar row of one slot under the port's tables (for planting)."""
    sm, sid, _ = p["tfast"]
    cur = torch.tensor([p["span_types"][min(span, MAX_SPANS - 1)]])
    row = tg.allowed_mask_fast(torch.as_tensor(sm), torch.as_tensor(sid), torch.tensor([state]),
                               torch.tensor([steps == 1]), cur, bool(p["no_whole"]),
                               start_overrides=p["jt"].mode == 1)[0]
    return row.numpy()


def plant(mode, scenario, greedy, seed=0):
    """A scenario's carry, stream, source, window and logits.  Drafts are
    sequences the grammar allows slot by slot (each slot's state the chain's),
    planted where the draft lookup finds them; the logits peak (+20) on each
    slot's draft up to the slot that rejects, which peaks on another allowed
    token."""
    rng = np.random.default_rng(seed + 17 * mode)
    vocab = WordVocab(mode, CONTROL_SETS[5])
    tvocab = TWordVocab(mode, CONTROL_SETS[5])
    jt, tt = jg.GrammarTables.build(vocab), tg.GrammarTables.build(tvocab)
    V, vpad = tvocab.vocab_size, ds.vocab_pad(tvocab.vocab_size)
    p = dict(jt=jt, jfast=tuple(jnp.asarray(a) for a in jg.build_fast_tables(jt)),
             tfast=tg.build_fast_tables(tt), vpad=vpad, V=V, mask=tvocab.mask_index,
             eos=tvocab.eos_index)
    nb = p["tfast"][2]
    K = 0 if scenario == "tail" else 8
    W, Lp = K + 1, 128
    p["span_types"] = np.where(rng.random(MAX_SPANS) < 0.7, jg.SPAN_BODY,
                               rng.integers(1, 4, MAX_SPANS)).astype(np.int32)
    p["span_types"][:3] = jg.SPAN_BODY
    p["no_whole"] = bool(rng.random() < 0.5)
    p["n_spans"] = 2 if scenario == "done_mid_window" else 12
    pos = {"one_short": Lp - W - 1, "no_fit": Lp - W, "tail": Lp - 3}.get(scenario, 40)
    # the draft: each token allowed under its slot's chained state; an m_0
    # inside it where the scenario asks, at the slot that reaches the span
    # cap (so it ends its span whatever it samples)
    m0_at = {"m0_in_draft": 2, "done_mid_window": 2}.get(scenario, -1)
    state, steps, span = 0, (SPAN_CAP - m0_at if m0_at >= 0 else 3), 1
    sts, ste, spn, draft = [state], [steps], [span], []
    for j in range(K):
        if j == m0_at:
            w = p["mask"]
        else:
            ok = np.flatnonzero(_allowed(p, sts[j], ste[j], spn[j]))
            ok = ok[(ok != p["eos"]) & (ok != p["mask"])]
            w = int(rng.choice(ok))
        draft.append(w)
        ended = w == p["mask"]
        sts.append(0 if ended else int(nb[sts[j], w]))
        ste.append(1 if ended else ste[j] + 1)
        spn.append(spn[j] + int(ended))
    if scenario == "none":
        draft = [0] * K
    out = np.zeros(Lp, np.int32)
    out[0] = p["mask"]
    out[1 : pos + 1] = rng.integers(3, V, pos)
    src = rng.integers(3, V, 200).astype(np.int32)
    src[150:] = 0
    key0, key1 = out[pos - 1], out[pos]
    if scenario in ("stream", "m0_in_draft", "done_mid_window", "one_short", "no_fit"):
        j0 = 10  # an earlier bigram, the draft after it
        out[j0 - 1 : j0 + 1] = key0, key1
        out[j0 + 1 : j0 + 1 + K] = draft
    elif scenario == "source":
        src[60 : 62] = key0, key1
        src[62 : 62 + K] = draft
    # no other occurrence of the bigram where the draft should not come from
    p["out"], p["src"] = out, src
    reject = {"stream": 3, "source": K, "none": 0, "m0_in_draft": 5, "done_mid_window": K,
              "one_short": K, "no_fit": K, "tail": 0}[scenario]
    logits = rng.standard_normal((W, vpad)).astype(np.float32)
    logits[:, V:] = -1e9
    for j in range(W):
        if j < reject and j < K and draft[j] != p["mask"]:
            logits[j, draft[j]] = 20.0
        elif j == reject:
            ok = np.flatnonzero(_allowed(p, sts[j], ste[j], spn[j]))
            ok = ok[(ok != (draft[j] if j < K else -1)) & (ok != p["eos"])]
            logits[j, int(rng.choice(ok))] = 20.0
    p["carry"] = np.array([pos, 0, state, steps, span, pos + 1, 0, 0], np.int32)
    p["window"] = np.array([out[pos]] + list(draft), np.int32)
    p["logits"] = logits
    noise = rng.gumbel(size=(Lp, vpad)).astype(np.float32)
    noise[:, V:] = 0.0
    p["noise"], p["uniforms"] = noise, rng.random(Lp).astype(np.float32)
    p["emb"] = rng.standard_normal((V, D_PLANT)).astype(np.float32)
    p["pos_table"] = sinusoidal_table(MAX_LEN, D_PLANT).numpy()
    p["greedy"] = greedy
    return p


def twin(p, carry=None, window=None, prime=False):
    tt = lambda a, dt=torch.int32: torch.as_tensor(np.asarray(a), dtype=dt)
    fast = tuple(torch.as_tensor(a) for a in p["tfast"])
    g = p["greedy"]
    return ds.spec_advance_reference(
        None if prime else torch.as_tensor(p["logits"]), tt(p["carry"] if carry is None else carry),
        tt(p["out"]), tt(p["window"] if window is None else window), tt(p["src"]),
        tt(p["span_types"]), tt([p["n_spans"], int(p["no_whole"])]), fast,
        None if g else torch.as_tensor(p["noise"]), None if g else torch.as_tensor(p["uniforms"]),
        torch.as_tensor(p["emb"]), torch.as_tensor(p["pos_table"]), mode=p["jt"].mode,
        max_spans=MAX_SPANS, span_cap=SPAN_CAP, eos_index=p["eos"], mask_index=p["mask"],
        nucleus_p=None if g else 0.9, temperature=1.0, greedy=g, span_body=tg.SPAN_BODY,
        compute_dtype=torch.float32, prime=prime)


SCENARIOS = ["stream", "source", "none", "m0_in_draft", "done_mid_window", "one_short", "no_fit",
             "tail"]


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "nucleus"])
@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("mode", [0, 1], ids=["smer", "remi"])
def test_planted_iteration_equals_jax_body(mode, scenario, greedy):
    p = plant(mode, scenario, greedy)
    W = len(p["window"])
    pos = int(p["carry"][0])
    g = None if greedy else jnp.asarray(p["noise"][pos : pos + W, : p["V"]])
    u = None if greedy else jnp.asarray(p["uniforms"][pos : pos + W])
    want = jax_iteration(p, p["window"], p["logits"], g, u, greedy)
    got = twin(p)
    assert got["carry"][:6].tolist() == want["carry"]
    np.testing.assert_array_equal(got["out"].numpy(), want["out"])
    assert got["window"].tolist() == want["window"]
    np.testing.assert_array_equal(got["x"].numpy(), want["x"])
    assert got["kv_rows"].tolist() == list(range(pos, pos + W))
    # what each scenario plants
    m = want["carry"][0] - pos
    K = W - 1
    if scenario == "stream":
        assert m == 4
    elif scenario in ("source", "one_short"):
        assert m == W  # every draft accepted, then the bonus token
    elif scenario == "none":
        assert m == 1 and p["window"][1:].tolist() == [0] * K
    elif scenario == "m0_in_draft":
        assert m == 6 and want["out"][pos + 3] == p["mask"]
    elif scenario == "done_mid_window":
        assert m == 3 and want["carry"][1] == 1 and want["out"][pos + 3] == 0
    elif scenario in ("no_fit",):
        assert m == 0 and np.array_equal(want["out"], p["out"])
    elif scenario == "tail":
        assert m == 1
    if scenario == "one_short":  # the next window no longer fits: a no-op
        nxt = twin(p, carry=got["carry"].numpy(), window=got["window"].numpy())
        assert torch.equal(nxt["carry"], got["carry"])


@pytest.mark.parametrize("mode", [0, 1], ids=["smer", "remi"])
def test_no_op_after_done_or_past_the_cap(mode):
    """An iteration whose carry is done, or whose window no longer fits
    (pos + W >= L), samples nothing: carry and stream unchanged, the same
    window and rows as a prime of that carry, at every replay."""
    p = plant(mode, "stream", greedy=False)
    done = p["carry"].copy()
    done[1] = 1
    late = p["carry"].copy()
    late[0] = len(p["out"]) - len(p["window"])
    for carry in (done, late):
        a = twin(p, carry=carry)
        prime = twin(p, carry=carry, prime=True)
        assert a["carry"].tolist() == carry.tolist()
        np.testing.assert_array_equal(a["out"].numpy(), p["out"])
        for k in ("window", "x", "kv_rows"):
            assert torch.equal(a[k], prime[k]), k
        b = twin(p, carry=a["carry"].numpy(), window=a["window"].numpy())
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "nucleus"])
def test_loop_steps_once_past_the_end(setup, monkeypatch, greedy):
    """The host reads (position, done) back one iteration behind the steps
    it queues: each phase takes exactly one step past its end, and that
    step changes neither the carry nor the stream.  A second decode finds
    its graph in the decoder's cache and decodes alike."""
    _, tvocab, _, _, tmodel, (src, span_types, n_spans, no_whole) = setup
    args = (src[1:2], span_types[1:2], n_spans[1:2], no_whole[1:2])
    log = []
    inner = dg.SpecGraph.step

    def spy(self, W):
        before = (self.carry.clone(), self.out.clone())
        inner(self, W)
        log.append((W, not torch.equal(before[0], self.carry) or not torch.equal(before[1], self.out)))

    monkeypatch.setattr(dg.SpecGraph, "step", spy)
    dec = InfillDecoder(tmodel, tvocab, fused=True, max_tgt_len=96, span_cap=100, greedy=greedy,
                        nucleus_p=None if greedy else 0.9, draft_k=8)
    first = dec(*args, generator=torch.Generator().manual_seed(3))
    assert decode_mod.SPEC_AHEAD == 2
    for W in (9, 1):
        moved = [m for w, m in log if w == W]
        assert moved and all(moved[:-1]) and not moved[-1], (W, moved)
    log.clear()
    again = dec(*args, generator=torch.Generator().manual_seed(3))
    assert dec.graphs.hits == 1 and dec.graphs.misses == 1
    assert torch.equal(first.tokens, again.tokens) and first.steps == again.steps
