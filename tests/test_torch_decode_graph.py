"""The decode graph (``ops/decode_graph.py``) on the CPU: what a CUDA graph of
a v3 token or a v4 chunk captures, and the decoder loops that replay it.

(a) The launch plan (``decode_step.launch_tokens``) is free of the position:
    recorded through a stub library at two positions, every launch's
    arguments are the same, so one capture serves every token.
(b) The twins take the position as an int32 tensor and give what they give
    with a host int.
(c) The writes by position tensor (the sampler's output column, the cache's
    ``index_copy_``, the advance of the position) equal the old slice writes
    by host int, over several steps: through the twins (the CPU step of
    ``DecodeGraph``) and through the launch plan itself, run on CPU tensors
    by a host stand-in for the library (``HostLib`` of
    ``test_torch_decode_tiles``, with the two token kernels added).
    A graph loaded with a second decode's inputs (as a cached graph is on
    the card) runs it as a new graph does.
(d) The v3 and v4 decoder loops, which step a ``DecodeGraph``, are still
    token-exact with JAX's ``_decode_v3`` / ``_decode_v4`` (Pallas in
    interpret mode), here on int8 weights.
(e) The decoder's ``GraphCache``: a decode finds the graph of its (B,
    source rows) key, the least recently used goes past the bound, new
    weights drop every graph, and a decoder's second decode on reused
    buffers equals a new decoder's.

Shapes: d_model 128, 2 heads (head_dim 64), 2 decoder layers, d_ff 256,
B <= 4, SMER and REMI; inputs made with numpy from a seed.  Tolerance: every
comparison is exact (the two sides run the same arithmetic).
"""

import math

import jax
import numpy as np
import pytest
import torch

from smer_music_generation_tpu.infer.decode import InfillDecoder as JDecoder
from smer_music_generation_tpu.vocab import CONTROL_SETS, WordVocab
from smer_music_generation_tpu_torch.infer import grammar as tg
from smer_music_generation_tpu_torch.infer.decode import CHUNK_SLOP, InfillDecoder
from smer_music_generation_tpu_torch.infer.engine import InfillEngine
from smer_music_generation_tpu_torch.ops import decode_graph as dg
from smer_music_generation_tpu_torch.ops import decode_step as ds
from smer_music_generation_tpu_torch.vocab import WordVocab as TWordVocab
from tests.test_torch_decode_tiles import HostLib
from tests.test_torch_decode_token import _random_state
from tests.torch_port_helpers import model_pair, serving_events

L = 256  # self cache rows
S = 200  # cross rows
L_LOOP = 512  # the decoder loops' max_tgt_len: JAX's fused decode takes multiples of 512
MAX_SPANS, SPAN_CAP = 16, 12


@pytest.fixture(scope="module", params=[0, 1], ids=["smer", "remi"])
def setup(request):
    mode = request.param
    vocab = WordVocab(mode, CONTROL_SETS[5])
    tvocab = TWordVocab(mode, CONTROL_SETS[5])
    jmodel, params, tmodel = model_pair(vocab.vocab_size, seed=91 + mode)
    vpad = ds.vocab_pad(vocab.vocab_size)
    tt = tg.GrammarTables.build(tvocab)
    tables = {k: torch.from_numpy(v) for k, v in
              ds.pack_sampling_tables(tvocab, tt, tg.build_fast_tables(tt), vpad).items()}
    return vocab, tvocab, jmodel, params, tmodel, vpad, tables


def _kernel_packed(tmodel, vpad, quant, dtype=torch.bfloat16):
    """The packed weights as the card gets them: matrices and embedding in
    the model's compute dtype ``dtype`` (bf16, or f32 as packed; int8
    matrices); the f32 logits and the f32 strips as packed."""
    packed = ds.pack_decoder_weights(tmodel, vpad, quant=quant)
    keys = ("emb",) if quant == "int8" else ("w_attn", "w_ff1", "w_ff2", "emb")
    for k in keys:
        packed[k] = packed[k].to(dtype)
    return packed


def _inputs(tmodel, tvocab, vpad, B, seed, *, greedy, dtype=torch.bfloat16):
    """(state, aux, span_types, noise, cache, cross_kv, cross_len) in
    ``dtype`` caches, a live row 0, Gumbel noise for L + 64 positions."""
    cfg = tmodel.cfg
    nl, D = cfg.num_decoder_layers, cfg.d_model
    rng = np.random.default_rng(seed)
    state, aux, span_types = (torch.from_numpy(a) for a in
                              _random_state(rng, B, tvocab.vocab_size))
    state[ds.ST_DONE, 0] = 0
    noise = None if greedy else torch.from_numpy(
        rng.gumbel(size=(L + 64, B, vpad)).astype(np.float32))
    cache = torch.from_numpy(rng.normal(size=(nl, B, L, 2 * D)).astype(np.float32)).to(dtype)
    cross_kv = torch.from_numpy(rng.normal(size=(nl, B, S, 2 * D)).astype(np.float32)).to(dtype)
    cross_len = torch.tensor([S - 37 * b for b in range(B)], dtype=torch.int32)
    return state, aux, span_types, noise, cache, cross_kv, cross_len


def _statics(tmodel, tvocab, vpad, greedy):
    cfg = tmodel.cfg
    kw = dict(n_layers=cfg.num_decoder_layers, d_model=cfg.d_model, nhead=cfg.nhead,
              d_ff=cfg.d_ff, vpad=vpad)
    skw = dict(mode=tvocab.mode, max_spans=MAX_SPANS, span_cap=SPAN_CAP,
               eos_index=tvocab.eos_index, mask_index=tvocab.mask_index,
               nucleus_p=None if greedy else 0.9, temperature=1.0, greedy=greedy,
               n_sid=tg.N_SID, span_body=tg.SPAN_BODY)
    return kw, skw


class RecordingLib:
    """Records every entry point's name and arguments; launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("smer_"):
            raise AttributeError(name)

        def launch(*args):
            self.calls.append((name, args))
            return 0

        return launch


class GraphHostLib(HostLib):
    """``HostLib`` plus the two token kernels of ``csrc/decode_token.cu``,
    with the twins' math, reading the position from the (B,) int32 vector
    at its pointer, as the kernels do: the embedding at position pos[b] +
    offset, the sampler's noise row and length there, its token into the
    output at column position + 1, the state in place, then pos += advance,
    and the sampler's fold: the next token's input row at position + 1
    into x.  ``embeds`` counts the embedding launches."""

    def __init__(self):
        super().__init__()
        self.embeds = 0

    def _ints(self, ptr, n):
        return self._mat(ptr, 1, n, n, torch.int32)[0]

    def _embed_rows(self, emb, emb_f32, vpad, D, scale, tokens, index, x, B):
        assert abs(scale / math.sqrt(D) - 1) < 1e-6  # sqrt(D) as an f32
        table = self._mat(emb, vpad, D, D, torch.float32 if emb_f32 else torch.bfloat16)
        self._mat(x, B, D, D, torch.float32).copy_(ds.embed_pe_reference(table, tokens, index, D))

    def smer_embed_pe(self, B, D, tokens, emb, emb_f32, vpad, scale, pos, pos_offset, neg_log, x,
                      stream):
        self.embeds += 1
        p = self._ints(pos, B) + pos_offset
        assert (p == p[0]).all()
        self._embed_rows(emb, emb_f32, vpad, D, scale, self._ints(tokens, B), int(p[0]), x, B)
        return 0

    def smer_sample_advance(self, B, vpad, logits, state, aux, span_types, sid, masks, cls, noise,
                            pos, pos_offset, advance, out, ld_out, mode, max_spans, span_cap,
                            eos_index, mask_index, use_nucleus, nucleus_p, temperature, n_sid,
                            span_body, emb, emb_f32, D, scale, neg_log, x, stream):
        row_pos = self._ints(pos, B)
        index = row_pos + pos_offset
        assert (index == index[0]).all()
        index = int(index[0])
        st = self._mat(state, 6, B, B, torch.int32)
        tables = {"sid_tbl": self._ints(sid, 16),
                  "state_masks_f": self._mat(masks, 2 * n_sid, vpad, vpad, torch.float32),
                  "class_mat": self._mat(cls, vpad, 8, 8, torch.float32)}
        rows = None if noise is None else self._mat(
            noise, (index + 1) * B, vpad, vpad, torch.float32).reshape(index + 1, B, vpad)
        new = ds.sample_and_advance_reference(
            self._mat(logits, B, vpad, vpad, torch.float32), st.clone(),
            self._mat(aux, 2, B, B, torch.int32), self._mat(span_types, B, max_spans, max_spans,
                                                            torch.int32),
            rows, index, tables, mode=mode, max_spans=max_spans, span_cap=span_cap,
            eos_index=eos_index, mask_index=mask_index,
            nucleus_p=nucleus_p if use_nucleus else None, temperature=temperature,
            greedy=noise is None, n_sid=n_sid, span_body=span_body)
        st.copy_(new)
        if out is not None:
            self._mat(out, B, index + 2, ld_out, torch.int32)[:, index + 1] = new[ds.ST_TOKEN]
        if advance:
            row_pos += advance
        if x is not None:  # the fold: the next token's row at position + 1
            self._embed_rows(emb, emb_f32, vpad, D, scale, new[ds.ST_TOKEN], index + 1, x, B)
        return 0


# ----------------------------------------------------------------------
# (a) the launch plan is free of the position
# ----------------------------------------------------------------------
PLAN_CASES = [  # (T_chunk or None for v3, quant, greedy)
    (None, "none", False),
    (None, "int8", True),
    (8, "none", False),
    (4, "int8", False),
]


@pytest.mark.parametrize("T,quant,greedy", PLAN_CASES,
                         ids=[f"{'v3' if t is None else f'v4-T{t}'}-{q}-{'greedy' if g else 'nucleus'}"
                              for t, q, g in PLAN_CASES])
def test_launch_plan_is_free_of_the_position(setup, T, quant, greedy):
    """Every argument of every launch of a token (or chunk) is the same at
    position 5 and at 300, in an eager call's plan and in a graph's body:
    the position reaches the kernels only through the (B,) vector's
    pointer.  An eager call embeds its first token (one ``smer_embed_pe``
    at its head), a graph's body none; each token's sampler writes the
    next token's input row into the x the layers read.  Control: the v2
    launches with a host position do see it."""
    _, tvocab, _, _, tmodel, vpad, tables = setup
    B = 3
    packed = _kernel_packed(tmodel, vpad, quant)
    kw, skw = _statics(tmodel, tvocab, vpad, greedy)
    state, aux, span_types, noise, cache, cross_kv, cross_len = _inputs(
        tmodel, tvocab, vpad, B, 7, greedy=greedy)
    n = 1 if T is None else T
    work = ds.token_work(B, kw["d_model"], kw["d_ff"], vpad, kw["n_layers"], T, cache.dtype,
                         state.device)
    out = torch.zeros(B, L + 1, dtype=torch.int32)
    pos = torch.zeros(B, dtype=torch.int32)
    rows = 320 + n  # the graph's cache: positions 300.. fit it
    graph = dg.DecodeGraph(packed, tables, state.clone(), aux, span_types, noise,
                           torch.zeros(kw["n_layers"], B, rows, 2 * kw["d_model"],
                                       dtype=cache.dtype), cross_kv, cross_len,
                           torch.zeros(B, rows + 1, dtype=torch.int32), T_chunk=T, **kw, **skw)
    plans = {"eager": [], "graph": []}
    for p in (5, 300):
        pos.fill_(p)
        lib = RecordingLib()
        ds.launch_tokens(lib, packed, tables, state, aux, span_types, noise, cache, cross_kv, pos,
                         cross_len, work, T=T, stream=0, embed_first=True, out=out, **kw, **skw)
        plans["eager"].append(lib.calls)
        graph.pos.fill_(p)
        lib = RecordingLib()
        graph._body(lib, 0)
        plans["graph"].append(lib.calls)
    nl = kw["n_layers"]
    for plan, embeds, x in (("eager", 1, work["x"]), ("graph", 0, graph._work["x"])):
        first, second = plans[plan]
        assert first == second, plan
        names = [name for name, _ in first]
        # each LayerNorm the tail of a row-vector launch; the embedding in the sampler
        assert len(names) == embeds + n * (8 * nl + 2), plan
        assert "smer_add_layernorm" not in names
        assert names.count("smer_embed_pe") == embeds
        assert names[:embeds] == ["smer_embed_pe"] * embeds
        assert names.count("smer_sample_advance") == n and names[-1] == "smer_sample_advance"
        assert names.count("smer_attend") == 2 * nl * n
        # the rows each sampler writes are the rows the next token's layers read
        folds = [args[-2] for name, args in first if name == "smer_sample_advance"]
        assert folds == [x.data_ptr()] * n, plan
        assert [args[3] for name, args in first if name == "smer_rowvec"][0] == x.data_ptr()
    # the control: a host position reaches the self-attention by value
    control = []
    for p in (5, 300):
        lib = RecordingLib()
        ds._launch_layers(lib, packed, work["x"], cache, cross_kv, p, cross_len, work["logits"],
                          work["new_kv"] if T is None else work["new_kv"][:, 0],
                          n_layers=nl, D=kw["d_model"], H=kw["nhead"], F=kw["d_ff"], vpad=vpad,
                          stream=0)
        control.append(lib.calls)
    assert control[0] != control[1]


# ----------------------------------------------------------------------
# (b) the twins take a device position
# ----------------------------------------------------------------------
@pytest.mark.parametrize("T", [None, 4], ids=["v3", "v4-T4"])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "nucleus"])
def test_twins_take_a_position_tensor(setup, T, greedy):
    """The CPU wrappers (their twins) and the sampler's twin at an int32
    position tensor equal them at the host int: tokens, state and K|V."""
    _, tvocab, _, _, tmodel, vpad, tables = setup
    B = 3
    packed = ds.pack_decoder_weights(tmodel, vpad)
    kw, skw = _statics(tmodel, tvocab, vpad, greedy)
    state, aux, span_types, noise, cache, cross_kv, cross_len = _inputs(
        tmodel, tvocab, vpad, B, 11, greedy=greedy)
    cache, cross_kv = cache.float(), cross_kv.float()
    for index in (0, 37, L - 8):
        pos = torch.full((B,), index, dtype=torch.int32)
        args = (packed, tables, state, aux, span_types, noise, cache, cross_kv)
        if T is None:
            by_int = ds.fused_decode_token(*args, index, cross_len, **kw, **skw)
            by_pos = ds.fused_decode_token(*args, pos, cross_len, **kw, **skw)
        else:
            by_int = ds.fused_decode_tokens(*args, index, cross_len, **kw, **skw, T_chunk=T)
            by_pos = ds.fused_decode_tokens(*args, pos, cross_len, **kw, **skw, T_chunk=T)
        for a, b in zip(by_int, by_pos):
            assert torch.equal(a, b)
        assert (pos == index).all()  # read, not advanced
        logits = torch.randn(B, vpad, generator=torch.Generator().manual_seed(index))
        sargs = (logits, state, aux, span_types, noise)
        assert torch.equal(ds.sample_and_advance(*sargs, index, tables, **skw),
                           ds.sample_and_advance(*sargs, pos, tables, **skw))


# ----------------------------------------------------------------------
# (c) the writes by position tensor equal the old slice writes
# ----------------------------------------------------------------------
WRITE_CASES = [  # (through, T_chunk, quant, greedy)
    ("twins", None, "none", False),
    ("twins", 4, "none", True),
    ("plan", None, "none", False),
    ("plan", 4, "none", False),
    ("plan", None, "int8", True),
    ("plan", 3, "int8", False),
]


@pytest.mark.parametrize("through,T,quant,greedy", WRITE_CASES,
                         ids=[f"{w}-{'v3' if t is None else f'v4-T{t}'}-{q}-"
                              f"{'greedy' if g else 'nucleus'}" for w, t, q, g in WRITE_CASES])
def test_writes_by_position_equal_slice_writes(setup, through, T, quant, greedy):
    """Steps of a ``DecodeGraph`` from position 3, against the old loop: one
    v3 token at a time at the host's position, then ``out[:, pos + 1] =
    state[ST_TOKEN]`` and ``cache[:, :, pos] = new_kv``.  ``twins``: the
    graph's CPU step against the twins' token; ``plan``: the graph's own
    body (the launch plan it captures, the output written by the sampler,
    the cache by ``index_copy_``) on a host stand-in for the library
    against the same stand-in running single tokens.  State, output,
    every cache row and the position equal exactly; a v4 chunk equals
    T_chunk v3 tokens."""
    _writes_case(setup, through, T, quant, greedy, torch.bfloat16)


F32_WRITE_CASES = [("plan", None, "none", False), ("plan", 4, "none", True),
                   ("plan", 3, "int8", False)]


@pytest.mark.parametrize("through,T,quant,greedy", F32_WRITE_CASES,
                         ids=[f"{w}-{'v3' if t is None else f'v4-T{t}'}-{q}-"
                              f"{'greedy' if g else 'nucleus'}" for w, t, q, g in F32_WRITE_CASES])
def test_writes_by_position_equal_slice_writes_f32(setup, through, T, quant, greedy):
    """The same through the launch plan of an f32 model: f32 caches, f32
    (or int8) matrices and an f32 embedding, which the sampler's fold reads
    as f32 (``smer_sample_advance``'s emb_f32)."""
    _writes_case(setup, through, T, quant, greedy, torch.float32)


def _writes_case(setup, through, T, quant, greedy, dtype):
    _, tvocab, _, _, tmodel, vpad, tables = setup
    B, start, n_steps = 3, 3, 4
    packed = _kernel_packed(tmodel, vpad, quant, dtype) if through == "plan" else \
        ds.pack_decoder_weights(tmodel, vpad, quant=quant)
    kw, skw = _statics(tmodel, tvocab, vpad, greedy)
    state, aux, span_types, noise, cache, cross_kv, cross_len = _inputs(
        tmodel, tvocab, vpad, B, 23, greedy=greedy, dtype=dtype)
    if through == "twins":
        cache, cross_kv = cache.float(), cross_kv.float()
    n = 1 if T is None else T
    out = torch.zeros(B, L, dtype=torch.int32)
    out[:, 0] = tvocab.mask_index
    old = [state.clone(), cache.clone(), out.clone()]
    lib = GraphHostLib()
    graph = dg.DecodeGraph(packed, tables, state, aux, span_types, noise, cache, cross_kv,
                           cross_len, out, T_chunk=T, start=start, **kw, **skw)
    for _ in range(n_steps):
        if through == "twins":
            graph.step()
        else:
            graph._body(lib, 0)
    # the old loop, one token at a time
    st, kv_cache, o = old
    work = ds.token_work(B, kw["d_model"], kw["d_ff"], vpad, kw["n_layers"], None, cache.dtype,
                         state.device)
    for p in range(start, start + n_steps * n):
        if through == "twins":
            st, new_kv = ds.fused_decode_token(packed, tables, st, aux, span_types, noise,
                                               kv_cache, cross_kv, p, cross_len, **kw, **skw)
        else:
            ds.launch_tokens(lib, packed, tables, st, aux, span_types, noise, kv_cache, cross_kv,
                             torch.full((B,), p, dtype=torch.int32), cross_len, work, T=None,
                             stream=0, embed_first=True, **kw, **skw)
            new_kv = work["new_kv"]
        o[:, p + 1] = st[ds.ST_TOKEN]
        kv_cache[:, :, p] = new_kv
    assert torch.equal(state, st)
    assert torch.equal(out, o)
    assert torch.equal(cache, kv_cache)
    assert (graph.pos == start + n_steps * n).all()
    if through == "twins":
        assert graph.host_pos == start + n_steps * n


@pytest.mark.parametrize("T", [None, 4], ids=["v3", "v4-T4"])
def test_reloaded_graph_equals_a_new_one(setup, T):
    """A graph that decoded one request and is loaded with the next (what a
    cached graph does on the card) runs the next exactly as a new graph
    does: its body on the host stand-in, state, output, cache and position
    equal."""
    _, tvocab, _, _, tmodel, vpad, tables = setup
    B = 3
    packed = _kernel_packed(tmodel, vpad, "none")
    kw, skw = _statics(tmodel, tvocab, vpad, False)
    lib = GraphHostLib()
    first, second = (_inputs(tmodel, tvocab, vpad, B, seed, greedy=False) for seed in (5, 6))
    opened = dict(cache_rows=L, cache_dtype=torch.bfloat16, T_chunk=T, **kw, **skw)

    def run(graph, steps=3):
        for _ in range(steps):
            graph._body(lib, 0)

    state, aux, span_types, noise, _, cross_kv, cross_len = second
    with dg.open_graph(dg.GraphCache(), packed, tables, state, aux, span_types, noise, cross_kv,
                       cross_len, **opened) as fresh:
        assert (fresh.out[:, 0] == state[ds.ST_TOKEN]).all() and (fresh.pos == 0).all()
        run(fresh)
    a = first
    with dg.open_graph(dg.GraphCache(), packed, tables, a[0], a[1], a[2], a[3], a[5], a[6],
                       **opened) as reused:
        run(reused, 5)
        reused.load(state, aux, span_types, noise, cross_kv, cross_len)
        run(reused)
    for name in ("state", "out", "cache", "pos"):
        assert torch.equal(getattr(reused, name), getattr(fresh, name)), name
    assert torch.equal(reused._work["x"], fresh._work["x"])


@pytest.mark.parametrize("T", [None, 4], ids=["v3", "v4-T4"])
def test_reloaded_graph_starts_from_loads_x(setup, T):
    """The captured body embeds no token: a graph's first token reads the
    x that ``load`` wrote, the row of the loaded state's token at the
    loaded position, not the row the previous decode's last sampler left.
    Control: the body run from the stale row decodes something else."""
    _, tvocab, _, _, tmodel, vpad, tables = setup
    B, D = 3, tmodel.cfg.d_model
    packed = _kernel_packed(tmodel, vpad, "none")
    kw, skw = _statics(tmodel, tvocab, vpad, False)
    lib = GraphHostLib()
    first, second = (_inputs(tmodel, tvocab, vpad, B, seed, greedy=False) for seed in (8, 9))
    state, aux, span_types, noise, _, cross_kv, cross_len = second
    opened = dict(cache_rows=L, cache_dtype=torch.bfloat16, T_chunk=T, **kw, **skw)
    a = first
    with dg.open_graph(dg.GraphCache(), packed, tables, a[0], a[1], a[2], a[3], a[5], a[6],
                       **opened) as graph:
        for _ in range(4):
            graph._body(lib, 0)
        stale = graph._work["x"].clone()
        graph.load(state, aux, span_types, noise, cross_kv, cross_len, start=7)
        want = ds.embed_pe_reference(packed["emb"], state[ds.ST_TOKEN], 7, D)
        assert torch.equal(graph._work["x"], want) and not torch.equal(stale, want)
        assert lib.embeds == 0  # the body launched no embedding
        graph._body(lib, 0)
        n = 1 if T is None else T
        loaded = graph.state.clone(), graph.out.clone(), graph.cache[:, :, 7 : 7 + n].clone()
        graph.load(state, aux, span_types, noise, cross_kv, cross_len, start=7)
        graph._work["x"].copy_(stale)
        graph._body(lib, 0)
        assert not torch.equal(graph.cache[:, :, 7 : 7 + n], loaded[2])
    # the same token(s) eagerly, embedded at the head of the call
    eager = ds.token_work(B, D, kw["d_ff"], vpad, kw["n_layers"], T, torch.bfloat16,
                          state.device)
    st, out = state.clone(), torch.zeros(B, L, dtype=torch.int32)
    ds.launch_tokens(lib, packed, tables, st, aux, span_types, noise,
                     torch.zeros(kw["n_layers"], B, L, 2 * D, dtype=torch.bfloat16), cross_kv,
                     torch.full((B,), 7, dtype=torch.int32), cross_len, eager, T=T,
                     stream=0, embed_first=True, out=out, **kw, **skw)
    assert lib.embeds == 1
    rows = eager["new_kv"].unsqueeze(2) if T is None else eager["new_kv"].transpose(1, 2)
    assert torch.equal(rows, loaded[2])
    assert torch.equal(st, loaded[0]) and torch.equal(out[:, 8:], loaded[1][:, 8:])


def test_step_past_the_buffers_raises(setup):
    """The host keeps the position's bound: a step that would sample past
    the noise, the cache or the output raises before anything runs."""
    _, tvocab, _, _, tmodel, vpad, tables = setup
    B = 1
    packed = ds.pack_decoder_weights(tmodel, vpad)
    kw, skw = _statics(tmodel, tvocab, vpad, False)
    state, aux, span_types, noise, cache, cross_kv, cross_len = _inputs(
        tmodel, tvocab, vpad, B, 3, greedy=False)
    out = torch.zeros(B, L, dtype=torch.int32)
    graph = dg.DecodeGraph(packed, tables, state, aux, span_types, noise, cache.float(),
                           cross_kv.float(), cross_len, out, T_chunk=4, start=L - 6, **kw, **skw)
    graph.step()  # positions L-6..L-3, output columns up to L-2
    with pytest.raises(ValueError, match="does not fit"):
        graph.step()
    assert graph.host_pos == L - 2 and (graph.pos == L - 2).all()


# ----------------------------------------------------------------------
# (d) the loops through DecodeGraph still match JAX
# ----------------------------------------------------------------------
LOOP_CASES = [  # (token_chunk, greedy, B); JAX's v3/v4 kernels take B of 1, 4 or 8
    (1, False, 4),
    (8, False, 4),
    (8, True, 1),
]


@pytest.mark.parametrize("T,greedy,B", LOOP_CASES,
                         ids=[f"{'v3' if t == 1 else f'v4-T{t}'}-{'greedy' if g else 'nucleus'}-B{b}"
                              for t, g, b in LOOP_CASES])
def test_int8_loops_through_the_graph_match_jax(setup, T, greedy, B):
    """The port's v3 / v4 loop on int8 weights, each token or chunk a
    ``DecodeGraph`` step (its twins on the CPU), against JAX's v3 / v4 loop
    with ``quant="int8"`` in interpret mode: tokens, lengths and steps
    equal; the loop stepped the graph once a token or chunk."""
    vocab, tvocab, jmodel, params, tmodel, vpad, _ = setup
    eng = InfillEngine(tmodel, tvocab, max_tgt_len=L_LOOP, fused=False)
    events = serving_events(tvocab)
    reqs = [eng.prepare(events, [0], [1]), eng.prepare(events, [1], [2, 3]),
            eng.prepare(events, [0, 1], [0]), eng.prepare(events, [0], [5, 6, 7])]
    args = tuple(a[:B] for a in eng._assemble(reqs)[:4])
    kw = dict(max_tgt_len=L_LOOP, span_cap=SPAN_CAP, greedy=greedy,
              nucleus_p=None if greedy else 0.9, quant="int8", token_chunk=T)
    rng = jax.random.PRNGKey(21)
    want = JDecoder(jmodel, vocab, fused=True, fused_sampling=True, interpret=True, **kw)(
        params, *args, rng)
    rows = L_LOOP + (CHUNK_SLOP if T > 1 else 0)
    noise = None if greedy else np.asarray(jax.random.gumbel(rng, (rows, B, vpad), dtype=np.float32))
    steps = []
    step = dg.DecodeGraph.step

    def spy(graph):
        steps.append(graph.host_pos)
        step(graph)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dg.DecodeGraph, "step", spy)
        got = InfillDecoder(tmodel, tvocab, fused=True, **kw)(*args, noise=noise)
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert got.steps == int(want.steps)
    assert steps == list(range(0, T * len(steps), T)) and len(steps) >= got.steps // T


# ----------------------------------------------------------------------
# the decoder's graph cache
# ----------------------------------------------------------------------
def test_graph_cache_keys_and_bound(setup):
    """A ``GraphCache`` hands a decode the graph of its (B, source rows)
    key, captured once: the same key finds the same graph, another B or
    source bucket a new one; past ``size`` the least recently used goes;
    new weights drop every graph."""
    _, tvocab, _, _, tmodel, vpad, tables = setup
    kw, skw = _statics(tmodel, tvocab, vpad, False)
    packed = ds.pack_decoder_weights(tmodel, vpad)
    graphs = dg.GraphCache(size=2)
    opened = dict(cache_rows=L, cache_dtype=torch.float32, **kw, **skw)

    def open_at(B, S_rows, weights=packed):
        state, aux, span_types, noise, _, cross_kv, cross_len = _inputs(
            tmodel, tvocab, vpad, B, 40 + B, greedy=False)
        with dg.open_graph(graphs, weights, tables, state, aux, span_types, noise,
                           cross_kv[:, :, :S_rows].float(), cross_len.clamp(max=S_rows),
                           **opened) as graph:
            return graph

    a = open_at(3, S)
    assert open_at(3, S) is a and (graphs.misses, graphs.hits) == (1, 1)
    b = open_at(2, S)
    c = open_at(3, S // 2)
    assert len({id(a), id(b), id(c)}) == 3 and graphs.misses == 3
    assert list(graphs.graphs.values()) == [b, c]  # a, the least recently used, went
    assert open_at(3, S) is not a and graphs.misses == 4
    assert open_at(2, S) is not b  # b went in its turn
    other = ds.pack_decoder_weights(tmodel, vpad)
    open_at(2, S, other)
    assert len(graphs.graphs) == 1 and graphs.packed is other


@pytest.mark.parametrize("T", [1, 4], ids=["v3", "v4-T4"])
def test_decoder_reuses_its_graphs(setup, T):
    """A decoder's second decode of a batch of the same size and source
    bucket finds the graph of the first and decodes, on the reused
    buffers, what a new decoder decodes: tokens, lengths and steps equal."""
    _, tvocab, _, _, tmodel, vpad, _ = setup
    eng = InfillEngine(tmodel, tvocab, max_tgt_len=L_LOOP, fused=False)
    events = serving_events(tvocab)
    reqs = [[eng.prepare(events, [0], [1]), eng.prepare(events, [1], [2, 3])],
            [eng.prepare(events, [0, 1], [0]), eng.prepare(events, [0], [5, 6, 7])]]
    first, second = (eng._assemble(r)[:4] for r in reqs)
    assert first[0].shape == second[0].shape
    rows = L_LOOP + (CHUNK_SLOP if T > 1 else 0)
    rng = np.random.default_rng(17)
    noise = [rng.gumbel(size=(rows, 2, vpad)).astype(np.float32) for _ in range(2)]
    kw = dict(max_tgt_len=L_LOOP, span_cap=SPAN_CAP, nucleus_p=0.9, token_chunk=T)
    dec = InfillDecoder(tmodel, tvocab, fused=True, **kw)
    dec(*first, noise=noise[0])
    got = dec(*second, noise=noise[1])
    assert (dec.graphs.misses, dec.graphs.hits) == (1, 1)
    want = InfillDecoder(tmodel, tvocab, fused=True, **kw)(*second, noise=noise[1])
    assert torch.equal(got.tokens, want.tokens) and torch.equal(got.lengths, want.lengths)
    assert got.steps == want.steps and want.steps > 0
