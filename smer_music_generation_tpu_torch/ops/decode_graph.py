"""A v3 decode token, a v4 chunk of tokens, or an iteration of speculative
decode, as one CUDA-graph replay.

On the TPU a whole token is one ``pallas_call`` (JAX
``ops/decode_step.py:796``, v4 ``:1028``) inside a device-side
``lax.while_loop`` (JAX ``infer/decode.py:723-765``), three XLA ops a token.
The port's token is 34 hand-written kernel launches
(:func:`~.decode_step.launch_tokens`), each of which costs the host more than
the card spends in it.  :class:`DecodeGraph` captures them once and replays
them once a token (v3) or once a chunk of ``T_chunk`` tokens (v4): the
graph is the counterpart of the TPU's one kernel a token.

:func:`open_graph` is what the decoder calls.  It takes the decoder's
:class:`GraphCache`: the graphs captured for that decoder's
weights and sampling tables, each on buffers of its own, keyed by what else
a graph bakes in: B, the cross rows (the source's padding bucket), the cache
and noise rows, ``T_chunk`` and the sampler's settings (of these only B and
the bucket vary under one decoder).  A decode copies its inputs (state,
aux, span types, noise, cross K/V and lengths) into the graph's buffers,
zeroes its cache and output and replays; only a new key pays the warm-up
and the capture.  (Capturing anew for every decode call, the first design,
cost 5-6% of a served request's wall time at v3 and 19% at v4, whose chunk
of 8 is 384 launches to record; PERF.md.)  The graphs live as long as the
decoder, as JAX's jit keeps its compiled decode loop per shape.

What makes the launches replayable is that the position lives on the
device: ``pos`` (B,) int32, read by the self-attention (as
``attend_kernel``'s per-row lengths, its splits sized from the cache's
capacity) and by ``sample_advance_kernel``, which samples the noise row of
the position, writes the next token into the (B, L) output at column
position + 1, advances the state in place, advances ``pos`` and writes the
next token's input row x at the new position.  So the graph's body starts
from an x that is already there: ``embed_pe_kernel`` writes the first
token's row when a graph is built and in :meth:`DecodeGraph.load`, outside
the captured body, and each replay leaves the next one's.  The K|V rows of
the token go into the cache by a captured ``index_copy_`` at the
position.  The self-attention's splits cover the
cache's capacity, so those past the position hold no row; the merge of
``attend_kernel`` reads only the splits that hold a row (counted from the
row's length alone), so an empty split adds nothing, and a row's bits are
those of the eager launch sized to the position.  The host keeps its own count of the
position only to bound the loop and to check that the next step fits.

Capture: the stream's workspace and tickets (``decode_step._scratch``) are
keyed by (device, stream), so a graph is captured on a side stream of its
cache's own, whose scratch exists before capture (the warm-up makes it),
and the graphs of one cache share it.  So one graph decode of a cache runs
at a time (:func:`open_graph` holds the cache's lock for the decode, which
also guards the graph's buffers); replays run on the caller's current
stream, one after another, each launch leaving its tickets at zero.  Two
decoders share no scratch and no lock.
The first :meth:`DecodeGraph.step` of a decode runs the token's launches
once eagerly on the side stream (the warm-up: loads the kernels, sizes the
scratch), puts back what it wrote (state, position, output, cache rows and
x), then captures.  Nothing inside the capture allocates, loads the library
or reads a device value on the host; the shape checks run before it.  A failed
capture or replay raises: nothing falls back to the eager launches.

Counts: a replay adds one to ``fused_decode_token.launches`` (v3) or
``fused_decode_tokens.launches`` (v4), and the token's int8 row-vector
launches to ``rowvec_int8.launches``, as the eager wrappers count a call;
the warm-up, a real run of the kernels, counts once too.
``DecodeGraph.captures`` and ``DecodeGraph.replays`` count captures and
replays.

:class:`SpecGraph` (with :func:`open_spec_graph`) does the same for the
speculative decode loop at B=1 (JAX ``infer/decode.py:411-702``): one
replay an iteration of the W-row verify, ``spec_advance_kernel`` and the
cache copy, the carry (position, done, grammar state, length), the output
row and the next window living on the device; its docstring says how.

On the CPU the same object runs the twins instead
(:func:`~.decode_step.fused_decode_token_reference`,
:func:`~.decode_step.fused_decode_tokens_reference`) with the same writes
by position tensor, kept in the decoder's :class:`GraphCache` as on the
card, so the CPU tests hold this path and the cache against JAX.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import List, Optional

import torch

from .decode_step import (
    _SCRATCH,
    SPEC_CARRY,
    SPEC_DONE,
    SPEC_POS,
    ST_TOKEN,
    _check_layer_inputs,
    _check_spec_inputs,
    _check_token_inputs,
    _launch_embed_pe,
    _launch_layers,
    _launch_spec_advance,
    _layer_work,
    embed_pe_reference,
    fused_decode_token,
    fused_decode_token_reference,
    fused_decode_tokens,
    fused_decode_tokens_reference,
    fused_verify_window,
    launch_tokens,
    load_library,
    rowvec_int8,
    spec_advance,
    spec_advance_reference,
    token_work,
)

# captured graphs a decoder keeps: under a served mix of batches of 1-8 and
# sources in three buckets (scripts/graph_cache_mix.py) 16 found a graph for
# as many batches as no bound did (83%, against 77% for 8), holding ~1 GB
CACHE_SIZE = 16


class DecodeGraph:
    """One v3 token (``T_chunk`` None) or one v4 chunk of ``T_chunk`` tokens
    a :meth:`step`, at the position held on the device, from ``start``.

    ``state`` (6, B) int32 is advanced in place; ``out`` (B, Lo) int32
    takes token t of a step at column position + t + 1; ``cache`` (n_layers,
    B, Lc, 2D) takes the step's K|V rows at position + t; the input row of
    the first token is written here and by :meth:`load`, each later one by
    the sampler of the token before it.  ``noise``,
    ``aux``, ``span_types``, ``cross_kv`` and ``cross_len`` are read.
    ``stream``: the side stream to capture on (a new one if None).  The
    decoder reaches it through :func:`open_graph`."""

    captures = 0
    replays = 0
    capture_ms: List[float] = []

    def __init__(self, packed, tables, state, aux, span_types, noise, cache, cross_kv, cross_len,
                 out, *, T_chunk: Optional[int] = None, start: int = 0, stream=None,
                 n_layers: int, d_model: int, nhead: int, d_ff: int, vpad: int, **skw):
        self.kw = dict(n_layers=n_layers, d_model=d_model, nhead=nhead, d_ff=d_ff, vpad=vpad)
        self.skw = skw
        self.T = T_chunk
        self.n = 1 if T_chunk is None else int(T_chunk)
        self.packed, self.tables = packed, tables
        self.state, self.aux, self.span_types, self.noise = state, aux, span_types, noise
        self.cache, self.cross_kv, self.cross_len, self.out = cache, cross_kv, cross_len, out
        dev = self.device = state.device
        B = state.shape[1]
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"DecodeGraph runs on cuda or cpu, not {dev}")
        if dev.type == "cuda":  # the kernels' shapes and types; the twins take any
            _check_token_inputs(packed, tables, state, aux, span_types, noise, cache, cross_kv,
                                start, cross_len, self.T, **self.kw, **skw)
        if out.dtype != torch.int32 or out.shape[0] != B or out.device != dev:
            raise ValueError(f"out must be (B={B}, *) int32 on {dev}")
        self.host_pos = int(start)
        self.limit = min(cache.shape[2], out.shape[1] - 1,
                         noise.shape[0] if noise is not None and not skw["greedy"] else cache.shape[2])
        self.pos = torch.full((B,), self.host_pos, dtype=torch.int32, device=dev)
        self._steps = torch.arange(self.n, dtype=torch.int64, device=dev)
        self._rows = torch.empty(self.n, dtype=torch.int64, device=dev)
        self.stream = stream
        self._graph = None
        self._work = token_work(B, d_model, d_ff, vpad, n_layers, self.T, cache.dtype, dev)
        self._embed()

    def load(self, state, aux, span_types, noise, cross_kv, cross_len, start: int = 0) -> None:
        """A new decode's inputs into this graph's buffers (in place, so a
        captured graph reads them), its cache and output zeroed, the
        output's column ``start`` the state's token, the position at
        ``start``."""
        for dst, src in ((self.state, state), (self.aux, aux), (self.span_types, span_types),
                         (self.cross_kv, cross_kv), (self.cross_len, cross_len)):
            if dst.shape != src.shape:
                raise ValueError(f"a decode's input of shape {tuple(src.shape)} into a graph's "
                                 f"buffer of {tuple(dst.shape)}")
            dst.copy_(src)
        if self.noise is not None:
            self.noise.copy_(noise)
        self.cache.zero_()
        self.out.zero_()
        self.out[:, start] = state[ST_TOKEN]
        self.pos.fill_(start)
        self.host_pos = int(start)
        self._embed()

    def _embed(self) -> None:
        """The first token's input row into the graph's x: the state's
        token at the position, by ``embed_pe_kernel`` on the caller's
        stream (its twin on the CPU, where the launch plan runs only on a
        host stand-in for the library)."""
        x = self._work["x"]
        if self.device.type == "cpu":
            x.copy_(embed_pe_reference(self.packed["emb"], self.state[ST_TOKEN], self.pos,
                                       self.kw["d_model"]))
        else:
            _launch_embed_pe(load_library(), self.packed["emb"], self.state, self.pos, x,
                             stream=torch.cuda.current_stream(self.device).cuda_stream)

    # ------------------------------------------------------------------
    def step(self) -> None:
        """One token (v3) or one chunk (v4) at the device's position."""
        if self.host_pos + self.n > self.limit:
            raise ValueError(f"a step of {self.n} tokens at position {self.host_pos} does not fit "
                             f"the cache, noise and output ({self.limit} positions)")
        if self.device.type == "cpu":
            self._twin_step()
        else:
            if self._graph is None:
                self._capture()
            self._graph.replay()
            DecodeGraph.replays += 1
            self._count(self._int8_launches)
        self.host_pos += self.n

    def _count(self, int8_launches: int) -> None:
        """One run of the step's kernels, as the eager wrappers count a call."""
        (fused_decode_token if self.T is None else fused_decode_tokens).launches += 1
        rowvec_int8.launches += int8_launches

    def _body(self, lib, stream: int) -> None:
        """What one replay does: the rows the step writes, the token
        launches, the K|V rows into the cache at the position."""
        torch.add(self._steps, self.pos[:1], out=self._rows)  # before pos advances
        launch_tokens(lib, self.packed, self.tables, self.state, self.aux, self.span_types,
                      self.noise, self.cache, self.cross_kv, self.pos, self.cross_len, self._work,
                      T=self.T, stream=stream, embed_first=False, out=self.out, **self.kw,
                      **self.skw)
        kv = self._work["new_kv"]  # (nl, B, 2D) or (nl, T, B, 2D)
        self.cache.index_copy_(2, self._rows, kv.unsqueeze(2) if self.T is None
                               else kv.transpose(1, 2))

    def _capture(self) -> None:
        lib = load_library()
        if self.stream is None:
            self.stream = torch.cuda.Stream(device=self.device)
        side = self.stream
        cur = torch.cuda.current_stream(self.device)
        p, n = self.host_pos, self.n
        x = self._work["x"]
        saved = (self.state.clone(), self.pos.clone(), self.out.clone(),
                 self.cache[:, :, p : p + n].clone(), x.clone())
        # the warm-up: one real run of the step on the side stream
        before = rowvec_int8.launches
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._body(lib, side.cuda_stream)
        cur.wait_stream(side)
        self._int8_launches = rowvec_int8.launches - before  # counted by the launches
        self._count(0)
        # the graph bakes in the side stream's workspace and tickets
        self._scratch = _SCRATCH[(self.device.index, side.cuda_stream)]
        self.state.copy_(saved[0])
        self.pos.copy_(saved[1])
        self.out.copy_(saved[2])
        self.cache[:, :, p : p + n] = saved[3]
        x.copy_(saved[4])  # the warm-up's sampler wrote the next token's row
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self._body(lib, side.cuda_stream)
            except BaseException:
                graph.capture_end()
                raise
            graph.capture_end()
        DecodeGraph.capture_ms.append(1e3 * (time.perf_counter() - t0))
        rowvec_int8.launches -= self._int8_launches  # the capture launched nothing
        DecodeGraph.captures += 1
        self._graph = graph

    def _twin_step(self) -> None:
        """The step on the CPU: the twins at the position, and the same
        writes by position tensor as the graph's."""
        args = (self.packed, self.tables, self.state, self.aux, self.span_types, self.noise,
                self.cache, self.cross_kv, self.pos, self.cross_len)
        if self.T is None:
            state, kv = fused_decode_token_reference(*args, **self.kw, **self.skw)
            tokens, rows = state[ST_TOKEN][None], kv.unsqueeze(2)
        else:
            state, tokens, kv = fused_decode_tokens_reference(*args, **self.kw, **self.skw,
                                                              T_chunk=self.T)
            rows = kv.transpose(1, 2)
        torch.add(self._steps, self.pos[:1], out=self._rows)
        self.cache.index_copy_(2, self._rows, rows)
        self.out.index_copy_(1, self._rows + 1, tokens.T.to(self.out.dtype))
        self.state.copy_(state)
        self.pos += self.n


class GraphCache:
    """The captured graphs of one decoder (``InfillDecoder`` keeps one), at
    most ``size``, the least recently used dropped first.  It holds the
    weights and tables its graphs bake in and drops every graph when a
    decode brings others; the side stream they are captured on; a lock
    that one decode holds while it loads and replays a graph (two threads
    may call one decoder); and counts of the decodes that found their
    graph (``hits``) and of those that captured one (``misses``)."""

    def __init__(self, size: int = CACHE_SIZE):
        self.size = size
        self.graphs: "OrderedDict[tuple, DecodeGraph]" = OrderedDict()
        self.lock = threading.Lock()
        self.stream = None
        self.packed = self.tables = None
        self.hits = self.misses = 0


@contextlib.contextmanager
def open_graph(graphs: GraphCache, packed, tables, state, aux, span_types, noise,
               cross_kv, cross_len, *, cache_rows: int, cache_dtype, T_chunk: Optional[int] = None,
               start: int = 0, n_layers: int, d_model: int, nhead: int, d_ff: int, vpad: int,
               **skw):
    """A :class:`DecodeGraph` loaded with one decode's inputs, for the
    decode's loop: ``cache_rows`` cache rows (and output columns) in
    ``cache_dtype``, a token (``T_chunk`` None) or a chunk a step.  The
    graph comes from ``graphs`` (a new one for a new key, on CUDA captured
    at its first step), whose lock is held until the block ends: read
    ``state`` and ``out`` inside it, as the next decode overwrites them."""
    kw = dict(n_layers=n_layers, d_model=d_model, nhead=nhead, d_ff=d_ff, vpad=vpad)
    B, dev = state.shape[1], state.device

    def new(stream=None):
        cache = torch.zeros(n_layers, B, cache_rows, 2 * d_model, dtype=cache_dtype, device=dev)
        out = torch.zeros(B, cache_rows, dtype=torch.int32, device=dev)
        return DecodeGraph(packed, tables, state.clone(), aux.clone(), span_types.clone(),
                           None if noise is None else noise.clone(), cache, cross_kv.clone(),
                           cross_len.clone(), out, T_chunk=T_chunk, start=start, stream=stream,
                           **kw, **skw)

    key = (B, cross_kv.shape[2], cache_rows, None if noise is None else noise.shape[0], T_chunk,
           cache_dtype, tuple(sorted(kw.items())), tuple(sorted(skw.items())))
    with graphs.lock:
        if graphs.packed is not packed or graphs.tables is not tables:
            graphs.graphs.clear()
            graphs.packed, graphs.tables = packed, tables
        graph = graphs.graphs.pop(key, None)
        if graph is None:
            graphs.misses += 1
            if graphs.stream is None and dev.type == "cuda":
                graphs.stream = torch.cuda.Stream(device=dev)
            graph = new(graphs.stream)
        else:
            graphs.hits += 1
        graphs.graphs[key] = graph  # the most recently used last
        while len(graphs.graphs) > graphs.size:
            graphs.graphs.popitem(last=False)
        graph.load(state, aux, span_types, noise, cross_kv, cross_len, start)
        yield graph


class SpecGraph:
    """One iteration of speculative decode for one sequence a :meth:`step`:
    the verify of W window rows (``W = draft_k + 1``, or 1 in the tail),
    ``spec_advance_kernel``, and the verify's K|V rows copied into the
    cache, the counterpart of one pass of the body of JAX's device-side
    ``lax.while_loop`` (``infer/decode.py:539-651``, the tail :660-698).

    On CUDA each W is one CUDA graph, captured at its first step and
    replayed at every later one: the verify's 33 launches on the window rows
    ``x`` (the self-attention reading the cache length from ``carry``, its
    splits sized from the cache's capacity), the sampler (a programmatic
    dependent launch behind the logits launch, which writes the carry, the
    output, the draft tables, the next window, its input rows ``x`` and the
    rows ``kv_rows`` the verify's K|V go to), then a captured ``index_copy_`` into the cache
    at ``kv_rows``: 35 nodes, no argument of which depends on the
    position.  The window and tail graphs share every buffer (the tail reads
    the first row of each), so the loop moves from one to the other without
    a copy.  An iteration past the end (done, or a window that no longer
    fits before the cap) changes nothing but the cache rows at and past the
    position, which it writes once with the same K|V at every later replay:
    the host may replay before it reads the carry back.  ``graph=False``
    launches the same body eagerly (the bit reference of the replays).

    The cache has ``L + draft_k`` rows, so that a window at any position
    fits it; the output has L.  On the CPU a step runs the twins with the
    same writes: ``fused_verify_window`` (whose CPU branch is the twin),
    :func:`~.decode_step.spec_advance_reference` and the same
    ``index_copy_``.

    Counts: a step adds one to ``fused_verify_window.launches`` and (on
    CUDA) one to ``spec_advance.launches``, the warm-up of a capture once,
    and :meth:`load`'s first window one more; ``SpecGraph.captures`` and
    ``SpecGraph.replays`` count captures and replays."""

    captures = 0
    replays = 0
    capture_ms: List[float] = []

    def __init__(self, packed, tables, fast_tables, emb, pos_table, *, K: int, L: int, S: int,
                 max_spans: int, compute_dtype, stream=None, graph: bool = True, n_layers: int, d_model: int, nhead: int, d_ff: int,
                 vpad: int, **skw):
        dev = self.device = emb.device
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"SpecGraph runs on cuda or cpu, not {dev}")
        self.kw = dict(n_layers=n_layers, d_model=d_model, nhead=nhead, d_ff=d_ff, vpad=vpad)
        self.skw = dict(skw, max_spans=max_spans)
        self.packed, self.tables, self.fast_tables = packed, tables, fast_tables
        self.emb, self.pos_table, self.cdt = emb, pos_table, compute_dtype
        self.stream, self.use_graph = stream, graph
        self.W = W = K + 1
        D, i32 = d_model, torch.int32
        self.cache = torch.zeros(n_layers, 1, L + K, 2 * D, dtype=compute_dtype, device=dev)
        self.cross_kv = torch.zeros(n_layers, 1, S, 2 * D, dtype=compute_dtype, device=dev)
        self.cross_len = torch.zeros(W, dtype=i32, device=dev)
        self.carry = torch.zeros(SPEC_CARRY, dtype=i32, device=dev)
        self.out = torch.zeros(L, dtype=i32, device=dev)
        self.window = torch.zeros(W, dtype=i32, device=dev)
        self.x = torch.zeros(W, D, device=dev)
        self.kv_rows = torch.zeros(W, dtype=torch.int64, device=dev)
        self.aux = torch.zeros(2, dtype=i32, device=dev)
        self.span_types = torch.zeros(max_spans, dtype=i32, device=dev)
        self.src = torch.zeros(S, dtype=i32, device=dev)
        # the draft's bigram tables spec_advance_kernel keeps (the stream's,
        # the source's: ``decode_step.draft_tables_reference``), set to -1
        # before each decode's prime builds them; the CPU's twin needs none
        self.draft_tbl = (torch.full((2, vpad, vpad), -1, dtype=i32, device=dev)
                          if dev.type == "cuda" else None)
        greedy = skw["greedy"]
        self.noise = None if greedy else torch.zeros(L, vpad, device=dev)
        self.uniforms = None if greedy else torch.zeros(L, device=dev)
        self.work = {}
        for w in sorted({W, 1}):
            wk = _layer_work(w, D, d_ff, dev)
            wk["logits"] = torch.empty(w, vpad, device=dev)
            wk["new_kv"] = torch.empty(n_layers, w, 2 * D, dtype=compute_dtype, device=dev)
            self.work[w] = wk
        self._graphs = {}
        self._scratch = []
        if dev.type == "cuda":
            _check_layer_inputs(packed, 1, dev, self.cache, self.cross_kv, self.cross_len[:1],
                                n_layers, D, nhead, d_ff, vpad)
            _check_spec_inputs(self.carry, self.out, self.window, self.src, self.span_types,
                               self.aux, tables, self.noise, self.uniforms, emb, pos_table,
                               **self.skw)
            # read-backs of (pos, done), each behind the replays queued before it
            self._ring = [torch.zeros(2, dtype=i32, pin_memory=True) for _ in range(4)]
            self._events = [torch.cuda.Event() for _ in self._ring]
            self._marks = 0

    def load(self, src, span_types, aux, noise, uniforms, cross_kv, cross_len) -> None:
        """A new decode's inputs into the buffers (in place, so the captured
        graphs read them): the carry at position 0 (done when the row has no
        span), the output's column 0 ``m_0``, the cache zeroed, then the first
        window and its rows (the sampler with ``prime``: no sampling)."""
        for dst, val in ((self.src, src), (self.span_types, span_types), (self.aux, aux),
                         (self.cross_kv, cross_kv)):
            if dst.shape != val.shape:
                raise ValueError(f"a decode's input of shape {tuple(val.shape)} into a buffer of "
                                 f"{tuple(dst.shape)}")
            dst.copy_(val)
        if self.noise is not None:
            self.noise.copy_(noise)
            self.uniforms.copy_(uniforms)
        self.cross_len.copy_(cross_len.expand(self.W))
        self.cache.zero_()
        self.out.zero_()
        self.out[0] = self.skw["mask_index"]
        self.carry.copy_(torch.tensor([0, int(aux[0] <= 0), 0, 1, 0, 1, 0, 0], dtype=torch.int32))
        self.tables_reset()
        self._advance(None, self.W, prime=True)

    def tables_reset(self) -> None:
        """The draft tables back to -1 (on CUDA, once a decode, before the
        prime rebuilds them)."""
        if self.draft_tbl is not None:
            self.draft_tbl.fill_(-1)

    def _advance(self, logits, W: int, *, prime: bool = False, stream=None) -> None:
        """The sampler over W slots: the kernel on CUDA (on ``stream``), its
        twin on the CPU, writing the same buffers."""
        if self.device.type == "cpu":
            r = spec_advance_reference(logits, self.carry, self.out, self.window[:W], self.src,
                                       self.span_types, self.aux, self.fast_tables, self.noise,
                                       self.uniforms, self.emb, self.pos_table,
                                       compute_dtype=self.cdt, prime=prime, **self.skw)
            for k in ("carry", "out"):
                getattr(self, k).copy_(r[k])
            for k in ("window", "x", "kv_rows"):
                getattr(self, k)[:W].copy_(r[k])
            return
        if stream is None:
            stream = torch.cuda.current_stream(self.device).cuda_stream
        _launch_spec_advance(load_library(), logits, self.carry, self.out, self.window[:W],
                             self.x[:W], self.kv_rows[:W], self.aux, self.span_types, self.tables,
                             self.noise, self.uniforms, self.src, self.emb, self.pos_table,
                             self.draft_tbl, stream=stream, round_bf16=self.cdt == torch.bfloat16,
                             prime=prime, **self.skw)

    # ------------------------------------------------------------------
    def step(self, W: int) -> None:
        """One iteration of W rows (``draft_k + 1`` or the tail's 1) at the
        position in the carry."""
        if W not in self.work:
            raise ValueError(f"a SpecGraph steps W={self.W} or 1 rows, not {W}")
        if self.device.type == "cpu":
            self._twin_step(W)
        elif not self.use_graph:
            self._body(W, torch.cuda.current_stream(self.device).cuda_stream)
            fused_verify_window.launches += 1
        else:
            if W not in self._graphs:
                self._capture(W)
            self._graphs[W].replay()
            SpecGraph.replays += 1
            fused_verify_window.launches += 1
            spec_advance.launches += 1

    def _body(self, W: int, stream: int) -> None:
        """What one replay does: the verify, the sampler, the K|V rows."""
        wk = self.work[W]
        kw = self.kw
        _launch_layers(load_library(), self.packed, self.x[:W], self.cache, self.cross_kv,
                       self.carry[SPEC_POS : SPEC_POS + 1], self.cross_len[:W], wk["logits"],
                       wk["new_kv"], n_layers=kw["n_layers"], D=kw["d_model"], H=kw["nhead"],
                       F=kw["d_ff"], vpad=kw["vpad"], stream=stream, window=True, work=wk)
        self._advance(wk["logits"], W, stream=stream)
        self.cache.index_copy_(2, self.kv_rows[:W], wk["new_kv"].unsqueeze(1))

    def _capture(self, W: int) -> None:
        if self.stream is None:
            self.stream = torch.cuda.Stream(device=self.device)
        side = self.stream
        cur = torch.cuda.current_stream(self.device)
        bufs = (self.carry, self.out, self.window, self.x, self.kv_rows, self.cache, self.draft_tbl)
        saved = [t.clone() for t in bufs]
        # the warm-up: one real run of the body on the side stream, which
        # advances the decode; it is put back before the capture
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._body(W, side.cuda_stream)
        cur.wait_stream(side)
        fused_verify_window.launches += 1
        # the graph bakes in the side stream's workspace and tickets
        self._scratch.append(_SCRATCH[(self.device.index, side.cuda_stream)])
        for t, v in zip(bufs, saved):
            t.copy_(v)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self._body(W, side.cuda_stream)
            except BaseException:
                graph.capture_end()
                raise
            graph.capture_end()
        SpecGraph.capture_ms.append(1e3 * (time.perf_counter() - t0))
        spec_advance.launches -= 1  # the capture launched nothing
        SpecGraph.captures += 1
        self._graphs[W] = graph

    def _twin_step(self, W: int) -> None:
        """The iteration on the CPU: the verify's twin, the sampler's, and
        the same writes as the graph's."""
        logits, new_kv = fused_verify_window(self.packed, self.x[:W].to(self.cdt), self.cache,
                                             self.cross_kv, self.carry[SPEC_POS : SPEC_POS + 1],
                                             self.cross_len[:1], **self.kw)
        self._advance(logits, W)
        self.cache.index_copy_(2, self.kv_rows[:W], new_kv.unsqueeze(1).to(self.cache.dtype))

    def mark(self):
        """A read-back of (position, done) queued behind the steps so far;
        :meth:`read` waits for it.  On the CPU the values themselves."""
        if self.device.type == "cpu":
            return int(self.carry[SPEC_POS]), bool(self.carry[SPEC_DONE])
        i = self._marks % len(self._ring)
        self._marks += 1
        self._ring[i].copy_(self.carry[SPEC_POS : SPEC_DONE + 1], non_blocking=True)
        self._events[i].record()
        return i

    def read(self, mark):
        """(position, done) of a :meth:`mark`."""
        if self.device.type == "cpu":
            return mark
        self._events[mark].synchronize()
        pos, done = self._ring[mark].tolist()
        return pos, bool(done)


@contextlib.contextmanager
def open_spec_graph(graphs: GraphCache, packed, tables, fast_tables, emb, pos_table, src,
                    span_types, aux, noise, uniforms, cross_kv, cross_len, *, K: int, L: int,
                    compute_dtype, graph: bool = True, n_layers: int,
                    d_model: int, nhead: int, d_ff: int, vpad: int, **skw):
    """A :class:`SpecGraph` loaded with one decode's inputs (``src`` (S,),
    ``span_types`` (max_spans,), ``aux`` (2,) int32, ``noise`` (L, vpad) and
    ``uniforms`` (L,) f32 or None when greedy, ``cross_kv`` (n_layers, 1, S,
    2D), ``cross_len`` (1,)), from ``graphs`` under the key (W, the
    source's bucket S, ...), as :func:`open_graph` keeps the v3 graphs; the
    cache's lock is held until the block ends.  ``graph=False``: a
    SpecGraph that launches its steps eagerly (the bit reference of the
    replays)."""
    kw = dict(n_layers=n_layers, d_model=d_model, nhead=nhead, d_ff=d_ff, vpad=vpad)
    S = src.shape[0]
    key = ("spec", K + 1, S, L, noise is None, compute_dtype, graph, tuple(sorted(kw.items())),
           tuple(sorted(skw.items())))
    with graphs.lock:
        if graphs.packed is not packed or graphs.tables is not tables:
            graphs.graphs.clear()
            graphs.packed, graphs.tables = packed, tables
        spec = graphs.graphs.pop(key, None)
        if spec is None:
            graphs.misses += 1
            if graphs.stream is None and emb.device.type == "cuda":
                graphs.stream = torch.cuda.Stream(device=emb.device)
            spec = SpecGraph(packed, tables, fast_tables, emb, pos_table, K=K, L=L, S=S,
                             compute_dtype=compute_dtype, stream=graphs.stream,
                             graph=graph, **kw, **skw)
        else:
            graphs.hits += 1
        graphs.graphs[key] = spec
        while len(graphs.graphs) > graphs.size:
            graphs.graphs.popitem(last=False)
        spec.load(src, span_types, aux, noise, uniforms, cross_kv, cross_len)
        yield spec


def reset_counts() -> None:
    DecodeGraph.captures = 0
    DecodeGraph.replays = 0
    DecodeGraph.capture_ms = []
    SpecGraph.captures = 0
    SpecGraph.replays = 0
    SpecGraph.capture_ms = []
