"""Batched KV-cache infill decode loop.

Port of ``InfillDecoder._decode`` of ``smer_music_generation_tpu/infer/decode.py``
(:228-408).  The encoder runs once and the cross-attention K/V are
projected once; then a host loop steps the decoder one token at a time
against a preallocated self cache, under the grammar masks
(``infer/grammar.py``) and greedy or nucleus sampling (``infer/sampling.py``).
Span boundaries are handled in the loop exactly as in JAX: on ``<eos>``, at
the span cap (which counts the introducing ``m_0``) or after a control
span's one token, the next ``m_0`` is emitted and the element's span index
advances.

Five loop bodies, as in JAX:

* ``draft_k > 0`` on a batch of one: speculative decode, ``_decode_v5`` (JAX
  :411-702), before any other branch.  Each iteration drafts ``draft_k``
  tokens by prompt lookup (the continuation of the latest bigram match in
  the emitted stream, else in the source), scores the current token and the
  drafts in one W = draft_k + 1 row verify, samples all W slots in one
  batched pass under the grammar state each slot would reach if the slots
  before it emitted their window tokens, and emits the accepted prefix plus
  one corrective or bonus token; a single-token tail fills the positions
  the window no longer fits.  With ``fused`` the loop lives on the device as
  JAX's ``lax.while_loop`` does: one step of an ``ops.decode_graph.
  SpecGraph`` an iteration (the verify ``fused_verify_window``'s launches,
  ``spec_advance_kernel`` and the cache write; one CUDA-graph replay on the
  card, the twins on the CPU), the position and done flag read back once an
  iteration, two iterations behind; without it, a host loop around the
  model's ``decode_window``.  Greedy output equals the plain loop's;
  nucleus sampling draws
  Gumbel rows (L, V) and acceptance uniforms (L,) from the generator (or
  takes ``noise=`` and ``uniforms=``) and emits the same distribution.  A
  batch of several rows with ``draft_k`` set decodes through the loops
  below, as in JAX;
* ``fused=True``, ``fused_sampling`` True or None and ``token_chunk > 1``:
  the v4 chunk (JAX ``_decode_v4`` :843-917): ``token_chunk`` (at most 64)
  whole tokens a step of ``ops.decode_graph.DecodeGraph``, the launches of
  ``ops.decode_step.fused_decode_tokens``, the state and the position on
  the device, the done flags read back once a chunk, the chunk's tokens and
  K/V rows written at its base on the device; the per-position buffers
  carry 64 slop rows past ``max_tgt_len`` for a live row that runs on
  inside the last chunk, trimmed after the loop;
* ``fused=True`` with ``fused_sampling`` True or None: the v3 whole token
  (JAX ``_v3_loop`` / ``_decode_v3`` :704-778): embedding, decoder layers,
  grammar-masked sampling and the (6, B) state advance, the launches of
  ``ops.decode_step.fused_decode_token``, one ``DecodeGraph`` step a token,
  which also writes the output column and the cache row at the position
  held on the device, so the loop body is that step alone.  On CUDA a step
  is one replay of a CUDA graph (v3 and v4, ``quant="int8"`` too), as JAX's
  token is one ``pallas_call``, captured at a decoder's first decode of a
  batch size and source bucket and kept in its ``GraphCache``; on the CPU
  it runs the twins;
* ``fused=True, fused_sampling=False``: the v2 decoder step,
  ``ops.decode_step.fused_decode_step``, with grammar and sampling in torch;
* ``fused=False``: the model's own ``decode_step``; the one loop that takes
  a teacher-forced prefix (``forced``/``forced_len``, JAX :184-220 and
  :376-386), which the engine's span-retry and in-decode correct-control
  paths resume a session with; the kernel loops raise on it, as in JAX.

``mesh`` (a ``parallel.mesh.make_mesh`` mesh) shards every batch's rows over
the mesh's ``dp`` devices, JAX's ``_decode_v3_sharded`` (:783-840): one
replica of the decoder a shard (the model and the packed decoder weights
once a device, the graphs a shard), each encoding and decoding its rows on
its device.  The Gumbel noise is drawn once at the global ``(L, B, vpad)``
(``(L, B, V)`` for the plain and v2 loops) from the decoder's generator and
sliced by rows, so row b sees the same noise under any layout and the
tokens are those of the unsharded decode.  The v3 shards step in lockstep,
each replaying its own graph on its own device, and the tokens, lengths and
steps are gathered in row order; the plain and v2 loops run shard after
shard.  Under a mesh ``token_chunk > 1`` warns and decodes single tokens,
as JAX does, and a batch whose rows do not divide by dp warns and decodes
unsharded on the first device (JAX's ``_shard_batch``).

The fused calls launch the CUDA kernels on the card and run their plain
twins on the CPU.  ``fused=None`` resolves to the kernels on CUDA where they
fit the model (head_dim 64 or 128, d_model a multiple of 64; a bf16 or an
f32 model alike, as JAX's kernels take any compute dtype), as JAX's
``resolve_backend`` (:157-181) picks its kernel on a TPU only where it
fits, and to the plain loop otherwise and on the CPU; ``fused_sampling=None``
follows ``fused``.  This is decided from the configuration when the decoder
is built, not by a failure: an explicit ``fused=True`` on a model the
kernels do not fit raises, as does a fused batch of more than 8.
``quant="int8"`` packs the decoder matrices as int8 with f32 column scales
for the fused loops (v2, v3, v4); it needs ``fused``, as in JAX.  The v2/v3 loops read the done flags
back to the host every ``SYNC_EVERY`` steps, not every step, so the host
can queue a step while the card runs the previous one; a step after every
element is done writes only padding, so the tokens, lengths and step count
are those of a loop that stops at once.

Output follows the reference's decoder-stream convention: concatenated
spans, each introduced by ``m_0``, with no ``<eos>``.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import math
import warnings
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.transformer import ScoreTransformer
from ..ops.decode_graph import GraphCache, open_graph, open_spec_graph
from ..ops.decode_step import (
    SPEC_LEN,
    SPEC_POS,
    ST_DONE,
    ST_LEN,
    build_draft_reference,
    fused_decode_step,
    fused_verify_window,
    pack_decoder_weights,
    pack_sampling_tables,
    pack_spec_tables,
    stack_kv_cache,
    vocab_pad,
)
from ..vocab import WordVocab
from .grammar import (
    N_SID,
    SPAN_BODY,
    GrammarTables,
    allowed_mask_fast,
    build_fast_tables,
    update_bits,
)
from .sampling import (
    greedy_sample,
    gumbel_noise,
    masked_sample_gumbel,
    spec_accept_resample,
)

SYNC_EVERY = 8
SPEC_AHEAD = 2  # v5: iterations the host queues ahead of the read-back it waits on
CHUNK_SLOP = 64  # v4: positions past max_tgt_len a chunk may run into (JAX :860-866)


class DecodeResult(NamedTuple):
    tokens: torch.Tensor  # (B, max_tgt) int64, pad 0
    lengths: torch.Tensor  # (B,) valid length per element
    steps: int  # loop iterations that did work


def _kernel_device(device: torch.device) -> bool:
    """Whether the decoder's device is where the decode kernels launch (and
    not their CPU twins)."""
    return device.type == "cuda"


def _on(device: torch.device):
    """The device context a shard's launches and graph replays run in."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


@dataclass(eq=False)
class InfillDecoder:
    """Infill decoder bound to one model + vocab, on the model's device."""

    model: ScoreTransformer
    vocab: WordVocab
    max_tgt_len: int = 1024
    max_spans: int = 256  # 16 bars x 3 tracks x (body + 3 controls + tensile)
    span_cap: int = 100  # tokens per span incl. the introducing m_0
    nucleus_p: Optional[float] = 0.9
    temperature: float = 1.0
    greedy: bool = False
    fused: Optional[bool] = None
    fused_sampling: Optional[bool] = None
    quant: str = "none"
    token_chunk: int = 1
    draft_k: int = 0
    mesh: Optional[object] = None
    seed: int = 0

    def __post_init__(self):
        if self.quant not in ("none", "int8"):
            raise ValueError(f"unknown quant mode {self.quant!r}")
        if not 1 <= self.token_chunk <= CHUNK_SLOP:
            raise ValueError(f"token_chunk={self.token_chunk} must lie in [1, {CHUNK_SLOP}]")
        if self.draft_k > 0 and self.quant != "none":
            raise ValueError(
                "speculative decode (draft_k > 0) runs the plain cache path "
                "and cannot stream quantized weights; drop one of the two"
            )
        self.shards = None
        if self.mesh is not None:
            self._place_on_mesh()
        self.tables = GrammarTables.build(self.vocab)
        cfg = self.model.cfg
        if self.max_tgt_len > cfg.max_len:
            raise ValueError(
                f"max_tgt_len={self.max_tgt_len} exceeds the model's "
                f"positional limit max_len={cfg.max_len}"
            )
        self.device = self.model.device
        self.resolve_backend()
        fast = build_fast_tables(self.tables)
        self.fast_tables = tuple(torch.as_tensor(a, device=self.device) for a in fast)
        self._next_bits = np.asarray(fast[2], np.int64)  # v5's host-side state chain
        vpad = vocab_pad(self.tables.vocab_size)
        self.sampling_tables = {  # v3's tables, and v5's next_bits beside them
            k: torch.as_tensor(a, device=self.device)
            for k, a in {**pack_sampling_tables(self.vocab, self.tables, fast, vpad),
                         **pack_spec_tables(fast, vpad)}.items()
        }
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self._packed = None
        self.graphs = GraphCache()  # the v3 / v4 loops' captured graphs
        if self.mesh is not None:
            self._build_shards()

    def _place_on_mesh(self) -> None:
        """Under a mesh the decoder lives on the first dp device: the model
        is moved there (a copy, where it lies elsewhere)."""
        self._dp_devices = [torch.device(d) for d in self.mesh.dp_devices()]
        self._models = {}
        self.model = self._model_on(self._dp_devices[0])

    def _model_on(self, dev: torch.device) -> ScoreTransformer:
        """The model once a device: the caller's where it lies there."""
        key = str(dev)
        if key not in self._models:
            same = self.model.device == dev
            self._models[key] = self.model if same else copy.deepcopy(self.model).to(dev)
        return self._models[key]

    def _build_shards(self) -> None:
        """One replica decoder a dp shard (no mesh, single tokens, no spec
        decode), each with its graphs; replicas on one device share the
        model and the packed weights."""
        self.shards = []
        packed = {}
        for dev in self._dp_devices:
            rep = dataclasses.replace(self, model=self._model_on(dev), mesh=None, token_chunk=1,
                                      draft_k=0)
            if rep.fused:
                key = str(rep.device)
                if key not in packed:
                    with _on(rep.device):
                        packed[key] = rep.packed()
                rep._packed = packed[key]
            self.shards.append(rep)

    def resolve_backend(self) -> None:
        """``fused=None`` takes the kernels only where they fit, as JAX's
        ``resolve_backend`` (:157-181) takes them on a TPU only where its
        ``_kernel_fits`` (:133-136): on CUDA, for head_dim 64 or 128 and
        d_model a multiple of 64, with no condition on the dtype (a bf16 or
        an f32 model); elsewhere the plain loop.  An explicit ``fused=True``
        that does not fit raises, as JAX's (:138-141).  Decided from the
        configuration, before any build or launch."""
        cfg = self.model.cfg
        cuda = _kernel_device(self.device)
        fits = cfg.d_model % 64 == 0 and cfg.head_dim in (64, 128)
        if self.fused is None:
            self.fused = cuda and fits
        if self.fused_sampling is None:
            self.fused_sampling = self.fused
        self.fused_sampling = bool(self.fused_sampling and self.fused)
        if self.quant != "none" and not self.fused:
            raise ValueError("quantized decode requires the fused kernel path")
        if self.token_chunk > 1 and not self.fused_sampling:
            raise ValueError(
                "token_chunk > 1 (kernel looping) requires the fused-sampling kernel path"
            )
        if self.fused and not fits:
            raise ValueError(
                "the fused decode step needs d_model % 64 == 0 and head_dim 64 or 128; "
                "pass fused=False for the plain loop"
            )

    def packed(self):
        """The decoder weights in the kernel layout (``self.quant``), packed once."""
        if self._packed is None:
            self._packed = pack_decoder_weights(
                self.model, vocab_pad(self.tables.vocab_size), quant=self.quant
            )
        return self._packed

    def __call__(
        self,
        src: np.ndarray,  # (B, S) int, 0-padded
        span_types: np.ndarray,  # (B, max_spans) span codes
        n_spans: np.ndarray,  # (B,)
        no_whole_duration,  # bool or (B,) bool
        generator: Optional[torch.Generator] = None,
        noise=None,  # optional Gumbel noise, (L, B, V); v3: (L, B, vpad); v4: (L + 64, B, vpad); v5: (L, V)
        forced=None,  # (B, n) int teacher-forced output prefix; plain loop only
        forced_len=None,  # (B,) its lengths
        uniforms=None,  # v5 only: the acceptance draws (L,), given with noise
    ) -> DecodeResult:
        """``forced`` (B, n) / ``forced_len`` (B,): teacher-force the first
        ``forced_len`` positions of each row's output stream (``m_0`` span
        markers, no ``<eos>``); sampling takes over at ``forced_len`` (JAX
        :184-220).  The plain loop only: a fused decoder raises, as JAX's
        does."""
        dev = self.device
        src = torch.as_tensor(np.asarray(src), dtype=torch.long, device=dev)
        B = src.shape[0]
        dp = 1 if self.shards is None else len(self.shards)
        if dp > 1 and B % dp != 0:
            warnings.warn(
                f"batch of {B} rows is not divisible by dp={dp}; placing unsharded "
                "(no data parallelism for this call). Pad the batch to a multiple of dp "
                "to shard it.", stacklevel=2)
        if forced is not None:
            if self.fused:
                raise ValueError(
                    "forced-prefix decode requires the plain loop; build the decoder with fused=False"
                )
            forced = np.asarray(forced, np.int64)
            f = np.zeros((src.shape[0], self.max_tgt_len), np.int64)
            n = min(forced.shape[1], self.max_tgt_len)
            f[:, :n] = forced[:, :n]
            forced = (torch.as_tensor(f, device=dev),
                      torch.as_tensor(np.asarray(forced_len), dtype=torch.long, device=dev))
        span_types = torch.as_tensor(np.asarray(span_types), dtype=torch.long, device=dev)
        n_spans = torch.as_tensor(np.asarray(n_spans), dtype=torch.long, device=dev)
        no_whole = torch.as_tensor(np.asarray(no_whole_duration), dtype=torch.bool, device=dev)
        with torch.no_grad():
            if dp > 1 and B % dp == 0:
                return self._decode_sharded(src, span_types, n_spans, no_whole, generator, noise, forced)
            if self.shards is not None:  # unsharded, on the first device
                return self.shards[0]._decode(src, span_types, n_spans, no_whole, generator, noise,
                                              uniforms, forced)
            return self._decode(src, span_types, n_spans, no_whole, generator, noise, uniforms, forced)

    def _decode_sharded(self, src, span_types, n_spans, no_whole, generator, noise,
                        forced) -> DecodeResult:
        """JAX's ``_decode_v3_sharded`` (:783): the rows split over the
        shards, the noise drawn once at the global shape and sliced."""
        if self.token_chunk > 1:
            warnings.warn("token_chunk > 1 (kernel looping) is not implemented for the "
                          "dp-sharded fused path; decoding with single-token steps", stacklevel=3)
        B, dp = src.shape[0], len(self.shards)
        n = B // dp
        no_whole = torch.broadcast_to(no_whole, (B,))
        V = self.tables.vocab_size
        v3 = self.fused and self.fused_sampling
        width = vocab_pad(V) if v3 else V
        if not self.greedy:
            if noise is None:
                noise = gumbel_noise((self.max_tgt_len, B, width),
                                     generator if generator is not None else self.generator, self.device)
            noise = _noise_tensor(noise, (self.max_tgt_len, B, width), self.device)

        def rows(s, t):
            return None if t is None else t[s * n : (s + 1) * n].to(self.shards[s].device)

        parts = []
        for s, rep in enumerate(self.shards):
            part = [rows(s, t) for t in (src, span_types, n_spans, no_whole)]
            nz = None if noise is None else noise[:, s * n : (s + 1) * n].to(rep.device)
            parts.append((rep, part, nz))
        if v3:
            return self._decode_v3_lockstep(parts, n_spans)
        results = []
        for s, (rep, part, nz) in enumerate(parts):
            f = None if forced is None else tuple(rows(s, t) for t in forced)
            with _on(rep.device):
                results.append(rep._decode(*part, None, nz, None, f))
        return DecodeResult(tokens=torch.cat([r.tokens.to(self.device) for r in results]),
                            lengths=torch.cat([r.lengths.to(self.device) for r in results]),
                            steps=max(r.steps for r in results))

    def _decode_v3_lockstep(self, parts, n_spans) -> DecodeResult:
        """The v3 loops of the shards, a token of each in turn: each shard
        encodes its rows and replays its own graph on its device."""
        L = self.max_tgt_len
        with contextlib.ExitStack() as stack:
            tokens = []
            for rep, (src, span_types, n_sp, no_whole), noise in parts:
                with _on(rep.device):
                    packed, cross_kv, cross_len, kw = rep._encode_for_kernel(src)
                    noise, state, aux, st, skw = rep._v3_setup(kw, span_types, n_sp, no_whole,
                                                               None, noise, L)
                    tokens.append((rep.device, stack.enter_context(open_graph(
                        rep.graphs, packed, rep.sampling_tables, state, aux, st, noise, cross_kv,
                        cross_len, cache_rows=L, cache_dtype=rep.model.cfg.dtype, **kw, **skw))))
            pos = _step_tokens(tokens, L)
            state = torch.cat([t.state.to(self.device) for _, t in tokens], dim=1)
            out = torch.cat([t.out.to(self.device).long() for _, t in tokens])
        return _v3_result(state, out, n_spans, pos)

    def _decode(self, src, span_types, n_spans, no_whole, generator, noise,
                uniforms=None, forced=None) -> DecodeResult:
        model, t = self.model, self.tables
        cfg = model.cfg
        B = src.shape[0]
        L = self.max_tgt_len
        V = t.vocab_size
        dev = self.device

        src_pad = src == 0
        memory = model.encode(src, src_pad)
        cross = model.init_cross_cache(memory)

        # speculative decode takes a batch of one before the other loops (JAX
        # :273); a batch of several, or a forced prefix, goes on below
        if self.draft_k > 0 and B == 1 and forced is None:
            return self._decode_v5(src, src_pad, cross, span_types, n_spans, no_whole,
                                   generator, noise, uniforms)

        use_fused = self.fused
        if use_fused:
            nl, D = cfg.num_decoder_layers, cfg.d_model
            packed, cross_kv, cross_len, kw = self._kernel_inputs(cross, src_pad)
            if self.fused_sampling:
                loop = self._decode_v4 if self.token_chunk > 1 else self._decode_v3
                return loop(packed, cross_kv, cross_len, kw, span_types, n_spans, no_whole,
                            generator, noise)
            cache = torch.zeros(nl, B, L, 2 * D, dtype=cfg.dtype, device=dev)
            emb_table = model.embedding.weight
            pos_table = model.pos_table
        else:
            cache = model.init_self_cache(B, L)

        if not self.greedy:
            if noise is None:
                gen = generator if generator is not None else self.generator
                noise = gumbel_noise((L, B, V), gen, dev)
            else:
                noise = _noise_tensor(noise, (L, B, V), dev)

        state_masks, sid_from_bits, next_bits = self.fast_tables
        rows = torch.arange(B, device=dev)
        out = torch.zeros(B, L, dtype=torch.long, device=dev)
        out[:, 0] = t.mask_index
        state = torch.zeros(B, dtype=torch.long, device=dev)  # packed grammar bits
        steps_in_span = torch.ones(B, dtype=torch.long, device=dev)
        span_idx = torch.zeros(B, dtype=torch.long, device=dev)
        done = n_spans <= 0
        lengths = torch.ones(B, dtype=torch.long, device=dev)
        steps = torch.zeros((), dtype=torch.long, device=dev)

        pos = 0
        while pos + 1 < L:
            if pos % SYNC_EVERY == 0 and bool(done.all()):
                break
            token = out[:, pos]
            if use_fused:
                x = (emb_table[token] * math.sqrt(cfg.d_model) + pos_table[pos]).to(cfg.dtype)
                logits, new_kv = fused_decode_step(packed, x, cache, cross_kv, pos, cross_len, **kw)
                logits = logits[:, :V]
                cache[:, :, pos] = new_kv
            else:
                logits = model.decode_step(token, pos, cache, cross, src_pad)

            cur_type = span_types[rows, span_idx.clamp(max=self.max_spans - 1)]
            is_start = steps_in_span == 1
            allowed = allowed_mask_fast(
                state_masks, sid_from_bits, state, is_start, cur_type, no_whole,
                start_overrides=(t.mode == 1),
            )
            if self.greedy:
                sampled = greedy_sample(logits, allowed)
            else:
                sampled = masked_sample_gumbel(
                    noise[pos], logits, allowed, self.nucleus_p, self.temperature
                )

            control_done = (cur_type != SPAN_BODY) & (steps_in_span >= 2)
            # the cap counts the introducing m_0: a span ends once it holds
            # span_cap tokens (reference generation.py:542)
            end_span = (sampled == t.eos_index) | (steps_in_span >= self.span_cap) | control_done
            if forced is not None:
                # within the prefix the forced token is the sample, and only
                # a forced m_0 ends a span (JAX :376-386)
                f_next = forced[0][:, pos + 1]
                in_force = (pos + 1) < forced[1]
                forced_end = in_force & (f_next == t.mask_index)
                sampled = torch.where(in_force & ~forced_end, f_next, sampled)
                end_span = torch.where(in_force, forced_end, end_span)
            new_span_idx = torch.where(end_span, span_idx + 1, span_idx)
            now_done = done | (new_span_idx >= n_spans)

            next_tok = torch.where(end_span, t.mask_index, sampled)
            next_tok = torch.where(now_done, 0, next_tok)

            new_state = update_bits(next_bits, state, sampled)
            state = torch.where(end_span | done, 0, new_state)
            steps_in_span = torch.where(end_span, 1, steps_in_span + 1)
            out[:, pos + 1] = next_tok
            lengths = torch.where(next_tok != 0, pos + 2, lengths)
            # a step taken while some element was live counts
            steps = torch.where(done.all(), steps, pos + 1)
            span_idx, done = new_span_idx, now_done
            pos += 1
        return DecodeResult(tokens=out, lengths=lengths, steps=int(steps))

    def _kernel_inputs(self, cross, src_pad):
        """The fused loops' packed weights, stacked cross K/V, cross lengths
        and kernel shape arguments; at most 8 rows, the kernels' batch."""
        B = src_pad.shape[0]
        if B > 8:
            raise ValueError(f"the fused decode step takes at most 8 sequences, got {B}")
        cfg = self.model.cfg
        nl = cfg.num_decoder_layers
        kw = dict(n_layers=nl, d_model=cfg.d_model, nhead=cfg.nhead, d_ff=cfg.d_ff,
                  vpad=vocab_pad(self.tables.vocab_size))
        return (self.packed(), stack_kv_cache(cross, nl), (~src_pad).sum(dim=1).to(torch.int32), kw)

    def _encode_for_kernel(self, src):
        """Encode ``src`` and project the cross K/V once: the fused loops' inputs."""
        src_pad = src == 0
        cross = self.model.init_cross_cache(self.model.encode(src, src_pad))
        return self._kernel_inputs(cross, src_pad)

    def _v3_setup(self, kw, span_types, n_spans, no_whole, generator, noise, rows: int):
        """Noise, state, aux, span types and sampler arguments of the v3 and
        v4 loops (JAX ``_v3_state0`` :704).  The noise has ``rows`` rows:
        the first ``max_tgt_len`` drawn as the v3 loop draws them; v4's slop
        rows past them hold zeros, so the generator advances as under v3 and
        a retry draws the same noise under both (the slop rows are read only
        for positions at or past ``max_tgt_len``, whose tokens are trimmed)."""
        t, dev = self.tables, self.device
        B, L, vpad = span_types.shape[0], self.max_tgt_len, kw["vpad"]
        if self.greedy:
            noise = None
        elif noise is None:
            noise = gumbel_noise((L, B, vpad), generator if generator is not None else self.generator, dev)
            if rows > L:
                noise = torch.cat([noise, noise.new_zeros(rows - L, B, vpad)])
        else:
            noise = _noise_tensor(noise, (rows, B, vpad), dev)
        i32 = torch.int32
        state = torch.stack([
            torch.full((B,), t.mask_index, dtype=i32, device=dev),  # ST_TOKEN
            torch.zeros(B, dtype=i32, device=dev),  # ST_BITS
            torch.ones(B, dtype=i32, device=dev),  # ST_STEPS
            torch.zeros(B, dtype=i32, device=dev),  # ST_SPAN
            (n_spans <= 0).to(i32),  # ST_DONE
            torch.ones(B, dtype=i32, device=dev),  # ST_LEN
        ])
        aux = torch.stack([n_spans.to(i32), torch.broadcast_to(no_whole, (B,)).to(i32)])
        return noise, state, aux, span_types.to(i32).contiguous(), self._sampler_kw()

    def _sampler_kw(self):
        """The sampling kernels' settings (v3, v4 and v5)."""
        t = self.tables
        return dict(mode=t.mode, max_spans=self.max_spans, span_cap=self.span_cap,
                    eos_index=t.eos_index, mask_index=t.mask_index, nucleus_p=self.nucleus_p,
                    temperature=self.temperature, greedy=self.greedy, n_sid=N_SID,
                    span_body=SPAN_BODY)

    def _decode_v3(self, packed, cross_kv, cross_len, kw, span_types, n_spans,
                   no_whole, generator, noise) -> DecodeResult:
        """The v3 token loop (JAX ``_v3_loop`` :723): one ``DecodeGraph``
        step a token, a graph replay on CUDA."""
        L = self.max_tgt_len
        noise, state, aux, span_types, skw = self._v3_setup(
            kw, span_types, n_spans, no_whole, generator, noise, L)
        with open_graph(self.graphs, packed, self.sampling_tables, state, aux, span_types, noise,
                        cross_kv, cross_len, cache_rows=L, cache_dtype=self.model.cfg.dtype, **kw,
                        **skw) as token:
            pos = _step_tokens([(self.device, token)], L)
            state, out = token.state.clone(), token.out.long()
        return _v3_result(state, out, n_spans, pos)

    def _decode_v4(self, packed, cross_kv, cross_len, kw, span_types, n_spans,
                   no_whole, generator, noise) -> DecodeResult:
        """The kernel-looped loop (JAX ``_decode_v4`` :843-917): one
        ``DecodeGraph`` step of ``token_chunk`` tokens a chunk, a graph
        replay on CUDA."""
        dev, L, T = self.device, self.max_tgt_len, self.token_chunk
        Lp = L + CHUNK_SLOP  # a chunk starting below L - 1 ends below Lp
        noise, state, aux, span_types, skw = self._v3_setup(
            kw, span_types, n_spans, no_whole, generator, noise, Lp)
        pos = 0
        with open_graph(self.graphs, packed, self.sampling_tables, state, aux, span_types, noise,
                        cross_kv, cross_len, cache_rows=Lp, cache_dtype=self.model.cfg.dtype,
                        T_chunk=T, **kw, **skw) as chunk:
            while pos + 1 < L and not bool(chunk.state[ST_DONE].all()):  # one read-back a chunk
                chunk.step()
                pos += T
            state, out = chunk.state.clone(), chunk.out.clone()
        # a chunk may overshoot a finish inside it, and a row still live near
        # the cap decodes into the slop rows: clamp the lengths to L, zero
        # every position past them and trim the slop (JAX :897-905)
        lengths = state[ST_LEN].long().clamp(max=L)
        valid = torch.arange(Lp, device=dev)[None, :] < lengths[:, None]
        out = torch.where(valid, out, 0)[:, :L].long()
        # v3's step count: the slowest row's unclamped length, at most the
        # L - 1 steps of v3's loop, and 0 when the loop never ran (JAX :906-916)
        ran = L > 1 and bool((n_spans > 0).any())
        steps = min(int(state[ST_LEN].max()), L - 1) if ran else 0
        return DecodeResult(tokens=out, lengths=lengths, steps=steps)

    def _decode_v5(self, src, src_pad, cross, span_types, n_spans, no_whole, generator,
                   noise, uniforms) -> DecodeResult:
        """Speculative (draft-and-verify) decode of one sequence (JAX
        ``_decode_v5`` :411-702).  Each iteration verifies the current token
        and ``draft_k`` drafted ones in one W-row verify, samples the W
        slots under the grammar state each would reach if the slots before
        it emitted their window tokens, emits the accepted prefix plus one
        corrective or bonus token and drafts the next window; the tail
        decodes one token an iteration where the window no longer fits.
        Each absolute position reads its own noise row and uniform once.

        With ``fused`` the loop lives on the device, as JAX's
        ``lax.while_loop``: the carry, the output, the window and its input
        rows stay in a :class:`~..ops.decode_graph.SpecGraph`, one step of
        which (one CUDA-graph replay on the card; the twins on the CPU) is
        one iteration, and the host reads (position, done) back once an
        iteration, ``SPEC_AHEAD`` iterations behind the steps it has queued.
        Without it the host loop of :meth:`_decode_v5_plain`."""
        if not self.fused:
            return self._decode_v5_plain(src, src_pad, cross, span_types, n_spans, no_whole,
                                         generator, noise, uniforms)
        model, t, dev = self.model, self.tables, self.device
        cfg = model.cfg
        L, K, V = self.max_tgt_len, self.draft_k, t.vocab_size
        nl, vpad = cfg.num_decoder_layers, vocab_pad(V)
        noise, uniforms = self._v5_draws(generator, noise, uniforms)
        if noise is not None:  # the kernel's rows are vpad wide
            noise = torch.nn.functional.pad(noise, (0, vpad - V))
        i32 = torch.int32
        emb, pos_table = self._spec_embedding()
        aux = torch.stack([n_spans[0], no_whole.reshape(-1)[0].long()]).to(i32)
        with open_spec_graph(
                self.graphs, self.packed(), self.sampling_tables, self.fast_tables, emb,
                pos_table, src[0].to(i32), span_types[0].to(i32), aux, noise, uniforms,
                stack_kv_cache(cross, nl), (~src_pad).sum(dim=1).to(i32), K=K, L=L,
                compute_dtype=cfg.dtype, n_layers=nl,
                d_model=cfg.d_model, nhead=cfg.nhead, d_ff=cfg.d_ff, vpad=vpad,
                **self._sampler_kw()) as graph:
            done = int(n_spans[0]) <= 0
            with torch.profiler.record_function("spec_decode_loop"):
                pos, done = _spec_phase(graph, K + 1, L, 0, done)
                _spec_phase(graph, 1, L, pos, done)  # the single-token tail
            carry, out = graph.carry.tolist(), graph.out.long()[None]
        return DecodeResult(tokens=out, lengths=torch.tensor([carry[SPEC_LEN]], device=dev),
                            steps=carry[SPEC_POS])

    def _v5_draws(self, generator, noise, uniforms):
        """v5's Gumbel rows (L, V) and acceptance uniforms (L,): None when
        greedy, the caller's (JAX's draws, in the tests), or drawn from the
        generator, the noise first."""
        L, V, dev = self.max_tgt_len, self.tables.vocab_size, self.device
        if self.greedy:
            return None, None
        if noise is None:
            gen = generator if generator is not None else self.generator
            noise = gumbel_noise((L, V), gen, dev)
            return noise, torch.rand((L,), generator=gen, device=dev, dtype=torch.float32)
        if uniforms is None:
            raise ValueError("speculative decode takes uniforms (L,) beside its noise (L, V)")
        noise = torch.as_tensor(np.array(noise), dtype=torch.float32, device=dev)
        uniforms = torch.as_tensor(np.array(uniforms), dtype=torch.float32, device=dev)
        if tuple(noise.shape) != (L, V) or tuple(uniforms.shape) != (L,):
            raise ValueError(f"noise {tuple(noise.shape)} and uniforms {tuple(uniforms.shape)}: "
                             f"expected {(L, V)} and {(L,)}")
        return noise, uniforms

    def _spec_embedding(self):
        """The f32 embedding table (V, D) and the PE table the verify's input
        rows are built from, as JAX's verify reads them (:471-474)."""
        if getattr(self, "_spec_emb", None) is None:
            self._spec_emb = (self.model.embedding.weight.detach().float().contiguous(),
                              self.model.pos_table.float().contiguous())
        return self._spec_emb

    def _decode_v5_plain(self, src, src_pad, cross, span_types, n_spans, no_whole, generator,
                         noise, uniforms) -> DecodeResult:
        """Speculative decode without ``fused``: the host keeps the token
        stream, the grammar state and the draft lookup, the model's
        ``decode_window`` verifies, and the W slots' sampling runs on the
        model's device, one read-back an iteration (JAX :411-702 with its
        XLA verify)."""
        model, t, dev = self.model, self.tables, self.device
        L, K = self.max_tgt_len, self.draft_k
        W = K + 1
        cache = model.init_self_cache(1, L)

        def verify(window, pos):
            return model.decode_window(window[None], pos, cache, cross, src_pad)[0]

        noise, uniforms = self._v5_draws(generator, noise, uniforms)
        state_masks, sid_from_bits, _ = self.fast_tables
        next_bits = self._next_bits
        span_row = span_types[0].cpu().numpy()
        n_sp = int(n_spans[0])
        src_tensor = src[0].cpu()
        mode1 = t.mode == 1

        def advance(sampled, states, steps_w, spans_w):
            """The plain loop's bookkeeping for each slot, vectorized."""
            cur_type = span_row[np.minimum(spans_w, self.max_spans - 1)]
            control_done = (cur_type != SPAN_BODY) & (steps_w >= 2)
            end_span = (sampled == t.eos_index) | (steps_w >= self.span_cap) | control_done
            new_span = np.where(end_span, spans_w + 1, spans_w)
            now_done = new_span >= n_sp
            next_tok = np.where(now_done, 0, np.where(end_span, t.mask_index, sampled))
            st_post = np.where(end_span, 0, next_bits[states, sampled])
            steps_post = np.where(end_span, 1, steps_w + 1)
            return next_tok, now_done, st_post, steps_post, new_span

        def sample(logits, states, steps_w, spans_w, draft, pos):
            """The slots' tokens in one batched pass: each slot's grammar
            mask, then greedy, or (nucleus) the speculative accept/resample
            of each slot's draft and a plain sample in the slot without one."""
            n = len(states)
            cur_type = span_row[np.minimum(spans_w, self.max_spans - 1)]
            rows = torch.as_tensor(np.stack([states, steps_w, cur_type]), device=dev)
            allowed = allowed_mask_fast(state_masks, sid_from_bits, rows[0], rows[1] == 1, rows[2],
                                        no_whole, start_overrides=mode1)
            if self.greedy:
                return greedy_sample(logits, allowed).cpu().numpy()
            g, u = noise[pos : pos + n], uniforms[pos : pos + n]
            tok = masked_sample_gumbel(g, logits, allowed, self.nucleus_p, self.temperature)
            if draft is not None:
                proposals = torch.as_tensor(np.append(np.maximum(draft, 0), 0), device=dev)
                spec, _ = spec_accept_resample(u, g, logits, allowed, proposals,
                                               self.nucleus_p, self.temperature)
                tok = torch.where(torch.arange(n, device=dev) == K, tok, spec)
            return tok.cpu().numpy()

        out = np.zeros(L, np.int64)
        out[0] = t.mask_index
        pos, done, state, steps, span, length = 0, n_sp <= 0, 0, 1, 0, 1
        slots = np.arange(W)
        while pos + 1 + K < L and not done:
            draft = build_draft_reference(torch.from_numpy(out), pos, src_tensor, K).numpy()
            window = np.concatenate([out[pos : pos + 1], draft])
            logits = verify(torch.as_tensor(window, device=dev), pos)  # (W, V)
            # the state each slot samples under if the slots before it
            # emitted their window tokens: an emitted m_0 ends a span
            states, steps_w, spans_w = (np.empty(W, np.int64) for _ in range(3))
            states[0], steps_w[0], spans_w[0] = state, steps, span
            for i, w in enumerate(draft):
                ended = w == t.mask_index
                states[i + 1] = 0 if ended else next_bits[states[i], w]
                steps_w[i + 1] = 1 if ended else steps_w[i] + 1
                spans_w[i + 1] = spans_w[i] + int(ended)
            sampled = sample(logits, states, steps_w, spans_w, draft, pos)
            next_tok, now_done, st_post, steps_post, new_span = advance(
                sampled, states, steps_w, spans_w)
            # slot i emits iff every slot before it emitted its window token
            # and did not finish the session
            keep = np.append(next_tok[:K] == draft, False) & ~now_done
            emit = np.concatenate([[True], np.cumprod(keep)[:K].astype(bool)])
            m = int(emit.sum())
            out[pos + 1 : pos + 1 + W] = np.where(emit, next_tok, 0)
            length = max(length, int(np.where(emit & (next_tok != 0), pos + slots + 2, 0).max()))
            last = m - 1
            pos += m
            done = bool(now_done[last])
            state, steps, span = int(st_post[last]), int(steps_post[last]), int(new_span[last])
        # the single-token tail: the window no longer fits before the cap
        while pos + 1 < L and not done:
            logits = verify(torch.as_tensor(out[pos : pos + 1], device=dev), pos)
            slot = tuple(np.asarray([v], np.int64) for v in (state, steps, span))
            sampled = sample(logits, *slot, None, pos)
            next_tok, now_done, st_post, steps_post, new_span = advance(sampled, *slot)
            out[pos + 1] = next_tok[0]
            if next_tok[0] != 0:
                length = pos + 2
            pos += 1
            done = bool(now_done[0])
            state, steps, span = int(st_post[0]), int(steps_post[0]), int(new_span[0])
        return DecodeResult(tokens=torch.as_tensor(out[None], device=dev),
                            lengths=torch.tensor([length], device=dev), steps=pos)


def _noise_tensor(noise, shape, dev) -> torch.Tensor:
    """Caller-given noise (an array or a tensor) as f32 on ``dev``, of ``shape``."""
    if not isinstance(noise, torch.Tensor):
        noise = torch.as_tensor(np.array(noise))
    noise = noise.to(device=dev, dtype=torch.float32)
    if tuple(noise.shape) != tuple(shape):
        raise ValueError(f"noise has shape {tuple(noise.shape)}, expected {tuple(shape)}")
    return noise


def _step_tokens(tokens, L: int) -> int:
    """Step the v3 graphs (``(device, DecodeGraph)`` pairs) a token each in
    turn until every row of every graph is done (read back every
    ``SYNC_EVERY`` tokens) or the cap; returns the position reached."""
    pos = 0
    while pos + 1 < L:
        if pos % SYNC_EVERY == 0 and all(bool(t.state[ST_DONE].all()) for _, t in tokens):
            break
        for dev, t in tokens:
            with _on(dev):
                t.step()
        pos += 1
    return pos


def _spec_phase(graph, W: int, L: int, pos: int, done: bool):
    """Step the ``SpecGraph`` W rows an iteration until its carry is done or
    the window no longer fits before the cap (pos + W >= L), reading
    (position, done) back once an iteration, ``SPEC_AHEAD`` iterations
    behind the steps queued, so the card never waits for the host; the
    steps queued past the end change nothing.  Returns the last (position,
    done) read."""
    marks = collections.deque()
    while not done and pos + W < L:
        graph.step(W)
        marks.append(graph.mark())
        if len(marks) >= SPEC_AHEAD:
            pos, done = graph.read(marks.popleft())
    return pos, done


def _v3_result(state, out, n_spans, pos: int) -> DecodeResult:
    """Lengths and steps of a v3 decode stopped at ``pos``.  JAX's loop stops
    at the first position where every element is done.  An element that
    becomes done in the step at position s wrote its last token in the step
    before, so its length is s + 1: the stop position is the longest length,
    or 0 when no element had a span, or ``pos`` when one is still live."""
    lengths = state[ST_LEN].long()
    if not bool(state[ST_DONE].all()):
        steps = pos
    elif bool((n_spans > 0).any()):
        steps = int(lengths.max())
    else:
        steps = 0
    return DecodeResult(tokens=out, lengths=lengths, steps=steps)


def pad_to_bucket(
    ids: np.ndarray, bucket: int = 512, cap: int = 2048, hard_cap: int = 2400
) -> np.ndarray:
    """Pad a (B, S) id matrix to a bucketed length (JAX ``pad_to_bucket``,
    :920): multiples of ``bucket`` up to ``cap``, then of 256, truncated at
    ``hard_cap``, the model's positional limit."""
    S = ids.shape[1]
    if S > cap:
        target = min(int(np.ceil(S / 256)) * 256, hard_cap)
        if target <= S:
            return ids[:, :target]
        return np.pad(ids, ((0, 0), (0, target - S)))
    target = int(np.ceil(max(S, 1) / bucket)) * bucket
    return np.pad(ids, ((0, 0), (0, target - S)))
