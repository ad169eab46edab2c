#!/usr/bin/env python3
"""Time the PyTorch port's kernels of several checkouts on one card, in turns.

    python scripts/torch_kernel_ab.py ROOT [ROOT ...]

Each ROOT is a checkout that holds ``smer_music_generation_tpu_torch``.  Each
runs in a process of its own, in the order given, with its kernels built from
its own sources into ``ROOT/build/torch_kernels/``; so ``parent change change
parent`` compares two versions on one card.  The shape is the served batch:
B=3, S=1536, index 512, cross lengths 1536/1440/1344, at the flagship width
(4 decoder layers, d512, 8 heads, d_ff 2048) with seeded random bf16 weights
and random biases and LayerNorms.  Timed: the v2 step (``fused_decode_step``),
the v2 step at B=4 (the three rows plus a copy of the first, cross length
1248), the v3 nucleus token (``fused_decode_token``), the v4 chunk of 8 nucleus
tokens (``fused_decode_tokens``), the verify window of 9 rows at B=1
(``fused_verify_window``, index 512, cross length 1440) and, where the
checkout has int8 weights, the v3 token on them; then the served batch
of ``chip_smoke.py`` phase 3 end to end (3 nucleus requests of the seeded
score on the committed snapshot, ``InfillEngine.run_batch`` with a seeded
generator, so both checkouts decode the same tokens: one warm-up run, then
the wall ms of 5 runs); where the checkout has
``ops/decode_graph.py``, also the v3 token, the int8 v3 token and the v4
chunk of 8 as the decoder runs them, one CUDA-graph replay (``DecodeGraph``
step) each, from index 512 (the replays advance the position: the v3 token
is timed over positions 512-772, the chunk over 512-760), the replayed v3
token with each ``sample_advance_kernel``'s start less the end of the
device event before it (``sampler_gap_us``, from the profiler's trace;
negative where the sampler, a programmatic dependent launch, began while
the logits launch ran); and the two ends of a token alone: the sampler
(``sample_and_advance``, nucleus, on the v2 step's logits; with
``sampler_fold`` also its fold where the checkout has one) and
``embed_pe_kernel`` through its launcher.  Then the attention kernels: ``fused_attention``
(the flash encoder's) at B=3, T=S=1536, H=8, key lengths 1536/1440/1344; and
the train attention at B=8, H=8, 640x640 and 384x384 causal (rate 0.1, ~10%
of keys invalid, one batch row with no valid key, as chip_smoke's phase 2g;
the seed words on the card and the mask as int32, as the model passes them):
its backward ``dropout_attention_bwd`` (the two kernels ``train_bwd_rows_kernel``
and ``train_bwd_keys_kernel``) is the measured kernel, at 640x640 also at rate
0 (what the keep hash costs it), and its forward ``dropout_attention_fwd``,
``fused_attention`` and the decode kernels are the control.
Prints one JSON line per run: the card and its power limit, the root, and per
kernel the ms a call (CUDA events, the mean of 200 back-to-back calls after 20
warm-up calls), the ms of one call alone (events around a single call queued
behind a short spin on a drained stream, the mean of 20), the device
microseconds a call by kernel family (torch.profiler over 20 calls) and the
device busy share (their sum over the ms a call).  Where the run built the
checkout's kernels, also the registers, spills and commonest SASS opcodes of
the decode kernels' instantiations (``chip_smoke.DECODE_KERNELS`` and, as the
earlier split-free designs named them, ``rowvec_kernel`` at 3, 4 and 9 rows and
``attend_kernel`` at head_dim 64), read with chip_smoke's ``ptxas_facts`` and
``sass_mix``.  Each run also hashes the outputs of each timed decode call
(logits, K|V rows, state, tokens; a replayed decode's state, output row
and cache after its replays; the served batch's tokens), and a last line
says whether every output is bit-equal across the roots.

    python scripts/torch_kernel_ab.py build/parent . . build/parent

The train attention is also timed at 384x640, and, where the checkout has
``ops/flash_train.py``, the flash-train kernels at B=8, H=8, 640x640 and
2048x2048 (~10% of keys invalid, one batch row with no valid key): the
backward ``flash_train_bwd`` (``flash_train_dq_kernel`` then
``flash_train_dkv_kernel``, each kernel's device µs by name), the forward,
and SDPA's backward with the same boolean mask; and the f32 backward pair
(``flash_train_f32_dq_kernel`` then ``flash_train_f32_dkv_kernel``) at B=8,
640x640, head_dim 64 (H=8) and 128 (H=4) beside f32 SDPA's backward, with
its largest relative norm from the twin (the f32 outputs are not hashed:
another design of the pair sums in another order); and the f32 forward
(``attn_f32_fwd_kernel``) in both modes: ``flash_train_fwd`` at B=8, 640x640
and ``fused_attention`` at B=3, 1536x1536 (key lengths 1536/1440/1344), each
at head_dim 64 (H=8) and 128 (H=4), beside f32 SDPA's forward with the same
mask and with its relative norm from the twin; and every attention wrapper
at head_dim 64 and 128, causal, in bf16 and f32 (the dropout attention in
bf16 only), its outputs and gradients hashed for the last line; and, where
the checkout has ``ops/attention_wide.py``, the wide kernels at
``chip_smoke.WIDE_TIMED`` (B=8, H=2, 640x640, head_dim 256): ``fused_attention``,
the dropout attention's forward and backward pair (bf16), and the flash-train
forward and pair in bf16 and f32, each with its device µs by kernel
(``wide_fwd_kernel``, ``wide_rows_kernel``, ``wide_keys_kernel``) and its
relative norm from the twin (each gradient's apart), the forwards' outputs
and the pairs' dq hashed for the last line (dk and dv are not: another
design of the keys kernel sums in another order); and each wide backward
pair's gradients against the twin at chip_smoke phase 5e's shapes at
head_dim 256 (its inputs: B=3, H=2, 640x640, 384x384 causal, 384x640, the
dropout pair also 200x333 and 333x200 causal, the flash pair also 512x512
causal).
``--attention`` before
the roots times the attention kernels alone (no decode kernels, no served
batch):

    python scripts/torch_kernel_ab.py --attention build/parent . . build/parent

``--decode`` before the roots times the decode kernels and the served batch
alone (no attention kernels), for roots that differ only there, such as the
design variants of ``scripts/decode_token_variants.py``:

    python scripts/torch_kernel_ab.py --decode build/parent . . build/parent
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import hashlib, inspect, json, math, subprocess, sys, time
root = sys.argv[1]
sys.path.insert(0, root)
import torch
from torch.profiler import ProfilerActivity, profile
from smer_music_generation_tpu_torch.infer.grammar import N_SID, SPAN_BODY, GrammarTables, build_fast_tables
from smer_music_generation_tpu_torch.models.transformer import LayerNorm, ModelConfig, ScoreTransformer
from smer_music_generation_tpu_torch.ops import attention as attn
from smer_music_generation_tpu_torch.ops import decode_step as ds
from smer_music_generation_tpu_torch.ops import train_attention as ta
from smer_music_generation_tpu_torch.utils.config import ExperimentConfig
from smer_music_generation_tpu_torch.vocab import WordVocab

NL, D, H, F, L = 4, 512, 8, 2048, 1024
B, S, INDEX = 3, 1536, 512
FAMILIES = ("rowvec_kernel", "attend_kernel", "add_layernorm_kernel", "embed_pe_kernel",
            "sample_advance_kernel", "flash_fwd_kernel", "flash_train_fwd_kernel",
            "flash_train_dq_kernel", "flash_train_dkv_kernel", "train_fwd_kernel",
            "train_bwd_rows_kernel", "train_bwd_keys_kernel", "attn_f32_fwd_kernel",
            "flash_train_f32_dq_kernel", "flash_train_f32_dkv_kernel", "wide_fwd_kernel",
            "wide_rows_kernel", "wide_keys_kernel")
ATTENTION_ONLY = len(sys.argv) > 3 and sys.argv[3] == "attention"
DECODE_ONLY = len(sys.argv) > 3 and sys.argv[3] == "decode"
dev = torch.device("cuda", 0)
torch.manual_seed(0)
vocab = WordVocab(0, ExperimentConfig().control_list)
model = ScoreTransformer(ModelConfig(vocab_size=vocab.vocab_size, d_model=D, nhead=H,
                                     num_encoder_layers=1, num_decoder_layers=NL, d_ff=F,
                                     dtype=torch.bfloat16)).to(dev).eval()
with torch.no_grad():
    for m in model.modules():
        if isinstance(m, LayerNorm):
            m.weight.copy_(1.0 + 0.2 * torch.randn_like(m.weight))
        if isinstance(m, (LayerNorm, torch.nn.Linear)):
            m.bias.normal_(0.0, 0.5)
vpad = ds.vocab_pad(vocab.vocab_size)
t = GrammarTables.build(vocab)
tables = {k: torch.as_tensor(v, device=dev)
          for k, v in ds.pack_sampling_tables(vocab, t, build_fast_tables(t), vpad).items()}
g = torch.Generator(device=dev).manual_seed(1)
self_kv = torch.randn(NL, B, L, 2 * D, generator=g, device=dev).to(torch.bfloat16)
cross_kv = torch.randn(NL, B, S, 2 * D, generator=g, device=dev).to(torch.bfloat16)
cross_len = torch.tensor([S - (S // 16) * b for b in range(B)], dtype=torch.int32, device=dev)
x = torch.randn(B, D, generator=g, device=dev).to(torch.bfloat16)
noise = -torch.log(-torch.log(torch.rand(L, B, vpad, generator=g, device=dev).clamp(1e-30, 1 - 2 ** -24)))
state = torch.stack([torch.full((B,), 20), torch.zeros(B, dtype=torch.long), torch.full((B,), 3),
                     torch.zeros(B, dtype=torch.long), torch.zeros(B, dtype=torch.long),
                     torch.full((B,), INDEX + 1)]).to(torch.int32).to(dev)
aux = torch.stack([torch.full((B,), 8), torch.zeros(B, dtype=torch.long)]).to(torch.int32).to(dev)
span_types = torch.zeros(B, 256, dtype=torch.int32, device=dev)
kw = dict(n_layers=NL, d_model=D, nhead=H, d_ff=F, vpad=vpad)
skw = dict(mode=0, max_spans=256, span_cap=100, eos_index=vocab.eos_index,
           mask_index=vocab.mask_index, nucleus_p=0.9, temperature=1.0, greedy=False,
           n_sid=N_SID, span_body=SPAN_BODY)


def digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


outputs = {}


def timed(fn, warm=20, n=200, n_prof=20, n_iso=20):
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    start_end_ms = start.elapsed_time(end) / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            fn()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    split = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0) or 0
        # device events only: a host op carries its kernels' time too
        if us > 0 and evt.device_type == DeviceType.CUDA and not evt.is_user_annotation:
            fam = next((k for k in FAMILIES if k in evt.key), "other")
            split[fam] = round(split.get(fam, 0.0) + us / n_prof, 1)
    # one call at a time, nothing queued behind it: the stream drained, a
    # ~100 us spin on the card so the host's launch work ends before the
    # start event fires, then events around the single call
    iso = []
    for _ in range(n_iso):
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        iso.append(start.elapsed_time(end))
    busy = sum(split.values()) / (1e3 * start_end_ms)
    return dict(ms=start_end_ms, ms_isolated=sum(iso) / len(iso), device_us=split,
                busy=round(busy, 4))


try:
    from smer_music_generation_tpu_torch.ops import decode_graph as dg
except ImportError:  # a checkout from before the decode graph
    dg = None


def sampler_gaps(fn, n=5):
    # chip_smoke's measure (this script's checkout, after the root's package
    # on the path): each sample_advance_kernel's start less the end of the
    # device event that began before it (us; negative: it began while that
    # one ran)
    sys.path.append(sys.argv[4])
    from chip_smoke import pdl_gaps

    return [round(u, 2) for u in pdl_gaps(fn, n)["us"]]


def replayed(packed, T):
    # the decoder's step as a graph replay from index 512, as the decoder
    # opens it (open_graph: the inputs copied into the graph's buffers, the
    # capture at the first step)
    with dg.open_graph(dg.GraphCache(), packed, tables, state, aux, span_types, noise, cross_kv,
                       cross_len, cache_rows=self_kv.shape[2], cache_dtype=self_kv.dtype, T_chunk=T,
                       start=INDEX, **kw, **skw) as graph:
        if T is None:
            t = timed(graph.step)
            t["sampler_gap_us"] = sampler_gaps(graph.step)
        else:
            t = timed(graph.step, warm=3, n=20, n_prof=3, n_iso=5)
        # the same number of replays on every root: the end state compares
        t["outputs"] = digest(graph.state, graph.out, graph.cache)
        return t


out = {"root": root}
for quant in () if ATTENTION_ONLY else ("none", "int8") if hasattr(ds, "quantize_columns") else ("none",):
    packed = ds.pack_decoder_weights(model, vpad, quant=quant)
    tag = "" if quant == "none" else "_int8"
    if quant == "none":
        outputs["v2_step"] = digest(*ds.fused_decode_step(packed, x, self_kv, cross_kv, INDEX,
                                                           cross_len, **kw))
        out["v2_step"] = timed(lambda: ds.fused_decode_step(packed, x, self_kv, cross_kv, INDEX,
                                                            cross_len, **kw))
        # the same step at B=4 (one more row of every input): the row-vector
        # kernel's cost against its row count
        b4 = [torch.cat([t, t[:, :1]], dim=1) for t in (self_kv, cross_kv)]
        cl4 = torch.cat([cross_len, cross_len[-1:] - S // 16])
        x4 = torch.cat([x, x[:1]])
        out["v2_step_B4"] = timed(lambda: ds.fused_decode_step(packed, x4, b4[0], b4[1], INDEX,
                                                               cl4, **kw))
    outputs["v3_token" + tag] = digest(*ds.fused_decode_token(
        packed, tables, state, aux, span_types, noise, self_kv, cross_kv, INDEX, cross_len,
        **kw, **skw))
    out["v3_token" + tag] = timed(lambda: ds.fused_decode_token(
        packed, tables, state, aux, span_types, noise, self_kv, cross_kv, INDEX, cross_len,
        **kw, **skw))
    if dg is not None:
        out["v3_token_graph" + tag] = replayed(packed, None)
        outputs["v3_token_graph" + tag] = out["v3_token_graph" + tag].pop("outputs")
    if quant == "none":
        # the two ends of a token alone, on the served shape: the sampler
        # (nucleus) on the logits of the v2 step, with its fold where the
        # checkout has one, and embed_pe_kernel through its launcher
        logits = ds.fused_decode_step(packed, x, self_kv, cross_kv, INDEX, cross_len, **kw)[0]
        folds = "emb" in inspect.signature(ds.sample_and_advance).parameters
        fold = dict(emb=packed["emb"]) if folds else {}
        outputs["sampler"] = digest(ds.sample_and_advance(
            logits, state, aux, span_types, noise, INDEX, tables, **skw))
        out["sampler"] = timed(lambda: ds.sample_and_advance(
            logits, state, aux, span_types, noise, INDEX, tables, **skw))
        if folds:
            out["sampler_fold"] = timed(lambda: ds.sample_and_advance(
                logits, state, aux, span_types, noise, INDEX, tables, **fold, **skw))
        lib = ds.load_library()
        xe = torch.empty(B, D, device=dev)
        pos_t = torch.full((B,), INDEX, dtype=torch.int32, device=dev)

        def embed():  # the launcher, whose C call each checkout binds its own way
            ds._launch_embed_pe(lib, packed["emb"], state, pos_t, xe,
                                stream=torch.cuda.current_stream(dev).cuda_stream)

        embed()
        outputs["embed_pe"] = digest(xe)
        out["embed_pe"] = timed(embed)
    if quant == "none":
        outputs["v4_chunk8"] = digest(*ds.fused_decode_tokens(
            packed, tables, state, aux, span_types, noise, self_kv, cross_kv, INDEX, cross_len,
            **kw, **skw, T_chunk=8))
        out["v4_chunk8"] = timed(lambda: ds.fused_decode_tokens(
            packed, tables, state, aux, span_types, noise, self_kv, cross_kv, INDEX, cross_len,
            **kw, **skw, T_chunk=8))
        if dg is not None:
            out["v4_chunk8_graph"] = replayed(packed, 8)
            outputs["v4_chunk8_graph"] = out["v4_chunk8_graph"].pop("outputs")
        xw = torch.randn(9, D, generator=g, device=dev).to(torch.bfloat16)
        one = (self_kv[:, :1].contiguous(), cross_kv[:, 1:2].contiguous(),
               cross_len[1:2].contiguous())  # the second row's cross length, 1440
        outputs["verify_w9"] = digest(*ds.fused_verify_window(packed, xw, one[0], one[1], INDEX,
                                                              one[2], **kw))
        out["verify_w9"] = timed(lambda: ds.fused_verify_window(
            packed, xw, one[0], one[1], INDEX, one[2], **kw))
g = torch.Generator(device=dev).manual_seed(9)


def rnd(*shape):
    return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)


qa, ka, va = rnd(3, 1536, H, 64), rnd(3, 1536, H, 64), rnd(3, 1536, H, 64)
lens = torch.tensor([1536, 1440, 1344], dtype=torch.int32, device=dev)
if not DECODE_ONLY:
    out["fused_attention"] = timed(lambda: attn.fused_attention(qa, ka, va, lens, False))
for T_, S_, causal in () if DECODE_ONLY else ((640, 640, False), (384, 384, True),
                                              (384, 640, False)):
    q, k, v, go = rnd(8, T_, H, 64), rnd(8, S_, H, 64), rnd(8, S_, H, 64), rnd(8, T_, H, 64)
    valid = (torch.rand(8, S_, generator=g, device=dev) >= 0.1).to(torch.int32)
    valid[1] = 0
    seed = ta.seed_tensor((0, 7), dev)  # on the card, as the model passes it
    tag = f"{T_}x{S_}" + ("_causal" if causal else "")
    out["dropout_attention_fwd_" + tag] = timed(
        lambda: ta.dropout_attention_fwd(q, k, v, valid, seed, 0.1, causal))
    out["dropout_attention_bwd_" + tag] = timed(
        lambda: ta.dropout_attention_bwd(q, k, v, valid, seed, go, 0.1, causal))
    outputs["dropout_attention_bwd_" + tag] = digest(
        *ta.dropout_attention_bwd(q, k, v, valid, seed, go, 0.1, causal))
    if (T_, S_) == (640, 640):  # without dropout: what the keep hash costs the backward
        out["dropout_attention_bwd_" + tag + "_rate0"] = timed(
            lambda: ta.dropout_attention_bwd(q, k, v, valid, seed, go, 0.0, causal))
try:
    from smer_music_generation_tpu_torch.ops import flash_train as ft
except ImportError:  # a checkout from before the flash-train kernels
    ft = None
# the flash-train kernels (flash_training's attention) at B=8, H=8, ~10% of
# keys invalid and one batch row with none, as chip_smoke's phase 2j; the
# backward (flash_train_dq_kernel + flash_train_dkv_kernel) beside SDPA's
# backward with the same boolean mask, the forward as the control
for T_ in (640, 2048) if ft is not None and not DECODE_ONLY else ():
    q, k, v, go = (rnd(8, T_, H, 64) for _ in range(4))
    valid = (torch.rand(8, T_, generator=g, device=dev) >= 0.1).to(torch.int32)
    valid[1] = 0
    o, stats = ft.flash_train_fwd(q, k, v, valid, False)
    tag = f"{T_}x{T_}"
    out["flash_train_fwd_" + tag] = timed(lambda: ft.flash_train_fwd(q, k, v, valid, False))
    out["flash_train_bwd_" + tag] = timed(
        lambda: ft.flash_train_bwd(q, k, v, valid, o, stats, go, False))
    outputs["flash_train_bwd_" + tag] = digest(*ft.flash_train_bwd(q, k, v, valid, o, stats, go, False))
    qt, kt, vt = (a.transpose(1, 2).contiguous().requires_grad_(True) for a in (q, k, v))
    mask = valid.bool()[:, None, None, :].expand(8, 1, T_, T_)
    sd_out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    gt = go.transpose(1, 2).contiguous()
    out["sdpa_bwd_" + tag] = timed(
        lambda: torch.autograd.grad(sd_out, (qt, kt, vt), gt, retain_graph=True))
# the f32 backward pair (flash_train_f32_dq_kernel + flash_train_f32_dkv_kernel)
# at B=8, 640x640, head_dim 64 (H=8) and 128 (H=4), f32 inputs made from a
# generator of their own, beside f32 SDPA's backward with the same mask (TF32
# off); the largest relative norm of dq, dk, dv from the twin beside each
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
for D_, H_ in ((64, H), (128, 4)) if ft is not None and not DECODE_ONLY else ():
    gf = torch.Generator(device=dev).manual_seed(2)
    q, k, v, go = (torch.randn(8, 640, H_, D_, generator=gf, device=dev) for _ in range(4))
    valid = (torch.rand(8, 640, generator=gf, device=dev) >= 0.1).to(torch.int32)
    valid[1] = 0
    o, stats = ft.flash_train_fwd(q, k, v, valid, False)
    tag = f"f32_hd{D_}_640x640"
    out["flash_train_bwd_" + tag] = timed(
        lambda: ft.flash_train_bwd(q, k, v, valid, o, stats, go, False))
    got = ft.flash_train_bwd(q, k, v, valid, o, stats, go, False)
    ref = ft.flash_train_bwd_reference(q, k, v, valid, o, stats, go, False)
    out["flash_train_bwd_" + tag]["rel_to_twin"] = max(
        ((a - b).norm() / b.norm()).item() for a, b in zip(got, ref))
    qt, kt, vt = (a.transpose(1, 2).contiguous().requires_grad_(True) for a in (q, k, v))
    mask = valid.bool()[:, None, None, :].expand(8, 1, 640, 640)
    sd_out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    gt = go.transpose(1, 2).contiguous()
    out["sdpa_bwd_" + tag] = timed(
        lambda: torch.autograd.grad(sd_out, (qt, kt, vt), gt, retain_graph=True))
# the f32 forward (attn_f32_fwd_kernel) in MODE 1 (flash_train_fwd) at B=8,
# 640x640 with ~10% of keys invalid and in MODE 0 (fused_attention) at B=3,
# 1536x1536 with key lengths 1536/1440/1344, each at head_dim 64 (H=8) and
# 128 (H=4), beside f32 SDPA with the same mask; the relative norm of the
# output from the twin beside each
for D_, H_ in ((64, H), (128, 4)) if ft is not None and not DECODE_ONLY else ():
    gf = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(8, 640, H_, D_, generator=gf, device=dev) for _ in range(3))
    valid = (torch.rand(8, 640, generator=gf, device=dev) >= 0.1).to(torch.int32)
    valid[1] = 0
    tag = f"f32_hd{D_}_640x640"
    out["flash_train_fwd_" + tag] = timed(lambda: ft.flash_train_fwd(q, k, v, valid, False))
    got = ft.flash_train_fwd(q, k, v, valid, False)[0]
    ref = ft.flash_train_fwd_reference(q, k, v, valid, False)[0]
    out["flash_train_fwd_" + tag]["rel_to_twin"] = ((got - ref).norm() / ref.norm()).item()
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    mask = valid.bool()[:, None, None, :].expand(8, 1, 640, 640)
    out["sdpa_fwd_" + tag] = timed(
        lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    q, k, v = (torch.randn(3, 1536, H_, D_, generator=gf, device=dev) for _ in range(3))
    tag = f"f32_hd{D_}_1536x1536"
    out["fused_attention_" + tag] = timed(lambda: attn.fused_attention(q, k, v, lens, False))
    got, ref = attn.fused_attention(q, k, v, lens, False), attn.attention_reference(q, k, v, lens, False)
    out["fused_attention_" + tag]["rel_to_twin"] = ((got - ref).norm() / ref.norm()).item()
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    mask = (torch.arange(1536, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    out["sdpa_fwd_" + tag] = timed(
        lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
# the wide kernels (attention_wide.cu, every head_dim above 128) at chip_smoke's
# WIDE_TIMED, B=8, H=2, 640x640, head_dim 256, where the checkout has them:
# fused_attention (wide_fwd_kernel MODE 0, key lengths 640/320/1/640...), the
# dropout attention (MODE 1, rate 0.1) forward and backward pair, the flash
# pair and forward (MODE 2) in bf16 and f32, ~10% of keys invalid and one
# batch row with none, each with its relative norm from the twin (each
# gradient's apart: dq, dk, dv); each backward pair's device us by kernel
# (wide_rows_kernel, wide_keys_kernel); the forwards' outputs and the pairs'
# dq hashed (dk and dv not: another keys kernel sums in another order)
try:
    from smer_music_generation_tpu_torch.ops import attention_wide as aw
except ImportError:  # a checkout from before the wide kernels
    aw = None


def rels(got, ref):
    if isinstance(got, torch.Tensor):
        got, ref = (got,), (ref,)
    return [((a.float() - b.float()).norm() / b.float().norm()).item() for a, b in zip(got, ref)]


def rel_to_twin(got, ref):
    return max(rels(got, ref))


for dt in (torch.bfloat16, torch.float32) if aw is not None and not DECODE_ONLY else ():
    gw = torch.Generator(device=dev).manual_seed(23)
    q, k, v, go = (torch.randn(8, 640, 2, 256, generator=gw, device=dev).to(dt) for _ in range(4))
    valid = (torch.rand(8, 640, generator=gw, device=dev) >= 0.1).to(torch.int32)
    valid[1] = 0
    wlens = torch.tensor([640, 320, 1] + [640] * 5, dtype=torch.int32, device=dev)
    tag = f"wide_{str(dt).split('.')[-1]}_hd256_640x640"
    out["fused_attention_" + tag] = timed(lambda: attn.fused_attention(q, k, v, wlens, False))
    got = attn.fused_attention(q, k, v, wlens, False)
    outputs["fused_attention_" + tag] = digest(got)
    out["fused_attention_" + tag]["rel_to_twin"] = rel_to_twin(
        got, attn.attention_reference(q, k, v, wlens, False))
    o, stats = ft.flash_train_fwd(q, k, v, valid, False)
    outputs["flash_train_fwd_" + tag] = digest(o, stats)
    out["flash_train_fwd_" + tag] = timed(lambda: ft.flash_train_fwd(q, k, v, valid, False))
    out["flash_train_fwd_" + tag]["rel_to_twin"] = rel_to_twin(
        o, ft.flash_train_fwd_reference(q, k, v, valid, False)[0])
    out["flash_train_bwd_" + tag] = timed(
        lambda: ft.flash_train_bwd(q, k, v, valid, o, stats, go, False))
    got = ft.flash_train_bwd(q, k, v, valid, o, stats, go, False)
    outputs["flash_train_bwd_dq_" + tag] = digest(got[0])
    out["flash_train_bwd_" + tag]["rel_dq_dk_dv"] = rels(
        got, ft.flash_train_bwd_reference(q, k, v, valid, o, stats, go, False))
    out["flash_train_bwd_" + tag]["rel_to_twin"] = max(out["flash_train_bwd_" + tag]["rel_dq_dk_dv"])
    if dt == torch.bfloat16:
        seed = ta.seed_tensor((0, 7), dev)
        out["dropout_attention_fwd_" + tag] = timed(
            lambda: ta.dropout_attention_fwd(q, k, v, valid, seed, 0.1, False))
        got = ta.dropout_attention_fwd(q, k, v, valid, seed, 0.1, False)
        outputs["dropout_attention_fwd_" + tag] = digest(got)
        out["dropout_attention_fwd_" + tag]["rel_to_twin"] = rel_to_twin(
            got, ta.dropout_attention_fwd_reference(q, k, v, valid, seed, 0.1, False))
        out["dropout_attention_bwd_" + tag] = timed(
            lambda: ta.dropout_attention_bwd(q, k, v, valid, seed, go, 0.1, False))
        got = ta.dropout_attention_bwd(q, k, v, valid, seed, go, 0.1, False)
        outputs["dropout_attention_bwd_dq_" + tag] = digest(got[0])
        out["dropout_attention_bwd_" + tag]["rel_dq_dk_dv"] = rels(
            got, ta.dropout_attention_bwd_reference(q, k, v, valid, seed, go, 0.1, False))
        out["dropout_attention_bwd_" + tag]["rel_to_twin"] = max(out["dropout_attention_bwd_" + tag]["rel_dq_dk_dv"])
# the wide backward pairs' gradients against their twins at chip_smoke phase
# 5e's shapes and inputs at head_dim 256 (padded_ops_vs_twins, d512/h2)
for dt in (torch.bfloat16, torch.float32) if aw is not None and not DECODE_ONLY else ():
    gp = torch.Generator(device=dev).manual_seed(256)
    q, k, v, go = (torch.randn(3, 640, 2, 256, generator=gp, device=dev).to(dt) for _ in range(4))
    valid = torch.rand(3, 640, generator=gp, device=dev) < 0.9
    valid[1] = False
    valid[0, 0] = valid[2, 0] = True
    name = str(dt).split(".")[-1]
    if dt == torch.bfloat16:
        seed = ta.seed_tensor((0, 7), dev)
        for T_, S_, causal in ((640, 640, False), (384, 384, True), (384, 640, False), (200, 333, False),
                               (333, 200, True)):
            a_ = [t[:, :n].contiguous() for t, n in ((q, T_), (k, S_), (v, S_), (go, T_))]
            vv = valid[:, :S_].contiguous()
            out[f"dropout_bwd_rels_{name}_hd256_{T_}x{S_}{'_causal' if causal else ''}"] = rels(
                ta.dropout_attention_bwd(*a_[:3], vv, seed, a_[3], 0.1, causal),
                ta.dropout_attention_bwd_reference(*a_[:3], vv, seed, a_[3], 0.1, causal))
    for T_, S_, causal in ((512, 512, True), (640, 640, False), (384, 384, True), (384, 640, False)):
        a_ = [t[:, :n].contiguous() for t, n in ((q, T_), (k, S_), (v, S_), (go, T_))]
        vv = valid[:, :S_].clone()
        vv[1, 0] = True
        o, stats = ft.flash_train_fwd(*a_[:3], vv, causal=causal)
        out[f"flash_bwd_rels_{name}_hd256_{T_}x{S_}{'_causal' if causal else ''}"] = rels(
            ft.flash_train_bwd(*a_[:3], vv, o, stats, a_[3], causal=causal),
            ft.flash_train_bwd_reference(*a_[:3], vv, o, stats, a_[3], causal=causal))
# every attention wrapper at head_dim 64 (H=8) and 128 (H=4), causal, in bf16
# and (where it takes it) f32: outputs and gradients hashed, not timed, so the
# last line says whether the roots' kernels agree bit for bit at both widths
for D_, H_ in ((64, H), (128, 4)) if ft is not None and not DECODE_ONLY else ():
    for dt in (torch.bfloat16, torch.float32):
        gh = torch.Generator(device=dev).manual_seed(4)
        q, k, v, go = (torch.randn(2, 384, H_, D_, generator=gh, device=dev).to(dt) for _ in range(4))
        valid = (torch.rand(2, 384, generator=gh, device=dev) >= 0.1).to(torch.int32)
        tag = f"{str(dt).split('.')[-1]}_hd{D_}"
        outputs["fused_attention_" + tag] = digest(attn.fused_attention(
            q, k, v, torch.tensor([384, 200], dtype=torch.int32, device=dev), True))
        o, stats = ft.flash_train_fwd(q, k, v, valid, True)
        outputs["flash_train_" + tag] = digest(o, stats, *ft.flash_train_bwd(q, k, v, valid, o, stats, go,
                                                                              True))
        if dt == torch.bfloat16:
            seed = ta.seed_tensor((0, 7), dev)
            outputs["dropout_attention_" + tag] = digest(
                ta.dropout_attention_fwd(q, k, v, valid, seed, 0.1, True),
                *ta.dropout_attention_bwd(q, k, v, valid, seed, go, 0.1, True))
if len(sys.argv) > 2 and not ATTENTION_ONLY:  # the served batch end to end on the committed snapshot
    from smer_music_generation_tpu_torch.infer.engine import InfillEngine
    from smer_music_generation_tpu_torch.train.state import load_inference_model

    with open(sys.argv[2]) as fh:
        served = json.load(fh)
    cfg = ExperimentConfig()
    smodel, _ = load_inference_model(cfg, vocab.vocab_size, served["snapshot"], torch.bfloat16,
                                     device=dev)
    engine = InfillEngine(smodel, vocab, nucleus_p=0.9, max_tgt_len=L, seed=0)
    reqs = [engine.prepare(served["events"], t, b) for t, b in served["jobs"]]
    runs, served_tokens = [], []
    for i in range(6):  # the first warms up (and, with the decode graph, captures)
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.run_batch(reqs, gen)
        torch.cuda.synchronize()
        runs.append(dict(ms=1e3 * (time.perf_counter() - t0),
                         tokens=sum(len(r.generated) for r in res if r is not None)))
        served_tokens.append([None if r is None else [str(t) for t in r.generated] for r in res])
    outputs["served_run_batch"] = hashlib.sha256(
        json.dumps(served_tokens).encode()).hexdigest()[:16]
    out["served_run_batch"] = dict(first=runs[0], runs=runs[1:],
                                   ms=sum(r["ms"] for r in runs[1:]) / 5)
out["outputs"] = outputs
out["build"] = {"path": str(ds.BUILD_INFO.get("path")), "log": str(ds.BUILD_INFO.get("log", ""))}
out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip().splitlines()[0]
print(json.dumps(out), flush=True)
"""


# the decode kernels as earlier designs instantiated them: rowvec_kernel before
# its LN tail (three template flags), the split-free designs (rows NB a
# template argument, head_dim 64 as EPL = 2), and the kernels before they
# took an f32 model (attend_kernel without its row type, the two token
# kernels not templates of the embedding's type)
OLD_DECODE_KERNELS = {
    "attend_kernel<64, cache> (bf16 rows only)": "attend_kernelILi64ELi0E",
    "attend_kernel<64, chunk> (bf16 rows only)": "attend_kernelILi64ELi1E",
    "attend_kernel<64, window> (bf16 rows only)": "attend_kernelILi64ELi2E",
    "embed_pe_kernel (bf16 embedding only)": "embed_pe_kernelEPKi",
    "sample_advance_kernel (bf16 embedding only)": "sample_advance_kernelEPKf",
    "rowvec_kernel<bf16> (before the LN tail)": "rowvec_kernelI13__nv_bfloat16Lb1ELb0EE",
    "rowvec_kernel<int8> (before the LN tail)": "rowvec_kernelIaLb1ELb0EE",
    "rowvec_kernel<bf16, NB=3>": "rowvec_kernelI13__nv_bfloat16Li3ELb1ELb0E",
    "rowvec_kernel<bf16, NB=4>": "rowvec_kernelI13__nv_bfloat16Li4ELb1ELb0E",
    "rowvec_kernel<bf16, NB=9>": "rowvec_kernelI13__nv_bfloat16Li9ELb1ELb0E",
    "attend_kernel<EPL=2, cache>": "attend_kernelILi2ELi0E",
}


def build_facts(build) -> dict:
    """{label: registers, spills, shared memory and the 10 commonest SASS
    opcodes} of the decode kernels in a child's build (none when the child
    found the library built)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    if "Compiling entry" not in build["log"]:
        return {}
    kernels = {**chip_smoke.DECODE_KERNELS, **OLD_DECODE_KERNELS}
    facts = chip_smoke.ptxas_facts(build["log"], tuple(kernels.values()))
    mix = chip_smoke.sass_mix(build["path"], tuple(kernels.values()))
    out = {}
    for label, name in kernels.items():
        if name in facts:
            top = sorted(mix[name].items(), key=lambda kv: -kv[1])[:10]
            out[label] = dict(facts[name], sass_total=sum(mix[name].values()), sass_top=top)
    return out


def served_inputs(path: Path) -> None:
    """The served batch of ``chip_smoke`` phase 3 (its seeded score, its 3
    jobs) and the committed snapshot, written as JSON for the children."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from smer_music_generation_tpu_torch.train.state import default_flagship_snapshot
    from smer_music_generation_tpu_torch.utils.config import ExperimentConfig
    from smer_music_generation_tpu_torch.vocab import WordVocab

    cfg = ExperimentConfig()
    vocab = WordVocab(cfg.vocab_mode, cfg.control_list)
    events = chip_smoke.served_events(chip_smoke.make_score(), vocab)
    path.write_text(json.dumps(dict(snapshot=default_flagship_snapshot(), events=list(events),
                                    jobs=[list(j) for j in chip_smoke.SERVED_JOBS])))


def main(argv) -> int:
    mode = "all"
    if argv and argv[0] in ("--attention", "--decode"):
        mode, argv = argv[0][2:], argv[1:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    served = Path(__file__).resolve().parents[1] / "build" / "ab_served.json"
    served.parent.mkdir(exist_ok=True)
    served_inputs(served)
    digests = {}
    for root in argv:
        proc = subprocess.run([sys.executable, "-c", CHILD, root, str(served), mode,
                               str(Path(__file__).resolve().parents[1])],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        out["build"] = build_facts(out["build"])
        print(json.dumps(out), flush=True)
        for key, d in out["outputs"].items():
            digests.setdefault(key, set()).add(d)
    differ = sorted(k for k, d in digests.items() if len(d) > 1)
    print(json.dumps({"outputs_bit_equal_across_roots": not differ, "differ": differ,
                      "compared": sorted(digests)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
