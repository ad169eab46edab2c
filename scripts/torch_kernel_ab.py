#!/usr/bin/env python3
"""Time the PyTorch port's decode kernels of several checkouts on one card, in turns.

    python scripts/torch_kernel_ab.py ROOT [ROOT ...]

Each ROOT is a checkout that holds ``smer_music_generation_tpu_torch``.  Each
runs in a process of its own, in the order given, with its kernels built from
its own sources into ``ROOT/build/torch_kernels/``; so ``parent change change
parent`` compares two versions on one card.  The shape is the served batch:
B=3, S=1536, index 512, cross lengths 1536/1440/1344, at the flagship width
(4 decoder layers, d512, 8 heads, d_ff 2048) with seeded random bf16 weights
and random biases and LayerNorms.  Timed: the v2 step (``fused_decode_step``),
the v3 nucleus token (``fused_decode_token``) and, where the checkout has int8
weights, the v3 token on them.  Prints one JSON line per run: the card and its
power limit, the root, and per kernel the ms a call (CUDA events, the mean of
200 calls after 20 warm-up calls) and the device microseconds a call by kernel
family (torch.profiler over 20 calls).
"""

from __future__ import annotations

import json
import subprocess
import sys

CHILD = r"""
import json, math, subprocess, sys
root = sys.argv[1]
sys.path.insert(0, root)
import torch
from torch.profiler import ProfilerActivity, profile
from smer_music_generation_tpu_torch.infer.grammar import N_SID, SPAN_BODY, GrammarTables, build_fast_tables
from smer_music_generation_tpu_torch.models.transformer import LayerNorm, ModelConfig, ScoreTransformer
from smer_music_generation_tpu_torch.ops import decode_step as ds
from smer_music_generation_tpu_torch.utils.config import ExperimentConfig
from smer_music_generation_tpu_torch.vocab import WordVocab

NL, D, H, F, L = 4, 512, 8, 2048, 1024
B, S, INDEX = 3, 1536, 512
FAMILIES = ("rowvec_kernel", "attend_kernel", "add_layernorm_kernel", "embed_pe_kernel",
            "sample_advance_kernel")
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


def timed(fn):
    for _ in range(20):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(200):
        fn()
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    split = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0) or 0
        if us > 0:
            fam = next((k for k in FAMILIES if k in evt.key), "other")
            split[fam] = round(split.get(fam, 0.0) + us / 20, 1)
    return dict(ms=start.elapsed_time(end) / 200, device_us=split)


out = {"root": root}
for quant in ("none", "int8") if hasattr(ds, "quantize_columns") else ("none",):
    packed = ds.pack_decoder_weights(model, vpad, quant=quant)
    tag = "" if quant == "none" else "_int8"
    if quant == "none":
        out["v2_step"] = timed(lambda: ds.fused_decode_step(packed, x, self_kv, cross_kv, INDEX,
                                                            cross_len, **kw))
    out["v3_token" + tag] = timed(lambda: ds.fused_decode_token(
        packed, tables, state, aux, span_types, noise, self_kv, cross_kv, INDEX, cross_len,
        **kw, **skw))
out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip().splitlines()[0]
print(json.dumps(out), flush=True)
"""


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv:
        proc = subprocess.run([sys.executable, "-c", CHILD, root], capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
