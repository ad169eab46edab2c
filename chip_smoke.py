#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives ``smer_music_generation_tpu_torch`` (nothing of JAX) through its
paths and prints one line per phase with the elapsed seconds:

0. card: ``nvidia-smi`` name and power limit;
1. build: the CUDA kernels (``ops/csrc/decode_step.cu``,
   ``decode_token.cu``, ``attention.cu``, ``train_attention.cu`` and
   ``flash_train.cu``, one nvcc each, started together; the last three
   include ``attn_tiles.cuh``, ``flash_train.cu`` also ``hopper.cuh``) into
   ``build/torch_kernels/``, with each
   kernel's registers and spills; then the tensor-core instructions
   (HMMA/HGMMA in ``cuobjdump -sass`` of the library) of the seven
   tensor-core kernels, ``flash_fwd_kernel``, ``flash_train_fwd_kernel``,
   ``flash_train_dq_kernel``, ``flash_train_dkv_kernel``,
   ``train_fwd_kernel``, ``train_bwd_rows_kernel`` and
   ``train_bwd_keys_kernel``, with their registers, spills and shared
   memory from the ``-Xptxas -v`` log: the phase fails if any has none,
   or if the flash-train backward pair (on wgmma) has no HGMMA; then the
   registers, spills, shared memory and commonest SASS opcodes of
   the decode kernels' instantiations (``rowvec_kernel`` for bf16, bf16
   with ReLU, bf16 with the LN tail, int8, int8 with ReLU, int8 with the
   LN tail and f32; ``attend_kernel`` at head_dim 64 for each row source):
   the phase fails if one has no entry in the build log or spills;
2. v2 kernel vs twin: ``fused_decode_step`` against its plain torch twin at
   the flagship width (4 decoder layers, d512, 8 heads, d_ff 2048) with
   random seeded bf16 weights and random biases and LayerNorm parameters,
   for B in {1, 3, 4, 8}, L = 1024, S in {512, 1024, 1536}, index in
   {0, 1, 511, 512, 1023} and ragged cross lengths; the kernel's and the
   twin's time (CUDA events) beside the bound (bytes over 3.35 TB/s);
2h. the decode kernels alone: ``rowvec_kernel`` (through ``smer_rowvec``)
   at a token's seven projection shapes (QKV, the three 512 x 512, FFN up
   and down, the f32 logits) in bf16 at B = 1, 3, 8 and 9 rows (the W=9
   verify) and in int8 at B = 3, each held against its twin within
   ``REL_2H`` relative norm (the twin with its last K-slice left out must
   fall outside it) and timed (CUDA events and the profiler's device time)
   beside its bytes bound and ``torch.mm`` of the bf16-rounded x against
   the same W (the yardstick, timed the same two ways), with the sums over
   a token's 25 launches; its time a launch at every row count 1..16 for
   QKV and FFN down; then the LN tail: the three projections whose output
   feeds a post-LN (self out, cross out, FFN down, and FFN down with the
   final LN chained) at B = 1, 3, 8, 9 and 16 in bf16 and B = 3 in int8,
   each launch with its tail bit-equal (output and LayerNorm) to the
   unfused pair (the same launch without the tail, then
   ``add_layernorm_kernel``, twice with the final LN), and timed with and
   without the tail beside ``add_layernorm_kernel`` alone (CUDA events and
   device µs); ``attend_kernel`` at the served case (B=3, self over
   index 512 plus the current row, cross over 1536/1440/1344 rows) against
   its twin within ``REL_2H`` (the twin with each row's last 64-row split
   left out must fall outside it), beside its bound and
   ``scaled_dot_product_attention`` of a (B, H, 1, 64) query over strided
   K and V views of the same cache with a boolean length mask (both timed
   the same two ways), and the sum over a token's 8 launches;
2b. v3 kernel vs twin: ``fused_decode_token`` against its twin on the same
   model, over random valid states, B in {1, 3, 4, 8}, S in {512, 1536},
   index in {0, 1, 512, 1023}, greedy and nucleus (p 0.9 at temperatures
   1.0 and 0.8): ``new_kv`` within the phase-2 tolerance, ``new_state``
   equal except in rows where the twin's own decision margin is within
   what that tolerance allows (counted, at most 2% of the rows); then
   ``sample_advance_kernel`` alone on the twin's logits, equal to the
   twin's sampler except at exact ties (margin within a 1e-5 move of the
   log-probabilities, counted); times and bound at the served shape; then
   the same on a REMI-vocabulary flagship (B in {1, 3, 8}, S 1536, index 0
   and 512);
2c. v4 kernel: ``fused_decode_tokens`` for B in {1, 3, 8}, T_chunk in
   {1, 8, 64}, base index in {0, 512, 1472}, greedy and nucleus, SMER and
   REMI: tokens, state and K/V bit-equal to the v3 kernel run T_chunk times
   over the spliced cache; against the twin, each row's tokens equal up to
   a token where the twin's margin is within the tolerance (at most 2% of
   the rows), ``new_kv`` within the tolerance up to there; v4's time at
   T_chunk 8 and 64 at the served shape beside its bound;
2d. int8: ``rowvec_int8`` against its twin at the six matrix shapes of each
   layer, B in {1, 3, 8}, timed over a token's 24 int8 matrices at B=3;
   then v2, v3 and v4 with ``quant="int8"`` weights against their twins
   under the same tolerance and margin rule (v3-int8 timed at the served
   shape, with its kernel split);
2i. graph replay vs eager: whole decodes the way ``InfillDecoder`` runs them
   on the card, one ``DecodeGraph`` step (a CUDA-graph replay, the position
   on the device) a v3 token or a v4 chunk, against the same decodes through
   the eager wrappers at the host's position with slice writes: tokens,
   final state and every cache row bit-equal, v3 at B in {1, 3, 8}, S in
   {512, 1536}, greedy and nucleus p 0.9, SMER and REMI, int8 at B=3, v4 at
   T_chunk 8 and 64, each B=3 case decoded twice, the second time through
   the graph its decoder's ``GraphCache`` kept; every captured graph's
   tickets zero after each; then the layer plan with the self-attention's
   splits sized from the cache's capacity and the position read through
   ``lens`` against the plan sized from the host's index, bit-equal in
   logits, K|V rows and activation at the served B and S (v3 at index 0,
   1, 512 and 1000 of L rows, v4 at index 512 of L + 64 rows with 0 and 5
   chunk rows, bf16 and int8); then at the served shape a v3 token, an
   int8 token and a v4 chunk of 8 (over L + 64 cache rows, as the decoder
   opens it), eager
   against replayed (CUDA events, the profiler's device time by kernel and
   busy share, the replays' host ops), the capture's ms; the replayed v3
   token's profile must hold its 35 port kernels and no
   ``add_layernorm_kernel``; then the device µs of the LN tail a fused
   launch (with it less without it, at B=3), of ``embed_pe_kernel`` and of
   ``sample_advance_kernel`` beside their bounds;
3. serve: the committed trained snapshot on the card in bf16, a seeded
   3-track 16-bar 4/4 score, ``generate_cli.main`` infilling 2 bars of one
   track (greedy), then ``InfillEngine.run_batch`` on 3 nucleus requests,
   decoded as one batch of 3; every result must restore, close its bars
   and write a MIDI file that reads back, and the path must have gone
   through the v3 kernels only (no twin, no other kernel), as CUDA-graph
   replays: one capture a new graph key of the decoder (the captures' ms,
   their share of the ``run_batch`` wall and the decodes that found their
   graph printed) and one replay a token, the launches
   counting the replays and one warm-up run a capture.  Then the same
   3 requests through the v2 path (``fused_sampling=False``), through v4
   (``InfillDecoder(token_chunk=8)``, which must decode the v3 run's tokens
   and steps) and through v3 with ``InfillEngine(quant="int8")``, each on
   its own kernels alone; then 3 nucleus requests on the committed REMI
   snapshot (``assets/flagship_remi_params.msgpack``, loaded with the
   config its sidecar names) through v3;
3b. HTTP: ``serve.app.serve`` on the trained snapshot, ``GET /health``,
   ``POST /encode`` of the score as the plugin's note dict, 3 concurrent
   ``POST /generate``; each answer must be 200 with events and no ``m_0``,
   through the v3 kernels only.  Then ``serve_cli`` with no flags but its
   address, in a process of its own, answers /health, /encode and one
   /generate, and is stopped;
2e. verify kernel vs twin: ``fused_verify_window`` (the W-row verify of
   speculative decode) against its twin on the random SMER and REMI
   flagships, W in {1, 5, 9, 16, 17, 24} (past 16 rows the row-vector
   kernel runs in launches of 16), index in {0, 512, 1530}, S in {512, 1536}:
   logits and ``new_kv`` within the phase-2 tolerance, and each row against
   the v2 kernel's step at index + j over the spliced cache (bit-equality
   counted, else the largest difference); one call timed at W=9, index 512,
   S 1536 beside its bound, the v2 step at B=1 and its device split;
2f. flash attention vs twin: ``fused_attention`` at B=3, T=S=1536, H=8,
   HD=64, bf16, key lengths 1536/1440/1344, causal and not, and at T, S =
   1000, 777; then a peaked case (q x 4, as a trained encoder's softmax) at
   the served shape and batch rows with key length 0 (all keys weigh alike,
   causal and not, one of them peaked); every case within atol 1e-3 + rtol
   2^-7 (one bf16 ulp of the output); the kernel, the twin and, as a
   yardstick only, torch's ``scaled_dot_product_attention`` with the same
   boolean mask, timed (SDPA gives NaN on a row with no valid key: printed,
   not checked); the card's clocks, temperature and power draw before and
   after (as for 2g);
2g. train attention vs twins: ``fused_dropout_attention``'s forward and
   backward kernels at B=8, H=8, HD=64, bf16, (T, S) = 640x640, 384x384
   causal, 384x640, 1024x1024 and the ragged 200x333 and 333x333 causal,
   ~10% of keys invalid and one batch row
   with no valid key, rates 0 and 0.1, two seeds (then JAX's own gradient
   case, B=2, T=256, S=512, H=2, key (0, 5), sum(out^2),
   tests/test_ops.py:621-655, held at ``TA_REL``, dv's relative norm
   printed beside JAX's 1e-4): the kernels' keep mask
   (``smer_dropout_keep_mask``) bit-equal to ``dropout_mask_reference``;
   the output within atol 1e-2 + rtol 2^-7 of the twin (one bf16 ulp) and 0
   on the row with no valid key; dq, dk, dv within relative norm 0.02,
   0.02 and 1e-3 of the backward twin and exactly 0 on the batch row with
   no valid key; one backward through the autograd
   Function equal to the wrapper's; at 640x640 and 384x640 the forward and
   backward kernels (given the seed on the card and an int32 mask, as the
   model gives them), the twins and SDPA (forward, backward, its own dropout
   stream) timed beside the bounds; the card's clocks before and after;
2j. flash-train kernels (``ops/flash_train.py``, the port of the library
   flash attention ``flash_training`` runs) against their twins at B=8,
   H=8 and (T, S, causal) in ``FT_CASES`` (640x640, 384x384 causal,
   384x640, 2048x2048, 512x512 causal, 512x2048), with a key mask that is
   not a suffix, one batch row with no valid key (whose output must be the
   mean of V over its visited keys) and one suffix-padded: the output
   within ``TA_ATOL`` + ``TA_RTOL`` of the twin, dq, dk and dv within
   ``TA_REL`` of the backward twin fed the kernel's output and m, l, dv's
   reading printed beside JAX's kernel-to-twin bound of 1e-4; one backward
   through the autograd Function equal to the wrappers'; at every shape the
   forward and backward ms (CUDA events) beside the operations bound and
   SDPA's forward and backward with the same boolean mask, the twins too at
   640x640 and 2048x2048, and ``flash_train_dq_kernel`` and
   ``flash_train_dkv_kernel`` each alone (the profiler's device time) beside
   its own operations bound; first the pair's registers and spills from the
   build log;
3c. speculative decode served on the trained snapshot: one request at B=1
   through ``InfillEngine(draft_k=8)``, greedy and nucleus, the same request
   through v3 at B=1 (verify launches, tokens a verify, ms a verify
   iteration and an emitted token), ``generate_cli --draft_k 8``, one
   ``/generate`` on an in-process server with ``draft_k=8`` and a
   ``serve_cli --draft_k 8`` process; the counters must show the verify
   kernel alone; the greedy spec streams at draft_k 8 and 24 against the v2
   stream of the same request under the margin rule of phase 4;
3d. flash encoder served on the trained snapshot: the 3 requests of phase 3
   through v3 on the same weights with ``flash_encoder=True``, four
   ``fused_attention`` launches an encode; its greedy stream against the
   plain encoder's under the margin rule; one encode timed each way;
5. train on the card: the flagship (4+4 layers, d512, 8 heads, d_ff 2048,
   SMER vocab) from a seeded random init, bf16, dropout 0.1, lr 1e-4, 20
   lean train steps on one fixed seeded batch of 8 x 640 + 384 token ids
   with suffix padding, with ``fused_attn_train`` (12 forward and 12
   backward kernel launches a step, no twin) and on the default path (no
   port kernel): the loss finite on every step and lower after 20 than
   after 1; ms a step over steps 6-20 (CUDA events), tokens/s and the
   device busy share (torch.profiler); 5b: ``Trainer.run`` for 2 epochs (1
   pretraining, 1 finetuning) with ``fused_attn_train``, warm-started from
   the committed snapshot, on the windows ``process_song`` cuts from a
   seeded 32-bar, 2-track score (binned loader, seq_bucket 256), the
   kernels launched 12 times each on every step; the last checkpoint
   restored; a snapshot exported; the checkpoint and the snapshot each
   loaded and serving one greedy infill through v3; 5c: the same 20 steps
   with ``flash_training`` at 8 x 640 + 384 and at 8 x 2048 + 512 (JAX's
   long-sequence shape for it): 12 forward and 12 backward flash-train
   launches a step and nothing else, the loss finite and falling, ms a
   step, tokens/s and the busy share; at 8 x 2048 + 512 one step's loss
   and gradients with ``remat`` against one without from one generator
   state (within 1e-6 relative norm, the generator left alike) and the peak
   memory of each; then ``Trainer.run`` for 1 epoch with
   ``flash_training`` and ``remat`` as in 5b, every step through the
   flash-train kernels, its checkpoint serving one greedy infill through
   v3;
4. kernel path vs twin path: one greedy request decoded through the kernels
   and through the twin on the card, for v2 and for v3, and where they
   first differ; a difference at a step where the twin's margin between
   the two tokens exceeds what the phase-2 tolerance allows is a failure;
   then the greedy v3-int8 stream against the v2-int8 stream, under the
   same rule.
6. evaluate on the card, on the committed snapshot (bf16): 6a, six seeded
   16-bar 3-track scores written as MIDI and ``data/build_cli --pack`` in a
   process of its own, whose log must say the native tokenizer core
   (``native/``, built under ``build/native/``) tokenized the tracks; 6b,
   ``eval_cli --max_time_fix_attempts 0 --max_windows 2`` on its test split,
   every kind, each (window, kind) one ``run_batch`` decode through the v3
   kernels alone as graph replays; 6c, ``eval_cli --kinds tensile
   --max_time_fix_attempts 2 --max_windows 1``, the span-retry settle loop
   on the plain forced-prefix loop (no port kernel), every forced decode's
   output beginning with its prefix, its decodes and ms a token printed;
   6d, the same with ``--correct_controls`` (the in-decode mode,
   ``--max_time_fix_attempts 1``); 6e, ``generate_cli --correct_controls``
   on phase 3's greedy request through v3 replays.  Each eval JSON must hold
   JAX's schema and a measured diff; each leg's wall seconds are printed.

Then a JSON line describing the kernels, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero; without a
CUDA device it exits 2 before printing any result.  ``--phases 2e,2f``
(for bring-up) runs the build and the named phases only and prints no
result lines; ``--phases 2g,5`` is the short first call for the training
kernels, ``--phases 2j,5c`` for the flash-train kernels.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import faulthandler
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from smer_music_generation_tpu_torch import native
from smer_music_generation_tpu_torch.codec.annotate import encode_midi
from smer_music_generation_tpu_torch.codec.midi import (
    Instrument,
    MidiScore,
    Note,
    TimeSignature,
    read_midi,
)
from smer_music_generation_tpu_torch.codec.remi import remi_to_midi, smer_to_remi
from smer_music_generation_tpu_torch.codec.smer import events_to_midi, midi_to_events
from smer_music_generation_tpu_torch.data.build import process_song
from smer_music_generation_tpu_torch.data.pack import load_batches, pack_windows
from smer_music_generation_tpu_torch.eval import eval_cli
from smer_music_generation_tpu_torch.infer import decode as decode_mod
from smer_music_generation_tpu_torch.infer import generate_cli
from smer_music_generation_tpu_torch.infer.decode import InfillDecoder
from smer_music_generation_tpu_torch.infer.engine import InfillEngine, change_controls
from smer_music_generation_tpu_torch.infer.grammar import (
    N_SID,
    SPAN_BODY,
    GrammarTables,
    build_fast_tables,
)
from smer_music_generation_tpu_torch.infer.sampling import gumbel_noise
from smer_music_generation_tpu_torch.models.transformer import LayerNorm, ModelConfig, ScoreTransformer
from smer_music_generation_tpu_torch.ops import attention as attn
from smer_music_generation_tpu_torch.ops import decode_graph as dg
from smer_music_generation_tpu_torch.ops import decode_step as ds
from smer_music_generation_tpu_torch.ops import flash_train as ft
from smer_music_generation_tpu_torch.ops import train_attention as ta
from smer_music_generation_tpu_torch.serve.app import ServingContext, serve
from smer_music_generation_tpu_torch.train.checkpoint import (
    export_params_msgpack,
    latest_checkpoint,
    restore_checkpoint,
)
from smer_music_generation_tpu_torch.train.loop import Trainer
from smer_music_generation_tpu_torch.train.loss import build_loss_tables, multihead_ce
from smer_music_generation_tpu_torch.train.state import (
    TrainState,
    _forward_batch,
    build_model,
    default_flagship_snapshot,
    load_inference_model,
    make_train_step,
)
from smer_music_generation_tpu_torch.utils.config import ExperimentConfig
from smer_music_generation_tpu_torch.vocab import WordVocab

TIME_LIMIT_S = 900  # a hang dumps its traceback and exits before an outer 1200 s limit
HBM_BYTES_PER_S = 3.35e12  # H100 SXM at its full 700 W (NVIDIA data sheet)
BF16_FLOPS = 989e12
F32_FLOPS = 67e12  # f32 outside the tensor cores
NL, D, H, F, L = 4, 512, 8, 2048, 1024
MAX_SPANS, SPAN_CAP = 256, 100  # the decoder's defaults
# kernel vs twin: bf16 operands with f32 accumulation on both sides, summed
# in another order; an activation that lands on the other side of a bf16
# rounding boundary moves a downstream value by one bf16 ulp (2^-8
# relative), so the check is |kernel - twin| <= ATOL + RTOL * |twin|
ATOL, RTOL = 5e-2, 2e-2
# phase 2h, a decode kernel alone against its twin (both f32 sums of the
# same bf16 operands, only the order differs): |kernel - twin| / |twin|,
# far under what one 64-row split or one K-slice left out moves (~0.1)
REL_2H = 1e-3
TIE = 1e-5  # the sampler alone on identical logits may part only at a tie this close
MAX_CLOSE_SHARE = 0.02  # the share of v3 state rows that may take the margin exception
SERVED_CASE = (3, 1536, 512)  # (B, S, index): the served batch's shape, where both kernels are timed
SAMPLERS = (  # (name, greedy, nucleus_p, temperature)
    ("greedy", True, None, 1.0),
    ("nucleus p0.9 T1.0", False, 0.9, 1.0),
    ("nucleus p0.9 T0.8", False, 0.9, 0.8),
)
# the flash-train kernels come before the train kernels, whose names their
# own hold: a name matches the first family (or SASS function) it is in
FLASH_TRAIN_KERNELS = ("flash_train_fwd_kernel", "flash_train_dq_kernel", "flash_train_dkv_kernel")
FAMILIES = ("rowvec_kernel", "attend_kernel", "add_layernorm_kernel",
            "embed_pe_kernel", "sample_advance_kernel", "flash_fwd_kernel", *FLASH_TRAIN_KERNELS,
            "train_fwd_kernel", "train_bwd_rows_kernel", "train_bwd_keys_kernel")
# the kernels on the tensor cores: phase 1 reads their SASS and their ptxas
# facts
TENSOR_CORE_KERNELS = ("flash_fwd_kernel", *FLASH_TRAIN_KERNELS, "train_fwd_kernel",
                       "train_bwd_rows_kernel", "train_bwd_keys_kernel")
# the warp-specialised kernels on wgmma and TMA: phase 1 fails unless their
# SASS holds HGMMA
WGMMA_KERNELS = ("flash_train_dq_kernel", "flash_train_dkv_kernel")
# flash attention vs twin: f32 sums on both sides in another order, then the
# output rounded to bf16, so the two may differ by one bf16 ulp (2^-7 of the
# value at most) plus what rounds near zero
ATTN_ATOL, ATTN_RTOL = 1e-3, 2 ** -7
SPEC_K = 8  # draft_k of the served speculative decode (JAX measured 8)
# the six matrices of a decoder layer as the row-vector kernel reads them:
# (name, packed key, row stride, first column (bias and scale strip), K, N,
# relu); the logits (D -> vpad, f32) are the seventh projection of a token
LAYER_MATRICES = (
    ("QKV", "w_attn", 6 * D, 0, D, 3 * D, False), ("self out", "w_attn", 6 * D, 3 * D, D, D, False),
    ("cross q", "w_attn", 6 * D, 4 * D, D, D, False),
    ("cross out", "w_attn", 6 * D, 5 * D, D, D, False),
    ("FFN up", "w_ff1", F, 6 * D, D, F, True), ("FFN down", "w_ff2", D, 6 * D + F, F, D, False),
)
# the decode kernels' instantiations (mangled-name pieces) whose registers,
# spills and SASS phase 1 prints; each must appear in the build log and
# spill no more than DECODE_SPILL_BYTES (none; the earlier split-free
# attend_kernel spilled 4 + 4 bytes, its rowvec_kernel none)
DECODE_KERNELS = {
    "rowvec_kernel<bf16>": "rowvec_kernelI13__nv_bfloat16Lb1ELb0ELb0EE",
    "rowvec_kernel<bf16, relu>": "rowvec_kernelI13__nv_bfloat16Lb1ELb1ELb0EE",
    "rowvec_kernel<bf16, LN tail>": "rowvec_kernelI13__nv_bfloat16Lb1ELb0ELb1EE",
    "rowvec_kernel<int8>": "rowvec_kernelIaLb1ELb0ELb0EE",
    "rowvec_kernel<int8, relu>": "rowvec_kernelIaLb1ELb1ELb0EE",
    "rowvec_kernel<int8, LN tail>": "rowvec_kernelIaLb1ELb0ELb1EE",
    "rowvec_kernel<f32>": "rowvec_kernelIfLb0ELb0ELb0EE",
    "attend_kernel<64, cache>": "attend_kernelILi64ELi0E",
    "attend_kernel<64, chunk>": "attend_kernelILi64ELi1E",
    "attend_kernel<64, window>": "attend_kernelILi64ELi2E",
}
DECODE_SPILL_BYTES = 0
# the projections whose output feeds a post-LN, with the LayerNorm rows of
# layer 0 they carry (packed["ln"]); the last layer's FFN down chains the
# final LN (packed["fin_ln"]) too
LN_TAILS = (("self out", 0, False), ("cross out", 2, False), ("FFN down", 4, False),
            ("FFN down", 4, True))
# phase 2e's window widths: past 16 rows the row-vector kernel runs in
# launches of 16 rows, which must not change a bit of any row
VERIFY_WIDTHS = (1, 5, 9, 16, 17, 24)
SERVED_JOBS = (([0], [2, 3]), ([1], [7]), ([2], [11, 12]))  # (tracks, bars) of phase 3's batch
HD_ATTN = 64  # the encoder's head_dim, the flash kernel's
# train attention vs twin: f32 sums in another order, so a weight may round
# to the neighbouring bf16 value: the output within one bf16 ulp (2^-7 of
# the value) plus what rounds near zero; the gradients within JAX's own
# bounds between its kernel and its twin (tests/test_ops.py:621-655), dv
# at 1e-3 and not JAX's 1e-4: dv = bf16(w)^T g summed by the tensor cores,
# whose f32 accumulation does not round to nearest, reads 1.0-1.6e-4 from
# the same sum in float64 on an H100 where the twin's f32 sum reads
# 1-4.5e-5 from it; the exp (ex2.approx gives torch.exp2's bits) and the
# order of w's formula are not what moves it (scripts/dv_order_probe.py;
# tests/test_torch_attention_tiles.py::test_dv_moves_with_the_last_bits_of_w)
TA_ATOL, TA_RTOL = 1e-2, 2 ** -7
TA_REL = {"dq": 0.02, "dk": 0.02, "dv": 1e-3}
TA_SEEDS = ((0, 7), (0xDEADBEEF, 0x12345678))  # raw two-word keys
# (T, S, causal) of phase 2g: the encoder's, the decoder's self and cross
# attention at the training step's 640 + 384 bucket, the gate's largest, and
# two ragged shapes the wrapper takes (T not a multiple of the 32-row block,
# S not one of the 64-key tile)
TA_CASES = ((640, 640, False), (384, 384, True), (384, 640, False), (1024, 1024, False),
            (200, 333, False), (333, 333, True))
TA_TIMED = ((640, 640), (384, 640))
# (T, S, causal) of phase 2j, the flash-train kernels at B=8, H=8: the
# training step's 640 + 384 bucket (encoder, decoder self, cross) and JAX's
# long-sequence shape for flash_training, B8 x (src 2048, tgt 512)
# (docs/PERFORMANCE.md:566-570); held as phase 2g holds its kernels
FT_CASES = ((640, 640, False), (384, 384, True), (384, 640, False), (2048, 2048, False),
            (512, 512, True), (512, 2048, False))
FT_TIMED = (640, 640, False), (2048, 2048, False)  # twins timed too; the last is the kernels line's
TRAIN_LONG_SRC, TRAIN_LONG_TGT = 2048, 512  # phase 5c's long bucket
TRAIN_B = 8  # rows of the training step of phases 2g and 5
TRAIN_SRC, TRAIN_TGT = 640, 384  # the dominant bucket of the packed corpus
TRAIN_STEPS, TRAIN_WARM = 20, 5  # phase 5's steps, and how many the timing skips

T0 = time.perf_counter()


def say(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled(fn, iters: int = 20, top: int = 6):
    """``fn`` once to warm, then ``iters`` calls under torch.profiler:
    (device µs a call by kernel family, or None when the profiler records
    no CUDA kernel on this machine; the ``top`` host ops by self CPU time
    over the calls, as (name, µs, count); the ``top`` device kernels by
    device time, as (name, µs a call, launches a call)).  Only the device's
    own events count (kernels, copies, sets), not the host ops and ranges
    that launched them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    split, host, dev = {}, [], []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0) or 0
        # device work only: host ops and user ranges carry their kernels'
        # device time too, and summing them would count it twice
        if us > 0 and evt.device_type == DeviceType.CUDA and not evt.is_user_annotation:
            family = next((k for k in FAMILIES if k in evt.key), "other")
            split[family] = split.get(family, 0.0) + us / iters
            dev.append((evt.key, us / iters, evt.count / iters))
        host.append((evt.key, evt.self_cpu_time_total, evt.count))
    host.sort(key=lambda e: -e[1])
    dev.sort(key=lambda e: -e[1])
    return split or None, host[:top], dev[:top]


def device_split(fn, iters: int = 20):
    return profiled(fn, iters)[0]


def say_split(split, ms: float) -> None:
    if split is None:
        say("    device time by kernel: not measured (the profiler saw no CUDA kernel)")
        return
    busy = sum(split.values())
    parts = ", ".join(f"{k} {v:.1f} us" for k, v in sorted(split.items()))
    say(f"    device time per call: {parts}; total {busy:.1f} us of "
        f"{1e3 * ms:.1f} us wall, device busy {busy / (1e3 * ms):.1%}")


def step_bytes_flops(packed, B: int, index: int, cross_len):
    """Bytes and bf16 operations of one v2 step: every packed decoder weight
    (not the embedding, which v2 does not read), x_emb, the valid cache
    rows and the outputs, each moved once."""
    weight_bytes = sum(t.numel() * t.element_size() for k, t in packed.items() if k != "emb")
    vpad = packed["fc_w"].shape[1]
    rows = NL * (B * index + int(sum(cross_len)))
    cache_bytes = rows * 2 * D * 2
    io_bytes = B * D * 2 + B * vpad * 4 + NL * B * 2 * D * 2 + B * 4
    flops = 2 * B * NL * (6 * D * D + 2 * D * F) + 2 * B * D * vpad + 4 * D * rows
    return weight_bytes + cache_bytes + io_bytes, flops


def bound_ms(nbytes: float, flops: float) -> float:
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)


def token_bound_ms(packed, B: int, index: int, cross_len, V: int, nucleus: bool) -> float:
    """Least time of one v3 token.  Bytes: the v2 step's, with B embedding
    rows (bf16) in place of x_emb and without the logits, which stay inside
    the token; fc_w and fc_b over the V real lanes only (the sampling
    tables never allow a pad lane, so its logit, mask entry and noise are
    never needed); then the state in and out, aux, and a row's span type,
    grammar mask row (V lanes), class row and (nucleus) noise row (V lanes),
    and sid_tbl.  Operations: v2's over V lanes plus the nucleus rule's
    V x V multiply-adds a row."""
    nbytes, flops = step_bytes_flops(packed, B, index, cross_len)
    fc_w, fc_b = packed["fc_w"], packed["fc_b"]
    pad = fc_w.shape[1] - V
    nbytes -= B * fc_w.shape[1] * 4  # the v2 logits output
    nbytes -= pad * (D * fc_w.element_size() + fc_b.element_size())
    row = 4 + V * 4 + ds._N_CLASSES * 4 + (V * 4 if nucleus else 0)
    nbytes += 2 * 6 * B * 4 + 2 * B * 4 + B * row + 16 * 4  # ..., sid_tbl (16,) int32
    flops -= 2 * B * D * pad
    flops += 2 * B * V * V if nucleus else 0
    return bound_ms(nbytes, flops)


def make_score(bars=16, tracks=3, tempo=100.0, seed=7) -> MidiScore:
    """A seeded 4/4 score of random sixteenth-grid notes and chords."""
    rng = np.random.default_rng(seed)
    s = MidiScore(initial_tempo=tempo)
    s.time_signature_changes = [TimeSignature(4, 4, 0.0)]
    sixteenth = 60.0 / tempo / 4
    for t in range(tracks):
        inst = Instrument(program=[0, 32, 48][t])
        for bar in range(bars):
            slot = 0
            while slot < 16:
                if rng.random() < 0.5:
                    length = min(int(rng.integers(1, 5)), 16 - slot)
                    start = (bar * 16 + slot) * sixteenth
                    pitch = int(rng.integers(40, 90))
                    inst.notes.append(Note(100, pitch, start, start + length * sixteenth))
                    if rng.random() < 0.3:
                        inst.notes.append(Note(100, min(pitch + 4, 108), start, start + length * sixteenth))
                    slot += length
                else:
                    slot += 1
        s.instruments.append(inst)
    return s


def random_flagship(dev, mode: int = 0):
    """The flagship-width decoder with seeded random bf16 weights, random
    biases and random LayerNorm parameters (a fresh model has zero biases
    and unit LayerNorms, so a kernel that dropped a bias or read the wrong
    offset would still agree), for the SMER (0) or REMI (1) vocabulary."""
    torch.manual_seed(mode)
    vocab = WordVocab(mode, ExperimentConfig().control_list)
    model = ScoreTransformer(ModelConfig(
        vocab_size=vocab.vocab_size, d_model=D, nhead=H, num_encoder_layers=1,
        num_decoder_layers=NL, d_ff=F, dtype=torch.bfloat16,
    )).to(dev).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LayerNorm):
                m.weight.copy_(1.0 + 0.2 * torch.randn_like(m.weight))
            if isinstance(m, (LayerNorm, torch.nn.Linear)):
                m.bias.normal_(0.0, 0.5)
    vpad = ds.vocab_pad(vocab.vocab_size)
    return vocab, model, ds.pack_decoder_weights(model, vpad), vpad


def phase_kernel_vs_twin(dev, packed, vocab, vpad, Bs=(1, 3, 4, 8), Ss=(512, 1024, 1536),
                         indices=(0, 1, 511, 512, 1023)):
    kw = dict(n_layers=NL, d_model=D, nhead=H, d_ff=F, vpad=vpad)
    g = torch.Generator(device=dev).manual_seed(1)
    worst, report = 0.0, None
    for B in Bs:
        for S in Ss:
            x = torch.randn(B, D, generator=g, device=dev).to(torch.bfloat16)
            self_kv = torch.randn(NL, B, L, 2 * D, generator=g, device=dev).to(torch.bfloat16)
            cross_kv = torch.randn(NL, B, S, 2 * D, generator=g, device=dev).to(torch.bfloat16)
            cl_list = [S - (S // 16) * b for b in range(B)]
            cross_len = torch.tensor(cl_list, dtype=torch.int32, device=dev)
            for index in indices:
                args = (packed, x, self_kv, cross_kv, index, cross_len)
                lg, kv = ds.fused_decode_step(*args, **kw)
                torch.cuda.synchronize()
                lr, kr = ds.fused_decode_step_reference(*args, **kw)
                V = vocab.vocab_size
                err = max((lg[:, :V] - lr[:, :V]).abs().max().item(),
                          (kv.float() - kr.float()).abs().max().item())
                ok = (
                    torch.allclose(lg[:, :V], lr[:, :V], atol=ATOL, rtol=RTOL)
                    and torch.allclose(kv.float(), kr.float(), atol=ATOL, rtol=RTOL)
                    and torch.isfinite(lg[:, :V]).all().item()
                )
                ms = cuda_ms(lambda: ds.fused_decode_step(*args, **kw), iters=20)
                plain_ms = cuda_ms(lambda: ds.fused_decode_step_reference(*args, **kw), iters=5)
                bound = bound_ms(*step_bytes_flops(packed, B, index, cl_list))
                say(f"  B={B} S={S} index={index:4d} cross_len={cl_list}: max|kernel-twin|={err:.3e} "
                    f"kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, bound {bound:.4f} ms")
                if not ok:
                    raise AssertionError(f"kernel disagrees with the twin at B={B} S={S} index={index}")
                worst = max(worst, err)
                if (B, S, index) == SERVED_CASE:
                    report = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound)
                    say_split(device_split(lambda: ds.fused_decode_step(*args, **kw)), ms)
    return worst, report


def sampling_tables(vocab, vpad, dev):
    t = GrammarTables.build(vocab)
    tabs = ds.pack_sampling_tables(vocab, t, build_fast_tables(t), vpad)
    return {k: torch.as_tensor(v, device=dev) for k, v in tabs.items()}


def random_states(rng, B: int, V: int, dev):
    """Valid (6, B) states: any token, bits 0-15 (0 in a third of the rows),
    steps 1..span_cap (a span start in a third of the rows), a span index
    below n_spans, mixed done and no_whole flags, span types of all five
    kinds, mostly bodies (a control span ends after one token and resets
    the bits)."""
    n_spans = rng.integers(1, MAX_SPANS + 1, size=B)
    third = rng.random((2, B)) < 1 / 3
    state = np.stack([
        rng.integers(1, V, size=B), np.where(third[0], 0, rng.integers(0, 16, size=B)),
        np.where(third[1], 1, rng.integers(1, SPAN_CAP + 1, size=B)), rng.integers(0, n_spans),
        rng.random(B) < 0.25, rng.integers(1, 500, size=B),
    ]).astype(np.int32)
    aux = np.stack([n_spans, rng.random(B) < 0.5]).astype(np.int32)
    body = rng.random((B, MAX_SPANS)) < 0.6
    span_types = np.where(body, 0, rng.integers(1, 5, size=(B, MAX_SPANS))).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (state, aux, span_types))


def twin_logits(packed, state, self_kv, cross_kv, index, cross_len, vpad):
    """The logits the v3 twin samples from: the embedding row x sqrt(D) plus
    the analytic PE row, in f32, through the v2 twin."""
    x = packed["emb"][state[ds.ST_TOKEN].long()].float() * math.sqrt(D) + ds.pe_row(index, D, state.device)
    return ds.fused_decode_step_reference(
        packed, x, self_kv, cross_kv, index, cross_len, n_layers=NL, d_model=D, nhead=H, d_ff=F, vpad=vpad,
    )[0]


def decision_flips(logits, state, aux, span_types, noise, index, tables, skw, eps):
    """Per row, whether the twin's token could change if every log-probability
    moved by at most ``eps`` (B,) (a logit error d moves them by at most
    2d/T): the top two final scores lie within ``eps``, or, under the
    nucleus rule, a lane that could win (its score without the rule comes
    within ``eps`` of the winner's) has |above - p| within what such a move
    allows in ``above``: above * expm1(eps) for the lanes it keeps, plus the
    mass of the lanes whose order against it may flip (those within
    ``eps`` in log-probability)."""
    kw = dict(mode=skw["mode"], max_spans=skw["max_spans"], temperature=skw["temperature"],
              n_sid=skw["n_sid"])
    noise_row = None if skw["greedy"] else noise[index]
    final, above = ds.sampling_scores(logits, state, aux, span_types, noise_row, tables,
                                      nucleus_p=skw["nucleus_p"], greedy=skw["greedy"], **kw)
    top2 = final.topk(2, dim=-1).values
    flips = top2[:, 0] - top2[:, 1] <= eps
    if above is None:
        return flips
    logp, _ = ds.sampling_scores(logits, state, aux, span_types, None, tables,
                                 nucleus_p=None, greedy=True, **kw)
    e = eps[:, None]
    cand = logp + noise_row >= top2[:, :1] - e
    order_may_flip = (logp[:, None, :] - logp[:, :, None]).abs() <= e[:, :, None]  # (B, w, v)
    order_may_flip &= ~torch.eye(logp.shape[1], dtype=torch.bool, device=logp.device)
    near = (logp.exp()[:, None, :] * order_may_flip).sum(dim=-1)
    slack = above * torch.expm1(e) + torch.exp(e) * near
    return flips | (cand & ((above - skw["nucleus_p"]).abs() <= slack)).any(dim=-1)


def sampler_kw(vocab, greedy, p, temp):
    return dict(mode=vocab.mode, max_spans=MAX_SPANS, span_cap=SPAN_CAP,
                eos_index=vocab.eos_index, mask_index=vocab.mask_index,
                nucleus_p=p, temperature=temp, greedy=greedy, n_sid=N_SID,
                span_body=SPAN_BODY)


def phase_token_vs_twin(dev, packed, vocab, vpad, Bs=(1, 3, 4, 8), Ss=(512, 1536),
                        indices=(0, 1, 512, 1023)):
    tables = sampling_tables(vocab, vpad, dev)
    V = vocab.vocab_size
    kw = dict(n_layers=NL, d_model=D, nhead=H, d_ff=F, vpad=vpad)
    g = torch.Generator(device=dev).manual_seed(2)
    rng = np.random.default_rng(3)
    worst, report, cases = 0.0, None, 0
    close_rows = tie_rows = rows = 0
    for B in Bs:
        for S in Ss:
            self_kv = torch.randn(NL, B, L, 2 * D, generator=g, device=dev).to(torch.bfloat16)
            cross_kv = torch.randn(NL, B, S, 2 * D, generator=g, device=dev).to(torch.bfloat16)
            cl_list = [S - (S // 16) * b for b in range(B)]
            cross_len = torch.tensor(cl_list, dtype=torch.int32, device=dev)
            noise = gumbel_noise((L, B, vpad), g, dev)
            for index in indices:
                state, aux, span_types = random_states(rng, B, V, dev)
                for name, greedy, p, temp in SAMPLERS:
                    skw = sampler_kw(vocab, greedy, p, temp)
                    args = (packed, tables, state, aux, span_types, noise, self_kv, cross_kv, index, cross_len)
                    ks, kkv = ds.fused_decode_token(*args, **kw, **skw)
                    torch.cuda.synchronize()
                    rs, rkv = ds.fused_decode_token_reference(*args, **kw, **skw)
                    err = (kkv.float() - rkv.float()).abs().max().item()
                    if not torch.allclose(kkv.float(), rkv.float(), atol=ATOL, rtol=RTOL):
                        raise AssertionError(f"v3 new_kv disagrees at B={B} S={S} index={index} {name}")
                    worst = max(worst, err)
                    # rows where the twin's margin is within what the tolerance allows
                    lg = twin_logits(packed, state, self_kv, cross_kv, index, cross_len, vpad)
                    delta = ATOL + RTOL * lg[:, :V].abs().amax(dim=-1)
                    close = decision_flips(lg, state, aux, span_types, noise, index, tables, skw,
                                           eps=2 * delta / temp)
                    differ = (ks != rs).any(dim=0)
                    if (differ & ~close).any():
                        raise AssertionError(
                            f"v3 new_state differs from the twin at B={B} S={S} index={index} {name} "
                            f"in a row with a decisive margin: kernel {ks.tolist()} twin {rs.tolist()}")
                    close_rows += int((differ & close).sum())
                    rows += B
                    # the sampler alone on the twin's logits: equal but at exact ties
                    alone = ds.sample_and_advance(lg, state, aux, span_types, noise, index, tables, **skw)
                    want = ds.sample_and_advance_reference(lg, state, aux, span_types, noise, index,
                                                           tables, **skw)
                    tie = decision_flips(lg, state, aux, span_types, noise, index, tables, skw,
                                         eps=torch.full((B,), TIE, device=dev))
                    differ_alone = (alone != want).any(dim=0)
                    if (differ_alone & ~tie).any():
                        raise AssertionError(
                            f"sample_advance_kernel differs from its twin at B={B} S={S} index={index} "
                            f"{name}: kernel {alone.tolist()} twin {want.tolist()}")
                    tie_rows += int((differ_alone & tie).sum())
                    cases += 1
                    if (B, S, index) == SERVED_CASE and name == SAMPLERS[1][0]:
                        ms = cuda_ms(lambda: ds.fused_decode_token(*args, **kw, **skw), iters=20)
                        plain_ms = cuda_ms(lambda: ds.fused_decode_token_reference(*args, **kw, **skw), iters=5)
                        bound = token_bound_ms(packed, B, index, cl_list, V, nucleus=True)
                        report = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound)
                        say(f"  served shape B={B} S={S} index={index} cross_len={cl_list} ({name}): "
                            f"kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, bound {bound:.4f} ms (bytes)")
                        say_split(device_split(lambda: ds.fused_decode_token(*args, **kw, **skw)), ms)
            say(f"  B={B} S={S}: max|kernel-twin| of new_kv so far {worst:.3e}")
    say(f"  {cases} cases: new_kv within atol {ATOL} + rtol {RTOL} (max {worst:.3e}); "
        f"{close_rows} of {rows} state rows differ where the twin's margin is within that tolerance; "
        f"sample_advance_kernel alone differs in {tie_rows} rows, all exact ties (< {TIE})")
    if close_rows > MAX_CLOSE_SHARE * rows:
        raise AssertionError(f"{close_rows} of {rows} state rows needed the margin exception "
                             f"(more than {MAX_CLOSE_SHARE:.0%})")
    return worst, report


def splice(self_kv, rows, base: int):
    """The cache as the decode loop leaves it after a chunk: a copy of
    ``self_kv`` with ``rows`` (nl, T, B, 2D) at positions base.."""
    out = self_kv.clone()
    out[:, :, base : base + rows.shape[1]] = rows.transpose(1, 2)
    return out


def tokens_bound_ms(packed, B: int, base: int, cross_len, V: int, nucleus: bool, T: int) -> float:
    """Least time of one v4 call of T tokens, each input read once: the
    weights (fc_w and fc_b over the V real lanes), the cache rows below
    ``base`` and the cross rows once a call; per token the embedding rows,
    the K|V rows it writes, a row's span type, grammar mask row, class row
    and (nucleus) noise row, and its token; the state, aux and sid_tbl once.
    Operations: T v3 tokens', each token also attending the chunk rows
    before it."""
    fc_w = packed["fc_w"]
    pad = fc_w.shape[1] - V
    weight_bytes = sum(t.numel() * t.element_size() for k, t in packed.items() if k != "emb")
    weight_bytes -= pad * (D * fc_w.element_size() + packed["fc_b"].element_size())
    cache_bytes = NL * (B * base + int(sum(cross_len))) * 2 * D * 2
    row = 4 + V * 4 + ds._N_CLASSES * 4 + (V * 4 if nucleus else 0)
    per_token = B * D * 2 + NL * B * 2 * D * 2 + B * row + B * 4
    nbytes = weight_bytes + cache_bytes + T * per_token + 2 * 6 * B * 4 + 3 * B * 4 + 16 * 4
    _, flops = step_bytes_flops(packed, B, base, cross_len)
    flops = T * (flops - 2 * B * D * pad + (2 * B * V * V if nucleus else 0))
    flops += 4 * D * NL * B * T * (T - 1) // 2
    return bound_ms(nbytes, flops)


def phase_tokens_vs_twin(dev, flagships):
    """v4 ``fused_decode_tokens`` against its twin and against the v3 kernel
    run T_chunk times over the spliced cache, SMER and REMI."""
    LC = 1536  # the self cache: base + T_chunk <= 1536
    S = 1536
    g = torch.Generator(device=dev).manual_seed(4)
    rng = np.random.default_rng(5)
    worst, report, cases, close_rows, rows, decisions = 0.0, {}, 0, 0, 0, 0
    for vocab, packed, vpad in flagships:
        tables = sampling_tables(vocab, vpad, dev)
        V = vocab.vocab_size
        kw = dict(n_layers=NL, d_model=D, nhead=H, d_ff=F, vpad=vpad)
        for B in (1, 3, 8):
            self_kv = torch.randn(NL, B, LC, 2 * D, generator=g, device=dev).to(torch.bfloat16)
            cross_kv = torch.randn(NL, B, S, 2 * D, generator=g, device=dev).to(torch.bfloat16)
            cl_list = [S - (S // 16) * b for b in range(B)]
            cross_len = torch.tensor(cl_list, dtype=torch.int32, device=dev)
            noise = gumbel_noise((LC, B, vpad), g, dev)
            for T in (1, 8, 64):
                for base in (0, 512, LC - 64):
                    state, aux, span_types = random_states(rng, B, V, dev)
                    state[ds.ST_DONE, 0] = 0  # a live row in every case
                    for name, greedy, p, temp in SAMPLERS[:2]:
                        skw = dict(**sampler_kw(vocab, greedy, p, temp), T_chunk=T)
                        args = (packed, tables, state, aux, span_types, noise, self_kv, cross_kv,
                                base, cross_len)
                        ks, ktok, kkv = ds.fused_decode_tokens(*args, **kw, **skw)
                        # the v3 kernel T times over the cache the v3 loop would hold
                        st, cache, toks, kvs = state, self_kv.clone(), [], []
                        for t in range(T):
                            st, kv = ds.fused_decode_token(
                                packed, tables, st, aux, span_types, noise, cache, cross_kv,
                                base + t, cross_len, **kw, **sampler_kw(vocab, greedy, p, temp))
                            cache[:, :, base + t] = kv
                            toks.append(st[ds.ST_TOKEN])
                            kvs.append(kv)
                        torch.cuda.synchronize()
                        same = (torch.equal(ktok, torch.stack(toks)) and torch.equal(ks, st)
                                and torch.equal(kkv, torch.stack(kvs, dim=1)))
                        if not same:
                            d = (kkv.float() - torch.stack(kvs, dim=1).float()).abs().max().item()
                            raise AssertionError(
                                f"v4 is not bit-equal to v3 over the spliced cache at {vocab.mode=} "
                                f"B={B} T={T} base={base} {name}: max |K/V difference| {d:.3e}")
                        rs, rtok, rkv = ds.fused_decode_tokens_reference(*args, **kw, **skw)
                        parted, compared = tokens_against_twin(
                            packed, tables, args, kw, skw, (ks, ktok), (rs, rtok), vpad, V,
                            f"{vocab.mode=} B={B} T={T} base={base} {name}")
                        close_rows += parted
                        decisions += compared
                        worst = max(worst, max_kv_err(ktok, kkv, rtok, rkv))
                        rows += B
                        cases += 1
                        if (vocab.mode, B, base, name) == (0, 3, 512, SAMPLERS[1][0]) and T > 1:
                            ms = cuda_ms(lambda: ds.fused_decode_tokens(*args, **kw, **skw), iters=5)
                            plain_ms = cuda_ms(
                                lambda: ds.fused_decode_tokens_reference(*args, **kw, **skw),
                                iters=1, warmup=1)
                            bound = tokens_bound_ms(packed, B, base, cl_list, V, True, T)
                            report[T] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound)
                            say(f"  served shape B={B} S={S} base={base} T_chunk={T} ({name}): "
                                f"kernel {ms:.4f} ms ({ms / T:.4f} ms a token), twin {plain_ms:.4f} ms, "
                                f"bound {bound:.4f} ms ({bound / T:.5f} ms a token)")
                            say_split(device_split(lambda: ds.fused_decode_tokens(*args, **kw, **skw),
                                                   iters=3), ms)
            say(f"  vocab_mode {vocab.mode} B={B}: {cases} cases so far, v4 bit-equal to v3 x T_chunk "
                f"in all; max|kernel-twin| of new_kv {worst:.3e}")
    say(f"  {cases} cases: tokens, state and K/V bit-equal to the v3 kernel run T_chunk times over "
        f"the spliced cache; against the twin new_kv within atol {ATOL} + rtol {RTOL} (max "
        f"{worst:.3e}) up to each row's first token that differs; {close_rows} of {rows} rows "
        f"part from the twin, each where the twin's margin is within that tolerance, at "
        f"{close_rows} of the {decisions} token decisions compared")
    # a row decides T_chunk tokens: the share is taken over decisions, as
    # phase 2b's is over its one-token rows
    if close_rows > MAX_CLOSE_SHARE * decisions:
        raise AssertionError(f"{close_rows} of {decisions} v4 token decisions needed the margin "
                             f"exception")
    return worst, report


def first_differences(ktok, rtok):
    """(B,) the first chunk row where the kernel's token differs from the
    twin's, T_chunk where none does."""
    T = ktok.shape[0]
    differ = ktok != rtok
    idx = torch.arange(T, device=ktok.device)[:, None].expand_as(differ)
    return torch.where(differ, idx, T).amin(dim=0)


def max_kv_err(ktok, kkv, rtok, rkv) -> float:
    """max |kernel - twin| of new_kv over the rows computed from equal
    inputs: row t of an element while its tokens before t agree."""
    first = first_differences(ktok, rtok)
    T = ktok.shape[0]
    keep = torch.arange(T, device=ktok.device)[:, None] <= first[None, :]  # (T, B)
    diff = (kkv.float() - rkv.float()).abs() * keep[None, :, :, None]
    ok = torch.isclose(kkv.float(), rkv.float(), atol=ATOL, rtol=RTOL) | ~keep[None, :, :, None]
    if not ok.all():
        raise AssertionError(f"v4 new_kv disagrees with the twin by {diff.max().item():.3e}")
    return diff.max().item()


def tokens_against_twin(packed, tables, args, kw, skw, kernel, twin, vpad, V, label) -> int:
    """The v4 kernel's tokens and state against the twin's.  A row may part
    from the twin only at a token where the twin's own margin is within what
    the tolerance allows (``decision_flips``, as phase 2b); after that the
    two streams are not comparable.  Returns (rows that part, token
    decisions compared)."""
    (ks, ktok), (rs, rtok) = kernel, twin
    first = first_differences(ktok, rtok)
    T = ktok.shape[0]
    parted, compared = 0, 0
    for b in range(ks.shape[1]):
        t = int(first[b])
        compared += min(t + 1, T)
        if t == T:
            if not torch.equal(ks[:, b], rs[:, b]):
                raise AssertionError(f"v4 {label}: row {b} ends in another state than the twin's")
            continue
        # the twin's logits at row t, from its own state and cache after t tokens
        state, aux, span_types, noise, self_kv, cross_kv, base, cross_len = args[2:]
        st, cache = state, self_kv
        if t > 0:
            st, _, rows = ds.fused_decode_tokens_reference(*args, **kw, **dict(skw, T_chunk=t))
            cache = splice(self_kv, rows, base)
        lg = twin_logits(packed, st, cache, cross_kv, base + t, cross_len, vpad)
        delta = ATOL + RTOL * lg[:, :V].abs().amax(dim=-1)
        close = decision_flips(lg, st, aux, span_types, noise, base + t, tables,
                               {k: v for k, v in skw.items() if k != "T_chunk"},
                               eps=2 * delta / skw["temperature"])
        if not bool(close[b]):
            raise AssertionError(f"v4 {label}: row {b} parts from the twin at chunk row {t} where "
                                 f"the twin's margin is decisive: {ktok[:, b].tolist()} vs "
                                 f"{rtok[:, b].tolist()}")
        parted += 1
    return parted, compared


def start_states(rng, B: int, dev, mask_index: int, n_spans_max: int = 4):
    """The state a decode starts from (the decoder's ``_v3_setup``): the
    mask token, no bits, step 1, span 0, not done, length 1; 1..n_spans_max
    spans a row, mostly bodies, and mixed no_whole flags."""
    n_spans = rng.integers(1, n_spans_max + 1, size=B)
    state = np.stack([np.full(B, mask_index), np.zeros(B), np.ones(B), np.zeros(B), np.zeros(B),
                      np.ones(B)]).astype(np.int32)
    aux = np.stack([n_spans, rng.random(B) < 0.5]).astype(np.int32)
    body = rng.random((B, MAX_SPANS)) < 0.7
    span_types = np.where(body, 0, rng.integers(1, 5, size=(B, MAX_SPANS))).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (state, aux, span_types))


def eager_decode(packed, tables, state0, aux, span_types, noise, cross_kv, cross_len, Lc, kw,
                 skw, mask_index, T=None):
    """A whole decode through the eager wrappers at the host's position,
    with the output and cache written by slices (the loops of
    ``infer/decode.py`` before the decode graph): v3 (``T`` None, the done flags read every
    ``SYNC_EVERY`` tokens) or v4 chunks of T.  Returns (state, out, cache,
    positions decoded)."""
    B = state0.shape[1]
    state = state0.clone()
    cache = torch.zeros(NL, B, Lc, 2 * D, dtype=torch.bfloat16, device=state.device)
    out = torch.zeros(B, Lc, dtype=torch.int32, device=state.device)
    out[:, 0] = mask_index
    pos, n = 0, 1 if T is None else T
    while pos + 1 < L:
        if T is None:
            if pos % decode_mod.SYNC_EVERY == 0 and bool(state[ds.ST_DONE].all()):
                break
            state, kv = ds.fused_decode_token(packed, tables, state, aux, span_types, noise, cache,
                                              cross_kv, pos, cross_len, **kw, **skw)
            out[:, pos + 1] = state[ds.ST_TOKEN]
            cache[:, :, pos] = kv
        else:
            if bool(state[ds.ST_DONE].all()):
                break
            state, tokens, kv = ds.fused_decode_tokens(packed, tables, state, aux, span_types, noise,
                                                       cache, cross_kv, pos, cross_len, **kw, **skw,
                                                       T_chunk=T)
            out[:, pos + 1 : pos + 1 + T] = tokens.T
            cache[:, :, pos : pos + T] = kv.transpose(1, 2)
        pos += n
    return state, out, cache, pos


def graph_decode(graphs, packed, tables, state0, aux, span_types, noise, cross_kv, cross_len, Lc,
                 kw, skw, mask_index, T=None):
    """The same decode as ``eager_decode`` the way ``InfillDecoder`` runs it
    on the card: ``open_graph`` on the decoder's ``graphs`` (a cached graph,
    or a new capture), one step (a graph replay) a token or a chunk, the
    position on the device."""
    pos, n = 0, 1 if T is None else T
    with dg.open_graph(graphs, packed, tables, state0, aux, span_types, noise, cross_kv, cross_len,
                       cache_rows=Lc, cache_dtype=torch.bfloat16, T_chunk=T, **kw, **skw) as graph:
        if not bool((graph.out[:, 0] == mask_index).all()):
            raise AssertionError("the graph's output does not start with the mask token")
        while pos + 1 < L:
            # the done flags: every SYNC_EVERY tokens (v3), every chunk (v4)
            if (T is not None or pos % decode_mod.SYNC_EVERY == 0) and bool(
                    graph.state[ds.ST_DONE].all()):
                break
            graph.step()
            pos += n
        return graph.state.clone(), graph.out.clone(), graph.cache.clone(), pos


def tickets_zero(graphs) -> bool:
    """The tickets every captured graph of ``graphs`` reads, all zero after
    every replay."""
    return not any(bool(gr._scratch[1].any()) for gr in graphs.graphs.values()
                   if gr._graph is not None)


def empty_splits_bit_equal(dev, flagships, g) -> int:
    """The self-attention as a graph runs it (the position read through
    ``attend_kernel``'s ``lens``, the splits sized from the cache's
    capacity, those past the position empty) against it as the v2 step
    runs it (the host's index as ``n_rows``, the splits sized from it), on
    the same inputs through ``_launch_layers``: logits, K|V rows and the
    activation bit-equal, at the served B and S; v3 over L cache rows at
    index 0, 1, 512 (half the splits empty) and 1000, v4 over L + CHUNK_SLOP
    rows at index 512 with 0 and 5 of a chunk's rows.  Returns the cases."""
    B, S, _ = SERVED_CASE
    lib = ds.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    cross_kv = torch.randn(NL, B, S, 2 * D, generator=g, device=dev).to(torch.bfloat16)
    cross_len = torch.tensor([S - (S // 16) * b for b in range(B)], dtype=torch.int32, device=dev)
    Lc4, T = L + decode_mod.CHUNK_SLOP, 8
    cases = 0
    for name, packed, vpad in flagships:
        kw = dict(n_layers=NL, D=D, H=H, F=F, vpad=vpad, stream=stream)
        for Lc, index, t in ((L, 0, None), (L, 1, None), (L, 512, None), (L, 1000, None),
                             (Lc4, 512, 0), (Lc4, 512, 5)):
            self_kv = torch.randn(NL, B, Lc, 2 * D, generator=g, device=dev).to(torch.bfloat16)
            x0 = torch.randn(B, D, generator=g, device=dev)
            chunk = None if t is None else (
                torch.randn(NL, T, B, 2 * D, generator=g, device=dev).to(torch.bfloat16), t)
            got = []
            for at in (index, torch.full((B,), index, dtype=torch.int32, device=dev)):
                x = x0.clone()
                logits = torch.empty(B, vpad, device=dev)
                new_kv = torch.empty(NL, B, 2 * D, dtype=torch.bfloat16, device=dev)
                ds._launch_layers(lib, packed, x, self_kv, cross_kv, at, cross_len, logits, new_kv,
                                  chunk=chunk, **kw)
                got.append((logits, new_kv, x))
            torch.cuda.synchronize()
            source, n_chunk = (ds._ROWS_CACHE_ONLY, 0) if t is None else (ds._ROWS_CHUNK, t)
            splits = [ds._attend_splits(index, lens, Lc, source, n_chunk, B)
                      for lens in (None, cross_len)]
            label = (f"{name} {'v3' if t is None else f'v4 chunk row {t}'} at index {index} "
                     f"over {Lc} cache rows ({splits[0]} self splits by the index, {splits[1]} by "
                     f"the capacity)")
            for what, a, b in zip(("logits", "K|V rows", "activation"), *got):
                if not torch.equal(a, b):
                    raise AssertionError(f"2i {label}: the {what} by position tensor are not "
                                         f"bit-equal to those by host index "
                                         f"(max |diff| {(a.float() - b.float()).abs().max().item():.3e})")
            say(f"  {label}: logits, K|V rows and activation bit-equal")
            cases += 1
    return cases


def small_kernel_bounds(B: int, V: int, nucleus: bool):
    """The bytes bounds (ms) of the three small parts of a token at B rows
    and what bounds each: the LN tail (as ``add_layernorm_kernel`` was)
    reads x and o (B, D) f32 and gamma and beta, writes (B, D) f32;
    ``embed_pe_kernel`` reads B
    tokens, B bf16 embedding rows and the position, writes (B, D) f32;
    ``sample_advance_kernel`` reads a row's V logits, V mask entries,
    (nucleus) V noise entries, its class row, span type, state, aux and
    position and sid_tbl, writes its state, token and position, and does
    V x V f32 multiply-adds a row for the nucleus rule (at 67 TFLOP/s, the
    f32 rate outside the tensor cores)."""
    ln = (3 * B + 2) * D * 4
    emb = B * (4 + 2 * D + 4 + 4 * D)
    smp = B * (V * 4 * (3 if nucleus else 2) + ds._N_CLASSES * 4 + 4 + 6 * 4 + 2 * 4 + 4
               + 6 * 4 + 4 + 4) + 16 * 4
    smp_ops = 2 * B * V * V if nucleus else 0
    out = {}
    for name, nbytes, ops in (("LN tail", ln, 0), ("embed_pe_kernel", emb, 0),
                              ("sample_advance_kernel", smp, smp_ops)):
        t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / F32_FLOPS
        out[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", nbytes)
    return out


def phase_graph_vs_eager(dev, flagships, int8_flagship):
    """Phase 2i: whole decodes replayed as CUDA graphs (``DecodeGraph``, the
    decoder's v3 and v4 path) against the same decodes through the eager
    wrappers, bit-equal in tokens, final state and every cache row: v3 at B
    in {1, 3, 8}, S in {512, 1536}, greedy and nucleus, SMER and REMI; int8
    at B=3; v4 at T_chunk 8 and 64.  The capture stream's tickets are zero
    after every decode.  Then times at the served shape: a v3 token eager
    against replayed (CUDA events, the profiler's device time and busy
    share), the int8 token, a v4 chunk of 8 and the captures' ms; and the
    three small kernels' device time a launch beside their bounds.
    Returns {"v3": ..., "v4": ..., "int8": ...} reports and the captures'
    ms."""
    rng = np.random.default_rng(31)
    g = torch.Generator(device=dev).manual_seed(32)
    cases, tokens_decoded = 0, 0
    Lc4 = L + decode_mod.CHUNK_SLOP

    tables_of = {}  # one set a vocabulary, as a decoder keeps it
    graphs_of = {}  # one GraphCache a vocabulary and weight type, as a decoder keeps it

    def check(label, packed, vocab, vpad, B, S, greedy, T=None):
        nonlocal cases, tokens_decoded
        if vocab.mode not in tables_of:
            tables_of[vocab.mode] = sampling_tables(vocab, vpad, dev)
        tables = tables_of[vocab.mode]
        graphs = graphs_of.setdefault((vocab.mode, "scale" in packed), dg.GraphCache())
        kw = dict(n_layers=NL, d_model=D, nhead=H, d_ff=F, vpad=vpad)
        skw = sampler_kw(vocab, greedy, None if greedy else 0.9, 1.0)
        Lc = L if T is None else Lc4
        cross_kv = torch.randn(NL, B, S, 2 * D, generator=g, device=dev).to(torch.bfloat16)
        cross_len = torch.tensor([S - (S // 16) * b for b in range(B)], dtype=torch.int32,
                                 device=dev)
        noise = None if greedy else gumbel_noise((Lc, B, vpad), g, dev)
        state0, aux, span_types = start_states(rng, B, dev, vocab.mask_index)
        args = (packed, tables, state0, aux, span_types, noise, cross_kv, cross_len, Lc, kw, skw,
                vocab.mask_index)
        es, eo, ec, epos = eager_decode(*args, T=T)
        gs, go, gc, gpos = graph_decode(graphs, *args, T=T)
        torch.cuda.synchronize()
        same = (epos == gpos and torch.equal(es, gs) and torch.equal(eo, go)
                and torch.equal(ec, gc))
        if not same:
            raise AssertionError(
                f"2i {label}: the graph replay is not bit-equal to the eager wrappers "
                f"(positions {gpos} vs {epos}; state {torch.equal(es, gs)}, tokens "
                f"{torch.equal(eo, go)}, cache {torch.equal(ec, gc)})")
        if not tickets_zero(graphs):
            raise AssertionError(f"2i {label}: a replay left a ticket of a captured graph set")
        cases += 1
        tokens_decoded += gpos
        say(f"  {label}: {gpos} positions, tokens, state and all {Lc} cache rows bit-equal")

    for vocab, packed, vpad in flagships:
        for B in (1, 3, 8):
            for S in (512, 1536):
                for greedy in (True, False):
                    label = (f"v3 vocab_mode {vocab.mode} B={B} S={S} "
                             f"{'greedy' if greedy else 'nucleus p0.9'}")
                    check(label, packed, vocab, vpad, B, S, greedy)
                    if B == 3:  # the next decode of the key reuses the captured graph
                        before = dg.DecodeGraph.captures
                        check(label + ", again", packed, vocab, vpad, B, S, greedy)
                        if dg.DecodeGraph.captures != before:
                            raise AssertionError(f"2i {label}: the second decode captured anew")
    vocab, packed, vpad = flagships[0]
    int8_packed = int8_flagship
    for greedy in (True, False):
        check(f"v3 int8 B=3 S=1536 {'greedy' if greedy else 'nucleus p0.9'}", int8_packed, vocab,
              vpad, 3, 1536, greedy)
    for T in (8, 64):
        check(f"v4 T_chunk {T} B=3 S=1536 nucleus p0.9", packed, vocab, vpad, 3, 1536, False, T=T)
    say(f"  {cases} whole decodes ({tokens_decoded} positions): the graph replay bit-equal to the "
        f"eager wrappers in every one; the captured graphs' tickets zero after each")
    n = empty_splits_bit_equal(dev, [("bf16", flagships[0][1], flagships[0][2]),
                                     ("int8", int8_flagship, flagships[0][2])], g)
    say(f"  {n} layer plans: the self-attention's empty splits change no bit")

    # times at the served shape: B=3, S=1536, from index 512
    B, S, index = SERVED_CASE
    V = vocab.vocab_size
    tables = sampling_tables(vocab, vpad, dev)
    kw = dict(n_layers=NL, d_model=D, nhead=H, d_ff=F, vpad=vpad)
    cl_list = [S - (S // 16) * b for b in range(B)]
    cross_len = torch.tensor(cl_list, dtype=torch.int32, device=dev)
    cross_kv = torch.randn(NL, B, S, 2 * D, generator=g, device=dev).to(torch.bfloat16)
    reports = {}
    dg.reset_counts()
    for name, pk, T in (("v3", packed, None), ("int8", int8_packed, None), ("v4", packed, 8)):
        skw = sampler_kw(vocab, False, 0.9, 1.0)
        Lc = L if T is None else Lc4  # the decoder's cache rows
        graphs = dg.GraphCache()  # each timed graph is captured anew
        cache = torch.randn(NL, B, Lc, 2 * D, generator=g, device=dev).to(torch.bfloat16)
        noise = gumbel_noise((Lc, B, vpad), g, dev)
        state, aux, span_types = random_states(rng, B, V, dev)
        state[ds.ST_DONE] = 0  # every row live
        args = (pk, tables, state.clone(), aux, span_types, noise, cache, cross_kv, index, cross_len)
        if T is None:
            eager = lambda: ds.fused_decode_token(*args, **kw, **skw)  # noqa: E731
        else:
            eager = lambda: ds.fused_decode_tokens(*args, **kw, **skw, T_chunk=T)  # noqa: E731
        eager_ms = cuda_ms(eager, iters=40 if T is None else 10)
        eager_split, _, _ = profiled(eager, iters=10)
        # the replays advance the position: 3 + 100 + 11 tokens from 512 (v3)
        # or 3 + 20 + 3 chunks of 8 (v4), inside the cache
        opened = dict(cache_rows=Lc, cache_dtype=torch.bfloat16, T_chunk=T, start=index)
        with dg.open_graph(graphs, pk, tables, state, aux, span_types, noise, cross_kv, cross_len,
                           **opened, **kw, **skw) as graph:
            t0 = time.perf_counter()
            graph.step()  # the warm-up, the capture and the first replay
            torch.cuda.synchronize()
            first_ms = 1e3 * (time.perf_counter() - t0)
            ms = cuda_ms(graph.step, iters=100 if T is None else 20)
            split, host, kernels = profiled(graph.step, iters=10 if T is None else 2, top=200)
            end = graph.host_pos
        # the next decode of the same key: the inputs loaded, no capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with dg.open_graph(graphs, pk, tables, state, aux, span_types, noise, cross_kv, cross_len,
                           **opened, **kw, **skw) as graph:
            graph.step()
            torch.cuda.synchronize()
        hit_ms = 1e3 * (time.perf_counter() - t0)
        if (graphs.misses, graphs.hits) != (1, 1):
            raise AssertionError(f"2i {name}: the second decode of a key did not find its graph")
        bound = (token_bound_ms(pk, B, index, cl_list, V, nucleus=True) if T is None
                 else tokens_bound_ms(pk, B, index, cl_list, V, True, T))
        plain_ms = cuda_ms(lambda: (ds.fused_decode_token_reference(*args, **kw, **skw) if T is None
                                    else ds.fused_decode_tokens_reference(*args, **kw, **skw,
                                                                          T_chunk=T)),
                           iters=3, warmup=1)
        cap = dg.DecodeGraph.capture_ms[-1]
        reports[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, eager_ms=eager_ms,
                             capture_ms=cap, hit_ms=hit_ms, split=split, eager_split=eager_split)
        what = "token" if T is None else f"chunk of {T}"
        say(f"  {name} {what} at B={B} S={S} from index {index} (positions up to {end}): eager "
            f"{eager_ms:.4f} ms, graph replay {ms:.4f} ms ({eager_ms / ms:.2f}x), twin "
            f"{plain_ms:.4f} ms, bound {bound:.5f} ms; warm-up + capture + first replay "
            f"{first_ms:.2f} ms, of which the capture {cap:.2f} ms; a cached graph's load + "
            f"first replay {hit_ms:.2f} ms")
        say("    eager:")
        say_split(eager_split, eager_ms)
        say("    graph replay:")
        say_split(split, ms)
        say("    host ops of the replays: " +
            ", ".join(f"{k} {us:.0f} us x{c}" for k, us, c in host[:6]))
        if name == "v3" and split is not None:
            # every replay runs every node of the graph, and the profiler may
            # lose a record but never adds one: a family's launches a replay
            # are the records a replay rounded up
            seen = {}
            for key, _, c in kernels:
                family = next((f for f in FAMILIES if f in key), None)
                if family is not None:
                    seen[family] = seen.get(family, 0.0) + c
            ours = {k: math.ceil(v - 1e-9) for k, v in seen.items()}
            say(f"    port kernels a replayed token: {sum(ours.values())} "
                f"({', '.join(f'{k} {v} ({seen[k]:.2f} records a replay)' for k, v in sorted(ours.items()))})")
            if sum(ours.values()) != 35 or "add_layernorm_kernel" in ours:
                raise AssertionError(f"2i: a replayed v3 token ran {ours}, not 35 port kernels "
                                     f"with no add_layernorm_kernel")
            # the tail a fused launch at this B: the three projections that
            # carry it, with it less without it
            lib, stream = ds.load_library(), torch.cuda.current_stream(dev).cuda_stream
            tails = [ln_tail_time(dev, lib, stream, pk, vpad, V, case, B, g, check=False)["tail_us"]
                     for case in LN_TAILS if not case[2]]
            tail_us = None if None in tails else sum(tails) / len(tails)
            bounds = small_kernel_bounds(B, V, nucleus=True)
            for k, n, t in (("LN tail", 13, tail_us),
                            ("embed_pe_kernel", 1, split.get("embed_pe_kernel", 0.0)),
                            ("sample_advance_kernel", 1, split.get("sample_advance_kernel", 0.0))):
                b_ms, by, nbytes = bounds[k]
                say(f"    {k}: {us(t)} of device time a launch, {n} a token, bound "
                    f"{1e3 * b_ms:.4f} us ({by}, {nbytes} bytes)")
    say(f"  captures {dg.DecodeGraph.captures}, ms each {[round(c, 2) for c in dg.DecodeGraph.capture_ms]}")
    return reports


def phase_int8(dev, flagship, vocab, vpad):
    """int8 weights: the row-vector kernel alone against its twin at the six
    matrix shapes of a layer, then v2, v3 and v4 with int8 against their
    twins (the phase-2 tolerance and margin rule).  Returns the rowvec
    error, its report at the served B=3 and the v3-int8 report."""
    packed = ds.pack_decoder_weights(flagship, vpad, quant="int8")
    g = torch.Generator(device=dev).manual_seed(6)

    def calls(B, fn):
        out = []
        for i in range(NL):
            sc, b = packed["scale"][i, 0], packed["bias"][i, 0]
            for _, name, ld, lo, K, N, relu in LAYER_MATRICES:
                w = packed[name][i]
                q = w[:, lo : lo + N] if name == "w_attn" else w
                x = torch.randn(B, K, generator=g, device=dev)
                out.append((fn, x, q, sc[lo : lo + N], b[lo : lo + N], relu))
        return out

    worst, report = 0.0, None
    for B in (1, 3, 8):
        for fn, x, q, sc, b, relu in calls(B, ds.rowvec_int8):
            y = fn(x, q, sc, b, relu=relu)
            torch.cuda.synchronize()
            r = ds.rowvec_int8_reference(x, q, sc, b, relu=relu)
            if not torch.allclose(y, r, atol=ATOL, rtol=RTOL):
                raise AssertionError(f"rowvec_int8 disagrees with its twin at B={B} "
                                     f"K={q.shape[0]} N={q.shape[1]}")
            worst = max(worst, (y - r).abs().max().item())
        if B == SERVED_CASE[0]:
            batch = calls(B, None)

            def run(f):
                for _, x, q, sc, b, relu in batch:
                    f(x, q, sc, b, relu=relu)

            ms = cuda_ms(lambda: run(ds.rowvec_int8), iters=20)
            plain_ms = cuda_ms(lambda: run(ds.rowvec_int8_reference), iters=5)
            nbytes = sum(q.numel() + 4 * (2 * q.shape[1]) + 4 * B * (q.shape[0] + q.shape[1])
                         for _, x, q, *_ in batch)
            flops = sum(2 * B * q.numel() for _, x, q, *_ in batch)
            report = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms(nbytes, flops))
            say(f"  rowvec_int8, the 24 int8 matrices of a token at B={B}: kernel {ms:.4f} ms, "
                f"twin {plain_ms:.4f} ms, bound {report['bound_ms']:.4f} ms ({nbytes / 1e6:.2f} MB)")
    say(f"  rowvec_int8 within atol {ATOL} + rtol {RTOL} of its twin at B 1, 3, 8 "
        f"(max {worst:.3e})")
    say("  v2 with int8 weights against its twin")
    worst2, _ = phase_kernel_vs_twin(dev, packed, vocab, vpad, Bs=(1, 3, 8), Ss=(512, 1536),
                                     indices=(0, 512, 1023))
    say("  v3 with int8 weights against its twin")
    worst3, report3 = phase_token_vs_twin(dev, packed, vocab, vpad, Bs=(1, 3, 8), Ss=(1536,),
                                          indices=(0, 512))
    say("  v4 with int8 weights against its twin and against v3 x T_chunk")
    worst4, _ = phase_tokens_vs_twin(dev, [(vocab, packed, vpad)])
    say(f"  int8: v2 max|kernel-twin| {worst2:.3e}, v3 new_kv {worst3:.3e}, v4 new_kv {worst4:.3e}")
    return max(worst, worst2, worst3, worst4), report, report3


def verify_bytes_flops(packed, W: int, index: int, cross_len: int, vpad: int):
    """Bytes and bf16 operations of one verify call: every packed decoder
    weight once (not the embedding), the ``index`` cache rows and the
    ``cross_len`` cross rows once, the W input rows, the (W, vpad) logits
    and the new K|V rows; the W rows' matrix products and attention (row j
    over index + j + 1 self rows and the cross rows)."""
    weight_bytes = sum(t.numel() * t.element_size() for k, t in packed.items() if k != "emb")
    cache_bytes = NL * (index + cross_len) * 2 * D * 2
    io_bytes = W * D * 2 + W * vpad * 4 + NL * W * 2 * D * 2 + 4
    rows = W * index + W * (W + 1) // 2 + W * cross_len
    flops = 2 * W * NL * (6 * D * D + 2 * D * F) + 2 * W * D * vpad + 4 * D * NL * rows
    return weight_bytes + cache_bytes + io_bytes, flops


def phase_verify_vs_twin(dev, flagships):
    """``fused_verify_window`` against its twin, and each of its rows
    against the v2 kernel's step over the spliced cache."""
    LV = 1600  # the self cache: index + W <= 1554
    g = torch.Generator(device=dev).manual_seed(8)
    worst, report, cases, equal, step_diff = 0.0, None, 0, 0, 0.0
    for vocab, packed, vpad in flagships:
        kw = dict(n_layers=NL, d_model=D, nhead=H, d_ff=F, vpad=vpad)
        V = vocab.vocab_size
        for S in (512, 1536):
            self_kv = torch.randn(NL, 1, LV, 2 * D, generator=g, device=dev).to(torch.bfloat16)
            cross_kv = torch.randn(NL, 1, S, 2 * D, generator=g, device=dev).to(torch.bfloat16)
            cl = S - S // 16
            cross_len = torch.tensor([cl], dtype=torch.int32, device=dev)
            for W in VERIFY_WIDTHS:
                x = torch.randn(W, D, generator=g, device=dev).to(torch.bfloat16)
                for index in (0, 512, 1530):
                    args = (packed, x, self_kv, cross_kv, index, cross_len)
                    lg, kv = ds.fused_verify_window(*args, **kw)
                    torch.cuda.synchronize()
                    lr, kr = ds.fused_verify_window_reference(*args, **kw)
                    ok = (torch.allclose(lg[:, :V], lr[:, :V], atol=ATOL, rtol=RTOL)
                          and torch.allclose(kv.float(), kr.float(), atol=ATOL, rtol=RTOL)
                          and torch.isfinite(lg[:, :V]).all().item())
                    err = max((lg[:, :V] - lr[:, :V]).abs().max().item(),
                              (kv.float() - kr.float()).abs().max().item())
                    if not ok:
                        raise AssertionError(f"verify disagrees with its twin at {vocab.mode=} S={S} "
                                             f"W={W} index={index}: max |kernel - twin| {err:.3e}")
                    worst = max(worst, err)
                    # row j against the v2 kernel's step at index + j
                    cache = self_kv.clone()
                    same = True
                    for j in range(W):
                        sl, skv = ds.fused_decode_step(packed, x[j : j + 1], cache, cross_kv,
                                                       index + j, cross_len, **kw)
                        cache[:, :, index + j] = skv
                        same &= torch.equal(sl[0], lg[j]) and torch.equal(skv[:, 0], kv[:, j])
                        step_diff = max(step_diff, (sl[0, :V] - lg[j, :V]).abs().max().item(),
                                        (skv[:, 0].float() - kv[:, j].float()).abs().max().item())
                    equal += int(same)
                    cases += 1
                    if (vocab.mode, S, W, index) == (0, 1536, 9, 512):
                        ms = cuda_ms(lambda: ds.fused_verify_window(*args, **kw), iters=20)
                        plain_ms = cuda_ms(lambda: ds.fused_verify_window_reference(*args, **kw),
                                           iters=3, warmup=1)
                        step_ms = cuda_ms(lambda: ds.fused_decode_step(
                            packed, x[:1], self_kv, cross_kv, index, cross_len, **kw), iters=20)
                        nbytes, flops = verify_bytes_flops(packed, W, index, cl, vpad)
                        bound = bound_ms(nbytes, flops)
                        report = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound)
                        say(f"  W={W} index={index} S={S} cross_len={cl}: kernel {ms:.4f} ms "
                            f"({ms / W:.4f} ms a row), twin {plain_ms:.4f} ms, bound {bound:.5f} ms "
                            f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); one v2 step at B=1 "
                            f"{step_ms:.4f} ms")
                        say_split(device_split(lambda: ds.fused_verify_window(*args, **kw)), ms)
            say(f"  vocab_mode {vocab.mode} S={S}: {cases} cases so far, max|kernel-twin| {worst:.3e}, "
                f"{equal} bit-equal to the v2 steps")
    say(f"  {cases} cases within atol {ATOL} + rtol {RTOL} of the twin (max {worst:.3e}); "
        f"{equal} of {cases} bit-equal to W sequential v2 kernel steps over the spliced cache "
        f"(largest difference {step_diff:.3e})")
    return worst, report


def rowvec_cases(packed, vpad, V):
    """(label, w view, row stride, bias, column scales or None, K, N, relu,
    real columns) of a token's seven projection shapes, from layer 0 (the
    logits from fc_w, whose pad lanes past V carry no weight and a -1e9
    bias)."""
    quant = "scale" in packed
    out = []
    for label, key, ld, lo, K, N, relu in LAYER_MATRICES:
        w = packed[key][0]
        w = w[:, lo : lo + N] if key == "w_attn" else w
        sc = packed["scale"][0, 0, lo : lo + N] if quant else None
        out.append((label, w, ld, packed["bias"][0, 0, lo : lo + N], sc, K, N, relu, N))
    out.append(("logits", packed["fc_w"], vpad, packed["fc_b"], None, D, vpad, False, V))
    return out


def device_us(fn, family=None):
    """µs a call of ``fn`` on the device (the profiler) in kernels of
    ``family``, or in all its kernels (a library call's) where family is
    None; None where the profiler sees no CUDA kernel."""
    split = device_split(fn, iters=20)
    if split is None:
        return None
    return sum(split.values()) if family is None else split.get(family, 0.0)


def us(t) -> str:
    return "not measured" if t is None else f"{t:.2f} us"


def rel_err(got, want) -> float:
    return ((got - want).norm() / want.norm()).item()


def hold_to_twin(label, got, want, control) -> float:
    """``got`` within REL_2H relative norm of the twin's ``want``, and the
    twin's ``control`` (the same call with its last split left out) outside
    it, so that the bound can see a lost split.  Returns the error."""
    err, ctl = rel_err(got, want), rel_err(control, want)
    if err > REL_2H:
        raise AssertionError(f"{label} disagrees with its twin: |kernel - twin| / |twin| "
                             f"{err:.3e} > {REL_2H}")
    if ctl <= REL_2H:
        raise AssertionError(f"{label}: the twin without its last split is within {REL_2H} "
                             f"({ctl:.3e}): the bound cannot see a lost split")
    return err


def rowvec_time(dev, lib, stream, case, B, g, check=True):
    """One projection through ``_launch_rowvec`` at B rows: held against
    the twin (``_rowvec_math``; the control leaves out the last K-slice of
    ``rowvec_k_split``), then its ms a launch (CUDA events over back-to-back
    launches; where the host's launch rate is the slower, that rate), its
    device µs (the profiler), its bytes bound (W, x, y, bias and scales each
    moved once) and, as the yardstick, ``torch.mm`` of the bf16-rounded x
    against the same W (for int8, a bf16 copy of the same values; for the
    f32 logits, x and W in f32), in CUDA-event ms and device µs."""
    label, w, ld, bias, sc, K, N, relu, cols = case
    x = torch.randn(B, K, generator=g, device=dev)
    y = torch.empty(B, N, device=dev)
    ws, tickets = ds._scratch(dev, stream, *ds._rowvec_need(K, N, B))
    scratch = (ws.data_ptr(), tickets.data_ptr())

    def kernel():
        ds._launch_rowvec(lib, x, w, ld, bias, y, stream=stream, scratch=scratch, relu=relu,
                          colscale=sc)

    kernel()
    torch.cuda.synchronize()
    err = None
    if check:
        cdt = torch.float32 if w.dtype == torch.float32 else torch.bfloat16

        def twin(xs):  # over the real columns
            out = ds._rowvec_math(xs, w, cdt, sc) + bias
            return (torch.relu(out) if relu else out)[:, :cols]

        last = (K - 1) // ds.rowvec_k_split(K, N) * ds.rowvec_k_split(K, N)
        x_ctl = x.clone()
        x_ctl[:, last:] = 0
        err = hold_to_twin(f"rowvec_kernel {label} B={B} {w.dtype}", y[:, :cols], twin(x),
                           twin(x_ctl))
    ms = cuda_ms(kernel, iters=100, warmup=10)
    dev_us = device_us(kernel, "rowvec_kernel") if check else None
    nbytes = K * N * w.element_size() + 4 * (B * K + B * N + N) + (4 * N if sc is not None else 0)
    bound = bound_ms(nbytes, 2 * B * K * N)
    if w.dtype == torch.float32:
        xl, wl = x, w
    else:
        xl, wl = x.to(torch.bfloat16), w.to(torch.bfloat16) if w.dtype == torch.int8 else w

    def library():
        torch.mm(xl, wl)

    lib_ms = cuda_ms(library, iters=100, warmup=10)
    lib_us = device_us(library) if check else None
    return dict(ms=ms, dev_us=dev_us, bound=bound, lib_ms=lib_ms, lib_us=lib_us, err=err)


def ln_tail_time(dev, lib, stream, packed, vpad, V, case, B, g, check=True):
    """One projection with its LN tail (``case`` of LN_TAILS) at B rows:
    with ``check``, bit-equal in its output and its LayerNorm to the unfused
    pair, the same launch without the tail and then ``add_layernorm_kernel``
    (again with no y for the final LN); then the launch with and without
    the tail and ``add_layernorm_kernel`` alone timed (CUDA-event µs, and
    device µs: with ``check=False``, device µs only).  Returns their µs
    and the tail's device µs (with less without)."""
    label, ln_row, chained = case
    proj = next(c for c in rowvec_cases(packed, vpad, V) if c[0] == label)
    _, w, ld, bias, sc, K, N, _, _ = proj
    gamma, beta = packed["ln"][0, ln_row], packed["ln"][0, ln_row + 1]
    fin = (packed["fin_ln"][0], packed["fin_ln"][1]) if chained else None
    x = torch.randn(B, K, generator=g, device=dev)
    res0 = 2.0 * torch.randn(B, N, generator=g, device=dev)
    res, y = res0.clone(), torch.empty(B, N, device=dev)
    ws, tickets = ds._scratch(dev, stream, *ds._rowvec_need(K, N, B))
    kw = dict(stream=stream, scratch=(ws.data_ptr(), tickets.data_ptr()), colscale=sc)

    def fused():
        ds._launch_rowvec(lib, x, w, ld, bias, y, ln=(res, gamma, beta, fin), **kw)

    def plain():
        ds._launch_rowvec(lib, x, w, ld, bias, y, **kw)

    def add_layernorm(y_ptr, gb):
        ds._check(lib.smer_add_layernorm(B, N, res.data_ptr(), y_ptr, gb[0].data_ptr(),
                                         gb[1].data_ptr(), res.data_ptr(), ds.LN_EPS, stream),
                  "add_layernorm")

    def unfused_ln():
        add_layernorm(y.data_ptr(), (gamma, beta))
        if fin is not None:
            add_layernorm(None, fin)

    what = f"{label}{' + final LN' if chained else ''} K={K} N={N} B={B} {w.dtype}"
    if check:
        fused()
        torch.cuda.synchronize()
        got_y, got = y.clone(), res.clone()
        y.zero_()
        res.copy_(res0)
        plain()
        unfused_ln()
        torch.cuda.synchronize()
        for part, a, b in (("output", got_y, y), ("LayerNorm", got, res)):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"2h LN tail {what}: the {part} is not bit-equal to the unfused pair (max "
                    f"|diff| {(a - b).abs().max().item():.3e})")
    t = dict(fused_us=device_us(fused, "rowvec_kernel"), plain_us=device_us(plain, "rowvec_kernel"),
             ln_us=device_us(unfused_ln, "add_layernorm_kernel"))
    if check:
        t.update(fused_ms=cuda_ms(fused, iters=100, warmup=10),
                 plain_ms=cuda_ms(plain, iters=100, warmup=10),
                 ln_ms=cuda_ms(unfused_ln, iters=100, warmup=10))
    t["tail_us"] = (None if t["fused_us"] is None or t["plain_us"] is None
                    else t["fused_us"] - t["plain_us"])
    t["what"] = what
    return t


def add_up(total, one, n):
    """Adds n times each number of ``one`` into ``total``; a number not
    measured (None) leaves its sum not measured."""
    for k, v in one.items():
        if k != "err":
            total[k] = None if v is None or total.get(k, 0.0) is None else total.get(k, 0.0) + n * v


def phase_decode_kernels(dev, packed, model, vpad):
    """Phase 2h: ``rowvec_kernel`` and ``attend_kernel`` alone at the
    shapes of the served token, each held against its twin within REL_2H
    relative norm (and a control with one split left out shown outside it)
    and timed beside its bytes bound and its library yardstick
    (``torch.mm``; SDPA over strided K and V views of the same cache with a
    boolean length mask) in CUDA-event ms and device µs, the per-token
    sums, and rowvec's ms a launch at every row count 1..16 (a launch must
    not jump from one row count to the next); then the LN tail
    (``ln_tail_time``) of each projection of LN_TAILS at B = 1, 3, 8, 9, 16
    (bf16) and 3 (int8)."""
    lib = ds.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(12)
    int8 = ds.pack_decoder_weights(model, vpad, quant="int8")
    V = model.fc.bias.shape[0]
    worst = 0.0
    for wname, pk, rows in (("bf16", packed, (1, 3, 8, SPEC_K + 1)), ("int8", int8, (3,))):
        for B in rows:
            token = {}
            for case in rowvec_cases(pk, vpad, V):
                t = rowvec_time(dev, lib, stream, case, B, g)
                worst = max(worst, t["err"])
                add_up(token, t, 1 if case[0] == "logits" else NL)
                say(f"  rowvec {wname} {case[0]:9s} K={case[5]:4d} N={case[6]:4d} B={B:2d}: kernel "
                    f"{1e3 * t['ms']:7.2f} us (device {us(t['dev_us'])}), bound "
                    f"{1e3 * t['bound']:6.2f} us, torch.mm {1e3 * t['lib_ms']:7.2f} us (device "
                    f"{us(t['lib_us'])}); |kernel-twin|/|twin| {t['err']:.2e}")
            say(f"  rowvec {wname} B={B}: a token's 25 launches {1e3 * token['ms']:.1f} us (device "
                f"{us(token['dev_us'])}), bound {1e3 * token['bound']:.1f} us, torch.mm "
                f"{1e3 * token['lib_ms']:.1f} us (device {us(token['lib_us'])})")
    for label in ("QKV", "FFN down"):
        case = next(c for c in rowvec_cases(packed, vpad, V) if c[0] == label)
        times = [rowvec_time(dev, lib, stream, case, B, g, check=False)["ms"]
                 for B in range(1, 17)]
        say(f"  rowvec bf16 {label} us a launch at rows 1..16: " +
            " ".join(f"{1e3 * t:.2f}" for t in times))

    # the LN tail of the three projections that feed a post-LN: bit-equal
    # to the unfused pair, and its cost
    cases = 0
    for wname, pk, rows in (("bf16", packed, (1, 3, 8, SPEC_K + 1, 16)), ("int8", int8, (3,))):
        for B in rows:
            for case in LN_TAILS:
                t = ln_tail_time(dev, lib, stream, pk, vpad, V, case, B, g)
                cases += 1
                say(f"  LN tail {wname} {t['what']}: with the tail {1e3 * t['fused_ms']:.2f} us "
                    f"(device {us(t['fused_us'])}), without {1e3 * t['plain_ms']:.2f} us (device "
                    f"{us(t['plain_us'])}), add_layernorm_kernel x{1 + case[2]} alone {1e3 * t['ln_ms']:.2f} us "
                    f"(device {us(t['ln_us'])}); the tail {us(t['tail_us'])} of device time")
    say(f"  {cases} launches with the LN tail bit-equal to the unfused pair (the launch without "
        f"it, then add_layernorm_kernel) in output and LayerNorm")

    # attend_kernel at the served case: self over index 512 plus the current
    # row, cross over 1536/1440/1344 rows
    B, S, index = SERVED_CASE
    HD = D // H
    qkv = torch.randn(B, 3 * D, generator=g, device=dev)
    self_kv = torch.randn(B, L, 2 * D, generator=g, device=dev).to(torch.bfloat16)
    cross_kv = torch.randn(B, S, 2 * D, generator=g, device=dev).to(torch.bfloat16)
    cl = [S - (S // 16) * b for b in range(B)]
    cross_len = torch.tensor(cl, dtype=torch.int32, device=dev)
    out = torch.empty(B, D, device=dev)
    extra = qkv.data_ptr() + D * qkv.element_size()
    ws, tickets = ds._scratch(dev, stream, B * H * (-(-S // 64)) * (2 + HD), B * H)
    kw = dict(H=H, stream=stream, scratch=(ws.data_ptr(), tickets.data_ptr()))
    q, extra_kv = qkv[:, :D], (qkv[:, D : 2 * D], qkv[:, 2 * D :])

    def last_split(n):  # rows of a batch row's last 64-row split
        return (n - 1) % ds._ATTEND_SPLIT_ROWS + 1

    cases = {  # (kernel, twin over the first n rows of each batch row, cache, rows)
        "self": (lambda: ds._launch_attend(lib, qkv, self_kv, L * 2 * D, index, None, L,
                                           ds._ROWS_CACHE_ONLY, None, 0, 0, extra, out, **kw),
                 lambda n: ds._attend(q, self_kv, n, H, extra_kv=extra_kv), self_kv, [index] * B),
        "cross": (lambda: ds._launch_attend(lib, qkv, cross_kv, S * 2 * D, 0, cross_len, S,
                                            ds._ROWS_CACHE_ONLY, None, 0, 0, None, out, **kw),
                  lambda n: ds._attend(q, cross_kv, n, H), cross_kv, cl),
    }
    token = {}
    for name, (kernel, twin, kv, lens) in cases.items():
        kernel()
        torch.cuda.synchronize()
        n = torch.tensor(lens, device=dev)
        err = hold_to_twin(f"attend_kernel ({name})", out, twin(n),
                           twin(n - torch.tensor([last_split(m) for m in lens], device=dev)))
        worst = max(worst, err)
        ms = cuda_ms(kernel, iters=100, warmup=10)
        dev_us = device_us(kernel, "attend_kernel")
        rows = sum(lens)
        nbytes = rows * 2 * D * 2 + 4 * B * D * 2 + (8 * B * D if name == "self" else 0)
        bound = bound_ms(nbytes, 4 * D * rows)
        # the yardstick: SDPA of a (B, H, 1, 64) query over the cache's K and
        # V as strided (B, H, L, 64) views, masked to each row's length (the
        # current row of the self case is not in it)
        Lk = kv.shape[1]
        kview = kv[..., :D].view(B, Lk, H, HD).transpose(1, 2)
        vview = kv[..., D:].view(B, Lk, H, HD).transpose(1, 2)
        qb = q.to(torch.bfloat16).view(B, H, 1, HD)
        mask = (torch.arange(Lk, device=dev)[None, :] < n[:, None])[:, None, None, :]

        def library():
            torch.nn.functional.scaled_dot_product_attention(qb, kview, vview, attn_mask=mask)

        lib_ms = cuda_ms(library, iters=100, warmup=10)
        lib_us = device_us(library)
        add_up(token, dict(ms=ms, dev_us=dev_us, bound=bound, lib_ms=lib_ms, lib_us=lib_us), NL)
        say(f"  attend {name:5s} B={B} rows {lens}: kernel {1e3 * ms:7.2f} us (device "
            f"{us(dev_us)}), bound {1e3 * bound:6.2f} us, SDPA {1e3 * lib_ms:7.2f} us (device "
            f"{us(lib_us)}); |kernel-twin|/|twin| {err:.2e}")
    say(f"  attend B={B}: a token's 8 launches {1e3 * token['ms']:.1f} us (device "
        f"{us(token['dev_us'])}), bound {1e3 * token['bound']:.1f} us, SDPA "
        f"{1e3 * token['lib_ms']:.1f} us (device {us(token['lib_us'])})")
    say(f"  both kernels within {REL_2H} relative norm of their twins (worst {worst:.2e}); the "
        f"twins without their last split outside it")


def attention_bound(B: int, T: int, S: int, lens, causal: bool):
    """Least time of one flash-attention call and what bounds it: q, k, v
    read and the output written once (bf16); 4 HD operations for every
    (query, valid key) pair this call's lengths and mask leave, at the bf16
    tensor-core rate.  Returns (ms, "bytes" or "operations")."""
    nbytes = (2 * B * T + 2 * B * S) * H * HD_ATTN * 2
    pairs = 0
    for n in lens:
        n = min(int(n), S)
        if causal:
            t = np.arange(T)
            pairs += int(np.minimum(t + 1, n).sum())
        else:
            pairs += T * n
    flops = 4 * HD_ATTN * H * pairs
    return bound_ms(nbytes, flops), ("bytes" if nbytes / HBM_BYTES_PER_S > flops / BF16_FLOPS
                                     else "operations")


def sass_mix(lib_path: str, names=TENSOR_CORE_KERNELS):
    """The SASS of each kernel in the built library whose (mangled) name
    holds one of ``names``, by ``cuobjdump -sass`` (beside nvcc): {name:
    {opcode: static count}}, the opcode without its modifiers (HMMA, MUFU,
    IMAD, LOP3, ...).  A name matches the first kernel that holds it."""
    cuobjdump = Path(ds._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", lib_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    got, current, seen = {k: {} for k in names}, None, set()
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((k for k in names if k in line and k not in seen), None)
            seen.add(current)
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if current is not None and op:
            got[current][op.group(1)] = got[current].get(op.group(1), 0) + 1
    return got


def ptxas_facts(log: str, names=TENSOR_CORE_KERNELS):
    """Registers, spill bytes and static shared memory of each kernel whose
    (mangled) name holds one of ``names``, from the ``-Xptxas -v`` log of
    the build (the first entry that holds the name)."""
    facts, current = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            current = next((k for k in names if k in entry.group(1) and k not in facts), None)
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            facts.setdefault(current, {}).update(spill_stores=int(spill.group(1)),
                                                 spill_loads=int(spill.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            smem = re.search(r"(\d+) bytes smem", line)
            facts.setdefault(current, {}).update(registers=int(regs.group(1)),
                                                 smem_bytes=int(smem.group(1)) if smem else 0)
    return facts


def phase_tensor_cores() -> None:
    """The attention kernels redesigned for the tensor cores (the two
    forwards and the train-attention backward pair) were compiled to
    tensor-core instructions (HMMA, HGMMA); their registers, spills, shared
    memory and the commonest opcodes of their SASS."""
    mix = sass_mix(str(ds.BUILD_INFO["path"]))
    counts = {k: sum(n for op, n in mix[k].items() if op in ("HMMA", "HGMMA"))
              for k in TENSOR_CORE_KERNELS}
    facts = ptxas_facts(str(ds.BUILD_INFO["log"]))
    for name in TENSOR_CORE_KERNELS:
        f = facts.get(name)
        said = ("not in this process's build log" if f is None else
                f"{f.get('registers')} registers, spill stores/loads {f.get('spill_stores')}/"
                f"{f.get('spill_loads')} bytes, {f.get('smem_bytes')} bytes static shared memory")
        say(f"  {name}: {counts[name]} tensor-core instructions (HMMA/HGMMA) in its SASS; {said}")
        top = sorted(mix[name].items(), key=lambda kv: -kv[1])[:14]
        say(f"    SASS opcodes (static): {sum(mix[name].values())} in all; " +
            ", ".join(f"{op} {n}" for op, n in top))
    if not all(counts.values()):
        raise AssertionError(f"a redesigned kernel has no tensor-core instruction: {counts}")
    hgmma = {k: mix[k].get("HGMMA", 0) for k in WGMMA_KERNELS}
    if not all(hgmma.values()):
        raise AssertionError(f"a wgmma kernel has no HGMMA in its SASS: {hgmma}")


def phase_decode_facts() -> None:
    """Registers, spills, shared memory and the commonest SASS opcodes of
    the decode kernels' instantiations (``DECODE_KERNELS``); fails if one
    has no entry in the build log or spills more than DECODE_SPILL_BYTES."""
    names = tuple(DECODE_KERNELS.values())
    mix = sass_mix(str(ds.BUILD_INFO["path"]), names)
    facts = ptxas_facts(str(ds.BUILD_INFO["log"]), names)
    for label, name in DECODE_KERNELS.items():
        f = facts.get(name)
        if f is None:
            raise AssertionError(f"{label} ({name}) has no entry in the build log")
        spilled = f.get("spill_stores", 0) + f.get("spill_loads", 0)
        say(f"  {label}: {f.get('registers')} registers, spill stores/loads "
            f"{f.get('spill_stores')}/{f.get('spill_loads')} bytes, {f.get('smem_bytes')} bytes "
            f"static shared memory")
        top = sorted(mix[name].items(), key=lambda kv: -kv[1])[:12]
        say(f"    SASS opcodes (static): {sum(mix[name].values())} in all; " +
            ", ".join(f"{op} {n}" for op, n in top))
        if spilled > DECODE_SPILL_BYTES:
            raise AssertionError(f"{label} spills {spilled} bytes (at most {DECODE_SPILL_BYTES})")


def say_clocks(when: str) -> None:
    """The card's SM clock, its maximum, temperature and power draw, beside
    a timed window (runs on one card differ; this says by how much the
    clocks did)."""
    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,temperature.gpu,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(f"  clocks {when} (sm, max sm, temperature, power draw): {q}")


def phase_attention_vs_twin(dev):
    """``fused_attention`` against its twin (and SDPA as the yardstick).
    Cases: (B, T, S, key lengths, causal, q scale); q x 4 makes the softmax
    as peaked as a trained encoder's, and a key length 0 makes a batch row
    whose keys all weigh alike."""
    g = torch.Generator(device=dev).manual_seed(9)
    worst, report = 0.0, None
    served = [1536, 1440, 1344]
    cases = [(3, 1536, 1536, served, False, 1.0), (3, 1536, 1536, served, True, 1.0),
             (3, 1000, 777, [777, 640, 1], False, 1.0), (3, 1000, 777, [777, 640, 1], True, 1.0),
             (3, 1536, 1536, served, False, 4.0), (3, 1000, 777, [0, 640, 1], False, 1.0),
             (3, 1000, 777, [777, 0, 1], True, 4.0)]
    for B, T, S, lens, causal, qscale in cases:
        q = (qscale * torch.randn(B, T, H, HD_ATTN, generator=g, device=dev)).to(torch.bfloat16)
        k, v = (torch.randn(B, S, H, HD_ATTN, generator=g, device=dev).to(torch.bfloat16)
                for _ in range(2))
        kl = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = attn.fused_attention(q, k, v, kl, causal)
        torch.cuda.synchronize()
        ref = attn.attention_reference(q, k, v, kl, causal)
        err = (out.float() - ref.float()).abs().max().item()
        if not (torch.allclose(out.float(), ref.float(), atol=ATTN_ATOL, rtol=ATTN_RTOL)
                and torch.isfinite(out.float()).all().item()):
            raise AssertionError(f"fused_attention disagrees with its twin at B={B} T={T} S={S} "
                                 f"lens={lens} causal={causal} q x {qscale:g}: max |kernel - twin| "
                                 f"{err:.3e}")
        worst = max(worst, err)
        ms = cuda_ms(lambda: attn.fused_attention(q, k, v, kl, causal), iters=20)
        plain_ms = cuda_ms(lambda: attn.attention_reference(q, k, v, kl, causal), iters=3, warmup=1)
        # the yardstick: one torch call of the same function on (B, H, T, HD)
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        mask = torch.arange(S, device=dev)[None, None, None, :] < kl[:, None, None, None]
        if causal:
            mask = mask & torch.ones(T, S, dtype=torch.bool, device=dev).tril()[None, None]
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)  # noqa: E731
        sdpa_err = (sdpa().transpose(1, 2).float() - ref.float()).abs().max().item()
        library_ms = cuda_ms(sdpa, iters=20)
        bound, by = attention_bound(B, T, S, lens, causal)
        say(f"  B={B} T={T} S={S} H={H} HD={HD_ATTN} lens={lens} causal={causal} q x {qscale:g}: "
            f"max|kernel-twin| {err:.3e}; kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, "
            f"sdpa {library_ms:.4f} ms (max|sdpa-twin| {sdpa_err:.3e}), bound {bound:.5f} ms ({by})")
        if (T, causal, qscale) == (1536, False, 1.0):
            report = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=library_ms)
            say_split(device_split(lambda: attn.fused_attention(q, k, v, kl, causal)), ms)
    say(f"  all cases within atol {ATTN_ATOL} + rtol {ATTN_RTOL:.4g} of the twin (max {worst:.3e})")
    return worst, report


def train_attention_pairs(valid, T: int, causal: bool, H_: int) -> int:
    """(query row, attendable key) pairs of one train-attention call over
    all heads: the keys this run's validity mask and causal rule leave."""
    n_keys = valid.sum(dim=1)  # (B,)
    if not causal:
        return int(n_keys.sum().item()) * T * H_
    # causal: row t attends the valid keys at or before t
    csum = valid.int().cumsum(dim=1)  # (B, S)
    return int(csum[:, :T].sum().item()) * H_


def train_attention_bound(B: int, T: int, S: int, valid, causal: bool, backward: bool):
    """Least time of the train-attention forward or backward and what bounds
    it.  Bytes: forward reads q, k, v (bf16) and the int32 validity mask and
    writes the output; backward also reads g and writes dq, dk, dv.
    Operations: 2 HD for every attendable (row, key) pair and product:
    the forward's two (scores, then weights x V), the backward's five
    (scores recomputed, wd^T g, g v^T, ds k, ds^T q), at the bf16
    tensor-core rate.  Returns (ms, "bytes" or "operations")."""
    qb, kb = B * T * H * HD_ATTN * 2, B * S * H * HD_ATTN * 2
    nbytes = (2 * qb + 2 * kb if not backward else 3 * qb + 4 * kb) + B * S * 4 + 16
    pairs = train_attention_pairs(valid, T, causal, H)
    flops = 2 * HD_ATTN * pairs * (5 if backward else 2)
    return bound_ms(nbytes, flops), ("bytes" if nbytes / HBM_BYTES_PER_S > flops / BF16_FLOPS
                                     else "operations")


def rel_norm(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def phase_train_attention_vs_twin(dev):
    """``fused_dropout_attention`` (forward and backward kernels) against
    its twins on the card, the keep mask against ``dropout_mask_reference``,
    and times beside the bound and SDPA.  Returns (max forward error, max
    |kernel - twin| of a gradient, {(T, S): (forward report, backward
    report)} at the timed shapes)."""
    g = torch.Generator(device=dev).manual_seed(17)
    B = TRAIN_B
    worst, worst_rel, worst_grad = 0.0, {"dq": 0.0, "dk": 0.0, "dv": 0.0}, 0.0
    reports = {}
    for T, S, causal in TA_CASES:
        q = torch.randn(B, T, H, HD_ATTN, generator=g, device=dev).to(torch.bfloat16)
        k, v = (torch.randn(B, S, H, HD_ATTN, generator=g, device=dev).to(torch.bfloat16)
                for _ in range(2))
        go = torch.randn(B, T, H, HD_ATTN, generator=g, device=dev).to(torch.bfloat16)
        valid = torch.rand(B, S, generator=g, device=dev) >= 0.1
        valid[1] = False  # one batch row with no valid key
        for seed in TA_SEEDS:
            for rate in (0.0, 0.1):
                if rate > 0.0:
                    keep = ta.dropout_keep_mask(seed, B, H, T, S, rate, dev)
                    ref_keep = ta.dropout_mask_reference(seed, B, H, T, S, rate, device=dev)
                    if not torch.equal(keep, ref_keep):
                        raise AssertionError(f"keep mask differs from dropout_mask_reference at T={T} "
                                             f"S={S} seed={seed}: {(keep != ref_keep).sum().item()} "
                                             "elements")
                out = ta.dropout_attention_fwd(q, k, v, valid, seed, rate, causal)
                torch.cuda.synchronize()
                ref = ta.dropout_attention_fwd_reference(q, k, v, valid, seed, rate, causal)
                err = (out.float() - ref.float()).abs().max().item()
                if not (torch.allclose(out.float(), ref.float(), atol=TA_ATOL, rtol=TA_RTOL)
                        and torch.isfinite(out.float()).all().item()
                        and (out[1] == 0).all().item()):
                    raise AssertionError(f"train-attention forward disagrees with its twin at T={T} "
                                         f"S={S} causal={causal} rate={rate}: max {err:.3e}")
                worst = max(worst, err)
                grads = ta.dropout_attention_bwd(q, k, v, valid, seed, go, rate, causal)
                torch.cuda.synchronize()
                ref_grads = ta.dropout_attention_bwd_reference(q, k, v, valid, seed, go, rate, causal)
                if not all((gr[1] == 0).all().item() for gr in grads):
                    raise AssertionError(f"train-attention backward: the batch row with no valid key "
                                         f"has a nonzero gradient at T={T} S={S} causal={causal} "
                                         f"rate={rate}")
                rels = {}
                for name, a, b in zip(("dq", "dk", "dv"), grads, ref_grads):
                    rels[name] = rel_norm(a, b)
                    worst_grad = max(worst_grad, (a.float() - b.float()).abs().max().item())
                    worst_rel[name] = max(worst_rel[name], rels[name])
                    if not (rels[name] < TA_REL[name] and torch.isfinite(a.float()).all().item()):
                        raise AssertionError(f"train-attention backward {name} disagrees with its twin "
                                             f"at T={T} S={S} causal={causal} rate={rate}: "
                                             f"relative norm {rels[name]:.3e}")
                say(f"  T={T} S={S} causal={causal} seed={seed} rate={rate}: fwd max|kernel-twin| "
                    f"{err:.3e}; backward relative norms " +
                    ", ".join(f"{n} {r:.2e}" for n, r in rels.items()))
        # the autograd Function on the card: one forward and backward through it
        qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
        ta.fused_dropout_attention(qa, ka, va, valid, TA_SEEDS[0], 0.1, causal).backward(go)
        want = ta.dropout_attention_bwd(q, k, v, valid, TA_SEEDS[0], go, 0.1, causal)
        for name, a, b in zip(("dq", "dk", "dv"), (qa.grad, ka.grad, va.grad), want):
            if not torch.equal(a, b):
                raise AssertionError(f"autograd through fused_dropout_attention gives another {name}")
        if (T, S) in TA_TIMED:
            reports[(T, S)] = time_train_attention(dev, q, k, v, go, valid, causal)
    say(f"  keep masks bit-equal; forward within atol {TA_ATOL} + rtol {TA_RTOL:.4g} (max {worst:.3e}); "
        "backward relative norms max " + ", ".join(f"{n} {r:.2e}" for n, r in worst_rel.items())
        + f" (max |kernel - twin| of a gradient {worst_grad:.3e})")
    train_attention_jax_case(dev)
    return worst, worst_grad, reports


def train_attention_jax_case(dev) -> dict:
    """The case at which JAX bounds its kernel's gradients against its twin
    (tests/test_ops.py:621-655, ``_fda_inputs`` :548): B=2, T=256, S=512,
    H=2, head_dim 64, inputs from numpy's generator seeded 3, ~10% of keys
    invalid, key PRNGKey(5) (raw words (0, 5)), rate 0.1, not causal, each
    side differentiating sum(out^2) of its own output.  Held at ``TA_REL``
    (dq and dk at JAX's 0.02); dv's relative norm is printed beside JAX's
    1e-4, which it does not meet on an H100 (ROADMAP Queue 3 item 1)."""
    rng = np.random.default_rng(3)
    B_, T_, S_, H_, HD_ = 2, 256, 512, 2, 64
    q, k, v = (torch.from_numpy(rng.normal(size=(B_, n, H_, HD_))).to(dev).to(torch.bfloat16)
               for n in (T_, S_, S_))
    valid = torch.from_numpy(rng.random((B_, S_)) < 0.9).to(dev)
    seed, rate = (0, 5), 0.1
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    (ta.fused_dropout_attention(qa, ka, va, valid, seed, rate, False).float() ** 2).sum().backward()
    ref = ta.dropout_attention_fwd_reference(q, k, v, valid, seed, rate, False)
    want = ta.dropout_attention_bwd_reference(q, k, v, valid, seed, (2 * ref.float()).to(torch.bfloat16),
                                              rate, False)
    rels = {name: rel_norm(a, b) for name, a, b in zip(("dq", "dk", "dv"), (qa.grad, ka.grad, va.grad),
                                                        want)}
    say(f"  JAX's own gradient case (B=2, T=256, S=512, H=2, key (0, 5), rate 0.1, sum(out^2)): "
        f"relative norms dq {rels['dq']:.3e}, dk {rels['dk']:.3e} (JAX's bound 0.02), dv "
        f"{rels['dv']:.3e} (JAX's bound 1e-4; held at {TA_REL['dv']:g})")
    for name, r in rels.items():
        if not r < TA_REL[name]:
            raise AssertionError(f"train-attention {name} at JAX's own case: relative norm {r:.3e} "
                                 f"against {TA_REL[name]}")
    return rels


def time_train_attention(dev, q, k, v, go, valid, causal):
    """Times of the forward and backward kernels, their twins and SDPA
    (forward, backward) at one shape, rate 0.1, beside the bounds.  The
    wrappers get what the model's training forward hands them: the seed
    words already on the card and the validity mask as int32 (a host seed
    would add a synchronous copy to every call)."""
    B, T = q.shape[:2]
    S = k.shape[1]
    seed, rate = ta.seed_tensor(TA_SEEDS[0], dev), 0.1
    valid = valid.to(torch.int32)
    fwd = lambda: ta.dropout_attention_fwd(q, k, v, valid, seed, rate, causal)  # noqa: E731
    bwd = lambda: ta.dropout_attention_bwd(q, k, v, valid, seed, go, rate, causal)  # noqa: E731
    ms_f, ms_b = cuda_ms(fwd, iters=20), cuda_ms(bwd, iters=20)
    plain_f = cuda_ms(lambda: ta.dropout_attention_fwd_reference(q, k, v, valid, seed, rate, causal),
                      iters=3, warmup=1)
    plain_b = cuda_ms(lambda: ta.dropout_attention_bwd_reference(q, k, v, valid, seed, go, rate, causal),
                      iters=3, warmup=1)
    # the yardstick: SDPA on (B, H, T, D) with the same boolean mask and its
    # own dropout stream
    qt, kt, vt = (a.transpose(1, 2).contiguous().requires_grad_(True) for a in (q, k, v))
    gt = go.transpose(1, 2).contiguous()
    mask = valid.bool()[:, None, None, :].expand(B, 1, T, S)
    if causal:
        mask = mask & torch.ones(T, S, dtype=torch.bool, device=dev).tril()[None, None]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, dropout_p=rate)
    lib_f = cuda_ms(lambda: sdpa().detach(), iters=20)
    out = sdpa()
    lib_b = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True), iters=20)
    bound_f, by_f = train_attention_bound(B, T, S, valid, causal, backward=False)
    bound_b, by_b = train_attention_bound(B, T, S, valid, causal, backward=True)
    say(f"  times at B={B} T={T} S={S} H={H} causal={causal} rate {rate}: forward kernel {ms_f:.4f} ms, "
        f"twin {plain_f:.4f}, SDPA {lib_f:.4f}, bound {bound_f:.5f} ({by_f}); backward kernels "
        f"{ms_b:.4f} ms, twin {plain_b:.4f}, SDPA backward {lib_b:.4f}, bound {bound_b:.5f} ({by_b})")
    say_split(device_split(fwd), ms_f)
    say_split(device_split(bwd), ms_b)
    return (dict(ms=ms_f, plain_ms=plain_f, bound_ms=bound_f, bound_by=by_f, library_ms=lib_f),
            dict(ms=ms_b, plain_ms=plain_b, bound_ms=bound_b, bound_by=by_b, library_ms=lib_b))


def flash_train_pairs(B: int, T: int, S: int, causal: bool) -> int:
    """(query row, key) pairs the flash-train function needs over all heads:
    every key when not causal (the mask is added, not skipped), the keys at
    or before the row when causal."""
    if not causal:
        return B * H * T * S
    return B * H * int(np.minimum(np.arange(T) + 1, S).sum())


def flash_train_bound(B: int, T: int, S: int, causal: bool, backward: bool):
    """Least time of the flash-train forward or backward and what bounds it.
    Bytes: the forward reads q, k, v (bf16) and the int32 mask and writes
    the output and each row's m and l (f32); the backward reads q, k, v,
    the output, g, m, l and the mask and writes dq, dk, dv.  Operations:
    2 HD for every pair and product, the forward's two (scores, p v) and
    the backward's five (scores recomputed, g v^T, p^T g, ds k, ds^T q),
    at the bf16 tensor-core rate.  Returns (ms, "bytes" or "operations")."""
    qb, kb, st = B * T * H * HD_ATTN * 2, B * S * H * HD_ATTN * 2, 2 * B * H * T * 4
    nbytes = (2 * qb + 2 * kb + st if not backward else 4 * qb + 4 * kb + st) + B * S * 4
    flops = 2 * HD_ATTN * flash_train_pairs(B, T, S, causal) * (5 if backward else 2)
    return bound_ms(nbytes, flops), ("bytes" if nbytes / HBM_BYTES_PER_S > flops / BF16_FLOPS
                                     else "operations")


def flash_train_kernel_bound(B: int, T: int, S: int, causal: bool, kernel: str):
    """Least time of one of the two backward kernels alone and what bounds
    it.  ``flash_train_dq_kernel`` reads q, k, v, the output, g, m, l and
    the mask and writes dq and di, and does 3 products (scores, g v^T, ds
    k); ``flash_train_dkv_kernel`` reads q, k, v, g, m, l, di and the mask
    and writes dk and dv, and does 4 (scores, g v^T, p^T g, ds^T q): the
    scores and g v^T are recomputed in both, 7 products for the pair where
    the function needs 5.  2 HD operations a pair and product at the bf16
    rate.  Returns (ms, "bytes" or "operations")."""
    qb, kb, row = B * T * H * HD_ATTN * 2, B * S * H * HD_ATTN * 2, B * H * T * 4
    if kernel == "flash_train_dq_kernel":
        nbytes, products = 4 * qb + 2 * kb + 3 * row + B * S * 4, 3
    else:
        nbytes, products = 2 * qb + 4 * kb + 3 * row + B * S * 4, 4
    flops = 2 * HD_ATTN * flash_train_pairs(B, T, S, causal) * products
    return bound_ms(nbytes, flops), ("bytes" if nbytes / HBM_BYTES_PER_S > flops / BF16_FLOPS
                                     else "operations")


def flash_train_inputs(g, dev, T: int, S: int):
    """Seeded bf16 q, k, v, g at B=8, H=8 and a key mask that is not a suffix
    (~10% of keys invalid anywhere, the first three of row 0 among them),
    batch row 1 with no valid key and row 2 suffix-padded from 0.7 S."""
    B = TRAIN_B
    q = torch.randn(B, T, H, HD_ATTN, generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(B, S, H, HD_ATTN, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    go = torch.randn(B, T, H, HD_ATTN, generator=g, device=dev).to(torch.bfloat16)
    valid = torch.rand(B, S, generator=g, device=dev) >= 0.1
    valid[0, :3] = False
    valid[1] = False
    valid[2] = torch.arange(S, device=dev) < int(0.7 * S)
    return q, k, v, go, valid


def phase_flash_train_vs_twin(dev):
    """The flash-train kernels (forward; dq then dk/dv) against their twins
    at FT_CASES, timed beside the operations bound and SDPA with the same
    boolean mask.  Returns (max forward error, max |kernel - twin| of a
    gradient, the worst dv relative norm, {(T, S, causal): (forward report,
    backward report)} at FT_TIMED)."""
    facts = ptxas_facts(str(ds.BUILD_INFO["log"]), WGMMA_KERNELS)
    for name in WGMMA_KERNELS:
        f = facts.get(name)
        say(f"  {name}: " + ("not in this process's build log" if f is None else
                             f"{f.get('registers')} registers at launch (setmaxnreg moves them to "
                             f"the consumers), spill stores/loads {f.get('spill_stores')}/"
                             f"{f.get('spill_loads')} bytes, {f.get('smem_bytes')} bytes static "
                             "shared memory (its ring is dynamic)"))
    g = torch.Generator(device=dev).manual_seed(23)
    worst, worst_grad, worst_rel = 0.0, 0.0, {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    reports = {}
    for T, S, causal in FT_CASES:
        q, k, v, go, valid = flash_train_inputs(g, dev, T, S)
        out, stats = ft.flash_train_fwd(q, k, v, valid, causal)
        torch.cuda.synchronize()
        ref, ref_stats = ft.flash_train_fwd_reference(q, k, v, valid, causal)
        err = (out.float() - ref.float()).abs().max().item()
        if not (torch.allclose(out.float(), ref.float(), atol=TA_ATOL, rtol=TA_RTOL)
                and torch.isfinite(out.float()).all().item()):
            raise AssertionError(f"flash-train forward disagrees with its twin at T={T} S={S} "
                                 f"causal={causal}: max {err:.3e}")
        stat_err = rel_norm(stats, ref_stats)
        grads = ft.flash_train_bwd(q, k, v, valid, out, stats, go, causal)
        torch.cuda.synchronize()
        # the twin's backward from the kernel's forward (its output and m, l),
        # so the check holds the backward kernels alone
        ref_grads = ft.flash_train_bwd_reference(q, k, v, valid, out, stats, go, causal)
        rels = {}
        for name, a, b in zip(("dq", "dk", "dv"), grads, ref_grads):
            rels[name] = rel_norm(a, b)
            worst_grad = max(worst_grad, (a.float() - b.float()).abs().max().item())
            worst_rel[name] = max(worst_rel[name], rels[name])
            if not (rels[name] < TA_REL[name] and torch.isfinite(a.float()).all().item()):
                raise AssertionError(f"flash-train backward {name} disagrees with its twin at T={T} "
                                     f"S={S} causal={causal}: relative norm {rels[name]:.3e}")
        worst = max(worst, err)
        # the row with no valid key weighs the keys of its visited blocks alike
        keys = min(S, 128) if causal else S
        mean = v[1, :keys].float().mean(dim=0)
        if not torch.allclose(out[1, 0].float(), mean, atol=TA_ATOL, rtol=TA_RTOL):
            raise AssertionError(f"flash-train forward: the row with no valid key is not the mean "
                                 f"of V over its visited keys at T={T} S={S} causal={causal}")
        say(f"  T={T} S={S} causal={causal}: fwd max|kernel-twin| {err:.3e}, m and l relative norm "
            f"{stat_err:.2e}; backward relative norms " +
            ", ".join(f"{n} {r:.2e}" for n, r in rels.items()) +
            f" (dv beside JAX's kernel-to-twin bound 1e-4)")
        # the autograd Function on the card: one forward and backward through it
        qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
        ft.flash_train_attention(qa, ka, va, valid, causal).backward(go)
        for name, a, b in zip(("dq", "dk", "dv"), (qa.grad, ka.grad, va.grad), grads):
            if not torch.equal(a, b):
                raise AssertionError(f"autograd through flash_train_attention gives another {name}")
        reports[(T, S, causal)] = time_flash_train(dev, q, k, v, go, valid, causal,
                                                   twin=(T, S, causal) in FT_TIMED)
        del q, k, v, go, out, ref, grads, ref_grads, qa, ka, va
        torch.cuda.empty_cache()
    say(f"  forward within atol {TA_ATOL} + rtol {TA_RTOL:.4g} (max {worst:.3e}); backward relative "
        "norms max " + ", ".join(f"{n} {r:.2e}" for n, r in worst_rel.items()) +
        f" (max |kernel - twin| of a gradient {worst_grad:.3e})")
    return worst, worst_grad, worst_rel["dv"], reports


def time_flash_train(dev, q, k, v, go, valid, causal, twin: bool):
    """Times of the flash-train forward and backward kernels (CUDA events),
    their twins (``twin``) and SDPA (forward, backward) with the same
    boolean mask, beside the bounds."""
    B, T = q.shape[:2]
    S = k.shape[1]
    valid = valid.to(torch.int32)
    out, stats = ft.flash_train_fwd(q, k, v, valid, causal)
    fwd = lambda: ft.flash_train_fwd(q, k, v, valid, causal)  # noqa: E731
    bwd = lambda: ft.flash_train_bwd(q, k, v, valid, out, stats, go, causal)  # noqa: E731
    ms_f, ms_b = cuda_ms(fwd, iters=20), cuda_ms(bwd, iters=20)
    plain_f = plain_b = None
    if twin:
        plain_f = cuda_ms(lambda: ft.flash_train_fwd_reference(q, k, v, valid, causal), iters=2,
                          warmup=1)
        plain_b = cuda_ms(lambda: ft.flash_train_bwd_reference(q, k, v, valid, out, stats, go, causal),
                          iters=2, warmup=1)
    qt, kt, vt = (a.transpose(1, 2).contiguous().requires_grad_(True) for a in (q, k, v))
    gt = go.transpose(1, 2).contiguous()
    mask = valid.bool()[:, None, None, :].expand(B, 1, T, S)
    if causal:
        mask = mask & torch.ones(T, S, dtype=torch.bool, device=dev).tril()[None, None]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)  # noqa: E731
    lib_f = cuda_ms(lambda: sdpa().detach(), iters=20)
    sd_out = sdpa()
    lib_b = cuda_ms(lambda: torch.autograd.grad(sd_out, (qt, kt, vt), gt, retain_graph=True),
                    iters=20)
    bound_f, by_f = flash_train_bound(B, T, S, causal, backward=False)
    bound_b, by_b = flash_train_bound(B, T, S, causal, backward=True)
    twins = "" if not twin else f" (twins: forward {plain_f:.4f}, backward {plain_b:.4f})"
    say(f"    times at B={B} T={T} S={S} H={H} causal={causal}: forward kernel {ms_f:.4f} ms, SDPA "
        f"{lib_f:.4f}, bound {bound_f:.5f} ({by_f}); backward kernels {ms_b:.4f} ms, SDPA backward "
        f"{lib_b:.4f}, bound {bound_b:.5f} ({by_b}, the function's 5 products){twins}")
    # each backward kernel alone: its device time by name, beside its own bound
    split_b = device_split(bwd)
    for name in WGMMA_KERNELS:
        kb_ms, kb_by = flash_train_kernel_bound(B, T, S, causal, name)
        us_k = "not measured" if split_b is None else f"{split_b.get(name, 0.0):.1f} us"
        say(f"      {name}: {us_k} a call (profiler), bound {1e3 * kb_ms:.1f} us ({kb_by})")
    if twin:
        say_split(device_split(fwd), ms_f)
        say_split(split_b, ms_b)
    return (dict(ms=ms_f, plain_ms=plain_f, bound_ms=bound_f, bound_by=by_f, library_ms=lib_f),
            dict(ms=ms_b, plain_ms=plain_b, bound_ms=bound_b, bound_by=by_b, library_ms=lib_b))


def reset_counts() -> None:
    ds.reset_counts()
    dg.reset_counts()
    attn.reset_counts()
    ta.reset_counts()
    ft.reset_counts()


def counts():
    return dict(v2=ds.fused_decode_step.launches, v3=ds.fused_decode_token.launches,
                v4=ds.fused_decode_tokens.launches, int8=ds.rowvec_int8.launches,
                verify=ds.fused_verify_window.launches, attn=attn.fused_attention.launches,
                v2_twin=ds.fused_decode_step_reference.calls,
                v3_twin=ds.fused_decode_token_reference.calls,
                v4_twin=ds.fused_decode_tokens_reference.calls,
                int8_twin=ds.rowvec_int8_reference.calls,
                ta_fwd=ta.dropout_attention_fwd.launches, ta_bwd=ta.dropout_attention_bwd.launches,
                ta_fwd_twin=ta.dropout_attention_fwd_reference.calls,
                ta_bwd_twin=ta.dropout_attention_bwd_reference.calls,
                verify_twin=ds.fused_verify_window_reference.calls,
                attn_twin=attn.attention_reference.calls,
                ft_fwd=ft.flash_train_fwd.launches, ft_bwd=ft.flash_train_bwd.launches,
                ft_fwd_twin=ft.flash_train_fwd_reference.calls,
                ft_bwd_twin=ft.flash_train_bwd_reference.calls)


def check_counts(what: str, on) -> int:
    """The path just driven launched every kernel named in ``on`` (of v2, v3,
    v4, int8, verify, attn) and nothing else: no other kernel and no twin
    (with ``on`` empty: no kernel and no twin at all).  Returns the launches
    of the first."""
    got = counts()
    say(f"  {what}: launches {got}")
    if any(got[k] == 0 for k in on) or any(v for k, v in got.items() if k not in on):
        raise AssertionError(f"{what} did not go through the {'+'.join(on)} kernels alone: {got}")
    return got[on[0]] if on else 0


def serve_requests(engine, reqs, workdir, tag, to_midi=events_to_midi):
    """``run_batch`` on the requests, decoded as one batch; every result must
    restore, close its bars (SMER) and write a MIDI file that reads back.
    Returns (wall seconds, results)."""
    seen = []
    dispatch = engine._dispatch
    engine._dispatch = lambda src_b, *a: seen.append(src_b.shape) or dispatch(src_b, *a)
    t = time.perf_counter()
    results = engine.run_batch(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if seen[0][0] != len(reqs):
        raise AssertionError(f"{len(reqs)} requests were not decoded as one batch of {len(reqs)} ({seen})")
    tokens = 0
    for i, (req, res) in enumerate(zip(reqs, results)):
        if res is None or "m_0" in res.events:
            raise AssertionError(f"request {i} did not restore")
        # the engine checks and repairs bar durations for SMER only, as JAX's
        if engine.vocab.mode == 0 and not engine._spans_close(res.events, req):
            raise AssertionError(f"request {i}: a masked bar does not close after the repair")
        path = os.path.join(workdir, f"{tag}{i}.mid")
        to_midi(res.events, 100.0).write(path)
        if not read_midi(path).instruments:
            raise AssertionError(f"request {i}: written MIDI does not read back")
        tokens += len(res.generated)
        say(f"  request {i}: bars {req.mask_bars} tracks {req.mask_tracks}: "
            f"{len(res.generated)} tokens, {res.decode_steps} decode steps, "
            f"{res.time_corrections} retries")
    say(f"  run_batch ({tag}): {len(seen)} decodes of batch {[s[0] for s in seen]}, src {seen[0][1]} ids, "
        f"{wall:.3f} s, {tokens / wall:.1f} tokens/s, {1e3 * wall / len(reqs):.1f} ms per request")
    return wall, results


def served_events(score, vocab):
    events, controls = encode_midi(score, controls={"key": None},
                                   track_names=["track_0", "track_1", "track_2"])
    if vocab.mode == 1:
        events = smer_to_remi(events)
    controls["bar_track"] = 0
    for name in ("track_0", "track_1", "track_2"):
        controls[f"{name}_c"] = controls[name]
    return change_controls(events, controls, vocab)


def served_requests(engine, events):
    """Phase 3's batch of 3 requests, prepared by ``engine``."""
    reqs = [engine.prepare(events, tracks, bars) for tracks, bars in SERVED_JOBS]
    if any(r is None for r in reqs):
        raise AssertionError("a request could not be prepared")
    return reqs


def serve_path(engine, reqs, workdir, tag, on, to_midi=events_to_midi):
    """One served run with every count at 0 just before it; returns (results,
    the launch counts)."""
    reset_counts()
    wall, results = serve_requests(engine, reqs, workdir, tag, to_midi)
    check_counts(f"run_batch ({tag})", on)
    got = counts()
    caps, reps = dg.DecodeGraph.captures, dg.DecodeGraph.replays
    if "v3" in on or "v4" in on:
        # one capture a new graph key of the decoder (B, source bucket),
        # after one warm-up run of the kernels; then one replay a token (v3)
        # or a chunk (v4)
        cap_ms = sum(dg.DecodeGraph.capture_ms)
        graphs = engine.decoder.graphs
        say(f"  {tag}: {caps} graph captures ({cap_ms:.2f} ms, {cap_ms / (1e3 * wall):.2%} of the "
            f"run_batch wall), {reps} replays; the decoder keeps {len(graphs.graphs)} graphs, "
            f"{graphs.hits} decodes found theirs, {graphs.misses} captured one")
        if reps == 0 or got["v3"] + got["v4"] != reps + caps:
            raise AssertionError(f"{tag}: the decode did not run as graph replays: {caps} captures, "
                                 f"{reps} replays, launches {got}")
    elif caps or reps:
        raise AssertionError(f"{tag}: a graph was captured on the {on} path")
    steps = got["v2"] + reps * engine.decoder.token_chunk  # a v4 replay is a chunk
    say(f"  {tag}: {steps} decode steps, {1e3 * wall / max(steps, 1):.3f} ms of wall time a step")
    return results, got


def phase_serve(dev, workdir):
    cfg = ExperimentConfig()
    vocab = WordVocab(cfg.vocab_mode, cfg.control_list)
    snapshot = default_flagship_snapshot()
    if snapshot is None:
        raise FileNotFoundError("assets/flagship_params.msgpack is missing")
    model, epoch = load_inference_model(cfg, vocab.vocab_size, snapshot, torch.bfloat16, device=dev)
    say(f"  loaded {snapshot} (epoch {epoch}) onto {dev} in bf16")
    score = make_score()
    midi_in = os.path.join(workdir, "in.mid")
    score.write(midi_in)

    reset_counts()
    t = time.perf_counter()
    midi_out = os.path.join(workdir, "cli_out.mid")
    rc = generate_cli.main([
        "-i", midi_in, "-o", midi_out, "--bars", "3", "4", "--tracks", "1",
        "--greedy", "--device", str(dev),
    ])
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"generate_cli.main returned {rc}")
    if not read_midi(midi_out).instruments:
        raise AssertionError("the CLI's MIDI output has no instruments")
    say(f"  generate_cli (greedy, bars 3-4 of track 1): {time.perf_counter() - t:.2f} s")
    launches = dict(v3=check_counts("generate_cli", ["v3"]))

    events = served_events(score, vocab)
    engine = InfillEngine(model, vocab, nucleus_p=0.9, max_tgt_len=L, seed=0)
    reqs = served_requests(engine, events)
    v3_results, got = serve_path(engine, reqs, workdir, "v3_", ["v3"])
    launches["v3"] += got["v3"]

    v2_engine = InfillEngine(model, vocab, nucleus_p=0.9, max_tgt_len=L, seed=0)
    v2_engine.decoder.fused_sampling = False  # the v2 step with the host's sampling ops
    launches["v2"] = serve_path(v2_engine, reqs, workdir, "v2_", ["v2"])[1]["v2"]

    # v4: InfillDecoder(token_chunk=8), as JAX reaches it (its engine has no flag)
    v4_engine = InfillEngine(model, vocab, nucleus_p=0.9, max_tgt_len=L, seed=0)
    v4_engine.decoder = dataclasses.replace(v4_engine.decoder, token_chunk=8)
    v4_results, got = serve_path(v4_engine, reqs, workdir, "v4_", ["v4"])
    launches["v4"] = got["v4"]
    for i, (a, b) in enumerate(zip(v3_results, v4_results)):
        if a.generated != b.generated or a.decode_steps != b.decode_steps:
            raise AssertionError(f"request {i}: the v4 run decoded other tokens than the v3 run "
                                 f"under the same seed")
    say("  v4 (token_chunk=8) decoded the v3 run's tokens and steps in every request and retry")

    int8_engine = InfillEngine(model, vocab, nucleus_p=0.9, max_tgt_len=L, seed=0, quant="int8")
    got = serve_path(int8_engine, reqs, workdir, "v3_int8_", ["int8", "v3"])[1]
    launches["int8"] = got["int8"]
    launches["v3"] += got["v3"]
    return model, vocab, score, events, launches


def phase_serve_remi(dev, workdir) -> int:
    """The committed REMI snapshot, loaded with the config its sidecar
    describes (vocab_mode 1, 349 words), serving 3 nucleus requests through
    the v3 kernels."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                        "flagship_remi_params.msgpack")
    with open(path + ".json") as fh:
        meta = json.load(fh)
    cfg = ExperimentConfig(vocab_mode=int(meta["vocab_mode"]))
    vocab = WordVocab(cfg.vocab_mode, cfg.control_list)
    if (vocab.mode, vocab.vocab_size) != (1, int(meta["vocab_size"])):
        raise AssertionError(f"REMI vocab {vocab.mode}/{vocab.vocab_size} against the sidecar {meta}")
    model, epoch = load_inference_model(cfg, vocab.vocab_size, path, torch.bfloat16, device=dev)
    say(f"  loaded {path} (epoch {epoch}, vocab_mode {vocab.mode}, {vocab.vocab_size} words) in bf16")
    events = served_events(make_score(), vocab)
    engine = InfillEngine(model, vocab, nucleus_p=0.9, max_tgt_len=L, seed=0)
    reqs = served_requests(engine, events)
    return serve_path(engine, reqs, workdir, "remi_v3_", ["v3"], to_midi=remi_to_midi)[1]["v3"]


def plugin_notes(score: MidiScore, tempo: float = 100.0):
    """The plugin's note dict of a score: [pitch, start beat, beats] a note,
    program + 1 a track."""
    beat = 60.0 / tempo
    out = {"tempo": tempo, "numerator": 4, "denominator": 4}
    for i, inst in enumerate(score.instruments):
        out[f"track_{i}"] = [[n.pitch, n.start / beat, (n.end - n.start) / beat] for n in inst.notes]
        out[f"track_{i}_program"] = inst.program + 1
    return out


def http_json(url: str, payload=None, timeout: float = 300.0):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if resp.status != 200:
            raise AssertionError(f"{url} answered {resp.status}")
        return json.loads(resp.read())


def unlocked(controls):
    """The plugin's overwrite before /generate: per-track control dicts move
    to ``track_N_c`` and ``track_N`` becomes the lock flag 0 (unlocked)."""
    controls = dict(controls, bar_track=0, start_bar=1)
    for n in range(controls["track_nums"]):
        controls[f"track_{n}_c"] = controls[f"track_{n}"]
        controls[f"track_{n}"] = 0
    return controls


def phase_http(model, vocab, score) -> int:
    ctx = ServingContext(model, vocab)
    groups = []
    run_batch = ctx.engine.run_batch
    ctx.engine.run_batch = lambda reqs, *a, **k: groups.append(len(reqs)) or run_batch(reqs, *a, **k)
    reset_counts()
    server = serve(ctx, host="127.0.0.1", port=0)
    try:
        host, port = server.server_address
        url = f"http://{host}:{port}"
        health = http_json(url + "/health", timeout=60)
        if health.get("status") != "ok":
            raise AssertionError(f"/health answered {health}")
        t = time.perf_counter()
        enc = http_json(url + "/encode", {"notes": plugin_notes(score), "controls": {"start_bar": 1}})
        say(f"  /health {health}; /encode: {len(enc['events'])} events, "
            f"track_map {enc['track_map']}, {1e3 * (time.perf_counter() - t):.1f} ms")
        controls = unlocked(enc["controls"])
        jobs = [([0], [2, 3]), ([1], [7]), ([2], [11])]
        answers, errors = [None] * len(jobs), []

        def worker(i):
            tracks, bars = jobs[i]
            try:
                answers[i] = http_json(url + "/generate", {
                    "events": enc["events"], "controls": controls, "tracks": tracks,
                    "bars": bars, "tempo": 100,
                })
            except Exception as exc:  # reported below, and the phase fails
                errors.append(f"request {i}: {type(exc).__name__}: {exc}")

        t = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(jobs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if errors or any(th.is_alive() for th in threads):
            raise AssertionError(f"/generate failed: {errors}")
        for i, ans in enumerate(answers):
            if "events" not in ans or "m_0" in ans["events"]:
                raise AssertionError(f"/generate {i} answered {str(ans)[:300]}")
            say(f"  /generate {i} (tracks {jobs[i][0]} bars {jobs[i][1]}): {len(ans['events'])} events, "
                f"{ans['decode_steps']} decode steps, notes for {sorted(ans.get('notes', {}))}")
        say(f"  3 concurrent /generate in {wall:.3f} s, {1e3 * wall / len(jobs):.1f} ms per request; "
            f"the batcher formed {len(groups)} run_batch groups of {groups}")
    finally:
        server.shutdown()
        server.server_close()
        ctx.close()
    return check_counts("HTTP /generate", ["v3"])


def phase_serve_cli(score, flags=()) -> None:
    """``python -m ...serve.serve_cli`` with no flags but its address (and
    ``flags``), in a process of its own: it loads the committed snapshot
    onto the card and answers /health, /encode and one /generate; then it is
    stopped."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    cmd = [sys.executable, "-m", "smer_music_generation_tpu_torch.serve.serve_cli",
           "--host", "127.0.0.1", "--port", str(port), *flags]
    with tempfile.TemporaryFile("w+") as log:
        t = time.perf_counter()
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            while True:
                if proc.poll() is not None:
                    log.seek(0)
                    raise RuntimeError(f"serve_cli exited with {proc.returncode}:\n{log.read()[-3000:]}")
                try:
                    http_json(url + "/health", timeout=5)
                    break
                except OSError:
                    if time.perf_counter() - t > 240:
                        raise
                    time.sleep(0.5)
            say(f"  serve_cli answers /health {time.perf_counter() - t:.1f} s after its start")
            enc = http_json(url + "/encode", {"notes": plugin_notes(score), "controls": {"start_bar": 1}})
            t = time.perf_counter()
            ans = http_json(url + "/generate", {"events": enc["events"], "controls": unlocked(enc["controls"]),
                                               "tracks": [1], "bars": [5], "tempo": 100})
            if "events" not in ans or "m_0" in ans["events"]:
                raise AssertionError(f"serve_cli's /generate answered {str(ans)[:300]}")
            say(f"  serve_cli {' '.join(flags)} /generate (track 1, bar 5): {ans['decode_steps']} decode steps, "
                f"{1e3 * (time.perf_counter() - t):.1f} ms")
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        log.seek(0)
        for line in log.read().splitlines()[-4:]:
            print("   ", line, flush=True)


def greedy_request(model, vocab, events):
    """The one greedy request phase 4 and phases 3c-3d compare streams on,
    assembled as the engine assembles it."""
    eng = InfillEngine(model, vocab, max_tgt_len=L)
    return eng._assemble([eng.prepare(events, [0], [5, 6])])


def greedy_stream(model, vocab, asm, **kw) -> torch.Tensor:
    dec = InfillDecoder(model, vocab, max_tgt_len=L, greedy=True, nucleus_p=None, fused=True, **kw)
    res = dec(*asm[:4])
    return res.tokens[0, : int(res.lengths[0])].cpu()


def first_divergence(model, vocab, events, fused_sampling: bool, quant: str = "none",
                     against_v2: bool = False):
    """One greedy request through the kernels, then through the twin (the
    decoder's call patched to the twin), or, with ``against_v2``, through
    the v3 kernels and then the v2 kernels (JAX's
    ``test_fused_int8_v2_v3_token_exact_greedy`` on the card); then
    :func:`check_divergence`."""
    asm = greedy_request(model, vocab, events)
    label = ("v3" if fused_sampling else "v2") + ("-int8" if quant != "none" else "")
    a = greedy_stream(model, vocab, asm, fused_sampling=fused_sampling, quant=quant)
    if against_v2:
        other = "v2-int8" if quant != "none" else "v2"
        b = greedy_stream(model, vocab, asm, fused_sampling=False, quant=quant)
    else:
        other = "twin"
        name, twin = (("open_graph", twin_graph) if fused_sampling
                      else ("fused_decode_step", ds.fused_decode_step_reference))
        with mock.patch.object(decode_mod, name, twin):
            b = greedy_stream(model, vocab, asm, fused_sampling=fused_sampling, quant=quant)
    check_divergence(model, vocab, asm, a, b, label, other, f32_row=fused_sampling, quant=quant,
                     either=against_v2)


class TwinGraph(dg.DecodeGraph):
    """A ``DecodeGraph`` whose steps run the twins, on the card too."""

    def step(self) -> None:
        self._twin_step()
        self.host_pos += self.n


@contextlib.contextmanager
def twin_graph(graphs, packed, tables, state, aux, span_types, noise, cross_kv, cross_len, *,
               cache_rows, cache_dtype, T_chunk=None, start=0, **kw):
    """``open_graph`` for the twin path: a ``TwinGraph`` on new buffers."""
    B = state.shape[1]
    cache = torch.zeros(NL, B, cache_rows, 2 * D, dtype=cache_dtype, device=state.device)
    out = torch.zeros(B, cache_rows, dtype=torch.int32, device=state.device)
    graph = TwinGraph(packed, tables, state.clone(), aux, span_types, noise, cache, cross_kv,
                      cross_len, out, T_chunk=T_chunk, start=start, **kw)
    graph.load(state, aux, span_types, noise, cross_kv, cross_len, start)
    yield graph


def check_divergence(model, vocab, asm, a, b, label, other, *, f32_row: bool, quant="none",
                     either: bool) -> None:
    """Where the two greedy token streams ``a`` and ``b`` first differ, the
    twin's logits are recomputed on the shared prefix (``model``'s plain
    encoder, the v2 twin on ``f32_row`` input rows as v3 builds them, or on
    rows rounded to the compute dtype as v2 and the verify build them): the
    two paths may part only where the twin's margin between its token and
    the other's is within the phase-2 tolerance on each of the two logits.
    Against the twin, the twin's own token may lead by at most that; with
    ``either``, between two kernel paths, either may."""
    n = min(len(a), len(b))
    diff = (a[:n] != b[:n]).nonzero()
    if len(diff) == 0 and len(a) == len(b):
        say(f"  {label} path and {other} path: identical ({len(a)} tokens)")
        return
    p = int(diff[0]) if len(diff) else n
    src = torch.as_tensor(asm[0], dtype=torch.long, device=model.device)
    pad = src == 0
    cfg = model.cfg
    kw = dict(n_layers=cfg.num_decoder_layers, d_model=cfg.d_model, nhead=cfg.nhead,
              d_ff=cfg.d_ff, vpad=ds.vocab_pad(vocab.vocab_size))
    packed = ds.pack_decoder_weights(model, kw["vpad"], quant=quant)
    with torch.no_grad():
        cross_kv = ds.stack_kv_cache(model.init_cross_cache(model.encode(src, pad)), cfg.num_decoder_layers)
        cross_len = (~pad).sum(1).to(torch.int32)
        kv = torch.zeros(cfg.num_decoder_layers, 1, L, 2 * cfg.d_model, dtype=cfg.dtype, device=model.device)
        for pos in range(p):  # the step at p - 1 emits position p
            tok = b[pos : pos + 1].to(model.device)
            if f32_row:  # v3: the f32 row with the analytic PE
                x = packed["emb"][tok].float() * math.sqrt(cfg.d_model) + ds.pe_row(pos, cfg.d_model, model.device)
            else:
                x = (model.embedding.weight[tok] * math.sqrt(cfg.d_model) + model.pos_table[pos]).to(cfg.dtype)
            logits, new_kv = ds.fused_decode_step_reference(packed, x, kv, cross_kv, pos, cross_len, **kw)
            kv[:, :, pos] = new_kv
    lg = logits[0, : vocab.vocab_size].float()

    def sampled(tokens):
        # the sampled token behind position p: m_0 (a new span) or padding
        # (the element is done) after a common prefix follows a sampled <eos>
        tok = int(tokens[p]) if p < len(tokens) else 0
        return vocab.eos_index if tok in (0, vocab.mask_index) else tok

    ta, tb = sampled(a), sampled(b)
    gap = (lg[tb] - lg[ta]).item()
    allowed = 2 * ATOL + RTOL * (abs(lg[ta].item()) + abs(lg[tb].item()))
    say(f"  {label} path and {other} path first differ at position {p} of {n}: "
        f"{vocab.index2char(ta)!r} vs {vocab.index2char(tb)!r}; twin logit gap "
        f"{gap:.4f}, tolerance {allowed:.4f}")
    if (abs(gap) if either else gap) > allowed:
        raise AssertionError(
            f"{label} path departs from the {other} path at position {p} where the twin's "
            f"margin {gap:.4f} exceeds the tolerance {allowed:.4f}"
        )


def phase_spec(model, vocab, events, score, workdir):
    """Speculative decode served at B=1 through the verify kernel."""
    launches = 0
    asm = greedy_request(model, vocab, events)
    say(f"  the request: bars [5, 6] of track 0, src {asm[0].shape[1]} ids")
    report = {}
    for name, greedy, p in (("greedy", True, None), ("nucleus", False, 0.9)):
        for k in (SPEC_K, 0):
            eng = InfillEngine(model, vocab, greedy=greedy, nucleus_p=p, max_tgt_len=L, draft_k=k, seed=0)
            eng.decoder(*asm[:4])  # warm: the decoder's packed weights and first launches
            torch.cuda.synchronize()
            reset_counts()
            t = time.perf_counter()
            out = eng.decoder(*asm[:4])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            emitted = out.steps  # the positions decoded, the done padding included
            if k:
                verifies = check_counts(f"spec decode (draft_k={k}, {name})", ["verify"])
                launches += verifies
                report[name] = dict(verifies=verifies, emitted=emitted, ms_verify=1e3 * wall / verifies,
                                    ms_token=1e3 * wall / emitted)
                say(f"  {name} draft_k={k}: {verifies} verify calls for {emitted} positions, "
                    f"{emitted / verifies:.3f} tokens a verify, {1e3 * wall / verifies:.3f} ms a verify "
                    f"iteration, {1e3 * wall / emitted:.3f} ms an emitted token ({1e3 * wall:.1f} ms, "
                    f"the encode included)")
                # where one decode call's time goes (the profiler's own cost included)
                split, host, _ = profiled(lambda: eng.decoder(*asm[:4]), iters=1)
                t = time.perf_counter()
                eng.decoder(*asm[:4])
                torch.cuda.synchronize()
                say_split(split, 1e3 * (time.perf_counter() - t))
                say("    host ops by self CPU time: " + ", ".join(
                    f"{key} {us / 1e3:.1f} ms x{n}" for key, us, n in host))
            else:
                check_counts(f"v3 at B=1 ({name})", ["v3"])
                say(f"  {name} v3 at B=1: {emitted} steps, {1e3 * wall / max(emitted, 1):.3f} ms a token "
                    f"({1e3 * wall:.1f} ms)")
                report[name]["v3_ms_token"] = 1e3 * wall / max(emitted, 1)
        # the served path: run_batch of the one request (the bar-time retries included)
        eng = InfillEngine(model, vocab, greedy=greedy, nucleus_p=p, max_tgt_len=L, draft_k=SPEC_K, seed=0)
        req = eng.prepare(events, [0], [5, 6])
        reset_counts()
        serve_requests(eng, [req], workdir, f"spec_{name}_")
        launches += check_counts(f"run_batch (draft_k={SPEC_K}, {name})", ["verify"])

    reset_counts()
    midi_in = os.path.join(workdir, "in.mid")
    score.write(midi_in)
    t = time.perf_counter()
    rc = generate_cli.main(["-i", midi_in, "-o", os.path.join(workdir, "spec_cli.mid"), "--bars", "3", "4",
                            "--tracks", "1", "--greedy", "--draft_k", str(SPEC_K), "--device", str(model.device)])
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"generate_cli --draft_k returned {rc}")
    say(f"  generate_cli --draft_k {SPEC_K} (greedy, bars 3-4 of track 1): {time.perf_counter() - t:.2f} s")
    launches += check_counts(f"generate_cli --draft_k {SPEC_K}", ["verify"])

    ctx = ServingContext(model, vocab, draft_k=SPEC_K)
    reset_counts()
    server = serve(ctx, host="127.0.0.1", port=0)
    try:
        host, port = server.server_address
        url = f"http://{host}:{port}"
        enc = http_json(url + "/encode", {"notes": plugin_notes(score), "controls": {"start_bar": 1}})
        t = time.perf_counter()
        ans = http_json(url + "/generate", {"events": enc["events"], "controls": unlocked(enc["controls"]),
                                           "tracks": [2], "bars": [9], "tempo": 100})
        if "events" not in ans or "m_0" in ans["events"]:
            raise AssertionError(f"/generate with draft_k answered {str(ans)[:300]}")
        say(f"  HTTP /generate with draft_k={SPEC_K} (track 2, bar 9): {ans['decode_steps']} positions, "
            f"{1e3 * (time.perf_counter() - t):.1f} ms")
    finally:
        server.shutdown()
        server.server_close()
        ctx.close()
    launches += check_counts(f"HTTP /generate (draft_k={SPEC_K})", ["verify"])
    phase_serve_cli(score, ["--draft_k", str(SPEC_K)])

    b = greedy_stream(model, vocab, asm, fused_sampling=False)
    for k in (SPEC_K, 24):  # the served width, and a window of 25 rows (two row-vector launches)
        reset_counts()
        a = greedy_stream(model, vocab, asm, draft_k=k)
        check_counts(f"greedy spec decode (draft_k={k})", ["verify"])
        # both round the input rows to bf16 (the verify as v2 does)
        check_divergence(model, vocab, asm, a, b, f"spec (draft_k={k})", "v2", f32_row=False,
                         either=True)
    return launches, report


def phase_flash_encoder(model, vocab, events, workdir):
    """The 3-request batch of phase 3 through v3 on the same weights with
    ``flash_encoder=True``: four fused_attention launches an encode."""
    flash = ScoreTransformer(dataclasses.replace(model.cfg, flash_encoder=True))
    flash.load_state_dict(model.state_dict())
    flash = flash.to(model.device).eval().requires_grad_(False)
    engine = InfillEngine(flash, vocab, nucleus_p=0.9, max_tgt_len=L, seed=0)
    encodes = []
    dispatch = engine._dispatch
    engine._dispatch = lambda *a: encodes.append(1) or dispatch(*a)
    reqs = served_requests(engine, events)
    _, got = serve_path(engine, reqs, workdir, "flash_v3_", ["v3", "attn"])
    n_layers = model.cfg.num_encoder_layers
    if got["attn"] != n_layers * len(encodes):
        raise AssertionError(f"{got['attn']} fused_attention launches for {len(encodes)} encodes of "
                             f"{n_layers} layers")
    say(f"  {got['attn']} fused_attention launches for {len(encodes)} encodes")

    # one encode of the batch each way
    src_b = torch.as_tensor(engine._assemble(reqs)[0], dtype=torch.long, device=model.device)
    pad = src_b == 0
    times = {}
    with torch.no_grad():
        for tag, m in (("plain", model), ("flash", flash)):
            times[tag] = cuda_ms(lambda: m.init_cross_cache(m.encode(src_b, pad)), iters=10)
        mem_p, mem_f = model.encode(src_b, pad), flash.encode(src_b, pad)
    valid = ~pad
    err = (mem_p[valid].float() - mem_f[valid].float()).abs().max().item()
    say(f"  one encode + cross K/V of the batch (B={src_b.shape[0]}, S={src_b.shape[1]}): "
        f"plain {times['plain']:.4f} ms, flash {times['flash']:.4f} ms; max |flash - plain| "
        f"memory on valid rows {err:.3e}")
    asm = greedy_request(model, vocab, events)
    a = greedy_stream(flash, vocab, asm)
    b = greedy_stream(model, vocab, asm)
    check_divergence(model, vocab, asm, a, b, "flash-encoder v3", "plain-encoder v3", f32_row=True,
                     either=True)
    return got["attn"], times


def train_batch(vocab, dev, B: int = TRAIN_B, S: int = TRAIN_SRC, T: int = TRAIN_TGT, seed: int = 5):
    """One fixed batch of B rows x src S + tgt T from seeded SMER token ids,
    suffix-padded: row lengths drawn from [S/2, S] and [T/2, T], the first
    row full."""
    rng = np.random.default_rng(seed)
    V = vocab.vocab_size
    src = rng.integers(3, V, (B, S)).astype(np.int64)
    tgt = rng.integers(3, V, (B, T)).astype(np.int64)
    tout = np.concatenate([tgt[:, 1:], rng.integers(3, V, (B, 1))], axis=1)
    src_len = np.concatenate([[S], rng.integers(S // 2, S + 1, B - 1)])
    tgt_len = np.concatenate([[T], rng.integers(T // 2, T + 1, B - 1)])
    spm = np.arange(S)[None, :] >= src_len[:, None]
    tpm = np.arange(T)[None, :] >= tgt_len[:, None]
    src[spm] = vocab.pad_index
    tgt[tpm] = vocab.pad_index
    tout[tpm] = vocab.pad_index
    batch = {"input": src, "target_in": tgt, "target_out": tout,
             "input_pad_mask": spm, "target_pad_mask": tpm}
    real = int(src_len.sum() + tgt_len.sum())
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}, real


def train_steps(dev, vocab, tables, batch, fused: bool = False, flash: bool = False):
    """TRAIN_STEPS lean train steps of the seeded flagship (bf16, dropout
    0.1) on one batch, with ``fused_attn_train`` or ``flash_training``; every
    count at 0 just before them.  Returns (losses, ms a step over the steps
    after the first TRAIN_WARM, the counts, the step function and the
    attention blocks a step)."""
    torch.manual_seed(0)
    model = build_model(vocab.vocab_size, dropout=0.1, dtype=torch.bfloat16,
                        fused_attn_train=fused, flash_training=flash).to(dev)
    per_step = len(model.encoder_layers) + 2 * len(model.decoder_layers)
    state = TrainState.create(model, lr=ExperimentConfig().lr)
    step = make_train_step(model, tables, with_metrics=False)
    gen = torch.Generator(device=dev).manual_seed(1)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    losses = []
    reset_counts()
    for i in range(TRAIN_STEPS):
        if i == TRAIN_WARM:
            start.record()
        state, m = step(state, batch, 1.0, gen)
        losses.append(m["loss"])
    end.record()
    torch.cuda.synchronize()
    got = counts()
    ms = start.elapsed_time(end) / (TRAIN_STEPS - TRAIN_WARM)
    return (torch.stack(losses).float().tolist(), ms, got, (lambda: step(state, batch, 1.0, gen)),
            per_step)


def phase_train(dev):
    """20 train steps of the flagship at 8 x 640 + 384 through the
    dropout-attention kernels, then the same steps on the default path."""
    vocab = WordVocab(ExperimentConfig().vocab_mode, ExperimentConfig().control_list)
    tables = build_loss_tables(vocab)
    batch, real = train_batch(vocab, dev)
    padded = TRAIN_B * (TRAIN_SRC + TRAIN_TGT)
    out = {}
    for fused in (True, False):
        tag = "fused_attn_train" if fused else "default path"
        losses, ms, got, again, per_step = train_steps(dev, vocab, tables, batch, fused)
        say(f"  {tag}: losses " + ", ".join(f"{x:.4f}" for x in losses))
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"{tag}: the loss is not finite or did not fall over "
                                 f"{TRAIN_STEPS} steps: {losses}")
        say(f"  {tag}: launches {got}")
        if fused:  # 12 a step at the flagship's 4 + 4 layers
            want = per_step * TRAIN_STEPS
            if got["ta_fwd"] != want or got["ta_bwd"] != want or any(
                    v for k, v in got.items() if k not in ("ta_fwd", "ta_bwd")):
                raise AssertionError(f"{tag}: expected {want} forward and {want} backward kernel "
                                     f"launches and nothing else, got {got}")
        elif any(got.values()):
            raise AssertionError(f"the default train path launched a port kernel or twin: {got}")
        split, host_top, dev_top = profiled(again, iters=5, top=12)
        say(f"  {tag}: {ms:.3f} ms a step (CUDA events, steps {TRAIN_WARM + 1}-{TRAIN_STEPS}), "
            f"{1e3 * padded / ms:.0f} tokens/s padded ({padded} a step), "
            f"{1e3 * real / ms:.0f} real ({real})")
        say_split(split, ms)
        for name, us, n in dev_top:
            say(f"      {us:9.1f} us a step in {n:6.1f} launches: {name[:110]}")
        say("    host ops by self CPU time (5 steps):")
        for name, us, n in host_top[:8]:
            say(f"      {us / 5:9.1f} us a step in {n / 5:6.1f} calls: {name[:110]}")
        out[fused] = dict(ms=ms, losses=losses, launches=got, split=split)
    say(f"  step: fused_attn_train {out[True]['ms']:.3f} ms, default {out[False]['ms']:.3f} ms "
        f"({out[True]['ms'] / out[False]['ms']:.2f}x)")
    return out


def phase_flash_train(dev):
    """TRAIN_STEPS flagship train steps with ``flash_training`` at 8 x 640 +
    384 and at 8 x 2048 + 512: 12 forward and 12 backward flash-train
    launches a step and nothing else, a finite falling loss, ms a step,
    tokens/s and the busy share.  Then at 8 x 2048 + 512 one step's loss and
    gradients with ``remat`` against one without, from one generator state,
    and the peak memory of each.  Returns {(S, T): report} and the remat
    report."""
    vocab = WordVocab(ExperimentConfig().vocab_mode, ExperimentConfig().control_list)
    tables = build_loss_tables(vocab)
    out = {}
    for S, T in ((TRAIN_SRC, TRAIN_TGT), (TRAIN_LONG_SRC, TRAIN_LONG_TGT)):
        batch, real = train_batch(vocab, dev, S=S, T=T)
        padded = TRAIN_B * (S + T)
        tag = f"flash_training at {TRAIN_B} x {S} + {T}"
        losses, ms, got, again, per_step = train_steps(dev, vocab, tables, batch, flash=True)
        say(f"  {tag}: losses " + ", ".join(f"{x:.4f}" for x in losses))
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"{tag}: the loss is not finite or did not fall over "
                                 f"{TRAIN_STEPS} steps: {losses}")
        say(f"  {tag}: launches {got}")
        want = per_step * TRAIN_STEPS  # 12 a step at the flagship's 4 + 4 layers
        if got["ft_fwd"] != want or got["ft_bwd"] != want or any(
                v for k, v in got.items() if k not in ("ft_fwd", "ft_bwd")):
            raise AssertionError(f"{tag}: expected {want} forward and {want} backward flash-train "
                                 f"launches and nothing else, got {got}")
        split, _, dev_top = profiled(again, iters=5, top=8)
        say(f"  {tag}: {ms:.3f} ms a step (CUDA events, steps {TRAIN_WARM + 1}-{TRAIN_STEPS}), "
            f"{1e3 * padded / ms:.0f} tokens/s padded ({padded} a step), "
            f"{1e3 * real / ms:.0f} real ({real})")
        say_split(split, ms)
        for name, us, n in dev_top:
            say(f"      {us:9.1f} us a step in {n:6.1f} launches: {name[:110]}")
        out[(S, T)] = dict(ms=ms, losses=losses, launches=got, split=split)
        del again
        torch.cuda.empty_cache()
    return out, flash_remat_step(dev, vocab, tables)


def flash_remat_step(dev, vocab, tables):
    """One step's loss and gradients of the flash_training flagship at 8 x
    2048 + 512 with ``remat`` and without, the same weights and generator
    state: equal within 1e-6 relative norm (the kernels take no atomics, so
    the recompute gives the same bits); the peak memory of each."""
    batch, _ = train_batch(vocab, dev, S=TRAIN_LONG_SRC, T=TRAIN_LONG_TGT)
    torch.manual_seed(0)
    base = build_model(vocab.vocab_size, dropout=0.1, dtype=torch.bfloat16, flash_training=True)
    weights = base.state_dict()
    res = {}
    for remat in (False, True):
        model = build_model(vocab.vocab_size, dropout=0.1, dtype=torch.bfloat16, flash_training=True,
                            remat=remat).to(dev)
        model.load_state_dict(weights)
        gen = torch.Generator(device=dev).manual_seed(3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        logits, _ = _forward_batch(model, batch, False, gen)
        loss, _ = multihead_ce(logits, batch["target_out"], tables, 1.0)
        loss.backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        res[remat] = dict(loss=loss.item(), peak=peak, launches=counts(), gen=gen.get_state(),
                          grads={n: p.grad.detach().float().clone() for n, p in model.named_parameters()})
        del model, logits, loss
        torch.cuda.empty_cache()
    a, b = res[False], res[True]
    loss_rel = abs(a["loss"] - b["loss"]) / abs(a["loss"])
    grad_rel = max(rel_norm(b["grads"][n], a["grads"][n]) for n in a["grads"])
    say(f"  remat at {TRAIN_B} x {TRAIN_LONG_SRC} + {TRAIN_LONG_TGT}: loss {a['loss']:.6f} without, "
        f"{b['loss']:.6f} with (relative {loss_rel:.2e}); worst gradient relative norm {grad_rel:.2e}; "
        f"peak memory {a['peak'] / 2**30:.3f} GiB without, {b['peak'] / 2**30:.3f} GiB with; "
        f"flash-train launches without {a['launches']['ft_fwd']}+{a['launches']['ft_bwd']}, with "
        f"{b['launches']['ft_fwd']}+{b['launches']['ft_bwd']}")
    if not (loss_rel <= 1e-6 and grad_rel <= 1e-6 and torch.equal(a["gen"], b["gen"])):
        raise AssertionError(f"remat changes the flash_training step: loss {loss_rel:.3e}, "
                             f"gradients {grad_rel:.3e}, generator equal {torch.equal(a['gen'], b['gen'])}")
    return dict(peak=a["peak"], peak_remat=b["peak"], loss_rel=loss_rel, grad_rel=grad_rel)


def phase_trainer(dev, workdir, flash: bool = False):
    """``Trainer.run`` for 2 epochs (1 pretraining, 1 finetuning) at the
    flagship width with ``fused_attn_train``, warm-started from the
    committed snapshot, on the windows of a seeded 32-bar, 2-track score;
    then a snapshot export, and the checkpoint and the snapshot each served
    one greedy infill through v3.  With ``flash``: 1 epoch with
    ``flash_training`` and ``remat`` (its checkpoint alone served).  Returns
    the kernel launches."""
    score = make_score(bars=32, tracks=2)
    windows = process_song(midi_to_events(score)[0])
    groups, _ = pack_windows(windows)
    say(f"  {len(windows)} windows of {[len(w) for w in windows]} tokens, {len(groups)} groups")
    out_dir = os.path.join(workdir, "flash_train_run" if flash else "train_run")
    if flash:
        opts = dict(epochs=1, pretraining_epochs=1, flash_training=True, remat=True)
    else:
        opts = dict(epochs=2, pretraining_epochs=1, fused_attn_train=True)
    cfg = dataclasses.replace(ExperimentConfig(), output_dir=out_dir, print_every=1,
                              resume_from=default_flagship_snapshot(), **opts)
    trainer = Trainer(cfg, device=dev)
    reset_counts()
    t = time.perf_counter()
    trainer.run(groups, groups)
    torch.cuda.synchronize()
    got = counts()
    steps = trainer.state.step
    per_step = len(trainer.model.encoder_layers) + 2 * len(trainer.model.decoder_layers)
    say(f"  Trainer.run: {cfg.epochs} epochs, {steps} steps in {time.perf_counter() - t:.2f} s; "
        f"launches {got}")
    fwd, bwd = ("ft_fwd", "ft_bwd") if flash else ("ta_fwd", "ta_bwd")
    # under remat every layer's forward runs again in the backward pass; the
    # validation passes (no gradients) launch forwards alone
    if flash:
        ok = steps >= 1 and got[bwd] == per_step * steps and got[fwd] >= 2 * got[bwd]
    else:
        ok = steps >= 2 and got[fwd] == per_step * steps and got[bwd] == per_step * steps
    if not ok or any(v for k, v in got.items() if k not in (fwd, bwd)):
        raise AssertionError(f"Trainer.run did not launch the {fwd}/{bwd} kernels on every one of its "
                             f"{steps} steps alone: {got}")
    latest = latest_checkpoint(os.path.join(out_dir, cfg.checkpoint_dir))
    last = f"checkpoint_{cfg.epochs - 1}"
    if latest is None or not latest.endswith(last):
        raise AssertionError(f"Trainer.run wrote no {last} ({latest})")
    _, epoch, loss = restore_checkpoint(latest, trainer.state)
    say(f"  restored {latest}: epoch {epoch}, valid loss {loss:.4f}")
    vocab = trainer.vocab
    if flash:
        del trainer
        model, ep = load_inference_model(cfg, vocab.vocab_size, latest, torch.bfloat16, device=dev)
        engine = InfillEngine(model, vocab, greedy=True, nucleus_p=None, max_tgt_len=L, seed=0)
        reqs = [engine.prepare(served_events(make_score(), vocab), [0], [2, 3])]
        serve_path(engine, reqs, workdir, "flash_trained_", ["v3"])
        say(f"  served {latest} (epoch {ep}) through v3")
        return got
    snap = os.path.join(workdir, "trained.msgpack")
    export_params_msgpack(snap, trainer.model.state_dict(), meta={
        "epoch": epoch, "final_norm": True, "vocab_size": vocab.vocab_size,
        "vocab_mode": cfg.vocab_mode})
    del trainer
    events = served_events(make_score(), vocab)
    for what in (latest, snap):
        model, ep = load_inference_model(cfg, vocab.vocab_size, what, torch.bfloat16, device=dev)
        engine = InfillEngine(model, vocab, greedy=True, nucleus_p=None, max_tgt_len=L, seed=0)
        reqs = [engine.prepare(events, [0], [2, 3])]
        serve_path(engine, reqs, workdir, f"trained_{os.path.basename(what)}_", ["v3"])
        say(f"  served {what} (epoch {ep}) through v3")
    return got


EVAL_FILES = 6  # seeded 16-bar, 3-track scores phase 6 builds its split from
EVAL_KEYS = {"control", "n", "mean_abs_diff", "failures", "diffs"}


def eval_results(path: str, kinds) -> dict:
    """``eval_cli``'s JSON: every kind asked for with the keys and counts of
    JAX's schema, the time stats, and at least one measured diff."""
    with open(path) as fh:
        results = json.load(fh)
    if set(results) != set(kinds) | {"time_stats"}:
        raise AssertionError(f"eval_cli wrote {sorted(results)} for the kinds {kinds}")
    for k in kinds:
        r = results[k]
        if not EVAL_KEYS <= set(r) or r["n"] != len(r["diffs"]) or any(d < 0 for d in r["diffs"]):
            raise AssertionError(f"eval_cli's {k} entry is malformed: {str(r)[:300]}")
    ts = results["time_stats"]
    if len(ts["time_correct_list"]) != len(ts["failed_times_list"]):
        raise AssertionError(f"time_stats lists differ in length: {ts}")
    if not any(results[k]["n"] >= 1 for k in kinds):
        raise AssertionError(f"eval_cli measured no diff: {results}")
    for k in kinds:
        say(f"    {k}: n {results[k]['n']}, mean |set - achieved| {results[k]['mean_abs_diff']}, "
            f"failures {results[k]['failures']}")
    say(f"    time stats: mean corrections {ts['mean_corrections']}, failed rate {ts['failed_rate']} "
        f"over {len(ts['time_correct_list'])} entries")
    return results


def eval_leg(dev, tag, argv, out, kinds, on, plain=None):
    """``eval_cli.main(argv)`` with every count at 0 just before it: the
    JSON holds, and the run launched the kernels ``on`` alone (none: only
    the plain loop ran).  ``plain`` (a dict) collects the plain-loop
    decodes: each forced decode's output must begin with its forced prefix.
    Returns the leg's wall seconds."""
    inner = InfillDecoder.__call__

    def settle_call(dec, *a, **kw):
        t = time.perf_counter()
        res = inner(dec, *a, **kw)
        if dec.fused:
            return res
        torch.cuda.synchronize()
        plain["s"] += time.perf_counter() - t
        plain["decodes"] += 1
        plain["steps"] += res.steps
        if kw.get("forced") is not None:
            # the prefix's closing m_0 ends the session (0, not m_0) when it
            # closes the last span: the replay that materialises a substitution
            n = int(np.asarray(kw["forced_len"])[0])
            m = min(n, int(res.lengths[0]))
            if m < n - 1 or not np.array_equal(res.tokens[0, :m].cpu().numpy(), np.asarray(kw["forced"])[0, :m]):
                raise AssertionError(f"{tag}: a settle decode does not begin with its forced prefix")
            plain["forced"] += 1
        return res

    reset_counts()
    t = time.perf_counter()
    with mock.patch.object(InfillDecoder, "__call__", settle_call) if plain is not None \
            else contextlib.nullcontext():
        rc = eval_cli.main([*argv, "--output", out, "--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if rc != 0:
        raise RuntimeError(f"eval_cli ({tag}) returned {rc}")
    say(f"  eval_cli {tag}: {wall:.2f} s")
    eval_results(out, kinds)
    check_counts(f"eval_cli ({tag})", on)
    return wall


def phase_eval(dev, workdir):
    """Phase 6: the controllability evaluation on the card, on the committed
    snapshot (``eval_cli``, ``data/build_cli``, ``generate_cli
    --correct_controls``).  Returns {leg: wall seconds}."""
    root = os.path.dirname(os.path.abspath(__file__))
    snapshot = default_flagship_snapshot()
    walls = {}
    # 6a: a packed split built by build_cli in a process of its own, its
    # SMER tokenization on the native core
    midi_dir, data_dir = os.path.join(workdir, "eval_midi"), os.path.join(workdir, "eval_data")
    os.makedirs(midi_dir)
    for i in range(EVAL_FILES):
        make_score(seed=40 + i).write(os.path.join(midi_dir, f"s{i}.mid"))
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "smer_music_generation_tpu_torch.data.build_cli",
                           "-i", midi_dir, "-o", data_dir, "--pack"],
                          capture_output=True, text=True, timeout=300, cwd=root)
    walls["6a"] = time.perf_counter() - t
    with open(os.path.join(data_dir, "build.log")) as fh:
        log = fh.read()
    for line in log.splitlines():
        print("   ", line, flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"build_cli exited with {proc.returncode}:\n{proc.stderr[-3000:]}")
    m = re.search(r"native tokenizer: loaded (\S+); tokenized (\d+) tracks", log)
    if m is None or int(m.group(2)) == 0 or native.load_library() is None:
        raise AssertionError(f"build_cli did not tokenize on the native core ({native.BUILD_INFO})")
    split = os.path.join(data_dir, "smer_test")
    n_windows = sum(len(g) for g in load_batches(split)[0])
    say(f"  6a build_cli --pack: {walls['6a']:.2f} s, {n_windows} test windows; the native core "
        f"{native.BUILD_INFO['path']} (loaded in {native.BUILD_INFO['seconds']:.2f} s here)")
    base = ["--checkpoint", snapshot, "--test_batches", split, "--seed", "0"]
    kinds = ["tensile", "density", "occupation", "polyphony"]

    # 6b: one run_batch decode a (window, kind), the v3 kernels as graph replays
    walls["6b"] = eval_leg(dev, "--max_time_fix_attempts 0 --max_windows 2",
                           [*base, "--max_time_fix_attempts", "0", "--max_windows", "2"],
                           os.path.join(workdir, "eval_6b.json"), kinds, ["v3"])
    caps, reps = dg.DecodeGraph.captures, dg.DecodeGraph.replays
    got = counts()
    say(f"  6b: {caps} graph captures, {reps} replays, v3 launches {got['v3']}")
    if reps == 0 or got["v3"] != reps + caps:
        raise AssertionError(f"6b: the evaluation's decodes were not v3 graph replays: {caps} captures, "
                             f"{reps} replays, launches {got}")

    # 6c, 6d: the settle loop on the plain forced-prefix loop, no port kernel
    for leg, extra in (("6c", ["--max_time_fix_attempts", "2"]),
                       ("6d", ["--max_time_fix_attempts", "1", "--correct_controls"])):
        plain = dict(s=0.0, decodes=0, forced=0, steps=0)
        walls[leg] = eval_leg(dev, " ".join(["--kinds tensile --max_windows 1", *extra]),
                              [*base, "--kinds", "tensile", "--max_windows", "1", *extra],
                              os.path.join(workdir, f"eval_{leg}.json"), ["tensile"], [], plain)
        if plain["decodes"] == 0:
            raise AssertionError(f"{leg}: no decode ran on the plain loop")
        say(f"  {leg}: {plain['decodes']} plain-loop decodes ({plain['forced']} with a forced prefix, "
            f"each beginning with it), {plain['steps']} steps, {1e3 * plain['s'] / max(plain['steps'], 1):.3f} "
            f"ms a token (the encode included), {plain['s']:.2f} s of decode")

    # 6e: the post-hoc rewrite through run_batch, v3 graph replays
    midi_in, midi_out = os.path.join(workdir, "eval_in.mid"), os.path.join(workdir, "eval_cc.mid")
    make_score().write(midi_in)
    reset_counts()
    t = time.perf_counter()
    rc = generate_cli.main(["-i", midi_in, "-o", midi_out, "--bars", "3", "4", "--tracks", "1",
                            "--greedy", "--correct_controls", "--device", str(dev)])
    torch.cuda.synchronize()
    walls["6e"] = time.perf_counter() - t
    if rc != 0 or not read_midi(midi_out).instruments:
        raise AssertionError(f"generate_cli --correct_controls returned {rc} or wrote no readable MIDI")
    say(f"  6e generate_cli --correct_controls (greedy, bars 3-4 of track 1): {walls['6e']:.2f} s")
    check_counts("generate_cli --correct_controls", ["v3"])
    if dg.DecodeGraph.replays == 0:
        raise AssertionError("6e: the decode did not run as graph replays")
    say("  phase 6 legs (s): " + ", ".join(f"{k} {v:.2f}" for k, v in walls.items()))
    return walls


def trained_flagship(dev):
    """The committed trained snapshot in bf16 on the card, with the score
    and the served events of phase 3 (for a run of some phases alone)."""
    cfg = ExperimentConfig()
    vocab = WordVocab(cfg.vocab_mode, cfg.control_list)
    model, _ = load_inference_model(cfg, vocab.vocab_size, default_flagship_snapshot(), torch.bfloat16,
                                    device=dev)
    score = make_score()
    return model, vocab, score, served_events(score, vocab)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Smoke test of the PyTorch port on one GPU.")
    parser.add_argument("--phases", default=None,
                        help="comma-separated phases to run after the build (2..2j, 3, 3c, 3d, 6, 5, 5c, 4); "
                        "default all, with the result lines")
    args = parser.parse_args(argv)
    only = None if args.phases is None else set(args.phases.split(","))

    def run(phase: str) -> bool:
        return only is None or phase in only

    faulthandler.dump_traceback_later(TIME_LIMIT_S, exit=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(f"phase 0 card: {card}")
    print(card, flush=True)

    say("phase 1 build")
    ds.load_library()
    say(f"  built {ds.BUILD_INFO['path']} in {ds.BUILD_INFO['seconds']:.1f} s")
    for line in str(ds.BUILD_INFO["log"]).splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("   ", line.strip(), flush=True)
    phase_tensor_cores()
    phase_decode_facts()

    vocab, model, packed, vpad = random_flagship(dev)
    remi_vocab, remi_model, remi_packed, _ = random_flagship(dev, mode=1)
    if run("2"):
        say("phase 2 v2 kernel vs twin (random bf16 weights, flagship width)")
        worst, report = phase_kernel_vs_twin(dev, packed, vocab, vpad)
        say(f"  all cases within atol {ATOL} + rtol {RTOL}; max |kernel - twin| {worst:.3e}")

    if run("2h"):
        say("phase 2h decode kernels alone: rowvec_kernel (and its LN tail) and attend_kernel at "
            "the served shapes")
        phase_decode_kernels(dev, packed, model, vpad)

    if run("2b"):
        say("phase 2b v3 kernel vs twin (same model, random states)")
        worst3, report3 = phase_token_vs_twin(dev, packed, vocab, vpad)
        say("phase 2b REMI: v3 kernel vs twin on a REMI-vocab flagship (random weights)")
        worst3 = max(worst3, phase_token_vs_twin(dev, remi_packed, remi_vocab, vpad, Bs=(1, 3, 8),
                                                 Ss=(1536,), indices=(0, 512))[0])

    if run("2c"):
        say("phase 2c v4 kernel vs twin and vs v3 x T_chunk (SMER and REMI, random states)")
        worst4, report4 = phase_tokens_vs_twin(
            dev, [(vocab, packed, vpad), (remi_vocab, remi_packed, vpad)])

    if run("2d"):
        say("phase 2d int8 weights: rowvec_int8, v2, v3, v4 against their twins")
        worst8, report8, report3_int8 = phase_int8(dev, model, vocab, vpad)

    if run("2e"):
        say("phase 2e verify kernel vs twin and vs W sequential v2 steps (SMER and REMI)")
        worst_v, report_v = phase_verify_vs_twin(
            dev, [(vocab, packed, vpad), (remi_vocab, remi_packed, vpad)])

    if run("2i"):
        say("phase 2i the v3 token and the v4 chunk as CUDA-graph replays vs the eager wrappers "
            "(whole decodes, SMER and REMI, int8)")
        graph = phase_graph_vs_eager(dev, [(vocab, packed, vpad), (remi_vocab, remi_packed, vpad)],
                                     ds.pack_decoder_weights(model, vpad, quant="int8"))
    del model, packed, remi_model, remi_packed

    if run("2f"):
        say("phase 2f fused_attention vs twin (and SDPA as the yardstick)")
        say_clocks("before 2f")
        worst_a, report_a = phase_attention_vs_twin(dev)
        say_clocks("after 2f")

    if run("2g"):
        say("phase 2g train attention (forward and backward kernels) vs twins, keep mask vs reference")
        say_clocks("before 2g")
        worst_t, worst_t_grad, report_t = phase_train_attention_vs_twin(dev)
        say_clocks("after 2g")

    if run("2j"):
        say("phase 2j flash-train kernels (forward; dq, dk/dv) vs twins, SDPA as the yardstick")
        say_clocks("before 2j")
        worst_f, worst_f_grad, worst_f_dv, report_f = phase_flash_train_vs_twin(dev)
        say_clocks("after 2j")

    model = None
    with tempfile.TemporaryDirectory() as workdir:
        if run("3"):
            say("phase 3 serve with the trained snapshot")
            model, vocab, score, events, launches = phase_serve(dev, workdir)
            say("phase 3 REMI: serve with the trained REMI snapshot")
            launches["v3"] += phase_serve_remi(dev, workdir)
            say("phase 3b HTTP serving (ServingContext, MicroBatcher) with the trained snapshot")
            launches["v3"] += phase_http(model, vocab, score)
            phase_serve_cli(score)
        if model is None and (run("3c") or run("3d") or run("4")):
            model, vocab, score, events = trained_flagship(dev)
        if run("3c"):
            say(f"phase 3c speculative decode (draft_k={SPEC_K}) served with the trained snapshot")
            launches_v, spec = phase_spec(model, vocab, events, score, workdir)
        if run("3d"):
            say("phase 3d flash encoder served with the trained snapshot")
            launches_a, encode_ms = phase_flash_encoder(model, vocab, events, workdir)

        if run("6"):
            say("phase 6 evaluate on the card: build_cli, eval_cli (v3 replays, span retries, "
                "in-decode controls), generate_cli --correct_controls")
            phase_eval(dev, workdir)

        if run("5"):
            say(f"phase 5 train the flagship on the card: {TRAIN_STEPS} steps at {TRAIN_B} x "
                f"{TRAIN_SRC} + {TRAIN_TGT}, fused_attn_train and the default path")
            train = phase_train(dev)
            say("phase 5b Trainer.run (2 epochs, fused_attn_train) from the snapshot, checkpoint "
                "and snapshot served through v3")
            launches_t = phase_trainer(dev, workdir)

        if run("5c"):
            say(f"phase 5c train the flagship with flash_training: {TRAIN_STEPS} steps at {TRAIN_B} x "
                f"{TRAIN_SRC} + {TRAIN_TGT} and at {TRAIN_B} x {TRAIN_LONG_SRC} + {TRAIN_LONG_TGT}, "
                "remat against none, Trainer.run with flash_training and remat")
            flash_train_steps, remat = phase_flash_train(dev)
            launches_f = {k: v for k, v in phase_trainer(dev, workdir, flash=True).items()}
            for steps5 in flash_train_steps.values():
                for k in ("ft_fwd", "ft_bwd"):
                    launches_f[k] += steps5["launches"][k]

    if run("4"):
        say("phase 4 kernel path vs twin path (greedy)")
        first_divergence(model, vocab, events, fused_sampling=False)
        first_divergence(model, vocab, events, fused_sampling=True)
        say("phase 4 int8: the v3-int8 stream against the v2-int8 stream (greedy)")
        first_divergence(model, vocab, events, fused_sampling=True, quant="int8", against_v2=True)

    if only is not None:
        say(f"done: phases {sorted(only)} only, no result lines")
        faulthandler.cancel_dump_traceback_later()
        return 0
    say(f"  v4 ms a token: T_chunk 8 {report4[8]['ms'] / 8:.4f}, T_chunk 64 "
        f"{report4[64]['ms'] / 64:.4f} (v3 {report3['ms']:.4f}); v3-int8 token "
        f"{report3_int8['ms']:.4f} ms, bound {report3_int8['bound_ms']:.5f} ms")
    say(f"  as graph replays (phase 2i): v3 token {graph['v3']['ms']:.4f} ms (eager "
        f"{graph['v3']['eager_ms']:.4f}), v4 chunk of 8 {graph['v4']['ms']:.4f} ms (eager "
        f"{graph['v4']['eager_ms']:.4f}), v3-int8 token {graph['int8']['ms']:.4f} ms (eager "
        f"{graph['int8']['eager_ms']:.4f}); captures {graph['v3']['capture_ms']:.2f}, "
        f"{graph['v4']['capture_ms']:.2f} and {graph['int8']['capture_ms']:.2f} ms")
    say(f"  verify W={SPEC_K + 1}: {report_v['ms']:.4f} ms; spec decode greedy "
        f"{spec['greedy']['ms_token']:.3f} ms a token (v3 at B=1 {spec['greedy']['v3_ms_token']:.3f}), "
        f"nucleus {spec['nucleus']['ms_token']:.3f} (v3 {spec['nucleus']['v3_ms_token']:.3f}); "
        f"fused_attention {report_a['ms']:.4f} ms vs SDPA {report_a['library_ms']:.4f} ms; "
        f"encode plain {encode_ms['plain']:.4f} ms, flash {encode_ms['flash']:.4f} ms")
    say(f"  train step at {TRAIN_B} x {TRAIN_SRC} + {TRAIN_TGT}: fused_attn_train {train[True]['ms']:.3f} ms, "
        f"default {train[False]['ms']:.3f} ms; train-attention forward "
        f"{report_t[(640, 640)][0]['ms']:.4f} ms, backward {report_t[(640, 640)][1]['ms']:.4f} ms at 640 x 640")
    long_ = report_f[FT_TIMED[-1]]
    say(f"  flash_training step: {flash_train_steps[(TRAIN_SRC, TRAIN_TGT)]['ms']:.3f} ms at {TRAIN_B} x "
        f"{TRAIN_SRC} + {TRAIN_TGT}, {flash_train_steps[(TRAIN_LONG_SRC, TRAIN_LONG_TGT)]['ms']:.3f} ms at "
        f"{TRAIN_B} x {TRAIN_LONG_SRC} + {TRAIN_LONG_TGT}; peak memory {remat['peak'] / 2**30:.3f} GiB, "
        f"{remat['peak_remat'] / 2**30:.3f} with remat; flash-train forward {long_[0]['ms']:.4f} ms "
        f"(SDPA {long_[0]['library_ms']:.4f}), backward {long_[1]['ms']:.4f} ms (SDPA "
        f"{long_[1]['library_ms']:.4f}) at 2048 x 2048; dv {worst_f_dv:.2e} of the twin at worst")
    common = dict(route="cuda", bound_by="bytes", library_ms=None)
    csrc = "smer_music_generation_tpu_torch/ops/csrc/"
    ref = "smer_music_generation_tpu/ops/decode_step.py:"
    # the decoder's v3 and v4 steps are graph replays: their times are the
    # replays' at the served shape (phase 2i)
    replay3, replay4 = ({k: graph[n][k] for k in ("ms", "plain_ms", "bound_ms")} for n in ("v3", "v4"))
    kernels = {"kernels": [
        dict(name="fused_decode_step", source=csrc + "decode_step.cu", replaces=ref + "456",
             launches=launches["v2"], max_abs_err=worst, **report, **common),
        dict(name="fused_decode_token", source=csrc + "decode_token.cu", replaces=ref + "796",
             launches=launches["v3"], max_abs_err=worst3, **replay3, **common),
        dict(name="fused_decode_tokens", source=csrc + "decode_token.cu", replaces=ref + "1028",
             launches=launches["v4"], max_abs_err=worst4, **replay4, **common),
        dict(name="rowvec_int8", source=csrc + "decode_step.cu", replaces=ref + "296",
             launches=launches["int8"], max_abs_err=worst8, **report8, **common),
        dict(name="fused_verify_window", source=csrc + "decode_step.cu", replaces=ref + "1368",
             launches=launches_v, max_abs_err=worst_v, **report_v, **common),
        dict(name="fused_attention", source=csrc + "attention.cu",
             replaces="smer_music_generation_tpu/ops/attention.py:115", launches=launches_a,
             max_abs_err=worst_a, route="cuda", **report_a),
        dict(name="fused_dropout_attention_fwd", source=csrc + "train_attention.cu",
             replaces="smer_music_generation_tpu/ops/train_attention.py:111",
             launches=train[True]["launches"]["ta_fwd"] + launches_t["ta_fwd"],
             max_abs_err=worst_t, route="cuda", **report_t[(640, 640)][0]),
        dict(name="fused_dropout_attention_bwd", source=csrc + "train_attention.cu",
             replaces="smer_music_generation_tpu/ops/train_attention.py:163",
             launches=train[True]["launches"]["ta_bwd"] + launches_t["ta_bwd"],
             max_abs_err=worst_t_grad, route="cuda", **report_t[(640, 640)][1]),
        dict(name="flash_attention_train_fwd", source=csrc + "flash_train.cu",
             replaces="smer_music_generation_tpu/models/transformer.py:360 (library "
                      "jax/experimental/pallas/ops/tpu/flash_attention.py:758)",
             launches=launches_f["ft_fwd"], max_abs_err=worst_f, route="cuda",
             **report_f[FT_TIMED[-1]][0]),
        dict(name="flash_attention_train_bwd", source=csrc + "flash_train.cu",
             replaces="smer_music_generation_tpu/models/transformer.py:360 (library "
                      "jax/experimental/pallas/ops/tpu/flash_attention.py:1121 and :1456)",
             launches=launches_f["ft_bwd"], max_abs_err=worst_f_grad, route="cuda",
             **report_f[FT_TIMED[-1]][1]),
    ]}
    print(json.dumps(kernels), flush=True)
    say(f"done: the whole script took {time.perf_counter() - T0:.1f} s on {card}")
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
