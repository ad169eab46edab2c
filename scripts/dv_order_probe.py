#!/usr/bin/env python3
"""How far the train-attention keys kernel's dv is from a twin that forms
the weights in the kernels' own order, on one CUDA card, and what keeps the
attention backward kernels' dv from JAX's kernel-to-twin bound of 1e-4.

    python3 scripts/dv_order_probe.py

First it builds a probe kernel with nvcc (into ``build/dv_order_probe/``)
that writes ``exp2f(x)`` (libdevice, no fast math) and ``ex2.approx.ftz``
(the SFU instruction the kernels call) for 2^24 seeded f32 values of x in
[-60, 1], and counts where each differs from ``torch.exp2(x)`` on the card.

The backward twin (``ops/train_attention.py::_weights``) forms
``w = exp(s - m) / sum e`` with PyTorch's exp and sum; the kernels form
``e = 2^(s log2(e)/8 - m log2(e)/8)`` (one FFMA and ``ex2.approx``), sum
``l`` online over 64-key tiles (each lane of a quad over its 16 columns of a
tile, rescaled by ``alpha`` as the row max grows, the quad's four partial
sums added at the end) and divide once.  ``kernel_order_weights`` replays
that order with PyTorch's accurate ``exp2`` and float64-emulated FMAs, so
against the kernel only ``ex2.approx``'s last bits remain.  For JAX's own
gradient case and phase 2g's shapes of ``chip_smoke.py`` it prints dv's
relative norm of the kernel against the twin, of the kernel against the
kernel-order twin, and of the two twins against each other, beside JAX's
bound of 1e-4 (``tests/test_ops.py:654``), and the kernel's and the
twin's dv each against the same product summed in float64 (the twin's
bf16 weights and g), which says whether either side is the more accurate.
Last, the same readings for the flash-train backward
(``ops/flash_train.py``) at phase 2j's cases and inputs, by batch row too,
at head_dim 64 (H=8) and at head_dim 128 (H=4, d512 with nhead 4).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402
    FT_CASES, H_WIDE, HD_ATTN, HD_WIDE, TA_CASES, TA_SEEDS, TRAIN_B, H, flash_train_inputs, rel_norm,
)
from smer_music_generation_tpu_torch.ops import decode_step as ds  # noqa: E402
from smer_music_generation_tpu_torch.ops import flash_train as ft  # noqa: E402
from smer_music_generation_tpu_torch.ops import train_attention as ta  # noqa: E402

PROBE_CU = r"""
extern "C" __global__ void exp2_probe(const float* x, float* acc, float* sfu, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    acc[i] = exp2f(x[i]);
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x[i]));
    sfu[i] = y;
  }
}
extern "C" int exp2_probe_launch(const float* x, float* acc, float* sfu, int n, void* stream) {
  exp2_probe<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(x, acc, sfu, n);
  return (int)cudaGetLastError();
}
"""

LOG2E = 1.4426950408889634
TILE = 64


def fma(a, b, c):
    """a * b + c rounded once to f32 (emulated in float64)."""
    return (a.double() * b.double() + c.double()).float()


def kernel_order_weights(q, k, kv_valid, causal):
    """The f32 weights (B, H, T, S) as the rows and keys kernels form them."""
    B, T, H_, _ = q.shape
    S = k.shape[1]
    sl2 = torch.tensor(np.float32(LOG2E) * np.float32(0.125), device=q.device)
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()).to(torch.bfloat16).float()
    mask = kv_valid.to(torch.bool)[:, None, None, :].expand(B, H_, T, S)
    if causal:
        mask = mask & torch.ones(T, S, dtype=torch.bool, device=q.device).tril()[None, None]
    s = torch.where(mask, s, -torch.inf)
    pad = (-S) % TILE
    sp = torch.nn.functional.pad(s, (0, pad), value=-torch.inf)
    m = torch.full((B, H_, T), -1e30, device=q.device)
    lanes = torch.zeros(B, H_, T, 4, device=q.device)
    for k0 in range(0, S + pad, TILE):
        st = sp[..., k0:k0 + TILE]
        m_new = torch.maximum(m, st.amax(-1).clamp(min=-1e30))
        alpha = torch.exp2((m - m_new) * sl2)
        e = torch.exp2(fma(st, sl2, -(m_new * sl2)[..., None]))
        pairs = e.view(B, H_, T, TILE // 8, 4, 2).sum(-1)  # ea + eb, lane t of n-block j
        acc = torch.zeros_like(lanes)
        for j in range(TILE // 8):
            acc = acc + pairs[..., j, :]
        lanes = fma(lanes, alpha[..., None], acc)
        m = m_new
    l = (lanes[..., 0] + lanes[..., 1]) + (lanes[..., 2] + lanes[..., 3])
    e = torch.exp2(fma(s, sl2, -(m * sl2)[..., None]))
    return e / l.clamp(min=1e-30)[..., None]


def exp2_probe(dev) -> None:
    out_dir = Path(__file__).resolve().parents[1] / "build" / "dv_order_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "exp2_probe.cu", out_dir / "libexp2_probe.so"
    src.write_text(PROBE_CU)
    subprocess.run([ds._nvcc(), *ds.NVCC_FLAGS, "-shared", "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    p = ctypes.c_void_p
    lib.exp2_probe_launch.argtypes = [p, p, p, ctypes.c_int, p]
    n = 1 << 24
    x = -60.0 + 61.0 * torch.rand(n, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    acc, sfu = torch.empty_like(x), torch.empty_like(x)
    ds._check(lib.exp2_probe_launch(x.data_ptr(), acc.data_ptr(), sfu.data_ptr(), n,
                                    torch.cuda.current_stream(dev).cuda_stream), "exp2_probe")
    want = torch.exp2(x)
    torch.cuda.synchronize()
    print(f"exp2 probe over {n} values in [-60, 1]: exp2f differs from torch.exp2 on "
          f"{int((acc != want).sum())}, ex2.approx.ftz on {int((sfu != want).sum())}", flush=True)


def twin_dv(w, g, seed, rate, B, H_, T, S, device, dtype=torch.float32):
    """dv = bf16(w)^T g (after dropout) with the products summed in
    ``dtype``, rounded to bf16."""
    keep = ta.dropout_mask_reference(seed, B, H_, T, S, rate, device=device) if rate > 0.0 else None
    wd16 = ta._dropped(w.to(torch.bfloat16), keep, rate)
    return torch.einsum("bhts,bthd->bshd", wd16.to(dtype), g.to(dtype)).to(torch.bfloat16)


def probe(label, q, k, v, valid, seed, g, rate, causal):
    B, T, H_, _ = q.shape
    S = k.shape[1]
    dv_kernel = ta.dropout_attention_bwd(q, k, v, valid, seed, g, rate, causal)[2]
    dv_twin = ta.dropout_attention_bwd_reference(q, k, v, valid, seed, g, rate, causal)[2]
    dv_order = twin_dv(kernel_order_weights(q, k, valid, causal), g, seed, rate, B, H_, T, S, q.device)
    dv_f64 = twin_dv(ta._weights(q, k, valid, causal)[0], g, seed, rate, B, H_, T, S, q.device,
                     torch.float64)
    r = (rel_norm(dv_kernel, dv_twin), rel_norm(dv_kernel, dv_order), rel_norm(dv_twin, dv_order),
         rel_norm(dv_kernel, dv_f64), rel_norm(dv_twin, dv_f64))
    print(f"{label}: dv relative norm kernel-twin {r[0]:.3e}, kernel-kernel_order_twin {r[1]:.3e}, "
          f"twin-kernel_order_twin {r[2]:.3e}; against the float64 sum: kernel {r[3]:.3e}, twin "
          f"{r[4]:.3e}", flush=True)
    return r


def flash_probe(dev, heads: int = H, hd: int = HD_ATTN) -> None:
    """The flash-train backward's dv at phase 2j's cases, on its inputs
    (``chip_smoke.FT_CASES`` from one generator seeded 23, as 2j draws
    them at head_dim 64): against the twin and, each, against bf16(p)^T g
    summed in float64 (the twin's p, the kernel's forward), whole and by
    batch row."""
    gen = torch.Generator(device=dev).manual_seed(23)
    for T, S, causal in FT_CASES:
        q, k, v, go, valid = flash_train_inputs(gen, dev, T, S, heads, hd)
        out, stats = ft.flash_train_fwd(q, k, v, valid, causal)
        dv_kernel = ft.flash_train_bwd(q, k, v, valid, out, stats, go, causal)[2]
        dv_twin = ft.flash_train_bwd_reference(q, k, v, valid, out, stats, go, causal)[2]
        B, T = q.shape[:2]
        s = ft._masked_scores(q, k, valid, causal)
        m, l = (x.reshape(B, heads, T, 1) for x in stats)
        p16 = (ft._exp(s - m) * (1.0 / l)).to(torch.bfloat16)
        del s
        dv_f64 = torch.einsum("bhts,bthd->bshd", p16.double(), go.double()).to(torch.bfloat16)
        rows = ", ".join(f"{rel_norm(dv_kernel[b], dv_twin[b]):.1e}" for b in range(B))
        print(f"flash-train head_dim {hd} T={T} S={S} causal={causal}: dv relative norm kernel-twin "
              f"{rel_norm(dv_kernel, dv_twin):.3e} (by batch row {rows}); against the float64 sum: "
              f"kernel {rel_norm(dv_kernel, dv_f64):.3e}, twin {rel_norm(dv_twin, dv_f64):.3e}",
              flush=True)
        diff = (dv_kernel.float() - dv_twin.float()).abs()
        worst_at = torch.topk(diff.flatten(), 3).indices
        for flat in worst_at.tolist():
            b_, key, h_, d_ = np.unravel_index(flat, dv_kernel.shape)
            col = p16[b_, h_, :, key].float()
            print(f"    dv[{b_}, {key}, {h_}, {d_}]: kernel {dv_kernel[b_, key, h_, d_].item():.6g}, twin "
                  f"{dv_twin[b_, key, h_, d_].item():.6g}, float64 {dv_f64[b_, key, h_, d_].item():.6g}; "
                  f"key valid {bool(valid[b_, key])}, rows with p > 0: {int((col > 0).sum())}, max p "
                  f"{col.max().item():.4g} at row {int(col.argmax())}", flush=True)
        del q, k, v, go, out, p16
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("dv_order_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    exp2_probe(dev)
    # JAX's own case (chip_smoke.train_attention_jax_case): sum(out^2), so g = 2 out
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, n, 2, 64))).to(dev).to(torch.bfloat16)
               for n in (256, 512, 512))
    valid = torch.from_numpy(rng.random((2, 512)) < 0.9).to(dev).to(torch.int32)
    out = ta.dropout_attention_fwd(q, k, v, valid, (0, 5), 0.1, False)
    worst_jax = probe("JAX's case B=2 T=256 S=512 H=2 rate 0.1", q, k, v, valid, (0, 5),
                      (2 * out.float()).to(torch.bfloat16), 0.1, False)
    # phase 2g's shapes at B=8, H=8, rate 0.1 and 0, its first seed
    gen = torch.Generator(device=dev).manual_seed(17)
    worst = [0.0] * 5
    for T, S, causal in TA_CASES:
        q = torch.randn(TRAIN_B, T, H, HD_ATTN, generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn(TRAIN_B, S, H, HD_ATTN, generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        g = torch.randn(TRAIN_B, T, H, HD_ATTN, generator=gen, device=dev).to(torch.bfloat16)
        valid = (torch.rand(TRAIN_B, S, generator=gen, device=dev) >= 0.1).to(torch.int32)
        valid[1] = 0
        for rate in (0.1, 0.0):
            r = probe(f"T={T} S={S} causal={causal} rate={rate}", q, k, v, valid, TA_SEEDS[0], g, rate,
                      causal)
            worst = [max(a, b) for a, b in zip(worst, r)]
    print(f"worst over phase 2g's shapes: kernel-twin {worst[0]:.3e}, kernel-kernel_order_twin "
          f"{worst[1]:.3e}, twin-kernel_order_twin {worst[2]:.3e}, kernel-float64 {worst[3]:.3e}, "
          f"twin-float64 {worst[4]:.3e}; JAX's case kernel-kernel_order_twin {worst_jax[1]:.3e} "
          f"(JAX's bound 1e-4) on {card}", flush=True)
    flash_probe(dev)
    flash_probe(dev, H_WIDE, HD_WIDE)
    return 0


if __name__ == "__main__":
    sys.exit(main())
