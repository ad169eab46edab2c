"""One decoder step (v2) through hand-written CUDA kernels, plus its plain twin.

Port of ``smer_music_generation_tpu/ops/decode_step.py``: the packers
``pack_decoder_weights`` (:66), ``stack_kv_cache`` (:154) and ``vocab_pad``
(:551), and the TPU kernel ``fused_decode_step`` (:456), which becomes the
kernel set in ``csrc/decode_step.cu``.

``fused_decode_step`` keeps the JAX signature and returns
``(logits (B, vpad) f32, new_kv (n_layers, B, 2D))``.  A tensor on the CPU
goes to :func:`fused_decode_step_reference`, the same math in plain torch; a
CUDA tensor launches the kernels or raises.  There is no fallback from one
to the other.  The kernels are built at first use with ``nvcc`` into
``build/torch_kernels/`` (named by the source's hash) and bound with
``ctypes``; nothing is built when this module is imported.

Layouts follow the JAX packer: every packed weight keeps the flax
``(in, out)`` layout, K and V of a cache row are interleaved as lanes
``[0:D) = K`` and ``[D:2D) = V``.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

LN_EPS = 1e-6
_SRC = Path(__file__).resolve().parent / "csrc" / "decode_step.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def vocab_pad(vocab_size: int) -> int:
    return ((vocab_size + 127) // 128) * 128


def pack_decoder_weights(model, vpad: int, quant: str = "none") -> Dict[str, torch.Tensor]:
    """Stack per-layer decoder weights into layer-major packed tensors.

    Same layout as the JAX packer (D = d_model, F = d_ff), on the model's
    device, with the matrices in the model's compute dtype:

      w_attn (nl, D, 6D): [W_q | W_k | W_v | W_self_out | W_cross_q | W_cross_out]
      bias   (nl, 1, 7D + F) f32:
             [b_qkv (3D) | b_self_out | b_cross_q | b_cross_out | b_ff1 (F) | b_ff2]
      ln     (nl, 6, D) f32: norm{1,2,3} x {scale, bias}
      w_ff1  (nl, D, F), w_ff2 (nl, F, D)
      fin_ln (2, D) f32 when the model has ``norm_d``
      fc_w   (D, vpad) f32, fc_b (vpad,) f32, padded slots biased to -1e9

    torch ``Linear.weight`` is (out, in); it is transposed here back to
    the flax (in, out) layout the kernels read.
    """
    if quant == "int8":
        raise NotImplementedError(
            "quant='int8' is not ported yet (ROADMAP.md Queue 2 item 5)"
        )
    if quant != "none":
        raise ValueError(f"unknown quant mode {quant!r}")
    dt = model.cfg.dtype
    layers = list(model.decoder_layers)

    def kernel(lin):
        return lin.weight.detach().t()

    with torch.no_grad():
        packed = {
            "w_attn": torch.stack([
                torch.cat(
                    [kernel(getattr(lp.self_attn, m)) for m in ("q", "k", "v", "out")]
                    + [kernel(lp.cross_attn.q), kernel(lp.cross_attn.out)],
                    dim=1,
                )
                for lp in layers
            ]).to(dt).contiguous(),
            "bias": torch.stack([
                torch.cat(
                    [getattr(lp.self_attn, m).bias for m in ("q", "k", "v", "out")]
                    + [lp.cross_attn.q.bias, lp.cross_attn.out.bias,
                       lp.ff.fc1.bias, lp.ff.fc2.bias]
                )[None, :]
                for lp in layers
            ]).float().contiguous(),
            "ln": torch.stack([
                torch.stack([
                    lp.norm1.weight, lp.norm1.bias,
                    lp.norm2.weight, lp.norm2.bias,
                    lp.norm3.weight, lp.norm3.bias,
                ])
                for lp in layers
            ]).float().contiguous(),
            "w_ff1": torch.stack([kernel(lp.ff.fc1) for lp in layers]).to(dt).contiguous(),
            "w_ff2": torch.stack([kernel(lp.ff.fc2) for lp in layers]).to(dt).contiguous(),
        }
        if model.norm_d is not None:
            packed["fin_ln"] = torch.stack(
                [model.norm_d.weight, model.norm_d.bias]
            ).float().contiguous()
        fc_w = kernel(model.fc).float()
        V = fc_w.shape[1]
        packed["fc_w"] = torch.nn.functional.pad(fc_w, (0, vpad - V)).contiguous()
        packed["fc_b"] = torch.nn.functional.pad(
            model.fc.bias.float(), (0, vpad - V), value=-1e9
        ).contiguous()
    return packed


def stack_kv_cache(cross_cache: Dict[str, Tuple[torch.Tensor, torch.Tensor]], n_layers: int) -> torch.Tensor:
    """Per-layer dict of ((B,S,H,hd), (B,S,H,hd)) -> (nl, B, S, 2D) interleaved."""
    rows = []
    for i in range(n_layers):
        k, v = cross_cache[f"layer_{i}"]
        B, S = k.shape[0], k.shape[1]
        rows.append(torch.cat([k.reshape(B, S, -1), v.reshape(B, S, -1)], dim=-1))
    return torch.stack(rows).contiguous()


# ---------------------------------------------------------------------------
# The plain twin: the kernel's math in torch (f32 softmax, LayerNorm and
# accumulation; bf16 operands stay bf16-valued)
# ---------------------------------------------------------------------------


def _layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


def _attend(q, kv, n_valid, H, extra_kv=None):
    """Softmax attention of one query row per batch element against the
    first ``n_valid[b]`` rows of an interleaved (B, L, 2D) K|V cache, plus
    an optional current row ``extra_kv = (k (B, D), v (B, D))``."""
    B, D = q.shape
    HD = D // H
    L = kv.shape[1]
    k = kv[..., :D].float().reshape(B, L, H, HD)
    v = kv[..., D:].float().reshape(B, L, H, HD)
    qh = q.reshape(B, H, HD)
    scores = torch.einsum("bhd,blhd->bhl", qh, k) / math.sqrt(HD)
    valid = torch.arange(L, device=q.device)[None, :] < n_valid[:, None]  # (B, L)
    scores = scores.masked_fill(~valid[:, None, :], -math.inf)
    v = v.masked_fill(~valid[:, :, None, None], 0.0)
    if extra_kv is not None:
        k_x, v_x = (t.reshape(B, 1, H, HD) for t in extra_kv)
        scores = torch.cat([scores, torch.einsum("bhd,blhd->bhl", qh, k_x) / math.sqrt(HD)], dim=-1)
        v = torch.cat([v, v_x], dim=1)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhl,blhd->bhd", w, v).reshape(B, D)


def fused_decode_step_reference(
    packed: Dict[str, torch.Tensor],
    x_emb: torch.Tensor,
    self_kv: torch.Tensor,
    cross_kv: torch.Tensor,
    index,
    cross_len: torch.Tensor,
    *,
    n_layers: int,
    d_model: int,
    nhead: int,
    d_ff: int,
    vpad: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of :func:`fused_decode_step`, on any device."""
    fused_decode_step_reference.calls += 1
    D, F = d_model, d_ff
    dt = packed["w_attn"].dtype
    index = int(index)
    B = x_emb.shape[0]
    n_self = torch.full((B,), index, dtype=torch.int64, device=x_emb.device)
    cross_len = cross_len.to(torch.int64)

    def mm(a, w):  # operands rounded to the weight dtype, f32 accumulation
        return a.to(dt).float() @ w.float()

    x = x_emb.float()
    new_kv = []
    for i in range(n_layers):
        w = packed["w_attn"][i]
        b = packed["bias"][i, 0]
        ln = packed["ln"][i]
        qkv = mm(x, w[:, : 3 * D]) + b[: 3 * D]
        new_kv.append(qkv[:, D:].to(self_kv.dtype))
        att = _attend(
            qkv[:, :D], self_kv[i, :, :index], n_self, nhead,
            extra_kv=(qkv[:, D : 2 * D], qkv[:, 2 * D :]),
        )
        o = mm(att, w[:, 3 * D : 4 * D]) + b[3 * D : 4 * D]
        x = _layernorm(x + o, ln[0], ln[1])
        qc = mm(x, w[:, 4 * D : 5 * D]) + b[4 * D : 5 * D]
        att = _attend(qc, cross_kv[i], cross_len, nhead)
        o = mm(att, w[:, 5 * D : 6 * D]) + b[5 * D : 6 * D]
        x = _layernorm(x + o, ln[2], ln[3])
        h = torch.relu(mm(x, packed["w_ff1"][i]) + b[6 * D : 6 * D + F])
        y = mm(h, packed["w_ff2"][i]) + b[6 * D + F :]
        x = _layernorm(x + y, ln[4], ln[5])
    if "fin_ln" in packed:
        x = _layernorm(x, packed["fin_ln"][0], packed["fin_ln"][1])
    logits = x @ packed["fc_w"] + packed["fc_b"]
    return logits, torch.stack(new_kv)


fused_decode_step_reference.calls = 0


# ---------------------------------------------------------------------------
# The CUDA kernels: build, bind, launch
# ---------------------------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA decode-step kernels cannot be built")


def build_library() -> Path:
    """Compile ``csrc/decode_step.cu`` into ``build/torch_kernels/`` unless a
    library of the same source hash is there already.  Raises with nvcc's
    stderr when the build fails."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = _BUILD_DIR / f"libsmer_decode_step_{digest}.so"
    if out.is_file():
        BUILD_INFO.setdefault("path", str(out))
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("log", "(built before this process)")
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    BUILD_INFO.update(path=str(out), seconds=time.perf_counter() - t0, log=proc.stderr)
    return out


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        i, p, f, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong
        lib.smer_rowvec.argtypes = [i, i, i, p, i, p, i, p, p, i, p, i, i, i, i, p]
        lib.smer_attend.argtypes = [i, i, i, p, i, p, ll, i, i, p, i, p, i, p, i, f, p]
        lib.smer_add_layernorm.argtypes = [i, i, p, p, p, p, p, f, p]
        for fn in (lib.smer_rowvec, lib.smer_attend, lib.smer_add_layernorm):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {rc}")


def _check_inputs(packed, x_emb, self_kv, cross_kv, cross_len, n_layers, D, H, F, vpad, index):
    dev = x_emb.device
    bf16 = torch.bfloat16
    want = {
        "x_emb": (x_emb, bf16), "self_kv": (self_kv, bf16), "cross_kv": (cross_kv, bf16),
        "cross_len": (cross_len, torch.int32),
        "w_attn": (packed["w_attn"], bf16), "w_ff1": (packed["w_ff1"], bf16),
        "w_ff2": (packed["w_ff2"], bf16), "bias": (packed["bias"], torch.float32),
        "ln": (packed["ln"], torch.float32), "fc_w": (packed["fc_w"], torch.float32),
        "fc_b": (packed["fc_b"], torch.float32),
    }
    if "fin_ln" in packed:
        want["fin_ln"] = (packed["fin_ln"], torch.float32)
    for name, (t, dtype) in want.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x_emb on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B = x_emb.shape[0]
    if not 1 <= B <= 8:
        raise ValueError(f"the CUDA decode step takes 1 <= B <= 8, got B={B}")
    if D % 64 or D // H not in (64, 128) or D % H:
        raise ValueError(f"d_model={D}, nhead={H}: need d_model % 64 == 0 and head_dim 64 or 128")
    if vpad % 2:
        raise ValueError(f"vpad={vpad} must be even")
    L, S = self_kv.shape[2], cross_kv.shape[2]
    shapes = {
        "x_emb": (x_emb.shape, (B, D)),
        "self_kv": (self_kv.shape, (n_layers, B, L, 2 * D)),
        "cross_kv": (cross_kv.shape, (n_layers, B, S, 2 * D)),
        "cross_len": (cross_len.shape, (B,)),
        "w_attn": (packed["w_attn"].shape, (n_layers, D, 6 * D)),
        "w_ff1": (packed["w_ff1"].shape, (n_layers, D, F)),
        "w_ff2": (packed["w_ff2"].shape, (n_layers, F, D)),
        "bias": (packed["bias"].shape, (n_layers, 1, 7 * D + F)),
        "ln": (packed["ln"].shape, (n_layers, 6, D)),
        "fc_w": (packed["fc_w"].shape, (D, vpad)),
        "fc_b": (packed["fc_b"].shape, (vpad,)),
    }
    for name, (got, exp) in shapes.items():
        if tuple(got) != tuple(exp):
            raise ValueError(f"{name} has shape {tuple(got)}, expected {tuple(exp)}")
    if not 0 <= index < L:
        raise ValueError(f"index={index} outside the self cache of {L} rows")


def fused_decode_step(
    packed: Dict[str, torch.Tensor],
    x_emb: torch.Tensor,  # (B, D) compute-dtype embedded token (+PE)
    self_kv: torch.Tensor,  # (n_layers, B, L, 2D) interleaved K|V
    cross_kv: torch.Tensor,  # (n_layers, B, S, 2D)
    index,  # int: number of cached self rows (= position)
    cross_len: torch.Tensor,  # (B,) int32 valid memory rows
    *,
    n_layers: int,
    d_model: int,
    nhead: int,
    d_ff: int,
    vpad: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, vpad) f32, new_kv (n_layers, B, 2D))."""
    kw = dict(n_layers=n_layers, d_model=d_model, nhead=nhead, d_ff=d_ff, vpad=vpad)
    if x_emb.device.type == "cpu":
        return fused_decode_step_reference(packed, x_emb, self_kv, cross_kv, index, cross_len, **kw)
    if x_emb.device.type != "cuda":
        raise ValueError(f"fused_decode_step runs on cuda or cpu, not {x_emb.device}")
    if "scale" in packed:
        raise NotImplementedError("int8 weights are not ported yet (ROADMAP.md Queue 2 item 5)")
    index = int(index)
    D, H, F = d_model, nhead, d_ff
    _check_inputs(packed, x_emb, self_kv, cross_kv, cross_len, n_layers, D, H, F, vpad, index)
    lib = load_library()
    B, L, S = x_emb.shape[0], self_kv.shape[2], cross_kv.shape[2]
    HD = D // H
    scale = 1.0 / math.sqrt(HD)
    stream = torch.cuda.current_stream(x_emb.device).cuda_stream
    f32 = dict(device=x_emb.device, dtype=torch.float32)

    x = x_emb.float()
    qkv = torch.empty(B, 3 * D, **f32)
    att = torch.empty(B, D, **f32)
    qc = torch.empty(B, D, **f32)
    o = torch.empty(B, D, **f32)
    h = torch.empty(B, F, **f32)
    logits = torch.empty(B, vpad, **f32)
    new_kv = torch.empty(n_layers, B, 2 * D, dtype=self_kv.dtype, device=x_emb.device)

    def rowvec(xin, w, ldw, bias, y, relu=False, kv_out=None, w_f32=False):
        K, N = xin.shape[1], y.shape[1]
        _check(lib.smer_rowvec(
            int(w_f32), int(relu), B, xin.data_ptr(), K, w.data_ptr(), ldw,
            bias.data_ptr(), y.data_ptr(), N,
            kv_out.data_ptr() if kv_out is not None else None, 2 * D, D,
            K, N, stream,
        ), "rowvec")

    def attend(q, kv, n_rows, lens, max_rows, extra, out):
        _check(lib.smer_attend(
            HD, B, H, q.data_ptr(), q.shape[1], kv.data_ptr(), max_rows * 2 * D, D,
            n_rows, lens.data_ptr() if lens is not None else None, max_rows,
            extra, 3 * D, out.data_ptr(), D, scale, stream,
        ), "attend")

    def add_ln(xin, y, gamma, beta):  # in place on xin
        _check(lib.smer_add_layernorm(
            B, D, xin.data_ptr(), y.data_ptr() if y is not None else None,
            gamma.data_ptr(), beta.data_ptr(), xin.data_ptr(), LN_EPS, stream,
        ), "add_layernorm")

    # the current token's K row inside the QKV output; its V row follows at +D
    k_new_ptr = qkv.data_ptr() + D * qkv.element_size()
    ldw = 6 * D
    for i in range(n_layers):
        w = packed["w_attn"][i]
        b = packed["bias"][i, 0]
        ln = packed["ln"][i]
        rowvec(x, w, ldw, b, qkv, kv_out=new_kv[i])
        attend(qkv, self_kv[i], index, None, L, k_new_ptr, att)
        rowvec(att, w[:, 3 * D :], ldw, b[3 * D :], o)
        add_ln(x, o, ln[0], ln[1])
        rowvec(x, w[:, 4 * D :], ldw, b[4 * D :], qc)
        attend(qc, cross_kv[i], 0, cross_len, S, None, att)
        rowvec(att, w[:, 5 * D :], ldw, b[5 * D :], o)
        add_ln(x, o, ln[2], ln[3])
        rowvec(x, packed["w_ff1"][i], F, b[6 * D :], h, relu=True)
        rowvec(h, packed["w_ff2"][i], D, b[6 * D + F :], o)
        add_ln(x, o, ln[4], ln[5])
    if "fin_ln" in packed:
        add_ln(x, None, packed["fin_ln"][0], packed["fin_ln"][1])
    rowvec(x, packed["fc_w"], vpad, packed["fc_b"], logits, w_f32=True)
    fused_decode_step.launches += 1
    return logits, new_kv


fused_decode_step.launches = 0

def reset_counts() -> None:
    fused_decode_step.launches = 0
    fused_decode_step_reference.calls = 0
