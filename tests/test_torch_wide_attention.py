"""The attention kernels' domain beyond bf16 at head_dim 64: the port's twins
at head_dim 128 and in f32 against the JAX package on the CPU, and the
wrappers' refusals of other head_dims.  The flash-train forward's order of
work is in ``tests/test_torch_flash_fwd_tiles.py``, the model's
flash_training path at head_dim 128 in ``tests/test_torch_wide_model.py``.

The JAX side runs its kernels as its own tests run them off a TPU:
``fused_attention(..., interpret=True)``, ``fused_dropout_attention`` in
interpret mode (its default off a TPU) and the library flash kernel under
``force_tpu_interpret_mode``, with ``sm_scale = 1/sqrt(head_dim)`` as
``attend_flash_vjp`` passes it.  Inputs are made with numpy from a seed.

Tolerances:
- ``fused_attention``'s twin against JAX's kernel: f32 within atol 2e-5 +
  rtol 1e-4, the bound ``tests/test_ops.py`` holds the kernel to; bf16
  within atol 1e-3 + rtol 2^-7 (``chip_smoke.ATTN_ATOL``/``ATTN_RTOL``: f32
  sums in another order, then one bf16 rounding of the output);
- the flash-train twins against the library kernel: the relative norms of
  ``tests/test_torch_flash_train.py`` (f32 1e-5; bf16 1e-2 for the output,
  2e-2 for the gradients);
- the dropout-attention twins against JAX's kernel: the bounds of
  ``tests/test_torch_train_attention.py`` (forward one bf16 ulp, atol 1e-2 +
  rtol 2^-7; gradients dq and dk 0.02, dv 1e-3 relative norm).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds, flash_attention

from chip_smoke import ATTN_ATOL, ATTN_RTOL, TA_ATOL, TA_RTOL
from smer_music_generation_tpu.ops import train_attention as jta
from smer_music_generation_tpu.ops.attention import attention_reference as jref
from smer_music_generation_tpu.ops.attention import fused_attention as jfused
from smer_music_generation_tpu_torch.ops import attention as attn
from smer_music_generation_tpu_torch.ops import flash_train as ft
from smer_music_generation_tpu_torch.ops import train_attention as ta

F32_ATOL, F32_RTOL = 2e-5, 1e-4
FT_REL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 2e-2)}  # (output, gradients)
TA_GRAD_REL = {"dq": 0.02, "dk": 0.02, "dv": 1e-3}
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _rel(a, b) -> float:
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = b.detach().float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _normal(rng, *shapes):
    return tuple(rng.standard_normal(s).astype(np.float32) for s in shapes)


# ----------------------------------------------------------------------
# fused_attention (flash_encoder's kernel) at head_dim 128, f32 and bf16
# ----------------------------------------------------------------------
ATTN_CASES = [  # (B, T, S, key lengths or None, causal)
    (2, 64, 96, [96, 40], False),
    (2, 48, 48, None, True),
    (2, 96, 128, [0, 128], False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,S,lens,causal", ATTN_CASES,
                         ids=[f"T{t}-S{s}-{'lens' if n else 'full'}-{'causal' if c else 'bidir'}"
                              for _, t, s, n, c in ATTN_CASES])
def test_attention_twin_at_head_dim_128_against_jax_kernel(B, T, S, lens, causal, dtype):
    q, k, v = _normal(np.random.default_rng(T + S), (B, T, 2, 128), (B, S, 2, 128), (B, S, 2, 128))
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    jq, jk, jv = (jnp.asarray(a, JDTYPE[dtype]) for a in (q, k, v))
    want = jfused(jq, jk, jv, kv_valid_len=jl, causal=causal, blk_q=32, blk_kv=32, interpret=True)
    tl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    got = attn.fused_attention(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)), kv_valid_len=tl,
                               causal=causal)  # CPU tensors: the twin
    assert got.shape == (B, T, 2, 128) and got.dtype == dtype
    atol, rtol = (F32_ATOL, F32_RTOL) if dtype == torch.float32 else (ATTN_ATOL, ATTN_RTOL)
    rows = np.ones(B, bool) if lens is None else np.asarray(lens) > 0
    # a sequence with no valid key: the twin weighs all S keys alike (JAX's
    # reference), the Pallas kernel all S padded to its block; not compared
    got = got.float().numpy()
    np.testing.assert_allclose(got[rows], np.asarray(want, np.float32)[rows], atol=atol, rtol=rtol)
    if dtype == torch.float32:  # JAX's reference takes the scores in the inputs' dtype
        np.testing.assert_allclose(
            got, np.asarray(jref(jq, jk, jv, kv_valid_len=jl, causal=causal), np.float32), atol=atol,
            rtol=rtol)


# ----------------------------------------------------------------------
# flash training attention at head_dim 128, f32 and bf16, with its VJP
# ----------------------------------------------------------------------
def _valid(B, S, seed):
    """~10% of keys invalid anywhere (the first three of row 0 among them,
    so its first causal rows have no key to attend), row 1 with none."""
    rng = np.random.default_rng(seed)
    valid = rng.random((B, S)) >= 0.1
    valid[0, :3] = False
    valid[1] = False
    return valid


def _jax_flash(q, k, v, valid, g, causal, dtype):
    """The library kernel as ``attend_flash_vjp`` calls it, in interpret
    mode: (out, dq, dk, dv) as f32 arrays in the (B, L, H, D) layout; g
    None gives the output alone."""
    B, T, _, D = q.shape
    seg = SegmentIds(q=jnp.ones((B, T), jnp.int32), kv=jnp.asarray(valid, jnp.int32))

    def f(q, k, v):
        t = lambda a: a.transpose(0, 2, 1, 3)  # noqa: E731
        return t(flash_attention(t(q), t(k), t(v), segment_ids=seg, causal=causal,
                                 sm_scale=1.0 / math.sqrt(D)))

    with pltpu.force_tpu_interpret_mode():
        args = tuple(jnp.asarray(a, JDTYPE[dtype]) for a in (q, k, v))
        if g is None:
            return (np.asarray(f(*args), np.float32),)
        out, vjp = jax.vjp(f, *args)
        grads = vjp(jnp.asarray(g, JDTYPE[dtype]))
    return tuple(np.asarray(a, np.float32) for a in (out, *grads))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("T,S", [(128, 256), (256, 256)])
def test_flash_train_twins_at_head_dim_128_against_jax_library_kernel(T, S, causal, dtype):
    q, k, v, g = _normal(np.random.default_rng(T + S + 1), (2, T, 2, 128), (2, S, 2, 128),
                         (2, S, 2, 128), (2, T, 2, 128))
    valid = _valid(2, S, seed=S)
    want = _jax_flash(q, k, v, valid, g, causal, dtype)
    tq, tk, tv, tg = (torch.from_numpy(a).to(dtype) for a in (q, k, v, g))
    out, stats = ft.flash_train_fwd(tq, tk, tv, torch.from_numpy(valid), causal)
    got = (out, *ft.flash_train_bwd(tq, tk, tv, torch.from_numpy(valid), out, stats, tg, causal))
    rel_out, rel_grad = FT_REL[dtype]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == dtype
        r = _rel(a, b)
        assert r < (rel_out if name == "out" else rel_grad), (name, r)


# ----------------------------------------------------------------------
# fused_dropout_attention (fused_attn_train's kernel) at head_dim 128
# ----------------------------------------------------------------------
@pytest.mark.parametrize("T,S,causal", [(128, 256, False), (256, 256, True)])
def test_dropout_attention_twins_at_head_dim_128_against_jax_kernel(T, S, causal):
    rng = np.random.default_rng(T + S + 2)
    q, k, v, g = _normal(rng, (2, T, 2, 128), (2, S, 2, 128), (2, S, 2, 128), (2, T, 2, 128))
    valid = rng.random((2, S)) < 0.9
    key, rate = jax.random.PRNGKey(7), 0.1
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jta.fused_dropout_attention(jq, jk, jv, jnp.asarray(valid), key, rate, causal)

    def jloss(a, b, c):
        out = jta.fused_dropout_attention(a, b, c, jnp.asarray(valid), key, rate, causal)
        return (out.astype(jnp.float32) * jnp.asarray(g)).sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq = tuple(torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True) for a in (q, k, v))
    out = ta.fused_dropout_attention(*tq, torch.from_numpy(valid), np.asarray(key), rate, causal)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(want, np.float32), atol=TA_ATOL,
                               rtol=TA_RTOL)
    (out.float() * torch.from_numpy(g)).sum().backward()
    for name, a, b in zip(("dq", "dk", "dv"), tq, jg):
        assert _rel(a.grad, b) < TA_GRAD_REL[name], (name, _rel(a.grad, b))



# ----------------------------------------------------------------------
# the wrappers' refusals before any launch
# ----------------------------------------------------------------------
@pytest.mark.parametrize("hd", [32, 96, 256])
def test_attention_wrappers_refuse_other_head_dims(hd):
    """The flash-attention and train-attention wrappers take head_dim 64 and
    128 on the card and name both when they refuse another."""
    x = torch.zeros(1, 64, 2, hd, dtype=torch.bfloat16)
    ones = torch.ones(1, 64, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"head_dim \(64, 128\), got " + str(hd)):
        attn._check_inputs(x, x, x, None)
    with pytest.raises(ValueError, match=r"head_dim \(64, 128\), got " + str(hd)):
        ta._check_inputs(x, x, x, ones)


@pytest.mark.parametrize("hd", [64, 128])
def test_attention_wrappers_take_head_dims_64_and_128(hd):
    """bf16 and f32 at both head_dims pass the flash-attention wrapper's
    checks; bf16 at both the train-attention wrapper's, which refuses f32
    (JAX's gate sends f32 to the plain path, never to its kernel)."""
    ones = torch.ones(1, 64, dtype=torch.int32)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.zeros(1, 64, 2, hd, dtype=dtype)
        attn._check_inputs(x, x, x, torch.tensor([64], dtype=torch.int32))
    x = torch.zeros(1, 64, 2, hd, dtype=torch.bfloat16)
    assert ta._check_inputs(x, x, x, ones) == (1, 64, 2, 64)
    with pytest.raises(TypeError):
        y = x.float()
        ta._check_inputs(y, y, y, ones)

