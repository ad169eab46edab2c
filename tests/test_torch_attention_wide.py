"""The attention twins at head_dims above 128 against the JAX package on the
CPU: the functions the wide kernels of ``ops/csrc/attention_wide.cu``
compute on the card (their order of work is held to these twins in
``tests/test_torch_attention_wide_tiles.py``).

The JAX side runs its kernels as its own tests run them off a TPU:
``fused_attention(..., interpret=True)``, ``fused_dropout_attention`` in
interpret mode (its default off a TPU) and the library flash kernel under
``force_tpu_interpret_mode``, with ``sm_scale = 1/sqrt(head_dim)`` as
``attend_flash_vjp`` passes it.  Inputs are made with numpy from a seed, at
head_dim 160, 192 and 256 (the library flash kernel at 256 and 384: it
refuses a head_dim above 128 that is not a multiple of 128).

Tolerances, those of ``tests/test_torch_wide_attention.py`` at head_dim 128:
- ``fused_attention``'s twin against JAX's kernel: f32 within atol 2e-5 +
  rtol 1e-4 (the bound ``tests/test_ops.py`` holds the kernel to), bf16
  within ``chip_smoke.ATTN_ATOL`` + ``ATTN_RTOL`` (f32 sums in another
  order, then one bf16 rounding of the output);
- the flash-train twins against the library kernel: relative norms f32
  1e-5, bf16 1e-2 for the output and 2e-2 for the gradients
  (``tests/test_torch_flash_train.py``);
- the dropout-attention twins against JAX's kernel: the output within
  ``chip_smoke.TA_ATOL`` + ``TA_RTOL`` (one bf16 ulp), the gradients dq and
  dk within 0.02 and dv within 1e-3 relative norm
  (``tests/test_torch_train_attention.py``).
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
from smer_music_generation_tpu.ops.attention import fused_attention as jfused
from smer_music_generation_tpu_torch.ops import attention as attn
from smer_music_generation_tpu_torch.ops import flash_train as ft
from smer_music_generation_tpu_torch.ops import train_attention as ta

F32_ATOL, F32_RTOL = 2e-5, 1e-4
FT_REL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 2e-2)}  # (output, gradients)
TA_GRAD_REL = {"dq": 0.02, "dk": 0.02, "dv": 1e-3}
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
HEAD_DIMS = (160, 192, 256)


def _rel(a, b) -> float:
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _normal(rng, *shapes):
    return tuple(rng.standard_normal(s).astype(np.float32) for s in shapes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_attention_twin_at_wide_head_dims_against_jax_kernel(hd, causal, dtype):
    B, T, S, lens = 2, 64, 96, [96, 40]
    q, k, v = _normal(np.random.default_rng(hd + causal), (B, T, 2, hd), (B, S, 2, hd), (B, S, 2, hd))
    jq, jk, jv = (jnp.asarray(a, JDTYPE[dtype]) for a in (q, k, v))
    want = jfused(jq, jk, jv, kv_valid_len=jnp.asarray(lens, jnp.int32), causal=causal, blk_q=32,
                  blk_kv=32, interpret=True)
    got = attn.fused_attention(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)),
                               kv_valid_len=torch.tensor(lens, dtype=torch.int32), causal=causal)
    assert got.shape == (B, T, 2, hd) and got.dtype == dtype
    atol, rtol = (F32_ATOL, F32_RTOL) if dtype == torch.float32 else (ATTN_ATOL, ATTN_RTOL)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol, rtol=rtol)


def _jax_flash(q, k, v, valid, g, causal, dtype):
    """The library kernel as ``attend_flash_vjp`` calls it, in interpret
    mode, with its VJP: (out, dq, dk, dv) as f32 arrays in (B, L, H, D)."""
    B, T, _, D = q.shape
    seg = SegmentIds(q=jnp.ones((B, T), jnp.int32), kv=jnp.asarray(valid, jnp.int32))

    def f(q, k, v):
        t = lambda a: a.transpose(0, 2, 1, 3)  # noqa: E731
        return t(flash_attention(t(q), t(k), t(v), segment_ids=seg, causal=causal,
                                 sm_scale=1.0 / math.sqrt(D)))

    with pltpu.force_tpu_interpret_mode():
        args = tuple(jnp.asarray(a, JDTYPE[dtype]) for a in (q, k, v))
        out, vjp = jax.vjp(f, *args)
        grads = vjp(jnp.asarray(g, JDTYPE[dtype]))
    return tuple(np.asarray(a, np.float32) for a in (out, *grads))


# the library kernel takes a head_dim above 128 only as a multiple of 128
# (flash_attention.py:461 raises NotImplementedError at 160 and 192): the
# twins at those head_dims are held to the kernels' order of work alone
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hd,T,S,causal", [(256, 128, 256, False), (256, 256, 256, True),
                                           (384, 128, 128, True)])
def test_flash_train_twins_at_wide_head_dims_against_jax_library_kernel(hd, T, S, causal, dtype):
    rng = np.random.default_rng(hd + T + S)
    q, k, v, g = _normal(rng, (2, T, 1, hd), (2, S, 1, hd), (2, S, 1, hd), (2, T, 1, hd))
    valid = rng.random((2, S)) >= 0.1
    valid[0, :3] = False  # row 0's first causal rows have no key to attend
    valid[1, 200:] = False
    want = _jax_flash(q, k, v, valid, g, causal, dtype)
    tq, tk, tv, tg = (torch.from_numpy(a).to(dtype) for a in (q, k, v, g))
    out, stats = ft.flash_train_fwd(tq, tk, tv, torch.from_numpy(valid), causal)
    got = (out, *ft.flash_train_bwd(tq, tk, tv, torch.from_numpy(valid), out, stats, tg, causal))
    rel_out, rel_grad = FT_REL[dtype]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape[-1] == hd
        r = _rel(a, b)
        assert r < (rel_out if name == "out" else rel_grad), (name, r)


@pytest.mark.parametrize("hd,T,S,causal", [(160, 128, 256, False), (192, 256, 256, True),
                                           (256, 128, 128, False)])
def test_dropout_attention_twins_at_wide_head_dims_against_jax_kernel(hd, T, S, causal):
    rng = np.random.default_rng(hd + T + S + 2)
    q, k, v, g = _normal(rng, (2, T, 2, hd), (2, S, 2, hd), (2, S, 2, hd), (2, T, 2, hd))
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
