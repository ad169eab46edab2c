"""Training attention with weight dropout: the port's twins of
``fused_dropout_attention`` (forward and backward), its keep mask, and the
custom-VJP Functions of the model's attention, against the JAX package on
the CPU.

The JAX side runs ``fused_dropout_attention`` in interpret mode, its default
off a TPU, as ``tests/test_ops.py:557-655`` runs it.  Inputs are made with
numpy from a seed: bf16 (B, T, H, 64) queries, (B, S, H, 64) keys and values,
about 10% of keys invalid.

Tolerances:
- the keep mask is bit-equal (plain uint32 arithmetic on both sides);
- the forward twin within atol 1e-2 + rtol 2^-7 of JAX's kernel, one bf16
  ulp of the output: both sum in f32, in another order, so a weight may
  round to the neighbouring bf16 value;
- the backward twin within JAX's own bounds between its kernel and its twin
  (relative norm: dv 1e-3, dq and dk 0.02, the bf16 rounding of ds), against
  JAX's VJP and against autograd through the port's forward twin fed the
  same mask;
- the model's Functions: in f32 within 1e-5 relative (sums in another
  order); in bf16 within 2^-7 relative, one bf16 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smer_music_generation_tpu.models import transformer as jtr
from smer_music_generation_tpu.ops import train_attention as jta
from smer_music_generation_tpu_torch.models import transformer as ptr
from smer_music_generation_tpu_torch.ops import train_attention as ta

FWD_ATOL, FWD_RTOL = 1e-2, 2 ** -7
GRAD_REL = {"q": 0.02, "k": 0.02, "v": 1e-3}


def _inputs(B=2, T=128, S=256, H=2, D=64, seed=0, pad=True):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((B, T, H, D), (B, S, H, D), (B, S, H, D)))
    valid = rng.random((B, S)) < 0.9 if pad else np.ones((B, S), bool)
    return q, k, v, valid


def _jax(q, k, v):
    return tuple(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))


def _torch(q, k, v, grad=False):
    return tuple(torch.from_numpy(a).to(torch.bfloat16).requires_grad_(grad) for a in (q, k, v))


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _rel(a, b) -> float:
    a, b = _f32(a), _f32(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.mark.parametrize("seed", [0, 7, 123456789])
@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_keep_mask_is_bit_equal_to_jax(seed, rate):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jta.dropout_mask_reference(key, 2, 2, 256, 512, rate))
    got = ta.dropout_mask_reference(np.asarray(key), 2, 2, 256, 512, rate).numpy()
    assert np.array_equal(got, want)
    assert abs(got.mean() - (1.0 - rate)) < 0.01


def test_seed_words_pad_a_raw_key_as_jax_does():
    """A raw two-word key is zero-padded to four words; four words with the
    top bit set keep their bit patterns."""
    four = np.array([0x80000001, 5, 0xFFFFFFFF, 3], np.uint32)
    for key in (np.array([9, 0x9E3779B1], np.uint32), four):
        want = np.asarray(jta._seed_words(jnp.asarray(key))).astype(np.uint32)
        assert ta.seed_words(key) == tuple(int(w) for w in want)
        t = ta.seed_tensor(torch.from_numpy(key.astype(np.int64)), "cpu")
        assert t.dtype == torch.int32 and ta.seed_words(t) == tuple(int(w) for w in want)
        got = ta.dropout_mask_reference(key, 1, 2, 128, 128, 0.1).numpy()
        assert np.array_equal(got, np.asarray(jta.dropout_mask_reference(jnp.asarray(key), 1, 2, 128, 128, 0.1)))


@pytest.mark.parametrize("T,S,causal", [(128, 256, False), (256, 512, False), (256, 256, True)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_forward_twin_against_jax_kernel(T, S, causal, rate):
    q, k, v, valid = _inputs(T=T, S=S, seed=T + S)
    key = jax.random.PRNGKey(5)
    want = jta.fused_dropout_attention(*_jax(q, k, v), jnp.asarray(valid), key, rate, causal)
    got = ta.fused_dropout_attention(*_torch(q, k, v), torch.from_numpy(valid), np.asarray(key),
                                     rate, causal)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=FWD_ATOL, rtol=FWD_RTOL)
    # bit-equality is not required (f32 sums in another order); it is the
    # common case: 99.89-99.97% of the elements agree exactly, the rest by
    # one bf16 ulp
    assert np.mean(_f32(got) == _f32(want)) > 0.99


@pytest.mark.parametrize("causal", [False, True])
def test_backward_twin_against_jax_vjp_and_autograd(causal):
    q, k, v, valid = _inputs(T=256, S=256 if causal else 512, seed=3)
    key = jax.random.PRNGKey(11)
    rate = 0.1
    B, T, H, _ = q.shape
    S = k.shape[1]
    g = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)

    def jloss(a, b, c):
        out = jta.fused_dropout_attention(a, b, c, jnp.asarray(valid), key, rate, causal)
        return (out.astype(jnp.float32) * jnp.asarray(g)).sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*_jax(q, k, v))

    tq = _torch(q, k, v, grad=True)
    out = ta.fused_dropout_attention(*tq, torch.from_numpy(valid), np.asarray(key), rate, causal)
    (out.float() * torch.from_numpy(g)).sum().backward()
    for name, a, b in zip("qkv", tq, jg):
        assert a.grad.dtype == torch.bfloat16
        assert _rel(a.grad, b) < GRAD_REL[name], (name, _rel(a.grad, b))

    # autograd through the forward twin fed the same mask
    keep = ta.dropout_mask_reference(np.asarray(key), B, H, T, S, rate)
    tw = _torch(q, k, v, grad=True)
    out = ta.attention_dropout_twin(*tw, torch.from_numpy(valid), keep, rate, causal)
    (out.float() * torch.from_numpy(g)).sum().backward()
    for name, a, b in zip("qkv", tq, tw):
        assert _rel(a.grad, b.grad) < GRAD_REL[name], (name, _rel(a.grad, b.grad))


def test_row_without_a_valid_key_gives_zero_output_and_finite_gradients():
    q, k, v, _ = _inputs(T=256, S=256, seed=1)
    valid = np.ones((2, 256), bool)
    valid[1] = False
    key = jax.random.PRNGKey(11)
    want = jta.fused_dropout_attention(*_jax(q, k, v), jnp.asarray(valid), key, 0.1, True)
    tq = _torch(q, k, v, grad=True)
    out = ta.fused_dropout_attention(*tq, torch.from_numpy(valid), np.asarray(key), 0.1, True)
    assert (out[1] == 0).all()
    np.testing.assert_allclose(_f32(out), _f32(want), atol=FWD_ATOL, rtol=FWD_RTOL)
    (out.float() ** 2).sum().backward()
    for t in tq:
        assert torch.isfinite(t.grad.float()).all()
    assert (tq[0].grad[1] == 0).all() and (tq[1].grad[1] == 0).all()


def test_cpu_tensors_take_the_twins_and_count_them():
    q, k, v, valid = _inputs(T=128, S=128, seed=2)
    ta.reset_counts()
    tq = _torch(q, k, v, grad=True)
    ta.fused_dropout_attention(*tq, torch.from_numpy(valid), (0, 3), 0.1).float().sum().backward()
    assert ta.dropout_attention_fwd_reference.calls == 1
    assert ta.dropout_attention_bwd_reference.calls == 1
    assert ta.dropout_attention_fwd.launches == 0 and ta.dropout_attention_bwd.launches == 0
    with pytest.raises(ValueError, match="cuda or cpu"):
        ta.dropout_attention_fwd(*(t.detach().to("meta") for t in tq),
                                 torch.from_numpy(valid).to("meta"), (0, 3), 0.1)
    with pytest.raises(ValueError, match="CUDA hash"):
        ta.dropout_keep_mask((0, 3), 1, 1, 8, 8, 0.1, "cpu")


def _scores(B=2, H=2, T=24, S=40, seed=0):
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((B, H, T, S)).astype(np.float32) * 3
    mask = rng.random((B, 1, T, S)) < 0.85
    mask[1, :, 5] = False  # a query row with no key to attend
    scores = np.where(mask, scores, np.finfo(np.float32).min)
    any_valid = mask.any(axis=-1, keepdims=True).astype(np.float32)
    v = rng.standard_normal((B, S, H, 16)).astype(np.float32)
    g = rng.standard_normal((B, T, H, 16)).astype(np.float32)
    gw = rng.standard_normal((B, H, T, S)).astype(np.float32)
    return scores, any_valid, v, g, gw


def test_softmax_bf16_residual_function_against_jax():
    scores, _, _, _, gw = _scores()
    jw, jvjp = jax.vjp(jtr._softmax_bf16_residual, jnp.asarray(scores))
    (jds,) = jvjp(jnp.asarray(gw))
    ts = torch.from_numpy(scores).requires_grad_(True)
    w = ptr.SoftmaxBf16Residual.apply(ts)
    w.backward(torch.from_numpy(gw))
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jds), rtol=1e-5, atol=1e-6)
    # and it differs from plain autograd only by the bf16 residual
    tp = torch.from_numpy(scores).requires_grad_(True)
    torch.softmax(tp, dim=-1).backward(torch.from_numpy(gw))
    assert _rel(ts.grad, tp.grad) < 2 ** -7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_weights_dropout_matmul_at_rate_0_against_jax(dtype):
    scores, any_valid, v, g, gw = _scores(seed=1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2 ** -7

    def jf(s, vv):
        return jtr._attn_weights_dropout_matmul(s, vv, jax.random.PRNGKey(0), jnp.asarray(any_valid),
                                                0.0, jdt)

    (jout, jwd), jvjp = jax.vjp(jf, jnp.asarray(scores), jnp.asarray(v, jdt))
    jds, jdv = jvjp((jnp.asarray(g, jdt), jnp.asarray(gw, jdt)))

    ts = torch.from_numpy(scores).requires_grad_(True)
    tv = torch.from_numpy(v).to(tdt).requires_grad_(True)
    keep = torch.ones(scores.shape, dtype=torch.bool)
    out, wd = ptr.AttnWeightsDropoutMatmul.apply(ts, tv, keep, torch.from_numpy(any_valid), 0.0, tdt)
    torch.autograd.backward((out, wd), (torch.from_numpy(g).to(tdt), torch.from_numpy(gw).to(tdt)))
    assert _rel(out, jout) < tol and _rel(wd, jwd) < tol
    assert _rel(ts.grad, jds) < tol and _rel(tv.grad, jdv) < tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_weights_dropout_matmul_at_rate_01_against_autograd(dtype):
    """At rate 0.1, with the same keep mask, against plain autograd of the
    same chain; in bf16 the Function's softmax VJP reads the bf16 weights,
    so the scores' gradient differs by their rounding."""
    scores, any_valid, v, g, _ = _scores(seed=2)
    tdt = getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2 ** -6
    keep = torch.from_numpy(np.random.default_rng(3).random(scores.shape) < 0.9)
    av = torch.from_numpy(any_valid)
    gt = torch.from_numpy(g).to(tdt)

    ts = torch.from_numpy(scores).requires_grad_(True)
    tv = torch.from_numpy(v).to(tdt).requires_grad_(True)
    out, wd = ptr.AttnWeightsDropoutMatmul.apply(ts, tv, keep, av, 0.1, tdt)
    out.backward(gt)

    ps = torch.from_numpy(scores).requires_grad_(True)
    pv = torch.from_numpy(v).to(tdt).requires_grad_(True)
    w = (torch.softmax(ps, dim=-1) * av).to(tdt)
    pwd = torch.where(keep, w / torch.tensor(0.9, dtype=tdt), 0.0).to(tdt)
    pout = torch.einsum("bhts,bshd->bthd", pwd, pv)
    pout.backward(gt)
    assert torch.equal(out, pout) and torch.equal(wd, pwd)
    assert _rel(tv.grad, pv.grad) < 1e-5
    assert _rel(ts.grad, ps.grad) < tol
