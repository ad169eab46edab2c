"""Flash training attention: the port's twins of the library kernel that the
JAX model trains through with ``flash_training``
(``jax.experimental.pallas.ops.tpu.flash_attention``, forward and custom
VJP), the wrappers' dispatch, and the model's flash path, against the JAX
package on the CPU.

The JAX side runs the library kernel in TPU interpret mode
(``force_tpu_interpret_mode``), from the test only: the model calls it as
``attend_flash_vjp`` does (q segment ids all ones, kv segment ids the key
validity, sm_scale 1/8).  Inputs are made with numpy from a seed: (B, T, H,
64) queries, (B, S, H, 64) keys and values, a seeded cotangent.

Tolerances (relative norm):
- f32: 1e-5 for the output and the three gradients: the same function, the
  sums in another order and ``exp`` taken as ``2^(x log2(e))``;
- bf16: 1e-2 for the output and 2e-2 for the gradients: p and ds are
  rounded to bf16 before their products, and a value one side rounds the
  other way moves the product by a bf16 ulp;
- the model at f32: logits within 1e-4 absolute, the loss and every
  gradient of mean(logits^2) within 1e-4 relative norm (two layers of the
  above, the LayerNorms and the projections).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds, flash_attention

from smer_music_generation_tpu.models.transformer import ModelConfig as JModelConfig
from smer_music_generation_tpu.models.transformer import ScoreTransformer as JScoreTransformer
from smer_music_generation_tpu_torch.models.transformer import ModelConfig, ScoreTransformer
from smer_music_generation_tpu_torch.ops import flash_train as ft
from smer_music_generation_tpu_torch.train.state import params_from_flax, params_to_flax

REL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 2e-2)}  # (output, gradients)
SHAPES = ((128, 128), (128, 256), (256, 256))


def _valid(B, S, kind, seed):
    """(B, S) key validity: "suffix" (row 0 full, row 1 padded from 0.6 S),
    "scattered" (~10% of keys invalid anywhere, the first three keys of row
    0 among them, so its first causal rows have no key to attend) or
    "empty" (row 0 scattered, row 1 with no valid key at all)."""
    rng = np.random.default_rng(seed)
    valid = np.ones((B, S), bool)
    if kind == "suffix":
        valid[1, int(0.6 * S):] = False
        return valid
    valid = rng.random((B, S)) >= 0.1
    valid[0, :3] = False
    if kind == "empty":
        valid[1] = False
    return valid


def _inputs(B, T, S, H, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, T, H, 64), (B, S, H, 64), (B, S, H, 64), (B, T, H, 64)))


def _jax_flash(q, k, v, valid, g, causal, dtype):
    """The library kernel as ``attend_flash_vjp`` calls it, in interpret
    mode: (out, dq, dk, dv) as f32 numpy arrays in the (B, L, H, D) layout."""
    B, T = q.shape[:2]
    seg = SegmentIds(q=jnp.ones((B, T), jnp.int32), kv=jnp.asarray(valid, jnp.int32))

    def f(q, k, v):
        t = lambda a: a.transpose(0, 2, 1, 3)  # noqa: E731
        return t(flash_attention(t(q), t(k), t(v), segment_ids=seg, causal=causal, sm_scale=0.125))

    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(f, *(jnp.asarray(a, dtype) for a in (q, k, v)))
        grads = vjp(jnp.asarray(g, dtype))
    return tuple(np.asarray(a, np.float32) for a in (out, *grads))


def _rel(a, b) -> float:
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _twins(q, k, v, valid, g, causal, dtype):
    tq, tk, tv, tg = (torch.from_numpy(a).to(dtype) for a in (q, k, v, g))
    tvalid = torch.from_numpy(valid)
    out, stats = ft.flash_train_fwd(tq, tk, tv, tvalid, causal)
    return (out, *ft.flash_train_bwd(tq, tk, tv, tvalid, out, stats, tg, causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("T,S", SHAPES)
@pytest.mark.parametrize("kind", ["suffix", "scattered"])
def test_twins_against_jax_library_kernel(T, S, causal, dtype, kind):
    q, k, v, g = _inputs(2, T, S, 2, seed=T + S)
    valid = _valid(2, S, kind, seed=S)
    want = _jax_flash(q, k, v, valid, g, causal, jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    got = _twins(q, k, v, valid, g, causal, dtype)
    rel_out, rel_grad = REL[dtype]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        r = _rel(a, b)
        assert r < (rel_out if name == "out" else rel_grad), (name, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_row_with_no_valid_key_weighs_the_visited_blocks_alike(causal, dtype):
    """A row with no key to attend does not give 0: the mask is added, so
    every score of the row ties and the output is the mean of V over the
    128-key blocks the row visits (when causal, those at or below its
    block: row 5 the first 128 keys, row 200 all 256), as the library
    gives it; its gradients match too."""
    T = S = 256
    q, k, v, g = _inputs(2, T, S, 2, seed=11)
    valid = _valid(2, S, "empty", seed=12)
    want = _jax_flash(q, k, v, valid, g, causal, jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    got = _twins(q, k, v, valid, g, causal, dtype)
    rel_out, rel_grad = REL[dtype]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        r = _rel(a, b)
        assert r < (rel_out if name == "out" else rel_grad), (name, r)
    vt = torch.from_numpy(v).to(dtype).float()
    out = got[0].float()
    for row in (5, 200):
        keys = 128 if causal and row < 128 else S
        mean = vt[1, :keys].mean(dim=0)
        torch.testing.assert_close(out[1, row], mean, atol=4e-3 if dtype == torch.bfloat16 else 1e-5,
                                   rtol=0)


def test_autograd_function_matches_the_twins_and_counts_them():
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(2, 128, 256, 2, seed=3))
    valid = torch.from_numpy(_valid(2, 256, "scattered", seed=4))
    ft.reset_counts()
    qa, ka, va = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = ft.flash_train_attention(qa, ka, va, valid, causal=True)
    out.backward(g)
    assert (ft.flash_train_fwd_reference.calls, ft.flash_train_bwd_reference.calls) == (1, 1)
    assert (ft.flash_train_fwd.launches, ft.flash_train_bwd.launches) == (0, 0)
    want_out, stats = ft.flash_train_fwd_reference(q, k, v, valid, True)
    want = ft.flash_train_bwd_reference(q, k, v, valid, want_out, stats, g, True)
    assert torch.equal(out, want_out)
    for a, b in zip((qa.grad, ka.grad, va.grad), want):
        assert torch.equal(a, b)


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """Off the card a non-CPU tensor raises; the shape checks name the 128
    multiples and the head_dims 64 and 128, and the dtype check bf16 and f32
    (they run before any launch)."""
    q = torch.zeros(1, 100, 1, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 128, 1, 64, dtype=torch.bfloat16)
    ones = torch.ones(1, 128, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiples of 128"):
        ft._check_inputs(q, k, k, ones)
    for hd in (32, 96, 256):
        kh = torch.zeros(1, 128, 1, hd)
        with pytest.raises(ValueError, match=r"head_dim \(64, 128\), got " + str(hd)):
            ft._check_inputs(torch.zeros(1, 128, 1, hd), kh, kh, ones)
    for hd, dtype in ((64, torch.bfloat16), (128, torch.bfloat16), (64, torch.float32),
                      (128, torch.float32)):
        kh = torch.zeros(1, 128, 1, hd, dtype=dtype)
        assert ft._check_inputs(kh, kh, kh, ones) == (1, 128, 1, 128)
    with pytest.raises(TypeError, match="bf16 or f32"):
        kh = torch.zeros(1, 128, 1, 64, dtype=torch.float16)
        ft._check_inputs(kh, kh, kh, ones)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ft.flash_train_fwd(q.to("meta"), k.to("meta"), k.to("meta"), torch.ones(1, 128).to("meta"))


# ----------------------------------------------------------------------
# the model's flash path
# ----------------------------------------------------------------------
V = 50
KW = dict(vocab_size=V, d_model=128, nhead=2, num_encoder_layers=1, num_decoder_layers=1,
          d_ff=256, max_len=256, dropout=0.0, pos_dropout=0.0)


def _pair(**cfg):
    jm = JScoreTransformer(JModelConfig(**KW, **cfg))
    rng = np.random.default_rng(9)
    # 8 is no block multiple: init runs the plain path, no kernel
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.ones((1, 8), jnp.int32),
                     jnp.ones((1, 8), jnp.int32))
    # seeded biases, so a dropped or swapped bias would show
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: (0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        if p[-1].key == "bias" else np.asarray(a), params)
    tm = ScoreTransformer(ModelConfig(**KW, **cfg))
    tm.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _tokens(S, T, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(3, V, (2, S)).astype(np.int32)
    tgt = rng.integers(3, V, (2, T)).astype(np.int32)
    spm = np.zeros((2, S), bool)
    spm[1, 3 * S // 4:] = True
    tpm = np.zeros((2, T), bool)
    tpm[1, T // 2:] = True
    src[spm] = 0
    tgt[tpm] = 0
    return src, tgt, spm, tpm


def test_model_flash_path_against_jax_in_interpret_mode():
    """flash_training at src 256 / tgt 128 (both gates pass): the port's
    logits, loss and gradients of mean(logits^2) against JAX's model with
    the same weights, the library kernel in interpret mode; no cross
    weights on either side."""
    jm, params, tm = _pair(flash_training=True)
    src, tgt, spm, tpm = _tokens(256, 128)

    def loss_fn(p):
        logits, w = jm.apply(p, src, tgt, src_pad_mask=spm, tgt_pad_mask=tpm)
        return jnp.mean(logits ** 2), (logits, w)

    with pltpu.force_tpu_interpret_mode():
        (jl, (jlogits, jw)), jg = jax.value_and_grad(loss_fn, has_aux=True)(params)
    assert jw is None
    ft.reset_counts()
    logits, w = tm(*(torch.from_numpy(a) for a in (src, tgt, spm, tpm)))
    loss = (logits ** 2).mean()
    loss.backward()
    assert w is None
    # encoder self, decoder self, cross: each once forward, once backward
    assert (ft.flash_train_fwd_reference.calls, ft.flash_train_bwd_reference.calls) == (3, 3)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
    assert abs(loss.item() - float(jl)) / abs(float(jl)) < 1e-4
    # a K projection's bias adds one constant to each row's scores, so its
    # gradient is 0 but for rounding (~1e-10 on both sides): each leaf is
    # held to 1e-4 of its own norm or of 1e-3 of the largest leaf's
    grads = params_to_flax({n: p.grad for n, p in tm.named_parameters()})
    leaves = jax.tree_util.tree_leaves_with_path(jg)
    floor = 1e-3 * max(np.linalg.norm(np.asarray(a)) for _, a in leaves)
    for path, a in leaves:
        got = grads
        for key in path:
            got = got[key.key]
        a = np.asarray(a)
        assert np.linalg.norm(got - a) < 1e-4 * max(np.linalg.norm(a), floor), \
            [key.key for key in path]


def test_flash_training_falls_back_below_the_block_multiples():
    """JAX's fallback case (tests/test_model.py:216-240): at src 100 / tgt 60
    flash_training gives the plain path's output exactly, with weights."""
    _, _, plain = _pair()
    _, _, flash = _pair(flash_training=True)
    src = torch.ones(2, 100, dtype=torch.long)
    tgt = torch.ones(2, 60, dtype=torch.long)
    ft.reset_counts()
    with torch.no_grad():
        l0, w0 = plain(src, tgt)
        l1, w1 = flash(src, tgt)
    assert torch.equal(l0, l1)
    assert w1 is not None and torch.equal(w0, w1)
    assert ft.flash_train_fwd_reference.calls == 0


def test_flash_training_takes_precedence_over_the_other_paths():
    """With flash_encoder and fused_attn_train also set, a 128-multiple
    batch runs the flash kernels' twins alone, on a deterministic pass
    too (the encoder's gate does not look at it)."""
    from smer_music_generation_tpu_torch.ops import attention as attn
    from smer_music_generation_tpu_torch.ops import train_attention as ta

    cfg = ModelConfig(**{**KW, "dropout": 0.1, "pos_dropout": 0.1}, flash_training=True,
                      flash_encoder=True, fused_attn_train=True, dtype=torch.bfloat16)
    model = ScoreTransformer(cfg)
    src, tgt, spm, tpm = (torch.from_numpy(a) for a in _tokens(128, 128))
    for deterministic in (True, False):
        ft.reset_counts(), ta.reset_counts(), attn.reset_counts()
        gen = None if deterministic else torch.Generator().manual_seed(0)
        logits, w = model(src, tgt, spm, tpm, deterministic=deterministic, generator=gen)
        assert w is None and torch.isfinite(logits).all()
        assert ft.flash_train_fwd_reference.calls == 3
        assert ta.dropout_attention_fwd_reference.calls == 0
        assert attn.attention_reference.calls == 0


def test_parameter_names_do_not_change():
    base = ScoreTransformer(ModelConfig(**KW))
    for cfg in (dict(flash_training=True), dict(remat=True), dict(flash_training=True, remat=True)):
        assert ScoreTransformer(dataclasses.replace(base.cfg, **cfg)).state_dict().keys() == \
            base.state_dict().keys()
