"""The port's mesh, sharded serving and sharded training, on the CPU.

- ``make_mesh`` shapes and errors, ``batch_sharding`` and ``param_shardings``
  against JAX's (``tests/test_parallel.py``), the same leaves split on the
  same axis (a flax kernel's dim d is a torch weight's dim 1 - d).
- The dropout-attention keep mask of a shard (its rows from ``b0``, its
  heads from ``h0`` of ``H_global``) is the slice of the unsharded mask, in
  the port and against JAX's ``dropout_mask_reference``; so is the twin's
  output.
- A greedy decode on a two-CPU mesh gives JAX's dp8-sharded decode's
  tokens (JAX's test inputs); a nucleus one gives the port's unsharded
  decode's tokens bit for bit.

Sharded training is in ``tests/test_torch_parallel_train.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smer_music_generation_tpu.infer.decode import InfillDecoder as JDecoder
from smer_music_generation_tpu.infer.decode import pad_to_bucket
from smer_music_generation_tpu.ops import train_attention as jta
from smer_music_generation_tpu.parallel import mesh as jmesh
from smer_music_generation_tpu.train.state import build_model as jbuild_model
from smer_music_generation_tpu.vocab import CONTROL_SETS, WordVocab
from smer_music_generation_tpu_torch.infer.decode import InfillDecoder
from smer_music_generation_tpu_torch.ops import train_attention as ta
from smer_music_generation_tpu_torch.parallel import mesh
from smer_music_generation_tpu_torch.train.state import build_model, params_from_flax
from smer_music_generation_tpu_torch.vocab import WordVocab as TWordVocab
from tests import torch_parallel_workers as workers

# small shapes beside other xdist workers: one torch thread (as
# tests/torch_port_helpers.py sets for the port's parity tests)
torch.set_num_threads(1)

def _cpus(n):
    return ["cpu"] * n


def test_dcn_mesh_shape_and_batch_sharding():
    """JAX's ``test_dcn_mesh_shape_and_batch_sharding`` on the port."""
    m = mesh.make_mesh(8, tp=1, dcn_slices=2, devices=_cpus(8))
    assert m.shape == {"dcn": 2, "dp": 4, "tp": 1}
    assert mesh.batch_sharding(m).spec == (("dcn", "dp"),)
    flat = mesh.make_mesh(8, tp=2, devices=_cpus(8))
    assert flat.shape == {"dp": 4, "tp": 2}
    assert mesh.batch_sharding(flat).spec == ("dp",)
    assert mesh.batch_sharding(flat).dim_of("dp") == 0 and mesh.replicated(flat).spec == ()
    assert len(flat.dp_devices()) == 4
    with pytest.raises(ValueError, match="not divisible"):
        mesh.make_mesh(8, tp=1, dcn_slices=3, devices=_cpus(8))
    with pytest.raises(ValueError, match="only 2"):
        mesh.make_mesh(4, devices=_cpus(2))


@functools.lru_cache(maxsize=None)
def jax_params():
    """JAX's ``tiny_setup`` model (``tests/test_parallel.py``) and its
    initial params; the params do not depend on the dropout rate."""
    vocab = WordVocab(0, CONTROL_SETS[5])
    model = jbuild_model(vocab.vocab_size, dropout=0.1, **workers.DIMS)
    params = model.init({"params": jax.random.PRNGKey(0)}, jnp.ones((8, 64), jnp.int32),
                        jnp.ones((8, 32), jnp.int32))
    return vocab, model, params


def test_param_shardings_match_jax():
    """The same leaves split, on the same axis, at tp=2 (the (309, 64) logit
    weight stays whole: 309 is odd), and none at tp=1."""
    _, _, params = jax_params()
    state = params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    for tp in (1, 2):
        jm = jmesh.make_mesh(8, tp=tp)
        jspecs = jax.tree_util.tree_map_with_path(
            lambda path, s: ("/".join(str(getattr(k, "key", k)) for k in path), s.spec),
            jmesh.param_shardings(jm, params["params"]))
        jflat = dict(jax.tree_util.tree_leaves(jspecs, is_leaf=lambda x: isinstance(x, tuple)))
        port = mesh.param_shardings(mesh.make_mesh(8, tp=tp, devices=_cpus(8)), state)
        split = 0
        for name, sh in port.items():
            parts = name.split(".")
            if parts[0] in ("encoder_layers", "decoder_layers"):
                parts = [f"{parts[0].split('_')[0]}_{parts[1]}"] + parts[2:]
            kernel = parts[-1] == "weight" and state[name].dim() == 2 and parts[0] != "embedding"
            leaf = {"weight": "kernel" if kernel else "scale"}.get(parts[-1], parts[-1])
            if parts[0] == "embedding":
                leaf = "embedding"
            jspec = tuple(jflat["/".join(parts[:-1] + [leaf])])
            jdim = next((d for d, a in enumerate(jspec) if a == "tp"), None)
            dim = sh.dim_of("tp")
            if jdim is None:
                assert dim is None, name
            else:
                split += 1
                assert dim == (1 - jdim if kernel else jdim), (name, jspec, sh.spec)
        # the embedding, and q/k/v/out and the FFN pair of 2 encoder and 2 decoder layers
        assert split == (0 if tp == 1 else 1 + 2 * 6 + 2 * 10)
        assert port["fc.weight"].spec == ()
    full = mesh.train_state_shardings(mesh.make_mesh(2, tp=2, devices=_cpus(2)), state)
    assert full["exp_avg"] is full["params"] and full["lr"].spec == ()


def test_shard_keep_mask_is_slice_of_global_mask():
    """(b0, h0, H_global) place a shard's keep hash: its mask is the slice
    of the unsharded mask (and of JAX's), and the twin's forward and
    backward on the shard are the slices of the unsharded ones."""
    seed = np.asarray(jax.random.PRNGKey(11))
    B, H, T, S, rate = 4, 4, 128, 256, 0.1
    full = ta.dropout_mask_reference(seed, B, H, T, S, rate)
    jfull = np.asarray(jta.dropout_mask_reference(jnp.asarray(seed), B, H, T, S, rate))
    assert np.array_equal(full.numpy(), jfull)
    for b0, h0, nb, nh in ((2, 0, 2, 4), (0, 2, 4, 2), (1, 3, 2, 1)):
        part = ta.dropout_mask_reference(seed, nb, nh, T, S, rate, b0=b0, h0=h0, H_global=H)
        assert torch.equal(part, full[b0 : b0 + nb, h0 : h0 + nh])
    with pytest.raises(ValueError, match="does not hold"):
        ta.fused_dropout_attention(torch.zeros(1, 8, 2, 64), torch.zeros(1, 8, 2, 64),
                                   torch.zeros(1, 8, 2, 64), torch.ones(1, 8), seed, rate,
                                   h0=1, H_global=2)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, T, H, 64, generator=g).to(torch.bfloat16).requires_grad_()
               for _ in range(3))
    valid = torch.ones(B, S // 2, dtype=torch.bool)
    k2, v2 = (t.detach()[:, : S // 2].clone().requires_grad_() for t in (k, v))
    out = ta.fused_dropout_attention(q, k2, v2, valid, seed, rate, causal=False)
    out.float().pow(2).sum().backward()
    qs, ks, vs = (t.detach()[2:4, :, 1:3].clone().requires_grad_() for t in (q, k2, v2))
    part = ta.fused_dropout_attention(qs, ks, vs, valid[2:4], seed, rate, False, b0=2, h0=1, H_global=H)
    part.float().pow(2).sum().backward()
    assert torch.equal(part, out[2:4, :, 1:3])
    assert torch.equal(qs.grad, q.grad[2:4, :, 1:3]) and torch.equal(vs.grad, v2.grad[2:4, :, 1:3])


def _decode_inputs(vocab):
    """JAX's ``test_sharded_decode_matches_unsharded`` inputs."""
    src_tokens = ["4/4", "t_3", "k_0", "d_2", "o_2", "y_2", "i_0", "bar", "s_2", "track_0",
                  "d_2", "o_2", "y_2", "m_0", "m_0", "m_0", "m_0"]
    src = pad_to_bucket(np.array([[vocab.char2index(t) for t in src_tokens]], np.int32), bucket=128)
    src_b = np.repeat(src, 8, axis=0)
    span_types = np.zeros((8, 256), np.int32)
    span_types[:, :4] = [0, 1, 2, 3]
    n_spans = np.full((8,), 4, np.int32)
    return src_b, span_types, n_spans


def test_sharded_decode_matches_jax_dp8_and_unsharded():
    """Greedy: the two-CPU sharded decode gives JAX's dp8-sharded decode's
    tokens and lengths.  Nucleus: the sharded decode gives the port's
    unsharded decode's tokens, lengths and steps (the global noise sliced)."""
    vocab, jmodel, params = jax_params()
    src_b, span_types, n_spans = _decode_inputs(vocab)
    jdec = JDecoder(jmodel, vocab, max_tgt_len=128, greedy=True, nucleus_p=None, fused=False)
    jm = jmesh.make_mesh(8, tp=1)
    dp, rep = jmesh.batch_sharding(jm), jmesh.replicated(jm)
    want = jdec(jax.device_put(params, rep), *(jax.device_put(jnp.asarray(a), dp)
                                               for a in (src_b, span_types, n_spans)),
                False, jax.random.PRNGKey(5))
    tvocab = TWordVocab(0, CONTROL_SETS[5])
    tmodel = build_model(tvocab.vocab_size, dropout=0.0, **workers.DIMS)
    tmodel.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    tmodel.eval().requires_grad_(False)
    m2 = mesh.make_mesh(2, devices=_cpus(2))
    args = (src_b, span_types, n_spans, False)
    got = InfillDecoder(tmodel, tvocab, max_tgt_len=128, greedy=True, nucleus_p=None, fused=False,
                        mesh=m2)(*args)
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    kw = dict(max_tgt_len=128, nucleus_p=0.9, fused=False, seed=9)
    one = InfillDecoder(tmodel, tvocab, **kw)(*args)
    for dp_n in (2, 4):
        sharded = InfillDecoder(tmodel, tvocab, mesh=mesh.make_mesh(dp_n, devices=_cpus(dp_n)),
                                **kw)(*args)
        assert torch.equal(sharded.tokens, one.tokens) and torch.equal(sharded.lengths, one.lengths)
        assert sharded.steps == one.steps
    with pytest.warns(UserWarning, match="not divisible by dp=2"):
        odd = InfillDecoder(tmodel, tvocab, mesh=m2, **kw)(*(a[:3] for a in args[:3]), False)
    assert odd.tokens.shape[0] == 3


