"""The schedules of the decode kernels, emulated in plain torch on the CPU,
against the port's twins and JAX's ``fused_decode_step`` in interpret mode.

``rowvec_kernel`` and ``attend_kernel`` (``ops/csrc/decode_step.cu``) cannot
run here, so these emulations repeat their order of operations step by step:

- ``rowvec_tiles``: a block owns 64 output columns and a K-slice of
  ``ds.rowvec_k_split(K, N)`` rows (16 to 64, a function of K and N); a thread
  holds one 16-byte piece of W (8 bf16, 16 int8 or 4 f32 columns) in each of
  the slice's passes of 16 rows and sums its passes with one FMA each; the K
  rows of a warp are summed by a xor-shuffle tree, the warps of a block in
  order, the slices in order; then the column scale (int8, rounded), the
  bias and the ReLU.  Rows are launched 16 at a time, in groups of 4;
- ``attend_tiles``: the rows of the spliced sequence (the cache rows, then
  the v4 chunk or verify window rows) in splits of 64 by their index in it;
  a row's score an FMA chain over each of its 8 lanes' dims, then a
  xor-shuffle tree over the 8 lanes, times the scale; per split the max of
  its 64 scores, p = exp(s - m) once a row, p and p V summed by each thread
  over its 4 rows in order, then a shuffle tree over a warp's 4 rows and the
  4 warps in order; the splits merged in order (m, l, acc), then the
  current token's own row;
- ``ln_tail``: the post-LN that ``rowvec_kernel`` runs at the end of the
  out projections' and FFN down's launches, in ``add_layernorm_kernel``'s
  order of sums (which it replaced): thread t of 256 sums elements t, t +
  256, ... from 0, a xor-shuffle tree from offset 16 down over each warp's
  32 threads, the 8 warps' totals in order from 0; the mean, then the same
  for the squared deviations by FMA; ``(v - mean) * r * gamma + beta`` with
  the last product and sum as one FMA.  A warp takes a row (warp w of the
  block's rows w, w + warps, ...), and the final LN may follow on the
  result.

An FMA is taken in float64 and rounded once to float32; exp and rsqrt are
torch's (the card's expf and rsqrtf may differ in the last bit: the
emulation pins the order, not the card's bits).  The emulations agree with the twins
(``_rowvec_math``, ``_attend``, ``fused_decode_step_reference``) and with
JAX's Pallas step within chip_smoke's ``ATOL`` + ``RTOL``, and show the
invariants that chip_smoke's phases 2c and 2e hold on the card: a row's
bits (LayerNorm included) do not depend on how many rows a launch has, on
the launch it lands in,
or on where the cache ends and the chunk or window rows begin, so a verify
row is bit-equal to the v2 step at index + j and a v4 token to a v3 token
over the spliced cache.  A control shows the attention rule has teeth:
summing the cache rows and the chunk rows as separate splits breaks it.
Small widths: d_model 128, 2 heads of 64, 2 decoder layers, d_ff 256.

The same on an f32 model (the kernels' f32 instantiations, as JAX's
kernels take any compute dtype): x is not rounded, the K|V rows are written
in f32, int8 weights read x unrounded, an f32 row takes the bf16 row's
lanes and order (two 16-byte loads a lane at head_dim 64), the LN tail runs
on 4 of an f32 block's 8 warps; held against the f32 twins and JAX's f32
``fused_decode_step`` in interpret mode within ``F32_ATOL``, the bound the
f32 twin keeps to JAX (``tests/test_torch_decode_step.py``), with the same
launch invariants.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ATOL, RTOL
from smer_music_generation_tpu.ops.decode_step import _layernorm as jax_layernorm
from smer_music_generation_tpu.ops.decode_step import fused_decode_step as jax_step
from smer_music_generation_tpu.vocab import CONTROL_SETS, WordVocab
from smer_music_generation_tpu_torch.ops import decode_step as ds
from tests.torch_port_helpers import model_pair

SPLIT = 64  # attend_kernel's rows a split
LAUNCH_ROWS = 16  # rowvec_kernel's rows a launch
GROUP = 4  # rowvec_kernel's rows a thread holds at once
LN_THREADS, LN_WARPS = 256, 8  # add_layernorm_kernel's block, whose order the LN tail keeps
# the warps of rowvec_kernel's block that run its LN tail, by W's type (an
# f32 block's 8 warps: its first 4)
TAIL_WARPS = {torch.bfloat16: 4, torch.int8: 2, torch.float32: 4}
F32_ATOL = 1e-4  # an f32 model: the emulation, the twin and JAX, f32 sums in other orders


def fma(a, b, c):
    """fmaf: a * b + c rounded once to f32 (a * b is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def tree(t):
    """A xor-shuffle tree over the last dim (a power of two): each level adds
    neighbours, the value every lane of the tree ends with."""
    while t.shape[-1] > 1:
        t = t[..., 0::2] + t[..., 1::2]
    return t[..., 0]


def rowvec_launch(x, w, colscale, bias, relu, cdt=None):
    """One ``rowvec_kernel`` launch on at most 16 rows of x (B, K) f32, x
    rounded to the compute dtype ``cdt`` (None: W's own, bf16 for int8)."""
    B, K = x.shape
    N = w.shape[1]
    vec = 16 // w.element_size()
    rows_a_warp = 32 // (64 // vec)
    warps = 16 // rows_a_warp
    if cdt is None:
        cdt = torch.bfloat16 if w.dtype == torch.int8 else w.dtype
    xs = x if cdt == torch.float32 else x.to(torch.bfloat16).float()
    ks = ds.rowvec_k_split(K, N)
    passes, slices = ks // 16, -(-K // ks)
    xp = torch.zeros(B, slices * ks)
    xp[:, :K] = xs
    wp = torch.zeros(slices * ks, N)
    wp[:K] = w.float()
    xp = xp.view(B, slices, passes, 16)
    wp = wp.view(slices, passes, 16, N)
    out = []
    for g0 in range(0, B, GROUP):  # rows a thread holds at once; a group's
        xg = xp[g0 : g0 + GROUP]  # missing rows are zeros the kernel drops
        acc = torch.zeros(xg.shape[0], slices, 16, N)
        for p in range(passes):
            acc = fma(xg[:, :, p, :, None], wp[None, :, p], acc)
        # krow = warp * rows_a_warp + j: the shuffle tree over j, warps in order
        acc = tree(acc.view(-1, slices, warps, rows_a_warp, N).transpose(-1, -2))
        part = acc[:, :, 0]
        for wi in range(1, warps):
            part = part + acc[:, :, wi]
        s = part[:, 0]
        for sl in range(1, slices):
            s = s + part[:, sl]
        out.append(s)
    s = torch.cat(out)
    if colscale is not None:
        s = s * colscale
    s = s + bias
    return torch.relu(s) if relu else s


def rowvec_tiles(x, w, colscale, bias, relu=False, rows=LAUNCH_ROWS, cdt=None):
    """The wrapper's launches: ``rows`` rows at a time."""
    return torch.cat([rowvec_launch(x[r : r + rows], w, colscale, bias, relu, cdt)
                      for r in range(0, x.shape[0], rows)])


def block_order_sum(v, step=None):
    """(R, D) -> (R,): thread t of 256 folds ``step`` (default a sum) over
    v[:, t], v[:, t + 256], ... from 0, then a xor-shuffle tree from
    offset 16 down over each warp's 32 threads, then the 8 warps' totals
    added in order from 0."""
    R, D = v.shape
    per = -(-D // LN_THREADS)
    vp = torch.zeros(R, per * LN_THREADS)
    vp[:, :D] = v
    acc = torch.zeros(R, LN_THREADS)
    for j in range(per):  # a thread past D folds in zeros, which change no bit
        col = vp[:, j * LN_THREADS : (j + 1) * LN_THREADS]
        acc = acc + col if step is None else step(col, acc)
    total = torch.zeros(R)
    for w in range(LN_WARPS):
        t = acc[:, w * 32 : (w + 1) * 32]
        while t.shape[-1] > 1:  # offsets 16, 8, 4, 2, 1
            h = t.shape[-1] // 2
            t = t[:, :h] + t[:, h:]
        total = total + t[:, 0]
    return total


def ln_rows(v, gamma, beta):
    """LN of each row of v (R, D) in ``add_layernorm_kernel``'s order."""
    D = v.shape[1]
    mean = block_order_sum(v) / D
    d = v - mean[:, None]
    var = block_order_sum(d, lambda c, a: fma(c, c, a)) / D
    r = torch.rsqrt(var + ds.LN_EPS)
    return fma(d * r[:, None], gamma, beta)


def ln_tail(res, o, gamma, beta, fin=None, warps=4):
    """``rowvec_kernel``'s LN tail on a launch's rows: LN(res + o), then the
    final LN ``fin = (gamma2, beta2)`` where given; warp w of ``warps``
    takes rows w, w + warps, ..."""
    out = torch.empty_like(res)
    for w in range(warps):
        rows = slice(w, None, warps)
        v = ln_rows(res[rows] + o[rows], gamma, beta)
        out[rows] = v if fin is None else ln_rows(v + 0.0, *fin)
    return out


def row_scores(q, k, scale):
    """(B, R, H) scores of q (B, H, 8, dpl) against rows k (B, R, H, 8, dpl)."""
    s = torch.zeros(k.shape[:-1])
    for e in range(k.shape[-1]):
        s = fma(q[:, None, :, :, e], k[..., e], s)
    return tree(s) * scale


def attend_tiles(q, cache, n_cache, more, H, extra=None, separate=False):
    """``attend_kernel`` for q (B, D) f32 over, for each b, the first
    ``n_cache[b]`` rows of ``cache`` (B, L, 2D) bf16 or f32 then the rows of
    ``more[b]`` ((n_b, 2D), the same dtype: v4 chunk or verify window rows),
    then the
    current row ``extra = (k, v)`` (B, D) f32.  ``separate`` is the control:
    the cache's rows and the others as splits of their own."""
    B, D = q.shape
    HD = D // H
    dpl = HD // 8
    scale = 1.0 / np.sqrt(HD)
    seqs = [torch.cat([cache[b, : n_cache[b]], more[b]]) for b in range(B)]
    starts = [[0] * (n_cache[b] > 0) + [n_cache[b]] * (len(more[b]) > 0) if separate else [0]
              for b in range(B)]
    R = SPLIT * max(1, max(-(-len(s) // SPLIT) for s in seqs) + (1 if separate else 0))
    rows = torch.zeros(B, R, 2 * D)
    valid = torch.zeros(B, R, dtype=torch.bool)
    for b, s in enumerate(seqs):
        # each source starts a split of its own in the control, so shift
        # the chunk rows to the next multiple of 64
        pos = 0
        for i, st in enumerate(starts[b]):
            end = starts[b][i + 1] if i + 1 < len(starts[b]) else len(s)
            rows[b, pos : pos + end - st] = s[st:end].float()
            valid[b, pos : pos + end - st] = True
            pos = -(-(pos + end - st) // SPLIT) * SPLIT
    k = rows[..., :D].view(B, R, H, 8, dpl)
    v = rows[..., D:].view(B, R, H, 8, dpl)
    qv = q.view(B, H, 8, dpl)
    s = row_scores(qv, k, scale)
    s = torch.where(valid[..., None], s, -torch.inf)
    nsp = R // SPLIT
    # place in a split: st * 16 + warp * 4 + rl
    s = s.view(B, nsp, 4, 4, 4, H)
    v = v.view(B, nsp, 4, 4, 4, H, HD)
    m = s.amax(dim=(2, 3, 4))  # (B, nsp, H)
    p = torch.exp(s - m[:, :, None, None, None])
    p = torch.nan_to_num(p, nan=0.0)  # a split with no row: never merged
    l = torch.zeros(B, nsp, 4, 4, H)
    acc = torch.zeros(B, nsp, 4, 4, H, HD)
    for st in range(4):
        l = l + p[:, :, st]
        acc = fma(p[:, :, st, ..., None], v[:, :, st], acc)
    l = tree(l.transpose(-1, -2))  # over rl: (B, nsp, warp, H)
    acc = tree(acc.permute(0, 1, 2, 4, 5, 3))  # (B, nsp, warp, H, HD)
    lp, ap = l[:, :, 0], acc[:, :, 0]
    for wi in range(1, 4):
        lp, ap = lp + l[:, :, wi], ap + acc[:, :, wi]
    used = torch.tensor([bool(valid[b, sp * SPLIT:(sp + 1) * SPLIT].any()) for b in range(B)
                         for sp in range(nsp)]).view(B, nsp)
    M = torch.full((B, H), -torch.inf)
    if extra is not None:
        sx = row_scores(qv, extra[0].view(B, 1, H, 8, dpl), scale)[:, 0]
        M = sx
    for sp in range(nsp):
        M = torch.where(used[:, sp, None], torch.maximum(M, m[:, sp]), M)
    L, A = torch.zeros(B, H), torch.zeros(B, H, HD)
    for sp in range(nsp):
        c = torch.exp(m[:, sp] - M)
        u = used[:, sp, None]
        L = torch.where(u, fma(lp[:, sp], c, L), L)
        A = torch.where(u[..., None], fma(ap[:, sp], c[..., None], A), A)
    if extra is not None:
        c = torch.exp(sx - M)
        L = L + c
        A = fma(c[..., None], extra[1].view(B, H, HD), A)
    return (A / L[..., None]).reshape(B, D)


def layers_tiles(packed, x, self_kv, cross_kv, index, cross_len, *, H, F, rows=LAUNCH_ROWS,
                 chunk=None, window=False):
    """The v2 launches (``_launch_layers``) with both kernels emulated:
    logits (B, vpad) and new_kv (nl, B, 2D), in the caches' compute dtype
    (bf16 or f32; int8 weights with their column scales).  ``chunk = (rows
    (nl, t, B, 2D), ...)``: v4 token t after t chunk rows; ``window``: the
    B rows are one sequence's verify window over a cache of one batch
    row."""
    B, D = x.shape
    cdt = self_kv.dtype
    nl = packed["w_attn"].shape[0]
    new_kv = torch.zeros(nl, B, 2 * D, dtype=cdt)
    cl = cross_len.tolist()
    fin = (packed["fin_ln"][0], packed["fin_ln"][1]) if "fin_ln" in packed else None
    warps = TAIL_WARPS[packed["w_attn"].dtype]
    for i in range(nl):
        w, b, ln = packed["w_attn"][i], packed["bias"][i, 0], packed["ln"][i]
        sc = packed["scale"][i, 0] if "scale" in packed else None

        def mm(a, wm, lo, hi, relu=False):
            return rowvec_tiles(a, wm, None if sc is None else sc[lo:hi], b[lo:hi], relu, rows,
                                cdt)

        def add_ln(x, o, g, be, last=False):  # the tail of o's launches of ``rows`` rows
            return torch.cat([ln_tail(x[r : r + rows], o[r : r + rows], g, be,
                                      fin if last else None, warps)
                              for r in range(0, B, rows)])

        qkv = mm(x, w[:, : 3 * D], 0, 3 * D)
        new_kv[i] = qkv[:, D:].to(cdt)
        cache = self_kv[i].expand(B, -1, -1) if window else self_kv[i]
        if window:
            more = [new_kv[i, :j] for j in range(B)]
        elif chunk is not None:
            more = [chunk[i, :, j] for j in range(B)]
        else:
            more = [cache[j, :0] for j in range(B)]
        att = attend_tiles(qkv[:, :D], cache, [index] * B, more, H,
                           extra=(qkv[:, D : 2 * D], qkv[:, 2 * D :]))
        x = add_ln(x, mm(att, w[:, 3 * D : 4 * D], 3 * D, 4 * D), ln[0], ln[1])
        qc = mm(x, w[:, 4 * D : 5 * D], 4 * D, 5 * D)
        cross = cross_kv[i].expand(B, -1, -1) if window else cross_kv[i]
        att = attend_tiles(qc, cross, cl * (B if window else 1), [cross[j, :0] for j in range(B)], H)
        x = add_ln(x, mm(att, w[:, 5 * D : 6 * D], 5 * D, 6 * D), ln[2], ln[3])
        h = mm(x, packed["w_ff1"][i], 6 * D, 6 * D + F, relu=True)
        x = add_ln(x, mm(h, packed["w_ff2"][i], 6 * D + F, 7 * D + F), ln[4], ln[5],
                   last=i == nl - 1)
    return rowvec_tiles(x, packed["fc_w"], None, packed["fc_b"], rows=rows,
                        cdt=torch.float32), new_kv


def _close(got, want):
    return torch.allclose(got, want, atol=ATOL, rtol=RTOL)


RNG = np.random.default_rng(2026)


@pytest.mark.parametrize("kind", ["bf16", "int8", "f32", "int8-f32"])
@pytest.mark.parametrize("K,N,relu", [(128, 192, False), (512, 64, True), (2048, 128, False),
                                      (100, 64, False)])
def test_rowvec_tiles_match_the_twin(kind, K, N, relu):
    """The split-K schedule computes ``_rowvec_math``'s function: K from one
    slice of 16 to 32 slices of 64 and a ragged K, for each weight type and
    int8 in an f32 model (x unrounded); an f32 model's kinds within
    ``F32_ATOL``."""
    rng = np.random.default_rng(K + N)
    x = torch.from_numpy(rng.standard_normal((5, K)).astype(np.float32))
    wf = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)) / np.sqrt(K)
    bias = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    sc, cdt = None, torch.float32 if kind.endswith("f32") else torch.bfloat16
    if kind.startswith("int8"):
        w, sc = ds.quantize_columns(wf)
        sc = sc[0]
    elif kind == "bf16":
        w = wf.to(torch.bfloat16)
    else:
        w = wf
    got = rowvec_tiles(x, w, sc, bias, relu, cdt=cdt)
    want = ds._rowvec_math(x, w, cdt, sc) + bias
    want = torch.relu(want) if relu else want
    assert _close(got, want), (got - want).abs().max()
    if cdt == torch.float32:
        assert torch.allclose(got, want, atol=F32_ATOL, rtol=0), (got - want).abs().max()
    if kind == "int8-f32":  # x unrounded: not the bf16 model's int8 sums
        assert not torch.equal(got, rowvec_tiles(x, w, sc, bias, relu))


def _rows_launch_independent(x, w, sc, bias, relu=False, cdt=None):
    whole = rowvec_tiles(x, w, sc, bias, relu, cdt=cdt)
    for rows in (1, 3, 4, 16):
        assert torch.equal(rowvec_tiles(x, w, sc, bias, relu, rows=rows, cdt=cdt), whole)
    assert torch.equal(rowvec_launch(x[16:], w, sc, bias, relu, cdt), whole[16:])


def test_rowvec_rows_do_not_depend_on_the_launch():
    """A row's bits are the same launched alone, in a launch of 3, 4 or 16
    rows, or as row 17 of 24 (the second launch of a 24-row window)."""
    x = torch.from_numpy(RNG.standard_normal((24, 512)).astype(np.float32))
    w = torch.from_numpy(RNG.standard_normal((512, 192)).astype(np.float32)).to(torch.bfloat16)
    bias = torch.from_numpy(RNG.standard_normal(192).astype(np.float32))
    _rows_launch_independent(x, w, None, bias)


@pytest.mark.parametrize("kind,relu", [("f32", False), ("f32", True), ("int8-f32", False),
                                       ("int8-f32", True)])
def test_rowvec_rows_do_not_depend_on_the_launch_f32(kind, relu):
    """The same on an f32 model: f32 W (blocks of 8 warps, two K rows a
    warp) and int8 W reading x unrounded, with and without the ReLU."""
    rng = np.random.default_rng(10 * len(kind) + relu)
    x = torch.from_numpy(rng.standard_normal((24, 512)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((512, 192)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(192).astype(np.float32))
    sc = None
    if kind == "int8-f32":
        w, sc = ds.quantize_columns(w)
        sc = sc[0]
    _rows_launch_independent(x, w, sc, bias, relu, cdt=torch.float32)


def _ln_inputs(R, D, seed):
    """res, o (R, D) and two (gamma, beta) pairs as a trained model's, f32."""
    rng = np.random.default_rng(seed)
    res, o = (torch.from_numpy(rng.standard_normal((R, D)).astype(np.float32)) for _ in range(2))
    pairs = [(torch.from_numpy((1 + 0.2 * rng.standard_normal(D)).astype(np.float32)),
              torch.from_numpy((0.5 * rng.standard_normal(D)).astype(np.float32)))
             for _ in range(2)]
    return res, 3.0 * o + 1.0, pairs


@pytest.mark.parametrize("D", [128, 512])
def test_ln_tail_matches_twin_and_jax(D):
    """The LN tail's order of sums computes the twin's ``_layernorm`` and
    JAX's ``_layernorm`` (``ops/decode_step.py:166``, the TPU kernels' LN)
    on the same numpy-seeded inputs within ATOL + RTOL, alone and with the
    final LN chained; and the twin to f32 rounding (1e-5)."""
    res, o, ((g, b), (g2, b2)) = _ln_inputs(16, D, seed=D)
    got, got_fin = ln_tail(res, o, g, b), ln_tail(res, o, g, b, fin=(g2, b2))
    want = ds._layernorm(res + o, g, b)
    want_fin = ds._layernorm(want, g2, b2)
    j = jax_layernorm(jnp.asarray((res + o).numpy()), jnp.asarray(g.numpy()), jnp.asarray(b.numpy()))
    j_fin = jax_layernorm(j, jnp.asarray(g2.numpy()), jnp.asarray(b2.numpy()))
    for a, tw, jx in ((got, want, j), (got_fin, want_fin, j_fin)):
        assert torch.allclose(a, tw, atol=1e-5, rtol=1e-5), (a - tw).abs().max()
        assert _close(a, tw) and _close(a, torch.from_numpy(np.array(jx)))


def test_ln_tail_rows_do_not_depend_on_the_launch():
    """A row's bits are the same whatever the launch's rows (1..16), the warp
    that takes it (4 warps of a bf16 block or of an f32 one, 2 of an int8
    one) or its place; with and without the final LN."""
    res, o, (ln, fin) = _ln_inputs(16, 512, seed=9)
    for f in (None, fin):
        alone = torch.cat([ln_tail(res[r : r + 1], o[r : r + 1], *ln, f) for r in range(16)])
        for nb in range(1, 17):
            for warps in (4, 2):
                assert torch.equal(ln_tail(res[:nb], o[:nb], *ln, f, warps), alone[:nb]), (nb, warps)
        tail = ln_tail(res[5:], o[5:], *ln, f)
        assert torch.equal(tail, alone[5:])


def _attend_inputs(B, L, D, seed, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    cache = torch.from_numpy(rng.standard_normal((B, L, 2 * D)).astype(np.float32)).to(dtype)
    extra = tuple(torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)) for _ in range(2))
    return q, cache, extra


def _attend_tiles_against_twin(lens, dtype, H, D):
    q, cache, extra = _attend_inputs(3, 320, D, seed=sum(lens), dtype=dtype)
    n = torch.tensor(lens)
    none = [cache[b, :0] for b in range(3)]
    keep = [b for b in range(3) if lens[b] > 0]  # no row and no current row: 0 / 0 in both
    for ex, rows in ((extra, slice(None)), (None, keep)):
        got = attend_tiles(q, cache, lens, none, H, extra=ex)[rows]
        want = ds._attend(q, cache, n, H, extra_kv=ex)[rows]
        assert _close(got, want)
        if dtype == torch.float32:
            assert torch.allclose(got, want, atol=F32_ATOL, rtol=0), (got - want).abs().max()


@pytest.mark.parametrize("lens", [[300, 1, 64], [0, 65, 200], [128, 127, 129]])
def test_attend_tiles_match_the_twin(lens):
    """Splits of 64 rows merged in order compute ``_attend``'s function,
    with and without the current row, over ragged row counts."""
    _attend_tiles_against_twin(lens, torch.bfloat16, H=2, D=128)


@pytest.mark.parametrize("lens", [[300, 1, 64], [0, 65, 200]])
@pytest.mark.parametrize("hd", [64, 128])
def test_attend_tiles_match_the_twin_f32(lens, hd):
    """The same over f32 rows (an f32 model's caches), each lane's dims and
    order those of the bf16 rows, at head_dim 64 and 128: within
    ``F32_ATOL`` of the twin."""
    _attend_tiles_against_twin(lens, torch.float32, H=2, D=2 * hd)


def test_attend_bits_do_not_depend_on_where_the_cache_ends():
    """One spliced sequence of 150 rows, its first c rows from the cache and
    the rest from the chunk (or window), for c on both sides of a split's
    edge: the same bits at every c.  The control, the cache's rows and the
    chunk's as splits of their own, moves them."""
    _attend_splice_invariant(torch.bfloat16)


def test_attend_bits_do_not_depend_on_where_the_cache_ends_f32():
    """The same over f32 rows."""
    _attend_splice_invariant(torch.float32)


def _attend_splice_invariant(dtype):
    H, D, n = 2, 128, 150
    q, cache, extra = _attend_inputs(2, n, D, seed=5, dtype=dtype)
    want = attend_tiles(q, cache, [n, n], [cache[b, n:] for b in range(2)], H, extra=extra)
    for c in (0, 1, 63, 64, 65, 128, 149):
        got = attend_tiles(q, cache, [c, c], [cache[b, c:n] for b in range(2)], H, extra=extra)
        assert torch.equal(got, want), c
    control = attend_tiles(q, cache, [100, 100], [cache[b, 100:n] for b in range(2)], H,
                           extra=extra, separate=True)
    assert not torch.equal(control, want)
    assert _close(control, want)


@pytest.fixture(scope="module")
def step_setup():
    vocab = WordVocab(0, CONTROL_SETS[5])
    jmodel, params, tmodel = model_pair(vocab.vocab_size, seed=31)
    vpad = ds.vocab_pad(vocab.vocab_size)
    cfg = jmodel.cfg
    packed = ds.pack_decoder_weights(tmodel, vpad)
    for k in ("w_attn", "w_ff1", "w_ff2"):  # the card's bf16 weights
        packed[k] = packed[k].to(torch.bfloat16)
    return jmodel, params, packed, cfg, vpad


def _step_inputs(B, D, nl, L, S, seed, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    self_kv = torch.from_numpy(rng.standard_normal((nl, B, L, 2 * D)).astype(np.float32))
    cross_kv = torch.from_numpy(rng.standard_normal((nl, B, S, 2 * D)).astype(np.float32))
    cross_len = torch.tensor([S - 37 * b for b in range(B)], dtype=torch.int32)
    return x.to(dtype).float(), self_kv.to(dtype), cross_kv.to(dtype), cross_len


@pytest.fixture(scope="module")
def f32_setup():
    """The f32 model of ``step_setup``'s seed, packed as it is (f32) and
    with int8 weights (quantized from the same f32 parameters)."""
    vocab = WordVocab(0, CONTROL_SETS[5])
    jmodel, params, tmodel = model_pair(vocab.vocab_size, seed=31)
    vpad = ds.vocab_pad(vocab.vocab_size)
    packed = {q: ds.pack_decoder_weights(tmodel, vpad, quant=q) for q in ("none", "int8")}
    return jmodel, packed, jmodel.cfg, vpad


def test_decode_step_tiles_match_twin_and_jax(step_setup):
    """A whole v2 step through both emulated kernels against the twin and
    against JAX's Pallas step (interpret mode) on the same bf16 weights and
    caches: logits and new_kv within ATOL + RTOL."""
    _, _, packed, cfg, vpad = step_setup
    D, nl, H, F = cfg.d_model, cfg.num_decoder_layers, cfg.nhead, cfg.d_ff
    index = 150
    x, self_kv, cross_kv, cross_len = _step_inputs(3, D, nl, 512, 512, seed=3)
    got, got_kv = layers_tiles(packed, x, self_kv, cross_kv, index, cross_len, H=H, F=F)
    kw = dict(n_layers=nl, d_model=D, nhead=H, d_ff=F, vpad=vpad)
    want, want_kv = ds.fused_decode_step_reference(packed, x, self_kv, cross_kv, index, cross_len,
                                                   **kw)
    V = cfg.vocab_size
    assert _close(got[:, :V], want[:, :V]) and _close(got_kv.float(), want_kv.float())
    mats = ("w_attn", "w_ff1", "w_ff2")
    jpacked = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16 if k in mats else jnp.float32)
               for k, v in packed.items()}
    jl, jkv = jax_step(jpacked, jnp.asarray(x.numpy(), jnp.bfloat16),
                       jnp.asarray(self_kv.float().numpy(), jnp.bfloat16),
                       jnp.asarray(cross_kv.float().numpy(), jnp.bfloat16), jnp.int32(index),
                       jnp.asarray(cross_len.numpy()), interpret=True, **kw)
    jl = torch.from_numpy(np.asarray(jl, np.float32))
    jkv = torch.from_numpy(np.asarray(jnp.asarray(jkv, jnp.float32)))
    assert _close(got[:, :V], jl[:, :V]) and _close(got_kv.float(), jkv)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_decode_step_tiles_match_twin_and_jax_f32(f32_setup, quant):
    """A whole v2 step of an f32 model through both emulated kernels (f32
    weights, or int8 weights reading x unrounded; f32 caches; the LN tails
    and the ReLU on f32 blocks) against the twin and against JAX's f32
    Pallas step (interpret mode): logits and new_kv within F32_ATOL, and
    new_kv in f32."""
    jmodel, packs, cfg, vpad = f32_setup
    packed = packs[quant]
    D, nl, H, F = cfg.d_model, cfg.num_decoder_layers, cfg.nhead, cfg.d_ff
    index = 150
    x, self_kv, cross_kv, cross_len = _step_inputs(3, D, nl, 512, 512, seed=13,
                                                   dtype=torch.float32)
    got, got_kv = layers_tiles(packed, x, self_kv, cross_kv, index, cross_len, H=H, F=F)
    assert got_kv.dtype == torch.float32
    kw = dict(n_layers=nl, d_model=D, nhead=H, d_ff=F, vpad=vpad)
    want, want_kv = ds.fused_decode_step_reference(packed, x, self_kv, cross_kv, index, cross_len,
                                                   **kw)
    V = cfg.vocab_size
    jpacked = {k: jnp.asarray(v.numpy()) for k, v in packed.items()}
    jl, jkv = jax_step(jpacked, jnp.asarray(x.numpy()), jnp.asarray(self_kv.numpy()),
                       jnp.asarray(cross_kv.numpy()), jnp.int32(index),
                       jnp.asarray(cross_len.numpy()), interpret=True, **kw)
    jl, jkv = torch.from_numpy(np.array(jl)), torch.from_numpy(np.array(jkv))
    for other, other_kv in ((want, want_kv), (jl, jkv)):
        assert torch.allclose(got[:, :V], other[:, :V], atol=F32_ATOL, rtol=0), \
            (got[:, :V] - other[:, :V]).abs().max()
        assert torch.allclose(got_kv, other_kv, atol=F32_ATOL, rtol=0), (got_kv - other_kv).abs().max()


def test_verify_and_chunk_rows_equal_sequential_steps(step_setup):
    """Phase 2e's and 2c's invariants in the emulated schedule: a verify
    window of 20 rows (launches of 16 + 4) is bit-equal, row by row, to 20
    v2 steps over the spliced cache; a v4 token after t chunk rows is
    bit-equal to the v2 step over the cache holding them."""
    _, _, packed, cfg, _ = step_setup
    D, nl, H, F = cfg.d_model, cfg.num_decoder_layers, cfg.nhead, cfg.d_ff
    W, index = 20, 100
    x, self_kv, cross_kv, cross_len = _step_inputs(W, D, nl, 256, 200, seed=4)
    self_kv, cross_kv, cross_len = self_kv[:, :1], cross_kv[:, :1], cross_len[:1]
    logits, new_kv = layers_tiles(packed, x, self_kv, cross_kv, index, cross_len, H=H, F=F,
                                  window=True)
    cache = self_kv.clone()
    for j in range(W):
        lg, kv = layers_tiles(packed, x[j : j + 1], cache, cross_kv, index + j, cross_len, H=H, F=F)
        cache[:, :, index + j] = kv
        assert torch.equal(lg[0], logits[j]) and torch.equal(kv[:, 0], new_kv[:, j]), j
    # v4: token t attends the cache below index and chunk rows 0..t-1
    B, t = 3, 5
    x, self_kv, cross_kv, cross_len = _step_inputs(B, D, nl, 256, 200, seed=6)
    chunk = self_kv[:, :, index : index + t].transpose(1, 2).contiguous()  # (nl, t, B, 2D)
    got, got_kv = layers_tiles(packed, x, self_kv, cross_kv, index, cross_len, H=H, F=F,
                               chunk=chunk)
    want, want_kv = layers_tiles(packed, x, self_kv, cross_kv, index + t, cross_len, H=H, F=F)
    assert torch.equal(got, want) and torch.equal(got_kv, want_kv)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_verify_and_chunk_rows_equal_sequential_steps_f32(f32_setup, quant):
    """The same invariants on an f32 model: a verify window of 18 rows
    (launches of 16 + 2; f32 weights, as the verify takes no int8) bit-equal
    row by row to 18 v2 steps, and a v4 token after t chunk rows bit-equal
    to the v2 step over the cache holding them (f32 and int8 weights)."""
    _, packs, cfg, _ = f32_setup
    packed = packs[quant]
    D, nl, H, F = cfg.d_model, cfg.num_decoder_layers, cfg.nhead, cfg.d_ff
    index = 100
    if quant == "none":
        W = 18
        x, self_kv, cross_kv, cross_len = _step_inputs(W, D, nl, 256, 200, seed=14,
                                                       dtype=torch.float32)
        self_kv, cross_kv, cross_len = self_kv[:, :1], cross_kv[:, :1], cross_len[:1]
        logits, new_kv = layers_tiles(packed, x, self_kv, cross_kv, index, cross_len, H=H, F=F,
                                      window=True)
        cache = self_kv.clone()
        for j in range(W):
            lg, kv = layers_tiles(packed, x[j : j + 1], cache, cross_kv, index + j, cross_len,
                                  H=H, F=F)
            cache[:, :, index + j] = kv
            assert torch.equal(lg[0], logits[j]) and torch.equal(kv[:, 0], new_kv[:, j]), j
    B, t = 3, 5
    x, self_kv, cross_kv, cross_len = _step_inputs(B, D, nl, 256, 200, seed=15, dtype=torch.float32)
    chunk = self_kv[:, :, index : index + t].transpose(1, 2).contiguous()
    got, got_kv = layers_tiles(packed, x, self_kv, cross_kv, index, cross_len, H=H, F=F,
                               chunk=chunk)
    want, want_kv = layers_tiles(packed, x, self_kv, cross_kv, index + t, cross_len, H=H, F=F)
    assert torch.equal(got, want) and torch.equal(got_kv, want_kv)


# ----------------------------------------------------------------------
# the launch plan's addressing, with a host stand-in for the library
# ----------------------------------------------------------------------
class HostLib:
    """Stands in for the CUDA library on CPU tensors: each entry point
    ``_launch_layers`` calls reads and writes host memory at the pointers
    and strides it is given, with the twins' math (``_rowvec_math``,
    ``_attend``, ``_layernorm``), and checks what the kernels require of a
    launch (at most 16 rows a row-vector launch, 16-byte W pieces, a split
    grid that covers every row, a workspace and tickets).  It has no
    ``smer_add_layernorm``: every LayerNorm of the plan is a row-vector
    launch's tail, and a plan that called it would fail."""

    _CT = {torch.float32: ctypes.c_float, torch.bfloat16: ctypes.c_uint16,
           torch.int8: ctypes.c_int8, torch.int32: ctypes.c_int32}

    def __init__(self):
        self.rowvec_rows = []
        self.rowvec_kinds = []  # smer_rowvec's w_kind a launch
        self.attend_kinds = []  # the K|V rows' dtype a launch
        self.rowvec_tails = []  # a launch's (LN tail, final LN chained)

    def _mat(self, ptr, rows, cols, ld, dtype):
        n = (rows - 1) * ld + cols
        flat = torch.frombuffer((self._CT[dtype] * n).from_address(ptr), dtype=dtype)
        return flat.as_strided((rows, cols), (ld, 1))

    def smer_rowvec(self, kind, relu, nb, x, ldx, w, ldw, cs, bias, y, ldy, kv, ldkv, kv_col0, K,
                    N, k_split, res, ldr, gamma, beta, gamma2, beta2, eps, ws, tickets, stream):
        wdt = (torch.bfloat16, torch.float32, torch.int8, torch.int8)[kind]
        cdt = torch.float32 if kind in (1, 3) else torch.bfloat16  # x rounded, K|V written
        vec = 16 // torch.tensor([], dtype=wdt).element_size()
        assert 1 <= nb <= LAUNCH_ROWS and N % vec == 0 and ldw % vec == 0 and w % 16 == 0
        assert k_split == ds.rowvec_k_split(K, N) and ws and tickets
        self.rowvec_rows.append(nb)
        self.rowvec_kinds.append(kind)
        self.rowvec_tails.append((res is not None, gamma2 is not None))
        xs = self._mat(x, nb, K, ldx, torch.float32)
        wm = self._mat(w, K, N, ldw, wdt)
        sc = self._mat(cs, 1, N, N, torch.float32)[0] if cs is not None else None
        assert (cs is not None) == (kind >= 2)
        # row by row, as the kernel's sums are (a batched CPU product may
        # round a row's sums apart from the same row alone)
        out = torch.cat([ds._rowvec_math(xs[r : r + 1], wm, cdt, sc) for r in range(nb)])
        out = out + self._mat(bias, 1, N, N, torch.float32)[0]
        out = torch.relu(out) if relu else out
        self._mat(y, nb, N, ldy, torch.float32).copy_(out)
        if kv is not None:
            self._mat(kv, nb, N - kv_col0, ldkv, cdt).copy_(out[:, kv_col0:])
        if res is not None:  # the LN tail: res = LN(res + out) [then the final LN], in place
            assert not relu and eps == ds.LN_EPS
            assert gamma and beta and (gamma2 is None) == (beta2 is None)
            r = self._mat(res, nb, N, ldr, torch.float32)

            def vec(ptr):
                return self._mat(ptr, 1, N, N, torch.float32)[0]

            v = ds._layernorm(r + out, vec(gamma), vec(beta))
            r.copy_(v if gamma2 is None else ds._layernorm(v, vec(gamma2), vec(beta2)))
        return 0

    def smer_attend(self, HD, kv_f32, B, H, q, ldq, kv, bstride, D, n_rows, lens, max_rows, source,
                    rows, tstride, n_chunk, extra, ld_extra, out, ldo, scale, n_splits, ws, tickets,
                    stream):
        assert ws and tickets and abs(scale - 1 / np.sqrt(HD)) < 1e-7
        kdt = torch.float32 if kv_f32 else torch.bfloat16
        es = kdt.itemsize
        self.attend_kinds.append(kdt)
        qs = self._mat(q, B, D, ldq, torch.float32)
        n_cache = (self._mat(lens, 1, B, B, torch.int32)[0].tolist() if lens is not None
                   else [n_rows] * B)
        for b in range(B):
            nc = max(0, min(n_cache[b], max_rows))
            seq = [self._mat(kv + es * b * bstride, max(nc, 1), 2 * D, 2 * D, kdt)[:nc]]
            n_more = (n_chunk if source == ds._ROWS_CHUNK else b if source == ds._ROWS_WINDOW
                      else 0)
            if n_more:
                base = rows + (es * b * 2 * D if source == ds._ROWS_CHUNK else 0)
                seq.append(self._mat(base, n_more, 2 * D, tstride, kdt))
            seq = torch.cat(seq)
            assert n_splits * SPLIT >= len(seq)
            ex = None
            if extra is not None:
                e = self._mat(extra + 4 * b * ld_extra, 1, 2 * D, 2 * D, torch.float32)
                ex = (e[:, :D], e[:, D:])
            att = ds._attend(qs[b : b + 1], seq[None], torch.tensor([len(seq)]), H, extra_kv=ex)
            self._mat(out + 4 * b * ldo, 1, D, D, torch.float32).copy_(att)
        return 0



@pytest.fixture(scope="module")
def bf16_model():
    vocab = WordVocab(0, CONTROL_SETS[5])
    _, _, tmodel = model_pair(vocab.vocab_size, seed=41)
    vpad = ds.vocab_pad(vocab.vocab_size)
    return tmodel, vpad


@pytest.mark.parametrize("mode,quant", [("step", "none"), ("step", "int8"), ("chunk", "none"),
                                        ("chunk", "int8"), ("window", "none")])
def test_launch_plan_addresses_what_the_twin_reads(bf16_model, mode, quant):
    """``_launch_layers`` hands the library the pointers and strides of
    every weight, bias, scale strip, LayerNorm row, cache row, chunk or
    window row and output, and splits a window into row-vector launches of
    16 rows; run on CPU tensors through ``HostLib`` it computes the twin's
    step: v2
    at B=3, v4 token t = 5 over the cache below index and 5 chunk rows, and
    a verify window of 20 rows (row-vector launches of 16 + 4; the verify
    takes no int8 weights, as in JAX).  Every LayerNorm runs as the tail of
    a row-vector launch, 3 a layer (each part of 16 rows its own), the
    final LN chained on the last, and ``smer_add_layernorm`` not at all."""
    _launch_plan_case(*bf16_model, mode, quant, torch.bfloat16)


@pytest.mark.parametrize("mode,quant", [("step", "none"), ("step", "int8"), ("chunk", "none"),
                                        ("chunk", "int8"), ("window", "none")])
def test_launch_plan_addresses_what_the_twin_reads_f32(bf16_model, mode, quant):
    """The same plan on an f32 model: f32 caches, chunk and window rows and
    new_kv (``smer_attend``'s K|V in f32), the matrices f32 or int8 in the
    f32 model (``smer_rowvec``'s kinds 1 and 3), every LayerNorm a tail;
    logits and new_kv within 1e-4 of the f32 twin."""
    _launch_plan_case(*bf16_model, mode, quant, torch.float32)


def _launch_plan_case(tmodel, vpad, mode, quant, dtype):
    cfg = tmodel.cfg
    D, nl, H, F = cfg.d_model, cfg.num_decoder_layers, cfg.nhead, cfg.d_ff
    packed = ds.pack_decoder_weights(tmodel, vpad, quant=quant)
    if quant == "none":
        for k in ("w_attn", "w_ff1", "w_ff2"):
            packed[k] = packed[k].to(dtype)
    B, index, t = {"step": 3, "chunk": 3, "window": 20}[mode], 100, 5
    x, self_kv, cross_kv, cross_len = _step_inputs(B, D, nl, 256, 200, seed=8, dtype=dtype)
    if mode == "window":
        self_kv, cross_kv = self_kv[:, :1].contiguous(), cross_kv[:, :1].contiguous()
        cross_len = cross_len[:1]
    lib = HostLib()
    logits = torch.empty(B, vpad)
    new_kv = torch.empty(nl, B, 2 * D, dtype=dtype)
    chunk = None
    if mode == "chunk":
        rows = torch.empty(nl, t + 1, B, 2 * D, dtype=dtype)
        rows[:, :t] = self_kv[:, :, index : index + t].transpose(1, 2)
        chunk, new_kv = (rows, t), rows[:, t]
    kw = dict(n_layers=nl, d_model=D, nhead=H, d_ff=F, vpad=vpad)
    ds._launch_layers(lib, packed, x.clone(), self_kv, cross_kv, index,
                      cross_len.expand(B).contiguous() if mode == "window" else cross_len,
                      logits, new_kv, n_layers=nl, D=D, H=H, F=F, vpad=vpad, stream=0,
                      chunk=chunk, window=mode == "window")
    if mode == "window":
        want, want_kv = ds.fused_verify_window_reference(packed, x, self_kv, cross_kv, index,
                                                         cross_len, **kw)
        assert lib.rowvec_rows.count(16) == lib.rowvec_rows.count(4) == 6 * nl + 1
    else:
        at = index + (t if mode == "chunk" else 0)
        want, want_kv = ds.fused_decode_step_reference(packed, x, self_kv, cross_kv, at, cross_len,
                                                       **kw)
    assert torch.allclose(logits, want, atol=1e-4, rtol=1e-4)
    kv_tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert new_kv.dtype == dtype
    assert torch.allclose(new_kv.float(), want_kv.float(), atol=kv_tol, rtol=kv_tol)
    # the matrices' kind (smer_rowvec's w_kind) by the model's dtype, the
    # logits f32 in both; the attention's K|V rows in the compute dtype
    layer_kind = {(torch.bfloat16, "none"): 0, (torch.bfloat16, "int8"): 2,
                  (torch.float32, "none"): 1, (torch.float32, "int8"): 3}[dtype, quant]
    parts = -(-B // LAUNCH_ROWS)
    assert lib.rowvec_kinds == [layer_kind] * (6 * nl * parts) + [1] * parts
    assert lib.attend_kinds == [dtype] * (2 * nl)
    tails = [i for i, (tail, _) in enumerate(lib.rowvec_tails) if tail]
    fins = [i for i, (_, fin) in enumerate(lib.rowvec_tails) if fin]
    assert len(lib.rowvec_tails) == (6 * nl + 1) * parts and len(tails) == 3 * nl * parts
    assert "fin_ln" in packed and fins == tails[-parts:]


@pytest.mark.parametrize("cache,weights,ok", [
    (torch.bfloat16, torch.bfloat16, True),
    (torch.bfloat16, torch.int8, True),
    (torch.float32, torch.float32, True),
    (torch.float32, torch.int8, True),
    (torch.bfloat16, torch.float32, False),
    (torch.float32, torch.bfloat16, False),
    (torch.float16, torch.float16, False),
], ids=["bf16", "bf16-int8", "f32", "f32-int8", "bf16-cache-f32-weights",
        "f32-cache-bf16-weights", "f16"])
def test_layer_inputs_take_the_compute_dtype(bf16_model, cache, weights, ok):
    """The CUDA wrappers' check of the packed weights and the caches: the
    caches in the model's compute dtype (bf16 or f32), the matrices in it
    or int8; a mixed pair, or a dtype the kernels have no instantiation
    for, raises ``TypeError`` before any launch."""
    tmodel, vpad = bf16_model
    cfg = tmodel.cfg
    D, nl, H, F = cfg.d_model, cfg.num_decoder_layers, cfg.nhead, cfg.d_ff
    packed = ds.pack_decoder_weights(tmodel, vpad, quant="int8" if weights == torch.int8 else "none")
    if weights != torch.int8:
        for k in ("w_attn", "w_ff1", "w_ff2"):
            packed[k] = packed[k].to(weights)
    B, L, S = 2, 64, 48
    self_kv = torch.zeros(nl, B, L, 2 * D, dtype=cache)
    cross_kv = torch.zeros(nl, B, S, 2 * D, dtype=cache)
    cross_len = torch.full((B,), S, dtype=torch.int32)
    args = (packed, B, self_kv.device, self_kv, cross_kv, cross_len, nl, D, H, F, vpad)
    if ok:
        ds._check_layer_inputs(*args)
        # a cross cache in the other dtype is refused all the same
        other = torch.float32 if cache == torch.bfloat16 else torch.bfloat16
        with pytest.raises(TypeError):
            ds._check_layer_inputs(packed, B, self_kv.device, self_kv, cross_kv.to(other),
                                   cross_len, nl, D, H, F, vpad)
    else:
        with pytest.raises(TypeError):
            ds._check_layer_inputs(*args)


def test_rowvec_int8_twin_takes_the_compute_dtype():
    """``rowvec_int8`` on CPU tensors: x rounded to bf16 in a bf16 model and
    read as it is in an f32 model, as JAX casts x and the int8 block to the
    compute dtype (:306-319)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 128)).astype(np.float32))
    q, sc = ds.quantize_columns(torch.from_numpy(rng.standard_normal((128, 64)).astype(np.float32)))
    b = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    for cdt in (torch.bfloat16, torch.float32):
        want = (x.to(cdt).double() @ q.double()) * sc[0].double() + b.double()
        got = ds.rowvec_int8(x, q, sc[0], b, compute_dtype=cdt)
        assert torch.allclose(got.double(), want, atol=1e-4, rtol=1e-5)
    assert not torch.equal(ds.rowvec_int8(x, q, sc[0], b),
                           ds.rowvec_int8(x, q, sc[0], b, compute_dtype=torch.float32))
