"""Data- and tensor-parallel training across processes, one a device.

What JAX gets from ``jax.device_put`` with ``train_state_shardings`` and
``pjit`` (``train/loop.py:152-192``), written out with ``torch.distributed``:

* the batch's rows split over ``(dcn, dp)``: every rank builds the same
  global batch and keeps its own contiguous rows; gradients are SUMMED over
  ``(dp, dcn)``, since each rank's loss is its share of the global loss
  (its token sum over the global denominator, ``train/state.py``);
* Megatron tensor parallelism over ``tp`` by ``parallel.mesh._param_spec``:
  column-parallel q/k/v, ``ff.fc1`` and the logit ``fc`` (its output
  gathered), row-parallel ``out`` and ``ff.fc2`` (an all-reduce, the bias
  added once after it), the embedding's D columns split and gathered after
  the lookup.  Each rank holds ``nhead / tp`` whole heads.  The biases stay
  replicated, as in JAX's rules: a column-parallel layer adds its slice, so
  that bias's gradient is summed over tp;
* dropout bits that do not depend on the layout: every plain dropout mask is
  drawn at its GLOBAL shape from the generator all ranks share and sliced to
  this rank's rows and heads (or FFN columns), and the dropout-attention
  kernels hash the global (b, h) (``ops.train_attention``), so a sharded
  step keeps the single-process step's bits, as JAX's masks do
  (``tests/test_parallel.py:103-105``).

The model's modules read a :class:`ShardContext` from their ``shard``
attribute (None: one process); :func:`shard_train_state` sets it, slices the
parameters and Adam's moments, and :func:`full_train_state` gathers them
back for a checkpoint, which therefore restores at any layout.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import COLUMN, ROW, TP_AXIS, ProcessMesh, _leaf_spec


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over ``group``; nothing to do on a group of one."""
    if _group_size(group) > 1:
        dist.all_reduce(t, group=group)
    return t


class _CopyToTP(torch.autograd.Function):
    """Megatron's f: identity forward, gradient summed over tp."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's g: sum over tp forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """All-gather along ``dim`` forward; the backward takes this rank's
    slice, since the gradient of a replicated activation is the same on
    every tp rank."""

    @staticmethod
    def forward(ctx, x, group, dim, index, size):
        ctx.dim, ctx.index, ctx.n = dim, index, x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n).contiguous(), None, None, None, None


class ShardContext:
    """This rank's place in sharded training, as the model's modules read
    it: its batch shard (``row_shard`` of ``row_shards``), its tp index and
    size, and the groups of the three mesh axes."""

    def __init__(self, pm: ProcessMesh):
        self.pm = pm
        self.row_shard, self.row_shards = pm.row_shard, pm.row_shards
        self.tp_index, self.tp = pm.tp_index, pm.tp
        self.tp_group = pm.group(TP_AXIS)
        self.dp_group, self.dcn_group = pm.group("dp"), pm.group("dcn")

    def rand(self, shape: Sequence[int], generator, device, tp_dim: Optional[int] = None) -> torch.Tensor:
        """Uniforms for a local tensor of ``shape``: drawn at the global
        shape (rows x row_shards, dim ``tp_dim`` x tp) and sliced to this
        rank's rows and tp part."""
        shape = list(shape)
        full = list(shape)
        full[0] *= self.row_shards
        if tp_dim is not None:
            full[tp_dim] *= self.tp
        u = torch.rand(full, generator=generator, device=device)
        u = u.narrow(0, self.row_shard * shape[0], shape[0])
        if tp_dim is not None:
            u = u.narrow(tp_dim, self.tp_index * shape[tp_dim], shape[tp_dim])
        return u

    def copy_to_tp(self, x):
        return x if self.tp == 1 else _CopyToTP.apply(x, self.tp_group)

    def reduce_from_tp(self, x):
        return x if self.tp == 1 else _ReduceFromTP.apply(x, self.tp_group)

    def gather_from_tp(self, x, dim: int = -1):
        if self.tp == 1:
            return x
        return _GatherFromTP.apply(x, self.tp_group, dim % x.dim(), self.tp_index, self.tp)

    def sum_rows_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the batch shards, (dp) then (dcn), in place."""
        return all_reduce_(all_reduce_(t, self.dp_group), self.dcn_group)


# ----------------------------------------------------------------------
# placing a train state on the mesh
# ----------------------------------------------------------------------
def _local(t: torch.Tensor, spec, ctx: ShardContext) -> torch.Tensor:
    """This rank's tp slice of a full tensor by its spec."""
    for dim, axis in enumerate(spec):
        if axis == TP_AXIS:
            n = t.shape[dim] // ctx.tp
            return t.narrow(dim, ctx.tp_index * n, n).clone()
    return t


def _specs(named: Dict[str, torch.Tensor], ctx: ShardContext) -> Dict[str, tuple]:
    sizes = {"dcn": ctx.pm.dcn, "dp": ctx.pm.dp, TP_AXIS: ctx.tp}
    return {name: _leaf_spec(sizes, name, tuple(t.shape)) for name, t in named.items()}


def shard_train_state(state, ctx: ShardContext):
    """Place a full ``TrainState`` (the model on this rank's device) on the
    mesh, in place: every module gets ``shard = ctx``; under tp the
    sharded parameters are cut to this rank's slice, each ``Dense`` learns
    its mode (``col``, ``col_gather`` for the logits, ``row``), and Adam's
    moments are cut like their parameters.  Returns the state, with
    ``state.sharded`` the names of the tp-sharded parameters and
    ``state.tp_partial`` those whose gradient each tp rank holds a slice of
    (the column-parallel biases)."""
    from ..models.transformer import Dense
    from ..train.state import make_optimizer

    model = state.model
    for m in model.modules():
        m.shard = ctx
    named = dict(model.named_parameters())
    specs = _specs(named, ctx)
    state.specs = specs
    state.sharded = tuple(n for n, s in specs.items() if TP_AXIS in s)
    partial = []
    if ctx.tp > 1:
        opt_state = state.optimizer.state_dict()
        for mname, m in model.named_modules():
            spec = specs.get(f"{mname}.weight" if mname else "weight")
            if isinstance(m, Dense) and spec in (COLUMN, ROW):
                m.tp_mode = ("col_gather" if mname == "fc" else "col") if spec == COLUMN else "row"
                if spec == COLUMN:
                    partial.append(f"{mname}.bias")
        for name, p in named.items():
            if name in state.sharded:
                p.data = _local(p.data, specs[name], ctx)
        model.embed_sharded = "embedding.weight" in state.sharded
        names = list(named)
        for i, per in opt_state["state"].items():
            for key in ("exp_avg", "exp_avg_sq"):
                if key in per:
                    per[key] = _local(per[key], specs[names[i]], ctx)
        state.optimizer = make_optimizer(model.parameters())
        state.optimizer.load_state_dict(opt_state)
    state.tp_partial = tuple(partial)
    return state


def _full(t: torch.Tensor, spec, ctx: ShardContext) -> torch.Tensor:
    for dim, axis in enumerate(spec):
        if axis == TP_AXIS:
            parts = [torch.empty_like(t) for _ in range(ctx.tp)]
            dist.all_gather(parts, t.contiguous(), group=ctx.tp_group)
            return torch.cat(parts, dim=dim)
    return t


def full_train_state(state, ctx: ShardContext):
    """``(params, opt_state)`` at their full shapes on every rank (a
    collective: every rank calls it), the tp-sharded tensors gathered, for a
    checkpoint that restores at any layout."""
    names = list(state.specs)
    params = {}
    sd = state.model.state_dict()
    for name, t in sd.items():
        params[name] = _full(t, state.specs.get(name, ()), ctx).detach().cpu()
    opt_state = state.optimizer.state_dict()
    for i, per in opt_state["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            if key in per:
                per[key] = _full(per[key], state.specs[names[i]], ctx).cpu()
    return params, opt_state


# ----------------------------------------------------------------------
# gradients and norms
# ----------------------------------------------------------------------
def _flat_all_reduce_(tensors: List[torch.Tensor], reduce) -> None:
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    reduce(flat)
    at = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[at : at + n].view_as(t))
        at += n


def sync_grads_(state, ctx: ShardContext) -> None:
    """Sum the gradients: the column-parallel biases' slices over tp, then
    every gradient over (dp, dcn), one flat buffer each."""
    named = dict(state.model.named_parameters())
    for p in named.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if ctx.tp > 1:
        _flat_all_reduce_([named[n].grad for n in state.tp_partial],
                          lambda t: all_reduce_(t, ctx.tp_group))
    if ctx.row_shards > 1:
        _flat_all_reduce_([p.grad for p in named.values()], ctx.sum_rows_)


def leaf_norms(named: Sequence, sharded: Sequence[str], ctx: Optional[ShardContext]) -> List[torch.Tensor]:
    """The global L2 norm of each tensor of ``named`` ((name, tensor) pairs),
    in f32: a tp-sharded tensor's squares summed over tp, a replicated one
    counted once."""
    norms = torch._foreach_norm([t.float() for _, t in named])
    if ctx is None or ctx.tp == 1:
        return list(norms)
    idx = [i for i, (n, _) in enumerate(named) if n in set(sharded)]
    if idx:
        sq = torch.stack([norms[i] for i in idx]) ** 2
        all_reduce_(sq, ctx.tp_group)
        norms = list(norms)
        for j, i in enumerate(idx):
            norms[i] = sq[j].sqrt()
    return list(norms)


def place_on_rows(batch: Dict[str, object], ctx: ShardContext) -> Dict[str, object]:
    """This rank's contiguous rows of a global batch whose rows divide by
    ``row_shards`` (``train.loop.pad_batch_rows``)."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0] // ctx.row_shards
        out[k] = v[ctx.row_shard * n : (ctx.row_shard + 1) * n]
    return out

