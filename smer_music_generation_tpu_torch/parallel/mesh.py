"""Device mesh and sharding rules (dp first, Megatron tp optional).

Port of ``smer_music_generation_tpu/parallel/mesh.py``: ``make_mesh`` (:36),
``batch_sharding`` (:81), ``replicated`` (:88), the Megatron rules
``_param_spec`` (:92), ``train_state_shardings`` (:111) and
``param_shardings`` (:129).  JAX's ``Mesh`` of devices becomes :class:`Mesh`,
an object array of ``torch.device``s shaped ``(dp, tp)`` or ``(dcn, dp,
tp)`` with its axis names and a ``shape`` mapping, so that callers read
``mesh.shape["dp"]`` as JAX's do.  A ``NamedSharding`` becomes
:class:`Sharding`: the mesh and a spec, a tuple with one entry a dimension
(None, an axis name, or a tuple of axis names), as a ``PartitionSpec``.

The specs name the port's parameters in torch's layout: a ``Linear.weight``
is (out, in) where flax's kernel is (in, out), so JAX's column-parallel
``P(None, "tp")`` on a kernel is ``("tp", None)`` here and its row-parallel
``P("tp", None)`` is ``(None, "tp")``.  The (V, D) embedding is the same in
both, its D columns split.

Serving reads the ``dp`` axis of a mesh (``infer/decode.py``); training
runs one process a device (``torchrun``) and uses :func:`init_process_mesh`
for the process group and the ``(dcn, dp, tp)`` sub-groups.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

DCN_AXIS = "dcn"
DP_AXIS = "dp"
TP_AXIS = "tp"

Spec = Tuple


class Mesh:
    """An n-d array of ``torch.device``s with named axes (``jax.sharding.Mesh``)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def dp_devices(self):
        """The devices along ``dp`` (at the first index of every other
        axis): where a serving mesh places its batch shards."""
        index = tuple(slice(None) if a == DP_AXIS else 0 for a in self.axis_names)
        return list(self.devices[index])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.reshape(-1)]})"


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh and a spec (``NamedSharding``)."""

    mesh: Mesh
    spec: Spec

    def dim_of(self, axis: str) -> Optional[int]:
        """The tensor dimension split over mesh ``axis``, or None."""
        for dim, entry in enumerate(self.spec):
            if entry == axis or (isinstance(entry, tuple) and axis in entry):
                return dim
        return None


def cuda_devices():
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, tp: int = 1, devices: Optional[Sequence] = None,
              dcn_slices: int = 1) -> Mesh:
    """A ``("dp", "tp")`` mesh over the first ``n_devices`` devices, with a
    leading ``"dcn"`` axis of ``dcn_slices`` when above 1 (JAX :36): the
    device list is taken slice-major, as JAX's single-process fallback
    does.  ``devices`` defaults to every CUDA device, ``cuda:0`` to
    ``cuda:{count - 1}``; a list may name one device more than once (two
    shards on one card)."""
    devices = cuda_devices() if devices is None else [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices % (tp * dcn_slices) != 0:
        raise ValueError(f"{n_devices} devices not divisible by tp={tp} x dcn_slices={dcn_slices}")
    if n_devices > len(devices):
        raise ValueError(f"a mesh of {n_devices} devices, but only {len(devices)} are given")
    dev = np.empty(n_devices, dtype=object)
    dev[:] = devices[:n_devices]
    dp = n_devices // (tp * dcn_slices)
    if dcn_slices == 1:
        return Mesh(dev.reshape(dp, tp), (DP_AXIS, TP_AXIS))
    return Mesh(dev.reshape(dcn_slices, dp, tp), (DCN_AXIS, DP_AXIS, TP_AXIS))


def batch_sharding(mesh: Mesh) -> Sharding:
    """The leading (batch) axis over dp (x dcn), replicated over tp (JAX :81)."""
    if DCN_AXIS in mesh.shape:
        return Sharding(mesh, ((DCN_AXIS, DP_AXIS),))
    return Sharding(mesh, (DP_AXIS,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


COLUMN = (TP_AXIS, None)  # Linear.weight (out, in): the outputs split
ROW = (None, TP_AXIS)  # the inputs split; the embedding's D columns too


def _param_spec(name: str, tp_enabled: bool) -> Spec:
    """Megatron specs on the port's parameter names (JAX :92): q/k/v,
    ``ff.fc1`` and the logit ``fc`` column-parallel, ``out`` and ``ff.fc2``
    row-parallel, the embedding's columns split, the rest replicated."""
    if not tp_enabled:
        return ()
    if name == "embedding.weight":
        return ROW
    if any(f"{m}.{proj}.weight" in name for m in ("self_attn", "cross_attn") for proj in "qkv"):
        return COLUMN
    if any(f"{m}.out.weight" in name for m in ("self_attn", "cross_attn")):
        return ROW
    if name.endswith("ff.fc1.weight"):
        return COLUMN
    if name.endswith("ff.fc2.weight"):
        return ROW
    if name == "fc.weight":
        return COLUMN
    return ()


def _leaf_spec(sizes: Mapping[str, int], name: str, shape: Sequence[int]) -> Spec:
    """``_param_spec`` with JAX's fallback (:140-150) on a mesh of axis
    ``sizes``: a leaf whose rank is below the spec's, or whose split
    dimension does not divide by its mesh axis, stays replicated (the
    (309, D) logit weight at tp=2)."""
    spec = _param_spec(name, sizes.get(TP_AXIS, 1) > 1)
    if len(shape) < len(spec):
        return ()
    for dim, axis in enumerate(spec):
        if axis is not None and shape[dim] % sizes[axis] != 0:
            return ()
    return spec


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def param_shardings(mesh: Mesh, params: Mapping[str, object]) -> Dict[str, Sharding]:
    """A :class:`Sharding` for every parameter of a state dict (name ->
    tensor or shape), JAX :129."""
    return {name: Sharding(mesh, _leaf_spec(mesh.shape, name, _shape(leaf)))
            for name, leaf in params.items()}


def train_state_shardings(mesh: Mesh, params: Mapping[str, object]) -> Dict[str, object]:
    """The shardings of a whole train state (JAX :111): the parameters by
    :func:`param_shardings`, Adam's two moments (``exp_avg``,
    ``exp_avg_sq``) mirroring them, the step count and the learning rate
    replicated."""
    p = param_shardings(mesh, params)
    rep = replicated(mesh)
    return {"params": p, "exp_avg": p, "exp_avg_sq": p, "step": rep, "lr": rep}


# ----------------------------------------------------------------------
# processes: one a device
# ----------------------------------------------------------------------
@dataclasses.dataclass
class ProcessMesh:
    """This process's place on a ``(dcn, dp, tp)`` mesh of processes, one a
    device: its rank, its coordinates, and the process groups of each axis
    (from ``init_device_mesh``).  ``row_shard`` / ``row_shards`` number the
    batch shards over (dcn, dp)."""

    mesh: object  # torch.distributed.device_mesh.DeviceMesh
    rank: int
    dcn: int
    dp: int
    tp: int
    dcn_index: int
    dp_index: int
    tp_index: int

    @property
    def row_shards(self) -> int:
        return self.dcn * self.dp

    @property
    def row_shard(self) -> int:
        return self.dcn_index * self.dp + self.dp_index

    def group(self, axis: str):
        return self.mesh.get_group(axis)


GROUP_TIMEOUT = datetime.timedelta(seconds=600)  # a collective that waits longer raises


def init_process_mesh(tp: int = 1, dcn_slices: int = 1, backend: Optional[str] = None) -> ProcessMesh:
    """Join the default process group, starting it from torchrun's
    environment (``env://``) when the caller has not, and build the ``(dcn,
    dp, tp)`` device mesh over its ranks, rank-major as :func:`make_mesh`
    reshapes its devices.  ``backend`` (for a group started here) defaults
    to ``nccl`` when CUDA is available and ``gloo`` otherwise.  A group that
    fails to start raises; the world size must divide by ``tp *
    dcn_slices``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        dist.init_process_group(backend, timeout=GROUP_TIMEOUT)
    world, me = dist.get_world_size(), dist.get_rank()
    if world % (tp * dcn_slices) != 0:
        raise ValueError(f"world size {world} not divisible by tp={tp} x dcn_slices={dcn_slices}")
    dp = world // (tp * dcn_slices)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, (dcn_slices, dp, tp), mesh_dim_names=(DCN_AXIS, DP_AXIS, TP_AXIS))
    dcn_i, rest = divmod(me, dp * tp)
    dp_i, tp_i = divmod(rest, tp)
    return ProcessMesh(mesh=mesh, rank=me, dcn=dcn_slices, dp=dp, tp=tp,
                       dcn_index=dcn_i, dp_index=dp_i, tp_index=tp_i)


def launched_world_size() -> int:
    """The world size torchrun (or another launcher) set, 1 without one."""
    return int(os.environ.get("WORLD_SIZE", "1"))
