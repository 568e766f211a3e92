"""Fully-sharded data parallelism as placement
(``horovod_tpu/parallel/fsdp.py``).

The JAX package places each large parameter sharded over the ``fsdp`` mesh
axis (its largest dimension the axis extent divides) and lets GSPMD insert
the all-gather on use and the reduce-scatter of the gradient; optimizer
state inherits the placement because ``optimizer.init`` runs on the placed
parameters.  The port keeps the placement rule (:func:`fsdp_sharding`) and
does by hand what GSPMD inserts (:func:`shard_params`):

* each placed ``Parameter`` (the object the user's optimizer holds) is cut
  down to this rank's shard in place, so a torch optimizer builds its state
  lazily at the shard's shape, ``1/fsdp`` of the replicated footprint;
* a forward pre-hook on the model gathers every placed leaf over the fsdp
  group (one all-gather each) and puts the full tensor where the module
  reads it; a forward hook puts the shard back.  The gathered tensors live
  as long as backward needs them;
* backward reduce-scatters each full gradient over the fsdp group to its
  shard and averages it there (the ``1/fsdp`` scale is a ``fused_scale``
  pass, as the sharded exchange's is), into the shard's ``.grad``, where
  the step's exchange over the rest of the data axes takes it.

Leaves smaller than ``min_weight_size`` elements, or with no dimension the
extent divides, stay whole and take the ordinary data-axes exchange.  The
model must be called through its own forward (the hooks sit on it), and
``torch.distributed.fsdp`` is not used: it cuts dim 0 of every leaf, where
the JAX rule cuts the largest dimension.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.parallel.mesh import mark_shard

# leaves smaller than this stay replicated: sharding a bias vector saves
# bytes measured in KB but adds a collective to the step
DEFAULT_MIN_WEIGHT_SIZE = 1 << 14


def _extent(mesh, axis: str) -> int:
    return int(mesh) if isinstance(mesh, int) else int(mesh.shape[axis])


def fsdp_sharding(shape, mesh, axis: str = "fsdp",
                  min_weight_size: int = DEFAULT_MIN_WEIGHT_SIZE
                  ) -> Optional[int]:
    """Placement rule for one parameter of ``shape`` over ``axis`` of
    ``mesh`` (a :class:`~horovod_tpu_torch.parallel.mesh.ParallelMesh`, or
    the extent itself): the dimension to partition, the largest one the
    extent divides (the last of equal ones, as JAX's ``max`` over
    ``(size, index)`` picks), or None to replicate a leaf below
    ``min_weight_size`` elements or with no such dimension."""
    n = _extent(mesh, axis)
    shape = tuple(shape)
    size = int(np.prod(shape)) if shape else 1
    if n == 1 or size < min_weight_size:
        return None
    candidates = [(d, i) for i, d in enumerate(shape) if d % n == 0]
    if not candidates:
        return None
    return max(candidates)[1]


def _leaves(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    if isinstance(params, Mapping):
        return dict(params)
    return {str(i): p for i, p in enumerate(params)}


def sharding_specs(params, mesh, axis: str = "fsdp",
                   min_weight_size: int = DEFAULT_MIN_WEIGHT_SIZE
                   ) -> Dict[str, Optional[int]]:
    """The partitioned dimension (or None) :func:`shard_params` gives each
    leaf of ``params`` (a module, by ``named_parameters`` name, or a
    mapping of tensors or arrays, by key), at the leaves' current shapes."""
    return {name: fsdp_sharding(np.shape(p) if not hasattr(p, "shape")
                                else tuple(p.shape), mesh, axis,
                                min_weight_size)
            for name, p in _leaves(params).items()}


def resident_bytes(params) -> int:
    """Bytes this rank holds of ``params`` (a module's parameters, each
    once, or a mapping or sequence of tensors): a placed leaf counts its
    shard, a replicated one the whole tensor, the number FSDP shrinks."""
    seen, total = set(), 0
    for p in _leaves(params).values():
        if id(p) in seen:
            continue
        seen.add(id(p))
        total += p.numel() * p.element_size()
    return total


class _Gather(torch.autograd.Function):
    """All-gather of a shard along ``dim`` over ``group`` forward; backward
    reduce-scatters the full gradient back to the shard and averages it
    over the group (a ``fused_scale`` pass)."""

    @staticmethod
    def forward(ctx, shard, group, n: int, dim: int, shape):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        flat = shard.new_empty(n * shard.numel())
        C._all_gather_tensor(flat, shard.contiguous().reshape(-1), group)
        return flat.view((n,) + tuple(shard.shape)).movedim(0, dim) \
            .reshape(shape)

    @staticmethod
    def backward(ctx, g):
        n = ctx.n
        parts = torch.stack(g.chunk(n, ctx.dim)).contiguous()
        out = parts.new_empty(parts.shape[1:])
        C._reduce_scatter_tensor(out.view(-1), parts.view(-1), ctx.group)
        return C._scale(out, 1.0 / n), None, None, None, None


@dataclasses.dataclass
class _Placed:
    param: nn.Parameter
    dim: int
    shape: Tuple[int, ...]
    owners: List[Tuple[nn.Module, str]]


class FsdpPlacement:
    """The placement :func:`shard_params` made on a model: which leaves are
    sharded (:attr:`dims`, by name) over which group, and the hooks that
    gather them around the model's forward."""

    def __init__(self, model: nn.Module, group, n: int,
                 placed: Dict[str, _Placed], dims: Dict[str, Optional[int]]):
        self.group, self.extent = group, n
        self.dims = dims
        self._placed = placed
        model.register_forward_pre_hook(self._gather)
        model.register_forward_hook(self._release, always_call=True)

    @property
    def params(self) -> List[nn.Parameter]:
        """The placed parameters (each this rank's shard)."""
        return [e.param for e in self._placed.values()]

    def _gather(self, module, args):
        for e in self._placed.values():
            full = _Gather.apply(e.param, self.group, self.extent, e.dim,
                                 e.shape)
            for owner, attr in e.owners:
                owner._parameters[attr] = full

    def _release(self, module, args, output):
        for e in self._placed.values():
            for owner, attr in e.owners:
                owner._parameters[attr] = e.param


def shard_params(model: nn.Module, mesh, axis: str = "fsdp",
                 min_weight_size: int = DEFAULT_MIN_WEIGHT_SIZE,
                 group=None, index: Optional[int] = None) -> FsdpPlacement:
    """Place ``model``'s parameters over ``axis`` of ``mesh`` by
    :func:`fsdp_sharding`, in place: each placed parameter keeps this
    rank's shard (the block ``mesh.index(axis)`` of its partitioned
    dimension) and is gathered around the model's forward.  Every rank
    must hold the same full values first (broadcast them).  ``group`` and
    ``index`` stand in for ``mesh``'s when ``mesh`` is an extent.
    Returns the :class:`FsdpPlacement`, also kept as
    ``model.hvd_fsdp``."""
    if getattr(model, "hvd_fsdp", None) is not None:
        raise ValueError("the model is placed by fsdp already")
    n = _extent(mesh, axis)
    if not isinstance(mesh, int):
        group, index = mesh.group(axis), mesh.index(axis)
    owners: Dict[int, List[Tuple[nn.Module, str]]] = {}
    for mod in model.modules():
        for attr, p in mod._parameters.items():
            if p is not None:
                owners.setdefault(id(p), []).append((mod, attr))
    dims: Dict[str, Optional[int]] = {}
    placed: Dict[str, _Placed] = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            dim = fsdp_sharding(tuple(p.shape), n, axis, min_weight_size)
            dims[name] = dim
            if dim is None:
                continue
            shape = tuple(p.shape)
            p.data = p.data.chunk(n, dim)[index].contiguous()
            mark_shard(p, f"fsdp shard of dim {dim} of {shape} over {n} "
                          f"ranks")
            placed[name] = _Placed(p, dim, shape, owners[id(p)])
    placement = FsdpPlacement(model, group, n, placed, dims)
    model.hvd_fsdp = placement
    return placement



def gather_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter of a model :func:`shard_params` placed, at its full
    shape, by ``named_parameters`` name (collective: each placed leaf is
    all-gathered over the fsdp group, as reading a JAX global array
    assembles its shards); the replicated ones as they are.  What a rank-0
    checkpoint of a placed model saves."""
    placement = model.hvd_fsdp
    out = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            e = placement._placed.get(name)
            out[name] = p.detach().clone() if e is None else _Gather.apply(
                p.detach(), placement.group, placement.extent, e.dim,
                e.shape)
    return out
