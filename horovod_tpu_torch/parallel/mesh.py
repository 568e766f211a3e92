"""Multi-axis parallelism mesh over the ``torch.distributed`` world
(``horovod_tpu/parallel/mesh.py``).

The JAX package lays its devices out as an N-D ``jax.sharding.Mesh`` whose
axis order puts the axes with rare collectives outermost (dp, pp) and the
per-layer ones innermost (tp).  The port lays the ranks of the
``hvd.init()`` world out the same way: rank ``r`` sits at the C-order
coordinates of ``r`` over :data:`AXIS_ORDER`, so tp is the fastest-varying
index and rank ``r`` of a tp group owns the same row block as
``lax.axis_index("tp") == r``.  Each axis becomes one process group per
line of ranks along it.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch.distributed as dist

from horovod_tpu_torch.runtime import state

AXIS_DP = "dp"       # data parallel: gradient exchange once per step
AXIS_PP = "pp"       # pipeline stages: p2p activations between neighbours
AXIS_FSDP = "fsdp"   # fully-sharded dp: param all-gather + grad reduce-scatter
AXIS_EP = "ep"       # expert parallel: all_to_all token dispatch
AXIS_SP = "sp"       # sequence/context parallel: ring p2p / all_to_all
AXIS_TP = "tp"       # tensor parallel: boundary collectives per block

# outermost (slowest-varying rank index) → innermost (NVLink neighbours)
AXIS_ORDER = (AXIS_DP, AXIS_PP, AXIS_FSDP, AXIS_EP, AXIS_SP, AXIS_TP)

#: the sets of several axes a mesh holds groups for, besides every single
#: axis: the data axes, with ep and without one of them (the pjit step's
#: exchange scope and its scope left once fsdp has averaged), and every
#: axis but tp (the ranks that hold one tensor-parallel shard)
GROUPED_AXES = ((AXIS_DP, AXIS_FSDP), (AXIS_DP, AXIS_FSDP, AXIS_EP),
                (AXIS_DP, AXIS_EP), (AXIS_FSDP, AXIS_EP),
                tuple(a for a in AXIS_ORDER if a != AXIS_TP))


Axes = Union[str, Sequence[str]]


def _axes(axes: Axes) -> Tuple[str, ...]:
    """``axes`` as a tuple in :data:`AXIS_ORDER` order; unknown names
    raise."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in names:
        if a not in AXIS_ORDER:
            raise ValueError(f"unknown mesh axis {a!r}: expected one of "
                             f"{', '.join(AXIS_ORDER)}")
    return tuple(a for a in AXIS_ORDER if a in names)


def axis_ranks(shape: Dict[str, int], axis: Axes) -> List[List[int]]:
    """The ranks of every group along ``axis`` (one axis name or several)
    of a mesh of ``shape`` (extents by axis name): each list holds the
    ranks that differ only in their coordinates on those axes, ordered
    row-major over them in :data:`AXIS_ORDER`."""
    names = _axes(axis)
    extents = [shape[a] for a in AXIS_ORDER]
    grid = np.arange(int(np.prod(extents))).reshape(extents)
    idx = [AXIS_ORDER.index(a) for a in names]
    size = int(np.prod([extents[i] for i in idx]))
    moved = np.moveaxis(grid, idx, list(range(-len(idx), 0)))
    return moved.reshape(-1, size).tolist()


@dataclasses.dataclass(frozen=True)
class ParallelMesh:
    """This rank's view of the mesh: the extent of every axis, this rank's
    coordinate on it, and the process group of its line along it
    (``None`` for an axis of extent 1, which needs no communication).
    ``groups`` also holds, under a tuple of axis names in
    :data:`AXIS_ORDER` order, the group of each set of :data:`GROUPED_AXES`
    whose axes of extent > 1 are two or more."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[Union[str, Tuple[str, ...]], Optional[dist.ProcessGroup]]

    def group(self, axis: Axes) -> Optional[dist.ProcessGroup]:
        """The process group of this rank's line along ``axis``, one axis
        name or several (the ranks that share every other coordinate);
        ``None`` when it is this rank alone."""
        names = tuple(a for a in _axes(axis) if self.shape[a] > 1)
        if not names:
            return None
        key = names[0] if len(names) == 1 else names
        if key not in self.groups:
            raise ValueError(
                f"the mesh holds no group of the axes {names}: it makes "
                f"one for every axis and for the sets {GROUPED_AXES}")
        return self.groups[key]

    def index(self, axis: Axes) -> int:
        """This rank's coordinate on ``axis``, or its row-major index over
        several axes (its index in :meth:`group`)."""
        i = 0
        for a in _axes(axis):
            i = i * self.shape[a] + self.coords[a]
        return i

    def scope(self, axis: Axes):
        """``axis``'s group as a collective's scope: the group, or
        :data:`~horovod_tpu_torch.ops.collectives.ALONE` when it is this
        rank alone (where ``None`` would mean the world)."""
        from horovod_tpu_torch.ops.collectives import ALONE

        group = self.group(axis)
        return ALONE if group is None else group


def make_parallel_mesh(dp: Optional[int] = None, pp: int = 1, fsdp: int = 1,
                       ep: int = 1, sp: int = 1, tp: int = 1) -> ParallelMesh:
    """Lay the ``hvd.init()`` world out with the requested parallel degrees.

    ``dp=None`` absorbs whatever rank count the other axes leave over.
    Every rank must call this with the same arguments: the groups are
    created collectively, in the same order on every rank.

    ::

        mesh = make_parallel_mesh(tp=4)        # dp fills the rest
        y = matmul_reducescatter(x, w, mesh.group("tp"))
    """
    st = state.global_state()
    n = st.size
    fixed = pp * fsdp * ep * sp * tp
    if dp is None:
        if n % fixed != 0:
            raise ValueError(
                f"cannot infer dp: {n} ranks not divisible by "
                f"pp*fsdp*ep*sp*tp={fixed}")
        dp = n // fixed
    total = dp * fixed
    if total != n:
        raise ValueError(
            f"mesh {dp}x{pp}x{fsdp}x{ep}x{sp}x{tp}={total} does not cover "
            f"{n} ranks")
    shape = dict(zip(AXIS_ORDER, (dp, pp, fsdp, ep, sp, tp)))
    coords = dict(zip(AXIS_ORDER, (int(c) for c in np.unravel_index(
        st.rank, tuple(shape.values())))))
    groups: Dict = {}
    keys = list(AXIS_ORDER)
    for axes in GROUPED_AXES:
        live = tuple(a for a in axes if shape[a] > 1)
        if len(live) > 1 and live not in keys:
            keys.append(live)
    for key in keys:
        extent = int(np.prod([shape[a] for a in _axes(key)]))
        if extent == 1:
            groups[key] = None
        elif extent == n:
            groups[key] = dist.group.WORLD
        else:
            for ranks in axis_ranks(shape, key):
                group = dist.new_group(ranks)
                if st.rank in ranks:
                    groups[key] = group
    return ParallelMesh(shape, coords, groups)


#: the tensors that hold a shard: weak references to them, by id
_SHARDS: Dict[int, Tuple["weakref.ref", str]] = {}

#: whether every optimizer's steps mark its state of the marked parameters
_WATCHING = False


def mark_shard(param, what: str) -> None:
    """Record that ``param`` holds this rank's shard of a wider tensor;
    ``what`` says how (for error messages).  From the first mark on, every
    optimizer step marks the state tensors of a marked parameter that have
    its shape (AdamW's moments): they hold the same shard."""
    global _WATCHING
    key = id(param)
    _SHARDS[key] = (weakref.ref(param, lambda _: _SHARDS.pop(key, None)),
                    what)
    if not _WATCHING:
        from torch.optim.optimizer import register_optimizer_step_post_hook

        register_optimizer_step_post_hook(_mark_state)
        _WATCHING = True


def _mark_state(optimizer, args, kwargs) -> None:
    """An optimizer step's post hook: mark the state of its parameters
    :func:`mark_shard` marked."""
    for p, st in optimizer.state.items():
        entry = _SHARDS.get(id(p))
        if entry is None or entry[0]() is not p:
            continue
        for t in st.values():
            if getattr(t, "shape", None) == p.shape and id(t) not in _SHARDS:
                mark_shard(t, f"{entry[1]} (optimizer state)")


def shard_of(tensor) -> Optional[str]:
    """How ``tensor`` (a parameter :func:`mark_shard` recorded, or a view
    that shares its storage, such as ``state_dict()``'s) holds a shard;
    None for any other tensor."""
    try:
        ptr = tensor.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):   # meta or sparse
        return None
    if ptr == 0:                                  # no storage to share
        return None
    for ref, what in list(_SHARDS.values()):
        p = ref()
        if p is not None and p.device == tensor.device and \
                p.untyped_storage().data_ptr() == ptr:
            return what
    return None
