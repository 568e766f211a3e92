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
from typing import Dict, List, Optional

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


def axis_ranks(shape: Dict[str, int], axis: str) -> List[List[int]]:
    """The ranks of every group along ``axis`` of a mesh of ``shape``
    (extents by axis name): each list holds the ranks that differ only in
    their ``axis`` coordinate, in coordinate order."""
    extents = [shape[a] for a in AXIS_ORDER]
    grid = np.arange(int(np.prod(extents))).reshape(extents)
    i = AXIS_ORDER.index(axis)
    return np.moveaxis(grid, i, -1).reshape(-1, extents[i]).tolist()


@dataclasses.dataclass(frozen=True)
class ParallelMesh:
    """This rank's view of the mesh: the extent of every axis, this rank's
    coordinate on it, and the process group of its line along it
    (``None`` for an axis of extent 1, which needs no communication)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Optional[dist.ProcessGroup]]

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.groups[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]


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
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    for axis in AXIS_ORDER:
        if shape[axis] == 1:
            groups[axis] = None
        elif shape[axis] == n:
            groups[axis] = dist.group.WORLD
        else:
            for ranks in axis_ranks(shape, axis):
                group = dist.new_group(ranks)
                if st.rank in ranks:
                    groups[axis] = group
    return ParallelMesh(shape, coords, groups)
