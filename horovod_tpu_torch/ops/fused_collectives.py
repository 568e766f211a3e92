"""Tile-fused matmul⊗collective ops over ``torch.distributed``
(``horovod_tpu/ops/pallas_kernels.py``: ``matmul_reducescatter``,
``allgather_matmul`` and ``resolve_fused_collectives``).

The tensor-parallel boundary ops of the Megatron sequence-parallel layout.
Where the JAX package streams tiles around a ``ppermute`` ring inside one
program, the port posts one ``dist.batch_isend_irecv`` send/receive pair per
hop on the tensor-parallel process group, and computes the next tile's
product with :func:`~horovod_tpu_torch.ops.kernels.pallas_matmul`'s kernel
while the hop is in flight.  Every rank posts the same pairs in the same
order, so the ring cannot deadlock.

``group`` is a ``torch.distributed`` process group, or ``None`` for a group
of this rank alone (a tensor-parallel extent of 1, where both ops are the
bare kernel, as in the JAX package).  Rows are rank-major: the gather
concatenates the ranks' row blocks in group-rank order and the scatter
hands group rank ``r`` the rows ``[r·m/world, (r+1)·m/world)``.

Gradients: the transpose of one ring is the other.  The dX of
``matmul_reducescatter`` is ``allgather_matmul(dy, wᵀ)`` and the dX of
``allgather_matmul`` is ``matmul_reducescatter(dy, wᵀ)``; dW is the local
product against the gathered operand, which the ring collects as it passes.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops import kernels as K
from horovod_tpu_torch.runtime.config import Config


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


#: valid values of the ``HOROVOD_FUSED_COLLECTIVES`` knob
FUSED_COLLECTIVES_MODES = ("auto", "on", "off")


def resolve_fused_collectives(mode: Optional[str] = None) -> bool:
    """Whether the boundary ops take the tile-fused rings
    (``pallas_kernels.resolve_fused_collectives``): ``"on"``/``"off"``
    force, and ``None`` reads the ``HOROVOD_FUSED_COLLECTIVES`` knob.

    ``"auto"``, the knob's default, is off.  The JAX package's ``"auto"``
    takes the rings on a TPU; on four NVLink H100s at the 870.9M model's
    shapes the rings (one NCCL send/receive pair a hop) took about twice
    the unfused collectives' time through ``fused_tp_apply``
    (``tp_bench.py``)."""
    if mode is None:
        mode = Config.from_env().fused_collectives
    if mode not in FUSED_COLLECTIVES_MODES:
        raise ValueError(f"fused_collectives must be one of "
                         f"{FUSED_COLLECTIVES_MODES}, got {mode!r}")
    return mode == "on"


def _hop(t: torch.Tensor, group, to: int, frm: int
         ) -> Tuple[torch.Tensor, List]:
    """Post one ring hop: send ``t`` to group rank ``to`` and receive a
    tensor like it from group rank ``frm``.  Returns the receive buffer and
    the requests to wait on before reading it."""
    buf = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, to), group),
           dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, frm),
                      group)]
    return buf, dist.batch_isend_irecv(ops)


def _wait(requests) -> None:
    for req in requests:
        req.wait()


def _matmul_rs(x: torch.Tensor, w: torch.Tensor, group,
               fused: bool) -> torch.Tensor:
    """Forward of :func:`matmul_reducescatter` at a world above 1."""
    world, m = group_size(group), x.shape[0]
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    if not fused:
        y = K._mm(x, w, out_dtype)
        out = y.new_empty((m // world, y.shape[1]))
        dist.reduce_scatter_tensor(out, y, group=group)
        return out
    me = group_rank(group)
    tiles = x.reshape(world, m // world, x.shape[1])
    # start at tile (me-1) so that after world-1 send-right hops each rank
    # holds its OWN fully reduced tile; the partials are summed in fp32
    acc = K._mm(tiles[(me - 1) % world], w, torch.float32)
    for s in range(1, world):
        got, requests = _hop(acc, group, (me + 1) % world, (me - 1) % world)
        part = K._mm(tiles[(me - 1 - s) % world], w, torch.float32)
        _wait(requests)
        acc = got.add_(part)
    return acc.to(out_dtype)


def _allgather_mm(x: torch.Tensor, w: torch.Tensor, group, fused: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward of :func:`allgather_matmul` at a world above 1; returns the
    product and the gathered ``x``."""
    world, m_local = group_size(group), x.shape[0]
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    x = x.contiguous()
    if not fused:
        full = x.new_empty((world * m_local, x.shape[1]))
        dist.all_gather_into_tensor(full, x, group=group)
        return K._mm(full, w, out_dtype), full
    me = group_rank(group)
    out = x.new_empty((world * m_local, w.shape[1]), dtype=out_dtype)
    full = x.new_empty((world * m_local, x.shape[1]))
    cur = x
    # send left = receive from the right neighbour: at hop s this rank
    # holds shard (me + s) % world
    for s in range(world):
        src = (me + s) % world
        rows = slice(src * m_local, (src + 1) * m_local)
        if s < world - 1:
            nxt, requests = _hop(cur, group, (me - 1) % world,
                                 (me + 1) % world)
        K._mm(cur, w, out_dtype, out=out[rows])
        full[rows].copy_(cur)
        if s < world - 1:
            _wait(requests)
            cur = nxt
    return out, full


class _MatmulReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group, fused):
        ctx.save_for_backward(x, w)
        ctx.group, ctx.fused = group, fused
        return _matmul_rs(x, w, group, fused)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(torch.promote_types(x.dtype, w.dtype))
        dx, dy_full = _allgather_mm(dy, w.t(), ctx.group, ctx.fused)
        dw = K.matmul_grad_w(x, dy_full, w) if ctx.needs_input_grad[1] \
            else None
        return dx.to(x.dtype), dw, None, None


class _AllgatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group, fused):
        out, full = _allgather_mm(x, w, group, fused)
        ctx.save_for_backward(full, w)
        ctx.group, ctx.fused, ctx.x_dtype = group, fused, x.dtype
        return out

    @staticmethod
    def backward(ctx, dy):
        full, w = ctx.saved_tensors
        dy = dy.to(torch.promote_types(full.dtype, w.dtype))
        dx = _matmul_rs(dy, w.t(), ctx.group, ctx.fused)
        dw = K.matmul_grad_w(full, dy, w) if ctx.needs_input_grad[1] \
            else None
        return dx.to(ctx.x_dtype), dw, None, None


def _check_2d(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{name} takes 2-D operands, got {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} (flatten leading dims first)")


def matmul_reducescatter(x: torch.Tensor, w: torch.Tensor, group=None,
                         fused: bool = True) -> torch.Tensor:
    """Fused ``reduce_scatter(x @ w)`` over ``group``: the row-parallel
    boundary op.  ``x`` is ``(m, k)`` with ``m`` divisible by the group's
    size, ``w`` this rank's ``(k, n)`` contraction shard; returns the
    reduced ``(m/world, n)`` row block this rank owns.

    Fused, each hop sends the fp32 partial of one output tile to the right
    neighbour while this rank computes its partial of the next tile;
    ``fused=False`` is the kernel followed by ``reduce_scatter_tensor``.  A
    group of one is the bare :func:`~horovod_tpu_torch.ops.kernels.pallas_matmul`."""
    _check_2d("matmul_reducescatter", x, w)
    world = group_size(group)
    if x.shape[0] % world:
        raise ValueError(f"matmul_reducescatter rows {x.shape[0]} not "
                         f"divisible by the group's size {world}")
    if world == 1:
        return K.pallas_matmul(x, w)
    if fused:
        matmul_reducescatter.launches += 1
    return _MatmulReduceScatter.apply(x, w, group, fused)


def allgather_matmul(x: torch.Tensor, w: torch.Tensor, group=None,
                     fused: bool = True) -> torch.Tensor:
    """Fused ``all_gather(x) @ w`` over ``group``: the column-parallel
    boundary op.  ``x`` is this rank's ``(m_local, k)`` row shard, ``w`` the
    ``(k, n)`` kernel; returns the full ``(world·m_local, n)`` product.

    Fused, each hop passes the row shard this rank holds to the left
    neighbour while this rank multiplies it; ``fused=False`` is
    ``all_gather_into_tensor`` followed by the kernel.  A group of one is
    the bare :func:`~horovod_tpu_torch.ops.kernels.pallas_matmul`."""
    _check_2d("allgather_matmul", x, w)
    world = group_size(group)
    if world == 1:
        return K.pallas_matmul(x, w)
    if fused:
        allgather_matmul.launches += 1
    return _AllgatherMatmul.apply(x, w, group, fused)


#: constructions of the fused rings, per op: the counterpart of the JAX
#: package's ``hvd_pallas_fused_launches_total{kernel}``
matmul_reducescatter.launches = 0
allgather_matmul.launches = 0

