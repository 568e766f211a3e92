"""Adasum, adaptive-summation reduction (``horovod_tpu/ops/adasum.py``,
and ``adasum_pair`` of ``horovod_tpu/ops/collectives.py``).

The pairwise rule, per tensor (per layer): given ``a``, ``b``,

    a' = (1 - a.b / (2|a|^2)) * a  +  (1 - a.b / (2|b|^2)) * b

which is ``a+b`` for orthogonal gradients and the average for parallel
ones.  :func:`adasum_pair` is the port's one combine: the eager plane's
tree (``ops/eager.py``), :func:`adasum_tree` and the in-step exchange all
call it.

Over the world's layout, ``(cross, local)`` (``runtime/state.py``), the
reduction is the reference GPU op's (``adasum_gpu_operations.cc:38``) and
the JAX package's over ``(dcn, ici)``: the average within ``local``, then
Adasum across ``cross``.  Across a power-of-two ``cross`` it is recursive
doubling: log2(n) rounds, each exchanging the whole vector with the
partner ``i ^ 2^r`` (``dist.batch_isend_irecv`` over the ``cross``
group), both partners combining the pair in rank order, so every rank
ends with the same bits and no gather-back is needed.  Across any other
extent it is one all-gather and the same binary tree on every rank.
Every tensor gets its own coefficients, so how tensors are bucketed does
not change the result.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch.runtime import state


def adasum_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One pairwise Adasum combine of two tensors of one shape and dtype
    (JAX ``adasum_pair``).  Dots and norms are taken in fp32 whatever the
    input dtype, as the reference's fp16 path widens its accumulation
    (``adasum.h:107``); a zero-norm operand (``|x|^2 < 1e-30``) takes
    coefficient 1, the plain-sum guard, so all-zero operands pass through
    exactly.  The result has ``a``'s dtype.

    On CPU tensors the guard's activations count into
    ``hvd_adasum_zero_norm_fallbacks_total`` (the port's telemetry
    registry), as JAX counts on its numpy plane; on a card nothing is
    counted, since reading the norms would wait for the card."""
    af, bf = a.float().reshape(-1), b.float().reshape(-1)
    dot = torch.dot(af, bf)
    anormsq = torch.dot(af, af)
    bnormsq = torch.dot(bf, bf)
    one = torch.ones((), dtype=torch.float32, device=a.device)
    acoeff = torch.where(anormsq >= 1e-30,
                         1.0 - dot / (2.0 * anormsq + 1e-30), one)
    bcoeff = torch.where(bnormsq >= 1e-30,
                         1.0 - dot / (2.0 * bnormsq + 1e-30), one)
    if a.device.type == "cpu":
        fallbacks = int(anormsq < 1e-30) + int(bnormsq < 1e-30)
        if fallbacks:
            from horovod_tpu_torch import telemetry

            telemetry.counter(
                "hvd_adasum_zero_norm_fallbacks_total",
                "zero-norm plain-sum guard activations in adasum_pair"
            ).inc(fallbacks)
    return (acoeff * af + bcoeff * bf).to(a.dtype).view(a.shape)


def adasum_tree(rows: List[torch.Tensor],
                combine: Callable = adasum_pair) -> torch.Tensor:
    """The pairwise Adasum reduction tree over per-rank rows (JAX
    ``eager._adasum_tree`` and the non-power-of-two branch of
    ``_adasum_axis``): neighbours combine, the lower row first, an odd
    last row passes up unchanged, until one row is left.  ``combine`` is
    the pair rule (the sharded exchange's takes whole-bucket
    coefficients)."""
    vals = list(rows)
    while len(vals) > 1:
        nxt = [combine(vals[i], vals[i + 1])
               for i in range(0, len(vals) - 1, 2)]
        if len(vals) % 2:
            nxt.append(vals[-1])
        vals = nxt
    return vals[0]


def _bounds(segments: Sequence[int]) -> List[int]:
    out = [0]
    for s in segments:
        out.append(out[-1] + int(s))
    return out


def _combine_segments(a: torch.Tensor, b: torch.Tensor,
                      bounds: Sequence[int], out: torch.Tensor) -> None:
    """:func:`adasum_pair` of each segment of the flat ``a`` and ``b``
    into the same segment of ``out``."""
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi > lo:
            out[lo:hi] = adasum_pair(a[lo:hi], b[lo:hi])


def _average_local(flat: torch.Tensor,
                   group: Optional[dist.ProcessGroup], n: int) -> None:
    """Sum ``flat`` over the local group and divide by its extent, in
    place (JAX ``psum(x, ici) / local_n``)."""
    if group is None:
        return
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    if flat.is_floating_point():
        flat.div_(n)
    else:
        flat.copy_((flat.double() / n).to(flat.dtype))


def swap(send: torch.Tensor, recv: torch.Tensor, partner: int,
         group: dist.ProcessGroup) -> None:
    """Send ``send`` to the rank of index ``partner`` in ``group`` and
    receive its tensor of the same shape into ``recv``: one
    ``dist.batch_isend_irecv`` pair, both partners calling."""
    peer = dist.get_global_rank(group, partner)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, peer, group),
                                   dist.P2POp(dist.irecv, recv, peer, group)])
    for req in reqs:
        req.wait()


def _adasum_cross(flat: torch.Tensor, bounds: Sequence[int],
                  group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Adasum of ``flat`` (segments at ``bounds``) across the cross group
    (JAX ``_adasum_axis``); the result on every rank of the group, bit for
    bit."""
    if group is None:
        return flat
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    if n & (n - 1) == 0:
        recv = torch.empty_like(flat)
        for r in range(n.bit_length() - 1):
            partner = me ^ (1 << r)
            swap(flat, recv, partner, group)
            # the lower cross index's operand first on both partners, so
            # both compute the same expression
            lo, hi = (flat, recv) if me < partner else (recv, flat)
            out = torch.empty_like(flat)
            _combine_segments(lo, hi, bounds, out)
            flat = out
        return flat
    rows = flat.new_empty(n * flat.numel())
    # all_gather_single from torch 2.13, which deprecates the older name
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(rows, flat, group=group)
    rows = rows.view(n, flat.numel())
    out = torch.empty_like(flat)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi > lo:
            out[lo:hi] = adasum_tree([rows[i, lo:hi] for i in range(n)])
    return out


def adasum_flat(flat: torch.Tensor, segments: Sequence[int]) -> torch.Tensor:
    """Adasum over the world's layout of a flat buffer holding tensors of
    ``segments`` elements each, every one with its own coefficients: the
    average within ``local`` (in place in ``flat``), then Adasum across
    ``cross``.  Returns the reduced buffer (``flat`` itself on a world of
    one node of one rank)."""
    st = state.global_state()
    _average_local(flat, st.layout_group(state.LOCAL), st.local_size)
    return _adasum_cross(flat, _bounds(segments),
                         st.layout_group(state.CROSS))


def adasum_grouped_allreduce(xs: Sequence[torch.Tensor]
                             ) -> List[torch.Tensor]:
    """Adasum-reduce a group of tensors over the world's layout, each with
    its own coefficients (JAX ``adasum_grouped_allreduce`` over
    ``GLOBAL_AXES``): ``grouped_allreduce(op=Adasum)``, one flat buffer and
    one exchange per dtype, split back into new tensors.  A world of one
    returns ``xs`` as they are, as JAX returns them at extent 1."""
    xs = list(xs)
    if state.global_state().size == 1:
        return xs
    from horovod_tpu_torch.ops import collectives

    return collectives.grouped_allreduce(xs, op=collectives.Adasum)


def adasum_allreduce(x: torch.Tensor) -> torch.Tensor:
    """Single-tensor Adasum allreduce (request type ADASUM, reference
    ``message.h:51``)."""
    return adasum_grouped_allreduce([x])[0]
