"""Pipeline parallelism over a ``pp`` process group: GPipe and
interleaved-1F1B schedules, the port of the JAX package's
``parallel/pipeline.py``.

Every rank of the group is one stage and holds its stage's modules or
tensors; activations advance stage to stage with one send/receive pair a
tick (:class:`_Hop`: send to group rank ``r + 1``, receive from ``r - 1``,
the ring wrap included).  Every rank runs the same ticks, as the JAX
package's ``lax.scan`` does: a tick in a bubble posts its hop too, with a
zero activation, so the sends and receives of all ranks pair up tick by
tick.  Autograd through the hops gives the reverse schedule: each hop's
backward posts the reverse pair, and a scalar token threaded through the
hops in tick order makes every rank run them last tick first, also where
a hop's received activation went unused (rank 0 injects its microbatches
instead).  The finished microbatches are banked on the last rank and
fanned out by a sum all-reduce whose backward is a sum all-reduce too
(JAX's ``psum`` and its transpose): a loss that every rank computes from
the fanned-out output is averaged over the group before its backward, as
the JAX tests' ``pmean`` over ``pp`` does, or the last stage's gradients
come out ``s`` times too large.

The stage calls of the bubbles are skipped: JAX computes them on the
zero-masked carry and masks their outputs to zeros, so their outputs and
gradients are exact zeros, which is what the skipped tick sends.  The
outputs and gradients are therefore JAX's, and a rank's idle share is the
schedule's bubble.

:func:`gpipe` fills the pipe once: ``m + s - 1`` ticks for ``m``
microbatches over ``s`` stages, bubble ``(s-1)/(m+s-1)``.
:func:`interleaved_1f1b` gives every rank ``v`` chunks (rank ``r`` owns
global chunks ``j*s + r``), bubble ``(s-1)/(v*m+s-1)``; ``v=1`` is
GPipe's schedule.

``group`` is the ``torch.distributed`` process group of the pipeline
(``make_parallel_mesh(pp=s).group("pp")``), or ``None`` for a group of
this rank alone, where the hop is the identity and no collective runs.
The input is replicated over the group; its gradient lands on rank 0,
which injects it, and a parameter outside the pipe that every rank holds
(an embedding, a head) needs its gradients summed over the group, as
JAX's transpose of a replicated input sums them.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops import fused_collectives as FC


def pipeline_ticks(stages: int, microbatches: int,
                   virtual_stages: int = 1) -> int:
    """Ticks of the schedule: ``v*m + s - 1`` (``v=1`` is GPipe's
    ``m + s - 1``)."""
    return virtual_stages * microbatches + stages - 1


def bubble_fraction(stages: int, microbatches: int,
                    virtual_stages: int = 1) -> float:
    """Idle share of the schedule, ``(s-1)/(v*m+s-1)``."""
    return (stages - 1) / pipeline_ticks(stages, microbatches,
                                         virtual_stages)


class _Hop(torch.autograd.Function):
    """One tick's hop: send ``h`` to group rank ``r + 1`` and receive its
    like from ``r - 1``; backward sends the received tensor's gradient to
    ``r - 1`` and receives the sent one's from ``r + 1``.  ``token`` only
    orders the hops' backwards (module docstring)."""

    @staticmethod
    def forward(ctx, h, token, group):
        world, me = FC.group_size(group), FC.group_rank(group)
        ctx.group, ctx.like = group, (h.shape, h.dtype, h.device)
        (got,), requests = FC._hop([h.contiguous()], group,
                                   (me + 1) % world, (me - 1) % world)
        FC._wait(requests)
        return got, token.clone()

    @staticmethod
    def backward(ctx, g, g_token):
        group = ctx.group
        world, me = FC.group_size(group), FC.group_rank(group)
        if g is None:
            shape, dtype, device = ctx.like
            g = torch.zeros(shape, dtype=dtype, device=device)
        (back,), requests = FC._hop([g.contiguous()], group,
                                    (me - 1) % world, (me + 1) % world)
        FC._wait(requests)
        return back, g_token, None


class _FanOut(torch.autograd.Function):
    """The masked ``psum`` that fans the last stage's outputs out to every
    rank; its backward is JAX's transpose, a sum all-reduce."""

    @staticmethod
    def forward(ctx, out, token, group):
        ctx.group = group
        out = out.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, torch.zeros((), device=g.device), None


def _schedule(stage_fn: Callable, chunk, x: torch.Tensor, m: int, v: int,
              group, decode: Callable) -> torch.Tensor:
    """Run the ticks: ``decode(t) -> (active, microbatch, chunk index)``
    for this rank; ``chunk(j)`` is its chunk ``j``'s parameters."""
    world, me = FC.group_size(group), FC.group_rank(group)
    b = x.shape[0]
    mb = b // m
    mbs = x.reshape((m, mb) + tuple(x.shape[1:]))
    state = x.new_zeros((mb,) + tuple(x.shape[1:]))
    outputs = [None] * m
    graph = world > 1 and torch.is_grad_enabled()
    token = torch.zeros((), device=x.device, requires_grad=graph)
    for t in range(pipeline_ticks(world, m, v)):
        active, i, j = decode(t)
        if active:
            # rank 0 injects a fresh microbatch whenever it starts chunk
            # 0; every other (rank, chunk) consumes what the ring delivered
            h_in = mbs[i] if me == 0 and j == 0 else state
            h_out = stage_fn(chunk(j), h_in)
            if me == world - 1 and j == v - 1:
                outputs[i] = h_out       # the finished microbatch
        else:
            h_out = torch.zeros_like(state)
        if world == 1:
            state = h_out
        else:
            state, token = _Hop.apply(h_out, token, group)
    if world == 1:
        return torch.stack(outputs).reshape(x.shape[:1] + outputs[0].shape[1:])
    stacked = torch.stack(outputs) if me == world - 1 else \
        torch.zeros_like(mbs)
    out = _FanOut.apply(stacked, token, group)
    return out.reshape((b,) + tuple(out.shape[2:]))


def gpipe(stage_fn: Callable, stage_params, x: torch.Tensor,
          num_microbatches: int, group=None) -> torch.Tensor:
    """Run ``x`` through the group's stages, GPipe's schedule.

    Args:
      stage_fn: ``f(params, h) -> h``, one stage; activation shapes are
        the same across stages.
      stage_params: this rank's stage parameters (a module, a tensor or
        any object ``stage_fn`` reads).
      x: ``(batch, ...)`` input, the same on every rank of the group;
        ``batch`` must divide by ``num_microbatches``.
      num_microbatches: pipeline depth ``m``; ``m + s - 1`` ticks.

    Returns:
      ``(batch, ...)`` output of the last stage, on every rank.
    """
    me = FC.group_rank(group)
    b = x.shape[0]
    if b % num_microbatches != 0:
        raise ValueError(
            f"batch {b} not divisible by num_microbatches={num_microbatches}")
    m = num_microbatches

    def decode(t):
        return 0 <= t - me < m, t - me, 0

    return _schedule(stage_fn, lambda j: stage_params, x, m, 1, group,
                     decode)


def interleaved_1f1b(stage_fn: Callable, stage_params, x: torch.Tensor,
                     num_microbatches: int, virtual_stages: int = 1,
                     group=None) -> torch.Tensor:
    """Interleaved schedule: rank ``r`` runs the ``v`` chunks
    ``{j*s + r}`` of a ``v*s``-stage pipeline.

    Microbatch ``i`` (group ``g = i // s``, slot ``k = i % s``) reaches
    chunk ``j`` on rank ``r`` at tick ``t = g*v*s + j*s + k + r``;
    decoding ``t - r`` recovers ``(g, j, k)``, so every rank works on one
    chunk of one microbatch a tick, and the ring wrap ``s-1 → 0`` carries
    an activation into chunk ``j+1``.  ``v*m + s - 1`` ticks, bubble
    ``(s-1)/(v*m+s-1)``.

    Args:
      stage_fn: ``f(chunk_params, h) -> h``, one chunk (``1/(v*s)`` of the
        model); activation shapes are the same across chunks.
      stage_params: this rank's ``v`` chunks, indexable by ``j`` (a list
        of modules, or tensors stacked on a leading ``v`` dimension);
        chunk ``j`` of rank ``r`` is global stage ``j*s + r``.
      x: ``(batch, ...)`` input, the same on every rank of the group.
      num_microbatches: ``m``; must divide the batch and be a multiple of
        the stage count ``s``.
      virtual_stages: chunks per rank ``v``; ``v=1`` is :func:`gpipe`'s
        schedule.

    Returns:
      ``(batch, ...)`` output of the final chunk, on every rank.
    """
    world, me = FC.group_size(group), FC.group_rank(group)
    m, v = num_microbatches, virtual_stages
    if v < 1:
        raise ValueError(f"virtual_stages must be >= 1, got {v}")
    b = x.shape[0]
    if b % m != 0:
        raise ValueError(f"batch {b} not divisible by "
                         f"num_microbatches={m}")
    if m % world != 0:
        raise ValueError(
            f"interleaved schedule needs num_microbatches ({m}) "
            f"divisible by the stage count ({world}): microbatches "
            f"tile in groups of s across the v chunks")
    groups = m // world

    def decode(t):
        tr = t - me
        g, j, k = tr // (v * world), (tr % (v * world)) // world, tr % world
        return tr >= 0 and g < groups, g * world + k, j

    return _schedule(stage_fn, lambda j: stage_params[j], x, m, v, group,
                     decode)
