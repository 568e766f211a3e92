"""Remat policy compiler: the per-block rematerialization tiers (a copy of
``horovod_tpu/memory/remat.py`` over ``torch.utils.checkpoint``).

====================  =====================================================
policy                what backward may read without recompute
====================  =====================================================
``none``              everything: no remat, peak activations, no overhead
``dots``              matmul outputs only (``aten.mm``, ``addmm``, ``bmm``,
                      ``baddbmm``, as JAX's ``dots_saveable``); every other
                      op of the block is recomputed
``full``              nothing: every block replays its forward
``offload``           matmul outputs, copied to pinned host memory (kept
                      for reuse across steps) on a side stream instead of
                      kept on the card, and back for the recompute; on
                      the CPU it computes as ``dots`` (JAX falls back to
                      ``dots`` where the backend has no pinned host space)
====================  =====================================================

Resolution (:func:`resolve_remat_policy`): an explicit policy string
beats the ``HOROVOD_REMAT_POLICY`` knob beats the boolean ``remat``
(``True`` is ``full``) beats ``none``.

Each tier is ``torch.utils.checkpoint.checkpoint(..., use_reentrant=
False)`` around a block: ``dots`` with a selective-checkpoint policy,
``offload`` with two dispatch modes of its own (the forward's copies the
matmul outputs to the host, the recompute's copies them back in their
place).  The port's kernels are dispatcher ops (``hvd_torch::flash_fwd``,
``hvd_torch::pallas_matmul``, ...; ``ops/kernels.py``), which both see;
neither is among :data:`MATMUL_OPS`, so every tier recomputes them: under
``dots``, ``full`` and ``offload`` a block's flash forward runs twice a
step (JAX's ``dots_saveable`` does not save a ``pallas_call`` either).
"""

from __future__ import annotations

import os
from typing import Optional, Union

#: Closed policy vocabulary, cheapest-memory last.  Mirrored by value in
#: ``analysis/cost_model.REMAT_POLICIES`` (a stdlib-only module).
REMAT_POLICIES = ("none", "dots", "full", "offload")

ENV_REMAT_POLICY = "HOROVOD_REMAT_POLICY"

#: the aten ops whose outputs ``dots`` saves and ``offload`` moves to the
#: host: the matmuls, as the dispatcher sees them (``F.linear`` and
#: ``torch.matmul`` reach it as these)
MATMUL_OPS = ("mm", "addmm", "bmm", "baddbmm")


def validate_policy(policy: str) -> str:
    if policy not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat policy {policy!r}: expected one of "
            f"{', '.join(REMAT_POLICIES)} (HOROVOD_REMAT_POLICY / "
            f"remat_policy; docs/memory.md)")
    return policy


def resolve_remat_policy(policy: Optional[str] = None,
                         remat: Union[bool, str, None] = None) -> str:
    """Resolve the effective policy for one model / train step.

    Precedence: explicit ``policy`` > ``HOROVOD_REMAT_POLICY`` env >
    the legacy boolean ``remat`` (``True`` → ``"full"``, preserving
    what the flag always meant) > ``"none"``.  A string passed through
    the legacy ``remat`` slot counts as explicit — it is how
    ``DistributedTrainStep(remat="dots")`` spells a policy.
    """
    if isinstance(remat, str) and policy is None:
        policy = remat
        remat = None
    if policy is not None:
        return validate_policy(policy)
    env = os.environ.get(ENV_REMAT_POLICY)
    if env:
        return validate_policy(env.strip())
    return "full" if remat else "none"


def _is_matmul(func) -> bool:
    return func.overloadpacket.__name__ in MATMUL_OPS


def _dots_policy(ctx, func, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return CheckpointPolicy.MUST_SAVE if _is_matmul(func) \
        else CheckpointPolicy.PREFER_RECOMPUTE


class OffloadStats:
    """Bytes the ``offload`` tier has copied to the host (``d2h_bytes``)
    and back (``h2d_bytes``) since :meth:`reset`."""

    d2h_bytes = 0
    h2d_bytes = 0

    @classmethod
    def reset(cls) -> None:
        cls.d2h_bytes = cls.h2d_bytes = 0


class _Saved(list):
    """One checkpoint call's host copies, ``[buffer, D2H done]`` in call
    order; those its recompute never reads (it stops once backward has
    what it needs) go back to the pool when the call's graph is freed."""

    def __del__(self):
        from horovod_tpu_torch.memory.offload import PINNED

        for buf, done in self:
            if buf is not None:
                PINNED.give(buf, done)


def _offload_contexts():
    """The forward's and the recompute's dispatch modes of one
    ``offload`` checkpoint call: the forward copies each matmul output
    into a pinned host buffer (``offload.PINNED``) on a side stream (the
    output's memory is kept from reuse until the copy ends,
    ``record_stream``); the recompute waits for that copy and returns it,
    copied back to the card, in place of running its matmul again."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from horovod_tpu_torch.memory.offload import PINNED

    stream = _side_stream(torch)
    saved = _Saved()

    class Save(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if _is_matmul(func):
                host = PINNED.take(out.shape, out.dtype)
                stream.wait_stream(torch.cuda.current_stream(out.device))
                with torch.cuda.stream(stream):
                    host.copy_(out, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(stream)
                out.record_stream(stream)
                saved.append([host, done])
                OffloadStats.d2h_bytes += host.numel() * host.element_size()
            return out

    class Load(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.index = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not _is_matmul(func):
                return func(*args, **(kwargs or {}))
            entry = saved[self.index]
            self.index += 1
            host, done = entry
            current = torch.cuda.current_stream(args[0].device)
            current.wait_event(done)
            out = host.to(args[0].device, non_blocking=True)
            read = torch.cuda.Event()
            read.record(current)
            PINNED.give(host, read)
            entry[0] = None
            OffloadStats.h2d_bytes += host.numel() * host.element_size()
            return out

    return Save(), Load()


_STREAMS = {}


def _side_stream(torch):
    dev = torch.cuda.current_device()
    if dev not in _STREAMS:
        _STREAMS[dev] = torch.cuda.Stream(dev)
    return _STREAMS[dev]


def _on_card(torch, args) -> bool:
    """Whether a tensor among ``args`` (nested, or a module's parameters)
    lies on a card."""
    from torch.utils._pytree import tree_leaves

    for leaf in tree_leaves(list(args)):
        if isinstance(leaf, torch.nn.Module):
            leaf = next(leaf.parameters(), None)
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            return True
    return False


def _checkpoint(fn, policy: str, args, kwargs):
    import torch
    from torch.utils.checkpoint import (
        checkpoint,
        create_selective_checkpoint_contexts,
    )

    if not torch.is_grad_enabled():     # no backward: nothing to save
        return fn(*args, **kwargs)
    if policy == "full":
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    if policy == "offload" and _on_card(torch, args):
        context_fn = _offload_contexts
    else:           # dots, and offload off the card
        def context_fn():
            return create_selective_checkpoint_contexts(_dots_policy)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=context_fn, **kwargs)


def remat_block(block, policy: str):
    """``block`` (a module or any callable) wrapped per policy: the
    models' per-block replacement for JAX's ``nn.remat(Block)``.
    ``none`` returns ``block`` untouched."""
    if validate_policy(policy) == "none":
        return block

    def run(*args, **kwargs):
        return _checkpoint(block, policy, args, kwargs)

    return run


def remat_fn(fn, policy: str):
    """Wrap a plain function (the train step's ``loss_fn``) per policy —
    the drop-in replacement for ``jax.checkpoint(loss_fn) if remat else
    loss_fn``."""
    return remat_block(fn, policy)
