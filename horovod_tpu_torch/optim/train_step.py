"""Data-parallel training step of the PyTorch port
(``horovod_tpu/optim/train_step.py`` ``DistributedTrainStep``).

::

    step = DistributedTrainStep(loss_fn, torch.optim.AdamW(model.parameters(), 3e-4))
    model, opt = step.init(model)
    model, opt, loss = step(model, opt, step.shard_batch(batch))

One call is the JAX step's shard_map body: value and gradient of
``loss_fn`` on this rank's shard, the bucketed gradient exchange, the
optimizer update, and the loss averaged across ranks.

A parallelism plan (``plan="dp=2,sp=2"`` or ``HOROVOD_PLAN``) lays the world
out as a mesh (``step.mesh``) and adds sequence parallelism: each rank gets
its dp rows and its contiguous sp chunk of the tokens, and the model's
ring or Ulysses attention runs over ``step.mesh.group("sp")``.  A zigzag
ring masks by other positions than contiguous chunks hold, so under
``HOROVOD_SP_LAYOUT=zigzag`` :meth:`DistributedTrainStep.shard_batch`
refuses an sp plan rather than hand out tokens the mask does not match.  Because the
loss is a token mean over equal chunks, sp joins the gradient and loss
average like a data axis: the world group already spans dp × sp.

Expert parallelism (``plan="dp=2,ep=2"``): the batch's rows split over the
data axes × ep, each rank runs its ``E/ep`` experts of the replicated
weights over ``step.mesh.group("ep")`` (``MoETransformerLM(ep_group=...)``),
and the exchange averages over every rank, as ``examples/moe_lm_example.py``
averages over ep: with ample capacity a step equals local experts on the
global batch.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from torch.utils._pytree import tree_flatten, tree_unflatten

from horovod_tpu_torch import functions as F
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.ops.collectives import Average, ReduceOp, Sum
from horovod_tpu_torch.ops.fused_collectives import resolve_fused_collectives
from horovod_tpu_torch.optim.optimizer import (
    DistributedOptimizer,
    _DistributedOptimizer,
    _ShardedDistributedOptimizer,
)
from horovod_tpu_torch.parallel.mesh import ParallelMesh, make_parallel_mesh
from horovod_tpu_torch.parallel.plan import PLAN_AXES, ShardingPlan
from horovod_tpu_torch.runtime import config, state

#: the sharded exchange's options as a step leaves them unset
_SHARDED_DEFAULTS = dict(shard_optimizer_states=False,
                         exchange_bucket_bytes=None, hierarchy="auto",
                         fused_collectives="auto", error_feedback=False,
                         reduction=None)


class DistributedTrainStep:
    """``loss_fn(model, batch) -> scalar`` must be the *mean* loss over its
    batch shard.  ``optimizer`` is a ``torch.optim.Optimizer`` over the
    model's parameters, wrapped here in :func:`DistributedOptimizer` with
    ``op`` and ``compression``, or an optimizer that
    :func:`DistributedOptimizer` already wrapped (then ``op`` and
    ``compression`` must stay at their defaults).

    ``plan`` (a :class:`~horovod_tpu_torch.parallel.plan.ShardingPlan` or
    its ``HOROVOD_PLAN`` string; unset, the knob) builds ``step.mesh`` with
    :func:`~horovod_tpu_torch.parallel.mesh.make_parallel_mesh` unless a
    ``mesh`` is given, which must match it (a mesh alone stands for its
    own plan).  The step trains data plans (dp/fsdp) plus sequence
    parallelism (sp) and expert parallelism (ep); plans with pp or tp are
    rejected.  Every rank must construct the step with the same plan,
    since the mesh's groups are created collectively.

    ``shard_optimizer_states=True`` wraps the optimizer in the ZeRO-style
    sharded exchange (:func:`DistributedOptimizer`'s argument of that
    name), with ``exchange_bucket_bytes``, ``hierarchy``,
    ``fused_collectives``, ``error_feedback`` and ``reduction``; unset,
    the first four fall back to ``HOROVOD_EXCHANGE_BUCKET_BYTES``,
    ``HOROVOD_EXCHANGE_HIERARCHY``, ``HOROVOD_FUSED_COLLECTIVES`` and
    ``HOROVOD_EXCHANGE_REDUCTION``, as in the JAX step.  The sharded
    exchange with ep > 1 raises ``NotImplementedError`` (ROADMAP Queue A
    13: the JAX package compiles that pair only under pjit).

    ``moe_fused`` and ``moe_capacity_factor`` are the MoE schedule (unset:
    ``HOROVOD_MOE_FUSED_DISPATCH`` and ``HOROVOD_MOE_CAPACITY_FACTOR``;
    neither set: the model's ``MoEConfig`` rules).  The step exposes them
    resolved and, where set, writes them into the config of every
    ``SwitchFFN`` of the model it trains, in :meth:`init` and at each
    call; the JAX step only stamps them into its AOT key and leaves the
    routing to the model's config."""

    def __init__(self, loss_fn: Callable, optimizer,
                 op: ReduceOp = Average, compression=None, plan=None,
                 mesh: Optional[ParallelMesh] = None,
                 shard_optimizer_states: bool = False,
                 exchange_bucket_bytes: Optional[int] = None,
                 hierarchy: str = "auto",
                 fused_collectives: str = "auto",
                 error_feedback: bool = False,
                 reduction: Optional[str] = None,
                 moe_fused: Optional[str] = None,
                 moe_capacity_factor: Optional[float] = None):
        self.plan, self.mesh = _resolve_plan(plan, mesh)
        if self.plan is not None and self.plan.ep > 1 and (
                shard_optimizer_states or
                isinstance(optimizer, _ShardedDistributedOptimizer)):
            raise NotImplementedError(
                f"shard_optimizer_states with plan {self.plan.to_string()}: "
                f"the sharded exchange with ep > 1 is not ported (ROADMAP "
                f"Queue A 13; the JAX package compiles it only under pjit, "
                f"where the exchange scope leaves ep out)")
        if moe_fused is None:
            moe_fused = os.environ.get("HOROVOD_MOE_FUSED_DISPATCH")
        self._moe_fused = None if moe_fused is None else (
            "on" if resolve_fused_collectives(str(moe_fused).lower())
            else "off")
        if moe_capacity_factor is None:
            env_cf = os.environ.get("HOROVOD_MOE_CAPACITY_FACTOR")
            moe_capacity_factor = float(env_cf) if env_cf else None
        self._moe_capacity_factor = None if moe_capacity_factor is None \
            else float(moe_capacity_factor)
        sharded = dict(shard_optimizer_states=shard_optimizer_states,
                       exchange_bucket_bytes=exchange_bucket_bytes,
                       hierarchy=hierarchy,
                       fused_collectives=fused_collectives,
                       error_feedback=error_feedback, reduction=reduction)
        if isinstance(optimizer, _DistributedOptimizer):
            if op != Average or compression is not None or \
                    sharded != _SHARDED_DEFAULTS:
                raise ValueError("op/compression and the sharded exchange's "
                                 "options belong to the "
                                 "DistributedOptimizer already given")
        else:
            if shard_optimizer_states:
                cfg = state.global_state().config
                if exchange_bucket_bytes is None:
                    sharded["exchange_bucket_bytes"] = \
                        cfg.exchange_bucket_bytes
                if hierarchy == "auto":
                    sharded["hierarchy"] = cfg.exchange_hierarchy
                if fused_collectives == "auto":
                    sharded["fused_collectives"] = cfg.fused_collectives
            optimizer = DistributedOptimizer(optimizer, op=op,
                                             compression=compression,
                                             **sharded)
        self._loss_fn = loss_fn
        self.optimizer = optimizer

    @property
    def moe_fused(self) -> Optional[str]:
        """The MoE expert dispatch the step applies: ``"on"`` (the fused
        ring), ``"off"`` (two all_to_alls), or None (the model's own)."""
        return self._moe_fused

    @property
    def moe_capacity_factor(self) -> Optional[float]:
        """The MoE capacity factor the step applies (None: the model's
        own)."""
        return self._moe_capacity_factor

    def _apply_moe_schedule(self, model: torch.nn.Module) -> None:
        over = {k: v for k, v in (("fused_dispatch", self._moe_fused),
                                  ("capacity_factor",
                                   self._moe_capacity_factor))
                if v is not None}
        if not over:
            return
        from horovod_tpu_torch.models.moe import moe_layers

        for ffn in moe_layers(model):
            if any(getattr(ffn.cfg, k) != v for k, v in over.items()):
                ffn.cfg = dataclasses.replace(ffn.cfg, **over)

    def init(self, model: torch.nn.Module):
        """Broadcast rank 0's parameters, and its optimizer state unless the
        state is sharded (each rank's shard state is its own, as the JAX
        step's ``init_fn`` builds it per rank); returns ``(model,
        optimizer)``."""
        self._apply_moe_schedule(model)
        F.broadcast_variables(model, root_rank=0)
        if not isinstance(self.optimizer, _ShardedDistributedOptimizer):
            F.broadcast_optimizer_state(self.optimizer.optimizer,
                                        root_rank=0)
        return model, self.optimizer

    def shard_batch(self, batch):
        """This rank's part of the *global* batch (identical on every
        rank), on the runtime's device.  Accepts a tensor, a numpy array,
        or a dict of them.  The leading dim is split over the data ranks
        (the world, or under a plan its dp × fsdp × ep extent, row-major,
        as the JAX ep formulation shards the batch over ``ep``); under a plan
        with sp > 1 dim 1, the tokens, is split into contiguous chunks
        over the sp group (JAX ``batch_spec``), which is the ``contiguous``
        layout; under ``HOROVOD_SP_LAYOUT=zigzag`` it raises, since the
        ring would mask those chunks by zigzag positions."""
        st = state.global_state()
        if self.plan is None:
            data, data_index, sp, sp_index = st.size, st.rank, 1, 0
        else:
            plan, mesh = self.plan, self.mesh
            data, data_index = 1, 0
            for ax in plan.data_axes + (("ep",) if plan.ep > 1 else ()):
                # row-major over dp, fsdp, ep
                extent = getattr(plan, ax)
                data, data_index = data * extent, \
                    data_index * extent + mesh.index(ax)
            sp, sp_index = plan.sp, mesh.index("sp")
            if sp > 1 and config.sp_layout() == "zigzag":
                raise ValueError(
                    "HOROVOD_SP_LAYOUT=zigzag: shard_batch splits the tokens "
                    "into contiguous chunks, which a zigzag ring would mask "
                    "by the wrong positions; leave the knob unset, permute "
                    "the global batch with zigzag_sequence_indices before "
                    "shard_batch, and give the model "
                    "TransformerConfig(sp_layout='zigzag') and the positions "
                    "of ring_layout_positions")

        def shard(x):
            x = torch.as_tensor(np.asarray(x)) if isinstance(x, np.ndarray) \
                else x
            if x.shape[0] % data:
                raise ValueError(f"batch dim {x.shape[0]} does not divide "
                                 f"by the {data} data ranks")
            n = x.shape[0] // data
            x = x[data_index * n:(data_index + 1) * n]
            if sp > 1:
                if x.dim() < 2 or x.shape[1] % sp:
                    raise ValueError(f"sp={sp} splits dim 1 (tokens), got "
                                     f"shape {tuple(x.shape)}")
                c = x.shape[1] // sp
                x = x[:, sp_index * c:(sp_index + 1) * c]
            return x.to(st.device, non_blocking=True)

        if isinstance(batch, dict):
            return {k: shard(v) for k, v in batch.items()}
        return shard(batch)

    def __call__(self, model: torch.nn.Module, optimizer, batch):
        self._apply_moe_schedule(model)
        optimizer.zero_grad(set_to_none=True)
        loss = self._loss_fn(model, batch)
        loss.backward()
        optimizer.step()
        return model, optimizer, C.allreduce(loss.detach(), op=Average)


def _resolve_plan(plan, mesh: Optional[ParallelMesh]):
    """(resolved plan, mesh) of a step, or (None, None) without either."""
    if isinstance(plan, str):
        plan = ShardingPlan.from_string(plan)
    if plan is None and mesh is None:
        text = state.global_state().config.plan \
            if state.is_initialized() else None
        if not text:
            return None, None
        plan = ShardingPlan.from_string(text)
    if plan is None:
        plan = ShardingPlan(**mesh.shape)
    plan = plan.resolve(state.global_state().size)
    if plan.pp > 1:
        raise ValueError(
            f"plan {plan.to_string()} has pp>1: pipeline parallelism is not "
            f"a plan of the training step")
    blocked = tuple(a for a in plan.model_axes if a not in ("sp", "ep"))
    if blocked:
        raise ValueError(
            f"plan {plan.to_string()} has model axes {blocked}: the step "
            f"trains data plans (dp/fsdp) plus sequence parallelism (sp) "
            f"and expert parallelism (ep)")
    if mesh is None:
        mesh = make_parallel_mesh(**{ax: getattr(plan, ax)
                                     for ax in PLAN_AXES})
    elif any(mesh.shape[ax] != getattr(plan, ax) for ax in PLAN_AXES):
        raise ValueError(f"plan {plan.to_string()} does not match the given "
                         f"mesh {mesh.shape}")
    return plan, mesh


def join_step(grads, has_data):
    """Ragged-data gradient reduction: the in-step JoinOp (JAX
    ``optim/train_step.py:1018``; reference ``JoinOp``,
    ``collective_operations.h:259``).  Every rank takes part; one whose
    ``has_data`` is False contributes zeros, and the sum is divided by the
    number of ranks that have data (0 when none has).  ``grads`` is a
    tensor or a list, tuple or dict of them, returned in the same
    structure and dtypes."""
    leaves, spec = tree_flatten(grads)
    flag = torch.as_tensor(has_data, dtype=torch.float32,
                           device=leaves[0].device)
    n = C.allreduce(flag, op=Sum)
    inv = torch.where(n > 0, 1.0 / n.clamp(min=1.0), torch.zeros_like(n))
    masked = [torch.where(flag > 0, g, torch.zeros_like(g)) for g in leaves]
    summed = C.grouped_allreduce(masked, op=Sum)
    return tree_unflatten([(s.float() * inv).to(s.dtype) for s in summed],
                          spec)
