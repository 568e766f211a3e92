"""Data-parallel training step of the PyTorch port
(``horovod_tpu/optim/train_step.py`` ``DistributedTrainStep``).

::

    step = DistributedTrainStep(loss_fn, torch.optim.AdamW(model.parameters(), 3e-4))
    model, opt = step.init(model)
    model, opt, loss = step(model, opt, step.shard_batch(batch))

One call is the JAX step's program: value and gradient of ``loss_fn`` on
this rank's shard, the bucketed gradient exchange, the optimizer update,
and the loss averaged over the exchange's scope.

The JAX step has two modes, and so does this one (``step.mode``):

* ``"pjit"``: a plan is a placement.  The exchange is scoped to the plan's
  data axes (with ep, as the ep exchange always was); tp > 1 shards the
  model's ``ColumnParallelDense``/``RowParallelDense`` modules over
  ``step.mesh.group("tp")`` (what the JAX modules' partition annotations
  ask GSPMD for), and fsdp > 1 places every large leaf over the fsdp
  group (:mod:`~horovod_tpu_torch.parallel.fsdp`).  The ranks of a tp
  group see the same rows.
* ``"shard_map"``: the explicit exchange over the world, where the JAX
  package runs Adasum, Sum, a compressed wire, ``op=None``, the sparse
  exchange, the sharded (ZeRO) exchange and sequence parallelism; a
  plan's model axes other than sp are refused there, as JAX refuses them,
  but for ep when the default mode chose shard_map (class docstring).

Sequence parallelism (``plan="dp=2,sp=2"``, shard_map): each rank gets its
dp rows and its contiguous sp chunk of the tokens, and the model's ring or
Ulysses attention runs over ``step.mesh.group("sp")``.  A zigzag ring masks
by other positions than contiguous chunks hold, so under
``HOROVOD_SP_LAYOUT=zigzag`` :meth:`DistributedTrainStep.shard_batch`
refuses an sp plan rather than hand out tokens the mask does not match.
Because the loss is a token mean over equal chunks, sp joins the gradient
and loss average like a data axis: the world group already spans dp × sp.

Expert parallelism (``plan="dp=2,ep=2"``, pjit): the batch's rows split
over the data axes × ep, each rank runs its ``E/ep`` experts of the
replicated (or fsdp-placed) weights over ``step.mesh.group("ep")``
(``MoETransformerLM(ep_group=...)``), and the exchange averages over the
data axes and ep, as ``examples/moe_lm_example.py`` averages over ep: with
ample capacity a step equals local experts on the global batch.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from horovod_tpu_torch import functions as F
from horovod_tpu_torch import telemetry
from horovod_tpu_torch.memory.remat import remat_fn, resolve_remat_policy
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.ops.collectives import Average, ReduceOp, Sum
from horovod_tpu_torch.ops.fused_collectives import resolve_fused_collectives
from horovod_tpu_torch.optim.optimizer import (
    DistributedOptimizer,
    _DistributedAdasumOptimizer,
    _DistributedOptimizer,
    _ShardedDistributedOptimizer,
)
from horovod_tpu_torch.parallel import fsdp
from horovod_tpu_torch.parallel.mesh import AXIS_ORDER, ParallelMesh
from horovod_tpu_torch.parallel.plan import ShardingPlan
from horovod_tpu_torch.parallel.tensor_parallel import (
    ColumnParallelDense,
    tp_modules,
)
from horovod_tpu_torch.runtime import compile_cache, config, state
from horovod_tpu_torch.runtime.distributed import raise_internal

#: the step's modes (JAX's ``mode``)
MODES = ("pjit", "shard_map")

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
    own plan).  Plans with pp are rejected.  Every rank must construct the
    step with the same plan, since the mesh's groups are created
    collectively.  A model that a plan's tp shards is built before the
    optimizer: at full width (:meth:`init` shards it over
    ``step.mesh.group("tp")``) or with ``tp_group=mesh.group("tp")`` of the
    mesh the step is given (``plan.build_mesh()``); :meth:`init` checks
    the model's tp extent against the plan's.

    ``mode`` is JAX's (module docstring): ``"pjit"`` or ``"shard_map"``
    (:attr:`mode`).  Its default, None, resolves to ``"shard_map"`` when
    the call asks for what the JAX step runs only there
    (``shard_optimizer_states``, an ``op`` other than Average, ``op=None``,
    a ``compression``, ``sparse_params``, an optimizer wrapped with one of
    those, or sp > 1) and to ``"pjit"`` otherwise; a data plan trains
    alike under both.  A shard_map it chose takes an ep plan on the world
    exchange, where the JAX step refuses ep under shard_map; an explicit
    ``mode="shard_map"`` and ``shard_optimizer_states`` refuse it in JAX's
    words.  ``data_axes`` (default: the plan's) must equal the
    plan's data axes.  ``fsdp_axis`` (pjit only; a plan with fsdp > 1 sets
    ``"fsdp"``) places the parameters over that mesh axis in :meth:`init`,
    leaves below ``fsdp_min_weight_size`` elements (default ``2**14``)
    whole; the optimizer must then be a torch optimizer, which the step
    wraps in :meth:`init`, after the placement, and a call needs the
    optimizer :meth:`init` returned.  Every refusal the JAX step makes is
    made in its words.

    Under a plan with tp > 1 (pjit) the step also wraps a torch
    optimizer in :meth:`init`, after the model's tensor-parallel modules
    are cut, since the exchange plans its buckets over the parameters'
    sizes.

    ``shard_optimizer_states=True`` wraps the optimizer in the ZeRO-style
    sharded exchange (:func:`DistributedOptimizer`'s argument of that
    name), with ``exchange_bucket_bytes``, ``hierarchy``,
    ``fused_collectives``, ``error_feedback`` and ``reduction``; unset,
    the first four fall back to ``HOROVOD_EXCHANGE_BUCKET_BYTES``,
    ``HOROVOD_EXCHANGE_HIERARCHY``, ``HOROVOD_FUSED_COLLECTIVES`` and
    ``HOROVOD_EXCHANGE_REDUCTION``, and the per-level codecs are
    ``HOROVOD_EXCHANGE_LEVEL_CODECS``'s, as in the JAX step (the
    optimizer reads that one).  :attr:`exchange_hierarchy` is the
    topology the exchange runs.  With ep > 1 it resolves to shard_map,
    which refuses ep as JAX's does: sharded state under ep is the fsdp
    placement (``plan="fsdp=2,ep=2"``).

    ``op=Adasum`` reduces the gradients by Adasum over the world's layout.
    ``op=None`` leaves them local: the optimizer owns the reduction, as
    :func:`~horovod_tpu_torch.optim.optimizer.DistributedAdasumOptimizer`
    does (the only distributing optimizer the step takes with it; given
    one, ``op`` must be None), and neither ``compression`` nor
    ``sparse_params`` may be given.  ``sparse_params`` (``{pattern:
    max_rows}``) reaches :func:`DistributedOptimizer`; since it matches
    ``named_parameters`` names, the step wraps the optimizer in
    :meth:`init`, from the model's names, and a call needs the optimizer
    that :meth:`init` returned.  The loss is averaged over the exchange's
    scope whatever ``op`` is.

    ``remat`` (a bool or a policy string, ``none|dots|full|offload``)
    wraps ``loss_fn`` in that remat tier
    (:func:`~horovod_tpu_torch.memory.remat.remat_fn`); :attr:`remat_policy`
    is the policy resolved with the ``HOROVOD_REMAT_POLICY`` knob, which the
    models read per block.  With the sharded exchange, the first call sets
    the cost model's wire bytes a step per layout level as gauges.

    ``guard`` attaches the numerics guardian
    (:class:`~horovod_tpu_torch.guard.TrainingGuard`, or anything with
    ``current_limit()`` and ``observe(gnorm, limit=)``): once the exchange
    has finished, the global gradient norm is computed on the device and
    read on the host, and the optimizer's update runs only when the norm
    is finite and at most the guardian's current limit (rounded to fp32,
    as the JAX step's traced limit is); otherwise the parameters and the
    optimizer's state (moments, step counters, error-feedback residuals)
    stay as they were.  Then the guardian observes the norm against that
    limit and applies its policy, raising ``GuardRollback``/``GuardAbort``
    from the call.  The norm is JAX's: that of the reduced gradient on the
    hook path and under pjit, where a tp or fsdp shard's squares are summed
    over the group that holds the shards and a leaf tp leaves whole counts
    once; under the sharded exchange and ``op=None`` the root of the
    world's sum of each rank's sum of squares before the reduction.  A
    call that only accumulates (``backward_passes_per_step``) observes
    nothing.  Every rank reaches the same verdict.  A guard requires
    ``steps_per_call=1`` (JAX's rule) and refuses an ep plan, whose experts
    differ by rank.

    ``steps_per_call=k`` is JAX's scanned call: one call makes ``k``
    optimizer steps on the same batch and returns the last step's loss;
    the parameters and the optimizer's state then equal those after ``k``
    calls of ``steps_per_call=1``, and ``hvd_steps_total`` and the run
    context advance by ``k``.  On the CPU (the caller asked for it) the
    call runs the eager step ``k`` times.  On a card one whole step
    (``zero_grad``, ``loss_fn``, backward with the hook-fired exchange on
    its side stream, ``optimizer.step()`` and the loss's all-reduce) is
    captured as a ``torch.cuda.CUDAGraph`` and replayed: the first call of
    a key runs one step eagerly (the warm-up of the optimizer's state,
    NCCL's communicators and the kernels' first-use host calls, and step 1
    of the ``k``), captures the next and replays it ``k - 1`` times; a later
    call copies the batch into the graph's static inputs and replays it
    ``k`` times.  One host dispatch then makes ``k`` updates.  A capture
    that fails raises; nothing falls back to the eager loop.  The graph
    lives in the compile cache's in-memory layer
    (:class:`~horovod_tpu_torch.runtime.compile_cache.ExecutableLRU`),
    keyed by
    :func:`~horovod_tpu_torch.runtime.compile_cache.executable_key`: a new
    float lr, shape, plan or ``k`` captures anew.  The step keeps one graph:
    its memory pool holds a copy of the gradients and the step's
    activations, so a new key's capture replaces the old graph, never adds
    one.  A learning-rate schedule is replayed without a capture when the
    optimizer's lr is a tensor on the card (``lr=torch.tensor(3e-4,
    device="cuda")``: the graph reads it at each replay, and torch's
    schedulers ``fill_`` it); a float lr that changes every call captures
    every call.  A graph is also bound to the tensors it was captured on
    (the model's parameters and buffers, the optimizer's parameters,
    tensor hyperparameters and state, all of which the graph holds): a
    call that finds one of them replaced (``load_state_dict``,
    ``broadcast_optimizer_state``, another model of the same shapes)
    captures anew, as a miss.  A random draw
    from the default CUDA generator (dropout) gets fresh numbers at each
    replay, since the capture registers that generator; a draw from a
    generator of the caller's is replayed with the captured offsets unless
    the caller registers it with the graph.  On a card the
    torch optimizer must be built with ``capturable=True`` where it has
    that flag (AdamW keeps its step count on the host otherwise, which a
    graph cannot advance); it is not flipped here.  ``k > 1`` refuses what
    cannot be captured: the row-sparse exchange (``sparse_params``) and
    Adasum (each reads values on the host), the sharded exchange's error
    feedback (each step replaces the residual tensors, which a replay
    would not see), ``backward_passes_per_step > 1`` (the hook path counts
    the passes on the host), and, on a card, an elastic world of several
    ranks (the exchange's host wait polls a CUDA event, which a capturing
    stream forbids).

    ``moe_fused`` and ``moe_capacity_factor`` are the MoE schedule (unset:
    ``HOROVOD_MOE_FUSED_DISPATCH`` and ``HOROVOD_MOE_CAPACITY_FACTOR``;
    neither set: the model's ``MoEConfig`` rules).  The step exposes them
    resolved and, where set, writes them into the config of every
    ``SwitchFFN`` of the model it trains, in :meth:`init` and at each
    call; the JAX step only stamps them into its AOT key and leaves the
    routing to the model's config."""

    def __init__(self, loss_fn: Callable, optimizer,
                 op: Optional[ReduceOp] = Average, compression=None,
                 plan=None,
                 mesh: Optional[ParallelMesh] = None,
                 shard_optimizer_states: bool = False,
                 exchange_bucket_bytes: Optional[int] = None,
                 hierarchy: str = "auto",
                 fused_collectives: str = "auto",
                 error_feedback: bool = False,
                 reduction: Optional[str] = None,
                 moe_fused: Optional[str] = None,
                 moe_capacity_factor: Optional[float] = None,
                 sparse_params: Optional[dict] = None,
                 mode: Optional[str] = None,
                 data_axes=None,
                 fsdp_axis: Optional[str] = None,
                 fsdp_min_weight_size: Optional[int] = None,
                 remat: Union[bool, str] = False,
                 guard=None, steps_per_call: int = 1):
        if steps_per_call < 1:
            raise ValueError(
                f"steps_per_call must be >= 1, got {steps_per_call}")
        if guard is not None and steps_per_call != 1:
            raise ValueError(
                "guard= requires steps_per_call=1: the guardian must "
                "observe (and be able to suppress) every optimizer step "
                "individually — a scanned multi-step program would apply "
                "k-1 updates before the host sees the first norm")
        self._steps_per_call = int(steps_per_call)
        self._guard = guard
        self._world = state.world_id()
        self.plan, self.mesh = _resolve_plan(plan, mesh)
        plan = self.plan
        # a shard_map that mode=None chose keeps ep on the world exchange
        # (rows over the data axes x ep, every gradient averaged over the
        # world); an explicit mode="shard_map" and the sharded exchange
        # refuse ep as the JAX step does
        kept_axes = ("sp",) if mode is not None or shard_optimizer_states \
            else ("sp", "ep")
        if mode is None:
            mode = _default_mode(plan, optimizer, op, compression,
                                 shard_optimizer_states, sparse_params)
        if plan is not None:
            blocked_model_axes = tuple(
                a for a in plan.model_axes if a not in kept_axes)
            if mode == "shard_map" and blocked_model_axes:
                raise ValueError(
                    f"plan {plan.to_string()} has model axes "
                    f"{blocked_model_axes}: mode='shard_map' compiles "
                    "data plans (dp/fsdp) plus sequence parallelism "
                    "(sp — the batch's token dim shards over the sp "
                    "axis and the model's ring/ulysses attention owns "
                    "the exchange) — tp/ep plans need mode='pjit', "
                    "where GSPMD places the shardings the model's "
                    "modules declare")
            if data_axes is not None:
                norm_axes = (data_axes,) if isinstance(data_axes, str) \
                    else tuple(data_axes)
                if norm_axes != plan.data_axes:
                    raise ValueError(
                        f"data_axes {norm_axes} conflicts with plan "
                        f"{plan.to_string()} (data axes "
                        f"{plan.data_axes}): the plan owns the exchange "
                        "scope — drop the explicit data_axes")
            if mode == "pjit" and plan.fsdp > 1 and fsdp_axis is None:
                fsdp_axis = "fsdp"
        elif data_axes is not None:
            raise ValueError(
                "data_axes names axes of a mesh, and the port's world has "
                "none without one: pass plan= or mesh=")
        if shard_optimizer_states:
            if mode != "shard_map":
                raise ValueError(
                    "shard_optimizer_states requires mode='shard_map' "
                    "(the explicit exchange; under pjit use fsdp_axis, "
                    "where GSPMD inserts the sharded collectives)")
            # op=None is refused below, in the words of the delta form
            if op is not None and op not in (ReduceOp.SUM,
                                             ReduceOp.AVERAGE):
                raise ValueError(
                    "shard_optimizer_states performs the gradient "
                    "reduction itself and supports op=Sum/Average")
            if sparse_params:
                raise ValueError(
                    "shard_optimizer_states is incompatible with "
                    "sparse_params (sparse leaves bypass the fused "
                    "flat buffer the shard slicing is defined over)")
        if fsdp_axis is not None and mode != "pjit":
            raise ValueError(
                "fsdp_axis requires mode='pjit' (GSPMD inserts the "
                "gather/reduce-scatter collectives; shard_map mode "
                "manages per-device values by hand)")
        mesh_axes = tuple(self.mesh.shape) if self.mesh is not None else ()
        if fsdp_axis is not None and fsdp_axis not in mesh_axes:
            raise ValueError(
                f"fsdp_axis {fsdp_axis!r} is not an axis of the mesh "
                f"{mesh_axes}")
        if fsdp_min_weight_size is not None and fsdp_axis is None:
            raise ValueError(
                "fsdp_min_weight_size has no effect without fsdp_axis")
        if sparse_params and mode != "shard_map":
            raise ValueError(
                "sparse_params requires mode='shard_map' (pjit autodiff "
                "reduces every gradient densely)")
        if op is None and mode != "shard_map":
            raise ValueError(
                "op=None (gradients stay local; the optimizer chain owns "
                "the reduction, e.g. DistributedAdasumOptimizer) requires "
                "mode='shard_map' — pjit autodiff would mean-reduce the "
                "gradients behind the optimizer's back")
        if op is None and sparse_params:
            raise ValueError(
                "op=None leaves gradients local, so train-step "
                "sparse_params would never route anything; pass sparse "
                "handling to the distributing optimizer instead")
        if op is None and compression is not None:
            raise ValueError(
                "op=None leaves gradients local, so a train-step "
                "compression would never run; pass compression to the "
                "distributing optimizer (e.g. DistributedAdasumOptimizer) "
                "instead")
        if mode == "pjit" and (op != Average or compression is not None):
            raise ValueError(
                "mode='pjit' performs a plain mean gradient reduction; use "
                "mode='shard_map' for op=Adasum/Sum or compression")
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        if guard is not None and plan is not None and plan.ep > 1:
            raise ValueError(
                f"guard= with plan {plan.to_string()}: each ep rank holds "
                f"other experts, and the guarded norm counts only leaves "
                f"that are whole or tp/fsdp shards")
        self._mode = mode
        self._fsdp_axis = fsdp_axis
        self._fsdp_min = fsdp_min_weight_size
        self.fsdp_placement = None
        #: the exchange's scope (None: the world) and its axes: under pjit
        #: with a plan, the data axes and ep; and the scope of the leaves
        #: fsdp places, which backward averages over fsdp already
        self._scope, self._scope_axes, self._rest_scope = None, None, None
        if mode == "pjit" and plan is not None:
            self._scope_axes = plan.data_axes + (
                ("ep",) if plan.ep > 1 else ())
            self._scope = self.mesh.scope(self._scope_axes)
            if C.is_world(self._scope):
                self._scope = None
            if fsdp_axis is not None:
                self._rest_scope = self.mesh.scope(
                    tuple(a for a in self._scope_axes if a != fsdp_axis))
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
        #: DistributedOptimizer's arguments until init() names the
        #: parameters for sparse_params, or places them for fsdp
        self._wrap = None
        if isinstance(optimizer, _DistributedOptimizer):
            if op != Average or compression is not None or \
                    sharded != _SHARDED_DEFAULTS or sparse_params:
                raise ValueError("op/compression, sparse_params and the "
                                 "sharded exchange's options belong to the "
                                 "DistributedOptimizer already given")
            if fsdp_axis is not None:
                raise ValueError(
                    f"fsdp_axis {fsdp_axis!r} places the parameters the "
                    f"optimizer holds: pass the torch optimizer, which the "
                    f"step wraps after the placement")
            if optimizer.axis is not self._scope and not (
                    C.is_world(optimizer.axis) and C.is_world(self._scope)):
                where = "the step exchanges over the world" \
                    if self._scope_axes is None else (
                        f"plan {plan.to_string()} scopes the exchange to "
                        f"{self._scope_axes}")
                raise ValueError(
                    f"{where}; the DistributedOptimizer given exchanges "
                    f"over another group: wrap it with that scope (the "
                    f"step's mesh.scope(...)), or pass the torch optimizer")
        elif op is None or isinstance(optimizer,
                                      _DistributedAdasumOptimizer):
            if op is not None:
                raise ValueError(
                    "a DistributedAdasumOptimizer reduces the weight deltas "
                    "itself and leaves the gradients local: pass op=None")
            if sharded != _SHARDED_DEFAULTS:
                raise ValueError(
                    "op=None leaves gradients local; the sharded exchange "
                    "reduces them and supports op=Sum/Average")
        elif sparse_params:
            if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
                raise ValueError("sparse_params supports op=Sum/Average")
            self._wrap = dict(op=op, compression=compression,
                              sparse_params=sparse_params, **sharded)
        elif fsdp_axis is not None:
            self._wrap = {}             # wrapped in init, after placement
        elif mode == "pjit" and plan is not None and plan.tp > 1:
            # wrapped in init, once the tp shards have their sizes: the
            # exchange plans its buckets over the parameters' bytes
            self._wrap = dict(op=op, compression=compression,
                              axis=self._scope)
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
                                             axis=self._scope, **sharded)
        # remat takes the legacy bool or a policy string; the resolved
        # policy (the HOROVOD_REMAT_POLICY knob included, which steers the
        # models' per-block remat) is the step's property, and the loss is
        # wrapped only when the caller asked: a knob-driven model already
        # remats per block
        self._remat_policy = resolve_remat_policy(remat=remat)
        if remat:
            loss_fn = remat_fn(loss_fn, self._remat_policy)
        self._wire_recorded = False
        self._loss_fn = loss_fn
        self.optimizer = optimizer
        self._hierarchy = optimizer.exchange_hierarchy if isinstance(
            optimizer, _ShardedDistributedOptimizer) else hierarchy
        self._fused_collectives = "on" if shard_optimizer_states and \
            resolve_fused_collectives(str(fused_collectives).lower()) \
            else "off"
        if self._steps_per_call > 1:
            _check_capturable(self._steps_per_call, optimizer, op,
                              sparse_params, reduction)
        #: the captured steps (created at the first graph call) and the
        #: stream they are captured on
        self._graphs = None
        self._capture_stream = None
        self._last_cache_hit: Optional[bool] = None
        #: graph replays this step has run (each one optimizer step)
        self.replays = 0
        self._tel_steps = telemetry.counter(
            "hvd_steps_total", "optimizer steps executed")
        self._tel_step_seconds = telemetry.histogram(
            "hvd_step_seconds",
            "host wall time per train-step dispatch call")

    @property
    def mode(self) -> str:
        """``"pjit"`` or ``"shard_map"``, as resolved (class docstring)."""
        return self._mode

    @property
    def steps_per_call(self) -> int:
        """Optimizer steps a call makes (class docstring)."""
        return self._steps_per_call

    @property
    def compile_cache_hit(self) -> Optional[bool]:
        """Whether the kernel library this step's kernels ran from was
        loaded from the compile cache's store (``True``) or compiled by this
        process (``False``); ``None`` before a call on a card, on the CPU,
        and with the store disabled.  (JAX's property of that name reads
        the AOT store's verdict on the step's executable.  The port's store
        keeps executables of exported forwards, ``aot_compile``, but not
        yet of the training step, whose exchange fires from autograd hooks
        and whose update mutates the optimizer's state; the step's graph is
        captured in memory.)"""
        return self._last_cache_hit

    @property
    def graphs(self):
        """The captured steps, the compile cache's in-memory layer (None
        before the first call that captures)."""
        return self._graphs

    def _aot_extras(self) -> dict:
        """The step's knobs in an executable's key (JAX's field names):
        the captured graph of one plan, exchange or ``steps_per_call`` is
        never replayed for another."""
        opt = self.optimizer
        sharded = isinstance(opt, _ShardedDistributedOptimizer)
        plan = self.plan
        return {
            "mesh_shape": None if self.mesh is None
            else tuple(sorted(self.mesh.shape.items())),
            "mode": self._mode,
            "hierarchy": self._hierarchy,
            "fused_collectives": self._fused_collectives,
            "shard_optimizer_states": sharded,
            "data_axes": None if plan is None else plan.data_axes,
            "fsdp_axis": self._fsdp_axis,
            "steps_per_call": self._steps_per_call,
            "donate_batch": False,
            "guard": self._guard is not None,
            "plan": None if plan is None else plan.to_string(),
            "error_feedback": sharded and
            opt.sharded_state.residuals is not None,
            "reduction": opt.reduction if sharded else None,
            "remat": self._remat_policy,
            "moe_fused": self._moe_fused,
            "moe_capacity_factor": self._moe_capacity_factor,
            "sp": 1 if plan is None else plan.sp,
        }

    @property
    def exchange_scope(self):
        """The group the gradients and the loss are averaged over: None
        for the world, else, under pjit with a plan, the mesh's group of
        the data axes and ep (or ``ALONE``)."""
        return self._scope

    @property
    def exchange_hierarchy(self) -> str:
        """The exchange topology this step runs (JAX's property of that
        name): ``"flat"`` or ``"two_level"``, resolved against the world's
        layout, under the sharded exchange; the ``hierarchy`` argument as
        given otherwise."""
        return self._hierarchy

    @property
    def remat_policy(self) -> str:
        """The resolved remat policy (``none|dots|full|offload``) this step
        was built under: the ``remat=`` argument or the
        ``HOROVOD_REMAT_POLICY`` knob (:mod:`~horovod_tpu_torch.memory.
        remat`)."""
        return self._remat_policy

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
        """Broadcast rank 0's parameters (a tensor-parallel shard from the
        first rank that holds the same shard), and its optimizer state
        unless the state is per rank (sharded, or of a model tp or fsdp
        shards: each rank's is its own, as the JAX step builds it per
        rank); under pjit, then shard the model's tensor-parallel modules
        over the plan's tp group and place its leaves over the fsdp axis.
        Returns ``(model, optimizer)``."""
        self._apply_moe_schedule(model)
        to_shard = self._check_tp(model)
        _broadcast_model(model, self.mesh)
        for m in to_shard:
            m.shard_(self.mesh.group("tp"))
        scopes = {}
        if self._fsdp_axis is not None:
            kw = {} if self._fsdp_min is None else \
                {"min_weight_size": self._fsdp_min}
            self.fsdp_placement = fsdp.shard_params(
                model, self.mesh, self._fsdp_axis, **kw)
            placed = {id(p) for p in self.fsdp_placement.params}
            trainable = [p for g in self.optimizer.param_groups
                         for p in g["params"] if p.requires_grad]
            scopes = {i: self._rest_scope for i, p in enumerate(trainable)
                      if id(p) in placed}
        if self._wrap is not None:
            if self._fsdp_axis is not None:
                self.optimizer = _DistributedOptimizer(
                    self.optimizer, Average, None, 1, None, None,
                    axis=self._scope, scopes=scopes)
            else:
                self.optimizer = DistributedOptimizer(
                    self.optimizer,
                    named_parameters=model.named_parameters(), **self._wrap)
            self._wrap = None
        per_rank = isinstance(self.optimizer, _ShardedDistributedOptimizer) \
            or self._fsdp_axis is not None or any(
                m.tp > 1 for m in tp_modules(model))
        if not per_rank:
            F.broadcast_optimizer_state(
                getattr(self.optimizer, "optimizer", self.optimizer),
                root_rank=0)
        return model, self.optimizer

    def _check_tp(self, model: torch.nn.Module) -> list:
        """The model's tensor-parallel modules that :meth:`init` must
        shard over the plan's tp group; raises when the model's tp extent
        is not the plan's."""
        modules = list(tp_modules(model))
        tp = 1 if self.plan is None or self._mode != "pjit" else self.plan.tp
        wrong = sorted({m.tp for m in modules} - {1, tp})
        if wrong:
            raise ValueError(
                f"the model's tensor-parallel modules are sharded over tp="
                f"{wrong[0]}, and the step's plan "
                f"{self.plan.to_string() if self.plan else None} has tp="
                f"{tp}")
        if tp > 1 and not modules:
            raise ValueError(
                f"plan {self.plan.to_string()} has tp={tp}, and the model "
                f"holds no ColumnParallelDense/RowParallelDense module to "
                f"shard over it")
        return [m for m in modules if m.tp == 1 and tp > 1]

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
        return self._place(batch, slice_rows=True)

    def shard_local_batch(self, batch):
        """This rank's *own* rows on the runtime's device, with no slicing
        of the batch dim (the streaming-reader contract, JAX
        ``shard_local_batch``): each rank passes the rows it read, its
        shard of the global batch, as a :class:`~horovod_tpu_torch.data.
        ShardedDataset` hands them out.  Every rank must pass the same
        number of rows a call; under a plan with sp > 1 the ranks of one
        sp group pass the same rows, and dim 1 is split over the group as
        :meth:`shard_batch` splits it.  The copy is ``non_blocking``: from
        pinned memory (a :class:`~horovod_tpu_torch.data.PrefetchIterator`
        on a card) it runs on the current stream, off the host."""
        return self._place(batch, slice_rows=False)

    def _place(self, batch, slice_rows: bool):
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
            if slice_rows:
                if x.shape[0] % data:
                    raise ValueError(f"batch dim {x.shape[0]} does not "
                                     f"divide by the {data} data ranks")
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

    def _ready(self, model: torch.nn.Module) -> None:
        """Check the world and that :meth:`init` wrapped the optimizer,
        then write the MoE schedule into the model."""
        self._world = state.check_world(self._world,
                                        "this DistributedTrainStep")
        if self._wrap is not None:
            raise RuntimeError("the step wraps the optimizer in init(model) "
                               "(sparse_params names the parameters; fsdp "
                               "and tp cut them first): call init(model) "
                               "first and step with the optimizer it "
                               "returns")
        self._apply_moe_schedule(model)

    @raise_internal("the training step")
    def __call__(self, model: torch.nn.Module, optimizer, batch):
        self._ready(model)
        tel_on = telemetry.enabled()
        t0 = time.perf_counter() if tel_on else 0.0
        first = next(iter(model.parameters()), None)
        on_card = first is not None and first.is_cuda
        if on_card:
            from horovod_tpu_torch.ops import build

            self._last_cache_hit = build.library_hit \
                if compile_cache.resolve_dir() is not None else None
        if on_card and self._steps_per_call > 1:
            loss = self._graph_call(model, optimizer, batch)
        else:
            for _ in range(self._steps_per_call):
                loss = self._one_step(model, optimizer, batch)
        if tel_on:
            self._tel_step_seconds.observe(time.perf_counter() - t0)
            self._tel_steps.inc(self._steps_per_call)
            telemetry.run_context().advance_step(self._steps_per_call)
        return model, optimizer, loss

    @raise_internal("the training step")
    def trace(self, model: torch.nn.Module, optimizer, batch):
        """One optimizer step, traced: the counterpart of JAX's
        ``compiled_text``, whose HLO the collective guards and the cost
        model read.  Returns ``(loss, StepTrace)``
        (:mod:`~horovod_tpu_torch.utils.trace`): every collective the step
        issued, whatever module issued it, with its group's global ranks;
        the FLOPs of its matmul class by op (the kernels count the dense
        work they replace, a remat tier's recomputed forward counts
        again); its measured memory high-water; and on a card its kernels,
        streams and device intervals.

        Unlike JAX's, it takes a real step: the parameters and the
        optimizer's state advance as under :meth:`__call__`.  It runs one
        eager step whatever ``steps_per_call`` is (no graph is captured or
        replayed)."""
        from horovod_tpu_torch.utils.trace import trace_call

        self._ready(model)
        cfg = getattr(model, "cfg", None)
        sp = self.plan.sp if self.plan is not None and \
            getattr(cfg, "attention_impl", None) == "ring" else 1
        loss, tr = trace_call(self._one_step, model, optimizer, batch, sp=sp)
        if telemetry.enabled():
            # the step counts; its seconds under the profiler stay out of
            # the step-time histogram
            self._tel_steps.inc(1)
            telemetry.run_context().advance_step(1)
        return loss, tr

    def _one_step(self, model: torch.nn.Module, optimizer, batch):
        """One optimizer step (the eager step, and what a graph captures):
        the averaged loss."""
        optimizer.zero_grad(set_to_none=True)
        loss = self._loss_fn(model, batch)
        loss.backward()
        gnorm = None
        if self._guard is None:
            optimizer.step()
        else:
            # the limit the step runs with, in fp32 as JAX traces it
            limit = float(np.float32(self._guard.current_limit()))
            gnorm = optimizer.guarded_step(limit,
                                           sumsq=self._plan_sumsq(model))
        if not self._wire_recorded:
            self._record_wire_telemetry(model, optimizer)
        loss = C.allreduce(loss.detach(), op=Average, group=self._scope)
        if gnorm is not None:
            # the state is known unchanged on a failed verdict: the policy
            # may raise now
            self._guard.observe(gnorm, limit=limit)
        return loss

    def _graph_call(self, model: torch.nn.Module, optimizer, batch):
        """``steps_per_call`` steps through the captured graph of this
        call's key (class docstring); the last step's loss."""
        if self._graphs is None:
            self._graphs = compile_cache.ExecutableLRU(capacity=1)
        key = compile_cache.executable_key(
            self._aot_extras(), model=model, optimizer=optimizer,
            batch=batch)
        bound = _bound_tensors(model, optimizer)
        captured = self._graphs.get(key, valid=lambda c: c.binds(bound))
        if captured is None:
            # the old graph and its memory pool go before the new capture
            self._graphs.clear()
            # step 1 of k, eagerly: the optimizer's state, NCCL's
            # communicators and the kernels' first-use host calls exist
            # before the capture
            self._one_step(model, optimizer, batch)
            captured = self._capture(model, optimizer, batch)
            self._graphs.put(key, captured)
            replays = self._steps_per_call - 1
        else:
            captured.feed(batch)
            replays = self._steps_per_call
        for _ in range(replays):
            captured.graph.replay()
        self.replays += replays
        captured.restore_grads()
        return captured.graph.result.clone()

    def _capture(self, model: torch.nn.Module, optimizer,
                 batch) -> "CapturedStep":
        """One whole step captured on the step's capture stream, reading a
        static copy of ``batch``."""
        device = next(model.parameters()).device
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(device)
        static = tree_map(lambda t: t.clone() if isinstance(
            t, torch.Tensor) else t, batch)
        graph = compile_cache.capture(
            lambda: self._one_step(model, optimizer, static),
            self._capture_stream)
        params = [p for g in optimizer.param_groups for p in g["params"]]
        return CapturedStep(graph, static, params, [p.grad for p in params],
                            _bound_tensors(model, optimizer))

    def _plan_sumsq(self, model: torch.nn.Module):
        """The guarded norm's sum of squares over the trainable parameters
        under a pjit plan that shards leaves (tp > 1 or an fsdp axis): each
        tp shard's and fsdp shard's squares summed over the groups that
        hold its pieces (fsdp first, then tp), and the squares of the
        leaves tp leaves whole added on tp index 0 only, so every element
        counts once and every rank holds the same sum.  None (the
        optimizer's own sum) otherwise."""
        plan = self.plan
        if self._mode != "pjit" or plan is None or (
                plan.tp == 1 and self._fsdp_axis is None):
            return None
        import torch.distributed as dist

        from horovod_tpu_torch.optim.optimizer import grad_sumsq

        tp_ids = set()
        for m in tp_modules(model):
            if m.tp > 1:
                tp_ids.add(id(m.weight))
                if isinstance(m, ColumnParallelDense) and m.bias is not None:
                    tp_ids.add(id(m.bias))
        placed = set() if self.fsdp_placement is None else \
            {id(p) for p in self.fsdp_placement.params}
        tp_group = self.mesh.group("tp")
        fsdp_group = None if self._fsdp_axis is None else \
            self.mesh.group(self._fsdp_axis)
        first_tp = self.mesh.index("tp") == 0

        def sumsq(params) -> torch.Tensor:
            kinds = {"whole": [], "tp": [], "fsdp": [], "both": []}
            for p in params:
                if id(p) in placed:
                    kind = "both" if id(p) in tp_ids else "fsdp"
                else:
                    kind = "tp" if id(p) in tp_ids else "whole"
                kinds[kind].append(p.grad)
            s = {k: grad_sumsq(g).reshape(1) for k, g in kinds.items()}
            if fsdp_group is not None:
                placed_sums = torch.cat([s["both"], s["fsdp"]])
                dist.all_reduce(placed_sums, group=fsdp_group)
                s["both"], s["fsdp"] = placed_sums[:1], placed_sums[1:]
            total = s["tp"] + s["both"]
            if tp_group is None:
                return total + s["whole"] + s["fsdp"]
            if first_tp:
                total = total + s["whole"] + s["fsdp"]
            dist.all_reduce(total, group=tp_group)
            return total

        return sumsq

    def _record_wire_telemetry(self, model: torch.nn.Module,
                               optimizer) -> None:
        """Once: the cost model's wire bytes of the sharded exchange a
        step, per layout level (``hvd_exchange_wire_bytes{level=local|
        cross}``), and Adasum's extra cross bytes
        (``hvd_adasum_dot_wire_bytes``), as JAX's
        ``_record_step_telemetry`` sets them."""
        self._wire_recorded = True
        if not isinstance(optimizer, _ShardedDistributedOptimizer):
            return
        from horovod_tpu_torch import telemetry
        from horovod_tpu_torch.analysis import cost_model as CM

        st = state.global_state()
        payload = float(sum(p.numel() * p.element_size()
                            for p in model.parameters()))
        hierarchy = self._hierarchy \
            if self._hierarchy in ("flat", "two_level") else "flat"
        wire = CM.exchange_wire_bytes(payload, n_dcn=st.cross_size,
                                      n_ici=st.local_size,
                                      hierarchy=hierarchy)
        g = telemetry.gauge(
            "hvd_exchange_wire_bytes",
            "modeled per-step gradient-exchange bytes per layout level "
            "(analysis/cost_model.py)")
        g.set(wire.ici, level="local")
        g.set(wire.dcn, level="cross")
        if optimizer.reduction == "adasum":
            telemetry.gauge(
                "hvd_adasum_dot_wire_bytes",
                "modeled extra per-step cross-level bytes of the adasum "
                "exchange (analysis/cost_model.py)").set(
                    CM.adasum_extra_wire_bytes(payload, n_dcn=st.cross_size,
                                               n_ici=st.local_size))


class CapturedStep:
    """One captured step of :class:`DistributedTrainStep`: the graph
    (:class:`~horovod_tpu_torch.runtime.compile_cache.CapturedGraph`, whose
    result is the loss it writes), the static batch it reads, the
    gradients it leaves (installed again after a replay, for an eager call
    may have replaced them), and the tensors it was captured on
    (:func:`_bound_tensors`), held so that none is freed while the graph
    can still write it."""

    def __init__(self, graph, batch, params, grads, bound):
        self.graph = graph
        self.batch = batch
        self._params = params
        self._grads = grads
        self._bound = bound

    def binds(self, bound: list) -> bool:
        """Whether ``bound`` (this call's :func:`_bound_tensors`) are the
        very tensors the graph was captured on."""
        return len(bound) == len(self._bound) and all(
            a is b for a, b in zip(bound, self._bound))

    def feed(self, batch) -> None:
        """Copy this call's batch into the static inputs."""
        for s, b in zip(tree_flatten(self.batch)[0], tree_flatten(batch)[0]):
            if isinstance(s, torch.Tensor):
                s.copy_(b, non_blocking=True)

    def restore_grads(self) -> None:
        for p, g in zip(self._params, self._grads):
            p.grad = g


def _bound_tensors(model: torch.nn.Module, optimizer) -> list:
    """The tensors a captured step reads or updates in place, in a fixed
    order: the model's parameters and buffers, the user's param groups'
    tensor hyperparameters, and the optimizer that updates (the innermost
    torch optimizer, or the sharded exchange's over its flat shards): its
    groups' tensor hyperparameters, parameters and state.  Their addresses
    are in the graph."""
    out = [*model.parameters(), *model.buffers()]
    groups = list(optimizer.param_groups)
    sharded = getattr(optimizer, "sharded_state", None)
    if sharded is not None:
        inner = sharded.inner
    else:
        inner = optimizer
        while isinstance(inner, _DistributedOptimizer):
            inner = inner.optimizer
    for g in groups + list(inner.param_groups):
        out += [v for k, v in sorted(g.items(), key=lambda kv: kv[0])
                if k != "params" and isinstance(v, torch.Tensor)]
    for g in inner.param_groups:
        for p in g["params"]:
            out.append(p)
            st = inner.state.get(p, {})
            out += [st[k] for k in sorted(st)
                    if isinstance(st[k], torch.Tensor)]
    return out


def _check_capturable(k: int, optimizer, op, sparse_params,
                      reduction) -> None:
    """``steps_per_call > 1``'s refusals (class docstring), made when the
    step is built."""
    from horovod_tpu_torch.runtime import distributed as hvd_dist

    if sparse_params or getattr(optimizer, "_sparse", None):
        raise ValueError(
            f"steps_per_call={k} captures the step as a CUDA graph, and "
            f"the row-sparse exchange (sparse_params) reads each "
            f"gradient's row count on the host, which a graph cannot "
            f"replay: use steps_per_call=1")
    if op == ReduceOp.ADASUM or reduction == "adasum" or isinstance(
            optimizer, _DistributedAdasumOptimizer) or getattr(
            optimizer, "reduction", None) == "adasum":
        raise ValueError(
            f"steps_per_call={k} captures the step as a CUDA graph, and "
            f"Adasum's combine reads its coefficients on the host, which "
            f"a graph cannot replay: use steps_per_call=1")
    sharded = getattr(optimizer, "sharded_state", None)
    if sharded is not None and sharded.residuals is not None:
        raise ValueError(
            f"steps_per_call={k} captures the step as a CUDA graph, and "
            f"the sharded exchange's error feedback replaces its residual "
            f"tensors at every step, which a replay would not see: use "
            f"steps_per_call=1")
    if getattr(optimizer, "backward_passes_per_step", 1) > 1:
        raise ValueError(
            f"steps_per_call={k} with backward_passes_per_step="
            f"{optimizer.backward_passes_per_step}: the optimizer counts "
            f"its backward passes on the host, and a replayed step would "
            f"not advance the count; accumulate in loss_fn instead, or use "
            f"steps_per_call=1")
    if hvd_dist.collective_deadline_s() is not None:
        raise ValueError(
            f"steps_per_call={k} in an elastic world on a card: the "
            f"exchange's host waits for it on a CUDA event (so that a dead "
            f"peer raises within the world's timeout), which a capturing "
            f"stream forbids; use steps_per_call=1")
    inner = optimizer
    while isinstance(inner, _DistributedOptimizer):
        inner = inner.optimizer
    if state.global_state().device.type == "cuda" and any(
            g.get("capturable") is False for g in inner.param_groups):
        raise ValueError(
            f"steps_per_call={k} captures the step as a CUDA graph on the "
            f"card, and {type(inner).__name__} keeps its step count on the "
            f"host unless it is built with capturable=True (e.g. "
            f"torch.optim.AdamW(params, lr, capturable=True)); the step "
            f"does not change the flag for you")


def _broadcast_model(model: torch.nn.Module,
                     mesh: Optional[ParallelMesh]) -> None:
    """Rank 0's parameters and buffers on every rank; a tensor-parallel
    shard (of a module already sharded) from the first rank of the ranks
    that hold the same shard, those of its tp coordinate."""
    import torch.distributed as dist

    shards = set()
    for m in tp_modules(model):
        if m.tp > 1:
            shards.add(id(m.weight))
            if isinstance(m, ColumnParallelDense) and m.bias is not None:
                shards.add(id(m.bias))
    if not shards:
        F.broadcast_variables(model, root_rank=0)
        return
    rest = [t for t in list(model.parameters()) + list(model.buffers())
            if id(t) not in shards]
    F.broadcast_variables(rest, root_rank=0)
    group = mesh.group(tuple(a for a in AXIS_ORDER if a != "tp"))
    if group is None:
        return
    root = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for p in model.parameters():
            if id(p) in shards:
                dist.broadcast(p.data, src=root, group=group)


def _default_mode(plan, optimizer, op, compression, shard_optimizer_states,
                  sparse_params) -> str:
    """``mode=None``'s resolution: ``"shard_map"`` for what the JAX step
    runs only there, ``"pjit"`` otherwise."""
    wrapped = isinstance(optimizer, (_ShardedDistributedOptimizer,
                                     _DistributedAdasumOptimizer)) or (
        isinstance(optimizer, _DistributedOptimizer) and (
            optimizer.op != Average or optimizer.compression is not None
            or optimizer._sparse))
    if shard_optimizer_states or op != Average or compression is not None \
            or sparse_params or wrapped or (plan is not None and
                                            plan.sp > 1):
        return "shard_map"
    return "pjit"


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
    if mesh is not None and not plan.matches_mesh(mesh):
        raise ValueError(
            f"plan {plan.to_string()} does not match the "
            f"given mesh {dict(mesh.shape)}: pass one "
            f"source of truth (the plan builds its own "
            f"mesh when mesh=None)")
    if plan.pp > 1:
        raise ValueError(
            f"plan {plan.to_string()} has pp>1: pipeline "
            "parallelism runs through parallel.pipeline "
            "(gpipe / interleaved_1f1b inside shard_map), not "
            "the train step — the step compiles "
            "dp/fsdp/tp/ep/sp plans")
    if mesh is None:
        mesh = plan.build_mesh()
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
