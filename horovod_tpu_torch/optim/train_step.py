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
from horovod_tpu_torch.runtime import config, state

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
                 fsdp_min_weight_size: Optional[int] = None):
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
        self._loss_fn = loss_fn
        self.optimizer = optimizer
        self._hierarchy = optimizer.exchange_hierarchy if isinstance(
            optimizer, _ShardedDistributedOptimizer) else hierarchy

    @property
    def mode(self) -> str:
        """``"pjit"`` or ``"shard_map"``, as resolved (class docstring)."""
        return self._mode

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

    def __call__(self, model: torch.nn.Module, optimizer, batch):
        if self._wrap is not None:
            raise RuntimeError("the step wraps the optimizer in init(model) "
                               "(sparse_params names the parameters; fsdp "
                               "and tp cut them first): call init(model) "
                               "first and step with the optimizer it "
                               "returns")
        self._apply_moe_schedule(model)
        optimizer.zero_grad(set_to_none=True)
        loss = self._loss_fn(model, batch)
        loss.backward()
        optimizer.step()
        return model, optimizer, C.allreduce(loss.detach(), op=Average,
                                             group=self._scope)


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
