"""Distributed optimizer of the PyTorch port (``horovod_tpu/optim/optimizer.py``).

:func:`distributed_gradients` is the gradient exchange: gradients are
packed into byte-capped fusion buckets in reverse-layer order
(:func:`~horovod_tpu_torch.ops.bucketing.plan_buckets`, capped at
``HOROVOD_FUSION_THRESHOLD``), and each bucket is reduced by
:func:`~horovod_tpu_torch.ops.collectives.grouped_allreduce`, whose
pre/postscale passes are ``fused_scale`` kernel launches.
:func:`DistributedOptimizer` wraps a ``torch.optim.Optimizer`` so that
gradient hooks launch each bucket of that exchange while backward runs
and ``step()`` updates once they are reduced
(:class:`_DistributedOptimizer`), or, with
``shard_optimizer_states=True``, runs the ZeRO-style sharded exchange in
``step()`` (:class:`_ShardedDistributedOptimizer`, JAX
``sharded_distributed_update``): reduce-scatter, the update on this rank's
1/N flat shard only, allgather.  :func:`DistributedAdasumOptimizer` is
Adasum's delta form: the local step, then the weight deltas
Adasum-reduced (:func:`adasum_updates`).  ``sparse_params`` routes
embedding-style gradients through the row-sparse exchange
(:func:`_sparse_leaf_reduce`).  :class:`DistributedGradientTape` reduces
what a gradient function returns through the eager plane.

Each wrapper also has ``guarded_step(limit)``, the update under the
numerics guard (``DistributedTrainStep(guard=)``): the global gradient
norm is read on the host before the update, and the update runs only when
the norm is finite and within ``limit`` (:func:`guard_ok`).
"""

from __future__ import annotations

import dataclasses
import inspect
import logging
import math
import os
import weakref
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch.profiler import record_function
from torch.utils._pytree import tree_flatten, tree_unflatten

from horovod_tpu_torch.exceptions import HorovodInternalError
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.ops.bucketing import plan_buckets
from horovod_tpu_torch.ops.collectives import Adasum, Average, ReduceOp, Sum
from horovod_tpu_torch.ops.fused_collectives import resolve_fused_collectives
from horovod_tpu_torch.runtime import distributed as hvd_dist
from horovod_tpu_torch.runtime import state
from horovod_tpu_torch.runtime.distributed import raise_internal
from horovod_tpu_torch.runtime.topology import LAYOUT_AXES, \
    TOPOLOGY_MODES, TreeLayout, parse_level_codecs, resolve_topology


_log = logging.getLogger(__name__)


def _fusion_threshold() -> int:
    return state.global_state().config.fusion_threshold_bytes


def grad_sumsq(grads: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """fp32 sum of squares over every tensor of ``grads`` (None skipped):
    the global-norm reduction of the guarded step (JAX ``_sumsq``), each
    tensor's fp32 2-norm from one multi-tensor pass, then the sum of their
    squares.  A 0-d tensor on the runtime's device when there is none."""
    grads = [g for g in grads if g is not None]
    if not grads:
        return torch.zeros((), dtype=torch.float32,
                           device=state.global_state().device)
    norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
    return torch.stack(norms).square().sum()


def params_sumsq(params: Sequence[torch.Tensor]) -> torch.Tensor:
    """:func:`grad_sumsq` over the ``.grad`` of ``params``."""
    return grad_sumsq([p.grad for p in params])


def world_gnorm(params: Sequence[torch.Tensor], sumsq=None) -> float:
    """The guarded norm where JAX takes it before the reduction (the
    sharded exchange, the delta form): the root of the world's sum of each
    rank's ``sumsq(params)`` (default :func:`params_sumsq`), one scalar
    all-reduce."""
    return float(C.allreduce((sumsq or params_sumsq)(params), op=Sum).sqrt())


def guard_ok(gnorm: float, limit: float) -> bool:
    """The guarded step's predicate (JAX ``isfinite(gnorm) & (gnorm <=
    limit)``): the update runs only when it holds."""
    return math.isfinite(gnorm) and gnorm <= limit


def _sparse_leaf_reduce(g: torch.Tensor, max_rows: int, op: ReduceOp,
                        prescale_factor: Optional[float] = None,
                        postscale_factor: Optional[float] = None
                        ) -> torch.Tensor:
    """Row-sparse reduction of one dense-shaped gradient (JAX
    ``_sparse_leaf_reduce``): the rows of ``g`` with a nonzero entry are
    taken with the static bound ``max_rows`` and exchanged through
    :func:`~horovod_tpu_torch.ops.collectives.sparse_allreduce`, an
    all-gather of ``max_rows`` rows a rank instead of an allreduce of the
    whole table (the reference's IndexedSlices path,
    ``tensorflow/__init__.py:100-110``).

    As ``jnp.nonzero(size=max_rows, fill_value=rows)`` does, the first
    ``max_rows`` touched rows are kept, the slots left over carry index
    ``rows`` and value 0 (the scatter drops them), and touched rows past
    the bound are dropped: the bound is the caller's promise.  With
    ``HOROVOD_DEBUG_SPARSE`` set, a warning is logged when rows are
    dropped.  The slots are filled by a cumulative sum of the row mask and
    a scatter, with no host sync (the warning's count reads the card)."""
    rows = g.shape[0]
    mask = (g.reshape(rows, -1) != 0).any(dim=1)
    if os.environ.get("HOROVOD_DEBUG_SPARSE"):
        touched = int(mask.sum())
        if touched > max_rows:
            _log.warning("sparse_params: %d touched rows exceed max_rows=%d;"
                         " excess gradients dropped", touched, max_rows)
    slot = torch.cumsum(mask, 0) - 1
    keep = mask & (slot < max_rows)
    # rows not kept land on a spare slot past the bound
    idx = torch.full((max_rows + 1,), rows, dtype=torch.long,
                     device=g.device)
    idx.scatter_(0, torch.where(keep, slot, max_rows),
                 torch.arange(rows, device=g.device))
    idx = idx[:max_rows]
    filled = (idx < rows).view((max_rows,) + (1,) * (g.dim() - 1))
    vals = torch.where(filled, g.index_select(0, idx.clamp(max=rows - 1)),
                       torch.zeros((), dtype=g.dtype, device=g.device))
    vals = C._scale(vals, prescale_factor)
    return C._scale(C.sparse_allreduce(vals, idx, rows, op=op),
                    postscale_factor)


def _match_sparse(name: str, sparse_params: Optional[Mapping]
                  ) -> Optional[int]:
    """``max_rows`` for the parameter ``name`` (a ``named_parameters``
    name, components split on ``.``) when one of its components equals a
    pattern, or its full name does, written with ``.`` or ``/``; else None
    (JAX ``_match_sparse``).  Whole components only: ``"emb"`` never
    routes ``"member"`` through the truncating sparse path."""
    if not sparse_params:
        return None
    comps = name.split(".")
    for pat, max_rows in sparse_params.items():
        if pat.replace("/", ".") == name or pat in comps:
            return int(max_rows)
    return None


def _check_sparse(sparse_params, op: ReduceOp) -> None:
    if sparse_params and op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError("sparse_params supports op=Sum/Average")


@torch.no_grad()
def distributed_gradients(grads: Union[Sequence[torch.Tensor],
                                       Mapping[str, torch.Tensor]],
                          op: ReduceOp = Average,
                          compression=None,
                          prescale_factor: Optional[float] = None,
                          postscale_factor: Optional[float] = None,
                          bucket_bytes: Optional[int] = None,
                          sparse_params: Optional[Mapping] = None,
                          group=None) -> None:
    """Reduce ``grads`` across ranks in place, one fused collective per
    bucket (and dtype).  ``bucket_bytes`` defaults to the runtime's fusion
    threshold (64 MiB).  ``Compression.int8`` sends float buckets through
    the shared-scale quantized wire, one scale per gradient.  ``group`` is
    the exchange's scope (JAX's ``axis``): None for the world, a process
    group, or :data:`~horovod_tpu_torch.ops.collectives.ALONE`.

    ``sparse_params`` (``{name: max_rows}``, op Sum or Average) needs
    ``grads`` as a mapping from parameter names to gradients: the ones
    :func:`_match_sparse` matches leave the buckets and are reduced
    row-sparse (:func:`_sparse_leaf_reduce`), in order, after them."""
    _check_sparse(sparse_params, op)
    names = list(grads) if isinstance(grads, Mapping) else None
    grads = list(grads.values()) if names is not None else list(grads)
    sparse: Dict[int, int] = {}
    if sparse_params:
        if names is None:
            raise ValueError("sparse_params matches parameter names: pass "
                             "grads as a mapping from names to gradients")
        for i, name in enumerate(names):
            m = _match_sparse(name, sparse_params)
            if m is not None:
                sparse[i] = m
    if sparse and not C.is_world(group):
        raise ValueError("sparse_params reduces over the world; pass "
                         "group=None")
    if bucket_bytes is None:
        bucket_bytes = _fusion_threshold()
    dense = [i for i in range(len(grads)) if i not in sparse]
    nbytes = [grads[i].numel() * grads[i].element_size() for i in dense]
    for bucket in plan_buckets(nbytes, bucket_bytes):
        ins = [grads[dense[j]] for j in bucket]
        outs = C.grouped_allreduce(ins, op=op,
                                   prescale_factor=prescale_factor,
                                   postscale_factor=postscale_factor,
                                   compression=compression, group=group)
        for g, r in zip(ins, outs):
            g.copy_(r)
    for i, max_rows in sparse.items():
        grads[i].copy_(_sparse_leaf_reduce(grads[i], max_rows, op,
                                           prescale_factor, postscale_factor))


#: reference ``torch/optimizer.py`` text for a second backward before step()
_SECOND_BACKWARD = (
    "Gradients were computed more than backward_passes_per_step times "
    "before call to step(). Increase backward_passes_per_step to "
    "accumulate gradients locally.")


def _exchange_hook(owner: "weakref.ref", i: int):
    """Parameter ``i``'s post-accumulate-grad hook: hands the finished
    gradient to the wrapper that registered it, while that wrapper lives
    and is the parameter's newest (a parameter wrapped again is exchanged
    once, by the newer wrapper)."""
    def hook(p: torch.Tensor) -> None:
        opt = owner()
        if opt is not None and getattr(p, "_hvd_exchange", None) == id(opt):
            opt._on_grad(i, p)
    return hook


class _DistributedOptimizer:
    """The replicated exchange, overlapped with backward (reference
    ``torch/optimizer.py:103-200``; the JAX package's default mode lets
    XLA overlap its in-graph bucket collectives with backward).

    At wrap time the trainable parameters (``requires_grad``) are planned
    into :func:`plan_buckets`' buckets, reverse registration order capped
    at ``HOROVOD_FUSION_THRESHOLD``, and each gets a post-accumulate-grad
    hook.  A hook counts its gradient into its bucket; when the bucket's
    last gradient lands, that bucket and every complete bucket after it
    launch in plan order (bucket k only after bucket k-1, so every rank
    issues its collectives in the same order whatever order the hooks
    fire in): on a card, on a side stream that first waits for the stream
    that produced the gradients, the bucket's pack, prescale, NCCL
    all-reduce, postscale and unpack into ``.grad``.  :meth:`synchronize`
    launches the rest, replanned over the gradients present, and makes the
    current stream wait for the side stream; :meth:`step` calls it unless
    it already ran for this step.  The result is
    :func:`distributed_gradients` over the gradients present, bit for bit:
    the buckets launched from hooks are that plan's first buckets, and the
    rest are planned as it plans them.  A parameter without a gradient
    keeps ``.grad = None``; one frozen at wrap time is left out.

    ``backward_passes_per_step = N > 1``: the hooks of the first N-1
    passes add each gradient into a running sum and launch nothing; the
    N-th pass's hooks install the mean (optax ``MultiSteps``'
    accumulation) and launch.  A gradient that reaches ``step()`` without
    its hook (assigned by hand) is folded in there the same way.

    A launch that fails raises from the hook, and so from backward; it
    never falls back to a step-time exchange.  Every other attribute is
    the wrapped optimizer's.

    ``sparse`` maps the indices of the parameters that ``sparse_params``
    matched to their ``max_rows``: they stay out of the buckets, and
    :meth:`synchronize` launches each, in order, after the buckets, as a
    row-sparse exchange (:func:`_sparse_leaf_reduce`) on the same
    stream.

    ``axis`` is the exchange's scope (:attr:`axis`: None for the world, a
    process group, or ``ALONE``); ``scopes`` gives some parameters, by
    index, a scope of their own (the FSDP-placed shards, which backward
    has averaged over the fsdp group already, take the rest of the data
    axes).  A bucket holds the parameters of one scope: each bucket of the
    plan is split by scope, in order."""

    def __init__(self, optimizer: torch.optim.Optimizer, op: ReduceOp,
                 compression, backward_passes_per_step: int,
                 prescale_factor: Optional[float],
                 postscale_factor: Optional[float], overlap: bool = True,
                 sparse: Optional[Dict[int, int]] = None, axis=None,
                 scopes: Optional[Dict[int, object]] = None):
        self.optimizer = optimizer
        self.op = op
        self.compression = compression
        self.axis = axis
        self._world = state.world_id()
        self._scopes = dict(scopes or {})
        self.backward_passes_per_step = backward_passes_per_step
        self.prescale_factor = prescale_factor
        self.postscale_factor = postscale_factor
        self._passes = 0
        self._accum: Dict[int, torch.Tensor] = {}
        self._trainable = [p for g in optimizer.param_groups
                           for p in g["params"] if p.requires_grad]
        self._sparse = dict(sparse or {})
        self._bucket_bytes = _fusion_threshold()
        self._buckets: List[List[int]] = []
        self._stream = None
        #: (parameter indices, "hook" or "synchronize") of each bucket the
        #: current or last backward launched, in launch order
        self.launches: List[Tuple[List[int], str]] = []
        if overlap:
            dense = [i for i in range(len(self._trainable))
                     if i not in self._sparse]
            self._buckets = self._by_scope(
                [[dense[j] for j in b] for b in plan_buckets(
                    [self._trainable[i].numel() *
                     self._trainable[i].element_size() for i in dense],
                    self._bucket_bytes)])
            owner = weakref.ref(self)
            for i, p in enumerate(self._trainable):
                p._hvd_exchange = id(self)
                p.register_post_accumulate_grad_hook(_exchange_hook(owner, i))
        self._bucket_of = [0] * len(self._trainable)
        for b, ids in enumerate(self._buckets):
            for i in ids:
                self._bucket_of[i] = b
        self._open = False
        self._reset_round()

    def __getattr__(self, name):
        if name == "optimizer":        # not set yet (e.g. mid-unpickle)
            raise AttributeError(name)
        return getattr(self.optimizer, name)

    def _scope(self, i: int):
        """The scope parameter ``i``'s gradient is reduced over."""
        return self._scopes.get(i, self.axis)

    def _by_scope(self, buckets: List[List[int]]) -> List[List[int]]:
        """Each bucket split into one bucket a scope, in first-seen
        order."""
        if not self._scopes:
            return buckets
        out = []
        for ids in buckets:
            parts: Dict[int, List[int]] = {}
            for i in ids:
                parts.setdefault(id(self._scope(i)), []).append(i)
            out.extend(parts.values())
        return out

    # -- one backward pass's exchange ---------------------------------------

    def _reset_round(self) -> None:
        self._left = [len(b) for b in self._buckets]
        self._fired = [False] * len(self._trainable)
        self._next = 0
        self._synced = False

    def _begin_round(self) -> None:
        self._open = True
        self.launches = []

    def _close_round(self) -> None:
        """End this backward's exchange; work launched that no
        synchronize() waited for is ordered before what follows."""
        if self._open and not self._synced and self._stream is not None:
            torch.cuda.current_stream(self._stream.device).wait_stream(
                self._stream)
        self._open = False
        self._reset_round()

    def _on_grad(self, i: int, p: torch.Tensor) -> None:
        if not self._open:
            self._begin_round()
        if self._fired[i]:
            raise RuntimeError(_SECOND_BACKWARD)
        self._fired[i] = True
        if self.backward_passes_per_step > 1:
            final = self._passes == self.backward_passes_per_step - 1
            self._accumulate_grad(i, p, final)
            if not final:
                return
        if i in self._sparse:
            return
        b = self._bucket_of[i]
        self._left[b] -= 1
        if self._left[b] == 0:
            while self._next < len(self._buckets) and \
                    self._left[self._next] == 0:
                self._launch(self._buckets[self._next], "hook")
                self._next += 1

    @torch.no_grad()
    def _accumulate_grad(self, i: int, p: torch.Tensor, final: bool) -> None:
        """Add parameter ``i``'s gradient into its running sum; on the
        step's last pass install the mean in ``.grad``."""
        acc = self._accum.get(i)
        if acc is None:
            acc = self._accum[i] = p.grad.clone()
        else:
            acc.add_(p.grad)
        if final:
            p.grad.copy_(acc.div_(self.backward_passes_per_step))
            del self._accum[i]

    def _side_stream(self, device: torch.device):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    @torch.no_grad()
    @raise_internal("the gradient exchange")
    def _launch(self, ids: List[int], source: str) -> None:
        """Reduce the gradients of parameters ``ids`` as one bucket of
        :func:`distributed_gradients`, into their ``.grad``."""
        self._world = state.check_world(self._world,
                                        "this DistributedOptimizer")
        self.launches.append((list(ids), source))
        grads = [self._trainable[i].grad for i in ids]
        if not grads[0].is_cuda:
            self._reduce(ids, grads)
            return
        side = self._side_stream(grads[0].device)
        side.wait_stream(torch.cuda.current_stream(grads[0].device))
        with torch.cuda.stream(side):
            for g in grads:
                g.record_stream(side)
            self._reduce(ids, grads)

    def _reduce(self, ids: List[int], grads: List[torch.Tensor]) -> None:
        if ids[0] in self._sparse:
            grads[0].copy_(_sparse_leaf_reduce(
                grads[0], self._sparse[ids[0]], self.op,
                self.prescale_factor, self.postscale_factor))
            return
        outs = C.grouped_allreduce(grads, op=self.op,
                                   prescale_factor=self.prescale_factor,
                                   postscale_factor=self.postscale_factor,
                                   compression=self.compression,
                                   group=self._scope(ids[0]))
        for g, r in zip(grads, outs):
            g.copy_(r)

    @raise_internal("the gradient exchange")
    def synchronize(self) -> None:
        """Launch the buckets no hook launched, over the gradients present
        and planned as :func:`distributed_gradients` plans them, and order
        the current stream after the exchange (reference
        ``optimizer.synchronize``).  Once a step; ``step()`` then skips
        it."""
        self._world = state.check_world(self._world,
                                        "this DistributedOptimizer")
        if self._synced:
            return
        if not self._open:
            self._begin_round()
        rest = [i for ids in self._buckets[self._next:] for i in ids
                if self._trainable[i].grad is not None]
        nbytes = [self._trainable[i].grad.numel() *
                  self._trainable[i].grad.element_size() for i in rest]
        for ids in self._by_scope([
                [rest[j] for j in bucket] for bucket in
                plan_buckets(nbytes, self._bucket_bytes, reverse=False)]):
            self._launch(ids, "synchronize")
        for i in self._sparse:
            if self._trainable[i].grad is not None:
                self._launch([i], "synchronize")
        self._next = len(self._buckets)
        if self._stream is not None:
            deadline = hvd_dist.collective_deadline_s()
            if deadline is not None:
                # an elastic world: the host waits for the exchange, so
                # that a dead peer raises here within the group's timeout,
                # before anything queued behind it reads a result
                done = torch.cuda.Event()
                done.record(self._stream)
                hvd_dist.await_event(done, "the gradient exchange",
                                     deadline)
            torch.cuda.current_stream(self._stream.device).wait_stream(
                self._stream)
        self._synced = True

    def _micro_step(self) -> bool:
        """``backward_passes_per_step > 1``: fold the gradients no hook saw
        into the running sums; True on the pass that completes a step."""
        if self.backward_passes_per_step == 1:
            return True
        final = self._passes == self.backward_passes_per_step - 1
        for i, p in enumerate(self._trainable):
            if p.grad is not None and not self._fired[i]:
                self._accumulate_grad(i, p, final)
        self._passes = 0 if final else self._passes + 1
        return final

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Close this backward's exchange (a backward that no ``step()``
        consumed), then the wrapped optimizer's ``zero_grad``."""
        self._close_round()
        self.optimizer.zero_grad(set_to_none=set_to_none)

    @raise_internal("the optimizer step")
    def step(self, closure=None):
        if not self._micro_step():
            self._close_round()
            return None
        self.synchronize()
        self._close_round()
        return self.optimizer.step(closure)

    @raise_internal("the optimizer step")
    def guarded_step(self, limit: float, sumsq=None) -> Optional[float]:
        """:meth:`step` under the numerics guard: once the exchange has
        finished, the global norm of the reduced gradients
        (``sumsq(params)`` of the trainable parameters, default
        :func:`params_sumsq`) is read on the host, and the wrapped
        optimizer steps only when :func:`guard_ok` holds; otherwise
        nothing of its state moves.  Returns the norm, or None on a pass
        that only accumulates."""
        if not self._micro_step():
            self._close_round()
            return None
        self.synchronize()
        self._close_round()
        gnorm = float((sumsq or params_sumsq)(self._trainable).sqrt())
        if guard_ok(gnorm, limit):
            self.optimizer.step()
        return gnorm


@dataclasses.dataclass
class ShardedOptimizerState:
    """State of the sharded exchange (JAX ``ShardedOptimizerState``):
    ``inner`` is the user's optimizer class built again over ``shards``,
    this rank's flat slice of each parameter group buffer (one tensor per
    :class:`~horovod_tpu_torch.ops.collectives.ShardGroup`), so its state
    is 1/N of the replicated footprint.  ``residuals`` (error feedback
    only, else None) holds the quantized wire's rounding residual of each
    float group, fp32 at the group's full padded length."""

    inner: torch.optim.Optimizer
    shards: Dict[str, torch.Tensor]
    residuals: Optional[Dict[str, torch.Tensor]] = None


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) \
            and a.shape == b.shape and bool(torch.equal(a, b))
    return a == b


def _hyperparameters(optimizer: torch.optim.Optimizer) -> dict:
    """The hyperparameters every param group shares; ``ValueError`` if
    they differ (the sharded update applies one rule to the whole flat
    shard, as JAX applies one transform)."""
    groups = optimizer.param_groups
    hyper = {k: v for k, v in groups[0].items() if k != "params"}
    for g in groups[1:]:
        other = {k: v for k, v in g.items() if k != "params"}
        if other.keys() != hyper.keys() or \
                not all(_same(v, other[k]) for k, v in hyper.items()):
            raise ValueError(
                "shard_optimizer_states applies one update rule to the "
                "flat shard; the optimizer's param groups have different "
                "hyperparameters")
    return hyper


def _rebuild(optimizer: torch.optim.Optimizer,
             params: List[torch.Tensor]) -> torch.optim.Optimizer:
    """``type(optimizer)`` over ``params`` with ``optimizer``'s defaults
    and shared group hyperparameters."""
    accepted = inspect.signature(type(optimizer).__init__).parameters
    kwargs = {k: v for k, v in optimizer.defaults.items() if k in accepted}
    return type(optimizer)([dict(_hyperparameters(optimizer),
                                 params=params)], **kwargs)


def sharded_exchange_levels(hierarchy: str = "auto",
                            layout: Optional[TreeLayout] = None,
                            quantized_bits: Optional[int] = None,
                            level_codecs: Optional[
                                Dict[str, Optional[int]]] = None,
                            error_feedback: bool = False
                            ) -> Tuple[str, Optional[Tuple]]:
    """The sharded exchange's topology, resolved as JAX's ``update_fn``
    resolves it over its mesh axes: ``(mode, levels)``, the mode
    ``"flat"``, ``"two_level"`` or ``"tree"`` and the
    :class:`~horovod_tpu_torch.ops.collectives.ExchangeLevel` s innermost
    first (None when flat).  The axes are the world's ``(cross, local)``
    layout, or ``layout``'s.  Two levels take JAX's two-level branch (the
    codec on the outer hop, and under error feedback on the inner one);
    a tree its levels of extent > 1 with their codecs (``level_codecs``
    by level name, ``quantized_bits`` on the outermost), error feedback
    turning on the innermost one.  The levels' groups are made here, so
    every rank must call it together."""
    st = state.global_state()
    if layout is None:
        sizes, names = (st.cross_size, st.local_size), LAYOUT_AXES
    else:
        layout.check_world(st.size)
        sizes, names = layout.shape, layout.names
    tree = resolve_topology(hierarchy, sizes, axis_names=names,
                            wire_bits=quantized_bits,
                            level_codecs=level_codecs)
    if tree.mode == "flat":
        return tree.mode, None
    if tree.mode == "two_level":
        inner, outer = C.exchange_levels_from_topology(tree, layout)
        return tree.mode, (
            C.ExchangeLevel(inner.group, inner.extent,
                            quantized_bits if error_feedback else None),
            C.ExchangeLevel(outer.group, outer.extent, quantized_bits))
    levels = list(C.exchange_levels_from_topology(tree.effective(), layout))
    if error_feedback and levels[0].quantized_bits is None:
        levels[0] = C.ExchangeLevel(levels[0].group, levels[0].extent,
                                    quantized_bits)
    return tree.mode, tuple(levels)


class _ShardedDistributedOptimizer(_DistributedOptimizer):
    """``step()`` = the sharded exchange with the update in the middle
    (JAX ``sharded_distributed_update``):

    1. reduce-scatter the gradients in reverse-layer-order buckets:
       flat (:func:`~horovod_tpu_torch.ops.collectives.grouped_reducescatter`)
       or, on a world of several nodes of several ranks, two-level
       (:func:`~horovod_tpu_torch.ops.collectives.tree_reducescatter`
       within the node, then across the nodes), or level by level over a
       ``TreeLayout``'s axes; ``Compression.int8``
       quantizes the wire, error feedback keeps its residual;
    2. copy this rank's slice of the parameters (the block it owns,
       :attr:`shard_index`) into its shard tensors
       (:func:`~horovod_tpu_torch.ops.collectives.local_fusion_shards`),
       so a broadcast or restore between steps is seen, and set their
       ``.grad`` to the reduced shards;
    3. step the user's optimizer class, rebuilt over the shards, with the
       user optimizer's current hyperparameters;
    4. all-gather the new shards and copy them into the parameters.

    The topology is resolved once, here, from the world's ``(cross,
    local)`` extents, or from the extents and names of a ``layout``
    (``runtime/topology.TreeLayout``), with
    ``runtime/topology.resolve_topology``, as JAX's ``update_fn`` resolves
    it at trace time over its mesh axes: ``"flat"``, ``"two_level"`` or,
    over three or more axes, ``"tree"`` (:attr:`exchange_hierarchy`; a
    ``"tree"`` over two axes is the two-level one, as in JAX).  The
    two-level exchange puts the codec on the outer hop, and under error
    feedback on the inner hop too, where the residual pins it (JAX's
    ``quantize_inner``); as in JAX, ``level_codecs`` is checked against
    the levels' names and places codecs only on a tree of three or more
    levels.  The tree runs its levels of extent > 1, innermost first, the
    codec on the outermost hop and on any level ``level_codecs`` names,
    and error feedback turns on the innermost one; the rank owns block
    :func:`~horovod_tpu_torch.ops.collectives.tree_shard_index` of each
    buffer (:attr:`shard_index`).  ``reduction="adasum"`` combines over
    the outermost level with Adasum and is the plain sum on a flat
    topology.  The levels' process groups are made here, on every rank
    alike.

    Equal to allreduce-then-update for elementwise optimizers (SGD,
    momentum, Adam/AdamW, RMSProp): element i's update reads only element
    i's history.  The padded tail of each shard stays zero.

    The exchange covers the parameters that require a gradient when the
    wrapper is built: a frozen one (``requires_grad=False``) is left out,
    so it stays as it is, as torch.optim leaves it.  A trainable parameter
    with no gradient at a step takes a zero one, as every leaf of the
    parameter tree has a gradient in JAX; weight decay and momentum then
    still move it, where the replicated path would skip it."""

    def __init__(self, optimizer, op, compression, backward_passes_per_step,
                 prescale_factor, postscale_factor, bucket_bytes,
                 error_feedback: bool, hierarchy: str = "auto",
                 level_codecs: Optional[Dict[str, Optional[int]]] = None,
                 reduction: str = "sum",
                 layout: Optional[TreeLayout] = None):
        super().__init__(optimizer, op, compression,
                         backward_passes_per_step, prescale_factor,
                         postscale_factor, overlap=False)
        self.quantized_bits = getattr(compression, "wire_reduce_bits", None)
        self.reduction = reduction
        #: the exchange this wrapper runs ("flat", "two_level" or "tree")
        #: and its levels, innermost first (None when flat)
        self.exchange_hierarchy, self.levels = sharded_exchange_levels(
            hierarchy, layout, self.quantized_bits, level_codecs,
            error_feedback)
        self.shard_index = state.global_state().rank \
            if self.levels is None else C.tree_shard_index(self.levels)
        if not self._trainable:
            raise ValueError("shard_optimizer_states needs a parameter "
                             "that requires a gradient")
        if not all(p.is_floating_point() for p in self._trainable):
            raise ValueError("shard_optimizer_states needs floating "
                             "parameters")
        self.spec = C.make_fusion_spec(self._trainable,
                                       state.global_state().size,
                                       bucket_bytes)
        shards = {}
        for g in self.spec.groups:
            first = self._trainable[g.indices[0]]
            shards[g.key] = torch.zeros(g.shard, dtype=first.dtype,
                                        device=first.device)
        residuals = None
        if error_feedback:
            residuals = {g.key: torch.zeros(g.padded, dtype=torch.float32,
                                            device=shards[g.key].device)
                         for g in self.spec.groups}
        self.sharded_state = ShardedOptimizerState(
            inner=_rebuild(optimizer, list(shards.values())),
            shards=shards, residuals=residuals)

    def synchronize(self) -> None:
        raise ValueError("the sharded exchange reduces the gradients inside "
                         "step(), together with the update")

    def state_dict(self) -> dict:
        """This rank's shard state: the inner optimizer's and the
        residuals, for a restore at the same world size and rank
        (:meth:`sharded_state_dict` is the tree that
        ``Checkpointer.save_sharded`` reshards across world sizes)."""
        return {"inner": self.sharded_state.inner.state_dict(),
                "residuals": self.sharded_state.residuals}

    def load_state_dict(self, sd: dict) -> None:
        self.sharded_state.inner.load_state_dict(sd["inner"])
        if sd.get("residuals") is not None:
            for k, r in sd["residuals"].items():
                self.sharded_state.residuals[k].copy_(r)

    def sharded_state_dict(self) -> dict:
        """This rank's shard of the optimizer state as the tree that
        ``Checkpointer.save_sharded`` writes: ``{"state": {group key:
        {name: tensor}}}``, the inner optimizer's state of each shard keyed
        like :attr:`ShardedOptimizerState.shards` (1-D leaves of the
        group's shard length; scalars such as AdamW's ``step``), and with
        error feedback ``{"residuals": {group key: tensor}}``, each rank's
        own full-length residual.  The tensors are the live state, not
        copies."""
        st = self.sharded_state
        out = {"state": {key: dict(st.inner.state[shard])
                         for key, shard in st.shards.items()
                         if shard in st.inner.state}}
        if st.residuals is not None:
            out["residuals"] = dict(st.residuals)
        return out

    def sharded_state_template(self) -> dict:
        """:meth:`sharded_state_dict`'s structure with every 1-D leaf sized
        by this rank's fusion spec: the restore target of
        ``Checkpointer.restore_sharded`` at this world size.  A torch
        optimizer creates its state at its first step, so before that the
        names and shapes come from one step of the optimizer class, rebuilt
        over meta tensors of the shards' shapes (no memory, no values).
        The group keys and their order come from the leaves' sizes and the
        bucket cap alone, never from the world size."""
        st = self.sharded_state
        if all(shard in st.inner.state for shard in st.shards.values()):
            return self.sharded_state_dict()
        metas = [torch.zeros(s.shape, dtype=s.dtype, device="meta",
                             requires_grad=True)
                 for s in st.shards.values()]
        group = dict(_hyperparameters(self.optimizer), params=metas)
        for k in ("foreach", "fused", "capturable", "differentiable"):
            if k in group:
                group[k] = False
        probe = type(self.optimizer)([group])
        for m in metas:
            m.grad = torch.zeros_like(m)
        with torch.no_grad():
            probe.step()
        out = {"state": {key: dict(probe.state[m])
                         for key, m in zip(st.shards, metas)}}
        if st.residuals is not None:
            out["residuals"] = dict(st.residuals)
        return out

    def load_sharded_state_dict(self, tree: dict) -> None:
        """Load a :meth:`sharded_state_dict` tree (such as
        ``Checkpointer.restore_sharded`` returns) into this rank's shard
        state; values move to the shards' device and dtype."""
        st = self.sharded_state
        if ("residuals" in tree) != (st.residuals is not None):
            raise ValueError(
                "the sharded state and this optimizer disagree on error "
                "feedback residuals")
        sd = st.inner.state_dict()
        sd["state"] = {i: tree["state"][key]
                       for i, key in enumerate(st.shards)
                       if key in tree["state"]}
        st.inner.load_state_dict(sd)
        for key, r in tree.get("residuals", {}).items():
            st.residuals[key].copy_(r)

    @raise_internal("the optimizer step")
    def step(self, closure=None):
        self._world = state.check_world(self._world,
                                        "this DistributedOptimizer")
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        if not self._micro_step():
            return loss
        self._exchange_and_update()
        return loss

    @raise_internal("the optimizer step")
    def guarded_step(self, limit: float, sumsq=None) -> Optional[float]:
        """:meth:`step` under the numerics guard, with JAX's norm for the
        sharded exchange (:func:`world_gnorm` of the gradients before the
        reduction).  When :func:`guard_ok` fails, neither the
        reduce-scatter, the update nor the allgather runs, so the
        error-feedback residuals stay as they were too.  Returns the norm,
        or None on a pass that only accumulates."""
        self._world = state.check_world(self._world,
                                        "this DistributedOptimizer")
        if not self._micro_step():
            return None
        gnorm = world_gnorm(self._trainable, sumsq)
        if guard_ok(gnorm, limit):
            self._exchange_and_update()
        return gnorm

    @torch.no_grad()
    def _exchange_and_update(self) -> None:
        st = self.sharded_state
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._trainable]
        if self.levels is None:
            out = C.grouped_reducescatter(
                grads, op=self.op, prescale_factor=self.prescale_factor,
                postscale_factor=self.postscale_factor,
                quantized_bits=self.quantized_bits, spec=self.spec,
                residuals=st.residuals)
        else:
            out = C.tree_reducescatter(
                grads, self.levels, op=self.op,
                prescale_factor=self.prescale_factor,
                postscale_factor=self.postscale_factor, spec=self.spec,
                residuals=st.residuals, reduction=self.reduction)
        # an elastic world on a card: a dead peer raises here, before the
        # update reads a shard the reduce-scatter never wrote
        hvd_dist.await_stream(grads[0].device,
                              "the sharded exchange's reduce-scatter")
        if st.residuals is not None:
            st.residuals = out[2]
        del grads
        C.local_fusion_shards(self._trainable, self.spec, out=st.shards,
                              index=self.shard_index)
        for key, shard in st.shards.items():
            shard.grad = out[0][key]
        del out
        inner_group = st.inner.param_groups[0]
        inner_group.update(_hyperparameters(self.optimizer))
        with record_function("hvd.shard_update"):
            st.inner.step()
        for shard in st.shards.values():
            shard.grad = None
        full = C.grouped_allgather(st.shards, self.spec) \
            if self.levels is None else \
            C.tree_allgather(st.shards, self.spec, self.levels)
        hvd_dist.await_stream(full[0].device,
                              "the sharded exchange's all-gather")
        for p, leaf in zip(self._trainable, full):
            p.copy_(leaf)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         op: ReduceOp = Average,
                         compression=None,
                         backward_passes_per_step: int = 1,
                         prescale_factor: Optional[float] = None,
                         postscale_factor: Optional[float] = None,
                         gradient_predivide_factor: float = 1.0,
                         shard_optimizer_states: bool = False,
                         exchange_bucket_bytes: Optional[int] = None,
                         hierarchy: str = "auto",
                         fused_collectives: str = "auto",
                         error_feedback: bool = False,
                         reduction: Optional[str] = None,
                         sparse_params: Optional[Mapping] = None,
                         level_codecs: Optional[
                             Dict[str, Optional[int]]] = None,
                         axis=None):
    """Wrap ``optimizer`` so each ``step()`` uses cross-rank-reduced
    gradients (reference ``DistributedOptimizer``, ``torch/optimizer.py``),
    exchanged bucket by bucket from gradient hooks while backward runs
    (:class:`_DistributedOptimizer`).

    ``axis`` is the exchange's scope (JAX's ``axis``): the world (None),
    or a process group, such as a mesh's data group
    (``mesh.scope(plan.data_axes)``, which is
    :data:`~horovod_tpu_torch.ops.collectives.ALONE` when the group is
    this rank alone).  It reaches the hook-fired and step-time exchanges,
    and Average and the pre/postscale passes divide by its size.  The
    sharded, Adasum, quantized and row-sparse forms take the world only
    (JAX runs them under ``shard_map``, whose scope is the data axes of a
    plan without tp) and raise otherwise.  With
    ``shard_optimizer_states=True``, ``axis`` may also be a
    :class:`~horovod_tpu_torch.runtime.topology.TreeLayout`, the world
    laid out over named axes (JAX's N-axis mesh as the sharded exchange's
    ``axis``): ``hierarchy`` then resolves over its axes, so a layout of
    three or more axes of extent > 1 runs the N-level tree.

    ``gradient_predivide_factor`` splits the averaging around the sum:
    gradients scale by ``1/f`` before it and ``f/size`` after (reference
    ``torch/optimizer.py:119-123``).  ``backward_passes_per_step=N`` makes
    ``step()`` a no-op for N-1 calls, accumulating each call's gradients,
    and on the Nth reduce their mean and update, as optax ``MultiSteps``
    does in the JAX package.  ``named_parameters`` names the parameters
    for ``sparse_params``.  ``Compression.int8`` quantizes the wire
    (shared-scale int8, or fp8 e4m3 under ``HOROVOD_EXCHANGE_WIRE_DTYPE``).

    ``shard_optimizer_states=True`` replaces allreduce-then-update with the
    ZeRO-style exchange (:class:`_ShardedDistributedOptimizer`): the same
    parameters within dtype tolerance, 1/N optimizer state and update work
    per rank.  With it: ``exchange_bucket_bytes`` splits the exchange into
    reverse-layer-order buckets (None: one); ``hierarchy`` selects the
    topology over the world's ``(cross, local)`` layout: ``"auto"`` runs
    the two-level exchange (within each node, then across the nodes)
    when both extents exceed 1 and the flat one otherwise,
    ``"flat"``/``"two_level"``/``"tree"`` force one (a tree over the two
    layout levels is the two-level exchange), and under the two-level one
    the rank at ``(cross c, local l)`` owns block ``l·C + c`` of each
    buffer; ``level_codecs`` (``{level name: wire bits or None}``, unset:
    ``HOROVOD_EXCHANGE_LEVEL_CODECS``) is checked against the tree's
    level names, as in JAX (see :class:`_ShardedDistributedOptimizer`);
    ``fused_collectives`` is checked and has no effect: JAX tiles the last
    bucket's reduce-scatter so that XLA overlaps each tile's wire with the
    update, and eager collectives run one after another, so tiles would
    only add launches; ``error_feedback=True`` (needs
    ``Compression.int8``) carries the wire's rounding residual;
    ``reduction="adasum"`` combines the nodes' partial sums with Adasum on
    the two-level exchange's cross hop (whole-bucket coefficients, the
    ``1/world`` of Average left out, as in JAX) and is, on a flat
    topology, the plain sum, bit for bit.  The wrapped optimizer must be
    elementwise, with one set of hyperparameters over its param groups.

    ``op=Adasum`` reduces each bucket by Adasum over the world's layout
    (``ops/adasum.py``), each gradient with its own coefficients, so the
    bucket plan does not change the result.  That is Adasum on raw
    gradients, right for plain SGD; a stateful optimizer takes
    :func:`DistributedAdasumOptimizer`.

    ``sparse_params`` (``{pattern: max_rows}``, op Sum or Average, not with
    ``shard_optimizer_states``) takes the parameters whose
    ``named_parameters`` name matches a pattern (:func:`_match_sparse`)
    out of the buckets and reduces their gradients row-sparse, at most
    ``max_rows`` nonzero rows a rank (:func:`_sparse_leaf_reduce`): an
    embedding table's gradient touches only the rows of the batch's
    tokens.  It needs ``named_parameters``.
    """
    if backward_passes_per_step < 1:
        raise ValueError("backward_passes_per_step must be >= 1")
    if exchange_bucket_bytes is not None and not shard_optimizer_states:
        raise ValueError(
            "exchange_bucket_bytes buckets the sharded exchange; pass "
            "shard_optimizer_states=True to enable it")
    if hierarchy != "auto" and not shard_optimizer_states:
        raise ValueError(
            "hierarchy selects the sharded exchange topology; pass "
            "shard_optimizer_states=True to enable it")
    if level_codecs is not None and not shard_optimizer_states:
        raise ValueError(
            "level_codecs places wire codecs on the sharded exchange's "
            "tree levels; pass shard_optimizer_states=True to enable it")
    if fused_collectives != "auto" and not shard_optimizer_states:
        raise ValueError(
            "fused_collectives schedules the sharded exchange's final "
            "bucket; pass shard_optimizer_states=True to enable it")
    if reduction not in (None, "sum") and not shard_optimizer_states:
        raise ValueError(
            "reduction selects the sharded exchange's combine operator; "
            "pass shard_optimizer_states=True to enable it")
    qbits = getattr(compression, "wire_reduce_bits", None)
    layout = axis if isinstance(axis, TreeLayout) else None
    if layout is not None and not shard_optimizer_states:
        raise ValueError(
            "a TreeLayout axis lays out the sharded exchange's tree; pass "
            "shard_optimizer_states=True to enable it")
    if layout is None and not C.is_world(axis):
        scoped = [name for name, on in (
            ("shard_optimizer_states", shard_optimizer_states),
            ("op=Adasum", op == Adasum), ("a quantized wire", qbits),
            ("sparse_params", bool(sparse_params))) if on]
        if scoped:
            raise ValueError(
                f"{', '.join(scoped)} reduce(s) over the world; an exchange "
                f"scoped to a process group (axis=) takes the replicated "
                f"form with op=Sum/Average")
    if shard_optimizer_states:
        if sparse_params:
            raise ValueError(
                "shard_optimizer_states is incompatible with sparse_params: "
                "sparse leaves bypass the fused flat buffer the shard "
                "slicing is defined over")
        if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
            raise ValueError(
                "shard_optimizer_states supports op=Sum/Average")
        if compression is not None and qbits is None:
            raise ValueError(
                "shard_optimizer_states supports only wire-reduction "
                "compression (Compression.int8); compressor-style codecs "
                "would decompress before the shard slicing")
    if error_feedback and not shard_optimizer_states:
        raise ValueError(
            "error_feedback carries the sharded exchange's quantization "
            "residual; pass shard_optimizer_states=True to enable it")
    if gradient_predivide_factor != 1.0:
        if op != Average:
            raise ValueError("gradient_predivide_factor requires op=Average")
        if prescale_factor is not None or postscale_factor is not None:
            raise ValueError(
                "pass either gradient_predivide_factor or explicit "
                "prescale/postscale factors, not both")
        prescale_factor = 1.0 / gradient_predivide_factor
        postscale_factor = gradient_predivide_factor
    if shard_optimizer_states:
        if hierarchy not in TOPOLOGY_MODES:
            raise ValueError(f"hierarchy must be one of {TOPOLOGY_MODES}, "
                             f"got {hierarchy!r}")
        if error_feedback and qbits is None:
            raise ValueError(
                "error_feedback compensates the quantized wire's rounding; "
                "pass a wire-reduction compression (Compression.int8) to "
                "enable it")
        resolve_fused_collectives(fused_collectives)
        if level_codecs is None:
            level_codecs = parse_level_codecs(
                state.global_state().config.exchange_level_codecs)
        return _ShardedDistributedOptimizer(
            optimizer, op, compression, backward_passes_per_step,
            prescale_factor, postscale_factor, exchange_bucket_bytes,
            error_feedback, hierarchy, level_codecs,
            C._resolve_reduction(reduction), layout)
    _check_sparse(sparse_params, op)
    return _DistributedOptimizer(
        optimizer, op, compression, backward_passes_per_step,
        prescale_factor, postscale_factor,
        sparse=_sparse_indices(optimizer, named_parameters, sparse_params),
        axis=axis)


def _sparse_indices(optimizer: torch.optim.Optimizer, named_parameters,
                    sparse_params: Optional[Mapping]) -> Dict[int, int]:
    """``{index among the trainable parameters: max_rows}`` of those whose
    name ``sparse_params`` matches."""
    if not sparse_params:
        return {}
    if named_parameters is None:
        raise ValueError("sparse_params matches parameter names: pass "
                         "named_parameters (model.named_parameters())")
    names = {id(p): name for name, p in named_parameters}
    trainable = [p for g in optimizer.param_groups for p in g["params"]
                 if p.requires_grad]
    out = {}
    for i, p in enumerate(trainable):
        m = _match_sparse(names.get(id(p), ""), sparse_params)
        if m is not None:
            out[i] = m
    return out


@torch.no_grad()
def adasum_updates(deltas: Sequence[torch.Tensor], compression=None,
                   bucket_bytes: Optional[int] = None) -> None:
    """Adasum-reduce weight deltas in place (JAX ``adasum_updates``), the
    core of :func:`DistributedAdasumOptimizer`: :func:`distributed_gradients`
    with ``op=Adasum``, in :func:`plan_buckets` buckets of ``bucket_bytes``
    (the fusion threshold by default), each delta with its own
    coefficients.  On a world of one without a compression it is the
    identity and moves nothing, as JAX returns the tensors at extent 1."""
    if state.global_state().size == 1 and compression is None:
        return
    distributed_gradients(list(deltas), op=Adasum, compression=compression,
                          bucket_bytes=bucket_bytes)


class _DistributedAdasumOptimizer:
    """Adasum in its delta form (reference ``_DistributedAdasumOptimizer``,
    ``torch/optimizer.py:210-380``; JAX ``DistributedAdasumOptimizer``,
    ``chain(optimizer, adasum_updates)``).  ``step()``:

    1. copy the trainable parameters into one persistent stash
       (``torch._foreach_copy_``);
    2. run the wrapped optimizer's step on this rank's local gradients;
    3. turn each parameter into its delta, ``p - start``, in place;
    4. Adasum-reduce the deltas (:func:`adasum_updates`);
    5. add the stash back, ``p = start + delta``.

    Gradients are never exchanged, and the optimizer's state (momenta,
    moments) evolves from local gradients, so it is per rank: a checkpoint
    saves rank 0's and a restore broadcasts it, the reference's rank-0
    convention.  ``backward_passes_per_step = k`` is optax ``MultiSteps``:
    ``step()`` adds each pass's gradients into a running sum and returns
    with the parameters unmoved, and on the k-th pass installs their mean
    and runs one local step and one Adasum.  Every other attribute is the
    wrapped optimizer's."""

    def __init__(self, optimizer: torch.optim.Optimizer, compression,
                 backward_passes_per_step: int):
        self.optimizer = optimizer
        self.compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        self._world = state.world_id()
        self._params = [p for g in optimizer.param_groups
                        for p in g["params"] if p.requires_grad]
        self._bucket_bytes = _fusion_threshold()
        self._start: Optional[List[torch.Tensor]] = None
        self._passes = 0
        self._accum: Dict[int, torch.Tensor] = {}

    def __getattr__(self, name):
        if name == "optimizer":        # not set yet (e.g. mid-unpickle)
            raise AttributeError(name)
        return getattr(self.optimizer, name)

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def _micro_step(self) -> bool:
        """Fold this pass's gradients into the running sums; on the pass
        that completes a step install their mean and return True."""
        k = self.backward_passes_per_step
        if k == 1:
            return True
        for i, p in enumerate(self._params):
            if p.grad is not None:
                acc = self._accum.get(i)
                if acc is None:
                    self._accum[i] = p.grad.clone()
                else:
                    acc.add_(p.grad)
        final = self._passes == k - 1
        self._passes = 0 if final else self._passes + 1
        if final:
            for i, acc in self._accum.items():
                p = self._params[i]
                if p.grad is None:
                    p.grad = acc.div_(k)
                else:
                    p.grad.copy_(acc.div_(k))
            self._accum = {}
        return final

    @raise_internal("the optimizer step")
    def step(self, closure=None):
        self._world = state.check_world(self._world,
                                        "this DistributedAdasumOptimizer")
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        if self._micro_step():
            self._delta_step()
        return loss

    @raise_internal("the optimizer step")
    def guarded_step(self, limit: float, sumsq=None) -> Optional[float]:
        """:meth:`step` under the numerics guard, with JAX's ``op=None``
        norm (:func:`world_gnorm` of the local gradients); when
        :func:`guard_ok` fails the whole delta step (local update and
        Adasum) is skipped.  Returns the norm, or None on a pass that only
        accumulates."""
        self._world = state.check_world(self._world,
                                        "this DistributedAdasumOptimizer")
        if not self._micro_step():
            return None
        gnorm = world_gnorm(self._params, sumsq)
        if guard_ok(gnorm, limit):
            self._delta_step()
        return gnorm

    @torch.no_grad()
    def _delta_step(self) -> None:
        params = self._params
        if self._start is None:
            self._start = [torch.empty_like(p) for p in params]
        torch._foreach_copy_(self._start, params)
        self.optimizer.step()
        torch._foreach_sub_(params, self._start)
        adasum_updates(params, compression=self.compression,
                       bucket_bytes=self._bucket_bytes)
        try:
            hvd_dist.await_stream(params[0].device, "the Adasum exchange")
        except HorovodInternalError:
            # the parameters hold their deltas: put the step's start back
            torch._foreach_copy_(params, self._start)
            raise
        torch._foreach_add_(params, self._start)


def DistributedAdasumOptimizer(optimizer: torch.optim.Optimizer,
                               named_parameters=None, compression=None,
                               backward_passes_per_step: int = 1):
    """Wrap ``optimizer`` in Adasum's delta form
    (:class:`_DistributedAdasumOptimizer`): the local step first, then the
    weight delta, not the gradient, Adasum-reduced over the world's layout
    (the average within a node, Adasum across nodes).  ``op=Adasum`` on
    raw gradients (:func:`DistributedOptimizer`) is only right for plain
    SGD; this form is right for momentum and Adam too.  Its gradients
    stay local, so ``DistributedTrainStep`` takes it with ``op=None``.
    ``named_parameters`` is accepted for the reference's signature;
    ``compression`` (``Compression.fp16``/``bf16``) is the deltas' wire
    dtype."""
    del named_parameters
    if backward_passes_per_step < 1:
        raise ValueError("backward_passes_per_step must be >= 1")
    if getattr(compression, "wire_reduce_bits", None) is not None:
        raise ValueError("quantized_bits supports op=Sum/Average")
    return _DistributedAdasumOptimizer(optimizer, compression,
                                       backward_passes_per_step)


class DistributedGradientTape:
    """Eager-style gradient wrapper (reference ``DistributedGradientTape``,
    ``tensorflow/__init__.py:508-572``; JAX ``optim/optimizer.py:742``).
    ``grad_fn`` returns gradients (a tensor, or a list, tuple or dict of
    them); ``gradient`` submits each through ``allreduce_async``, so the
    Bucketer fuses them, and returns them reduced, in the same
    structure::

        tape = hvd.DistributedGradientTape(grad_fn)
        grads = tape.gradient(params, batch)
    """

    def __init__(self, grad_fn, op: ReduceOp = Average, compression=None,
                 prescale_factor: Optional[float] = None,
                 postscale_factor: Optional[float] = None):
        self._grad_fn = grad_fn
        self._op = op
        self._compression = compression
        self._prescale = prescale_factor
        self._postscale = postscale_factor

    def __call__(self, *args, **kwargs):
        return self.gradient(*args, **kwargs)

    def gradient(self, *args, **kwargs):
        from horovod_tpu_torch.ops import eager

        leaves, spec = tree_flatten(self._grad_fn(*args, **kwargs))
        handles = [eager.allreduce_async(
            g, op=self._op, compression=self._compression,
            prescale_factor=self._prescale,
            postscale_factor=self._postscale) for g in leaves]
        return tree_unflatten([eager.synchronize(h) for h in handles], spec)
