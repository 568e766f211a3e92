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
1/N flat shard only, allgather.  :class:`DistributedGradientTape` reduces
what a gradient function returns through the eager plane.
"""

from __future__ import annotations

import dataclasses
import inspect
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function
from torch.utils._pytree import tree_flatten, tree_unflatten

from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.ops.bucketing import plan_buckets
from horovod_tpu_torch.ops.collectives import Average, ReduceOp
from horovod_tpu_torch.ops.fused_collectives import resolve_fused_collectives
from horovod_tpu_torch.runtime import state
from horovod_tpu_torch.runtime.topology import TOPOLOGY_MODES, \
    resolve_topology


def _fusion_threshold() -> int:
    return state.global_state().config.fusion_threshold_bytes


@torch.no_grad()
def distributed_gradients(grads: Sequence[torch.Tensor],
                          op: ReduceOp = Average,
                          compression=None,
                          prescale_factor: Optional[float] = None,
                          postscale_factor: Optional[float] = None,
                          bucket_bytes: Optional[int] = None) -> None:
    """Reduce ``grads`` across ranks in place, one fused collective per
    bucket (and dtype).  ``bucket_bytes`` defaults to the runtime's fusion
    threshold (64 MiB).  ``Compression.int8`` sends float buckets through
    the shared-scale quantized wire, one scale per gradient."""
    grads = list(grads)
    if bucket_bytes is None:
        bucket_bytes = _fusion_threshold()
    nbytes = [g.numel() * g.element_size() for g in grads]
    for bucket in plan_buckets(nbytes, bucket_bytes):
        ins = [grads[i] for i in bucket]
        outs = C.grouped_allreduce(ins, op=op,
                                   prescale_factor=prescale_factor,
                                   postscale_factor=postscale_factor,
                                   compression=compression)
        for g, r in zip(ins, outs):
            g.copy_(r)


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
    the wrapped optimizer's."""

    def __init__(self, optimizer: torch.optim.Optimizer, op: ReduceOp,
                 compression, backward_passes_per_step: int,
                 prescale_factor: Optional[float],
                 postscale_factor: Optional[float], overlap: bool = True):
        self.optimizer = optimizer
        self.op = op
        self.compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        self.prescale_factor = prescale_factor
        self.postscale_factor = postscale_factor
        self._passes = 0
        self._accum: Dict[int, torch.Tensor] = {}
        self._trainable = [p for g in optimizer.param_groups
                           for p in g["params"] if p.requires_grad]
        self._bucket_bytes = _fusion_threshold()
        self._buckets: List[List[int]] = []
        self._stream = None
        #: (parameter indices, "hook" or "synchronize") of each bucket the
        #: current or last backward launched, in launch order
        self.launches: List[Tuple[List[int], str]] = []
        if overlap:
            self._buckets = plan_buckets(
                [p.numel() * p.element_size() for p in self._trainable],
                self._bucket_bytes)
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
    def _launch(self, ids: List[int], source: str) -> None:
        """Reduce the gradients of parameters ``ids`` as one bucket of
        :func:`distributed_gradients`, into their ``.grad``."""
        self.launches.append((list(ids), source))
        grads = [self._trainable[i].grad for i in ids]
        if not grads[0].is_cuda:
            self._reduce(grads)
            return
        side = self._side_stream(grads[0].device)
        side.wait_stream(torch.cuda.current_stream(grads[0].device))
        with torch.cuda.stream(side):
            for g in grads:
                g.record_stream(side)
            self._reduce(grads)

    def _reduce(self, grads: List[torch.Tensor]) -> None:
        outs = C.grouped_allreduce(grads, op=self.op,
                                   prescale_factor=self.prescale_factor,
                                   postscale_factor=self.postscale_factor,
                                   compression=self.compression)
        for g, r in zip(grads, outs):
            g.copy_(r)

    def synchronize(self) -> None:
        """Launch the buckets no hook launched, over the gradients present
        and planned as :func:`distributed_gradients` plans them, and order
        the current stream after the exchange (reference
        ``optimizer.synchronize``).  Once a step; ``step()`` then skips
        it."""
        if self._synced:
            return
        if not self._open:
            self._begin_round()
        rest = [i for ids in self._buckets[self._next:] for i in ids
                if self._trainable[i].grad is not None]
        nbytes = [self._trainable[i].grad.numel() *
                  self._trainable[i].grad.element_size() for i in rest]
        for bucket in plan_buckets(nbytes, self._bucket_bytes,
                                   reverse=False):
            self._launch([rest[j] for j in bucket], "synchronize")
        self._next = len(self._buckets)
        if self._stream is not None:
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

    def step(self, closure=None):
        if not self._micro_step():
            self._close_round()
            return None
        self.synchronize()
        self._close_round()
        return self.optimizer.step(closure)


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


class _ShardedDistributedOptimizer(_DistributedOptimizer):
    """``step()`` = the sharded exchange with the update in the middle
    (JAX ``sharded_distributed_update``, flat topology):

    1. reduce-scatter the gradients in reverse-layer-order buckets
       (:func:`~horovod_tpu_torch.ops.collectives.grouped_reducescatter`;
       ``Compression.int8`` quantizes the wire, error feedback keeps its
       residual);
    2. copy this rank's slice of the parameters into its shard tensors
       (:func:`~horovod_tpu_torch.ops.collectives.local_fusion_shards`),
       so a broadcast or restore between steps is seen, and set their
       ``.grad`` to the reduced shards;
    3. step the user's optimizer class, rebuilt over the shards, with the
       user optimizer's current hyperparameters;
    4. all-gather the new shards and copy them into the parameters.

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
                 error_feedback: bool):
        super().__init__(optimizer, op, compression,
                         backward_passes_per_step, prescale_factor,
                         postscale_factor, overlap=False)
        self.quantized_bits = getattr(compression, "wire_reduce_bits", None)
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

    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        if not self._micro_step():
            return loss
        self._exchange_and_update()
        return loss

    @torch.no_grad()
    def _exchange_and_update(self) -> None:
        st = self.sharded_state
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._trainable]
        out = C.grouped_reducescatter(
            grads, op=self.op, prescale_factor=self.prescale_factor,
            postscale_factor=self.postscale_factor,
            quantized_bits=self.quantized_bits, spec=self.spec,
            residuals=st.residuals)
        if st.residuals is not None:
            st.residuals = out[2]
        del grads
        C.local_fusion_shards(self._trainable, self.spec, out=st.shards)
        for key, shard in st.shards.items():
            shard.grad = out[0][key]
        del out
        inner_group = st.inner.param_groups[0]
        inner_group.update(_hyperparameters(self.optimizer))
        with record_function("hvd.shard_update"):
            st.inner.step()
        for shard in st.shards.values():
            shard.grad = None
        for p, full in zip(self._trainable,
                           C.grouped_allgather(st.shards, self.spec)):
            p.copy_(full)


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
                         reduction: Optional[str] = None):
    """Wrap ``optimizer`` so each ``step()`` uses cross-rank-reduced
    gradients (reference ``DistributedOptimizer``, ``torch/optimizer.py``),
    exchanged bucket by bucket from gradient hooks while backward runs
    (:class:`_DistributedOptimizer`).

    ``gradient_predivide_factor`` splits the averaging around the sum:
    gradients scale by ``1/f`` before it and ``f/size`` after (reference
    ``torch/optimizer.py:119-123``).  ``backward_passes_per_step=N`` makes
    ``step()`` a no-op for N-1 calls, accumulating each call's gradients,
    and on the Nth reduce their mean and update, as optax ``MultiSteps``
    does in the JAX package.  ``named_parameters`` is accepted for the
    reference's signature.  ``Compression.int8`` quantizes the wire
    (shared-scale int8, or fp8 e4m3 under ``HOROVOD_EXCHANGE_WIRE_DTYPE``).

    ``shard_optimizer_states=True`` replaces allreduce-then-update with the
    ZeRO-style exchange (:class:`_ShardedDistributedOptimizer`): the same
    parameters within dtype tolerance, 1/N optimizer state and update work
    per rank.  With it: ``exchange_bucket_bytes`` splits the exchange into
    reverse-layer-order buckets (None: one); ``hierarchy`` selects the
    topology, of which only flat is ported (``"auto"`` resolves to it on a
    one-level world; a two-level or tree exchange raises
    ``NotImplementedError``); ``fused_collectives`` is checked and has no
    effect: JAX tiles the last bucket's reduce-scatter so that XLA overlaps
    each tile's wire with the update, and eager collectives run one after
    another, so tiles would only add launches; ``error_feedback=True``
    (needs ``Compression.int8``) carries the wire's rounding residual;
    ``reduction="adasum"`` is, on the flat topology, the plain sum, bit
    for bit, as in JAX.  The wrapped optimizer must be elementwise, with
    one set of hyperparameters over its param groups.
    """
    del named_parameters
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
    if fused_collectives != "auto" and not shard_optimizer_states:
        raise ValueError(
            "fused_collectives schedules the sharded exchange's final "
            "bucket; pass shard_optimizer_states=True to enable it")
    if reduction not in (None, "sum") and not shard_optimizer_states:
        raise ValueError(
            "reduction selects the sharded exchange's combine operator; "
            "pass shard_optimizer_states=True to enable it")
    qbits = getattr(compression, "wire_reduce_bits", None)
    if shard_optimizer_states:
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
        # adasum combines the outermost level's partial sums; the flat
        # topology has one level, so both operators are the plain sum
        C._resolve_reduction(reduction)
        resolve_fused_collectives(fused_collectives)
        st = state.global_state()
        resolve_topology(hierarchy, (st.cross_size, st.local_size))
        return _ShardedDistributedOptimizer(
            optimizer, op, compression, backward_passes_per_step,
            prescale_factor, postscale_factor, exchange_bucket_bytes,
            error_feedback)
    return _DistributedOptimizer(optimizer, op, compression,
                                 backward_passes_per_step, prescale_factor,
                                 postscale_factor)


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
