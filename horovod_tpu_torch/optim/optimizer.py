"""Distributed optimizer of the PyTorch port (``horovod_tpu/optim/optimizer.py``).

:func:`distributed_gradients` is the gradient exchange: gradients are
packed into byte-capped fusion buckets in reverse-layer order
(:func:`~horovod_tpu_torch.ops.bucketing.plan_buckets`, capped at
``HOROVOD_FUSION_THRESHOLD``), and each bucket is reduced by
:func:`~horovod_tpu_torch.ops.collectives.grouped_allreduce`, whose
pre/postscale passes are ``fused_scale`` kernel launches.
:func:`DistributedOptimizer` wraps a ``torch.optim.Optimizer`` so that
``step()`` exchanges the gradients before the update.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.ops.bucketing import plan_buckets
from horovod_tpu_torch.ops.collectives import Average, ReduceOp
from horovod_tpu_torch.runtime import state


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
    threshold (64 MiB)."""
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


class _DistributedOptimizer:
    """``step()`` = exchange the gradients, then the wrapped optimizer's
    step.  Every other attribute is the wrapped optimizer's."""

    def __init__(self, optimizer: torch.optim.Optimizer, op: ReduceOp,
                 compression, backward_passes_per_step: int,
                 prescale_factor: Optional[float],
                 postscale_factor: Optional[float]):
        self.optimizer = optimizer
        self.op = op
        self.compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        self.prescale_factor = prescale_factor
        self.postscale_factor = postscale_factor
        self._passes = 0
        self._accum: Optional[List[torch.Tensor]] = None

    def __getattr__(self, name):
        if name == "optimizer":        # not set yet (e.g. mid-unpickle)
            raise AttributeError(name)
        return getattr(self.optimizer, name)

    def _params(self) -> List[torch.Tensor]:
        return [p for group in self.optimizer.param_groups
                for p in group["params"] if p.grad is not None]

    @torch.no_grad()
    def _accumulate(self, params) -> bool:
        """backward_passes_per_step > 1: keep the running sum of each
        micro-step's gradients; on the last one install their mean (optax
        ``MultiSteps``' accumulation) and report that the step is due."""
        grads = [p.grad for p in params]
        if self._accum is None:
            self._accum = [g.clone() for g in grads]
        else:
            for a, g in zip(self._accum, grads):
                a.add_(g)
        self._passes += 1
        if self._passes < self.backward_passes_per_step:
            return False
        for p, a in zip(params, self._accum):
            p.grad.copy_(a.div_(self.backward_passes_per_step))
        self._passes, self._accum = 0, None
        return True

    def synchronize(self) -> None:
        """Exchange the gradients now (reference ``optimizer.synchronize``)."""
        distributed_gradients([p.grad for p in self._params()], op=self.op,
                              compression=self.compression,
                              prescale_factor=self.prescale_factor,
                              postscale_factor=self.postscale_factor)

    def step(self, closure=None):
        if self.backward_passes_per_step > 1 and \
                not self._accumulate(self._params()):
            return None
        self.synchronize()
        return self.optimizer.step(closure)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         op: ReduceOp = Average,
                         compression=None,
                         backward_passes_per_step: int = 1,
                         prescale_factor: Optional[float] = None,
                         postscale_factor: Optional[float] = None,
                         gradient_predivide_factor: float = 1.0):
    """Wrap ``optimizer`` so each ``step()`` uses cross-rank-reduced
    gradients (reference ``DistributedOptimizer``, ``torch/optimizer.py``).

    ``gradient_predivide_factor`` splits the averaging around the sum:
    gradients scale by ``1/f`` before it and ``f/size`` after (reference
    ``torch/optimizer.py:119-123``).  ``backward_passes_per_step=N`` makes
    ``step()`` a no-op for N-1 calls, accumulating each call's gradients,
    and on the Nth reduce their mean and update, as optax ``MultiSteps``
    does in the JAX package.  ``named_parameters`` is accepted for the
    reference's signature.
    """
    del named_parameters
    if backward_passes_per_step < 1:
        raise ValueError("backward_passes_per_step must be >= 1")
    if gradient_predivide_factor != 1.0:
        if op != Average:
            raise ValueError("gradient_predivide_factor requires op=Average")
        if prescale_factor is not None or postscale_factor is not None:
            raise ValueError(
                "pass either gradient_predivide_factor or explicit "
                "prescale/postscale factors, not both")
        prescale_factor = 1.0 / gradient_predivide_factor
        postscale_factor = gradient_predivide_factor
    return _DistributedOptimizer(optimizer, op, compression,
                                 backward_passes_per_step, prescale_factor,
                                 postscale_factor)
