"""Data-parallel training step of the PyTorch port
(``horovod_tpu/optim/train_step.py`` ``DistributedTrainStep``).

::

    step = DistributedTrainStep(loss_fn, torch.optim.AdamW(model.parameters(), 3e-4))
    model, opt = step.init(model)
    model, opt, loss = step(model, opt, step.shard_batch(batch))

One call is the JAX step's shard_map body: value and gradient of
``loss_fn`` on this rank's shard, the bucketed gradient exchange, the
optimizer update, and the loss averaged across ranks.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from horovod_tpu_torch import functions as F
from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.ops.collectives import Average, ReduceOp
from horovod_tpu_torch.optim.optimizer import (
    DistributedOptimizer,
    _DistributedOptimizer,
)
from horovod_tpu_torch.runtime import state


class DistributedTrainStep:
    """``loss_fn(model, batch) -> scalar`` must be the *mean* loss over its
    batch shard.  ``optimizer`` is a ``torch.optim.Optimizer`` over the
    model's parameters, wrapped here in :func:`DistributedOptimizer` with
    ``op`` and ``compression``, or an optimizer that
    :func:`DistributedOptimizer` already wrapped (then ``op`` and
    ``compression`` must stay at their defaults)."""

    def __init__(self, loss_fn: Callable, optimizer,
                 op: ReduceOp = Average, compression=None):
        if isinstance(optimizer, _DistributedOptimizer):
            if op != Average or compression is not None:
                raise ValueError("op/compression belong to the "
                                 "DistributedOptimizer already given")
        else:
            optimizer = DistributedOptimizer(optimizer, op=op,
                                             compression=compression)
        self._loss_fn = loss_fn
        self.optimizer = optimizer

    def init(self, model: torch.nn.Module):
        """Broadcast rank 0's parameters and optimizer state to every
        rank; returns ``(model, optimizer)``."""
        F.broadcast_variables(model, root_rank=0)
        F.broadcast_optimizer_state(self.optimizer.optimizer, root_rank=0)
        return model, self.optimizer

    def shard_batch(self, batch):
        """This rank's rows of the *global* batch (identical on every
        rank), on the runtime's device.  Accepts a tensor, a numpy array,
        or a dict of them; the leading dim must divide by the world size."""
        st = state.global_state()

        def shard(x):
            x = torch.as_tensor(np.asarray(x)) if isinstance(x, np.ndarray) \
                else x
            if x.shape[0] % st.size:
                raise ValueError(f"batch dim {x.shape[0]} does not divide "
                                 f"by the world size {st.size}")
            n = x.shape[0] // st.size
            return x[st.rank * n:(st.rank + 1) * n].to(st.device,
                                                      non_blocking=True)

        if isinstance(batch, dict):
            return {k: shard(v) for k, v in batch.items()}
        return shard(batch)

    def __call__(self, model: torch.nn.Module, optimizer, batch):
        optimizer.zero_grad(set_to_none=True)
        loss = self._loss_fn(model, batch)
        loss.backward()
        optimizer.step()
        return model, optimizer, C.allreduce(loss.detach(), op=Average)
