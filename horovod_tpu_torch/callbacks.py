"""Training-loop callbacks (a copy of ``horovod_tpu/callbacks.py``, the
Keras-layer parity surface).

Reference: ``horovod/_keras/callbacks.py`` —
``BroadcastGlobalVariablesCallback``, ``MetricAverageCallback``,
``LearningRateWarmupCallback``, ``LearningRateScheduleCallback``
(:22-187) — and ``horovod/_keras/elastic.py`` (``CommitStateCallback``,
``UpdateBatchStateCallback``, ``UpdateEpochStateCallback``).

No Keras Model owns the loop, so callbacks operate on a duck-typed
``loop`` object (anything with ``model``/``optimizer`` attributes, e.g. a
small dataclass around ``DistributedTrainStep``) and a ``logs`` dict.
Learning-rate control, two ways:

* :func:`warmup_schedule`, a function of the step (the JAX package's
  optax schedule), for ``torch.optim.lr_scheduler.LambdaLR`` or a loop
  that sets the rate itself;
* the callback classes, which set ``lr`` in every one of
  ``loop.optimizer.param_groups`` between steps (the JAX package sets
  an ``optax.inject_hyperparams`` rate).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

import horovod_tpu_torch.functions as F
from horovod_tpu_torch.ops import eager


def warmup_schedule(base_lr: float, warmup_epochs: int,
                    steps_per_epoch: int, size: Optional[int] = None,
                    initial_lr_scale: Optional[float] = None
                    ) -> Callable[[int], float]:
    """Gradual LR warmup for large-batch scaling (reference
    ``LearningRateWarmupCallback``; Goyal et al. 2017): ramp from
    ``base_lr`` (single-worker LR) to ``base_lr * size`` over
    ``warmup_epochs``.  Returns ``f(step) -> lr``, the values of the JAX
    package's ``optax.linear_schedule``."""
    import horovod_tpu_torch as hvd

    size = size if size is not None else hvd.size()
    init = base_lr * (initial_lr_scale if initial_lr_scale is not None
                      else 1.0)
    end = base_lr * size
    steps = max(warmup_epochs * steps_per_epoch, 1)

    def schedule(step: int) -> float:
        frac = min(max(float(step), 0.0) / steps, 1.0)
        return init + (end - init) * frac

    return schedule


class Callback:
    """Minimal lifecycle protocol (Keras callback shape)."""

    def on_train_begin(self, loop, logs: Optional[Dict] = None): ...
    def on_epoch_begin(self, epoch: int, loop, logs: Optional[Dict] = None): ...
    def on_batch_begin(self, batch: int, loop, logs: Optional[Dict] = None): ...
    def on_batch_end(self, batch: int, loop, logs: Optional[Dict] = None): ...
    def on_epoch_end(self, epoch: int, loop, logs: Optional[Dict] = None): ...
    def on_train_end(self, loop, logs: Optional[Dict] = None): ...


class CallbackList:
    def __init__(self, callbacks: List[Callback]):
        self._callbacks = list(callbacks)

    def __getattr__(self, name):
        if not name.startswith("on_"):
            raise AttributeError(name)

        def fanout(*args, **kwargs):
            for cb in self._callbacks:
                getattr(cb, name)(*args, **kwargs)
        return fanout


class BroadcastGlobalVariablesCallback(Callback):
    """Broadcast the initial model and optimizer state from ``root_rank``
    at train start (reference ``callbacks.py:22``: the consistency step of
    the 5-line recipe)."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank

    def on_train_begin(self, loop, logs=None):
        F.broadcast_parameters(loop.model.state_dict(), self.root_rank)
        if getattr(loop, "optimizer", None) is not None:
            F.broadcast_optimizer_state(loop.optimizer, self.root_rank)


class MetricAverageCallback(Callback):
    """Average epoch metrics over all workers (reference
    ``callbacks.py:48-87``) so logged/checkpoint-selection metrics agree
    everywhere; through the port's eager allreduce."""

    def on_epoch_end(self, epoch, loop, logs=None):
        if not logs:
            return
        import horovod_tpu_torch as hvd

        for k in sorted(logs):
            v = logs[k]
            if isinstance(v, (int, float, np.floating, np.integer)) or \
                    hasattr(v, "shape"):
                t = torch.as_tensor(np.asarray(v, np.float32),
                                    device=hvd.device())
                logs[k] = float(eager.allreduce(t, name=f"metric.{k}",
                                                op=eager.Average))


class _LrCallback(Callback):
    """Base for callbacks setting the learning rate of every one of
    ``loop.optimizer.param_groups``."""

    @staticmethod
    def _set_lr(loop, lr: float) -> None:
        groups = getattr(loop.optimizer, "param_groups", None)
        if not groups or any("lr" not in g for g in groups):
            raise ValueError(
                "LR callbacks need a torch optimizer whose param_groups "
                "hold an 'lr'")
        for g in groups:
            g["lr"] = float(lr)

    @staticmethod
    def _get_lr(loop) -> float:
        return float(loop.optimizer.param_groups[0]["lr"])


class LearningRateWarmupCallback(_LrCallback):
    """Epoch-fraction warmup ``initial → base_lr*size`` (reference
    ``callbacks.py:104-187``)."""

    def __init__(self, initial_lr: float, warmup_epochs: int = 5,
                 steps_per_epoch: Optional[int] = None, verbose: bool = False):
        import horovod_tpu_torch as hvd

        self.initial_lr = initial_lr
        self.target_lr = initial_lr * hvd.size()
        self.warmup_epochs = warmup_epochs
        self.steps_per_epoch = steps_per_epoch
        self.verbose = verbose
        self._epoch = 0

    def on_epoch_begin(self, epoch, loop, logs=None):
        self._epoch = epoch

    def on_batch_begin(self, batch, loop, logs=None):
        if self._epoch >= self.warmup_epochs:
            return
        if not self.steps_per_epoch:
            raise ValueError("steps_per_epoch required for warmup")
        progress = (self._epoch * self.steps_per_epoch + batch + 1) / \
            (self.warmup_epochs * self.steps_per_epoch)
        lr = self.initial_lr + (self.target_lr - self.initial_lr) * \
            min(progress, 1.0)
        self._set_lr(loop, lr)

    def on_epoch_end(self, epoch, loop, logs=None):
        if epoch == self.warmup_epochs - 1 and self.verbose:
            print(f"Epoch {epoch}: finished gradual learning rate warmup "
                  f"to {self.target_lr}.")


class LearningRateScheduleCallback(_LrCallback):
    """Multiplier schedule against the (scaled) base LR (reference
    ``callbacks.py:104-160``): ``multiplier`` is a float or
    ``f(epoch) -> float``; with ``staircase`` the epoch is floored."""

    def __init__(self, initial_lr: float,
                 multiplier: Callable[[float], float],
                 start_epoch: int = 0, end_epoch: Optional[int] = None,
                 staircase: bool = True,
                 steps_per_epoch: Optional[int] = None):
        self.initial_lr = initial_lr
        self.multiplier = multiplier if callable(multiplier) \
            else (lambda _e, _m=multiplier: _m)
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.steps_per_epoch = steps_per_epoch
        self._epoch = 0

    def _adjust(self, loop, epoch: float) -> None:
        if epoch < self.start_epoch or \
                (self.end_epoch is not None and epoch >= self.end_epoch):
            return
        self._set_lr(loop, self.initial_lr * self.multiplier(epoch))

    def on_epoch_begin(self, epoch, loop, logs=None):
        self._epoch = epoch
        if self.staircase:
            self._adjust(loop, epoch)

    def on_batch_begin(self, batch, loop, logs=None):
        if not self.staircase:
            if not self.steps_per_epoch:
                raise ValueError("steps_per_epoch required for smooth "
                                 "schedules")
            self._adjust(loop, self._epoch + batch / self.steps_per_epoch)


# -- elastic callbacks (reference horovod/_keras/elastic.py) ----------------

class CommitStateCallback(Callback):
    """``state.commit()`` every ``batches_per_commit`` batches (reference
    ``CommitStateCallback``)."""

    def __init__(self, state, batches_per_commit: int = 1):
        self.state = state
        self.batches_per_commit = batches_per_commit

    def on_batch_end(self, batch, loop, logs=None):
        if (batch + 1) % self.batches_per_commit == 0:
            self.state.commit()


class UpdateBatchStateCallback(Callback):
    """Track ``state.batch``; resuming mid-epoch skips finished batches
    (reference ``UpdateBatchStateCallback``)."""

    def __init__(self, state):
        self.state = state

    def on_batch_end(self, batch, loop, logs=None):
        self.state.batch = batch + 1

    def on_epoch_end(self, epoch, loop, logs=None):
        self.state.batch = 0


class UpdateEpochStateCallback(Callback):
    """Track ``state.epoch`` across resets (reference
    ``UpdateEpochStateCallback``)."""

    def __init__(self, state):
        self.state = state

    def on_epoch_end(self, epoch, loop, logs=None):
        self.state.epoch = epoch + 1
