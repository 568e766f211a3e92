"""Rank-0 checkpoints of the PyTorch port (``horovod_tpu/checkpoint.py``).

Horovod ships no checkpoint format; its recipe saves on rank 0 and restores
with a broadcast.  :class:`Checkpointer` writes one ``step_<N>/state.pt``
per step on rank 0: the state's tensors are copied to host memory first
(the consistent cut), written with ``torch.save`` to a temporary file,
fsynced, and made visible by an atomic ``os.replace`` followed by an fsync
of the directory entry, so a crash mid-write leaves only ``.tmp`` files,
which readers ignore.  The oldest steps beyond ``max_to_keep`` are removed
after the new one is durable.  Saving is synchronous; the JAX package's
async writer, sharded (ZeRO) state and orbax backend wait for later slices.

::

    ckpt = Checkpointer("/tmp/run1")
    ckpt.save(step, {"model": model.state_dict(), "opt": opt.state_dict()})
    state = ckpt.restore()          # every rank reads; latest step
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch

from horovod_tpu_torch.runtime import state as _rt


def _is_root() -> bool:
    return not _rt.is_initialized() or _rt.global_state().rank == 0


def _host_copy(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _atomic_save(path: str, payload: Any) -> None:
    d = os.path.dirname(path)
    tmp = os.path.join(d, f".tmp.{os.path.basename(path)}.{os.getpid()}")
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dirfd = os.open(d, os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)


class Checkpointer:
    """Directory-per-step checkpoints written by rank 0."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def save(self, step: int, state: Any) -> bool:
        """Write ``state`` (tensors, dicts, lists, numbers) for ``step`` on
        rank 0; a no-op elsewhere.  Returns whether this rank wrote."""
        if not _is_root():
            return False
        host_state = _host_copy(state)
        path = os.path.join(self._dir, f"step_{int(step)}")
        os.makedirs(path, exist_ok=True)
        _atomic_save(os.path.join(path, "state.pt"), host_state)
        for old in self.all_steps()[:-self._max_to_keep]:
            shutil.rmtree(os.path.join(self._dir, f"step_{old}"),
                          ignore_errors=True)
        return True

    def all_steps(self) -> list:
        """Steps with a finished ``state.pt``, ascending."""
        steps = []
        for d in os.listdir(self._dir):
            if d.startswith("step_") and d[5:].isdigit() and \
                    os.path.exists(os.path.join(self._dir, d, "state.pt")):
                steps.append(int(d[5:]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None,
                map_location=None) -> Any:
        """Load ``step`` (default: the latest) on this rank; tensors land
        on ``map_location`` (default: where they were saved from, the
        CPU)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self._dir}")
        path = os.path.join(self._dir, f"step_{int(step)}", "state.pt")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no checkpoint for step {step} in {self._dir} "
                f"(available: {self.all_steps()})")
        return torch.load(path, map_location=map_location,
                          weights_only=True)
