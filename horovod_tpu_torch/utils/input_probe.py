"""Measured H2D/compute overlap for the input feed
(``horovod_tpu/utils/input_probe.py``).

The input-pipeline claim is that batch ``k+1``'s host→device copy hides
under batch ``k``'s compute.  It is verified by *timing the copy against
an in-flight step*, reduced to three numbers:

* ``put_s`` — placing one host batch on the device, fenced;
* ``step_s`` — one train-step call on an already-resident batch,
  fenced on a host fetch of its scalar loss;
* ``both_s`` — the step on one batch while the *next* batch's placement
  is issued, fence both.  A PyTorch step's call returns only once its
  host work has queued every kernel, which is most of an eager step, so
  the placement is issued from a second thread as the step starts, as
  :class:`~horovod_tpu_torch.data.PrefetchIterator`'s workers issue it
  (the JAX package's step returns at once, and its probe places after
  it on the same thread).

If the two serialize, ``both ≈ step + put``; if the copy fully hides,
``both ≈ max(step, put)``.  The achieved fraction is::

    h2d_overlap = (step_s + put_s - both_s) / min(step_s, put_s)

clamped to [0, 1], the same estimator and field names as the JAX
package's probe.  On a card the fence is a CUDA event on the copy,
synchronised: the event a :class:`~horovod_tpu_torch.data.prefetch.
CardStager` recorded after the copy, or else one recorded on the
current stream after a placement issued there — not a host fetch of the
batch.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from horovod_tpu_torch.data.prefetch import COPY_EVENT_ATTR


@dataclasses.dataclass
class H2dReport:
    put_s: float
    step_s: float
    both_s: float
    overlap_fraction: float

    def as_bench_fields(self, prefix: str = "") -> dict:
        return {
            f"{prefix}h2d_overlap_fraction": round(self.overlap_fraction,
                                                   4),
            f"{prefix}h2d_put_s": round(self.put_s, 6),
            f"{prefix}h2d_step_s": round(self.step_s, 6),
        }


def fence_batch(batch) -> None:
    """Wait for a placed batch's copy: synchronise the CUDA event of its
    first tensor's copy (recorded by the pipeline's stager, or recorded
    here on the current stream).  A batch on the CPU has nothing to wait
    for."""
    leaf = next(t for t in tree_leaves(batch) if isinstance(t, torch.Tensor))
    if not leaf.is_cuda:
        return
    event = getattr(leaf, COPY_EVENT_ATTR, None)
    if event is None:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(leaf.device))
    event.synchronize()


def measure_h2d_overlap(run_step: Callable, make_batch: Callable,
                        place: Callable, iters: int = 3,
                        warmup: int = 1) -> H2dReport:
    """Time the three phases and return the achieved overlap.

    ``make_batch() -> host batch`` (fresh each call);
    ``place(host) -> device batch`` (callable from a second thread; the
    probe fences each batch before a step reads it);
    ``run_step(device_batch) -> scalar tensor`` (owns the train state
    internally — the probe treats the step as a black box)."""
    def t_put():
        b = make_batch()
        t0 = time.perf_counter()
        fence_batch(place(b))
        return time.perf_counter() - t0

    def t_step():
        b = place(make_batch())
        fence_batch(b)
        t0 = time.perf_counter()
        float(run_step(b))
        return time.perf_counter() - t0

    def t_both():
        b = place(make_batch())
        fence_batch(b)
        nxt = make_batch()
        failed = []

        def put():
            try:
                fence_batch(place(nxt))
            except BaseException as e:  # noqa: BLE001 - raised below
                failed.append(e)

        th = threading.Thread(target=put, name="hvd-input-probe")
        t0 = time.perf_counter()
        th.start()                   # H2D issued while the step runs
        out = run_step(b)
        th.join()
        float(out)
        dt = time.perf_counter() - t0
        if failed:
            raise failed[0]
        return dt

    def median(fn):
        for _ in range(warmup):
            fn()
        return float(np.median([fn() for _ in range(iters)]))

    put_s, step_s, both_s = median(t_put), median(t_step), median(t_both)
    denom = min(put_s, step_s)
    frac = (put_s + step_s - both_s) / denom if denom > 0 else 0.0
    return H2dReport(put_s=put_s, step_s=step_s, both_s=both_s,
                     overlap_fraction=float(np.clip(frac, 0.0, 1.0)))
