"""Online autotuning of runtime knobs (reference ``parameter_manager.{h,cc}``;
``horovod_tpu/utils/autotune.py``).

The reference tunes fusion-buffer size, cycle time, cache and hierarchy
flags during the first training batches: a categorical warm-up grid, then
Bayesian optimization (GP + expected improvement, ``optim/``), scoring each
sample by negotiated bytes/sec and broadcasting the winner from rank 0
(``controller.cc:34-48``).

The port tunes the two knobs of the eager plane's
:class:`~horovod_tpu_torch.ops.bucketing.Bucketer`: its fusion threshold
and flush cycle time (the in-step exchange's buckets are planned when the
step is built; :mod:`~horovod_tpu_torch.utils.bench_autotune` tunes
those offline).  This manager keeps the same
lifecycle — ``record_bytes()`` each step, sample scoring over fixed windows,
readback of the best point — with a grid + golden-section refinement, which
converges in fewer samples than GP for 1–2 smooth dims.  Knobs the user set
explicitly (``fixed_knobs``) are never touched (reference ``operations.cc:436``).
"""

from __future__ import annotations

import csv
import time
from typing import List, Optional, Tuple

from horovod_tpu_torch.utils import logging as hvd_logging

MiB = 1024 * 1024

# categorical warm-up grid: (fusion_threshold_bytes, cycle_time_ms),
# same spirit as parameter_manager.cc's initial grid
_WARMUP_GRID: List[Tuple[int, float]] = [
    (0, 1.0),
    (8 * MiB, 2.5),
    (32 * MiB, 5.0),
    (64 * MiB, 5.0),
    (128 * MiB, 10.0),
]


#: Bayesian-refinement search box: log2(fusion bytes) in [1 MiB, 256 MiB],
#: cycle time in [1, 20] ms (reference tunable ranges,
#: parameter_manager.h:58-78)
_BO_BOUNDS = [(20.0, 28.0), (1.0, 20.0)]
_BO_SAMPLES = 8

#: warm-up points still MEASURED after cost-model pruning (predict=):
#: the model ranks, the measurement decides — two survivors keep the
#: decision empirical while skipping the predicted-hopeless majority
_PREDICT_KEEP = 2


class ParameterManager:
    """Online knob tuner; ``predict=`` (a scorer of a point's bytes/sec,
    such as a cost model's) pre-prunes the categorical warm-up grid so
    that only the plausible points pay for measurement steps."""

    def __init__(self, config, log_path: Optional[str] = None,
                 predict=None):
        self._config = config
        self._tunable = [k for k in ("fusion_threshold_bytes", "cycle_time_ms")
                         if k not in config.fixed_knobs]
        self._samples_per_point = config.autotune_steps_per_sample
        self._points = list(_WARMUP_GRID)
        if predict is not None:
            self._points = self._prune_by_prediction(predict)
        self._scores: List[Tuple[float, Tuple[int, float]]] = []
        self._point_idx = 0
        self._bytes_this_point = 0
        self._steps_this_point = 0
        self._point_start = time.monotonic()
        self._done = not self._tunable
        self._log_path = log_path
        self._log_rows: List[dict] = []
        self._bo = None
        self._bo_samples_left = getattr(
            config, 'autotune_bayes_opt_max_samples', _BO_SAMPLES)
        self._gp_noise = getattr(
            config, 'autotune_gaussian_process_noise', 0.8)
        if not self._done:
            self._apply(self._points[0])

    def _prune_by_prediction(self, predict) -> List[Tuple[int, float]]:
        """Rank the warm-up grid by the cost model's predicted score
        and keep the top ``_PREDICT_KEEP`` points (grid order
        preserved).  A predictor that throws falls back to the full
        grid — a broken model must cost tuning time, never correctness.
        The Bayesian refinement after the warm-up is untouched: it can
        still walk back into pruned territory if the measurements
        disagree with the model."""
        try:
            scored = sorted(((float(predict(p)), p)
                             for p in self._points),
                            key=lambda s: -s[0])
        except Exception as e:  # noqa: BLE001 — prediction is advisory
            hvd_logging.warning(
                "autotune: predict scorer failed (%s); measuring the "
                "full warm-up grid", e)
            return list(self._points)
        top = {p for _, p in scored[:_PREDICT_KEEP]}
        kept = [p for p in self._points if p in top]
        hvd_logging.info(
            "autotune: cost model pruned the warm-up grid %d -> %d "
            "points (%s)", len(self._points), len(kept), kept)
        return kept

    @property
    def active(self) -> bool:
        return not self._done

    def _apply(self, point: Tuple[int, float]) -> None:
        if "fusion_threshold_bytes" in self._tunable:
            self._config.fusion_threshold_bytes = point[0]
        if "cycle_time_ms" in self._tunable:
            self._config.cycle_time_ms = point[1]

    def record_bytes(self, nbytes: int) -> None:
        """Called by the bucketing layer after each flushed collective."""
        if self._done:
            return
        self._bytes_this_point += nbytes
        self._steps_this_point += 1
        if self._steps_this_point >= self._samples_per_point:
            self._finish_point()

    def _finish_point(self) -> None:
        elapsed = max(time.monotonic() - self._point_start, 1e-9)
        score = self._score_across_processes(self._bytes_this_point, elapsed)
        point = self._points[self._point_idx]
        self._scores.append((score, point))
        self._log_rows.append({
            "fusion_threshold": point[0], "cycle_time_ms": point[1],
            "bytes_per_sec": score})
        hvd_logging.debug("autotune: point %s scored %.3e B/s", point, score)

        self._point_idx += 1
        if self._point_idx < len(self._points):
            self._apply(self._points[self._point_idx])
            self._reset_window()
            return

        # Bayesian refinement after the categorical warm-up (reference
        # parameter_manager.cc: grid warm-up, then GP+EI).  Deterministic
        # seed + synced scores keep every process proposing the same point.
        import math

        from horovod_tpu_torch.utils.bayesian import BayesianOptimizer

        if self._bo is None:
            self._bo = BayesianOptimizer(_BO_BOUNDS, seed=0,
                                         noise=self._gp_noise)
            for sc, (thr, cyc) in self._scores:
                self._bo.observe(
                    [math.log2(max(thr, 1 * MiB)), cyc], sc)
        else:
            self._bo.observe([math.log2(max(point[0], 1 * MiB)), point[1]],
                             score)

        if self._bo_samples_left > 0:
            self._bo_samples_left -= 1
            log_thr, cyc = self._bo.suggest()
            nxt = (int(2 ** log_thr), round(float(cyc), 2))
            self._points.append(nxt)
            self._apply(nxt)
            self._reset_window()
            return

        best = max(self._scores, key=lambda s: s[0])[1]
        self._apply(best)
        self._done = True
        hvd_logging.info(
            "autotune converged: fusion_threshold=%d cycle_time=%.1fms",
            self._config.fusion_threshold_bytes, self._config.cycle_time_ms)
        self._write_log()

    def _reset_window(self) -> None:
        self._bytes_this_point = 0
        self._steps_this_point = 0
        self._point_start = time.monotonic()

    def _score_across_processes(self, nbytes: int, elapsed: float) -> float:
        """Agree on one score for this sample point across all processes.

        Locally-timed scores differ per process; applying per-process
        winners would set divergent fusion thresholds and break the
        bucketer's every-process-fuses-the-same-set invariant.  The
        reference solves this by rank-0 tuning + parameter broadcast
        (``controller.cc:34-48``); here every rank derives the identical
        score from a metadata allgather over the host group — total bytes
        over the slowest rank's elapsed time.  All ranks reach this
        exchange at the same flush index because flush decisions follow
        program order.
        """
        import numpy as np

        from horovod_tpu_torch.ops import eager
        from horovod_tpu_torch.runtime import state

        if state.global_state().size == 1:
            return nbytes / elapsed
        sample = np.asarray([nbytes, int(elapsed * 1e9)], np.int64)
        gathered = eager._allgather_host_metadata(sample)
        total_bytes = float(gathered[:, 0].sum())
        slowest_s = max(float(gathered[:, 1].max()) / 1e9, 1e-9)
        return total_bytes / slowest_s

    def _write_log(self) -> None:
        if not self._log_path or not self._log_rows:
            return
        with open(self._log_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(self._log_rows[0]))
            w.writeheader()
            w.writerows(self._log_rows)
