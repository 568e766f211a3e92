"""Offline throughput autotuning of step-level knobs
(``horovod_tpu/utils/bench_autotune.py``).

The runtime :class:`~horovod_tpu_torch.utils.autotune.ParameterManager`
tunes the *eager* plane's knobs online by bytes/sec, the reference
``parameter_manager.{h,cc}`` lifecycle.  A training step's own knobs (the
exchange's bucket bytes, a flash block size) are set when the step is
built, so they are tuned *offline* by this driver against the measured
objective (images/sec, tokens/sec): each candidate builds and times the
step anew.

Strategy: coordinate descent over small categorical axes with
memoization: cycling the axes to a fixed point finds the optimum of an
axis-wise unimodal grid in far fewer measurements than the cross
product.  Every sample lands in a CSV log, the same artifact shape as the
online manager's log.
"""

from __future__ import annotations

import csv
import time
from typing import Callable, Dict, List, Optional, Tuple

from horovod_tpu_torch.utils import logging as hvd_logging


class ThroughputAutotuner:
    """Maximize ``measure(point)`` over a categorical grid.

    ``axes`` maps knob name → candidate values (order defines the scan
    order).  ``measure`` builds + runs the workload at a point and
    returns units/sec; each unique point is measured once (memoized).
    ``seed`` picks the starting point (default: middle of each axis —
    a deliberately un-tuned cold start).

    ``predict`` (optional) is a static scorer — higher is better, the
    cost-model contract of
    a cost model's score of the exchange schedule —
    used to PRUNE each axis scan to the ``prune_to`` most promising
    candidates (the current value always stays) before paying a
    compile+measure per point.  A predictor that returns ``None`` for
    any candidate, scores every candidate identically, or raises,
    leaves that axis fully measured — the measurement, never the
    model, picks the winner.

    ``feasible`` (optional) is a hard predicate — the HBM-budget
    contract of a memory budget's fit predicate: a
    point it rejects is never compiled or measured (score ``-inf``),
    so the tuner returns the fastest *feasible* point.  Unlike
    ``predict`` it is a constraint, not a ranking — a raising
    predicate fails the run (a budget that cannot be evaluated must
    not silently become "everything fits").  When every point in the
    grid is rejected, :meth:`run` raises ``RuntimeError``.
    """

    def __init__(self, measure: Callable[[Dict], float],
                 axes: Dict[str, List],
                 seed: Optional[Dict] = None,
                 log_path: Optional[str] = None,
                 max_rounds: int = 3,
                 predict: Optional[Callable[[Dict], Optional[float]]]
                 = None,
                 prune_to: int = 2,
                 feasible: Optional[Callable[[Dict], bool]] = None):
        self._measure = measure
        self._axes = {k: list(v) for k, v in axes.items()}
        self._seed = dict(seed) if seed else \
            {k: v[len(v) // 2] for k, v in self._axes.items()}
        self._log_path = log_path
        self._max_rounds = max_rounds
        self._predict = predict
        self._prune_to = max(1, int(prune_to))
        self._feasible = feasible
        self._cache: Dict[Tuple, float] = {}
        self._rows: List[dict] = []

    def _candidates(self, current: Dict, knob: str,
                    values: List) -> List:
        """The axis candidates to actually measure: cost-model-pruned
        to the top ``prune_to`` (+ the current value) when the
        predictor can rank them, the full axis otherwise."""
        if self._predict is None or len(values) <= self._prune_to:
            return values
        try:
            preds = [self._predict(dict(current, **{knob: v}))
                     for v in values]
        except Exception:   # noqa: BLE001 — broken predictor = no prune
            return values
        if any(p is None for p in preds) or len(set(preds)) <= 1:
            return values
        ranked = [v for _, v in sorted(zip(preds, range(len(values))),
                                       key=lambda t: -t[0])]
        keep = [values[i] for i in ranked[: self._prune_to]]
        if current[knob] not in keep:
            keep.append(current[knob])
        hvd_logging.info(
            "autotune: cost model pruned %s axis %s -> %s", knob,
            values, keep)
        return keep

    def _key(self, point: Dict) -> Tuple:
        return tuple(point[k] for k in self._axes)

    def _score(self, point: Dict) -> float:
        key = self._key(point)
        if key in self._cache:
            return self._cache[key]
        if self._feasible is not None and not self._feasible(dict(point)):
            self._cache[key] = float("-inf")
            self._rows.append(dict(point, units_per_sec="",
                                   measure_seconds=0.0,
                                   infeasible="*"))
            hvd_logging.info("autotune: %s -> infeasible (skipped)",
                             point)
            return float("-inf")
        t0 = time.monotonic()
        rate = float(self._measure(dict(point)))
        self._cache[key] = rate
        self._rows.append(dict(point, units_per_sec=rate,
                               measure_seconds=round(
                                   time.monotonic() - t0, 1),
                               infeasible=""))
        hvd_logging.info("autotune: %s -> %.1f/sec", point, rate)
        return rate

    def run(self) -> Tuple[Dict, float]:
        """Coordinate-descend to a fixed point; returns
        ``(best_point, best_rate)`` and writes the log."""
        current = dict(self._seed)
        for _round in range(self._max_rounds):
            moved = False
            for knob, values in self._axes.items():
                scored = [(self._score(dict(current, **{knob: v})), v)
                          for v in self._candidates(current, knob,
                                                    values)]
                best_rate, best_v = max(scored)
                if best_v != current[knob]:
                    current[knob] = best_v
                    moved = True
            if not moved:
                break
        best = max(self._cache.items(), key=lambda kv: kv[1])
        if best[1] == float("-inf"):
            raise RuntimeError(
                "autotune: no feasible point in the grid — every "
                "candidate was rejected by the feasibility predicate")
        point = dict(zip(self._axes, best[0]))
        self._write_log(point, best[1])
        return point, best[1]

    def _write_log(self, best_point: Dict, best_rate: float) -> None:
        if not self._log_path or not self._rows:
            return
        rows = [dict(r, best="") for r in self._rows]
        for r in rows:
            if all(r[k] == best_point[k] for k in self._axes):
                r["best"] = "*"
        with open(self._log_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        hvd_logging.info("autotune: winner %s at %.1f/sec; log at %s",
                         best_point, best_rate, self._log_path)
