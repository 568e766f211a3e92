"""Progress watchdog: the primitive behind hung-but-alive detection
(``horovod_tpu/utils/stall.py``'s :class:`ProgressWatchdog`, which the
elastic health monitor needs).  The reference's ``StallInspector``
waits for a later slice beside the timeline.
"""

from __future__ import annotations

import time
from typing import Optional

from horovod_tpu_torch import telemetry


class ProgressWatchdog:
    """Tracks a monotonically-advancing progress counter and reports how
    long it has been stagnant — the primitive behind hung-but-alive
    detection (a rank whose heartbeats keep arriving while its step
    counter stopped moving is wedged, not dead).

    Pure bookkeeping, no thread: the owner decides when to call
    :meth:`stalled_for` and what stagnation threshold means trouble.
    ``clock`` is injectable for deterministic tests."""

    def __init__(self, clock=time.monotonic, name: Optional[str] = None):
        self._clock = clock
        self._value: Optional[int] = None
        self._since: Optional[float] = None
        # named watchdogs publish their stagnation as a labeled gauge —
        # the hung-worker precursor the health plane acts on later
        # (docs/metrics.md); unnamed ones stay pure bookkeeping
        self._tel_stall = None if name is None else telemetry.gauge(
            "hvd_progress_stall_seconds",
            "seconds since a watched progress counter last advanced"
        ).labels(watchdog=name)

    def update(self, value: int, now: Optional[float] = None) -> None:
        """Record the counter's current value; only an *advance*
        restarts the stagnation clock (a repeated or regressed value —
        a worker re-reporting after restore — does not look like
        progress)."""
        if now is None:
            now = self._clock()
        if self._value is None or value > self._value:
            self._value = value
            self._since = now
            if self._tel_stall is not None:
                self._tel_stall.set(0.0)

    @property
    def value(self) -> Optional[int]:
        return self._value

    def stalled_for(self, now: Optional[float] = None) -> float:
        """Seconds since the counter last advanced (0.0 before the
        first update — never-reported is the startup watchdog's job,
        not this one's)."""
        if self._since is None:
            return 0.0
        if now is None:
            now = self._clock()
        stalled = max(now - self._since, 0.0)
        if self._tel_stall is not None:
            self._tel_stall.set(stalled)
        return stalled
