"""Retry policy: exponential backoff + full jitter + deadline.

A copy of ``horovod_tpu/runtime/retry.py`` without its environment knobs:
each caller states its policy (the checkpoint writer's ``IO_*``, the NIC
probe's ``PROBE_*``), since no caller needs another one.  Each sleep is
uniform in ``[0, min(max_s, base_s * 2**attempt)]`` (*full jitter*, which
minimizes contention when a fleet retries the same endpoint at once) under
both an attempt budget and a wall-clock deadline (0 = none).

Only exceptions in ``retry_on`` are retried — everything else
propagates immediately (a programming error must never be masked by
backoff).  ``seed``/``clock``/``sleep`` are injectable for
deterministic tests; warnings go to ``logger``, by default this module's.
"""

from __future__ import annotations

import logging
import random
import time
from typing import Any, Callable, Optional, Tuple, Type

DEFAULT_RETRY_ON: Tuple[Type[BaseException], ...] = (OSError, TimeoutError)

_log = logging.getLogger(__name__)


class RetryPolicy:
    def __init__(self, *,
                 max_attempts: int,
                 base_s: float,
                 max_s: float,
                 deadline_s: float,
                 jitter: bool = True,
                 retry_on: Tuple[Type[BaseException], ...] = DEFAULT_RETRY_ON,
                 name: str = "retry",
                 logger: Optional[logging.Logger] = None,
                 seed: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.max_attempts = max(max_attempts, 1)
        self.base_s = base_s
        self.max_s = max_s
        self.deadline_s = deadline_s
        self.jitter = jitter
        self.retry_on = retry_on
        self.name = name
        self._log = logger or _log
        self._rng = random.Random(seed)
        self._clock = clock
        self._sleep = sleep

    def backoff_s(self, attempt: int) -> float:
        """Sleep before retry number ``attempt+1`` (attempt is 0-based)."""
        cap = min(self.max_s, self.base_s * (2.0 ** attempt))
        return self._rng.uniform(0.0, cap) if self.jitter else cap

    def call(self, fn: Callable, *args, **kwargs) -> Any:
        """Run ``fn`` under this policy; re-raises the last retryable
        error once the attempt budget or the deadline is exhausted."""
        start = self._clock()
        last: Optional[BaseException] = None
        for attempt in range(self.max_attempts):
            try:
                return fn(*args, **kwargs)
            except self.retry_on as e:  # noqa: PERF203 — the point
                last = e
                if attempt + 1 >= self.max_attempts:
                    break
                delay = self.backoff_s(attempt)
                if self.deadline_s > 0:
                    remaining = self.deadline_s - (self._clock() - start)
                    if remaining <= 0:
                        self._log.warning(
                            "%s: deadline %.1fs exhausted after %d "
                            "attempt(s): %s", self.name, self.deadline_s,
                            attempt + 1, e)
                        raise
                    # the final sleep is clamped to the remaining budget,
                    # so a full-jitter draw cannot overshoot the deadline
                    delay = min(delay, remaining)
                self._log.warning(
                    "%s: attempt %d/%d failed (%s: %s) — retrying in "
                    "%.2fs", self.name, attempt + 1, self.max_attempts,
                    type(e).__name__, e, delay)
                self._sleep(delay)
        assert last is not None
        raise last


#: the JAX package's policy with its ``HOROVOD_RETRY_*`` knobs unset: the
#: elastic plane's callers state only what differs from it, as there
DEFAULTS = dict(max_attempts=5, base_s=0.1, max_s=5.0, deadline_s=60.0)


def default_policy(**kw) -> RetryPolicy:
    """A :class:`RetryPolicy` of :data:`DEFAULTS` and ``kw``."""
    return RetryPolicy(**{**DEFAULTS, **kw})
