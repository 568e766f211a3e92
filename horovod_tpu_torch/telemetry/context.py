"""RunContext: the (run_id, generation, step) correlation triple (a copy
of ``horovod_tpu/telemetry/context.py``).

Trace spans (``utils/timeline.py``), metric snapshots (the JSONL
exporter) and log lines (``utils/logging.py``) all stamp the same
triple, so an operator can pivot between the three planes of one run:
find the slow step in the timeline, read its metrics sample, grep its
log lines (docs/metrics.md "Correlating the three planes").

* ``run_id`` — one training invocation end-to-end, surviving elastic
  resets; from ``HOROVOD_RUN_ID`` when the launcher provides it
  (re-exported to workers), else derived once per process.
* ``generation`` — the elastic world generation
  (``HOROVOD_ELASTIC_GENERATION``); bumped through ``update()`` on
  reset.
* ``step`` — the training progress counter; advanced by
  ``DistributedTrainStep`` calls and elastic commits.

The singleton is process-wide and thread-safe; reads are lock-free
snapshots of immutable ints/strings (torn reads impossible — each field
is one reference swap).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional


class RunContext:
    def __init__(self, run_id: Optional[str] = None,
                 generation: int = 0, step: int = 0):
        self._lock = threading.Lock()
        self.run_id = run_id or _default_run_id()
        self.generation = int(generation)
        self.step = int(step)
        # whether anything explicitly set context — the signal the log
        # formatter uses to start stamping lines (a non-run process,
        # e.g. a unit test, keeps the historical log format)
        self.explicit = False

    def update(self, run_id: Optional[str] = None,
               generation: Optional[int] = None,
               step: Optional[int] = None) -> None:
        with self._lock:
            if run_id is not None:
                self.run_id = str(run_id)
            if generation is not None:
                self.generation = int(generation)
            if step is not None:
                self.step = int(step)
            self.explicit = True

    def advance(self, generation: Optional[int] = None,
                step: Optional[int] = None) -> None:
        """Update values WITHOUT marking the context explicit — for
        instrumentation that tracks progress (train step, elastic
        commits) and must not switch a process into correlated-log mode
        on its own; ``update()`` is the operator-facing setter."""
        with self._lock:
            if generation is not None:
                self.generation = int(generation)
            if step is not None:
                self.step = int(step)

    def advance_step(self, n: int = 1) -> int:
        with self._lock:
            self.step += int(n)
            return self.step

    def as_dict(self) -> Dict:
        with self._lock:
            return {"run_id": self.run_id, "generation": self.generation,
                    "step": self.step}

    def log_suffix(self) -> str:
        """``" gen G step S"`` once context is explicitly set, else
        ``""`` — appended inside the log prefix bracket."""
        if not self.explicit:
            return ""
        return f" gen {self.generation} step {self.step}"


def _default_run_id() -> str:
    env = os.environ.get("HOROVOD_RUN_ID")
    if env:
        return env
    return f"run-{os.getpid():x}-{int(time.time()) & 0xFFFFFF:x}"


_ctx: Optional[RunContext] = None
_ctx_lock = threading.Lock()


def run_context() -> RunContext:
    global _ctx
    if _ctx is None:
        with _ctx_lock:
            if _ctx is None:
                _ctx = RunContext()
    return _ctx
