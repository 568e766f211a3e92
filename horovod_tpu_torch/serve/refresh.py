"""Live weight refresh without drain (a copy of
``horovod_tpu/serve/refresh.py``, docs/serving.md).

Serving weights go stale the moment training produces a better
checkpoint; draining the fleet to swap them costs exactly the
availability the fleet exists to provide.  :class:`WeightRefresher`
double-buffers each tenant model's parameter tree and swaps it under
traffic:

1. **stage** — the new checkpoint streams toward the replicas on the
   :class:`~horovod_tpu_torch.memory.offload.HostOffloadEngine`'s
   double-buffered H2D path (when an engine is wired; trees already on
   the right device skip the hop).  A transfer fault degrades to the
   engine's retained reference — the offload engine's contract: the
   caller gets its tree back bit-identical, no step (and no refresh)
   lost.  Staging while a previous stage is still pending is
   **latest-wins**: the superseded buffer is dropped whole, never
   half-applied (no torn state).
2. **flip** — :meth:`maybe_flip` applies the pending stage *between*
   batches only (the FleetBatcher calls it before snapshotting the
   batch's weights), so in-flight requests complete on the old weights
   and no batch ever runs half-old half-new.
3. **verify** — before the flip commits, the staged tree's
   position-weighted fingerprint (guard/checksum.py) is recomputed and
   checked against the producer's expected fingerprint.  A mismatch
   **rolls the flip back**: the old weights keep serving, the staged
   buffer is discarded, and the checkpoint tag is quarantined (the
   guard's rollback discipline — ``on_quarantine`` is the hook to pin
   the last-good checkpoint, ``Checkpointer.pin`` style).  Zero
   requests are shed on this path; the swap simply never happens.

Every response minted after a flip carries the new fingerprint
(``InferenceResponse.weights_fp``), so weight freshness is verifiable
end to end.

Fault site ``serve.refresh`` fires at the top of every flip attempt; a
``corrupt`` action there tampers the staged tree in transit and must
be caught by the fingerprint verify (the rollback path's chaos proof),
a ``raise`` models a flip-time failure and takes the same rollback
edge (docs/faults.md).

``HOROVOD_SERVE_REFRESH_VERIFY=0`` disables the fingerprint check
(trusted same-process producers); the default is on.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from horovod_tpu_torch import faults, telemetry
from horovod_tpu_torch.runtime.config import _env_bool
from horovod_tpu_torch.utils import logging as hvd_logging

_TEL_STAGED = telemetry.counter(
    "hvd_serve_refresh_staged_total",
    "checkpoints staged for a live weight swap (model=)")
_TEL_FLIPS = telemetry.counter(
    "hvd_serve_refresh_flips_total",
    "atomic weight flips committed (model=)")
_TEL_ROLLBACKS = telemetry.counter(
    "hvd_serve_refresh_rollbacks_total",
    "flips rolled back on fingerprint mismatch, checkpoint "
    "quarantined (model=)")
_TEL_SUPERSEDED = telemetry.counter(
    "hvd_serve_refresh_superseded_total",
    "pending stages replaced by a newer one before flipping "
    "(latest-wins; model=)")


class _Staged:
    """One pending double-buffer: the streamed tree, the producer's
    expected fingerprint, and the checkpoint tag for quarantine."""

    __slots__ = ("params", "expected_fp", "tag")

    def __init__(self, params: Any, expected_fp: Optional[int],
                 tag: str):
        self.params = params
        self.expected_fp = expected_fp
        self.tag = tag


class WeightRefresher:
    """Double-buffered, fingerprint-verified live weight swap for the
    serving fleet (module docstring).

    ``engine`` is an optional
    :class:`~horovod_tpu_torch.memory.offload.HostOffloadEngine`; with one
    wired, :meth:`stage` round-trips the checkpoint through its
    offload/fetch path (async D2H behind a bounded ring, blocking H2D
    restore) so the transfer rides — and inherits the degrade contract
    of — the same machinery the training loop's optimizer offload
    already proved.  ``on_quarantine(model_id, tag)`` is the guard's
    rollback hook (pin the last-good checkpoint, alert, …).
    """

    def __init__(self, verify: Optional[bool] = None,
                 engine=None,
                 on_quarantine: Optional[Callable[[str, str],
                                                  None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.verify = verify if verify is not None \
            else _env_bool("HOROVOD_SERVE_REFRESH_VERIFY", True)
        self._engine = engine
        self._on_quarantine = on_quarantine
        self._clock = clock
        self._lock = threading.Lock()
        self._active: Dict[str, Tuple[Any, int]] = {}
        self._staged: Dict[str, _Staged] = {}
        self._seq = 0
        self.flips = 0
        self.rollbacks = 0
        self.superseded = 0
        self.quarantined: List[Tuple[str, str]] = []

    # -- registration -------------------------------------------------------

    def register(self, model_id: str, params: Any) -> int:
        """Install the initial serving weights; returns their
        fingerprint (stamped on every response until the first flip)."""
        from horovod_tpu_torch.guard.checksum import fingerprint

        fp = fingerprint(params)
        with self._lock:
            self._active[model_id] = (params, fp)
        return fp

    def active(self, model_id: str) -> Tuple[Any, Optional[int]]:
        """The serving buffer: ``(params, fingerprint)`` — snapshot it
        ONCE per batch (FleetBatcher does) so the batch can never mix
        weights."""
        with self._lock:
            return self._active.get(model_id, (None, None))

    def fingerprint_of(self, model_id: str) -> Optional[int]:
        with self._lock:
            entry = self._active.get(model_id)
        return entry[1] if entry else None

    # -- stage --------------------------------------------------------------

    def stage(self, model_id: str, params: Any, tag: str = "",
              expected_fp: Optional[int] = None) -> str:
        """Stream a new checkpoint into the standby buffer; the flip
        itself waits for the next between-batches window.  Latest-wins:
        a stage arriving while another is pending replaces it whole.
        Returns the stage tag (auto-derived when empty)."""
        from horovod_tpu_torch.guard.checksum import fingerprint

        if expected_fp is None:
            # producer-side fingerprint, taken BEFORE the transfer —
            # the verify step re-hashes after it, so a corrupted hop
            # cannot go unnoticed
            expected_fp = fingerprint(params)
        with self._lock:
            self._seq += 1
            tag = tag or f"refresh-{model_id}-{self._seq}"
        if self._engine is not None:
            # the double-buffered H2D path: async D2H into host RAM,
            # blocking H2D restore; a fault on either hop degrades to
            # the retained reference (bit-identical, nothing lost)
            self._engine.offload(tag, params)
            params = self._engine.fetch(tag, params)
        with self._lock:
            if model_id in self._staged:
                self.superseded += 1
                _TEL_SUPERSEDED.inc(model=model_id)
            self._staged[model_id] = _Staged(params, expected_fp, tag)
        _TEL_STAGED.inc(model=model_id)
        return tag

    def pending(self, model_id: str) -> bool:
        with self._lock:
            return model_id in self._staged

    # -- flip ---------------------------------------------------------------

    def maybe_flip(self, model_id: str) -> bool:
        """Commit the pending stage for ``model_id`` if there is one —
        called between batches only.  Returns True on a committed
        flip; False when nothing was pending *or* the flip rolled back
        (old weights keep serving either way)."""
        with self._lock:
            staged = self._staged.pop(model_id, None)
        if staged is None:
            return False
        try:
            tampered = faults.inject("serve.refresh",
                                     value=staged.params)
            if tampered is not None:
                staged.params = tampered
            actual = staged.expected_fp
            if self.verify:
                from horovod_tpu_torch.guard.checksum import fingerprint

                actual = fingerprint(staged.params)
            if actual != staged.expected_fp:
                return self._rollback(
                    model_id, staged,
                    f"fingerprint mismatch {actual:#x} != "
                    f"{staged.expected_fp:#x}")
        except faults.WorkerCrash:
            raise
        except Exception as e:  # noqa: BLE001 — flip faults roll back
            return self._rollback(model_id, staged,
                                  f"{type(e).__name__}: {e}")
        with self._lock:
            self._active[model_id] = (staged.params, staged.expected_fp)
            self.flips += 1
        _TEL_FLIPS.inc(model=model_id)
        hvd_logging.info(
            "serve: model %s flipped to %s (fp %#x)", model_id,
            staged.tag, staged.expected_fp)
        return True

    def _rollback(self, model_id: str, staged: _Staged,
                  why: str) -> bool:
        """The fingerprint-verify/rollback edge: discard the staged
        buffer, quarantine the checkpoint tag, keep serving the old
        weights — zero requests shed on this path."""
        with self._lock:
            self.rollbacks += 1
            self.quarantined.append((model_id, staged.tag))
        _TEL_ROLLBACKS.inc(model=model_id)
        hvd_logging.warning(
            "serve: model %s refresh %s ROLLED BACK (%s) — old "
            "weights keep serving, checkpoint quarantined",
            model_id, staged.tag, why)
        if self._on_quarantine is not None:
            try:
                self._on_quarantine(model_id, staged.tag)
            except Exception as e:  # noqa: BLE001 — hook is best-effort
                hvd_logging.warning(
                    "serve: quarantine hook for %s failed: %s",
                    staged.tag, e)
        return False
