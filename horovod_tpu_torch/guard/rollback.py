"""Rollback-and-replay: in-place restore to the last *verified* step (a
copy of ``horovod_tpu/guard/rollback.py``, over
:class:`~horovod_tpu_torch.elastic.TorchState`).

The elastic plane already knows how to restore a checkpoint — but it
does so by bumping the generation and re-running rendezvous, because its
trigger is a dead worker.  A guardian anomaly is different: every worker
is alive, one of them just computed garbage.  :class:`RollbackManager`
restores the last-good checkpoint *in place* — same generation, same
assignment, no rendezvous — rewinds the :class:`ShardedDataset` to the
exact global sample position that checkpoint was cut at, and lets the
loop replay.  Replayed training is bit-deterministic (seeded shards,
seeded faults), so the recovered trajectory equals a fault-free run.

"Last good" is stronger than "last written": a checkpoint taken *after*
a silent corruption is itself poisoned.  A checkpoint is promoted to
last-good only once a replica-consistency check newer than it passes,
and the promoted step is pinned against the checkpointer's GC
(:meth:`Checkpointer.pin`) so retention can never reap the one rollback
target that matters.

Replay bound: corruption strikes in ``(c0, c1]`` between two checks; the
newest checkpoint at or before the clean check ``c0`` is clean, so
``steps_replayed ≤ checkpoint_every + check_interval``.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Optional

from horovod_tpu_torch import telemetry

logger = logging.getLogger("horovod_tpu_torch.guard")

_TEL_ROLLBACKS = telemetry.counter(
    "hvd_guard_rollbacks_total", "guardian rollback-and-replay events")
_TEL_REPLAYED = telemetry.gauge(
    "hvd_guard_steps_replayed",
    "steps between the anomaly and the restored checkpoint")
_TEL_LAST_GOOD = telemetry.gauge(
    "hvd_guard_last_good_step", "newest verified (pinned) checkpoint step")


class RollbackManager:
    """Tracks verified checkpoints for a :class:`TorchState` and performs
    in-place rollback (the model, the optimizer and the object attributes
    restored in place, through ``restore_from_checkpoint``).

    ``dataset_state_fn(step)`` (optional) returns the dataset position
    state (:meth:`ShardedDataset.state_dict`) as of ``step``'s commit;
    it is captured at checkpoint time and surfaced again on rollback so
    the loop can ``load_position`` back to the exact sample.
    """

    def __init__(self, state: Any,
                 dataset_state_fn: Optional[Callable[[int], Any]] = None):
        self._state = state
        self._dataset_state_fn = dataset_state_fn
        self._positions: Dict[int, Any] = {}
        self._last_checkpoint: Optional[int] = None
        self._last_good: Optional[int] = None
        self.last_data_position: Optional[Any] = None
        self.rollbacks = 0

    @property
    def last_good_step(self) -> Optional[int]:
        return self._last_good

    @property
    def last_checkpoint_step(self) -> Optional[int]:
        return self._last_checkpoint

    def note_commit(self) -> None:
        """Call right after ``state.commit()``: records whether this
        commit cut a checkpoint, and at which dataset position."""
        state = self._state
        step = state._commit_count
        every = max(getattr(state, "_checkpoint_every", 1), 1)
        if getattr(state, "_checkpointer", None) is None:
            return
        if step % every != 0:
            return
        self._last_checkpoint = step
        if self._dataset_state_fn is not None:
            self._positions[step] = self._dataset_state_fn(step)

    def note_verified(self, step: int) -> None:
        """A replica-consistency check at ``step`` passed: every
        checkpoint at or before it is clean — promote the newest."""
        cand = self._last_checkpoint
        if cand is None or cand > step:
            return
        if self._last_good == cand:
            return
        prev = self._last_good
        ckpt = getattr(self._state, "_checkpointer", None)
        if ckpt is not None:
            ckpt.pin(cand)
            if prev is not None:
                ckpt.unpin(prev)
        self._last_good = cand
        _TEL_LAST_GOOD.set(cand)
        # positions older than the rollback target can never be needed
        for s in [s for s in self._positions if s < cand]:
            del self._positions[s]

    def rollback(self, reason: str = "anomaly") -> int:
        """Restore the last-good checkpoint in place; returns the number
        of steps the loop must replay.  ``last_data_position`` afterward
        holds the dataset state to ``load_position`` (None if no
        ``dataset_state_fn`` was wired)."""
        target = self._last_good
        if target is None:
            # no verified checkpoint yet (anomaly inside the first check
            # window): the newest checkpoint predates any detected
            # corruption and is the best available target
            target = self._last_checkpoint
        if target is None:
            raise RuntimeError(
                "guard rollback requested but no checkpoint has been "
                "written yet — is checkpointing enabled?")
        before = self._state._commit_count
        self._state.restore_from_checkpoint(step=target)
        self.last_data_position = self._positions.get(target)
        replayed = before - target
        self.rollbacks += 1
        _TEL_ROLLBACKS.inc(reason=reason)
        _TEL_REPLAYED.set(replayed)
        logger.warning(
            "guard rollback (%s): step %d -> %d, replaying %d steps",
            reason, before, target, replayed)
        return replayed
