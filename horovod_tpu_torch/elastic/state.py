"""Framework-independent elastic state, the torch state and the retry loop
(``horovod_tpu/elastic/state.py``).

Reference: ``horovod/common/elastic.py`` — ``State`` (commit/
check_host_updates:60-93), ``ObjectState:112``, ``run_fn`` retry loop
(:147-168) — and ``horovod/torch/elastic/state.py`` (``TorchState``).
:class:`TorchState` is the port's counterpart of the JAX package's
``TpuState``: it takes a model and an optimizer, as the reference's
``TorchState`` does, commits host snapshots of their ``state_dict``\\ s
and restores them in place.
"""

from __future__ import annotations

import copy
import queue
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from horovod_tpu_torch.exceptions import (
    HorovodInternalError,
    HostsUpdatedInterrupt,
)
from horovod_tpu_torch.utils import logging as hvd_logging


class State:
    """Base elastic state (reference ``common/elastic.py:State``).

    Subclasses implement ``save``/``restore``/``sync``.  ``commit()``
    persists a known-good snapshot and then checks for host changes;
    ``check_host_updates()`` alone is the cheap between-batch probe.
    """

    def __init__(self, **kwargs):
        self._host_messages: "queue.Queue" = queue.Queue()
        self._last_updated_timestamp = 0
        self._reset_callbacks = []

    def register_reset_callbacks(self, callbacks) -> None:
        self._reset_callbacks.extend(callbacks)

    def on_reset(self) -> None:
        self._host_messages = queue.Queue()
        self.reset()
        for callback in self._reset_callbacks:
            callback()

    def on_hosts_updated(self, timestamp, update_res=None) -> None:
        """Called by the worker notification service when the driver reports
        a host-set change (reference ``elastic.py:54``)."""
        self._host_messages.put((timestamp, update_res))

    def commit(self) -> None:
        from horovod_tpu_torch import faults

        faults.inject("worker.commit")   # chaos hook: crash/hang at step k
        self.save()
        self.check_host_updates()

    def check_host_updates(self) -> None:
        """Raise ``HostsUpdatedInterrupt`` if new hosts arrived/left; all
        workers agree on the decision: rank 0's view is broadcast
        (reference ``elastic.py:70-93``)."""
        last_updated_timestamp = prev_timestamp = self._last_updated_timestamp
        all_update_res = 0
        while not self._host_messages.empty():
            timestamp, update_res = self._host_messages.get()
            if timestamp > last_updated_timestamp:
                last_updated_timestamp = timestamp
                if update_res:
                    all_update_res |= int(update_res)

        prev_timestamp, last_updated_timestamp, all_update_res = \
            self._sync_host_updates(prev_timestamp, last_updated_timestamp,
                                    all_update_res)

        if last_updated_timestamp > prev_timestamp:
            self._last_updated_timestamp = last_updated_timestamp
            raise HostsUpdatedInterrupt(all_update_res == 0)

    def _sync_host_updates(self, prev_ts, last_ts, update_res):
        """Rank 0's ``(prev, last, res)`` triple is the global truth, as
        the reference broadcasts all three (``elastic.py:84-88``), so the
        raise decision is all-or-none: a freshly-joined worker's prev is 0
        where a survivor's already covers the update.  Through the eager
        plane's host metadata exchange (int64 stays int64), behind a
        ``hostsync`` negotiation that a rank in ``join()`` answers with
        zeros.  Without an initialized runtime the process is a world of
        one, as the JAX package's is without one."""
        from horovod_tpu_torch.ops import eager
        from horovod_tpu_torch.runtime import state as rt

        if not rt.is_initialized() or eager._size() == 1:
            return prev_ts, last_ts, update_res
        eager._negotiate({"kind": "hostsync", "sig": "hostsync"})
        allv = eager._allgather_host_metadata(
            np.asarray([prev_ts, last_ts, update_res], np.int64))
        return int(allv[0, 0]), int(allv[0, 1]), int(allv[0, 2])

    # -- to implement -------------------------------------------------------

    def save(self) -> None:
        raise NotImplementedError

    def restore(self) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class ObjectState(State):
    """Elastic state for arbitrary picklable attributes (reference
    ``elastic.py:112``): everything passed as kwargs becomes a synced,
    commit/restorable attribute."""

    def __init__(self, bcast_object: Optional[Callable] = None, **kwargs):
        if bcast_object is None:
            from horovod_tpu_torch.functions import broadcast_object

            bcast_object = broadcast_object
        self._bcast_object = bcast_object
        self._saved_state: Dict[str, Any] = kwargs
        for k, v in kwargs.items():
            setattr(self, k, v)
        super().__init__()

    def save(self) -> None:
        new_state = {}
        for attr in self._saved_state.keys():
            new_state[attr] = copy.deepcopy(getattr(self, attr))
        self._saved_state = new_state

    def restore(self) -> None:
        for attr, value in self._saved_state.items():
            setattr(self, attr, copy.deepcopy(value))

    def sync(self) -> None:
        if self._saved_state:
            synced = self._bcast_object(self._saved_state, root_rank=0)
            for attr, value in synced.items():
                setattr(self, attr, value)
                self._saved_state[attr] = copy.deepcopy(value)


def _tensor_paths(tree, path=()):
    """``(path, tensor)`` of every tensor of a state_dict tree, in order."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensor_paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensor_paths(v, path + (i,))


def _with_tensors(tree, tensors: dict, path=()):
    """``tree`` with the leaf at each path of ``tensors`` replaced by
    ``tensors[path]`` (a tensor, or a placeholder of one), and every other
    leaf deep-copied."""
    if path in tensors:
        return tensors[path]
    if isinstance(tree, dict):
        return {k: _with_tensors(v, tensors, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_with_tensors(v, tensors, path + (i,))
                          for i, v in enumerate(tree))
    return copy.deepcopy(tree)


class TorchState(ObjectState):
    """Elastic state of a torch model and optimizer, with host snapshots:
    the counterpart of the JAX package's ``TpuState`` (and of the
    reference's ``horovod/torch/elastic/state.py:TorchState``).

    ``commit()`` copies ``model.state_dict()`` and
    ``optimizer.state_dict()``'s tensors into host buffers: page-locked
    ones, allocated at the first commit and reused, so a card's copy runs
    at the link's rate and uses no device memory; the snapshot is complete
    when ``commit()`` returns.  ``restore()`` copies the snapshot back
    into the live tensors in place (the optimizer's through its
    ``load_state_dict`` when its state's layout changed, e.g. before its
    first step); ``sync()`` broadcasts the model and the optimizer state
    from rank 0.  Extra kwargs (``epoch=0, batch=0``) are synced,
    committed and restored as :class:`ObjectState` attributes.

    ``checkpointer`` (a :class:`horovod_tpu_torch.checkpoint.
    Checkpointer`) also writes every ``checkpoint_every``-th commit to
    durable storage through its writer thread, and
    :meth:`restore_from_checkpoint` reads one back, continuing the commit
    counter from its step, as ``TpuState``'s do.

    A ``DistributedOptimizer`` or ``DistributedTrainStep`` holds the
    process groups of the world it was built in: after a reset, build it
    again in a callback given to ``register_reset_callbacks`` (one built
    before raises ``RuntimeError`` rather than hang).  Pass the optimizer
    the wrapper wraps, which survives the reset.
    """

    def __init__(self, model=None, optimizer=None, checkpointer=None,
                 checkpoint_every: int = 1, **kwargs):
        self.model = model
        self.optimizer = optimizer
        self._checkpointer = checkpointer
        self._checkpoint_every = max(int(checkpoint_every), 1)
        self._commit_count = 0
        # the committed snapshot: {"model": state_dict, "optimizer":
        # state_dict} with host tensors, and the host buffers by path
        self._snapshot: Optional[dict] = None
        self._host: Dict[tuple, torch.Tensor] = {}
        #: seconds and bytes of the last commit's device → host copy, and
        #: seconds of the last restore's copy back
        self.last_commit_s = 0.0
        self.last_commit_bytes = 0
        self.last_restore_s = 0.0
        super().__init__(**kwargs)

    # -- snapshot -----------------------------------------------------------

    def _live(self) -> dict:
        live = {}
        if self.model is not None:
            live["model"] = self.model.state_dict()
        if self.optimizer is not None:
            live["optimizer"] = self.optimizer.state_dict()
        return live

    def _buffer(self, path: tuple, t: torch.Tensor) -> torch.Tensor:
        """This path's host buffer, made at the first commit (again if
        the tensor's shape or dtype changed): page-locked for a card's
        tensor."""
        buf = self._host.get(path)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype,
                              pin_memory=t.is_cuda)
            self._host[path] = buf
        return buf

    @staticmethod
    def _check_world() -> None:
        """Raise ``HorovodInternalError`` when the world's last collectives
        failed.  The snapshot's buffers are reused, so a commit must not
        copy what a failed exchange left (NCCL's watchdog aborts a
        communicator whose peer died, and the kernels waiting on it end
        with a partial sum): a one-element all-reduce over the world runs
        after everything queued before it, and an aborted communicator
        raises from it or sums short."""
        from horovod_tpu_torch.runtime import distributed as hvd_dist
        from horovod_tpu_torch.runtime import state as rt
        from horovod_tpu_torch.runtime.distributed import raise_internal

        if not rt.is_initialized() or rt.global_state().size == 1:
            return
        import torch.distributed as dist

        st = rt.global_state()
        flag = torch.ones(1, device=st.device)
        what = "the elastic commit's check of the world"
        with raise_internal(what):
            dist.all_reduce(flag)
            deadline = hvd_dist.collective_deadline_s()
            if deadline is not None:
                # read the sum only once it is there, or raise within the
                # group's timeout (runtime/distributed.await_event)
                done = torch.cuda.Event()
                done.record()
                hvd_dist.await_event(done, what, deadline)
            if int(flag.item()) != st.size:
                raise HorovodInternalError(
                    f"the elastic commit's check of the world summed "
                    f"{int(flag.item())} of {st.size} ranks")

    def _save_tensors(self) -> None:
        t0 = time.perf_counter()
        self._check_world()
        live = self._live()
        host, nbytes, cards = {}, 0, set()
        for path, t in _tensor_paths(live):
            buf = self._buffer(path, t)
            buf.copy_(t.detach(), non_blocking=t.is_cuda)
            host[path] = buf
            nbytes += t.numel() * t.element_size()
            if t.is_cuda:
                cards.add(t.device)
        for device in cards:
            torch.cuda.synchronize(device)   # complete before we return
        self._host = host
        self._snapshot = _with_tensors(live, host)
        self.last_commit_s = time.perf_counter() - t0
        self.last_commit_bytes = nbytes

    def _restore_tensors(self) -> None:
        snap = self._snapshot
        if snap is None:
            return
        t0 = time.perf_counter()
        live = self._live()
        with torch.no_grad():
            if "model" in snap:
                self.model.load_state_dict(snap["model"])
            if "optimizer" in snap:
                got = dict(_tensor_paths(live["optimizer"]))
                want = dict(_tensor_paths(snap["optimizer"]))
                if got.keys() == want.keys() and all(
                        got[k].shape == want[k].shape and
                        got[k].dtype == want[k].dtype for k in got):
                    for k, t in got.items():
                        t.copy_(want[k])
                    for g, saved in zip(self.optimizer.param_groups,
                                        snap["optimizer"]["param_groups"]):
                        g.update({k: copy.deepcopy(v)
                                  for k, v in saved.items()
                                  if k != "params"})
                else:
                    self.optimizer.load_state_dict(
                        _with_tensors(snap["optimizer"], {
                            k: v.clone() for k, v in want.items()}))
        for t in _tensor_paths(live):
            if t[1].is_cuda:
                torch.cuda.synchronize(t[1].device)
                break
        self.last_restore_s = time.perf_counter() - t0

    # -- the State protocol -------------------------------------------------

    def save(self) -> None:
        self._save_tensors()
        super().save()
        self._commit_count += 1
        # progress export: the commit count rides the worker's heartbeats
        # so the driver's hung-rank watchdog sees training advance
        from horovod_tpu_torch import telemetry
        from horovod_tpu_torch.elastic import worker as elastic_worker

        elastic_worker.report_step(self._commit_count)
        telemetry.counter("hvd_elastic_commits_total",
                          "elastic state commits").inc()
        # gauge (not counter): overwritten per commit, so a crash leaves
        # the last durable-loop value for restore's steps_lost diff
        telemetry.gauge("hvd_elastic_steps_committed",
                        "highest committed elastic step").set(
                            self._commit_count)
        telemetry.gauge("hvd_elastic_commit_seconds",
                        "last commit's device-to-host copy").set(
                            self.last_commit_s)
        telemetry.run_context().advance(step=self._commit_count)
        if self._checkpointer is not None and \
                self._commit_count % self._checkpoint_every == 0:
            self._checkpointer.save(self._commit_count, self._durable())

    def _durable(self) -> dict:
        """What a durable checkpoint holds: the snapshot and the object
        attributes."""
        return {"tensors": self._snapshot or {},
                "objects": dict(self._saved_state)}

    def wait(self) -> None:
        """Barrier on the async checkpoint writer (no-op without one)."""
        if self._checkpointer is not None:
            self._checkpointer.wait()

    def priority_commit(self) -> int:
        """A commit that bypasses ``checkpoint_every``: whatever the
        interval, THIS commit reaches durable storage.  Uses :meth:`save`,
        not :meth:`commit`: the world is already changing, so the
        host-update check would raise mid-drain.  Returns the committed
        step; blocks until the writer has it durable."""
        every, self._checkpoint_every = self._checkpoint_every, 1
        try:
            self.save()
        finally:
            self._checkpoint_every = every
        self.wait()
        return self._commit_count

    def restore_from_checkpoint(self, step=None) -> bool:
        """Load the latest (or ``step``-th) durable commit into the model,
        the optimizer and the attributes: the cold-restart path when no
        surviving worker holds an in-memory commit.  The commit counter
        continues from the restored step.  Returns False when the
        checkpointer has nothing."""
        if self._checkpointer is None:
            return False
        t0 = time.perf_counter()
        if step is None:
            step = self._checkpointer._resolve_step()
            if step is None:
                return False
        saved = self._checkpointer.restore(step=step)
        self._snapshot = saved["tensors"] or None
        self._saved_state = saved["objects"]
        self._commit_count = int(step)
        from horovod_tpu_torch.elastic import worker as elastic_worker

        elastic_worker.report_step(self._commit_count)
        self.restore()
        from horovod_tpu_torch import telemetry

        if telemetry.enabled():
            committed = telemetry.value("hvd_elastic_steps_committed")
            telemetry.gauge("hvd_elastic_restore_seconds",
                            "durable-checkpoint restore latency").set(
                                time.perf_counter() - t0)
            telemetry.gauge("hvd_elastic_restored_step",
                            "step the state restored to").set(
                                self._commit_count)
            telemetry.gauge(
                "hvd_elastic_steps_lost",
                "committed-but-not-durable steps lost by the restore"
            ).set(max(int(committed) - self._commit_count, 0))
        return True

    def restore(self) -> None:
        self._restore_tensors()
        super().restore()

    def _broadcast_optimizer(self) -> None:
        """Rank 0's optimizer state on every rank: its layout (the
        tensors' shapes and dtypes, and every other value) as one object,
        then each tensor by a broadcast on the world's device (a joiner's
        optimizer holds no state yet; a pickled state of gigabytes would
        outlast the elastic timeout on rank 0)."""
        import torch.distributed as dist

        from horovod_tpu_torch.functions import broadcast_object
        from horovod_tpu_torch.runtime import state as rt

        st = rt.global_state()
        if st.size == 1:
            return
        live = dict(_tensor_paths(self.optimizer.state_dict()))
        layout = None
        if st.rank == 0:
            layout = (_with_tensors(self.optimizer.state_dict(),
                                    dict.fromkeys(live)),
                      {k: (tuple(t.shape), t.dtype, t.device.type)
                       for k, t in live.items()})
        skeleton, meta = broadcast_object(layout, root_rank=0)
        tensors = {}
        for k, (shape, dtype, kind) in meta.items():
            t = live[k].to(st.device) if st.rank == 0 else \
                torch.empty(shape, dtype=dtype, device=st.device)
            dist.broadcast(t, src=0)
            tensors[k] = t.cpu() if kind == "cpu" else t
        self.optimizer.load_state_dict(_with_tensors(skeleton, tensors))

    def sync(self) -> None:
        from horovod_tpu_torch.functions import broadcast_parameters

        if self.model is not None:
            broadcast_parameters(self.model.state_dict(), root_rank=0)
        if self.optimizer is not None:
            self._broadcast_optimizer()
        for attr in list(self._saved_state.keys()):
            setattr(self, attr, self._bcast_object(
                getattr(self, attr), root_rank=0,
                name=f"elastic.sync.{attr}"))
        self.save()


def run(func: Callable) -> Callable:
    """Elastic run decorator (reference ``run_fn``, ``elastic.py:147-168``)::

        @hvd.elastic.run
        def train(state, ...):
            ...

        train(state)

    Loop: notification init → ``state.sync()`` → ``func(state)``; on
    ``HorovodInternalError`` restore committed state, on
    ``HostsUpdatedInterrupt`` continue with live state; then ``reset()``
    (runtime re-init over the new world) and retry.
    """

    def wrapper(state: State, *args, **kwargs):
        global last_failure_t
        from horovod_tpu_torch.elastic.worker import \
            init_notification_manager

        notification_manager = init_notification_manager()
        if notification_manager is not None:
            notification_manager.register_listener(state)

        skip_sync = False
        try:
            while True:
                if not skip_sync:
                    state.sync()
                try:
                    return func(state, *args, **kwargs)
                except HorovodInternalError:
                    last_failure_t = time.time()
                    hvd_logging.warning(
                        "elastic: collective failure — restoring last "
                        "committed state and re-initializing")
                    # the dead world's groups are aborted first: a
                    # collective that a dead peer never joined may still
                    # hold the card, and the restore waits for the card
                    device = _abort_world()
                    state.restore()
                    skip_sync = False
                    _reset(device=device)
                except HostsUpdatedInterrupt as e:
                    hvd_logging.info(
                        "elastic: host set changed — re-initializing")
                    skip_sync = e.skip_sync
                    _reset()
                state.on_reset()
        finally:
            if notification_manager is not None:
                notification_manager.remove_listener(state)

    return wrapper


#: seconds of the last :func:`_reset`, teardown to the new world's init
last_reset_s: Optional[float] = None
#: wall-clock time (``time.time()``) at which :func:`run` last caught a
#: ``HorovodInternalError``: a dead peer's detection, in this rank
last_failure_t: Optional[float] = None


def _abort_world() -> Optional[str]:
    """After a peer failure: shut the runtime down with every process
    group of the dead world aborted (``runtime/state.shutdown(abort=
    True)``: NCCL's communicators are aborted, not waited on, so no
    collective a dead peer never joined is left holding the card and no
    group's watchdog outlives the world).  Returns the runtime's device
    type, for :func:`_reset`'s new world."""
    from horovod_tpu_torch.runtime import state as rt_state

    if not rt_state.is_initialized():
        return None
    device = rt_state.global_state().device.type
    rt_state.shutdown(abort=True)
    return device


def _reset(device: Optional[str] = None) -> None:
    """Tear down and re-initialize the runtime for a changed world.

    In order: the input pipelines close (their queues hold the old world's
    device batches); the runtime shuts down, destroying every process
    group the port made (the world, the host group, the layout groups,
    ``make_parallel_mesh``'s groups, and with them the eager plane's
    state and Bucketer, which live in the runtime state); under an
    elastic launcher the new assignment is fetched from the driver; the
    old generation's store is left; ``init()`` makes the new world on
    ``device`` (default: the old world's).  After a peer failure
    :func:`run` has aborted the old world already (:func:`_abort_world`),
    before it restored the state.  Objects that hold the old world's
    groups and bucket plans
    (``DistributedOptimizer``, ``DistributedTrainStep``, a
    ``ParallelMesh``) are rebuilt by the caller's reset callbacks.
    """
    global last_reset_s
    from horovod_tpu_torch import data as hvd_data
    from horovod_tpu_torch.elastic.worker import \
        refresh_assignment_from_driver
    from horovod_tpu_torch.runtime import distributed as hvd_dist
    from horovod_tpu_torch.runtime import state as rt_state

    t0 = time.perf_counter()
    n_closed = hvd_data.close_all_pipelines()
    if n_closed:
        hvd_logging.info(
            "elastic: closed %d input pipeline(s) for reset", n_closed)
    if rt_state.is_initialized():
        device = rt_state.global_state().device.type
    rt_state.shutdown()
    refresh_assignment_from_driver()
    hvd_dist.disconnect_elastic_client()
    rt_state.init(device=device)
    last_reset_s = time.perf_counter() - t0
    from horovod_tpu_torch import telemetry

    telemetry.gauge("hvd_elastic_reset_seconds",
                    "last elastic reset, teardown to the new world").set(
                        last_reset_s)
