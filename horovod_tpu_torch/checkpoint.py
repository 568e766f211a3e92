"""Checkpoints of the PyTorch port (``horovod_tpu/checkpoint.py``).

Horovod ships no checkpoint format; its recipe saves on rank 0 and restores
with a broadcast.  :class:`Checkpointer` writes one ``step_<N>/state.pt``
per step on rank 0 with ``torch.save``, and takes serialization off the
training clock:

**Async writer** (default): ``save()`` blocks only for the device→host
copy, the consistent cut (every tensor is copied synchronously into host
memory the snapshot owns, so the caller may overwrite its tensors as soon
as ``save()`` returns); pickling, fsync and retention run on one non-daemon
writer thread, which never reads a CUDA tensor.  ``wait()`` is the
barrier; ``save()`` calls it first, so at most one write is outstanding.
A writer error is sticky: every ``save()``/``wait()``/``close()`` re-raises
it until :meth:`Checkpointer.clear_error`.  ``async_save=False`` writes
before ``save()`` returns.

**Crash consistency**: a file is written to a ``.tmp`` name, fsynced, made
visible by an atomic ``os.replace`` and its directory entry fsynced, so a
crash mid-write leaves only ``.tmp`` files, which readers ignore.  The
oldest steps beyond ``max_to_keep`` are removed after the new one is
durable, except steps pinned by :meth:`Checkpointer.pin`.

**Sharded (ZeRO) state**: with ``shard_optimizer_states=True`` each rank
owns 1/N of the flat optimizer state, so :meth:`Checkpointer.save_sharded`
has every rank write ``step_<N>/shard_<r>_of_<n>.pt`` and
:meth:`Checkpointer.restore_sharded` rebuilds this rank's shard from a
checkpoint saved at any world size: the saved pieces concatenate into the
flat buffer, whose zero padding is trimmed or extended to the restoring
world's and sliced (:func:`_reshard_leaf`).  A plan stamped into the shards
(``plan=``) lets the data extent (dp×fsdp×sp) change and refuses a change
of pp/ep/tp.

The JAX package's orbax backend and its telemetry and fault-injection hooks
are not ported.

::

    ckpt = hvd.checkpoint.Checkpointer("checkpoints/run1")
    ckpt.save(step, {"model": model.state_dict(), "opt": opt.state_dict()})
    ckpt.wait()                                 # durable
    state = ckpt.restore()                      # every rank reads

    # shard_optimizer_states=True, on every rank:
    ckpt.save_sharded(step, opt.sharded_state_dict(), hvd.rank(), hvd.size())
    opt.load_sharded_state_dict(ckpt.restore_sharded(
        opt.sharded_state_template(), hvd.rank(), hvd.size()))
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from horovod_tpu_torch.runtime import state as _rt
from horovod_tpu_torch.runtime.retry import RetryPolicy

_log = logging.getLogger(__name__)


def _world() -> int:
    return _rt.global_state().size if _rt.is_initialized() else 1


def _rank() -> int:
    return _rt.global_state().rank if _rt.is_initialized() else 0


def _is_root() -> bool:
    return _rank() == 0


def _host_copy(obj: Any) -> Any:
    """The consistent cut: a synchronous copy of every tensor into host
    memory the snapshot owns (a numpy array becomes a CPU tensor), so the
    snapshot is immune to what the caller does after ``save()`` returns."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.array(obj, copy=True))
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _key(k) -> tuple:
    return (type(k).__name__, k)


def _flatten(tree: Any) -> list:
    """Leaves in a fixed order: dict keys sorted (as JAX's pytrees sort
    them), lists and tuples in order; ``None`` holds no leaf."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree, key=_key)
                for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _flatten(v)]
    return [] if tree is None else [tree]


def _unflatten(template: Any, leaves) -> Any:
    """``template``'s structure with its leaves taken from the iterator
    ``leaves`` in :func:`_flatten`'s order."""
    if isinstance(template, dict):
        vals = {k: _unflatten(template[k], leaves)
                for k in sorted(template, key=_key)}
        return {k: vals[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return None if template is None else next(leaves)


def _refuse_shards(tree: Any, call: str) -> None:
    """Raise when a tensor of ``tree`` holds this rank's shard of a wider
    parameter (a tensor-parallel slice or an FSDP placement,
    ``parallel.mesh.shard_of``): a rank-0 checkpoint would write rank 0's
    shard under the full parameter's name, and a broadcast restore would
    put rank 0's shard on every rank."""
    from horovod_tpu_torch.parallel.mesh import shard_of

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        elif isinstance(node, torch.Tensor):
            what = shard_of(node)
            if what is not None:
                raise ValueError(
                    f"Checkpointer.{call}: {'/'.join(path) or 'the state'} "
                    f"holds this rank's {what}, not the whole tensor, so "
                    f"rank 0 alone cannot stand for it; write every rank's "
                    f"shard with save_sharded(step, state, "
                    f"shard_rank=hvd.rank(), shard_count=hvd.size()) and "
                    f"read it back with restore_sharded, or save the full "
                    f"weights (parallel.fsdp.gather_params for an fsdp "
                    f"placement)")

    walk(tree, ())


def _atomic_save(path: str, payload: Any) -> None:
    """``torch.save`` to ``path`` durably: tmp file → fsync → atomic
    rename → fsync of the directory entry."""
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


#: The writer's retry for transient storage errors, at the JAX package's
#: default policy (``runtime/retry.py``): 5 tries, each sleep uniform in
#: ``[0, min(5, 0.1 · 2^attempt)]`` s (full jitter), 60 s in all.
IO_ATTEMPTS, IO_BASE_S, IO_MAX_S, IO_DEADLINE_S = 5, 0.1, 5.0, 60.0


def _io_policy(jitter: bool = True) -> RetryPolicy:
    return RetryPolicy(max_attempts=IO_ATTEMPTS, base_s=IO_BASE_S,
                       max_s=IO_MAX_S, deadline_s=IO_DEADLINE_S,
                       jitter=jitter, retry_on=(OSError,),
                       name="checkpoint-io", logger=_log)


def _io_backoff_cap(attempt: int) -> float:
    """The sleep cap before retry number ``attempt + 1`` (0-based)."""
    return _io_policy(jitter=False).backoff_s(attempt)


def _io_retry(fn, *args) -> Any:
    """``fn(*args)`` with an OSError retried under the policy above; any
    other error, a pickling error for one, surfaces at once."""
    return _io_policy().call(fn, *args)


def _load(path: str, map_location=None) -> Any:
    return torch.load(path, map_location=map_location, weights_only=True)


class Checkpointer:
    """Directory-per-step checkpoints with an async writer thread.

    Replicated state is written by rank 0 (:meth:`save`); sharded state by
    every rank (:meth:`save_sharded`).  ``last_stall_s`` is the training
    loop's blocking time of the last save (the host copy) and
    ``last_write_s`` the duration of its write, pickle to fsync."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = True):
        self._dir = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        self._async = async_save
        self._writer: Optional[threading.Thread] = None
        # the writer thread sets the error; wait()/clear_error() consume it
        self._error_lock = threading.Lock()
        self._writer_error: Optional[BaseException] = None
        # steps exempt from retention: written by the caller, read by the
        # writer thread's _gc()
        self._pin_lock = threading.Lock()
        self._pins: set = set()
        self.last_stall_s: Optional[float] = None
        self.last_write_s: Optional[float] = None
        os.makedirs(self._dir, exist_ok=True)

    # -- the writer ------------------------------------------------------

    def wait(self) -> None:
        """Block until the pending write (if any) is durable; re-raise the
        sticky writer error until :meth:`clear_error` acknowledges it."""
        w = self._writer
        if w is not None:
            w.join()
            self._writer = None
        with self._error_lock:
            err = self._writer_error
        if err is not None:
            raise err

    def clear_error(self) -> Optional[BaseException]:
        """Acknowledge (and return) the sticky writer error, unblocking
        further saves."""
        with self._error_lock:
            err, self._writer_error = self._writer_error, None
        return err

    def close(self) -> None:
        """The final barrier: join the pending write and surface its
        error."""
        self.wait()

    def _dispatch(self, fn) -> None:
        """Run ``fn`` on the writer thread (async) or inline (sync)."""

        def run():
            t0 = time.perf_counter()
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 - surfaced at wait()
                with self._error_lock:
                    self._writer_error = e
            finally:
                self.last_write_s = time.perf_counter() - t0

        if not self._async:
            run()
            # raised here, so consumed rather than left sticky
            err = self.clear_error()
            if err is not None:
                raise err
            return
        # non-daemon: a process exiting right after save() joins the
        # writer at interpreter shutdown instead of truncating the write
        self._writer = threading.Thread(target=run, daemon=False,
                                        name="hvd_torch_ckpt_writer")
        self._writer.start()

    def _snapshot(self, state: Any) -> Any:
        self.wait()                       # one outstanding write, ever
        t0 = time.perf_counter()
        host_state = _host_copy(state)    # the consistent cut
        self.last_stall_s = time.perf_counter() - t0
        return host_state

    # -- write -------------------------------------------------------------

    def save(self, step: int, state: Any) -> bool:
        """Write ``state`` (tensors, numbers, strings and dicts, lists or
        tuples of them) for ``step`` on rank 0; a no-op elsewhere.  Returns
        whether this rank wrote.  A state that holds a rank's shard of a
        tensor-parallel or FSDP-placed parameter raises, on every rank."""
        _refuse_shards(state, "save")
        if not _is_root():
            return False
        host_state = self._snapshot(state)

        def write():
            path = os.path.join(self._dir, f"step_{int(step)}")
            os.makedirs(path, exist_ok=True)
            _io_retry(_atomic_save, os.path.join(path, "state.pt"),
                      host_state)
            self._gc()
            _log.info("checkpoint: saved step %d to %s", step, self._dir)

        self._dispatch(write)
        return True

    def save_sharded(self, step: int, shard_state: Any, shard_rank: int,
                     shard_count: int, plan: Any = None) -> bool:
        """Write this rank's shard of a sharded (ZeRO) state: every rank
        calls it with its own ``shard_state`` (for the port's
        ``shard_optimizer_states=True``,
        ``optimizer.sharded_state_dict()``: flat ``(shard,)`` leaves keyed
        by fusion group).  The same async contract as :meth:`save`; the
        step is complete once all ``shard_count`` files exist.  ``plan``
        (a ``ShardingPlan`` or its grammar string) is stamped into the
        shard for :meth:`restore_sharded`'s check; its dp×fsdp×sp must be
        ``shard_count``."""
        if not 0 <= shard_rank < shard_count:
            raise ValueError(
                f"shard_rank {shard_rank} out of range for "
                f"shard_count {shard_count}")
        plan_str = _canonical_plan(plan, shard_count)
        host_state = self._snapshot(shard_state)

        def write():
            path = os.path.join(self._dir, f"step_{int(step)}")
            os.makedirs(path, exist_ok=True)
            payload = {"shard_rank": shard_rank, "shard_count": shard_count,
                       "state": host_state}
            if plan_str is not None:
                payload["plan"] = plan_str
            _io_retry(
                _atomic_save,
                os.path.join(path, _shard_name(shard_rank, shard_count)),
                payload)
            _log.info("checkpoint: saved shard %d/%d of step %d to %s",
                      shard_rank, shard_count, step, self._dir)

        self._dispatch(write)
        return True

    def pin(self, step: int) -> None:
        """Exempt ``step`` from retention until :meth:`unpin`."""
        with self._pin_lock:
            self._pins.add(int(step))

    def unpin(self, step: int) -> None:
        """Release a :meth:`pin`; the step rejoins retention at the next
        save."""
        with self._pin_lock:
            self._pins.discard(int(step))

    def pinned_steps(self) -> list:
        with self._pin_lock:
            return sorted(self._pins)

    def _gc(self) -> None:
        with self._pin_lock:
            pins = set(self._pins)
        for s in sorted(self._steps())[:-self._max_to_keep]:
            if s not in pins:
                shutil.rmtree(os.path.join(self._dir, f"step_{s}"),
                              ignore_errors=True)

    # -- read --------------------------------------------------------------

    def _steps(self) -> list:
        """Steps with at least one finished payload file (``state.pt`` or a
        shard); ``.tmp`` files do not count."""
        out = []
        for d in os.listdir(self._dir):
            if not (d.startswith("step_") and d[5:].isdigit()):
                continue
            try:
                names = os.listdir(os.path.join(self._dir, d))
            except NotADirectoryError:
                continue
            if any(n.endswith(".pt") and not n.startswith(".tmp")
                   for n in names):
                out.append(int(d[5:]))
        return out

    def all_steps(self) -> list:
        """Steps on disk in either layout, ascending; waits for this
        process's pending write first (read-your-writes)."""
        self.wait()
        if not os.path.isdir(self._dir):
            return []
        return sorted(self._steps())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None,
                map_location=None) -> Any:
        """Load ``step`` (default: the latest, agreed across ranks) on this
        rank; tensors land on ``map_location`` (default: the CPU, where
        they were saved from).  Use :meth:`restore_and_broadcast` to read
        once and broadcast."""
        self.wait()
        if step is None:
            step = self._resolve_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self._dir}")
        step_dir = os.path.join(self._dir, f"step_{int(step)}")
        path = os.path.join(step_dir, "state.pt")
        if os.path.exists(path):
            return _load(path, map_location)
        if os.path.isdir(step_dir) and any(
                n.startswith("shard_") and n.endswith(".pt")
                for n in os.listdir(step_dir)):
            raise ValueError(
                f"step {step} in {self._dir} was written by "
                f"save_sharded() (per-rank shard files, no replicated "
                f"state.pt) — use restore_sharded(target, shard_rank, "
                f"shard_count) to read it")
        raise FileNotFoundError(
            f"no checkpoint for step {step} in {self._dir} "
            f"(available: {self.all_steps()})")

    def saved_plan(self, step: Optional[int] = None) -> Optional[str]:
        """The plan stamped into ``step``'s sharded checkpoint, or None
        when the step holds no shard files or an unstamped one."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        try:
            shards = _load_shards(os.path.join(self._dir, f"step_{step}"))
        except (FileNotFoundError, ValueError):
            return None
        return shards[0].get("plan")

    def restore_sharded(self, target: Any, shard_rank: int, shard_count: int,
                        step: Optional[int] = None, plan: Any = None) -> Any:
        """This rank's shard of a sharded state saved at any world size, in
        ``target``'s structure (CPU tensors).  ``target``'s 1-D leaves size
        the restoring world's shards (``sharded_state_template()``); scalar
        leaves, such as AdamW's ``step``, take the saving rank 0's value.
        With ``plan`` (the restoring run's) and a stamped checkpoint, the
        pp/ep/tp extents must match; the data extent may change."""
        self.wait()
        if step is None:
            step = self._resolve_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self._dir}")
        path = os.path.join(self._dir, f"step_{step}")
        shards = _load_shards(path)
        plan_str = _canonical_plan(plan, shard_count)
        saved_plan = shards[0].get("plan")
        if saved_plan is not None and plan_str is not None:
            _check_plan_reshard(saved_plan, plan_str, path)
        t_leaves = _flatten(target)
        shard_leaves = [_flatten(s["state"]) for s in shards]
        if any(len(sl) != len(t_leaves) for sl in shard_leaves):
            raise ValueError(
                f"sharded checkpoint at {path} has a different tree "
                f"structure than the restore target")
        out = [_reshard_leaf(t, [sl[i] for sl in shard_leaves], shard_rank,
                             shard_count)
               for i, t in enumerate(t_leaves)]
        return _unflatten(target, iter(out))

    def _resolve_step(self) -> Optional[int]:
        """The latest step, agreed across ranks: collective when the world
        is larger than one (every rank calls it), root's listing broadcast
        through the eager ``broadcast``, because per-rank listings can lag
        on shared filesystems."""
        if _world() == 1:
            return self.latest_step()
        from horovod_tpu_torch.ops import eager

        mine = self.latest_step() if _is_root() else None
        step = int(eager.broadcast(
            torch.tensor([-1 if mine is None else mine], dtype=torch.int64),
            root_rank=0, name="ckpt_latest_step")[0])
        return None if step < 0 else step

    def restore_and_broadcast(self, target: Any, step: Optional[int] = None,
                              root_rank: int = 0) -> Any:
        """``root_rank`` reads the checkpoint into ``target`` (tensors
        copied in place; numbers and strings replaced) and every rank
        receives it: tensors through ``broadcast_variables``, the rest
        pickled.  Collective at a world above one; returns ``target``'s
        structure with the checkpoint's values.  A target that holds a
        rank's shard of a tensor-parallel or FSDP-placed parameter raises,
        on every rank."""
        from horovod_tpu_torch import functions as F

        _refuse_shards(target, "restore_and_broadcast")

        if _world() == 1:
            return _fill(target, self.restore(step))
        # resolved on every rank: restore() below runs on the root alone
        if step is None:
            step = self._resolve_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self._dir}")
        root = _rank() == root_rank
        state = _fill(target, self.restore(step)) if root else target
        F.broadcast_variables(state, root_rank=root_rank,
                              name="checkpoint_restore")
        leaves = _flatten(state)
        rest = F.broadcast_object(
            [None if isinstance(v, torch.Tensor) else v for v in leaves]
            if root else None, root_rank=root_rank)
        return _unflatten(state, iter(
            v if isinstance(v, torch.Tensor) else r
            for v, r in zip(leaves, rest)))


def _fill(target: Any, loaded: Any) -> Any:
    """``loaded``'s values in ``target``'s structure: each tensor of
    ``target`` is overwritten in place, every other leaf replaced."""
    if isinstance(target, torch.Tensor):
        if not isinstance(loaded, torch.Tensor) or \
                loaded.shape != target.shape:
            raise ValueError(
                f"checkpoint leaf {getattr(loaded, 'shape', loaded)!r} "
                f"does not fit the target's tensor of shape "
                f"{tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(loaded)
        return target
    if isinstance(target, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(target):
            raise ValueError("the checkpoint's keys differ from the "
                             "target's")
        return {k: _fill(v, loaded[k]) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if not isinstance(loaded, (list, tuple)) or \
                len(loaded) != len(target):
            raise ValueError("the checkpoint's sequence differs from the "
                             "target's")
        return type(target)(_fill(t, v) for t, v in zip(target, loaded))
    return loaded


def _shard_name(rank: int, count: int) -> str:
    return f"shard_{rank}_of_{count}.pt"


def _canonical_plan(plan: Any, shard_count: int) -> Optional[str]:
    """Canonical plan string for shard payloads, validated against the
    exchange width: the sharded state spreads over the plan's dp×fsdp×sp
    ranks (sp shards activations, not parameters)."""
    if plan is None:
        return None
    from horovod_tpu_torch.parallel.plan import as_plan

    p = as_plan(plan)
    if p.dp is not None:
        data_extent = p.dp * p.fsdp * p.sp
        if data_extent != shard_count:
            raise ValueError(
                f"plan {p.to_string()} shards the exchange over "
                f"dp*fsdp*sp={data_extent} ranks, but shard_count is "
                f"{shard_count}")
    return p.to_string(allow_unresolved=True)


def _check_plan_reshard(saved: str, restoring: str, path: str) -> None:
    """Refuse a restore that changes the model-parallel factorization:
    pp/ep/tp reshape the parameter tensors themselves, which the flat
    reshard cannot follow; dp/fsdp/sp changes reshard like a world-size
    change."""
    from horovod_tpu_torch.parallel.plan import ShardingPlan

    sp = ShardingPlan.from_string(saved.replace("dp=?", "dp=1")
                                  if "dp=?" in saved else saved)
    rp = ShardingPlan.from_string(restoring.replace("dp=?", "dp=1")
                                  if "dp=?" in restoring else restoring)
    mismatch = [ax for ax in ("pp", "ep", "tp")
                if getattr(sp, ax) != getattr(rp, ax)]
    if mismatch:
        raise ValueError(
            f"sharded checkpoint in {path} was saved under plan "
            f"{saved!r} but the restore runs plan {restoring!r}: "
            f"model-parallel extents differ on {mismatch} — resharding "
            f"only covers data-extent (dp/fsdp/sp) changes; "
            f"re-partition the model to change pp/ep/tp")


def _load_shards(path: str) -> list:
    """Every shard payload of one step, by shard rank; refuses a set that
    is incomplete or mixes world sizes."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint directory {path}")
    names = [n for n in os.listdir(path)
             if n.startswith("shard_") and n.endswith(".pt")]
    if not names:
        raise FileNotFoundError(f"no shard files in {path}")
    payloads = [_load(os.path.join(path, n)) for n in sorted(names)]
    counts = {p["shard_count"] for p in payloads}
    if len(counts) != 1:
        raise ValueError(
            f"mixed shard_count values {sorted(counts)} in {path} — "
            f"partial overwrite from two world sizes?")
    count = counts.pop()
    ranks = sorted(p["shard_rank"] for p in payloads)
    if ranks != list(range(count)):
        missing = sorted(set(range(count)) - set(ranks))
        raise FileNotFoundError(
            f"incomplete sharded checkpoint in {path}: missing shard(s) "
            f"{missing} of {count}")
    payloads.sort(key=lambda p: p["shard_rank"])
    return payloads


def _reshard_leaf(target, saved: list, shard_rank: int, shard_count: int):
    """One leaf's reshard: concatenate the saved per-rank pieces, trim the
    zero padding (refusing a non-zero tail) or pad with zeros to the
    restoring world's padded length, and slice this rank's piece."""
    if not hasattr(target, "shape") or len(target.shape) == 0:
        # a replicated scalar (AdamW's step): the saving rank 0's value
        return saved[0]
    t_shape = tuple(target.shape)
    s0 = saved[0]
    if tuple(s0.shape) == t_shape and len(saved) == shard_count:
        # same world size: this rank's own shard, no reassembly
        return saved[shard_rank]
    if s0.dim() != 1 or len(t_shape) != 1:
        raise ValueError(
            f"cannot re-shard a non-flat leaf of shape {tuple(s0.shape)} to "
            f"{t_shape}: sharded state leaves are 1-D fusion-buffer "
            f"slices (shard_optimizer_states contract)")
    full = torch.cat(list(saved))
    new_padded = t_shape[0] * shard_count
    if new_padded < full.shape[0]:
        # the fusion spec pads with zeros and padded gradient tails are
        # zero, so state tails are zero: trimming drops only padding
        if bool((full[new_padded:] != 0).any()):
            raise ValueError(
                "re-shard would trim non-zero state: the restore "
                f"target's padded length {new_padded} is shorter than "
                f"the saved buffer {full.shape[0]} and the excess is "
                "not fusion padding")
        full = full[:new_padded]
    elif new_padded > full.shape[0]:
        full = torch.cat([full, full.new_zeros(new_padded - full.shape[0])])
    shard = full.shape[0] // shard_count
    return full[shard_rank * shard:(shard_rank + 1) * shard].clone()
