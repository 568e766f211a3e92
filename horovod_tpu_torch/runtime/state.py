"""Process-wide runtime state of the PyTorch port.

Counterpart of ``horovod_tpu/runtime/state.py``.  The process model is
Horovod's own: one process per GPU, so ``rank``/``size`` are the process
rank and world size, and ``local_rank`` picks the process's card.  The
launcher's environment contract is the JAX package's
(``HOROVOD_RANK``/``HOROVOD_SIZE``/``HOROVOD_COORDINATOR_ADDR``, plus
``HOROVOD_LOCAL_*``/``HOROVOD_CROSS_*``; under ``mpirun`` or ``jsrun`` the
rank and local extent come from their PMIx/OpenMPI/MPICH variables,
``Config.from_env``); without it the world is this one process.  Collectives run on a ``torch.distributed`` process group: NCCL
for the card, gloo for the CPU.  Beside it every rank holds a gloo group
over the same ranks, ``host_group``: the eager plane's negotiation and its
host data plane run there, so they never wait on the card.

A process group that the caller made before ``init()`` (``torchrun``, or
``init_process_group`` by hand) gives ``rank``/``size``; the local extent
then comes from ``HOROVOD_LOCAL_*``, else torchrun's
``LOCAL_RANK``/``LOCAL_WORLD_SIZE``, else the hostnames gathered over the
group, and ``cross_*`` follow, so that local × cross = size on a
homogeneous world, as the JAX package derives them from its devices.  The
card, ``cuda:<local_rank>``, is chosen only after that.

The world's layout, ``(cross, local)`` in row-major order as the JAX
package's ``(dcn, ici)`` mesh, has a process group per level
(:meth:`GlobalState.layout_group`): ``"local"``, the ranks of one node,
and ``"cross"``, the ranks of one local index across the nodes.  They are
made at their first use, by every rank, and kept until ``shutdown()``.
"""

from __future__ import annotations

import atexit
import os
import socket
import threading
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch.runtime.config import Config
from horovod_tpu_torch.utils import logging as hvd_logging


#: the layout's levels, innermost first (JAX ``AXIS_ICI``, ``AXIS_DCN``)
LOCAL = "local"
CROSS = "cross"
LAYOUT_LEVELS = (LOCAL, CROSS)


class NotInitializedError(RuntimeError):
    def __init__(self):
        super().__init__(
            "horovod_tpu_torch has not been initialized; call "
            "horovod_tpu_torch.init() first.")


class GlobalState:
    """The process singleton that ``init()`` creates and ``shutdown()``
    destroys (reference ``HorovodGlobalState``)."""

    def __init__(self, config: Config, device: torch.device):
        self.config = config
        self.device = device
        self.rank = 0
        self.size = 1
        self.local_rank = 0
        self.local_size = 1
        self.cross_rank = 0
        self.cross_size = 1
        # every host drives the same number of ranks (reference
        # horovod_is_homogeneous); gathered with the hostnames
        self.is_homogeneous = True
        self.owns_group = False
        # the host plane's gloo group: the world itself when it is gloo
        self.host_group = None
        # hits and misses of the in-memory caches: the eager negotiation
        # cache (reference response-cache statistics) and the captured
        # graphs (runtime/compile_cache.py ExecutableLRU); the disk store's
        # loads against builds, this process's so far, beside them
        self.cache_stats = {"hits": 0, "misses": 0,
                            "aot_disk_hits": 0, "aot_disk_misses": 0}
        # the store's root resolved at initialize() (None = disabled)
        self.compile_cache_dir = None
        # the eager plane's per-world state (ops/eager.py): its handles,
        # negotiation caches and cycle counter, and its Bucketer
        self.eager = None
        # this rank's group of each layout level, made at first use
        self._layout: Optional[Dict[str, Optional[dist.ProcessGroup]]] = None
        # this rank's group along each axis of every named layout made in
        # this world, by (extents, names): the layout levels' among them
        self._trees: Dict[Tuple[Tuple[int, ...], Tuple[str, ...]],
                          Dict[str, Optional[dist.ProcessGroup]]] = {}
        # the process groups' timeout: torch's default, or an elastic
        # world's short one (runtime/distributed.py); device_timeout is
        # that of the groups on the world's backend (an elastic NCCL
        # world's backstop, longer than the host's deadline)
        self.timeout = None
        self.device_timeout = None
        # the runtime tools (JAX runtime/state.py:182-204): the telemetry
        # exporters, the timeline, the stall inspector, the parameter
        # manager; and the timeline aggregation's per-world key counter
        self.telemetry = None
        self.timeline = None
        self.stall_inspector = None
        self.parameter_manager = None
        self.aggregate_seq = 0

    def initialize(self) -> None:
        cfg = self.config
        if cfg.fault_plan:
            # the chaos layer first, live before any instrumented
            # subsystem starts (JAX runtime/state.py)
            from horovod_tpu_torch import faults

            faults.load_env_plan(config=cfg)
        if dist.is_initialized():
            # a process group the caller made: its identity first, then
            # the local extent, and only then the card
            self.rank, self.size = dist.get_rank(), dist.get_world_size()
            self._make_host_group()
            self._identity_from_group(self._gather(self._local_env()))
            _apply_affinity(self.local_rank)
            self._set_device()
        else:
            self.rank = cfg.rank or 0
            self.size = cfg.size or 1
            self.local_size = cfg.local_size or self.size
            self.local_rank = cfg.local_rank if cfg.local_rank is not None \
                else self.rank % self.local_size
            self.cross_size = cfg.cross_size if cfg.cross_size is not None \
                else max(self.size // self.local_size, 1)
            self.cross_rank = cfg.cross_rank if cfg.cross_rank is not None \
                else self.rank // self.local_size
            if not 0 <= self.rank < self.size:
                raise ValueError(f"HOROVOD_RANK {self.rank} is outside a "
                                 f"world of {self.size}")
            # before the card and the process group: the mask is
            # inherited only by the threads made after it
            _apply_affinity(self.local_rank)
            self._set_device()
            if self.size > 1 and not cfg.coordinator_addr:
                raise ValueError("HOROVOD_SIZE > 1 needs "
                                 "HOROVOD_COORDINATOR_ADDR (host:port of "
                                 "rank 0)")
            backend = "nccl" if self.device.type == "cuda" else "gloo"
            if self.size > 1 and cfg.elastic_enabled:
                self._init_elastic_group(backend)
            elif self.size > 1:
                dist.init_process_group(
                    backend, init_method=f"tcp://{cfg.coordinator_addr}",
                    world_size=self.size, rank=self.rank)
            else:
                # a world of one rendezvouses with nobody: an in-memory
                # store, so that no free port is picked and then taken by
                # another socket before the store binds it (EADDRINUSE),
                # even where a launcher gave one (hvdrun -np 1)
                dist.init_process_group(backend, store=dist.HashStore(),
                                        world_size=1, rank=0)
            self.owns_group = True
            self._make_host_group()
            # a gather over the host group: every rank has joined
            sizes = [n for _, _, n in self._gather(
                (self.local_rank, self.local_size))]
            self.is_homogeneous = len(set(sizes)) == 1
            if self.size > 1 and cfg.elastic_enabled:
                from horovod_tpu_torch.runtime import distributed as hvd_dist

                self.timeout, self.device_timeout = \
                    hvd_dist.shorten_timeouts(dist.group.WORLD,
                                              self.host_group)
        self._start_tools()

    def _start_tools(self) -> None:
        """The compile cache's store, then the telemetry plane (the
        timeline renders its gauges and the stall inspector counts through
        it), then the timeline, the stall inspector and the parameter
        manager, as the config asks."""
        cfg = self.config
        from horovod_tpu_torch.runtime import compile_cache

        self.cache_stats.update(compile_cache.stats())
        if cfg.compile_cache_enabled:
            self.compile_cache_dir = \
                compile_cache.enable_persistent_cache(config=cfg)
            if self.compile_cache_dir:
                n = compile_cache.entry_count(self.compile_cache_dir)
                hvd_logging.info(
                    "compile cache: %s (%d entr%s)", self.compile_cache_dir,
                    n, "y" if n == 1 else "ies")
        from horovod_tpu_torch import telemetry

        self.telemetry = telemetry.start_from_config(cfg,
                                                     process_rank=self.rank)
        if cfg.timeline_filename:
            from horovod_tpu_torch.utils.timeline import make_timeline

            self.timeline = make_timeline(cfg.timeline_filename,
                                          cfg.timeline_mark_cycles,
                                          rank=self.rank)
        if cfg.stall_check_enabled:
            from horovod_tpu_torch.utils.stall import StallInspector

            self.stall_inspector = StallInspector(
                warning_time_s=cfg.stall_warning_time_seconds,
                shutdown_time_s=cfg.stall_shutdown_time_seconds)
        if cfg.autotune:
            from horovod_tpu_torch.utils.autotune import ParameterManager

            self.parameter_manager = ParameterManager(
                cfg, log_path=cfg.autotune_log)

    def _init_elastic_group(self, backend: str) -> None:
        """The world's process group of an elastic generation: on the
        driver's store (``runtime/distributed.py``), so that no rank's
        death takes the rendezvous down, under the rendezvous's long
        timeout (``initialize`` then shortens it, so that a collective
        with a dead peer raises in the caller).  On NCCL the watchdog
        aborts the communicator and leaves the process up
        (``TORCH_NCCL_ASYNC_ERROR_HANDLING=2``, "clean up only", which
        this sets: the other modes tear the process down or never abort)."""
        from horovod_tpu_torch.runtime import distributed as hvd_dist

        store = hvd_dist.client_store()
        if store is None:
            store = hvd_dist.connect_elastic_client(
                self.config.coordinator_addr, self.size, self.rank)
        if backend == "nccl":
            # set, not defaulted: a launcher's or an image's other mode
            # either tears the survivor down or never aborts the collective
            os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = "2"
        # the rendezvous waits for the joiners' start; the collectives
        # get the short timeout once every rank is in (initialize)
        self.timeout = hvd_dist.start_timeout()
        dist.init_process_group(backend, store=store, world_size=self.size,
                                rank=self.rank, timeout=self.timeout)

    def _make_host_group(self) -> None:
        # collective: every rank creates it here, in the same order
        self.host_group = dist.group.WORLD if dist.get_backend() == "gloo" \
            else dist.new_group(backend="gloo", timeout=self.timeout)

    def _local_env(self) -> tuple:
        """This rank's (local rank, local size) from ``HOROVOD_LOCAL_*``,
        else torchrun's ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``; (None, None)
        when neither gives the extent."""
        cfg = self.config
        if cfg.local_size is not None:
            return cfg.local_rank, cfg.local_size
        v = os.environ.get("LOCAL_WORLD_SIZE")
        if v in (None, ""):
            return None, None
        r = os.environ.get("LOCAL_RANK")
        return (int(r) if r not in (None, "") else None), int(v)

    def _gather(self, local: tuple) -> list:
        """(hostname, *local) of every rank, in rank order, over the host
        group."""
        mine = (socket.gethostname(),) + tuple(local)
        if self.size == 1:
            return [mine]
        out = [None] * self.size
        dist.all_gather_object(out, mine, group=self.host_group)
        return out

    def _identity_from_group(self, hosts: list) -> None:
        """``local_*``/``cross_*`` of this rank from the gathered
        ``(hostname, local rank, local size)`` of every rank."""
        cfg = self.config
        _, env_rank, env_size = hosts[self.rank]
        order = list(dict.fromkeys(h for h, _, _ in hosts))
        peers = [r for r, (h, _, _) in enumerate(hosts)
                 if h == hosts[self.rank][0]]
        if env_size is not None:
            # the launcher's local extent: blocks of local_size ranks
            self.local_size = env_size
            self.local_rank = env_rank if env_rank is not None \
                else self.rank % env_size
            self.cross_size = max(self.size // env_size, 1)
            self.cross_rank = self.rank // env_size
            sizes = [n for _, _, n in hosts]
        else:
            # the ranks that share this host, in rank order
            self.local_size = len(peers)
            self.local_rank = peers.index(self.rank)
            self.cross_size = len(order)
            self.cross_rank = order.index(hosts[self.rank][0])
            sizes = [sum(1 for x, _, _ in hosts if x == h) for h in order]
        if cfg.cross_rank is not None:
            self.cross_rank = cfg.cross_rank
        if cfg.cross_size is not None:
            self.cross_size = cfg.cross_size
        self.is_homogeneous = len(set(sizes)) == 1

    def layout_group(self, level: str) -> Optional[dist.ProcessGroup]:
        """This rank's process group of layout level ``level``:
        ``"local"`` (the ranks that share its ``cross_rank``, ordered by
        ``local_rank``) or ``"cross"`` (the ranks that share its
        ``local_rank``, ordered by ``cross_rank``).  ``None`` at extent 1,
        ``dist.group.WORLD`` when the level spans the world.

        The first call makes every group of both levels, as
        :meth:`tree_groups` makes those of the layout ``(cross, local)``,
        so every rank must make it, at the same point of its program (the
        collectives that need a level do).  It gathers each rank's ``(cross_rank,
        local_rank)`` and raises ``ValueError`` on every rank alike unless
        the world is the row-major grid ``rank = cross_rank *
        local_size + local_rank``, the order of the JAX package's mesh."""
        if level not in LAYOUT_LEVELS:
            raise ValueError(f"layout level must be one of {LAYOUT_LEVELS}, "
                             f"got {level!r}")
        if self._layout is None:
            self._layout = self._make_layout()
        return self._layout[level]

    def _make_layout(self) -> Dict[str, Optional[dist.ProcessGroup]]:
        n_cross, n_local = self.cross_size, self.local_size
        ids = [(c, l) for _, c, l in self._gather((self.cross_rank,
                                                   self.local_rank))]
        grid = [(r // n_local, r % n_local) for r in range(self.size)]
        if n_cross * n_local != self.size or ids != grid:
            raise ValueError(
                f"the world of {self.size} is not laid out as {n_cross} "
                f"nodes of {n_local} ranks in rank order (rank = "
                f"cross_rank * local_size + local_rank); (cross_rank, "
                f"local_rank) by rank: {ids}")
        return self.tree_groups((n_cross, n_local), (CROSS, LOCAL))

    def tree_groups(self, shape: Tuple[int, ...], names: Tuple[str, ...]
                    ) -> Dict[str, Optional[dist.ProcessGroup]]:
        """This rank's process group along each axis of the world laid out
        over ``names`` with extents ``shape``, outermost first, in rank
        order (``runtime/topology.TreeLayout``; the layout levels are
        ``(cross, local)``'s): ``None`` at extent 1, ``dist.group.WORLD``
        when the axis spans the world.  The first call for a layout in
        this world makes its groups (``parallel/mesh.line_groups``), the
        innermost axis first as the exchange runs its levels (the layout
        levels local, then cross), so every rank must make it together;
        later calls, and equal layouts, share them, and :meth:`shutdown`
        releases them."""
        from horovod_tpu_torch.parallel.mesh import line_groups

        key = (tuple(shape), tuple(names))
        if key not in self._trees:
            self._trees[key] = line_groups(
                dict(zip(names, shape)), names[::-1], self.rank,
                self.group_timeout(), order=names)
        return self._trees[key]

    def group_timeout(self):
        """The timeout of a group made on the world's backend (None:
        torch's default)."""
        return self.device_timeout or self.timeout

    def _set_device(self) -> None:
        if self.device.type == "cuda":
            self.device = torch.device("cuda", self.local_rank)
            torch.cuda.set_device(self.device)

    def close_timeline(self, aggregate: bool = True) -> None:
        """Close the timeline; with ``aggregate`` (every rank calls it at
        the same point) rank 0 then merges every rank's file into its own
        (``utils/timeline.aggregate_after_close``)."""
        tl, self.timeline = self.timeline, None
        if tl is None:
            return
        tl.close()
        if aggregate and dist.is_initialized():
            from horovod_tpu_torch.utils.timeline import aggregate_after_close

            aggregate_after_close(tl.filename, tl.wall_origin_us)

    def _stop_tools(self, abort: bool) -> None:
        # an aborted world merges no timeline: its dead ranks upload
        # nothing, and rank 0 would wait out the aggregation's deadline
        self.close_timeline(aggregate=not abort)
        if self.stall_inspector is not None:
            self.stall_inspector.stop()
            self.stall_inspector = None
        self.parameter_manager = None
        if self.telemetry is not None:
            # final JSONL snapshot and endpoint teardown; the registry
            # itself lives on (elastic resets re-init around it)
            self.telemetry.shutdown()
            self.telemetry = None

    def shutdown(self, abort: bool = False) -> None:
        self._stop_tools(abort)
        if dist.is_initialized():
            if self.owns_group and abort and dist.get_backend() == "nccl":
                # a peer died: abort the communicators rather than wait on
                # the collectives that will never complete
                _abort_or_destroy()
            elif self.owns_group:
                dist.destroy_process_group()
            else:
                made = [self.host_group] + [
                    g for groups in self._trees.values()
                    for g in groups.values()]
                for group in made:
                    if group not in (None, dist.group.WORLD):
                        dist.destroy_process_group(group)
        self.owns_group = False
        self.host_group = None
        self._layout = None
        self._trees = {}


def _apply_affinity(local_rank: int) -> None:
    """``HOROVOD_THREAD_AFFINITY``'s set of ``local_rank``, applied to this
    process (``utils/affinity.py``; JAX ``runtime/state.py``)."""
    from horovod_tpu_torch.utils import affinity

    affinity.set_affinity_from_env(local_rank)


def _abort_or_destroy() -> None:
    """Abort every process group (torch's ``_abort_process_group``, where
    this torch has it and every backend takes it), else destroy them."""
    import logging

    from torch.distributed import distributed_c10d as c10d

    try:
        c10d._abort_process_group()
    except (AttributeError, RuntimeError, NotImplementedError) as e:
        logging.getLogger(__name__).warning(
            "aborting the process groups failed (%s); destroying them", e)
        if dist.is_initialized():
            dist.destroy_process_group()


_state: Optional[GlobalState] = None
_state_lock = threading.Lock()
#: how many worlds init() has made in this process: an object built in one
#: holds its groups, and must not run in the next (elastic resets)
_worlds = 0


@atexit.register
def _shutdown_at_exit() -> None:
    shutdown()


def _resolve_device(device) -> torch.device:
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "horovod_tpu_torch runs on CUDA and no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def init(device=None, config: Optional[Config] = None) -> GlobalState:
    """Create (or return) the singleton; idempotent like ``horovod_init``.
    ``device`` defaults to the card; ``"cpu"`` runs the plain versions of
    the kernels over a gloo group."""
    global _state
    with _state_lock:
        if _state is not None:
            return _state
        global _worlds
        st = GlobalState(config or Config.from_env(), _resolve_device(device))
        st.initialize()
        _state = st
        _worlds += 1
        return st


def shutdown(abort: bool = False) -> None:
    """Destroy the world's process groups (``abort``: abort the NCCL
    communicators instead, after a peer died)."""
    global _state
    with _state_lock:
        if _state is not None:
            _state.shutdown(abort)
            _state = None


def is_initialized() -> bool:
    return _state is not None


def world_id() -> Optional[int]:
    """The number of the current world (None before ``init()``): an
    elastic reset's ``init()`` makes a new one."""
    return _worlds if _state is not None else None


def check_world(built: Optional[int], what: str) -> int:
    """Raise when ``built``, the :func:`world_id` an object took when it
    was built, is an earlier world's: its process groups and plans are
    gone (an elastic reset), and its collectives would hang.  Returns
    the current world's number (``built`` None: the object was built
    before ``init()`` and takes this world)."""
    now = world_id()
    if built is not None and now != built:
        raise RuntimeError(
            f"{what} was built for an earlier world (before an elastic "
            f"reset): its process groups are gone; build it again, in "
            f"the elastic state's on_reset callback")
    return now


def global_state() -> GlobalState:
    if _state is None:
        raise NotInitializedError()
    return _state
