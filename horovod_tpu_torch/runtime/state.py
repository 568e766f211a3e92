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
from typing import Dict, Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch.runtime.config import Config


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
        # hits and misses of the eager negotiation cache (reference
        # response-cache statistics)
        self.cache_stats = {"hits": 0, "misses": 0}
        # the eager plane's per-world state (ops/eager.py): its handles,
        # negotiation caches and cycle counter, and its Bucketer
        self.eager = None
        # this rank's group of each layout level, made at first use
        self._layout: Optional[Dict[str, Optional[dist.ProcessGroup]]] = None

    def initialize(self) -> None:
        cfg = self.config
        if dist.is_initialized():
            # a process group the caller made: its identity first, then
            # the local extent, and only then the card
            self.rank, self.size = dist.get_rank(), dist.get_world_size()
            self._make_host_group()
            self._identity_from_group(self._gather(self._local_env()))
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
            self._set_device()
            if self.size > 1 and not cfg.coordinator_addr:
                raise ValueError("HOROVOD_SIZE > 1 needs "
                                 "HOROVOD_COORDINATOR_ADDR (host:port of "
                                 "rank 0)")
            backend = "nccl" if self.device.type == "cuda" else "gloo"
            if self.size > 1:
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
            sizes = [n for _, _, n in self._gather(
                (self.local_rank, self.local_size))]
            self.is_homogeneous = len(set(sizes)) == 1

    def _make_host_group(self) -> None:
        # collective: every rank creates it here, in the same order
        self.host_group = dist.group.WORLD if dist.get_backend() == "gloo" \
            else dist.new_group(backend="gloo")

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

        The first call makes every group of both levels, local ones node
        by node and then cross ones index by index, so every rank must
        make it, at the same point of its program (the collectives that
        need a level do).  It gathers each rank's ``(cross_rank,
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
        levels = {LOCAL: [[c * n_local + l for l in range(n_local)]
                          for c in range(n_cross)],
                  CROSS: [[c * n_local + l for c in range(n_cross)]
                          for l in range(n_local)]}
        out: Dict[str, Optional[dist.ProcessGroup]] = {}
        for level, lines in levels.items():
            extent = len(lines[0])
            if extent == 1:
                out[level] = None
            elif extent == self.size:
                out[level] = dist.group.WORLD
            else:
                for ranks in lines:
                    group = dist.new_group(ranks)
                    if self.rank in ranks:
                        out[level] = group
        return out

    def _set_device(self) -> None:
        if self.device.type == "cuda":
            self.device = torch.device("cuda", self.local_rank)
            torch.cuda.set_device(self.device)

    def shutdown(self) -> None:
        if dist.is_initialized():
            if self.owns_group:
                dist.destroy_process_group()
            else:
                made = [self.host_group] + list((self._layout or {}).values())
                for group in made:
                    if group not in (None, dist.group.WORLD):
                        dist.destroy_process_group(group)
        self.owns_group = False
        self.host_group = None
        self._layout = None


_state: Optional[GlobalState] = None
_state_lock = threading.Lock()


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
        st = GlobalState(config or Config.from_env(), _resolve_device(device))
        st.initialize()
        _state = st
        return st


def shutdown() -> None:
    global _state
    with _state_lock:
        if _state is not None:
            _state.shutdown()
            _state = None


def is_initialized() -> bool:
    return _state is not None


def global_state() -> GlobalState:
    if _state is None:
        raise NotInitializedError()
    return _state
