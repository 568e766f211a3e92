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
"""

from __future__ import annotations

import atexit
import os
import socket
import threading
from typing import Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch.runtime.config import Config


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

    def _set_device(self) -> None:
        if self.device.type == "cuda":
            self.device = torch.device("cuda", self.local_rank)
            torch.cuda.set_device(self.device)

    def shutdown(self) -> None:
        if dist.is_initialized():
            if self.owns_group:
                dist.destroy_process_group()
            elif self.host_group not in (None, dist.group.WORLD):
                dist.destroy_process_group(self.host_group)
        self.owns_group = False
        self.host_group = None


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
