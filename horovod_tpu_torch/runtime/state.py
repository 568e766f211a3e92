"""Process-wide runtime state of the PyTorch port.

Counterpart of ``horovod_tpu/runtime/state.py``.  The process model is
Horovod's own: one process per GPU, so ``rank``/``size`` are the process
rank and world size, and ``local_rank`` picks the process's card.  The
launcher's environment contract is the JAX package's
(``HOROVOD_RANK``/``HOROVOD_SIZE``/``HOROVOD_COORDINATOR_ADDR``, plus
``HOROVOD_LOCAL_*``/``HOROVOD_CROSS_*``); without it the world is this one
process.  Collectives run on a ``torch.distributed`` process group: NCCL
for the card, gloo for the CPU.  Beside it every rank holds a gloo group
over the same ranks, ``host_group``: the eager plane's negotiation and its
host data plane run there, so they never wait on the card.
"""

from __future__ import annotations

import atexit
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
            raise ValueError(f"HOROVOD_RANK {self.rank} is outside a world "
                             f"of {self.size}")
        if self.device.type == "cuda":
            self.device = torch.device("cuda", self.local_rank)
            torch.cuda.set_device(self.device)
        if dist.is_initialized():
            # a process group the caller made: take its identity
            self.rank, self.size = dist.get_rank(), dist.get_world_size()
        else:
            if self.size > 1 and not cfg.coordinator_addr:
                raise ValueError("HOROVOD_SIZE > 1 needs "
                                 "HOROVOD_COORDINATOR_ADDR (host:port of "
                                 "rank 0)")
            backend = "nccl" if self.device.type == "cuda" else "gloo"
            if cfg.coordinator_addr:
                dist.init_process_group(
                    backend, init_method=f"tcp://{cfg.coordinator_addr}",
                    world_size=self.size, rank=self.rank)
            else:
                # a world of one rendezvouses with nobody: an in-memory
                # store, so that no free port is picked and then taken by
                # another socket before the store binds it (EADDRINUSE)
                dist.init_process_group(backend, store=dist.HashStore(),
                                        world_size=1, rank=0)
            self.owns_group = True
        # collective: every rank creates it here, in the same order
        self.host_group = dist.group.WORLD if dist.get_backend() == "gloo" \
            else dist.new_group(backend="gloo")

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
