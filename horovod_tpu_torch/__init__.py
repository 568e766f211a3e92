"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

A second package beside the JAX one, with the same user-facing contract on
an NVIDIA GPU: Horovod's five-line recipe ::

    import horovod_tpu_torch as hvd

    hvd.init()                                     # one process per GPU
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(model.parameters(), 3e-4))
    # or shard_optimizer_states=True: ZeRO-style, 1/N optimizer state a rank;
    # op=hvd.Adasum, sparse_params={"embedding": max_rows}, or
    # hvd.DistributedAdasumOptimizer(...) with DistributedTrainStep(op=None)
    step = hvd.DistributedTrainStep(loss_fn, opt)
    model, opt = step.init(model)                  # broadcast from rank 0
    model, opt, loss = step(model, opt, step.shard_batch(batch))
    hvd.checkpoint.Checkpointer(path).save(n, {"model": model.state_dict()})

``DistributedOptimizer`` registers a hook on every trainable parameter:
each gradient bucket is reduced on a side stream as soon as backward has
produced its last gradient, while backward goes on.  The eager collectives
(``allreduce``, ``allreduce_async``/``synchronize``/``poll``,
``allgather``, ``broadcast``, ``alltoall``, ``barrier``, ``join``) are the
top-level names, as in the JAX package; the collectives a training step
calls are in ``hvd.ops.collectives``.

A job of N processes starts with ``python -m horovod_tpu_torch.runner -np N
python train.py`` (``hvdrun``'s flags; ``--mpi`` and ``--jsrun`` too), or
``horovod_tpu_torch.runner.run(fn, np=N)``.

The port imports torch, numpy and the standard library only, never JAX or
``horovod_tpu``.  Its kernels are CUDA C++ for Hopper (``ops/csrc``),
built on first use; on CPU tensors each kernel's plain PyTorch version
runs instead.
"""

from __future__ import annotations

import torch

from horovod_tpu_torch import checkpoint  # noqa: F401
from horovod_tpu_torch import data  # noqa: F401
from horovod_tpu_torch import faults  # noqa: F401
from horovod_tpu_torch.exceptions import (  # noqa: F401
    HorovodInternalError,
    HostsUpdatedInterrupt,
)
from horovod_tpu_torch.functions import (  # noqa: F401
    allgather_object,
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
    broadcast_variables,
)
from horovod_tpu_torch.ops import (  # noqa: F401
    Adasum,
    Average,
    Compression,
    Handle,
    ReduceOp,
    Sum,
    allgather,
    allgather_async,
    allgather_v,
    allreduce,
    allreduce_async,
    alltoall,
    alltoall_async,
    alltoall_v,
    barrier,
    broadcast,
    broadcast_async,
    grouped_allreduce,
    join,
    poll,
    reducescatter,
    synchronize,
)
from horovod_tpu_torch.optim import (  # noqa: F401
    DistributedAdasumOptimizer,
    DistributedGradientTape,
    DistributedOptimizer,
    DistributedTrainStep,
    ShardedOptimizerState,
    SyncBatchNorm,
    join_step,
    sync_batch_stats,
)
from horovod_tpu_torch.runtime import state as _state

__version__ = "0.1.0"


def init(device=None, config=None):
    """Initialize the runtime (reference ``HorovodBasics.init``).  Runs on
    the card (``cuda:<local_rank>``, NCCL); raises when CUDA is absent
    unless ``device="cpu"`` (gloo), as the tests pass."""
    _state.init(device=device, config=config)
    return True


def shutdown():
    _state.shutdown()


def is_initialized() -> bool:
    return _state.is_initialized()


def rank() -> int:
    return _state.global_state().rank


def size() -> int:
    return _state.global_state().size


def local_rank() -> int:
    return _state.global_state().local_rank


def local_size() -> int:
    return _state.global_state().local_size


def cross_rank() -> int:
    return _state.global_state().cross_rank


def cross_size() -> int:
    return _state.global_state().cross_size


def process_rank() -> int:
    """This process's index.  The port runs one process per card, so it
    is :func:`rank` (the JAX package's process drives several chips)."""
    return _state.global_state().rank


def process_count() -> int:
    """The number of processes: :func:`size`, one process per card."""
    return _state.global_state().size


def is_homogeneous() -> bool:
    """True when every host drives the same number of ranks (reference
    ``horovod_is_homogeneous``); the local sizes are gathered with the
    hostnames at ``init()``."""
    return _state.global_state().is_homogeneous


def device():
    """The ``torch.device`` this process runs on."""
    return _state.global_state().device


# -- capability probes (reference basics.py:71-233 *_built/enabled), for
# this build: NCCL on the card, gloo for the host plane and the CPU ---------

def nccl_built() -> bool:
    import torch.distributed as dist

    return bool(dist.is_nccl_available())


def gloo_built() -> bool:
    return True


def gloo_enabled() -> bool:
    """True once ``init()`` has made the host plane's gloo group."""
    return _state.is_initialized() and \
        _state.global_state().host_group is not None


def cuda_built() -> bool:
    return torch.version.cuda is not None


def mpi_built() -> bool:
    return False


def mpi_enabled() -> bool:
    return False


def ddl_built() -> bool:
    return False


def ccl_built() -> bool:
    return False


def rocm_built() -> bool:
    return False


def mpi_threads_supported() -> bool:
    return False


def current_operations() -> str:
    """The data plane the eager collectives take for a tensor on this
    process's device: ``"XLA"`` (the device plane) or ``"HOST"``
    (``HOROVOD_TPU_OPERATIONS``)."""
    from horovod_tpu_torch.ops import op_manager

    return op_manager.current_operations(
        torch.empty(0, device=device()))


def cache_stats() -> dict:
    """Hits and misses of the eager negotiation cache (reference
    response-cache statistics), bounded by ``HOROVOD_CACHE_CAPACITY``."""
    if not _state.is_initialized():
        return {"hits": 0, "misses": 0}
    return dict(_state.global_state().cache_stats)


__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "process_rank",
    "process_count", "is_homogeneous", "device",
    "nccl_built", "gloo_built", "gloo_enabled", "cuda_built", "mpi_built",
    "mpi_enabled", "ddl_built", "ccl_built", "rocm_built",
    "mpi_threads_supported",
    "current_operations", "cache_stats",
    "allreduce", "allreduce_async", "allgather", "allgather_async",
    "alltoall", "alltoall_async", "broadcast", "broadcast_async", "barrier",
    "join", "poll", "synchronize", "Handle",
    "grouped_allreduce", "allgather_v", "reducescatter", "alltoall_v",
    "Average", "Sum", "Adasum", "ReduceOp", "Compression",
    "HorovodInternalError", "HostsUpdatedInterrupt",
    "broadcast_variables", "broadcast_parameters", "broadcast_object",
    "broadcast_optimizer_state", "allgather_object",
    "DistributedOptimizer", "DistributedAdasumOptimizer",
    "DistributedGradientTape", "DistributedTrainStep",
    "ShardedOptimizerState", "join_step", "SyncBatchNorm",
    "sync_batch_stats",
    "checkpoint", "data",
]
