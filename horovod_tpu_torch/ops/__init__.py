"""Data plane of the PyTorch port: collectives, compression, fusion buckets
and the hand-written CUDA kernels."""

from horovod_tpu_torch.ops.collectives import (  # noqa: F401
    Adasum,
    Average,
    ReduceOp,
    Sum,
    allgather,
    allreduce,
    barrier,
    broadcast,
    grouped_allreduce,
)
from horovod_tpu_torch.ops.compression import Compression  # noqa: F401
