"""Data plane of the PyTorch port: collectives, the quantized wire codec,
the sharded exchange, compression, fusion buckets and the hand-written
CUDA kernels."""

from horovod_tpu_torch.ops.collectives import (  # noqa: F401
    Adasum,
    Average,
    FusionSpec,
    ReduceOp,
    ShardGroup,
    Sum,
    allgather,
    allgather_v,
    allgather_v_compact,
    allgather_v_mask,
    allreduce,
    alltoall,
    alltoall_v,
    barrier,
    bitwise_and,
    bitwise_or,
    broadcast,
    ef_quantized_reducescatter,
    grouped_allgather,
    grouped_allreduce,
    grouped_reducescatter,
    local_fusion_shards,
    make_fusion_spec,
    quantized_allreduce,
    quantized_reducescatter,
    reducescatter,
)
from horovod_tpu_torch.ops.compression import Compression  # noqa: F401
