"""Data plane of the PyTorch port.

* :mod:`~horovod_tpu_torch.ops.eager`: the eager, named, asynchronous
  collectives (``allreduce``/``allreduce_async``/``synchronize``/``poll``/
  ``join``...), which this package exports under Horovod's names, as the
  JAX package's ``ops`` does;
* :mod:`~horovod_tpu_torch.ops.collectives`: the collectives a training
  step calls (``grouped_allreduce``, the sharded exchange, the quantized
  wire codec), also exported here where their names do not collide;
* :mod:`~horovod_tpu_torch.ops.op_manager`: the eager plane's two data
  planes;
* :mod:`~horovod_tpu_torch.ops.bucketing`: fusion buckets;
* :mod:`~horovod_tpu_torch.ops.adasum`: Adasum's pairwise combine and its
  reduction over the world's layout;
* :mod:`~horovod_tpu_torch.ops.compression`, :mod:`~.kernels`: compression
  and the hand-written CUDA kernels.
"""

from horovod_tpu_torch.ops.collectives import (  # noqa: F401
    Adasum,
    Average,
    FusionSpec,
    ReduceOp,
    ShardGroup,
    Sum,
    allgather_v,
    allgather_v_compact,
    allgather_v_mask,
    alltoall_v,
    bitwise_and,
    bitwise_or,
    ef_quantized_reducescatter,
    grouped_allgather,
    grouped_allreduce,
    grouped_reducescatter,
    local_fusion_shards,
    make_fusion_spec,
    quantized_allreduce,
    quantized_reducescatter,
    reducescatter,
    sparse_allreduce,
)
from horovod_tpu_torch.ops.compression import Compression  # noqa: F401
from horovod_tpu_torch.ops.eager import (  # noqa: F401
    Handle,
    HorovodInternalError,
    allgather,
    allgather_async,
    allgather_with_sizes,
    allreduce,
    allreduce_async,
    alltoall,
    alltoall_async,
    barrier,
    broadcast,
    broadcast_async,
    join,
    poll,
    synchronize,
)
