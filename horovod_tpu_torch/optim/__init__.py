"""Optimizer layer of the PyTorch port."""

from horovod_tpu_torch.optim.optimizer import (  # noqa: F401
    DistributedGradientTape,
    DistributedOptimizer,
    ShardedOptimizerState,
    distributed_gradients,
)
from horovod_tpu_torch.optim.train_step import (  # noqa: F401
    DistributedTrainStep,
    join_step,
)
