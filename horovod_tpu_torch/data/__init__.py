"""Streaming, shard-aware input pipeline (``horovod_tpu/data``).

The layer between a dataset and :class:`DistributedTrainStep`:

* :class:`ShardedDataset` — each rank reads a disjoint 1/N of a
  deterministic per-epoch order (no full-copy-per-worker), position is
  world-size independent for elastic resume; the index stream is the
  JAX package's, bit for bit;
* :class:`PrefetchIterator` — host batch assembly and the copy to the
  card on background threads with a bounded queue, through pinned
  staging buffers on a copy stream of its own, so batch ``k+1``'s H2D
  copy overlaps batch ``k``'s compute;
* :class:`ArraySource` / :class:`ParquetSource` — random-access
  sources over in-memory arrays and parquet (row-group pruned range
  reads);
* :func:`broadcast_seed` — one shuffle seed for all processes;
* :func:`close_all_pipelines` — closes every live pipeline.

Knobs: ``HOROVOD_PREFETCH_DEPTH`` (queue bound, default 2) and
``HOROVOD_INPUT_THREADS`` (assembly pool, default 2).
"""

from horovod_tpu_torch.data.prefetch import (
    PrefetchIterator,
    close_all as close_all_pipelines,
    default_input_threads,
    default_prefetch_depth,
)
from horovod_tpu_torch.data.sharded import (
    ArraySource,
    ParquetSource,
    ShardedDataset,
    broadcast_seed,
)

__all__ = [
    "ArraySource",
    "ParquetSource",
    "PrefetchIterator",
    "ShardedDataset",
    "broadcast_seed",
    "close_all_pipelines",
    "default_input_threads",
    "default_prefetch_depth",
]
