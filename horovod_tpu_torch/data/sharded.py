"""Shard-aware dataset views: each rank reads 1/N, never the whole set
(``horovod_tpu/data/sharded.py``).

The same index stream as the JAX package, bit for bit: a
:class:`ShardedDataset` assigns each rank a disjoint slice of a
deterministic per-epoch sample order, so a rank *materializes* only its
~1/N of the data (range reads / index gathers against the source), while
all ranks agree on the global order from one broadcast seed.

Sharding contract (docs/data.md):

* the per-epoch global order is ``permutation(seed, epoch)`` —
  identical on every rank, no communication needed once the seed is
  agreed (:func:`broadcast_seed`);
* consumption advances in *global sample position*: the step at
  position ``p`` hands rank ``r`` the contiguous block
  ``order[p + r*B : p + (r+1)*B]`` and advances ``p`` by ``world*B``
  — so with ``shuffle=False`` each rank's reads are literal index
  ranges (the spark store's range-read fast path);
* drop-remainder: a step exists only if a full ``world*B`` chunk
  remains — no ragged tail batch ever reaches the device, the input
  counterpart of the exchange plane's zero-tail fusion invariant
  (every shard always full, shard-divisible);
* elastic resume: position is world-size-independent, so after a
  reshard (say 2 → 4 ranks) the new world continues the SAME epoch
  order from the restored position — no sample replays, none is
  skipped (up to the drop-remainder tail).  ``reshard()`` +
  ``epoch(e, start_sample=p)`` is the whole protocol; elastic
  ``_reset`` tears down any live prefetchers
  (:func:`horovod_tpu_torch.data.close_all_pipelines`) and the training fn
  re-seeds from the committed ``(epoch, position)``.

The sources are host-side: numpy arrays (or CPU tensors) in, numpy rows
out.  :class:`~horovod_tpu_torch.data.PrefetchIterator` stages them into
pinned memory and copies them to the card.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Union

import numpy as np
from torch.utils._pytree import tree_leaves, tree_map


def broadcast_seed(seed: Optional[int] = None, root_rank: int = 0) -> int:
    """Agree on one shuffle seed across processes (rank 0's wins).

    ``seed=None`` draws a fresh one on the root.  Single-process (or
    uninitialized) runs return the local value — the broadcast is a
    no-op there, so this is safe to call unconditionally."""
    if seed is None:
        seed = int(np.random.SeedSequence().generate_state(1)[0] >> 1)
    from horovod_tpu_torch.runtime import state

    if state.is_initialized() and state.global_state().size > 1:
        from horovod_tpu_torch.functions import broadcast_object

        seed = broadcast_object(int(seed), root_rank=root_rank,
                                name="data.shuffle_seed")
    return int(seed)


class ArraySource:
    """Random-access source over an in-memory tree of equal-length
    host arrays (a dict of columns, a tuple, a bare array ...).

    ``rows_fetched`` counts rows actually materialized through
    :meth:`take` — the accounting hook the no-full-copy tests assert on
    (a rank driving a :class:`ShardedDataset` must fetch ~1/world of
    the rows, never all of them)."""

    def __init__(self, data):
        self._data = data
        leaves = tree_leaves(data)
        if not leaves:
            raise ValueError("ArraySource needs at least one array leaf")
        n = len(leaves[0])
        for leaf in leaves[1:]:
            if len(leaf) != n:
                raise ValueError(
                    f"ArraySource leaves disagree on length: {n} vs "
                    f"{len(leaf)}")
        self._n = n
        self.rows_fetched = 0

    def __len__(self) -> int:
        return self._n

    def take(self, indices: np.ndarray):
        self.rows_fetched += len(indices)
        return tree_map(lambda a: a[indices], self._data)


class ParquetSource:
    """Random-access source over a store parquet directory — row-group
    pruned, so :meth:`take` materializes only the groups its indices
    touch (the :class:`~horovod_tpu_torch.spark.store.RowGroupReader`
    range API underneath; ``reader.rows_materialized`` is the
    accounting).  pyarrow is imported here, not with the module."""

    def __init__(self, path: str):
        from horovod_tpu_torch.spark.store import RowGroupReader

        self.reader = RowGroupReader(path)

    def __len__(self) -> int:
        return self.reader.num_rows

    @property
    def rows_fetched(self) -> int:
        return self.reader.rows_materialized

    def take(self, indices: np.ndarray):
        return self.reader.take(indices)


def _epoch_rng(seed: int, epoch: int) -> np.random.RandomState:
    # golden-ratio mix so (seed, epoch) and (seed+1, epoch-1) diverge
    return np.random.RandomState((seed + 0x9E3779B1 * (epoch + 1))
                                 % (1 << 32))


class ShardedDataset:
    """Disjoint 1/N shard view of a random-access source (module doc
    has the full contract).

    ``source`` is anything with ``__len__`` and ``take(indices)`` —
    :class:`ArraySource`, :class:`ParquetSource`, or your own.
    ``batch_size`` is PER RANK.  ``rank``/``world`` default to the
    runtime's process identity (``process_rank``/``process_count``: one
    process a card, so the world's rank and size), or (0, 1) before
    ``init()``.  ``seed`` must be process-consistent — pass it through
    :func:`broadcast_seed` in multi-process runs.
    """

    def __init__(self, source, batch_size: int,
                 rank: Optional[int] = None, world: Optional[int] = None,
                 seed: int = 0, shuffle: bool = True):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if rank is None or world is None:
            from horovod_tpu_torch.runtime import state

            if state.is_initialized():
                st = state.global_state()
                rank = st.rank if rank is None else rank
                world = st.size if world is None else world
            else:
                rank = rank or 0
                world = world or 1
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside world of {world}")
        self.source = source
        self.batch_size = int(batch_size)
        self.rank = int(rank)
        self.world = int(world)
        self.seed = int(seed)
        self.shuffle = bool(shuffle)

    # -- geometry ----------------------------------------------------------

    @property
    def num_samples(self) -> int:
        """Global sample count of the underlying source."""
        return len(self.source)

    @property
    def samples_per_step(self) -> int:
        """Global samples one step consumes across all ranks."""
        return self.world * self.batch_size

    @property
    def steps_per_epoch(self) -> int:
        """Full steps in an epoch (drop-remainder)."""
        return self.num_samples // self.samples_per_step

    def position_after(self, steps: int, start_sample: int = 0) -> int:
        """Global sample position after ``steps`` full steps — the value
        to commit for elastic resume (world-size independent)."""
        return start_sample + steps * self.samples_per_step

    # -- iteration ---------------------------------------------------------

    def _order(self, epoch: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.num_samples, dtype=np.int64)
        return _epoch_rng(self.seed, epoch).permutation(
            self.num_samples).astype(np.int64)

    def epoch_indices(self, epoch: int,
                      start_sample: int = 0) -> Iterator[np.ndarray]:
        """This rank's per-step index arrays for ``epoch``, starting at
        global sample position ``start_sample`` (must be a prior
        ``position_after`` value — i.e. a multiple of some generation's
        ``samples_per_step``)."""
        if start_sample < 0:
            raise ValueError(f"start_sample must be >= 0, got "
                             f"{start_sample}")
        order = self._order(epoch)
        n, chunk, b = len(order), self.samples_per_step, self.batch_size
        pos = start_sample
        while pos + chunk <= n:
            lo = pos + self.rank * b
            yield order[lo:lo + b]
            pos += chunk

    def epoch(self, epoch: int, start_sample: int = 0):
        """This rank's batches for one epoch — each a ``source.take`` of
        its own index block only (the no-full-copy guarantee)."""
        for idx in self.epoch_indices(epoch, start_sample):
            yield self.source.take(idx)

    def iter_epochs(self, start_epoch: int = 0, start_sample: int = 0):
        """Endless epoch-after-epoch batch stream (``start_sample``
        applies to the first epoch only) — what a pipeline feeds from."""
        epoch = start_epoch
        while True:
            yield from self.epoch(epoch, start_sample)
            start_sample = 0
            epoch += 1

    # -- elastic -----------------------------------------------------------

    def reshard(self, rank: int, world: int) -> "ShardedDataset":
        """The same dataset (source, seed, order) viewed by a different
        world — the elastic-restart constructor.  Resuming the restored
        epoch at the committed ``position_after`` value replays no
        sample: position is counted in global samples, not steps, so it
        means the same thing at any world size."""
        return ShardedDataset(self.source, self.batch_size, rank=rank,
                              world=world, seed=self.seed,
                              shuffle=self.shuffle)

    def state_dict(self, epoch: int, step: int,
                   start_sample: int = 0) -> dict:
        """The committable resume point after ``step`` full steps of
        ``epoch`` — store it with the checkpoint and hand it back to
        :meth:`load_position`."""
        return {"epoch": int(epoch), "seed": self.seed,
                "sample": self.position_after(step, start_sample)}

    def load_position(self, state: dict):
        """``(epoch, start_sample)`` for :meth:`epoch` /
        :meth:`iter_epochs` from a :meth:`state_dict` snapshot; checks
        the seed so a mismatched restore fails loudly instead of
        silently replaying a different order."""
        if int(state.get("seed", self.seed)) != self.seed:
            raise ValueError(
                f"restored shuffle seed {state.get('seed')} does not "
                f"match this dataset's {self.seed}; re-seed the dataset "
                f"from the committed state before resuming")
        return int(state["epoch"]), int(state["sample"])
