"""Parquet row-group reads for the input pipeline
(``horovod_tpu/spark/store.py``).

The port has ported only :class:`RowGroupReader` so far, which
:class:`~horovod_tpu_torch.data.ParquetSource` reads through; the store
layout and the estimators come with the spark slice.  pyarrow (and
pandas) are imported when a reader is made, not with this module.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np


class RowGroupReader:
    """Streaming shard reader over a store data directory.

    The petastorm-reader analogue (reference ``spark/keras/remote.py:336``
    trains from per-worker parquet shard streams; schema machinery in
    ``spark/common/util.py:697``): parquet row groups are the unit of
    sharding and of IO, so a worker touches only its own groups and holds
    at most one group in memory at a time.  ``groups_read`` /
    ``rows_materialized`` record what was actually read off disk — the
    accounting hooks the sharding tests assert on.  Beyond the classic
    round-robin :meth:`shard_groups`, the range API —
    :meth:`shard_range` / :meth:`read_rows` / :meth:`take` — serves
    index-range shards and shuffled gathers with group-pruned IO (what
    :class:`horovod_tpu_torch.data.ShardedDataset` drives).
    """

    def __init__(self, path: str):
        import glob as _glob

        import pyarrow.parquet as pq

        files = sorted(_glob.glob(os.path.join(path, "*.parquet")))
        if not files:
            raise FileNotFoundError(f"no parquet files under {path!r}")
        self._pfs = [pq.ParquetFile(f) for f in files]
        self._shapes = {}
        meta_path = os.path.join(path, "_meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                self._shapes = json.load(f).get("shapes", {})
        # global group index -> (file, local group index, row count);
        # built from parquet footers only — no data pages are read
        self._groups = []
        for pf in self._pfs:
            for g in range(pf.metadata.num_row_groups):
                self._groups.append(
                    (pf, g, pf.metadata.row_group(g).num_rows))
        self.groups_read: List[int] = []
        # rows actually materialized off disk — the no-full-copy
        # accounting (a 1/N shard reader must stay near num_rows/N)
        self.rows_materialized = 0
        # cumulative row offsets: group g spans [offsets[g], offsets[g+1])
        self._offsets = np.concatenate(
            [[0], np.cumsum([n for _, _, n in self._groups])]).astype(
            np.int64)

    @property
    def num_row_groups(self) -> int:
        return len(self._groups)

    @property
    def num_rows(self) -> int:
        """Total rows across every part/group (footer metadata only)."""
        return int(self._offsets[-1])

    @property
    def group_rows(self) -> List[int]:
        """Per-group row counts (footer metadata, identical on every
        process — lets ranks agree on step counts without communicating)."""
        return [n for _, _, n in self._groups]

    def shard_groups(self, shard: int, num_shards: int) -> List[int]:
        """Round-robin group assignment: shard ``p`` of ``n`` owns groups
        ``p, p+n, p+2n, …`` (petastorm ``cur_shard``/``shard_count``)."""
        return list(range(shard, self.num_row_groups, num_shards))

    def shard_range(self, shard: int, num_shards: int):
        """Contiguous row-range assignment ``[lo, hi)``: shard ``p`` of
        ``n`` owns rows ``[p*⌊N/n⌋, (p+1)*⌊N/n⌋)`` — equal-size shards,
        remainder dropped (the input plane's zero-tail invariant: every
        shard identical in size, no ragged tail).  The unit a
        :class:`~horovod_tpu_torch.data.ShardedDataset` maps onto range
        reads."""
        per = self.num_rows // num_shards
        return shard * per, (shard + 1) * per

    def read_group(self, index: int):
        """Materialize one row group as a pandas DataFrame (tensor cells
        reshaped from ``_meta.json``)."""
        pf, local, nrows = self._groups[index]
        self.groups_read.append(index)
        self.rows_materialized += nrows
        df = pf.read_row_group(local).to_pandas()
        for c, shape in self._shapes.items():
            if c in df.columns:
                df[c] = [np.asarray(v).reshape(shape) for v in df[c]]
        return df

    def read_rows(self, start: int, stop: int):
        """Rows ``[start, stop)`` as one DataFrame, touching only the
        row groups overlapping the range (range read: IO cost scales
        with the slice, not the dataset)."""
        import pandas as pd

        if not 0 <= start <= stop <= self.num_rows:
            raise ValueError(
                f"row range [{start}, {stop}) outside the "
                f"{self.num_rows}-row dataset")
        if start == stop:
            raise ValueError("empty row range")
        g_lo = int(np.searchsorted(self._offsets, start, side="right")) - 1
        g_hi = int(np.searchsorted(self._offsets, stop, side="left"))
        frames = []
        for g in range(g_lo, g_hi):
            df = self.read_group(g)
            lo = max(start - int(self._offsets[g]), 0)
            hi = min(stop, int(self._offsets[g + 1])) - int(
                self._offsets[g])
            frames.append(df.iloc[lo:hi])
        return pd.concat(frames, ignore_index=True) if len(frames) > 1 \
            else frames[0].reset_index(drop=True)

    def take(self, indices):
        """Arbitrary global rows, in the requested order, each needed
        group read once (the shuffled-shard gather: a rank fetching its
        permuted 1/N touches ~1/N of the groups, never the rest)."""
        import pandas as pd

        idx = np.asarray(indices, dtype=np.int64)
        if idx.size == 0:
            raise ValueError("take() of no indices")
        if idx.min() < 0 or idx.max() >= self.num_rows:
            raise IndexError(
                f"row indices outside [0, {self.num_rows})")
        gids = np.searchsorted(self._offsets, idx, side="right") - 1
        frames, base, off = {}, {}, 0
        for g in np.unique(gids):
            frames[int(g)] = self.read_group(int(g))
            base[int(g)] = off
            off += len(frames[int(g)])
        cat = pd.concat([frames[g] for g in sorted(frames)],
                        ignore_index=True) if len(frames) > 1 \
            else next(iter(frames.values()))
        pos = np.asarray([base[int(g)] + int(i) - int(self._offsets[g])
                          for g, i in zip(gids, idx)])
        return cat.iloc[pos].reset_index(drop=True)
