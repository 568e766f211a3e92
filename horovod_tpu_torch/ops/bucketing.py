"""Byte-capped fusion buckets (``horovod_tpu/ops/bucketing.py``
``plan_buckets``, copied)."""

from __future__ import annotations

from typing import List, Optional, Sequence


def plan_buckets(nbytes: Sequence[int],
                 bucket_bytes: Optional[int],
                 reverse: bool = True) -> List[List[int]]:
    """Partition leaf indices into byte-capped fusion buckets.

    ``nbytes[i]`` is leaf ``i``'s payload.  Greedy, order-preserving
    packing: a bucket closes when adding the next leaf would exceed
    ``bucket_bytes`` (a single oversized leaf still gets its own bucket).
    With ``reverse=True`` (default) leaves are walked from the END:
    backward produces gradients in reverse layer order, so bucket 0 holds
    the earliest-ready gradients.  ``bucket_bytes`` of ``None`` or
    ``<= 0`` gives one bucket with every index (still reverse-ordered).
    The plan depends only on sizes and the cap, so every rank runs the
    same collectives in the same order.
    """
    order = range(len(nbytes) - 1, -1, -1) if reverse \
        else range(len(nbytes))
    if not bucket_bytes or bucket_bytes <= 0:
        ids = list(order)
        return [ids] if ids else []
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i in order:
        if cur and cur_bytes + nbytes[i] > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes[i]
    if cur:
        buckets.append(cur)
    return buckets
