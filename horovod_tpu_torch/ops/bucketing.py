"""Fusion buckets (``horovod_tpu/ops/bucketing.py``): ``plan_buckets``,
copied, which plans the optimizer's byte-capped buckets, and the eager
plane's :class:`Bucketer`."""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence


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


class _Entry:
    __slots__ = ("name", "tensor", "op", "prescale", "postscale", "handle",
                 "nbytes")

    def __init__(self, name, tensor, op, prescale, postscale, handle):
        self.name = name
        self.tensor = tensor
        self.op = op
        self.prescale = prescale
        self.postscale = postscale
        self.handle = handle
        self.nbytes = tensor.numel() * tensor.element_size()


class Bucketer:
    """The eager plane's fusion buckets (JAX ``bucketing.Bucketer``).

    ``allreduce_async`` submissions of one key, ``(op, dtype, prescale,
    postscale)`` and the tensor's device type (a flat buffer lives on one
    device), wait in a bucket; the bucket dispatches as one reduction when
    its bytes reach ``HOROVOD_FUSION_THRESHOLD``, in submission order, and
    nowhere else.  :meth:`flush` (on ``synchronize``, ``poll`` and
    ``join``) dispatches what waits, in insertion order, which is program
    order, so every rank dispatches the same groups in the same order.
    There is no background thread.  ``groups`` counts the dispatches."""

    def __init__(self):
        self._lock = threading.Lock()
        self._buckets: Dict[tuple, List[_Entry]] = {}
        self._bytes: Dict[tuple, int] = {}
        self.groups = 0

    def add(self, name, tensor, op, prescale, postscale, handle) -> None:
        from horovod_tpu_torch.runtime import state

        threshold = state.global_state().config.fusion_threshold_bytes
        e = _Entry(name, tensor, op, prescale, postscale, handle)
        key = (op, tensor.dtype, prescale, postscale, tensor.device.type)
        group = None
        with self._lock:
            self._buckets.setdefault(key, []).append(e)
            self._bytes[key] = self._bytes.get(key, 0) + e.nbytes
            if self._bytes[key] >= max(threshold, 1):
                group = self._take(key)
        if group:
            self._dispatch(group)

    def _take(self, key) -> List[_Entry]:
        self._bytes.pop(key, None)
        return self._buckets.pop(key, [])

    def _dispatch(self, group: List[_Entry]) -> None:
        from horovod_tpu_torch.ops.eager import _dispatch_group

        self.groups += 1
        _dispatch_group(group)

    def flush(self) -> None:
        """Dispatch every waiting bucket, in insertion order."""
        with self._lock:
            groups = [self._take(k) for k in list(self._buckets)]
        for g in groups:
            if g:
                self._dispatch(g)


def global_bucketer() -> Bucketer:
    """This world's Bucketer (a new ``init()`` starts a new one)."""
    from horovod_tpu_torch.ops.eager import _world

    return _world().bucketer
