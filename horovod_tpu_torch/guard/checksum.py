"""Replica-consistency checksums: silent-data-corruption detection (a copy
of ``horovod_tpu/guard/checksum.py``).

A diverged replica is the failure heartbeats cannot see: the process is
alive, beating, making "progress" — on wrong bits.  Every
``HOROVOD_GUARD_CHECK_INTERVAL`` steps each rank fingerprints its
parameters, the 64-bit fingerprints are gathered across the data-parallel
ranks (a few bytes — one tiny collective), and a majority vote names the
diverged rank (docs/guardian.md).

The fingerprint is Fletcher-style over the raw bytes: two 32-bit sums
over the bytes read as little-endian 32-bit words (zero-padded), one
plain and one weighted by the word's position 1..n, packed into one int.
The weighted sum makes the checksum order-sensitive (two swapped elements
change it), and reading raw bytes makes any flipped bit — including
NaN-payload bits equality would miss — change the value.  Leaves are
mixed in the JAX package's order (:mod:`~horovod_tpu_torch.utils.pytree`:
a dict's keys sorted, ``None`` skipped), so the same leaves, as numpy
arrays or as tensors, give the same value in both packages.

A numpy array or a CPU tensor is summed on the host, as the JAX package
sums every leaf.  A tensor on a card is summed where it lies: its words
widened to int64 and masked to unsigned, in chunks, the weighted
products reduced mod 2**32 before each sum, so no step overflows and the
sums equal numpy's uint64 arithmetic in their low 32 bits.  The only host
traffic is 8 bytes a leaf, read once for the whole tree; parameters and
AdamW state on a card are never copied to the host.

``gather_fn`` is injectable: single-process runs (and the CPU tests) pass
a callable that returns every simulated rank's fingerprint;
:func:`dist_gather_fn` gathers over ``torch.distributed``, carrying each
fingerprint as an int64.  Without one, a single-process run compares
trivially against itself.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import Counter
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from horovod_tpu_torch import telemetry
from horovod_tpu_torch.utils import pytree

_MOD32 = np.uint64(0xFFFFFFFF)
_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF
#: 32-bit words a card sums at a time: its int64 temporaries stay at
#: 128 MiB whatever the leaf's size
_CHUNK_WORDS = 1 << 24

_TEL_CHECKS = telemetry.counter(
    "hvd_guard_checks_total", "replica-checksum passes")
_TEL_CHECK_S = telemetry.histogram(
    "hvd_guard_checksum_seconds",
    "wall time of one replica-checksum pass (fingerprint + gather)")
_TEL_DIVERGED = telemetry.gauge(
    "hvd_guard_divergence_rank",
    "rank named by the most recent divergence verdict")


def _leaf_bytes(x: Any) -> bytes:
    if isinstance(x, torch.Tensor):
        flat = x.detach().contiguous().reshape(-1)
        return flat.view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _leaf_fingerprint(x: Any) -> int:
    """The host sums of one array leaf (the JAX package's arithmetic)."""
    buf = _leaf_bytes(x)
    pad = (-len(buf)) % 4
    if pad:
        buf += b"\x00" * pad
    words = np.frombuffer(buf, np.uint32).astype(np.uint64)
    s1 = int(words.sum() & _MOD32)
    # position-weighted second sum (uint64 wraparound is deterministic):
    # reordered bytes hash differently
    weights = np.arange(1, words.size + 1, dtype=np.uint64)
    s2 = int((words * weights).sum() & _MOD32)
    return (s1 << 32) | s2


@torch.no_grad()
def _device_fingerprint(x: torch.Tensor) -> torch.Tensor:
    """:func:`_leaf_fingerprint` of a tensor on a card, computed there: an
    int64 scalar on its device holding ``(s1 << 32) | s2`` (negative when
    bit 63 is set)."""
    raw = x.detach().contiguous().reshape(-1).view(torch.uint8)
    n_full = raw.numel() // 4
    parts = [raw[:4 * n_full].view(torch.int32)]
    tail = raw.numel() - 4 * n_full
    if tail:
        word = torch.zeros(4, dtype=torch.uint8, device=raw.device)
        word[:tail] = raw[4 * n_full:]
        parts.append(word.view(torch.int32))
    s1 = torch.zeros((), dtype=torch.int64, device=raw.device)
    s2 = torch.zeros((), dtype=torch.int64, device=raw.device)
    pos = 0
    for words in parts:
        for start in range(0, words.numel(), _CHUNK_WORDS):
            w = words[start:start + _CHUNK_WORDS].to(torch.int64)
            w.bitwise_and_(_MASK32)
            s1.add_(w.sum()).bitwise_and_(_MASK32)
            first = pos + start + 1
            weights = torch.arange(first, first + w.numel(),
                                   dtype=torch.int64, device=raw.device)
            # word < 2**32 times weight < 2**31: no product overflows, and
            # each is cut to its low 32 bits before the sum
            s2.add_(w.mul_(weights).bitwise_and_(_MASK32).sum())
            s2.bitwise_and_(_MASK32)
        pos += words.numel()
    return (s1 << 32) | s2


def fingerprint(tree: Any) -> int:
    """Order-sensitive 64-bit fingerprint of every array leaf in a
    pytree (non-array leaves hashed by repr).  Equal trees — same
    structure, same bytes — always agree; any flipped bit disagrees."""
    leaves = pytree.leaves(tree)
    hashes: List[Optional[int]] = [None] * len(leaves)
    on_card = {}
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu":
            on_card.setdefault(leaf.device, []).append(
                (i, _device_fingerprint(leaf)))
        elif hasattr(leaf, "shape"):
            hashes[i] = _leaf_fingerprint(leaf)
        else:
            # builtin hash() is salted per-process (PYTHONHASHSEED) —
            # ranks comparing fingerprints need a stable digest
            hashes[i] = int.from_bytes(
                hashlib.blake2b(repr(leaf).encode(),
                                digest_size=8).digest(), "big")
    for found in on_card.values():
        values = torch.stack([v for _, v in found]).tolist()   # one read
        for (i, _), v in zip(found, values):
            hashes[i] = v & _MASK64
    fp = 0
    for h in hashes:
        # polynomial mix keeps leaf order significant across the tree
        fp = ((fp * 1000003) ^ h) & _MASK64
    return fp


def dist_gather_fn(group=None) -> Callable[[int], List[int]]:
    """A ``gather_fn`` over ``torch.distributed``: every rank of ``group``
    (None: the world) sends its fingerprint as an int64 on the runtime's
    device (NCCL on a card, gloo on the CPU), and each gets them all back,
    in the group's rank order, as unsigned 64-bit ints."""
    import torch.distributed as dist

    from horovod_tpu_torch.runtime import state

    def gather(fp: int) -> List[int]:
        dev = state.global_state().device
        signed = fp - (1 << 64) if fp >= (1 << 63) else fp
        mine = torch.tensor([signed], dtype=torch.int64, device=dev)
        out = [torch.empty_like(mine)
               for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, mine, group=group)
        return [v & _MASK64 for v in torch.cat(out).tolist()]

    return gather


def compare(fps: List[int]) -> List[int]:
    """Majority vote over per-rank fingerprints; returns the ranks that
    disagree with the majority (empty = consistent).  On an exact tie
    the first-seen value wins — deterministic, and with two ranks the
    higher rank is named (rank 0 is the checkpoint writer, so recovery
    treats it as the reference copy)."""
    if len(fps) <= 1:
        return []
    majority = Counter(fps).most_common(1)[0][0]
    return [i for i, f in enumerate(fps) if f != majority]


@dataclasses.dataclass
class DivergenceReport:
    """A detected SDC: who diverged, at which step, from what vote."""

    step: int
    fingerprints: List[int]
    diverged: List[int]

    @property
    def rank(self) -> int:
        """The (first) diverged rank the verdict names."""
        return self.diverged[0]


class ReplicaChecker:
    """Cadenced replica-consistency checker.

    ``interval`` in steps (0 disables); ``gather_fn(fp) -> [fp_rank0,
    ...]`` collects every rank's fingerprint (default: the local one
    alone — trivially consistent single-process)."""

    def __init__(self, interval: int = 10,
                 gather_fn: Optional[Callable[[int], List[int]]] = None):
        self.interval = max(int(interval), 0)
        self._gather = gather_fn
        self.last_report: Optional[DivergenceReport] = None
        self.last_check_s: Optional[float] = None

    def due(self, step: int) -> bool:
        return self.interval > 0 and step > 0 and step % self.interval == 0

    def check(self, step: int, params: Any) -> Optional[DivergenceReport]:
        """One checksum pass (call when :meth:`due`); returns a report
        on divergence, None when every rank agrees."""
        t0 = time.perf_counter()
        fp = fingerprint(params)
        fps = self._gather(fp) if self._gather is not None else [fp]
        self.last_check_s = time.perf_counter() - t0
        _TEL_CHECKS.inc()
        _TEL_CHECK_S.observe(self.last_check_s)
        diverged = compare(list(fps))
        if not diverged:
            self.last_report = None
            return None
        report = DivergenceReport(step=step, fingerprints=list(fps),
                                  diverged=diverged)
        self.last_report = report
        _TEL_DIVERGED.set(report.rank)
        return report
