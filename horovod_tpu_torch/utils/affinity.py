"""CPU affinity pinning (reference ``HOROVOD_THREAD_AFFINITY``;
``horovod_tpu/utils/affinity.py``).

The reference pins its background communication thread to a core per
local rank (``parse_and_set_affinity``, ``common/common.cc``).  The port
confines the whole worker process instead: ``init()`` applies the set to every thread the process holds (torch's
intra-op pool, started when torch is imported, among them) before the
process group starts and before the first CUDA call, so the threads made
after it (NCCL's proxy and watchdog threads, the CUDA driver's, gloo's)
inherit the mask and co-located workers do not migrate onto each other's
cores.  ``os.sched_setaffinity`` acts on one thread, so the set is applied
to each thread of ``/proc/self/task`` in turn (:func:`pin_process`).

``HOROVOD_THREAD_AFFINITY`` holds one core set per local rank,
semicolon-separated; each set is a comma list and/or ranges::

    HOROVOD_THREAD_AFFINITY="0-3;4-7"      # local rank 0 → 0-3, 1 → 4-7
    HOROVOD_THREAD_AFFINITY="0,2;1,3"
"""

from __future__ import annotations

import os
from typing import List, Optional, Set

from horovod_tpu_torch.utils import logging as hvd_logging


def parse_affinity(spec: str) -> List[Set[int]]:
    """Parse the per-local-rank core sets; raises ValueError on junk."""
    out: List[Set[int]] = []
    for rank_spec in spec.split(";"):
        cores: Set[int] = set()
        for part in rank_spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "-" in part:
                lo, _, hi = part.partition("-")
                lo_i, hi_i = int(lo), int(hi)
                if hi_i < lo_i:
                    raise ValueError(
                        f"invalid core range '{part}' in affinity spec")
                cores.update(range(lo_i, hi_i + 1))
            else:
                cores.add(int(part))
        if not cores:
            raise ValueError(
                f"empty core set in HOROVOD_THREAD_AFFINITY: {spec!r}")
        out.append(cores)
    return out


def pin_process(cores: Set[int]) -> None:
    """Confine every thread of this process to ``cores``: the calling
    thread first (an ``OSError`` for cores the host lacks is raised before
    any other thread moves), then each thread of ``/proc/self/task``; a
    thread that ended meanwhile is passed over.  Without ``/proc`` only the
    calling thread, and the threads it makes later, are confined."""
    os.sched_setaffinity(0, cores)
    try:
        tids = os.listdir("/proc/self/task")
    except OSError:
        return
    for tid in tids:
        try:
            os.sched_setaffinity(int(tid), cores)
        except ProcessLookupError:
            pass


def set_affinity_from_env(local_rank: int,
                          setter=None) -> Optional[Set[int]]:
    """Apply this process's core set from ``HOROVOD_THREAD_AFFINITY``;
    returns the set applied, or None when the knob is unset.  ``setter``
    is injectable for tests (defaults to :func:`pin_process`)."""
    spec = os.environ.get("HOROVOD_THREAD_AFFINITY")
    if not spec:
        return None
    try:
        sets = parse_affinity(spec)
    except ValueError as e:
        hvd_logging.warning("ignoring HOROVOD_THREAD_AFFINITY: %s", e)
        return None
    if local_rank >= len(sets):
        # never silently share a core set between co-located workers:
        # that is the contention pinning exists to prevent (the reference
        # raises when the list is shorter than the local size)
        hvd_logging.warning(
            "HOROVOD_THREAD_AFFINITY has %d core set(s) but this is "
            "local rank %d; not pinning: provide one set per local rank",
            len(sets), local_rank)
        return None
    cores = sets[local_rank]
    setter = setter or pin_process
    try:
        setter(cores)
    except OSError as e:  # cores absent on this host
        hvd_logging.warning("could not set CPU affinity %s: %s",
                            sorted(cores), e)
        return None
    hvd_logging.info("pinned process to cores %s (local rank %d)",
                     sorted(cores), local_rank)
    return cores
