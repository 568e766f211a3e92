"""Host/slot parsing and rank assignment (``horovod_tpu/runner/hosts.py``).

Reference: ``horovod/runner/common/util/hosts.py`` (``SlotInfo``,
``parse_hosts``, ``get_host_assignments:106`` — round-robin ranks over
hosts with local/cross rank computation) and ``--hostfile`` handling in
``runner/launch.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class HostInfo:
    hostname: str
    slots: int

    @staticmethod
    def from_string(host_string: str) -> "HostInfo":
        if ":" in host_string:
            hostname, slots = host_string.rsplit(":", 1)
            return HostInfo(hostname.strip(), int(slots))
        return HostInfo(host_string.strip(), 1)


@dataclasses.dataclass
class SlotInfo:
    """One worker process's identity (reference ``SlotInfo``): global,
    node-local and cross-node (one-per-host) ranks and sizes."""

    hostname: str
    rank: int
    local_rank: int
    cross_rank: int
    size: int
    local_size: int
    cross_size: int

    def to_env(self) -> Dict[str, str]:
        """The worker env contract (reference ``gloo_context.cc:47-55``)."""
        return {
            "HOROVOD_HOSTNAME": self.hostname,
            "HOROVOD_RANK": str(self.rank),
            "HOROVOD_SIZE": str(self.size),
            "HOROVOD_LOCAL_RANK": str(self.local_rank),
            "HOROVOD_LOCAL_SIZE": str(self.local_size),
            "HOROVOD_CROSS_RANK": str(self.cross_rank),
            "HOROVOD_CROSS_SIZE": str(self.cross_size),
        }


def parse_hosts(hosts_string: str) -> List[HostInfo]:
    """Parse ``"h1:2,h2:4"`` (reference ``parse_hosts``)."""
    return [HostInfo.from_string(s)
            for s in hosts_string.split(",") if s.strip()]


def parse_hostfile(path: str) -> List[HostInfo]:
    """Parse a hostfile with ``hostname slots=N`` or ``hostname:N`` lines
    (reference ``launch.py`` hostfile format)."""
    hosts = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "slots=" in line:
                name, _, slots = line.partition("slots=")
                hosts.append(HostInfo(name.strip(), int(slots.strip())))
            else:
                hosts.append(HostInfo.from_string(line))
    return hosts


def get_host_assignments(hosts: List[HostInfo], min_np: int,
                         max_np: Optional[int] = None) -> List[SlotInfo]:
    """Assign ``rank/local_rank/cross_rank`` over hosts in order
    (reference ``get_host_assignments:106``): ranks fill each host's slots
    before moving on, so consecutive ranks share a host — the layout that
    keeps intra-node (NVLink) neighbors adjacent.

    Raises when fewer than ``min_np`` slots exist; assigns at most
    ``max_np``.
    """
    total = sum(h.slots for h in hosts)
    if total < min_np:
        raise ValueError(
            f"requested {min_np} processes but hosts supply only {total} "
            f"slots: {', '.join(f'{h.hostname}:{h.slots}' for h in hosts)}")
    np_ = min(total, max_np) if max_np else min_np

    assignments: List[SlotInfo] = []
    local_sizes: Dict[str, int] = {}
    rank = 0
    for cross_rank, host in enumerate(hosts):
        if rank >= np_:
            break
        take = min(host.slots, np_ - rank)
        for local_rank in range(take):
            assignments.append(SlotInfo(
                hostname=host.hostname, rank=rank, local_rank=local_rank,
                cross_rank=cross_rank, size=0, local_size=take,
                cross_size=0))
            rank += 1
        local_sizes[host.hostname] = take
    n_hosts = len(local_sizes)
    for s in assignments:
        s.size = rank
        s.cross_size = n_hosts
    return assignments
