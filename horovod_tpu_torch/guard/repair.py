"""Peer state repair: restore a diverged-but-alive worker over RPC (a copy
of ``horovod_tpu/guard/repair.py``).

A worker named by a divergence verdict holds poisoned parameters, but
its process, its card and its driver registration are all fine.
Restarting it through the elastic path (generation bump, rendezvous,
cold checkpoint load) throws that away.  Instead the diverged worker:

1. asks the driver for a healthy peer (:func:`request_healthy_peer` —
   the driver picks a registered, non-suspect worker of another rank);
2. fetches that peer's committed ``(step, state)`` snapshot directly
   over the existing notification channel (:func:`fetch_peer_state` —
   the peer's :class:`WorkerNotificationManager` serves it from the
   provider installed via ``set_state_provider``);
3. adopts it and rejoins the lockstep replay.  With a
   :class:`~horovod_tpu_torch.elastic.TorchState` the snapshot holds the
   model's and the optimizer's ``state_dict`` tensors, on the host.

Disk is never touched: the healthy peer's in-memory committed state is
newer than (or equal to) the last checkpoint and already verified by
the same checksum vote that caught the divergence.
"""

from __future__ import annotations

import logging
from typing import Any, Optional, Tuple

from horovod_tpu_torch import faults
from horovod_tpu_torch.runner.network import (
    BasicClient,
    FetchStateRequest,
    GetHealthyPeerRequest,
    PeerAddressResponse,
    StateSnapshotResponse,
)

logger = logging.getLogger("horovod_tpu_torch.guard")


def _split_addr(addr: str) -> Tuple[str, int]:
    host, port = addr.rsplit(":", 1)
    return host, int(port)


def request_healthy_peer(driver_addr: str, key: bytes, host: str,
                         local_rank: int, rank: int,
                         timeout_s: float = 30.0
                         ) -> Optional[Tuple[str, int]]:
    """Ask the driver for a healthy peer's notification address;
    returns ``(host, port)`` or None when no healthy peer exists."""
    client = BasicClient(_split_addr(driver_addr), key, timeout_s=timeout_s)
    resp = client.request(
        GetHealthyPeerRequest(host=host, local_rank=local_rank, rank=rank))
    if not isinstance(resp, PeerAddressResponse) or resp.address is None:
        return None
    return tuple(resp.address)


def fetch_peer_state(peer_addr: Tuple[str, int], key: bytes,
                     timeout_s: float = 60.0
                     ) -> Optional[Tuple[int, Any]]:
    """Fetch the peer's committed ``(step, state)`` snapshot; returns
    None if the peer has no provider installed (no committed state)."""
    faults.inject("guard.repair")
    client = BasicClient(tuple(peer_addr), key, timeout_s=timeout_s)
    resp = client.request(FetchStateRequest())
    if not isinstance(resp, StateSnapshotResponse) or resp.state is None:
        return None
    return int(resp.step), resp.state


def repair_from_peer(driver_addr: str, key: bytes, host: str,
                     local_rank: int, rank: int,
                     timeout_s: float = 60.0
                     ) -> Optional[Tuple[int, Any]]:
    """Full repair round-trip: locate a healthy peer via the driver,
    then pull its committed snapshot.  Returns ``(step, state)`` to
    adopt, or None when no peer (or no snapshot) is available — the
    caller then falls back to checkpoint rollback."""
    peer = request_healthy_peer(driver_addr, key, host, local_rank, rank,
                                timeout_s=timeout_s)
    if peer is None:
        logger.warning("peer repair: no healthy peer available, "
                       "falling back to checkpoint rollback")
        return None
    snap = fetch_peer_state(peer, key, timeout_s=timeout_s)
    if snap is None:
        logger.warning("peer repair: peer %s had no committed state", peer)
        return None
    logger.info("peer repair: adopted state @ step %d from %s",
                snap[0], peer)
    return snap
