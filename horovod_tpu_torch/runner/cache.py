"""On-disk TTL cache for launch-time discovery results
(``horovod_tpu/runner/cache.py``).

Reference: ``horovod/runner/util/cache.py`` — the launcher memoizes
expensive pre-flight discovery (NIC routability probes) in a JSON file
under the user's cache dir, keyed by the call parameters, with entries
expiring after a staleness threshold; ``--disable-cache`` bypasses it.
Repeated launches against the same host set then skip the multi-second
ssh + ring-probe round trip.  The port keeps its entries in a directory of
its own (``horovod_tpu_torch``), so that the two packages' caches never
mix.
"""

from __future__ import annotations

import json
import os
import socket
import time
from typing import Any, Optional

from horovod_tpu_torch.utils import logging as hvd_logging

DEFAULT_TTL_S = 600.0
_TTL_ENV = "HOROVOD_TPU_DISCOVERY_CACHE_TTL"


def tcp_reachable(ip: str, port: int = 22, timeout_s: float = 1.0) -> bool:
    """Cheap liveness check for a cached rank-0 IP: one TCP connect.

    A completed handshake proves the host is up and routable; so does a
    REFUSED connect (the RST came *from that host* — nothing listening
    on ``port`` is fine, we only validate addressing).  Only a timeout
    or a routing error (host renumbered, NIC gone, network moved) marks
    the cached IP stale.  Well inside the TTL a host can re-IP — DHCP
    churn, pod rescheduling — and a launcher that trusts the entry then
    burns the full startup timeout; one connect costs ~an RTT."""
    try:
        with socket.create_connection((ip, port), timeout=timeout_s):
            return True
    except ConnectionRefusedError:
        return True
    except OSError:
        return False


def _default_path() -> str:
    root = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(root, "horovod_tpu_torch", "discovery_cache.json")


class DiscoveryCache:
    """``{key: (timestamp, value)}`` in one JSON file.

    Keys are JSON-serialized (sorted) parameter dicts; values must be
    JSON-serializable.  The file is re-read on every ``get`` — launches
    are seconds apart, not microseconds, and rereads keep concurrent
    launchers coherent enough (last-writer-wins, same as the
    reference's fcntl-less fallback behavior)."""

    def __init__(self, path: Optional[str] = None,
                 ttl_s: Optional[float] = None):
        self._path = path or _default_path()
        self._ttl = ttl_s if ttl_s is not None else \
            float(os.environ.get(_TTL_ENV, DEFAULT_TTL_S))

    @staticmethod
    def _key(params: Any) -> str:
        return json.dumps(params, sort_keys=True)

    def _load(self) -> dict:
        try:
            with open(self._path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def get(self, params: Any):
        """The cached value for ``params``, or None when missing or
        older than the TTL."""
        entry = self._load().get(self._key(params))
        if not entry:
            return None
        ts, value = entry
        if time.time() - ts > self._ttl:
            return None
        return value

    def put(self, params: Any, value: Any) -> None:
        data = self._load()
        data[self._key(params)] = (time.time(), value)
        try:
            os.makedirs(os.path.dirname(self._path), exist_ok=True)
            tmp = self._path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(data, f)
            os.replace(tmp, self._path)    # atomic vs concurrent readers
        except OSError as e:
            hvd_logging.debug("discovery cache write failed: %s", e)
