"""TCP service/client plumbing for launcher ⇄ worker control traffic
(``horovod_tpu/runner/network.py``).

Reference: ``horovod/runner/common/util/network.py`` (``BasicService`` /
``BasicClient`` — threaded TCP servers exchanging pickled ``Wire`` frames
authenticated with an HMAC key from ``secret.py:36``).

The data plane never touches this layer — it only carries launcher
control messages (the NIC ring probe, ``run()``'s function and results,
and the elastic driver's worker registration, host-update pings,
heartbeats and peer state fetches), so a simple length-prefixed
pickle-with-HMAC frame is adequate and mirrors the reference's wire
format decision.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import pickle
import socket
import socketserver
import struct
import threading
from typing import Any, Callable, Optional, Tuple

from horovod_tpu_torch.utils import logging as hvd_logging

_HMAC_DIGEST = hashlib.sha256
_HMAC_LEN = 32
_MAX_FRAME = 64 * 1024 * 1024


def make_secret_key() -> str:
    """Random per-run HMAC key (reference ``secret.py:make_secret_key``)."""
    return os.urandom(32).hex()


class Wire:
    """Length-prefixed pickle frame with HMAC (reference ``network.py`` Wire).
    A frame is unpickled only after its HMAC verified."""

    def __init__(self, key: Optional[str]):
        self._key = key.encode() if key else b""

    def write(self, sock: socket.socket, obj: Any) -> None:
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        digest = hmac.new(self._key, payload, _HMAC_DIGEST).digest()
        sock.sendall(struct.pack("!I", len(payload)) + digest + payload)

    def read(self, sock: socket.socket) -> Any:
        header = self._read_exact(sock, 4 + _HMAC_LEN)
        (length,) = struct.unpack("!I", header[:4])
        if length > _MAX_FRAME:
            raise IOError(f"frame too large: {length}")
        digest = header[4:]
        payload = self._read_exact(sock, length)
        expected = hmac.new(self._key, payload, _HMAC_DIGEST).digest()
        if not hmac.compare_digest(digest, expected):
            raise PermissionError("HMAC verification failed — secret key "
                                  "mismatch between launcher and worker")
        return pickle.loads(payload)

    @staticmethod
    def _read_exact(sock: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise EOFError("connection closed mid-frame")
            buf += chunk
        return buf


class PingRequest:
    pass


class PingResponse:
    def __init__(self, service_name: str):
        self.service_name = service_name


class AckResponse:
    pass


class HostsUpdatedRequest:
    """Driver → worker: the discovered host set changed (reference
    ``runner/elastic/worker.py`` HostsUpdatedRequest).  ``generation`` is
    the world generation the change made (-1: not stated): a worker that
    already runs in it has nothing to interrupt for."""

    def __init__(self, timestamp: int, res: int = 0, generation: int = -1):
        self.timestamp = timestamp
        self.res = res
        self.generation = generation


class RegisterWorkerRequest:
    """Worker → driver: notification-service address registration."""

    def __init__(self, rank: int, address: Tuple[str, int]):
        self.rank = rank
        self.address = address


class WorkerReadyRequest:
    """Worker → driver: this worker finished startup and entered the
    elastic training loop (reference ``WorkerStateRegistry`` READY
    barrier, ``runner/elastic/registration.py`` — worker-reported, so a
    worker hung in startup is distinguishable from a healthy one)."""

    def __init__(self, host: str, local_rank: int):
        self.host = host
        self.local_rank = local_rank


class HeartbeatRequest:
    """Worker → driver: periodic liveness beat, piggybacking the
    training step counter so the driver's progress watchdog can tell a
    hung-but-alive rank from a healthy one (``elastic/health.py``) and,
    when telemetry is enabled, the rank's counter snapshot so the
    driver aggregates per-worker metrics with no extra RPC
    (docs/metrics.md; the driver reads ``metrics`` via ``getattr`` so
    old workers interoperate)."""

    def __init__(self, host: str, local_rank: int, step: int = -1,
                 metrics: Optional[dict] = None):
        self.host = host
        self.local_rank = local_rank
        self.step = step
        self.metrics = metrics


class PlannedDepartureRequest:
    """Worker → driver: this worker is being preempted and will exit
    after committing a priority checkpoint (guard/preempt.py).  The
    driver marks it departing so the HealthMonitor stops counting it
    toward death verdicts and its exit skips blacklist/quarantine."""

    def __init__(self, host: str, local_rank: int, step: int = -1):
        self.host = host
        self.local_rank = local_rank
        self.step = step


class GetHealthyPeerRequest:
    """Diverged worker → driver: name a healthy peer (another rank,
    not suspect/departing) whose notification service can serve a
    state snapshot for peer repair (guard/repair.py)."""

    def __init__(self, host: str, local_rank: int, rank: int):
        self.host = host
        self.local_rank = local_rank
        self.rank = rank


class PeerAddressResponse:
    """Driver → worker: a healthy peer's rank and notification address
    (``address`` None when no healthy peer exists)."""

    def __init__(self, rank: int = -1,
                 address: Optional[Tuple[str, int]] = None):
        self.rank = rank
        self.address = address


class FetchStateRequest:
    """Diverged worker → healthy peer: send your committed state."""


class StateSnapshotResponse:
    """Healthy peer → diverged worker: committed ``(step, state)``
    snapshot (``state`` None when the peer has nothing committed)."""

    def __init__(self, step: int = -1, state: Any = None):
        self.step = step
        self.state = state


class BasicService:
    """Threaded TCP server dispatching pickled requests to a handler
    (reference ``BasicService``, ``network.py:268``)."""

    def __init__(self, name: str, key: Optional[str],
                 handler: Callable[[Any], Any], host: str = "0.0.0.0"):
        self._name = name
        self._wire = Wire(key)
        self._handler = handler
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    req = outer._wire.read(self.request)
                    if isinstance(req, PingRequest):
                        resp = PingResponse(outer._name)
                    else:
                        resp = outer._handler(req)
                    outer._wire.write(self.request, resp)
                except (EOFError, ConnectionError):
                    pass
                except PermissionError as e:
                    hvd_logging.warning("%s: rejected request: %s",
                                        outer._name, e)

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, 0), _Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True,
                                        name=f"hvd_torch_{name}_service")

    def start(self) -> None:
        self._thread.start()

    @property
    def address(self) -> Tuple[str, int]:
        host, port = self._server.server_address[:2]
        if host == "0.0.0.0":
            host = socket.gethostname()
        return (host, port)

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class BasicClient:
    """One-shot request/response client (reference ``BasicClient``)."""

    def __init__(self, address: Tuple[str, int], key: Optional[str],
                 timeout_s: float = 30.0):
        self._address = tuple(address)
        self._wire = Wire(key)
        self._timeout_s = timeout_s

    def request(self, obj: Any) -> Any:
        with socket.create_connection(self._address,
                                      timeout=self._timeout_s) as sock:
            self._wire.write(sock, obj)
            return self._wire.read(sock)

    def ping(self) -> bool:
        try:
            return isinstance(self.request(PingRequest()), PingResponse)
        except OSError:
            return False


class NotificationServer:
    """Worker-side listener for HostsUpdated pings (reference
    ``WorkerNotificationService``)."""

    def __init__(self, manager, key: Optional[str]):
        def handle(req):
            if isinstance(req, HostsUpdatedRequest):
                manager.handle_hosts_updated(
                    req.timestamp, req.res, getattr(req, "generation", -1))
                return AckResponse()
            if isinstance(req, FetchStateRequest):
                # peer-repair fetch (guard/repair.py) — served from the
                # provider the manager registered, if any
                fetch = getattr(manager, "handle_fetch_state", None)
                snap = fetch() if fetch is not None else None
                if snap is None:
                    return StateSnapshotResponse()
                return StateSnapshotResponse(step=snap[0], state=snap[1])
            raise ValueError(f"unexpected request {type(req).__name__}")

        self._service = BasicService("worker_notification", key, handle)

    def start(self) -> None:
        self._service.start()

    @property
    def address(self) -> Tuple[str, int]:
        return self._service.address

    def shutdown(self) -> None:
        self._service.shutdown()


def notify_worker_registered(driver_addr: str, worker_addr: Tuple[str, int],
                             key: Optional[str]) -> None:
    """Register this worker's notification address with the elastic driver.

    ``driver_addr`` is "host:port" from ``HOROVOD_ELASTIC_DRIVER_ADDR``.
    """
    host, port = driver_addr.rsplit(":", 1)
    rank = int(os.environ.get("HOROVOD_RANK", "0"))
    BasicClient((host, int(port)), key).request(
        RegisterWorkerRequest(rank, tuple(worker_addr)))


def notify_hosts_updated(worker_addr: Tuple[str, int], key: Optional[str],
                         timestamp: int, res: int = 0,
                         generation: int = -1) -> None:
    """Driver-side: ping one worker that the host set changed, making
    world generation ``generation``."""
    BasicClient(tuple(worker_addr), key).request(
        HostsUpdatedRequest(timestamp, res, generation))


def notify_worker_ready(driver_addr: str, key: Optional[str],
                        host: str, local_rank: int) -> None:
    """Worker-side: report READY to the elastic driver's registry."""
    dhost, port = driver_addr.rsplit(":", 1)
    BasicClient((dhost, int(port)), key).request(
        WorkerReadyRequest(host, local_rank))


def notify_planned_departure(driver_addr: str, key: Optional[str],
                             host: str, local_rank: int,
                             step: int = -1) -> None:
    """Worker-side: announce a preemption-driven departure so the
    driver treats the coming exit as planned (no blacklist, no
    quarantine, no death verdict)."""
    dhost, port = driver_addr.rsplit(":", 1)
    BasicClient((dhost, int(port)), key, timeout_s=5.0).request(
        PlannedDepartureRequest(host, local_rank, step))


def notify_heartbeat(driver_addr: str, key: Optional[str],
                     host: str, local_rank: int, step: int = -1,
                     metrics: Optional[dict] = None) -> None:
    """Worker-side: one liveness beat to the elastic driver (short
    timeout — a slow beat must not back the sender thread up)."""
    dhost, port = driver_addr.rsplit(":", 1)
    BasicClient((dhost, int(port)), key, timeout_s=5.0).request(
        HeartbeatRequest(host, local_rank, step, metrics=metrics))
