"""TCP service/client plumbing for launcher ⇄ worker control traffic
(``horovod_tpu/runner/network.py``).

Reference: ``horovod/runner/common/util/network.py`` (``BasicService`` /
``BasicClient`` — threaded TCP servers exchanging pickled ``Wire`` frames
authenticated with an HMAC key from ``secret.py:36``).

The data plane never touches this layer — it only carries launcher
control messages (the NIC ring probe, ``run()``'s function and results),
so a simple length-prefixed pickle-with-HMAC frame is adequate and
mirrors the reference's wire format decision.  The JAX package's elastic
messages (host updates, heartbeats, peer repair) come with the port's
elastic launch.
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
