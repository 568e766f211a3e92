"""Pre-launch NIC discovery: find interfaces every worker can route to
(``horovod_tpu/runner/driver_service.py``).

Reference: ``horovod/runner/driver/driver_service.py:124-193`` — before
fanning out the real job, the launcher starts a tiny task server on each
host; every task registers its per-interface addresses with the driver,
then task *i* is asked to probe task *i+1*'s addresses ("the ring
trick": if every consecutive pair is mutually routable on an interface
set, the full mesh is, for any symmetric network).  The launcher then
restricts rendezvous/coordinator addressing to the common interfaces
instead of hoping ``hosts[0]`` resolves from everywhere.

The port: the same ring probe over the existing ``BasicService``
control plane.  Task servers are started via the worker command path
(ssh for remote hosts, direct exec locally), so the machinery is fully
exercisable on localhost without ssh — the form the tests use.
"""

from __future__ import annotations

import array
import fcntl
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch.runner.network import (
    AckResponse,
    BasicClient,
    BasicService,
)
from horovod_tpu_torch.utils import logging as hvd_logging

PROBE_TIMEOUT_S = 5.0


def local_interface_addresses() -> Dict[str, str]:
    """``{interface: ipv4}`` for every up interface (reference
    ``get_local_host_addresses`` / psutil.net_if_addrs; implemented with
    the SIOCGIFCONF ioctl — no psutil dependency)."""
    max_ifaces = 64
    bufsz = max_ifaces * 40
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        buf = array.array("B", b"\0" * bufsz)
        ifconf = struct.pack("iL", bufsz, buf.buffer_info()[0])
        outbytes = struct.unpack("iL", fcntl.ioctl(
            s.fileno(), 0x8912, ifconf))[0]   # SIOCGIFCONF
    raw = buf.tobytes()[:outbytes]
    out: Dict[str, str] = {}
    # each record: 16-byte name + sockaddr_in (40 bytes/entry on 64-bit)
    for off in range(0, len(raw), 40):
        name = raw[off:off + 16].split(b"\0", 1)[0].decode()
        ip = socket.inet_ntoa(raw[off + 20:off + 24])
        out[name] = ip
    return out


class RegisterProbeTaskRequest:
    """Task → driver: my index and per-interface (ip, port) listeners."""

    def __init__(self, index: int, addresses: Dict[str, Tuple[str, int]]):
        self.index = index
        self.addresses = addresses


class GetProbeTargetRequest:
    """Task → driver: whom should I probe?  Blocks via polling until all
    tasks registered; the driver answers with task (index+1)'s
    addresses, or None while the ring is incomplete."""

    def __init__(self, index: int):
        self.index = index


class ProbeTargetResponse:
    def __init__(self, addresses: Optional[Dict[str, Tuple[str, int]]]):
        self.addresses = addresses


class ProbeResultRequest:
    """Task → driver: interfaces of my ring successor I could connect
    to."""

    def __init__(self, index: int, reachable_ifaces: List[str]):
        self.index = index
        self.reachable_ifaces = reachable_ifaces


class ProbeCompleteQuery:
    """Task → driver: has the whole ring reported?  Tasks must keep
    their listeners open until then — closing after one's own probe
    races the predecessor's probe of *this* task (it would see
    connection-refused and the common set would collapse to empty)."""


class ProbeCompleteResponse:
    def __init__(self, done: bool):
        self.done = done


class ProbeDriver:
    """Driver side of the ring probe (reference ``_driver_fn``)."""

    def __init__(self, ntasks: int, secret_key: Optional[str] = None):
        self._ntasks = ntasks
        self._lock = threading.Lock()
        self._addresses: Dict[int, Dict[str, Tuple[str, int]]] = {}
        self._results: Dict[int, List[str]] = {}
        self._done = threading.Event()
        self._service = BasicService("probe_driver", secret_key,
                                     self._handle, host="0.0.0.0")
        self._service.start()

    @property
    def address(self) -> Tuple[str, int]:
        return self._service.address

    def _handle(self, req):
        if isinstance(req, RegisterProbeTaskRequest):
            with self._lock:
                self._addresses[req.index] = dict(req.addresses)
            return AckResponse()
        if isinstance(req, GetProbeTargetRequest):
            with self._lock:
                if len(self._addresses) < self._ntasks:
                    return ProbeTargetResponse(None)
                succ = (req.index + 1) % self._ntasks
                return ProbeTargetResponse(self._addresses[succ])
        if isinstance(req, ProbeResultRequest):
            with self._lock:
                self._results[req.index] = list(req.reachable_ifaces)
                if len(self._results) == self._ntasks:
                    self._done.set()
            return AckResponse()
        if isinstance(req, ProbeCompleteQuery):
            return ProbeCompleteResponse(self._done.is_set())
        raise ValueError(f"unexpected request {type(req).__name__}")

    def wait_common_interfaces(self, timeout_s: float = 60.0) -> List[str]:
        """Block until every ring probe reported; return the interfaces
        reachable on EVERY hop (reference ``get_common_interfaces``,
        ``driver_service.py:193``)."""
        if not self._done.wait(timeout_s):
            with self._lock:
                missing = [i for i in range(self._ntasks)
                           if i not in self._results]
            raise TimeoutError(
                f"NIC probe incomplete after {timeout_s}s; no result from "
                f"task(s) {missing} — host(s) unreachable or blocked. "
                f"If a previous launch cached discovery results for "
                f"these hosts (~/.cache/horovod_tpu_torch/"
                f"discovery_cache.json), a stale entry may be "
                f"addressing a moved host: retry with --disable-cache "
                f"or delete the cache file")
        with self._lock:
            common = None
            for ifaces in self._results.values():
                s = set(ifaces)
                common = s if common is None else (common & s)
        if not common:
            raise RuntimeError(
                "No network interface is routable between all hosts "
                "(reference driver_service.py mutual-routability check)")
        return sorted(common)

    def task_address(self, index: int) -> Dict[str, Tuple[str, int]]:
        with self._lock:
            return dict(self._addresses[index])

    def shutdown(self) -> None:
        self._service.shutdown()


#: the probe's connect retry: the JAX package's default policy (5 tries,
#: each sleep uniform in ``[0, min(5, 0.1 · 2^attempt)]`` s) under its
#: probe's 30 s deadline
PROBE_ATTEMPTS, PROBE_BASE_S, PROBE_MAX_S, PROBE_DEADLINE_S = 5, 0.1, 5.0, 30.0


def _connect_driver(driver_addrs: str, secret_key: Optional[str]
                    ) -> BasicClient:
    """Try each candidate driver address (comma-separated ``ip:port``)
    until one answers a ping — the driver advertises every local
    interface because its hostname may not resolve from worker hosts
    (the reference hands tasks the full driver address list,
    ``driver_service.py:49-84``).  The scan is retried with
    backoff+jitter under the unified policy: a probe task often races
    the driver's own bind, and one refused connect must not fail the
    whole NIC discovery."""
    from horovod_tpu_torch.runtime.retry import RetryPolicy

    def scan() -> BasicClient:
        from horovod_tpu_torch import faults

        # chaos hook: a transient OSError here exercises the retry
        # policy exactly as a refused connect during driver bind does
        faults.inject("probe.connect")
        last_err: Optional[Exception] = None
        for addr in driver_addrs.split(","):
            host, port = addr.rsplit(":", 1)
            client = BasicClient((host, int(port)), secret_key,
                                 timeout_s=5.0)
            try:
                if client.ping():
                    return client
            except OSError as e:
                last_err = e
        raise ConnectionError(
            f"probe task could not reach the driver at any of "
            f"[{driver_addrs}]: {last_err}")

    return RetryPolicy(max_attempts=PROBE_ATTEMPTS, base_s=PROBE_BASE_S,
                       max_s=PROBE_MAX_S, deadline_s=PROBE_DEADLINE_S,
                       retry_on=(OSError,), name="driver-probe").call(scan)


def run_probe_task(driver_addrs: str, index: int,
                   secret_key: Optional[str] = None) -> None:
    """Task side: bind one listener per interface, register, probe the
    ring successor, report (reference ``task_fn.py`` + routability probe
    ``driver_service.py:124-190``)."""
    listeners: Dict[str, socket.socket] = {}
    addresses: Dict[str, Tuple[str, int]] = {}
    for iface, ip in local_interface_addresses().items():
        try:
            srv = socket.socket()
            srv.bind((ip, 0))
            srv.listen(8)
            listeners[iface] = srv
            addresses[iface] = (ip, srv.getsockname()[1])
        except OSError:
            continue

    accepting = True

    def accept_loop(srv: socket.socket) -> None:
        srv.settimeout(0.5)
        while accepting:
            try:
                conn, _ = srv.accept()
                conn.close()
            except socket.timeout:
                continue
            except OSError:
                return

    threads = [threading.Thread(target=accept_loop, args=(srv,),
                                daemon=True) for srv in listeners.values()]
    for t in threads:
        t.start()

    client = _connect_driver(driver_addrs, secret_key)
    client.request(RegisterProbeTaskRequest(index, addresses))
    target = None
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        resp = client.request(GetProbeTargetRequest(index))
        if resp.addresses is not None:
            target = resp.addresses
            break
        time.sleep(0.2)
    reachable = []
    if target is not None:
        for iface, (ip, tport) in target.items():
            try:
                with socket.create_connection((ip, tport),
                                              timeout=PROBE_TIMEOUT_S):
                    reachable.append(iface)
            except OSError:
                hvd_logging.debug("probe: %s (%s:%d) unreachable",
                                  iface, ip, tport)
    client.request(ProbeResultRequest(index, reachable))
    # hold listeners until the whole ring reported — the predecessor may
    # not have probed this task yet
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        try:
            if client.request(ProbeCompleteQuery()).done:
                break
        except OSError:
            break   # driver gone: discovery concluded or aborted
        time.sleep(0.2)
    accepting = False
    for srv in listeners.values():
        srv.close()


def discover_common_interfaces(hostnames: List[str], spawn_task,
                               secret_key: Optional[str] = None,
                               timeout_s: float = 60.0):
    """Run the full ring probe: start the driver, spawn one probe task
    per host via ``spawn_task(host, index, driver_addrs)``, and return
    ``(common_interfaces, driver)``.  ``driver_addrs`` is the
    comma-separated candidate list of every driver interface IP — the
    launcher's hostname may not resolve from worker hosts.  The caller
    reads coordinator addressing from ``driver.task_address(0)``
    restricted to the common set, then shuts the driver down."""
    driver = ProbeDriver(len(hostnames), secret_key)
    port = driver.address[1]
    daddrs = ",".join(f"{ip}:{port}"
                      for ip in local_interface_addresses().values())
    for idx, host in enumerate(hostnames):
        spawn_task(host, idx, daddrs)
    common = driver.wait_common_interfaces(timeout_s)
    return common, driver


def probe_common_and_rank0(hostnames: List[str], spawn_task,
                           secret_key: Optional[str] = None,
                           timeout_s: float = 60.0, cache=None,
                           validate_port: int = 22):
    """``(common_interfaces, {iface: rank0_ip})`` — the two facts a
    launcher consumes from the ring probe — with an optional on-disk TTL
    cache (reference ``runner/util/cache.py``: repeated launches against
    the same host set skip the ssh + probe round trip; an expired or
    missing entry re-probes).  Only interface/IP facts are cached —
    ports are per-run ephemera.

    A hit is trusted only after a cheap TCP connect to a cached rank-0
    IP (``validate_port``, normally the ssh port the launcher will use
    anyway): hosts can re-IP inside the TTL, and a stale address would
    otherwise surface as a full startup-timeout hang instead of one
    extra probe round trip."""
    params = {"probe": hostnames}
    if cache is not None:
        hit = cache.get(params)
        if hit is not None:
            from horovod_tpu_torch.runner.cache import tcp_reachable

            ips = sorted(set(hit["rank0"].values()))
            if any(tcp_reachable(ip, validate_port) for ip in ips):
                hvd_logging.debug("NIC discovery: warm cache hit for %s",
                                  hostnames)
                return hit["common"], hit["rank0"]
            hvd_logging.info(
                "NIC discovery: cached rank-0 IP(s) %s failed the TCP "
                "liveness check; falling through to a fresh probe", ips)
    common, driver = discover_common_interfaces(
        hostnames, spawn_task, secret_key, timeout_s)
    try:
        rank0 = {iface: addr[0]
                 for iface, addr in driver.task_address(0).items()}
    finally:
        driver.shutdown()
    if cache is not None:
        cache.put(params, {"common": common, "rank0": rank0})
    return common, rank0
