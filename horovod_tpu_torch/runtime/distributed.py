"""The elastic world's coordination store (``horovod_tpu/runtime/
distributed.py``).

A process group rendezvouses through a key-value store.  In a plain
launch that store lives in rank 0 (``init_method="tcp://..."``): if
rank 0 dies, every other rank loses it.  Elastic training must survive
any rank's death, so, as the reference's rendezvous server lives in the
launcher (``gloo_run.py:213 RendezvousServer``) and the JAX package's
coordination service in its driver, the port keeps the store in the
elastic **driver**:

* the driver hosts one ``torch.distributed.TCPStore`` (``is_master``) per
  world generation (:func:`start_coordination_service`) at the
  generation's coordinator address, which it hands out with each
  worker's assignment;
* **workers** join it with :func:`connect_elastic_client` and
  ``init_process_group(store=...)`` on it (``runtime/state.py``) under
  the rendezvous's :func:`start_timeout`, then give the gloo groups the
  short :func:`elastic_timeout`, so that a collective with a dead peer
  raises in the caller instead of hanging, and the NCCL groups
  :func:`watchdog_timeout`: on a card the host waits for the exchange
  with the short deadline itself (:func:`await_event`), and the elastic
  loop aborts the dead world's groups before anything else waits on
  them;
* :func:`disconnect_elastic_client` leaves it on reset without a
  barrier (a barrier would wait on the dead peers).

A dead peer surfaces as a ``RuntimeError`` or ``DistBackendError`` from
the collective (gloo: "Connection closed by peer"; NCCL: the timeout or
the aborted communicator), which the exchange, the eager plane and the
step turn into ``HorovodInternalError`` (:func:`raise_internal`), and
the elastic retry loop recovers.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import threading
import time

from horovod_tpu_torch.exceptions import HorovodInternalError
from horovod_tpu_torch.utils import logging as hvd_logging

# snappy failure detection for elastic worlds, as the JAX package's
DEFAULT_HEARTBEAT_TIMEOUT_S = 10


def elastic_timeout() -> datetime.timedelta:
    """The collectives' timeout in an elastic world:
    ``HOROVOD_ELASTIC_HEARTBEAT_TIMEOUT`` seconds (default 10)."""
    return datetime.timedelta(seconds=float(os.environ.get(
        "HOROVOD_ELASTIC_HEARTBEAT_TIMEOUT", DEFAULT_HEARTBEAT_TIMEOUT_S)))


def start_timeout() -> datetime.timedelta:
    """The rendezvous's timeout in an elastic world: a new generation's
    joiners start their processes while its survivors wait for them, so
    the groups are made under ``HOROVOD_ELASTIC_START_TIMEOUT`` seconds
    (default 120, the driver's start timeout) and
    :func:`shorten_timeouts` then gives them :func:`elastic_timeout`."""
    return datetime.timedelta(seconds=float(os.environ.get(
        "HOROVOD_ELASTIC_START_TIMEOUT", 120.0)))


#: an NCCL group's own timeout, in elastic timeouts: the watchdog is the
#: backstop, behind the host's deadline (:func:`await_event`)
WATCHDOG_FACTOR = 6


def watchdog_timeout() -> datetime.timedelta:
    """The timeout of an elastic world's NCCL groups: ``WATCHDOG_FACTOR``
    elastic timeouts.  The host waits for a collective one elastic
    timeout (:func:`collective_deadline_s`) and then aborts the world's
    groups; that abort must come before NCCL's watchdog catches the
    timeout itself: on four H100s (torch 2.11, NCCL 2.27) an abort made
    after the watchdog had caught a dead peer's timeout never returned,
    and one made before it returned in 0.66 s."""
    return elastic_timeout() * WATCHDOG_FACTOR


def shorten_timeouts(world, host_group) -> tuple:
    """Give the world's groups (every rank has joined them) their elastic
    timeouts: :func:`elastic_timeout` to the gloo groups, whose
    collectives then raise in the caller, and :func:`watchdog_timeout` to
    an NCCL world.  Returns ``(timeout, device_timeout)``: the gloo
    groups', and that of groups made later on the world's backend."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    timeout = elastic_timeout()
    device_timeout = timeout if dist.get_backend(world) == "gloo" \
        else watchdog_timeout()
    c10d._set_pg_timeout(device_timeout, world)
    if host_group is not None and host_group is not world:
        c10d._set_pg_timeout(timeout, host_group)
    return timeout, device_timeout


class CoordinationService:
    """Driver-side store handle (one per generation)."""

    def __init__(self, port: int, num_processes: int,
                 heartbeat_timeout: int = DEFAULT_HEARTBEAT_TIMEOUT_S):
        import torch.distributed as dist

        # the store serves joins for as long as the generation lives; the
        # heartbeat timeout bounds a client's wait on a key
        self._store = dist.TCPStore(
            "0.0.0.0", port, None, True,
            timeout=datetime.timedelta(seconds=max(heartbeat_timeout, 60)),
            wait_for_workers=False)
        self.port = self._store.port      # the bound one, given port 0
        self.num_processes = num_processes

    def shutdown(self) -> None:
        self._store = None


def start_coordination_service(
        port: int, num_processes: int,
        heartbeat_timeout: int = DEFAULT_HEARTBEAT_TIMEOUT_S,
) -> CoordinationService:
    return CoordinationService(port, num_processes, heartbeat_timeout)


_client_lock = threading.Lock()
_live_client = None


def connect_elastic_client(coordinator_addr: str, num_processes: int,
                           process_id: int, init_timeout: int = 120):
    """Worker-side: join the driver-hosted store at ``coordinator_addr``
    (``host:port``), retrying a refused connect (the driver mid-bind) on
    a fresh client; returns the store, which :func:`client_store` hands
    out until :func:`disconnect_elastic_client`."""
    global _live_client
    import torch.distributed as dist

    host, port = coordinator_addr.rsplit(":", 1)

    def _connect():
        from horovod_tpu_torch import faults

        faults.inject("coordinator.connect")
        return dist.TCPStore(
            host, int(port), None, False,
            timeout=datetime.timedelta(seconds=init_timeout))

    from horovod_tpu_torch.runtime.retry import default_policy

    store = default_policy(name="coordinator-connect",
                           retry_on=(OSError, TimeoutError, RuntimeError),
                           deadline_s=float(init_timeout)).call(_connect)
    with _client_lock:
        _live_client = store
    hvd_logging.info(
        "elastic: joined the driver-hosted store %s as process %d of %d",
        coordinator_addr, process_id, num_processes)
    return store


def client_store():
    """The store :func:`connect_elastic_client` joined, or None."""
    with _client_lock:
        return _live_client


def disconnect_elastic_client() -> None:
    """Leave the current generation's store, without a barrier."""
    global _live_client
    with _client_lock:
        _live_client = None


def elastic_client_active() -> bool:
    with _client_lock:
        return _live_client is not None


def world_store():
    """The store every rank of the world reaches without a collective, for
    the runtime tools' out-of-band keys (the timeline's aggregation, the
    stall inspector's status): the elastic driver's (:func:`client_store`),
    else the default process group's, else None."""
    store = client_store()
    if store is not None:
        return store
    import torch.distributed as dist

    if not dist.is_initialized():
        return None
    from torch.distributed import distributed_c10d as c10d

    try:
        return c10d._get_default_store()
    except (RuntimeError, ValueError):
        return None


def await_event(event, what: str, timeout_s: float,
                poll_s: float = 0.0002) -> None:
    """Block the host until ``event`` (a ``torch.cuda.Event`` recorded
    after the collectives to wait for) has completed, or raise
    ``HorovodInternalError`` once ``timeout_s`` has passed.

    NCCL's own watchdog does not bound the wait of a host that reads a
    result behind a collective a dead peer never joined (the survivors
    read a loss 70 s after a kill, with a 10 s group timeout): the host
    waits here instead, off the stream, so that the elastic loop can
    restore and abort the dead world's groups (``runtime/state.py``)."""
    deadline = time.monotonic() + timeout_s
    while not event.query():
        if time.monotonic() > deadline:
            raise HorovodInternalError(
                f"{what} did not complete within {timeout_s:g} s, the "
                f"world's collective timeout: a peer may have died")
        time.sleep(poll_s)


def await_stream(device, what: str) -> None:
    """In an elastic world on a card (:func:`collective_deadline_s` not
    None), block the host until the work queued so far on ``device``'s
    current stream, the collectives just issued among it, has completed,
    or raise ``HorovodInternalError`` at the deadline
    (:func:`await_event`); elsewhere return at once."""
    deadline = collective_deadline_s()
    if deadline is None:
        return
    import torch

    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    await_event(done, what, deadline)


def collective_deadline_s():
    """The host's deadline for a collective of the current world: the
    elastic timeout in an elastic world of more than one rank on a card,
    else None (no host-side wait: torch's timeout governs)."""
    from horovod_tpu_torch.runtime import state

    if not state.is_initialized():
        return None
    st = state.global_state()
    if st.size == 1 or not st.config.elastic_enabled or \
            st.device.type != "cuda" or st.timeout is None:
        return None
    return st.timeout.total_seconds()


#: the errors a collective raises when a peer died or the group was
#: aborted (``DistBackendError`` is a ``RuntimeError``)
PEER_ERRORS = (RuntimeError, ConnectionError, TimeoutError)


@contextlib.contextmanager
def raise_internal(what: str):
    """Turn a collective's peer failure into ``HorovodInternalError``, the
    exception the elastic retry loop recovers from; every other error
    passes as it is."""
    try:
        yield
    except HorovodInternalError:
        raise
    except PEER_ERRORS as e:
        if isinstance(e, (NotImplementedError, RecursionError)) or \
                not _peer_failure(e):
            raise
        raise HorovodInternalError(f"{what}: {e}") from e


#: fragments of the messages of torch.distributed's peer failures that
#: come as a plain ``RuntimeError`` (gloo's closed or reset connections
#: and timeouts; NCCL's raise ``DistBackendError``)
_PEER_MARKERS = ("connection closed", "connection reset", "broken pipe",
                 "timed out", "timeout", "aborted", "peer", "read error",
                 "write error")


def _peer_failure(e: BaseException) -> bool:
    text = f"{type(e).__name__}: {e}".lower()
    return type(e).__name__ in ("DistBackendError", "DistNetworkError",
                                "DistStoreError") or \
        isinstance(e, (ConnectionError, TimeoutError)) or \
        any(m in text for m in _PEER_MARKERS)
