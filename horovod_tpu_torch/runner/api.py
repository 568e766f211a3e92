"""Programmatic launcher: ``horovod_tpu_torch.runner.run(fn, ...)``
(``horovod_tpu/runner/api.py``).

Reference: ``horovod/runner/__init__.py:90`` — pickle ``fn``, launch the
distributed job, collect and return the per-rank return values (tested
by ``test/test_interactiverun.py``).  The function travels and the
results return over the launcher's HMAC-authenticated
:class:`~horovod_tpu_torch.runner.network.BasicService` (the
KVStoreServer analogue, ``runner/http/http_server.py``).

The function is pickled with ``cloudpickle`` where it is installed, which
carries closures and lambdas by value.  Without it ``pickle`` carries a
module-level function by reference, and a closure raises an error that
names ``cloudpickle``.
"""

from __future__ import annotations

import os
import pickle
import sys
import threading
from typing import Any, Callable, List, Optional

from horovod_tpu_torch.runner import launch as launch_mod
from horovod_tpu_torch.runner.network import (
    AckResponse,
    BasicClient,
    BasicService,
    make_secret_key,
)


class GetFuncRequest:
    pass


class FuncResponse:
    def __init__(self, payload: bytes):
        self.payload = payload


class ResultRequest:
    def __init__(self, rank: int, payload: bytes):
        self.rank = rank
        self.payload = payload


def dumps_function(fn: Callable, args=(), kwargs=None) -> bytes:
    """``(fn, args, kwargs)`` as the bytes a worker loads with
    ``pickle.loads``."""
    job = (fn, tuple(args), dict(kwargs or {}))
    try:
        import cloudpickle
    except ImportError:
        try:
            return pickle.dumps(job)
        except (pickle.PicklingError, AttributeError, TypeError) as e:
            raise TypeError(
                f"run() sends {fn!r} to its workers with pickle, which "
                f"carries a function by its module and name only; a "
                f"closure, lambda or nested function needs cloudpickle, "
                f"which is not installed: {e}") from e
    return cloudpickle.dumps(job)


def run(fn: Callable, args=(), kwargs=None, np: int = 1,
        hosts: Optional[str] = None, verbose: bool = False,
        extra_env: Optional[dict] = None) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` on ``np`` workers; returns the list of
    per-rank return values in rank order.  ``extra_env`` is set for the
    workers and restored in this process afterwards."""
    payload = dumps_function(fn, args, kwargs)
    key = make_secret_key()
    results: dict = {}
    lock = threading.Lock()
    done = threading.Event()

    def handler(req):
        if isinstance(req, GetFuncRequest):
            return FuncResponse(payload)
        if isinstance(req, ResultRequest):
            with lock:
                results[req.rank] = pickle.loads(req.payload)
                if len(results) == np:
                    done.set()
            return AckResponse()
        raise ValueError(f"unexpected request {type(req).__name__}")

    service = BasicService("run_service", key, handler, host="127.0.0.1")
    service.start()
    env = {"HOROVOD_RUN_SERVICE_ADDR": f"127.0.0.1:{service.port}",
           "HOROVOD_RUN_SECRET": key, **(extra_env or {})}
    saved = {k: os.environ.get(k) for k in env}
    try:
        argv = ["-np", str(np)]
        if hosts:
            argv += ["-H", hosts]
        if verbose:
            argv += ["--verbose"]
        argv += ["--", sys.executable, "-m",
                 "horovod_tpu_torch.runner.run_task"]
        os.environ.update(env)
        try:
            rc = launch_mod.run_commandline(argv)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        if rc != 0:
            raise RuntimeError(f"horovod_tpu_torch.runner.run failed with "
                               f"exit code {rc}")
        if not done.wait(timeout=30):
            missing = sorted(set(range(np)) - set(results))
            raise RuntimeError(f"no results from ranks {missing}")
        return [results[r] for r in range(np)]
    finally:
        service.shutdown()


def _task_main() -> None:
    """Worker entry (``python -m horovod_tpu_torch.runner.run_task``):
    fetch the function, execute, report the result."""
    addr = os.environ["HOROVOD_RUN_SERVICE_ADDR"]
    key = os.environ["HOROVOD_RUN_SECRET"]
    rank = int(os.environ.get("HOROVOD_RANK", "0"))
    host, port = addr.rsplit(":", 1)
    client = BasicClient((host, int(port)), key)
    # the frame's HMAC verified before these bytes were unpickled
    fn, args, kwargs = pickle.loads(
        client.request(GetFuncRequest()).payload)
    result = fn(*args, **kwargs)
    client.request(ResultRequest(rank, pickle.dumps(result)))
