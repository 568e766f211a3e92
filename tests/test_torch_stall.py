"""The port's stall inspector (``horovod_tpu_torch/utils/stall.py``) held
against the JAX package's: a warning after the warning time, once an op;
none for an op that completes; the shutdown time ending the process with
JAX's exit code; the attribution report for the same peer statuses; and
the inspector inside the runtime.  The missing rank on a gloo world of 2
is ``tests/test_torch_timeline.py``'s ``test_stall_names_the_missing_rank``
(one world serves both files)."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from horovod_tpu.utils import logging as jax_logging
from horovod_tpu.utils import stall as JS
from horovod_tpu_torch import faults
from horovod_tpu_torch import telemetry
from horovod_tpu_torch.utils import logging as hvd_logging
from horovod_tpu_torch.utils import stall as TS

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def warnings(monkeypatch):
    """The warnings of both packages' inspectors, by package."""
    got = {"port": [], "jax": []}
    monkeypatch.setattr(hvd_logging, "warning",
                        lambda msg, *a: got["port"].append(msg % a))
    monkeypatch.setattr(jax_logging, "warning",
                        lambda msg, *a: got["jax"].append(msg % a))
    return got


def _strip_age(w):
    """A warning without the op's age in seconds, which is timing."""
    import re

    return re.sub(r"\(\d+s\)", "(_s)", w)


class TestWarnings:
    def test_warns_once_after_the_warning_time(self, warnings):
        """An op pending past the warning time warns once, in the words
        of the JAX package's inspector, and not before the time."""
        mine = TS.StallInspector(warning_time_s=0.3, poll_interval_s=0.05)
        ref = JS.StallInspector(warning_time_s=0.3, poll_interval_s=0.05)
        for si in (mine, ref):
            si.record_dispatch("stuck_tensor")
        time.sleep(0.15)
        early = dict(warnings)
        early = {k: list(v) for k, v in early.items()}
        time.sleep(0.6)
        for si in (mine, ref):
            si.stop()
        assert early == {"port": [], "jax": []}
        assert len(warnings["port"]) == len(warnings["jax"]) == 1
        assert _strip_age(warnings["port"][0]) == \
            _strip_age(warnings["jax"][0])
        assert "stuck_tensor" in warnings["port"][0]

    def test_completion_clears(self, warnings):
        for mod in (TS, JS):
            si = mod.StallInspector(warning_time_s=0.2, poll_interval_s=0.05)
            si.record_dispatch("fast_tensor")
            si.record_complete("fast_tensor")
            time.sleep(0.35)
            si.stop()
            assert si.pending_ops() == {}
        assert warnings == {"port": [], "jax": []}

    def test_warnings_counter(self, warnings):
        """Each stalled op counts once in ``hvd_stall_warnings_total``, as
        in the JAX package (the pending-ops gauges are process-wide, and
        another inspector may set them: not compared here)."""
        was = telemetry.enabled()
        reg = telemetry.enable()
        try:
            before = reg.value("hvd_stall_warnings_total")
            si = TS.StallInspector(warning_time_s=0.2, poll_interval_s=0.05)
            si.record_dispatch("a")
            si.record_dispatch("b")
            time.sleep(0.45)
            si.stop()
            assert reg.value("hvd_stall_warnings_total") - before == 2
            assert set(si.pending_ops()) == {"a", "b"}
        finally:
            if not was:
                telemetry.disable()

    @pytest.mark.filterwarnings(
        "ignore::pytest.PytestUnhandledThreadExceptionWarning")
    def test_stall_watch_fault_silences_the_inspector(self, warnings):
        """The ``stall.watch`` fault (a raise) ends the watcher thread of
        either package before it warns."""
        faults.set_plan(faults.FaultPlan().add("stall.watch", "raise"))
        from horovod_tpu import faults as jax_faults

        jax_faults.set_plan(jax_faults.FaultPlan().add("stall.watch",
                                                       "raise"))
        try:
            sis = [mod.StallInspector(warning_time_s=0.1,
                                      poll_interval_s=0.05)
                   for mod in (TS, JS)]
            for si in sis:
                si.record_dispatch("x")
            time.sleep(0.4)
            assert [si._thread.is_alive() for si in sis] == [False, False]
        finally:
            faults.clear_plan()
            jax_faults.clear_plan()
        assert not [w for ws in warnings.values() for w in ws
                    if "not completed" in w]


_SHUTDOWN = """
import sys, time
sys.path.insert(0, {root!r})
from {pkg}.utils.stall import StallInspector
si = StallInspector(warning_time_s=0.1, shutdown_time_s=0.3,
                    poll_interval_s=0.05)
si.record_dispatch("wedged")
time.sleep(20)
print("survived")
"""


@pytest.mark.parametrize("pkg", ["horovod_tpu_torch", "horovod_tpu"])
def test_shutdown_time_ends_the_process(pkg):
    """Past ``shutdown_time_s`` the inspector ends the process with exit
    code 1 in both packages."""
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", _SHUTDOWN.format(
        root=str(ROOT), pkg=pkg)], capture_output=True, text=True,
        timeout=120, env={k: v for k, v in os.environ.items()
                          if k != "PYTHONPATH"})
    assert out.returncode == 1, out.stderr
    assert "survived" not in out.stdout
    assert time.monotonic() - t0 < 15
    assert "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS" in out.stderr


class _Store:
    """A store of the port's kind (``set``/``check``/``get``)."""

    def __init__(self, statuses):
        self.d = {f"{TS._STATUS_DIR}/{p}": json.dumps(
            {"pending": v}).encode() for p, v in statuses.items()}

    def set(self, k, v):
        self.d[k] = v

    def check(self, keys):
        return all(k in self.d for k in keys)

    def get(self, k):
        return self.d[k]


class _Client:
    """The JAX package's coordination client (a directory of keys)."""

    def __init__(self, statuses):
        self.entries = [(f"{JS._STATUS_DIR}/{p}/1", json.dumps(
            {"pending": v})) for p, v in statuses.items()]

    def key_value_dir_get_bytes(self, d):
        return self.entries


@pytest.mark.parametrize("statuses", [
    {},
    {1: ["op"], 2: ["op"], 3: ["op"]},
    {1: [], 2: ["other"], 3: ["op", "x"]},
    {2: ["other", "op2"]},
])
def test_attribution_matches_jax(statuses):
    """For the same peer statuses both inspectors name the same ranks as
    unreported, diverged and co-stalled, in the same words (rank 0 of 4,
    stalled on ``op`` and ``op2``)."""
    mine = TS.StallInspector.__new__(TS.StallInspector)
    ref = JS.StallInspector.__new__(JS.StallInspector)
    names = ["op", "op2"] if 2 in statuses and "op2" in statuses[2] \
        else ["op"]
    assert mine._attribute(_Store(statuses), 0, 4, names) == \
        ref._attribute(_Client(statuses), 0, 4, names)


def test_runtime_starts_and_stops_the_inspector(monkeypatch):
    """``init()`` starts the inspector with the configured times (unless
    ``HOROVOD_STALL_CHECK_DISABLE``); the eager plane registers each op at
    dispatch and clears it at completion; ``shutdown()`` stops it."""
    import torch

    import horovod_tpu_torch as hvd

    monkeypatch.setenv("HOROVOD_STALL_CHECK_TIME_SECONDS", "7.5")
    hvd.init(device="cpu")
    try:
        si = hvd._state.global_state().stall_inspector
        assert si._warning_time_s == 7.5 and si._thread.is_alive()
        seen = []
        real = si.record_dispatch
        monkeypatch.setattr(si, "record_dispatch",
                            lambda n: (seen.append(n), real(n)))
        h = hvd.allreduce_async(torch.ones(2), name="si.op")
        assert si.pending_ops().keys() == {"si.op"}
        hvd.synchronize(h)
        assert seen == ["si.op"] and si.pending_ops() == {}
    finally:
        hvd.shutdown()
    assert not si._thread.is_alive()
    monkeypatch.setenv("HOROVOD_STALL_CHECK_DISABLE", "1")
    hvd.init(device="cpu")
    try:
        assert hvd._state.global_state().stall_inspector is None
    finally:
        hvd.shutdown()
