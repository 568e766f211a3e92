"""A dead peer over NCCL (ROADMAP C 11): the host waits for an elastic
world's exchange with a deadline, the group's timeout, instead of reading a
result behind a collective that never ends, and an elastic reset after a
failure aborts every process group the dead world made (the world, the
host group, the layout groups, a parallel mesh's), so that none of their
watchdogs outlives it.  The four-card run is ``test_elastic_over_nccl``
in ``tests/test_torch_gpu.py``; here the CPU parts, with the card's
stream and events stood in for."""

import datetime
import time

import pytest
import torch

from horovod_tpu_torch.exceptions import HorovodInternalError
from horovod_tpu_torch.runtime import distributed as hvd_dist
from torch_port_workers import spawn_world


class _Event:
    """A ``torch.cuda.Event`` whose work completes after ``after`` s (never
    when None)."""

    def __init__(self, after=None):
        self.t0 = time.monotonic()
        self.after = after

    def record(self, stream=None):
        pass

    def query(self):
        return self.after is not None and \
            time.monotonic() - self.t0 >= self.after


class TestAwaitEvent:
    def test_returns_when_the_work_completes(self):
        t0 = time.monotonic()
        hvd_dist.await_event(_Event(after=0.1), "x", timeout_s=5.0)
        assert 0.1 <= time.monotonic() - t0 < 2.0

    def test_raises_past_the_deadline(self):
        t0 = time.monotonic()
        with pytest.raises(HorovodInternalError,
                           match="the gradient exchange did not complete "
                                 "within 0.3 s"):
            hvd_dist.await_event(_Event(), "the gradient exchange", 0.3)
        assert 0.3 <= time.monotonic() - t0 < 2.0


def test_deadline_only_in_an_elastic_world_on_a_card(monkeypatch):
    """The host waits only in an elastic world of more than one rank on
    a card, for the world's collective timeout."""
    import horovod_tpu_torch as hvd

    assert hvd_dist.collective_deadline_s() is None
    hvd.init(device="cpu")
    try:
        st = hvd._state.global_state()
        assert hvd_dist.collective_deadline_s() is None
        monkeypatch.setattr(st, "size", 4)
        monkeypatch.setattr(st.config, "elastic_enabled", True)
        monkeypatch.setattr(st, "timeout", datetime.timedelta(seconds=10))
        assert hvd_dist.collective_deadline_s() is None      # the CPU
        monkeypatch.setattr(st, "device", torch.device("cuda", 0))
        assert hvd_dist.collective_deadline_s() == 10.0
    finally:
        hvd.shutdown()


class _Stream:
    device = torch.device("cuda", 0)

    def wait_stream(self, other):
        self.waited = other


def test_hook_path_step_raises_within_the_deadline(monkeypatch):
    """An elastic world's ``step()`` on a card whose exchange never
    completes raises ``HorovodInternalError`` once the deadline passes,
    before the optimizer runs and before the current stream is ordered
    after the exchange (without the deadline the host went on, and
    blocked later reading the loss)."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        model = torch.nn.Linear(4, 2)
        inner = torch.optim.SGD(model.parameters(), lr=0.1)
        opt = hvd.DistributedOptimizer(
            inner, named_parameters=model.named_parameters())
        model(torch.ones(3, 4)).sum().backward()
        side, current = _Stream(), _Stream()
        opt._stream = side
        monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: _Event())
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda device=None: current)
        monkeypatch.setattr(hvd_dist, "collective_deadline_s", lambda: 0.3)
        before = [p.detach().clone() for p in model.parameters()]
        t0 = time.monotonic()
        with pytest.raises(HorovodInternalError, match="within 0.3 s"):
            opt.step()
        assert time.monotonic() - t0 < 5.0
        assert not hasattr(current, "waited")
        assert all(torch.equal(a, b) for a, b in
                   zip(before, model.parameters()))
    finally:
        hvd.shutdown()


def test_reset_after_a_failure_aborts_every_group():
    """``shutdown(abort=True)`` on an NCCL world (the backend answered as
    ``"nccl"`` on gloo ranks laid out 2 x 2) aborts all the groups at
    once: the world, the host group, the layout groups and a dp x tp
    mesh's groups are gone, and the runtime is down."""
    outs = spawn_world("run_abort_groups", world=4, layout=(2, 2),
                       timeout=120)
    for o in outs:
        # the world (the host group on gloo), this rank's two layout
        # groups, and its groups of the mesh
        assert o["made"] >= 5, o
        assert o["calls"] == [None]
        assert o["left"] == 0
        assert not o["initialized"] and not o["runtime"]
