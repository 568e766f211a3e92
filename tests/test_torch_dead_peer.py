"""A dead peer over NCCL (ROADMAP C 11): the host waits for an elastic
world's exchange with a deadline, the group's timeout, instead of reading a
result behind a collective that never ends, and an elastic reset after a
failure aborts every process group the dead world made (the world, the
host group, the layout groups, a parallel mesh's), so that none of their
watchdogs outlives it.  The four-card run is ``test_elastic_over_nccl``
in ``tests/test_torch_gpu.py``; here the CPU parts, with the card's
stream and events stood in for.  ROADMAP C 15 puts the same deadline on
the sharded step, the Adasum step and the eager ``synchronize``; their
CPU drills are here, and ``test_sharded_kill_over_nccl`` the four-card
run."""

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


def _fake_card(monkeypatch, deadline=0.3):
    """The card's events never complete, and the current stream is a
    recorder: an elastic world's host deadline of ``deadline`` s."""
    current = _Stream()
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: _Event())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: current)
    monkeypatch.setattr(hvd_dist, "collective_deadline_s", lambda: deadline)
    return current


@pytest.mark.parametrize("kind", ["sharded", "adasum"])
def test_step_raises_within_the_deadline(monkeypatch, kind):
    """An elastic world's sharded step (behind its reduce-scatter, before
    the update) and Adasum step (behind the delta exchange) on a card
    whose exchange never completes raise ``HorovodInternalError`` once
    the deadline passes, with the parameters as they were before the
    step (before, the host waited for NCCL's watchdog, 6 deadlines)."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        model = torch.nn.Linear(4, 2)
        inner = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        opt = hvd.DistributedOptimizer(inner, shard_optimizer_states=True) \
            if kind == "sharded" else hvd.DistributedAdasumOptimizer(inner)
        model(torch.ones(3, 4)).sum().backward()
        before = [p.detach().clone() for p in model.parameters()]
        _fake_card(monkeypatch)
        t0 = time.monotonic()
        with pytest.raises(HorovodInternalError, match="within 0.3 s"):
            opt.step()
        assert time.monotonic() - t0 < 5.0
        assert all(torch.equal(a, b) for a, b in
                   zip(before, model.parameters()))
    finally:
        hvd.shutdown()


def test_sharded_step_waits_after_the_all_gather(monkeypatch):
    """The sharded step's second wait, behind the all-gather and before
    the copy into the parameters: a deadline that passes there raises
    with the parameters unchanged, after the update ran on the shards."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        model = torch.nn.Linear(4, 2)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            shard_optimizer_states=True)
        model(torch.ones(3, 4)).sum().backward()
        before = [p.detach().clone() for p in model.parameters()]
        waits = []
        real = hvd_dist.await_stream

        def await_stream(device, what):
            waits.append(what)
            if "all-gather" in what:
                _fake_card(monkeypatch)
            real(device, what)

        monkeypatch.setattr(hvd_dist, "await_stream", await_stream)
        with pytest.raises(HorovodInternalError, match="all-gather"):
            opt.step()
        assert waits == ["the sharded exchange's reduce-scatter",
                         "the sharded exchange's all-gather"]
        assert all(torch.equal(a, b) for a, b in
                   zip(before, model.parameters()))
    finally:
        hvd.shutdown()


def test_eager_synchronize_raises_within_the_deadline(monkeypatch):
    """The eager plane's ``synchronize`` on a card waits for the handle's
    event with the deadline in an elastic world, and raises
    ``HorovodInternalError`` instead of returning the result; outside one
    it waits on the event itself, as before."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import eager

    hvd.init(device="cpu")
    try:
        handle = eager.allreduce_async(torch.ones(4), name="deadline")
        eager.synchronize(handle)       # a completed CPU handle
        waited = []

        class Waited(_Event):
            def synchronize(self):
                waited.append(True)

        handle._event = Waited()
        monkeypatch.setattr(hvd_dist, "collective_deadline_s", lambda: None)
        assert torch.equal(eager.synchronize(handle), torch.ones(4))
        assert waited == [True]
        monkeypatch.setattr(hvd_dist, "collective_deadline_s", lambda: 0.3)
        t0 = time.monotonic()
        with pytest.raises(HorovodInternalError,
                           match="an eager collective did not complete "
                                 "within 0.3 s"):
            eager.synchronize(handle)
        assert 0.3 <= time.monotonic() - t0 < 5.0
        assert waited == [True]
    finally:
        hvd.shutdown()


#: the gloo drills' group timeout (HOROVOD_ELASTIC_HEARTBEAT_TIMEOUT), and
#: the margin a survivor may take past it
DRILL_TIMEOUT_S, DRILL_MARGIN_S = 5, 10


@pytest.mark.parametrize("path,victim", [("sharded", 3), ("eager", 2)])
def test_dead_peer_on_gloo_raises_not_hangs(monkeypatch, path, victim):
    """A world of 4 on gloo with an elastic world's timeouts: one rank
    exits after a completed step, and the others, in the sharded step's
    exchange or an eager allreduce's ``synchronize``, raise
    ``HorovodInternalError`` within the timeout and a margin, their
    parameters unchanged.  The world's own time limit turns a hang into
    this test's failure."""
    monkeypatch.setenv("HOROVOD_ELASTIC_HEARTBEAT_TIMEOUT",
                       str(DRILL_TIMEOUT_S))
    outs = spawn_world("run_kill", world=4, args=(path, victim),
                       dies=(victim,), timeout=120)
    assert outs[victim] is None
    for rank, out in enumerate(outs):
        if rank == victim:
            continue
        assert out["error"] == "HorovodInternalError", (rank, out)
        assert out["seconds"] < DRILL_TIMEOUT_S + DRILL_MARGIN_S, out
        assert out["unchanged"], out


def test_sharded_kill_under_the_elastic_launcher(tmp_path):
    """The gloo rehearsal of ``test_sharded_kill_over_nccl``: the elastic
    launcher with two host names of two slots, the narrow LM under
    ``TorchState`` through the sharded exchange (rebuilt at each reset);
    start rank 3 is killed at epoch 1's first batch, so the survivors'
    next collective is the sharded step's reduce-scatter.  They recover
    on the host left, commit every step with the same parameters, and the
    launcher returns 0 within its time limit."""
    from test_torch_elastic_e2e import run_elastic

    both = ["localhost:2", "127.0.0.1:2"]
    run = run_elastic(
        tmp_path, [(None, both)], np=4, min_np=2, max_np=4,
        exit_schedule={"1,0": [3]}, exit_mode="kill", epochs=3,
        timeout=150, extra_env={"HOROVOD_QUARANTINE_DISABLE": "1"},
        worker_args=("--model", "lm", "--sharded", "--device", "cpu"))
    assert run["rc"] == 0, (run["stderr"][-3000:] + run["logs"])
    killed = [r for r in run["ranks"] if r.get("event") == "rendezvous"
              and r["rendezvous"] > 1]
    assert killed and {r["size"] for r in killed} == {2}, killed
    commits: dict = {}
    for r in run["ranks"]:
        if r.get("event") == "commit":
            commits.setdefault((r["gstep"], r["rendezvous"]),
                               set()).add(r["check"])
    assert all(len(v) == 1 for v in commits.values()), commits
    assert sorted({g for g, _ in commits}) == list(range(1, 3 * 2 + 1))


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
