"""The port's elastic plane against the JAX package's.

1. The JAX package's tier-1 elastic unit tests, run against the port's
   modules with the same cases and fake clocks: ``tests/
   test_elastic_recovery.py``, ``tests/test_health.py`` and the driver
   cases of ``tests/test_elastic_driver.py`` (its ``TestHostManager`` and
   ``TestElasticDriver``; its end-to-end class is
   ``tests/test_torch_elastic_e2e.py``'s).  Each file's source is read,
   its ``horovod_tpu`` imports point at ``horovod_tpu_torch``, and its
   test classes are collected here under ``Port`` names.
2. Where a case's inputs are plain data (quarantine cooldowns, host
   updates and assignments, health verdicts on a fake clock), the same
   inputs through both packages' modules give the same answers.
3. The state: one MLP from numpy weights, with SGD and with AdamW, in
   JAX's ``TpuState`` and the port's ``TorchState`` in one process, each
   under its package's ``elastic.run`` with a ``HorovodInternalError`` at
   one step and a ``HostsUpdatedInterrupt`` at another: the same
   committed step sequence and parameters within 1e-6 (AdamW: 1e-5, the
   two frameworks' fp32 update order); ``priority_commit`` and
   ``restore_from_checkpoint`` continue the commit counter as JAX's do.
4. The callbacks against JAX's on one schedule: equal learning rates per
   batch.
"""

import threading
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu import callbacks as JCB
from horovod_tpu.elastic import discovery as JD
from horovod_tpu.elastic import health as JH
from horovod_tpu.elastic import state as JS
from horovod_tpu.runner import hosts as JHosts
from horovod_tpu_torch import callbacks as TCB
from horovod_tpu_torch.elastic import discovery as TD
from horovod_tpu_torch.elastic import health as TH
from horovod_tpu_torch.elastic import state as TS
from horovod_tpu_torch.exceptions import HorovodInternalError
from horovod_tpu_torch.runner import hosts as THosts

from torch_port_workers import port_test_module

TESTS = Path(__file__).resolve().parent


def _port_of(name: str) -> types.ModuleType:
    """``tests/<name>`` against the port (:func:`port_test_module`), its
    slow mark, which keeps the JAX driver's cases out of tier-1 where they
    hang, dropped: the port's driver cases finish in seconds."""
    slow = "pytestmark = pytest.mark.slow"
    src = (TESTS / name).read_text()
    return port_test_module(name, [(slow, "")] if slow in src else [])


_RECOVERY = _port_of("test_elastic_recovery.py")
_HEALTH = _port_of("test_health.py")
_DRIVER = _port_of("test_elastic_driver.py")

for _mod, _classes in (
        (_RECOVERY, ("TestHostQuarantine", "TestHostManagerQuarantine",
                     "TestDiscoveryScriptRobustness",
                     "TestDriverHeartbeatDeath", "TestWorkerExitEdgeCases",
                     "TestHeartbeatWire", "TestPlannedDepartureDriver")),
        (_HEALTH, ("TestProgressWatchdog", "TestLiveness", "TestProgress",
                   "TestBookkeeping", "TestPlannedDeparture",
                   "TestDepartGrace", "TestStraggler")),
        (_DRIVER, ("TestHostManager", "TestElasticDriver"))):
    for _name in _classes:
        globals()["TestPort" + _name[len("Test"):]] = getattr(_mod, _name)


def test_every_jax_case_is_collected():
    """Every test class of the three files but the driver file's
    end-to-end class runs here."""
    for mod, skip in ((_RECOVERY, ()), (_HEALTH, ()),
                      (_DRIVER, ("TestElasticEndToEnd",))):
        names = {n for n in vars(mod) if n.startswith("Test")}
        here = {n[len("TestPort"):] for n in globals()
                if n.startswith("TestPort")}
        assert {n[len("Test"):] for n in names if n not in skip} <= here


# -- plain-data parity ------------------------------------------------------

class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def test_quarantine_schedule_matches_jax():
    """Failures and probation on one fake clock: the same exclusions,
    remaining times and cooldowns in both packages."""
    seen = []
    for mod in (JD, TD):
        clk = Clock()
        q = mod.HostQuarantine(base_s=5.0, max_s=40.0, probation_s=20.0,
                               clock=clk)
        trace = []
        for t, fail in ((0, "a"), (3, None), (6, None), (7, "a"),
                        (20, None), (30, "b"), (50, None), (80, "a"),
                        (200, None)):
            clk.t = float(t)
            if fail:
                q.record_failure(fail)
            trace.append(tuple((h, q.is_excluded(h), round(
                q.remaining_s(h), 6)) for h in ("a", "b")))
        seen.append(trace)
    assert seen[0] == seen[1]


def test_host_updates_and_assignments_match_jax():
    """A sequence of discovered host sets through each package's
    HostManager, and the slot assignments of each set: equal."""
    sets = [{"a": 2, "b": 1}, {"a": 2, "b": 1, "c": 2}, {"c": 2, "a": 1},
            {"d": 4}]
    out = []
    for mod, hosts in ((JD, JHosts), (TD, THosts)):
        class Seq:
            def __init__(self):
                self.i = 0

            def find_available_hosts_and_slots(self):
                s = sets[min(self.i, len(sets) - 1)]
                self.i += 1
                return dict(s)

        hm = mod.HostManager(Seq())
        rec = []
        for _ in sets:
            res = hm.update_available_hosts()
            avail = hm.current_hosts
            infos = [hosts.HostInfo(h, avail[h])
                     for h in hm.assignment_order]
            slots = hosts.get_host_assignments(infos, 1, 8)
            rec.append((int(res), list(hm.assignment_order),
                        [(s.hostname, s.rank, s.local_rank, s.cross_rank,
                          s.size) for s in slots]))
        out.append(rec)
    assert out[0] == out[1]


def test_health_verdicts_match_jax(monkeypatch):
    """Beats, steps and silence on one fake clock: the same suspects,
    deaths and hangs, at the same times, in both packages."""
    got = []
    for mod in (JH, TH):
        clk = Clock()
        dead = []
        mon = mod.HealthMonitor(
            lambda host, lr, detect, reason: dead.append(
                (host, lr, round(detect, 6), reason)),
            interval_s=1.0, suspect_misses=3, dead_s=5.0,
            progress_timeout_s=4.0, clock=clk, start_thread=False)
        for t in range(0, 20):
            clk.t = float(t)
            if t < 12:
                mon.record_heartbeat("a", 0, t // 2)
            mon.record_heartbeat("b", 0, 1)
            if t < 6:
                mon.record_heartbeat("c", 0, t)
            mon.check()
        got.append(dead)
    assert got[0] == got[1]
    assert got[0], "the schedule declares someone"


def test_health_verdict_that_stops_the_monitor():
    """A death declared on the monitor's own thread whose callback stops
    the monitor (the driver's stop once every host is lost): the thread
    ends, and the callback returns rather than raising on a join of its
    own thread."""
    clk = Clock()
    stopped, errors = threading.Event(), []

    def on_dead(host, lr, detect, reason):
        try:
            mon.stop()
        except RuntimeError as e:      # "cannot join current thread"
            errors.append(e)
        stopped.set()

    mon = TH.HealthMonitor(on_dead, interval_s=0.1, suspect_misses=3,
                           dead_s=0.5, clock=clk)
    mon.record_heartbeat("a", 0)
    mon.start()
    thread = mon._thread
    clk.t = 10.0
    assert stopped.wait(10.0)
    thread.join(timeout=10.0)
    assert not errors and not thread.is_alive() and mon._thread is None


# -- the state ----------------------------------------------------------------

MLP = dict(d_in=6, d_hidden=8, d_out=3, rows=16)
STEPS = 6
FAIL_AT, HOSTS_AT = 3, 5


def mlp_data():
    rng = np.random.RandomState(7)
    w = {"w1": rng.randn(MLP["d_in"], MLP["d_hidden"]).astype(np.float32)
         * 0.5,
         "b1": np.zeros(MLP["d_hidden"], np.float32),
         "w2": rng.randn(MLP["d_hidden"], MLP["d_out"]).astype(np.float32)
         * 0.5,
         "b2": np.zeros(MLP["d_out"], np.float32)}
    x = rng.randn(STEPS, MLP["rows"], MLP["d_in"]).astype(np.float32)
    y = rng.randn(STEPS, MLP["rows"], MLP["d_out"]).astype(np.float32)
    return w, x, y


class TorchMlp(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        for k, v in w.items():
            setattr(self, k, torch.nn.Parameter(torch.tensor(v)))

    def forward(self, x):
        return torch.tanh(x @ self.w1 + self.b1) @ self.w2 + self.b2


OPTIMIZERS = {
    "sgd": (lambda: optax.sgd(0.1),
            lambda ps: torch.optim.SGD(ps, lr=0.1)),
    "adamw": (lambda: optax.adamw(1e-2, weight_decay=1e-4),
              lambda ps: torch.optim.AdamW(ps, lr=1e-2, weight_decay=1e-4)),
}


@pytest.fixture(scope="module")
def runtimes():
    jhvd.init()
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _schedule(state, events, step_of, error=HorovodInternalError):
    """The interruptions: a HorovodInternalError once at step FAIL_AT (a
    peer died mid-step, after the update, before the commit) and a
    host-update message before the commit of step HOSTS_AT."""
    step = step_of(state)
    if step == FAIL_AT and "fail" not in events:
        events.append("fail")
        raise error("a peer died")
    if step == HOSTS_AT and "hosts" not in events:
        events.append("hosts")
        state.on_hosts_updated(1, 0)


def _jax_run(opt_name, resets):
    w, x, y = mlp_data()
    tx = OPTIMIZERS[opt_name][0]()

    def loss(p, xb, yb):
        h = jnp.tanh(xb @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
        return jnp.mean((h - yb) ** 2)

    grad = jax.jit(jax.grad(loss))
    params = {k: jnp.asarray(v) for k, v in w.items()}
    state = JS.TpuState(params=params, opt_state=tx.init(params), step=0)
    commits, events = [], []

    @JS.run
    def train(state):
        while state.step < STEPS:
            g = grad(state.params, x[state.step], y[state.step])
            upd, state.opt_state = tx.update(g, state.opt_state,
                                             state.params)
            state.params = optax.apply_updates(state.params, upd)
            state.step += 1
            _schedule(state, events, lambda s: s.step,
                      jhvd.exceptions.HorovodInternalError)
            state.commit()
            commits.append((state.step, state._commit_count))

    train(state)
    return commits, {k: np.asarray(v) for k, v in state.params.items()}, \
        resets


def _torch_run(opt_name):
    w, x, y = mlp_data()
    model = TorchMlp(w)
    opt = OPTIMIZERS[opt_name][1](model.parameters())
    state = TS.TorchState(model, opt, step=0)
    commits, events = [], []

    @TS.run
    def train(state):
        while state.step < STEPS:
            opt.zero_grad()
            out = model(torch.from_numpy(x[state.step]))
            torch.mean((out - torch.from_numpy(y[state.step])) ** 2) \
                .backward()
            opt.step()
            state.step += 1
            _schedule(state, events, lambda s: s.step)
            state.commit()
            commits.append((state.step, state._commit_count))

    train(state)
    return commits, {k: v.detach().numpy() for k, v in
                     model.state_dict().items()}


@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
def test_state_parity(runtimes, monkeypatch, opt_name):
    """The same committed (step, commit count) sequence through a failure
    and a host update, and the same parameters; the port's run resets
    its runtime (a new world of one) at both interruptions."""
    jax_resets = []
    monkeypatch.setattr(JS, "_reset", lambda: jax_resets.append(1))
    j_commits, j_params, _ = _jax_run(opt_name, jax_resets)
    world = hvd._state.world_id()
    t_commits, t_params = _torch_run(opt_name)
    assert t_commits == j_commits
    assert len(jax_resets) == 2
    assert hvd._state.world_id() == world + 2
    tol = 1e-6 if opt_name == "sgd" else 1e-5
    for k in j_params:
        np.testing.assert_allclose(t_params[k], j_params[k], rtol=tol,
                                   atol=tol, err_msg=k)


def test_restore_is_bit_exact(runtimes):
    """``restore()`` puts the committed parameters and AdamW state back
    bit for bit, in place, after more steps moved them."""
    w, x, y = mlp_data()
    model = TorchMlp(w)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)

    def step(i):
        opt.zero_grad()
        torch.mean((model(torch.from_numpy(x[i])) -
                    torch.from_numpy(y[i])) ** 2).backward()
        opt.step()

    state = TS.TorchState(model, opt)
    step(0)
    state.commit()
    want = {k: v.clone() for k, v in model.state_dict().items()}
    want_opt = {(i, k): v.clone() for i, s in opt.state_dict()["state"]
                .items() for k, v in s.items()}
    ids = {k: v.data_ptr() for k, v in model.state_dict().items()}
    step(1)
    step(2)
    state.restore()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
        assert v.data_ptr() == ids[k], "restored in place"
    for (i, k), v in want_opt.items():
        assert torch.equal(opt.state_dict()["state"][i][k], v), (i, k)
    assert state.last_commit_bytes == sum(
        t.numel() * t.element_size() for t in want.values()) + sum(
        t.numel() * t.element_size() for t in want_opt.values())


def test_stale_wrappers_raise_after_reset(runtimes):
    """A DistributedOptimizer or DistributedTrainStep built before a reset
    raises rather than use the old world's groups."""
    w, x, y = mlp_data()
    model = TorchMlp(w)
    inner = torch.optim.SGD(model.parameters(), lr=0.1)
    opt = hvd.DistributedOptimizer(inner,
                                   named_parameters=model.named_parameters())
    step = hvd.DistributedTrainStep(lambda m, b: m(b).sum(), inner)
    TS._reset()
    with pytest.raises(RuntimeError, match="earlier world"):
        opt.step()
    with pytest.raises(RuntimeError, match="earlier world"):
        step(model, inner, torch.from_numpy(x[0]))
    fresh = hvd.DistributedOptimizer(
        inner, named_parameters=model.named_parameters())
    model(torch.from_numpy(x[0])).sum().backward()
    fresh.step()


def test_peer_failure_becomes_internal_error():
    """A collective's peer failure (gloo's closed connection, NCCL's
    aborted communicator) is HorovodInternalError; other errors pass."""
    from horovod_tpu_torch.runtime.distributed import raise_internal

    for err in (RuntimeError("[gloo/transport/tcp/pair.cc:534] Connection "
                             "closed by peer [127.0.0.1]:4431"),
                RuntimeError("Read error [127.0.0.1]:51234: Connection "
                             "reset by peer"),
                ConnectionResetError("reset")):
        with pytest.raises(HorovodInternalError):
            with raise_internal("the exchange"):
                raise err
    for err in (RuntimeError("shape mismatch"), ValueError("no")):
        with pytest.raises(type(err)):
            with raise_internal("the exchange"):
                raise err


def _commit_counts(mod, state_cls, make, tmp_path):
    ck = mod.Checkpointer(str(tmp_path), async_save=False) \
        if hasattr(mod, "Checkpointer") else None
    state = make(state_cls, ck)
    counts = []
    for _ in range(3):
        state.save()
        counts.append(state._commit_count)
    counts.append(state.priority_commit())
    fresh = make(state_cls, ck)
    assert fresh.restore_from_checkpoint()
    counts.append(fresh._commit_count)
    fresh.save()
    counts.append(fresh._commit_count)
    counts.append(sorted(ck.all_steps()))
    return counts


def test_priority_commit_and_checkpoint_restore_continue_the_counter(
        runtimes, tmp_path):
    """checkpoint_every = 2: commits 2 and 4 (the priority one) are
    durable; a fresh state restores step 4 and its next commit is 5, in
    both packages."""
    from horovod_tpu import checkpoint as jckpt
    from horovod_tpu_torch import checkpoint as tckpt

    w, _, _ = mlp_data()

    def jax_make(cls, ck):
        return cls(params={k: jnp.asarray(v) for k, v in w.items()},
                   checkpointer=ck, checkpoint_every=2, step=0)

    def torch_make(cls, ck):
        return cls(TorchMlp(w), None, checkpointer=ck, checkpoint_every=2,
                   step=0)

    j = _commit_counts(jckpt, JS.TpuState, jax_make, tmp_path / "j")
    t = _commit_counts(tckpt, TS.TorchState, torch_make, tmp_path / "t")
    assert t == j
    assert j[:6] == [1, 2, 3, 4, 4, 5]


# -- the callbacks ------------------------------------------------------------

class _JaxLoop:
    def __init__(self, lr):
        self.opt_state = optax.inject_hyperparams(optax.sgd)(
            learning_rate=lr).init({"w": jnp.zeros(2)})


class _TorchLoop:
    def __init__(self, lr):
        self.model = torch.nn.Linear(2, 2)
        self.optimizer = torch.optim.SGD(self.model.parameters(), lr=lr)


def _lrs(cbs, loop, get, epochs=3, batches=4):
    out = []
    for e in range(epochs):
        for cb in cbs:
            cb.on_epoch_begin(e, loop)
        for b in range(batches):
            for cb in cbs:
                cb.on_batch_begin(b, loop)
            out.append(round(get(loop), 7))
        for cb in cbs:
            cb.on_epoch_end(e, loop)
    return out


def test_callbacks_set_the_same_learning_rates(runtimes, monkeypatch):
    """Warmup, then a smooth schedule, on one schedule of epochs and
    batches: the learning rate of every batch is JAX's (at the port's
    world size: JAX's counts this process's 8 virtual devices)."""
    monkeypatch.setattr(jhvd, "size", hvd.size)
    def cbs(mod):
        return [mod.LearningRateWarmupCallback(0.1, warmup_epochs=2,
                                               steps_per_epoch=4),
                mod.LearningRateScheduleCallback(
                    0.1, lambda e: 0.5 ** e, start_epoch=2,
                    staircase=False, steps_per_epoch=4)]

    j = _lrs(cbs(JCB), _JaxLoop(0.1),
             lambda lp: float(lp.opt_state.hyperparams["learning_rate"]))
    t = _lrs(cbs(TCB), _TorchLoop(0.1),
             lambda lp: lp.optimizer.param_groups[0]["lr"])
    assert t == pytest.approx(j, rel=1e-6)


def test_warmup_schedule_matches_optax(runtimes):
    j = JCB.warmup_schedule(0.1, 2, 5, size=4, initial_lr_scale=0.5)
    t = TCB.warmup_schedule(0.1, 2, 5, size=4, initial_lr_scale=0.5)
    for s in range(15):
        assert t(s) == pytest.approx(float(j(s)), rel=1e-6)


def test_metric_average_and_state_callbacks(runtimes):
    """A world of one averages a metric to itself; the state callbacks
    commit and track batch and epoch as JAX's do."""
    logs = {"loss": 2.5, "acc": np.float32(0.75)}
    TCB.MetricAverageCallback().on_epoch_end(0, None, logs)
    assert logs == {"loss": 2.5, "acc": 0.75}
    out = []
    for mod, state in ((JCB, JS.ObjectState(epoch=0, batch=0)),
                       (TCB, TS.ObjectState(epoch=0, batch=0))):
        cbs = [mod.CommitStateCallback(state, batches_per_commit=2),
               mod.UpdateBatchStateCallback(state),
               mod.UpdateEpochStateCallback(state)]
        seen = []
        for e in range(2):
            for b in range(3):
                for cb in cbs:
                    cb.on_batch_end(b, None)
                seen.append((state.batch, state._saved_state["batch"]))
            for cb in cbs:
                cb.on_epoch_end(e, None)
            seen.append((state.epoch, state.batch))
        out.append(seen)
    assert out[0] == out[1]


def test_hosts_update_of_a_joined_generation_is_dropped(monkeypatch):
    """A host-update ping for a generation this worker already runs in
    interrupts nothing (a failure's survivor joins the new generation on
    its own, and the driver's ping of it can land later); a newer one,
    or one that states no generation, reaches the listeners."""
    from horovod_tpu_torch.elastic.worker import WorkerNotificationManager

    monkeypatch.setenv("HOROVOD_ELASTIC_GENERATION", "2")
    seen = []

    class Listener:
        def on_hosts_updated(self, ts, res):
            seen.append(ts)

    mgr = WorkerNotificationManager()
    mgr.register_listener(Listener())
    for ts, gen in ((1, 1), (2, 2), (3, 3), (4, -1)):
        mgr.handle_hosts_updated(ts, 0, gen)
    assert seen == [3, 4]


def test_torch_state_sync_over_a_world_of_two():
    """``TorchState.sync()`` hands rank 0's parameters, AdamW state (rank
    1 holds none, as a joiner) and attributes to rank 1, bit for bit, and
    commits once, as ``TpuState.sync`` does."""
    from torch_port_workers import spawn_world

    outs = spawn_world("run_torch_state_sync", world=2, timeout=120)
    for out in outs:
        assert out["epoch"] == 5 and out["commits"] == 1
        assert out["opt"].keys() == outs[0]["opt"].keys()
        assert len(out["opt"]) == 12     # 4 tensors × (step, exp_avg(_sq))
        for group in ("params", "opt"):
            for k, v in outs[0][group].items():
                np.testing.assert_array_equal(out[group][k], v, err_msg=k)
