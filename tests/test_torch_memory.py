"""The port's memory plane against the JAX package's: the budgeted planner
(``memory/planner.py``) returns the same winner, and raises
``InfeasibleError`` on the same tightest axis, on JAX's grids with one
explicit hardware model built in both packages; its budget knob and
default; and the host-offload engine (``memory/offload.py``) under
``tests/test_memory.py``'s ``TestHostOffloadEngine`` and
``TestOffloadTrainLoop`` cases over torch tensors (the loop through the
port's ``DistributedTrainStep`` with AdamW on a world of one)."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from horovod_tpu.analysis import cost_model as JCM
from horovod_tpu.memory import planner as JP
from horovod_tpu.parallel.plan import candidate_plans as j_candidates
from horovod_tpu_torch import faults
from horovod_tpu_torch.analysis import cost_model as TCM
from horovod_tpu_torch.faults import FaultPlan
from horovod_tpu_torch.memory import (
    HostOffloadEngine,
    InfeasibleError,
    search_memory_plans,
)
from horovod_tpu_torch.parallel.plan import candidate_plans

GB = 1e9
HW = dataclasses.asdict(TCM.H100)


@pytest.fixture(autouse=True)
def _clean_fault_plan():
    faults.clear_plan()
    yield
    faults.clear_plan()


# -- planner ----------------------------------------------------------------

#: tests/test_memory.py's grid and memory/smoke.py's, and a 4-way grid
#: with pp and sp candidates
GRIDS = {
    "test_memory": ([p.to_string() for p in candidate_plans(8)],
                    dict(param_bytes=8e9, activation_bytes=24e9,
                         shard_optimizer_states=True, compute_s=0.1,
                         n_ici=8)),
    "four": ([p.to_string() for p in candidate_plans(
        4, ("dp", "fsdp", "tp", "pp", "sp"))],
             dict(param_bytes=3.48e9, activation_bytes=12e9,
                  exchange_bucket_bytes=64 << 20, compute_s=0.15,
                  n_dcn=2, n_ici=2)),
    "one": (["dp=1"], dict(param_bytes=3.48e9, activation_bytes=16e9,
                           microbatches=(1,), offload=(False,))),
}
BUDGETS = [None, 1e15, 40 * GB, 16 * GB, 6 * GB, 3 * GB, 0.1 * GB]


def _both(grid, budget):
    """(JAX's, the port's) outcome: the winner's fields, or the
    InfeasibleError's axis, closest candidate and message."""
    plans, kw = GRIDS[grid]
    out = []
    for mod, cm in ((JP, JCM), (None, TCM)):
        search = mod.search_memory_plans if mod else search_memory_plans
        err = mod.InfeasibleError if mod else InfeasibleError
        try:
            c = search(plans, budget_bytes=budget,
                       hw=cm.HardwareModel(**HW), **kw)
            out.append(("fits", dataclasses.asdict(c), c.summary()))
        except err as e:
            out.append(("infeasible", e.tightest_axis,
                        dataclasses.asdict(e.closest), str(e)))
    return out


def test_grids_match_jax_candidates():
    assert GRIDS["test_memory"][0] == \
        [p.to_string() for p in j_candidates(8)]


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("budget", BUDGETS)
def test_planner_matches_jax(grid, budget, monkeypatch):
    monkeypatch.delenv("HOROVOD_HBM_BUDGET_BYTES", raising=False)
    jax_out, port_out = _both(grid, budget)
    assert port_out == jax_out


def test_budget_excludes_the_free_winner(monkeypatch):
    monkeypatch.delenv("HOROVOD_HBM_BUDGET_BYTES", raising=False)
    plans, kw = GRIDS["test_memory"]
    free = search_memory_plans(plans, budget_bytes=1e15, **kw)
    tight = search_memory_plans(plans, budget_bytes=6e9, **kw)
    assert free != tight
    assert tight.total_bytes <= 6e9 < free.total_bytes
    assert tight.predicted_step_s >= free.predicted_step_s
    assert search_memory_plans(plans, budget_bytes=6e9, **kw) == tight


def test_infeasible_names_the_tightest_axis(monkeypatch):
    monkeypatch.delenv("HOROVOD_HBM_BUDGET_BYTES", raising=False)
    plans, kw = GRIDS["test_memory"]
    with pytest.raises(InfeasibleError) as e:
        search_memory_plans(plans, budget_bytes=0.1e9, **kw)
    assert e.value.tightest_axis in str(e.value)
    assert e.value.closest.total_bytes > 0.1e9
    with pytest.raises(ValueError, match="at least one plan"):
        search_memory_plans([], **kw)


def test_budget_knob_and_capacity_default(monkeypatch):
    """Unset, the budget is ``HOROVOD_HBM_BUDGET_BYTES``, else the
    resolved hardware model's capacity (the H100's 80 GB): the JAX
    function given that budget explicitly picks the same."""
    plans, kw = GRIDS["four"]
    monkeypatch.delenv("HOROVOD_CALIBRATION_PATH", raising=False)
    monkeypatch.delenv("HOROVOD_HW_PRESET", raising=False)
    for env in (None, "6000000000", "16000000000"):
        if env is None:
            monkeypatch.delenv("HOROVOD_HBM_BUDGET_BYTES", raising=False)
        else:
            monkeypatch.setenv("HOROVOD_HBM_BUDGET_BYTES", env)
        budget = float(env) if env else TCM.H100.hbm_capacity_bytes
        got = search_memory_plans(plans, **kw)
        want = JP.search_memory_plans(plans, budget_bytes=budget,
                                      hw=JCM.HardwareModel(**HW), **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.total_bytes <= budget


# -- host offload -----------------------------------------------------------

def tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"mu": torch.from_numpy(rng.randn(32, 8).astype(np.float32)),
            "nu": torch.from_numpy(rng.rand(32, 8).astype(np.float32)),
            "count": torch.tensor(7, dtype=torch.int32)}


def assert_bit_exact(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])


class TestHostOffloadEngine:
    def test_round_trip_bit_exact(self):
        with HostOffloadEngine(name="t", depth=2) as engine:
            t = tree()
            engine.offload(0, t)
            out = engine.fetch(0, t)
            assert_bit_exact(t, out)
            assert out["mu"] is not t["mu"]
            assert engine.fallbacks == 0
            assert engine.stall_s >= 0.0

    def test_unknown_tag_returns_fallback(self):
        with HostOffloadEngine(name="t") as engine:
            t = tree()
            assert engine.fetch("never-offloaded", t) is t

    def test_double_offload_same_tag_refuses(self):
        with HostOffloadEngine(name="t") as engine:
            t = tree()
            engine.offload(0, t)
            with pytest.raises(ValueError, match="already offloaded"):
                engine.offload(0, t)
            engine.fetch(0, t)

    def test_backpressure_past_depth_does_not_hang(self):
        engine = HostOffloadEngine(name="t", depth=2)
        trees = [tree(seed=i) for i in range(5)]   # 2×depth + 1
        done = threading.Event()

        def work():
            for i, t in enumerate(trees):
                engine.offload(i, t)
            done.set()

        threading.Thread(target=work, daemon=True).start()
        assert done.wait(timeout=30), \
            "offload() hung with depth+1 outstanding tags"
        for i, t in enumerate(trees):
            assert_bit_exact(t, engine.fetch(i, t))
        assert engine.fallbacks == 0
        engine.close()

    def test_backpressure_with_faulted_copy_neither_hangs_nor_leaks(self):
        faults.set_plan(FaultPlan().add("offload.d2h", "raise", "OSError",
                                        at=1))
        with HostOffloadEngine(name="t", depth=1) as engine:
            t0, t1, t2 = tree(0), tree(1), tree(2)
            engine.offload(0, t0)          # this D2H raises
            engine.offload(1, t1)          # must pass the backpressure
            engine.offload(2, t2)
            assert engine.fetch(0, t0) is t0   # the retained reference
            assert engine.fallbacks == 1
            assert_bit_exact(t1, engine.fetch(1, t1))
            assert_bit_exact(t2, engine.fetch(2, t2))
            assert engine.fallbacks == 1

    def test_close_idempotent_and_refuses_new_work(self):
        engine = HostOffloadEngine(name="t")
        engine.close()
        engine.close()
        with pytest.raises(RuntimeError, match="closed"):
            engine.offload(0, tree())

    @pytest.mark.parametrize("site", ["offload.d2h", "offload.h2d"])
    def test_chaos_fault_degrades_to_device_ref(self, site):
        faults.set_plan(FaultPlan().add(site, "raise", "OSError", at=1))
        with HostOffloadEngine(name="t", depth=2) as engine:
            t = tree()
            engine.offload(0, t)
            assert engine.fetch(0, t) is t
            assert engine.fallbacks == 1
            t2 = tree(seed=1)
            engine.offload(1, t2)
            assert_bit_exact(t2, engine.fetch(1, t2))
            assert engine.fallbacks == 1

    def test_depth_knob(self, monkeypatch):
        from horovod_tpu_torch.memory.offload import default_offload_depth

        monkeypatch.setenv("HOROVOD_OFFLOAD_DEPTH", "3")
        assert default_offload_depth() == 3
        assert HostOffloadEngine(name="k").depth == 3
        monkeypatch.delenv("HOROVOD_OFFLOAD_DEPTH")
        assert default_offload_depth() == 2


@pytest.fixture
def hvd_torch():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


class TestOffloadTrainLoop:
    """Streaming AdamW's state out and back between seeded steps of the
    port's ``DistributedTrainStep`` changes no number, with or without an
    injected transfer fault."""

    STEPS = 4

    def _run(self, hvd, offload, plan=None):
        if plan is not None:
            faults.set_plan(plan)
        rng = np.random.RandomState(0)
        m = torch.nn.Module()
        m.w1 = torch.nn.Parameter(torch.from_numpy(
            (rng.randn(8, 16) * 0.3).astype(np.float32)))
        m.w2 = torch.nn.Parameter(torch.from_numpy(
            (rng.randn(16, 4) * 0.3).astype(np.float32)))

        def loss_fn(model, batch):
            h = torch.tanh(batch["x"] @ model.w1)
            return ((h @ model.w2 - batch["y"]) ** 2).mean()

        step = hvd.DistributedTrainStep(
            loss_fn, torch.optim.AdamW(m.parameters(), lr=0.05))
        m, opt = step.init(m)
        batch = step.shard_batch({
            "x": np.random.RandomState(1).randn(8, 8).astype(np.float32),
            "y": np.random.RandomState(2).randn(8, 4).astype(np.float32)})
        inner = opt.optimizer
        engine = HostOffloadEngine(name="loop", depth=2) if offload \
            else None
        losses = []
        for i in range(self.STEPS):
            if engine is not None and i:
                state = engine.fetch(i - 1, inner.state_dict()["state"])
                inner.load_state_dict({
                    "state": state,
                    "param_groups": inner.state_dict()["param_groups"]})
            m, opt, loss = step(m, opt, batch)
            losses.append(float(loss))
            if engine is not None:
                engine.offload(i, inner.state_dict()["state"])
        if engine is not None:
            engine.fetch(self.STEPS - 1, None)
            engine.close()
        faults.clear_plan()
        return losses, engine

    def test_offloaded_loop_is_bit_identical(self, hvd_torch):
        base, _ = self._run(hvd_torch, offload=False)
        offloaded, engine = self._run(hvd_torch, offload=True)
        assert offloaded == base
        assert engine.fallbacks == 0

    @pytest.mark.parametrize("site", ["offload.d2h", "offload.h2d"])
    def test_chaos_fault_loses_no_step(self, hvd_torch, site):
        base, _ = self._run(hvd_torch, offload=False)
        plan = FaultPlan().add(site, "raise", "OSError", at=2)
        faulted, engine = self._run(hvd_torch, offload=True, plan=plan)
        assert faulted == base
        assert engine.fallbacks == 1

    def test_offload_depth_config_default(self, hvd_torch, monkeypatch):
        from horovod_tpu_torch.memory.offload import default_offload_depth

        assert hvd_torch._state.global_state().config.offload_depth == 2
        assert default_offload_depth() == 2


class TestMemorySeries:
    def test_engine_counters(self):
        """The engine's series carry JAX's names (its metrics schema's
        MEMORY_SERIES)."""
        from horovod_tpu.analysis import metrics_schema as MS
        from horovod_tpu_torch import telemetry

        telemetry.enable()
        try:
            with HostOffloadEngine(name="x", depth=1) as engine:
                t = tree()
                engine.offload(0, t)
                engine.fetch(0, t)
            for name in ("hvd_memory_offload_bytes_total",
                         "hvd_memory_offload_stall_seconds",
                         "hvd_memory_offload_inflight",
                         "hvd_memory_offload_fallbacks_total"):
                assert name in MS.MEMORY_SERIES
            nbytes = sum(x.numel() * x.element_size() for x in t.values())
            assert telemetry.value("hvd_memory_offload_bytes_total",
                                   engine="x", direction="d2h") == nbytes
            assert telemetry.value("hvd_memory_offload_bytes_total",
                                   engine="x", direction="h2d") == nbytes
        finally:
            telemetry.disable()


class TestWireGauges:
    """The step's one-time cost-model gauges (JAX ``_record_step_telemetry``)
    under the sharded exchange, with the port's level names."""

    def test_sharded_step_sets_the_wire_gauges(self, hvd_torch):
        from horovod_tpu.analysis.cost_model import exchange_wire_bytes
        from horovod_tpu_torch import telemetry

        telemetry.enable()
        try:
            model = torch.nn.Linear(8, 4)
            step = hvd_torch.DistributedTrainStep(
                lambda m, b: (m(b) ** 2).mean(),
                torch.optim.SGD(model.parameters(), lr=0.1),
                shard_optimizer_states=True, reduction="adasum")
            model, opt = step.init(model)
            step(model, opt, step.shard_batch(np.ones((4, 8), np.float32)))
            payload = float(sum(p.numel() * 4 for p in model.parameters()))
            want = exchange_wire_bytes(payload, n_dcn=1, n_ici=1)
            assert telemetry.value("hvd_exchange_wire_bytes",
                                   level="local") == want.ici
            assert telemetry.value("hvd_exchange_wire_bytes",
                                   level="cross") == want.dcn
            assert telemetry.value("hvd_adasum_dot_wire_bytes") == 0.0
        finally:
            telemetry.disable()
