"""The port's plan-aware degradation (``horovod_tpu_torch/elastic/
degrade.py``) against the JAX package's.

1. ``tests/test_degrade.py``'s classes, run against the port's modules
   (its ``horovod_tpu`` imports pointed at ``horovod_tpu_torch``, the
   checkpointer built without JAX's orbax switch) and collected here under
   ``Port`` names; its pure-sim round trip is replaced by the same
   scenario on real gloo worlds (3): ``test_round_trip_4_2_4_matches_
   never_degraded``.
2. The resolver's verdicts, the controller's transitions and
   ``preserve_global_batch`` on the same inputs through both packages.
3. The 4 → 2 → 4 round trip of ``horovod_tpu/elastic/smoke.py`` on gloo
   worlds (``run_degrade`` in ``tests/torch_port_workers.py``): a dp=4
   world with sharded momentum and error-feedback residual checkpoints
   every 3 steps and loses half its ranks after step 8; the controller
   shrinks to dp=2, a world of 2 restores step 6 through
   ``reshard_restore``, replays with gradient accumulation 2 and reaches
   the boundary at step 9, where the controller promotes; a world of 4
   restores step 9 and ends at step 12.  The final weights, momentum and
   residual equal the never-degraded run's bit for bit (the gradients are
   exact in fp32 whatever the grouping), and the losses within 1e-9.
4. The elastic launcher under ``HOROVOD_DEGRADE=1`` (gloo): discovery
   takes a host away and gives it back; the driver's controller shrinks
   the plan and promotes it, the workers take it from ``HOROVOD_PLAN``,
   reshard-restore their shards and accumulate; the committed losses equal
   the never-degraded run's within 1e-9 (the gloo rehearsal of the
   four-card ``test_degrade_over_nccl``).
"""

import dataclasses
import re
import types
from pathlib import Path

import numpy as np
import pytest

from horovod_tpu.elastic import degrade as JD
from horovod_tpu.elastic import smoke as JSMOKE
from horovod_tpu.parallel.plan import ShardingPlan as JPlan
from horovod_tpu_torch.elastic import degrade as TD
from horovod_tpu_torch.parallel.plan import ShardingPlan as TPlan

from torch_port_workers import (
    DEGRADE,
    DEGRADE_LOSS_TOL,
    check_degrade_run,
    degrade_reference,
    spawn_world,
)

TESTS = Path(__file__).resolve().parent


def _port_of(name: str) -> types.ModuleType:
    src = (TESTS / name).read_text()
    src = re.sub(r"\bhorovod_tpu\b(?!_torch)", "horovod_tpu_torch", src)
    src = src.replace(", use_orbax=False", "")
    mod = types.ModuleType(f"port_{name[:-3]}")
    mod.__file__ = str(TESTS / name)
    exec(compile(src, f"port of tests/{name}", "exec"), mod.__dict__)
    return mod


_DEG = _port_of("test_degrade.py")

for _name in ("TestDegradeCandidates", "TestResolver", "TestController",
              "TestPreserveGlobalBatch", "TestChaosSites", "TestSpDegrade"):
    globals()[f"TestPort{_name[4:]}"] = getattr(_DEG, _name)


@pytest.fixture(scope="module")
def trip(tmp_path_factory):
    return round_trip(tmp_path_factory.mktemp("degrade"))


class TestPortReshardEdgeCases(_DEG.TestReshardEdgeCases):
    def test_round_trip_4_2_4_matches_never_degraded(self, trip):
        """The smoke's walk on real worlds: final state bit-identical to
        a run that never degraded (section 3 of the module docstring)."""
        res = trip
        assert res["events"] == ["shrink@8->dp=2", "promote@9->4"]
        assert res["final_matches_fault_free"]
        assert res["steps_lost"] <= DEGRADE["every"]
        assert res["final_plan"] == res["from_plan"] == "dp=4"
        assert max(res["grad_accums"]) == 2
        assert res["grad_accum_final"] == 1


# -- 2. the same verdicts ---------------------------------------------------

RESOLVE_CASES = [("dp=4", 4, n) for n in range(1, 9)] + \
    [("dp=2,fsdp=2", 4, n) for n in (1, 2, 3, 4)] + \
    [("dp=4,tp=2", 8, n) for n in (1, 2, 3, 4, 6, 8)] + \
    [("dp=2,ep=4", 8, n) for n in (3, 4, 8)] + \
    [("dp=4,sp=2", 8, n) for n in (1, 6)] + \
    [("fsdp=4", 4, n) for n in (2, 3)]


@pytest.fixture
def jax_prices_h100(monkeypatch):
    """JAX's resolver prices with ``plan_cost_s``'s default model (v5e),
    the port's with its own (the H100): JAX's default is made the port's
    H100, field for field."""
    import functools

    from horovod_tpu.analysis import cost_model as JCM
    from horovod_tpu_torch.analysis import cost_model as TCM

    hw = JCM.HardwareModel(**dataclasses.asdict(TCM.H100))
    monkeypatch.setattr(JCM, "plan_cost_s",
                        functools.partial(JCM.plan_cost_s, hw=hw))


@pytest.mark.usefixtures("jax_prices_h100")
@pytest.mark.parametrize("base,world,n", RESOLVE_CASES)
@pytest.mark.parametrize("kw", [dict(payload_bytes=1e6),
                                dict(payload_bytes=3.48e9, compute_s=0.1,
                                     n_dcn=2, n_ici=2, min_data_extent=2)],
                         ids=["plain", "priced"])
def test_resolve_matches_jax(base, world, n, kw):
    jr = JD.DegradedPlanResolver(base, world, **kw)
    tr = TD.DegradedPlanResolver(base, world, **kw)
    assert tr.min_world() == jr.min_world()
    assert [p.to_string() for p in tr.candidates(n)] == \
        [p.to_string() for p in jr.candidates(n)]
    jd, td = jr.resolve(n), tr.resolve(n)
    assert (td.action, td.plan_string, td.cost_s, td.reason, td.wait_s) \
        == (jd.action, jd.plan_string, jd.cost_s, jd.reason, jd.wait_s)


@pytest.mark.usefixtures("jax_prices_h100")
@pytest.mark.parametrize("walk", [(2, 4), (3, 1, 4), (1, 2, 3, 4, 2)])
@pytest.mark.parametrize("promote", [True, False])
def test_controller_matches_jax(walk, promote):
    ctls = [mod.DegradeController(
        mod.DegradedPlanResolver("dp=4", 4, payload_bytes=64,
                                 compute_s=1e-3),
        global_batch=8, per_replica_batch=2, promote=promote,
        clock=lambda: 0.0) for mod in (JD, TD)]
    for step, n in enumerate(walk):
        jd, td = (c.on_world_change(n, step=step) for c in ctls)
        assert (td.action, td.plan_string, td.reason) == \
            (jd.action, jd.plan_string, jd.reason)
        assert [c.grad_accum() for c in ctls][0] == ctls[1].grad_accum()
        assert ctls[0].degraded == ctls[1].degraded
    assert ctls[1].history == ctls[0].history
    assert ctls[1].promoted_step == ctls[0].promoted_step


@pytest.mark.parametrize("gb,plan,per", [(8, "dp=2", 2), (8, "dp=4", 2),
                                         (10, "dp=4", 1),
                                         (16, "dp=3,ep=2", 2),
                                         (12, "dp=2,fsdp=3", 1)])
def test_preserve_global_batch_matches_jax(gb, plan, per):
    assert TD.preserve_global_batch(gb, TPlan.from_string(plan), per) == \
        JD.preserve_global_batch(gb, JPlan.from_string(plan), per)


def test_enabled(monkeypatch):
    monkeypatch.delenv("HOROVOD_DEGRADE", raising=False)
    assert TD.enabled() is JD.enabled() is False
    monkeypatch.setenv("HOROVOD_DEGRADE", "1")
    assert TD.enabled() is JD.enabled() is True


def test_names_in_hvd_elastic():
    import horovod_tpu_torch as hvd

    for name in ("DegradeController", "DegradeDecision",
                 "DegradedPlanResolver", "preserve_global_batch"):
        assert getattr(hvd.elastic, name) is getattr(TD, name)


# -- 3. the round trip on gloo worlds ---------------------------------------

def round_trip(tmp_path) -> dict:
    """The smoke's scenario (``_scenario``'s result keys) with each
    generation a real world: the controller decides in this process, the
    worlds train, checkpoint and restore."""
    d = DEGRADE
    ctl = TD.DegradeController(
        TD.DegradedPlanResolver(d["plan"], d["world"],
                                payload_bytes=4 * d["width"],
                                compute_s=1e-3),
        global_batch=d["global_batch"],
        per_replica_batch=d["per_replica_batch"], promote=True,
        clock=lambda: 0.0)
    directory = str(tmp_path / "ckpt")
    events, accums = [], []
    # generation 1: dp=4 to the kill; the last commit is step 6
    gen1 = spawn_world("run_degrade", world=d["world"],
                       args=(directory, d["plan"], 0, d["kill_at"]))
    accums += [gen1[0]["grad_accum"]] * d["kill_at"]
    decision = ctl.on_world_change(d["shrunk"], step=d["kill_at"])
    events.append(f"{decision.action}@{d['kill_at']}->"
                  f"{decision.plan_string}")
    restored = d["kill_at"] - d["kill_at"] % d["every"]
    # generation 2: the survivors replay from the commit to the boundary
    boundary = next(s for s in range(d["kill_at"] + 1, d["steps"] + 1)
                    if s % d["every"] == 0)
    gen2 = spawn_world("run_degrade", world=decision.plan.total,
                       args=(directory, decision.plan_string, restored,
                             boundary))
    accums += [ctl.grad_accum()] * (boundary - restored)
    decision = ctl.on_world_change(d["world"], step=boundary)
    events.append(f"{decision.action}@{boundary}->{decision.plan.total}")
    # generation 3: capacity back at the boundary, to the end
    gen3 = spawn_world("run_degrade", world=decision.plan.total,
                       args=(directory, decision.plan_string, boundary,
                             d["steps"]))
    accums += [ctl.grad_accum()] * (d["steps"] - boundary)
    w, m, r, losses = degrade_reference(d["steps"])
    got_m = np.concatenate([g["m"] for g in gen3])
    got_r = np.concatenate([g["r"] for g in gen3])
    committed = gen1[0]["losses"][:restored] + gen2[0]["losses"] + \
        gen3[0]["losses"]
    np.testing.assert_allclose(committed, losses, rtol=DEGRADE_LOSS_TOL)
    ga = TD.preserve_global_batch(d["global_batch"], ctl.current_plan,
                                  d["per_replica_batch"])
    return {
        "from_plan": ctl.base_plan.to_string(),
        "events": events,
        "steps_lost": d["kill_at"] - restored,
        "final_plan": ctl.current_plan.to_string(),
        "grad_accums": accums,
        "grad_accum_final": ga[0],
        "final_matches_fault_free": bool(
            all(np.array_equal(g["w"], w) for g in gen3)
            and np.array_equal(got_m, m) and np.array_equal(got_r, r)),
        "jax_events": JSMOKE._scenario(str(tmp_path / "jax"))["events"],
    }


def test_round_trip_events_match_the_jax_smoke(trip):
    assert trip["events"] == trip["jax_events"]


# -- 4. the elastic launcher under HOROVOD_DEGRADE=1 -------------------------

def test_launcher_shrinks_and_promotes(tmp_path):
    from test_torch_elastic_e2e import run_elastic

    both = ["localhost:2", "127.0.0.1:2"]
    run = run_elastic(
        tmp_path, [(0, both), (1, ["localhost:2"]), (None, both)],
        np=4, min_np=2, max_np=4, epochs=3,
        extra_env={"HOROVOD_DEGRADE": "1"},
        worker_args=("--model", "zero", "--ckpt-dir",
                     str(tmp_path / "ckpt")))
    assert run["rc"] == 0, run["stderr"][-3000:] + run["logs"]
    check_degrade_run(run)

