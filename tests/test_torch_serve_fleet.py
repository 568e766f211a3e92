"""The port's serving fleet (tenancy, live weight refresh, autoscale)
against the JAX package's.

1. ``tests/test_serve_fleet.py`` (SLO classes, weighted-fair picks and
   the starvation bound, overload shedding, cost-model seeded estimates,
   the fleet's executable cache, the refresher, its staging through the
   host-offload engine, the fleet batcher, scale-signal hysteresis, the
   autoscale controller and its degrade wiring) run against the port's
   modules, collected here under ``Port`` names; its smoke class runs the
   JAX package's demo script.
2. The JAX package's seeded fleet scenario (``horovod_tpu/serve/
   fleet_smoke.py``: three tenants on a logical clock, a refresh flipped
   mid-load, a replica crash, autoscale repair, drains) through both
   packages: the same admissions, responses, weight fingerprints, picks,
   flips, scale-ups, deaths, drains and clock.
3. A refresh of torch tensors through ``HostOffloadEngine`` and a
   ``serve.refresh`` corrupt fault: caught by the fingerprint verify,
   rolled back and quarantined, as JAX's refresher does with the same
   weights as numpy arrays; the flip that follows commits, and every
   response carries the fingerprint of the buffer it ran on.
"""

import numpy as np
import pytest
import torch

from horovod_tpu import faults as jfaults
from horovod_tpu.serve import refresh as JR
from horovod_tpu_torch import faults
from horovod_tpu_torch.memory import HostOffloadEngine
from horovod_tpu_torch.serve import WeightRefresher

from torch_port_workers import port_test_module

_FLEET = port_test_module("test_serve_fleet.py")
for _name in ("TestSLOClasses", "TestWeightedFair", "TestOverloadShedding",
              "TestEwmaSeeding", "TestExecutableCacheFleet",
              "TestWeightRefresher", "TestRefreshOnTheOffloadEngine",
              "TestFleetBatcher", "TestScaleSignalHysteresis",
              "TestAutoscaleController"):
    globals()["TestPort" + _name[len("Test"):]] = getattr(_FLEET, _name)
_no_fault_plan = _FLEET._no_fault_plan


def test_every_fleet_case_is_collected():
    names = {n for n in vars(_FLEET) if n.startswith("Test")}
    here = {n[len("TestPort"):] for n in globals() if n.startswith("TestPort")}
    assert {n[len("Test"):] for n in names} - here == {"FleetSmoke"}


def test_seeded_fleet_scenario_equals_jax():
    """Every field of the scenario's summary, the weight fingerprints of
    numpy weights included: equal; the port's run passes the JAX
    package's own checks."""
    from horovod_tpu.serve import fleet_smoke as jsmoke

    port = port_test_module("horovod_tpu/serve/fleet_smoke.py")
    got, want = port._scenario(), jsmoke._scenario()
    assert got == want
    assert got["flips"] == 1 and got["scale_ups"] >= 1
    assert port.run_smoke() == []


def _weights(v: float, seed: int = 0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(16, 8).astype(np.float32) + v,
            "b": np.full(8, v, np.float32)}


def _tensors(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


@pytest.mark.parametrize("corrupt", [False, True])
def test_tensor_refresh_through_the_engine_equals_jax(corrupt):
    """Register, stage through the engine and flip, with a ``serve.refresh``
    corrupt fault on the first flip or none: the port with tensors and
    JAX with numpy arrays agree on every fingerprint, flip, rollback and
    quarantined tag; a rolled-back flip keeps the old weights serving."""
    runs = []
    for pkg, conv in ((jfaults, None), (faults, _tensors)):
        ref_mod = JR if pkg is jfaults else None
        if corrupt:
            pkg.set_plan(pkg.FaultPlan(seed=5).add("serve.refresh",
                                                   "corrupt", at=1))
        try:
            w0, w1, w2 = (_weights(v, i) for i, v in enumerate((1.0, 2.0,
                                                                3.0)))
            if conv is not None:
                w0, w1, w2 = conv(w0), conv(w1), conv(w2)
                engine = HostOffloadEngine(name="refresh")
                r = WeightRefresher(engine=engine)
            else:
                engine = None
                r = ref_mod.WeightRefresher()
            trace = [r.register("m", w0)]
            r.stage("m", w1, tag="t1")
            trace += [r.maybe_flip("m"), r.fingerprint_of("m")]
            r.stage("m", w2, tag="t2")
            trace += [r.maybe_flip("m"), r.fingerprint_of("m"), r.flips,
                      r.rollbacks, list(r.quarantined)]
            active = r.active("m")[0]
            trace.append(float(np.asarray(active["b"])[0]))
            if engine is not None:
                assert isinstance(active["w"], torch.Tensor)
                engine.close()
        finally:
            pkg.clear_plan()
        runs.append(trace)
    assert runs[0] == runs[1]
    if corrupt:
        assert runs[1][1] is False and runs[1][-2] == [("m", "t1")]
