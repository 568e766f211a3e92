"""The port's training-state guard against the JAX package's.

1. ``tests/test_guard.py`` (the numerics guardian, the checksum, rollback
   over a checkpointed state, preemption, the peer-repair RPC, the
   composed guard and the module hook) and ``tests/test_chaos.py``'s
   ``TestGuardSDCRecovery``, run against the port's modules (their
   ``TpuState`` is the port's ``TorchState``; the port's ``Checkpointer``
   has no orbax switch) and collected here under ``Port`` names.
2. The same inputs through both packages: the guardian's verdicts and
   limits on seeded norm sequences, bit for bit; the fingerprint of the
   same leaves as numpy arrays, CPU tensors and through the card's
   arithmetic (run here on CPU tensors), equal to JAX's; the seeded
   silent-data-corruption scenario with torch tensors in ``TorchState``,
   step for step JAX's.
3. The ``corrupt`` fault on torch tensors: a tensor of the leaf's dtype
   and device comes back, the original untouched, the element JAX's
   picks moved by JAX's amount.
4. Preemption by a real SIGTERM in a process of its own, and a repair
   over the driver's and the peer's RPC with a ``TorchState`` snapshot.
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu import faults as jfaults
from horovod_tpu import guard as jguard
from horovod_tpu_torch import faults, guard
from horovod_tpu_torch.guard import checksum

from torch_port_workers import port_test_module

ROOT = Path(__file__).resolve().parents[1]

_GUARD = port_test_module("test_guard.py", [
    (r",\s*use_orbax=False", ""),
    ("hvd.elastic.TpuState", "hvd.elastic.TorchState"),
    ("hvd.runtime.Config", "hvd.runtime.config.Config")])
_CHAOS = port_test_module("test_chaos.py", [
    (r",\s*use_orbax=False", ""),
    ("hvd.elastic.TpuState", "hvd.elastic.TorchState")])

for _name in ("TestNumericsGuardian", "TestChecksum", "TestRollbackManager",
              "TestPreemptionHandler", "TestPeerRepairRPC",
              "TestTrainingGuard", "TestModuleHook"):
    globals()["TestPort" + _name[len("Test"):]] = getattr(_GUARD, _name)
TestPortGuardSDCRecovery = _CHAOS.TestGuardSDCRecovery
_clean = _GUARD._clean


def test_every_guard_case_is_collected():
    names = {n for n in vars(_GUARD) if n.startswith("Test")}
    here = {n[len("TestPort"):] for n in globals() if n.startswith("TestPort")}
    assert {n[len("Test"):] for n in names} <= here


# -- the guardian -----------------------------------------------------------

def _norms(seed: int) -> list:
    """A seeded norm sequence: a noisy baseline with non-finite values and
    spikes mixed in."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(60):
        r = rng.rand()
        if r < 0.05:
            out.append(float("nan") if i % 2 else float("inf"))
        elif r < 0.12:
            out.append(float(rng.uniform(20.0, 1e4)))
        else:
            out.append(float(np.exp(rng.normal(0.0, 0.3))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("zscore,warmup,ema",
                         [(6.0, 10, 0.99), (3.0, 2, 0.9), (1.5, 1, 0.5)])
def test_verdicts_and_limits_equal_jax(seed, zscore, warmup, ema):
    """Limits before each step and verdicts, float for float, on the same
    norms; half the steps judged against an explicit stale limit."""
    seen = []
    for mod in (jguard, guard):
        g = mod.NumericsGuardian(policy="skip_step", zscore=zscore,
                                 warmup_steps=warmup, ema=ema)
        trace = []
        for i, n in enumerate(_norms(seed)):
            limit = g.current_limit()
            stale = limit * 0.5 if i % 2 and math.isfinite(limit) else None
            trace.append((limit, g.observe(n, limit=stale),
                          g.observed_steps, g.anomalies))
        seen.append(trace)
    assert seen[0] == seen[1]


# -- the fingerprint --------------------------------------------------------

def _bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _trees():
    rng = np.random.RandomState(5)
    f32 = rng.randn(33, 7).astype(np.float32)
    yield "fp32", f32
    yield "bf16_odd", _bf16(rng.randn(3))           # 6 bytes: padded
    yield "int8_odd", rng.randint(-128, 127, 7).astype(np.int8)
    yield "int32", rng.randint(-2**31, 2**31 - 1, 9).astype(np.int32)
    yield "int64", rng.randint(-2**62, 2**62, 5).astype(np.int64)
    yield "bool", rng.rand(11) > 0.5
    yield "empty", np.zeros((0, 3), np.float32)
    yield "nested", {"z": [f32, {"b": _bf16(rng.randn(5, 2)),
                                 "a": rng.randint(0, 9, 3).astype(np.int32)}],
                     "a": (np.float32(2.5), 7, None, "tag"),
                     "m": {"y": rng.randn(4).astype(np.float32),
                           "x": rng.rand(3) > 0.2}}


def _as_tensors(tree):
    """The same leaves as CPU tensors (numpy scalars, Python objects and
    None as they are)."""
    from horovod_tpu_torch.utils import pytree

    def conv(_, leaf):
        if isinstance(leaf, np.ndarray):
            if leaf.dtype == ml_dtypes.bfloat16:
                return torch.from_numpy(
                    leaf.view(np.int16).copy()).view(torch.bfloat16)
            return torch.from_numpy(leaf.copy())
        return leaf

    return pytree.map_leaves(tree, conv)


@pytest.mark.parametrize("name,tree", list(_trees()),
                         ids=[n for n, _ in _trees()])
def test_fingerprint_equals_jax(name, tree, monkeypatch):
    """numpy leaves, CPU tensors, and the card's int64 arithmetic (forced
    here onto CPU tensors, in chunks of 4 words so that several chunks
    and the padded tail word run) give JAX's 64-bit value."""
    want = jguard.fingerprint(tree)
    assert guard.fingerprint(tree) == want
    tensors = _as_tensors(tree)
    assert guard.fingerprint(tensors) == want
    monkeypatch.setattr(checksum, "_CHUNK_WORDS", 4)
    from horovod_tpu_torch.utils import pytree

    for leaf in pytree.leaves(tensors):
        if isinstance(leaf, torch.Tensor):
            got = int(checksum._device_fingerprint(leaf)) & (2**64 - 1)
            assert got == checksum._leaf_fingerprint(leaf), name


def test_leaf_order_equals_jax():
    """``utils.pytree`` visits JAX's containers in JAX's order (sorted
    dict and defaultdict keys, an OrderedDict as inserted, namedtuples,
    None as no leaf) and keeps every other object whole, a subclass of a
    container and ``torch.Size`` included; ``map_leaves`` rebuilds the
    same containers."""
    import collections

    import jax

    from horovod_tpu_torch.utils import pytree

    nt = collections.namedtuple("NT", "b a")

    class Sub(dict):
        pass

    tree = {"z": [1, (2, None, nt(3, 4))],
            "a": collections.OrderedDict([("y", 5), ("x", 6)]),
            "m": collections.defaultdict(int, {"q": 7, "p": 8}),
            "s": torch.Size([9, 10]), "d": Sub(k=11)}
    assert pytree.leaves(tree) == jax.tree_util.tree_leaves(tree)
    copy = pytree.map_leaves(tree, lambda i, leaf: i)
    assert pytree.leaves(copy) == list(range(len(pytree.leaves(tree))))
    assert type(copy["a"]) is collections.OrderedDict and \
        type(copy["m"]) is collections.defaultdict and \
        type(copy["z"][1][2]) is nt and list(copy) == list(tree)


def test_fingerprint_sorts_dict_keys_as_jax():
    """Insertion order does not matter; an OrderedDict keeps its own."""
    import collections

    a, b = np.ones(2, np.float32), np.zeros(3, np.float32)
    assert guard.fingerprint({"b": b, "a": a}) == \
        guard.fingerprint({"a": a, "b": b}) == \
        jguard.fingerprint({"b": b, "a": a})
    od = collections.OrderedDict([("b", b), ("a", a)])
    assert guard.fingerprint(od) == jguard.fingerprint(od) != \
        guard.fingerprint({"a": a, "b": b})


# -- the corrupt fault on tensors -------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
def test_corrupt_returns_a_tensor_of_the_leaf(dtype):
    """A tensor comes back with the leaf's dtype and device, one element
    moved, the original untouched (on the parent tree a bf16 tensor
    raised TypeError in numpy, and an fp32 one came back as a numpy
    array)."""
    leaf = torch.linspace(-3, 3, 12, dtype=dtype).reshape(3, 4)
    keep = leaf.clone()
    plan = faults.FaultPlan(seed=3).add("guard.params", "corrupt", "2.0")
    out = plan.inject("guard.params", value={"w": leaf})
    assert isinstance(out["w"], torch.Tensor)
    assert out["w"].dtype == dtype and out["w"].device == leaf.device
    assert torch.equal(leaf, keep)
    assert int((out["w"] != leaf).sum()) == 1


@pytest.mark.parametrize("seed", [1, 4, 9, 17])
@pytest.mark.parametrize("scale", ["1.0", "0.3", "1e-3"])
def test_corrupt_matches_jax_on_tensors(seed, scale):
    """Dicts, lists and tuples of fp32, bf16 and fp16 tensors: the same
    element of the same leaf moved to the same value as JAX's action on
    the same leaves as numpy arrays (a dict's keys sorted in both)."""
    rng = np.random.RandomState(seed)
    tree = {"z": rng.randn(5, 7).astype(np.float32) * 100,
            "b": [_bf16(rng.randn(6)), (rng.randn(3).astype(np.float16),)],
            "a": rng.randn(2).astype(np.float32)}
    want = jfaults.FaultPlan(seed=seed).add(
        "guard.params", "corrupt", scale).inject("guard.params", value=tree)
    got = faults.FaultPlan(seed=seed).add(
        "guard.params", "corrupt", scale).inject(
            "guard.params", value=_as_tensors(tree))
    from horovod_tpu_torch.utils import pytree

    for g, w in zip(pytree.leaves(got), pytree.leaves(want)):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w).astype(np.float32))


# -- the chaos scenario with tensors ----------------------------------------

def _tensor_scenario(root: str) -> dict:
    """``TestGuardSDCRecovery.run_scenario`` with fp32 tensors for the two
    ranks' parameters and in the port's ``TorchState``."""
    from horovod_tpu_torch.checkpoint import Checkpointer
    from horovod_tpu_torch.elastic import TorchState

    sc = _CHAOS.TestGuardSDCRecovery()
    faults.set_plan(faults.FaultPlan(seed=sc.SEED).add(
        "guard.params", "corrupt", at=2 * sc.CORRUPT_AT, arg=1.0))
    ckpt = Checkpointer(root)
    state = TorchState(params={"w": torch.full((4,), 2.0)},
                       checkpointer=ckpt, checkpoint_every=sc.EVERY)
    rb = guard.RollbackManager(state)
    params = [state.params["w"].clone() for _ in range(2)]

    def gather(fp):
        return [guard.fingerprint({"w": w}) for w in params]

    guards = [guard.TrainingGuard(check_interval=sc.INTERVAL,
                                  gather_fn=gather,
                                  rollback=rb if r == 0 else None)
              for r in range(2)]
    detected_at = rank = replayed = None
    trajectory = []
    step = 0
    try:
        while step < sc.STEPS:
            step = state._commit_count + 1
            b = torch.from_numpy(sc.batch(step))
            params[:] = [w - 0.1 * (w - b) for w in params]
            state.params = {"w": params[0].clone()}
            state.commit()
            guards[0].note_commit()
            try:
                for r in range(2):
                    params[r] = guards[r].check_replicas(
                        step, {"w": params[r]})["w"]
            except guard.GuardRollback as e:
                detected_at = step
                rank = int(e.detail.split()[1])
                replayed = guards[0].rollback(reason="divergence")
                params[:] = [state.params["w"].clone() for _ in range(2)]
                continue
            trajectory.append(round(float(params[0].numpy().sum()), 6))
        state.wait()
    finally:
        faults.clear_plan()
    return dict(detected_at=detected_at, rank=rank, replayed=replayed,
                trajectory=tuple(trajectory), final=params[0],
                pinned=tuple(ckpt.pinned_steps()))


def test_sdc_scenario_with_tensors_equals_jax(tmp_path):
    """``TestGuardSDCRecovery``'s scenario through JAX's ``TpuState`` with
    numpy parameters and through the port's ``TorchState`` with fp32
    tensors (the corrupt fault and the fingerprint on tensors): the same
    detection step, named rank, replay count, pinned step, trajectory and
    final parameters, bit for bit."""
    import test_chaos

    want = test_chaos.TestGuardSDCRecovery().run_scenario(
        str(tmp_path / "jax"))
    got = _tensor_scenario(str(tmp_path / "port"))
    for key in ("detected_at", "rank", "replayed", "trajectory", "pinned"):
        assert got[key] == want[key], key
    assert isinstance(got["final"], torch.Tensor)
    np.testing.assert_array_equal(got["final"].numpy(), want["final"])


# -- preemption by a signal, repair over RPC --------------------------------

PREEMPT = r"""
import os, signal, sys, tempfile, time
import numpy as np, torch
from horovod_tpu_torch.checkpoint import Checkpointer
from horovod_tpu_torch.elastic import TorchState
from horovod_tpu_torch.guard import PreemptionHandler
root = sys.argv[1]
model = torch.nn.Linear(3, 2)
opt = torch.optim.AdamW(model.parameters(), lr=0.1)
ckpt = Checkpointer(root)
state = TorchState(model, opt, checkpointer=ckpt, checkpoint_every=100)
notes = []
handler = PreemptionHandler(state.priority_commit,
                            notify_fn=lambda: notes.append("notify")).install()
for step in range(1, 50):
    opt.zero_grad()
    model(torch.ones(4, 3)).sum().backward()
    opt.step()
    state.commit()
    if step == 3:
        os.kill(os.getpid(), signal.SIGTERM)
    if handler.draining:
        break
assert handler.finalize() and not handler.finalize()
handler.uninstall()
print(step, state._commit_count, ckpt.latest_step(), notes,
      torch.equal(ckpt.restore()["tensors"]["model"]["weight"],
                  model.weight.detach()))
"""


def test_sigterm_drains_commits_and_notifies(tmp_path):
    """SIGTERM in a process of its own (a handler installs on the main
    thread only): the loop stops after the step in flight, the priority
    commit lands on disk whatever ``checkpoint_every`` is, then the
    departure notice goes out, once."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", PREEMPT, str(tmp_path)],
                         capture_output=True, text=True, timeout=120,
                         env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[:5] == ["3", "4", "4", "['notify']", "True"]


def test_repair_from_peer_adopts_a_torch_snapshot():
    """The driver names a healthy peer (``GetHealthyPeerRequest``), whose
    notification server hands over its committed ``TorchState`` snapshot
    (``FetchStateRequest``): the tensors arrive equal."""
    from horovod_tpu_torch.elastic import TorchState
    from horovod_tpu_torch.elastic.worker import WorkerNotificationManager
    from horovod_tpu_torch.guard.repair import repair_from_peer
    from horovod_tpu_torch.runner.network import (
        BasicService,
        GetHealthyPeerRequest,
        NotificationServer,
        PeerAddressResponse,
    )

    key = "k"
    model = torch.nn.Linear(4, 3)
    state = TorchState(model, torch.optim.SGD(model.parameters(), lr=0.1))
    state.commit()
    mgr = WorkerNotificationManager()
    mgr.set_state_provider(lambda: (state._commit_count, state._snapshot))
    peer = NotificationServer(mgr, key)
    peer.start()
    asked = []

    def driver(req):
        assert isinstance(req, GetHealthyPeerRequest)
        asked.append((req.host, req.local_rank, req.rank))
        return PeerAddressResponse(0, ("127.0.0.1", peer.address[1]))

    svc = BasicService("driver", key, driver)
    svc.start()
    try:
        got = repair_from_peer(f"127.0.0.1:{svc.address[1]}", key, "h1", 0,
                               1)
    finally:
        svc.shutdown()
        peer.shutdown()
    assert asked == [("h1", 0, 1)]
    step, snap = got
    assert step == 1
    for name, t in model.state_dict().items():
        assert torch.equal(snap["model"][name], t)
