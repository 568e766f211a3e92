"""The port's checkpoint plane against the JAX package's
(``tests/test_checkpoint.py``): the async writer's contract, sharded (ZeRO)
save/restore across world sizes, retention pins and plan stamps, the
reshard of one leaf bit for bit against JAX's ``_reshard_leaf``, and the
sharded optimizer's state saved by a gloo world of 4 and restored by a
world of 2 (``run_ckpt_save`` / ``run_ckpt_restore`` in
``tests/torch_port_workers.py``, each world spawned once) and in the
geometry of a world of 8."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu import checkpoint as JCK
from horovod_tpu_torch import checkpoint as CK
from horovod_tpu_torch.ops import collectives as TC

from torch_port_workers import (
    CKPT_LR,
    assert_adam_close,
    mlp_params,
    spawn_world,
)

from test_torch_train_step import hvd_torch  # noqa: F401 - fixture


def make_state(v=1.0):
    return {"params": {"w": torch.full((4, 4), v), "b": torch.zeros(4)},
            "step": int(v)}


def ckpt_at(tmp_path, **kw):
    return CK.Checkpointer(str(tmp_path / "ck"), **kw)


class TestCheckpointer:
    def test_roundtrip(self, tmp_path):
        ckpt = ckpt_at(tmp_path)
        assert ckpt.save(0, make_state(3.0))
        restored = ckpt.restore()
        torch.testing.assert_close(restored["params"]["w"],
                                   torch.full((4, 4), 3.0))
        assert restored["step"] == 3

    def test_latest_and_retention(self, tmp_path):
        ckpt = ckpt_at(tmp_path, max_to_keep=2)
        for s in range(5):
            ckpt.save(s, make_state(float(s)))
        assert ckpt.latest_step() == 4
        assert ckpt.all_steps() == [3, 4]

    def test_restore_and_broadcast_world_of_one(self, tmp_path, hvd_torch):
        """The root's read lands in the target: tensors in place, numbers
        replaced."""
        ckpt = ckpt_at(tmp_path)
        ckpt.save(7, make_state(7.0))
        target = make_state(0.0)
        w = target["params"]["w"]
        restored = ckpt.restore_and_broadcast(target)
        assert restored["params"]["w"] is w
        torch.testing.assert_close(w, torch.full((4, 4), 7.0))
        assert restored["step"] == 7

    def test_restore_and_broadcast_refuses_another_structure(self, tmp_path):
        ckpt = ckpt_at(tmp_path)
        ckpt.save(1, make_state(1.0))
        with pytest.raises(ValueError, match="keys differ"):
            ckpt.restore_and_broadcast({"params": {"w": torch.zeros(4, 4)}})

    def test_missing_checkpoint_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            ckpt_at(tmp_path).restore()


class TestAsyncSave:
    def test_roundtrip_through_background_writer(self, tmp_path):
        ckpt = ckpt_at(tmp_path, async_save=True)
        assert ckpt.save(0, make_state(9.0))
        ckpt.wait()
        assert ckpt.last_stall_s is not None
        assert ckpt.last_write_s is not None
        torch.testing.assert_close(ckpt.restore()["params"]["w"],
                                   torch.full((4, 4), 9.0))

    def test_reads_see_pending_write(self, tmp_path):
        ckpt = ckpt_at(tmp_path)
        ckpt.save(3, make_state(3.0))
        assert ckpt.latest_step() == 3
        assert ckpt.restore()["step"] == 3

    def test_save_stalls_only_for_the_copy(self, tmp_path, monkeypatch):
        """A 0.3 s write stays off the caller's clock; wait() blocks for
        it."""
        real = CK._atomic_save
        started = threading.Event()

        def slow_write(path, payload):
            started.set()
            time.sleep(0.3)
            real(path, payload)

        monkeypatch.setattr(CK, "_atomic_save", slow_write)
        ckpt = ckpt_at(tmp_path)
        t0 = time.perf_counter()
        ckpt.save(0, make_state(1.0))
        stall = time.perf_counter() - t0
        assert started.wait(5.0)
        assert stall < 0.25
        t0 = time.perf_counter()
        ckpt.wait()
        assert time.perf_counter() - t0 > 0.05
        assert ckpt.last_write_s >= 0.3

    def test_writer_error_surfaces_at_wait(self, tmp_path):
        """A lambda survives the host copy but cannot pickle: the error is
        sticky until clear_error()."""
        ckpt = ckpt_at(tmp_path)
        ckpt.save(0, {"fn": lambda: None})
        with pytest.raises(Exception):
            ckpt.wait()
        with pytest.raises(Exception):
            ckpt.wait()
        with pytest.raises(Exception):
            ckpt.save(1, make_state(2.0))
        with pytest.raises(Exception):
            ckpt.close()
        assert ckpt.clear_error() is not None
        ckpt.save(1, make_state(2.0))
        ckpt.wait()
        assert ckpt.latest_step() == 1

    def test_failing_write_leaves_no_visible_half_step(self, tmp_path,
                                                       monkeypatch):
        monkeypatch.setattr(CK, "IO_ATTEMPTS", 1)

        def dying_write(path, payload):
            d = os.path.dirname(path)
            with open(os.path.join(d, ".tmp.state.pt.999"), "wb") as f:
                f.write(b"torso")
            raise OSError("disk pulled mid-write")

        monkeypatch.setattr(CK, "_atomic_save", dying_write)
        root = tmp_path / "ck"
        ckpt = CK.Checkpointer(str(root))
        ckpt.save(3, make_state(1.0))
        with pytest.raises(OSError, match="disk pulled"):
            ckpt.wait()
        ckpt.clear_error()
        assert ckpt.all_steps() == []
        with pytest.raises(FileNotFoundError):
            ckpt.restore()
        assert os.listdir(root / "step_3") == [".tmp.state.pt.999"]

    def test_transient_write_error_is_retried(self, tmp_path, monkeypatch):
        real = CK._atomic_save
        calls = []

        def flaky_write(path, payload):
            calls.append(path)
            if len(calls) == 1:
                raise OSError("transient")
            real(path, payload)

        monkeypatch.setattr(CK, "IO_BASE_S", 0.01)
        monkeypatch.setattr(CK, "_atomic_save", flaky_write)
        ckpt = ckpt_at(tmp_path)
        ckpt.save(0, make_state(6.0))
        ckpt.wait()
        assert len(calls) == 2
        torch.testing.assert_close(ckpt.restore()["params"]["w"],
                                   torch.full((4, 4), 6.0))

    def test_close_is_final_barrier(self, tmp_path):
        root = tmp_path / "ck"
        ckpt = CK.Checkpointer(str(root))
        ckpt.save(0, make_state(2.0))
        ckpt.close()
        assert os.path.exists(root / "step_0" / "state.pt")

    @pytest.mark.parametrize("kind", ["tensor", "numpy"])
    def test_snapshot_owns_host_arrays(self, tmp_path, monkeypatch, kind):
        """Overwriting the caller's host buffer after save() returns does
        not reach the pending write (a numpy leaf is kept as a tensor)."""
        real = CK._atomic_save
        gate = threading.Event()

        def gated_write(path, payload):
            gate.wait(5.0)
            real(path, payload)

        monkeypatch.setattr(CK, "_atomic_save", gated_write)
        ckpt = ckpt_at(tmp_path)
        w = torch.full((4,), 1.0) if kind == "tensor" else \
            np.full((4,), 1.0, np.float32)
        ckpt.save(0, {"w": w})
        w[:] = -99.0
        gate.set()
        ckpt.wait()
        torch.testing.assert_close(ckpt.restore()["w"], torch.full((4,), 1.0))

    def test_no_tmp_droppings_and_atomic_layout(self, tmp_path):
        root = tmp_path / "ck"
        ckpt = CK.Checkpointer(str(root))
        ckpt.save(0, make_state(1.0))
        ckpt.wait()
        assert os.listdir(root / "step_0") == ["state.pt"]

    def test_crashed_partial_write_is_invisible(self, tmp_path):
        root = tmp_path / "ck"
        ckpt = CK.Checkpointer(str(root))
        ckpt.save(0, make_state(1.0))
        ckpt.wait()
        os.makedirs(root / "step_1", exist_ok=True)
        (root / "step_1" / ".tmp.state.pt.999").write_bytes(b"partial")
        assert ckpt.all_steps() == [0]
        torch.testing.assert_close(ckpt.restore()["params"]["w"],
                                   torch.full((4, 4), 1.0))

    def test_bfloat16_leaves_roundtrip(self, tmp_path):
        ckpt = ckpt_at(tmp_path)
        state = {"w": torch.full((4, 2), 1.5, dtype=torch.bfloat16),
                 "nu": torch.arange(6, dtype=torch.bfloat16)}
        ckpt.save(0, state)
        back = ckpt.restore()
        assert back["w"].dtype == torch.bfloat16
        torch.testing.assert_close(back["nu"], state["nu"], rtol=0, atol=0)

    def test_sync_mode_is_durable_on_return(self, tmp_path):
        root = tmp_path / "ck"
        ckpt = CK.Checkpointer(str(root), async_save=False)
        ckpt.save(0, make_state(4.0))
        assert os.path.exists(root / "step_0" / "state.pt")

    def test_sync_mode_raises_at_save(self, tmp_path):
        """Synchronous: a failed write raises from save() and is not left
        sticky."""
        ckpt = ckpt_at(tmp_path, async_save=False)
        with pytest.raises(Exception):
            ckpt.save(0, {"fn": lambda: None})
        assert ckpt.clear_error() is None
        ckpt.save(1, make_state(1.0))
        assert ckpt.all_steps() == [1]


# ---------------------------------------------------------------------------
# sharded state
# ---------------------------------------------------------------------------

LEAVES = [np.arange(10, dtype=np.float32),
          np.arange(6, dtype=np.float32).reshape(2, 3) + 100.0]


def _shard_trees(leaves, world):
    """Per-rank sharded trees of ``leaves`` (tests/test_checkpoint.py):
    each group's flat buffer, zero-padded to a multiple of ``world`` and
    sliced per rank, with a replicated scalar."""
    spec = TC.make_fusion_spec([torch.from_numpy(x) for x in leaves], world)
    flats = {}
    for g in spec.groups:
        flat = np.concatenate([np.ravel(leaves[i]) for i in g.indices])
        flats[g.key] = np.concatenate(
            [flat, np.zeros(g.padded - flat.size, flat.dtype)])
    trees = [{k: {"m": torch.from_numpy(v[r * (v.size // world):
                                          (r + 1) * (v.size // world)]),
                  "count": torch.tensor(7)}
              for k, v in flats.items()} for r in range(world)]
    return spec, flats, trees


def _repad(full, padded):
    if padded >= full.size:
        return np.concatenate([full, np.zeros(padded - full.size,
                                              full.dtype)])
    return full[:padded]


def _save_all(tmp_path, world, plan=None):
    ckpt = ckpt_at(tmp_path)
    spec, flats, trees = _shard_trees(LEAVES, world)
    for r, tree in enumerate(trees):
        ckpt.save_sharded(0, tree, r, world, plan=plan)
        ckpt.wait()
    return ckpt, spec, flats, trees


def _target(trees_r):
    return {k: {"m": torch.zeros_like(v["m"]), "count": torch.tensor(0)}
            for k, v in trees_r.items()}


class TestShardedCheckpoint:
    def test_same_world_roundtrip(self, tmp_path):
        ckpt, _, _, trees = _save_all(tmp_path, 4)
        for r in range(4):
            out = ckpt.restore_sharded(_target(trees[r]), r, 4)
            for k in trees[r]:
                torch.testing.assert_close(out[k]["m"], trees[r][k]["m"],
                                           rtol=0, atol=0)
                assert int(out[k]["count"]) == 7

    @pytest.mark.parametrize("new_world", [2, 8, 3])
    def test_resharded_restore(self, tmp_path, new_world):
        """Saved at 4, restored at 2, 8 or 3 (3 trims padding): each shard
        is the slice of the re-padded flat buffer; the scalar is rank
        0's."""
        ckpt, _, flats, _ = _save_all(tmp_path, 4)
        new_spec = TC.make_fusion_spec([torch.from_numpy(x) for x in LEAVES],
                                       new_world)
        for r in range(new_world):
            target = {g.key: {"m": torch.zeros(g.shard),
                              "count": torch.tensor(0)}
                      for g in new_spec.groups}
            out = ckpt.restore_sharded(target, r, new_world)
            for g in new_spec.groups:
                full = _repad(flats[g.key], g.padded)
                np.testing.assert_array_equal(
                    out[g.key]["m"].numpy(),
                    full[r * g.shard:(r + 1) * g.shard])
                assert int(out[g.key]["count"]) == 7

    def test_plain_restore_of_sharded_step_raises_clear_error(self,
                                                              tmp_path):
        ckpt, _, _, _ = _save_all(tmp_path, 4)
        with pytest.raises(ValueError, match="restore_sharded"):
            ckpt.restore()

    def test_trimming_nonzero_state_raises(self, tmp_path):
        ckpt = ckpt_at(tmp_path)
        for r in range(4):
            ckpt.save_sharded(0, {"m": torch.ones(3)}, r, 4)
        with pytest.raises(ValueError, match="non-zero state"):
            ckpt.restore_sharded({"m": torch.zeros(5)}, 0, 2)

    def test_incomplete_shard_set_raises(self, tmp_path):
        ckpt = ckpt_at(tmp_path)
        ckpt.save_sharded(0, {"m": torch.ones(3)}, 0, 4)
        ckpt.save_sharded(0, {"m": torch.ones(3)}, 2, 4)
        with pytest.raises(FileNotFoundError, match=r"missing shard"):
            ckpt.restore_sharded({"m": torch.zeros(3)}, 0, 4)

    def test_mixed_world_overwrite_raises(self, tmp_path):
        ckpt = ckpt_at(tmp_path)
        for r in range(2):
            ckpt.save_sharded(0, {"m": torch.ones(4)}, r, 2)
        ckpt.save_sharded(0, {"m": torch.ones(2)}, 3, 4)
        with pytest.raises(ValueError, match="mixed shard_count"):
            ckpt.restore_sharded({"m": torch.zeros(4)}, 0, 2)

    def test_structure_mismatch_raises(self, tmp_path):
        ckpt, _, _, trees = _save_all(tmp_path, 4)
        with pytest.raises(ValueError, match="tree structure"):
            ckpt.restore_sharded({"m": torch.zeros(3)}, 0, 4)

    def test_shard_rank_out_of_range(self, tmp_path):
        with pytest.raises(ValueError, match="out of range"):
            ckpt_at(tmp_path).save_sharded(0, {"m": torch.ones(2)}, 4, 4)

    def test_all_steps_counts_both_layouts(self, tmp_path):
        ckpt, _, _, _ = _save_all(tmp_path, 4)
        ckpt.save(1, make_state(1.0))
        assert ckpt.all_steps() == [0, 1]


#: (saved pieces, target length, shard_rank, shard_count) of
#: _reshard_leaf's branches: same world, grow with zero padding, trim zero
#: padding, a non-dividing world, and the full-length per-rank
#: error-feedback residuals grown from 2 ranks to 4
RESHARD_CASES = [
    ([[1.0, 2.0], [3.0, 4.0]], 2, 1, 2),
    ([[1.0, 2.0], [3.0, 4.0]], 1, 3, 4),
    ([[1.0, 2.0, 3.0], [4.0, 0.0, 0.0]], 2, 1, 2),
    ([[1.0, 2.0, 3.0], [4.0, 5.0, 0.0]], 2, 2, 3),
    ([[1.0, 2.0, 0.0, 0.0], [5.0, 6.0, 0.0, 0.0]], 4, 3, 4),
    ([[1.0, 2.0, 0.0, 0.0], [5.0, 6.0, 0.0, 0.0]], 8, 1, 4),
]


class TestReshardLeafMatchesJax:
    @pytest.mark.parametrize("case", RESHARD_CASES)
    def test_bit_exact(self, case):
        saved, n, rank, count = case
        pieces = [np.asarray(p, np.float32) for p in saved]
        want = JCK._reshard_leaf(np.zeros(n, np.float32), pieces, rank,
                                 count)
        got = CK._reshard_leaf(torch.zeros(n),
                               [torch.from_numpy(p) for p in pieces], rank,
                               count)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_trim_refusal_matches_jax(self):
        pieces = [np.ones(4, np.float32)] * 2
        with pytest.raises(ValueError) as jerr:
            JCK._reshard_leaf(np.zeros(3, np.float32), pieces, 0, 2)
        with pytest.raises(ValueError) as terr:
            CK._reshard_leaf(torch.zeros(3),
                             [torch.from_numpy(p) for p in pieces], 0, 2)
        assert str(terr.value) == str(jerr.value)

    def test_scalar_takes_rank_zero(self):
        assert CK._reshard_leaf(torch.tensor(0.0),
                                [torch.tensor(3.0), torch.tensor(4.0)],
                                1, 2) == 3.0
        assert CK._reshard_leaf(5, [7, 8], 1, 2) == 7


class TestPinAgainstRetention:
    def test_pinned_step_survives_gc(self, tmp_path):
        ckpt = ckpt_at(tmp_path, max_to_keep=2)
        ckpt.save(0, make_state(0.0))
        ckpt.pin(0)
        for s in range(1, 6):
            ckpt.save(s, make_state(float(s)))
        assert ckpt.all_steps() == [0, 4, 5]
        torch.testing.assert_close(ckpt.restore(step=0)["params"]["w"],
                                   torch.zeros(4, 4))

    def test_unpin_rejoins_retention(self, tmp_path):
        ckpt = ckpt_at(tmp_path, max_to_keep=2)
        ckpt.save(0, make_state(0.0))
        ckpt.pin(0)
        for s in range(1, 4):
            ckpt.save(s, make_state(float(s)))
        assert 0 in ckpt.all_steps()
        ckpt.unpin(0)
        ckpt.save(4, make_state(4.0))
        assert 0 not in ckpt.all_steps()
        assert ckpt.pinned_steps() == []

    def test_pinned_steps_reports(self, tmp_path):
        ckpt = ckpt_at(tmp_path)
        ckpt.pin(3)
        ckpt.pin(7)
        assert ckpt.pinned_steps() == [3, 7]
        ckpt.unpin(3)
        assert ckpt.pinned_steps() == [7]


class TestPlanReshard:
    @pytest.mark.parametrize("new_plan", ["dp=4", "dp=1,sp=4", "dp=2,sp=2",
                                          "dp=2,fsdp=2"])
    def test_sp_restores_across_data_factorizations(self, tmp_path,
                                                    new_plan):
        ckpt, _, _, trees = _save_all(tmp_path, 4, plan="dp=2,sp=2")
        for r in range(4):
            out = ckpt.restore_sharded(_target(trees[r]), r, 4,
                                       plan=new_plan)
            for k in trees[r]:
                torch.testing.assert_close(out[k]["m"], trees[r][k]["m"],
                                           rtol=0, atol=0)

    def test_sp_checkpoint_reshards_to_wider_world(self, tmp_path):
        ckpt, _, flats, _ = _save_all(tmp_path, 4, plan="dp=2,sp=2")
        spec8 = TC.make_fusion_spec([torch.from_numpy(x) for x in LEAVES], 8)
        for r in (0, 7):
            target = {g.key: {"m": torch.zeros(g.shard),
                              "count": torch.tensor(0)}
                      for g in spec8.groups}
            out = ckpt.restore_sharded(target, r, 8, plan="dp=8")
            for g in spec8.groups:
                full = _repad(flats[g.key], g.padded)
                np.testing.assert_array_equal(
                    out[g.key]["m"].numpy(),
                    full[r * g.shard:(r + 1) * g.shard])

    @pytest.mark.parametrize("new_plan", ["dp=4,tp=2", "dp=4,ep=2",
                                          "dp=4,pp=2"])
    def test_model_extent_change_refuses(self, tmp_path, new_plan):
        """Refused with JAX's error, word for word."""
        ckpt, _, _, trees = _save_all(tmp_path, 4, plan="dp=2,sp=2")
        path = os.path.join(ckpt._dir, "step_0")
        with pytest.raises(ValueError, match="pp/ep/tp") as terr:
            ckpt.restore_sharded(_target(trees[0]), 0, 4, plan=new_plan)
        with pytest.raises(ValueError) as jerr:
            JCK._check_plan_reshard("dp=2,sp=2",
                                    JCK._canonical_plan(new_plan, 4), path)
        assert str(terr.value) == str(jerr.value)

    def test_plan_shard_count_mismatch_is_a_clear_error(self, tmp_path):
        with pytest.raises(ValueError, match=r"dp\*fsdp\*sp") as terr:
            ckpt_at(tmp_path).save_sharded(0, {"m": torch.ones(3)}, 0, 8,
                                           plan="dp=2,sp=2")
        with pytest.raises(ValueError) as jerr:
            JCK._canonical_plan("dp=2,sp=2", 8)
        assert str(terr.value) == str(jerr.value)

    def test_unstamped_checkpoint_restores_under_any_plan(self, tmp_path):
        ckpt, _, _, trees = _save_all(tmp_path, 4, plan=None)
        out = ckpt.restore_sharded(_target(trees[0]), 0, 4, plan="dp=1,sp=4")
        for k in trees[0]:
            torch.testing.assert_close(out[k]["m"], trees[0][k]["m"],
                                       rtol=0, atol=0)

    @pytest.mark.parametrize("plan,count", [("dp=2,sp=2", 4),
                                            ("sp=4", 4),
                                            ("dp=2,fsdp=2,tp=2", 4)])
    def test_canonical_plan_matches_jax(self, plan, count):
        assert CK._canonical_plan(plan, count) == \
            JCK._canonical_plan(plan, count)

    def test_saved_plan(self, tmp_path):
        ckpt, _, _, _ = _save_all(tmp_path, 4, plan="dp=2,sp=2")
        assert ckpt.saved_plan() == "dp=2,sp=2"
        ckpt.save(1, make_state(1.0))
        assert ckpt.saved_plan(1) is None


# ---------------------------------------------------------------------------
# the sharded optimizer: a world of 4 saves, worlds of 2 and 8 restore
# ---------------------------------------------------------------------------

class TestShardedOptimizerWorldOfOne:
    def test_template_before_the_first_step(self, hvd_torch):
        """A fresh wrapper's AdamW has no state: the template still names
        exp_avg, exp_avg_sq and step at each group's shard length, on the
        meta device; after a step it is the live state."""
        model = torch.nn.Linear(5, 3)
        opt = hvd_torch.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), 1e-2),
            shard_optimizer_states=True, exchange_bucket_bytes=32)
        tpl = opt.sharded_state_template()
        assert list(tpl["state"]) == [g.key for g in opt.spec.groups]
        for g in opt.spec.groups:
            st = tpl["state"][g.key]
            assert set(st) == {"step", "exp_avg", "exp_avg_sq"}
            assert st["exp_avg"].shape == (g.shard,)
            assert st["exp_avg"].device.type == "meta"
        assert not opt.sharded_state.inner.state
        model(torch.randn(4, 5)).sum().backward()
        opt.step()
        live = opt.sharded_state_template()
        assert live["state"][opt.spec.groups[0].key]["exp_avg"].device.type \
            == "cpu"

    def test_sgd_momentum_template(self, hvd_torch):
        model = torch.nn.Linear(5, 3)
        opt = hvd_torch.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            shard_optimizer_states=True)
        tpl = opt.sharded_state_template()
        assert set(tpl["state"][opt.spec.groups[0].key]) == \
            {"momentum_buffer"}

    def test_load_refuses_residual_mismatch(self, hvd_torch):
        model = torch.nn.Linear(5, 3)
        opt = hvd_torch.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), 1e-2),
            shard_optimizer_states=True)
        with pytest.raises(ValueError, match="residuals"):
            opt.load_sharded_state_dict({"state": {}, "residuals": {}})


@pytest.fixture(scope="module")
def saved_and_restored(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sharded"))
    saved = spawn_world("run_ckpt_save", world=4, args=(d,), timeout=240)
    restored = spawn_world("run_ckpt_restore", world=2, args=(d,),
                           timeout=240)
    return d, saved, restored


def _full_buffers(saved):
    """The world-4 state's flat buffers, concatenated over ranks:
    {group key: {name: array}}."""
    out = {}
    for key in saved[0]["state"]["state"]:
        out[key] = {n: np.concatenate([s["state"]["state"][key][n]
                                       for s in saved])
                    for n in ("exp_avg", "exp_avg_sq")}
    return out


class TestShardedOptimizerAcrossWorlds:
    def test_world_two_restores_the_resharded_state(self, saved_and_restored):
        """Each world-2 rank's AdamW moments are the world-4 buffers,
        trimmed of padding and re-sliced, bit for bit; step is rank 0's."""
        _, saved, restored = saved_and_restored
        full = _full_buffers(saved)
        for r, out in enumerate(restored):
            for key, padded, shard, _ in out["groups"]:
                for n in ("exp_avg", "exp_avg_sq"):
                    want = _repad(full[key][n], padded)
                    np.testing.assert_array_equal(
                        out["state"]["state"][key][n],
                        want[r * shard:(r + 1) * shard])
                assert out["state"]["state"][key]["step"] == \
                    saved[0]["state"]["state"][key]["step"]
                assert out["shapes"][key]["exp_avg"] == (shard,)

    def test_group_keys_do_not_depend_on_the_world(self, saved_and_restored):
        _, saved, restored = saved_and_restored
        assert [g[0] for g in saved[0]["groups"]] == \
            [g[0] for g in restored[0]["groups"]]
        assert [g[3] for g in saved[0]["groups"]] == \
            [g[3] for g in restored[0]["groups"]]

    def test_world_two_continues_the_training(self, saved_and_restored):
        """One step at world 2 from the restored state equals the world-4
        run's third step (the same global batch; only the order of the
        gradient sums differs), as assert_adam_close states."""
        _, saved, restored = saved_and_restored
        for out in restored:
            for name, want in saved[0]["params3"].items():
                assert_adam_close(out["params"][name], want, name, steps=1,
                                  lr=CKPT_LR)

    def test_world_eight_geometry(self, saved_and_restored):
        """Targets sized by the fusion spec at world 8 (as a world-8
        optimizer's template is): every rank's shard is the re-padded
        slice."""
        d, saved, _ = saved_and_restored
        ckpt = CK.Checkpointer(os.path.join(d, "adamw"))
        full = _full_buffers(saved)
        leaves = [torch.from_numpy(v) for v in mlp_params().values()]
        spec8 = TC.make_fusion_spec(leaves, 8, 64)
        assert [g.key for g in spec8.groups] == list(full)
        for r in range(8):
            target = {"state": {g.key: {
                "step": torch.tensor(0.0),
                "exp_avg": torch.zeros(g.shard),
                "exp_avg_sq": torch.zeros(g.shard)} for g in spec8.groups}}
            out = ckpt.restore_sharded(target, r, 8, step=2, plan="dp=8")
            for g in spec8.groups:
                for n in ("exp_avg", "exp_avg_sq"):
                    want = _repad(full[g.key][n], g.padded)
                    np.testing.assert_array_equal(
                        out["state"][g.key][n].numpy(),
                        want[r * g.shard:(r + 1) * g.shard])

    def test_error_feedback_round_trip_at_the_same_world(self,
                                                         saved_and_restored):
        """int8 + error feedback: moments and each rank's full-length
        residuals restore bit for bit into a fresh wrapper at world 4."""
        _, saved, _ = saved_and_restored
        for out in saved:
            before, after = out["ef"]
            assert set(before) == {"state", "residuals"}
            for key, r in before["residuals"].items():
                np.testing.assert_array_equal(after["residuals"][key], r)
            for key, st in before["state"].items():
                for n, v in st.items():
                    np.testing.assert_array_equal(after["state"][key][n], v)

    def test_restore_and_broadcast_and_resolve_step(self, saved_and_restored):
        _, saved, _ = saved_and_restored
        for out in saved:
            np.testing.assert_array_equal(out["broadcast"]["w"],
                                          np.arange(6.0).reshape(2, 3))
            assert out["broadcast"]["n"] == 5
            assert out["broadcast"]["tag"] == "five"
            assert out["resolved"] == 5


class TestRetry:
    """The writer's retry (``checkpoint._io_retry``) against JAX's default
    policy."""

    @pytest.mark.parametrize("attempt", [0, 1, 3, 10])
    def test_backoff_matches_jax(self, monkeypatch, attempt):
        from horovod_tpu.runtime.retry import RetryPolicy as JRetry

        for name in ("MAX_ATTEMPTS", "BASE_S", "MAX_S", "DEADLINE_S"):
            monkeypatch.delenv(f"HOROVOD_RETRY_{name}", raising=False)
        monkeypatch.setenv("HOROVOD_RETRY_JITTER", "0")
        jax = JRetry()
        assert (CK.IO_ATTEMPTS, CK.IO_DEADLINE_S) == \
            (jax.max_attempts, jax.deadline_s)
        assert CK._io_backoff_cap(attempt) == jax.backoff_s(attempt)

    def test_attempts_and_non_retryable(self, monkeypatch):
        monkeypatch.setattr(CK, "IO_BASE_S", 0.0)
        calls = []

        def failing(exc):
            calls.append(exc)
            raise exc("boom")

        with pytest.raises(OSError):
            CK._io_retry(failing, OSError)
        assert len(calls) == CK.IO_ATTEMPTS == 5
        with pytest.raises(ValueError):
            CK._io_retry(failing, ValueError)
        assert len(calls) == 6
