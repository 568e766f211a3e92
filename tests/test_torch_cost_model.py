"""The port's cost model against the JAX package's: every function of the
hardware model's resolution, the exchange model, plan pricing, the plan's
memory high-water and the schedule scorers, on the same inputs and one
explicit :class:`HardwareModel` built with the same fields in both
packages, equal exactly (the port's module is a copy; only its presets
differ: ``H100`` and ``CPU_TWIN``, no TPU preset)."""

import dataclasses
import json
import warnings

import pytest

from horovod_tpu.analysis import cost_model as J
from horovod_tpu_torch.analysis import cost_model as T

#: two hardware models, built field for field in both packages: the port's
#: H100 preset and an arbitrary slower one
HW_FIELDS = [dataclasses.asdict(T.H100),
             dict(name="slow", peak_flops_per_s=1e14, hbm_bytes_per_s=1e12,
                  ici_bytes_per_s=1e11, dcn_bytes_per_s=1e10,
                  hbm_capacity_bytes=24e9)]
PLANS = ["dp=8", "dp=4,tp=2", "dp=2,fsdp=2,tp=2", "pp=4,dp=2", "pp=2,v=2,dp=4",
         "dp=2,sp=4", "ep=4,dp=2", "fsdp=8", {"dp": 2, "tp": 4}, "dp=?,tp=2"]
FABRICS = [(1, 1), (1, 8), (2, 4), (4, 2), (8, 1), (3, 5)]


def hws(fields):
    return J.HardwareModel(**fields), T.HardwareModel(**fields)


def same(a, b):
    """Equal values; the packages' dataclasses compared by their fields."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        return same(dataclasses.asdict(a), dataclasses.asdict(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        return all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        return all(same(x, y) for x, y in zip(a, b))
    assert a == b, (a, b)
    return True


class TestPresets:
    def test_no_tpu_preset(self):
        """The port carries H100 and CPU_TWIN only; v5e is refused, naming
        the port's presets."""
        assert set(T.HW_PRESETS) == {"h100", "cpu-twin"}
        for name in ("V5E", "V5P", "V4"):
            assert not hasattr(T, name)
        assert same(T.CPU_TWIN, J.CPU_TWIN)
        with pytest.raises(ValueError, match=r"\['cpu-twin', 'h100'\]"):
            T.resolve_hardware_model(preset="v5e")

    def test_h100_published_figures(self):
        assert (T.H100.peak_flops_per_s, T.H100.hbm_bytes_per_s,
                T.H100.ici_bytes_per_s, T.H100.dcn_bytes_per_s) == \
            (989e12, 3.35e12, 450e9, 50e9)

    def test_env_preset_refuses_v5e(self, monkeypatch):
        monkeypatch.setenv("HOROVOD_HW_PRESET", "v5e")
        with pytest.raises(ValueError, match="HOROVOD_HW_PRESET 'v5e'"):
            T.resolve_hardware_model()

    @pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3",
                                      "NVIDIA H100 PCIe", "cpu", "CPU"])
    def test_device_kind(self, kind):
        want = T.CPU_TWIN if "cpu" in kind.lower() else T.H100
        assert T.preset_for_device_kind(kind) is want
        assert T.resolve_hardware_model(device_kind=kind) is want

    def test_unknown_kind_warns_and_defaults_to_h100(self, monkeypatch):
        monkeypatch.delenv("HOROVOD_HW_PRESET", raising=False)
        monkeypatch.delenv("HOROVOD_CALIBRATION_PATH", raising=False)
        with pytest.warns(UserWarning, match="unrecognized device_kind"):
            assert T.preset_for_device_kind("NVIDIA A100") is None
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert T.resolve_hardware_model(device_kind="A100") is T.H100
        assert T.resolve_hardware_model() is T.H100

    def test_calibration_beats_preset(self, tmp_path, monkeypatch):
        from horovod_tpu_torch.analysis import calibration as CAL

        art = CAL.simulated_calibration(seed=3)
        path = tmp_path / "cal.json"
        path.write_text(json.dumps(art))
        monkeypatch.setenv("HOROVOD_HW_PRESET", "cpu-twin")
        monkeypatch.setenv("HOROVOD_CALIBRATION_PATH", str(path))
        hw = T.resolve_hardware_model()
        assert hw.name == "calibrated:simulated:h100"
        # the capacity comes from the calibrated kind's preset, which only
        # the port has for an H100
        assert hw.hbm_capacity_bytes == T.H100.hbm_capacity_bytes
        assert same(dataclasses.replace(hw, hbm_capacity_bytes=None),
                    J.HardwareModel.from_calibration(art))
        path.write_text("{")
        with pytest.raises(ValueError, match="does not load"):
            T.resolve_hardware_model()


class TestExchange:
    @pytest.mark.parametrize("fabric", FABRICS)
    @pytest.mark.parametrize("hierarchy", ["flat", "two_level"])
    @pytest.mark.parametrize("bits", [8, 16, 32])
    def test_exchange_wire_bytes(self, fabric, hierarchy, bits):
        n_dcn, n_ici = fabric
        kw = dict(n_dcn=n_dcn, n_ici=n_ici, hierarchy=hierarchy,
                  wire_bits_dcn=bits)
        same(J.exchange_wire_bytes(3.48e9, **kw),
             T.exchange_wire_bytes(3.48e9, **kw))

    @pytest.mark.parametrize("levels", [
        (("ici", 4), ("dcn", 2, 8)), (("local", 8),),
        (("chip", 2, None), ("slice", 4, 16), ("pod", 3, 8))])
    @pytest.mark.parametrize("fields", HW_FIELDS, ids=["h100", "slow"])
    def test_by_level(self, levels, fields):
        jh, th = hws(fields)
        jw = J.exchange_wire_by_level(1e9, levels)
        tw = T.exchange_wire_by_level(1e9, levels)
        same(jw, tw)
        same(J.level_bandwidths(levels, jh), T.level_bandwidths(levels, th))
        same(J.exchange_time_by_level(jw, J.level_bandwidths(levels, jh)),
             T.exchange_time_by_level(tw, T.level_bandwidths(levels, th)))

    @pytest.mark.parametrize("fields", HW_FIELDS, ids=["h100", "slow"])
    @pytest.mark.parametrize("fabric", FABRICS)
    def test_time_and_adasum(self, fields, fabric):
        jh, th = hws(fields)
        n_dcn, n_ici = fabric
        jw = J.exchange_wire_bytes(2e9, n_dcn=n_dcn, n_ici=n_ici)
        tw = T.exchange_wire_bytes(2e9, n_dcn=n_dcn, n_ici=n_ici)
        same(J.exchange_time_s(jw, jh), T.exchange_time_s(tw, th))
        same(J.adasum_extra_wire_bytes(2e9, n_dcn, n_ici),
             T.adasum_extra_wire_bytes(2e9, n_dcn, n_ici))

    @pytest.mark.parametrize("wire,compute,tiles", [
        (0.0, 1.0, 4), (1.0, 0.0, 4), (1.0, 0.5, 4), (1.0, 2.0, 1),
        (3.0, 1.0, 8), (-1.0, 1.0, 4)])
    def test_fused_tail(self, wire, compute, tiles):
        same(J.fused_tail_exchange_s(wire, compute, tiles),
             T.fused_tail_exchange_s(wire, compute, tiles))

    def test_bad_hierarchy(self):
        for mod in (J, T):
            with pytest.raises(ValueError, match="flat|two_level"):
                mod.exchange_wire_bytes(1.0, hierarchy="ring")


class TestPlans:
    @pytest.mark.parametrize("plan", PLANS, ids=str)
    def test_parse_plan(self, plan):
        same(J.parse_plan(plan), T.parse_plan(plan))

    @pytest.mark.parametrize("bad", ["dp", "xx=2", "dp=2,dp=2", "dp=0"])
    def test_parse_plan_errors(self, bad):
        with pytest.raises(ValueError) as je:
            J.parse_plan(bad)
        with pytest.raises(ValueError) as te:
            T.parse_plan(bad)
        assert str(je.value) == str(te.value)

    @pytest.mark.parametrize("s,m,v", [(1, 8, 1), (4, 8, 1), (4, 8, 2),
                                       (8, 3, 4)])
    def test_bubble(self, s, m, v):
        same(J.pipeline_bubble_fraction(s, m, v),
             T.pipeline_bubble_fraction(s, m, v))

    @pytest.mark.parametrize("plan", PLANS, ids=str)
    @pytest.mark.parametrize("fabric", FABRICS)
    @pytest.mark.parametrize("fields", HW_FIELDS, ids=["h100", "slow"])
    def test_plan_cost(self, plan, fabric, fields):
        jh, th = hws(fields)
        n_dcn, n_ici = fabric
        kw = dict(n_dcn=n_dcn, n_ici=n_ici, compute_s=0.15)
        same(J.plan_exchange_wire_bytes(plan, 3e9, n_dcn=n_dcn, n_ici=n_ici),
             T.plan_exchange_wire_bytes(plan, 3e9, n_dcn=n_dcn, n_ici=n_ici))
        for red in ("sum", "adasum"):
            same(J.plan_cost_s(plan, 3e9, hw=jh, reduction=red, **kw),
                 T.plan_cost_s(plan, 3e9, hw=th, reduction=red, **kw))

    def test_plan_wire_over_a_topology(self):
        topo = (("chip", 2), ("slice", 2), ("pod", 2))
        same(J.plan_exchange_wire_bytes("dp=8", 1e9, topology=topo),
             T.plan_exchange_wire_bytes("dp=8", 1e9, topology=topo))
        for mod in (J, T):
            with pytest.raises(ValueError, match="does not factor"):
                mod.plan_exchange_wire_bytes("dp=4", 1e9, topology=topo)

    @pytest.mark.parametrize("fields", HW_FIELDS, ids=["h100", "slow"])
    def test_rank_plans(self, fields):
        jh, th = hws(fields)
        plans = [p for p in PLANS if isinstance(p, str)]
        kw = dict(n_dcn=2, n_ici=4, compute_s=0.1, microbatches=4)
        same(J.rank_plans(plans, 2e9, hw=jh, **kw),
             T.rank_plans(plans, 2e9, hw=th, **kw))


class TestMemory:
    def test_vocabulary_and_constants(self):
        assert T.REMAT_POLICIES == J.REMAT_POLICIES
        assert T.REMAT_ACTIVATION_FRACTION == J.REMAT_ACTIVATION_FRACTION
        assert T.REMAT_RECOMPUTE_OVERHEAD == J.REMAT_RECOMPUTE_OVERHEAD
        assert T.OFFLOAD_RESIDENT_FRACTION == J.OFFLOAD_RESIDENT_FRACTION

    @pytest.mark.parametrize("plan", PLANS[:8])
    @pytest.mark.parametrize("policy", ["none", "dots", "full", "offload"])
    @pytest.mark.parametrize("kw", [
        {}, dict(microbatches=4, shard_optimizer_states=True),
        dict(offload_optimizer=True, exchange_bucket_bytes=64 << 20),
        dict(expert_param_bytes=2e9, moe_capacity_buffer_bytes=3e8,
             optimizer_slots=1)], ids=["plain", "zero", "offload", "moe"])
    def test_plan_memory_bytes(self, plan, policy, kw):
        args = dict(param_bytes=3.48e9, activation_bytes=12e9,
                    remat_policy=policy, **kw)
        jm = J.plan_memory_bytes(plan, **args)
        tm = T.plan_memory_bytes(plan, **args)
        same(jm, tm)
        assert jm.total == tm.total and jm.tightest == tm.tightest
        for budget in (None, 1e9, 5e9, 50e9):
            for fields in HW_FIELDS:
                jh, th = hws(fields)
                assert J.plan_fits(jm, budget, jh) == \
                    T.plan_fits(tm, budget, th)

    def test_unknown_policy(self):
        for mod in (J, T):
            with pytest.raises(ValueError, match="unknown remat policy"):
                mod.plan_memory_bytes("dp=1", param_bytes=1,
                                      activation_bytes=1,
                                      remat_policy="most")


class TestScorers:
    POINTS = [{}, {"steps_per_call": 4},
              {"hierarchy": "flat"}, {"hierarchy": "two_level"},
              {"fused_collectives": "on"}, {"wire_dtype": "int8"},
              {"hierarchy": "flat", "wire_dtype": "fp8_e4m3"},
              {"reduction": "adasum"},
              {"plan": "dp=2,sp=4", "fused_collectives": "on"},
              {"plan": "pp=2,v=2,dp=4", "reduction": "adasum"},
              {"plan": "dp=4,tp=2", "wire_dtype": "fp32"}]

    @pytest.mark.parametrize("point", POINTS, ids=json.dumps)
    @pytest.mark.parametrize("fields", HW_FIELDS, ids=["h100", "slow"])
    def test_score_exchange_schedule(self, point, fields):
        jh, th = hws(fields)
        kw = dict(n_dcn=2, n_ici=4, compute_s=0.05, sp_attn_wire_s=0.01,
                  sp_attn_compute_s=0.02)
        same(J.score_exchange_schedule(point, 2e9, hw=jh, **kw),
             T.score_exchange_schedule(point, 2e9, hw=th, **kw))

    @pytest.mark.parametrize("sp", [1, 2, 4, 8])
    @pytest.mark.parametrize("fields", HW_FIELDS, ids=["h100", "slow"])
    def test_sp(self, sp, fields):
        jh, th = hws(fields)
        same(J.sp_ring_wire_bytes(1024, 16, 128, sp, batch=6),
             T.sp_ring_wire_bytes(1024, 16, 128, sp, batch=6))
        for causal in (False, True):
            same(J.sp_attention_compute_s(4096, 16, 128, sp, 6, causal, jh),
                 T.sp_attention_compute_s(4096, 16, 128, sp, 6, causal, th))
        for fused in (False, True):
            same(J.sp_ring_exposed_s(0.01, 0.004, sp, fused),
                 T.sp_ring_exposed_s(0.01, 0.004, sp, fused))

    @pytest.mark.parametrize("ep", [1, 2, 4, 8])
    @pytest.mark.parametrize("fields", HW_FIELDS, ids=["h100", "slow"])
    def test_moe(self, ep, fields):
        jh, th = hws(fields)
        same(J.moe_capacity(16384, 8, 1.25), T.moe_capacity(16384, 8, 1.25))
        same(J.moe_dispatch_wire_bytes(16384, 1024, 8, ep),
             T.moe_dispatch_wire_bytes(16384, 1024, 8, ep))
        same(J.moe_expert_compute_s(16384, 1024, 4096, 8, ep, hw=jh),
             T.moe_expert_compute_s(16384, 1024, 4096, 8, ep, hw=th))
        for fused in (False, True):
            same(J.moe_dispatch_exposed_s(0.002, 0.001, ep, fused),
                 T.moe_dispatch_exposed_s(0.002, 0.001, ep, fused))
        for point in ({}, {"capacity_factor": 1.5},
                      {"tokens_per_expert": 2048},
                      {"capacity_factor": 2.0, "tokens_per_expert": 1000}):
            kw = dict(tokens=16384, d_model=1024, d_ff=4096, num_experts=8,
                      ep=ep, fused=ep > 2)
            same(J.score_moe_schedule(point, hw=jh, **kw),
                 T.score_moe_schedule(point, hw=th, **kw))
