"""The port's calibration against the JAX package's: the alpha-beta fits,
the artifact and its schema checks, and the simulated sweep give the same
numbers and the same fingerprint from one seed and one hardware model; and
``measure_artifact`` on a gloo world of 4 (``run_calibrate`` in
``tests/torch_port_workers.py``) writes an artifact that both packages'
``validate_calibration`` accept and both ``HardwareModel.from_calibration``
read alike."""

import dataclasses
import json

import pytest

from horovod_tpu.analysis import calibration as JCAL
from horovod_tpu.analysis import cost_model as JCM
from horovod_tpu_torch.analysis import calibration as TCAL
from horovod_tpu_torch.analysis import cost_model as TCM

from torch_port_workers import CAL_SWEEP, spawn_world

#: the artifact fields that name the framework's version, which differ
VERSION_FIELDS = ("jax_version", "jaxlib_version", "torch_version",
                  "cuda_version")


def _without_versions(art):
    return {k: v for k, v in art.items() if k not in VERSION_FIELDS}


SWEEPS = [([2 ** p for p in range(16, 27, 2)], 25e-6, 40e9),
          ([1e5, 1e6, 1e7], 1e-5, 1e10),
          ([1e6, 2e6, 4e6], -1e-6, 1e10)]


class TestFits:
    @pytest.mark.parametrize("sizes,alpha,beta", SWEEPS)
    def test_fit_alpha_beta(self, sizes, alpha, beta):
        times = [alpha + n / beta for n in sizes]
        assert TCAL.fit_alpha_beta(sizes, times) == \
            JCAL.fit_alpha_beta(sizes, times)
        jf = JCAL.fit_level("reduce_scatter", sizes, times)
        tf = TCAL.fit_level("reduce_scatter", sizes, times)
        assert dataclasses.asdict(jf) == dataclasses.asdict(tf)
        assert jf.as_json() == tf.as_json()
        assert jf.predict_s(3e6) == tf.predict_s(3e6)

    @pytest.mark.parametrize("sizes,times,match", [
        ([1e6], [1e-3], ">= 2"), ([1e6, 1e6], [1e-3, 1e-3], "distinct"),
        ([1e6, 2e6], [2e-3, 1e-3], "slope")])
    def test_degenerate_sweeps(self, sizes, times, match):
        for mod in (JCAL, TCAL):
            with pytest.raises(ValueError, match=match):
                mod.fit_alpha_beta(sizes, times)

    @pytest.mark.parametrize("seed", [0, 7])
    def test_simulate(self, seed):
        sizes = JCAL.DEFAULT_SWEEP_BYTES
        assert TCAL.simulate_sweep(2e-6, 1e11, sizes, seed) == \
            JCAL.simulate_sweep(2e-6, 1e11, sizes, seed)
        assert TCAL.simulate_level_measurements(1e11, 2e-6, sizes, seed) \
            == JCAL.simulate_level_measurements(1e11, 2e-6, sizes, seed)
        assert TCAL.CALIBRATED_COLLECTIVES == JCAL.CALIBRATED_COLLECTIVES
        assert TCAL.DEFAULT_SWEEP_BYTES == JCAL.DEFAULT_SWEEP_BYTES


class TestSimulatedCalibration:
    @pytest.mark.parametrize("seed", [3, 17])
    @pytest.mark.parametrize("levels", [("ici", "dcn"), ("local", "cross"),
                                        ("local",)])
    def test_same_artifact(self, seed, levels):
        """One seed, one hardware model with the same fields: the same
        fits, the same artifact and the same fingerprint."""
        fields = dataclasses.asdict(TCM.H100)
        jart = JCAL.simulated_calibration(
            JCM.HardwareModel(**fields), level_order=levels, seed=seed)
        tart = TCAL.simulated_calibration(
            TCM.HardwareModel(**fields), level_order=levels, seed=seed)
        assert _without_versions(tart) == _without_versions(jart)
        assert tart["calibration_fingerprint"] == \
            jart["calibration_fingerprint"]
        assert TCAL.validate_calibration(tart) == []
        assert JCAL.validate_calibration(tart) == []
        assert dataclasses.asdict(TCM.HardwareModel.from_calibration(tart)) \
            == dataclasses.asdict(JCM.HardwareModel.from_calibration(jart)) \
            | {"hbm_capacity_bytes": TCM.H100.hbm_capacity_bytes}

    def test_default_is_the_h100(self):
        art = TCAL.simulated_calibration(seed=17)
        assert art["level_order"] == ["local", "cross"]
        hw = TCM.HardwareModel.from_calibration(art)
        assert hw.ici_bytes_per_s == pytest.approx(
            TCM.H100.ici_bytes_per_s, rel=0.01)
        assert hw.dcn_bytes_per_s == pytest.approx(
            TCM.H100.dcn_bytes_per_s, rel=0.01)
        assert art == TCAL.simulated_calibration(seed=17)

    def test_save_load_round_trip(self, tmp_path):
        art = TCAL.simulated_calibration(seed=17)
        p = tmp_path / "CALIBRATION.json"
        TCAL.save_artifact(art, str(p))
        assert TCAL.load_artifact(str(p)) == art
        assert JCAL.load_artifact(str(p)) == art


class TestSchema:
    CASES = {
        "missing": lambda a: {k: v for k, v in a.items()
                              if k != "matmul_flops_per_s"},
        "kind": lambda a: dict(a, kind="something_else"),
        "newer": lambda a: dict(a, schema_version=99),
        "order": lambda a: dict(a, level_order=["local", "pod"]),
        "fingerprint": lambda a: dict(a, n_devices=64),
        "beta": lambda a: _zero_beta(a),
    }

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_same_errors(self, case):
        art = self.CASES[case](TCAL.simulated_calibration(seed=17))
        errs = TCAL.validate_calibration(art)
        assert errs and errs == JCAL.validate_calibration(art)


def _zero_beta(art):
    art = json.loads(json.dumps(art))
    art["levels"]["cross"]["collectives"]["reduce_scatter"][
        "beta_bytes_per_s"] = 0.0
    return art


class TestMeasured:
    @pytest.fixture(scope="class")
    def measured(self, tmp_path_factory):
        path = tmp_path_factory.mktemp("cal") / "CALIBRATION.json"
        # the best of 7 a point: the host clock of a loaded machine adds
        # delays, which the smallest of many readings leaves out
        arts = spawn_world("run_calibrate", world=4,
                           args=(str(path), CAL_SWEEP, 7), timeout=240)
        return path, arts

    def test_artifact_validates(self, measured):
        path, arts = measured
        art = json.loads(path.read_text())
        assert TCAL.validate_calibration(art) == []
        assert JCAL.validate_calibration(art) == []
        assert art["source"] == "measured" and art["platform"] == "cpu"
        assert art["level_order"] == ["local"]
        assert art["levels"]["local"]["extent"] == 4
        assert set(art["levels"]["local"]["collectives"]) == \
            set(TCAL.CALIBRATED_COLLECTIVES)
        # every rank fitted the slowest rank's times: one artifact
        assert all(a == art for a in arts)

    def test_from_calibration_reads_it(self, measured, monkeypatch):
        path, _ = measured
        art = json.loads(path.read_text())
        hw = TCM.HardwareModel.from_calibration(str(path))
        assert hw == TCM.HardwareModel(
            name="calibrated:cpu",
            peak_flops_per_s=art["matmul_flops_per_s"],
            hbm_bytes_per_s=art["hbm_bytes_per_s"],
            ici_bytes_per_s=art["levels"]["local"]["collectives"][
                "reduce_scatter"]["beta_bytes_per_s"],
            dcn_bytes_per_s=art["levels"]["local"]["collectives"][
                "reduce_scatter"]["beta_bytes_per_s"],
            hbm_capacity_bytes=None)
        assert dataclasses.asdict(hw) == dataclasses.asdict(
            JCM.HardwareModel.from_calibration(str(path)))
        monkeypatch.setenv("HOROVOD_CALIBRATION_PATH", str(path))
        assert TCM.resolve_hardware_model() == hw

    def test_world_of_one_is_refused(self):
        with pytest.raises(RuntimeError,
                           match="needs a multi-device mesh to time "
                                 "collectives"):
            spawn_world("run_calibrate", world=1, args=("",))
