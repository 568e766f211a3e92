"""The port's autotuners held against the JAX package's: the Bayesian
optimizer (to 1e-12), the online ``ParameterManager`` under one fake clock
(the same points in the same order, the same pick, the same log), the
knobs it must leave alone, and the offline ``ThroughputAutotuner`` (the
same path and the same log for one ``measure``).  Then the manager inside
the eager plane of a world of one."""

import csv
import dataclasses

import numpy as np
import pytest
import torch

from horovod_tpu.runtime import config as JCfg
from horovod_tpu.utils import autotune as JA
from horovod_tpu.utils import bayesian as JB
from horovod_tpu.utils import bench_autotune as JBA
from horovod_tpu_torch.runtime import config as TCfg
from horovod_tpu_torch.utils import autotune as TA
from horovod_tpu_torch.utils import bayesian as TB
from horovod_tpu_torch.utils import bench_autotune as TBA

TOL = 1e-12


class TestBayesian:
    @pytest.mark.parametrize("seed", [0, 1, 7])
    def test_gaussian_process_and_ei(self, seed):
        rng = np.random.RandomState(seed)
        x, y = rng.rand(9, 2), rng.randn(9)
        q = rng.rand(16, 2)
        outs = []
        for mod in (TB, JB):
            gp = mod.GaussianProcess(length_scale=0.4, sigma_n=0.1)
            gp.fit(x, y)
            mean, std = gp.predict(q)
            outs.append((mean, std, mod.expected_improvement(
                mean, std, float(y.max()))))
        for a, b in zip(*outs):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)

    @pytest.mark.parametrize("noise", [1e-4, 0.8])
    def test_optimizer_suggests_jax_points(self, noise):
        """Ten suggest/observe rounds on one objective: the same points
        (1e-12) and the same best."""
        def f(p):
            return -float((p[0] - 24.0) ** 2 + 0.1 * (p[1] - 7.0) ** 2)

        bounds = [(20.0, 28.0), (1.0, 20.0)]
        mine = TB.BayesianOptimizer(bounds, seed=3, noise=noise)
        ref = JB.BayesianOptimizer(bounds, seed=3, noise=noise)
        for _ in range(10):
            a, b = mine.suggest(), ref.suggest()
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
            mine.observe(a, f(a))
            ref.observe(b, f(b))
        np.testing.assert_allclose(mine.best[0], ref.best[0], rtol=TOL)
        assert mine.best[1] == ref.best[1]


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _bytes_for(point):
    """A deterministic objective: bytes a flush moves at ``point``, best
    near 32 MiB and 5 ms."""
    thr, cyc = point
    return int(1e6 * (8.0 - abs(np.log2(max(thr, 1 << 20)) - 25.0)
                      - 0.2 * abs(cyc - 5.0)))


def _drive(mod, cfg, clock, monkeypatch, log_path):
    """Run a manager to its end: every step moves ``_bytes_for`` of the
    current point in 1 s of the fake clock."""
    monkeypatch.setattr(mod.time, "monotonic", clock)
    pm = mod.ParameterManager(cfg, log_path=str(log_path))
    visited = []
    for _ in range(1000):
        if not pm.active:
            break
        point = (cfg.fusion_threshold_bytes, cfg.cycle_time_ms)
        if not visited or visited[-1] != point:
            visited.append(point)
        clock.t += 1.0
        pm.record_bytes(_bytes_for(point))
    assert not pm.active
    return visited, (cfg.fusion_threshold_bytes, cfg.cycle_time_ms)


@pytest.fixture
def one_process(monkeypatch):
    """Both packages' cross-process score at a world of one: the port's
    runtime on the CPU, the JAX package's process mesh of one."""
    import horovod_tpu_torch as hvd
    from horovod_tpu.ops import eager as JE

    class Mesh:
        class devices:
            size = 1

    monkeypatch.setattr(JE, "process_mesh", lambda: Mesh)
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _config(mod, **kw):
    cfg = mod.Config(autotune=True, autotune_steps_per_sample=3,
                     autotune_bayes_opt_max_samples=4)
    return dataclasses.replace(cfg, **kw)


class TestParameterManager:
    @pytest.mark.parametrize("noise", [0.8, 0.05])
    def test_visits_jax_points(self, one_process, monkeypatch, tmp_path,
                               noise):
        """Under one fake clock both managers walk the warm-up grid and
        the Bayesian points in the same order, pick the same point, and
        write the same CSV log."""
        got = _drive(TA, _config(TCfg, autotune_gaussian_process_noise=noise),
                     _Clock(), monkeypatch, tmp_path / "t.csv")
        want = _drive(JA, _config(JCfg, autotune_gaussian_process_noise=noise),
                      _Clock(), monkeypatch, tmp_path / "j.csv")
        assert got == want
        assert len(got[0]) == len(JA._WARMUP_GRID) + 4
        assert (tmp_path / "t.csv").read_text() == \
            (tmp_path / "j.csv").read_text()

    @pytest.mark.parametrize("fixed", [
        {"fusion_threshold_bytes"}, {"cycle_time_ms"},
        {"fusion_threshold_bytes", "cycle_time_ms"}])
    def test_fixed_knobs_are_left_alone(self, one_process, monkeypatch,
                                        tmp_path, fixed):
        """A knob the user set is never moved; with both set the manager
        is done at once, as JAX's."""
        for mod, cmod in ((TA, TCfg), (JA, JCfg)):
            cfg = _config(cmod, fusion_threshold_bytes=12345,
                          cycle_time_ms=3.25, fixed_knobs=frozenset(fixed))
            if fixed == {"fusion_threshold_bytes", "cycle_time_ms"}:
                assert not mod.ParameterManager(cfg).active
                continue
            visited, _ = _drive(mod, cfg, _Clock(), monkeypatch,
                                tmp_path / f"{mod.__name__}.csv")
            if "fusion_threshold_bytes" in fixed:
                assert {p[0] for p in visited} == {12345}
            else:
                assert {p[1] for p in visited} == {3.25}

    def test_fixed_knobs_from_the_environment(self, monkeypatch):
        """``HOROVOD_FUSION_THRESHOLD``/``HOROVOD_CYCLE_TIME`` fix their
        knobs in both packages' ``Config.from_env``."""
        for name in ("HOROVOD_FUSION_THRESHOLD", "HOROVOD_CYCLE_TIME"):
            monkeypatch.delenv(name, raising=False)
        assert TCfg.Config.from_env().fixed_knobs == frozenset()
        monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "1024")
        monkeypatch.setenv("HOROVOD_CYCLE_TIME", "2")
        assert TCfg.Config.from_env().fixed_knobs == \
            JCfg.Config.from_env().fixed_knobs & {
                "fusion_threshold_bytes", "cycle_time_ms"} == \
            {"fusion_threshold_bytes", "cycle_time_ms"}


class TestThroughputAutotuner:
    AXES = {"exchange_bucket_bytes": [1 << 20, 1 << 24, 1 << 26, None],
            "block": [128, 256, 512]}

    @staticmethod
    def _measure(point):
        b = point["exchange_bucket_bytes"] or (1 << 28)
        return 1000.0 - abs(np.log2(b) - 24) * 10 - abs(point["block"] - 256)

    @pytest.mark.parametrize("kw", [
        {}, {"seed": {"exchange_bucket_bytes": None, "block": 128}},
        {"max_rounds": 1},
        {"predict": lambda p: -p["block"], "prune_to": 2},
        {"feasible": lambda p: p["block"] != 512}])
    def test_path_and_log_match_jax(self, tmp_path, kw):
        """The same points measured in the same order, the same winner and
        the same CSV log (its one timing column aside)."""
        paths, results, logs = [], [], []
        for mod in (TBA, JBA):
            seen = []

            def measure(point):
                seen.append(dict(point))
                return self._measure(point)

            log = tmp_path / f"{mod.__name__}.csv"
            tuner = mod.ThroughputAutotuner(measure, self.AXES,
                                            log_path=str(log), **kw)
            results.append(tuner.run())
            paths.append(seen)
            with open(log) as f:
                logs.append([{k: v for k, v in row.items()
                              if k != "measure_seconds"}
                             for row in csv.DictReader(f)])
        assert paths[0] == paths[1] and results[0] == results[1]
        assert logs[0] == logs[1]

    def test_no_feasible_point_raises(self):
        for mod in (TBA, JBA):
            with pytest.raises(RuntimeError, match="no feasible point"):
                mod.ThroughputAutotuner(
                    self._measure, {"exchange_bucket_bytes": [1 << 20],
                                    "block": [128, 256]},
                    feasible=lambda p: False).run()


def test_autotune_in_the_eager_plane(monkeypatch, tmp_path):
    """``HOROVOD_AUTOTUNE=1`` at ``init()``: the Bucketer's dispatches feed
    the manager, which moves the fusion threshold and the cycle time
    through its points and writes its log; every result stays exact."""
    import horovod_tpu_torch as hvd

    log = tmp_path / "at.csv"
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_LOG", str(log))
    monkeypatch.setenv("HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", "2")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", "2")
    for name in ("HOROVOD_FUSION_THRESHOLD", "HOROVOD_CYCLE_TIME"):
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cpu")
    try:
        st = hvd._state.global_state()
        pm = st.parameter_manager
        seen = set()
        xs = [torch.arange(1000, dtype=torch.float32) * (i + 1)
              for i in range(4)]
        for step in range(40):
            if not pm.active:
                break
            seen.add((st.config.fusion_threshold_bytes,
                      st.config.cycle_time_ms))
            hs = [hvd.allreduce_async(x, name=f"g{i}")
                  for i, x in enumerate(xs)]
            for x, h in zip(xs, hs):
                assert torch.equal(hvd.synchronize(h), x)
        assert not pm.active
    finally:
        hvd.shutdown()
    assert len(seen) == len(TA._WARMUP_GRID) + 2
    rows = list(csv.DictReader(open(log)))
    assert len(rows) == len(TA._WARMUP_GRID) + 2
    assert set(rows[0]) == {"fusion_threshold", "cycle_time_ms",
                            "bytes_per_sec"}
