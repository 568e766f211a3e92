"""The port's metric exporters (``horovod_tpu_torch/telemetry/export.py``
and ``start_from_config``) held against the JAX package's: the Prometheus
text and the JSONL snapshot line for the same registry (exact, the
snapshot's wall-clock stamp aside), the endpoint, the runtime's exporters
from the ``HOROVOD_METRICS*`` knobs, the checkpoint writer's metrics, and
the four fault sites this slice adds, each firing as the JAX package's
does."""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from horovod_tpu import faults as jax_faults
from horovod_tpu.analysis import metrics_schema
from horovod_tpu.telemetry import export as JX
from horovod_tpu.telemetry.registry import MetricsRegistry as JRegistry
from horovod_tpu_torch import faults, telemetry
from horovod_tpu_torch.telemetry import export as TX
from horovod_tpu_torch.telemetry.registry import MetricsRegistry


@pytest.fixture(autouse=True)
def fresh_run_contexts(monkeypatch):
    """Both packages' run contexts made anew for each test, with one run
    id and generation (the snapshot line carries them)."""
    from horovod_tpu.telemetry import context as jax_context
    from horovod_tpu_torch.telemetry import context as port_context

    for mod in (jax_context, port_context):
        monkeypatch.setattr(mod, "_ctx", None)
        mod.run_context().update(run_id="run-export", generation=0)


def _fill(reg):
    """One registry's worth of series: labeled and unlabeled counters,
    gauges, a histogram with its overflow bucket, text to escape."""
    reg.counter("hvd_c_total", "help c").inc(3, site="s")
    reg.counter("hvd_c_total").inc(2, site='q"u\\o')
    reg.counter("hvd_plain_total").inc()
    reg.gauge("hvd_g", "a gauge").set(1.5)
    reg.gauge("hvd_g").set(-2.25, pipeline="p\nq")
    h = reg.histogram("hvd_h_seconds", "a histogram", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0, 0.5):
        h.observe(v)
    return reg


class TestRender:
    def test_prometheus_text_matches_jax(self):
        mine = TX.render_prometheus(_fill(MetricsRegistry(enabled=True)))
        want = JX.render_prometheus(_fill(JRegistry(enabled=True)))
        assert mine == want
        assert 'hvd_h_seconds_bucket{le="+Inf"} 4' in mine

    def test_worker_store_lines_match_jax(self):
        stores = [TX.WorkerMetricsStore(), JX.WorkerMetricsStore()]
        for s in stores:
            s.update("h:0", {"hvd_a_total": 1.0,
                             'hvd_b_total{site="x"}': 2.5})
            s.update("h:1", {"hvd_a_total": 2.0})
        assert stores[0].render_lines() == stores[1].render_lines()
        assert stores[0].merged() == stores[1].merged()
        mine = TX.render_prometheus(MetricsRegistry(enabled=True),
                                    stores[0])
        assert mine == JX.render_prometheus(JRegistry(enabled=True),
                                            stores[1])

    def test_snapshot_line_matches_jax(self):
        mine = TX.snapshot_line(_fill(MetricsRegistry(enabled=True)))
        want = JX.snapshot_line(_fill(JRegistry(enabled=True)))
        assert abs(mine.pop("ts_unix") - want.pop("ts_unix")) < 5
        assert mine == want
        assert mine["schema_version"] == JX.SCHEMA_VERSION


class TestExporters:
    def test_endpoint_serves_the_registry(self):
        reg = _fill(MetricsRegistry(enabled=True))
        store = TX.WorkerMetricsStore()
        store.update("hostA:0", {"hvd_worker_total": 7.0})
        exporter = TX.PrometheusExporter(reg, port=0, host="127.0.0.1",
                                         store=store)
        exporter.start()
        try:
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{exporter.port}/metrics",
                timeout=5).read().decode()
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(
                    f"http://127.0.0.1:{exporter.port}/nope", timeout=5)
        finally:
            exporter.stop()
        assert body == TX.render_prometheus(reg, store)
        assert 'hvd_worker_total{worker="hostA:0"} 7' in body

    def test_snapshot_writer_validates_with_jax_schema(self, tmp_path):
        """The periodic writer and its final record: lines the JAX
        package's schema validator accepts."""
        reg = _fill(MetricsRegistry(enabled=True))
        path = tmp_path / "m.jsonl"
        w = TX.MetricsSnapshotWriter(reg, str(path), interval_s=0.05)
        w.start()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not path.exists():
            time.sleep(0.02)
        w.stop()
        assert len(path.read_text().splitlines()) >= 2
        assert metrics_schema.validate_jsonl_path(str(path)) == []

    def test_start_from_config(self, tmp_path, monkeypatch):
        """``HOROVOD_METRICS_LOG``/``HOROVOD_METRICS_PORT`` at ``init()``
        turn collection on and start both exporters; ``shutdown()`` writes
        the final snapshot and closes the endpoint.  ``HOROVOD_METRICS=0``
        keeps both off, as in the JAX package."""
        import horovod_tpu_torch as hvd

        log = tmp_path / "run.jsonl"
        monkeypatch.setenv("HOROVOD_METRICS_LOG", str(log))
        monkeypatch.setenv("HOROVOD_METRICS_PORT", "0")
        monkeypatch.setenv("HOROVOD_RUN_ID", "run-tools")
        was = telemetry.enabled()
        hvd.init(device="cpu")
        try:
            rt = hvd._state.global_state().telemetry
            assert telemetry.enabled() and rt.writer is not None
            assert rt.exporter is None
        finally:
            hvd.shutdown()
            if not was:
                telemetry.disable()
        line = json.loads(log.read_text().splitlines()[-1])
        assert line["run_id"] == "run-tools"
        monkeypatch.setenv("HOROVOD_METRICS", "0")
        from horovod_tpu.runtime.config import Config as JConfig
        from horovod_tpu.telemetry import start_from_config as jstart

        from horovod_tpu_torch.runtime.config import Config

        assert telemetry.start_from_config(Config.from_env()) is None
        assert jstart(JConfig.from_env()) is None


class TestCheckpointMetrics:
    @pytest.fixture
    def metrics(self):
        was = telemetry.enabled()
        reg = telemetry.enable()
        yield reg
        if not was:
            telemetry.disable()

    def test_save_counts_and_times(self, tmp_path, metrics):
        """A rank-0 save: ``hvd_checkpoint_saves_total`` rises by one, the
        stall histogram gains ``last_stall_s`` and the write histogram
        ``last_write_s``."""
        from horovod_tpu_torch.checkpoint import Checkpointer

        saves = metrics.value("hvd_checkpoint_saves_total")
        snap = metrics.snapshot()["histograms"]
        stall0 = snap.get("hvd_checkpoint_stall_seconds", {"sum": 0.0,
                                                           "count": 0})
        ck = Checkpointer(str(tmp_path / "ck"))
        ck.save(1, {"w": torch.arange(10.0)})
        ck.wait()
        assert metrics.value("hvd_checkpoint_saves_total") == saves + 1
        h = metrics.snapshot()["histograms"]
        stall = h["hvd_checkpoint_stall_seconds"]
        assert stall["count"] == stall0["count"] + 1
        assert stall["sum"] - stall0["sum"] == pytest.approx(
            ck.last_stall_s, abs=1e-12)
        assert h["hvd_checkpoint_write_seconds"]["count"] >= 1

    def test_write_fault_matches_jax(self, tmp_path, metrics):
        """The ``checkpoint.write`` fault fails the writer: the error is
        sticky until ``clear_error``, counted once, and the next save
        writes; the JAX package's checkpointer does the same."""
        from horovod_tpu.checkpoint import Checkpointer as JCheckpointer
        from horovod_tpu.telemetry import default_registry as jreg
        from horovod_tpu_torch.checkpoint import Checkpointer

        jax_was = jreg().enabled
        jreg().enable()
        try:
            seen = []
            for plan, ck, reg, arr in (
                    (faults, Checkpointer(str(tmp_path / "t")), metrics,
                     torch.ones(3)),
                    (jax_faults, JCheckpointer(str(tmp_path / "j"),
                                               use_orbax=False), jreg(),
                     np.ones(3, np.float32))):
                errs = reg.value("hvd_checkpoint_writer_errors_total")
                plan.set_plan(plan.FaultPlan().add(
                    "checkpoint.write", "raise", arg="OSError", at=1))
                try:
                    ck.save(1, {"w": arr})
                    raised = []
                    for _ in range(2):      # sticky
                        try:
                            ck.wait()
                        except OSError:
                            raised.append(True)
                    cleared = type(ck.clear_error()).__name__
                    ck.save(2, {"w": arr})
                    ck.wait()
                finally:
                    plan.clear_plan()
                seen.append((raised, cleared, reg.value(
                    "hvd_checkpoint_writer_errors_total") - errs,
                    ck.all_steps()))
            assert seen[0] == seen[1] == ([True, True], "OSError", 1, [2])
        finally:
            if not jax_was:
                jreg().disable()


class TestFaultSites:
    def test_sites_are_listed(self):
        """The port's fault package lists the four sites of this slice."""
        for site in ("timeline.write", "stall.watch", "telemetry.export",
                     "checkpoint.write"):
            assert f"``{site}``" in faults.__doc__

    def test_export_fault_drops_the_sample_as_jax(self, tmp_path):
        """``telemetry.export`` raising: the sample is dropped, the error
        counted, nothing raised; the next pass writes, in both packages."""
        outs = []
        for mod, plan, reg in ((TX, faults, MetricsRegistry(enabled=True)),
                               (JX, jax_faults, JRegistry(enabled=True))):
            path = tmp_path / f"{mod.__name__}.jsonl"
            w = mod.MetricsSnapshotWriter(reg, str(path), interval_s=60)
            plan.set_plan(plan.FaultPlan().add("telemetry.export", "raise",
                                               arg="OSError"))
            try:
                first = w.write_now()
            finally:
                plan.clear_plan()
            outs.append((first, path.exists(),
                         reg.value("hvd_telemetry_export_errors_total"),
                         w.write_now() is not None))
        assert outs[0] == outs[1] == (None, False, 1, True)
