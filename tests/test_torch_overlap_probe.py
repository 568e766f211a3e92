"""The port's overlap probe (``utils/overlap_probe.py``) against the JAX
package's ``horovod_tpu/utils/overlap_probe.py``.

A gloo world of 8 laid out 2 x 4 (``run_overlap_probe`` in
``tests/torch_port_workers.py``) probes the test MLP two-level, flat and
over the 2 x 2 x 2 tree, and once with telemetry on.  JAX's probe runs on
the conftest's CPU devices as a ``("dcn", "ici")`` mesh of 2 x 4
(``test_overlap_probe_reports_per_level_structure`` of
tests/test_hierarchy_smoke.py).  The structure fields are compared, not
the times: those are host times of two programs on the CPU.  JAX reads
its structure from the compiled HLO, the port from a record of the
exchange's collectives; ``serial_tail_collectives`` comes from JAX's HLO
scan and from the port's trace of the fused program, 0 on both here (a
synchronous schedule: XLA's CPU collectives, gloo)."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from horovod_tpu.runtime.topology import GLOBAL_AXES
from horovod_tpu.utils import overlap_probe as JP
from horovod_tpu_torch.utils import overlap_probe as TP
from horovod_tpu_torch.utils import scaling as TS

from torch_port_workers import mlp_batch, mlp_params, spawn_world

WORLD_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def probed():
    return spawn_world("run_overlap_probe", world=8, layout=(2, 4),
                       timeout=WORLD_TIMEOUT_S)


def _jax_loss(params, batch):
    h = jnp.tanh(batch["x"] @ params["w1"] + params["b1"])
    return jnp.mean((h @ params["w2"] + params["b2"] - batch["y"]) ** 2)


@pytest.fixture(scope="module")
def jax_probe():
    """JAX's measure_overlap on the 2 x 4 mesh, auto and flat."""
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), GLOBAL_AXES)
    params = jax.device_put({k: jnp.asarray(v)
                             for k, v in mlp_params().items()},
                            NamedSharding(mesh, P()))
    x, y = mlp_batch(64)
    batch = jax.device_put({"x": jnp.asarray(x), "y": jnp.asarray(y)},
                           NamedSharding(mesh, P(GLOBAL_AXES)))
    return {h: JP.measure_overlap(_jax_loss, params, batch, mesh=mesh,
                                  hierarchy=h, iters=1, warmup=0)
            for h in ("auto", "flat")}


class TestStructure:
    def test_two_level_reports_per_level_structure(self, probed, jax_probe):
        """JAX's test_overlap_probe_reports_per_level_structure: auto on
        the 2 x 4 world resolves two_level, reduce-scatters over both
        scopes, no gradient-sized all-reduce, both levels timed; JAX's
        structure fields on every rank."""
        want = jax_probe["auto"]
        for rep in probed:
            rep = rep["auto"]
            assert rep["hierarchy"] == want.hierarchy == "two_level"
            assert rep["rs_scopes"] == want.rs_scopes == (2, 4)
            assert rep["ag_scopes"] == want.ag_scopes
            assert rep["grad_sized_allreduces"] == \
                want.grad_sized_allreduces == 0
            assert rep["exchange_intra_s"] is not None
            assert rep["exchange_cross_s"] is not None
            fields = rep["fields"]
            assert fields["exchange_hierarchy"] == "two_level"
            assert fields["exchange_rs_scopes"] == [2, 4]
            assert "overlap_exchange_intra_s" in fields

    def test_flat_has_one_world_scope(self, probed, jax_probe):
        want = jax_probe["flat"]
        for rep in probed:
            rep = rep["flat"]
            assert rep["hierarchy"] == want.hierarchy == "flat"
            assert rep["rs_scopes"] == want.rs_scopes == (8,)
            # XLA compiles JAX's flat all-gather on the CPU as one over
            # each mesh axis, (2, 4); the port gathers over the world
            assert rep["ag_scopes"] == (8,)
            assert rep["exchange_intra_s"] is None
            assert rep["wire_bytes_dcn"] == 0

    @pytest.mark.parametrize("hierarchy", ["auto", "flat"])
    def test_wire_bytes_are_jaxs(self, probed, jax_probe, hierarchy):
        """The bytes of the recorded collectives are those JAX counts in
        its compiled exchange: by level for the two-level exchange; in all
        for the flat one, whose all-gather XLA splits over the two mesh
        axes (so JAX books part of it on dcn) where the port gathers over
        the world at once."""
        want = jax_probe[hierarchy]
        for rep in probed:
            rep = rep[hierarchy]
            got = (rep["wire_bytes_ici"], rep["wire_bytes_dcn"])
            if hierarchy == "flat":
                assert sum(got) == \
                    want.wire_bytes_ici + want.wire_bytes_dcn
            else:
                assert got == (want.wire_bytes_ici, want.wire_bytes_dcn)

    def test_tree_scopes(self, probed):
        """The 2 x 2 x 2 tree over a TreeLayout: three reduce-scatter
        levels of 2 ranks (one distinct scope), the innermost timed alone,
        bytes on the outer levels."""
        for rep in probed:
            rep = rep["tree"]
            assert rep["hierarchy"] == "tree"
            assert rep["rs_scopes"] == rep["ag_scopes"] == (2,)
            assert rep["grad_sized_allreduces"] == 0
            assert rep["exchange_intra_s"] is not None
            assert rep["wire_bytes_ici"] > 0 and rep["wire_bytes_dcn"] > 0

    @pytest.mark.parametrize("hierarchy", ["auto", "flat"])
    def test_bench_fields_are_jaxs(self, probed, jax_probe, hierarchy):
        """as_bench_fields: JAX's keys for the same hierarchy; the same
        string and list values, and the same serial tail (0)."""
        want = jax_probe[hierarchy].as_bench_fields()
        for rep in probed:
            got = rep[hierarchy]["fields"]
            assert set(got) == set(want)
            for k in ("exchange_hierarchy", "fused_collectives",
                      "exchange_rs_scopes",
                      "exchange_grad_sized_allreduces",
                      "exchange_serial_tail_collectives"):
                assert got[k] == want[k], k

    def test_fraction_in_range_and_tail(self, probed):
        for rep in probed:
            for case in ("auto", "flat", "tree", "gauged"):
                r = rep[case]
                assert 0.0 <= r["overlap_fraction"] <= 1.0
                assert r["tail_exchange_s"] == max(
                    0.0, r["fused_s"] - r["backward_s"])
                assert r["device"] == "cpu" and r["world"] == 8

    def test_scaling_reads_the_fields_back(self, probed):
        """utils/scaling reads the probe's fraction and topology out of an
        artifact that carries its fields, with a prefix too."""
        fields = probed[0]["auto"]["fields"]
        assert TS.overlap_fraction_from_artifact(fields) == \
            fields["overlap_fraction"]
        assert TS.hierarchy_from_artifact(fields) == "two_level"
        prefixed = {"lm_" + k: v for k, v in fields.items()}
        assert TS.overlap_fraction_from_artifact(prefixed, "lm_") == \
            fields["overlap_fraction"]
        assert TS.resolve_overlap_fraction(artifact=fields) == \
            fields["overlap_fraction"]

    def test_gauges_carry_the_report(self, probed):
        """With telemetry on, the gauges hold the report's numbers under
        JAX's names, the levels as the port's local and cross."""
        for rep in probed:
            r, g = rep["gauged"], rep["gauges"]

            def val(name, **labels):
                return g[(name, tuple(sorted(labels.items())))]

            assert val("hvd_exchange_time_seconds", level="total") == \
                r["exchange_s"]
            assert val("hvd_exchange_time_seconds", level="local") == \
                r["exchange_intra_s"]
            assert val("hvd_exchange_time_seconds", level="cross") == \
                r["exchange_cross_s"]
            assert val("hvd_overlap_fraction") == r["overlap_fraction"]
            assert val("hvd_tail_exchange_seconds", fused="off") == \
                r["tail_exchange_s"]
            assert val("hvd_exchange_measured_wire_bytes",
                       level="local") == r["wire_bytes_ici"]
            assert val("hvd_exchange_measured_wire_bytes",
                       level="cross") == r["wire_bytes_dcn"]


@pytest.fixture
def world_of_one():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        yield hvd
    finally:
        hvd.shutdown()


def _mlp():
    model = torch.nn.ParameterDict({
        k: torch.nn.Parameter(torch.from_numpy(v.copy()))
        for k, v in mlp_params().items()})
    x, y = mlp_batch(8)
    return model, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}


def _loss(m, b):
    h = torch.tanh(b["x"] @ m["w1"] + m["b1"])
    return torch.mean((h @ m["w2"] + m["b2"] - b["y"]) ** 2)


class TestWorldOfOne:
    def test_report(self, world_of_one):
        """At a world of one: flat, one scope of one rank, no bytes on any
        wire, the payload the gradients' bytes."""
        model, batch = _mlp()
        rep = TP.measure_overlap(_loss, model, batch, iters=2, warmup=1)
        assert (rep.hierarchy, rep.rs_scopes, rep.ag_scopes) == \
            ("flat", (1,), (1,))
        assert (rep.wire_bytes_ici, rep.wire_bytes_dcn) == (0, 0)
        assert rep.payload_bytes == sum(
            p.numel() * p.element_size() for p in model.parameters())
        assert rep.world == 1 and rep.device == "cpu"
        assert rep.serial_tail_collectives == 0

    @pytest.mark.parametrize("times,want", [
        ((0.0, 1.0, 1.0, 0.5), 1.0), ((0.0, 1.0, 1.0, 3.0), 0.0),
        ((0.0, 2.0, 1.0, 2.5), 0.5), ((0.0, 0.0, 1.0, 1.0), 0.0),
        ((0.5, 1.5, 1.5, 2.5), 0.0), ((0.25, 1.25, 1.25, 1.25), 1.0)])
    def test_fraction_is_clamped(self, world_of_one, monkeypatch, times,
                                 want):
        """(backward + exchange - fused) / min(backward, exchange),
        clamped to [0, 1], 0 when a phase took no time, each median
        (fingerprint, backward, exchange, fused, in the probe's order)
        taken without the fingerprint's; the tail is what the fused
        program costs past backward."""
        seq = iter(times)
        monkeypatch.setattr(TP, "_median_time",
                            lambda fn, iters, warmup: next(seq))
        model, batch = _mlp()
        rep = TP.measure_overlap(_loss, model, batch)
        fp, bwd, exc, fsd = times
        assert rep.overlap_fraction == want
        assert (rep.fingerprint_s, rep.backward_s, rep.exchange_s,
                rep.fused_s) == (fp, bwd - fp, exc - fp, fsd - fp)
        assert rep.tail_exchange_s == max(0.0, fsd - bwd)

    def test_serial_fused_program_reads_zero(self, world_of_one,
                                             monkeypatch):
        """Programs that sleep on a clock of their own: backward, then
        the exchange, each program ending in the same fingerprint pass.
        The fused one runs the two in turn, so nothing hides and the
        fraction is 0, though the two apart pay for the fingerprint twice
        and the fused one once."""
        now = [0.0]

        def sleep(*seconds):
            now[0] += sum(seconds)
            return torch.zeros(())

        bwd, exc, fp = 1.0, 0.5, 0.25
        model, batch = _mlp()
        real = TP.overlap_programs(_loss, model, batch)
        fake = dataclasses.replace(
            real, backward_only=lambda: sleep(bwd, fp),
            exchange_only=lambda: sleep(exc, fp),
            fused=lambda: sleep(bwd, exc, fp),
            fingerprint_only=lambda: sleep(fp))
        monkeypatch.setattr(TP, "overlap_programs",
                            lambda *args, **kwargs: fake)
        monkeypatch.setattr(TP, "time",
                            types.SimpleNamespace(perf_counter=lambda: now[0]))
        rep = TP.measure_overlap(_loss, model, batch, iters=3, warmup=1)
        assert rep.overlap_fraction == 0.0
        assert (rep.backward_s, rep.exchange_s, rep.fused_s,
                rep.fingerprint_s) == (bwd, exc, bwd + exc, fp)
        assert rep.tail_exchange_s == exc

    def test_fused_equals_backward_then_exchange(self, world_of_one):
        """The fused program's fingerprint is that of backward followed by
        the exchange run on its own, bit for bit."""
        model, batch = _mlp()
        pr = TP.overlap_programs(_loss, model, batch)
        from horovod_tpu_torch.ops import collectives as C

        grads = torch.autograd.grad(_loss(model, batch),
                                    list(model.parameters()))
        shards, spec = C.grouped_reducescatter(list(grads), op=C.Average)
        eager = TP.fingerprint(C.grouped_allgather(shards, spec))
        assert float(pr.fused()) == float(eager)
        assert float(pr.exchange_only()) == float(eager)

    def test_refusals(self, world_of_one):
        model, batch = _mlp()
        with pytest.raises(ValueError, match="fused_collectives"):
            TP.measure_overlap(_loss, model, batch,
                               fused_collectives="sometimes")
        meta = torch.nn.Linear(2, 2, device="meta")
        with pytest.raises(ValueError, match="runs where hvd.init"):
            TP.measure_overlap(lambda m, b: m(b).sum(), meta,
                               torch.ones(1, 2, device="meta"))

    def test_report_fields_mirror_jax(self):
        """The report has JAX's fields, and ``device`` and
        ``fingerprint_s`` beside them."""
        names = {f.name for f in dataclasses.fields(TP.OverlapReport)}
        assert names == {f.name for f in dataclasses.fields(
            JP.OverlapReport)} | {"device", "fingerprint_s"}
