"""The port's timeline (``horovod_tpu_torch/utils/timeline.py`` and the
native writer) held against the JAX package's: the events of one sequence
through every writer, the merge of per-rank files both ways, a gloo world
of 2 whose files merge into rank 0's, and the eager plane's spans against
JAX's eager timeline.

The port names a collective's span after the backend that ran it
(``NCCL_ALLREDUCE``, ``GLOO_ALLREDUCE``), where the JAX package says
``XLA_ALLREDUCE``: :func:`jax_name` maps JAX's names to the port's.
Timestamps and process ids are not compared (tolerance: none on the
rest, which is exact)."""

import json
import os
import time

import numpy as np
import pytest
import torch

from horovod_tpu.utils import timeline as JT
from horovod_tpu_torch import faults
from horovod_tpu_torch.utils import timeline as TT
from torch_port_workers import spawn_world


def jax_name(name, backend="gloo"):
    """JAX's activity name as the port names it on ``backend``."""
    if isinstance(name, str) and name.startswith("XLA_"):
        return TT.collective_activity(name[4:], backend)
    return name


def structure(events, backend="gloo"):
    """The comparable part of each event: phase, name (mapped), category,
    thread row, arguments."""
    return [(e["ph"], jax_name(e.get("name"), backend),
             jax_name(e.get("cat"), backend), e.get("tid"),
             e.get("args")) for e in events]


def _sequence(tl, names=("grad/w0", "grad/b0")):
    """One sequence of events through a writer: spans, an instant, a
    cycle mark and the collective's spans of two tensors (named as the
    writer's package names them on gloo)."""
    jax_side = type(tl).__module__.startswith("horovod_tpu.")
    for n in names:
        tl.start_activity(n, "NEGOTIATE")
    for n in names:
        tl.end_activity(n)
    tl.mark_cycle_start()
    tl.instant("NEGOTIATE")
    for n in names:
        tl.start_activity(n, "XLA_ALLREDUCE" if jax_side else
                          TT.collective_activity(TT.ALLREDUCE, "gloo"))
        tl.end_activity(n)
    tl.close()


@pytest.fixture(autouse=True)
def fresh_run_contexts(monkeypatch):
    """Both packages' run contexts unset for each test (a context another
    test set explicitly opens every Python trace with an instant)."""
    from horovod_tpu.telemetry import context as jax_context
    from horovod_tpu_torch.telemetry import context as port_context

    monkeypatch.setattr(jax_context, "_ctx", None)
    monkeypatch.setattr(port_context, "_ctx", None)


@pytest.fixture
def jax_native():
    from torch_port_workers import jax_native as private_jax_native

    JN = private_jax_native()
    if not JN.native_built():
        pytest.fail("the JAX package's native library did not build")
    return JN


class TestWriters:
    @pytest.mark.parametrize("kind", ["python", "native"])
    def test_events_match_jax(self, tmp_path, kind, jax_native):
        """One sequence of events gives the same names, phases, tensor
        rows and arguments through the port's writer as through the JAX
        package's writer of the same kind."""
        from horovod_tpu_torch import native as TN

        if kind == "python":
            mine = TT.Timeline(str(tmp_path / "t.json"), mark_cycles=True)
            ref = JT.Timeline(str(tmp_path / "j.json"), mark_cycles=True)
        else:
            mine = TN.NativeTimeline(str(tmp_path / "t.json"),
                                     mark_cycles=True)
            ref = jax_native.NativeTimeline(str(tmp_path / "j.json"),
                                            mark_cycles=True)
        _sequence(mine)
        _sequence(ref)
        got = TT.load_trace(str(tmp_path / "t.json"))
        want = JT.load_trace(str(tmp_path / "j.json"))
        assert len(got) == 10
        assert structure(got) == structure(want)
        if kind == "native":
            assert mine.dropped_events == 0

    def test_python_and_native_agree(self, tmp_path):
        """The port's two writers give one structure, arguments aside
        (the native writer records none, as the JAX package's)."""
        from horovod_tpu_torch import native as TN

        py = TT.Timeline(str(tmp_path / "p.json"), mark_cycles=True)
        nat = TN.NativeTimeline(str(tmp_path / "n.json"), mark_cycles=True)
        _sequence(py)
        _sequence(nat)
        strip = [s[:4] for s in structure(TT.load_trace(
            str(tmp_path / "p.json")))]
        assert strip == [s[:4] for s in structure(TT.load_trace(
            str(tmp_path / "n.json")))]

    @pytest.mark.filterwarnings(
        "ignore::pytest.PytestUnhandledThreadExceptionWarning")
    def test_writer_death_leaves_truncated_valid_trace(self, tmp_path):
        """The ``timeline.write`` fault kills the Python writer as it
        kills the JAX package's: the file left has no closing bracket and
        every flushed event is recovered by ``load_trace``."""
        path = tmp_path / "tl.json"
        tl = TT.Timeline(str(path), flush_interval_s=0.05, flush_events=1)
        for i in range(5):
            tl.start_activity(f"t{i}", "QUEUE")
            tl.end_activity(f"t{i}")
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and \
                len(TT.load_trace(str(path))) < 10:
            time.sleep(0.02)
        faults.set_plan(faults.FaultPlan().add("timeline.write", "raise"))
        try:
            tl.start_activity("doomed", "QUEUE")
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and tl._writer.is_alive():
                time.sleep(0.02)
        finally:
            faults.clear_plan()
        assert not tl._writer.is_alive()
        with pytest.raises(ValueError):
            json.loads(path.read_text())
        events = TT.load_trace(str(path))
        assert len(events) >= 10 and all(e["ph"] in ("B", "E")
                                         for e in events)
        # the JAX package's loader reads the same events from it
        assert JT.load_trace(str(path)) == events
        tl.close()

    @pytest.mark.parametrize("text", [
        '[\n{"ph": "B", "name": "QUEUE", "tid": "a"},\n'
        '{"ph": "E", "tid": "a"},\n{"ph": "B", "na',
        '[\n{"ph": "i", "name": "x", "tid": "runtime"}\n]\n',
        '[\n'])
    def test_load_trace_matches_jax(self, tmp_path, text):
        path = tmp_path / "tl.json"
        path.write_text(text)
        assert TT.load_trace(str(path)) == JT.load_trace(str(path))


class TestMerge:
    def _files(self, tmp_path, mod, n=3):
        blobs = []
        for p in range(n):
            tl = mod.Timeline(str(tmp_path / f"{mod.__name__}.{p}.json"))
            time.sleep(0.002)
            _sequence(tl, names=(f"t{p}",))
            blobs.append((p, tl.wall_origin_us,
                          mod.load_trace(tl.filename)))
        return blobs

    def test_port_merges_jax_files_and_jax_merges_the_ports(self, tmp_path):
        """``merge_traces`` of the port on the JAX package's files equals
        JAX's merge of them, and the reverse: identical events, rebased
        timestamps included (exact)."""
        jax_blobs = self._files(tmp_path, JT)
        port_blobs = self._files(tmp_path, TT)
        assert TT.merge_traces(jax_blobs) == JT.merge_traces(jax_blobs)
        assert JT.merge_traces(port_blobs) == TT.merge_traces(port_blobs)
        assert TT.merge_traces([]) == JT.merge_traces([]) == []

    def test_aggregate_needs_a_world(self, tmp_path):
        """Outside a world of more than one rank, as in the JAX package
        outside a multi-process job, aggregation leaves the file alone."""
        tl = TT.Timeline(str(tmp_path / "a.json"))
        _sequence(tl)
        before = (tmp_path / "a.json").read_text()
        TT.aggregate_after_close(tl.filename, tl.wall_origin_us)
        JT.aggregate_after_close(tl.filename, tl.wall_origin_us)
        assert (tmp_path / "a.json").read_text() == before


@pytest.fixture(scope="module")
def tools_world(tmp_path_factory):
    """A gloo world of 2 through ``run_tools``, with the JAX package's
    per-rank trace files for the port's aggregation."""
    d = tmp_path_factory.mktemp("tools")
    jax_traces, blobs = [], []
    for r in range(2):
        tl = JT.Timeline(str(d / f"jax.{r}.json"))
        _sequence(tl, names=(f"jax_t{r}",))
        jax_traces.append((tl.filename, tl.wall_origin_us))
        blobs.append((r, tl.wall_origin_us, JT.load_trace(tl.filename)))
    outs = spawn_world("run_tools", world=2, args=(str(d), jax_traces),
                       timeout=180)
    return outs, JT.merge_traces(blobs)


class TestWorldOfTwo:
    def test_results(self, tools_world):
        outs, _ = tools_world
        for r, o in enumerate(outs):
            np.testing.assert_array_equal(o["ar"][0], np.full(4, 1.5))
            np.testing.assert_array_equal(o["ar"][1], np.full(8, 1.5))
            np.testing.assert_array_equal(o["ag"], [[0, 0], [1, 1], [1, 1]])
            np.testing.assert_array_equal(o["bc"], np.ones(3))
            np.testing.assert_array_equal(o["stuck"], np.full(2, 1.0))
            assert o["writer"] == "NativeTimeline"
            assert o["writer.py"] == "Timeline"

    @pytest.mark.parametrize("writer", ["", ".py"], ids=["native", "python"])
    def test_rank_files_merge_into_rank_0s(self, tools_world, writer):
        """Rank 1 wrote ``<file>.1``; rank 0's file is the merged trace: a
        ``process_name`` row for each rank, and each rank's NEGOTIATE then
        gloo collective span for every tensor."""
        outs, _ = tools_world
        assert outs[1][f"own_file{writer}"] is True
        merged = [dict(e, tid=e["tid"].removesuffix(writer)) if writer and
                  isinstance(e.get("tid"), str) else e
                  for e in outs[0][f"merged{writer}"]]
        assert [e["pid"] for e in merged if e["ph"] == "M"] == [0, 1]
        kinds = {"tl.ar_a": "ALLREDUCE", "tl.ar_b": "ALLREDUCE",
                 "tl.ag": "ALLGATHER", "tl.bc": "BROADCAST",
                 "tl.a2a": "ALLTOALL"}
        for pid in (0, 1):
            for name, kind in kinds.items():
                spans = [e["name"] for e in merged if e["pid"] == pid and
                         e["ph"] == "B" and e["tid"] == name]
                assert spans == ["NEGOTIATE", f"GLOO_{kind}"], (pid, name)

    def test_port_aggregates_jax_files(self, tools_world):
        """The port's ``aggregate_after_close`` over the JAX package's
        per-rank files leaves in rank 0's file what JAX's
        ``merge_traces`` makes of them (exact)."""
        outs, want = tools_world
        assert outs[0]["jax_merged"] == want

    def test_stall_names_the_missing_rank(self, tools_world):
        """Rank 0's stall report names rank 1, which had not submitted
        the op; rank 1 warned of nothing, and nothing stays pending."""
        outs, _ = tools_world
        w0 = [w for w in outs[0]["warnings"] if "tl.stuck" in w]
        assert len(w0) == 1, outs[0]["warnings"]
        assert "Attribution: process(es) 1 have not submitted the op" \
            in w0[0]
        assert not [w for w in outs[1]["warnings"] if "tl.stuck" in w]
        assert outs[0]["pending_after"] == {} == outs[1]["pending_after"]


class _FakeMesh:
    class devices:
        size = 2


class _FakePlane:
    """JAX's data plane at a simulated world of two identical ranks."""

    def reduce_rows(self, flat, op, pre, post, segments, nproc, me):
        return flat * 2

    def allgather_padded(self, pad, nproc, me):
        import jax.numpy as jnp

        return jnp.stack([pad, pad])

    def bcast(self, tensor, root, nproc, me):
        return tensor

    def alltoall_slots(self, slots, nproc, me):
        return slots


def _jax_eager_events(tmp_path, monkeypatch, world):
    """JAX's eager timeline for the run_tools ops on rank 0: its own
    runtime on one process (``world`` 1), or its eager code at a
    simulated world of two identical ranks (``world`` 2: the process mesh,
    the host metadata exchange and the data plane stand in for the peer;
    every span and instant comes from JAX's own code)."""
    import horovod_tpu as jhvd
    import jax.numpy as jnp
    from horovod_tpu.ops import eager as JE
    from horovod_tpu.ops import op_manager as JO

    if world == 2:
        monkeypatch.setattr(JE, "process_mesh", lambda: _FakeMesh)
        monkeypatch.setattr(JE, "_allgather_host_metadata",
                            lambda a: np.stack([np.asarray(a)] * 2))
        monkeypatch.setattr(JO, "active_op", lambda *a: _FakePlane())
    path = tmp_path / f"jax{world}.json"
    jhvd.start_timeline(str(path))
    tag = f"{world}.{time.monotonic_ns()}"
    h1 = jhvd.allreduce_async(jnp.ones(4), name=f"tl.ar_a.{tag}")
    h2 = jhvd.allreduce_async(jnp.ones(8), name=f"tl.ar_b.{tag}")
    jhvd.synchronize(h1)
    jhvd.synchronize(h2)
    jhvd.allgather(jnp.ones((1, 2)), name=f"tl.ag.{tag}")
    jhvd.broadcast(jnp.ones(3), root_rank=1 if world == 2 else 0,
                   name=f"tl.bc.{tag}")
    jhvd.alltoall(jnp.arange(2.0 * world), name=f"tl.a2a.{tag}")
    jhvd.stop_timeline()
    events = JT.load_trace(str(path))
    for e in events:
        if isinstance(e.get("tid"), str):
            e["tid"] = e["tid"].replace(f".{tag}", "")
    return events


def _eager_rows(events):
    """Each tensor's spans and the runtime's instants, in order."""
    return [(e["ph"], e.get("name"), e.get("tid"),
             {k: v for k, v in (e.get("args") or {}).items()
              if k != "cycle"})
            for e in events if e["ph"] in ("B", "E", "i")]


class TestEagerSpans:
    def test_world_of_one_matches_jax(self, tmp_path, monkeypatch,
                                      hvd_runtime):
        """A world of one: the two allreduces' NEGOTIATE and collective
        spans as JAX's eager plane records them; allgather, broadcast and
        alltoall return before any span in both packages."""
        import horovod_tpu_torch as hvd

        want = _jax_eager_events(tmp_path, monkeypatch, world=1)
        hvd.init(device="cpu")
        try:
            path = tmp_path / "port1.json"
            hvd.start_timeline(str(path))
            h1 = hvd.allreduce_async(torch.ones(4), name="tl.ar_a")
            h2 = hvd.allreduce_async(torch.ones(8), name="tl.ar_b")
            hvd.synchronize(h1)
            hvd.synchronize(h2)
            hvd.allgather(torch.ones(1, 2), name="tl.ag")
            hvd.broadcast(torch.ones(3), root_rank=0, name="tl.bc")
            hvd.alltoall(torch.arange(2.0), name="tl.a2a")
            hvd.stop_timeline()
        finally:
            hvd.shutdown()
        got = TT.load_trace(str(path))
        assert _eager_rows(got) == [
            (ph, jax_name(name), tid, args)
            for ph, name, tid, args in _eager_rows(want)]
        assert any(e.get("name") == "GLOO_ALLREDUCE" for e in got)

    def test_world_of_two_matches_jax(self, tmp_path, monkeypatch,
                                      hvd_runtime, tools_world):
        """Rank 0's spans and NEGOTIATE instants of the gloo world of 2
        (allreduce, allgather, broadcast, alltoall) against JAX's eager
        code at a world of two: the same rows in the same order, the
        instants' kind, cache outcome and join count included."""
        outs, _ = tools_world
        want = _eager_rows(_jax_eager_events(tmp_path, monkeypatch, 2))
        rows = [dict(e, tid=e.get("tid", "").removesuffix(".py"))
                for e in outs[0]["merged.py"] if e.get("pid") == 0]
        got = _eager_rows(rows)
        # the native pass: the same rows, its instants without arguments
        assert [row[:3] for row in got] == \
            [row[:3] for row in _eager_rows(
                e for e in outs[0]["merged"] if e.get("pid") == 0)]
        assert got == [(ph, jax_name(name), tid, args)
                       for ph, name, tid, args in want]


class TestProfilerRanges:
    def test_spans_show_in_the_profiler(self, tmp_path):
        """Under ``torch.profiler`` each timeline span is a
        ``record_function`` range ``hvd:ACTIVITY:tensor``; with no
        profiler running none is opened."""
        from torch.profiler import ProfilerActivity, profile

        import horovod_tpu_torch as hvd

        hvd.init(device="cpu")
        try:
            hvd.start_timeline(str(tmp_path / "p.json"))
            tl = hvd._state.global_state().timeline
            hvd.allreduce(torch.ones(4), name="prof_t")
            assert tl._ranges._open == {}
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                hvd.allreduce(torch.ones(4), name="prof_t")
            hvd.stop_timeline()
        finally:
            hvd.shutdown()
        keys = {e.key for e in prof.key_averages()}
        assert {"hvd:NEGOTIATE:prof_t", "hvd:GLOO_ALLREDUCE:prof_t"} <= keys


def test_timeline_from_the_environment(tmp_path, monkeypatch):
    """``HOROVOD_TIMELINE`` at ``init()`` records the eager ops and
    ``shutdown()`` closes the file; ``HOROVOD_TIMELINE_PYTHON`` picks the
    Python writer, as in the JAX package."""
    import horovod_tpu_torch as hvd

    for python in (False, True):
        path = tmp_path / f"env{python}.json"
        monkeypatch.setenv("HOROVOD_TIMELINE", str(path))
        monkeypatch.setenv("HOROVOD_TIMELINE_MARK_CYCLES", "1")
        if python:
            monkeypatch.setenv("HOROVOD_TIMELINE_PYTHON", "1")
        hvd.init(device="cpu")
        try:
            kind = type(hvd._state.global_state().timeline).__name__
            hvd.allreduce(torch.ones(2), name="env_t")
        finally:
            hvd.shutdown()
        assert kind == ("Timeline" if python else "NativeTimeline")
        events = json.loads(path.read_text())
        assert [e.get("name") for e in events if e["ph"] == "i"] == \
            ["CYCLE_START"]
        assert [(e["ph"], e.get("name")) for e in events
                if e.get("tid") == "env_t"] == [
            ("B", "NEGOTIATE"), ("E", None), ("B", "GLOO_ALLREDUCE"),
            ("E", None)]
