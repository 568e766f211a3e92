"""The port's input plane (``horovod_tpu_torch/data``,
``optim/train_step.shard_local_batch``, ``utils/input_probe``) and the
identity of a world that the caller made, held against the JAX package.

* ``ShardedDataset``'s per-step indices are the JAX package's bit for bit
  (worlds 1, 2 and 4, shuffled and not, across epochs, a reshard 2 → 4
  from a committed ``state_dict`` and ``load_position``'s seed check);
* ``ArraySource`` takes the same rows from the same tree, ~1/world of
  them a rank; ``ParquetSource`` reads only its row groups (pyarrow);
* ``PrefetchIterator`` keeps the JAX iterator's contract
  (tests/test_data_pipeline.py's cases and tests/test_chaos.py's
  ``data.feed`` fault), on the CPU, where ``place`` runs as given;
* the knobs resolve as ``horovod_tpu/data/prefetch.py`` resolves them, in
  a fresh process;
* gloo worlds of 2 and 4 made before ``hvd.init()`` without
  ``HOROVOD_*``, with and without torchrun's ``LOCAL_*``: distinct local
  ranks, local × cross = size, the identity queries and probes, and the
  input plane under that identity (``shard_local_batch`` equals
  ``shard_batch`` of the concatenated rows).

Everything compares exactly: indices, rows and batches are integers or
copied floats."""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from horovod_tpu import faults as jfaults
from horovod_tpu.data import ArraySource as JArraySource
from horovod_tpu.data import ShardedDataset as JShardedDataset
from horovod_tpu_torch import faults, telemetry
from horovod_tpu_torch.data import (
    ArraySource,
    ParquetSource,
    PrefetchIterator,
    ShardedDataset,
    broadcast_seed,
    close_all_pipelines,
)
from horovod_tpu_torch.faults import FaultPlan
from horovod_tpu_torch.utils.input_probe import (
    H2dReport,
    fence_batch,
    measure_h2d_overlap,
)

from torch_port_workers import (
    DATA_BATCH,
    IDENTITY_QUERIES,
    PROBES,
    data_columns,
    spawn_world,
)

ROOT = Path(__file__).resolve().parents[1]


def _columns(n):
    return {"x": np.arange(n, dtype=np.int64),
            "y": np.arange(n, dtype=np.int64) * 10}


def _pair(n, batch, world, rank=0, seed=7, shuffle=True):
    """The port's dataset and the JAX package's, over the same columns."""
    kw = dict(batch_size=batch, rank=rank, world=world, seed=seed,
              shuffle=shuffle)
    return (ShardedDataset(ArraySource(_columns(n)), **kw),
            JShardedDataset(JArraySource(_columns(n)), **kw))


def _same_indices(a, b, epoch, start=0):
    got = list(a.epoch_indices(epoch, start))
    want = list(b.epoch_indices(epoch, start))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    return got


class TestIndexStream:
    @pytest.mark.parametrize("world", [1, 2, 4])
    @pytest.mark.parametrize("shuffle", [True, False])
    @pytest.mark.parametrize("n", [48, 70])
    def test_bit_exact_with_jax(self, world, shuffle, n):
        """Every rank's per-step indices over three epochs, and the
        geometry, equal the JAX package's."""
        for rank in range(world):
            port, ref = _pair(n, 4, world, rank=rank, seed=13,
                              shuffle=shuffle)
            assert (port.steps_per_epoch, port.samples_per_step) == \
                (ref.steps_per_epoch, ref.samples_per_step)
            for epoch in range(3):
                _same_indices(port, ref, epoch)

    def test_reshard_2_to_4_from_a_committed_state(self):
        """Consume part of an epoch at world 2, commit, reshard to 4 and
        finish it: the same indices as the JAX package's, no sample twice,
        none missing."""
        n, b, seed, before = 64, 2, 11, 6
        gens = [_pair(n, b, 2, rank=r, seed=seed) for r in range(2)]
        consumed = [np.concatenate(_same_indices(p, j, 0)[:before])
                    for p, j in gens]
        st, jst = gens[0][0].state_dict(0, before), \
            gens[0][1].state_dict(0, before)
        assert st == jst
        for r in range(4):
            port = gens[0][0].reshard(rank=r, world=4)
            ref = gens[0][1].reshard(rank=r, world=4)
            epoch, start = port.load_position(st)
            assert (epoch, start) == ref.load_position(jst) == \
                (0, before * 2 * b)
            consumed.append(np.concatenate(
                _same_indices(port, ref, epoch, start)))
        flat = np.concatenate(consumed)
        assert sorted(flat.tolist()) == list(range(n))

    def test_load_position_checks_the_seed(self):
        port, ref = _pair(32, 4, 2, seed=5)
        other, jother = _pair(32, 4, 2, seed=6)
        for ds, st in ((other, port.state_dict(1, 2)),
                       (jother, ref.state_dict(1, 2))):
            with pytest.raises(ValueError, match="seed"):
                ds.load_position(st)

    def test_iter_epochs_from_a_position(self):
        port, ref = _pair(40, 4, 2, rank=1, seed=3)
        a, b = port.iter_epochs(1, 8), ref.iter_epochs(1, 8)
        for _ in range(12):       # crosses into epochs 2 and 3
            got, want = next(a), next(b)
            for k in want:
                assert np.array_equal(got[k], np.asarray(want[k]))

    def test_validation(self):
        with pytest.raises(ValueError, match="batch_size"):
            ShardedDataset(ArraySource(_columns(4)), batch_size=0)
        with pytest.raises(ValueError, match="rank"):
            ShardedDataset(ArraySource(_columns(4)), 2, rank=2, world=2)
        with pytest.raises(ValueError, match="length"):
            ArraySource({"x": np.arange(4), "y": np.arange(5)})
        with pytest.raises(ValueError, match="leaf"):
            ArraySource({})

    def test_broadcast_seed_without_a_world(self):
        assert broadcast_seed(123) == 123
        s = broadcast_seed()
        assert isinstance(s, int) and s >= 0


class TestArraySource:
    @pytest.mark.parametrize("tree", ["dict", "tuple", "list", "array",
                                      "nested", "tensor"])
    def test_take_matches_jax(self, tree):
        rows = np.arange(20, dtype=np.float32)
        trees = {"dict": {"b": rows * 2, "a": rows[:, None] * [1, 3]},
                 "tuple": (rows, rows.astype(np.int32)),
                 "list": [rows, rows + 1],
                 "array": rows,
                 "nested": {"a": (rows, {"c": rows * 5})},
                 "tensor": {"x": rows}}
        data = trees[tree]
        idx = np.array([3, 17, 0, 9], dtype=np.int64)
        port_data = {"x": torch.from_numpy(rows)} if tree == "tensor" \
            else data
        got = ArraySource(port_data).take(idx)
        want = JArraySource(data).take(idx)

        def walk(g, w):
            if isinstance(w, dict):
                assert sorted(g) == sorted(w)
                for k in w:
                    walk(g[k], w[k])
            elif isinstance(w, (tuple, list)):
                assert type(g) is type(w) and len(g) == len(w)
                for a, b in zip(g, w):
                    walk(a, b)
            else:
                assert np.array_equal(np.asarray(g), np.asarray(w))

        walk(got, want)

    @pytest.mark.parametrize("world", [1, 2, 4])
    def test_rank_fetches_its_fraction(self, world):
        """One rank's epoch fetches 1/world of the rows, as in JAX."""
        n = 96
        for rank in range(world):
            src, jsrc = ArraySource({"x": np.arange(n)}), \
                JArraySource({"x": np.arange(n)})
            for s, cls in ((src, ShardedDataset), (jsrc, JShardedDataset)):
                ds = cls(s, batch_size=4, rank=rank, world=world, seed=1)
                for batch in ds.epoch(0):
                    assert len(batch["x"]) == 4
            assert src.rows_fetched == jsrc.rows_fetched == n // world


class TestParquetSource:
    @pytest.fixture
    def store_dir(self, tmp_path):
        pa = pytest.importorskip("pyarrow")
        pq = pytest.importorskip("pyarrow.parquet")
        table = pa.table({"x": np.arange(40, dtype=np.int64),
                          "y": np.arange(40, dtype=np.int64) * 3})
        pq.write_table(table, str(tmp_path / "part-0.parquet"),
                       row_group_size=5)
        return str(tmp_path)

    def test_shard_reads_only_its_groups(self, store_dir):
        src = ParquetSource(store_dir)
        assert len(src) == 40
        ds = ShardedDataset(src, batch_size=5, rank=0, world=2, seed=0,
                            shuffle=False)
        got = list(ds.epoch(0))
        assert len(got) == 4
        assert src.rows_fetched == 20
        assert src.reader.groups_read == [0, 2, 4, 6]
        assert np.concatenate([np.asarray(b["x"]) for b in got]).tolist() \
            == [i for k in range(4) for i in range(k * 10, k * 10 + 5)]

    def test_shuffled_shard_matches_jax(self, store_dir):
        from horovod_tpu.data import ParquetSource as JParquetSource

        src, jsrc = ParquetSource(store_dir), JParquetSource(store_dir)
        kw = dict(batch_size=5, rank=1, world=2, seed=9)
        got = list(ShardedDataset(src, **kw).epoch(0))
        want = list(JShardedDataset(jsrc, **kw).epoch(0))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert g.equals(w)
        assert src.rows_fetched == jsrc.rows_fetched <= 4 * 25

    def test_pyarrow_is_not_imported_with_the_module(self):
        code = ("import sys, horovod_tpu_torch.data, "
                "horovod_tpu_torch.spark.store\n"
                "print('pyarrow' in sys.modules)")
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "False"


def _ints(n):
    for i in range(n):
        yield np.full((2,), i, dtype=np.int64)


def _input_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("hvd-input") and t.is_alive()]


class TestPrefetchIterator:
    """tests/test_data_pipeline.py's TestPrefetchIterator, on the port."""

    def test_order_and_determinism_at_any_depth(self):
        outs = []
        for depth, threads in ((1, 1), (2, 2), (8, 4)):
            with PrefetchIterator(_ints(20), depth=depth,
                                  threads=threads) as feed:
                outs.append([int(b[0]) for b in feed])
        assert outs[0] == list(range(20))
        assert outs[0] == outs[1] == outs[2]

    @pytest.mark.parametrize("depth", [1, 8])
    def test_sharded_batches_equal_jax_at_any_depth(self, depth):
        """The same seed gives the JAX package's batches, in order,
        through the pipeline at depth 1 and 8."""
        port, ref = _pair(48, 4, 2, rank=0, seed=13)
        with PrefetchIterator(port.epoch(0), depth=depth) as feed:
            got = [b["x"] for b in feed]
        want = [np.asarray(b["x"]) for b in ref.epoch(0)]
        assert len(got) == len(want) == 6
        assert all(np.array_equal(g, w) for g, w in zip(got, want))

    def test_place_runs_on_worker_threads(self):
        seen = set()

        def place(x):
            seen.add(threading.current_thread().name)
            return x * 2

        with PrefetchIterator(_ints(8), place=place, depth=2) as feed:
            got = [int(b[0]) for b in feed]
        assert got == [2 * i for i in range(8)]
        assert all(name.startswith("hvd-input") for name in seen)

    def test_cpu_pipeline_pins_nothing(self, hvd_cpu):
        """On the CPU ``place`` runs as given: no copy stream, no pinned
        staging."""
        with PrefetchIterator(_ints(4), place=torch.as_tensor) as feed:
            got = list(feed)
            assert feed.stager is None
        assert [int(t[0]) for t in got] == [0, 1, 2, 3]
        assert not any(t.is_pinned() for t in got)

    def test_bounded_queue_backpressure(self):
        """At most depth + 1 items pulled beyond what was consumed."""
        pulled = []

        def src():
            for i in range(100):
                pulled.append(i)
                yield i

        feed = PrefetchIterator(src(), depth=3, threads=1)
        try:
            for consumed in range(1, 6):
                next(feed)
                time.sleep(0.05)
                assert len(pulled) <= consumed + 3 + 1, \
                    f"feeder ran {len(pulled) - consumed} ahead"
        finally:
            feed.close()

    def test_source_exception_propagates(self):
        def src():
            yield np.zeros(1)
            yield np.zeros(1)
            raise RuntimeError("upstream reader died")

        feed = PrefetchIterator(src(), depth=2)
        next(feed), next(feed)
        with pytest.raises(RuntimeError, match="upstream reader died"):
            next(feed)
        assert feed.closed

    def test_place_exception_propagates(self):
        def place(x):
            if int(x[0]) == 2:
                raise ValueError("bad batch assembly")
            return x

        feed = PrefetchIterator(_ints(6), place=place, depth=2)
        with pytest.raises(ValueError, match="bad batch assembly"):
            for _ in range(6):
                next(feed)
        assert feed.closed

    def test_shutdown_without_leak(self):
        feed = PrefetchIterator(_ints(50), depth=2, threads=3,
                                name="leakcheck")
        next(feed)
        assert _input_threads()
        feed.close()
        assert not _input_threads(), "threads survived close()"
        feed.close()      # idempotent
        with pytest.raises(RuntimeError, match="closed"):
            next(feed)

    def test_close_unblocks_parked_feeder(self):
        feed = PrefetchIterator(_ints(1000), depth=1, threads=1)
        time.sleep(0.1)                      # feeder parks on put()
        t0 = time.perf_counter()
        feed.close()
        assert time.perf_counter() - t0 < 2.0
        assert not _input_threads()

    def test_close_during_inflight_worker_exception(self):
        """close() on an iterator whose feeder already hit an error
        returns cleanly and leak-free, dropping the pending error."""
        import queue as queue_mod

        gate = threading.Event()

        def src():
            yield np.zeros(1)
            gate.wait(5.0)
            raise RuntimeError("in-flight source failure")

        feed = PrefetchIterator(src(), depth=2, name="inflightclose")
        next(feed)
        gate.set()
        deadline = time.monotonic() + 5.0
        while feed._queue.empty() and time.monotonic() < deadline:
            time.sleep(0.01)
        feed.close()
        assert feed.closed
        assert not _input_threads(), "threads survived close()"
        with pytest.raises(queue_mod.Empty):
            feed._queue.get_nowait()

    def test_close_during_inflight_place_exception(self):
        def place(x):
            if int(x[0]) >= 1:
                raise ValueError("bad assembly in flight")
            return x

        feed = PrefetchIterator(_ints(10), place=place, depth=3,
                                name="placeclose")
        next(feed)
        time.sleep(0.1)
        feed.close()
        assert feed.closed
        assert not _input_threads()

    def test_exhaustion_closes(self):
        feed = PrefetchIterator(_ints(3), depth=4)
        assert [int(b[0]) for b in feed] == [0, 1, 2]
        assert feed.closed
        with pytest.raises(StopIteration):
            next(feed)

    def test_stall_accounting(self):
        def slow():
            for i in range(3):
                time.sleep(0.03)
                yield i

        with PrefetchIterator(slow(), depth=2) as feed:
            list(feed)
            assert feed.batches == 3
            assert feed.stall_s > 0.0
            assert len(feed.stall_samples) == 3
            assert feed.stall_s == pytest.approx(sum(feed.stall_samples))

    def test_telemetry_series(self):
        """The JAX iterator's three series, under its names, when the
        registry is on."""
        telemetry.enable()
        try:
            telemetry.reset()
            with PrefetchIterator(_ints(5), depth=2, name="tel") as feed:
                list(feed)
            snap = telemetry.snapshot()
            assert telemetry.value("hvd_input_batches_total",
                                   pipeline="tel") == 5.0
            hist = snap["histograms"][
                'hvd_input_stall_seconds{pipeline="tel"}']
            assert hist["count"] == 5
            assert 'hvd_input_queue_depth{pipeline="tel"}' in snap["gauges"]
        finally:
            telemetry.disable()
            telemetry.reset()

    def test_close_all_pipelines(self):
        feeds = [PrefetchIterator(_ints(100), depth=1, threads=1)
                 for _ in range(3)]
        feeds[0].close()
        assert close_all_pipelines() == 2
        assert all(f.closed for f in feeds)
        assert not _input_threads()

    def test_depth_validation(self):
        with pytest.raises(ValueError, match="depth"):
            PrefetchIterator(_ints(1), depth=0)
        with pytest.raises(ValueError, match="threads"):
            PrefetchIterator(_ints(1), threads=0)


class TestDataFeedFault:
    """tests/test_chaos.py's data.feed cases, on the port."""

    @pytest.mark.parametrize("depth", [1, 2, 4])
    def test_feeder_fault_surfaces_at_exact_batch(self, depth):
        faults.set_plan(FaultPlan(sim=True).add(
            "data.feed", "raise", "OSError", at=3))
        try:
            it = PrefetchIterator(iter(range(100)), depth=depth)
            got = [next(it), next(it)]
            with pytest.raises(OSError):
                while True:
                    got.append(next(it))
            assert got == [0, 1]
            assert it.closed
        finally:
            faults.clear_plan()

    def test_slow_source_fault_just_delays(self):
        plan = FaultPlan().add("data.feed", "delay", "0.05", at=1, count=2)
        faults.set_plan(plan)
        try:
            with PrefetchIterator(iter(range(4)), depth=2) as it:
                assert list(it) == [0, 1, 2, 3]
            assert [f[:2] for f in plan.fired] == [("data.feed", 1),
                                                   ("data.feed", 2)]
        finally:
            faults.clear_plan()

    @pytest.mark.parametrize("text", [
        "seed=42;data.feed@3:delay(0.5)",
        "mode=sim;data.feed@2:raise(OSError)x3?0.5;worker.commit:crash(9)",
        "data.feed:valuex*", "data.feed@4:hang(2)"])
    def test_plan_grammar_matches_jax(self, text):
        def spec(s):
            return (s.site, s.action, s.arg, s.at, s.count, s.prob)

        port, ref = FaultPlan.parse(text), jfaults.FaultPlan.parse(text)
        assert (port.seed, port.sim) == (ref.seed, ref.sim)
        assert [spec(s) for s in port.specs] == [spec(s) for s in ref.specs]

    def test_probabilistic_draws_match_jax(self):
        """?prob draws are a pure function of (seed, site, hit), the same
        in both packages."""
        text = "seed=7;data.feed:raise(ValueError)x*?0.3"
        hits = []
        for plan in (FaultPlan.parse(text), jfaults.FaultPlan.parse(text)):
            fired = []
            for hit in range(1, 41):
                try:
                    plan.inject("data.feed")
                except ValueError:
                    fired.append(hit)
            hits.append(fired)
        assert hits[0] == hits[1] and 0 < len(hits[0]) < 40

    @pytest.mark.parametrize("seed", [3, 4, 11])
    def test_corrupt_matches_jax(self, seed):
        """The same element of the same leaf moved by the same amount, on
        a tree both packages flatten in one order (lists and tuples; a
        dict's leaves are in insertion order in torch's pytree and in
        sorted-key order in JAX's)."""
        value = [np.arange(6, dtype=np.float32).reshape(2, 3),
                 (np.ones(4, np.float32), np.zeros(2, np.float32))]
        outs = []
        for mod in (faults, jfaults):
            plan = mod.FaultPlan(seed=seed).add("guard.params", "corrupt",
                                                "2.0")
            outs.append(plan.inject("guard.params", value=value))
        got, want = outs
        assert np.array_equal(got[0], np.asarray(want[0]))
        for g, w in zip(got[1], want[1]):
            assert np.array_equal(g, np.asarray(w))
        moved = sum(int((np.asarray(a) != b).sum()) for a, b in
                    ((got[0], value[0]), (got[1][0], value[1][0]),
                     (got[1][1], value[1][1])))
        assert moved == 1

    def test_env_plan(self, monkeypatch):
        monkeypatch.setenv("HOROVOD_FAULT_PLAN",
                           "mode=sim;data.feed@2:raise(TimeoutError)")
        try:
            plan = faults.load_env_plan(force=True)
            assert plan is not None and plan.sim
            it = PrefetchIterator(iter(range(5)), depth=1)
            assert next(it) == 0
            with pytest.raises(TimeoutError):
                next(it)
        finally:
            faults.clear_plan()


def test_knobs_match_jax_in_a_fresh_process():
    """``default_prefetch_depth``/``default_input_threads`` read the env
    before ``init()`` as ``horovod_tpu/data/prefetch.py:60-78`` does
    (floored at 1), and the runtime config after it."""
    code = r"""
import json, os
import jax
jax.config.update("jax_platforms", "cpu")
from horovod_tpu.data import prefetch as J
from horovod_tpu_torch.data import prefetch as T
out = []
for depth, threads in (("5", "3"), (None, None), ("0", "-2"), ("", "7")):
    for name, v in (("HOROVOD_PREFETCH_DEPTH", depth),
                    ("HOROVOD_INPUT_THREADS", threads)):
        os.environ.pop(name, None)
        if v is not None:
            os.environ[name] = v
    out.append([[T.default_prefetch_depth(), T.default_input_threads()],
                [J.default_prefetch_depth(), J.default_input_threads()]])
os.environ["HOROVOD_PREFETCH_DEPTH"] = "4"
os.environ["HOROVOD_INPUT_THREADS"] = "6"
import horovod_tpu_torch as hvd
hvd.init(device="cpu")
os.environ["HOROVOD_PREFETCH_DEPTH"] = "9"
out.append([T.default_prefetch_depth(), T.default_input_threads()])
hvd.shutdown()
print(json.dumps(out))
"""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    for port, ref in got[:-1]:
        assert port == ref
    assert [g[0] for g in got[:-1]] == [[5, 3], [2, 2], [1, 1], [2, 7]]
    assert got[-1] == [4, 6]       # the config, read at init()


@pytest.fixture
def hvd_cpu():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


class TestInputProbe:
    def test_report_fields_match_jax(self):
        from horovod_tpu.utils.input_probe import H2dReport as JReport

        args = dict(put_s=0.0123456789, step_s=0.084123456,
                    both_s=0.0851234567, overlap_fraction=0.91234567)
        assert H2dReport(**args).as_bench_fields("resnet_") == \
            JReport(**args).as_bench_fields("resnet_")

    def test_probe_on_the_cpu(self, hvd_cpu):
        """The estimator on a CPU step: fields in range, the fence a no-op
        for CPU tensors."""
        w = torch.ones(64, 64)

        def run_step(b):
            return (b["x"] @ w).sum()

        fence_batch({"x": torch.zeros(2)})
        rep = measure_h2d_overlap(run_step, lambda: {"x": np.ones((64, 64),
                                                                  np.float32)},
                                  lambda h: {"x": torch.from_numpy(h["x"])})
        assert rep.put_s >= 0 and rep.step_s > 0 and rep.both_s > 0
        assert 0.0 <= rep.overlap_fraction <= 1.0


#: (world, launch) of the worlds the caller makes before hvd.init(): no
#: HOROVOD_* variable; torchrun's LOCAL_* or none; one host, or hostnames
#: of two hosts, even or not
CALLER_WORLDS = {
    "w2": (2, {}),
    "w2-torchrun": (2, {"local_world_size": 2}),
    "w4-hosts": (4, {"hosts": ["a", "a", "b", "b"]}),
    "w4-torchrun": (4, {"local_world_size": 2}),
    "w4-uneven": (4, {"hosts": ["a", "a", "a", "b"]}),
}


@pytest.fixture(scope="module")
def caller_worlds():
    """Every world of CALLER_WORLDS, two at a time."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=2) as pool:
        runs = {name: pool.submit(spawn_world, "run_identity", world=world,
                                  launch=launch, timeout=180)
                for name, (world, launch) in CALLER_WORLDS.items()}
        return {name: run.result() for name, run in runs.items()}


@pytest.fixture(params=sorted(CALLER_WORLDS))
def caller_world(request, caller_worlds):
    name = request.param
    return name, CALLER_WORLDS[name][0], caller_worlds[name]


class TestCallerWorld:
    """ROADMAP Queue C 7: ``init()`` under a process group that the caller
    made."""

    #: (local_rank, local_size, cross_rank, cross_size) of each rank
    WANT = {"w2": [(0, 2, 0, 1), (1, 2, 0, 1)],
            "w2-torchrun": [(0, 2, 0, 1), (1, 2, 0, 1)],
            "w4-hosts": [(0, 2, 0, 2), (1, 2, 0, 2), (0, 2, 1, 2),
                         (1, 2, 1, 2)],
            "w4-torchrun": [(0, 2, 0, 2), (1, 2, 0, 2), (0, 2, 1, 2),
                            (1, 2, 1, 2)],
            "w4-uneven": [(0, 3, 0, 2), (1, 3, 0, 2), (2, 3, 0, 2),
                          (0, 1, 1, 2)]}

    def test_identity(self, caller_world):
        name, world, outs = caller_world
        assert [o["rank"] for o in outs] == list(range(world))
        assert all(o["size"] == world for o in outs)
        got = [(o["local_rank"], o["local_size"], o["cross_rank"],
                o["cross_size"]) for o in outs]
        assert got == self.WANT[name]
        homogeneous = name != "w4-uneven"
        for o in outs:
            assert (o["process_rank"], o["process_count"]) == \
                (o["rank"], o["size"])
            assert o["is_homogeneous"] is homogeneous
            if homogeneous:
                assert o["local_size"] * o["cross_size"] == o["size"]
            assert o["device"] == "cpu"
        # the local ranks of one host are distinct
        by_host = {}
        for lr, _, cr, _ in got:
            by_host.setdefault(cr, []).append(lr)
        for ranks in by_host.values():
            assert sorted(ranks) == list(range(len(ranks)))

    def test_probes(self, caller_world):
        import torch.distributed as dist

        want = dict.fromkeys(PROBES, False)
        want.update(nccl_built=bool(dist.is_nccl_available()),
                    gloo_built=True, gloo_enabled=True,
                    cuda_built=torch.version.cuda is not None)
        for o in caller_world[2]:
            assert o["probes"] == want

    def test_input_plane_reads_the_identity(self, caller_world):
        """The seed is rank 0's on every rank; a dataset's default rank
        and world are the runtime's; the fed batches are the JAX
        package's ShardedDataset of that rank, across two epochs."""
        _, world, outs = caller_world
        for rank, o in enumerate(outs):
            assert o["seed"] == 100
            assert tuple(o["ds"]) == (rank, world)
            ref = JShardedDataset(JArraySource(data_columns()),
                                  batch_size=DATA_BATCH, rank=rank,
                                  world=world, seed=100).iter_epochs()
            for got in o["fed"]:
                want = next(ref)
                for k in want:
                    assert np.array_equal(got[k], np.asarray(want[k]))

    def test_shard_local_batch_equals_shard_batch(self, caller_world):
        """Each rank's own rows through shard_local_batch equal its part
        of the concatenated rows through shard_batch, without a plan and
        under an sp plan (dim 1 split over the sp group)."""
        for o in caller_world[2]:
            for k in o["global"]:
                assert np.array_equal(o["local"][k], o["global"][k])
            assert np.array_equal(o["sp_local"], o["sp_global"])
            assert o["sp_local"].shape == (2, 4)


def test_identity_queries_in_all():
    import horovod_tpu_torch as hvd

    for name in IDENTITY_QUERIES + PROBES + ("SyncBatchNorm",
                                             "sync_batch_stats", "data"):
        assert name in hvd.__all__ and hasattr(hvd, name)


def test_world_of_one_identity(hvd_cpu):
    hvd = hvd_cpu
    assert (hvd.process_rank(), hvd.process_count(), hvd.is_homogeneous(),
            hvd.gloo_enabled()) == (0, 1, True, True)
    assert ShardedDataset(ArraySource(_columns(8)), 2).world == 1
