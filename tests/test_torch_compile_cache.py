"""The port's compile cache (``horovod_tpu_torch/runtime/compile_cache.py``)
on the CPU: the JAX package's own cases of ``tests/test_compile_cache.py``
that need no XLA executable (the key's stability and its fields, the
root's resolution and the disabled knob, LRU eviction over files), the
disk layer with the native library built by ``g++`` (a miss then a hit in
a fresh process, pruning, a truncated entry, the disabled store,
concurrent builds of one entry), ``executable_key`` across processes and
the in-memory layer's counters."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from horovod_tpu_torch.runtime import compile_cache

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def hvd_torch():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    """An isolated store root for env and config resolution, with a
    freshly initialized runtime (JAX's fixture)."""
    import horovod_tpu_torch as hvd

    d = str(tmp_path / "cc")
    monkeypatch.setenv("HOROVOD_COMPILE_CACHE_DIR", d)
    monkeypatch.delenv("HOROVOD_COMPILE_CACHE", raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    yield d
    hvd.shutdown()


def _python(code: str, env: dict, timeout: float = 240):
    """Run ``code`` in a fresh interpreter with ``env`` over this one's;
    returns the completed process (its output captured)."""
    full = dict(os.environ, PYTHONPATH=str(ROOT), **env)
    full.pop("HOROVOD_COMPILE_CACHE", None)
    full.update(env)
    return subprocess.run([sys.executable, "-c", code], env=full,
                          capture_output=True, text=True, timeout=timeout,
                          cwd=str(ROOT))


#: a fresh process loads the native library and prints what it saw
LOAD_NATIVE = """
import json
from horovod_tpu_torch import native
from horovod_tpu_torch.runtime import compile_cache
ok = native.native_built()
print(json.dumps({"ok": ok, "error": native.native_error(),
                  "path": str(native.library_path()),
                  "build_seconds": native.build_seconds,
                  "stats": compile_cache.stats()}))
"""


def _load_native(store, **env) -> dict:
    env = {"HOROVOD_COMPILE_CACHE_DIR": str(store), **env}
    proc = _python(LOAD_NATIVE, env)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["stderr"] = proc.stderr
    return out


class TestKey:
    def test_deterministic(self):
        k1 = compile_cache.executable_key({"a": 1})
        k2 = compile_cache.executable_key({"a": 1})
        assert k1 == k2

    def test_sensitive_to_extras(self):
        base = compile_cache.executable_key({"a": 1})
        assert compile_cache.executable_key({"a": 2}) != base
        assert compile_cache.executable_key({"a": 1, "b": None}) != base

    def test_no_addresses(self):
        """A field with a default repr keys the same in every process:
        its memory address is stripped (JAX's ``_stable_repr``)."""
        obj = object()
        assert " at 0x" in repr(obj)
        assert " at 0x" not in compile_cache._stable_repr(obj)
        assert compile_cache.executable_key({"o": obj}) == \
            compile_cache.executable_key({"o": object()})

    def test_sensitive_to_model_optimizer_and_batch(self):
        model = torch.nn.Linear(4, 3)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
        batch = torch.zeros(2, 4)
        base = compile_cache.executable_key(
            {}, model=model, optimizer=opt, batch=batch)
        assert compile_cache.executable_key(
            {}, model=torch.nn.Linear(4, 3), optimizer=opt,
            batch=batch) == base
        assert compile_cache.executable_key(
            {}, model=torch.nn.Linear(5, 3), optimizer=opt,
            batch=batch) != base
        assert compile_cache.executable_key(
            {}, model=model, optimizer=opt, batch=torch.zeros(3, 4)) != base
        assert compile_cache.executable_key(
            {}, model=model, optimizer=opt,
            batch=torch.zeros(2, 4, dtype=torch.float64)) != base
        opt.param_groups[0]["lr"] = 5e-4          # a scheduler's step
        assert compile_cache.executable_key(
            {}, model=model, optimizer=opt, batch=batch) != base
        sgd = torch.optim.SGD(model.parameters(), lr=5e-4)
        assert compile_cache.executable_key(
            {}, model=model, optimizer=sgd, batch=batch) != base


#: a fresh process builds a fixed step and prints its executable key
STEP_KEY = """
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.runtime import compile_cache
hvd.init(device="cpu")
model = torch.nn.Sequential(torch.nn.Linear(8, 4))
step = hvd.DistributedTrainStep(
    lambda m, b: m(b).square().mean(),
    torch.optim.AdamW(model.parameters(), lr=1e-3), steps_per_call=3)
print(compile_cache.executable_key(step._aot_extras(), model=model,
                                   optimizer=step.optimizer,
                                   batch=torch.zeros(6, 8)))
hvd.shutdown()
"""


class TestStepKey:
    def _key(self, hvd, lr=1e-3, rows=6, k=3, plan=None):
        model = torch.nn.Sequential(torch.nn.Linear(8, 4))
        step = hvd.DistributedTrainStep(
            lambda m, b: m(b).square().mean(),
            torch.optim.AdamW(model.parameters(), lr=lr),
            steps_per_call=k, plan=plan)
        return compile_cache.executable_key(
            step._aot_extras(), model=model, optimizer=step.optimizer,
            batch=torch.zeros(rows, 8))

    def test_equal_across_processes(self, hvd_torch):
        keys = [_python(STEP_KEY, {}) for _ in range(2)]
        for proc in keys:
            assert proc.returncode == 0, proc.stderr
        a, b = (p.stdout.strip().splitlines()[-1] for p in keys)
        assert a == b == self._key(hvd_torch)

    @pytest.mark.parametrize("change", [dict(lr=2e-3), dict(rows=4),
                                        dict(k=2), dict(plan="dp=1")])
    def test_differs(self, hvd_torch, change):
        """A new lr, batch shape, ``steps_per_call`` or plan is a new key:
        a graph is never replayed for another step."""
        assert self._key(hvd_torch, **change) != self._key(hvd_torch)

    def test_extras_carry_the_plan_and_the_exchange(self, hvd_torch):
        """JAX's key fields (``TestPlanKey``, ``TestReductionKey``,
        ``TestFusedCollectivesKey``): the plan's canonical string, the
        sharded exchange, its reduction and error feedback."""
        model = torch.nn.Sequential(torch.nn.Linear(8, 4))

        def extras(**kw):
            return hvd_torch.DistributedTrainStep(
                lambda m, b: m(b).sum(),
                torch.optim.SGD(model.parameters(), lr=0.1),
                **kw)._aot_extras()

        bare = extras()
        assert bare["plan"] is None and bare["reduction"] is None
        assert bare["shard_optimizer_states"] is False
        assert bare["steps_per_call"] == 1 and bare["guard"] is False
        planned = extras(plan="dp=1")
        assert planned["plan"] == "dp=1"
        sharded = extras(shard_optimizer_states=True,
                         compression=hvd_torch.Compression.int8,
                         error_feedback=True)
        assert sharded["shard_optimizer_states"] is True
        assert sharded["reduction"] == "sum"
        assert sharded["error_feedback"] is True
        keys = {compile_cache.executable_key(e)
                for e in (bare, planned, sharded)}
        assert len(keys) == 3

    def test_moe_fields(self, hvd_torch, monkeypatch):
        """JAX's ``TestMoeRoutingKey``: the dispatch schedule and the
        capacity factor are key fields, read from the knobs too."""
        model = torch.nn.Sequential(torch.nn.Linear(8, 4))
        monkeypatch.setenv("HOROVOD_MOE_FUSED_DISPATCH", "on")
        monkeypatch.setenv("HOROVOD_MOE_CAPACITY_FACTOR", "2.0")
        ex = hvd_torch.DistributedTrainStep(
            lambda m, b: m(b).sum(),
            torch.optim.SGD(model.parameters(), lr=0.1))._aot_extras()
        assert ex["moe_fused"] == "on" and ex["moe_capacity_factor"] == 2.0


class TestResolveDir:
    def test_env_disable(self, monkeypatch):
        import horovod_tpu_torch as hvd

        monkeypatch.setenv("HOROVOD_COMPILE_CACHE", "0")
        hvd.shutdown()   # fall back to raw-env resolution
        assert compile_cache.resolve_dir() is None

    def test_config_disable(self, cache_dir):
        import dataclasses

        from horovod_tpu_torch.runtime import state

        cfg = state.global_state().config
        off = dataclasses.replace(cfg, compile_cache_enabled=False)
        assert compile_cache.resolve_dir(off) is None

    def test_env_dir_wins(self, cache_dir):
        assert compile_cache.resolve_dir() == cache_dir

    def test_default_is_the_repo_build_dir(self, monkeypatch):
        import horovod_tpu_torch as hvd

        hvd.shutdown()
        monkeypatch.delenv("HOROVOD_COMPILE_CACHE_DIR", raising=False)
        monkeypatch.delenv("HOROVOD_COMPILE_CACHE", raising=False)
        assert compile_cache.resolve_dir() == str(ROOT / "build")

    def test_store_wired_at_init(self, cache_dir):
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.runtime import state

        assert state.global_state().compile_cache_dir == cache_dir
        assert os.path.isdir(cache_dir)
        stats = hvd.cache_stats()
        assert {"hits", "misses", "aot_disk_hits",
                "aot_disk_misses"} <= stats.keys()


def _fake_entry(root: Path, name: str, mtime: float) -> Path:
    path = root / f"{name}.so"
    for f in (path, path.with_suffix(".log"), path.with_suffix(".json")):
        f.write_text(name)
        os.utime(f, (mtime, mtime))
    return path


class TestLruEviction:
    def test_prune_keeps_most_recent(self, tmp_path):
        now = time.time()
        paths = [_fake_entry(tmp_path, f"lib{i}", now - 100 + i)
                 for i in range(4)]
        (tmp_path / "other.so").write_text("not the store's")
        assert compile_cache.entry_count(str(tmp_path)) == 4
        assert compile_cache.prune(tmp_path, capacity=2) == 2
        assert compile_cache.entry_count(str(tmp_path)) == 2
        for p in paths[:2]:            # an entry's files go together
            assert not any(f.exists() for f in
                           (p, p.with_suffix(".log"), p.with_suffix(".json")))
        assert all(p.exists() for p in paths[2:])
        assert (tmp_path / "other.so").exists()

    def test_a_load_refreshes_recency(self, tmp_path):
        now = time.time()
        old = _fake_entry(tmp_path, "old", now - 100)
        _fake_entry(tmp_path, "new", now - 50)
        compile_cache._touch(old)
        compile_cache.prune(tmp_path, capacity=1)
        assert old.exists() and not (tmp_path / "new.so").exists()


class TestDiskLayer:
    def test_miss_then_hit_in_a_fresh_process(self, tmp_path):
        store = tmp_path / "store"
        first = _load_native(store)
        assert first["ok"] and first["stats"] == {"aot_disk_hits": 0,
                                                  "aot_disk_misses": 1}
        assert first["build_seconds"] > 0
        assert Path(first["path"]).parent == store
        meta = json.loads(Path(first["path"]).with_suffix(
            ".json").read_text())
        assert "g++" in meta["env"]["toolchain"].lower() or \
            "gcc" in meta["env"]["toolchain"].lower()
        assert meta["env"]["torch"] == torch.__version__
        second = _load_native(store)
        assert second["ok"] and second["path"] == first["path"]
        assert second["stats"] == {"aot_disk_hits": 1, "aot_disk_misses": 0}
        assert second["build_seconds"] == 0

    def test_prune_at_capacity_one_keeps_the_newest(self, tmp_path,
                                                     monkeypatch):
        """Two entries of the native library (the second from an edited
        source) under ``capacity=1``: the first is evicted, .so, .log and
        .json together."""
        from horovod_tpu_torch import native as TN

        first = TN.library_path(tmp_path)
        compile_cache.store_library(first, TN._compile)
        src = tmp_path / "hvd_native.cc"
        src.write_text(TN.SRC.read_text() + "\n// edited\n")
        monkeypatch.setattr(TN, "SRC", src)
        second = TN.library_path(tmp_path)
        assert second != first
        time.sleep(0.01)
        compile_cache.store_library(second, TN._compile)
        # a store does not prune: the library's entries stay until asked
        assert compile_cache.entry_count(str(tmp_path)) == 2
        assert compile_cache.prune(tmp_path, capacity=1) == 1
        assert second.exists() and second.with_suffix(".json").exists()
        assert not first.exists() and not first.with_suffix(".json").exists()
        assert compile_cache.entry_count(str(tmp_path)) == 1

    def test_truncated_entry_is_rebuilt_with_one_warning(self, tmp_path):
        store = tmp_path / "store"
        first = _load_native(store)
        path = Path(first["path"])
        path.write_bytes(path.read_bytes()[:64])
        again = _load_native(store)
        assert again["ok"] and again["path"] == first["path"]
        assert again["stats"] == {"aot_disk_hits": 0, "aot_disk_misses": 1}
        warned = [line for line in again["stderr"].splitlines()
                  if "could not load" in line]
        assert len(warned) == 1, again["stderr"]
        assert path.stat().st_size > 64

    def test_disabled_store_builds_in_a_directory_gone_at_exit(
            self, tmp_path):
        got = _load_native(tmp_path / "unused", HOROVOD_COMPILE_CACHE="0")
        assert got["ok"]
        where = Path(got["path"]).parent
        assert where != tmp_path / "unused" and where.name.startswith(
            "hvd_compile_")
        assert got["stats"]["aot_disk_misses"] == 1
        assert not where.exists()
        assert not (tmp_path / "unused").exists()

    def test_concurrent_builds_load_whole_libraries(self, tmp_path):
        """Four processes build one entry at once, three rounds: every one
        loads a whole library (the JAX package's in-place build loses the
        library on some of them)."""
        code = LOAD_NATIVE
        for round_ in range(3):
            store = tmp_path / f"round{round_}"
            env = dict(os.environ, PYTHONPATH=str(ROOT),
                       HOROVOD_COMPILE_CACHE_DIR=str(store))
            env.pop("HOROVOD_COMPILE_CACHE", None)
            procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True,
                                      cwd=str(ROOT)) for _ in range(4)]
            outs = [p.communicate(timeout=240) for p in procs]
            for (out, err), p in zip(outs, procs):
                assert p.returncode == 0, err
                got = json.loads(out.strip().splitlines()[-1])
                assert got["ok"], got
            assert compile_cache.entry_count(str(store)) == 1
            assert not list(store.glob(".tmp.*"))


class TestInMemoryLayer:
    def test_counts_and_evicts(self, hvd_torch):
        from horovod_tpu_torch import telemetry

        lru = compile_cache.ExecutableLRU(capacity=2)
        telemetry.enable()
        try:
            before = hvd_torch.cache_stats()
            hits0 = telemetry.value("hvd_compile_cache_hits_total")
            misses0 = telemetry.value("hvd_compile_cache_misses_total")
            assert lru.get("a") is None
            lru.put("a", 1)
            lru.put("b", 2)
            assert lru.get("a") == 1           # a is now the most recent
            lru.put("c", 3)                    # evicts b
            assert "b" not in lru and len(lru) == 2
            assert lru.get("b") is None
            after = hvd_torch.cache_stats()
            assert after["hits"] - before["hits"] == 1
            assert after["misses"] - before["misses"] == 2
            assert telemetry.value("hvd_compile_cache_hits_total") - \
                hits0 == 1
            assert telemetry.value("hvd_compile_cache_misses_total") - \
                misses0 == 2
        finally:
            telemetry.disable()

    def test_an_invalid_entry_is_dropped_as_a_miss(self, hvd_torch):
        """``get(key, valid=)``: an entry the predicate rejects (a graph
        captured on tensors that were replaced) is dropped and the lookup
        counts as a miss, here and process-wide."""
        lru = compile_cache.ExecutableLRU(capacity=4)
        lru.put("a", 1)
        before = hvd_torch.cache_stats()
        assert lru.get("a", valid=lambda e: e == 1) == 1
        assert lru.get("a", valid=lambda e: e == 2) is None
        assert "a" not in lru and len(lru) == 0
        assert (lru.hits, lru.misses) == (1, 1)
        after = hvd_torch.cache_stats()
        assert after["hits"] - before["hits"] == 1
        assert after["misses"] - before["misses"] == 1

    def test_clear_and_values(self):
        lru = compile_cache.ExecutableLRU(capacity=4)
        lru.put("a", 1)
        lru.put("b", 2)
        assert lru.values() == [1, 2]
        lru.clear()
        assert len(lru) == 0 and lru.values() == []
        assert lru.get("a") is None and lru.misses == 1

    def test_capacity_from_the_config(self, monkeypatch):
        import horovod_tpu_torch as hvd

        monkeypatch.setenv("HOROVOD_CACHE_CAPACITY", "3")
        hvd.init(device="cpu")
        try:
            assert compile_cache.ExecutableLRU().capacity == 3
        finally:
            hvd.shutdown()


class TestElasticLaunch:
    @pytest.mark.parametrize("preset", [None, "/elsewhere"])
    def test_workers_get_the_store(self, monkeypatch, preset):
        """Every generation's workers are given the store's root (unless
        the launch set one), so a respawned worker loads the libraries
        instead of compiling them."""
        import argparse

        from horovod_tpu_torch.elastic import launch

        envs = []

        class Driver:
            address = ("localhost", 1)
            degrade_controller = None

            def __init__(self, *a, **kw):
                pass

            def start(self, np_, create_worker_fn):
                from horovod_tpu_torch.runner.hosts import SlotInfo

                for gen in (0, 1):
                    create_worker_fn(SlotInfo("localhost", 0, 0, 0, 1, 1, 1),
                                     "localhost:2", gen)

            def wait_for_completion(self):
                return 0

        monkeypatch.setattr(launch, "ElasticDriver", Driver)
        monkeypatch.setattr(launch.safe_shell_exec, "execute",
                            lambda cmd, env, **kw: envs.append(env) or 0)
        if preset is None:
            monkeypatch.delenv("HOROVOD_COMPILE_CACHE_DIR", raising=False)
        else:
            monkeypatch.setenv("HOROVOD_COMPILE_CACHE_DIR", preset)
        args = argparse.Namespace(
            min_np=1, np=1, max_np=1, hosts="localhost:1",
            host_discovery_script=None, slots=None, elastic_timeout=10,
            reset_limit=None, output_filename=None, command=["true"],
            ssh_port=None, verbose=False)
        assert launch.run_elastic(args) == 0
        want = preset or str(ROOT / "build")
        assert [e["HOROVOD_COMPILE_CACHE_DIR"] for e in envs] == [want] * 2
