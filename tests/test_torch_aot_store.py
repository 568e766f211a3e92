"""The port's AOT executable store (``runtime/compile_cache.aot_compile``,
JAX's layer 2) and ``ExecutableCache.from_exported`` (JAX's
``from_jitted``) on the CPU.

A narrow 2-layer LM (fp32, flash attention: ``hvd_torch::flash_fwd``
runs its plain version here) with weights carried from flax is exported
and compiled by AOTInductor once, into a store shared by the module's
tests; a corrupt entry is compiled once more.  Those are the file's two
compiles: the disabled store's compile is stood in for by a copy of the
first package.  Mirrors JAX's ``tests/test_compile_cache.py``
(``TestKey``, ``TestAotRoundTrip``, ``TestLruEviction``): the key's
fields, a miss then a hit in a fresh process, a corrupt entry evicted and
rewritten, the disabled store, LRU pruning by ``cache_capacity``; and the
served executor against JAX's ``from_jitted`` executor and the port's
eager ``from_module`` one on the same weights and padded batch.
"""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as JT
from horovod_tpu.serve import batcher as JB
from horovod_tpu_torch.models import transformer as TT
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.runtime import compile_cache
from horovod_tpu_torch.serve import ExecutableCache

ROOT = Path(__file__).resolve().parents[1]
SIZES = dict(vocab_size=96, num_layers=2, num_heads=4, d_model=64,
             d_ff=128, max_seq_len=32)
LEN, BUCKET = 16, 4
SIG = ((LEN,), "torch.int64")
#: AOT against JAX's jitted forward (reference attention, XLA's fusion)
#: and against the port's eager forward, fp32
RTOL, ATOL = 1e-5, 1e-6


class LastLogits(torch.nn.Module):
    """A served LM's result: the last position's logits."""

    def __init__(self, lm):
        super().__init__()
        self.lm = lm

    def forward(self, tokens):
        return self.lm(tokens)[:, -1]


def _port_model(state=None):
    model = LastLogits(TT.TransformerLM(TT.TransformerConfig(
        dtype=torch.float32, attention_impl="flash", **SIZES)))
    if state is not None:
        model.load_state_dict(state)
    return model


def _example(signature, padded):
    return torch.zeros((padded,) + tuple(signature[0]), dtype=torch.long)


def _requests():
    rng = np.random.RandomState(5)
    return [rng.randint(0, SIZES["vocab_size"], (LEN,)).astype(np.int64)
            for _ in range(BUCKET)]


def _weights(model):
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


def _forward(model):
    """The function ``from_exported`` exports: the forward on weights."""
    return lambda x, weights: torch.func.functional_call(model, weights,
                                                         (x,))


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    """JAX's LM and its weights, the port's twin, and the first compile:
    ``from_exported`` into a fresh store, a batch of 1, 3 and 4 payloads
    served (all padded to the one bucket)."""
    jmodel = JT.TransformerLM(JT.TransformerConfig(
        dtype=jnp.float32, attention_impl="dense", **SIZES))
    variables = jmodel.init(jax.random.PRNGKey(3),
                            jnp.zeros((1, LEN), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray,
                                    flax.core.meta.unbox(variables))
    port = _port_model()
    port.lm.load_state_dict(params_from_flax(params))
    work = tmp_path_factory.mktemp("aot")
    store = work / "store"
    torch.save(port.state_dict(), work / "weights.pt")
    before = compile_cache.stats()
    cache = ExecutableCache.from_exported(port, _example,
                                          bucket_sizes=(BUCKET,),
                                          directory=str(store))
    reqs = [torch.from_numpy(r) for r in _requests()]
    t0 = time.perf_counter()
    results = {n: cache.run(reqs[:n]) for n in (1, 3, BUCKET)}
    seconds = time.perf_counter() - t0
    return dict(jmodel=jmodel, params=params, port=port, cache=cache,
                store=store, work=work, reqs=reqs, results=results,
                seconds=seconds, before=before,
                after=compile_cache.stats())


def _entry(store):
    (entry,) = (Path(store) / "aot").glob("*.pt2")
    return entry


def _key(model, batch=BUCKET, extras=None):
    x = torch.zeros((batch, LEN), dtype=torch.long)
    with torch.no_grad():
        ep = torch.export.export(compile_cache._as_module(_forward(model)),
                                 (x, _weights(model)))
    return compile_cache.export_key(str(ep.graph), (x, _weights(model)),
                                    extras)


# -- the key ----------------------------------------------------------------

class TestKey:
    def test_deterministic(self, lm):
        assert _key(lm["port"], extras={"a": 1}) == \
            _key(lm["port"], extras={"a": 1})

    def test_sensitive_to_graph_inputs_and_extras(self, lm):
        base = _key(lm["port"], extras={"a": 1})
        assert _key(lm["port"], extras={"a": 2}) != base
        assert _key(lm["port"], batch=8, extras={"a": 1}) != base
        wider = _port_model()
        wider.lm.layers = wider.lm.layers[:1]
        assert _key(wider, extras={"a": 1}) != base

    def test_sensitive_to_the_environment(self, lm, monkeypatch):
        base = _key(lm["port"])
        env = compile_cache._env_fields()
        monkeypatch.setattr(compile_cache, "_env_fields",
                            lambda *a, **kw: dict(env, torch="0.0.0"))
        assert _key(lm["port"]) != base
        monkeypatch.undo()
        monkeypatch.setattr(compile_cache, "_kernel_digest",
                            lambda: "edited kernels")
        assert _key(lm["port"]) != base

    def test_weight_values_and_addresses_are_not_in_it(self, lm):
        """A flip keeps the key (weights are inputs); an extra's repr is
        taken without its address, as JAX's ``_stable_repr``."""
        twin = _port_model({k: v + 1.0 for k, v in
                            lm["port"].state_dict().items()})
        assert _key(twin) == _key(lm["port"])
        assert _key(lm["port"], extras={"o": object()}) == \
            _key(lm["port"], extras={"o": object()})


# -- the round trip ---------------------------------------------------------

FRESH = """
import json, sys, torch
sys.path.insert(0, {tests!r})
from test_torch_aot_store import BUCKET, _example, _port_model, _requests
from horovod_tpu_torch.runtime import compile_cache
from horovod_tpu_torch.serve import ExecutableCache

port = _port_model(torch.load({weights!r}))
cache = ExecutableCache.from_exported(port, _example, bucket_sizes=(BUCKET,),
                                      directory={store!r})
reqs = [torch.from_numpy(r) for r in _requests()]
out = cache.run(reqs[:3])
print(json.dumps({{"stats": compile_cache.stats(),
                  "results": [r.tolist() for r in out]}}))
"""


class TestAotRoundTrip:
    def test_miss_store_hit(self, lm):
        """The first build missed and stored one entry with its meta; a
        second build in this process loads it (a hit); each batch size
        ran the one executable."""
        assert len(lm["cache"]) == 1
        assert lm["after"] == dict(lm["before"], aot_disk_misses=lm[
            "before"]["aot_disk_misses"] + 1)
        entry = _entry(lm["store"])
        meta = json.loads(entry.with_suffix(".json").read_text())
        assert meta["extras"] == {"serve_signature": repr(SIG),
                                  "serve_batch": BUCKET}
        assert meta["env"]["torch"] == torch.__version__
        before = compile_cache.stats()
        again = ExecutableCache.from_exported(
            lm["port"], _example, bucket_sizes=(BUCKET,),
            directory=str(lm["store"]))
        got = again.run(lm["reqs"][:3])
        assert compile_cache.stats() == dict(
            before, aot_disk_hits=before["aot_disk_hits"] + 1)
        assert compile_cache.executable_count(str(lm["store"])) == 1
        for g, w in zip(got, lm["results"][3]):
            assert torch.equal(g, w)

    def test_hit_in_a_fresh_process(self, lm):
        """A fresh interpreter that imports the port (which registers the
        ops the package calls) and rebuilds the model from the saved
        weights loads the entry: a hit, no miss, the same results bit for
        bit."""
        code = FRESH.format(tests=str(ROOT / "tests"),
                            weights=str(lm["work"] / "weights.pt"),
                            store=str(lm["store"]))
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        proc = subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True, timeout=300,
                              cwd=str(ROOT))
        assert proc.returncode == 0, proc.stderr[-3000:]
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        assert out["stats"] == {"aot_disk_hits": 1, "aot_disk_misses": 0}
        for g, w in zip(out["results"], lm["results"][3]):
            assert torch.equal(torch.tensor(g), w)

    def test_entry_holds_no_weights(self, lm):
        """The exported forward reads every weight from its inputs: no
        parameter, buffer or constant tensor is packaged."""
        x = torch.zeros((BUCKET, LEN), dtype=torch.long)
        with torch.no_grad():
            ep = torch.export.export(
                compile_cache._as_module(_forward(lm["port"])),
                (x, _weights(lm["port"])))
        assert not ep.state_dict and not ep.constants
        text = str(ep.graph)
        assert text.count("hvd_torch.flash_fwd") == SIZES["num_layers"]
        assert "scaled_dot_product" not in text

    def test_served_equals_jax_from_jitted(self, lm):
        """JAX's ``from_jitted`` executor (the store bypassed) on the same
        flax weights and the same padded batches: within 1e-5 relative,
        1e-6 absolute, one executable a bucket in both."""
        jmodel, params = lm["jmodel"], lm["params"]
        jitted = jax.jit(lambda xs: jmodel.apply(params,
                                                 jnp.stack(xs))[:, -1])
        jcache = JB.ExecutableCache.from_jitted(
            jitted, lambda sig, n: [jnp.zeros(sig[0], jnp.int32)] * n,
            bucket_sizes=(BUCKET,), directory=None)
        reqs = _requests()
        for n, got in lm["results"].items():
            want = jcache.run([r.astype(np.int32) for r in reqs[:n]])
            assert len(got) == len(want) == n
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=RTOL, atol=ATOL)
        assert len(jcache) == len(lm["cache"]) == 1

    def test_served_equals_from_module(self, lm):
        """The eager executor of ``from_module`` on the same model: within
        the same limits (Inductor fuses the glue around the ops in its own
        order)."""
        eager = ExecutableCache.from_module(lm["port"], _example,
                                            bucket_sizes=(BUCKET,))
        for n, got in lm["results"].items():
            for g, w in zip(got, eager.run(lm["reqs"][:n])):
                torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)

    def test_weights_given_run_the_same_executable(self, lm):
        """``weights=`` (a flip): the executable already built runs the
        weights given, equal within the limits to a forward of a model
        holding them; nothing is built or stored."""
        g = torch.Generator().manual_seed(2)
        other = {k: v + 0.01 * torch.randn(v.shape, generator=g)
                 for k, v in lm["port"].state_dict().items()}
        count = compile_cache.executable_count(str(lm["store"]))
        got = lm["cache"].run(lm["reqs"][:3], weights=other)
        with torch.inference_mode():
            want = _port_model(other)(torch.stack(lm["reqs"][:3]))
        for g_, w in zip(got, want):
            torch.testing.assert_close(g_, w, rtol=RTOL, atol=ATOL)
        assert len(lm["cache"]) == 1
        assert compile_cache.executable_count(str(lm["store"])) == count

    def test_corrupt_entry_is_evicted_and_rewritten(self, lm, tmp_path,
                                                    monkeypatch):
        """A garbled copy of the entry fails to load: it is removed with a
        warning, compiled again (a miss) and rewritten; the rewritten entry
        loads (a hit) and serves the same results bit for bit."""
        store = tmp_path / "store"
        (store / "aot").mkdir(parents=True)
        entry = _entry(lm["store"])
        bad = store / "aot" / entry.name
        bad.write_bytes(b"not a package" + entry.read_bytes()[:64])
        shutil.copy2(entry.with_suffix(".json"), bad.with_suffix(".json"))
        warned = []
        monkeypatch.setattr(compile_cache.hvd_logging, "warning",
                            lambda msg, *a: warned.append(msg % a))
        before = compile_cache.stats()
        cache = ExecutableCache.from_exported(
            lm["port"], _example, bucket_sizes=(BUCKET,),
            directory=str(store))
        got = cache.run(lm["reqs"])
        assert compile_cache.stats() == dict(
            before, aot_disk_misses=before["aot_disk_misses"] + 1)
        assert len(warned) == 1 and "could not load AOT entry" in warned[0]
        assert bad.read_bytes()[:2] == b"PK"       # a zip archive again
        for g, w in zip(got, lm["results"][BUCKET]):
            assert torch.equal(g, w)
        again = ExecutableCache.from_exported(
            lm["port"], _example, bucket_sizes=(BUCKET,),
            directory=str(store))
        again.get(SIG, BUCKET)
        assert compile_cache.stats() == dict(
            before, aot_disk_hits=before["aot_disk_hits"] + 1,
            aot_disk_misses=before["aot_disk_misses"] + 1)
        assert len(warned) == 1

    def test_disabled_store_compiles_privately(self, lm, monkeypatch):
        """``HOROVOD_COMPILE_CACHE=0``: every build compiles (stood in for
        by a copy of the first package) into this process's private
        directory and loads it from there; nothing is looked up, stored or
        counted, and the private directory keeps no package."""
        import torch._inductor

        monkeypatch.setenv("HOROVOD_COMPILE_CACHE", "0")
        assert compile_cache.resolve_dir() is None
        compiled = []

        def stand_in(ep, package_path, inductor_configs=None):
            compiled.append(package_path)
            shutil.copy2(_entry(lm["store"]), package_path)
            return package_path

        monkeypatch.setattr(torch._inductor, "aoti_compile_and_package",
                            stand_in)
        before = compile_cache.stats()
        cache = ExecutableCache.from_exported(lm["port"], _example,
                                              bucket_sizes=(BUCKET,))
        got = cache.run(lm["reqs"])
        private = compile_cache._private_store()
        assert len(compiled) == 1 and Path(compiled[0]).parent == \
            private / "aot"
        assert not list((private / "aot").iterdir())
        assert compile_cache.stats() == before
        for g, w in zip(got, lm["results"][BUCKET]):
            assert torch.equal(g, w)

    def test_stats_flow_to_the_runtime(self, lm):
        """A hit counts in ``hvd.cache_stats()`` as JAX's does."""
        import horovod_tpu_torch as hvd

        hvd.init(device="cpu")
        try:
            before = hvd.cache_stats()
            compile_cache.aot_compile(
                _forward(lm["port"]),
                (_example(SIG, BUCKET), _weights(lm["port"])),
                extras={"serve_signature": repr(SIG),
                        "serve_batch": BUCKET},
                directory=str(lm["store"]))
            after = hvd.cache_stats()
        finally:
            hvd.shutdown()
        assert after["aot_disk_hits"] == before.get("aot_disk_hits", 0) + 1
        assert after.get("aot_disk_misses", 0) == \
            before.get("aot_disk_misses", 0)


# -- LRU eviction -----------------------------------------------------------

def _store_copies(lm, root, keys, capacity=None):
    """Store a copy of the first package under each key, in order (a
    short wait between stores keeps their mtimes apart)."""
    aot = Path(root) / "aot"
    aot.mkdir(parents=True, exist_ok=True)
    for i, key in enumerate(keys):
        time.sleep(0.02)
        tmp = aot / f".tmp.{key}.pt2"
        shutil.copy2(_entry(lm["store"]), tmp)
        os.utime(tmp, None)
        assert compile_cache.store_executable(key, tmp, root,
                                              capacity=capacity,
                                              meta={"i": i})


class TestLruEviction:
    def test_prune_keeps_most_recent(self, lm, tmp_path):
        """Four entries stored at capacity 2: the two most recently
        stored survive, each package with its meta."""
        keys = [f"k{i}" for i in range(4)]
        _store_copies(lm, tmp_path, keys)
        assert compile_cache.executable_count(str(tmp_path)) == 4
        assert compile_cache.prune_executables(tmp_path, capacity=2) == 2
        left = sorted(p.name for p in (tmp_path / "aot").iterdir())
        assert left == ["k2.json", "k2.pt2", "k3.json", "k3.pt2"]

    def test_packages_being_compiled_are_not_entries(self, lm, tmp_path):
        """A temporary package beside the entries (another process's
        compile, not yet renamed) is neither counted nor evicted."""
        _store_copies(lm, tmp_path, ["k0"])
        partial = tmp_path / "aot" / ".tmp.k1.123.456.pt2"
        partial.write_bytes(b"half a package")
        assert compile_cache.executable_count(str(tmp_path)) == 1
        assert compile_cache.prune_executables(tmp_path, capacity=0) == 1
        assert partial.exists()

    def test_a_load_refreshes_recency(self, lm, tmp_path):
        """Loading the oldest entry touches it: pruning to one keeps it."""
        _store_copies(lm, tmp_path, ["old", "new"])
        assert compile_cache.load_executable("old", tmp_path) is not None
        assert compile_cache.prune_executables(tmp_path, capacity=1) == 1
        assert [p.name for p in (tmp_path / "aot").glob("*.pt2")] == \
            ["old.pt2"]

    def test_every_store_prunes_to_cache_capacity(self, lm, tmp_path,
                                                  monkeypatch):
        """Without a capacity a store prunes to the runtime config's
        ``cache_capacity`` (``HOROVOD_CACHE_CAPACITY``), as JAX's does."""
        import horovod_tpu_torch as hvd

        monkeypatch.setenv("HOROVOD_CACHE_CAPACITY", "2")
        hvd.init(device="cpu")
        try:
            for i in range(4):
                _store_copies(lm, tmp_path, [f"k{i}"])
                assert compile_cache.executable_count(str(tmp_path)) == \
                    min(i + 1, 2)
        finally:
            hvd.shutdown()
        assert sorted(p.name for p in (tmp_path / "aot").glob("*.pt2")) \
            == ["k2.pt2", "k3.pt2"]
