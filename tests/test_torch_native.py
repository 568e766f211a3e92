"""The port's native library (``horovod_tpu_torch/native``): built with
``g++`` from its own copy of ``hvd_native.cc`` into ``<repo>/build/``
under a name that hashes the source, the KV store's round trips against
the JAX package's client and server, the native timeline's dropped-event
count, and the fallback when the library does not build."""

import threading
from pathlib import Path

import pytest

from horovod_tpu_torch import native as TN
from horovod_tpu_torch.runtime import compile_cache
from horovod_tpu_torch.utils import timeline as TT
from torch_port_workers import jax_native

ROOT = Path(__file__).resolve().parents[1]


class TestBuild:
    def test_library_is_built_into_build(self):
        """The library loads from the compile cache's store, named after a
        hash of the flags, the port's own source and the toolchain, which
        is not the JAX package's file.  The store is ``<repo>/build/``
        unless ``HOROVOD_COMPILE_CACHE_DIR`` moves it, as the suite's
        conftest does."""
        assert TN.native_built() and TN.native_error() is None
        path = TN.library_path()
        assert path.parent == compile_cache.store_dir() and path.exists()
        assert path.name.startswith("libhvd_torch_native_")
        assert compile_cache.default_dir() == str(ROOT / "build")
        assert TN.library_path(ROOT / "build") == ROOT / "build" / path.name
        assert TN.SRC == ROOT / "horovod_tpu_torch" / "native" / \
            "hvd_native.cc"
        assert not any(p.name.startswith("libhvd_torch_native")
                       for p in TN.SRC.parent.iterdir())

    def test_edited_source_builds_anew(self, tmp_path, monkeypatch):
        """An edited source hashes to another library name, which a load
        then builds."""
        src = tmp_path / "hvd_native.cc"
        src.write_text(TN.SRC.read_text() + "\n// edited\n")
        before = TN.library_path(tmp_path)
        monkeypatch.setattr(TN, "SRC", src)
        after = TN.library_path(tmp_path)
        assert after.name != before.name
        TN._build(after)
        assert after.exists()

    @pytest.mark.parametrize("failure", ["no_compiler", "compile_error"])
    def test_fallback(self, monkeypatch, tmp_path, failure):
        """No ``g++``: the Python writer serves quietly, as in the JAX
        package; a build that fails: it serves too, after a warning that
        names the failure."""
        def fail(path):
            if failure == "no_compiler":
                raise FileNotFoundError("g++ not found")
            raise RuntimeError("g++ failed (1): hvd_native.cc:1: error")

        monkeypatch.setattr(TN, "_lib", None)
        monkeypatch.setattr(TN, "_tried", False)
        monkeypatch.setattr(TN, "_error", None)
        monkeypatch.setattr(TN, "library_path",
                            lambda build_dir=None: tmp_path / "missing.so")
        monkeypatch.setattr(TN, "_build", fail)
        warned = []
        monkeypatch.setattr(TN.hvd_logging, "warning",
                            lambda msg, *a: warned.append(msg % a))
        tl = TT.make_timeline(str(tmp_path / "t.json"))
        tl.close()
        assert type(tl) is TT.Timeline
        assert not TN.native_built()
        if failure == "no_compiler":
            assert TN.native_error() == "g++ not found" and not warned
        else:
            assert "g++ failed" in TN.native_error()
            assert len(warned) == 1 and "g++ failed" in warned[0]
        with pytest.raises(RuntimeError, match="unavailable"):
            TN.NativeTimeline(str(tmp_path / "n.json"))


@pytest.fixture(params=["port_server", "jax_server"])
def kv(request):
    """A running KV server of either package, with a client of each."""
    JN = jax_native()
    if not JN.native_built():
        pytest.fail("the JAX package's native library did not build")
    server = (TN.KvStoreServer if request.param == "port_server"
              else JN.KvStoreServer)(0)
    yield server, TN.KvStoreClient("127.0.0.1", server.port), \
        JN.KvStoreClient("127.0.0.1", server.port)
    server.stop()


class TestKvStore:
    def test_round_trips(self, kv):
        """Set by one package's client, read by the other's: values, the
        key count, a missing key's timeout (None), an overwrite."""
        _, mine, ref = kv
        mine.set("a", b"1")
        ref.set("b", b"\x00" * 70000)
        assert ref.get("a") == b"1"
        assert mine.get("b") == b"\x00" * 70000
        assert mine.num_keys() == ref.num_keys() == 2
        assert mine.get("nope", timeout_ms=50) is None
        assert ref.get("nope", timeout_ms=50) is None
        mine.set("a", b"2")
        assert ref.get("a") == b"2" and mine.num_keys() == 2

    def test_get_waits_for_the_set(self, kv):
        """``get`` blocks until another client publishes the key, the
        rendezvous primitive."""
        _, mine, ref = kv
        got = {}
        t = threading.Thread(target=lambda: got.update(
            v=mine.get("late", timeout_ms=5000)))
        t.start()
        ref.set("late", b"here")
        t.join(timeout=10)
        assert got == {"v": b"here"}


class TestDroppedEvents:
    def test_no_drops_under_contention(self, tmp_path):
        """A ring of 8 slots under four producers of 500 events each: the
        producers wait for the drain, nothing drops, every event is in the
        file."""
        tl = TN.NativeTimeline(str(tmp_path / "c.json"), capacity=8)

        def produce(k):
            for i in range(250):
                tl.start_activity(f"p{k}", "QUEUE")
                tl.end_activity(f"p{k}")

        threads = [threading.Thread(target=produce, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert tl.dropped_events == 0
        tl.close()
        events = TT.load_trace(str(tmp_path / "c.json"))
        assert len(events) == 2000
        assert not any(str(e.get("name", "")).startswith("DROPPED_")
                       for e in events)

    def test_events_after_close_are_no_ops(self, tmp_path):
        """After close every event is dropped silently (a span opened
        before ``stop_timeline`` may close after it), as in the JAX
        package's writer; the file stays whole."""
        for mod in (TN, jax_native()):
            path = tmp_path / f"{mod.__name__}.json"
            tl = mod.NativeTimeline(str(path))
            tl.start_activity("t", "QUEUE")
            tl.close()
            tl.end_activity("t")
            tl.instant("late")
            tl.close()
            assert [e["ph"] for e in TT.load_trace(str(path))] == ["B"]
