"""``HOROVOD_THREAD_AFFINITY`` in the port (``utils/affinity.py``) against
the JAX package's ``horovod_tpu/utils/affinity.py``: JAX's own cases of
tests/test_affinity.py through the injectable setter, ``parse_affinity``
on the same specs (errors too), and ``init()`` applying the local rank's
set before the process group exists.  No test changes this process's
affinity: the setter, or ``os.sched_setaffinity``, is a recorder."""

import contextlib
import os
import threading

import pytest
import torch.distributed as dist

from horovod_tpu.utils import affinity as JA
from horovod_tpu_torch.utils import affinity as TA


@contextlib.contextmanager
def _older_thread():
    """A thread that runs through the block, made before it starts: its
    native id."""
    started, done = threading.Event(), threading.Event()
    ids = []

    def run():
        ids.append(threading.get_native_id())
        started.set()
        done.wait()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    started.wait()
    try:
        yield ids[0]
    finally:
        done.set()
        t.join()


class TestParse:
    def test_ranges_and_lists(self):
        assert TA.parse_affinity("0-3;4,6;7") == [{0, 1, 2, 3}, {4, 6}, {7}]

    def test_rejects_junk(self):
        with pytest.raises(ValueError):
            TA.parse_affinity("3-1")
        with pytest.raises(ValueError):
            TA.parse_affinity(";")

    @pytest.mark.parametrize("spec", ["0-3;4-7", "0,2;1,3", " 1 , 2-4 ;5",
                                      "7", "0-0;1-1;2-2;3-3", "0,,1;2"])
    def test_matches_jax(self, spec):
        assert TA.parse_affinity(spec) == JA.parse_affinity(spec)

    @pytest.mark.parametrize("spec", ["3-1", ";", "a", "0;", "1-x", ""])
    def test_errors_as_jax(self, spec):
        with pytest.raises(ValueError):
            JA.parse_affinity(spec)
        with pytest.raises(ValueError):
            TA.parse_affinity(spec)


class TestApply:
    def test_local_rank_selects_set(self, monkeypatch):
        monkeypatch.setenv("HOROVOD_THREAD_AFFINITY", "0-1;2-3")
        applied = {}
        assert TA.set_affinity_from_env(
            1, setter=lambda c: applied.update(c=c)) == {2, 3}
        assert applied["c"] == {2, 3}

    def test_too_few_sets_never_shares(self, monkeypatch):
        """A spec shorter than the local world must not silently pin two
        workers to the same cores."""
        monkeypatch.setenv("HOROVOD_THREAD_AFFINITY", "0-1;2-3")
        assert TA.set_affinity_from_env(2, setter=lambda c: 1 / 0) is None

    def test_unset_is_noop(self, monkeypatch):
        monkeypatch.delenv("HOROVOD_THREAD_AFFINITY", raising=False)
        assert TA.set_affinity_from_env(0, setter=lambda c: 1 / 0) is None

    def test_bad_spec_warns_not_raises(self, monkeypatch):
        monkeypatch.setenv("HOROVOD_THREAD_AFFINITY", "not-cores")
        assert TA.set_affinity_from_env(0, setter=lambda c: 1 / 0) is None

    def test_absent_cores_warn_not_raise(self, monkeypatch):
        """A set the host does not have (``sched_setaffinity`` raises
        ``OSError``) is reported and not applied."""
        monkeypatch.setenv("HOROVOD_THREAD_AFFINITY", "4096")

        def refuse(cores):
            raise OSError(22, "Invalid argument")

        assert TA.set_affinity_from_env(0, setter=refuse) is None

    def test_default_setter_pins_every_thread(self, monkeypatch):
        """Without a setter the set goes to the calling thread, then to
        each thread of the process, a thread made earlier among them
        (``os.sched_setaffinity`` recorded, not applied)."""
        monkeypatch.setenv("HOROVOD_THREAD_AFFINITY", "0-1;2-3")
        calls = []
        monkeypatch.setattr(os, "sched_setaffinity",
                            lambda pid, cores: calls.append((pid, cores)))
        with _older_thread() as older:
            assert TA.set_affinity_from_env(1) == {2, 3}
        assert calls[0] == (0, {2, 3})
        assert all(cores == {2, 3} for _, cores in calls)
        assert {older, threading.get_native_id()} <= {
            pid for pid, _ in calls[1:]}

    def test_thread_that_ended_is_passed_over(self, monkeypatch):
        """A thread that ends between the listing and its turn does not
        stop the others from being pinned."""
        calls = []

        def setaffinity(pid, cores):
            calls.append(pid)
            if len(calls) == 2:     # the listing's first thread ended
                raise ProcessLookupError(3, "No such process")

        monkeypatch.setattr(os, "sched_setaffinity", setaffinity)
        TA.pin_process({0})
        assert calls[0] == 0
        assert len(calls) == 1 + len(os.listdir("/proc/self/task"))

    @pytest.mark.parametrize("spec,rank", [("0-1;2-3", 0), ("0-1;2-3", 1),
                                           ("0-1;2-3", 2), ("x", 0),
                                           (None, 0)])
    def test_matches_jax(self, monkeypatch, spec, rank):
        """The set each package applies, and what it returns, for the
        same knob and local rank."""
        if spec is None:
            monkeypatch.delenv("HOROVOD_THREAD_AFFINITY", raising=False)
        else:
            monkeypatch.setenv("HOROVOD_THREAD_AFFINITY", spec)
        got, want = [], []
        assert TA.set_affinity_from_env(rank, setter=got.append) == \
            JA.set_affinity_from_env(rank, setter=want.append)
        assert got == want


class TestInit:
    @pytest.mark.parametrize("local_rank,want", [(0, {0}), (1, {1, 2})])
    def test_applied_before_the_process_group(self, monkeypatch,
                                              local_rank, want):
        """``init(device="cpu")`` applies the local rank's set through
        ``os.sched_setaffinity`` (recorded here, not applied) before
        ``dist.init_process_group`` makes the world: to the calling
        thread first, then to every thread of the process, one made
        before ``init()`` among them."""
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.runtime.config import Config

        order = []
        real_init = dist.init_process_group
        monkeypatch.setenv("HOROVOD_THREAD_AFFINITY", "0;1-2")
        monkeypatch.setattr(os, "sched_setaffinity",
                            lambda pid, cores: order.append(
                                ("affinity", pid, set(cores))))

        def init_group(*args, **kwargs):
            order.append(("group",))
            return real_init(*args, **kwargs)

        monkeypatch.setattr(dist, "init_process_group", init_group)
        cfg = Config.from_env()
        cfg.local_rank, cfg.local_size = local_rank, 2
        with _older_thread() as older:
            hvd.init(device="cpu", config=cfg)
        try:
            assert order[0] == ("affinity", 0, want)
            assert order[-1] == ("group",)
            pinned = order[1:-1]
            assert all(o[0] == "affinity" and o[2] == want for o in pinned)
            assert {older, threading.get_native_id()} <= {o[1]
                                                          for o in pinned}
            assert hvd.local_rank() == local_rank
        finally:
            hvd.shutdown()
