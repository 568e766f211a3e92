"""The port's eager plane (``ops/eager.py``, ``ops/op_manager.py``,
``ops/bucketing.Bucketer``): in this process against the JAX package's
eager ops on the same numpy inputs (tests/test_eager.py's cases), and on
spawned gloo worlds of 2 and 4 against numpy (tests/test_multiprocess.py's
scenarios), on both data planes.

Tolerances: in one process fp32 and integers exactly; fp16/bf16 with a
scale within one ulp of the dtype.  Across ranks see
:func:`torch_port_workers.eager_tolerance`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
from horovod_tpu.ops import eager as JE

from torch_port_workers import (
    EAGER_CASES,
    EAGER_CHECKS,
    check_eager_reduction,
    eager_rows,
    spawn_world,
)


@pytest.fixture(scope="module")
def jax_hvd():
    jhvd.init()
    yield jhvd
    JE._in_flight.clear()
    jhvd.shutdown()


@pytest.fixture
def hvd_torch():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


@pytest.fixture(params=["XLA", "HOST"])
def plane(request, hvd_torch):
    cfg = hvd_torch._state.global_state().config
    cfg.tpu_operations = request.param
    return request.param


def _both(jax_hvd, hvd, fn_name, x, **kw):
    """(port result, JAX result) of ``fn_name`` on the numpy ``x``."""
    got = getattr(hvd, fn_name)(torch.from_numpy(np.array(x)), **kw)
    want = getattr(jax_hvd, fn_name)(jnp.asarray(x), **kw)
    return got, np.asarray(want)


def _ulp(dtype) -> float:
    return float(torch.finfo(dtype).eps)


class TestAgainstJax:
    @pytest.mark.parametrize("case", [c for c in EAGER_CASES
                                      if c[0] not in ("i64", "f16")],
                             ids=str)
    def test_allreduce(self, jax_hvd, hvd_torch, plane, case):
        """fp32 and int32 reductions with the cases' ops and scales
        (prescale and postscale 0.0 included): exact."""
        key, op, pre, post = case
        x = eager_rows(0)[key]
        got, want = _both(jax_hvd, hvd_torch, "allreduce", x,
                          op=getattr(hvd_torch.ReduceOp, op.upper()),
                          prescale_factor=pre, postscale_factor=post,
                          name=f"{plane}.{case}")
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
    @pytest.mark.parametrize("scales", [(None, None), (0.5, 3.0),
                                        (3.0, None), (None, 0.1)])
    def test_half_precision_scales(self, jax_hvd, hvd_torch, plane, dtype,
                                   scales):
        """fp16/bf16 widen to fp32 when a scale is given (JAX
        ``_reduce_stacked``) and come back in their own dtype: within one
        ulp of JAX's."""
        pre, post = scales
        x = np.random.RandomState(3).randn(64).astype(np.float32)
        got = hvd_torch.allreduce(torch.from_numpy(x).to(dtype),
                                  prescale_factor=pre, postscale_factor=post)
        want = jax_hvd.allreduce(
            jnp.asarray(x).astype(jnp.dtype(str(dtype).split(".")[1])),
            prescale_factor=pre, postscale_factor=post)
        assert got.dtype == dtype
        want = torch.from_numpy(np.array(want.astype(jnp.float32)))
        torch.testing.assert_close(got.float(), want, rtol=_ulp(dtype),
                                   atol=0)

    def test_int64_metadata_roundtrip(self, hvd_torch):
        """The host metadata exchange keeps int64 (JAX test_eager)."""
        from horovod_tpu_torch.ops.eager import _allgather_host_metadata

        big = np.asarray([945563671418, -7, 2**40 + 3], np.int64)
        np.testing.assert_array_equal(_allgather_host_metadata(big)[0], big)

    def test_int64_allreduce(self, hvd_torch, plane):
        """int64 beyond int32 survives (JAX has no int64 without x64)."""
        x = eager_rows(0)["i64"]
        got = hvd_torch.allreduce(torch.from_numpy(x), op=hvd_torch.Sum)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), x)

    def test_async_handle_lifecycle(self, hvd_torch):
        h = hvd_torch.allreduce_async(torch.ones(2), name="t2")
        assert isinstance(h, hvd_torch.Handle)
        out = hvd_torch.synchronize(h)
        assert hvd_torch.poll(h)
        np.testing.assert_array_equal(out.numpy(), 1.0)

    def test_poll_drains_the_bucket(self, hvd_torch):
        """A submission waits in its bucket until a poll: the poll is the
        cycle edge, and completes it on the CPU."""
        from horovod_tpu_torch.ops.bucketing import global_bucketer

        h = hvd_torch.allreduce_async(torch.ones(3), name="p")
        assert not h._done and global_bucketer()._buckets
        assert hvd_torch.poll(h) and h._done

    def test_async_variants(self, jax_hvd, hvd_torch):
        x = np.arange(4, dtype=np.float32)
        for name, args in (("allgather_async", ()),
                           ("broadcast_async", (0,)),
                           ("alltoall_async", ())):
            h = getattr(hvd_torch, name)(torch.from_numpy(x), *args,
                                         name=f"a.{name}")
            jh = getattr(jax_hvd, name)(jnp.asarray(x), *args,
                                        name=f"a.{name}")
            assert hvd_torch.poll(h)
            np.testing.assert_array_equal(hvd_torch.synchronize(h).numpy(),
                                          np.asarray(jax_hvd.synchronize(jh)))

    def test_duplicate_name(self, jax_hvd, hvd_torch):
        """The reference's text, as the JAX package raises it; the name is
        free again once its handle completed."""
        h1 = hvd_torch.allreduce_async(torch.ones(2), name="dup")
        jh1 = jax_hvd.allreduce_async(jnp.ones((2,)), name="dup")
        with pytest.raises(hvd_torch.HorovodInternalError) as got:
            hvd_torch.allreduce_async(torch.ones(2), name="dup")
        with pytest.raises(jax_hvd.HorovodInternalError) as want:
            jax_hvd.allreduce_async(jnp.ones((2,)), name="dup")
        assert str(got.value) == str(want.value)
        hvd_torch.synchronize(h1)
        jax_hvd.synchronize(jh1)
        hvd_torch.synchronize(hvd_torch.allreduce_async(torch.ones(2),
                                                        name="dup"))

    def test_fusion_groups_many_tensors(self, hvd_torch, monkeypatch):
        """Ten submissions of one key: correct per-tensor results; with
        a 40-byte threshold the Bucketer dispatches at each threshold, in
        submission order (every fourth 12-byte tensor), and the rest at
        synchronize."""
        from horovod_tpu_torch.ops import eager as TE
        from horovod_tpu_torch.ops.bucketing import global_bucketer

        monkeypatch.setattr(hvd_torch._state.global_state().config,
                            "fusion_threshold_bytes", 40)
        groups = []
        real = TE._dispatch_group
        monkeypatch.setattr(TE, "_dispatch_group", lambda entries: (
            groups.append([e.name for e in entries]), real(entries)))
        handles = [hvd_torch.allreduce_async(
            torch.full((3,), float(i)), name=f"fuse.{i}", op=hvd_torch.Sum)
            for i in range(10)]
        assert groups == [[f"fuse.{i}" for i in range(4)],
                          [f"fuse.{i}" for i in range(4, 8)]]
        for i, h in enumerate(handles):
            np.testing.assert_array_equal(hvd_torch.synchronize(h).numpy(),
                                          float(i))
        assert groups[2] == ["fuse.8", "fuse.9"]
        assert global_bucketer().groups == 3

    def test_bucket_keys(self, hvd_torch, monkeypatch):
        """Keys are (op, dtype, prescale, postscale): a flush dispatches
        one group a key, in insertion order."""
        from horovod_tpu_torch.ops import eager as TE

        groups = []
        real = TE._dispatch_group
        monkeypatch.setattr(TE, "_dispatch_group", lambda entries: (
            groups.append([e.name for e in entries]), real(entries)))
        specs = [("a", torch.float32, None), ("b", torch.float16, None),
                 ("c", torch.float32, 2.0), ("d", torch.float32, None),
                 ("e", torch.float16, None)]
        hs = [hvd_torch.allreduce_async(torch.ones(2, dtype=dt), name=n,
                                        prescale_factor=pre)
              for n, dt, pre in specs]
        hvd_torch.synchronize(hs[0])
        assert groups == [["a", "d"], ["b", "e"], ["c"]]

    def test_compression_round_trip(self, jax_hvd, hvd_torch):
        x = np.asarray([1.5, -2.25, 3.0], np.float32)
        got = hvd_torch.allreduce(torch.from_numpy(x),
                                  compression=hvd_torch.Compression.fp16)
        want = jax_hvd.allreduce(jnp.asarray(x),
                                 compression=jax_hvd.Compression.fp16)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_int8_refused(self, jax_hvd, hvd_torch):
        with pytest.raises(ValueError) as got:
            hvd_torch.allreduce(torch.ones(2), name="i8",
                                compression=hvd_torch.Compression.int8)
        with pytest.raises(ValueError) as want:
            jax_hvd.allreduce(jnp.ones((2,)), name="i8",
                              compression=jax_hvd.Compression.int8)
        assert str(got.value) == str(want.value)
        hvd_torch.synchronize(hvd_torch.allreduce_async(torch.ones(2),
                                                        name="i8"))

    @pytest.mark.parametrize("fn,args", [("allgather", ()),
                                         ("broadcast", (0,)),
                                         ("alltoall", ())])
    def test_movement_single(self, jax_hvd, hvd_torch, fn, args):
        x = np.arange(6, dtype=np.float32).reshape(3, 2)
        got = getattr(hvd_torch, fn)(torch.from_numpy(x), *args)
        want = getattr(jax_hvd, fn)(jnp.asarray(x), *args)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_alltoall_bad_splits(self, jax_hvd, hvd_torch):
        with pytest.raises(ValueError) as got:
            hvd_torch.alltoall(torch.arange(6.0), splits=[2, 2])
        with pytest.raises(ValueError) as want:
            jax_hvd.alltoall(jnp.arange(6.0), splits=[2, 2])
        assert str(got.value) == str(want.value)
        with pytest.raises(ValueError, match="splits"):
            hvd_torch.alltoall(torch.arange(6.0), splits=[3, 3])

    def test_join_barrier_single(self, jax_hvd, hvd_torch):
        assert hvd_torch.join() == jax_hvd.join() == 0
        hvd_torch.barrier()

    def test_adasum_single(self, jax_hvd, hvd_torch, plane):
        got, want = _both(jax_hvd, hvd_torch, "allreduce",
                          np.asarray([1.0, 2.0], np.float32),
                          op=hvd_torch.Adasum)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_allgather_object(self, jax_hvd, hvd_torch):
        assert hvd_torch.allgather_object({"r": 0}) == \
            jax_hvd.allgather_object({"r": 0}) == [{"r": 0}]

    def test_current_operations(self, hvd_torch, plane):
        assert hvd_torch.current_operations() == plane

    def test_input_left_as_it_was(self, hvd_torch):
        x = torch.arange(6.0)
        y = hvd_torch.allreduce(x, op=hvd_torch.Sum, prescale_factor=2.0)
        np.testing.assert_array_equal(x.numpy(), np.arange(6.0))
        np.testing.assert_array_equal(y.numpy(), 2 * np.arange(6.0))

    def test_adasum_combine_matches_jax(self):
        """The pairwise combine against JAX's on the same rows (fp32 dot
        products summed in another order: 1e-6)."""
        from horovod_tpu.ops import adasum as JA
        from horovod_tpu_torch.ops import adasum as TA

        rng = np.random.RandomState(4)
        for a, b in ((rng.randn(33), rng.randn(33)),
                     (np.zeros(5), rng.randn(5)),
                     (rng.randn(7), 3 * rng.randn(7))):
            a, b = a.astype(np.float32), b.astype(np.float32)
            got = TA.adasum_pair(torch.from_numpy(a), torch.from_numpy(b))
            want = np.asarray(JA._combine(jnp.asarray(a), jnp.asarray(b)))
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6)


@pytest.fixture(scope="module", params=[2, 4])
def eager_world(request):
    return request.param, spawn_world("run_eager", world=request.param,
                                      timeout=180)


class TestGlooWorlds:
    @pytest.mark.parametrize("plane", ["XLA", "HOST"])
    @pytest.mark.parametrize("i", range(len(EAGER_CASES)))
    def test_allreduce(self, eager_world, plane, i):
        world, outs = eager_world
        check_eager_reduction(outs, world, plane, i)

    @pytest.mark.parametrize("name", sorted(EAGER_CHECKS))
    def test_scenario(self, eager_world, name):
        """Each of tests/test_multiprocess.py's scenarios
        (:data:`torch_port_workers.EAGER_CHECKS`)."""
        world, outs = eager_world
        EAGER_CHECKS[name](outs, world)
