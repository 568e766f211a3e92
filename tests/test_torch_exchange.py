"""The port's gradient exchange: plan_buckets, grouped_allreduce with the
reference's pre/postscale, Average and compression semantics, and the
other collectives and broadcasts — on a world of one in this process and
on a spawned gloo world of two."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.ops import bucketing as JB
from horovod_tpu.ops import collectives as JC
from horovod_tpu_torch.ops import bucketing as TB
from horovod_tpu_torch.ops import collectives as TC

from torch_port_workers import (
    EXCHANGE_CASES,
    check_exchange,
    exchange_inputs,
    spawn_world,
)


@pytest.fixture
def hvd_torch():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


@pytest.fixture(scope="module")
def world_of_two():
    return spawn_world("run_exchange", world=2)


def _run_local(hvd, case):
    op, pre, post, comp = case
    ts = [torch.from_numpy(x) for x in exchange_inputs(0)]
    ts[2] = ts[2].to(torch.bfloat16)
    red = hvd.grouped_allreduce(
        ts, op=TC.ReduceOp[op.upper()], prescale_factor=pre,
        postscale_factor=post,
        compression=getattr(hvd.Compression, comp) if comp else None)
    for r, t in zip(red, ts):
        assert r.dtype == t.dtype and r.shape == t.shape
    return [r.float().numpy() if r.is_floating_point() else r.numpy()
            for r in red]


class TestConfig:
    ENV = {"HOROVOD_RANK": "3", "HOROVOD_SIZE": "8",
           "HOROVOD_LOCAL_RANK": "1", "HOROVOD_LOCAL_SIZE": "2",
           "HOROVOD_CROSS_RANK": "1", "HOROVOD_CROSS_SIZE": "4",
           "HOROVOD_COORDINATOR_ADDR": "localhost:1234",
           "HOROVOD_FUSION_THRESHOLD": "4096",
           "HOROVOD_CYCLE_TIME": "2.5", "HOROVOD_CACHE_CAPACITY": "64",
           "HOROVOD_TPU_OPERATIONS": "host",
           "HOROVOD_EXCHANGE_BUCKET_BYTES": "1048576",
           "HOROVOD_EXCHANGE_HIERARCHY": "FLAT",
           "HOROVOD_EXCHANGE_WIRE_DTYPE": "FP8_E4M3",
           "HOROVOD_EXCHANGE_REDUCTION": "ADASUM",
           "HOROVOD_EXCHANGE_LEVEL_CODECS": "cross=int8,local=fp32",
           "HOROVOD_FUSED_COLLECTIVES": "ON",
           "HOROVOD_SP_LAYOUT": "zigzag",
           "HOROVOD_PLAN": "dp=2,sp=4",
           "HOROVOD_MOE_FUSED_DISPATCH": "on",
           "HOROVOD_MOE_CAPACITY_FACTOR": "2.0",
           "HOROVOD_PREFETCH_DEPTH": "5", "HOROVOD_INPUT_THREADS": "3",
           # read where it is used, as in the JAX package, by no Config
           # field
           "HOROVOD_DEBUG_SPARSE": "1",
           # the launcher's knobs, which no Config
           # field reads, at their defaults (the loggers read theirs once)
           "HOROVOD_CONTROLLER": "gloo", "HOROVOD_SECRET_KEY": "k",
           "HOROVOD_RUN_SECRET": "k",
           "HOROVOD_RUN_SERVICE_ADDR": "127.0.0.1:1",
           "HOROVOD_TPU_DISCOVERY_CACHE_TTL": "600",
           "HOROVOD_LSF_ACCELERATORS_PER_NODE": "4",
           "HOROVOD_LSF_CORES_PER_NODE": "16",
           "HOROVOD_LSF_THREADS_PER_CORE": "1",
           "HOROVOD_LOG_LEVEL": "warning", "HOROVOD_LOG_HIDE_TIME": "0"}

    @pytest.mark.parametrize("set_env", [False, True])
    def test_matches_jax(self, monkeypatch, set_env):
        """Every knob the port reads is a JAX-package knob, parsed to the
        same field value, set and unset."""
        import dataclasses

        from horovod_tpu.runtime import config as JCfg
        from horovod_tpu_torch.runtime import config as TCfg

        assert TCfg.KNOWN_KNOBS <= JCfg.KNOWN_KNOBS
        assert TCfg.KNOWN_KNOBS == set(self.ENV)
        for name in self.ENV:
            monkeypatch.delenv(name, raising=False)
            if set_env:
                monkeypatch.setenv(name, self.ENV[name])
        port = TCfg.Config.from_env()
        ref = JCfg.Config.from_env()
        for field in dataclasses.fields(port):
            assert getattr(port, field.name) == getattr(ref, field.name), \
                field.name


class TestPlanBuckets:
    @pytest.mark.parametrize("nbytes", [[], [4], [10, 20, 30, 40, 50],
                                        [100, 1, 1, 1, 100, 7],
                                        [64, 64, 64, 64]])
    @pytest.mark.parametrize("cap", [None, 0, 1, 60, 64, 128, 10 ** 9])
    @pytest.mark.parametrize("reverse", [True, False])
    def test_matches_jax(self, nbytes, cap, reverse):
        assert TB.plan_buckets(nbytes, cap, reverse) == \
            JB.plan_buckets(nbytes, cap, reverse)


class TestWorldOfOne:
    @pytest.mark.parametrize("case", EXCHANGE_CASES)
    def test_grouped_allreduce(self, hvd_torch, case):
        check_exchange(_run_local(hvd_torch, case), case, world=1)

    @pytest.mark.parametrize("case", [c for c in EXCHANGE_CASES
                                      if c[3] is None and c[0] != "Max"])
    def test_grouped_allreduce_matches_jax(self, hvd_torch, case):
        """Float tensors against the JAX grouped_allreduce on a one-device
        mesh (fp32 1e-6; the bf16 tensor 1e-2)."""
        op, pre, post, _ = case
        xs = exchange_inputs(0)[:3]
        mesh = Mesh(np.array(jax.devices()[:1]), ("i",))
        jop = JC.ReduceOp[op.upper()]

        def body(a, b, c):
            return tuple(JC.grouped_allreduce(
                [a, b, c], op=jop, axis="i", prescale_factor=pre,
                postscale_factor=post))

        want = jax.shard_map(body, mesh=mesh, in_specs=(P(), P(), P()),
                             out_specs=(P(), P(), P()))(
            jnp.asarray(xs[0]), jnp.asarray(xs[1]),
            jnp.asarray(xs[2]).astype(jnp.bfloat16))
        got = _run_local(hvd_torch, case)
        for j, (g, w) in enumerate(zip(got, want)):
            tol = 1e-2 if j == 2 else 1e-6
            np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                       rtol=tol, atol=tol)

    def test_scale_passes_are_fused_scale_launches(self, hvd_torch,
                                                   monkeypatch):
        """Average with no factors scales nothing; predivide-style factors
        give one prescale and one postscale pass per bucket (Average's
        1/size folded in); a wire cast rides the same two passes."""
        calls = []
        real = TC.fused_scale

        def spy(x, factor, out_dtype=None, out=None):
            calls.append((factor, out_dtype or x.dtype))
            return real(x, factor, out_dtype, out=out)

        monkeypatch.setattr(TC, "fused_scale", spy)
        xs = [torch.ones(5), torch.ones(3, 2)]
        hvd_torch.grouped_allreduce(xs)
        assert calls == []
        hvd_torch.grouped_allreduce(xs, prescale_factor=0.5,
                                    postscale_factor=2.0)
        assert calls == [(0.5, torch.float32), (2.0, torch.float32)]
        calls.clear()
        hvd_torch.grouped_allreduce(xs, compression=hvd_torch.Compression.fp16)
        assert calls == [(1.0, torch.float16), (1.0, torch.float32)]

    def test_allreduce_leaves_input(self, hvd_torch):
        x = torch.arange(6.0)
        y = TC.allreduce(x, op=hvd_torch.Sum, prescale_factor=2.0)
        torch.testing.assert_close(x, torch.arange(6.0))
        torch.testing.assert_close(y, 2 * torch.arange(6.0))

    def test_compressors_round_trip(self):
        x = torch.from_numpy(np.random.RandomState(0).randn(33)
                             .astype(np.float32))
        from horovod_tpu_torch.ops.compression import Compression

        for comp, wire in ((Compression.fp16, torch.float16),
                           (Compression.bf16, torch.bfloat16)):
            y, ctx = comp.compress(x)
            assert y.dtype == wire and ctx == torch.float32
            back = comp.decompress(y, ctx)
            assert back.dtype == torch.float32
            torch.testing.assert_close(back, x.to(wire).float())
        y, ctx = Compression.none.compress(x)
        assert y is x and Compression.none.decompress(y, ctx) is x

    def test_identity(self, hvd_torch):
        assert (hvd_torch.rank(), hvd_torch.size()) == (0, 1)
        assert (hvd_torch.local_rank(), hvd_torch.local_size()) == (0, 1)
        assert (hvd_torch.cross_rank(), hvd_torch.cross_size()) == (0, 1)
        assert hvd_torch.device() == torch.device("cpu")


class TestWorldOfTwo:
    @pytest.mark.parametrize("i", range(len(EXCHANGE_CASES)))
    def test_grouped_allreduce(self, world_of_two, i):
        for rank_out in world_of_two:
            check_exchange(rank_out[i], EXCHANGE_CASES[i], world=2)

    def test_allgather(self, world_of_two):
        want = np.concatenate([exchange_inputs(r)[0] for r in range(2)])
        for rank_out in world_of_two:
            np.testing.assert_array_equal(rank_out["allgather"], want)

    def test_broadcast(self, world_of_two):
        for rank_out in world_of_two:
            np.testing.assert_array_equal(rank_out["broadcast"],
                                          exchange_inputs(1)[1])

    def test_broadcast_variables_from_rank0(self, world_of_two):
        want = exchange_inputs(0)
        for rank_out in world_of_two:
            w, b = rank_out["broadcast_variables"]
            np.testing.assert_array_equal(w, want[0])
            np.testing.assert_array_equal(b, want[1])

    def test_broadcast_object(self, world_of_two):
        assert [o["broadcast_object"] for o in world_of_two] == \
            [{"rank": 1}, {"rank": 1}]
