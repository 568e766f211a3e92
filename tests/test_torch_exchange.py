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
           # the compile cache's store and the chaos layer's plan: Config
           # fields; the core sets are read where they are used (init()
           # applies them), as in the JAX package
           "HOROVOD_COMPILE_CACHE": "0",
           "HOROVOD_COMPILE_CACHE_DIR": "/tmp/hvd_cc",
           "HOROVOD_FAULT_PLAN": "seed=3;mode=sim",
           "HOROVOD_THREAD_AFFINITY": "0-1;2-3",
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
           "HOROVOD_LOG_LEVEL": "warning", "HOROVOD_LOG_HIDE_TIME": "0",
           # the elastic runtime's: HOROVOD_ELASTIC is a Config field, the
           # rest are read where they are used, as in the JAX package
           "HOROVOD_ELASTIC": "1",
           "HOROVOD_ELASTIC_DRIVER_ADDR": "127.0.0.1:1",
           "HOROVOD_ELASTIC_NOTIFY_ADDR": "127.0.0.1:2",
           "HOROVOD_ELASTIC_GENERATION": "3",
           "HOROVOD_ELASTIC_START_TIMEOUT": "120",
           "HOROVOD_ELASTIC_HEARTBEAT_TIMEOUT": "10",
           "HOROVOD_ELASTIC_HEARTBEAT_INTERVAL": "1",
           "HOROVOD_ELASTIC_HEARTBEAT_SUSPECT_MISSES": "3",
           "HOROVOD_ELASTIC_HEARTBEAT_DEAD_S": "30",
           "HOROVOD_ELASTIC_PROGRESS_TIMEOUT_S": "0",
           "HOROVOD_ELASTIC_DEPART_GRACE_S": "60",
           "HOROVOD_ELASTIC_STRAGGLER_RATIO": "0",
           "HOROVOD_QUARANTINE_BASE_S": "30",
           "HOROVOD_QUARANTINE_MAX_S": "600",
           "HOROVOD_QUARANTINE_PROBATION_S": "300",
           "HOROVOD_QUARANTINE_DISABLE": "0",
           "HOROVOD_HOSTNAME": "host-a",
           # the runtime tools': Config fields, but HOROVOD_TIMELINE_PYTHON,
           # which the timeline's maker reads, as in the JAX package
           "HOROVOD_TIMELINE": "/tmp/tl.json",
           "HOROVOD_TIMELINE_MARK_CYCLES": "1",
           "HOROVOD_TIMELINE_PYTHON": "1",
           "HOROVOD_STALL_CHECK_DISABLE": "1",
           "HOROVOD_STALL_CHECK_TIME_SECONDS": "7.5",
           "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS": "30",
           "HOROVOD_AUTOTUNE": "1", "HOROVOD_AUTOTUNE_LOG": "/tmp/at.csv",
           "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "2",
           "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "4",
           "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE": "0.5",
           "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "3",
           "HOROVOD_METRICS": "1", "HOROVOD_METRICS_PORT": "9090",
           "HOROVOD_METRICS_LOG": "/tmp/m.jsonl",
           "HOROVOD_METRICS_INTERVAL_S": "2.5", "HOROVOD_RUN_ID": "run-a",
           # the hardware model's and the memory plane's: Config fields;
           # the degrade knobs are read where they are used, as in the
           # JAX package
           "HOROVOD_CALIBRATION_PATH": "/tmp/cal.json",
           "HOROVOD_HW_PRESET": "h100",
           "HOROVOD_DEGRADE": "1", "HOROVOD_DEGRADE_WAIT_S": "7",
           "HOROVOD_DEGRADE_MIN_DATA_EXTENT": "2",
           "HOROVOD_DEGRADE_PROMOTE": "0",
           "HOROVOD_REMAT_POLICY": "dots",
           "HOROVOD_HBM_BUDGET_BYTES": "1000000000",
           "HOROVOD_OFFLOAD_OPTIMIZER": "1", "HOROVOD_OFFLOAD_DEPTH": "3",
           # the guard's: Config fields; the serving plane's are read
           # where they are used, as in the JAX package
           "HOROVOD_GUARD": "1", "HOROVOD_GUARD_POLICY": "Skip_Step",
           "HOROVOD_GUARD_CHECK_INTERVAL": "4",
           "HOROVOD_GUARD_ZSCORE": "3.5",
           "HOROVOD_GUARD_WARMUP_STEPS": "2", "HOROVOD_GUARD_EMA": "0.9",
           "HOROVOD_GUARD_PREEMPT": "0",
           "HOROVOD_SERVE_QUEUE_DEPTH": "64",
           "HOROVOD_SERVE_MAX_REQUEUES": "2",
           "HOROVOD_SERVE_MAX_BATCH": "4",
           "HOROVOD_SERVE_DRAIN_TIMEOUT_S": "3",
           "HOROVOD_SERVE_SCALE_UP_DEPTH": "16",
           "HOROVOD_SERVE_SCALE_DOWN_DEPTH": "1",
           "HOROVOD_SERVE_OVERLOAD_FRACTION": "0.5",
           "HOROVOD_SERVE_REFRESH_VERIFY": "0",
           "HOROVOD_SERVE_SCALE_HOLD_S": "2",
           "HOROVOD_SERVE_SCALE_COOLDOWN_S": "10",
           "HOROVOD_SERVE_SCALE_MIN_REPLICAS": "1",
           "HOROVOD_SERVE_SCALE_MAX_REPLICAS": "4"}

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
