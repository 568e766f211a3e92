"""The port's sharded exchange against the JAX package: the collective
primitives it stands on, the shared-scale int8/fp8 codec with error
feedback, the fusion plan, and ZeRO-style training
(``shard_optimizer_states=True``) against the replicated path and against
JAX's flat sharded exchange.  Worlds of 2 and 4 run on gloo, spawned once
each (``run_zero`` in ``tests/torch_port_workers.py``); the JAX references
run under ``shard_map`` over a one-axis mesh of as many CPU devices."""

import copy

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.models import transformer as JT
from horovod_tpu.ops import collectives as JC
from horovod_tpu.runtime import topology as JTopo
from horovod_tpu_torch.models import transformer as TT
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.ops import collectives as TC
from horovod_tpu_torch.runtime import topology as TTopo

from torch_port_workers import (
    A2A_CASES,
    MLP_CASES,
    RS_CASES,
    WIRES,
    assert_adam_close,
    codec_segments,
    mlp_batch,
    mlp_frozen,
    mlp_micro_steps,
    mlp_params,
    mlp_train,
    run_train,
    spawn_world,
    zero_inputs,
)

from test_torch_train_step import (  # noqa: F401 - fixture
    SIZES,
    _tokens,
    hvd_torch,
)

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def worlds():
    return {w: spawn_world("run_zero", world=w, timeout=240)
            for w in WORLDS}


def jax_map(world, fn, *arrays):
    """``fn`` on each of ``world`` CPU devices (axis ``"i"``), each given
    its row of every stacked input; returns each output stacked over
    ranks as numpy."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("i",))

    def body(*xs):
        out = fn(*[x[0] for x in xs])
        return jax.tree_util.tree_map(lambda y: y[None], out)

    res = jax.jit(jax.shard_map(body, mesh=mesh,
                                in_specs=tuple(P("i") for _ in arrays),
                                out_specs=P("i"), check_vma=False))(
        *[jnp.asarray(a) for a in arrays])
    return jax.tree_util.tree_map(np.asarray, res)


def each_rank(results, key):
    return [r[key] for r in results]


# ---------------------------------------------------------------------------
# primitives: exact at worlds 2 and 4
# ---------------------------------------------------------------------------

class TestPrimitives:
    @pytest.mark.parametrize("world", WORLDS)
    @pytest.mark.parametrize("case", RS_CASES)
    def test_reducescatter(self, worlds, world, case):
        op, d = case
        want = jax_map(world, lambda x: JC.reducescatter(
            x, op=JC.ReduceOp[op.upper()], axis="i", scatter_dimension=d),
            zero_inputs(world)["rs"])
        for r, got in enumerate(each_rank(worlds[world], ("rs",) + case)):
            np.testing.assert_array_equal(got, want[r])

    @pytest.mark.parametrize("world", WORLDS)
    def test_reducescatter_int(self, worlds, world):
        want = jax_map(world, lambda x: JC.reducescatter(x, axis="i"),
                       zero_inputs(world)["rs_int"])
        for r, got in enumerate(each_rank(worlds[world], "rs_int")):
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want[r])

    @pytest.mark.parametrize("world", WORLDS)
    def test_allgather_tiled_and_stacked(self, worlds, world):
        x = zero_inputs(world)["ag"]
        tiled = jax_map(world, lambda v: JC.allgather(v, axis="i"), x)
        stacked = jax_map(world, lambda v: JC.allgather(v, axis="i",
                                                        tiled=False), x)
        for r, (t, s) in enumerate(each_rank(worlds[world], "ag")):
            np.testing.assert_array_equal(t, tiled[r])
            np.testing.assert_array_equal(s, stacked[r])

    @pytest.mark.parametrize("world", WORLDS)
    def test_allgather_v(self, worlds, world):
        """Rank r contributes r + 1 rows of at most 5: the padded gather,
        the counts, the mask and the compaction."""
        v = zero_inputs(world)["v"]
        rows = np.stack([np.where(np.arange(5)[:, None] <= r, v[r], 0)
                         for r in range(world)]).astype(np.float32)
        want_g, want_c = jax_map(
            world, lambda x, n: JC.allgather_v(x, n[0], 5, axis="i"),
            rows, np.arange(1, world + 1, dtype=np.int32)[:, None])
        for r, (g, c, compact, mask) in enumerate(
                each_rank(worlds[world], "agv")):
            np.testing.assert_array_equal(g, want_g[r])
            np.testing.assert_array_equal(c, want_c[r])
            np.testing.assert_array_equal(
                compact, JC.allgather_v_compact(want_g[r], want_c[r]))
            np.testing.assert_array_equal(
                mask, np.asarray(JC.allgather_v_mask(jnp.asarray(c), 5)))

    @pytest.mark.parametrize("world", WORLDS)
    @pytest.mark.parametrize("case", A2A_CASES)
    def test_alltoall(self, worlds, world, case):
        s, c = case
        want = jax_map(world, lambda x: JC.alltoall(
            x, axis="i", split_axis=s, concat_axis=c),
            zero_inputs(world)["a2a"])
        for r, got in enumerate(each_rank(worlds[world], ("a2a",) + case)):
            np.testing.assert_array_equal(got, want[r])

    @pytest.mark.parametrize("world", WORLDS)
    def test_alltoall_v(self, worlds, world):
        inp = zero_inputs(world)
        want_x, want_c = jax_map(world, lambda x, n: JC.alltoall_v(
            x, n, 4, axis="i"), inp["a2av"], inp["a2av_counts"])
        for r, (x, c) in enumerate(each_rank(worlds[world], "a2av")):
            np.testing.assert_array_equal(x, want_x[r])
            np.testing.assert_array_equal(c, want_c[r])

    @pytest.mark.parametrize("world", WORLDS)
    @pytest.mark.parametrize("kind", ["bits32", "bits64", "bool"])
    @pytest.mark.parametrize("fn", ["and", "or"])
    def test_bitwise(self, worlds, world, kind, fn):
        """int32, int64 words with the sign bit set, and bool: the bits
        summed and repacked, held to JAX and to numpy's reduction."""
        x = zero_inputs(world)[kind]
        jfn = JC.bitwise_and if fn == "and" else JC.bitwise_or
        want = jax_map(world, lambda v: jfn(v, axis="i"), x) \
            if kind != "bits64" else None
        npfn = np.bitwise_and if fn == "and" else np.bitwise_or
        exact = npfn.reduce(x, axis=0)
        for r, got in enumerate(each_rank(worlds[world], (fn, kind))):
            assert got.dtype == x.dtype
            np.testing.assert_array_equal(got, exact)
            if want is not None:        # JAX runs without 64-bit words
                np.testing.assert_array_equal(got, want[r])

    @pytest.mark.parametrize("world", WORLDS)
    def test_bitwise_and_low_bits(self, worlds, world):
        x = zero_inputs(world)["bits32"]
        want = jax_map(world, lambda v: JC.bitwise_and(v, axis="i",
                                                       nbits=12), x)
        for r, got in enumerate(each_rank(worlds[world], "and_low")):
            np.testing.assert_array_equal(got, want[r])

    def test_bitwise_uses_no_bitwise_reduce_op(self):
        """NCCL has no BAND/BOR: the port sums bits instead."""
        import inspect

        src = inspect.getsource(TC)
        assert "ReduceOp.BAND" not in src and "ReduceOp.BOR" not in src


# ---------------------------------------------------------------------------
# the codec: bit-exact against JAX, residuals too
# ---------------------------------------------------------------------------

def _segments(world, segmented):
    return codec_segments(world) if segmented else ()


class TestCodec:
    @pytest.mark.parametrize("world", WORLDS)
    @pytest.mark.parametrize("wire", WIRES)
    @pytest.mark.parametrize("segmented", [False, True])
    def test_quantized_allreduce(self, worlds, world, wire, segmented):
        sg = _segments(world, segmented)
        want = jax_map(world, lambda x: JC.quantized_allreduce(
            x, axis="i", segments=sg, wire_dtype=wire),
            zero_inputs(world)["codec"])
        for r, got in enumerate(each_rank(worlds[world], ("qar", wire, sg))):
            np.testing.assert_array_equal(got, want[r])

    @pytest.mark.parametrize("world", WORLDS)
    @pytest.mark.parametrize("wire", WIRES)
    @pytest.mark.parametrize("segmented", [False, True])
    def test_quantized_reducescatter(self, worlds, world, wire, segmented):
        sg = _segments(world, segmented)
        want = jax_map(world, lambda x: JC.quantized_reducescatter(
            x, axis="i", op=JC.Sum, segments=sg, wire_dtype=wire),
            zero_inputs(world)["codec"])
        for r, got in enumerate(each_rank(worlds[world], ("qrs", wire, sg))):
            np.testing.assert_array_equal(got, want[r])

    @pytest.mark.parametrize("world", WORLDS)
    @pytest.mark.parametrize("wire", WIRES)
    @pytest.mark.parametrize("segmented", [False, True])
    def test_ef_quantized_reducescatter(self, worlds, world, wire,
                                        segmented):
        """With a carried residual and without one: the shard and the new
        residual, bit for bit."""
        sg = _segments(world, segmented)
        inp = zero_inputs(world)
        want = jax_map(world, lambda x, res: JC.ef_quantized_reducescatter(
            x, axis="i", residual=res, segments=sg, wire_dtype=wire),
            inp["codec"], inp["resid"])
        want0 = jax_map(world, lambda x: JC.ef_quantized_reducescatter(
            x, axis="i", segments=sg, wire_dtype=wire), inp["codec"])
        for r, (y, res, y0, res0) in enumerate(
                each_rank(worlds[world], ("ef", wire, sg))):
            np.testing.assert_array_equal(y, want[0][r])
            np.testing.assert_array_equal(res, want[1][r])
            np.testing.assert_array_equal(y0, want0[0][r])
            np.testing.assert_array_equal(res0, want0[1][r])

    @pytest.mark.parametrize("world", WORLDS)
    def test_grouped_allreduce_int8(self, worlds, world):
        """The replicated path's int8 wire: a scale per tensor, bit-exact
        with JAX's grouped_allreduce(quantized_bits=8)."""
        c = zero_inputs(world)["codec"]
        want = jax_map(world, lambda x: JC.grouped_allreduce(
            [x[:5], x[5:16], x[16:]], op=JC.Average, axis="i",
            quantized_bits=8), c)
        for r, got in enumerate(each_rank(worlds[world], "gar_int8")):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w[r])
        # the small tensor keeps its own scale (not rounded to zero)
        assert np.any(worlds[world][0]["gar_int8"][1] != 0)

    @pytest.mark.parametrize("world", WORLDS)
    def test_integer_group_stays_exact(self, worlds, world):
        x = zero_inputs(world)["rs_int"]
        for got in each_rank(worlds[world], "gar_int8_int"):
            np.testing.assert_array_equal(got, x.sum(axis=0))

    def test_world_of_one_matches_jax(self, hvd_torch):
        """Every codec function in this process at a world of one."""
        c = zero_inputs(1)["codec"]
        res = zero_inputs(1)["resid"]
        for wire in WIRES:
            for sg in ((), codec_segments(1)):
                want = jax_map(1, lambda x, r: JC.ef_quantized_reducescatter(
                    x, axis="i", residual=r, segments=sg, wire_dtype=wire),
                    c, res)
                y, r = TC.ef_quantized_reducescatter(
                    torch.from_numpy(c[0]), residual=torch.from_numpy(
                        res[0].copy()), segments=sg, wire_dtype=wire)
                np.testing.assert_array_equal(y.numpy(), want[0][0])
                np.testing.assert_array_equal(r.numpy(), want[1][0])
                want = jax_map(1, lambda x: JC.quantized_allreduce(
                    x, axis="i", segments=sg, wire_dtype=wire), c)
                np.testing.assert_array_equal(TC.quantized_allreduce(
                    torch.from_numpy(c[0]), segments=sg,
                    wire_dtype=wire).numpy(), want[0])

    def test_wire_dtype_knob(self, monkeypatch):
        monkeypatch.setenv("HOROVOD_EXCHANGE_WIRE_DTYPE", "FP8_E4M3")
        assert TC._resolve_wire_dtype(None) == \
            JC._resolve_wire_dtype(None) == "fp8_e4m3"
        monkeypatch.setenv("HOROVOD_EXCHANGE_REDUCTION", "adasum")
        assert TC._resolve_reduction(None) == "adasum"
        with pytest.raises(ValueError):
            TC._resolve_wire_dtype("int4")
        with pytest.raises(ValueError):
            TC._resolve_reduction("mean")

    @pytest.mark.parametrize("fn", ["quantized_allreduce",
                                    "quantized_reducescatter",
                                    "ef_quantized_reducescatter"])
    def test_codec_guards(self, hvd_torch, fn):
        x = torch.ones(4)
        with pytest.raises(ValueError, match="8-bit"):
            getattr(TC, fn)(x, bits=4)
        with pytest.raises(ValueError, match="Sum/Average"):
            getattr(TC, fn)(x, op=TC.ReduceOp.MAX)
        with pytest.raises(ValueError, match="partition"):
            getattr(TC, fn)(x, segments=(1, 2))


# ---------------------------------------------------------------------------
# the fusion plan
# ---------------------------------------------------------------------------

SPEC_LEAVES = [((3, 7), "float32"), ((11,), "float32"), ((5,), "bfloat16"),
               ((4, 4), "int32"), ((2, 3, 5), "float32"), ((1,), "bfloat16")]


class TestFusionSpec:
    @pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
    @pytest.mark.parametrize("cap", [None, 0, 16, 64, 100, 1 << 20])
    def test_matches_jax(self, world, cap):
        tl = [torch.zeros(s, dtype=getattr(torch, d)) for s, d in SPEC_LEAVES]
        jl = [jnp.zeros(s, getattr(jnp, d)) for s, d in SPEC_LEAVES]
        got = TC.make_fusion_spec(tl, world, cap)
        want = JC.make_fusion_spec(jl, world, cap)
        assert (got.world, got.num_leaves) == (want.world, want.num_leaves)
        assert len(got.groups) == len(want.groups)
        for g, w in zip(got.groups, want.groups):
            for field in ("key", "dtype", "indices", "sizes", "shapes",
                          "padded", "shard"):
                assert getattr(g, field) == getattr(w, field), field

    def test_local_shards_and_allgather_invert(self, hvd_torch):
        tl = [torch.arange(float(np.prod(s))).reshape(s) + 100 * i
              for i, (s, _) in enumerate(SPEC_LEAVES)]
        spec = TC.make_fusion_spec(tl, 1, 64)
        shards = TC.local_fusion_shards(tl, spec)
        for g in spec.groups:
            assert shards[g.key].shape == (g.shard,)
        back = TC.grouped_allgather(shards, spec)
        for a, b in zip(back, tl):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the sharded exchange in training
# ---------------------------------------------------------------------------

def _close(got, want, rtol, atol):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


#: (sharded case, replicated twin, rtol, atol): tests/test_optimizer.py's
#: own limits for the sharded against the replicated path
PAIRS = [("adamw", "adamw_dense", 1e-5, 1e-6),
         ("adamw_b64", "adamw_dense", 1e-5, 1e-6),
         ("adamw_b64_on", "adamw_dense", 1e-5, 1e-6),
         ("sgdm", "sgdm_dense", 1e-6, 1e-7),
         ("int8", "adamw3_dense", 0, 0.02),
         ("int8_ef", "adamw3_dense", 0, 0.02),
         ("fp8_ef", "adamw3_dense", 0, 0.02)]


@pytest.fixture(scope="module")
def world_of_one():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        return {name: mlp_train(hvd, name) for name in MLP_CASES}, \
            (mlp_micro_steps(hvd, True), mlp_micro_steps(hvd, False)), \
            (mlp_frozen(hvd, True), mlp_frozen(hvd, False))
    finally:
        hvd.shutdown()


class TestShardedTraining:
    @pytest.mark.parametrize("pair", PAIRS, ids=lambda p: p[0])
    def test_world_of_one(self, world_of_one, pair):
        sharded, dense, rtol, atol = pair
        (ls, ps), (ld, pd) = world_of_one[0][sharded], world_of_one[0][dense]
        assert np.isfinite(ls)
        _close(ps, pd, rtol, atol)

    @pytest.mark.parametrize("world", WORLDS)
    @pytest.mark.parametrize("pair", PAIRS, ids=lambda p: p[0])
    def test_gloo_world(self, worlds, world, pair):
        sharded, dense, rtol, atol = pair
        for rank_out in worlds[world]:
            (ls, ps), (ld, pd) = rank_out[("mlp", sharded)], \
                rank_out[("mlp", dense)]
            assert np.isfinite(ls)
            if atol < 0.02:
                assert abs(ls - ld) < 1e-5
            _close(ps, pd, rtol, atol)
        # every rank holds the same parameters
        first = worlds[world][0][("mlp", sharded)][1]
        for rank_out in worlds[world][1:]:
            _close(rank_out[("mlp", sharded)][1], first, 0, 0)

    def test_sharded_state_is_a_shard(self, hvd_torch):
        """The inner optimizer holds one flat tensor a group, of the
        group's padded length over the world, and no state of the user's
        optimizer is made."""
        model = torch.nn.ParameterDict({
            k: torch.nn.Parameter(torch.from_numpy(v.copy()))
            for k, v in mlp_params().items()})
        user = torch.optim.AdamW(model.parameters(), lr=1e-2)
        opt = hvd_torch.DistributedOptimizer(
            user, shard_optimizer_states=True, exchange_bucket_bytes=64)
        for p in model.values():
            p.grad = torch.ones_like(p)
        opt.step()
        st = opt.sharded_state
        assert [g.key for g in opt.spec.groups] == list(st.shards)
        for g in opt.spec.groups:
            assert st.inner.state[st.shards[g.key]]["exp_avg"].shape == \
                (g.shard,)
        assert not user.state
        assert opt.state_dict()["inner"]["state"]

    def test_state_dict_round_trip(self, hvd_torch):
        def build():
            model = torch.nn.ParameterDict({
                k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                for k, v in mlp_params().items()})
            return model, hvd_torch.DistributedOptimizer(
                torch.optim.AdamW(model.parameters(), lr=1e-2),
                shard_optimizer_states=True,
                compression=hvd_torch.Compression.int8, error_feedback=True)

        x, y = mlp_batch()
        batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
        a, opt_a = build()
        from torch_port_workers import mlp_loss

        mlp_loss(a, batch).backward()
        opt_a.step()
        b, opt_b = build()
        b.load_state_dict(a.state_dict())
        # a copy, as a checkpoint holds: torch's load_state_dict keeps the
        # tensors it is given
        opt_b.load_state_dict(copy.deepcopy(opt_a.state_dict()))
        for m, o in ((a, opt_a), (b, opt_b)):
            o.zero_grad()
            mlp_loss(m, batch).backward()
            o.step()
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)

    def test_micro_steps_world_of_one(self, world_of_one):
        sharded, dense = world_of_one[1]
        _close(sharded, dense, 1e-5, 1e-6)

    @pytest.mark.parametrize("world", WORLDS)
    def test_micro_steps_gloo_world(self, worlds, world):
        """backward_passes_per_step=2 through the plain optimizer wrapper:
        accumulate, then one sharded exchange and update."""
        for rank_out in worlds[world]:
            sharded, dense = rank_out["micro"]
            _close(sharded, dense, 1e-5, 1e-6)

    @pytest.mark.parametrize("world", (1,) + WORLDS)
    def test_fused_collectives_changes_nothing(self, world_of_one, worlds,
                                               world):
        """fused_collectives="on" is accepted and runs the same exchange,
        bit for bit."""
        runs = [world_of_one[0]] if world == 1 else \
            [{n: r[("mlp", n)] for n in MLP_CASES} for r in worlds[world]]
        for run in runs:
            on, auto = run["adamw_b64_on"][1], run["adamw_b64"][1]
            for k in auto:
                np.testing.assert_array_equal(on[k], auto[k])

    @pytest.mark.parametrize("world", (1,) + WORLDS)
    def test_frozen_parameter(self, world_of_one, worlds, world):
        """A parameter frozen before the optimizer is built stays out of
        the sharded plan and unchanged under AdamW's weight decay, as on
        the replicated path; the others match that path within
        tests/test_optimizer.py's AdamW limits."""
        runs = [world_of_one[2]] if world == 1 else \
            [r["frozen"] for r in worlds[world]]
        w1 = mlp_params()["w1"]
        for (sharded, n_leaves), (dense, _) in runs:
            assert n_leaves == 3
            np.testing.assert_array_equal(sharded["w1"], w1)
            np.testing.assert_array_equal(dense["w1"], w1)
            _close(sharded, dense, 1e-5, 1e-6)

    @pytest.mark.parametrize("world", WORLDS)
    def test_init_keeps_each_ranks_shard_state(self, worlds, world):
        """init broadcasts parameters only: each rank's moments are its
        own shard's, unchanged by init and unlike rank 0's."""
        states = each_rank(worlds[world], "init")
        for before, after in states:
            for b, a in zip(before, after):
                np.testing.assert_array_equal(a, b)
        assert any(not np.array_equal(s[0][0], states[0][0][0])
                   for s in states[1:])


@pytest.fixture(scope="module")
def jax_mlp():
    """JAX's flat sharded exchange on the MLP at worlds 2 and 4: each
    case's steps of DistributedOptimizer(shard_optimizer_states=True,
    hierarchy="flat") inside one shard_map, on the rows each rank owns."""
    x, y = mlp_batch()
    params0 = {k: jnp.asarray(v) for k, v in mlp_params().items()}

    def loss_fn(params, xb, yb):
        h = jnp.tanh(xb @ params["w1"] + params["b1"])
        return jnp.mean((h @ params["w2"] + params["b2"] - yb) ** 2)

    out = {}
    for world in WORLDS:
        for name in ("adamw", "int8_ef"):
            _, steps, kw = MLP_CASES[name]

            def body(xb, yb, steps=steps, kw=kw):
                tx = jhvd.DistributedOptimizer(
                    optax.adamw(1e-2), axis="i", hierarchy="flat",
                    shard_optimizer_states=True,
                    exchange_bucket_bytes=kw.get("exchange_bucket_bytes"),
                    compression=jhvd.Compression.int8
                    if "compression" in kw else None,
                    error_feedback=kw.get("error_feedback", False))
                params = params0
                state = tx.init(params)
                for _ in range(steps):
                    g = jax.grad(loss_fn)(params, xb, yb)
                    upd, state = tx.update(g, state, params)
                    params = optax.apply_updates(params, upd)
                return params

            mesh = Mesh(np.array(jax.devices()[:world]), ("i",))
            res = jax.jit(jax.shard_map(
                body, mesh=mesh, in_specs=(P("i"), P("i")), out_specs=P(),
                check_vma=False))(jnp.asarray(x), jnp.asarray(y))
            out[(world, name)] = {k: np.asarray(v) for k, v in res.items()}
    return out


#: the int8 wire with error feedback against JAX's, 3 AdamW steps of the
#: MLP: over ten (weights, batch) seeds at worlds 2 and 4 the port's
#: parameters lay at most 1.3e-6 from JAX's (2.4e-7 but in one run); with
#: the residual dropped they lay 2.0e-4 to 1.1e-2 away
INT8_EF_ATOL = 1e-5


class TestAgainstJaxShardedExchange:
    @pytest.mark.parametrize("world", WORLDS)
    @pytest.mark.parametrize("name", ["adamw", "int8_ef"])
    def test_mlp(self, worlds, jax_mlp, world, name):
        """fp32 AdamW: within torch's and optax's AdamW difference (the
        parity limit of tests/test_torch_train_step.py); the int8 wire with
        error feedback: :data:`INT8_EF_ATOL`, which the run without error
        feedback must exceed tenfold."""
        want = jax_mlp[(world, name)]
        steps = MLP_CASES[name][1]
        for rank_out in worlds[world]:
            got = rank_out[("mlp", name)][1]
            for k in want:
                if name == "adamw":
                    assert_adam_close(got[k], want[k], k, steps=steps,
                                      lr=1e-2)
                else:
                    np.testing.assert_allclose(got[k], want[k], rtol=0,
                                               atol=INT8_EF_ATOL, err_msg=k)
            if name == "int8_ef":
                no_ef = rank_out[("mlp", "int8")][1]
                assert max(np.abs(no_ef[k] - want[k]).max()
                           for k in want) > 10 * INT8_EF_ATOL


@pytest.fixture(scope="module")
def jax_sharded_run():
    """Three optax.adamw(3e-4) steps of JAX's DistributedTrainStep with
    the flat sharded exchange on the conftest CPU mesh (8 devices),
    global batch 8."""
    jhvd.init()
    try:
        model = JT.TransformerLM(JT.TransformerConfig(
            dtype=jnp.float32, attention_impl="dense", **SIZES))
        variables = model.init(jax.random.PRNGKey(1),
                               jnp.zeros((1, 32), jnp.int32))
        params0 = jax.tree_util.tree_map(np.asarray,
                                         flax.core.meta.unbox(variables))

        def loss_fn(params, batch):
            logits = model.apply(params, batch["inputs"])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, batch["labels"]).mean()

        step = jhvd.DistributedTrainStep(
            loss_fn, optax.adamw(3e-4), mode="shard_map",
            shard_optimizer_states=True, hierarchy="flat")
        params, opt_state = step.init(params0)
        tok = _tokens()
        batch = step.shard_batch({"inputs": tok[:, :-1],
                                  "labels": tok[:, 1:]})
        losses = []
        for _ in range(3):
            params, opt_state, loss = step(params, opt_state, batch)
            losses.append(float(loss))
        final = jax.tree_util.tree_map(np.asarray, params)
    finally:
        jhvd.shutdown()
    return params0, losses, final


class TestTransformer:
    def test_against_jax_sharded(self, hvd_torch, jax_sharded_run):
        """A two-layer TransformerLM on convert.py's weights, sharded in
        both packages: losses 1e-5 relative, parameters as
        assert_adam_close states (tests/test_torch_train_step.py's
        limits for the replicated path)."""
        params0, want, final = jax_sharded_run
        cfg = TT.TransformerConfig(dtype=torch.float32,
                                   attention_impl="flash", **SIZES)
        model = TT.TransformerLM(cfg)
        model.load_state_dict(params_from_flax(params0))
        step = hvd_torch.DistributedTrainStep(
            lambda m, b: TT.lm_loss(m, b),
            torch.optim.AdamW(model.parameters(), lr=3e-4,
                              weight_decay=1e-4),
            shard_optimizer_states=True)
        model, opt = step.init(model)
        batch = step.shard_batch(torch.from_numpy(_tokens()).long())
        got = []
        for _ in range(3):
            model, opt, loss = step(model, opt, batch)
            got.append(float(loss))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert got[-1] < got[0]
        ref = params_from_flax(final)
        for name, p in model.state_dict().items():
            assert_adam_close(p.numpy(), ref[name].numpy(), name)

    def test_int8_wire_with_error_feedback_stays_near_fp32(self, hvd_torch):
        """chip_smoke's phase 8 recipe at the 870.9M model's vocabulary
        (32000) and half its width (d_model 1024, one layer, batch 4 of 64
        tokens): 5 sharded AdamW steps with gradient_predivide_factor=2,
        the fp32 wire against Compression.int8 with error feedback and
        64 MiB buckets.  The int8 run's last loss lies within
        5 % of the fp32 run's 5-step loss drop (it read 1.9 %); the card
        check allows 10 % at twice the width."""
        sizes = dict(vocab_size=32000, num_layers=1, num_heads=16,
                     d_model=1024, d_ff=4096, max_seq_len=64)
        tokens = torch.randint(0, 32000, (4, 65),
                               generator=torch.Generator().manual_seed(0))

        def run(**kw):
            model = TT.TransformerLM(
                TT.TransformerConfig(dtype=torch.float32,
                                     attention_impl="flash", **sizes),
                generator=torch.Generator().manual_seed(0))
            step = hvd_torch.DistributedTrainStep(
                lambda m, b: TT.lm_loss(m, b), hvd_torch.DistributedOptimizer(
                    torch.optim.AdamW(model.parameters(), lr=3e-4,
                                      weight_decay=1e-4),
                    gradient_predivide_factor=2.0,
                    shard_optimizer_states=True, **kw))
            model, opt = step.init(model)
            batch = step.shard_batch(tokens)
            return [float(step(model, opt, batch)[2]) for _ in range(5)]

        fp32 = run()
        int8 = run(compression=hvd_torch.Compression.int8,
                   error_feedback=True, exchange_bucket_bytes=64 << 20)
        assert all(np.isfinite(int8)) and int8[-1] < int8[0]
        assert abs(int8[-1] - fp32[-1]) <= 5e-2 * (fp32[0] - fp32[-1]), \
            (int8, fp32)

    def test_gloo_world_of_two_matches_replicated(self, hvd_torch, worlds):
        """The sharded world of two against the replicated world of one
        (tests/test_torch_train_step.py TestGlooWorld's limits)."""
        want_losses, want_params = run_train(hvd_torch, 3)
        for rank_out in worlds[2]:
            losses, params = rank_out["train"]
            np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
            for k, v in params.items():
                assert_adam_close(v, want_params[k], k)


# ---------------------------------------------------------------------------
# topology and guards
# ---------------------------------------------------------------------------

class TestTopology:
    @pytest.mark.parametrize("sizes", [(1,), (8,), (1, 8), (8, 1), (1, 1)])
    @pytest.mark.parametrize("mode", ["auto", "flat"])
    def test_flat_matches_jax(self, sizes, mode):
        assert TTopo.resolve_topology(mode, sizes) == \
            JTopo.resolve_topology(mode, sizes).mode == "flat"

    @pytest.mark.parametrize("mode,sizes", [
        ("auto", (2, 4)), ("two_level", (2, 4)), ("two_level", (1, 8)),
        ("tree", (2, 4)), ("auto", (2, 2, 2)), ("tree", (2, 2, 2))])
    def test_other_modes_raise(self, mode, sizes):
        """JAX resolves these to a two-level or tree exchange, which the
        port does not run flat."""
        assert JTopo.resolve_topology(mode, sizes).mode != "flat"
        with pytest.raises(NotImplementedError, match="Queue A 7"):
            TTopo.resolve_topology(mode, sizes)

    @pytest.mark.parametrize("mode,sizes", [("ring", (8,)),
                                            ("two_level", (8,)),
                                            ("flat", ())])
    def test_invalid_raise_as_jax(self, mode, sizes):
        with pytest.raises(ValueError):
            JTopo.resolve_topology(mode, sizes)
        with pytest.raises(ValueError):
            TTopo.resolve_topology(mode, sizes)

    def test_modes_match_jax(self):
        assert TTopo.HIERARCHY_MODES == JTopo.HIERARCHY_MODES
        assert TTopo.TOPOLOGY_MODES == JTopo.TOPOLOGY_MODES


def _opt():
    return torch.optim.AdamW([torch.nn.Parameter(torch.ones(3))], lr=0.1)


#: (DistributedOptimizer keyword arguments, the error), each raised as
#: JAX's DistributedOptimizer raises it
OPTIMIZER_GUARDS = [
    (dict(exchange_bucket_bytes=1 << 20), ValueError),
    (dict(hierarchy="flat"), ValueError),
    (dict(fused_collectives="on"), ValueError),
    (dict(reduction="adasum"), ValueError),
    (dict(error_feedback=True), ValueError),
    (dict(shard_optimizer_states=True, op=TC.ReduceOp.MAX), ValueError),
    (dict(shard_optimizer_states=True, op=TC.Adasum), ValueError),
    (dict(shard_optimizer_states=True, compression="fp16"), ValueError),
    (dict(shard_optimizer_states=True, error_feedback=True), ValueError),
    (dict(shard_optimizer_states=True, hierarchy="ring"), ValueError),
    (dict(shard_optimizer_states=True, fused_collectives="tiled"),
     ValueError),
    (dict(shard_optimizer_states=True, reduction="mean"), ValueError),
    (dict(shard_optimizer_states=True, gradient_predivide_factor=2.0,
          op=TC.Sum), ValueError),
    (dict(shard_optimizer_states=True, hierarchy="two_level"),
     NotImplementedError),
    (dict(shard_optimizer_states=True, hierarchy="tree"),
     NotImplementedError),
]


class TestGuards:
    @pytest.mark.parametrize("case", range(len(OPTIMIZER_GUARDS)))
    def test_distributed_optimizer(self, hvd_torch, case):
        kw, err = OPTIMIZER_GUARDS[case]
        kw = dict(kw)
        if isinstance(kw.get("compression"), str):
            kw["compression"] = getattr(hvd_torch.Compression,
                                        kw["compression"])
        with pytest.raises(err):
            hvd_torch.DistributedOptimizer(_opt(), **kw)

    @pytest.mark.parametrize("case", [0, 1, 2, 3, 4])
    def test_jax_raises_the_same(self, case):
        """The replicated-path guards are JAX's own."""
        kw, err = OPTIMIZER_GUARDS[case]
        with pytest.raises(err):
            jhvd.DistributedOptimizer(optax.sgd(0.1), **kw)

    def test_auto_on_a_two_level_world_raises(self, hvd_torch, monkeypatch):
        """A world of 2 nodes x 4 cards: "auto" is two-level in JAX, and
        the port raises instead of running flat."""
        st = hvd_torch._state.global_state()
        monkeypatch.setattr(st, "cross_size", 2)
        monkeypatch.setattr(st, "local_size", 4)
        with pytest.raises(NotImplementedError, match="two_level"):
            hvd_torch.DistributedOptimizer(_opt(),
                                           shard_optimizer_states=True)
        with pytest.raises(NotImplementedError):
            hvd_torch.DistributedTrainStep(lambda m, b: 0, _opt(),
                                           shard_optimizer_states=True)

    def test_param_groups_must_agree(self, hvd_torch):
        a, b = torch.nn.Parameter(torch.ones(3)), \
            torch.nn.Parameter(torch.ones(2))
        same = torch.optim.SGD([{"params": [a]}, {"params": [b]}], lr=0.1)
        hvd_torch.DistributedOptimizer(same, shard_optimizer_states=True)
        differ = torch.optim.SGD([{"params": [a]},
                                  {"params": [b], "lr": 0.2}], lr=0.1)
        with pytest.raises(ValueError, match="param groups"):
            hvd_torch.DistributedOptimizer(differ,
                                           shard_optimizer_states=True)

    def test_all_frozen_raises(self, hvd_torch):
        p = torch.nn.Parameter(torch.ones(3), requires_grad=False)
        with pytest.raises(ValueError, match="requires a gradient"):
            hvd_torch.DistributedOptimizer(torch.optim.AdamW([p], lr=0.1),
                                           shard_optimizer_states=True)

    def test_trainable_parameter_without_gradient(self, hvd_torch):
        """A trainable parameter with no gradient at a step takes a zero
        one, as every leaf has a gradient in JAX: AdamW's decay moves it."""
        a, b = torch.nn.Parameter(torch.ones(3)), \
            torch.nn.Parameter(torch.ones(2))
        opt = hvd_torch.DistributedOptimizer(
            torch.optim.AdamW([a, b], lr=0.1, weight_decay=0.5),
            shard_optimizer_states=True)
        a.grad = torch.ones(3)
        opt.step()
        torch.testing.assert_close(b.detach(), torch.full((2,), 0.95),
                                   rtol=0, atol=0)

    def test_sharded_synchronize_raises(self, hvd_torch):
        opt = hvd_torch.DistributedOptimizer(_opt(),
                                             shard_optimizer_states=True)
        with pytest.raises(ValueError, match="inside"):
            opt.synchronize()

    @pytest.mark.parametrize("kw", [
        dict(exchange_bucket_bytes=1 << 20), dict(hierarchy="flat"),
        dict(fused_collectives="on"), dict(reduction="adasum"),
        dict(error_feedback=True),
        dict(shard_optimizer_states=True, error_feedback=True),
        dict(shard_optimizer_states=True, op=TC.ReduceOp.MAX)])
    def test_train_step(self, hvd_torch, kw):
        with pytest.raises(ValueError):
            hvd_torch.DistributedTrainStep(lambda m, b: 0, _opt(), **kw)

    def test_train_step_options_belong_to_a_wrapped_optimizer(self,
                                                              hvd_torch):
        opt = hvd_torch.DistributedOptimizer(_opt())
        with pytest.raises(ValueError):
            hvd_torch.DistributedTrainStep(lambda m, b: 0, opt,
                                           shard_optimizer_states=True)

    def test_train_step_reads_the_knobs(self, hvd_torch, monkeypatch):
        cfg = hvd_torch._state.global_state().config
        monkeypatch.setattr(cfg, "exchange_bucket_bytes", 64)
        step = hvd_torch.DistributedTrainStep(
            lambda m, b: 0, torch.optim.AdamW(
                [torch.nn.Parameter(torch.ones(40)),
                 torch.nn.Parameter(torch.ones(40))], lr=0.1),
            shard_optimizer_states=True)
        assert len(step.optimizer.spec.groups) == 2
        monkeypatch.setattr(cfg, "fused_collectives", "tiled")
        with pytest.raises(ValueError, match="fused_collectives"):
            hvd_torch.DistributedTrainStep(lambda m, b: 0, _opt(),
                                           shard_optimizer_states=True)
        monkeypatch.setattr(cfg, "fused_collectives", "auto")
        monkeypatch.setattr(cfg, "exchange_hierarchy", "tree")
        with pytest.raises(NotImplementedError):
            hvd_torch.DistributedTrainStep(lambda m, b: 0, _opt(),
                                           shard_optimizer_states=True)

    def test_adasum_on_flat_is_the_plain_sum(self, hvd_torch):
        """JAX: a flat topology has no outer hop, so adasum there is the
        bit-identical plain sum."""
        out = []
        for reduction in ("sum", "adasum"):
            p = torch.nn.Parameter(torch.linspace(-1, 1, 9))
            opt = hvd_torch.DistributedOptimizer(
                torch.optim.AdamW([p], lr=0.1), shard_optimizer_states=True,
                reduction=reduction)
            p.grad = torch.linspace(1, 2, 9)
            opt.step()
            out.append(p.detach().clone())
        torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)
