"""tp and fsdp in the port's training step, against the JAX package's pjit
step: the tensor-parallel modules, FSDP placement, the exchange scoped to
the plan's data axes, the plan methods, and every refusal.

One gloo world of 4 runs ``dp=2,tp=2``, ``dp=2,fsdp=2``, ``fsdp=4``,
``fsdp=2,tp=2``, ``dp=4``, the MoE LM at ``fsdp=2,ep=2`` and ``dp=2,ep=2``,
the refusals and the checkpoint guard; one world of 2 runs ``tp=2``
(``run_model_parallel`` in ``tests/torch_port_workers.py``, each world
spawned once).  The JAX references run ``DistributedTrainStep(mode="pjit")``
on as many of the 8 virtual CPU devices, with an explicit mesh of the same
extents, on the same numpy weights.  Tolerances: parameters after three
AdamW steps and logits at rtol 1e-5 / atol 1e-5 in fp32 (parameters as
:func:`~torch_port_workers.assert_adam_close` states: AdamW divides by the
gradient's own size, so an element whose gradient sits at the noise floor
may step the other way); the FSDP runs at ``tests/test_plan.py``'s rtol
2e-5 / atol 1e-6.
"""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as jhvd
from horovod_tpu.models import transformer as JT
from horovod_tpu.parallel import fsdp as JF
from horovod_tpu.parallel import make_parallel_mesh as jax_make_mesh
from horovod_tpu.parallel import plan as JP
from horovod_tpu_torch.models.convert import params_from_flax, tp_shard
from horovod_tpu_torch.parallel import fsdp as TF
from horovod_tpu_torch.parallel import mesh as TM
from horovod_tpu_torch.parallel import plan as TP
from horovod_tpu_torch.parallel.tensor_parallel import column_rows

from torch_port_workers import (
    MP_LM,
    MP_LR,
    MP_REFUSALS,
    MP_STEPS,
    assert_adam_close,
    fsdp_setup,
    mp_mlp_batch,
    mp_refusal_kwargs,
    mp_tokens,
    spawn_world,
    tp_mlp_state,
)

WORLDS = (2, 4)
RTOL = ATOL = 1e-5


def _tp_mlp_flax():
    import flax.linen as nn

    from horovod_tpu.parallel import ColumnParallelDense, RowParallelDense

    class TpMlp(nn.Module):
        @nn.compact
        def __call__(self, x):
            h = ColumnParallelDense(64, axis="tp")(x)
            h = nn.gelu(h)
            return RowParallelDense(32, axis="tp")(h)

    return TpMlp()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray,
                                  flax.core.meta.unbox(jax.device_get(tree)))


@pytest.fixture(scope="module")
def jax_runtime():
    """JAX's runtime with its warm-start store off: steps of one program
    on meshes of 4 and of 8 devices would share a key there.  A runtime
    that a JAX test earlier in the process left initialized (with the
    store on: ``tests/test_parallel.py``'s fsdp steps on 8 devices, whose
    executables this module's 4-device steps were then handed) is shut
    down first, so that ``init`` reads the knob."""
    old = os.environ.get("HOROVOD_COMPILE_CACHE")
    os.environ["HOROVOD_COMPILE_CACHE"] = "0"
    if jhvd.is_initialized():
        jhvd.shutdown()
    jhvd.init()
    yield
    jhvd.shutdown()
    if old is None:
        del os.environ["HOROVOD_COMPILE_CACHE"]
    else:
        os.environ["HOROVOD_COMPILE_CACHE"] = old


@pytest.fixture(scope="module")
def tp_mlp_variables():
    return _tp_mlp_flax().init(jax.random.PRNGKey(1),
                               jnp.asarray(mp_mlp_batch()["x"]))


@pytest.fixture(scope="module")
def lm_variables():
    cfg = JT.TransformerConfig(dtype=jnp.float32, **MP_LM)
    return JT.TransformerLM(cfg).init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 16), jnp.int32))


@pytest.fixture(scope="module")
def worlds(tp_mlp_variables, lm_variables, tmp_path_factory):
    """One gloo world of each size runs every case."""
    mlp = _np(tp_mlp_variables)["params"]
    lm_sd = params_from_flax(_np(lm_variables))
    return {w: spawn_world("run_model_parallel", world=w,
                           args=(mlp, lm_sd,
                                 str(tmp_path_factory.mktemp(f"ckpt{w}"))),
                           timeout=300)
            for w in WORLDS}


def _jax_mesh(plan: str, world: int):
    return JP.ShardingPlan.from_string(plan).resolve(world).build_mesh(
        devices=jax.devices("cpu")[:world])


def _jax_train(loss_fn, variables, batch, plan, world, tx, **kw):
    """MP_STEPS steps of the JAX pjit step under ``plan`` on a mesh of
    ``world`` CPU devices: (losses, trained parameters, step)."""
    mesh = _jax_mesh(plan, world)
    step = jhvd.DistributedTrainStep(loss_fn, tx, mesh=mesh, mode="pjit",
                                     plan=plan, donate=False, **kw)
    with mesh:
        params, opt_state = step.init(variables)
        b = step.shard_batch(batch)
        losses = []
        for _ in range(MP_STEPS):
            params, opt_state, loss = step(params, opt_state, b)
            losses.append(float(loss))
    return losses, params, step


@pytest.fixture(scope="module")
def jax_tp_mlp(jax_runtime, tp_mlp_variables):
    model = _tp_mlp_flax()
    batch = {k: jnp.asarray(v) for k, v in mp_mlp_batch().items()}

    def loss_fn(params, b):
        return jnp.mean((model.apply(params, b["x"]) - b["y"]) ** 2)

    out = {}
    for plan, world in (("dp=2,tp=2", 4), ("tp=2", 2)):
        losses, params, step = _jax_train(loss_fn, tp_mlp_variables, batch,
                                          plan, world, optax.adamw(MP_LR))
        with step._mesh:
            logits = np.asarray(model.apply(params, batch["x"]))
        out[plan] = (losses, tp_mlp_state(_np(params)["params"]), logits)
    return out


@pytest.fixture(scope="module")
def jax_lm(jax_runtime, lm_variables):
    cfg = JT.TransformerConfig(dtype=jnp.float32, **MP_LM)
    model = JT.TransformerLM(cfg)
    tok = jnp.asarray(mp_tokens().astype(np.int32))
    out = {}
    for plan, world in (("dp=2,tp=2", 4), ("tp=2", 2)):
        losses, params, step = _jax_train(
            lambda p, b: JT.lm_loss(p, model, b), lm_variables, tok, plan,
            world, optax.adamw(MP_LR))
        with step._mesh:
            logits = np.asarray(model.apply(params, tok[:, :-1]))
        out[plan] = (losses, params_from_flax(_np(params)), logits)
    return out


def _check_tp_shards(rec, full: dict, tp: int, name: str) -> None:
    """This rank's parameters against the JAX run's full ones, cut as the
    port's modules hold them."""
    for k, got in rec["params"].items():
        want = tp_shard(k, full[k], tp, rec["tp_index"]).numpy()
        if k == "col.weight":
            want = full[k].numpy()[column_rows(64, tp, rec["tp_index"])]
        elif k == "col.bias":
            want = full[k].numpy()[column_rows(64, tp, rec["tp_index"])]
        elif k == "row.weight":
            w = 64 // tp
            i = rec["tp_index"]
            want = full[k].numpy()[:, i * w:(i + 1) * w]
        assert got.shape == want.shape, (name, k)
        assert_adam_close(got, want, f"{name} {k}", steps=MP_STEPS,
                          lr=MP_LR, atol=ATOL)


# ---------------------------------------------------------------------------
# (a) tp: the TpMlp and the LM against JAX's pjit step
# ---------------------------------------------------------------------------

class TestTensorParallel:
    @pytest.mark.parametrize("world,plan", [(4, "dp=2,tp=2"), (2, "tp=2")])
    def test_tp_mlp_matches_jax(self, worlds, jax_tp_mlp, world, plan):
        """The step shards a full TpMlp over the plan's tp group in init:
        each rank holds its (64/tp, 32) column block and (32, 64/tp) row
        block, the optimizer's state has their shapes, and three AdamW
        steps land on JAX's parameters, with the same logits on every
        rank."""
        losses, full, logits = jax_tp_mlp[plan]
        tp = 2
        for rank, out in enumerate(worlds[world]):
            rec = out[("tp_mlp", plan)]
            assert rec["mode"] == "pjit"
            assert rec["tp_index"] == rank % tp
            np.testing.assert_allclose(rec["losses"], losses, rtol=RTOL,
                                       atol=ATOL)
            _check_tp_shards(rec, full, tp, plan)
            assert rec["state_shapes"]["col.weight"] == (64 // tp, 32)
            assert rec["state_shapes"]["row.weight"] == (32, 64 // tp)
            assert rec["state_shapes"]["row.bias"] == (32,)
            np.testing.assert_allclose(rec["logits"], logits, rtol=RTOL,
                                       atol=ATOL)

    @pytest.mark.parametrize("world,plan", [(4, "dp=2,tp=2"), (2, "tp=2")])
    def test_lm_matches_jax(self, worlds, jax_lm, world, plan):
        """The 2-layer LM (d 128, 4 heads): at world 4 built with the
        plan's mesh's tp group from converted per-rank weights, at world 2
        sharded by the step from full ones.  Each rank holds its two heads'
        q, k and v rows of ``qkv``, its rows of ``wi`` and its columns of
        ``proj`` and ``wo``; embedding and norm scales whole."""
        losses, full, logits = jax_lm[plan]
        tp = 2
        for out in worlds[world]:
            rec = out[("lm", plan)]
            np.testing.assert_allclose(rec["losses"], losses, rtol=RTOL,
                                       atol=ATOL)
            _check_tp_shards(rec, full, tp, plan)
            d, f = MP_LM["d_model"], MP_LM["d_ff"]
            shapes = rec["state_shapes"]
            assert shapes["layers.0.attn.qkv.weight"] == (3 * d // tp, d)
            assert shapes["layers.0.attn.proj.weight"] == (d, d // tp)
            assert shapes["layers.0.mlp.wi.weight"] == (f // tp, d)
            assert shapes["layers.0.mlp.wo.weight"] == (d, f // tp)
            assert shapes["embed.embedding"] == (MP_LM["vocab_size"], d)
            np.testing.assert_allclose(rec["logits"], logits, rtol=RTOL,
                                       atol=ATOL)

    @pytest.mark.parametrize("model", ["lm", "vit"])
    @pytest.mark.parametrize("world", [4, 2])
    def test_seeded_tp_model_is_the_full_models_shard(self, worlds, world,
                                                      model):
        """A model drawn from a seed with a tp group (``dp=2,tp=2`` on the
        world of 4, ``tp=2`` on 2) holds, on every rank, tp_shard of the
        model drawn from the same seed at full width: each kernel is drawn
        whole and cut, as JAX draws the global array, so the heads and
        hidden units of one tp group are not copies of each other."""
        for out in worlds[world]:
            differ, count = out["seeded_tp"][model]
            assert differ == []
            assert count > 10

    def test_exchange_buckets_plan_the_shards(self, worlds):
        """A step that cuts a full-width model over its tp group wraps the
        optimizer after the cut, so the exchange's buckets are planned
        over the shards' bytes (at a 128 KiB threshold: fewer buckets than
        over the full parameters)."""
        for out in worlds[4]:
            b = out["tp_buckets"]
            assert b["launched"] == b["shards"]
            assert b["shards"] < b["full"]

    def test_column_rows_cut_each_head(self):
        """A fused QKV's rows at tp = 2: rank r holds rows [r·d/2,
        (r+1)·d/2) of each of q, k and v; a contiguous cut would give rank
        0 all of q and half of k."""
        d = 8
        assert column_rows(3 * d, 2, 0, 3) == \
            list(range(0, 4)) + list(range(8, 12)) + list(range(16, 20))
        assert column_rows(3 * d, 2, 1, 3) == \
            list(range(4, 8)) + list(range(12, 16)) + list(range(20, 24))
        assert column_rows(16, 4, 3) == [12, 13, 14, 15]


# ---------------------------------------------------------------------------
# (b) fsdp placement against JAX's placement and the replicated run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_fsdp(jax_runtime):
    """tests/test_plan.py's test_plan_fsdp_extent_turns_on_placement on
    meshes of 4 devices: (params, resident bytes after init, the placed
    leaves' partitioned dims) by (plan, min_weight_size)."""
    w, batch = fsdp_setup()

    def loss_fn(params, b):
        h = jax.nn.relu(b["x"] @ params["w1"])
        return jnp.mean((h @ params["w2"] - b["y"]) ** 2)

    out = {}
    for plan, kw in (("dp=2,fsdp=2", {"fsdp_min_weight_size": 1}),
                     ("fsdp=4", {"fsdp_min_weight_size": 1}),
                     ("fsdp=4", {})):
        mesh = _jax_mesh(plan, 4)
        step = jhvd.DistributedTrainStep(loss_fn, optax.adam(1e-2),
                                         mesh=mesh, mode="pjit", plan=plan,
                                         donate=False, **kw)
        params, opt_state = step.init({k: jnp.asarray(v)
                                       for k, v in w.items()})
        resident = JF.resident_bytes(params)
        dims = {k: (list(v.sharding.spec).index("fsdp")
                    if "fsdp" in v.sharding.spec else None)
                for k, v in params.items()}
        b = step.shard_batch({k: jnp.asarray(v) for k, v in batch.items()})
        losses = []
        for _ in range(MP_STEPS):
            params, opt_state, loss = step(params, opt_state, b)
            losses.append(float(loss))
        out[(plan, bool(kw))] = (losses, _np(params), resident, dims)
    return out


def _adam_allclose(got, want, name, rtol=2e-5, atol=1e-6, lr=1e-2):
    """JAX's rtol 2e-5 / atol 1e-6 across the two frameworks, except at
    Adam's noise floor: Adam divides each element's step by the size of
    its own gradient, so an element with a near-zero gradient amplifies
    the last-bit differences of the two programs.  Those are at most 0.1%
    of the elements and never more than the steps of ``lr`` apart."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    off = diff > atol + rtol * np.abs(np.asarray(want, np.float64))
    assert off.mean() <= 1e-3, (name, float(diff.max()))
    assert diff.max() <= MP_STEPS * lr * 1.01, (name, float(diff.max()))


class TestFsdp:
    @pytest.mark.parametrize("plan", ["dp=2,fsdp=2", "fsdp=4"])
    def test_placement_matches_jax_and_replicated(self, worlds, jax_fsdp,
                                                  plan):
        """``fsdp_min_weight_size=1``: both leaves are placed on their
        largest dimension (256), as JAX places them; the optimizer's state
        has the shard's shape; the resident bytes are JAX's; and the
        trained parameters, gathered, equal the replicated ``dp=4`` run's
        and JAX's at JAX's rtol 2e-5 / atol 1e-6."""
        n = 4 if plan == "fsdp=4" else 2
        losses, want, resident, dims = jax_fsdp[(plan, True)]
        for out in worlds[4]:
            rec, repl = out[("fsdp_mlp", plan)], out[("fsdp_mlp", "dp=4")]
            assert rec["mode"] == "pjit"
            assert rec["dims"] == dims == {"w1": 1, "w2": 0}
            assert rec["state_shapes"] == {"w1": (64, 256 // n),
                                           "w2": (256 // n, 8)}
            assert rec["params"]["w1"].shape == (64, 256 // n)
            assert rec["resident"] == resident
            assert repl["resident"] == 4 * (64 * 256 + 256 * 8)
            np.testing.assert_allclose(rec["losses"], losses, rtol=2e-5,
                                       atol=1e-6)
            for k in ("w1", "w2"):
                np.testing.assert_allclose(rec["full"][k],
                                           repl["params"][k], rtol=2e-5,
                                           atol=1e-6)
                _adam_allclose(rec["full"][k], want[k], k)

    def test_default_min_weight_size_keeps_small_leaves_whole(
            self, worlds, jax_fsdp):
        """At the default 2**14 elements w2 (2048) stays replicated, as in
        JAX, and takes the ordinary data-axes exchange."""
        losses, want, resident, dims = jax_fsdp[("fsdp=4", False)]
        for out in worlds[4]:
            rec = out[("fsdp_mlp_default_min", "fsdp=4")]
            assert rec["dims"] == dims == {"w1": 1, "w2": None}
            assert rec["resident"] == resident
            assert rec["state_shapes"]["w2"] == (256, 8)
            for k in ("w1", "w2"):
                _adam_allclose(rec["full"][k], want[k], k)

    @pytest.mark.parametrize("extent", [2, 4, 3])
    @pytest.mark.parametrize("min_size", [1, JF.DEFAULT_MIN_WEIGHT_SIZE])
    def test_sharding_specs_match_jax(self, lm_variables, extent,
                                      min_size):
        """The port's rule gives JAX's partitioned dimension on every leaf
        of the flax LM and the FSDP MLP, at the same shapes, for any
        extent and minimum size (an extent of 3 divides no dimension of
        most leaves)."""
        from jax.sharding import Mesh

        mesh = Mesh(np.array(jax.devices("cpu")[:extent]), ("fsdp",))
        trees = [_np(lm_variables)["params"], fsdp_setup()[0]]
        for tree in trees:
            leaves = jax.tree_util.tree_leaves_with_path(tree)
            for path, leaf in leaves:
                spec = JF.fsdp_sharding(leaf.shape, mesh, "fsdp",
                                        min_size).spec
                want = list(spec).index("fsdp") if "fsdp" in spec else None
                got = TF.fsdp_sharding(leaf.shape, extent, "fsdp", min_size)
                assert got == want, (jax.tree_util.keystr(path), extent)
        flat = {str(i): leaf for i, leaf in
                enumerate(jax.tree_util.tree_leaves(trees[0]))}
        assert list(TF.sharding_specs(flat, extent,
                                      min_weight_size=min_size).values()) \
            == [TF.fsdp_sharding(v.shape, extent, "fsdp", min_size)
                for v in flat.values()]

    def test_resident_bytes_counts_each_leaf_once(self):
        model = torch.nn.Linear(4, 4)
        model.extra = model.weight
        assert TF.resident_bytes(model) == 4 * (16 + 4)
        assert TF.resident_bytes({"a": torch.zeros(3, dtype=torch.bfloat16)}) \
            == 6


# ---------------------------------------------------------------------------
# (c), (d): the mixes against the replicated plans
# ---------------------------------------------------------------------------

class TestMixes:
    def test_fsdp_tp_matches_dp(self, worlds):
        """``fsdp=2,tp=2`` (tp shards, each placed over fsdp) lands on
        ``dp=4``'s losses, logits and parameters."""
        for out in worlds[4]:
            rec, ref = out[("lm", "fsdp=2,tp=2")], out[("lm", "dp=4")]
            assert rec["mode"] == "pjit"
            np.testing.assert_allclose(rec["losses"], ref["losses"],
                                       rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(rec["logits"], ref["logits"],
                                       rtol=RTOL, atol=ATOL)
            full = {k: torch.from_numpy(v) for k, v in ref["params"].items()}
            for k, got in rec["full"].items():
                want = tp_shard(k, full[k], 2, rec["tp_index"]).numpy()
                assert_adam_close(got, want, k, steps=MP_STEPS, lr=MP_LR,
                                  atol=ATOL)
            assert rec["resident"] < ref["resident"] / 3

    def test_moe_fsdp_ep_matches_dp_ep(self, worlds):
        """The MoE LM at ``fsdp=2,ep=2`` (its experts' weights and every
        other leaf placed over fsdp, the exchange over fsdp × ep) against
        ``dp=2,ep=2``: the sharded state under ep that JAX reaches through
        the placement."""
        from torch_port_workers import MOE_LR

        for out in worlds[4]:
            rec, ref = out[("moe", "fsdp=2,ep=2")], out[("moe", "dp=2,ep=2")]
            np.testing.assert_allclose(rec["losses"], ref["losses"],
                                       rtol=RTOL, atol=ATOL)
            assert rec["state_shapes"]["layers.1.moe.w1"] == (8, 32, 32)
            for k, want in ref["params"].items():
                assert_adam_close(rec["full"][k], want, k, steps=MP_STEPS,
                                  lr=MOE_LR, atol=ATOL)
            assert rec["resident"] * 2 == ref["resident"]


# ---------------------------------------------------------------------------
# (e) the plan methods and every refusal, word for word
# ---------------------------------------------------------------------------

def _jax_error(fn) -> str:
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


class TestPlanMethods:
    @pytest.mark.parametrize("text,n", [
        ("dp=4,tp=2", 8), ("fsdp=2,tp=2,ep=2", 8), ("fsdp=2,tp=2,ep=2", 16),
        ("dp=2,pp=2,v=2", 4), ("tp=8", 8), ("fsdp=4", 16)])
    def test_views_match_jax(self, text, n):
        jp, tp = (mod.ShardingPlan.from_string(text).resolve(n)
                  for mod in (JP, TP))
        assert tp.total == jp.total
        assert tp.extents == jp.extents
        assert tp.model_extent == jp.model_extent
        for m in (1, 3, 4, 7, 8, n):
            assert [p.to_string() for p in tp.degrade_candidates(m)] == \
                [p.to_string() for p in jp.degrade_candidates(m)]

    @pytest.mark.parametrize("n", [1, 4, 6, 8, 12])
    @pytest.mark.parametrize("axes", [("dp", "fsdp", "tp"), ("dp", "tp"),
                                      ("fsdp", "ep", "dp")])
    def test_candidate_plans_match_jax(self, n, axes):
        assert [p.to_string() for p in TP.candidate_plans(n, axes)] == \
            [p.to_string() for p in JP.candidate_plans(n, axes)]

    def test_refusals_match_jax(self):
        unresolved = "dp=None"
        for fn in (lambda m: m.ShardingPlan().total,
                   lambda m: m.ShardingPlan().degrade_candidates(4),
                   lambda m: m.candidate_plans(0),
                   lambda m: m.candidate_plans(4, ("dp", "xx"))):
            assert _jax_error(lambda: fn(TP)) == _jax_error(lambda: fn(JP))
        assert unresolved in _jax_error(lambda: TP.ShardingPlan().total)

    def test_from_env_and_matches_mesh(self, monkeypatch):
        monkeypatch.setenv("HOROVOD_PLAN", "dp=2,tp=2")
        assert TP.ShardingPlan.from_env() == TP.ShardingPlan(dp=2, tp=2)
        assert TP.ShardingPlan.from_env().to_string(True) == \
            JP.ShardingPlan.from_env().to_string(True)
        monkeypatch.delenv("HOROVOD_PLAN")
        assert TP.ShardingPlan.from_env() is None
        plan = TP.ShardingPlan.from_string("dp=2,tp=4").resolve(8)
        jmesh = jax_make_mesh(
            dp=2, tp=4, devices=jax.devices("cpu")[:8])
        assert plan.matches_mesh(jmesh)
        shape = dict(jmesh.shape)
        port_mesh = TM.ParallelMesh(shape, dict.fromkeys(shape, 0), {})
        assert plan.matches_mesh(port_mesh)
        assert not TP.ShardingPlan.from_string("tp=8").resolve(8) \
            .matches_mesh(port_mesh)

    def test_build_mesh_on_a_world_of_one(self):
        import horovod_tpu_torch as hvd

        hvd.init(device="cpu")
        try:
            mesh = TP.ShardingPlan.from_string("tp=1").resolve(1) \
                .build_mesh()
            assert mesh.shape == dict.fromkeys(TM.AXIS_ORDER, 1)
            assert mesh.group(("dp", "fsdp")) is None
            assert mesh.scope(("dp", "fsdp")) is \
                hvd.ops.collectives.ALONE
            assert mesh.index(("dp", "tp")) == 0
        finally:
            hvd.shutdown()

    def test_axis_ranks_of_several_axes(self):
        """The group of several axes holds the ranks that share every
        other coordinate, in row-major order over them: a JAX mesh's
        devices along those axes."""
        shape = {**dict.fromkeys(TM.AXIS_ORDER, 1), "dp": 2, "fsdp": 2,
                 "tp": 2}
        jmesh = jax_make_mesh(
            dp=2, fsdp=2, tp=2, devices=jax.devices("cpu")[:8])
        ids = np.vectorize(lambda d: d.id)(jmesh.devices)
        for axes in (("dp", "fsdp"), ("fsdp", "tp"), ("dp", "tp"),
                     ("dp", "fsdp", "tp"), ("dp", "pp", "ep", "sp", "fsdp")):
            idx = [TM.AXIS_ORDER.index(a) for a in axes]
            size = int(np.prod([shape[a] for a in axes]))
            want = np.moveaxis(ids, idx, list(range(-len(idx), 0))) \
                .reshape(-1, size).tolist()
            assert TM.axis_ranks(shape, axes) == want, axes


class TestRefusals:
    @pytest.mark.parametrize("name", [r[0] for r in MP_REFUSALS] +
                             ["mesh_mismatch"])
    def test_step_refusals_match_jax(self, worlds, jax_runtime, name):
        """Each refusal of the port's step on the world of 4 is the JAX
        step's on a mesh of 4 CPU devices, word for word.  The sharded
        exchange with ep > 1 resolves to shard_map by the default mode;
        the JAX call names that mode."""
        if name == "mesh_mismatch":
            plan, kw = "dp=2,tp=2", {}
            mesh = jax_make_mesh(
                tp=4, devices=jax.devices("cpu")[:4])
        else:
            plan, kw = next((p, k) for n, p, k in MP_REFUSALS if n == name)
            kw = mp_refusal_kwargs(jhvd, kw)
            mesh = _jax_mesh(plan, 4)
        if name == "ep_sharded_states":
            kw["mode"] = "shard_map"
        want = _jax_error(lambda: jhvd.DistributedTrainStep(
            lambda p, b: 0.0, optax.sgd(0.1), mesh=mesh, plan=plan, **kw))
        for out in worlds[4]:
            assert out["errors"][name] == want

    def test_tp_extent_and_modules(self, worlds):
        """init refuses a model sharded over another tp extent than the
        plan's, and a tp plan over a model with no tensor-parallel
        module."""
        for out in worlds[4]:
            errors = out["errors"]
            assert "sharded over tp=2" in errors["tp_extent"]
            assert "tp=4" in errors["tp_extent"]
            assert "no ColumnParallelDense/RowParallelDense" in \
                errors["tp_no_modules"]


class TestExchangeScope:
    def test_optimizer_axis(self, worlds):
        """DistributedOptimizer(axis=mesh.scope("dp")) of a ``dp=2,tp=2``
        mesh averages over the rank's dp group only (ranks r and r+2), from
        the hooks and at synchronize(), with a predivide factor too; over
        ALONE the gradient is the rank's own."""
        from torch_port_workers import mp_axis_grads

        for rank, out in enumerate(worlds[4]):
            ax = out["axis"]
            assert ax["dp_ranks"] == [rank % 2, rank % 2 + 2]
            want = (mp_axis_grads(rank % 2) + mp_axis_grads(rank % 2 + 2)) / 2
            for path in ("hook", "synchronize"):
                for name in ("dp", "dp_predivide"):
                    got, sources = ax[(name, path)]
                    np.testing.assert_allclose(got, want, rtol=1e-6,
                                               atol=1e-7)
                    assert sources == [path]
                got, _ = ax[("alone", path)]
                np.testing.assert_array_equal(got, mp_axis_grads(rank))

    def test_world_only_forms_and_the_step_scope(self, worlds):
        """The sharded, Adasum, quantized and sparse forms take the world
        only; a step under a plan whose data axes are not the world
        refuses an optimizer wrapped over the world, and takes one wrapped
        over its mesh's data group."""
        for out in worlds[4]:
            refusals = out["axis"]["refusals"]
            assert "shard_optimizer_states" in refusals["sharded"]
            assert "op=Adasum" in refusals["adasum"]
            assert "quantized" in refusals["int8"]
            assert "sparse_params" in refusals["sparse"]
            for name in ("sharded", "adasum", "int8", "sparse"):
                assert "reduce(s) over the world" in refusals[name]
            assert "scopes the exchange to ('dp',)" in \
                refusals["step_scope"]
            assert out["axis"]["scope_accepted"]


class TestCheckpointGuard:
    def test_shards_are_refused(self, worlds):
        """Checkpointer.save and restore_and_broadcast refuse, on every
        rank, a state that holds a rank's tensor-parallel or fsdp shard
        (rank 0's shard would be written, or broadcast, under the full
        parameter's name); nothing is written for those steps, and a
        replicated model's state saves on rank 0."""
        for rank, out in enumerate(worlds[4]):
            ck = out["checkpoint"]
            assert "model/col.weight" in ck["tp_save"]
            assert "tensor-parallel columns over 2 ranks" in ck["tp_save"]
            assert "save_sharded" in ck["tp_save"]
            assert "restore_and_broadcast" in ck["tp_restore"]
            assert "model/w1 holds this rank's fsdp shard of dim 1" in \
                ck["fsdp_save"]
            assert ck["written"] == []
            assert ck["replicated_save"] is (rank == 0)

    def test_optimizer_state_of_shards_is_refused(self, worlds):
        """The optimizer's state alone is refused too: AdamW's moments of
        a tp or fsdp shard are that rank's shard of the moments, whether
        the optimizer is a plain torch one or the step's."""
        for out in worlds[4]:
            ck = out["checkpoint"]
            assert "opt/state/0/exp_avg holds this rank's tensor-parallel " \
                "columns over 2 ranks (optimizer state)" in ck["tp_opt_save"]
            assert "restore_and_broadcast" in ck["tp_opt_restore"]
            assert "(optimizer state)" in ck["tp_opt_restore"]
            assert "opt/state/0/exp_avg holds this rank's fsdp shard" in \
                ck["fsdp_opt_save"]
            assert "(optimizer state)" in ck["fsdp_opt_save"]
            assert ck["written"] == []

    def test_loaded_optimizer_state_of_shards_is_refused(self, worlds):
        """An AdamW over a tp = 2 or fsdp = 2 shard that loads a saved
        state is refused before any step, naming ``save_sharded`` and
        ``fsdp.gather_params``, as it is after a step: the loaded moments
        are this rank's shard too."""
        for out in worlds[4]:
            ck = out["checkpoint"]
            for key, what in (("tp_loaded_save", "tensor-parallel columns"),
                              ("fsdp_loaded_save", "fsdp shard")):
                assert f"opt/state/0/exp_avg holds this rank's {what}" in \
                    ck[key], key
                assert "(optimizer state)" in ck[key]
                assert "save_sharded" in ck[key]
                assert "fsdp.gather_params" in ck[key]
            assert ck["written"] == []
