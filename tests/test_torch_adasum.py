"""The port's Adasum against the JAX package: the pairwise combine, the
reduction over the world's layout, ``grouped_allreduce``/``allreduce``
with ``op=Adasum``, ``DistributedAdasumOptimizer`` (the delta form), the
op=Adasum exchange on the hook path, the step-time path and the step, and
the slice as a whole (a small TransformerLM trained 3 steps through
``DistributedAdasumOptimizer(AdamW)`` on a world of 4).

Gloo worlds laid out as ``(cross, local)`` = 2 x 1, 4 x 1, 3 x 1 and 2 x 4
(``ADASUM_LAYOUTS``) are spawned once for the module, two at a time
(``run_adasum`` in ``tests/torch_port_workers.py``).  A JAX single-axis
``"ranks"`` mesh of N stands for a world of N x 1; the ``GLOBAL_AXES``
2 x 4 mesh of the conftest's 8 CPU devices for the world of 2 x 4.

Tolerances: the pair at rtol 1e-5 (the JAX package's test_adasum.py);
across the layout fp32 at rtol 1e-4 (atol 1e-6 for the entries near 0)
and the bf16 tensor within ``BF16_STEPS`` bf16 steps of its largest entry
(the sums over ranks run in another order and round to bf16 between
rounds); the optimizers at
rtol 2e-4, atol 1e-5 (TestDistributedAdasumOptimizer's); the LM's losses
at 1e-5 and its parameters as ``assert_adam_close`` states.  Ranks agree
bit for bit after every call."""

from concurrent.futures import ThreadPoolExecutor

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
from horovod_tpu.ops import adasum as JA
from horovod_tpu.ops import collectives as JC
from horovod_tpu.runtime.topology import GLOBAL_AXES
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.ops import adasum as TA
from horovod_tpu_torch.ops import collectives as TC

from torch_port_workers import (
    ADASUM_LAYOUTS,
    ADASUM_LM,
    ADASUM_LM_STEPS,
    ADASUM_MLP,
    ADASUM_SCALES,
    ADASUM_TRAIN_LAYOUTS,
    DAO_B0,
    DAO_CASES,
    DAO_STEPS,
    DAO_W0,
    adasum_inputs,
    adasum_lm_tokens,
    adasum_mlp_batch,
    assert_adam_close,
    dao_grads,
    mlp_params,
    spawn_world,
)

from test_torch_train_step import hvd_torch  # noqa: F401 - fixture

PAIR_RTOL = 1e-5
LAYOUT_RTOL, LAYOUT_ATOL = 1e-4, 1e-6
#: bf16 steps (2^-8 of the largest entry) the bf16 tensor may move: gloo
#: sums bf16 in bf16 where XLA sums in fp32, and the sum, the mean, each
#: round's cast back and both scale passes round to bf16
BF16_STEPS = 4
OPT_RTOL, OPT_ATOL = 2e-4, 1e-5
#: the layout of the world that trains the LM
LM_LAYOUT = (4, 1)
WORLD_TIMEOUT_S = 300


def _name(layout) -> str:
    return f"{layout[0]}x{layout[1]}"


@pytest.fixture(scope="module")
def lm_params0():
    """The flax TransformerLM's initial parameters (seed 1)."""
    model = JT.TransformerLM(JT.TransformerConfig(
        dtype=jnp.float32, attention_impl="dense", **ADASUM_LM))
    variables = model.init(jax.random.PRNGKey(1),
                           jnp.zeros((1, 16), jnp.int32))
    return jax.tree_util.tree_map(np.asarray,
                                  flax.core.meta.unbox(variables))


@pytest.fixture(scope="module")
def worlds(lm_params0):
    """Every layout's world, two at a time; a failed world is kept as its
    exception and raised by the tests that read it."""
    lm_sd = {k: v.numpy() for k, v in params_from_flax(lm_params0).items()}

    def run(layout):
        args = (layout in ADASUM_TRAIN_LAYOUTS,
                lm_sd if layout == LM_LAYOUT else None)
        return spawn_world("run_adasum", world=layout[0] * layout[1],
                           args=args, layout=layout,
                           timeout=WORLD_TIMEOUT_S)

    with ThreadPoolExecutor(max_workers=2) as pool:
        futs = {layout: pool.submit(run, layout) for layout in ADASUM_LAYOUTS}
        out = {}
        for layout, f in futs.items():
            try:
                out[layout] = f.result()
            except Exception as e:  # noqa: BLE001 - raised by its tests
                out[layout] = e
    return out


def _world(worlds, layout):
    w = worlds[layout]
    if isinstance(w, Exception):
        raise w
    return w


def mesh_of(layout):
    """The JAX mesh and reduction axis that a world of ``layout`` stands
    for."""
    cross, local = layout
    devs = np.asarray(jax.devices()[:cross * local])
    if local == 1:
        return Mesh(devs, ("ranks",)), "ranks"
    return Mesh(devs.reshape(cross, local), GLOBAL_AXES), GLOBAL_AXES


def jax_ranks(layout, fn, *stacked):
    """``fn(axis, *row)`` on every device of ``layout``'s mesh, each given
    its row of every stacked input; the outputs stacked over ranks, as
    numpy (float32 for bf16)."""
    mesh, axis = mesh_of(layout)
    spec = P(axis)

    def body(*xs):
        out = fn(axis, *[x[0] for x in xs])
        return jax.tree_util.tree_map(lambda y: y[None], out)

    res = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=tuple(spec for _ in stacked),
        out_specs=spec, check_vma=False))(*stacked)
    return jax.tree_util.tree_map(
        lambda y: np.asarray(y.astype(jnp.float32)), res)


def _jax_inputs(world: int) -> list:
    stacked = [np.stack([adasum_inputs(r)[j] for r in range(world)])
               for j in range(3)]
    return [jnp.asarray(stacked[0]), jnp.asarray(stacked[1]),
            jnp.asarray(stacked[2]).astype(jnp.bfloat16)]


def _close_layout(got, want, j, msg):
    if j == 2:      # the bf16 tensor
        err = float(np.abs(got - want).max())
        assert err <= BF16_STEPS * 2.0 ** -8 * np.abs(want).max(), (msg, err)
    else:
        np.testing.assert_allclose(got, want, rtol=LAYOUT_RTOL,
                                   atol=LAYOUT_ATOL, err_msg=msg)


def _same_bits(a, b, msg):
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=msg)


PAIR_CASES = ["random", "orthogonal", "parallel", "zero_a", "all_zero"]


def _pair_operands(case):
    rng = np.random.RandomState(PAIR_CASES.index(case))
    a, b = rng.randn(33).astype(np.float32), rng.randn(33).astype(np.float32)
    if case == "orthogonal":
        a[16:], b[:16] = 0.0, 0.0
    elif case == "parallel":
        b = 2.5 * a
    elif case == "zero_a":
        a[:] = 0.0
    elif case == "all_zero":
        a[:], b[:] = 0.0, 0.0
    return a, b


class TestPair:
    """``adasum_pair`` against JAX's on the same operands."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
    @pytest.mark.parametrize("case", PAIR_CASES)
    def test_against_jax(self, case, dtype):
        a, b = _pair_operands(case)
        ta = torch.from_numpy(a).to(getattr(torch, dtype))
        tb = torch.from_numpy(b).to(getattr(torch, dtype))
        got = TA.adasum_pair(ta, tb)
        assert got.dtype == ta.dtype
        want = JC.adasum_pair(jnp.asarray(a).astype(dtype),
                              jnp.asarray(b).astype(dtype))
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=PAIR_RTOL, atol=0)

    def test_rule_and_symmetry(self):
        """Orthogonal operands add, parallel equal ones average, an all-zero
        pair passes through as zeros, and the pair is bitwise symmetric."""
        a, b = (torch.from_numpy(x) for x in _pair_operands("orthogonal"))
        torch.testing.assert_close(TA.adasum_pair(a, b), a + b)
        torch.testing.assert_close(TA.adasum_pair(a, a), a)
        z = torch.zeros(5)
        assert torch.equal(TA.adasum_pair(z, z), z)
        for case in PAIR_CASES:
            a, b = (torch.from_numpy(x) for x in _pair_operands(case))
            assert torch.equal(TA.adasum_pair(a, b), TA.adasum_pair(b, a))

    def test_two_dimensional_operands(self):
        """A tensor's coefficients come from all its entries: a (3, 4)
        pair equals the pair of their flattenings, reshaped."""
        rng = np.random.RandomState(3)
        a, b = (torch.from_numpy(rng.randn(3, 4).astype(np.float32))
                for _ in range(2))
        got = TA.adasum_pair(a, b)
        assert got.shape == (3, 4)
        assert torch.equal(got, TA.adasum_pair(a.reshape(-1),
                                               b.reshape(-1)).view(3, 4))

    def test_zero_norm_fallbacks_counted(self):
        """On CPU tensors the guard's activations count into telemetry,
        as JAX counts them on its numpy plane."""
        from horovod_tpu_torch import telemetry

        telemetry.enable()
        try:
            telemetry.reset()
            TA.adasum_pair(torch.zeros(4), torch.ones(4))
            TA.adasum_pair(torch.zeros(4), torch.zeros(4))
            TA.adasum_pair(torch.ones(4), torch.ones(4))
            assert telemetry.value(
                "hvd_adasum_zero_norm_fallbacks_total") == 3
        finally:
            telemetry.reset()
            telemetry.disable()

    def test_tree_matches_jax_eager_tree(self):
        """adasum_tree over 5 rows against JAX's eager host tree."""
        from horovod_tpu.ops import eager as JE

        rng = np.random.RandomState(8)
        rows = rng.randn(5, 9).astype(np.float32)
        got = TA.adasum_tree([torch.from_numpy(r) for r in rows])
        want = JE._adasum_tree([r for r in rows], xp=np)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=LAYOUT_RTOL, atol=LAYOUT_ATOL)


@pytest.mark.parametrize("layout", ADASUM_LAYOUTS, ids=_name)
class TestLayout:
    """The reduction over each world's layout against JAX's over the mesh
    it stands for, and every rank's bits equal."""

    def test_grouped_per_tensor(self, worlds, layout):
        outs = _world(worlds, layout)
        world = layout[0] * layout[1]
        want = jax_ranks(layout, lambda axis, *xs:
                         JA.adasum_grouped_allreduce(list(xs), axis=axis),
                         *_jax_inputs(world))
        for r, out in enumerate(outs):
            for j, got in enumerate(out["grouped"]):
                _close_layout(got, want[j][r], j, f"rank {r} tensor {j}")

    def test_scaled_forms(self, worlds, layout):
        """grouped_allreduce(op=Adasum) with a prescale and a postscale,
        and allreduce(op=Adasum), against JAX's single-tensor allreduce
        (which applies both factors)."""
        outs = _world(worlds, layout)
        world = layout[0] * layout[1]
        pre, post = ADASUM_SCALES

        def fn(axis, *xs):
            return [JC.allreduce(x, op=JC.ReduceOp.ADASUM, axis=axis,
                                 prescale_factor=pre,
                                 postscale_factor=post) for x in xs] + \
                [JC.allreduce(xs[0], op=JC.ReduceOp.ADASUM, axis=axis)]

        want = jax_ranks(layout, fn, *_jax_inputs(world))
        for r, out in enumerate(outs):
            for j, got in enumerate(out["scaled"]):
                _close_layout(got, want[j][r], j, f"rank {r} tensor {j}")
            _close_layout(out["single"], want[3][r], 0, f"rank {r} single")
            assert out["inputs_kept"]

    def test_ranks_hold_the_same_bits(self, worlds, layout):
        outs = _world(worlds, layout)
        keys = ("grouped", "scaled", "single", "dao", "dao_k2", "mlp", "lm")
        for r, out in enumerate(outs[1:], 1):
            for key in keys:
                if key in outs[0]:
                    _same_bits(out[key], outs[0][key], f"rank {r} {key}")

    def test_eager_plane_agrees(self, worlds, layout):
        """On a world of one rank a node the eager plane's flat tree and
        the in-step reduction combine the same pairs in the same order:
        bit for bit.  Over 2 x 4 the in-step one averages within nodes
        first, so only the guard's count is read there.  The guard counts
        on the rank that combines rank 1's zero tensor."""
        outs = _world(worlds, layout)
        for out in outs:
            if layout[1] == 1:
                np.testing.assert_array_equal(out["eager"], out["single"])
        if layout[1] == 1:
            # rank 1 combines its own zero tensor in its first pair
            assert outs[1]["fallbacks"] >= 1
        else:
            # the node's mean is nonzero
            assert all(out["fallbacks"] == 0 for out in outs)


def _optax_twin(case: str):
    name, kw = DAO_CASES[case]
    if name == "SGD":
        return optax.sgd(kw["lr"], momentum=kw["momentum"])
    return optax.adamw(kw["lr"], weight_decay=kw["weight_decay"])


def _jax_dao(layout, case: str, k: int = 1):
    """JAX's DistributedAdasumOptimizer on dao_grads, the parameters after
    each micro-step, stacked over ranks."""
    _, axis = mesh_of(layout)
    opt = jhvd.DistributedAdasumOptimizer(_optax_twin(case), axis=axis,
                                          backward_passes_per_step=k)

    def fn(axis):
        r = JC.axis_index(axis)
        params = {"w": jnp.asarray(DAO_W0), "b": jnp.asarray(DAO_B0)}

        def body(carry, t):
            p, s = carry
            u, s = opt.update(dao_grads(r, t, xp=jnp), s, p)
            p = optax.apply_updates(p, u)
            return (p, s), p

        _, hist = jax.lax.scan(body, (params, opt.init(params)),
                               jnp.arange(DAO_STEPS * k, dtype=jnp.float32))
        return hist

    return jax_ranks(layout, fn)


@pytest.mark.parametrize("layout", ADASUM_TRAIN_LAYOUTS, ids=_name)
class TestDeltaOptimizer:
    """DistributedAdasumOptimizer against JAX's on the same per-rank
    gradients, flat and 2 x 4."""

    @pytest.mark.parametrize("case", list(DAO_CASES))
    def test_against_jax(self, worlds, layout, case):
        outs = _world(worlds, layout)
        want = _jax_dao(layout, case)
        for r, out in enumerate(outs):
            for k in ("w", "b"):
                np.testing.assert_allclose(
                    out["dao"][case][k], want[k][r, -1], rtol=OPT_RTOL,
                    atol=OPT_ATOL, err_msg=f"rank {r} {case} {k}")

    def test_backward_passes_per_step(self, worlds, layout):
        """k = 2: the parameters do not move on the first pass of a step,
        and each step equals JAX's MultiSteps(k=2) chain."""
        outs = _world(worlds, layout)
        want = _jax_dao(layout, "sgdm", k=2)
        for r, out in enumerate(outs):
            hist = out["dao_k2"]
            before = {"w": DAO_W0, "b": DAO_B0}
            for t, params in enumerate(hist):
                if t % 2 == 0:      # mid-way: unmoved
                    _same_bits(params, before, f"rank {r} pass {t}")
                before = params
                for k in ("w", "b"):
                    np.testing.assert_allclose(
                        params[k], want[k][r, t], rtol=OPT_RTOL,
                        atol=OPT_ATOL, err_msg=f"rank {r} pass {t} {k}")


def _jax_mlp_loss(p, x, y):
    h = jnp.tanh(x @ p["w1"] + p["b1"])
    return jnp.mean((h @ p["w2"] + p["b2"] - y) ** 2)


def _jax_mlp(layout, tx):
    """``ADASUM_MLP["steps"]`` steps of ``tx`` on each rank's rows of
    :func:`adasum_mlp_batch` (gradients reduced by ``tx`` itself)."""
    world = layout[0] * layout[1]
    x, y = adasum_mlp_batch(world)
    n = ADASUM_MLP["rows"]
    xs, ys = x.reshape(world, n, -1), y.reshape(world, n, -1)

    def fn(axis, xr, yr):
        params = jax.tree_util.tree_map(jnp.asarray, mlp_params())
        state = tx.init(params)
        for _ in range(ADASUM_MLP["steps"]):
            g = jax.grad(_jax_mlp_loss)(params, xr, yr)
            u, state = tx.update(g, state, params)
            params = optax.apply_updates(params, u)
        return params

    return jax_ranks(layout, fn, xs, ys)


@pytest.mark.parametrize("layout", ADASUM_TRAIN_LAYOUTS, ids=_name)
class TestOpAdasum:
    """op=Adasum on raw gradients: the hook path, the step-time path and
    DistributedTrainStep(op=Adasum) hold the same bits (buckets of 64
    bytes, so the hooks launch several), against JAX's
    DistributedOptimizer(optax.sgd, op=Adasum); and DistributedTrainStep(
    op=None) over DistributedAdasumOptimizer(SGD(momentum=0.9)) against
    JAX's delta form."""

    def test_hook_path_is_step_time_path(self, worlds, layout):
        for out in _world(worlds, layout):
            mlp = out["mlp"]
            assert mlp["hook"]["buckets"] > 1
            assert all(s == ["hook"] for s in mlp["hook"]["sources"])
            assert all(s == ["synchronize"]
                       for s in mlp["step_time"]["sources"])
            _same_bits(mlp["hook"]["params"], mlp["step_time"]["params"],
                       "hook vs step-time")
            _same_bits(mlp["hook"]["params"], mlp["train_step"]["params"],
                       "hook vs DistributedTrainStep")

    def test_against_jax(self, worlds, layout):
        outs = _world(worlds, layout)
        _, axis = mesh_of(layout)
        lr = ADASUM_MLP["lr"]
        want = _jax_mlp(layout, jhvd.DistributedOptimizer(
            optax.sgd(lr), op=JC.ReduceOp.ADASUM, axis=axis))
        delta = _jax_mlp(layout, jhvd.DistributedAdasumOptimizer(
            optax.sgd(lr, momentum=0.9), axis=axis))
        for r, out in enumerate(outs):
            for k in want:
                np.testing.assert_allclose(
                    out["mlp"]["hook"]["params"][k], want[k][r],
                    rtol=OPT_RTOL, atol=OPT_ATOL, err_msg=f"rank {r} {k}")
                np.testing.assert_allclose(
                    out["mlp"]["delta"]["params"][k], delta[k][r],
                    rtol=OPT_RTOL, atol=OPT_ATOL,
                    err_msg=f"rank {r} delta {k}")
            losses = out["mlp"]["delta"]["losses"]
            assert all(np.isfinite(losses))


class TestSlice:
    """The slice as a whole: the TransformerLM from the flax weights
    (``models/convert.py``), 3 steps of DistributedTrainStep(op=None)
    over DistributedAdasumOptimizer(AdamW(3e-4, weight_decay=1e-4)) on a
    world of 4 x 1, against JAX's DistributedAdasumOptimizer(
    optax.adamw(3e-4, weight_decay=1e-4)) on a 4-device mesh."""

    @pytest.fixture(scope="class")
    def jax_lm(self, lm_params0):
        model = JT.TransformerLM(JT.TransformerConfig(
            dtype=jnp.float32, attention_impl="dense", **ADASUM_LM))
        opt = jhvd.DistributedAdasumOptimizer(
            optax.adamw(3e-4, weight_decay=1e-4), axis="ranks")
        world = LM_LAYOUT[0]
        tok = adasum_lm_tokens()
        rows = tok.reshape(world, -1, tok.shape[1])

        def loss_fn(params, t):
            logits = model.apply(params, t[:, :-1])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, t[:, 1:]).mean()

        def fn(axis, t):
            params = jax.tree_util.tree_map(jnp.asarray, lm_params0)

            def body(carry, _):
                p, s = carry
                loss, g = jax.value_and_grad(loss_fn)(p, t)
                u, s = opt.update(g, s, p)
                return (optax.apply_updates(p, u), s), \
                    jax.lax.pmean(loss, axis)

            (params, _), losses = jax.lax.scan(
                body, (params, opt.init(params)), None,
                length=ADASUM_LM_STEPS)
            return losses, params

        losses, params = jax_ranks(LM_LAYOUT, fn, jnp.asarray(rows))
        return losses[0], jax.tree_util.tree_map(lambda v: v[0], params)

    def test_losses(self, worlds, jax_lm):
        want, _ = jax_lm
        for out in _world(worlds, LM_LAYOUT):
            got = out["lm"]["losses"]
            np.testing.assert_allclose(got, want, rtol=1e-5)
            assert got[-1] < got[0]

    def test_params(self, worlds, jax_lm):
        _, final = jax_lm
        want = params_from_flax(final)
        for out in _world(worlds, LM_LAYOUT):
            for name, p in out["lm"]["params"].items():
                assert_adam_close(p, want[name].numpy(), name,
                                  steps=ADASUM_LM_STEPS)


class TestWorldOfOne:
    """In process, a world of one: Adasum is the identity."""

    def test_identity(self, hvd_torch):
        xs = [torch.randn(3, 4), torch.randn(5).to(torch.bfloat16)]
        assert TA.adasum_grouped_allreduce(xs)[0] is xs[0]
        out = TC.grouped_allreduce(xs, op=TC.Adasum, postscale_factor=2.0)
        assert torch.equal(out[0], 2.0 * xs[0])
        assert out[1].dtype == torch.bfloat16

    def test_delta_form_is_the_local_step(self, hvd_torch):
        """DistributedAdasumOptimizer(AdamW) against AdamW alone on the
        same gradients: ``start + (local - start)`` differs from ``local``
        only where the subtraction rounds (a weight crossing zero)."""
        rng = np.random.RandomState(2)
        p0 = rng.randn(64).astype(np.float32)
        grads = [rng.randn(64).astype(np.float32) for _ in range(3)]
        a = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        b = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt_a = hvd_torch.DistributedAdasumOptimizer(
            torch.optim.AdamW([a], lr=1e-2))
        opt_b = torch.optim.AdamW([b], lr=1e-2)
        for g in grads:
            a.grad, b.grad = torch.from_numpy(g), torch.from_numpy(g.copy())
            opt_a.step()
            opt_b.step()
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)
        # every other attribute is the wrapped optimizer's
        assert opt_a.param_groups is opt_a.optimizer.param_groups
        assert opt_a.state_dict()["state"][0]["step"] == 3


class TestGuards:
    def test_int8_wire_refused(self, hvd_torch):
        with pytest.raises(ValueError, match="Sum/Average"):
            hvd_torch.DistributedAdasumOptimizer(
                torch.optim.SGD([torch.nn.Parameter(torch.ones(2))], lr=1),
                compression=hvd_torch.Compression.int8)
        with pytest.raises(ValueError, match="Sum/Average"):
            TC.grouped_allreduce([torch.ones(3)], op=TC.Adasum,
                                 quantized_bits=8)

    def test_step_takes_the_delta_form_with_op_none(self, hvd_torch):
        p = [torch.nn.Parameter(torch.ones(2))]
        dao = hvd_torch.DistributedAdasumOptimizer(
            torch.optim.SGD(p, lr=1))
        with pytest.raises(ValueError, match="op=None"):
            hvd_torch.DistributedTrainStep(lambda m, b: 0, dao)
        with pytest.raises(ValueError, match="op=None"):
            hvd_torch.DistributedTrainStep(lambda m, b: 0, dao, op=None,
                                           shard_optimizer_states=True)
        with pytest.raises(ValueError, match="compression"):
            hvd_torch.DistributedTrainStep(
                lambda m, b: 0, dao, op=None,
                compression=hvd_torch.Compression.fp16)
        step = hvd_torch.DistributedTrainStep(lambda m, b: 0, dao, op=None)
        assert step.optimizer is dao

    def test_op_adasum_refusals(self, hvd_torch):
        p = [torch.nn.Parameter(torch.ones(2))]
        with pytest.raises(ValueError, match="op=Average"):
            hvd_torch.DistributedOptimizer(torch.optim.SGD(p, lr=1),
                                           op=hvd_torch.Adasum,
                                           gradient_predivide_factor=2.0)
        with pytest.raises(ValueError, match="Sum/Average"):
            hvd_torch.DistributedOptimizer(torch.optim.SGD(p, lr=1),
                                           op=hvd_torch.Adasum,
                                           shard_optimizer_states=True)
        with pytest.raises(ValueError, match="backward_passes_per_step"):
            hvd_torch.DistributedAdasumOptimizer(
                torch.optim.SGD(p, lr=1), backward_passes_per_step=0)
        assert "DistributedAdasumOptimizer" in hvd_torch.__all__

    def test_layout_levels(self, hvd_torch):
        from horovod_tpu_torch.runtime import state

        st = state.global_state()
        assert st.layout_group("local") is None
        assert st.layout_group("cross") is None
        with pytest.raises(ValueError, match="layout level"):
            st.layout_group("node")
