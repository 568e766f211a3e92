"""The port's ResNet (``horovod_tpu_torch.models.resnet``), the variable
conversion, and the ResNet training step against the flax model and the
JAX ``DistributedTrainStep``.

A narrow ResNet (``stage_sizes=[1, 1]``, 128 filters, so that the first
block's 3x3 segment is on the fused kernel's rule; 32 px, 10 classes) in
fp32, under weights from the flax init with the BatchNorm statistics and
scales moved off their init values, so that no gradient is trivially 0.
Inputs come from numpy.  Tolerances are stated per check.
"""

import flax
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import resnet as JR
from horovod_tpu_torch.models import resnet as TR
from horovod_tpu_torch.models.convert import (
    params_from_flax,
    variables_from_flax,
)

from torch_port_workers import resnet_batch, run_train_resnet, spawn_world

NARROW = dict(stage_sizes=[1, 1], num_classes=10, num_filters=128)
MODES = [(False, False), (False, True), (True, False), (True, True)]
MODE_IDS = ["7x7", "7x7-fused", "s2d", "s2d-fused"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.meta.unbox(tree))


def _perturb(variables, seed=5):
    """BN scale and var up by U(0, 0.5), bias and mean by N(0, 0.1)."""
    rng = np.random.RandomState(seed)

    def move(path, a):
        key = getattr(path[-1], "key", "")
        if key in ("scale", "var"):
            return a + rng.rand(*a.shape).astype(np.float32) * 0.5
        if key in ("bias", "mean"):
            return a + rng.randn(*a.shape).astype(np.float32) * 0.1
        return a

    return jax.tree_util.tree_map_with_path(move, variables)


def _flax_model(s2d, fused, dtype=jnp.float32):
    return JR.ResNet(**NARROW, dtype=dtype, space_to_depth=s2d,
                     fused_bwd=fused)


def _torch_model(variables, s2d, fused, dtype=torch.float32):
    model = TR.ResNet(**NARROW, dtype=dtype, space_to_depth=s2d,
                      fused_bwd=fused)
    model.load_state_dict(variables_from_flax(variables))
    return model


def _init(s2d, fused, seed=0):
    x, _ = resnet_batch(4, 32, seed)
    v = _flax_model(s2d, fused).init(jax.random.PRNGKey(seed),
                                     jnp.asarray(x), train=False)
    return _perturb(_np_tree(v))


@pytest.fixture(scope="module", params=MODES, ids=MODE_IDS)
def flax_case(request):
    """(s2d, fused, variables, batch, logits, loss, grads) of the flax
    model in inference-mode BN, the bench's loss."""
    s2d, fused = request.param
    variables = _init(s2d, fused)
    x, y = resnet_batch(4, 32, seed=1)
    model = _flax_model(s2d, fused)

    def loss_fn(v):
        logits = model.apply(v, jnp.asarray(x), train=False)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean(), logits

    (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables)
    return (s2d, fused, variables, (x, y), np.asarray(logits), float(loss),
            _np_tree(grads))


def _batch(x, y):
    return {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}


class TestConvert:
    @pytest.mark.parametrize("kernel,stride", [(3, 1), (3, 2), (4, 1),
                                               (1, 2), (7, 2)])
    def test_conv_kernel_hwio_to_oihw(self, kernel, stride):
        """A flax nn.Conv with a non-symmetric kernel and the port's Conv
        give the same output after conversion (fp32, 1e-5), with XLA's
        SAME padding (a 3x3 stride-2 conv pads (0, 1) on an even input,
        a 4x4 stride-1 one (1, 2))."""
        conv = nn.Conv(5, (kernel, kernel), (stride, stride), use_bias=False)
        x = np.random.RandomState(0).randn(2, 8, 10, 3).astype(np.float32)
        k = np.random.RandomState(1).randn(kernel, kernel, 3, 5).astype(
            np.float32)
        if kernel > 1:
            assert not np.allclose(k, k.transpose(1, 0, 2, 3))
        want = conv.apply({"params": {"kernel": k}}, jnp.asarray(x))
        port = TR.Conv(3, 5, kernel, stride)
        port.load_state_dict(params_from_flax({"params": {"kernel": k}}))
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)

    def test_plain_transpose_swaps_h_and_w(self):
        """The fault the conversion repairs: ``kernel.T`` has the right
        OIHW shape for a square kernel, but its H and W are swapped, so a
        non-symmetric 3x3 conv computes something else."""
        k = np.random.RandomState(2).randn(3, 3, 4, 6).astype(np.float32)
        x = torch.from_numpy(
            np.random.RandomState(3).randn(1, 4, 6, 6).astype(np.float32))
        good = params_from_flax({"kernel": k})["weight"]
        assert tuple(good.shape) == tuple(k.T.shape) == (6, 4, 3, 3)
        out = torch.nn.functional.conv2d(x, good, padding=1)
        out_t = torch.nn.functional.conv2d(x, torch.from_numpy(k.T.copy()),
                                           padding=1)
        assert float((out - out_t).abs().max()) > 0.1

    def test_dense_kernel_is_transposed(self):
        k = np.arange(12, dtype=np.float32).reshape(3, 4)
        sd = params_from_flax({"params": {"Dense_0": {"kernel": k}}})
        np.testing.assert_array_equal(sd["Dense_0.weight"].numpy(), k.T)

    def test_batch_stats_are_carried(self):
        v = _init(True, True)
        sd = variables_from_flax(v)
        np.testing.assert_array_equal(
            sd["bn_init.mean"].numpy(), v["batch_stats"]["bn_init"]["mean"])
        np.testing.assert_array_equal(
            sd["BottleneckBlock_0.FusedConvBnRelu3x3_0.var"].numpy(),
            v["batch_stats"]["BottleneckBlock_0"]["FusedConvBnRelu3x3_0"][
                "var"])
        assert not any(n.endswith((".mean", ".var"))
                       for n in params_from_flax(v))

    @pytest.mark.parametrize("s2d,fused", MODES, ids=MODE_IDS)
    def test_every_leaf_maps(self, s2d, fused):
        sd = variables_from_flax(_init(s2d, fused))
        model = TR.ResNet(**NARROW, space_to_depth=s2d, fused_bwd=fused)
        assert set(sd) == set(model.state_dict())
        for name, t in model.state_dict().items():
            assert tuple(sd[name].shape) == tuple(t.shape), name

    @pytest.mark.parametrize("fused", [False, True])
    def test_resnet50_size_at_full_width(self, fused):
        """ResNet-50 at bench.py's width (1000 classes, 64 filters, s2d):
        the port's parameters are flax's params plus batch_stats, leaf for
        leaf (25,557,032 + 53,120 values unfused)."""
        model = JR.ResNet50(num_classes=1000, space_to_depth=True,
                            fused_bwd=fused)
        shapes = jax.eval_shape(
            lambda: model.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 224, 224, 3)), train=False))
        leaves = jax.tree_util.tree_leaves(flax.core.meta.unbox(shapes))
        with torch.device("meta"):
            port = TR.ResNet50(num_classes=1000, space_to_depth=True,
                               fused_bwd=fused)
        assert sum(p.numel() for p in port.parameters()) == \
            sum(int(np.prod(x.shape)) for x in leaves)
        assert len(list(port.parameters())) == len(leaves)
        if not fused:
            n_stats = sum(p.numel() for n, p in port.named_parameters()
                          if n.endswith((".mean", ".var")))
            assert n_stats == 53_120
            # 25,557,032 with the 7x7 stem; the s2d stem has (12·4·4 − 3·7·7)·64
            # = 2,880 more
            assert sum(p.numel() for p in port.parameters()) - n_stats == \
                25_559_912


class TestPieces:
    @pytest.mark.parametrize("size", [1, 2, 5, 7, 8, 14, 15, 112, 224])
    @pytest.mark.parametrize("kernel,stride", [(1, 1), (1, 2), (3, 1),
                                               (3, 2), (4, 1), (7, 2)])
    def test_same_padding_is_xla(self, size, kernel, stride):
        want = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")
        assert TR.same_padding(size, kernel, stride) == tuple(want[0])

    def test_space_to_depth(self):
        x = np.random.RandomState(4).randn(2, 6, 8, 3).astype(np.float32)
        want = JR.space_to_depth_2x2(jnp.asarray(x))
        got = TR.space_to_depth_2x2(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        with pytest.raises(ValueError, match="even"):
            TR.space_to_depth_2x2(torch.zeros(1, 5, 4, 3))

    def test_max_pool_matches_flax(self):
        x = np.random.RandomState(5).randn(2, 9, 8, 4).astype(np.float32)
        want = nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                           padding=((1, 1), (1, 1)))
        got = torch.nn.functional.max_pool2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, padding=1)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(want))

    @pytest.mark.parametrize("train", [False, True])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_batchnorm_matches_flax(self, train, dtype):
        """flax nn.BatchNorm(momentum 0.9, eps 1e-5, dtype): output, and in
        train mode the running update with the biased batch variance.
        fp32: 1e-5; bf16: the output is rounded once from the same fp32
        value on both sides (up to one bf16 step, 2^-7 relative)."""
        rng = np.random.RandomState(6)
        x = (rng.randn(4, 5, 6, 8) * 2 + 1).astype(np.float32)
        stats = {"mean": rng.randn(8).astype(np.float32),
                 "var": (rng.rand(8) + 0.5).astype(np.float32)}
        params = {"scale": (rng.rand(8) + 0.5).astype(np.float32),
                  "bias": rng.randn(8).astype(np.float32)}
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        bn = nn.BatchNorm(use_running_average=not train, momentum=0.9,
                          epsilon=1e-5, dtype=jdt)
        xj = jnp.asarray(x).astype(jdt)
        want, upd = bn.apply({"params": params, "batch_stats": stats}, xj,
                             mutable=["batch_stats"])
        port = TR.BatchNorm(8, dtype=tdt)
        port.load_state_dict(variables_from_flax(
            {"params": params, "batch_stats": stats}))
        got = port(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2), train)
        assert got.dtype == tdt
        tol = 1e-5 if dtype == "float32" else 2 ** -7
        np.testing.assert_allclose(
            got.float().permute(0, 2, 3, 1).detach().numpy(),
            np.asarray(want, np.float32), rtol=tol, atol=tol)
        for key in ("mean", "var"):
            np.testing.assert_allclose(
                getattr(port, key).detach().numpy(),
                np.asarray(upd["batch_stats"][key]), rtol=1e-5, atol=1e-6)


def _leaf_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


#: normwise agreement of one gradient leaf.  fp32 sums in another order
#: move a leaf by ~1e-6; a relu whose input lies within fp32 rounding of 0
#: can take the other branch on one side, and such a single flipped element
#: was measured at 2.9e-3 on the BN bias it feeds (s2d, against a float64
#: run of the port, which JAX's fp32 gradient matched to 2.5e-7)
LEAF_TOL = 1e-2


class TestResNetParity:
    """fp32, the flax model against the port under the same variables:
    logits 1e-4, the loss 1e-5 relative, and the gradient of every leaf,
    batch_stats included, normwise within :data:`LEAF_TOL`, and all leaves
    together within 1e-3 (1.8e-4 measured with one flipped relu)."""

    def test_logits(self, flax_case):
        s2d, fused, variables, (x, y), logits, _, _ = flax_case
        got = _torch_model(variables, s2d, fused)(torch.from_numpy(x),
                                                  train=False)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), logits, rtol=1e-4,
                                   atol=1e-4)

    def test_loss(self, flax_case):
        s2d, fused, variables, batch, _, loss, _ = flax_case
        got = TR.resnet_loss(_torch_model(variables, s2d, fused),
                             _batch(*batch))
        np.testing.assert_allclose(float(got.detach()), loss, rtol=1e-5)

    def test_grads_of_every_leaf(self, flax_case):
        s2d, fused, variables, batch, _, _, grads = flax_case
        model = _torch_model(variables, s2d, fused)
        TR.resnet_loss(model, _batch(*batch)).backward()
        want = variables_from_flax(grads)
        assert set(want) == {n for n, _ in model.named_parameters()}
        for name, p in model.named_parameters():
            if fused and "FusedConvBnRelu3x3_0." in name and \
                    name.endswith((".mean", ".var")):
                assert not p.grad.any() and not want[name].any(), name
                continue
            assert _leaf_rel(p.grad, want[name]) <= LEAF_TOL, name
        got_all = np.concatenate([p.grad.numpy().ravel()
                                  for _, p in model.named_parameters()])
        want_all = np.concatenate([want[n].numpy().ravel()
                                   for n, _ in model.named_parameters()])
        assert _leaf_rel(got_all, want_all) <= 1e-3

    @pytest.mark.parametrize("s2d", [False, True])
    def test_train_mode_forward_and_running_stats(self, s2d):
        """train=True: batch statistics, and the running statistics
        updated as flax's mutable batch_stats (logits 1e-4, statistics
        1e-5 relative plus 1e-6)."""
        variables = _init(s2d, False)
        x, _ = resnet_batch(4, 32, seed=2)
        want, upd = _flax_model(s2d, False).apply(
            variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        model = _torch_model(variables, s2d, False)
        got = model(torch.from_numpy(x), train=True)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
        stats = variables_from_flax({"batch_stats": _np_tree(
            upd["batch_stats"])})
        sd = model.state_dict()
        for name, ref in stats.items():
            np.testing.assert_allclose(sd[name].numpy(), ref.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)

    def test_fused_model_refuses_train_mode(self):
        model = TR.ResNet(**NARROW, fused_bwd=True)
        with pytest.raises(ValueError, match="train=False"):
            model(torch.zeros(1, 32, 32, 3))

    def test_bf16_logits_follow_flax(self):
        """bf16 compute, s2d, fused: each side rounds to bf16 at the same
        places (conv outputs, BN outputs, the pooled features), from fp32
        values that differ in summation order, so a value may round one
        step apart and move on; the fp32 logits are held to 5e-2 of the
        largest one."""
        variables = _init(True, True)
        x, _ = resnet_batch(4, 32, seed=3)
        want = np.asarray(_flax_model(True, True, jnp.bfloat16).apply(
            variables, jnp.asarray(x), train=False))
        model = _torch_model(variables, True, True, torch.bfloat16)
        got = model(torch.from_numpy(x), train=False)
        assert got.dtype == torch.float32
        err = np.abs(got.detach().numpy() - want).max()
        assert err <= 5e-2 * np.abs(want).max(), err


class TestSgdConfig:
    @pytest.mark.parametrize("steps", [1, 3])
    def test_torch_sgd_momentum_matches_optax(self, steps):
        """torch.optim.SGD(0.01, momentum=0.9) is optax.sgd(0.01,
        momentum=0.9): both keep v = g + 0.9·v from a zero (optax) or
        first-gradient (torch) start and step by -0.01·v.  fp32, 1e-6;
        nesterov moves the parameters further, which the same tolerance
        rejects."""
        rng = np.random.RandomState(7)
        p0 = rng.randn(64).astype(np.float32)
        grads = [rng.randn(64).astype(np.float32) for _ in range(steps)]
        tx = optax.sgd(0.01, momentum=0.9)
        pj, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
        for g in grads:
            upd, state = tx.update(jnp.asarray(g), state, pj)
            pj = optax.apply_updates(pj, upd)

        def run(**kw):
            pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
            opt = torch.optim.SGD([pt], lr=0.01, momentum=0.9, **kw)
            for g in grads:
                pt.grad = torch.from_numpy(g)
                opt.step()
            return pt.detach().numpy()

        np.testing.assert_allclose(run(), np.asarray(pj), rtol=0, atol=1e-6)
        assert np.abs(run(nesterov=True) - np.asarray(pj)).max() > 1e-4


@pytest.fixture
def hvd_torch():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


@pytest.fixture(scope="module")
def jax_resnet_run():
    """Three optax.sgd(0.01, momentum=0.9) steps of the JAX
    DistributedTrainStep on the conftest CPU mesh (8 devices), global
    batch 8, inference-mode BN, fused_bwd=True, the whole variable tree
    trained (bench.py:526-541)."""
    import horovod_tpu as hvd

    hvd.init()
    try:
        variables0 = _init(True, True, seed=4)
        model = _flax_model(True, True)

        def loss_fn(params, batch):
            logits = model.apply(params, batch["x"], train=False)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, batch["y"]).mean()

        step = hvd.DistributedTrainStep(loss_fn,
                                        optax.sgd(0.01, momentum=0.9))
        params, opt_state = step.init(variables0)
        x, y = resnet_batch(8, 32, seed=5)
        batch = step.shard_batch({"x": x, "y": y.astype(np.int32)})
        losses = []
        for _ in range(3):
            params, opt_state, loss = step(params, opt_state, batch)
            losses.append(float(loss))
        final = _np_tree(params)
    finally:
        hvd.shutdown()
    return variables0, losses, final


class TestTrainStepAgainstJax:
    """fp32 on both sides.  Losses 1e-5 relative.  After three SGD steps
    each leaf of params and batch_stats has moved by the same update,
    normwise within :data:`LEAF_TOL` (the update is linear in the
    gradients, held as in :class:`TestResNetParity`), and agrees to 1e-5
    relative plus 1e-5 (the flipped relu moves a few weights by 2e-6)."""

    def _port_run(self, hvd, variables0):
        model = _torch_model(variables0, True, True)
        opt = hvd.DistributedOptimizer(torch.optim.SGD(
            model.parameters(), lr=0.01, momentum=0.9))
        step = hvd.DistributedTrainStep(TR.resnet_loss, opt)
        model, opt = step.init(model)
        x, y = resnet_batch(8, 32, seed=5)
        batch = step.shard_batch({"x": x, "y": y})
        losses = []
        for _ in range(3):
            model, opt, loss = step(model, opt, batch)
            losses.append(float(loss))
        return losses, model

    def test_losses(self, hvd_torch, jax_resnet_run):
        variables0, want, _ = jax_resnet_run
        got, _ = self._port_run(hvd_torch, variables0)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert got[-1] < got[0]

    def test_params_and_batch_stats(self, hvd_torch, jax_resnet_run):
        variables0, _, final = jax_resnet_run
        _, model = self._port_run(hvd_torch, variables0)
        want = variables_from_flax(final)
        start = variables_from_flax(variables0)
        moved = 0
        for name, p in model.state_dict().items():
            update = want[name].numpy() - start[name].numpy()
            if not update.any():
                np.testing.assert_array_equal(p.numpy(), want[name].numpy())
                continue
            assert _leaf_rel(p.numpy() - start[name].numpy(),
                             update) <= LEAF_TOL, name
            np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
            moved += name.endswith((".mean", ".var"))
        # SGD moved the unfused BNs' statistics, as the JAX step does
        assert moved > 0


@pytest.fixture(scope="module")
def gloo_resnet():
    return spawn_world("run_train_resnet", world=2, args=(3,), timeout=240)


class TestGlooWorld:
    def test_world_of_two_matches_world_of_one(self, hvd_torch, gloo_resnet):
        """Half batches per rank, averaged, against the full batch on one
        rank (inference-mode BN makes every image independent): the same
        trajectory within fp32 reassociation (1e-5 relative on the loss,
        1e-5 relative plus 1e-6 on every parameter and statistic)."""
        want_losses, want_state = run_train_resnet(hvd_torch, 3)
        for losses, state in gloo_resnet:
            np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
            for k, v in state.items():
                np.testing.assert_allclose(v, want_state[k], rtol=1e-5,
                                           atol=1e-6, err_msg=k)
        (l0, s0), (l1, s1) = gloo_resnet
        assert l0 == l1
        for k in s0:
            np.testing.assert_array_equal(s0[k], s1[k], err_msg=k)
