"""The port's SyncBatchNorm (``optim/sync_batch_norm.py``) on gloo worlds
of 2 and 4, against the JAX package's ``SyncBatchNorm`` and
``sync_batch_stats`` under ``shard_map`` on as many of the 8 virtual CPU
devices (as tests/test_keras_layer.py sets them up), with the same numpy
input, upstream gradient and weights, fp32.

Tolerances: values (output, running mean and variance, the statistics)
rtol 1e-5, atol 1e-6, as the JAX package's test holds them.  Gradients
are sums over a rank's rows, or over the world's, taken in another order
in each package: rtol 1e-5 and atol 1e-5 times the largest entry of the
reference.  The defining property (SyncBatchNorm on N ranks equals
BatchNorm on the concatenated batch) holds to the same limits.  At a
world of one the module's forward is the port's ``BatchNorm``'s up to the
mean's last rounding: the module multiplies the sums by 1/n, as torch's
CUDA mean does, where the CPU's mean divides, so here the two may differ
by an ulp (rtol 1e-6); on the card they are equal bit for bit
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from horovod_tpu.optim import SyncBatchNorm as JSyncBatchNorm
from horovod_tpu.optim import sync_batch_stats as j_sync_batch_stats
from horovod_tpu.runtime.topology import GLOBAL_AXES
from horovod_tpu_torch.models.convert import variables_from_flax
from horovod_tpu_torch.models.resnet import BatchNorm

from torch_port_workers import (
    SYNC_BN_SHAPE,
    spawn_world,
    sync_bn_grads,
    sync_bn_inputs,
    sync_bn_module,
)

VALUE_TOL = dict(rtol=1e-5, atol=1e-6)


def assert_grad_close(got, want):
    np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def _mesh(world: int) -> Mesh:
    devs = np.asarray(jax.devices("cpu")[:world]).reshape(1, world)
    return Mesh(devs, GLOBAL_AXES)


def _nhwc(x):
    return x.transpose(0, 2, 3, 1)


def _nchw(x):
    return np.asarray(x).transpose(0, 3, 1, 2)


def jax_sync_bn(world: int) -> dict:
    """The JAX module on the world's shards: output, the input gradient of
    ``(y·g).sum()``, each shard's scale and bias gradients, and the updated
    running statistics; then the statistics of unequal shards (rank r's
    r + 1 rows, zero-padded, weighted by ``counts``) and their input
    gradient."""
    inp = sync_bn_inputs(world)
    mesh = _mesh(world)
    bn = JSyncBatchNorm(use_running_average=False)
    params = {"scale": jnp.asarray(inp["scale"]),
              "bias": jnp.asarray(inp["bias"])}
    stats = {"mean": jnp.asarray(inp["mean"]), "var": jnp.asarray(inp["var"])}

    def body(xl, gl):
        def loss(xl, p):
            y, upd = bn.apply({"params": p, "batch_stats": stats}, xl,
                              mutable=["batch_stats"])
            return (y * gl).sum(), (y, upd["batch_stats"])

        (_, (y, upd)), (dx, dp) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(xl, params)
        return (y, dx, dp["scale"][None], dp["bias"][None],
                upd["mean"][None], upd["var"][None])

    spec = P(GLOBAL_AXES)
    y, dx, ds, db, mean, var = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(spec, spec), out_specs=(spec,) * 6,
        check_vma=False))(jnp.asarray(_nhwc(inp["x"])),
                          jnp.asarray(_nhwc(inp["g"])))
    out = {"y": _nchw(y), "dx": _nchw(dx), "dscale": np.asarray(ds),
           "dbias": np.asarray(db), "mean": np.asarray(mean),
           "var": np.asarray(var)}

    # unequal shards: rank r holds r + 1 rows, padded with zeros to the
    # largest, which add nothing to the sums that counts weight
    b, c, h, w = SYNC_BN_SHAPE
    pad = np.zeros((world, world, c, h, w), np.float32)
    lo = 0
    for r in range(world):
        pad[r, :r + 1] = inp["u"][lo:lo + r + 1]
        lo += r + 1
    counts = np.array([(r + 1) * h * w for r in range(world)], np.float32)

    def stats_body(ul, cl):
        def f(ul):
            m, v = j_sync_batch_stats(ul[0].transpose(0, 2, 3, 1),
                                      counts=cl[0])
            return (m * inp["gm"]).sum() + (v * inp["gv"]).sum(), (m, v)

        (_, (m, v)), du = jax.value_and_grad(f, has_aux=True)(ul)
        return m[None], v[None], du

    m, v, du = jax.jit(jax.shard_map(
        stats_body, mesh=mesh, in_specs=(spec, spec),
        out_specs=(spec,) * 3, check_vma=False))(jnp.asarray(pad),
                                                  jnp.asarray(counts))
    out["counts"] = {"mean": np.asarray(m), "var": np.asarray(v),
                     "du": [np.asarray(du)[r, :r + 1] for r in range(world)]}
    return out


@pytest.fixture(scope="module", params=[2, 4])
def sync_world(request):
    world = request.param
    return world, spawn_world("run_sync_bn", world=world, timeout=180), \
        jax_sync_bn(world)


def _rank_rows(world, rank):
    b = SYNC_BN_SHAPE[0]
    return slice(rank * b, (rank + 1) * b)


class TestAgainstJax:
    def test_output_and_running_stats(self, sync_world):
        world, outs, ref = sync_world
        for rank, o in enumerate(outs):
            np.testing.assert_allclose(o["y"], ref["y"][_rank_rows(world,
                                                                   rank)],
                                       **VALUE_TOL)
            np.testing.assert_allclose(o["mean"], ref["mean"][rank],
                                       **VALUE_TOL)
            np.testing.assert_allclose(o["var"], ref["var"][rank],
                                       **VALUE_TOL)
            assert o["channels_last"]

    def test_gradients(self, sync_world):
        world, outs, ref = sync_world
        for rank, o in enumerate(outs):
            assert_grad_close(o["dx"], ref["dx"][_rank_rows(world, rank)])
            assert_grad_close(o["dscale"], ref["dscale"][rank])
            assert_grad_close(o["dbias"], ref["dbias"][rank])

    def test_unequal_counts(self, sync_world):
        world, outs, ref = sync_world
        for rank, o in enumerate(outs):
            got, want = o["counts"], ref["counts"]
            np.testing.assert_allclose(got["mean"], want["mean"][rank],
                                       **VALUE_TOL)
            np.testing.assert_allclose(got["var"], want["var"][rank],
                                       **VALUE_TOL)
            assert_grad_close(got["du"], want["du"][rank])

    def test_one_collective_each_way(self, sync_world):
        """One all-reduce in forward, one in backward, none with the
        running averages."""
        for o in sync_world[1]:
            assert o["calls"] == (1, 1)
            assert o["calls_running"] == 0


def _concat_batchnorm(inp, rows=None):
    """The port's BatchNorm(train=True) on the concatenated rows."""
    x, g = inp["x"], inp["g"]
    if rows is not None:
        x, g = x[rows], g[rows]
    bn = BatchNorm(x.shape[1])
    bn.load_state_dict({k: torch.from_numpy(inp[k].copy())
                        for k in ("scale", "bias", "mean", "var")})
    xt = torch.from_numpy(x.copy()).requires_grad_()
    y = bn(xt, train=True)
    (y * torch.from_numpy(g)).sum().backward()
    return {"y": y.detach().numpy(), "dx": xt.grad.numpy(),
            "dscale": bn.scale.grad.numpy(), "dbias": bn.bias.grad.numpy(),
            "mean": bn.mean.detach().numpy(), "var": bn.var.detach().numpy()}


class TestDefiningProperty:
    def test_equals_batchnorm_on_the_concatenated_batch(self, sync_world):
        """SyncBatchNorm on N ranks is BatchNorm on the N ranks' rows:
        outputs and input gradients row for row, the running statistics,
        and the scale and bias gradients summed over the ranks."""
        world, outs, _ = sync_world
        want = _concat_batchnorm(sync_bn_inputs(world))
        np.testing.assert_allclose(np.concatenate([o["y"] for o in outs]),
                                   want["y"], **VALUE_TOL)
        assert_grad_close(np.concatenate([o["dx"] for o in outs]),
                          want["dx"])
        for k in ("dscale", "dbias"):
            assert_grad_close(sum(o[k] for o in outs), want[k])
        for o in outs:
            np.testing.assert_allclose(o["mean"], want["mean"], **VALUE_TOL)
            np.testing.assert_allclose(o["var"], want["var"], **VALUE_TOL)

    def test_running_average_path(self, sync_world):
        """use_running_average normalizes with the updated running
        statistics, rank by rank, as BatchNorm(train=False) does."""
        world, outs, _ = sync_world
        inp = sync_bn_inputs(world)
        for rank, o in enumerate(outs):
            bn = BatchNorm(inp["scale"].size)
            bn.load_state_dict({
                "scale": torch.from_numpy(inp["scale"]),
                "bias": torch.from_numpy(inp["bias"]),
                "mean": torch.from_numpy(o["mean"]),
                "var": torch.from_numpy(o["var"])})
            x = torch.from_numpy(inp["x"][_rank_rows(world, rank)])
            with torch.no_grad():
                want = bn(x, train=False).numpy()
            np.testing.assert_allclose(o["running"], want, **VALUE_TOL)

    def test_group_of_two_at_world_four(self, sync_world):
        """With ``group=`` a pair of ranks, each pair normalizes over its
        own rows only (the worker makes the pairs at a world of 4)."""
        world, outs, _ = sync_world
        if world != 4:
            assert all("pair" not in o for o in outs)
            return
        inp = sync_bn_inputs(world)
        b = SYNC_BN_SHAPE[0]
        for pair in ((0, 1), (2, 3)):
            want = _concat_batchnorm(inp, slice(pair[0] * b,
                                                (pair[1] + 1) * b))
            got = [outs[r]["pair"] for r in pair]
            np.testing.assert_allclose(np.concatenate([o["y"] for o in got]),
                                       want["y"], **VALUE_TOL)
            assert_grad_close(np.concatenate([o["dx"] for o in got]),
                              want["dx"])
            for o in got:
                np.testing.assert_allclose(o["var"], want["var"],
                                           **VALUE_TOL)


@pytest.fixture
def hvd_cpu():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


class TestWorldOfOne:
    def test_forward_equals_batchnorm(self, hvd_cpu):
        """The statistics go through the collective at a world of one too,
        and the forward is the port's BatchNorm's up to the mean's last
        rounding; the gradients agree within the gradient limits."""
        inp = sync_bn_inputs(1)
        got = sync_bn_grads(torch, sync_bn_module(torch, inp),
                            torch.from_numpy(inp["x"]),
                            torch.from_numpy(inp["g"]))
        want = _concat_batchnorm(inp)
        for k in ("y", "mean", "var"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0)
        for k in ("dx", "dscale", "dbias"):
            assert_grad_close(got[k], want[k])

    def test_bf16_input_gradient_rounds_once(self, hvd_cpu):
        """In bf16 the input's gradient is BatchNorm's: its statistics and
        normalization parts are summed in fp32 and rounded once (two casts
        of the input would round them apart, 2.4e-3 normwise on an H100).
        The limit, 1e-4 normwise, leaves room for a rounding flipped by the
        mean's last ulp."""
        inp = sync_bn_inputs(1)
        x = torch.from_numpy(inp["x"]).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        g = torch.from_numpy(inp["g"]).to(torch.bfloat16)
        grads = []
        for m, kw in ((sync_bn_module(torch, inp), {}),
                      (BatchNorm(x.shape[1], dtype=torch.bfloat16),
                       {"train": True})):
            if kw:
                m.load_state_dict({k: torch.from_numpy(inp[k].copy()) for k
                                   in ("scale", "bias", "mean", "var")})
            xin = x.clone().requires_grad_()
            (m(xin, **kw).float() * g.float()).sum().backward()
            grads.append(xin.grad.float())
        got, want = grads
        assert float((got - want).norm() / want.norm()) <= 1e-4

    def test_bf16_channels_last_keeps_its_layout(self, hvd_cpu):
        inp = sync_bn_inputs(1)
        x = torch.from_numpy(inp["x"]).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        y = sync_bn_module(torch, inp)(x)
        assert y.dtype == torch.bfloat16
        assert y.is_contiguous(memory_format=torch.channels_last)
        y32 = sync_bn_module(torch, inp, dtype=torch.float32)(x)
        assert y32.dtype == torch.float32

    def test_options(self, hvd_cpu):
        from horovod_tpu_torch.optim import SyncBatchNorm

        bn = SyncBatchNorm(3, use_scale=False, use_bias=False,
                           use_running_average=True)
        assert [n for n, _ in bn.named_parameters()] == []
        assert sorted(bn.state_dict()) == ["mean", "var"]
        x = torch.randn(2, 3, 4, 4)
        np.testing.assert_allclose(bn(x).numpy(),
                                   (x / np.sqrt(1 + 1e-5)).numpy(),
                                   rtol=1e-6)


def test_flax_variables_map_onto_the_module():
    """A flax SyncBatchNorm's params/{scale,bias} and
    batch_stats/{mean,var} load into the module through
    ``variables_from_flax``, and both give the same normalization with the
    running statistics."""
    inp = sync_bn_inputs(1)
    x = inp["x"]
    flax_vars = JSyncBatchNorm(use_running_average=True).init(
        jax.random.PRNGKey(0), jnp.asarray(_nhwc(x)))
    flax_vars = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + np.linspace(0.1, 0.6, a.shape[-1],
                                              dtype=np.float32),
        jax.tree_util.tree_map(np.asarray, flax_vars))
    from horovod_tpu_torch.optim import SyncBatchNorm

    bn = SyncBatchNorm(x.shape[1], use_running_average=True)
    bn.load_state_dict(variables_from_flax(flax_vars))
    got = bn(torch.from_numpy(x)).detach().numpy()
    want = _nchw(JSyncBatchNorm(use_running_average=True).apply(
        flax_vars, jnp.asarray(_nhwc(x))))
    np.testing.assert_allclose(got, want, **VALUE_TOL)
