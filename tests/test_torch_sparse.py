"""The port's row-sparse exchange against the JAX package:
``sparse_allreduce``, ``_sparse_leaf_reduce`` (the static ``max_rows``
bound, its fill slots and the rows it drops), ``_match_sparse`` by whole
component, and ``sparse_params`` on ``distributed_gradients``,
``DistributedOptimizer`` (the hook path and the step-time path) and
``DistributedTrainStep``, each equal to the dense exchange; then every
guard and the ``HOROVOD_DEBUG_SPARSE`` warning.

Gloo worlds of 2 and 4 are spawned once for the module (``run_sparse`` in
``tests/torch_port_workers.py``); the JAX references run under
``shard_map`` over a one-axis mesh of as many CPU devices.  Tolerance:
rtol 1e-5, atol 1e-6 (the JAX package's TestSparseGradientRouting), and
ranks agree bit for bit."""

import logging
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.ops import collectives as JC
from horovod_tpu.optim import optimizer as JO
from horovod_tpu_torch.ops import collectives as TC
from horovod_tpu_torch.optim import optimizer as TO

from torch_port_workers import (
    SPARSE_ROWS,
    sparse_inputs,
    sparse_model_params,
    sparse_tokens,
    spawn_world,
)

from test_torch_train_step import hvd_torch  # noqa: F401 - fixture

RTOL, ATOL = 1e-5, 1e-6
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def worlds():
    with ThreadPoolExecutor(max_workers=2) as pool:
        futs = {w: pool.submit(spawn_world, "run_sparse", world=w,
                               timeout=240) for w in WORLDS}
        return {w: f.result() for w, f in futs.items()}


def jax_ranks(world, fn, *stacked):
    """``fn(*row)`` on each of ``world`` CPU devices (axis ``"ranks"``);
    the outputs stacked over ranks, as numpy."""
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("ranks",))

    def body(*xs):
        out = fn(*[x[0] for x in xs])
        return jax.tree_util.tree_map(lambda y: y[None], out)

    res = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=tuple(P("ranks") for _ in stacked),
        out_specs=P("ranks"), check_vma=False))(
        *[jnp.asarray(a) for a in stacked])
    return jax.tree_util.tree_map(np.asarray, res)


def _stacked(world, key):
    return np.stack([sparse_inputs(r)[key] for r in range(world)])


def _close(got, want, msg):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=msg)


def _same_bits(outs, key):
    for r, out in enumerate(outs[1:], 1):
        for x, y in zip(jax.tree_util.tree_leaves(out[key]),
                        jax.tree_util.tree_leaves(outs[0][key])):
            np.testing.assert_array_equal(x, y, err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("world", WORLDS)
class TestCollective:
    @pytest.mark.parametrize("op", ["Sum", "Average"])
    def test_sparse_allreduce_against_jax(self, worlds, world, op):
        """The last slot of every rank is the fill index with a nonzero
        value: it must contribute nothing, as JAX's scatter drops it."""
        outs = worlds[world]
        want = jax_ranks(world, lambda v, i: JC.sparse_allreduce(
            v, i, SPARSE_ROWS, axis="ranks", op=getattr(JC.ReduceOp,
                                                        op.upper())),
            _stacked(world, "values"), _stacked(world, "indices"))
        dense = np.zeros((SPARSE_ROWS, 3), np.float64)
        for r in range(world):
            inp = sparse_inputs(r)
            for v, i in zip(inp["values"][:-1], inp["indices"][:-1]):
                dense[i] += v
        if op == "Average":
            dense /= world
        for r, out in enumerate(outs):
            _close(out[("allreduce", op)], want[r], f"rank {r}")
            _close(out[("allreduce", op)], dense, f"rank {r} vs numpy")
        _same_bits(outs, ("allreduce", op))

    @pytest.mark.parametrize("op", ["Sum", "Average"])
    @pytest.mark.parametrize("bound", [2, 8])
    def test_leaf_reduce_against_jax(self, worlds, world, op, bound):
        """Each rank touches 4 rows: a bound of 2 drops the last two as
        ``jnp.nonzero(size=2)`` does, a bound of 8 leaves 4 fill slots."""
        outs = worlds[world]
        jop = getattr(JC.ReduceOp, op.upper())
        want = jax_ranks(world, lambda g: JO._sparse_leaf_reduce(
            g, bound, jop, "ranks"), _stacked(world, "grad"))
        for r, out in enumerate(outs):
            _close(out[("leaf", op, bound)], want[r], f"rank {r}")
        _same_bits(outs, ("leaf", op, bound))
        if bound == 8:      # nothing dropped: the dense reduction
            dense = _stacked(world, "grad").astype(np.float64).sum(0)
            if op == "Average":
                dense /= world
            _close(outs[0][("leaf", op, bound)], dense, "vs dense")

    def test_distributed_gradients_with_names(self, worlds, world):
        """A mapping of names to gradients: "table.emb" goes row-sparse,
        "head" through the buckets; both the dense Average."""
        outs = worlds[world]
        grads = _stacked(world, "grad").astype(np.float64)
        heads = _stacked(world, "values").astype(np.float64)
        for out in outs:
            got = out["distributed_gradients"]
            _close(got["table.emb"], grads.mean(0), "table.emb")
            _close(got["head"], heads.mean(0), "head")
        _same_bits(outs, "distributed_gradients")


def _jax_emb_updates(world, sparse_params):
    """JAX's DistributedOptimizer(optax.sgd(1.0), sparse_params) on each
    rank's tokens (TestSparseGradientRouting's loss); the new parameters."""
    p0 = sparse_model_params()
    tx = jhvd.DistributedOptimizer(optax.sgd(1.0), op=JC.Average,
                                   axis="ranks",
                                   sparse_params=sparse_params)

    def fn(tok):
        params = jax.tree_util.tree_map(jnp.asarray, p0)

        def loss(p):
            return jnp.sum((p["emb"][tok] @ p["w"]) ** 2)

        u, _ = tx.update(jax.grad(loss)(params), tx.init(params), params)
        return optax.apply_updates(params, u)

    return jax_ranks(world, fn, sparse_tokens(world))


@pytest.mark.parametrize("world", WORLDS)
class TestOptimizer:
    @pytest.mark.parametrize("bound", [4, 16])
    @pytest.mark.parametrize("path", ["hook", "step_time"])
    def test_equals_dense(self, worlds, world, bound, path):
        """``sparse_params={"emb": bound}`` (4: the tight bound of 4 lookups
        a rank; 16: fill slots) against the dense exchange and JAX's sparse
        routing, on the hook path and the step-time path."""
        outs = worlds[world]
        want = _jax_emb_updates(world, {"emb": bound})
        for r, out in enumerate(outs):
            got, dense = out[("opt", bound, path)], out[("opt", None, path)]
            for k in ("emb", "w"):
                _close(got[k], dense[k], f"rank {r} {k} vs dense")
                _close(got[k], want[k][r], f"rank {r} {k} vs JAX")
        _same_bits(outs, ("opt", bound, path))

    def test_train_step(self, worlds, world):
        """DistributedTrainStep(sparse_params={"emb": 8}) against the dense
        step: the same loss and parameters."""
        for r, out in enumerate(worlds[world]):
            got, dense = out[("step", 8)], out[("step", None)]
            _close(got["loss"], dense["loss"], f"rank {r} loss")
            for k in ("emb", "w"):
                _close(got["params"][k], dense["params"][k], f"rank {r} {k}")
        _same_bits(worlds[world], ("step", 8))


MATCH_PATTERNS = ["emb", "embedding", "encoder/embedding", "member", "mem",
                  "encoder", "w"]


class TestMatch:
    def test_whole_components_as_jax(self):
        """The same tree as JAX paths and as ``named_parameters`` names:
        each pattern matches the same leaves, and "emb" never "member"."""
        tree = {"encoder": {"embedding": 0, "member": 0}, "emb": 0, "w": 0}
        paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
        names = [".".join(JO._path_components(p)) for p in paths]
        for pat in MATCH_PATTERNS:
            sp = {pat: 7}
            assert [TO._match_sparse(n, sp) for n in names] == \
                [JO._match_sparse(p, sp) for p in paths], pat
        assert TO._match_sparse("encoder.member", {"emb": 7}) is None
        assert TO._match_sparse("emb.weight", {"emb": 7}) == 7

    def test_dotted_full_name(self):
        """A full name may be written with "." (the port's names) or "/"
        (JAX's paths)."""
        for pat in ("encoder.embedding.weight", "encoder/embedding/weight"):
            assert TO._match_sparse("encoder.embedding.weight",
                                    {pat: 3}) == 3
        assert TO._match_sparse("encoder.embedding.weight",
                                {"encoder.embedding": 3}) is None
        assert TO._match_sparse("x", None) is None


def _emb_model():
    return torch.nn.ParameterDict({
        k: torch.nn.Parameter(torch.from_numpy(v.copy()))
        for k, v in sparse_model_params().items()})


class TestGuards:
    def test_optimizer(self, hvd_torch):
        m = _emb_model()
        sgd = torch.optim.SGD(m.parameters(), lr=1.0)
        with pytest.raises(ValueError, match="Sum/Average"):
            hvd_torch.DistributedOptimizer(
                sgd, named_parameters=m.named_parameters(),
                op=hvd_torch.Adasum, sparse_params={"emb": 4})
        with pytest.raises(ValueError, match="sparse_params"):
            hvd_torch.DistributedOptimizer(
                sgd, named_parameters=m.named_parameters(),
                sparse_params={"emb": 4}, shard_optimizer_states=True)
        with pytest.raises(ValueError, match="named_parameters"):
            hvd_torch.DistributedOptimizer(sgd, sparse_params={"emb": 4})
        with pytest.raises(ValueError, match="op=Average"):
            hvd_torch.DistributedOptimizer(
                sgd, named_parameters=m.named_parameters(),
                op=hvd_torch.Sum, sparse_params={"emb": 4},
                gradient_predivide_factor=2.0)
        with pytest.raises(ValueError, match="mapping"):
            TO.distributed_gradients([torch.ones(3)],
                                     sparse_params={"emb": 4})

    def test_collective(self, hvd_torch):
        for op in (TC.Adasum, TC.ReduceOp.MAX):
            with pytest.raises(ValueError, match="Sum/Average"):
                TC.sparse_allreduce(torch.ones(2, 3), torch.arange(2), 4,
                                    op=op)

    def test_train_step(self, hvd_torch):
        m = _emb_model()

        def sgd():
            return torch.optim.SGD(m.parameters(), lr=1.0)

        with pytest.raises(ValueError, match="op=None"):
            hvd_torch.DistributedTrainStep(lambda m, b: 0, sgd(), op=None,
                                           sparse_params={"emb": 4})
        with pytest.raises(ValueError, match="compression"):
            hvd_torch.DistributedTrainStep(
                lambda m, b: 0, sgd(), op=None,
                compression=hvd_torch.Compression.fp16)
        with pytest.raises(ValueError, match="shard_optimizer_states"):
            hvd_torch.DistributedTrainStep(lambda m, b: 0, sgd(),
                                           sparse_params={"emb": 4},
                                           shard_optimizer_states=True)
        with pytest.raises(ValueError, match="Sum/Average"):
            hvd_torch.DistributedTrainStep(lambda m, b: 0, sgd(),
                                           op=hvd_torch.Adasum,
                                           sparse_params={"emb": 4})
        wrapped = hvd_torch.DistributedOptimizer(sgd())
        with pytest.raises(ValueError, match="sparse_params"):
            hvd_torch.DistributedTrainStep(lambda m, b: 0, wrapped,
                                           sparse_params={"emb": 4})
        step = hvd_torch.DistributedTrainStep(lambda m, b: 0, sgd(),
                                              sparse_params={"emb": 4})
        with pytest.raises(RuntimeError, match="init"):
            step(m, step.optimizer, None)
        _, opt = step.init(m)
        assert opt._sparse == {0: 4}

    def test_debug_warning(self, hvd_torch, monkeypatch, caplog):
        """Under HOROVOD_DEBUG_SPARSE a bound that drops rows is logged;
        without it, or within the bound, nothing is."""
        g = torch.zeros(10, 2)
        g[[1, 4, 7]] = 1.0
        with caplog.at_level(logging.WARNING):
            TO._sparse_leaf_reduce(g, 2, TC.Sum)
            assert not caplog.records
            monkeypatch.setenv("HOROVOD_DEBUG_SPARSE", "1")
            TO._sparse_leaf_reduce(g, 3, TC.Sum)
            assert not caplog.records
            out = TO._sparse_leaf_reduce(g, 2, TC.Sum)
        assert "3 touched rows exceed max_rows=2" in caplog.text
        assert torch.equal(out[7], torch.zeros(2))
        assert torch.equal(out[[1, 4]], g[[1, 4]])
