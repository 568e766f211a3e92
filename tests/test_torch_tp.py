"""The port's tensor-parallel slice against the JAX package: the mesh
layout, the tile-fused ring ops over ``torch.distributed``
(gloo worlds of 2 and 4) and ``fused_tp_apply`` at tp = 1, 2 and 4.

Each JAX reference runs under ``shard_map`` on as many CPU devices as the
gloo world has ranks, on the same numpy inputs and flax weights, and is
compared rank by rank.  Tolerances are the JAX tests' own: 1e-5 for the
fp32 ring outputs, 1e-4 for their gradients, 3e-4 for the fp32 logits
(``tests/test_pallas_kernels.py`` TestFusedMatmulCollectives,
``tests/test_transformer.py`` TestFusedTpApply), and those of
``tests/test_torch_model.py`` for the loss and gradients at tp = 1.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.models import transformer as JT
from horovod_tpu.ops import pallas_kernels as PK
from horovod_tpu.parallel import mesh as JM
from horovod_tpu_torch.models import transformer as TT
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.ops import fused_collectives as FC
from horovod_tpu_torch.ops import kernels as K
from horovod_tpu_torch.parallel import mesh as TM

from torch_port_workers import TP_SIZES, ring_inputs, spawn_world

WORLDS = (2, 4)


def _mesh(world):
    return Mesh(np.asarray(jax.devices("cpu")[:world]), ("tp",))


@pytest.fixture(scope="module")
def flax_params():
    cfg = JT.TransformerConfig(dtype=jnp.float32, **TP_SIZES)
    variables = JT.TransformerLM(cfg).init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 16), jnp.int32))
    return jax.tree_util.tree_map(np.asarray,
                                  flax.core.meta.unbox(variables))


@pytest.fixture(scope="module")
def tokens():
    return np.random.RandomState(3).randint(0, 64, (2, 17)).astype(np.int32)


@pytest.fixture(scope="module")
def worlds(flax_params, tokens):
    """One gloo world of each size runs every tensor-parallel check."""
    return {w: spawn_world("run_tp", world=w,
                           args=(flax_params, tokens[:, :16]), timeout=180)
            for w in WORLDS}


def _torch_model(params, impl="dense"):
    cfg = TT.TransformerConfig(dtype=torch.float32, attention_impl=impl,
                               **TP_SIZES)
    model = TT.TransformerLM(cfg)
    model.load_state_dict(params_from_flax(params))
    return cfg, model


# ---------------------------------------------------------------------------
# the mesh layout
# ---------------------------------------------------------------------------

class TestMeshLayout:
    @pytest.mark.parametrize("shape", [dict(dp=2, tp=4), dict(dp=2, tp=2),
                                       dict(tp=8), dict(dp=2, sp=2, tp=2)])
    def test_rank_order_matches_jax_mesh(self, shape):
        """The ranks along each axis are the JAX mesh's device ids along
        it: tp varies fastest."""
        n = int(np.prod(list(shape.values())))
        jmesh = JM.make_parallel_mesh(devices=jax.devices("cpu")[:n],
                                      **shape)
        full = {a: shape.get(a, 1) for a in TM.AXIS_ORDER}
        ids = np.vectorize(lambda d: d.id)(jmesh.devices)
        for i, axis in enumerate(TM.AXIS_ORDER):
            want = np.moveaxis(ids, i, -1).reshape(-1, full[axis]).tolist()
            assert TM.axis_ranks(full, axis) == want, axis

    def test_world_of_one(self):
        import horovod_tpu_torch as hvd

        hvd.init(device="cpu")
        try:
            mesh = TM.make_parallel_mesh()
            assert mesh.shape == dict.fromkeys(TM.AXIS_ORDER, 1)
            assert mesh.group("tp") is None and mesh.index("tp") == 0
            with pytest.raises(ValueError, match="cover"):
                TM.make_parallel_mesh(dp=2)
        finally:
            hvd.shutdown()

    @pytest.mark.parametrize("world", WORLDS)
    def test_gloo_groups(self, worlds, world):
        for rank, out in enumerate(worlds[world]):
            assert out["coords"]["tp"] == rank
            assert out["tp_ranks"] == list(range(world))
            if world == 4:
                coords, shape, tp_ranks, dp_ranks = out["dp2tp2"]
                assert shape == {**dict.fromkeys(TM.AXIS_ORDER, 1),
                                 "dp": 2, "tp": 2}
                assert coords["tp"] == rank % 2
                assert coords["dp"] == rank // 2
                assert tp_ranks == [rank // 2 * 2, rank // 2 * 2 + 1]
                assert dp_ranks == [rank % 2, rank % 2 + 2]


# ---------------------------------------------------------------------------
# the ring ops, rank by rank
# ---------------------------------------------------------------------------

def _jax_rings(world, fused, dtype=jnp.float32):
    """Per-rank outputs of both JAX ring ops and the gradients of
    ``sum(rs²) + sum(ag²)``, stacked over ranks."""
    inp = ring_inputs(world)

    def body(x, w, xs):
        x, w, xs = x[0], w[0], xs[0]

        def loss(x, w, xs):
            rs = PK.matmul_reducescatter(x, w, "tp", fused=fused)
            ag = PK.allgather_matmul(xs, w, "tp", fused=fused)
            return jnp.sum(rs.astype(jnp.float32) ** 2) + \
                jnp.sum(ag.astype(jnp.float32) ** 2)

        rs = PK.matmul_reducescatter(x, w, "tp", fused=fused)
        ag = PK.allgather_matmul(xs, w, "tp", fused=fused)
        grads = jax.grad(loss, argnums=(0, 1, 2))(x, w, xs)
        return tuple(t[None] for t in (rs, ag, *grads))

    args = [jnp.asarray(inp[k]).astype(dtype) for k in ("x", "w", "xs")]
    outs = jax.jit(jax.shard_map(body, mesh=_mesh(world),
                                 in_specs=(P("tp"),) * 3,
                                 out_specs=(P("tp"),) * 5,
                                 check_vma=False))(*args)
    return [np.asarray(o, np.float32) for o in outs]


@pytest.fixture(scope="module")
def jax_rings():
    return {(w, fused): _jax_rings(w, fused) for w in WORLDS
            for fused in (True, False)}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("fused", [True, False])
class TestRingOps:
    def test_matmul_reducescatter_per_rank(self, worlds, jax_rings, world,
                                           fused):
        want = jax_rings[(world, True)][0]
        for rank, out in enumerate(worlds[world]):
            np.testing.assert_allclose(out[fused]["rs"], want[rank],
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {rank}")

    def test_allgather_matmul_per_rank(self, worlds, jax_rings, world,
                                       fused):
        want = jax_rings[(world, True)][1]
        for rank, out in enumerate(worlds[world]):
            np.testing.assert_allclose(out[fused]["ag"], want[rank],
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {rank}")

    def test_gradients_per_rank(self, worlds, jax_rings, world, fused):
        """dx, dw and dxs on every rank against ``jax.grad`` of the same
        loss under ``shard_map`` (the rings' transposes are the other
        rings), at the JAX test's 1e-4."""
        want = jax_rings[(world, fused)][2:]
        for rank, out in enumerate(worlds[world]):
            for name, got, ref in zip(("dx", "dw", "dxs"), out[fused]["grads"],
                                      want):
                np.testing.assert_allclose(got, ref[rank], rtol=1e-4,
                                           atol=1e-4,
                                           err_msg=f"rank {rank} {name}")

    def test_fused_matches_unfused(self, worlds, world, fused):
        """The port's own fused and unfused formulations agree, outputs at
        1e-5 and gradients at 1e-4, as ``tests/test_transformer.py``
        pins the JAX pair."""
        for out in worlds[world]:
            np.testing.assert_allclose(out[fused]["rs"], out[True]["rs"],
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(out[fused]["ag"], out[True]["ag"],
                                       rtol=1e-6, atol=1e-6)
            for got, ref in zip(out[fused]["grads"], out[True]["grads"]):
                np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_bf16_ring_accumulates_fp32(worlds, world):
    """bf16 operands: the partials travel and sum in fp32 and the result
    is rounded once to bf16, in the same ring order as the JAX op; the two
    fp32 sums may still round one bf16 step apart (2^-8 relative)."""
    want = _jax_rings(world, True, jnp.bfloat16)[0]
    for rank, out in enumerate(worlds[world]):
        np.testing.assert_allclose(out["rs_bf16"], want[rank], rtol=1e-2,
                                   atol=1e-2, err_msg=f"rank {rank}")


@pytest.mark.parametrize("world", WORLDS)
def test_fused_launch_counts(worlds, world):
    """One construction of a fused ring per public call: the fused
    reduce-scatter twice (fp32 and bf16), the fused all-gather once.  The
    backward's transposed rings and the unfused calls do not count."""
    for out in worlds[world]:
        assert out["launches"] == (2, 1)


def test_ring_ops_world_of_one_are_the_kernel():
    """A group of one is the bare pallas_matmul, as at tp = 1 in JAX."""
    x = torch.from_numpy(ring_inputs(2)["x"][0])
    w = torch.from_numpy(ring_inputs(2)["w"][0])
    np.testing.assert_allclose(FC.matmul_reducescatter(x, w).numpy(),
                               (x @ w).numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(FC.allgather_matmul(x, w).numpy(),
                               (x @ w).numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="2-D"):
        FC.allgather_matmul(x[None], w)


# ---------------------------------------------------------------------------
# fused_tp_apply
# ---------------------------------------------------------------------------

def _jax_tp_logits(params, tokens, world, impl):
    cfg = JT.TransformerConfig(dtype=jnp.float32, attention_impl=impl,
                               **TP_SIZES)
    f = jax.shard_map(lambda v, t: JT.fused_tp_apply(v, cfg, t, fused=True),
                      mesh=_mesh(world), in_specs=(P(), P()), out_specs=P(),
                      check_vma=False)
    return np.asarray(jax.jit(f)(params, jnp.asarray(tokens)))


@pytest.mark.parametrize("world,impl", [(2, "dense"), (4, "dense"),
                                        (4, "flash")])
@pytest.mark.parametrize("fused", [True, False])
def test_fused_tp_apply_matches_jax(worlds, flax_params, tokens, world,
                                    impl, fused):
    want = _jax_tp_logits(flax_params, tokens[:, :16], world, impl)
    for rank, out in enumerate(worlds[world]):
        np.testing.assert_allclose(out[("logits", impl, fused)], want,
                                   rtol=3e-4, atol=3e-4,
                                   err_msg=f"rank {rank}")


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_tp1_logits_match_jax(flax_params, tokens, impl):
    """tp = 1 (no mesh): the logits against the JAX fused_tp_apply on a
    one-device mesh, at 3e-4."""
    want = _jax_tp_logits(flax_params, tokens[:, :16], 1, impl)
    cfg, model = _torch_model(flax_params, impl)
    with torch.no_grad():
        got = TT.fused_tp_apply(model, cfg,
                                torch.from_numpy(tokens[:, :16]).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_fused_tp_apply_matches_port_model(worlds, flax_params, tokens,
                                           world, impl):
    """Every rank's logits equal the port's own TransformerLM forward."""
    _, model = _torch_model(flax_params, impl)
    with torch.no_grad():
        want = model(torch.from_numpy(tokens[:, :16]).long()).numpy()
    for out in worlds[world]:
        np.testing.assert_allclose(out[("logits", impl, True)], want,
                                   rtol=3e-4, atol=3e-4)


def test_divisibility_error(worlds):
    for out in worlds[2]:
        assert "divisible" in out["divisibility_error"]


def test_rejects_sequence_parallel_attention(flax_params, tokens):
    cfg, model = _torch_model(flax_params)
    cfg.attention_impl = "ring"
    with pytest.raises(ValueError, match="attention_impl"):
        TT.fused_tp_apply(model, cfg, torch.from_numpy(tokens).long())


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_tp1_loss_and_grads_match_jax(flax_params, tokens, impl):
    """tp = 1: loss and gradients of the next-token loss through
    ``fused_tp_apply`` against ``jax.grad`` of the same loss through the
    JAX ``fused_tp_apply`` on a one-device mesh."""
    jcfg = JT.TransformerConfig(dtype=jnp.float32, attention_impl=impl,
                                **TP_SIZES)

    def loss_j(v, toks):
        logits = JT.fused_tp_apply(v, jcfg, toks[:, :-1], fused=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, toks[:, 1:]).mean()

    loss_want, grads_want = jax.jit(jax.shard_map(
        jax.value_and_grad(loss_j), mesh=_mesh(1), in_specs=(P(), P()),
        out_specs=(P(), P()), check_vma=False))(flax_params,
                                                jnp.asarray(tokens))
    cfg, model = _torch_model(flax_params, impl)
    toks = torch.from_numpy(tokens).long()
    logits = TT.fused_tp_apply(model, cfg, toks[:, :-1])
    loss = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           toks[:, 1:].reshape(-1))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_want),
                               rtol=1e-5)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, grads_want))
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=1e-3,
                                   atol=1e-4 * float(np.abs(ref).max()),
                                   err_msg=name)


def test_tp1_uses_the_kernel_wrapper_four_times_a_layer(flax_params,
                                                        tokens, monkeypatch):
    """At tp = 1 every projection goes through pallas_matmul: 4 calls a
    layer in the forward, and its backward computes dX and dW of each."""
    calls = []
    real = K._mm

    def spy(x, w, out_dtype, out=None):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return real(x, w, out_dtype, out)

    monkeypatch.setattr(K, "_mm", spy)
    cfg, model = _torch_model(flax_params)
    logits = TT.fused_tp_apply(model, cfg, torch.from_numpy(tokens).long())
    assert len(calls) == 4 * TP_SIZES["num_layers"]
    logits.float().sum().backward()
    assert len(calls) == 12 * TP_SIZES["num_layers"]


@pytest.mark.parametrize("env,want", [("ON", True), (None, False),
                                      ("off", False)])
def test_fused_mode_resolution(flax_params, tokens, monkeypatch, env, want):
    """fused=None reads the HOROVOD_FUSED_COLLECTIVES knob; unset, it is
    "auto", which is off."""
    seen = []
    real = FC.resolve_fused_collectives
    monkeypatch.setattr(FC, "resolve_fused_collectives",
                        lambda mode=None: seen.append(real(mode)) or seen[-1])
    if env is None:
        monkeypatch.delenv("HOROVOD_FUSED_COLLECTIVES", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_FUSED_COLLECTIVES", env)
    cfg, model = _torch_model(flax_params)
    with torch.no_grad():
        TT.fused_tp_apply(model, cfg, torch.from_numpy(tokens).long())
    assert seen == [want]
