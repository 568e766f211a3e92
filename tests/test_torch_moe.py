"""The port's Switch-MoE LM and expert parallelism against the JAX package:
top-1 routing, ``SwitchFFN`` and ``MoETransformerLM`` on converted weights,
``expert_chunk_mlp`` and ``expert_alltoall_ffn`` (row 8 of the kernel
table), the ep SwitchFFN over gloo worlds of 2 and 4 (``run_moe`` in
``tests/torch_port_workers.py``, each world spawned once), and
``DistributedTrainStep`` under ``ep`` plans.  fp32 on both sides; every
tolerance is stated beside its check."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import moe as JM
from horovod_tpu.ops import pallas_kernels as JPK
from horovod_tpu.parallel import expert as JE
from horovod_tpu_torch.models import moe as TM
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.ops import fused_collectives as TF
from horovod_tpu_torch.parallel import expert as TE

from torch_port_workers import (
    MOE_AUX,
    MOE_LM,
    MOE_LR,
    MOE_STEPS,
    assert_adam_close,
    moe_ffn_x,
    moe_tokens,
    ring_expert_inputs,
    spawn_world,
)

from test_torch_train_step import hvd_torch  # noqa: F401 - fixture

WORLDS = (2, 4)
#: SwitchFFN / LM against JAX's flax model, fp32
MODEL_TOL = 2e-5
#: ep against local mode (JAX's own limit, tests/test_moe.py)
EP_TOL = 2e-4
#: fused ring against the unfused all_to_alls (tests/test_moe.py)
FUSED_TOL = 1e-5
FFN = dict(d_model=32, d_ff=64, num_experts=8)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jcfg(**kw):
    base = dict(MOE_LM, dtype=jnp.float32)
    base.update(kw)
    return JM.MoEConfig(**base)


@pytest.fixture(scope="module")
def ffn_params():
    """JAX SwitchFFN parameters at d 32, 8 experts, f 64 (numpy)."""
    ffn = JM.SwitchFFN(_jcfg(**FFN))
    v = jax.jit(ffn.init)(jax.random.PRNGKey(1), jnp.zeros((1, 8, 32)))
    return _np(flax.core.meta.unbox(v["params"]))


@pytest.fixture(scope="module")
def lm_params():
    """JAX MoETransformerLM parameters at MOE_LM (flax tree, numpy)."""
    model = JM.MoETransformerLM(_jcfg())
    v = jax.jit(model.init)(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    return _np(flax.core.meta.unbox(v["params"]))


@pytest.fixture(scope="module")
def worlds(ffn_params, lm_params):
    sd = {k: v.numpy() for k, v in params_from_flax(lm_params).items()}
    return {w: spawn_world("run_moe", world=w, args=(ffn_params, sd),
                           timeout=240) for w in WORLDS}


def _jax_ffn(params, x, cf):
    """JAX local-mode SwitchFFN on ``x``: (y, drop fraction)."""
    ffn = JM.SwitchFFN(_jcfg(capacity_factor=cf, **FFN))
    y, st = ffn.apply({"params": params}, jnp.asarray(x),
                      mutable=["intermediates"])
    return y, st["intermediates"]["moe_drop_fraction"][0]


def _jax_shardwise(params, xs, cf):
    """Local mode applied to each rank's row on its own (the ep semantics:
    capacity and slots are per source rank): outputs, drop fractions, and
    the gradients of Σ_r sum(y_r²) by the parameters and the rows."""
    def total(p, xs):
        ys = [_jax_ffn(p, xs[r:r + 1], cf)[0] for r in range(xs.shape[0])]
        return sum(jnp.sum(y ** 2) for y in ys), ys

    (_, ys), (gp, gx) = jax.jit(jax.value_and_grad(
        total, argnums=(0, 1), has_aux=True))(params, jnp.asarray(xs))
    drops = [float(_jax_ffn(params, xs[r:r + 1], cf)[1])
             for r in range(xs.shape[0])]
    return [np.asarray(y) for y in ys], drops, _np(gp), np.asarray(gx)


def _torch_ffn(params, cf=MOE_LM["capacity_factor"]):
    cfg = TM.MoEConfig(dtype=torch.float32, capacity_factor=cf, **FFN)
    ffn = TM.SwitchFFN(cfg)
    ffn.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in params.items()})
    return ffn


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

class TestTop1Routing:
    def test_capacity_respected(self):
        """tests/test_pipeline_expert.py: every token prefers expert 0;
        capacity 2 keeps the first two."""
        idx, slot, keep, _ = TE.top1_routing(
            torch.tensor([[5.0, 0.0]] * 6), capacity=2)
        assert (idx == 0).all() and int(keep.sum()) == 2
        assert slot[:2].tolist() == [0, 1]

    @pytest.mark.parametrize("capacity", [1, 2, 3, 64])
    def test_matches_jax_with_ties_and_overflow(self, capacity):
        """Exact ties (the first maximum wins), near ties and overflow:
        expert, slot and keep equal JAX's exactly, the gate to 1e-6."""
        rng = np.random.RandomState(capacity)
        scores = rng.randn(48, 4).astype(np.float32)
        scores[::5] = [1.0, 3.0, 3.0, 0.5]          # a tie of 1 and 2
        scores[1::7] = 2.0                          # all four tied
        scores[2::9, 0] = scores[2::9, 3] + 1e-7    # within an ulp or so
        j = JE.top1_routing(jnp.asarray(scores), capacity)
        t = TE.top1_routing(torch.from_numpy(scores), capacity)
        for a, b in zip(j[:3], t[:3]):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_allclose(t[3].numpy(), np.asarray(j[3]),
                                   rtol=1e-6)
        assert int(t[2].sum()) == int(np.asarray(j[2]).sum())

    @pytest.mark.parametrize("cf,t,e", [(1.25, 16, 8), (1.0, 64, 8),
                                        (0.25, 32, 4), (16.0, 8, 8),
                                        (1.25, 16384, 8), (0.01, 3, 8)])
    def test_capacity_formula(self, cf, t, e):
        assert TE.moe_capacity(t, e, cf) == \
            int(max(1, -(-cf * t // e)))

    def test_dropped_tokens_get_zeros(self):
        """tests/test_pipeline_expert.py test_dropping_with_tight_capacity
        at a world of one: everything routes to expert 0, capacity 8."""
        t, d, e = 64, 4, 8
        x = torch.from_numpy(np.abs(np.random.RandomState(1).randn(t, d))
                             .astype(np.float32) + 0.1)
        gate = torch.zeros(d, e)
        gate[:, 0] = 10.0
        y, dropped = TE.expert_parallel_ffn(x, gate, lambda b: b * 2.0, e,
                                            capacity_factor=1.0)
        assert float(dropped) > 0.5
        assert int((y.abs().sum(1) > 0).sum()) <= TE.moe_capacity(t, e, 1.0)


# ---------------------------------------------------------------------------
# one process: SwitchFFN, the LM, the row-8 functions
# ---------------------------------------------------------------------------

class TestSwitchFFN:
    @pytest.mark.parametrize("cf", [8.0, 1.25, 0.25])
    def test_matches_jax(self, ffn_params, cf):
        """Output, aux loss, expert shares and drop fraction against the
        flax module on the same weights (MODEL_TOL); ``cf`` 0.25 drops."""
        x = moe_ffn_x(2)
        ffn = JM.SwitchFFN(_jcfg(capacity_factor=cf, **FFN))
        y, st = ffn.apply({"params": ffn_params}, jnp.asarray(x),
                          mutable=["intermediates"])
        inter = st["intermediates"]
        tf = _torch_ffn(ffn_params, cf)
        got = tf(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                                   rtol=MODEL_TOL, atol=MODEL_TOL)
        np.testing.assert_allclose(float(tf.moe_aux_loss.detach()),
                                   float(inter["moe_aux_loss"][0]),
                                   rtol=MODEL_TOL)
        np.testing.assert_array_equal(
            tf.moe_expert_fraction.numpy(),
            np.asarray(inter["moe_expert_fraction"][0]))
        assert float(tf.moe_drop_fraction) == \
            float(inter["moe_drop_fraction"][0])
        if cf == 8.0:
            assert float(tf.moe_drop_fraction) == 0.0
        if cf == 0.25:
            assert float(tf.moe_drop_fraction) > 0.5

    def test_gradients_match_jax(self, ffn_params):
        """Gradients of sum(y²) + aux by the router, the experts and the
        input, with drops (cf 1.0): MODEL_TOL of each leaf's largest."""
        x = moe_ffn_x(2)
        ffn = JM.SwitchFFN(_jcfg(capacity_factor=1.0, **FFN))

        def f(p, x):
            y, st = ffn.apply({"params": p}, x, mutable=["intermediates"])
            return jnp.sum(y ** 2) + st["intermediates"]["moe_aux_loss"][0]

        gp, gx = jax.grad(f, argnums=(0, 1))(ffn_params, jnp.asarray(x))
        tf = _torch_ffn(ffn_params, 1.0)
        xt = torch.from_numpy(x).requires_grad_()
        y = tf(xt)
        loss = (y ** 2).sum() + tf.moe_aux_loss
        grads = torch.autograd.grad(loss, [tf.gate, tf.w1, tf.w2, xt])
        for name, got, want in zip(("gate", "w1", "w2", "x"), grads,
                                   (gp["gate"], gp["w1"], gp["w2"], gx)):
            want = np.asarray(want)
            np.testing.assert_allclose(
                got.numpy(), want, rtol=MODEL_TOL,
                atol=MODEL_TOL * np.abs(want).max(), err_msg=name)

    def test_matches_per_token_expert_oracle(self, ffn_params):
        """tests/test_moe.py: with no drops, each token through its argmax
        expert's MLP, gate-weighted."""
        tf = _torch_ffn(ffn_params, 8.0)
        x = torch.from_numpy(moe_ffn_x(2))
        y = tf(x).detach()
        tokens = x.reshape(-1, 32)
        probs = torch.softmax(tokens @ tf.gate.detach(), -1)
        gate, idx = probs.max(-1)
        h = torch.einsum("td,tdf->tf", tokens, tf.w1.detach()[idx])
        dense = torch.einsum("tf,tfd->td",
                             torch.nn.functional.gelu(h, approximate="tanh"),
                             tf.w2.detach()[idx]) * gate[:, None]
        np.testing.assert_allclose(y.reshape(-1, 32).numpy(), dense.numpy(),
                                   rtol=MODEL_TOL, atol=MODEL_TOL)
        assert float(tf.moe_drop_fraction) == 0.0
        assert float(tf.moe_aux_loss.detach()) >= 1.0


class TestMoETransformerLM:
    def _loss(self, lm_params):
        jm = JM.MoETransformerLM(_jcfg())
        tok = moe_tokens()

        def loss(p):
            logits, st = jm.apply({"params": p}, jnp.asarray(tok[:, :-1]),
                                  mutable=["intermediates"])
            ce = optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.asarray(tok[:, 1:])).mean()
            return ce + MOE_AUX * JM.moe_aux_loss(st["intermediates"])

        return jax.jit(jax.value_and_grad(loss))(lm_params)

    def _port(self, lm_params):
        from torch_port_workers import moe_lm_loss

        model = TM.MoETransformerLM(TM.MoEConfig(dtype=torch.float32,
                                                 **MOE_LM))
        model.load_state_dict(params_from_flax(lm_params))
        loss = moe_lm_loss(model, torch.from_numpy(moe_tokens()))
        return model, loss

    def test_convert_carries_expert_leaves_untransposed(self, lm_params):
        sd = params_from_flax(lm_params)
        model = TM.MoETransformerLM(TM.MoEConfig(dtype=torch.float32,
                                                 **MOE_LM))
        assert set(sd) == set(model.state_dict())
        for leaf in ("gate", "w1", "w2"):
            np.testing.assert_array_equal(
                sd[f"layers.1.moe.{leaf}"].numpy(),
                lm_params["layer_1"]["moe"][leaf])
        assert "layers.0.mlp.wi.weight" in sd

    def test_loss_and_gradients_match_jax(self, lm_params):
        """CE + 0.01·aux and every parameter's gradient (MODEL_TOL of the
        leaf's largest gradient)."""
        want_loss, want = self._loss(lm_params)
        model, loss = self._port(lm_params)
        np.testing.assert_allclose(float(loss), float(want_loss),
                                   rtol=MODEL_TOL)
        loss.backward()
        want = params_from_flax(_np(want))
        for name, p in model.named_parameters():
            w = want[name].numpy()
            np.testing.assert_allclose(p.grad.numpy(), w, rtol=MODEL_TOL,
                                       atol=MODEL_TOL * np.abs(w).max(),
                                       err_msg=name)

    def test_mixes_dense_and_moe_blocks(self):
        cfg = TM.MoEConfig(dtype=torch.float32, **dict(MOE_LM,
                                                       num_layers=4))
        model = TM.MoETransformerLM(cfg)
        assert [type(b).__name__ for b in model.layers] == \
            ["Block", "MoEBlock", "Block", "MoEBlock"]
        out = model(torch.zeros(2, 8, dtype=torch.long))
        assert out.shape == (2, 8, cfg.vocab_size)
        assert torch.isfinite(out).all()
        assert len(TM.moe_layers(model)) == 2
        assert TM.moe_aux_loss(TM.MoETransformerLM(
            TM.MoEConfig(dtype=torch.float32,
                         **dict(MOE_LM, moe_every=0)))).item() == 0.0

    def test_init_scales(self):
        """Router N(0, 0.02); experts lecun normal over flax's fan-in,
        which counts the expert axis (E·d for w1, E·f for w2)."""
        cfg = TM.MoEConfig(dtype=torch.float32, **dict(
            MOE_LM, d_model=128, d_ff=256))
        model = TM.MoETransformerLM(
            cfg, generator=torch.Generator().manual_seed(0))
        moe = model.layers[1].moe
        for p, std in ((moe.gate, 0.02), (moe.w1, (8 * 128) ** -0.5),
                       (moe.w2, (8 * 256) ** -0.5)):
            assert abs(float(p.std()) / std - 1) < 0.05

    def test_trains_with_aux_loss(self, hvd_torch):
        """tests/test_moe.py: the LM under DistributedTrainStep at a world
        of one, CE + 0.01·aux, Adam(1e-2): finite and falling."""
        from torch_port_workers import moe_lm_loss

        model = TM.MoETransformerLM(
            TM.MoEConfig(dtype=torch.float32, **MOE_LM),
            generator=torch.Generator().manual_seed(0))
        step = hvd_torch.DistributedTrainStep(
            moe_lm_loss, torch.optim.Adam(model.parameters(), lr=1e-2))
        model, opt = step.init(model)
        batch = step.shard_batch(moe_tokens())
        losses = [float(step(model, opt, batch)[2]) for _ in range(5)]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]

    def test_remat_raises(self):
        for kw in ({"remat": True}, {"remat_policy": "dots"}):
            with pytest.raises(NotImplementedError, match="Queue A 12"):
                TM.MoEConfig(**kw)


class TestExpertChunkMlp:
    @pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5)])
    def test_matches_jax_interpret(self, dtype, tol):
        """JAX's loop over ``pallas_matmul`` in interpret mode, at shapes on
        the kernel's tiling contract; fp32 (1e-5)."""
        rng = np.random.RandomState(5)
        chunk = rng.randn(2, 16, 128).astype(dtype)
        w1 = (rng.randn(2, 128, 256) * 0.1).astype(dtype)
        w2 = (rng.randn(2, 256, 128) * 0.1).astype(dtype)
        want = JPK.expert_chunk_mlp(jnp.asarray(chunk), jnp.asarray(w1),
                                    jnp.asarray(w2), interpret=True)
        got = TF.expert_chunk_mlp(*(torch.from_numpy(a)
                                    for a in (chunk, w1, w2)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)

    def test_equals_the_batched_expert_body(self):
        """The per-expert loop and the model's batched einsum compute the
        same MLP (fp32, 1e-5)."""
        rng = np.random.RandomState(6)
        chunk, w1, w2 = (torch.from_numpy(a) for a in (
            rng.randn(3, 8, 128).astype(np.float32),
            (rng.randn(3, 128, 128) * 0.1).astype(np.float32),
            (rng.randn(3, 128, 128) * 0.1).astype(np.float32)))
        np.testing.assert_allclose(
            TF.expert_chunk_mlp(chunk, w1, w2).numpy(),
            TM._expert_mlp(chunk, w1, w2).numpy(), rtol=1e-5, atol=1e-5)

    def test_bf16_takes_the_plain_product_on_the_cpu(self):
        """On CPU tensors kernel 6's wrapper computes its plain version and
        launches nothing."""
        from horovod_tpu_torch.ops import kernels as K

        before = K.pallas_matmul.launches
        x = torch.randn(2, 8, 128).to(torch.bfloat16)
        w = torch.randn(2, 128, 128).to(torch.bfloat16)
        y = TF.expert_chunk_mlp(x, w, w)
        assert y.dtype == torch.bfloat16 and y.shape == (2, 8, 128)
        assert K.pallas_matmul.launches == before


class TestExpertAlltoallWorldOfOne:
    def test_world_one_is_the_expert_fn(self):
        disp = torch.randn(1, 2, 3, 4)
        out = TF.expert_alltoall_ffn(disp, lambda t: t * 3.0, None)
        torch.testing.assert_close(out, disp * 3.0, rtol=0, atol=0)

    def test_shape_validation(self):
        with pytest.raises(ValueError, match="dispatch buffer"):
            TF.expert_alltoall_ffn(torch.zeros(8, 2, 3), lambda t: t)
        with pytest.raises(ValueError, match="dim 0"):
            TF.expert_alltoall_ffn(torch.zeros(4, 2, 3, 4), lambda t: t)


# ---------------------------------------------------------------------------
# gloo worlds: the ep SwitchFFN, the ring, training under ep plans
# ---------------------------------------------------------------------------

class TestExpertParallel:
    @pytest.mark.parametrize("world", WORLDS)
    @pytest.mark.parametrize("fused", [False, True])
    def test_ample_capacity_matches_local_mode(self, worlds, ffn_params,
                                               world, fused):
        """tests/test_moe.py test_ep_mode_matches_local_mode: ep over the
        world, one row a rank, cf 16, against JAX local mode on every row
        at once (EP_TOL); no token drops."""
        y_local, _ = _jax_ffn(ffn_params, moe_ffn_x(world), 16.0)
        for r, out in enumerate(worlds[world]):
            y, drop, _, _ = out[("ffn", 16.0, fused)]
            np.testing.assert_allclose(y[0], np.asarray(y_local)[r],
                                       rtol=EP_TOL, atol=EP_TOL)
            assert drop == 0.0

    @pytest.mark.parametrize("world", WORLDS)
    def test_tight_capacity_matches_local_mode_per_rank(self, worlds,
                                                        ffn_params, world):
        """cf 1.0 drops tokens: each rank's output, drop fraction and the
        world's gradients equal JAX local mode applied to each rank's row
        (capacity and slots are per source rank), EP_TOL of each leaf's
        largest gradient."""
        ys, drops, gp, gx = _jax_shardwise(ffn_params, moe_ffn_x(world),
                                           1.0)
        assert max(drops) > 0
        for r, out in enumerate(worlds[world]):
            y, drop, grads, grad_x = out[("ffn", 1.0, False)]
            np.testing.assert_allclose(y, ys[r], rtol=EP_TOL, atol=EP_TOL)
            assert drop == drops[r]
            for name, got in zip(("gate", "w1", "w2"), grads):
                want = gp[name]
                np.testing.assert_allclose(
                    got, want, rtol=EP_TOL, atol=EP_TOL * np.abs(want).max(),
                    err_msg=name)
            np.testing.assert_allclose(grad_x, gx[r:r + 1], rtol=EP_TOL,
                                       atol=EP_TOL * np.abs(gx).max())

    @pytest.mark.parametrize("world", WORLDS)
    @pytest.mark.parametrize("cf", [16.0, 1.0])
    def test_fused_matches_unfused(self, worlds, world, cf):
        """tests/test_moe.py test_fused_dispatch_matches_local_mode: the
        ring against the all_to_alls, outputs and gradients (FUSED_TOL),
        with equal drop fractions."""
        for out in worlds[world]:
            yu, du, gu, gxu = out[("ffn", cf, False)]
            yf, df, gf, gxf = out[("ffn", cf, True)]
            np.testing.assert_allclose(yf, yu, rtol=FUSED_TOL,
                                       atol=FUSED_TOL)
            assert df == du
            for a, b in zip(gf + [gxf], gu + [gxu]):
                np.testing.assert_allclose(a, b, rtol=FUSED_TOL,
                                           atol=FUSED_TOL * np.abs(b).max())

    @pytest.mark.parametrize("world", WORLDS)
    @pytest.mark.parametrize("fused", [False, True])
    def test_ring_matches_closed_form(self, worlds, world, fused):
        """tests/test_pallas_kernels.py: out[r, q] is expert rank q's MLP of
        the tile rank r sent it; the gradients of Σ_r sum(out_r²) by each
        rank's dispatch and experts equal jax.grad of the closed form
        (1e-5); under no_grad the same values, with no graph."""
        disp, w1, w2 = ring_expert_inputs(world)

        def closed(disp, w1, w2):
            h = jnp.einsum("rqecd,qedf->rqecf", disp, w1)
            return jnp.einsum("rqecf,qefd->rqecd", jax.nn.gelu(h), w2)

        want = np.asarray(closed(disp, w1, w2))
        grads = jax.grad(lambda *a: jnp.sum(closed(*a) ** 2),
                         argnums=(0, 1, 2))(disp, w1, w2)
        for r, out in enumerate(worlds[world]):
            got, (gd, g1, g2), no_grad = out[("ring", fused)]
            np.testing.assert_allclose(got, want[r], rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(no_grad, got)
            for a, b in zip((gd, g1, g2), grads):
                np.testing.assert_allclose(a, np.asarray(b)[r], rtol=1e-5,
                                           atol=1e-5)

    @pytest.mark.parametrize("world", WORLDS)
    def test_errors(self, worlds, world):
        """3 experts over an ep group of 2 or 4 raises JAX's ValueError,
        word for word; the sharded exchange with ep > 1 raises
        NotImplementedError naming its ROADMAP item."""
        from jax.sharding import Mesh, PartitionSpec as P

        mesh = Mesh(np.array(jax.devices()[:world]), ("ep",))
        with pytest.raises(ValueError) as jerr:
            jax.shard_map(
                lambda x, g: JE.expert_parallel_ffn(x, g, lambda t: t,
                                                    3)[0],
                mesh=mesh, in_specs=(P(), P()), out_specs=P(),
                check_vma=False)(jnp.zeros((4, 32)), jnp.zeros((32, 3)))
        errors = worlds[world][0]["errors"]
        assert errors["divisible"] == str(jerr.value)
        assert "Queue A 13" in errors["sharded"]


def _jax_ep_step(lm_params, n_shards):
    """MOE_STEPS optax.adamw steps of JAX local mode on the global batch,
    the loss the mean over ``n_shards`` equal row shards of each shard's
    CE + 0.01·aux (the ep step's per-rank loss, averaged as the example's
    ``pmean`` over ep averages it): (losses, final parameters)."""
    jm = JM.MoETransformerLM(_jcfg())
    tok = moe_tokens()
    shards = np.split(tok, n_shards)

    def loss(p):
        total = 0.0
        for s in shards:
            logits, st = jm.apply({"params": p}, jnp.asarray(s[:, :-1]),
                                  mutable=["intermediates"])
            ce = optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.asarray(s[:, 1:])).mean()
            total = total + ce + MOE_AUX * JM.moe_aux_loss(
                st["intermediates"])
        return total / n_shards

    opt = optax.adamw(MOE_LR, weight_decay=1e-4)
    params, state, losses = lm_params, opt.init(lm_params), []
    value_and_grad = jax.jit(jax.value_and_grad(loss))
    for _ in range(MOE_STEPS):
        val, g = value_and_grad(params)
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
        losses.append(float(val))
    return losses, params_from_flax(_np(params))


@pytest.fixture(scope="module")
def jax_ep_steps(lm_params):
    return {n: _jax_ep_step(lm_params, n) for n in WORLDS}


class TestTrainStepEp:
    @pytest.mark.parametrize("world,plan,fused", [
        (2, "ep=2", False), (4, "dp=2,ep=2", False), (4, "ep=4", False),
        (4, "ep=4", True)])
    def test_matches_jax_local_step(self, worlds, jax_ep_steps, world, plan,
                                    fused):
        """DistributedTrainStep under ``plan`` (rows split over dp × ep,
        gradients averaged over every rank) against JAX local mode on the
        global batch with the per-shard loss: losses 1e-5 relative,
        parameters as assert_adam_close states; every rank alike.  The
        fused case sets the ring through the step's ``moe_fused`` over a
        model configured unfused: one ring a MoE layer a step."""
        key = ("train", plan, fused)
        want_losses, want = jax_ep_steps[world]
        losses, params, rings = worlds[world][0][key]
        n_moe = MOE_LM["num_layers"] // MOE_LM["moe_every"]
        assert rings == (MOE_STEPS * n_moe if fused else 0)
        np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
        for name, p in params.items():
            assert_adam_close(p, want[name].numpy(), name, steps=MOE_STEPS,
                              lr=MOE_LR)
        for out in worlds[world][1:]:
            assert out[key][0] == losses

    def test_shard_batch_splits_rows_over_data_and_ep(self, hvd_torch):
        step = hvd_torch.DistributedTrainStep(
            lambda m, b: m, torch.optim.SGD(
                [torch.zeros(1, requires_grad=True)], lr=0.1), plan="ep=1")
        x = np.arange(12).reshape(6, 2)
        np.testing.assert_array_equal(step.shard_batch(x).numpy(), x)

    def test_moe_schedule_properties(self, hvd_torch, monkeypatch):
        """``moe_fused``/``moe_capacity_factor``: arguments first, then
        the knobs; ``"auto"`` resolves to off, as the port's fused rings
        do."""
        opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=0.1)
        monkeypatch.delenv("HOROVOD_MOE_FUSED_DISPATCH", raising=False)
        monkeypatch.delenv("HOROVOD_MOE_CAPACITY_FACTOR", raising=False)
        step = hvd_torch.DistributedTrainStep(lambda m, b: m, opt)
        assert step.moe_fused is None and step.moe_capacity_factor is None
        step = hvd_torch.DistributedTrainStep(
            lambda m, b: m, opt, moe_fused="ON", moe_capacity_factor=2)
        assert step.moe_fused == "on" and step.moe_capacity_factor == 2.0
        monkeypatch.setenv("HOROVOD_MOE_FUSED_DISPATCH", "auto")
        monkeypatch.setenv("HOROVOD_MOE_CAPACITY_FACTOR", "1.5")
        step = hvd_torch.DistributedTrainStep(lambda m, b: m, opt)
        assert step.moe_fused == "off" and step.moe_capacity_factor == 1.5

    @pytest.mark.parametrize("source", ["argument", "knob"])
    def test_moe_schedule_reaches_the_model(self, hvd_torch, monkeypatch,
                                            source):
        """The step writes its capacity factor and dispatch into every
        SwitchFFN's config at init: at 0.25 against the model's 1.25 the
        same batch drops more tokens, and without a schedule the model's
        config stands."""
        from torch_port_workers import moe_lm_loss

        monkeypatch.delenv("HOROVOD_MOE_FUSED_DISPATCH", raising=False)
        monkeypatch.delenv("HOROVOD_MOE_CAPACITY_FACTOR", raising=False)
        batch = torch.from_numpy(moe_tokens())
        drops = {}
        for cf in (None, 0.25):
            model = TM.MoETransformerLM(
                TM.MoEConfig(dtype=torch.float32, fused_dispatch="off",
                             **MOE_LM),
                generator=torch.Generator().manual_seed(0))
            kw = {}
            if cf is not None and source == "argument":
                kw = dict(moe_fused="on", moe_capacity_factor=cf)
            elif cf is not None:
                monkeypatch.setenv("HOROVOD_MOE_FUSED_DISPATCH", "on")
                monkeypatch.setenv("HOROVOD_MOE_CAPACITY_FACTOR", str(cf))
            step = hvd_torch.DistributedTrainStep(
                moe_lm_loss, torch.optim.SGD(model.parameters(), lr=0.0),
                **kw)
            model, opt = step.init(model)
            model, opt, _ = step(model, opt, batch)
            ffns = TM.moe_layers(model)
            want = (MOE_LM["capacity_factor"], "off") if cf is None \
                else (cf, "on")
            assert all((f.cfg.capacity_factor, f.cfg.fused_dispatch) == want
                       for f in ffns)
            drops[cf] = float(ffns[0].moe_drop_fraction)
        assert drops[0.25] > drops[None]
