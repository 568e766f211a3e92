"""The port's DistributedOptimizer / DistributedTrainStep against the JAX
DistributedTrainStep, a gloo world of two against a world of one, and the
rank-0 checkpoint."""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import transformer as JT
from horovod_tpu_torch.models import transformer as TT
from horovod_tpu_torch.models.convert import params_from_flax

from torch_port_workers import assert_adam_close, run_train, spawn_world

SIZES = dict(vocab_size=256, num_layers=2, num_heads=4, d_model=128,
             d_ff=512, max_seq_len=64)


@pytest.fixture
def hvd_torch():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _tokens():
    return np.random.RandomState(3).randint(0, 256, (8, 33)).astype(
        np.int32)


@pytest.fixture(scope="module")
def jax_run():
    """Three optax.adamw(3e-4) steps of the JAX DistributedTrainStep on the
    conftest CPU mesh (8 devices), global batch 8."""
    import horovod_tpu as hvd

    hvd.init()
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

        step = hvd.DistributedTrainStep(loss_fn, optax.adamw(3e-4))
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
        hvd.shutdown()
    return params0, losses, final


def _port_run(hvd, params0, steps=3, **opt_kwargs):
    cfg = TT.TransformerConfig(dtype=torch.float32, attention_impl="flash",
                               **SIZES)
    model = TT.TransformerLM(cfg)
    model.load_state_dict(params_from_flax(params0))
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4),
        **opt_kwargs)
    step = hvd.DistributedTrainStep(lambda m, b: TT.lm_loss(m, b), opt)
    model, opt = step.init(model)
    batch = step.shard_batch(torch.from_numpy(_tokens()).long())
    losses = []
    for _ in range(steps):
        model, opt, loss = step(model, opt, batch)
        losses.append(float(loss))
    return losses, model


class TestAgainstJax:
    """fp32 on both sides.  Losses agree to 1e-5 relative; parameters as
    :func:`assert_adam_close` states."""

    def test_losses(self, hvd_torch, jax_run):
        params0, want, _ = jax_run
        got, _ = _port_run(hvd_torch, params0)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert got[-1] < got[0]

    def test_params(self, hvd_torch, jax_run):
        params0, _, final = jax_run
        _, model = _port_run(hvd_torch, params0)
        want = params_from_flax(final)
        for name, p in model.state_dict().items():
            assert_adam_close(p.numpy(), want[name].numpy(), name)

    def test_predivide_factor_is_numerically_neutral(self, hvd_torch,
                                                     jax_run):
        """gradient_predivide_factor=2 scales by 1/2 before the sum and by
        2/size after: the same update as plain Average."""
        params0, want, _ = jax_run
        got, _ = _port_run(hvd_torch, params0, gradient_predivide_factor=2.0)
        np.testing.assert_allclose(got, want, rtol=1e-5)


class TestAdamWConfig:
    @staticmethod
    def _torch_run(p0, grads, weight_decay):
        pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = torch.optim.AdamW([pt], lr=3e-4, weight_decay=weight_decay)
        for g in grads:
            pt.grad = torch.from_numpy(g)
            opt.step()
        return pt.detach().numpy()

    @pytest.mark.parametrize("steps", [1, 3])
    def test_torch_adamw_matches_optax_adamw(self, steps):
        """The recipe's torch.optim.AdamW(3e-4, weight_decay=1e-4) is
        optax.adamw(3e-4) (b1 .9, b2 .999, eps 1e-8, decay 1e-4 on every
        leaf).  With parameters ~10 the two agree to fp32 rounding (1e-5,
        a few ulps), while torch's default decay of 1e-2 moves them
        3e-5·|p| a step further, which the same tolerance rejects."""
        rng = np.random.RandomState(4)
        p0 = (rng.randn(64) * 10).astype(np.float32)
        grads = [rng.randn(64).astype(np.float32) for _ in range(steps)]
        tx = optax.adamw(3e-4)
        pj, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
        for g in grads:
            upd, state = tx.update(jnp.asarray(g), state, pj)
            pj = optax.apply_updates(pj, upd)
        want = np.asarray(pj)
        np.testing.assert_allclose(self._torch_run(p0, grads, 1e-4), want,
                                   rtol=0, atol=1e-5)
        wrong = self._torch_run(p0, grads, 1e-2)
        assert np.abs(wrong - want).max() > 1e-5


class TestOptimizerOptions:
    def test_backward_passes_per_step(self, hvd_torch):
        """Two micro-batches of half the rows with
        backward_passes_per_step=2 take one step on their mean gradient:
        the full batch's step, within fp32 reassociation."""
        def build():
            model = TT.TransformerLM(
                TT.TransformerConfig(dtype=torch.float32, **SIZES),
                generator=torch.Generator().manual_seed(5))
            return model, torch.optim.AdamW(model.parameters(), lr=3e-4,
                                            weight_decay=1e-4)

        tok = torch.from_numpy(_tokens()).long()
        full, opt = build()
        opt = hvd_torch.DistributedOptimizer(opt)
        TT.lm_loss(full, tok).backward()
        opt.step()
        micro, opt = build()
        opt = hvd_torch.DistributedOptimizer(opt, backward_passes_per_step=2)
        before = {k: v.clone() for k, v in micro.state_dict().items()}
        for half in (tok[:4], tok[4:]):
            opt.zero_grad()
            TT.lm_loss(micro, half).backward()
            opt.step()
            if half is tok[:4]:      # first micro-step: no update yet
                for k, v in micro.state_dict().items():
                    torch.testing.assert_close(v, before[k], rtol=0, atol=0)
        for k, v in micro.state_dict().items():
            assert_adam_close(v.numpy(), full.state_dict()[k].numpy(), k,
                              steps=1)

    def test_option_guards(self, hvd_torch):
        opt = torch.optim.SGD([torch.nn.Parameter(torch.ones(1))], lr=0.1)
        with pytest.raises(ValueError):
            hvd_torch.DistributedOptimizer(opt, op=hvd_torch.Sum,
                                           gradient_predivide_factor=2.0)
        with pytest.raises(ValueError):
            hvd_torch.DistributedOptimizer(opt, prescale_factor=0.5,
                                           gradient_predivide_factor=2.0)
        with pytest.raises(ValueError):
            hvd_torch.DistributedOptimizer(opt, backward_passes_per_step=0)

    def test_buckets_follow_fusion_threshold(self, hvd_torch, monkeypatch):
        """The exchange issues one grouped_allreduce per plan_buckets
        bucket, reverse-layer order, capped at HOROVOD_FUSION_THRESHOLD."""
        from horovod_tpu_torch.ops import collectives as TC
        from horovod_tpu_torch.optim import optimizer as TO

        sizes = []
        real = TC.grouped_allreduce

        def spy(xs, **kw):
            sizes.append([x.numel() for x in xs])
            return real(xs, **kw)

        monkeypatch.setattr(TO.C, "grouped_allreduce", spy)
        grads = [torch.ones(n) for n in (10, 20, 30, 40)]
        monkeypatch.setattr(hvd_torch._state.global_state().config,
                            "fusion_threshold_bytes", 200)
        TO.distributed_gradients(grads)
        assert sizes == [[40], [30, 20], [10]]


@pytest.fixture(scope="module")
def gloo_train():
    return spawn_world("run_train", world=2, args=(3, 0, True))


class TestGlooWorld:
    def test_world_of_two_matches_world_of_one(self, hvd_torch, gloo_train):
        """Half batches per rank, averaged, against the full batch on one
        rank: the same trajectory within fp32 reassociation (1e-5
        relative on the loss; parameters as assert_adam_close states)."""
        want_losses, want_params = run_train(hvd_torch, 3)
        for losses, params in gloo_train:
            np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
            for k, v in params.items():
                assert_adam_close(v, want_params[k], k)

    def test_ranks_stay_identical(self, gloo_train):
        """init broadcast rank 0's weights over rank 1's different draw,
        and the exchange keeps both ranks bit-identical."""
        (l0, p0), (l1, p1) = gloo_train
        assert l0 == l1
        for k in p0:
            np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)


class TestCheckpoint:
    def test_round_trip(self, hvd_torch, tmp_path):
        model = TT.TransformerLM(
            TT.TransformerConfig(dtype=torch.float32, **SIZES),
            generator=torch.Generator().manual_seed(2))
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4)
        TT.lm_loss(model, torch.from_numpy(_tokens()).long()).backward()
        opt.step()
        ckpt = hvd_torch.checkpoint.Checkpointer(str(tmp_path))
        state = {"model": model.state_dict(), "opt": opt.state_dict(),
                 "step": 7}
        assert ckpt.save(7, state)
        assert ckpt.latest_step() == 7
        back = ckpt.restore()
        assert back["step"] == 7
        for k, v in state["model"].items():
            torch.testing.assert_close(back["model"][k], v, rtol=0, atol=0)
        for pid, st in state["opt"]["state"].items():
            for key, val in st.items():
                torch.testing.assert_close(back["opt"]["state"][pid][key],
                                           val, rtol=0, atol=0)
        model2 = TT.TransformerLM(
            TT.TransformerConfig(dtype=torch.float32, **SIZES))
        model2.load_state_dict(back["model"])
        opt2 = torch.optim.AdamW(model2.parameters(), lr=3e-4)
        opt2.load_state_dict(back["opt"])

    def test_retention_and_partial_writes(self, hvd_torch, tmp_path):
        ckpt = hvd_torch.checkpoint.Checkpointer(str(tmp_path),
                                                 max_to_keep=2)
        for s in (1, 2, 3):
            ckpt.save(s, {"x": torch.full((3,), float(s))})
        assert ckpt.all_steps() == [2, 3]
        # a crash mid-write leaves only a tmp file: never a step
        os.makedirs(tmp_path / "step_9")
        (tmp_path / "step_9" / ".tmp.state.pt.123").write_bytes(b"partial")
        assert ckpt.latest_step() == 3
        torch.testing.assert_close(ckpt.restore()["x"], torch.full((3,), 3.0))
        with pytest.raises(FileNotFoundError):
            ckpt.restore(step=1)

    def test_only_rank0_writes(self, hvd_torch, tmp_path, monkeypatch):
        from horovod_tpu_torch import checkpoint as CK

        monkeypatch.setattr(hvd_torch._state.global_state(), "rank", 1)
        ckpt = CK.Checkpointer(str(tmp_path))
        assert ckpt.save(1, {"x": torch.ones(1)}) is False
        assert ckpt.latest_step() is None
