"""``DistributedTrainStep(steps_per_call=k)`` of the port on the CPU: one
call makes ``k`` optimizer steps, against the JAX step's scanned call
(``horovod_tpu/optim/train_step.py``) on one rank and on a gloo world of
two, and against ``k`` calls of ``steps_per_call=1`` bit for bit; the
refusals, the telemetry's step count and ``compile_cache_hit``.  The
captured graph itself runs on a card only (``tests/test_torch_gpu.py``)."""

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

from torch_port_workers import (
    SPC_CASES,
    assert_adam_close,
    check_steps_per_call,
    run_steps_per_call,
    spawn_world,
    spc_train,
)

K = 3
SIZES = dict(vocab_size=256, num_layers=2, num_heads=4, d_model=128,
             d_ff=512, max_seq_len=64)
#: the moments after K steps, normwise against JAX's: the gradients agree
#: to fp32 reassociation, as the losses (1e-5 relative) do
MOMENT_RTOL = 1e-4


def _tokens():
    return np.random.RandomState(3).randint(0, 256, (8, 33)).astype(
        np.int64)


@pytest.fixture
def hvd_torch():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


@pytest.fixture(scope="module")
def jax_run():
    """One call of the JAX ``DistributedTrainStep(optax.adamw(3e-4),
    steps_per_call=3)`` on the conftest CPU mesh (8 devices), global batch
    8: the initial weights, the call's loss, the parameters and Adam's
    moments after it, all under the port's names."""
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

        step = hvd.DistributedTrainStep(loss_fn, optax.adamw(3e-4),
                                        steps_per_call=K)
        params, opt_state = step.init(params0)
        tok = _tokens().astype(np.int32)
        batch = step.shard_batch({"inputs": tok[:, :-1],
                                  "labels": tok[:, 1:]})
        params, opt_state, loss = step(params, opt_state, batch)
        adam = opt_state[0]
        to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        out = dict(loss=float(loss),
                   params={n: v.numpy() for n, v in
                           params_from_flax(to_np(params)).items()},
                   mu={n: v.numpy() for n, v in
                       params_from_flax(to_np(adam.mu)).items()},
                   nu={n: v.numpy() for n, v in
                       params_from_flax(to_np(adam.nu)).items()})
    finally:
        hvd.shutdown()
    start = {n: v.numpy() for n, v in params_from_flax(params0).items()}
    return start, out


def _check_against_jax(got: dict, want: dict) -> None:
    """The port's call of ``steps_per_call=3`` against JAX's: the loss to
    1e-5 relative and the parameters as :func:`assert_adam_close` states
    (the existing step parity tests' limits), Adam's moments normwise to
    :data:`MOMENT_RTOL`."""
    np.testing.assert_allclose(got["losses"], [want["loss"]], rtol=1e-5)
    for name, v in want["params"].items():
        assert_adam_close(got["params"][name], v, name, steps=K)
    for name, st in zip(got["names"], got["state"]):
        for mine, ref in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            a, b = st[mine], want[ref][name]
            assert np.linalg.norm(a - b) <= MOMENT_RTOL * np.linalg.norm(b), \
                (name, mine)


class TestAgainstJax:
    def test_one_rank(self, hvd_torch, jax_run):
        """One rank, the whole batch, the hook path."""
        start, want = jax_run
        got = spc_train(hvd_torch, "hook", K, 1, params0=start,
                        tokens=_tokens(), sizes=SIZES)
        _check_against_jax(got, want)
        assert got["steps_total"] == got["context_steps"] == K

    def test_gloo_world_of_two(self, jax_run, gloo_spc):
        """Each rank half the batch, the gradients averaged by the hook
        path over gloo."""
        _, want = jax_run
        for rank in gloo_spc:
            _check_against_jax(rank["hook"]["graph"], want)


@pytest.fixture(scope="module")
def gloo_spc(jax_run):
    start, _ = jax_run
    return spawn_world("run_steps_per_call", world=2,
                       args=(K, 1, start, _tokens(), SIZES), timeout=240)


class TestEqualsKCalls:
    @pytest.mark.parametrize("case", SPC_CASES)
    def test_one_rank(self, hvd_torch, case):
        """k = 3 against three calls of k = 1 from the same weights, two
        calls each way: losses, parameters and optimizer state bit for
        bit."""
        res = run_steps_per_call(hvd_torch, k=K, calls=2, cases=(case,))
        check_steps_per_call(res, K, 2)

    def test_gloo_world_of_two(self, gloo_spc):
        """The same on each rank of the world of two, both cases, and the
        ranks identical."""
        for rank in gloo_spc:
            check_steps_per_call(rank, K, 1)
        for case in SPC_CASES:
            a, b = (r[case]["graph"] for r in gloo_spc)
            assert a["losses"] == b["losses"]
            for n in a["params"]:
                np.testing.assert_array_equal(a["params"][n], b["params"][n])


class TestOnTheCpu:
    def test_no_graph_and_no_cache_verdict(self, hvd_torch):
        """The caller asked for the CPU: the call loops over the eager
        step, captures nothing, and ``compile_cache_hit`` stays None."""
        got = spc_train(hvd_torch, "hook", K, 1)
        assert got["replays"] == 0 and got["graphs"] == 0
        assert got["cache_hit"] is None

    def test_steps_total_advances_by_k(self, hvd_torch):
        got = spc_train(hvd_torch, "sharded", 4, 2)
        assert got["steps_total"] == 8 and got["context_steps"] == 8


def _lm_and_opt(**kw):
    model = TT.TransformerLM(TT.TransformerConfig(
        dtype=torch.float32, attention_impl="flash", vocab_size=64,
        num_layers=1, num_heads=2, d_model=32, d_ff=64, max_seq_len=16))
    return model, torch.optim.AdamW(model.parameters(), lr=1e-3, **kw)


class TestRefusals:
    @pytest.mark.parametrize("k", [0, -1])
    def test_k_below_one(self, hvd_torch, k):
        _, opt = _lm_and_opt()
        with pytest.raises(ValueError, match="steps_per_call must be >= 1"):
            hvd_torch.DistributedTrainStep(TT.lm_loss, opt,
                                           steps_per_call=k)

    def test_guard(self, hvd_torch):
        """JAX's words."""
        from horovod_tpu_torch.guard import TrainingGuard

        _, opt = _lm_and_opt()
        with pytest.raises(ValueError, match="guard= requires "
                           "steps_per_call=1: the guardian must observe"):
            hvd_torch.DistributedTrainStep(TT.lm_loss, opt,
                                           guard=TrainingGuard(),
                                           steps_per_call=2)

    def test_sparse_params(self, hvd_torch):
        _, opt = _lm_and_opt()
        with pytest.raises(ValueError, match="row-sparse exchange"):
            hvd_torch.DistributedTrainStep(
                TT.lm_loss, opt, sparse_params={"embed": 8},
                steps_per_call=2)

    @pytest.mark.parametrize("how", ["op", "optimizer", "reduction"])
    def test_adasum(self, hvd_torch, how):
        _, opt = _lm_and_opt()
        kw = {"op": hvd_torch.Adasum} if how == "op" else \
            {"shard_optimizer_states": True, "reduction": "adasum"} \
            if how == "reduction" else {"op": None}
        if how == "optimizer":
            opt = hvd_torch.DistributedAdasumOptimizer(opt)
        with pytest.raises(ValueError, match="Adasum's combine reads"):
            hvd_torch.DistributedTrainStep(TT.lm_loss, opt,
                                           steps_per_call=2, **kw)

    def test_error_feedback(self, hvd_torch):
        _, opt = _lm_and_opt()
        with pytest.raises(ValueError, match="error feedback replaces its "
                           "residual tensors"):
            hvd_torch.DistributedTrainStep(
                TT.lm_loss, opt, shard_optimizer_states=True,
                compression=hvd_torch.Compression.int8,
                error_feedback=True, steps_per_call=2)

    def test_backward_passes_per_step(self, hvd_torch):
        _, opt = _lm_and_opt()
        opt = hvd_torch.DistributedOptimizer(opt, backward_passes_per_step=2)
        with pytest.raises(ValueError, match="counts its backward passes "
                           "on the host"):
            hvd_torch.DistributedTrainStep(TT.lm_loss, opt,
                                           steps_per_call=2)

    def test_elastic_world_on_a_card(self, hvd_torch, monkeypatch):
        """Where the exchange's host waits on an event (an elastic world
        of several ranks on a card, stood in for by its deadline)."""
        from horovod_tpu_torch.runtime import distributed as hvd_dist

        monkeypatch.setattr(hvd_dist, "collective_deadline_s", lambda: 10.0)
        _, opt = _lm_and_opt()
        with pytest.raises(ValueError, match="elastic world on a card"):
            hvd_torch.DistributedTrainStep(TT.lm_loss, opt,
                                           steps_per_call=2)

    def test_capturable_on_a_card(self, hvd_torch, monkeypatch):
        """On a card AdamW must be built capturable; the flag is not
        flipped.  The card is stood in for by the runtime's device."""
        st = hvd_torch._state.global_state()
        monkeypatch.setattr(st, "device", torch.device("cuda"))
        _, opt = _lm_and_opt()
        with pytest.raises(ValueError, match="capturable=True"):
            hvd_torch.DistributedTrainStep(TT.lm_loss, opt,
                                           steps_per_call=2)
        assert opt.param_groups[0]["capturable"] is False
        _, ok = _lm_and_opt(capturable=True)
        hvd_torch.DistributedTrainStep(TT.lm_loss, ok, steps_per_call=2)
        # k = 1 never captures, so any optimizer serves
        hvd_torch.DistributedTrainStep(TT.lm_loss, opt)


class TestGraphBinding:
    """What a captured step is bound to (the graph itself runs on a card
    only): the tensors it was captured on, which a hit must find again,
    and a key that reads a tensor lr by its signature."""

    @staticmethod
    def _stepped(hvd_torch, case, lr=1e-3):
        model, inner = _lm_and_opt()
        inner.param_groups[0]["lr"] = lr
        scheduler = torch.optim.lr_scheduler.LambdaLR(inner,
                                                      lambda c: 0.5 ** c)
        step = hvd_torch.DistributedTrainStep(
            TT.lm_loss, inner, shard_optimizer_states=case == "sharded")
        model, opt = step.init(model)
        batch = step.shard_batch(torch.from_numpy(
            np.random.RandomState(0).randint(0, 64, (2, 17))))
        model, opt, _ = step(model, opt, batch)
        return model, opt, step, batch, scheduler

    @pytest.mark.parametrize("case", SPC_CASES)
    def test_a_restored_state_unbinds(self, hvd_torch, case):
        """``load_state_dict`` (``broadcast_optimizer_state``, a restore)
        gives the optimizer new state tensors: the graph must not be
        replayed onto the old ones.  The model's ``load_state_dict``
        copies in place and keeps the binding."""
        import copy

        from horovod_tpu_torch.optim.train_step import (
            CapturedStep,
            _bound_tensors,
        )

        model, opt, *_ = self._stepped(hvd_torch, case)
        captured = CapturedStep(None, None, [], [],
                                _bound_tensors(model, opt))
        assert captured.binds(_bound_tensors(model, opt))
        n_state = sum(len(st) for st in (
            opt.sharded_state.inner if case == "sharded"
            else opt.optimizer).state.values())
        assert n_state > 0
        model.load_state_dict(copy.deepcopy(model.state_dict()))
        assert captured.binds(_bound_tensors(model, opt))
        opt.load_state_dict(copy.deepcopy(opt.state_dict()))
        assert not captured.binds(_bound_tensors(model, opt))

    def test_another_model_unbinds(self, hvd_torch):
        from horovod_tpu_torch.optim.train_step import (
            CapturedStep,
            _bound_tensors,
        )

        model, opt, *_ = self._stepped(hvd_torch, "hook")
        captured = CapturedStep(None, None, [], [],
                                _bound_tensors(model, opt))
        other, _ = _lm_and_opt()
        assert not captured.binds(_bound_tensors(other, opt))

    def test_a_tensor_lr_keys_by_signature(self, hvd_torch):
        """A tensor lr filled in place (torch's schedulers) keeps the key
        and the binding, so the graph replays with the new value; a float
        lr that changes is a new key; a tensor lr replaced by another
        tensor keeps the key but not the binding."""
        from horovod_tpu_torch.optim.train_step import (
            CapturedStep,
            _bound_tensors,
        )
        from horovod_tpu_torch.runtime import compile_cache

        model, opt, step, batch, scheduler = self._stepped(
            hvd_torch, "hook", lr=torch.tensor(1e-3))

        def key():
            return compile_cache.executable_key(
                step._aot_extras(), model=model, optimizer=opt, batch=batch)

        captured = CapturedStep(None, None, [], [],
                                _bound_tensors(model, opt))
        before = key()
        scheduler.step()
        lr = opt.param_groups[0]["lr"]
        assert isinstance(lr, torch.Tensor)
        assert torch.equal(lr, torch.tensor(1e-3) * 0.5)
        assert key() == before and captured.binds(_bound_tensors(model, opt))
        opt.param_groups[0]["lr"] = torch.tensor(2e-4)
        assert key() == before
        assert not captured.binds(_bound_tensors(model, opt))
        opt.param_groups[0]["lr"] = 2e-4
        floated = key()
        assert floated != before
        opt.param_groups[0]["lr"] = 1e-4
        assert key() != floated
