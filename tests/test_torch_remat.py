"""The port's remat tiers (``horovod_tpu_torch/memory/remat.py``) against
the JAX package's: each tier of a small ``TransformerLM``, ``ViT`` and
MoE LM (2 layers, d 64, fp32, on converted flax weights) gives JAX's same
tier's loss and gradients within ``tests/test_remat.py``'s tolerance (the
loss at rtol/atol 1e-5; the gradients at rtol 1e-5 / atol 1e-6, the MoE
LM's at 2e-5 / 1e-5), and on the CPU every tier gives ``none``'s loss and
gradients bit for bit.  Also the policy's resolution, the wrappers, and
``DistributedTrainStep(remat=...)``."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.memory import remat as JR
from horovod_tpu.models import moe as JMoE
from horovod_tpu.models import transformer as JT
from horovod_tpu.models import vit as JV
from horovod_tpu_torch.analysis import cost_model as TCM
from horovod_tpu_torch.memory import remat as TR
from horovod_tpu_torch.models import moe as TMoE
from horovod_tpu_torch.models import transformer as TT
from horovod_tpu_torch.models import vit as TV
from horovod_tpu_torch.models.convert import params_from_flax

POLICIES = ("none", "dots", "full", "offload")
LM = dict(vocab_size=128, num_layers=2, num_heads=4, d_model=64, d_ff=128,
          max_seq_len=32)
VIT = dict(image_size=16, patch_size=8, num_classes=4, num_layers=2,
           num_heads=2, d_model=64, d_ff=128)
MOE = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=64, d_ff=128,
           max_seq_len=16, num_experts=4, capacity_factor=8.0, moe_every=2)
#: (loss rtol/atol, gradient rtol, gradient atol): tests/test_remat.py's
TOL = {"lm": (1e-5, 1e-5, 1e-6), "vit": (1e-5, 1e-5, 1e-6),
       "moe": (1e-5, 2e-5, 1e-5)}


@pytest.fixture
def hvd_torch():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray,
                                  flax.core.meta.unbox(jax.device_get(tree)))


def _tokens(vocab, shape, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, shape)


def _jax_lm(policy):
    tok = jnp.asarray(_tokens(128, (2, 33)))
    base = JT.TransformerLM(JT.TransformerConfig(dtype=jnp.float32, **LM))
    variables = base.init(jax.random.PRNGKey(1), tok[:, :-1])
    model = JT.TransformerLM(JT.TransformerConfig(
        dtype=jnp.float32, remat_policy=policy, **LM))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda v: JT.lm_loss(v, model, tok)))(variables)
    return _np(variables), float(loss), _np(grads)


def _port_lm(variables, policy):
    model = TT.TransformerLM(TT.TransformerConfig(
        dtype=torch.float32, remat_policy=policy, **LM))
    model.load_state_dict(params_from_flax(variables))
    loss = TT.lm_loss(model, torch.from_numpy(_tokens(128, (2, 33))))
    loss.backward()
    return model, loss


def _jax_vit(policy):
    x = jnp.asarray(np.random.RandomState(0).randn(2, 16, 16, 3),
                    jnp.float32)
    base = JV.VisionTransformer(JV.ViTConfig(dtype=jnp.float32, **VIT))
    variables = base.init(jax.random.PRNGKey(1), x)
    model = JV.VisionTransformer(JV.ViTConfig(
        dtype=jnp.float32, remat_policy=policy, **VIT))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda v: jnp.sum(model.apply(v, x) ** 2)))(variables)
    return _np(variables), float(loss), _np(grads)


def _port_vit(variables, policy):
    model = TV.VisionTransformer(TV.ViTConfig(
        dtype=torch.float32, remat_policy=policy, **VIT))
    model.load_state_dict(params_from_flax(variables))
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 16, 16, 3)
                         .astype(np.float32))
    loss = (model(x) ** 2).sum()
    loss.backward()
    return model, loss


def _jax_moe(policy):
    tok = jnp.asarray(_tokens(64, (2, 16)))
    base = JMoE.MoETransformerLM(JMoE.MoEConfig(dtype=jnp.float32, **MOE))
    variables = base.init(jax.random.PRNGKey(1), tok)
    model = JMoE.MoETransformerLM(JMoE.MoEConfig(
        dtype=jnp.float32, remat_policy=policy, **MOE))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda v: jnp.sum(model.apply(v, tok) ** 2)))(variables)
    return _np(variables), float(loss), _np(grads)


def _port_moe(variables, policy):
    model = TMoE.MoETransformerLM(TMoE.MoEConfig(
        dtype=torch.float32, remat_policy=policy, **MOE))
    model.load_state_dict(params_from_flax(variables))
    loss = (model(torch.from_numpy(_tokens(64, (2, 16)))) ** 2).sum()
    loss.backward()
    return model, loss


MODELS = {"lm": (_jax_lm, _port_lm), "vit": (_jax_vit, _port_vit),
          "moe": (_jax_moe, _port_moe)}


@pytest.fixture(scope="module")
def runs():
    """Each model under each tier in both packages: JAX's (variables, loss,
    gradients as a port state_dict) and the port's (loss, gradients)."""
    out = {}
    for name, (jfn, tfn) in MODELS.items():
        for policy in POLICIES:
            variables, jloss, jgrads = jfn(policy)
            model, tloss = tfn(variables, policy)
            out[name, policy] = (
                jloss, {k: v.numpy() for k, v in
                        params_from_flax(jgrads).items()},
                float(tloss.detach()),
                {k: p.grad.clone() for k, p in model.named_parameters()})
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("policy", POLICIES)
def test_matches_jax_tier(runs, name, policy):
    jloss, jgrads, tloss, tgrads = runs[name, policy]
    ltol, rtol, atol = TOL[name]
    np.testing.assert_allclose(tloss, jloss, rtol=ltol, atol=ltol)
    assert set(tgrads) == set(jgrads)
    for k, g in tgrads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[k], rtol=rtol,
                                   atol=atol, err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("policy", POLICIES[1:])
def test_tier_bit_for_bit_none(runs, name, policy):
    """Recompute gives the same bits: each tier's loss and every gradient
    equal ``none``'s exactly on the CPU."""
    _, _, loss0, grads0 = runs[name, "none"]
    _, _, loss, grads = runs[name, policy]
    assert loss == loss0
    assert all(torch.equal(grads[k], grads0[k]) for k in grads0)


class TestResolution:
    """``tests/test_remat.py``'s precedence cases through both packages."""

    CASES = [((), {}), ((), {"remat": True}), ((), {"remat": False}),
             ((), {"remat": "dots"}), (("full",), {}),
             (("full",), {"remat": True}), ((), {"remat": "offload"})]

    @pytest.mark.parametrize("env", [None, "dots"])
    @pytest.mark.parametrize("case", range(len(CASES)))
    def test_matches_jax(self, monkeypatch, env, case):
        if env:
            monkeypatch.setenv("HOROVOD_REMAT_POLICY", env)
        else:
            monkeypatch.delenv("HOROVOD_REMAT_POLICY", raising=False)
        args, kw = self.CASES[case]
        assert TR.resolve_remat_policy(*args, **kw) == \
            JR.resolve_remat_policy(*args, **kw)

    def test_unknown_policy_refuses_in_jax_words(self, monkeypatch):
        for bad in ("sometimes",):
            with pytest.raises(ValueError) as je:
                JR.resolve_remat_policy(bad)
            with pytest.raises(ValueError) as te:
                TR.resolve_remat_policy(bad)
            assert str(te.value) == str(je.value)
        monkeypatch.setenv("HOROVOD_REMAT_POLICY", "frobnicate")
        with pytest.raises(ValueError, match="unknown remat policy"):
            TR.resolve_remat_policy()

    def test_vocabulary(self):
        assert TR.REMAT_POLICIES == JR.REMAT_POLICIES
        assert TR.REMAT_POLICIES == TCM.REMAT_POLICIES


class TestWrappers:
    def test_none_is_identity(self):
        def fn(x):
            return x

        block = torch.nn.Linear(2, 2)
        assert TR.remat_block(block, "none") is block
        assert TR.remat_fn(fn, "none") is fn

    @pytest.mark.parametrize("policy", POLICIES[1:])
    def test_remat_fn_parity(self, policy):
        """``tests/test_remat.py``'s function: the gradient of
        ``sum(tanh(x @ xᵀ))`` under each tier equals the plain one."""
        def f(x):
            return torch.tanh(x @ x.T).sum()

        x = torch.from_numpy(np.random.RandomState(0).randn(8, 8)
                             .astype(np.float32)).requires_grad_()
        base = torch.autograd.grad(f(x), x)[0]
        got = torch.autograd.grad(TR.remat_fn(f, policy)(x), x)[0]
        assert torch.equal(base, got)

    def test_no_grad_runs_plain(self):
        calls = []

        def f(x):
            calls.append(torch.is_grad_enabled())
            return x * 2

        with torch.no_grad():
            TR.remat_fn(f, "full")(torch.ones(2, requires_grad=True))
        assert calls == [False]

    def test_env_policy_reaches_the_block(self, monkeypatch):
        """``HOROVOD_REMAT_POLICY`` steers an unflagged model, resolved at
        each forward: the same numbers."""
        cfg = TT.TransformerConfig(dtype=torch.float32, **LM)
        model = TT.TransformerLM(cfg, generator=torch.Generator()
                                 .manual_seed(0))
        tok = torch.from_numpy(_tokens(128, (2, 33)))
        want = TT.lm_loss(model, tok)
        monkeypatch.setenv("HOROVOD_REMAT_POLICY", "full")
        assert torch.equal(TT.lm_loss(model, tok), want)

    def test_moe_trains_under_remat(self):
        """``MoEConfig(remat=True)`` is the ``full`` tier (the config no
        longer refuses it)."""
        cfg = TMoE.MoEConfig(dtype=torch.float32, remat=True, **MOE)
        model = TMoE.MoETransformerLM(cfg, generator=torch.Generator()
                                      .manual_seed(0))
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        tok = torch.from_numpy(_tokens(64, (4, 17)))
        losses = []
        for _ in range(4):
            opt.zero_grad()
            loss = TT.lm_loss(model, tok) + 0.01 * TMoE.moe_aux_loss(model)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        assert np.isfinite(losses).all() and losses[-1] < losses[0]


class TestTrainStepPolicy:
    def _step(self, hvd, **kw):
        model = torch.nn.Linear(8, 4)

        def loss_fn(m, batch):
            return (m(batch) ** 2).mean()

        return hvd.DistributedTrainStep(
            loss_fn, torch.optim.SGD(model.parameters(), lr=0.1), **kw)

    def test_policy_string_and_default(self, hvd_torch, monkeypatch):
        monkeypatch.delenv("HOROVOD_REMAT_POLICY", raising=False)
        assert self._step(hvd_torch, remat="dots").remat_policy == "dots"
        assert self._step(hvd_torch, remat=True).remat_policy == "full"
        assert self._step(hvd_torch).remat_policy == "none"

    def test_env_policy(self, hvd_torch, monkeypatch):
        monkeypatch.setenv("HOROVOD_REMAT_POLICY", "dots")
        assert self._step(hvd_torch, remat=True).remat_policy == "dots"

    @pytest.mark.parametrize("remat", ["full", "dots", "offload"])
    def test_remat_step_trains_identically(self, hvd_torch, remat):
        """``tests/test_remat.py``'s seeded MLP: three steps under a
        remat tier equal the plain step's, bit for bit."""
        rng = np.random.RandomState(0)
        w1 = torch.from_numpy(rng.randn(8, 16).astype(np.float32))
        w2 = torch.from_numpy(rng.randn(16, 4).astype(np.float32))
        x = torch.from_numpy(np.random.RandomState(1).randn(8, 8)
                             .astype(np.float32))
        y = torch.from_numpy(np.random.RandomState(2).randn(8, 4)
                             .astype(np.float32))

        def loss_fn(m, batch):
            h = torch.tanh(batch["x"] @ m.w1)
            return ((h @ m.w2 - batch["y"]) ** 2).mean()

        losses = {}
        for r in (False, remat):
            m = torch.nn.Module()
            m.w1 = torch.nn.Parameter(w1.clone())
            m.w2 = torch.nn.Parameter(w2.clone())
            step = hvd_torch.DistributedTrainStep(
                loss_fn, torch.optim.SGD(m.parameters(), lr=0.1), remat=r)
            m, opt = step.init(m)
            batch = step.shard_batch({"x": x, "y": y})
            for _ in range(3):
                m, opt, loss = step(m, opt, batch)
            losses[r] = float(loss)
        assert losses[False] == losses[remat]
