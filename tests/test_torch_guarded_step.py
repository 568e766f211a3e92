"""``DistributedTrainStep(guard=)`` of the port against the JAX package's.

1. A small LM with weights carried from flax (``models/convert.py``):
   JAX's guarded step in pjit mode on the conftest's CPU mesh against the
   port's on a world of one, over a schedule with a non-finite loss and a
   spike past the limit: the norms within 1e-5 relative, the same
   verdicts, the parameters within the step-parity tolerances.
2. Gloo worlds of 2 (``run_guard`` in ``tests/torch_port_workers.py``):
   the hook path, the sharded exchange with int8 error feedback, Adasum's
   delta form, ``tp=2`` and ``fsdp=2``.  Every rank reaches the same
   verdict with the same norm; a skipped step leaves the parameters and
   the optimizer state (AdamW's step counters, the residuals) bit for bit
   as they were; the norm is the global one, each element counted once
   (against a world of one on the global batch, or, where JAX takes the
   norm before the reduction, against the root of the ranks' summed
   squares).
3. The four-card test's scenario on a gloo world of 4 with a small LM.
4. Refusals, and a step that only accumulates.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as jhvd
from horovod_tpu import guard as jguard
from horovod_tpu.models import transformer as JT
from horovod_tpu_torch.models import transformer as TT
from horovod_tpu_torch.models.convert import params_from_flax

from torch_port_workers import (
    GUARD_CASES,
    GUARD_SCALES,
    GUARD_VERDICTS,
    assert_adam_close,
    check_guard_world,
    guard_case,
    guard_loss,
    guard_model,
    guard_tokens,
    spawn_world,
)

SIZES = dict(vocab_size=128, num_layers=2, num_heads=4, d_model=64,
             d_ff=256, max_seq_len=32)
ROWS = 8
GNORM_RTOL = 1e-5


def _tokens():
    return np.random.RandomState(7).randint(0, 128, (ROWS, 17)).astype(
        np.int32)


@pytest.fixture
def hvd_torch():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


@pytest.fixture(scope="module")
def jax_guarded():
    """JAX's guarded step (pjit, optax.adamw(3e-4)) over GUARD_SCALES: the
    initial parameters, each step's norm and verdict, the final
    parameters."""
    jhvd.init()
    try:
        model = JT.TransformerLM(JT.TransformerConfig(
            dtype=jnp.float32, attention_impl="dense", **SIZES))
        variables = model.init(jax.random.PRNGKey(3),
                               jnp.zeros((1, 16), jnp.int32))
        params0 = jax.tree_util.tree_map(np.asarray,
                                         flax.core.meta.unbox(variables))

        def loss_fn(params, batch):
            logits = model.apply(params, batch["inputs"])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, batch["labels"]).mean() * batch["scale"][0]

        g = jguard.TrainingGuard(policy="skip_step", warmup_steps=2)
        step = jhvd.DistributedTrainStep(loss_fn, optax.adamw(3e-4),
                                         guard=g)
        params, opt_state = step.init(params0)
        tok = _tokens()
        gnorms, verdicts = [], []
        for scale in GUARD_SCALES:
            batch = step.shard_batch({
                "inputs": tok[:, :-1], "labels": tok[:, 1:],
                "scale": np.full((ROWS,), scale, np.float32)})
            params, opt_state, _ = step(params, opt_state, batch)
            gnorms.append(g.numerics.last_gnorm)
            verdicts.append(g.numerics.last_verdict)
        final = jax.tree_util.tree_map(np.asarray, params)
    finally:
        jhvd.shutdown()
    return params0, gnorms, verdicts, final


def _port_guarded(hvd, params0):
    from horovod_tpu_torch.guard import TrainingGuard

    model = TT.TransformerLM(TT.TransformerConfig(
        dtype=torch.float32, attention_impl="flash", **SIZES))
    model.load_state_dict(params_from_flax(params0))
    g = TrainingGuard(policy="skip_step", warmup_steps=2)
    step = hvd.DistributedTrainStep(
        lambda m, b: TT.lm_loss(m, b["tokens"]) * b["scale"][0],
        hvd.DistributedOptimizer(torch.optim.AdamW(
            model.parameters(), lr=3e-4, weight_decay=1e-4)), guard=g)
    model, opt = step.init(model)
    tok = torch.from_numpy(_tokens()).long()
    gnorms, verdicts = [], []
    for scale in GUARD_SCALES:
        step(model, opt, step.shard_batch(
            {"tokens": tok, "scale": torch.full((ROWS,), scale)}))
        gnorms.append(g.numerics.last_gnorm)
        verdicts.append(g.numerics.last_verdict)
    return model, gnorms, verdicts


class TestAgainstJax:
    def test_norms_and_verdicts(self, hvd_torch, jax_guarded):
        """Each step's norm within 1e-5 relative of JAX's pjit norm (the
        global gradient's), NaN where JAX's is; the same verdicts."""
        params0, want, verdicts, _ = jax_guarded
        _, got, got_verdicts = _port_guarded(hvd_torch, params0)
        assert got_verdicts == verdicts == list(GUARD_VERDICTS)
        np.testing.assert_allclose(got, want, rtol=GNORM_RTOL)

    def test_params_after_skips(self, hvd_torch, jax_guarded):
        """Five updates in seven calls: the parameters within
        ``assert_adam_close``'s step-parity tolerance of JAX's."""
        params0, _, _, final = jax_guarded
        model, _, _ = _port_guarded(hvd_torch, params0)
        want = params_from_flax(final)
        for name, p in model.state_dict().items():
            assert_adam_close(p.numpy(), want[name].numpy(), name, steps=5)


# -- gloo worlds --------------------------------------------------------------

@pytest.fixture(scope="module")
def world2():
    return spawn_world("run_guard", world=2, timeout=300)


@pytest.fixture(scope="module")
def one_rank():
    """The hook path on a world of one over the same global batch: the
    norm of the global gradient at every step."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        return guard_case(hvd, "hook", guard_tokens(2))
    finally:
        hvd.shutdown()


def _pre_reduction_norm() -> float:
    """The first step's norm where JAX takes it before the reduction: the
    root of the two ranks' summed squares of their own gradients."""
    model = guard_model()
    tokens = torch.from_numpy(guard_tokens(2))
    total = 0.0
    for half in tokens.chunk(2):
        model.zero_grad()
        guard_loss(model, {"tokens": half,
                           "scale": torch.ones(half.shape[0])}).backward()
        total += sum(float(p.grad.double().square().sum())
                     for p in model.parameters())
    return total ** 0.5


@pytest.mark.parametrize("case", GUARD_CASES)
def test_every_rank_same_verdict(world2, case):
    """Each rank's norms equal bit for bit, and the verdicts are the
    schedule's: ok, a non-finite step and a spike skipped."""
    ranks = [out[case] for out in world2]
    assert ranks[0]["verdict"] == list(GUARD_VERDICTS)
    for out in ranks[1:]:
        assert out["verdict"] == ranks[0]["verdict"]
        np.testing.assert_array_equal(out["gnorm"], ranks[0]["gnorm"])
        assert out["limit"] == ranks[0]["limit"]


@pytest.mark.parametrize("case", GUARD_CASES)
def test_skip_leaves_state_unchanged(world2, case):
    """The parameters and the optimizer state (the sharded exchange's
    shard state and error-feedback residuals, AdamW's step counters)
    fingerprint the same after a skipped step, and not after an applied
    one."""
    for out in world2:
        r = out[case]
        assert r["unchanged"] == [v != "ok" for v in r["verdict"]]


@pytest.mark.parametrize("case", ["hook", "tp", "fsdp"])
def test_norm_counts_each_element_once(world2, one_rank, case):
    """Under the hook path, tp = 2 and fsdp = 2 the norm is the global
    gradient's, a shard's squares summed over its group and a leaf tp
    leaves whole counted once: the world of one's on the global batch,
    within 1e-5 relative at the first step (the same parameters) and
    1e-3 after (two trajectories within AdamW's rounding)."""
    got = world2[0][case]["gnorm"]
    want = one_rank["gnorm"]
    np.testing.assert_allclose(got[0], want[0], rtol=GNORM_RTOL)
    ok = [i for i, v in enumerate(GUARD_VERDICTS) if v == "ok"]
    np.testing.assert_allclose([got[i] for i in ok], [want[i] for i in ok],
                               rtol=1e-3)


@pytest.mark.parametrize("case", ["sharded", "adasum"])
def test_pre_reduction_norm(world2, case):
    """Under the sharded exchange and the delta form the norm is JAX's
    root of the world's summed squares before the reduction."""
    np.testing.assert_allclose(world2[0][case]["gnorm"][0],
                               _pre_reduction_norm(), rtol=GNORM_RTOL)


def test_replica_vote_over_gloo(world2):
    """``dist_gather_fn``: equal replicas agree; a parameter perturbed on
    rank 1 is named by both ranks' votes."""
    for out in world2:
        assert out["hook"]["fps_agree"]
        assert out["hook"]["diverged"] == [1]


def test_guard_world_rehearsal():
    """The four-card test's scenario on a gloo world of 4 with MP_LM:
    rank 2's corruption named by every rank, the world rolled back to the
    pinned step, the fault-free parameters bit for bit, and the sharded
    exchange's skip on every rank."""
    outs = spawn_world("run_guard_nccl", world=4, args=(True,), timeout=300)
    check_guard_world(outs)


# -- refusals and accumulation ----------------------------------------------

def test_steps_per_call_refused_in_jax_words(hvd_torch):
    jhvd.init()
    try:
        with pytest.raises(ValueError) as want:
            jhvd.DistributedTrainStep(lambda p, b: 0.0, optax.sgd(0.1),
                                      guard=jguard.TrainingGuard(),
                                      steps_per_call=2)
    finally:
        jhvd.shutdown()
    model = guard_model()
    with pytest.raises(ValueError) as got:
        hvd_torch.DistributedTrainStep(
            guard_loss, torch.optim.SGD(model.parameters(), lr=0.1),
            guard=jguard.TrainingGuard(), steps_per_call=2)
    assert str(got.value) == str(want.value)


def test_accumulation_observes_updating_calls(hvd_torch):
    """``backward_passes_per_step=2``: the guardian sees one norm each
    second call, the mean gradient's."""
    from horovod_tpu_torch.guard import TrainingGuard

    model = guard_model()
    g = TrainingGuard(policy="skip_step", warmup_steps=2)
    step = hvd_torch.DistributedTrainStep(
        guard_loss, hvd_torch.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-3),
            backward_passes_per_step=2), guard=g)
    model, opt = step.init(model)
    tokens = torch.from_numpy(guard_tokens(1))
    batch = step.shard_batch({"tokens": tokens,
                              "scale": torch.ones(tokens.shape[0])})
    seen = []
    for _ in range(4):
        step(model, opt, batch)
        seen.append(g.numerics.observed_steps)
    assert seen == [0, 1, 1, 2]
