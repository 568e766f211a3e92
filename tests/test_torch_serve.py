"""The port's serving plane against the JAX package's.

1. ``tests/test_serve.py`` (signatures, admission, the exactly-once
   state machine, signature batching, the executable cache, the replica
   pool, the elastic bridge, the continuous batcher) run against the
   port's modules, collected here under ``Port`` names; its gate and
   smoke classes gate the JAX package's bench artifacts and demo script.
2. The JAX package's seeded serve scenario (``horovod_tpu/serve/
   smoke.py``: a seeded request stream on a logical clock, a
   ``serve.batch`` crash mid-batch, a graceful drain) through both
   packages: the same admissions, responses, batch compositions,
   requeues, replica states, drains and clock; with torch tensors as
   payloads the port's responses are the same again.
3. ``ExecutableCache.from_module`` over a small LM with weights carried
   from flax, against JAX's model apply through JAX's ``ExecutableCache``
   on a plain ``jax.jit`` build function: two signatures, padded buckets,
   the last position's logits within 2e-5; ``weights=`` runs the forward
   on the weights given.  Under ``torch.inference_mode()`` the flash path
   runs its forward once and keeps nothing for a backward.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as JT
from horovod_tpu.serve import batcher as JB
from horovod_tpu_torch.models import transformer as TT
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.serve import (
    AdmissionQueue,
    ContinuousBatcher,
    ExecutableCache,
    InferenceRequest,
    Replica,
    ReplicaPool,
    payload_signature,
)

from torch_port_workers import port_test_module

_SERVE = port_test_module("test_serve.py", [
    (r"from horovod_tpu.analysis import perf_gate as PG\n", "")])
for _name in ("TestPayloadSignature", "TestAdmission", "TestExactlyOnce",
              "TestSignatureBatching", "TestExecutableCache",
              "TestReplicaPool", "TestElasticBridge",
              "TestContinuousBatcher"):
    globals()["TestPort" + _name[len("Test"):]] = getattr(_SERVE, _name)
_no_fault_plan = _SERVE._no_fault_plan

#: the JAX package's demo scenario and its port
_JAX_SMOKE = "horovod_tpu/serve/smoke.py"


def test_every_serve_case_is_collected():
    """Every class but the bench-artifact gate and the demo script's."""
    names = {n for n in vars(_SERVE) if n.startswith("Test")}
    here = {n[len("TestPort"):] for n in globals() if n.startswith("TestPort")}
    assert {n[len("Test"):] for n in names} - here == {"Smoke",
                                                       "ServeArtifactGate"}


# -- the seeded scenario ------------------------------------------------------

def test_seeded_scenario_equals_jax():
    """Admissions, every response (result, requeues, replica), the
    requeued ids, replica states, drains, engine steps and the logical
    clock: equal."""
    from horovod_tpu.serve import smoke as jsmoke

    port = port_test_module(_JAX_SMOKE)
    want = jsmoke._scenario()
    got = port._scenario()
    assert got == want
    assert got["requeued_ids"] and port.run_smoke() == []


def test_seeded_scenario_with_tensor_payloads():
    """The same stream with fp32 CPU tensors as payloads: the same
    responses; the signature names torch's dtype."""
    port = port_test_module(_JAX_SMOKE, [
        (r"payload=rng.rand\(4\).astype\(np.float32\)",
         "payload=torch.from_numpy(rng.rand(4).astype(np.float32))"),
        (r"import numpy as np\n", "import numpy as np\nimport torch\n")])
    from horovod_tpu.serve import smoke as jsmoke

    assert port._scenario() == jsmoke._scenario()
    assert payload_signature(torch.zeros(4)) == ((4,), "torch.float32")


# -- from_module against JAX's apply ------------------------------------------

SIZES = dict(vocab_size=96, num_layers=2, num_heads=4, d_model=64,
             d_ff=128, max_seq_len=32)
BUCKETS = (1, 2, 4, 8)
LOGITS_ATOL = 2e-5


class LastLogits(torch.nn.Module):
    """A served LM's result: the last position's logits."""

    def __init__(self, lm):
        super().__init__()
        self.lm = lm

    def forward(self, tokens):
        return self.lm(tokens)[:, -1]


@pytest.fixture(scope="module")
def lms():
    model = JT.TransformerLM(JT.TransformerConfig(
        dtype=jnp.float32, attention_impl="dense", **SIZES))
    variables = model.init(jax.random.PRNGKey(11),
                           jnp.zeros((1, 16), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray,
                                    flax.core.meta.unbox(variables))
    port = TT.TransformerLM(TT.TransformerConfig(
        dtype=torch.float32, attention_impl="flash", **SIZES))
    port.load_state_dict(params_from_flax(params))
    return model, params, LastLogits(port)


def _requests():
    rng = np.random.RandomState(4)
    return [rng.randint(0, SIZES["vocab_size"], (16 if i % 3 else 8,))
            .astype(np.int64) for i in range(11)]


def _example(signature, padded):
    return torch.zeros((padded,) + tuple(signature[0]), dtype=torch.long)


def test_from_module_equals_jax_apply(lms):
    """Batches of 1, 3 and 7 payloads of two signatures, padded to their
    buckets: each result within 2e-5 of JAX's ``model.apply`` through
    JAX's ``ExecutableCache``; one executable a (signature, bucket)."""
    jmodel, params, served = lms
    built = []

    def jbuild(signature, padded):
        built.append((signature, padded))
        fn = jax.jit(lambda x: jmodel.apply(params, x)[:, -1])
        return lambda xs: list(np.asarray(fn(jnp.stack(xs))))

    jcache = JB.ExecutableCache(jbuild, bucket_sizes=BUCKETS)
    tcache = ExecutableCache.from_module(served, _example,
                                         bucket_sizes=BUCKETS)
    reqs = _requests()
    for sig_len in (16, 8):
        group = [r for r in reqs if r.shape[0] == sig_len]
        for n in (1, 3, len(group)):
            want = jcache.run([r.astype(np.int32) for r in group[:n]])
            got = tcache.run([torch.from_numpy(r) for r in group[:n]])
            assert len(got) == n
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), w, atol=LOGITS_ATOL)
    assert len(tcache) == len(jcache) == len(built)


def test_from_module_runs_the_weights_given(lms):
    """``weights=`` (the refresher's buffer): the forward of a model
    holding those weights, and the model's own are left alone."""
    _, _, served = lms
    cache = ExecutableCache.from_module(served, _example,
                                        bucket_sizes=BUCKETS)
    x = [torch.from_numpy(r) for r in _requests()[1:3]]
    own = cache.run(x)
    g = torch.Generator().manual_seed(2)
    other = {k: v + 0.01 * torch.randn(v.shape, generator=g)
             for k, v in served.state_dict().items()}
    with_other = cache.run(x, weights=other)
    twin = LastLogits(TT.TransformerLM(served.lm.cfg))
    twin.load_state_dict(other)
    with torch.inference_mode():
        want = twin(torch.stack(x))
    for g_, w in zip(with_other, want):
        torch.testing.assert_close(g_, w, rtol=0, atol=1e-6)
    for a, b in zip(own, cache.run(x)):
        assert torch.equal(a, b)


def test_batcher_over_from_module(lms):
    """The continuous batcher on two replicas over one ``from_module``
    cache, a crash on one mid-load: every request answered once, each
    result equal to the model's own forward of that request alone."""
    from horovod_tpu_torch import faults

    _, _, served = lms
    cache = ExecutableCache.from_module(served, _example,
                                        bucket_sizes=BUCKETS)
    q = AdmissionQueue(depth=64, max_requeues=3)
    pool = ReplicaPool(q, drain_timeout_s=1.0)
    for i in range(2):
        pool.add_replica(Replica(f"r{i}", cache.run, host=f"h{i}"))
    got = {}
    b = ContinuousBatcher(q, pool, max_batch=4, on_response=lambda r:
                          got.setdefault(r.request_id, []).append(r))
    reqs = _requests()
    for i, r in enumerate(reqs):
        assert q.submit(InferenceRequest(f"q{i}", torch.from_numpy(r))) \
            == "admitted"
    faults.set_plan(faults.FaultPlan(sim=True).add("serve.batch", "crash",
                                                   at=2))
    try:
        while len(q):
            b.step()
    finally:
        faults.clear_plan()
    assert sorted(got) == sorted(f"q{i}" for i in range(len(reqs)))
    assert all(len(v) == 1 for v in got.values())
    assert sum(v[0].requeues for v in got.values()) > 0
    with torch.inference_mode():
        for i, r in enumerate(reqs):
            want = served(torch.from_numpy(r)[None])[0]
            torch.testing.assert_close(got[f"q{i}"][0].result, want,
                                       rtol=0, atol=LOGITS_ATOL)


def test_inference_runs_the_forward_kernel_alone(monkeypatch):
    """Under ``torch.inference_mode()`` ``flash_attention`` calls
    ``flash_fwd`` once and builds no autograd node (nothing is kept for a
    backward); with gradients it builds one."""
    from horovod_tpu_torch.ops import kernels as K

    calls = []
    real = K.flash_fwd
    monkeypatch.setattr(K, "flash_fwd", lambda *a, **kw: calls.append(1)
                        or real(*a, **kw))
    q, k, v = (torch.randn(2, 16, 2, 64) for _ in range(3))
    with torch.inference_mode():
        out = K.flash_attention(q, k, v, causal=True)
    assert calls == [1] and out.grad_fn is None
    q.requires_grad_(True)
    out = K.flash_attention(q, k, v, causal=True)
    assert calls == [1, 1] and out.grad_fn is not None
