"""The port's sequence-parallel slice against the JAX package: the
global-positions flash plain versions, the ring index math, the plan
grammar, ``ring_flash_attention``, the plain ring, Ulysses, the ring and
Ulysses TransformerLM, and ``DistributedTrainStep(plan="dp=2,sp=2")``.

One gloo world of 2 and one of 4 (``run_sp`` in ``torch_port_workers``)
start together and run every multi-rank check while the JAX references
compute; each JAX reference runs under ``shard_map`` on as many CPU devices
as the world has ranks, on the same numpy inputs, and is compared rank by
rank.  Tolerances are the JAX tests' own (``tests/test_sp_ring.py``): 2e-5
for fp32 attention outputs and 1e-4 for their gradients; the model's are
those of ``tests/test_torch_tp.py``; the train step against its dense twin
2e-4 (JAX ``TestTrainStepSp``, whose own test is not used as an oracle).
"""

from concurrent.futures import ThreadPoolExecutor

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.models import transformer as JT
from horovod_tpu.ops import pallas_kernels as PK
from horovod_tpu.parallel import plan as JP
from horovod_tpu.parallel.ring_attention import reference_attention as \
    j_reference
from horovod_tpu.parallel.ring_attention import ring_attention as j_ring
from horovod_tpu.parallel.ulysses import ulysses_attention as j_ulysses
from horovod_tpu_torch.models import transformer as TT
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.ops import fused_collectives as FC
from horovod_tpu_torch.ops import kernels as K
from horovod_tpu_torch.parallel import plan as TP
from horovod_tpu_torch.parallel import ring_attention as TR

from torch_port_workers import (
    FUSED_RING_CASES,
    PLAIN_RING_CASES,
    SP_LM_CASES,
    TP_SIZES,
    ULYSSES_CASES,
    sp_order,
    sp_qkv,
    sp_shard,
    sp_train_rows,
    spawn_world,
)

WORLDS = (2, 4)
SPEC = P(None, "sp", None, None)
OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
#: fused-ring cases also held against the JAX fused ring in interpret mode
#: (the rest against the JAX dense reference, which that ring equals within
#: the same tolerances in the JAX package's own tests)
AGAINST_JAX_FUSED = [(4, 128, True, "zigzag"), (4, 4, True, "contiguous")]


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


@pytest.fixture(scope="module", autouse=True)
def worlds(flax_params, tokens):
    """Both gloo worlds start with the module's first test and run while the
    tests compute their JAX references; a test reads a world's per-rank
    results with ``worlds[w].result()``."""
    pool = ThreadPoolExecutor(len(WORLDS))
    futures = {w: pool.submit(spawn_world, "run_sp", world=w,
                              args=(flax_params, tokens), timeout=240)
               for w in WORLDS}
    yield futures
    pool.shutdown(wait=True)


def _mesh(world):
    return Mesh(np.asarray(jax.devices("cpu")[:world]), ("sp",))


def _jax_vjp(fn, q, k, v, g):
    """``fn``'s output and the q, k, v cotangents for ``g``."""
    def go(q, k, v, g):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out,) + vjp(g)

    return [np.asarray(x) for x in jax.jit(go)(q, k, v, g)]


def _sharded(world, fn):
    return jax.shard_map(fn, mesh=_mesh(world), in_specs=(SPEC,) * 3,
                         out_specs=SPEC, check_vma=False)


def _dense_reference(world, t, causal, layout):
    """JAX dense attention on the natural sequence, its output and
    gradients reordered into the layout's shard order."""
    q, k, v, g = sp_qkv(t)
    got = _jax_vjp(lambda a, b, c: j_reference(a, b, c, causal=causal),
                   q, k, v, g)
    order = sp_order(world, t, layout)
    return [x[:, order] for x in got]


def _ring_reference(world, t, causal, layout, fused):
    """The JAX ring under shard_map on the layout-ordered sequence."""
    order = sp_order(world, t, layout)
    q, k, v, g = (x[:, order] for x in sp_qkv(t))
    fn = _sharded(world, lambda a, b, c: j_ring(
        a, b, c, "sp", causal=causal, fused=fused, layout=layout,
        interpret=True))
    return _jax_vjp(fn, q, k, v, g)


def _check_shards(outs, key, want, world):
    """Every rank's (out, dq, dk, dv) against the reference's shard."""
    n = want[0].shape[1] // world
    for rank, out in enumerate(outs):
        got = out[key]
        assert np.isfinite(got[0]).all(), f"rank {rank}"
        for name, a, ref in zip(("out", "dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(
                a, ref[:, rank * n:(rank + 1) * n],
                **(OUT_TOL if name == "out" else GRAD_TOL),
                err_msg=f"rank {rank} {name}")


# ---------------------------------------------------------------------------
# the flash plain versions with global positions
# ---------------------------------------------------------------------------

def _position_pairs():
    """(name, qpos, kpos) of the sp ring's launches at world 4, t_local 16:
    (a) arange, (b) zigzag rank 1's queries against rank 3's block (some
    rows see no key), (c) zigzag rank 2 against its own block, (d)
    contiguous rank 0 against rank 1's block (every row masked)."""
    def pos(rank, layout):
        return FC.ring_layout_positions(rank, 4, 16, layout).numpy()

    return [("a_arange", np.arange(16), np.arange(16)),
            ("b_zigzag_1_3", pos(1, "zigzag"), pos(3, "zigzag")),
            ("c_zigzag_2_2", pos(2, "zigzag"), pos(2, "zigzag")),
            ("d_contiguous_0_1", pos(0, "contiguous"),
             pos(1, "contiguous"))]


@pytest.mark.parametrize("name,qpos,kpos", _position_pairs(),
                         ids=[p[0] for p in _position_pairs()])
def test_positions_plain_match_pallas(name, qpos, kpos):
    """The forward, dQ and dK/dV plain versions with positions against
    ``_flash_fwd``/``_flash_bwd`` with ``qpos/kpos`` in interpret mode, the
    backward from the forward's lse and delta as the ring passes them."""
    rng = np.random.RandomState(11)
    q, k, v, g = (rng.randn(1, 16, 2, 16).astype(np.float32)
                  for _ in range(4))
    scale = 16 ** -0.5
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    out_j, lse_j = PK._flash_fwd(jq, jk, jv, True, scale, 16, 16, True,
                                 qpos=jnp.asarray(qpos),
                                 kpos=jnp.asarray(kpos))
    dq_j, dk_j, dv_j = PK._flash_bwd(jq, jk, jv, out_j, lse_j, jg, True,
                                     scale, 16, 16, True,
                                     qpos=jnp.asarray(qpos),
                                     kpos=jnp.asarray(kpos))
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    tqp, tkp = torch.from_numpy(qpos).int(), torch.from_numpy(kpos).int()
    out, lse = K.flash_fwd(tq, tk, tv, True, scale, tqp, tkp)
    delta = K.flash_delta(out, tg)
    dq, _ = K.flash_bwd_dq(tq, tk, tv, tg, lse, delta, True, scale, tqp,
                           tkp)
    dk, dv = K.flash_bwd_dkv(tq, tk, tv, tg, lse, delta, True, scale, tqp,
                             tkp)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **OUT_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, 0],
                               **OUT_TOL)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)
    masked = ~(qpos[:, None] >= kpos[None, :]).any(1)
    assert (name[0] in "bd") == bool(masked.any())
    if masked.any():
        assert not out.numpy()[:, masked].any()
        assert (lse.numpy()[:, masked] == K.NEG_INF).all()
    if name[0] == "d":
        assert not (dq.any() or dk.any() or dv.any())


def test_positions_arange_equal_local_indices():
    """At ``arange`` positions the variant is the kernel without them, bit
    for bit (the masked tiles the variant adds contribute exact zeros)."""
    rng = np.random.RandomState(12)
    q, k, v, g = (torch.from_numpy(rng.randn(2, 40, 2, 16).astype(
        np.float32)) for _ in range(4))
    pos = torch.arange(40, dtype=torch.int32)
    out, lse = K.flash_fwd(q, k, v, True, 0.25)
    out_p, lse_p = K.flash_fwd(q, k, v, True, 0.25, pos, pos)
    delta = K.flash_delta(out, g)
    assert torch.equal(out, out_p) and torch.equal(lse, lse_p)
    assert torch.equal(K.flash_bwd_dq(q, k, v, g, lse, delta, True, 0.25)[0],
                       K.flash_bwd_dq(q, k, v, g, lse, delta, True, 0.25,
                                      pos, pos)[0])
    for a, b in zip(K.flash_bwd_dkv(q, k, v, g, lse, delta, True, 0.25),
                    K.flash_bwd_dkv(q, k, v, g, lse, delta, True, 0.25,
                                    pos, pos)):
        assert torch.equal(a, b)


def test_positions_must_come_in_pairs():
    q = torch.zeros(1, 8, 1, 16)
    with pytest.raises(ValueError, match="both"):
        K._positions(torch.arange(8), None, 8, q.device)
    with pytest.raises(ValueError, match="positions"):
        K._positions(torch.arange(7), torch.arange(7), 8, q.device)


# ---------------------------------------------------------------------------
# the ring index math and the plan grammar
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", range(1, 9))
@pytest.mark.parametrize("layout", FC.RING_LAYOUTS)
def test_ring_index_math_matches_jax(world, layout):
    """Positions of every rank, the zigzag permutation and the causal and
    full schedules against the JAX functions."""
    for rank in range(world):
        np.testing.assert_array_equal(
            FC.ring_layout_positions(rank, world, 6, layout).numpy(),
            np.asarray(PK.ring_layout_positions(rank, world, 6, layout)))
    np.testing.assert_array_equal(
        FC.zigzag_sequence_indices(world, 6 * world).numpy(),
        np.asarray(PK.zigzag_sequence_indices(world, 6 * world)))
    for causal in (False, True):
        assert FC.ring_step_schedule(world, causal, layout) == \
            PK.ring_step_schedule(world, causal=causal, layout=layout)


def test_ring_step_schedule_census():
    """TestRingStepSchedule's pins: the contiguous causal triangle, zigzag
    never skipping, and the layout errors."""
    s = FC.ring_step_schedule(4, causal=True, layout="contiguous")
    assert (s["launches"], s["skipped"], s["skipped_by_rank"]) == \
        (10, 6, (3, 2, 1, 0))
    for w in (2, 4, 8):
        assert FC.ring_step_schedule(w, True, "contiguous")["skipped"] == \
            w * (w - 1) // 2
        assert FC.ring_step_schedule(w, True, "zigzag")["skipped_by_rank"] \
            == (0,) * w
    for layout in FC.RING_LAYOUTS:
        assert FC.ring_step_schedule(4, False, layout)["launches"] == 16
    with pytest.raises(ValueError, match="layout"):
        FC.ring_step_schedule(4, layout="striped")
    with pytest.raises(ValueError, match="layout"):
        FC.ring_layout_positions(0, 4, 8, "striped")
    with pytest.raises(ValueError, match="even"):
        FC.ring_layout_positions(0, 4, 7, "zigzag")
    with pytest.raises(ValueError, match="divisible"):
        FC.zigzag_sequence_indices(4, 12)


@pytest.mark.parametrize("text", ["dp=4,tp=2", "sp=4", "dp=2,sp=2",
                                  " fsdp=2 , sp=2 ", "dp=2,pp=2,v=2",
                                  "", "dp=0", "tp=two", "dp=2,dp=2", "xx=2",
                                  "v=2", "dp"])
@pytest.mark.parametrize("devices", [4, 8])
def test_plan_matches_jax(text, devices):
    """Parse, resolve, canonical string and axes against the JAX plan; an
    input one package rejects the other rejects too."""
    def run(mod):
        try:
            plan = mod.ShardingPlan.from_string(text).resolve(devices)
        except ValueError:
            return "ValueError"
        return (plan.to_string(), plan.data_axes, plan.model_axes,
                dataclass_fields(plan))

    assert run(TP) == run(JP)


def dataclass_fields(plan):
    return tuple(getattr(plan, a) for a in TP.PLAN_AXES) + \
        (plan.virtual_stages,)


# ---------------------------------------------------------------------------
# the rings and Ulysses, rank by rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", FUSED_RING_CASES,
                         ids=lambda c: "sp{}-t{}-{}-{}".format(
                             c[0], c[1], "causal" if c[2] else "full", c[3]))
def test_fused_ring_matches_jax(worlds, case):
    """``ring_attention`` (``auto``: the fused ring) output and q/k/v
    gradients on every rank, one ring construction a call."""
    wants = [_dense_reference(*case)]
    if case in AGAINST_JAX_FUSED:
        wants.append(_ring_reference(*case, fused=True))
    outs = worlds[case[0]].result()
    for want in wants:
        _check_shards(outs, ("fused",) + case, want, case[0])
    assert all(out[("fused_launches",) + case] == 1 for out in outs)


@pytest.mark.parametrize("case", PLAIN_RING_CASES,
                         ids=lambda c: "sp{}-t{}-{}-{}".format(
                             c[0], c[1], "causal" if c[2] else "full", c[3]))
def test_plain_ring_matches_jax_jnp_ring(worlds, case):
    """The plain ring against the JAX jnp ring (``fused=False``), outputs
    and gradients; no fused construction."""
    sp = case[0]
    want = _ring_reference(*case, fused=False)
    _check_shards(worlds[sp].result(), ("plain",) + case, want, sp)


@pytest.mark.parametrize("case", ULYSSES_CASES,
                         ids=lambda c: "sp{}-t{}-{}".format(
                             c[0], c[1], "causal" if c[2] else "full"))
def test_ulysses_matches_jax(worlds, case):
    sp, t, causal = case
    q, k, v, g = sp_qkv(t)
    fn = _sharded(sp, lambda a, b, c: j_ulysses(a, b, c, "sp",
                                                causal=causal))
    _check_shards(worlds[sp].result(), ("ulysses",) + case,
                  _jax_vjp(fn, q, k, v, g), sp)


# ---------------------------------------------------------------------------
# the sp TransformerLM and the train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense_lm(flax_params, tokens):
    """Logits, loss and gradients of the flax TransformerLM, dense, on the
    whole sequence."""
    cfg = JT.TransformerConfig(dtype=jnp.float32, **TP_SIZES)
    model = JT.TransformerLM(cfg)
    inputs, labels = jnp.asarray(tokens[:, :-1]), jnp.asarray(tokens[:, 1:])

    def loss_fn(v):
        logits = model.apply(v, inputs)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, labels).mean(), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(flax_params)
    return (np.asarray(logits), float(loss),
            params_from_flax(jax.tree_util.tree_map(np.asarray, grads)))


@pytest.mark.parametrize("case", SP_LM_CASES,
                         ids=lambda c: "sp{}-{}-{}".format(*c))
def test_sp_transformer_matches_dense_flax(worlds, dense_lm, case):
    """Each rank's logits are the dense model's at that rank's global
    positions (zigzag: tokens permuted, positions from
    ``ring_layout_positions``); the token-mean loss and the gradients
    averaged over the sp group are the dense model's."""
    sp, _, layout = case
    logits_want, loss_want, grads_want = dense_lm
    t = logits_want.shape[1]
    order = sp_order(sp, t, layout)
    n = t // sp
    for rank, out in enumerate(worlds[sp].result()):
        logits, loss, grads = out[("lm",) + case]
        np.testing.assert_allclose(
            logits, logits_want[:, order[rank * n:(rank + 1) * n]],
            rtol=3e-4, atol=3e-4, err_msg=f"rank {rank}")
        np.testing.assert_allclose(loss, loss_want, rtol=1e-5)
        for name, ref in grads_want.items():
            ref = ref.numpy()
            np.testing.assert_allclose(grads[name], ref, rtol=1e-3,
                                       atol=1e-4 * float(np.abs(ref).max()),
                                       err_msg=f"rank {rank} {name}")


def test_train_step_sp_matches_dense_twin(worlds):
    """``plan="dp=2,sp=2"`` with the ring model against the dp-only dense
    twin (``plan="dp=4"``, every row twice) on the same global objective:
    losses and parameters after 3 AdamW steps within 2e-4, identical on
    every rank."""
    outs = worlds[4].result()
    losses_sp, params_sp = outs[0]["train_sp"]
    losses_dense, params_dense = outs[0]["train_dense"]
    assert np.isfinite(losses_sp).all() and losses_sp[-1] < losses_sp[0]
    np.testing.assert_allclose(losses_sp, losses_dense, rtol=2e-4, atol=2e-4)
    for name, ref in params_dense.items():
        np.testing.assert_allclose(params_sp[name], ref, rtol=2e-4,
                                   atol=2e-4, err_msg=name)
    for out in outs[1:]:
        assert out["train_sp"][0] == losses_sp
        for name, ref in params_sp.items():
            np.testing.assert_array_equal(out["train_sp"][1][name], ref)
    assert sp_train_rows().shape == (4, 33)


def test_shard_batch_refuses_zigzag_knob(worlds):
    """Under ``HOROVOD_SP_LAYOUT=zigzag`` an sp plan's ``shard_batch``
    raises instead of handing out contiguous chunks that the ring would mask
    by zigzag positions, and names the permutation to apply."""
    for out in worlds[4].result():
        assert "zigzag_sequence_indices" in out["zigzag_error"]


def test_train_step_rejects_model_axes(worlds):
    """tp and pp plans are refused; ep joins sp among the plans the step
    trains (the MoE slice), so ``ep=2,sp=2`` builds and ``ep=2,tp=2`` is
    refused for its tp."""
    errors = worlds[4].result()[0]["plan_errors"]
    assert "model axes" in errors["dp=2,tp=2"]
    assert "model axes ('tp',)" in errors["ep=2,tp=2"]
    assert "ep=2,sp=2" not in errors
    assert "pp>1" in errors["pp=2"]


# ---------------------------------------------------------------------------
# one process: a group of one, the dispatch, the knobs
# ---------------------------------------------------------------------------

def test_sp1_ring_equals_flash_attention():
    """A group of one with causal masking launches the positions variant
    at ``arange``: output and gradients equal ``flash_attention``'s bit for
    bit, which the chip run's sp phase checks at full width."""
    q, k, v, g = (torch.from_numpy(x) for x in sp_qkv(64))
    grads = []
    for fn in (lambda a, b, c: TR.ring_attention(a, b, c, causal=True),
               lambda a, b, c: K.flash_attention(a, b, c, causal=True)):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves)
        out.backward(g)
        grads.append([out.detach()] + [x.grad for x in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_off_contract_shards_take_the_plain_ring():
    """Unequal q/k lengths and an odd zigzag shard are off the fused ring's
    contract: the dispatch takes the plain ring, which holds the JAX jnp
    ring's math for any shard; the fused ring itself raises."""
    q, k, v, _ = (torch.from_numpy(x) for x in sp_qkv(24))
    before = FC.ring_flash_attention.launches
    out = TR.ring_attention(q, k[:, :20], v[:, :20], causal=True)
    want = j_reference(jnp.asarray(q.numpy()),
                                  jnp.asarray(k[:, :20].numpy()),
                                  jnp.asarray(v[:, :20].numpy()),
                                  causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **OUT_TOL)
    with pytest.raises(ValueError, match="even"):
        TR.ring_attention(q[:, :7], k[:, :7], v[:, :7], causal=True,
                          layout="zigzag")
    assert FC.ring_flash_attention.launches == before
    with pytest.raises(ValueError, match="equal"):
        FC.ring_flash_attention(q, k[:, :20], v[:, :20])
    long = torch.zeros(1, 130, 1, 16)
    with pytest.raises(ValueError, match="tiling"):
        FC.ring_flash_attention(long, long, long)


@pytest.mark.parametrize("name,val", [
    (None, None), ("HOROVOD_FUSED_COLLECTIVES", "off"),
    ("HOROVOD_FUSED_COLLECTIVES", "OFF"), ("HOROVOD_FUSED_COLLECTIVES", "on"),
    ("HOROVOD_FUSED_COLLECTIVES", "auto"), ("HOROVOD_SP_FUSED_RING", "off"),
    ("HOROVOD_SP_FUSED_RING", "on"), ("HOROVOD_SP_FUSED_RING", "sometimes")])
def test_fused_mode_resolution(monkeypatch, name, val):
    """The dispatch takes the fused ring by shape alone: neither the
    tensor-parallel rings' ``HOROVOD_FUSED_COLLECTIVES`` nor the JAX
    package's ``HOROVOD_SP_FUSED_RING`` moves a fitting shard off it."""
    for knob in ("HOROVOD_FUSED_COLLECTIVES", "HOROVOD_SP_FUSED_RING"):
        monkeypatch.delenv(knob, raising=False)
    if name is not None:
        monkeypatch.setenv(name, val)
    q, k, v, _ = (torch.from_numpy(x) for x in sp_qkv(32))
    before = FC.ring_flash_attention.launches
    out = TR.ring_attention(q, k, v, causal=True)
    assert FC.ring_flash_attention.launches == before + 1
    assert torch.equal(out, K.flash_attention(q, k, v, causal=True))


def test_layout_knob(monkeypatch):
    """``layout=None`` reads ``HOROVOD_SP_LAYOUT``; an unknown one raises."""
    q = torch.zeros(1, 8, 1, 16)
    monkeypatch.setenv("HOROVOD_SP_LAYOUT", "striped")
    with pytest.raises(ValueError, match="layout"):
        TR.ring_attention(q, q, q)
    monkeypatch.setenv("HOROVOD_SP_LAYOUT", "zigzag")
    assert TR.ring_attention(q, q, q).shape == q.shape


def test_plan_of_one_builds_a_mesh():
    """``plan="sp=1"`` on a world of one: the mesh has every axis at 1, the
    sp group is None (the model's group of one), and the batch is whole."""
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        model = torch.nn.Linear(2, 2)
        step = hvd.DistributedTrainStep(
            lambda m, b: m(b).sum(), torch.optim.SGD(model.parameters(),
                                                     lr=0.1), plan="sp=1")
        assert step.plan.to_string() == "dp=1"
        assert step.mesh.group("sp") is None
        batch = np.arange(12).reshape(2, 6)
        np.testing.assert_array_equal(step.shard_batch(batch).numpy(), batch)
        with pytest.raises(ValueError, match="cover"):
            hvd.DistributedTrainStep(lambda m, b: 0, torch.optim.SGD(
                model.parameters(), lr=0.1), plan="dp=2")
    finally:
        hvd.shutdown()
