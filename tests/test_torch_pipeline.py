"""The port's pipeline schedules against the JAX package's: ``gpipe`` and
``interleaved_1f1b`` on gloo worlds of 2 and 4 (``run_pipeline`` in
``tests/torch_port_workers.py``, each world spawned once) against JAX's
under ``shard_map`` on as many of the 8 virtual CPU devices, on the same
numpy inputs, with ``tests/test_pipeline_expert.py``'s cases.

Tolerances: outputs and stage gradients at rtol 2e-5 / atol 2e-5 in fp32
(JAX's own test of its schedule against the sequential stages); the
narrow ``TransformerLM`` through both packages' pipelines at pp = 2 to
1e-5 on the loss and 1e-4 normwise on the gradients.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from horovod_tpu.models import transformer as JT
from horovod_tpu.parallel import make_parallel_mesh as jax_make_mesh
from horovod_tpu.parallel import pipeline as JPL
from horovod_tpu_torch.models import stages as TS
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.parallel import pipeline as TPL

from torch_port_workers import (
    PIPE_CASES,
    PIPE_LM,
    PIPE_LM_CASES,
    pipe_error_cases,
    pipe_inputs,
    pipe_lm_tokens,
    spawn_world,
)

WORLDS = (2, 4)
TOL = 2e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray,
                                  flax.core.meta.unbox(jax.device_get(tree)))


@pytest.fixture(scope="module")
def lm_params():
    cfg = JT.TransformerConfig(dtype=jnp.float32, **PIPE_LM)
    return _np(JT.TransformerLM(cfg).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 16), jnp.int32)))["params"]


@pytest.fixture(scope="module")
def worlds(lm_params):
    lm_sd = {k: v.numpy() for k, v in params_from_flax(lm_params).items()}
    return {w: spawn_world("run_pipeline", world=w,
                           args=(lm_sd if w == 2 else None,), timeout=240)
            for w in WORLDS}


def _mesh(s):
    return jax_make_mesh(pp=s, dp=1, devices=jax.devices("cpu")[:s])


def _stage(w, h):
    return jnp.tanh(h @ w)


def _jax_pipe(ws, x, m, v, s, schedule="interleaved"):
    """JAX's schedule: (output, gradient of pmean(sum(y**2)) by the
    ``v * s`` stage kernels)."""
    stacked = ws.reshape((v, s) + ws.shape[1:])

    def loss(stacked, x):
        def f(w_local, x_local):
            if schedule == "gpipe":
                y = JPL.gpipe(_stage, w_local[0, 0], x_local,
                              num_microbatches=m)
            else:
                y = JPL.interleaved_1f1b(_stage, w_local[:, 0], x_local,
                                         num_microbatches=m,
                                         virtual_stages=v)
            return lax.pmean(jnp.sum(y ** 2), "pp")[None], y

        out, y = jax.shard_map(
            f, mesh=_mesh(s), in_specs=(P(None, "pp"), P()),
            out_specs=(P(), P()), check_vma=False)(stacked, x)
        return out[0], y

    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(stacked), jnp.asarray(x))
    return np.asarray(y), np.asarray(g).reshape(ws.shape)


def _sequential(ws, x):
    """Outputs and gradients of the stages run one after another."""
    w = torch.tensor(ws, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    h = xt
    for s in range(ws.shape[0]):
        h = torch.tanh(h @ w[s])
    h.pow(2).sum().backward()
    return h.detach().numpy(), w.grad.numpy(), xt.grad.numpy()


def _rank_grads(outs, world, v):
    """The ranks' chunk gradients in global stage order ``j*s + r``."""
    g = np.zeros((v * world,) + outs[0]["g"].shape[1:], np.float32)
    for r, out in enumerate(outs):
        for j in range(v):
            g[j * world + r] = out["g"][j]
    return g


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("m,v", PIPE_CASES)
def test_matches_sequential(worlds, world, m, v):
    """Every rank's fanned-out output, the stage gradients and the input's
    gradient (rank 0's, where it is injected, summed over the ranks) are
    the sequential stages'."""
    outs = [o["cases"][(m, v)] for o in worlds[world]]
    y, g, gx = _sequential(*pipe_inputs(world, v))
    for out in outs:
        np.testing.assert_allclose(out["y"], y, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_rank_grads(outs, world, v), g, rtol=TOL,
                               atol=TOL)
    got_gx = sum(o["gx"] for o in outs if o["gx"] is not None)
    np.testing.assert_allclose(got_gx, gx, rtol=TOL, atol=TOL)
    assert outs[0]["gx"] is not None


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("m,v", PIPE_CASES)
def test_matches_jax(worlds, world, m, v):
    """The same outputs and stage gradients as JAX's schedule under
    shard_map on a pp mesh of ``world`` CPU devices."""
    ws, x = pipe_inputs(world, v)
    y, g = _jax_pipe(ws, x, m, v, world)
    outs = [o["cases"][(m, v)] for o in worlds[world]]
    for out in outs:
        np.testing.assert_allclose(out["y"], y, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_rank_grads(outs, world, v), g, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_agree_on_the_fan_out(worlds, world):
    for m, v in PIPE_CASES:
        ys = [o["cases"][(m, v)]["y"] for o in worlds[world]]
        for y in ys[1:]:
            np.testing.assert_array_equal(y, ys[0])


@pytest.mark.parametrize("world", WORLDS)
def test_v1_is_gpipe(worlds, world):
    """``virtual_stages=1`` runs GPipe's schedule: the same numbers, bit
    for bit, and JAX's gpipe's."""
    for out in worlds[world]:
        one, gp = out["cases"][(8, 1)], out["gpipe"]
        np.testing.assert_array_equal(one["y"], gp["y"])
        np.testing.assert_array_equal(one["g"], gp["g"])
    ws, x = pipe_inputs(world, 1)
    y, g = _jax_pipe(ws, x, 8, 1, world, "gpipe")
    np.testing.assert_allclose(worlds[world][0]["gpipe"]["y"], y, rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(
        _rank_grads([o["gpipe"] for o in worlds[world]], world, 1), g,
        rtol=TOL, atol=TOL)


def _jax_error(world, rows, m, v):
    x = jnp.zeros((rows, 8))

    def f(x_local):
        if v == 1:
            return JPL.gpipe(lambda w, h: h, None, x_local, m)
        return JPL.interleaved_1f1b(lambda w, h: h, None, x_local, m, v)

    with pytest.raises(ValueError) as e:
        jax.shard_map(f, mesh=_mesh(world), in_specs=P(), out_specs=P(),
                      check_vma=False)(x)
    return str(e.value)


@pytest.mark.parametrize("world", WORLDS)
def test_divisibility_errors(worlds, world):
    """The schedules refuse what JAX's refuse, in JAX's words, on every
    rank."""
    for name, rows, m, v in pipe_error_cases(world):
        want = _jax_error(world, rows, m, v)
        for out in worlds[world]:
            assert out["errors"][name] == want, name


def test_batch_error_on_a_group_of_one():
    with pytest.raises(ValueError, match="not divisible"):
        TPL.gpipe(lambda w, h: h, None, torch.zeros(6, 2), 4)


def test_tick_and_bubble_algebra():
    """JAX's numbers: 11 and 19 ticks at s = 4, m = 8, v = 1 and 2; the
    bubble shrinks in v; and every (s, m, v) of a grid agrees."""
    assert TPL.pipeline_ticks(4, 8) == 11
    assert TPL.pipeline_ticks(4, 8, virtual_stages=2) == 19
    assert TPL.bubble_fraction(4, 8) == pytest.approx(3 / 11)
    assert TPL.bubble_fraction(4, 8, virtual_stages=2) == \
        pytest.approx(3 / 19)
    bubbles = [TPL.bubble_fraction(4, 8, virtual_stages=v)
               for v in (1, 2, 4, 8)]
    assert all(a > b for a, b in zip(bubbles, bubbles[1:]))
    for s in (1, 2, 4, 8):
        for m in (1, 4, 6, 8):
            for v in (1, 2, 4):
                assert TPL.pipeline_ticks(s, m, v) == \
                    JPL.pipeline_ticks(s, m, v)
                assert TPL.bubble_fraction(s, m, v) == \
                    JPL.bubble_fraction(s, m, v)


def test_group_of_one_runs_every_chunk_in_order():
    """At a group of one the schedule is the sequential chunks, with no
    collective: interleaved at v = 4 and gpipe agree bit for bit."""
    ws, x = pipe_inputs(1, 4)
    w, xt = torch.tensor(ws), torch.tensor(x)
    seq = xt
    for s in range(4):
        seq = torch.tanh(seq @ w[s])

    def chunk(ws_, h):
        for k in range(ws_.shape[0]):
            h = torch.tanh(h @ ws_[k])
        return h

    inter = TPL.interleaved_1f1b(lambda wj, h: torch.tanh(h @ wj), w, xt, 4,
                                 4)
    gp = TPL.gpipe(chunk, w, xt, 4)
    torch.testing.assert_close(inter, seq, rtol=0, atol=0)
    torch.testing.assert_close(gp, seq, rtol=0, atol=0)


def test_stage_chunks_cut_global_stages():
    blocks = [torch.nn.Linear(1, 1) for _ in range(8)]
    chunks = TS.stage_chunks(blocks, stages=2, rank=1, virtual_stages=2)
    # rank 1's chunks are global stages 1 and 3 of 4, two blocks each
    assert [list(c) for c in chunks] == [blocks[2:4], blocks[6:8]]
    with pytest.raises(ValueError, match="do not cut"):
        TS.stage_chunks(blocks, stages=3, rank=0)


def _jax_lm_pipe(params, tokens, m, v, s):
    """JAX's pipeline over the flax LM's blocks at pp = ``s``: the loss
    and its gradients as a flax parameter tree."""
    cfg = JT.TransformerConfig(dtype=jnp.float32, **PIPE_LM)
    layers = cfg.num_layers
    per = layers // (v * s)
    block, norm = JT.Block(cfg), JT.RMSNorm()

    def chunk(g):
        return {f"b{k}": params[f"layer_{g * per + k}"] for k in range(per)}

    stacked = jax.tree_util.tree_map(
        lambda *ls: jnp.stack(ls).reshape((v, s) + ls[0].shape),
        *[chunk(g) for g in range(v * s)])
    outside = {"embed": params["embed"], "ln_f": params["ln_f"]}

    def loss(stacked, outside, tokens):
        def f(st, out, tok):
            emb = out["embed"]["embedding"]
            x = jnp.take(emb, tok[:, :-1], axis=0)
            pos = jnp.arange(x.shape[1])

            def stage_fn(cp, h):
                for k in range(per):
                    h = block.apply({"params": cp[f"b{k}"]}, h, pos)
                return h

            local = jax.tree_util.tree_map(lambda p: p[:, 0], st)
            if v == 1:
                y = JPL.gpipe(stage_fn, jax.tree_util.tree_map(
                    lambda p: p[0], local), x, num_microbatches=m)
            else:
                y = JPL.interleaved_1f1b(stage_fn, local, x,
                                         num_microbatches=m,
                                         virtual_stages=v)
            y = norm.apply({"params": out["ln_f"]}, y)
            logits = y.astype(jnp.float32) @ emb.T
            ce = optax.softmax_cross_entropy_with_integer_labels(
                logits, tok[:, 1:]).mean()
            return lax.pmean(ce, "pp")[None]

        spec = jax.tree_util.tree_map(lambda _: P(None, "pp"), stacked)
        return jax.shard_map(
            f, mesh=_mesh(s), in_specs=(spec, P(), P()), out_specs=P(),
            check_vma=False)(stacked, outside, tokens)[0]

    val, (g_st, g_out) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        stacked, outside, jnp.asarray(tokens))
    grads = dict(_np(g_out))
    flat = jax.tree_util.tree_map(
        lambda p: np.asarray(p).reshape((v * s,) + p.shape[2:]), g_st)
    for g in range(v * s):
        for k in range(per):
            grads[f"layer_{g * per + k}"] = jax.tree_util.tree_map(
                lambda p: p[g], flat[f"b{k}"])
    return float(val), params_from_flax(grads)


def _normwise(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.mark.parametrize("m,v", PIPE_LM_CASES)
def test_lm_through_both_pipelines(worlds, lm_params, m, v):
    """The narrow TransformerLM's 4 blocks through both packages'
    pipelines at pp = 2 (gpipe, two blocks a stage; interleaved at v = 2,
    one block a chunk), the weights carried across by ``params_from_flax``
    and cut by ``stage_chunks``: the losses within 1e-5, each rank's
    blocks' gradients and the summed embedding and final-norm gradients
    within 1e-4 normwise."""
    loss, grads = _jax_lm_pipe(lm_params, pipe_lm_tokens(), m, v, 2)
    seen = set()
    for out in worlds[2]:
        got = out["lm"][(m, v)]
        assert abs(got["loss"] - loss) <= 1e-5 * abs(loss)
        for name, g in got["grads"].items():
            assert _normwise(g, grads[name].numpy()) < 1e-4, name
            seen.add(name)
    assert seen == set(grads)
