"""The structure guards of ``tests/test_hlo_guards.py`` over the port's
record of a step (``DistributedTrainStep.trace``, ``utils/trace``) on gloo
worlds, and the wire bytes by level against JAX's compiled exchange.

Three worlds, one spawn each (``tests/torch_port_workers.py``):

* the exchange, a world of 4 laid out 2 x 2 (``run_trace_exchange``): the
  data-parallel step all-reduces the payload once; the sharded step
  reduce-scatters and never all-reduces more than the 4-byte loss; a
  bucket cap splits the collectives, at each level; two_level runs two
  level scopes and flat one; no HLO001;
* model parallelism, a world of 4 (``run_trace_model_parallel``): an fsdp
  step reduce-scatters, a tp block's forward costs one all-reduce, the sp
  ring permutes and never gathers, and the fused expert exchange issues no
  all-to-all; ``record_collectives`` sees all of them, though
  ``parallel/*`` and ``ops/fused_collectives.py`` call ``torch.distributed``
  themselves;
* the tree, a world of 8 laid out 2 x 4 (``run_trace_tree``): two_level's
  reduce-scatter scopes (2, 4) and flat's (8,), as JAX's compiled step on
  the conftest's 2 x 4 mesh, with the same lint verdict; the sharded
  optimizer over ``TreeLayout((2, 2, 2))``, each level's stride the
  product of the extents inside it.

Wire bytes: the port's ``collective_wire_by_level`` over each recorded
exchange against JAX's over its compiled HLO of the same exchange (the
net's leaves in one bucket, and the loss's scalar psum where the port's
step all-reduces its loss), exact: two_level and its int8 outer hop on the
(2, 2) CPU mesh, the tree and its int8 outermost hop on the (2, 2, 2)
mesh.  Flat: JAX gathers over the two mesh axes one after the other
(``grouped_allgather``), the port over the world at once, so the
all-gather's bytes fall on other levels; the reduce-scatters by level and
the total are held equal.  JAX's unsharded shard_map step (its grouped
all-reduce, whose own guard fails on the CPU backend) is not used as an
oracle."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.analysis import cost_model as JCM
from horovod_tpu.analysis import hlo_lint as JL
from horovod_tpu.ops import collectives as JC
from horovod_tpu.runtime.topology import GLOBAL_AXES
from horovod_tpu.utils import hlo as H
from horovod_tpu_torch.analysis import cost_model as CM
from horovod_tpu_torch.utils import trace as T

from torch_port_workers import TREE_SHAPE, spawn_world

WORLD_TIMEOUT_S = 300
TREE_AXES = ("pod", "slice", "chip")
#: the guard net's parameter shapes in the port's order
#: (``torch_port_workers.hlo_guard_net``)
NET_SHAPES = [(256, 64), (256,), (256, 256), (256,), (10, 256), (10,)]
NET_BYTES = 4 * sum(int(np.prod(s)) for s in NET_SHAPES)


def _ops(rec) -> list:
    return [T.CollectiveOp.from_json(o) for o in rec["ops"]]


@pytest.fixture(scope="module")
def exchange():
    return spawn_world("run_trace_exchange", world=4, layout=(2, 2),
                       timeout=WORLD_TIMEOUT_S)


@pytest.fixture(scope="module")
def model_parallel():
    return spawn_world("run_trace_model_parallel", world=4,
                       timeout=WORLD_TIMEOUT_S)


@pytest.fixture(scope="module")
def tree():
    return spawn_world("run_trace_tree", world=8, layout=(2, 4),
                       timeout=WORLD_TIMEOUT_S)


# -- JAX's side ----------------------------------------------------------------

def _jax_exchange_ops(mesh, axes, fn, scalar_loss):
    """The collectives of ``fn(leaves)`` compiled under shard_map over
    ``mesh`` (and a scalar psum over every axis, the loss's, when asked)."""
    leaves = [jnp.zeros(s, jnp.float32) for s in NET_SHAPES]

    def body(*xs):
        out = fn(list(xs))
        if scalar_loss:
            out = (out, jax.lax.psum(jnp.float32(1.0), axes))
        return out

    text = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=tuple(P() for _ in leaves),
        out_specs=P(), check_vma=False)).lower(*leaves).compile().as_text()
    return H.collective_ops(text)


@pytest.fixture(scope="module")
def jax_wire():
    """JAX's wire bytes by level of each exchange the port's worlds run,
    one bucket (``bucket_bytes=None``)."""
    mesh22 = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), GLOBAL_AXES)

    def flat(xs):
        shards, spec = JC.grouped_reducescatter(xs)
        return JC.grouped_allgather(shards, spec)

    def two(q):
        def run(xs):
            shards, spec = JC.hierarchical_reducescatter(
                xs, quantized_bits=q)[:2]
            return JC.hierarchical_allgather(shards, spec)
        return run

    out = {}
    for name, fn in (("sharded_flat", flat), ("two_level", two(None)),
                     ("two_level_int8", two(8))):
        ops = _jax_exchange_ops(mesh22, GLOBAL_AXES, fn, True)
        out[name] = (ops, JCM.collective_wire_by_level(ops, n_dcn=2,
                                                       n_ici=2))
    mesh222 = Mesh(np.asarray(jax.devices()[:8]).reshape(TREE_SHAPE),
                   TREE_AXES)

    def tree(pod):
        levels = (JC.ExchangeLevel("chip"), JC.ExchangeLevel("slice"),
                  JC.ExchangeLevel("pod", pod))

        def run(xs):
            shards, spec = JC.tree_reducescatter(xs, levels)[:2]
            return JC.tree_allgather(shards, spec, levels)
        return run

    topo = [(n, 2, None) for n in reversed(TREE_AXES)]
    for name, pod in (("tree", None), ("tree_int8", 8)):
        ops = _jax_exchange_ops(mesh222, TREE_AXES, tree(pod), False)
        out[name] = (ops, JCM.collective_wire_by_level(ops, topology=topo))
    return out


class _Net(nn.Module):
    @nn.compact
    def __call__(self, x):
        x = nn.relu(nn.Dense(256)(x))
        x = nn.Dense(256)(x)
        return nn.Dense(10)(x)


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's compiled sharded step on the conftest's 2 x 4 mesh, two-level
    and flat: its collectives and its lint's rules."""
    import horovod_tpu as jhvd

    jhvd.init()
    try:
        model = _Net()
        init = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64)))
        bdata = {"x": jnp.zeros((16, 64), jnp.float32),
                 "y": jnp.zeros((16,), jnp.int32)}

        def loss_fn(params, batch):
            return optax.softmax_cross_entropy_with_integer_labels(
                model.apply(params, batch["x"]), batch["y"]).mean()

        out = {}
        for h in ("two_level", "flat"):
            step = jhvd.DistributedTrainStep(
                loss_fn, optax.sgd(0.1), mode="shard_map",
                shard_optimizer_states=True, hierarchy=h)
            params, opt = step.init(init)
            text = step.compiled_text(params, opt, step.shard_batch(bdata))
            out[h] = (H.collective_ops(text), sorted(
                f.rule for f in JL.lint_hlo_text(text, expect_hierarchy=h,
                                                 grad_bytes=NET_BYTES)))
        return out
    finally:
        jhvd.shutdown()


# -- the exchange ---------------------------------------------------------------

class TestExchange:
    def test_payload_all_reduced_once(self, exchange):
        """JAX's test_pjit_step_allreduces_payload_exactly_once: every
        gradient and the scalar loss ride world-sized all-reduces whose
        bytes are the payload + 4, nothing exchanged twice."""
        for rec in exchange:
            ops = _ops(rec["dp"])
            assert ops and all(o.kind == "all-reduce" for o in ops)
            assert all(o.group_size == 4 for o in ops)
            assert sum(o.bytes for o in ops) == rec["dp"]["grad_bytes"] + 4
            assert len(ops) <= len(NET_SHAPES) + 1
            assert rec["dp"]["grad_bytes"] == NET_BYTES

    @pytest.mark.parametrize("case", ["sharded_flat", "two_level",
                                      "two_level_int8"])
    def test_sharded_step_reduce_scatters_not_allreduces(self, exchange,
                                                         case):
        """JAX's test_sharded_step_reduce_scatters_not_allreduces and
        test_no_gradient_sized_allreduce: reduce-scatters and all-gathers,
        the only all-reduces 4 bytes (the loss, the int8 wire's scale), the
        innermost shards covering the payload; no HLO001."""
        for rec in exchange:
            ops = _ops(rec[case])
            kinds = T.count_by_kind(ops)
            assert kinds["reduce-scatter"] >= 1 and kinds["all-gather"] >= 1
            assert all(o.bytes == 4 for o in ops if o.kind == "all-reduce")
            inner = [o for o in ops if o.kind == "reduce-scatter" and
                     T.group_stride(o.ranks) == 1]
            assert sum(o.bytes * o.group_size for o in inner) >= NET_BYTES
            assert "HLO001" not in rec[case]["rules"]
            assert rec[case]["unwaited"] == 0

    def test_bucketed_exchange_splits_collectives(self, exchange):
        """A cap below the largest leaf: several reduce-scatters flat, and
        several at each level two-level (JAX's
        test_bucketed_two_level_splits_both_scopes)."""
        for rec in exchange:
            assert T.count_by_kind(
                _ops(rec["sharded_bucketed"]))["reduce-scatter"] >= 2
            per_level: dict = {}
            for o in _ops(rec["two_level_bucketed"]):
                if o.kind == "reduce-scatter":
                    key = (o.group_size, T.group_stride(o.ranks))
                    per_level[key] = per_level.get(key, 0) + 1
            assert set(per_level) == {(2, 1), (2, 2)}
            assert min(per_level.values()) >= 2

    @pytest.mark.parametrize("case,want", [
        ("two_level", ((2, 1), (2, 2))), ("two_level_int8", ((2, 1), (2, 2))),
        ("sharded_flat", ((4, 1),)), ("sharded_bucketed", ((4, 1),))])
    def test_level_scopes(self, exchange, case, want):
        """Two level scopes two-level, one flat; at 2 x 2 the sizes alias
        the levels (JAX's scopes read (2,)), the strides do not; the lint
        finds no HLO004."""
        for rec in exchange:
            ops = _ops(rec[case])
            assert T.level_scopes_by_kind(ops)["reduce-scatter"] == want
            assert "HLO004" not in rec[case]["rules"]
        if case.startswith("two_level"):
            assert T.scopes_by_kind(ops)["reduce-scatter"] == (2,)

    @pytest.mark.parametrize("case", ["two_level", "two_level_int8"])
    def test_wire_by_level_is_jaxs(self, exchange, jax_wire, case):
        want = jax_wire[case][1]
        for rec in exchange:
            assert CM.collective_wire_by_level(
                _ops(rec[case]), n_dcn=2, n_ici=2) == want
        if case == "two_level_int8":
            assert want["dcn"] > 0 and {"int32"} & set().union(
                *(o.dtypes for o in _ops(exchange[0][case])))

    def test_flat_wire_is_jaxs(self, exchange, jax_wire):
        jax_ops, want = jax_wire["sharded_flat"]
        jax_rs = JCM.collective_wire_by_level(
            [o for o in jax_ops if o.kind == "reduce-scatter"], n_dcn=2,
            n_ici=2)
        for rec in exchange:
            ops = _ops(rec["sharded_flat"])
            got = CM.collective_wire_by_level(ops, n_dcn=2, n_ici=2)
            assert sum(got.values()) == sum(want.values())
            assert CM.collective_wire_by_level(
                [o for o in ops if o.kind == "reduce-scatter"], n_dcn=2,
                n_ici=2) == jax_rs


# -- model parallelism ------------------------------------------------------------

class TestModelParallel:
    def test_fsdp_step_shards_the_reduction(self, model_parallel):
        """JAX's test_fsdp_step_shards_the_reduction: the parameters are
        gathered, the gradients reduce-scattered, and no world all-reduce
        carries the full payload."""
        for rec in model_parallel:
            fsdp = rec["fsdp"]
            ops = _ops(fsdp)
            kinds = T.count_by_kind(ops)
            assert kinds["reduce-scatter"] >= 1 and kinds["all-gather"] >= 1
            assert all(o.bytes < fsdp["grad_bytes"] for o in ops
                       if o.kind == "all-reduce" and o.group_size == 4)
            assert fsdp["rules"] == []

    def test_tp_block_costs_exactly_one_psum(self, model_parallel):
        """JAX's test_tp_block_costs_exactly_one_psum: the column → row
        block's forward runs one all-reduce, of its output, and no
        all-gather."""
        for rec in model_parallel:
            ops = _ops(rec["tp"])
            assert T.count_by_kind(ops) == {"all-reduce": 1}
            assert ops[0].bytes == rec["tp"]["out_bytes"] == 16 * 32 * 4

    def test_ring_attention_permutes_never_gathers(self, model_parallel):
        """JAX's test_ring_attention_permutes_never_gathers: K/V move by
        collective permutes only, 2·(sp−1) of them forward; the backward
        too; the sp step of the ring LM lints clean (HLO007)."""
        for rec in model_parallel:
            fwd = T.count_by_kind(_ops(rec["sp_ring"]))
            assert fwd == {"collective-permute": 2 * (4 - 1)}
            bwd = T.count_by_kind([T.CollectiveOp.from_json(o)
                                   for o in rec["sp_ring"]["bwd"]])
            assert set(bwd) == {"collective-permute"}
            step = rec["sp_step"]
            assert step["sp"] == 4 and step["rules"] == []
            kinds = T.count_by_kind(_ops(step))
            assert kinds.get("all-gather", 0) == 0
            assert kinds["collective-permute"] >= 2 * (4 - 1)

    def test_fused_expert_exchange_has_no_alltoall(self, model_parallel):
        """JAX's test_fused_program_has_zero_alltoalls and its unfused
        control: the fused ring permutes, the unfused exchange runs its
        two all-to-alls."""
        for rec in model_parallel:
            fused = T.count_by_kind(_ops(rec["ep_fused"]))
            assert fused.get("all-to-all", 0) == 0
            assert fused["collective-permute"] >= 4 - 1
            assert T.count_by_kind(_ops(rec["ep_unfused"])) == \
                {"all-to-all": 2}


# -- the world of 8 -------------------------------------------------------------

class TestTree:
    @pytest.mark.parametrize("case", ["two_level", "flat"])
    def test_scopes_and_lint_are_jaxs(self, tree, jax_steps, case):
        """JAX's test_two_distinct_reduce_scatter_scopes and
        test_flat_keeps_single_scope on the same 2 x 4 layout: the same
        reduce-scatter scopes by size, the same all-gather scopes
        two-level (flat, JAX gathers over each mesh axis in turn and the
        port over the world), and the same lint verdict (HLO003 on the
        fp32 two-level exchange, in both packages)."""
        jax_ops, jax_rules = jax_steps[case]
        want = H.scopes_by_kind(jax_ops)
        for rec in tree:
            got = T.scopes_by_kind(_ops(rec[case]))
            assert got["reduce-scatter"] == want["reduce-scatter"]
            assert set(got["all-gather"]) == ({2, 4} if case == "two_level"
                                              else {8})
            assert set(want["all-gather"]) == {2, 4}
            assert sorted(rec[case]["rules"]) == jax_rules
        assert want["reduce-scatter"] == \
            ((2, 4) if case == "two_level" else (8,))

    @pytest.mark.parametrize("case", ["tree", "tree_int8"])
    def test_tree_levels_and_wire_are_jaxs(self, tree, jax_wire, case):
        """Over ``TreeLayout((2, 2, 2))`` each level's reduce-scatters step
        by the product of the extents inside it (1, 2, 4), and the wire
        bytes by level are JAX's."""
        topo = [(n, 2, None) for n in reversed(TREE_AXES)]
        for rec in tree:
            ops = _ops(rec[case])
            assert T.level_scopes_by_kind(ops)["reduce-scatter"] == \
                ((2, 1), (2, 2), (2, 4))
            assert CM.collective_wire_by_level(ops, topology=topo) == \
                jax_wire[case][1]
            assert rec[case]["unwaited"] == 0
