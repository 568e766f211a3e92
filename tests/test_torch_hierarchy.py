"""The port's hierarchical and tree sharded exchange against the JAX
package: topology resolution and the level-codec grammar; the two-level
exchange over the world's ``(cross, local)`` layout (round trip, each
rank's shard and the block it owns, Average and buckets, the codec on the
cross hop, on both hops with error feedback and by level name, Adasum on
the cross hop); the three-level tree from caller-made groups; the sharded
optimizer and step trained two_level, tree, auto and flat; the sharded
checkpoint saved under the two-level ownership; and the sharded optimizer
over ``TreeLayout((2, 2, 2), ("pod", "slice", "chip"))`` on a world of 8
(tree, auto, flat, level codecs on ``pod`` and ``chip``, error feedback,
a checkpoint round trip) against JAX's ``sharded_distributed_update`` on
the same mesh (``run_tree_layout``).

Gloo worlds laid out as 2 x 4 and 3 x 2 nodes (``HIER_LAYOUTS``) are
spawned once for the module, two at a time (``run_hierarchy`` in
``tests/torch_port_workers.py``); the world of 8 also runs the 2 x 2 x 2
tree from its own ``new_group``s.  The JAX references run under
``shard_map`` on the conftest's CPU devices: the ``(dcn, ici)`` mesh of
2 x 4 or 3 x 2 (the port's ``cross`` and ``local``) and the ``("pod",
"slice", "chip")`` mesh of ``TestTreeExchange``.  Device ``r`` of a mesh
stands for rank ``r``.

Tolerances: the round trips rtol 1e-6 (the JAX package's
test_hierarchy_smoke.py), atol 1e-6 where the seeded normal inputs cancel
near 0; Adasum rtol 1e-5 (atol 1e-6 for the entries
near 0); a codec case within one codec step of its largest scale (the
inner hop sums in another order, which can move a code by one); the
trainings as ``assert_adam_close`` states against JAX, and two_level
against flat at tests/test_hierarchy_smoke.py's rtol 1e-5, atol 1e-6."""

import os
from concurrent.futures import ThreadPoolExecutor

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.models import transformer as JT
from horovod_tpu.ops import collectives as JC
from horovod_tpu.runtime import topology as JTopo
from horovod_tpu.runtime.topology import GLOBAL_AXES
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.runtime import topology as TTopo

from torch_port_workers import (
    HIER_LAYOUTS,
    HIER_MLP_3X2,
    HIER_MLP_CASES,
    TREE_NAMES,
    TREE_OPT_CASES,
    TREE_OPT_STEPS,
    TREE_SHAPE,
    WIRES,
    assert_adam_close,
    hier_leaves,
    mlp_batch,
    mlp_params,
    spawn_world,
    tree_opt_grads,
)

from test_torch_train_step import SIZES, _tokens

WORLD_TIMEOUT_S = 300
RT_RTOL, RT_ATOL = 1e-6, 1e-6
ADASUM_RTOL, ADASUM_ATOL = 1e-5, 1e-6
#: one codec step, as a share of the largest magnitude it encodes: int8's
#: 1/127; e4m3's widest step below 448 is 32, 1/14 of it
CODEC_STEP = {"int8": 1 / 127, "fp8_e4m3": 1 / 14}
#: JAX's level names for the port's
JAX_NAMES = {"local": "ici", "cross": "dcn"}
TREE_AXES = ("pod", "slice", "chip")


@pytest.fixture(scope="module")
def lm_params0():
    """The flax TransformerLM's initial parameters at
    tests/test_torch_train_step.py's sizes (seed 1)."""
    model = JT.TransformerLM(JT.TransformerConfig(
        dtype=jnp.float32, attention_impl="dense", **SIZES))
    variables = model.init(jax.random.PRNGKey(1),
                           jnp.zeros((1, 32), jnp.int32))
    return jax.tree_util.tree_map(np.asarray,
                                  flax.core.meta.unbox(variables))


@pytest.fixture(scope="module")
def worlds(lm_params0):
    """Each layout's world, two at a time; the world of 8 also trains the
    LM.  A failed world is kept as its exception and raised by the tests
    that read it."""
    lm = ({k: v.numpy() for k, v in params_from_flax(lm_params0).items()},
          SIZES, _tokens())

    def run(layout):
        return spawn_world("run_hierarchy", world=layout[0] * layout[1],
                           args=(lm if layout == (2, 4) else None,),
                           layout=layout, timeout=WORLD_TIMEOUT_S)

    with ThreadPoolExecutor(max_workers=2) as pool:
        futs = {layout: pool.submit(run, layout) for layout in HIER_LAYOUTS}
        out = {}
        for layout, f in futs.items():
            try:
                out[layout] = f.result()
            except Exception as e:  # noqa: BLE001 - raised by its tests
                out[layout] = e
    return out


def _world(worlds, layout):
    w = worlds[layout]
    if isinstance(w, Exception):
        raise w
    return w


def _mesh(layout):
    cross, local = layout
    return Mesh(np.asarray(jax.devices()[:cross * local]).reshape(
        cross, local), GLOBAL_AXES), GLOBAL_AXES


def _tree_mesh():
    return Mesh(np.asarray(jax.devices()[:8]).reshape(2, 2, 2),
                TREE_AXES), TREE_AXES


def jax_ranks(mesh_axes, fn, *stacked):
    """``fn(*row)`` on every device of the mesh, each given its row of
    every stacked input; every output stacked over ranks, as numpy."""
    mesh, axes = mesh_axes
    spec = P(axes)

    def body(*xs):
        out = fn(*[x[0] for x in xs])
        return jax.tree_util.tree_map(lambda y: y[None], out)

    res = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=tuple(spec for _ in stacked),
        out_specs=spec, check_vma=False))(*[jnp.asarray(a) for a in stacked])
    return jax.tree_util.tree_map(lambda y: np.asarray(y, np.float32), res)


class _wire:
    """JAX's codec for the duration of a trace: its runtime is not
    initialized here, so it reads ``HOROVOD_EXCHANGE_WIRE_DTYPE``."""

    def __init__(self, wire):
        self.wire = wire

    def __enter__(self):
        self.old = os.environ.get("HOROVOD_EXCHANGE_WIRE_DTYPE")
        os.environ["HOROVOD_EXCHANGE_WIRE_DTYPE"] = self.wire

    def __exit__(self, *exc):
        if self.old is None:
            del os.environ["HOROVOD_EXCHANGE_WIRE_DTYPE"]
        else:
            os.environ["HOROVOD_EXCHANGE_WIRE_DTYPE"] = self.old


def _rt(shards_spec, levels=None):
    """(shards, gathered leaves) of a JAX reduce-scatter's result."""
    shards, spec = shards_spec[0], shards_spec[1]
    back = JC.hierarchical_allgather(shards, spec) if levels is None \
        else JC.tree_allgather(shards, spec, levels)
    if len(shards_spec) == 3:
        return shards, back, shards_spec[2]
    return shards, back


@pytest.fixture(scope="module")
def jax_exchange():
    """JAX's side of every exchange case of :func:`run_hierarchy`, by
    layout, from the same :func:`hier_leaves` inputs."""
    out = {}
    for layout in HIER_LAYOUTS:
        world = layout[0] * layout[1]
        mesh = _mesh(layout)
        inp = hier_leaves(world)
        abc = (inp["a"], inp["b"], inp["c"])
        padded = JC.make_fusion_spec([jnp.zeros(32)], world).groups[0].padded
        res = {}

        def leaves_case(**kw):
            return jax_ranks(mesh, lambda a, b, c: _rt(
                JC.hierarchical_reducescatter([a, b, c], **kw)), *abc)

        res[("two", "sum")] = leaves_case()
        res[("flat", "sum")] = jax_ranks(mesh, lambda a, b, c: (lambda r: (
            r[0], JC.grouped_allgather(*r)))(JC.grouped_reducescatter(
                [a, b, c])), *abc)
        res[("two", "avg_b64")] = leaves_case(op=JC.Average,
                                              bucket_bytes=64)
        res["index"] = jax_ranks(mesh, lambda a: JC.axis_index(
            JC.exchange_index_axes()), inp["a"])

        def own(a, b, c):
            spec = JC.make_fusion_spec([a, b, c], world, 64)
            return JC.local_fusion_shards([a, b, c], spec,
                                          axis=JC.exchange_index_axes())

        res["own"] = jax_ranks(mesh, own, *[np.stack([x[0]] * world)
                                            for x in abc])
        for wire in WIRES:
            with _wire(wire):
                res[("q", wire)] = jax_ranks(mesh, lambda x: _rt(
                    JC.hierarchical_reducescatter(
                        [x], op=JC.Average, quantized_bits=8)),
                    inp["codec"])
                res[("qi", wire)] = jax_ranks(mesh, lambda a, b, c, r: _rt(
                    JC.hierarchical_reducescatter(
                        [a, b, c], quantized_bits=8, quantize_inner=True,
                        inner_residuals={"b0/float32": r})),
                    *abc, inp["resid"][:, :padded])
                res[("adasum_q", wire)] = leaves_case(quantized_bits=8,
                                                      reduction="adasum")
        levels = JC.exchange_levels_from_topology(JTopo.resolve_topology(
            "two_level", layout, level_codecs={"ici": 8}))
        res["codecs_local"] = jax_ranks(mesh, lambda a, b, c: _rt(
            JC.tree_reducescatter([a, b, c], levels, op=JC.Average),
            levels), *abc)
        for op in ("Sum", "Average"):
            res[("adasum", op)] = leaves_case(
                op=getattr(JC, op), reduction="adasum", prescale_factor=0.5,
                postscale_factor=2.0)
        out[layout] = res
    tree = _tree_mesh()
    inp = hier_leaves(8)

    def levels3(pod=None, chip=None):
        return (JC.ExchangeLevel("chip", chip), JC.ExchangeLevel("slice"),
                JC.ExchangeLevel("pod", pod))

    def tree_case(levels, *xs, **kw):
        return _rt(JC.tree_reducescatter(list(xs), levels, **kw), levels)

    full = np.stack([np.full(8, 500.0, np.float32)] * 8), \
        np.stack([np.full(8, 1e-3, np.float32)] * 8)
    out["tree3"] = {
        "index": jax_ranks(tree, lambda a: JC.axis_index(
            JC.tree_index_axes(levels3())), inp["a"]),
        "sum": jax_ranks(tree, lambda a, b, c: tree_case(
            levels3(), a, b, c), inp["a"], inp["b"], inp["c"]),
        "pod_int8": jax_ranks(tree, lambda x: tree_case(
            levels3(pod=8), x, op=JC.Average), inp["codec"]),
        "chip_int8": jax_ranks(tree, lambda x, y: tree_case(
            levels3(chip=8), x, y, op=JC.Average), *full),
        "adasum": jax_ranks(tree, lambda a, b, c: tree_case(
            levels3(), a, b, c, op=JC.Average, reduction="adasum"),
            inp["a"], inp["b"], inp["c"])}
    return out


def _abssum(world, key="abc"):
    inp = hier_leaves(world)
    if key == "codec":
        return float(np.abs(inp["codec"]).sum(0).max())
    return max(float(np.abs(inp[k]).sum(0).max()) for k in "abc")


def _assert_rt(got, want, rtol=RT_RTOL, atol=RT_ATOL, msg=""):
    """A (shards, leaves[, residuals]) case against JAX's for one rank."""
    g_sh, w_sh = got[0], want[0]
    assert set(g_sh) == set(w_sh), msg
    for k in w_sh:
        np.testing.assert_allclose(g_sh[k], w_sh[k], rtol=rtol, atol=atol,
                                   err_msg=f"{msg} shard {k}")
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=f"{msg} leaf {i}")
    if len(want) == 3:
        for k in want[2]:
            np.testing.assert_allclose(got[2][k], want[2][k], rtol=rtol,
                                       atol=atol, err_msg=f"{msg} resid {k}")


def _rank(stacked, r):
    """Rank ``r``'s row of a stacked JAX result."""
    return jax.tree_util.tree_map(lambda y: y[r], stacked)


# ---------------------------------------------------------------------------
# topology resolution: no world
# ---------------------------------------------------------------------------

#: (mode, sizes) of tests/test_torch_zero.py's topology cases
TOPO_CASES = [(m, s) for s in [(1,), (8,), (1, 8), (8, 1), (1, 1)]
              for m in ("auto", "flat")] + [
    ("auto", (2, 4)), ("two_level", (2, 4)), ("two_level", (1, 8)),
    ("tree", (2, 4)), ("auto", (2, 2, 2)), ("tree", (2, 2, 2))]


def _levels(tree, names=None):
    """(name, extent, wire bits, spans every axis) of each level, names
    mapped through ``names``."""
    names = names or {}
    return [(names.get(lv.name, lv.name), lv.extent, lv.wire_bits,
             lv.axes is not None) for lv in tree.levels]


class TestResolveTopology:
    @pytest.mark.parametrize("bits", [None, 8])
    @pytest.mark.parametrize("case", TOPO_CASES,
                             ids=lambda c: f"{c[0]}-{c[1]}")
    def test_matches_jax(self, case, bits):
        """Mode, level names (JAX's ici/dcn for the port's local/cross),
        extents, codec placement and the effective tree."""
        mode, sizes = case
        got = TTopo.resolve_topology(mode, sizes, wire_bits=bits)
        want = JTopo.resolve_topology(mode, sizes, wire_bits=bits)
        assert got.mode == want.mode and got.world == want.world
        assert _levels(got, JAX_NAMES) == _levels(want)
        assert _levels(got.effective(), JAX_NAMES) == \
            _levels(want.effective())
        if mode in TTopo.HIERARCHY_MODES:
            assert TTopo.resolve_hierarchy(mode, sizes) == \
                JTopo.resolve_hierarchy(mode, sizes)

    @pytest.mark.parametrize("spec,codecs", [
        ("cross=int8", {"cross": 8}), ("local=fp8_e4m3,cross=fp32",
                                       {"local": 8, "cross": None}),
        ("", {}), (None, {}), (" local = INT8 , ", {"local": 8})])
    def test_codec_grammar_matches_jax(self, spec, codecs):
        assert TTopo.parse_level_codecs(spec) == codecs == \
            JTopo.parse_level_codecs(spec)

    @pytest.mark.parametrize("spec", ["local", "local=int4", "=int8",
                                      "local=int8,local=fp32"])
    def test_codec_grammar_errors_as_jax(self, spec):
        with pytest.raises(ValueError):
            JTopo.parse_level_codecs(spec)
        with pytest.raises(ValueError):
            TTopo.parse_level_codecs(spec)

    @pytest.mark.parametrize("codecs,sizes", [
        ({"local": 8}, (2, 4)), ({"cross": 8, "local": None}, (2, 4)),
        ({"pod": 8}, (2, 2, 2)), ({"chip": 8, "slice": 8}, (2, 2, 2))])
    def test_level_codecs_place_the_codec_as_jax(self, codecs, sizes):
        jcodecs = {JAX_NAMES.get(k, k): v for k, v in codecs.items()}
        for mode in ("two_level", "tree") if len(sizes) == 2 else ("tree",):
            got = TTopo.resolve_topology(mode, sizes, wire_bits=8,
                                         level_codecs=codecs)
            want = JTopo.resolve_topology(mode, sizes, wire_bits=8,
                                          level_codecs=jcodecs)
            assert [lv.wire_bits for lv in got.levels] == \
                [lv.wire_bits for lv in want.levels]

    @pytest.mark.parametrize("codecs,sizes", [({"ici": 8}, (2, 4)),
                                              ({"dcn": 8}, (2, 4)),
                                              ({"local": 8}, (2, 2, 2))])
    def test_unknown_level_raises(self, codecs, sizes):
        """A level name the tree does not have raises, as JAX raises on
        its own unknown names."""
        with pytest.raises(ValueError, match="unknown level"):
            TTopo.resolve_topology("tree", sizes, level_codecs=codecs)
        with pytest.raises(ValueError, match="unknown level"):
            JTopo.resolve_topology("tree", sizes,
                                   level_codecs={"nic": 8})


# ---------------------------------------------------------------------------
# the exchange on the gloo worlds against JAX
# ---------------------------------------------------------------------------

class TestTwoLevelExchange:
    @pytest.mark.parametrize("layout", HIER_LAYOUTS,
                             ids=lambda lay: f"{lay[0]}x{lay[1]}")
    def test_ownership_is_local_major(self, worlds, jax_exchange, layout):
        """The rank at (cross c, local l) owns block l·C + c, as JAX's
        exchange_index_axes linearizes it, and its slices of rank 0's
        leaves are JAX's local_fusion_shards over that linearization;
        gathered back, they are those leaves."""
        want = jax_exchange[layout]
        cross, local = layout
        for r, out in enumerate(_world(worlds, layout)):
            assert out["index"] == (r % local) * cross + r // local
            assert out["index"] == int(want["index"][r])
            own, back = out["own"]
            for k, v in _rank(want["own"], r).items():
                np.testing.assert_array_equal(own[k], v, err_msg=k)
            inp = hier_leaves(cross * local)
            for got, name in zip(back, "abc"):
                np.testing.assert_array_equal(got, inp[name][0])

    @pytest.mark.parametrize("layout", HIER_LAYOUTS,
                             ids=lambda lay: f"{lay[0]}x{lay[1]}")
    @pytest.mark.parametrize("case", [("two", "sum"), ("two", "avg_b64")],
                             ids=lambda c: c[1])
    def test_against_jax(self, worlds, jax_exchange, layout, case):
        """Each rank's shards and the reassembled leaves equal JAX's
        hierarchical_reducescatter / hierarchical_allgather for the same
        rank, and the sum of every rank's leaves."""
        world = layout[0] * layout[1]
        inp = hier_leaves(world)
        div = world if case[1] == "avg_b64" else 1
        for r, out in enumerate(_world(worlds, layout)):
            _assert_rt(out[case], _rank(jax_exchange[layout][case], r),
                       msg=f"rank {r}")
            for got, name in zip(out[case][1], "abc"):
                np.testing.assert_allclose(got, inp[name].sum(0) / div,
                                           rtol=RT_RTOL, atol=RT_ATOL)

    @pytest.mark.parametrize("layout", HIER_LAYOUTS,
                             ids=lambda lay: f"{lay[0]}x{lay[1]}")
    def test_round_trip_equals_flat(self, worlds, jax_exchange, layout):
        """RS -> AG two-level equals the flat exchange's leaves, and the
        flat exchange's shards are JAX's flat ones (rank-major)."""
        for r, out in enumerate(_world(worlds, layout)):
            for two, flat in zip(out[("two", "sum")][1],
                                 out[("flat", "sum")][1]):
                np.testing.assert_allclose(two, flat, rtol=RT_RTOL,
                                           atol=RT_ATOL)
            _assert_rt(out[("flat", "sum")],
                       _rank(jax_exchange[layout][("flat", "sum")], r))

    @pytest.mark.parametrize("layout", HIER_LAYOUTS,
                             ids=lambda lay: f"{lay[0]}x{lay[1]}")
    @pytest.mark.parametrize("wire", WIRES)
    @pytest.mark.parametrize("case", ["q", "qi"])
    def test_codec_against_jax(self, worlds, jax_exchange, layout, wire,
                               case):
        """The codec on the cross hop (Average of the codec input), and on
        both hops with the local hop's residuals fed back (the residuals
        too): within one codec step of JAX."""
        world = layout[0] * layout[1]
        step = CODEC_STEP[wire] * _abssum(world, "codec" if case == "q"
                                          else "abc")
        for r, out in enumerate(_world(worlds, layout)):
            _assert_rt(out[(case, wire)],
                       _rank(jax_exchange[layout][(case, wire)], r),
                       rtol=0, atol=step, msg=f"rank {r}")

    @pytest.mark.parametrize("layout", HIER_LAYOUTS,
                             ids=lambda lay: f"{lay[0]}x{lay[1]}")
    def test_level_codecs_place_the_local_codec(self, worlds, jax_exchange,
                                                layout):
        """exchange_levels_from_topology with ``{"local": 8}`` against
        JAX's levels with ``{"ici": 8}``: the codec on the local hop, one
        scale a leaf."""
        world = layout[0] * layout[1]
        step = CODEC_STEP["int8"] * _abssum(world)
        for r, out in enumerate(_world(worlds, layout)):
            _assert_rt(out["codecs_local"],
                       _rank(jax_exchange[layout]["codecs_local"], r),
                       rtol=0, atol=step, msg=f"rank {r}")

    @pytest.mark.parametrize("layout", HIER_LAYOUTS,
                             ids=lambda lay: f"{lay[0]}x{lay[1]}")
    @pytest.mark.parametrize("op", ["Sum", "Average"])
    def test_adasum_against_jax(self, worlds, jax_exchange, layout, op):
        """reduction="adasum" on the cross hop (recursive doubling across
        2 nodes, the gathered tree across 3), prescale 0.5 and postscale
        2.0: JAX's hierarchical_reducescatter(reduction="adasum") within
        rtol 1e-5; every rank of a node holds the same reassembled
        leaves."""
        outs = _world(worlds, layout)
        for r, out in enumerate(outs):
            _assert_rt(out[("adasum", op)],
                       _rank(jax_exchange[layout][("adasum", op)], r),
                       rtol=ADASUM_RTOL, atol=ADASUM_ATOL, msg=f"rank {r}")
            for got, ref in zip(out[("adasum", op)][1],
                                outs[0][("adasum", op)][1]):
                np.testing.assert_array_equal(got, ref)

    @pytest.mark.parametrize("layout", HIER_LAYOUTS,
                             ids=lambda lay: f"{lay[0]}x{lay[1]}")
    @pytest.mark.parametrize("wire", WIRES)
    def test_adasum_codec_against_jax(self, worlds, jax_exchange, layout,
                                      wire):
        """Adasum with the codec on the cross hop (each round's wire
        quantized at a power-of-two extent; JAX gathers the 3-node
        fallback unquantized, and so does the port): within one codec
        step of JAX."""
        world = layout[0] * layout[1]
        step = CODEC_STEP[wire] * _abssum(world)
        for r, out in enumerate(_world(worlds, layout)):
            _assert_rt(out[("adasum_q", wire)],
                       _rank(jax_exchange[layout][("adasum_q", wire)], r),
                       rtol=0, atol=step, msg=f"rank {r}")

    @pytest.mark.parametrize("layout", HIER_LAYOUTS,
                             ids=lambda lay: f"{lay[0]}x{lay[1]}")
    def test_adasum_degenerate_is_the_sum(self, worlds, layout):
        """An outer level of one rank, and a tree of one level: adasum is
        the plain sum, bit for bit (JAX tree_reducescatter's rule)."""
        for out in _world(worlds, layout):
            deg_sum, deg_ada, one_sum, one_ada = out["degenerate"]
            for a, b in ((deg_sum, deg_ada), (one_sum, one_ada)):
                for k in a[0]:
                    np.testing.assert_array_equal(a[0][k], b[0][k])
                for x, y in zip(a[1], b[1]):
                    np.testing.assert_array_equal(x, y)


class TestTreeExchange:
    """The 2 x 2 x 2 tree from the world of 8's own groups against JAX's
    ``("pod", "slice", "chip")`` mesh (TestTreeExchange of
    tests/test_hierarchy_smoke.py)."""

    def _outs(self, worlds):
        return [o["tree3"] for o in _world(worlds, (2, 4))]

    def test_ownership(self, worlds, jax_exchange):
        """Rank pod·4 + slice·2 + chip owns block chip·4 + slice·2 + pod."""
        for r, out in enumerate(self._outs(worlds)):
            assert out["index"] == int(jax_exchange["tree3"]["index"][r])
            assert out["index"] == (r & 1) * 4 + (r >> 1 & 1) * 2 + (r >> 2)

    def test_round_trip_against_jax(self, worlds, jax_exchange):
        inp = hier_leaves(8)
        for r, out in enumerate(self._outs(worlds)):
            _assert_rt(out["sum"], _rank(jax_exchange["tree3"]["sum"], r))
            for got, name in zip(out["sum"][1], "abc"):
                np.testing.assert_allclose(got, inp[name].sum(0),
                                           rtol=RT_RTOL, atol=RT_ATOL)

    def test_outermost_codec_against_jax(self, worlds, jax_exchange):
        step = CODEC_STEP["int8"] * _abssum(8, "codec")
        inp = hier_leaves(8)
        for r, out in enumerate(self._outs(worlds)):
            _assert_rt(out["pod_int8"],
                       _rank(jax_exchange["tree3"]["pod_int8"], r),
                       rtol=0, atol=step)
            np.testing.assert_allclose(out["pod_int8"][1][0],
                                       inp["codec"].mean(0), atol=step)

    def test_innermost_codec_takes_a_scale_a_leaf(self, worlds,
                                                  jax_exchange):
        """A 1e-3 leaf fused beside a 500 one survives the chip hop's
        codec, as in JAX."""
        for r, out in enumerate(self._outs(worlds)):
            _assert_rt(out["chip_int8"],
                       _rank(jax_exchange["tree3"]["chip_int8"], r),
                       rtol=RT_RTOL, atol=0)
            big, small = out["chip_int8"][1]
            np.testing.assert_allclose(big, 500.0, rtol=0.1)
            np.testing.assert_allclose(small, 1e-3, rtol=0.1)

    def test_adasum_on_the_pod_hop_against_jax(self, worlds, jax_exchange):
        """Adasum on the outermost level, its coefficients summed over the
        chip and slice groups: JAX's within rtol 1e-5."""
        for r, out in enumerate(self._outs(worlds)):
            _assert_rt(out["adasum"],
                       _rank(jax_exchange["tree3"]["adasum"], r),
                       rtol=ADASUM_RTOL, atol=ADASUM_ATOL)


# ---------------------------------------------------------------------------
# the optimizer and the step
# ---------------------------------------------------------------------------

def _mlp_loss(params, xb, yb):
    h = jnp.tanh(xb @ params["w1"] + params["b1"])
    return jnp.mean((h @ params["w2"] + params["b2"] - yb) ** 2)


def _mu(state):
    """The Adam first moment of a JAX sharded optimizer state."""
    found = [s for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    return found[0].mu


@pytest.fixture(scope="module")
def jax_mlp():
    """JAX's DistributedOptimizer(optax.adamw(1e-2),
    shard_optimizer_states=True) with each case's options on each layout's
    mesh, the batch's rows split over the ranks: the parameters and each
    rank's first-moment shards."""
    params0 = {k: jnp.asarray(v) for k, v in mlp_params().items()}
    out = {}
    for layout in HIER_LAYOUTS:
        world = layout[0] * layout[1]
        x, y = mlp_batch(8 * world)
        names = HIER_MLP_CASES if world == 8 else HIER_MLP_3X2
        for name in names:
            steps, kw = HIER_MLP_CASES[name]

            def body(xb, yb, steps=steps, kw=kw):
                tx = jhvd.DistributedOptimizer(
                    optax.adamw(1e-2), axis=GLOBAL_AXES,
                    shard_optimizer_states=True,
                    hierarchy=kw.get("hierarchy", "auto"),
                    exchange_bucket_bytes=kw.get("exchange_bucket_bytes"),
                    compression=jhvd.Compression.int8
                    if "compression" in kw else None,
                    error_feedback=kw.get("error_feedback", False),
                    reduction=kw.get("reduction"))
                params = params0
                state = tx.init(params)
                for _ in range(steps):
                    g = jax.grad(_mlp_loss)(params, xb, yb)
                    upd, state = tx.update(g, state, params)
                    params = optax.apply_updates(params, upd)
                return params, jax.tree_util.tree_map(lambda m: m[None],
                                                      _mu(state))

            mesh, axes = _mesh(layout)
            with _wire(kw.get("wire", "int8")):
                params, mu = jax.jit(jax.shard_map(
                    body, mesh=mesh, in_specs=(P(axes), P(axes)),
                    out_specs=(P(), P(axes)), check_vma=False))(
                    jnp.asarray(x), jnp.asarray(y))
            out[(layout, name)] = (
                {k: np.asarray(v) for k, v in params.items()},
                {k: np.asarray(v) for k, v in mu.items()})
    return out


#: the MLP cases held against JAX as AdamW states, by layout
MLP_PARITY = [((2, 4), n) for n in ("flat", "two_level", "auto", "tree",
                                    "b64", "adasum")] + \
    [((3, 2), n) for n in ("flat", "two_level", "adasum")]
#: the codec cases: int8 with and without error feedback, fp8 with: their
#: parameters within this of JAX's after 3 steps (the codec rounds the
#: inner hop's partial sums, which the two sides add in other orders)
MLP_CODEC_ATOL = 1e-4


class TestShardedOptimizer:
    @pytest.mark.parametrize("case", MLP_PARITY,
                             ids=lambda c: f"{c[0][0]}x{c[0][1]}-{c[1]}")
    def test_mlp_against_jax(self, worlds, jax_mlp, case):
        """Parameters as assert_adam_close states of JAX's, each rank's
        first-moment shard JAX's shard for the same rank (the block it
        owns), and the mode the step runs."""
        layout, name = case
        steps = HIER_MLP_CASES[name][0]
        want, want_mu = jax_mlp[case]
        mode = "flat" if name == "flat" else "two_level"
        for r, out in enumerate(_world(worlds, layout)):
            got = out["mlp"][name]
            assert got["mode"] == mode
            for k in want:
                assert_adam_close(got["params"][k], want[k], k, steps=steps,
                                  lr=1e-2)
            for k, v in want_mu.items():
                scale = float(np.abs(v).max())
                np.testing.assert_allclose(got["mu"][k], v[r], rtol=1e-3,
                                           atol=1e-3 * scale, err_msg=k)

    @pytest.mark.parametrize("name", ["int8", "int8_ef", "fp8_ef"])
    def test_mlp_codec_against_jax(self, worlds, jax_mlp, name):
        """The int8 / fp8 wire on the cross hop, and with error feedback
        on both hops (JAX's quantize_inner): JAX's parameters within
        MLP_CODEC_ATOL."""
        want, _ = jax_mlp[((2, 4), name)]
        for out in _world(worlds, (2, 4)):
            got = out["mlp"][name]["params"]
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=MLP_CODEC_ATOL, err_msg=k)

    @pytest.mark.parametrize("layout", HIER_LAYOUTS,
                             ids=lambda lay: f"{lay[0]}x{lay[1]}")
    def test_two_level_equals_flat(self, worlds, layout):
        """Two_level, auto, tree and bucketed against the flat exchange
        (tests/test_hierarchy_smoke.py's limits); the moments are the same
        values, each on the rank that owns its block."""
        names = [n for n in ("two_level", "auto", "tree", "b64")
                 if n in (HIER_MLP_CASES if layout == (2, 4)
                          else HIER_MLP_3X2)]
        outs = _world(worlds, layout)
        by_block = {o["mlp"]["flat"]["index"]: o["mlp"]["flat"]["mu"]
                    for o in outs}
        for out in outs:
            flat = out["mlp"]["flat"]
            for name in names:
                got = out["mlp"][name]
                for k in flat["params"]:
                    np.testing.assert_allclose(
                        got["params"][k], flat["params"][k], rtol=1e-5,
                        atol=1e-6, err_msg=f"{name}/{k}")
                assert abs(got["loss"] - flat["loss"]) < 1e-5
            two = out["mlp"]["two_level"]
            for k, v in two["mu"].items():
                np.testing.assert_allclose(v, by_block[two["index"]][k],
                                           rtol=1e-4, atol=1e-7)

    def test_auto_and_tree_are_two_level_bit_for_bit(self, worlds):
        """On a 2 x 4 layout "auto" and "tree" run the two-level
        exchange: the same bits."""
        for out in _world(worlds, (2, 4)):
            mlp = out["mlp"]
            for name in ("auto", "tree"):
                for k, v in mlp["two_level"]["params"].items():
                    np.testing.assert_array_equal(mlp[name]["params"][k], v)


@pytest.fixture(scope="module")
def jax_lm(lm_params0):
    """Three optax.adamw(3e-4) steps of JAX's DistributedTrainStep with
    the two-level exchange on the conftest 2 x 4 mesh, global batch 8."""
    jhvd.init()
    try:
        model = JT.TransformerLM(JT.TransformerConfig(
            dtype=jnp.float32, attention_impl="dense", **SIZES))

        def loss_fn(params, batch):
            logits = model.apply(params, batch["inputs"])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, batch["labels"]).mean()

        step = jhvd.DistributedTrainStep(
            loss_fn, optax.adamw(3e-4), mode="shard_map",
            shard_optimizer_states=True, hierarchy="two_level")
        assert step.exchange_hierarchy == "two_level"
        params, opt_state = step.init(lm_params0)
        tok = _tokens()
        batch = step.shard_batch({"inputs": tok[:, :-1],
                                  "labels": tok[:, 1:]})
        losses = []
        for _ in range(3):
            params, opt_state, loss = step(params, opt_state, batch)
            losses.append(float(loss))
        final = jax.tree_util.tree_map(np.asarray, params)
    finally:
        jhvd.shutdown()
    return losses, final


class TestTransformer:
    @pytest.mark.parametrize("hierarchy", ["two_level", "tree"])
    def test_against_jax_two_level(self, worlds, jax_lm, hierarchy):
        """The two-layer TransformerLM on convert.py's weights on the 2 x 4
        world, 3 steps: losses 1e-5 relative to JAX's two-level step,
        parameters as assert_adam_close states; every rank the same
        bits."""
        want_losses, final = jax_lm
        ref = {k: v.numpy() for k, v in params_from_flax(final).items()}
        outs = _world(worlds, (2, 4))
        for out in outs:
            losses, params = out["lm"][hierarchy]
            np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
            assert losses[-1] < losses[0]
            for k, v in params.items():
                assert_adam_close(v, ref[k], k)
            for k, v in outs[0]["lm"][hierarchy][1].items():
                np.testing.assert_array_equal(params[k], v)

    def test_tree_is_two_level(self, worlds):
        for out in _world(worlds, (2, 4)):
            assert out["lm"]["tree"][0] == out["lm"]["two_level"][0]


# ---------------------------------------------------------------------------
# the sharded checkpoint under the two-level ownership
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt_worlds(tmp_path_factory):
    """A 2 x 2 world saves its shards at the blocks it owns and restores
    them two-level and flat; then a flat world of 2 restores them."""
    directory = str(tmp_path_factory.mktemp("hier_ckpt"))
    saved = spawn_world("run_hier_ckpt", world=4, args=(directory, True),
                        layout=(2, 2), timeout=WORLD_TIMEOUT_S)
    two = spawn_world("run_hier_ckpt", world=2, args=(directory, False),
                      timeout=WORLD_TIMEOUT_S)
    return saved, two


def _by_block(rows):
    """{(group, state name): every 1-D leaf laid end to end in owned-block
    order} of (block index, sharded state tree) pairs."""
    full = {}
    for _, tree in sorted(rows, key=lambda r: r[0]):
        for g, names in tree["state"].items():
            for n, v in names.items():
                if np.ndim(v):
                    full.setdefault((g, n), []).append(v)
    return {k: np.concatenate(v) for k, v in full.items()}


class TestCheckpoint:
    @pytest.mark.parametrize("target", ["2x2", "flat4", "flat2"])
    def test_restores_exactly(self, ckpt_worlds, target):
        """The state saved at 2 x 2, laid out by owned block, is the state
        restored at 2 x 2, at a flat world of 4 and at a flat world of 2,
        bit for bit (the padding aside); the restored runs' next step is
        the saving run's (bit for bit at 2 x 2, as AdamW states
        elsewhere)."""
        saved, two = ckpt_worlds
        assert [o["index"] for o in saved] == [0, 2, 1, 3]
        want = _by_block([(o["index"], o["saved"]) for o in saved])
        outs, how = {"2x2": (saved, "auto"), "flat4": (saved, "flat"),
                     "flat2": (two, "auto")}[target]
        assert {o[how]["mode"] for o in outs} == \
            {"two_level" if target == "2x2" else "flat"}
        got = _by_block([(o[how]["index"], o[how]["restored"])
                         for o in outs])
        for k, v in want.items():
            n = min(len(v), len(got[k]))
            np.testing.assert_array_equal(got[k][:n], v[:n], err_msg=str(k))
            assert not np.any(got[k][n:]) and not np.any(v[n:])
        ref = saved[0]["params3"]
        for o in outs:
            for k, v in o[how]["params"].items():
                if target == "2x2":
                    np.testing.assert_array_equal(v, ref[k])
                else:
                    assert_adam_close(v, ref[k], k, steps=1)


# ---------------------------------------------------------------------------
# the four-card test's gloo twin
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def four_card_twin():
    """``run_hier_nccl`` (tests/test_torch_gpu.py's
    test_hierarchy_over_nccl) on gloo, laid out 2 x 2, without the
    870.9M LM."""
    return spawn_world("run_hier_nccl", world=4, layout=(2, 2),
                       timeout=WORLD_TIMEOUT_S)


class TestFourCardTwin:
    def test_round_trip(self, four_card_twin):
        """fp32 leaves and a bf16 one through the two-level round trip and
        the flat one: the numpy sum of the inputs as sent (bf16 within 4
        bf16 steps of its largest entry: gloo sums bf16 in bf16)."""
        inp = hier_leaves(4)
        exact = [inp[k].sum(0) for k in "abc"] + [torch.from_numpy(
            inp["b"]).to(torch.bfloat16).float().numpy().sum(0)]
        for rank, out in enumerate(four_card_twin):
            assert out["index"] == [0, 2, 1, 3][rank]
            for j, want in enumerate(exact):
                for got in (out["tree"][j], out["flat"][j]):
                    if j == 3:
                        err = np.abs(got - want).max()
                        assert err <= 4 * 2.0 ** -8 * np.abs(want).max()
                    else:
                        np.testing.assert_allclose(got, want, rtol=RT_RTOL,
                                                   atol=RT_ATOL)

    def test_small_lm_with_the_codec_and_adasum(self, four_card_twin):
        """int8 + error feedback + reduction="adasum" two_level: the loss
        falls and every rank holds the same bits."""
        ref = four_card_twin[0]["lm"]
        assert ref["losses"][-1] < ref["losses"][0]
        for out in four_card_twin:
            assert out["lm"]["mode"] == "two_level"
            assert out["lm"]["losses"] == ref["losses"]
            for k, v in out["lm"]["params"].items():
                np.testing.assert_array_equal(v, ref["params"][k])


# ---------------------------------------------------------------------------
# the N-level tree over a named layout (DistributedOptimizer(axis=TreeLayout))
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree_world(tmp_path_factory):
    """``run_tree_layout`` on a gloo world of 8 laid out 2 x 4."""
    directory = str(tmp_path_factory.mktemp("tree_ckpt"))
    return spawn_world("run_tree_layout", world=8, args=(directory,),
                       layout=(2, 4), timeout=WORLD_TIMEOUT_S)


@pytest.fixture(scope="module")
def jax_tree_opt():
    """JAX's ``sharded_distributed_update(optax.adam(0.1), axis=("pod",
    "slice", "chip"), world=8, ...)`` on the 2 x 2 x 2 mesh (JAX
    TestTreeExchange._sharded_update), ``TREE_OPT_STEPS`` steps of
    ``tree_opt_grads``, for every case: the parameters, stacked over
    ranks."""
    from horovod_tpu.optim.optimizer import sharded_distributed_update

    mesh, axes = _tree_mesh()
    grads = jnp.asarray(tree_opt_grads())
    out = {}
    for name, kw in TREE_OPT_CASES.items():
        def body(g, kw=kw):
            tx = sharded_distributed_update(
                optax.adam(0.1), axis=axes, world=8,
                hierarchy=kw["hierarchy"],
                quantized_bits=8 if "compression" in kw else None,
                level_codecs=kw.get("level_codecs"),
                error_feedback=kw.get("error_feedback", False))
            params = {"a": jnp.ones((8,)), "b": jnp.zeros((4,))}
            state = tx.init(params)
            for t in range(TREE_OPT_STEPS):
                u, state = tx.update({"a": g[t, 0, :8], "b": g[t, 0, 8:]},
                                     state, params)
                params = optax.apply_updates(params, u)
            return params["a"][None], params["b"][None]

        a, b = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(P(None, axes),),
            out_specs=(P(axes), P(axes)), check_vma=False))(grads)
        out[name] = (np.asarray(a), np.asarray(b))
    return out


class TestTreeLayout:
    """The sharded optimizer over ``TreeLayout((2, 2, 2), ("pod",
    "slice", "chip"))`` on a gloo world of 8 against JAX's
    ``sharded_distributed_update`` on the same mesh
    (tests/test_hierarchy_smoke.py TestTreeExchange)."""

    @pytest.mark.parametrize("name", list(TREE_OPT_CASES))
    def test_against_jax(self, tree_world, jax_tree_opt, name):
        """Each rank's parameters after the steps, the codec cases too:
        JAX's at rtol 1e-5, atol 1e-6 (tests/test_hierarchy_smoke.py's
        limits against flat); the mode the wrapper runs."""
        want_a, want_b = jax_tree_opt[name]
        for r, out in enumerate(tree_world):
            got = out["opt"][name]
            assert got["mode"] == ("flat" if name == "flat" else "tree")
            np.testing.assert_allclose(got["a"], want_a[r], rtol=1e-5,
                                       atol=1e-6, err_msg=f"rank {r} a")
            np.testing.assert_allclose(got["b"], want_b[r], rtol=1e-5,
                                       atol=1e-6, err_msg=f"rank {r} b")

    def test_auto_is_tree_bit_for_bit(self, tree_world):
        for out in tree_world:
            for k in "ab":
                np.testing.assert_array_equal(out["opt"]["auto"][k],
                                              out["opt"]["tree"][k])

    def test_tree_matches_flat(self, tree_world):
        """JAX's test_optimizer_tree_matches_flat: rtol 1e-5, atol
        1e-6."""
        for out in tree_world:
            for k in "ab":
                np.testing.assert_allclose(out["opt"]["tree"][k],
                                           out["opt"]["flat"][k],
                                           rtol=1e-5, atol=1e-6)

    def test_level_codec_places_the_wire_codec(self, tree_world):
        """``level_codecs={"pod": 8}`` equals ``Compression.int8``'s
        placement bit for bit, and stays within the codec's envelope of
        the full-precision tree (JAX's rtol 0.05, atol 4e-3)."""
        for out in tree_world:
            opt = out["opt"]
            for k in "ab":
                np.testing.assert_array_equal(opt["pod_codec"][k],
                                              opt["int8"][k])
                for name in ("pod_codec", "chip_codec", "int8_ef"):
                    np.testing.assert_allclose(opt[name][k], opt["tree"][k],
                                               rtol=0.05, atol=4e-3)

    def test_ownership_and_replicas(self, tree_world):
        """Rank pod·4 + slice·2 + chip owns block chip·4 + slice·2 + pod
        under the tree, its rank under the flat exchange; every rank holds
        the same parameters."""
        for r, out in enumerate(tree_world):
            want = (r & 1) * 4 + (r >> 1 & 1) * 2 + (r >> 2)
            for name, got in out["opt"].items():
                assert got["index"] == (r if name == "flat" else want)
                for k in "ab":
                    np.testing.assert_array_equal(
                        got[k], tree_world[0]["opt"][name][k])

    def test_checkpoint_round_trip(self, tree_world):
        """The sharded state saved under the tree at the block each rank
        owns restores into a fresh wrapper bit for bit, and the restored
        run's next step is the saving run's, bit for bit."""
        for out in tree_world:
            ck = out["ckpt"]
            saved, restored = ck["saved"], ck["restored"]
            assert saved.keys() == restored.keys()
            for part in saved:
                for key, v in saved[part].items():
                    if isinstance(v, dict):
                        for n, x in v.items():
                            np.testing.assert_array_equal(
                                restored[part][key][n], x)
                    else:
                        np.testing.assert_array_equal(restored[part][key], v)
            for a, b in zip(ck["continued"], ck["resumed"]):
                np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("how", ["named", "with_one"])
    @pytest.mark.parametrize("name", ["auto", "flat", "int8_ef"])
    def test_default_axis_unchanged(self, tree_world, how, name):
        """``axis=None`` (the world's 2 x 4 layout) runs what a layout
        naming the same axes runs, bit for bit, and a ``(2, 1, 4)``
        layout drops its extent-1 level to the same exchange."""
        for out in tree_world:
            none, other = out["default"]["none"][name], \
                out["default"][how][name]
            assert none["mode"] == ("flat" if name == "flat" else
                                    "two_level")
            assert other["mode"] == ("flat" if name == "flat" else
                                     "two_level" if how == "named" else
                                     "tree")
            assert other["index"] == none["index"]
            for k in "ab":
                np.testing.assert_array_equal(other[k], none[k])

    def test_uncovered_layout_raises(self, tree_world):
        for out in tree_world:
            assert "covers 4 ranks, and the world has 8" in out["uncovered"]


class TestTreeGroups:
    def test_layouts_share_groups_and_shutdown_releases_them(self):
        """On a caller-made world of 4 laid out 2 x 2, the world's layout
        levels make one group each; a layout naming the same axes, and a
        second layout equal to another, make none and hold the same
        groups; ``hvd.shutdown()`` releases every group it made and
        leaves the caller's world."""
        for o in spawn_world("run_tree_groups", world=4,
                             launch={"hosts": ["a", "a", "b", "b"]},
                             timeout=WORLD_TIMEOUT_S):
            held = o["held"]
            assert held["levels"] == held["start"] + 2
            assert held["named"] == held["levels"]
            assert held["other"] == held["named"] + 2
            assert held["again"] == held["other"]
            assert held["shutdown"] == 1
            assert o["named_shares_levels"] and o["equal_layouts_share"]
            assert o["other_differs"] and o["world_left"]


class TestTreeLayoutSpec:
    @pytest.mark.parametrize("shape,names,match", [
        ((2, 2), ("a",), "one name"), ((), (), "one name"),
        ((2, 2), ("a", "a"), "must differ"), ((2, 0), ("a", "b"), ">= 1")])
    def test_rejects(self, shape, names, match):
        with pytest.raises(ValueError, match=match):
            TTopo.TreeLayout(shape, names)

    def test_lines_are_jax_mesh_lines(self):
        """Each axis's lines are the device ids that JAX's
        ``Mesh(devices.reshape(shape), names)`` puts along that axis."""
        from horovod_tpu_torch.parallel.mesh import axis_ranks

        grid = np.arange(8).reshape(TREE_SHAPE)
        shape = dict(zip(TREE_NAMES, TREE_SHAPE))
        for i, name in enumerate(TREE_NAMES):
            want = sorted(np.moveaxis(grid, i, -1).reshape(-1, 2).tolist())
            assert sorted(axis_ranks(shape, name, order=TREE_NAMES)) == want

    def test_needs_the_sharded_exchange(self):
        with pytest.raises(ValueError, match="shard_optimizer_states"):
            import horovod_tpu_torch as hvd

            hvd.DistributedOptimizer(
                torch.optim.SGD([torch.nn.Parameter(torch.ones(2))],
                                lr=0.1),
                axis=TTopo.TreeLayout(TREE_SHAPE, TREE_NAMES))


@pytest.fixture(scope="module")
def tree_card_twin():
    """``run_tree_nccl`` (tests/test_torch_gpu.py's test_tree_over_nccl)
    on gloo, without the 870.9M LM: the probe takes the small LM."""
    return spawn_world("run_tree_nccl", world=4, timeout=WORLD_TIMEOUT_S)


class TestTreeFourCardTwin:
    def test_layouts_are_the_two_level_exchange(self, tree_card_twin):
        """"tree" on a (2, 2) layout and on (2, 1, 2) run the two-level
        exchange's bits; flat within 1e-5; every rank the same bits."""
        for rank, out in enumerate(tree_card_twin):
            lm = out["lm"]
            assert [lm[c]["mode"] for c in lm] == \
                ["two_level", "two_level", "tree", "tree", "flat"]
            assert lm["two_level"]["index"] == [0, 2, 1, 3][rank]
            for case in ("tree", "tree_212"):
                assert lm[case]["losses"] == lm["two_level"]["losses"]
                for k, v in lm["two_level"]["params"].items():
                    np.testing.assert_array_equal(lm[case]["params"][k], v)
            np.testing.assert_allclose(lm["flat"]["losses"],
                                       lm["two_level"]["losses"], rtol=1e-5)
            for case, r in lm.items():
                for k, v in r["params"].items():
                    np.testing.assert_array_equal(
                        v, tree_card_twin[0]["lm"][case]["params"][k])

    def test_pod_codec_within_the_envelope(self, tree_card_twin):
        """``level_codecs={"pod": 8}`` moves the result, within JAX's
        envelope of the exact tree (rtol 0.05, atol 4e-3)."""
        for out in tree_card_twin:
            lm = out["lm"]
            assert lm["pod_codec"]["losses"] != lm["tree_212"]["losses"]
            for k, v in lm["tree_212"]["params"].items():
                np.testing.assert_allclose(lm["pod_codec"]["params"][k], v,
                                           rtol=0.05, atol=4e-3)

    def test_probe_over_the_layout(self, tree_card_twin):
        for rank, out in enumerate(tree_card_twin):
            two, flat = out["probe"]["two_level"], out["probe"]["flat"]
            assert (two["hierarchy"], two["rs_scopes"]) == ("two_level",
                                                            (2,))
            assert (flat["hierarchy"], flat["rs_scopes"]) == ("flat", (4,))
            assert two["exchange_intra_s"] is not None
            assert two["wire_bytes_ici"] > 0 and two["wire_bytes_dcn"] > 0
            assert flat["wire_bytes_dcn"] == 0
            # the same payload crosses the wire either way
            assert two["wire_bytes_ici"] + two["wire_bytes_dcn"] == \
                flat["wire_bytes_ici"]
