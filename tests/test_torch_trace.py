"""The port's record of a step (``utils/trace.py``), its lint
(``analysis/trace_lint.py``) and the cost model's layer 1 against the JAX
package's HLO layer (``utils/hlo.py``, ``analysis/hlo_lint.py``,
``analysis/cost_model.py``), in one process.

* FLOPs: the tiny LM (vocab 128, 2 layers, 2 heads, d_model 64, d_ff 128,
  fp32) on seeded tokens of shape (2, 65), forward and backward, counted by
  the port through ``FlopCounterMode`` on the dense and the flash path,
  against the dots of JAX's compiled ``value_and_grad`` with each dot's
  operand shape looked up from its definition (JAX's own ``module_flops``
  reads 0 on the compiled text of the XLA the tests run, which prints the
  operands as bare names):
  integer equality.  Each kernel's flop formula against the dense
  computation it replaces: ``chip_smoke.flop_check``, phase 23's check.
* Memory: the measured high-water of known allocations, exact.
* Structure and wire bytes: synthetic ops of known groups, the port's
  ``scopes_by_kind`` and ``collective_wire_by_level`` against JAX's over
  the same groups written as HLO replica groups: exact.
* Record: ``record_collectives`` at a world of one (bytes conventions,
  unwaited async works, the patch undone), ``DistributedTrainStep.trace``
  against ``__call__`` from the same starting state, a saved trace.
* Lint: every artifact case of JAX's ``TestHloLint``, ``TestSerialTailRule``,
  ``TestMoeDispatchRule`` and ``TestSpRingRule`` rebuilt as a dict, and the
  probe's bench fields: the same ids and messages as JAX's; a synthetic
  trace fires each of HLO001-HLO007, and a clean one none.

The multi-rank structure guards are in ``test_torch_trace_guards.py``."""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import chip_smoke
from horovod_tpu.analysis import cost_model as JCM
from horovod_tpu.analysis import hlo_lint as JL
from horovod_tpu.models import transformer as JT
from horovod_tpu.utils import hlo as H
from horovod_tpu.utils import overlap_probe as JP
from horovod_tpu_torch.analysis import cost_model as CM
from horovod_tpu_torch.analysis import trace_lint as L
from horovod_tpu_torch.models import transformer as TT
from horovod_tpu_torch.ops import kernels as K
from horovod_tpu_torch.utils import overlap_probe as TP
from horovod_tpu_torch.utils import trace as T

from torch_port_workers import mlp_batch, mlp_params

REPO = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=128, num_layers=2, num_heads=2, d_model=64, d_ff=128,
            max_seq_len=64)
#: JAX's compiled dots of the tiny LM's forward and backward
TINY_FLOPS = 69_206_016


def _tokens():
    return np.random.RandomState(0).randint(0, 128, (2, 65)).astype(np.int64)


# -- FLOPs --------------------------------------------------------------------

_DEF = re.compile(
    r"^\s*(?:ROOT\s+)?(%[\w.\-]+)\s*=\s*(.+?)(?<=[\]})])\s*\b([\w\-]+)\(")


def resolved_dot_flops(text: str) -> int:
    """``2·|result|·K`` summed over the module's dots, K from the lhs
    operand's shape looked up from its definition (HLO names are unique in
    a module, fusion bodies included) and ``lhs_contracting_dims``."""
    defs, dots = {}, []
    for line in text.splitlines():
        m = _DEF.match(line)
        if m is None:
            continue
        defs[m.group(1)] = H._parse_shapes(m.group(2))
        if m.group(3) == "dot":
            dots.append((line, defs[m.group(1)][0][1]))
    total = 0
    for line, result in dots:
        lhs = re.search(r"\bdot\((%[\w.\-]+)", line).group(1)
        lhs_dims = defs[lhs][0][1]
        contract = [int(x) for x in re.search(
            r"lhs_contracting_dims=\{([\d,]*)\}", line).group(1).split(",")
            if x]
        total += 2 * int(np.prod(result)) * int(
            np.prod([lhs_dims[c] for c in contract]))
    return total


@pytest.fixture(scope="module")
def jax_dots():
    cfg = JT.TransformerConfig(dtype=jnp.float32, attention_impl="dense",
                               **TINY)
    model = JT.TransformerLM(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64), jnp.int32))

    def loss(p, t):
        logits = model.apply(p, t[:, :-1])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), t[:, 1:]).mean()

    text = jax.jit(jax.value_and_grad(loss)).lower(
        params, jnp.asarray(_tokens(), jnp.int32)).compile().as_text()
    return resolved_dot_flops(text)


def _lm_step(impl: str, remat=None):
    cfg = TT.TransformerConfig(dtype=torch.float32, attention_impl=impl,
                               remat_policy=remat, **TINY)
    model = TT.TransformerLM(cfg, generator=torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(_tokens())
    return lambda: TT.lm_loss(model, tokens).backward()


class TestFlops:
    def test_jax_resolved_dots(self, jax_dots):
        assert jax_dots == TINY_FLOPS

    @pytest.mark.parametrize("impl", ["dense", "flash"])
    def test_module_flops_equal_jax_dots(self, jax_dots, impl):
        """The same count on the dense path (aten bmm) and the flash path
        (the kernels' formulas), and JAX's."""
        assert T.module_flops(_lm_step(impl)) == jax_dots

    def test_flash_ops_count_the_dense_attention(self):
        dense = dict(T.op_flops(_lm_step("dense")))
        flash = dict(T.op_flops(_lm_step("flash")))
        assert flash["aten.mm"] == dense["aten.mm"]
        ops = {k: v for k, v in flash.items() if k.startswith("hvd_torch.")}
        # 2·B·h·t²·d for each product: QKᵀ and PV, then two a kernel
        each = 2 * (2 * 2 * 2 * 64 * 64 * 32) * 2
        assert ops == {"hvd_torch.flash_fwd": each,
                       "hvd_torch.flash_bwd_dq": each,
                       "hvd_torch.flash_bwd_dkv": each}
        assert sum(ops.values()) == dense["aten.bmm"]

    def test_remat_recomputes_count_again(self):
        """Under a remat tier the recomputed forward counts again, as the
        recomputed dots do in HLO."""
        plain = dict(T.op_flops(_lm_step("flash")))
        remat = dict(T.op_flops(_lm_step("flash", remat="full")))
        assert remat["hvd_torch.flash_fwd"] == \
            2 * plain["hvd_torch.flash_fwd"]
        assert remat["hvd_torch.flash_bwd_dq"] == \
            plain["hvd_torch.flash_bwd_dq"]
        assert remat["aten.mm"] > plain["aten.mm"]

    def test_kernel_formulas_equal_dense_counts(self):
        """Phase 23's check on the CPU, where each wrapper runs its op's
        plain kernel: the formulas count what the dense computation does."""
        got = chip_smoke.flop_check(torch, torch.device("cpu"),
                                    attn=(2, 64, 2, 32),
                                    cbr=(2, 8, 8, 128, 128),
                                    mm=(256, 256, 256))
        assert set(got) == {"flash_fwd", "flash_bwd", "cbr_bwd",
                            "pallas_matmul"}
        for name, (kernel, dense) in got.items():
            assert kernel == dense > 0, name

    def test_fused_scale_counts_nothing(self):
        x = torch.randn(4096)
        assert T.op_flops(K.fused_scale, x, 0.5) == []

    def test_analytic_count_of_the_tiny_lm(self):
        """chip_smoke's analytic count from the shapes is the counted one
        (phase 23 holds the 870.9M LM's to it)."""
        want = chip_smoke.analytic_step_flops(2, 64, 2, 2, 32, 64, 128, 128)
        assert want["total"] == TINY_FLOPS


# -- memory -------------------------------------------------------------------

class TestMemory:
    def test_high_water_of_known_allocations(self):
        def fn():
            a = torch.empty(1_000_000)          # 4 MB
            b = torch.empty(500_000)            # + 2 MB: the peak
            del a
            c = torch.empty(250_000)
            return b, c

        assert T.memory_high_water(fn) == 6_000_000

    def test_trace_call_measures_the_same(self):
        def fn():
            a = torch.empty(1_000_000)
            del a
            return torch.empty(10)

        _, tr = T.trace_call(fn)
        assert tr.memory_high_water_bytes == 4_000_000
        assert tr.memory_base_bytes is None and tr.device == "cpu"


# -- structure and wire bytes -------------------------------------------------

def _op(kind, nbytes, ranks, dtype="float32", shape=None, stream=None,
        interval=None):
    shape = shape or (nbytes // 4,)
    return T.CollectiveOp(kind=kind, shapes=[(dtype, tuple(shape))],
                          bytes=nbytes,
                          ranks=None if ranks is None else tuple(ranks),
                          group_size=None if ranks is None else len(ranks),
                          stream=stream, interval=interval)


def _groups(shape, axis):
    """The groups along ``axis`` of a C-order layout of ``shape`` (the
    world's ``(cross, local)`` layout and ``TreeLayout``'s rule)."""
    ids = np.arange(int(np.prod(shape))).reshape(shape)
    lines = np.moveaxis(ids, axis, -1).reshape(-1, shape[axis])
    return [list(map(int, g)) for g in lines]


def _jax_op(kind, nbytes, groups, dtype="f32"):
    raw = "{" + ",".join("{" + ",".join(map(str, g)) + "}"
                         for g in groups) + "}"
    return H.CollectiveOp(kind=kind, shapes=[(dtype, (nbytes // 4,))],
                          bytes=nbytes, replica_groups=raw,
                          group_size=len(groups[0]), line="")


LAYOUTS = [(2, 2), (2, 2, 2), (2, 4), (3, 2)]


class TestStructure:
    @pytest.mark.parametrize("shape", LAYOUTS)
    def test_level_stride_is_the_inner_extents(self, shape):
        """On a C-order layout level ℓ's groups step by the product of the
        extents inside it, levels of equal extent included; JAX's
        ``replica_group_stride`` reads the same."""
        for axis in range(len(shape)):
            want = int(np.prod(shape[axis + 1:]))
            groups = _groups(shape, axis)
            for g in groups:
                assert T.group_stride(g) == want
            raw = "{" + ",".join("{" + ",".join(map(str, g)) + "}"
                                 for g in groups) + "}"
            assert H.replica_group_stride(raw) == want

    def test_stride_unknown(self):
        assert T.group_stride(None) is None
        assert T.group_stride([3]) is None
        assert T.group_stride([0, 1, 3]) is None

    def test_count_and_scopes_are_jaxs(self):
        ops = [("reduce-scatter", 64, [[0, 1], [2, 3]]),
               ("reduce-scatter", 32, [[0, 2], [1, 3]]),
               ("all-gather", 64, [[0, 1, 2, 3]]),
               ("all-reduce", 4, [[0, 1, 2, 3]])]
        port = [_op(k, b, g[0]) for k, b, g in ops]
        jax_ops = [_jax_op(k, b, g) for k, b, g in ops]
        assert T.count_by_kind(port) == H.count_by_kind(jax_ops)
        assert T.scopes_by_kind(port) == H.scopes_by_kind(jax_ops)
        # the sizes alias the (2, 2) levels; the level scopes do not
        assert T.scopes_by_kind(port)["reduce-scatter"] == (2,)
        assert T.level_scopes_by_kind(port)["reduce-scatter"] == \
            ((2, 1), (2, 2))

    @pytest.mark.parametrize("shape", LAYOUTS)
    def test_wire_by_level_is_jaxs(self, shape):
        """Every kind on every level of the layout, and a world-sized op:
        the port's attribution (this rank's group's ranks) equals JAX's
        (all the groups), byte for byte."""
        names = ["chip", "slice", "pod"][:len(shape)]
        topology = [(n, e, None) for n, e in zip(names, reversed(shape))]
        port, jax_ops = [], []
        for axis in range(len(shape)):
            groups = _groups(shape, axis)
            for kind, nbytes in (("reduce-scatter", 96), ("all-gather", 384),
                                 ("all-reduce", 4), ("all-to-all", 48),
                                 ("collective-broadcast", 8)):
                port.append(_op(kind, nbytes, groups[-1]))
                jax_ops.append(_jax_op(kind, nbytes, groups))
        world = [list(range(int(np.prod(shape))))]
        port.append(_op("reduce-scatter", 40, world[0]))
        jax_ops.append(_jax_op("reduce-scatter", 40, world))
        got = CM.collective_wire_by_level(port, topology=topology)
        want = JCM.collective_wire_by_level(jax_ops, topology=topology)
        assert got == want
        if len(shape) == 2:
            assert CM.collective_wire_by_level(
                port, n_dcn=shape[0], n_ici=shape[1]) == \
                JCM.collective_wire_by_level(jax_ops, n_dcn=shape[0],
                                             n_ici=shape[1])

    @pytest.mark.parametrize("kind", ["all-reduce", "reduce-scatter",
                                      "all-gather", "all-to-all",
                                      "collective-permute",
                                      "collective-broadcast"])
    @pytest.mark.parametrize("g", [1, 2, 4])
    def test_op_wire_bytes_are_jaxs(self, kind, g):
        port = _op(kind, 1024, list(range(g)))
        jax_op = _jax_op(kind, 1024, [list(range(g))])
        assert CM._op_wire_bytes(port, 8) == JCM._op_wire_bytes(jax_op, 8)

    def test_module_cost(self):
        ops = [_op("reduce-scatter", 1000, [0, 1]),
               _op("reduce-scatter", 500, [0, 2])]
        tr = T.StepTrace(ops=ops, kernels=[], flops_by_op={"aten.mm": 989},
                         memory_high_water_bytes=123)
        cost = CM.module_cost(tr, n_dcn=2, n_ici=2)
        assert cost.flops == 989 and cost.memory_high_water_bytes == 123
        assert cost.wire_bytes == {"ici": 1000.0, "dcn": 500.0}
        hw = CM.H100
        assert cost.predicted_step_time_s(hw) == pytest.approx(
            989 / hw.peak_flops_per_s + 1000 / hw.ici_bytes_per_s
            + 500 / hw.dcn_bytes_per_s, rel=1e-12)
        assert cost.predicted_step_time_s(hw, overlap_fraction=1.0) == \
            pytest.approx(989 / hw.peak_flops_per_s, rel=1e-12)


# -- the record ---------------------------------------------------------------

@pytest.fixture
def world_of_one():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        yield hvd
    finally:
        hvd.shutdown()


_COLLECTIVES = ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor",
                "all_gather", "all_to_all_single", "broadcast", "isend",
                "irecv", "batch_isend_irecv")


class TestRecord:
    def test_patch_is_undone(self, world_of_one):
        before = {n: getattr(dist, n) for n in _COLLECTIVES}
        c10d = dist.distributed_c10d
        with T.record_collectives() as outer:
            assert dist.all_reduce is not before["all_reduce"]
            # P2POp takes the recording isend/irecv (equal to torch's),
            # and torch's own stay as they were
            assert dist.isend is not c10d.isend and dist.isend == c10d.isend
            op = dist.P2POp(dist.isend, torch.ones(2), 0)
            assert dist.P2POp(dist.irecv, torch.ones(2), 0).op == c10d.irecv
            with T.record_collectives() as inner:
                dist.all_reduce(torch.ones(3))
            dist.all_reduce(torch.ones(5))
        assert {n: getattr(dist, n) for n in _COLLECTIVES} == before
        assert c10d.isend is before["isend"] and op.op == c10d.isend
        assert [o.bytes for o in inner.ops] == [12]
        assert [o.bytes for o in outer.ops] == [12, 20]

    def test_bytes_are_jaxs_convention(self, world_of_one):
        """A reduce-scatter's result per shard, an all-gather's output, an
        all-reduce's payload; the group's global ranks; dtypes by name."""
        with T.record_collectives() as rec:
            dist.all_reduce(torch.ones(7))
            dist.reduce_scatter_tensor(torch.empty(4), torch.ones(4))
            dist.all_gather_into_tensor(torch.empty(6, dtype=torch.int32),
                                        torch.ones(6, dtype=torch.int32))
            dist.all_to_all_single(torch.empty(2, 3), torch.ones(2, 3))
            dist.broadcast(torch.ones(5, dtype=torch.int8), src=0)
            dist.all_gather([torch.empty(2)], torch.ones(2))
        got = [(o.kind, o.bytes, o.ranks, o.dtypes) for o in rec.ops]
        assert got == [("all-reduce", 28, (0,), {"float32"}),
                       ("reduce-scatter", 16, (0,), {"float32"}),
                       ("all-gather", 24, (0,), {"int32"}),
                       ("all-to-all", 24, (0,), {"float32"}),
                       ("collective-broadcast", 5, (0,), {"int8"}),
                       ("all-gather", 8, (0,), {"float32"})]
        assert not any(o.asynchronous for o in rec.ops)

    def test_unwaited_async_work_is_hlo002(self, world_of_one):
        def issue(wait):
            work = dist.all_reduce(torch.ones(3), async_op=True)
            if wait:
                work.wait()

        for wait in (False, True):
            _, tr = T.trace_call(issue, wait)
            assert tr.ops[0].asynchronous
            assert tr.unwaited == (0 if wait else 1)
            rules = [f.rule for f in L.lint_trace(tr)]
            assert rules == ([] if wait else ["HLO002"])

    def test_threads_lose_no_op(self, world_of_one):
        """Gradient hooks issue collectives from the autograd engine's
        threads: 16 threads × 50 recorded calls, switching every µs, leave
        800 ops and no pending work."""
        import sys
        import threading

        def bare(tensor, op=None, group=None, async_op=False):
            return None

        recorded = T._recording("all_reduce", bare)
        t = torch.ones(2)
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            with T.record_collectives() as rec:
                threads = [threading.Thread(
                    target=lambda: [recorded(t) for _ in range(50)])
                    for _ in range(16)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=60)
                assert not any(th.is_alive() for th in threads)
        finally:
            sys.setswitchinterval(old)
        assert len(rec.ops) == 800 and rec.unwaited == []

    def test_no_module_binds_a_collective_at_import(self):
        """The patch reaches every caller only if each calls
        ``dist.<name>`` when it runs: no module of the port imports a
        collective by name or keeps one in a module-level alias."""
        names = "|".join(_COLLECTIVES + ("reduce_scatter_single",
                                         "all_gather_single"))
        imported = re.compile(
            r"from\s+torch\.distributed(?:\.distributed_c10d)?\s+import\s+"
            r"\(?[^)]*?\b(" + names + r")\b", re.S)
        alias = re.compile(r"^\w+\s*=\s*(?:dist|torch\.distributed)\.("
                           + names + r")\b", re.M)
        offenders = []
        for path in sorted((REPO / "horovod_tpu_torch").rglob("*.py")):
            src = path.read_text()
            for m in list(imported.finditer(src)) + list(alias.finditer(src)):
                offenders.append(f"{path.name}: {m.group(0)[:80]}")
        assert offenders == []

    def test_step_trace_is_the_step(self, world_of_one):
        """``trace`` takes the same step as ``__call__`` from the same
        starting state (the loss and the parameters after it, bit for
        bit), and its FLOPs are the loss's forward and backward."""
        hvd = world_of_one
        tokens = torch.from_numpy(_tokens())
        runs = []
        for traced in (False, True):
            cfg = TT.TransformerConfig(dtype=torch.float32,
                                       attention_impl="flash", **TINY)
            model = TT.TransformerLM(cfg,
                                     generator=torch.Generator().manual_seed(0))
            step = hvd.DistributedTrainStep(
                TT.lm_loss, torch.optim.AdamW(model.parameters(), lr=1e-3))
            model, opt = step.init(model)
            if traced:
                loss, tr = step.trace(model, opt, tokens)
            else:
                model, opt, loss = step(model, opt, tokens)
            runs.append((float(loss), [p.detach().clone()
                                       for p in model.parameters()]))
        assert runs[0][0] == runs[1][0]
        for a, b in zip(runs[0][1], runs[1][1]):
            assert torch.equal(a, b)
        assert tr.flops == TINY_FLOPS
        assert T.count_by_kind(tr.ops) == {"all-reduce": 2}
        assert tr.memory_high_water_bytes > 0 and tr.world == 1
        assert T.serial_tail_collectives(tr) == 0
        assert L.lint_trace(tr) == []

    def test_traced_step_stays_out_of_step_seconds(self, world_of_one):
        """A traced step counts as a step, but its seconds under the
        profiler stay out of the step-time histogram; an untraced step
        goes into both."""
        from horovod_tpu_torch import telemetry

        hvd = world_of_one
        cfg = TT.TransformerConfig(dtype=torch.float32,
                                   attention_impl="dense", **TINY)
        model = TT.TransformerLM(cfg,
                                 generator=torch.Generator().manual_seed(0))
        step = hvd.DistributedTrainStep(
            TT.lm_loss, torch.optim.AdamW(model.parameters(), lr=1e-3))
        model, opt = step.init(model)
        tokens = torch.from_numpy(_tokens())

        def seen():
            hist = telemetry.snapshot()["histograms"].get(
                "hvd_step_seconds", {"count": 0})
            return telemetry.value("hvd_steps_total"), hist["count"]

        telemetry.enable()
        try:
            steps0, timed0 = seen()
            step.trace(model, opt, tokens)
            assert seen() == (steps0 + 1, timed0)
            step(model, opt, tokens)
            assert seen() == (steps0 + 2, timed0 + 1)
        finally:
            telemetry.disable()

    def test_saved_trace_round_trips_and_lints(self, world_of_one, tmp_path):
        def fn():
            dist.reduce_scatter_tensor(torch.empty(4), torch.ones(4))
            work = dist.all_reduce(torch.ones(300), async_op=True)
            return work

        _, tr = T.trace_call(fn)
        path = tmp_path / "step.json"
        tr.save(str(path))
        back = T.StepTrace.load(str(path))
        assert back == tr
        art = tmp_path / "bench.json"
        art.write_text(json.dumps({"exchange_hierarchy": "two_level",
                                   "exchange_rs_scopes": [8]}))
        rules = [f.rule for f in L.lint_paths([str(path), str(art)])]
        assert rules == ["HLO001", "HLO002", "HLO004"]
        with pytest.raises(ValueError, match="JSON"):
            L.lint_paths([str(tmp_path / "module.hlo")])


# -- the lint ------------------------------------------------------------------

#: every artifact case of JAX's TestHloLint, TestSerialTailRule,
#: TestMoeDispatchRule and TestSpRingRule (tests/test_analysis.py)
ARTIFACTS = [
    {"exchange_hierarchy": "two_level", "exchange_rs_scopes": [2, 4],
     "exchange_grad_sized_allreduces": 0, "overlap_fraction": 0.8},
    {"exchange_hierarchy": "two_level", "exchange_rs_scopes": [8],
     "exchange_grad_sized_allreduces": 2, "overlap_fraction": 1.7},
    {"transformer_exchange_hierarchy": "flat",
     "transformer_exchange_rs_scopes": [2, 4]},
    {"exchange_hierarchy": "two_level", "exchange_rs_scopes": [8]},
    {"overlap_fraction": 0.5, "fused_collectives": "on",
     "exchange_serial_tail_collectives": 1},
    {"overlap_fraction": 0.5, "fused_collectives": "off",
     "exchange_serial_tail_collectives": 1},
    {"overlap_fraction": 0.5},
    {"fused_overlap_fraction": 0.5, "fused_fused_collectives": "on",
     "fused_exchange_serial_tail_collectives": 2},
    {"moe_fused_collectives": "on", "moe_ep": 4,
     "moe_serial_tail_alltoalls": 1},
    {"moe_fused_collectives": "on", "moe_ep": 1,
     "moe_serial_tail_alltoalls": 1},
    {"moe_fused_collectives": "off", "moe_ep": 4,
     "moe_serial_tail_alltoalls": 1},
    {"sp_fused_collectives": "on", "sp": 4, "sp_serial_tail_permutes": 1,
     "sp_attention_allgathers": 2, "sp_collective_permutes": 3},
    {"sp_fused_collectives": "on", "sp": 2, "sp_serial_tail_permutes": 0,
     "sp_attention_allgathers": 0, "sp_collective_permutes": 10},
    {"sp_fused_collectives": "on", "sp": 1, "sp_serial_tail_permutes": 1},
    {"sp_fused_collectives": "off", "sp": 4, "sp_serial_tail_permutes": 1},
]


def _same(port, jax_findings):
    return [(f.rule, f.message, f.detail) for f in port] == \
        [(f.rule, f.message, f.detail) for f in jax_findings]


class TestArtifactLint:
    @pytest.mark.parametrize("art", ARTIFACTS,
                             ids=[str(i) for i in range(len(ARTIFACTS))])
    def test_equals_jax(self, art):
        assert _same(L.lint_artifact(art), JL.lint_artifact(art))

    def test_every_rule_of_the_artifact_cases_fires(self):
        rules = {f.rule for art in ARTIFACTS for f in L.lint_artifact(art)}
        assert rules == {"HLO001", "HLO004", "HLO005", "HLO006", "HLO007"}

    def test_file_and_multichip_wrapper(self, tmp_path):
        p = tmp_path / "bench.json"
        p.write_text(json.dumps({
            "parsed": {"exchange_hierarchy": "two_level",
                       "exchange_rs_scopes": [8]}}))
        got = L.lint_artifact_path(str(p))
        assert [f.rule for f in got] == ["HLO004"]
        assert _same(got, JL.lint_artifact_path(str(p)))
        assert _same(L.lint_paths([str(p)]), JL.lint_paths([str(p)]))

    @pytest.mark.parametrize("prefix", ["", "transformer_"])
    def test_probe_report_fields(self, prefix):
        """JAX's test_probe_report_emits_grad_sized_field, both reports."""
        kw = dict(backward_s=1.0, exchange_s=1.0, fused_s=1.5,
                  overlap_fraction=0.5, world=8, payload_bytes=1024,
                  hierarchy="two_level", rs_scopes=(2, 4), ag_scopes=(2, 4),
                  grad_sized_allreduces=0)
        got = TP.OverlapReport(**kw).as_bench_fields(prefix=prefix)
        want = JP.OverlapReport(**kw).as_bench_fields(prefix=prefix)
        assert got[f"{prefix}exchange_grad_sized_allreduces"] == 0
        assert L.lint_artifact(got) == []
        assert _same(L.lint_artifact(got), JL.lint_artifact(want))

    def test_measured_probe_fields(self, world_of_one):
        """The fields of a probe run at a world of one lint clean, as
        JAX's lint reads them."""
        model = torch.nn.ParameterDict({
            k: torch.nn.Parameter(torch.from_numpy(v.copy()))
            for k, v in mlp_params().items()})
        x, y = mlp_batch(8)

        def loss(m, b):
            h = torch.tanh(b["x"] @ m["w1"] + m["b1"])
            return torch.mean((h @ m["w2"] + m["b2"] - b["y"]) ** 2)

        rep = TP.measure_overlap(loss, model, {"x": torch.from_numpy(x),
                                               "y": torch.from_numpy(y)},
                                 iters=1, warmup=0)
        fields = rep.as_bench_fields()
        assert fields["exchange_serial_tail_collectives"] == 0
        assert L.lint_artifact(fields) == []
        assert _same(L.lint_artifact(fields), JL.lint_artifact(fields))


def _kernel(name, stream, start, dur):
    return T.Kernel(name, stream, float(start), float(dur))


def _rule_cases():
    """(rule, lint_trace keywords, dirty trace, clean trace)."""
    nccl = [_kernel("ncclDevKernel_ReduceScatter", 7, 0, 10)]
    cover = [_kernel("sm90_gemm", 13, 2, 5)]

    def tr(ops, kernels=(), **kw):
        return T.StepTrace(ops=ops, kernels=list(kernels), flops_by_op={},
                           memory_high_water_bytes=0, **kw)

    rs = _op("reduce-scatter", 52, [0, 1, 2, 3])
    cases = [
        ("HLO001", {}, tr([rs, _op("all-reduce", 400_000, [0, 1, 2, 3])]),
         tr([rs, _op("all-reduce", 4, [0, 1, 2, 3])])),
        ("HLO002", {}, tr([rs], unwaited=1), tr([rs])),
        ("HLO003", {"expect_hierarchy": "two_level"},
         tr([_op("reduce-scatter", 52, [0, 1]),
             _op("reduce-scatter", 26, [0, 2])]),
         tr([_op("reduce-scatter", 52, [0, 1]),
             _op("reduce-scatter", 26, [0, 2], dtype="int8")])),
        ("HLO004", {"expect_hierarchy": "two_level"},
         tr([_op("reduce-scatter", 52, [0, 1])]),
         tr([_op("reduce-scatter", 52, [0, 1]),
             _op("reduce-scatter", 26, [0, 2], dtype="int8")])),
        ("HLO004", {"expect_hierarchy": "flat"},
         tr([_op("reduce-scatter", 52, [0, 1]),
             _op("reduce-scatter", 26, [0, 2])]),
         tr([_op("reduce-scatter", 52, [0, 1, 2, 3])])),
    ]
    for rule, kind in (("HLO005", "all-gather"), ("HLO006", "all-to-all"),
                       ("HLO007", "collective-permute")):
        op = _op(kind, 64, [0, 1], stream=7, interval=(0.0, 10.0))
        # a compute kernel on the collective's own stream hides nothing
        same = [_kernel("sm90_gemm", 7, 11, 5)]
        cases.append((rule, {}, tr([op], nccl + same),
                      tr([op], nccl + cover)))
    ring = [_op("collective-permute", 64, [0, 1, 2, 3]) for _ in range(6)]
    cases.append(("HLO007", {}, tr(ring[:5], sp=4), tr(ring, sp=4)))
    gather = _op("all-gather", 4096, [0, 1, 2, 3], shape=(2, 16, 4, 8))
    cases.append(("HLO007", {}, tr(ring + [gather], sp=4),
                  tr(ring + [_op("all-gather", 4096, [0, 1, 2, 3])],
                     sp=4)))
    return cases


class TestTraceRules:
    @pytest.mark.parametrize("case", _rule_cases(),
                             ids=[f"{c[0]}-{i}" for i, c in
                                  enumerate(_rule_cases())])
    def test_fires_on_its_case_only(self, case):
        rule, kw, dirty, clean = case
        assert rule in {f.rule for f in L.lint_trace(dirty, **kw)}
        assert L.lint_trace(clean, **kw) == []

    def test_serial_tail_judges_the_last_window(self):
        """Only the last reduce-scatter/all-gather (by device start) is the
        tail; a trace without device intervals returns 0 off the card and
        None on it."""
        early = _op("reduce-scatter", 64, [0, 1], stream=7,
                    interval=(0.0, 10.0))
        late = _op("all-gather", 64, [0, 1], stream=7, interval=(20.0, 30.0))
        tr = T.StepTrace(ops=[early, late], flops_by_op={},
                         memory_high_water_bytes=0,
                         kernels=[_kernel("sm90_gemm", 13, 2, 5)])
        assert T.serial_tail_collectives(tr) == 1
        tr.kernels.append(_kernel("sm90_gemm", 13, 25, 2))
        assert T.serial_tail_collectives(tr) == 0
        tr.ops = [_op("all-gather", 64, [0, 1])]
        assert T.serial_tail_collectives(tr) == 0
        # on a card, a collective without a window leaves it unknown; a
        # group of one moves nothing and is not judged
        tr.device = "cuda:0"
        assert T.serial_tail_collectives(tr) is None
        tr.ops = [_op("all-gather", 64, [0])]
        assert T.serial_tail_collectives(tr) == 0

    def test_ops_placed_by_their_ranges(self):
        """On a card each op's window is the span of the NCCL kernels that
        the host operations in its range launched; a compute kernel
        launched there places nothing, nor does a range without an NCCL
        kernel."""
        spans = {"hvd.trace#op1": [
            _kernel("vectorized_elementwise_kernel", 9, 39, 1),
            _kernel("ncclDevKernel_ReduceScatter", 9, 41, 18)],
            "hvd.trace#op2": [_kernel("sm90_gemm", 7, 45, 10)]}
        ops = [_op("reduce-scatter", 64, [0, 1]),
               _op("all-gather", 64, [0, 1])]
        ops[0].tag, ops[1].tag = "hvd.trace#op1", "hvd.trace#op2"
        T._place_ops(ops, spans)
        assert (ops[0].stream, ops[0].interval) == (9, (41.0, 59.0))
        assert (ops[1].stream, ops[1].interval) == (None, None)

    def test_range_kernels_read_a_real_profile(self):
        """:func:`range_kernels_by_name` reads this torch's kineto events:
        on a CPU profile each ``hvd.trace#`` range is found, with no
        device kernel."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function("hvd.trace#op7"):
                torch.ones(8, 8) @ torch.ones(8, 8)
            torch.ones(4).sum()
        assert T.range_kernels_by_name(prof) == {"hvd.trace#op7": []}

    def test_kernel_links_read_a_real_profile(self):
        """:func:`kernel_links` reads this torch's kineto events: a CPU
        profile links no device kernel."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            torch.ones(8, 8) @ torch.ones(8, 8)
        assert T.kernel_links(prof) == {}

    def test_finding_format(self):
        f = L.TraceFinding("HLO001", "msg", "detail")
        assert f.format() == "HLO001: msg (detail)"
        assert f.as_json() == {"rule": "HLO001", "message": "msg",
                               "detail": "detail"}
