"""Measured comm/compute overlap of the sharded gradient exchange
(``horovod_tpu/utils/overlap_probe.py``).

The scaling model (``utils/scaling.py``) needs an ``overlap_fraction``:
how much of the gradient exchange hides under backward.  This probe
measures it on the devices of the ``hvd.init()`` world, with three
programs over the same model, batch and parameters:

* **backward only**: forward and backward, the gradients consumed locally
  by an fp32 fingerprint (the sum of their ``abs`` sums, :func:`fingerprint`),
  no collective;
* **exchange only**: the bucketed reduce-scatter then all-gather of the
  sharded exchange on gradient-shaped tensors computed once beforehand,
  so that its time holds no backward work;
* **fused**: backward followed by the exchange, issued as the port's
  sharded ``step()`` issues it.

Each program ends in one fingerprint pass and one host read.  A fourth
program, the fingerprint of the gradients alone, times that pass and
read, and its median is taken out of the three: otherwise the two
programs apart would pay for it twice and the fused one once, and the
difference would read as hidden exchange.

The port runs the sharded exchange inside ``step()``, after backward,
so the fused program runs the two one after the other and invents no
overlapping schedule the step does not run: the fraction it measures is
that of the step as it is.  If nothing hides, ``t_fused ≈ t_backward +
t_exchange``; if the shorter phase hides completely under the longer,
``t_fused ≈ max(t_backward, t_exchange)``.  The fraction is::

    overlap = (t_backward + t_exchange - t_fused) / min(t_backward,
                                                        t_exchange)

clamped to [0, 1], each time without the fingerprint's.  Each call is
fenced by a host read of its fingerprint scalar and timed with ``time.perf_counter``; the median of ``iters``
calls after ``warmup`` is kept, on the CPU and on the card alike.  At a
world of one the exchange moves no bytes across devices: its time is the
packing and unpacking of the buckets, and the fraction means little.

Where JAX reads the exchange's structure from the compiled HLO, the port
records the collectives that one call of the exchange-only program makes
(:func:`~horovod_tpu_torch.utils.trace.record_collectives`): the distinct
group sizes of its reduce-scatters and all-gathers, its all-reduces of at
least the gradient payload, and its wire bytes by level (the cost model's
``collective_wire_by_level``: the innermost level under JAX's ``ici``,
the outer levels summed under ``dcn``).  ``serial_tail_collectives`` is
read from one call of the fused program under the record and the profiler
(``utils/trace.trace_collectives``), as JAX reads it from the fused
program's HLO: 0 where no collective ran on a device (gloo, the CPU);
None on a card where a reduce-scatter or all-gather got no device window.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from horovod_tpu_torch.ops import collectives as C
from horovod_tpu_torch.ops.collectives import Average, ReduceOp
from horovod_tpu_torch.ops.fused_collectives import resolve_fused_collectives
from horovod_tpu_torch.runtime import state
from horovod_tpu_torch.runtime.topology import TreeLayout
from horovod_tpu_torch.utils import trace as T


@dataclasses.dataclass
class OverlapReport:
    """One probe run: the three phase timings, the derived overlap, and,
    for the two-level and tree exchanges, the innermost level's time and
    the outer remainder, beside the structure of the exchange's recorded
    collectives (JAX ``OverlapReport``; ``device`` names where it ran)."""

    backward_s: float
    exchange_s: float
    fused_s: float
    overlap_fraction: float
    world: int
    payload_bytes: int
    hierarchy: str = "flat"
    # exchange time left exposed past backward: max(0, fused_s -
    # backward_s); 0 = the wire hid completely
    tail_exchange_s: float = 0.0
    # the final bucket's schedule: the port's sharded exchange has no
    # tile-fused tail, so always "off"
    fused_collectives: str = "off"
    # 1 when the fused program's last RS/AG ran on the device with no
    # compute beside it (JAX's HLO scan of the same program), else 0
    serial_tail_collectives: Optional[int] = None
    # two-level and tree: the innermost level's share of the exchange
    # time and the outer remainder (clamped at 0) — measured, not modeled
    exchange_intra_s: Optional[float] = None
    exchange_cross_s: Optional[float] = None
    # the recorded exchange: kind → distinct group sizes
    rs_scopes: tuple = ()
    ag_scopes: tuple = ()
    grad_sized_allreduces: int = 0
    # wire bytes of the recorded collectives: the innermost level (or the
    # flat world) under JAX's "ici" name, the outer levels under "dcn"
    wire_bytes_ici: Optional[int] = None
    wire_bytes_dcn: Optional[int] = None
    # where the probe ran ("cuda:0", "cpu"); not a bench field
    device: str = ""
    # the median of the fingerprint pass and host read alone, taken out
    # of backward_s, exchange_s and fused_s; not a bench field
    fingerprint_s: float = 0.0

    def as_bench_fields(self, prefix: str = "") -> dict:
        """The fields a bench artifact carries, JAX's names letter for
        letter (``utils/scaling.overlap_fraction_from_artifact`` reads
        them)."""
        fields = {
            f"{prefix}overlap_fraction": round(self.overlap_fraction, 4),
            f"{prefix}overlap_backward_s": round(self.backward_s, 6),
            f"{prefix}overlap_exchange_s": round(self.exchange_s, 6),
            f"{prefix}overlap_fused_s": round(self.fused_s, 6),
            f"{prefix}tail_exchange_s": round(self.tail_exchange_s, 6),
            f"{prefix}exchange_hierarchy": self.hierarchy,
            f"{prefix}fused_collectives": self.fused_collectives,
        }
        if self.serial_tail_collectives is not None:
            fields[f"{prefix}exchange_serial_tail_collectives"] = \
                int(self.serial_tail_collectives)
        if self.exchange_intra_s is not None:
            fields[f"{prefix}overlap_exchange_intra_s"] = \
                round(self.exchange_intra_s, 6)
            fields[f"{prefix}overlap_exchange_cross_s"] = \
                round(self.exchange_cross_s, 6)
        if self.rs_scopes:
            fields[f"{prefix}exchange_rs_scopes"] = list(self.rs_scopes)
            fields[f"{prefix}exchange_grad_sized_allreduces"] = \
                int(self.grad_sized_allreduces)
        if self.wire_bytes_ici is not None:
            fields[f"{prefix}exchange_wire_bytes_ici"] = \
                int(self.wire_bytes_ici)
            fields[f"{prefix}exchange_wire_bytes_dcn"] = \
                int(self.wire_bytes_dcn or 0)
        return fields


def _median_time(fn: Callable[[], torch.Tensor], iters: int,
                 warmup: int) -> float:
    """Median seconds of ``iters`` calls of ``fn`` after ``warmup``, each
    fenced by a host read of the scalar it returns."""
    for _ in range(warmup):
        float(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        float(fn())             # host read = fence
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def fingerprint(tensors) -> torch.Tensor:
    """The fp32 sum of the tensors' ``abs`` sums: a scalar that consumes
    every element (JAX's ``fingerprint``).  Each tensor's is its L1 norm
    accumulated in fp32, one read of it and no temporary, so that the
    fingerprint each program ends in costs as little as it can."""
    return torch.stack([torch.linalg.vector_norm(t, 1, dtype=torch.float32)
                        for t in tensors]).sum()


@dataclasses.dataclass
class OverlapPrograms:
    """The probe's programs over one model, batch and exchange (each call
    returns its fingerprint scalar, not yet read on the host), with the
    gradients the exchange-only program takes and the resolved exchange."""

    backward_only: Callable[[], torch.Tensor]
    exchange_only: Callable[[], torch.Tensor]
    fused: Callable[[], torch.Tensor]
    # the fingerprint of ``grads`` alone, which each program ends in
    fingerprint_only: Callable[[], torch.Tensor]
    # the innermost level alone; None when flat
    intra_only: Optional[Callable[[], torch.Tensor]]
    grads: List[torch.Tensor]
    mode: str
    levels: Optional[tuple]
    spec: C.FusionSpec
    payload_bytes: int


def overlap_programs(loss_fn: Callable, params: torch.nn.Module, batch,
                     axis: Optional[TreeLayout] = None,
                     op: ReduceOp = Average,
                     bucket_bytes: Optional[int] = None,
                     hierarchy: str = "auto") -> OverlapPrograms:
    """Build :func:`measure_overlap`'s programs (arguments as there);
    computes the gradients once.  Every rank must call it together: it
    makes the exchange's process groups."""
    from horovod_tpu_torch.optim.optimizer import sharded_exchange_levels

    st = state.global_state()
    trainable = [p for p in params.parameters() if p.requires_grad]
    if not trainable:
        raise ValueError("measure_overlap needs a parameter that requires "
                         "a gradient")
    wrong = {str(p.device) for p in trainable
             if p.device.type != st.device.type}
    if wrong:
        raise ValueError(f"the model lies on {sorted(wrong)} and the "
                         f"runtime on {st.device}: measure_overlap runs "
                         f"where hvd.init() put the world")
    mode, levels = sharded_exchange_levels(hierarchy, axis)

    def grads_of() -> List[torch.Tensor]:
        loss = loss_fn(params, batch)
        return list(torch.autograd.grad(loss, trainable))

    grads = [g.detach() for g in grads_of()]
    spec = C.make_fusion_spec(grads, st.size, bucket_bytes)

    @torch.no_grad()
    def exchange(gs) -> List[torch.Tensor]:
        if levels is None:
            shards, _ = C.grouped_reducescatter(gs, op=op, spec=spec)
            return C.grouped_allgather(shards, spec)
        shards, _ = C.tree_reducescatter(gs, levels, op=op, spec=spec)
        return C.tree_allgather(shards, spec, levels)

    intra_only = None
    if levels is not None:
        inner = levels[:1]
        inner_spec = C.make_fusion_spec(grads, inner[0].extent,
                                        bucket_bytes)

        @torch.no_grad()
        def intra_only() -> torch.Tensor:
            shards, _ = C.tree_reducescatter(grads, inner, op=op,
                                             spec=inner_spec)
            return fingerprint(C.tree_allgather(shards, inner_spec, inner))

    return OverlapPrograms(
        backward_only=lambda: fingerprint(grads_of()),
        exchange_only=lambda: fingerprint(exchange(grads)),
        fused=lambda: fingerprint(exchange(grads_of())),
        fingerprint_only=lambda: fingerprint(grads),
        intra_only=intra_only, grads=grads, mode=mode, levels=levels,
        spec=spec,
        payload_bytes=sum(g.numel() * g.element_size() for g in grads))


def measure_overlap(loss_fn: Callable,
                    params: torch.nn.Module,
                    batch,
                    axis: Optional[TreeLayout] = None,
                    op: ReduceOp = Average,
                    bucket_bytes: Optional[int] = None,
                    hierarchy: str = "auto",
                    fused_collectives: str = "off",
                    iters: int = 5,
                    warmup: int = 2) -> OverlapReport:
    """Measure the backward, exchange and fused timings of ``loss_fn`` on
    the ``hvd.init()`` world and return the achieved overlap fraction
    (JAX ``measure_overlap``, its keyword names).

    ``loss_fn(params, batch)`` takes the module and this rank's batch and
    returns the scalar loss, as ``DistributedTrainStep``'s ``loss_fn``
    does; ``params`` is the module, replicated, on the runtime's device
    (the card unless ``hvd.init(device="cpu")`` asked for the CPU);
    ``batch`` is this rank's shard (``step.shard_batch``).  The gradients
    are taken with ``torch.autograd.grad``, which fires no hook of a
    wrapping ``DistributedOptimizer``.

    The exchange is the sharded ``step()``'s, resolved as
    ``DistributedOptimizer(shard_optimizer_states=True, axis=axis,
    hierarchy=hierarchy, exchange_bucket_bytes=bucket_bytes)`` resolves
    it (``optim/optimizer.sharded_exchange_levels``): ``axis`` is the
    world (None, its ``(cross, local)`` layout) or a
    :class:`~horovod_tpu_torch.runtime.topology.TreeLayout`.  Two-level
    and tree runs also time the innermost level alone; the outer
    remainder is the difference, clamped at 0.  Each time is taken without
    the fingerprint pass and host read that its program ends in (the
    median of that pass alone, :attr:`OverlapReport.fingerprint_s`).
    ``fused_collectives`` is
    checked, as the sharded wrapper checks it; the port's exchange has no
    tile-fused tail, so the report says ``"off"``.  Every rank must call
    it together."""
    resolve_fused_collectives(fused_collectives)
    pr = overlap_programs(loss_fn, params, batch, axis=axis, op=op,
                          bucket_bytes=bucket_bytes, hierarchy=hierarchy)
    from horovod_tpu_torch.analysis import cost_model as CM

    with T.record_collectives() as rec:
        pr.exchange_only()
    scopes = T.scopes_by_kind(rec.ops)
    levels = [(f"level{i}", lv.extent) for i, lv in enumerate(pr.levels)] \
        if pr.levels is not None else [("flat", state.global_state().size)]
    by_level = list(CM.collective_wire_by_level(
        rec.ops, topology=levels).values())
    wire = {"ici": by_level[0], "dcn": sum(by_level[1:])}
    grad_ars = sum(1 for o in rec.ops
                   if o.kind == "all-reduce" and o.bytes >= pr.payload_bytes)
    serial_tail = T.serial_tail_collectives(
        T.trace_collectives(pr.fused)[1])

    # each program's time without the fingerprint pass and host read it
    # ends in
    t_fp = _median_time(pr.fingerprint_only, iters, warmup)
    t_bwd = max(0.0, _median_time(pr.backward_only, iters, warmup) - t_fp)
    t_exc = max(0.0, _median_time(pr.exchange_only, iters, warmup) - t_fp)
    t_fsd = max(0.0, _median_time(pr.fused, iters, warmup) - t_fp)
    t_intra = t_cross = None
    if pr.intra_only is not None:
        t_intra = max(0.0, _median_time(pr.intra_only, iters, warmup) - t_fp)
        t_cross = max(0.0, t_exc - t_intra)

    saved = t_bwd + t_exc - t_fsd
    denom = min(t_bwd, t_exc)
    frac = float(np.clip(saved / denom if denom > 0 else 0.0, 0.0, 1.0))
    tail_s = max(0.0, t_fsd - t_bwd)
    _publish(t_exc, t_intra, t_cross, frac, tail_s, wire)
    return OverlapReport(
        backward_s=t_bwd, exchange_s=t_exc, fused_s=t_fsd,
        overlap_fraction=frac, world=state.global_state().size,
        payload_bytes=int(pr.payload_bytes), hierarchy=pr.mode,
        tail_exchange_s=tail_s, fused_collectives="off",
        serial_tail_collectives=serial_tail,
        exchange_intra_s=t_intra, exchange_cross_s=t_cross,
        rs_scopes=scopes.get("reduce-scatter", ()),
        ag_scopes=scopes.get("all-gather", ()),
        grad_sized_allreduces=grad_ars,
        wire_bytes_ici=int(wire["ici"]), wire_bytes_dcn=int(wire["dcn"]),
        device=str(state.global_state().device), fingerprint_s=t_fp)


def _publish(t_exc: float, t_intra: Optional[float],
             t_cross: Optional[float], frac: float, tail_s: float,
             wire: dict) -> None:
    """The probe's gauges, when telemetry is on (JAX's names, labels and
    help strings; the levels are the port's ``local`` and ``cross``)."""
    from horovod_tpu_torch import telemetry

    if not telemetry.enabled():
        return
    tg = telemetry.gauge("hvd_exchange_time_seconds",
                         "measured gradient-exchange time per level")
    tg.set(t_exc, level="total")
    if t_intra is not None:
        tg.set(t_intra, level="local")
        tg.set(t_cross, level="cross")
    telemetry.gauge("hvd_overlap_fraction",
                    "measured comm/compute overlap fraction").set(frac)
    telemetry.gauge(
        "hvd_tail_exchange_seconds",
        "exchange time left exposed past backward compute").set(
            tail_s, fused="off")
    wg = telemetry.gauge("hvd_exchange_measured_wire_bytes",
                         "per-level wire bytes of the compiled exchange")
    wg.set(wire["ici"], level="local")
    wg.set(wire["dcn"], level="cross")
