"""Offline lint of a step's record and of bench artifacts: the collective
guards as a rule pack (the counterpart of ``horovod_tpu/analysis/
hlo_lint.py``).

The JAX package lints compiled HLO text; the port lints the record of a
step that ran (``utils/trace.StepTrace``, from
``DistributedTrainStep.trace`` or ``utils/trace.trace_call``, or loaded
from the JSON that :meth:`StepTrace.save` wrote), and the same bench
artifact fields as JAX, with the same dict logic.  Findings keep JAX's
rule ids, so that a trace's findings and an artifact's share one table:

=========  ==============================================================
HLO001     gradient-sized all-reduce in a step that reduce-scatters (the
           sharded exchange regressed to allreduce)
HLO002     an ``async_op=True`` (or p2p) work never waited within the
           recorded call
HLO003     two-level exchange without a low-precision (int8/uint8/fp8)
           collective: the outer hop pays full-width wire bytes.  Both
           packages send the int8 codes as int32, so this fires on the
           int8 wire too, as JAX's does on its compiled step
HLO004     the reduce-scatter scope set against the hierarchy: two_level
           needs two distinct level scopes, flat one
HLO005     serial exchange tail: the last reduce-scatter/all-gather's
           device window has no compute kernel on another stream (or an
           artifact claims ``fused_collectives=on`` with a serial tail)
HLO006     serial MoE dispatch: the same judgment on the last all-to-all
HLO007     serial sp ring hop (the last collective-permute's window),
           any full-sequence all-gather in an sp ring, or fewer than
           ``2·(sp−1)`` ring permutes
=========  ==============================================================

Where they differ from JAX's rules over HLO:

* HLO004 compares level scopes, ``(group size, stride)``: the record knows
  each group's ranks, so the two levels of a ``(2, 2)`` layout, both of 2
  ranks, count as two scopes (JAX's sizes alias them).
* HLO005-HLO007 read device intervals, which only a trace on a card has:
  on gloo or the CPU they do not fire, as JAX's scan does not on a
  synchronous schedule.
* HLO007's all-gather check counts, in a trace of an sp ring, each
  all-gather over ``sp`` ranks of a tensor of two or more dimensions (an
  activation; the gradient exchange gathers flat buffers).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

from horovod_tpu_torch.utils import trace as T

_SCALAR_MAX_BYTES = 256     # "gradient-sized" = anything bigger than this


@dataclasses.dataclass(frozen=True)
class TraceFinding:
    rule: str
    message: str
    detail: str = ""

    def format(self) -> str:
        d = f" ({self.detail})" if self.detail else ""
        return f"{self.rule}: {self.message}{d}"

    def as_json(self) -> dict:
        return dataclasses.asdict(self)


def lint_trace(trace: "T.StepTrace",
               expect_hierarchy: Optional[str] = None,
               grad_bytes: Optional[int] = None) -> List[TraceFinding]:
    """Structural lint of one traced step (JAX ``lint_hlo_text``).

    ``grad_bytes`` (when known) sharpens HLO001 to "all-reduce >= the
    gradient payload"; without it any all-reduce of more than 256 bytes
    in a step that also reduce-scatters counts.  ``expect_hierarchy``
    enables the scope checks (HLO004) and the low-precision outer hop
    (HLO003).  HLO007's count checks read the extent of the sp ring the
    step ran from ``trace.sp``."""
    findings: List[TraceFinding] = []
    ops = trace.ops
    kinds = T.count_by_kind(ops)

    if kinds.get("reduce-scatter", 0) >= 1:
        threshold = grad_bytes if grad_bytes is not None \
            else _SCALAR_MAX_BYTES
        offenders = [o for o in ops if o.kind == "all-reduce"
                     and o.bytes >= threshold]
        if grad_bytes is None:
            offenders = [o for o in offenders
                         if o.bytes > _SCALAR_MAX_BYTES]
        for o in offenders:
            findings.append(TraceFinding(
                "HLO001",
                f"gradient-sized all-reduce ({o.bytes} bytes) in a "
                f"step that reduce-scatters — the sharded exchange "
                f"regressed to allreduce",
                detail=o.line[:160]))

    if trace.unwaited:
        findings.append(TraceFinding(
            "HLO002",
            f"{trace.unwaited} async collective work(s) never waited "
            f"within the traced call"))

    rs_scopes = T.level_scopes_by_kind(ops).get("reduce-scatter", ())
    if expect_hierarchy == "two_level":
        if len(rs_scopes) < 2:
            findings.append(TraceFinding(
                "HLO004",
                f"hierarchy=two_level but reduce-scatter level scopes are "
                f"{rs_scopes} — expected two distinct scopes (local + "
                f"cross); the exchange ran flat"))
        elif not any(o.dtypes & T.LOW_PRECISION for o in ops):
            findings.append(TraceFinding(
                "HLO003",
                "two-level exchange carries no low-precision "
                "(int8/uint8/fp8) collective — the cross hop is paying "
                "full-width wire bytes"))
    elif expect_hierarchy == "flat" and len(rs_scopes) > 1:
        findings.append(TraceFinding(
            "HLO004",
            f"hierarchy=flat but reduce-scatter runs {len(rs_scopes)} "
            f"distinct level scopes {rs_scopes} — expected one"))

    if T.serial_tail_collectives(trace):
        findings.append(TraceFinding(
            "HLO005",
            "serial exchange tail: the last reduce-scatter/all-gather's "
            "device window has no compute kernel on another stream — "
            "the last bucket's wire is fully exposed"))
    if T.serial_tail_collectives(trace, kinds=("all-to-all",)):
        findings.append(TraceFinding(
            "HLO006",
            "serial MoE dispatch: the last all-to-all's device window has "
            "no compute kernel on another stream — the expert exchange is "
            "fully exposed"))
    if T.serial_tail_collectives(trace, kinds=("collective-permute",)):
        findings.append(TraceFinding(
            "HLO007",
            "serial sp ring hop: the last collective-permute's device "
            "window has no compute kernel on another stream — the K/V "
            "exchange is fully exposed"))
    sp = trace.sp
    if sp > 1:
        gathers = [o for o in ops if o.kind == "all-gather"
                   and o.group_size == sp
                   and any(len(dims) >= 2 for _, dims in o.shapes)]
        if gathers:
            findings.append(TraceFinding(
                "HLO007",
                f"sp={sp} ring attention but the step ran "
                f"{len(gathers)} full-sequence all-gather(s) over the sp "
                f"group — the ring degenerated to gather-everything"))
        permutes = kinds.get("collective-permute", 0)
        if permutes < 2 * (sp - 1):
            findings.append(TraceFinding(
                "HLO007",
                f"sp={sp} ring attention ran only {permutes} "
                f"collective-permute(s) — expected >= 2·(sp−1) = "
                f"{2 * (sp - 1)} (K and V each hop sp−1 times)"))
    return findings


# -- bench artifacts: JAX's dict logic, letter for letter --------------------


def _prefixes(artifact: Dict) -> List[str]:
    """Field prefixes present in a bench artifact."""
    out = {""}
    for k in artifact:
        for marker in ("exchange_hierarchy", "overlap_fraction",
                       "exchange_rs_scopes"):
            if k.endswith(marker) and k != marker:
                out.add(k[: -len(marker)])
    return sorted(out)


def lint_artifact(artifact: Dict) -> List[TraceFinding]:
    """Lint the collective-structure fields of one bench artifact (the
    overlap probe's ``as_bench_fields`` among them): JAX's
    ``lint_artifact``, its messages."""
    findings: List[TraceFinding] = []
    for prefix in _prefixes(artifact):
        hierarchy = artifact.get(f"{prefix}exchange_hierarchy")
        rs_scopes = artifact.get(f"{prefix}exchange_rs_scopes")
        grad_ars = artifact.get(f"{prefix}exchange_grad_sized_allreduces")
        label = prefix.rstrip("_") or "default"
        if grad_ars:
            findings.append(TraceFinding(
                "HLO001",
                f"[{label}] artifact reports "
                f"{grad_ars} gradient-sized all-reduce(s) — the "
                f"sharded exchange regressed to allreduce on the wire"))
        if hierarchy == "two_level" and rs_scopes is not None:
            distinct = [s for s in rs_scopes if s is not None]
            if len(distinct) < 2:
                findings.append(TraceFinding(
                    "HLO004",
                    f"[{label}] exchange_hierarchy=two_level but "
                    f"rs scopes are {rs_scopes} — expected two distinct "
                    f"scopes (ici + dcn)"))
        if hierarchy == "flat" and rs_scopes is not None:
            distinct = [s for s in rs_scopes if s is not None]
            if len(distinct) > 1:
                findings.append(TraceFinding(
                    "HLO004",
                    f"[{label}] exchange_hierarchy=flat but rs scopes "
                    f"are {rs_scopes} — expected a single scope"))
        frac = artifact.get(f"{prefix}overlap_fraction")
        if frac is not None and not 0.0 <= float(frac) <= 1.0:
            findings.append(TraceFinding(
                "HLO004",
                f"[{label}] overlap_fraction={frac} out of [0, 1] — "
                f"corrupt probe output"))
        serial = artifact.get(
            f"{prefix}exchange_serial_tail_collectives")
        fused = artifact.get(f"{prefix}fused_collectives")
        if fused == "on" and serial:
            findings.append(TraceFinding(
                "HLO005",
                f"[{label}] fused_collectives=on but the probe still "
                f"found {serial} serial final RS/AG pair(s) — the "
                f"tile-fused exchange is not reaching the wire"))
        moe_serial = artifact.get(
            f"{prefix}moe_serial_tail_alltoalls")
        moe_fused = artifact.get(f"{prefix}moe_fused_collectives")
        moe_ep = artifact.get(f"{prefix}moe_ep")
        if moe_fused == "on" and moe_ep and int(moe_ep) > 1 \
                and moe_serial:
            findings.append(TraceFinding(
                "HLO006",
                f"[{label}] moe_fused_collectives=on for an "
                f"ep={moe_ep} plan but the probe still found "
                f"{moe_serial} serial boundary-wide all-to-all(s) — "
                f"the a2a ⊗ expert-matmul ring is not reaching the "
                f"wire"))
        sp_fused = artifact.get(f"{prefix}sp_fused_collectives")
        sp_ext = artifact.get(f"{prefix}sp")
        if sp_fused == "on" and sp_ext and int(sp_ext) > 1:
            sp_serial = artifact.get(
                f"{prefix}sp_serial_tail_permutes")
            sp_ag = artifact.get(f"{prefix}sp_attention_allgathers")
            sp_perms = artifact.get(f"{prefix}sp_collective_permutes")
            if sp_serial:
                findings.append(TraceFinding(
                    "HLO007",
                    f"[{label}] sp_fused_collectives=on for an "
                    f"sp={sp_ext} plan but the probe still found "
                    f"{sp_serial} serial collective-permute window(s) "
                    f"— the K/V ring is not hiding under the flash "
                    f"compute"))
            if sp_ag:
                findings.append(TraceFinding(
                    "HLO007",
                    f"[{label}] sp={sp_ext} fused ring attention but "
                    f"the probe found {sp_ag} full-sequence "
                    f"all-gather(s) on the attention path — the ring "
                    f"degenerated to gather-everything"))
            if sp_perms is not None and \
                    int(sp_perms) < 2 * (int(sp_ext) - 1):
                findings.append(TraceFinding(
                    "HLO007",
                    f"[{label}] sp={sp_ext} fused ring attention "
                    f"compiled only {sp_perms} collective-permute(s) — "
                    f"expected >= 2·(sp−1) = {2 * (int(sp_ext) - 1)} "
                    f"(K and V each hop sp−1 times)"))
    return findings


def lint_artifact_path(path: str) -> List[TraceFinding]:
    with open(path, "r") as f:
        data = json.load(f)
    # a multi-chip artifact wraps the bench line under "parsed"
    if isinstance(data.get("parsed"), dict):
        data = dict(data, **data["parsed"])
    return lint_artifact(data)


def lint_paths(paths: Sequence[str],
               expect_hierarchy: Optional[str] = None
               ) -> List[TraceFinding]:
    """Lint each file: a trace saved by ``StepTrace.save`` with
    :func:`lint_trace`, any other JSON as a bench artifact.  The port
    writes no HLO text, so any other file raises."""
    findings: List[TraceFinding] = []
    for p in paths:
        if not p.endswith(".json"):
            raise ValueError(f"{p}: the port lints saved traces and bench "
                             f"artifacts, both JSON")
        with open(p, "r") as f:
            data = json.load(f)
        if T.is_trace(data):
            findings.extend(lint_trace(T.StepTrace.from_json(data),
                                       expect_hierarchy=expect_hierarchy))
        else:
            findings.extend(lint_artifact_path(p))
    return findings
