"""Bytes-on-wire scaling model for data-parallel training (a copy of
``horovod_tpu/utils/scaling.py`` over the port's cost model).

Multi-device efficiency is modeled from quantities the repo measures or
pins: the one-device step time, the per-step gradient payload
(:func:`step_payload_bytes`) and the link bandwidths, which come from the
resolved hardware model (:func:`~horovod_tpu_torch.analysis.cost_model.
resolve_hardware_model`: a calibration artifact, a preset, or the H100's
published figures) unless the caller passes them.  The model is the ring
cost: an all-reduce of ``B`` payload bytes over ``N`` devices moves
``2·(N-1)/N·B`` bytes through each device's links; the exposed fraction
after compute/communication overlap sets the efficiency.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Union


def allreduce_wire_bytes(payload_bytes: float, n_chips: int) -> float:
    """Bytes through EACH chip's links for one ring all-reduce of
    ``payload_bytes``: reduce-scatter + all-gather phases each move
    ``(N-1)/N`` of the payload (``2·(N-1)/N·B`` total), the bound of
    NCCL's ring all-reduce.

    This is the single-fabric (flat, full-width) cost; the two-level
    exchange prices per level through
    :func:`exchange_wire_bytes` — the same cost model
    (``analysis/cost_model.py``) both this module and the perf gate
    consume."""
    from horovod_tpu_torch.analysis import cost_model as CM

    return CM.exchange_wire_bytes(payload_bytes, n_dcn=1,
                                  n_ici=n_chips).ici


def exchange_wire_bytes(payload_bytes: float, n_chips: int,
                        hierarchy: str = "flat",
                        n_ici: Optional[int] = None,
                        wire_bits_dcn: int = 8):
    """Per-level per-chip wire bytes of one gradient exchange over
    ``n_chips`` split as ``(n_chips/n_ici) × n_ici`` (dcn × ici) —
    delegated to :func:`~horovod_tpu_torch.analysis.cost_model.\
exchange_wire_bytes`.  With ``hierarchy="two_level"`` the DCN hop
    carries only the ``1/n_ici`` partial-sum shard at ``wire_bits_dcn``
    (the int8 codec of the cross hop).  Returns the cost
    model's ``WireBytes`` (``.ici``/``.dcn``/``.total``)."""
    from horovod_tpu_torch.analysis import cost_model as CM

    if n_ici in (None, 0):
        if hierarchy == "two_level":
            raise ValueError(
                "hierarchy='two_level' needs n_ici (devices per node) "
                "to split the world; pass e.g. n_ici=8 for 8-GPU nodes")
        n_dcn, n_inner = 1, n_chips
    else:
        if n_chips % n_ici:
            raise ValueError(
                f"n_chips={n_chips} is not divisible by n_ici={n_ici}")
        n_dcn, n_inner = n_chips // n_ici, n_ici
    return CM.exchange_wire_bytes(payload_bytes, n_dcn=n_dcn,
                                  n_ici=n_inner, hierarchy=hierarchy,
                                  wire_bits_dcn=wire_bits_dcn)


def step_payload_bytes(params) -> int:
    """Per-step all-reduce payload of a model's parameters (a module, or
    an iterable of tensors): every gradient at its parameter's width, plus
    the 4-byte scalar loss."""
    tensors = params.parameters() if hasattr(params, "parameters") \
        else params
    return sum(t.numel() * t.element_size() for t in tensors) + 4


def overlap_fraction_from_artifact(
        artifact: Union[str, os.PathLike, dict],
        prefix: str = "") -> Optional[float]:
    """The MEASURED ``overlap_fraction`` out of a BENCH artifact — a
    ``BENCH_r0N.json`` path (one JSON object on its first line, the
    ``bench.py --json-out`` format) or the already-parsed dict.  The
    field is what ``utils/overlap_probe.py`` measured for that run's
    gradient exchange; ``prefix`` selects a per-model variant (e.g.
    ``"resnet_"``).  Returns None when the artifact has no probe field
    (``--no-overlap-probe`` runs) — callers then fall back to the
    pinned default, never to a silently-invented constant."""
    if not isinstance(artifact, dict):
        with open(artifact) as f:
            artifact = json.loads(f.readline())
    val = artifact.get(prefix + "overlap_fraction")
    return None if val is None else float(val)


def resolve_overlap_fraction(
        overlap_fraction: Optional[float] = None,
        artifact: Union[str, os.PathLike, dict, None] = None,
        prefix: str = "") -> float:
    """The model's one load-bearing assumption, resolved: an explicit
    value wins; else the artifact's measured probe value; else 0.0 —
    the fully-exposed worst case, the only defensible *assumption*
    (VERDICT round 5: the overlap constant must be measured, not
    assumed)."""
    if overlap_fraction is not None:
        return float(overlap_fraction)
    if artifact is not None:
        measured = overlap_fraction_from_artifact(artifact, prefix)
        if measured is not None:
            return measured
    return 0.0


def hierarchy_from_artifact(
        artifact: Union[str, os.PathLike, dict],
        prefix: str = "") -> Optional[str]:
    """The exchange topology a BENCH artifact ran
    (``{prefix}exchange_hierarchy``, emitted by the overlap probe), or
    None when the run had no sharded exchange."""
    if not isinstance(artifact, dict):
        with open(artifact) as f:
            artifact = json.loads(f.readline())
    val = artifact.get(prefix + "exchange_hierarchy")
    return None if val is None else str(val)


def resolve_exchange_hierarchy(hierarchy: Optional[str] = None,
                               artifact=None, prefix: str = "") -> str:
    """Same precedence discipline as
    :func:`resolve_overlap_fraction`: an explicit mode wins, else the
    artifact's measured ``exchange_hierarchy``, else ``"flat"`` — the
    conservative (most wire) assumption, never a silently-invented
    topology."""
    if hierarchy is not None:
        if hierarchy not in ("flat", "two_level"):
            raise ValueError(f"hierarchy must be flat|two_level, got "
                             f"{hierarchy!r}")
        return hierarchy
    if artifact is not None:
        measured = hierarchy_from_artifact(artifact, prefix)
        if measured is not None:
            return measured
    return "flat"


@dataclasses.dataclass
class ScalingPoint:
    n_chips: int
    comm_time_s: float        # full (unoverlapped) wire time
    exposed_time_s: float     # comm left over after overlap
    efficiency: float         # step_time / (step_time + exposed)
    hierarchy: str = "flat"   # exchange topology the wire was priced at
    wire_bytes_ici: float = 0.0   # per-chip bytes on the ICI fabric
    wire_bytes_dcn: float = 0.0   # per-chip bytes crossing DCN


def scaling_efficiency(step_time_s: float,
                       payload_bytes: float,
                       n_chips: int,
                       link_bytes_per_s: Optional[float] = None,
                       overlap_fraction: Optional[float] = None,
                       artifact=None,
                       artifact_prefix: str = "",
                       hierarchy: Optional[str] = None,
                       n_ici: Optional[int] = None,
                       dcn_bytes_per_s: Optional[float] = None,
                       wire_bits_dcn: int = 8) -> ScalingPoint:
    """Modeled weak-scaling efficiency at ``n_chips``.

    ``overlap_fraction`` is how much of the collective hides under
    compute.  Pass a value to pin it, or pass ``artifact=`` (a BENCH
    JSON path/dict) to use the run's MEASURED ``overlap_fraction``
    from ``utils/overlap_probe.py`` — the model no longer invites an
    assumed constant where a measurement exists.  With neither, the
    fully-exposed worst case (0.0) applies: collective serial after
    the backward pass.  Efficiency is per-step throughput relative to
    the single-chip rate: ``t / (t + exposed)``.

    The wire is priced by the cost model
    (``analysis/cost_model.py``), hierarchy-aware: with ``n_ici``
    (chips per slice) the mesh factors into ``(n_chips/n_ici) ×
    n_ici`` and each level pays its own fabric — ICI at
    ``link_bytes_per_s``, DCN at ``dcn_bytes_per_s`` — with
    ``hierarchy="two_level"`` crossing DCN at ``wire_bits_dcn`` on the
    ``1/n_ici`` shard (the int8 DCN codec).  ``hierarchy`` resolves
    like overlap: explicit > the artifact's measured
    ``exchange_hierarchy`` > ``"flat"``.  Without ``n_ici`` the mesh
    is a single ICI domain — exactly the old flat model.  Unset,
    ``link_bytes_per_s`` and ``dcn_bytes_per_s`` are the resolved
    hardware model's ``ici_bytes_per_s`` and ``dcn_bytes_per_s``.
    """
    if link_bytes_per_s is None or dcn_bytes_per_s is None:
        from horovod_tpu_torch.analysis import cost_model as CM

        hw = CM.resolve_hardware_model()
        link_bytes_per_s = link_bytes_per_s or hw.ici_bytes_per_s
        dcn_bytes_per_s = dcn_bytes_per_s or hw.dcn_bytes_per_s
    overlap = resolve_overlap_fraction(overlap_fraction, artifact,
                                       artifact_prefix)
    mode = resolve_exchange_hierarchy(hierarchy, artifact,
                                      artifact_prefix)
    wire = exchange_wire_bytes(payload_bytes, n_chips, hierarchy=mode,
                               n_ici=n_ici,
                               wire_bits_dcn=wire_bits_dcn)
    comm = wire.ici / link_bytes_per_s + wire.dcn / dcn_bytes_per_s
    exposed = comm * (1.0 - overlap)
    return ScalingPoint(
        n_chips=n_chips, comm_time_s=comm, exposed_time_s=exposed,
        efficiency=step_time_s / (step_time_s + exposed),
        hierarchy=mode, wire_bytes_ici=wire.ici,
        wire_bytes_dcn=wire.dcn)


def efficiency_curve(step_time_s: float, payload_bytes: float,
                     chip_counts=(8, 16, 32, 64),
                     link_bytes_per_s: Optional[float] = None,
                     overlap_fraction: Optional[float] = None,
                     artifact=None,
                     artifact_prefix: str = "",
                     hierarchy: Optional[str] = None,
                     n_ici: Optional[int] = None,
                     dcn_bytes_per_s: Optional[float] = None,
                     wire_bits_dcn: int = 8):
    """One :class:`ScalingPoint` per chip count (docs/scaling.md
    table); ``artifact=`` sources the measured overlap AND exchange
    hierarchy exactly as in :func:`scaling_efficiency`, and ``n_ici``
    makes every point a two-fabric ``(n/n_ici) × n_ici`` mesh."""
    return [scaling_efficiency(step_time_s, payload_bytes, n,
                               link_bytes_per_s, overlap_fraction,
                               artifact, artifact_prefix,
                               hierarchy=hierarchy, n_ici=n_ici,
                               dcn_bytes_per_s=dcn_bytes_per_s,
                               wire_bits_dcn=wire_bits_dcn)
            for n in chip_counts]
