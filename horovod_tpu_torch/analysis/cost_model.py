"""Cost model of the port: the hardware model, the exchange's wire bytes
per level, a traced step's cost, plan pricing, the plan's memory
high-water and the schedule scorers (layers 1 and 2 and the plan, memory
and scoring parts of ``horovod_tpu/analysis/cost_model.py``), all without
a device.

Layer 1 (``module_cost``, ``collective_wire_by_level``) reads a step's
record (``utils/trace.StepTrace``) where the JAX module parses XLA's HLO
text.  The JAX module's layer 3, the roofline calibrated from the repo's
TPU bench artifacts, is not ported.

Hardware presets.  The port carries two: :data:`H100` and
:data:`CPU_TWIN`; the JAX package's ``v5e``/``v5p``/``v4`` are TPU
figures and are not here, so ``HOROVOD_HW_PRESET=v5e`` raises, naming
the presets the port has.  :func:`resolve_hardware_model` prefers a
calibration artifact (``HOROVOD_CALIBRATION_PATH``, made by
:func:`~horovod_tpu_torch.analysis.calibration.measure_artifact`), then
a named preset, then the preset of ``torch.cuda.get_device_name()``,
then :data:`H100`.

The level names keep the JAX package's fields: ``ici`` is the fabric
inside a node (NVLink between the cards of one host: the layout's
``local`` level) and ``dcn`` the network between nodes (the ``cross``
level).

Stdlib only at import: nothing here imports torch; layer 1 reads the
stride of a recorded group through ``utils/trace`` when it is called.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

# -- hardware ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Per-device roofline constants for one accelerator."""

    name: str
    peak_flops_per_s: float     # bf16 matmul peak
    hbm_bytes_per_s: float      # device memory bandwidth
    ici_bytes_per_s: float      # per-device link budget inside a node
    dcn_bytes_per_s: float      # per-device network budget between nodes
    #: per-device memory capacity: the default feasibility ceiling when
    #: HOROVOD_HBM_BUDGET_BYTES is unset; None = unconstrained
    hbm_capacity_bytes: Optional[float] = None

    @staticmethod
    def from_calibration(artifact: Union["os.PathLike", str, Dict]
                         ) -> "HardwareModel":
        """Build a hardware model from a calibration artifact (path or
        already-loaded dict).

        The roofline constants come from the measured fits: the matmul
        FLOP rate and the memory stream rate directly, the fabric
        bandwidths from the innermost/outermost level's fitted
        reduce-scatter beta.  The memory capacity is inherited from the
        builtin preset of the calibrated ``device_kind`` (None when the
        kind is unknown: feasibility then falls back to the explicit
        budget knob)."""
        if not isinstance(artifact, dict):
            with open(os.fspath(artifact)) as f:
                artifact = json.load(f)
        errs = _calibration_schema_errors(artifact)
        if errs:
            raise ValueError(
                "bad calibration artifact: " + "; ".join(errs))
        bw = calibration_level_bandwidths(artifact)
        order = list(artifact["level_order"])
        kind = str(artifact.get("device_kind", ""))
        preset = preset_for_device_kind(kind, warn=False)
        return HardwareModel(
            name=f"calibrated:{kind or 'unknown'}",
            peak_flops_per_s=float(artifact["matmul_flops_per_s"]),
            hbm_bytes_per_s=float(artifact["hbm_bytes_per_s"]),
            ici_bytes_per_s=bw[order[0]],
            dcn_bytes_per_s=bw[order[-1]],
            hbm_capacity_bytes=(preset.hbm_capacity_bytes
                                if preset is not None else None))


#: NVIDIA H100 SXM5 (80 GB HBM3), NVIDIA's published figures: 989 dense
#: bf16 TFLOP/s, 3.35 TB/s HBM3, NVLink 4 at 900 GB/s a GPU (450 GB/s
#: each way, what a ring moves), and one 400 Gb/s NDR InfiniBand port a
#: GPU between nodes (50 GB/s), as a DGX H100 has.  The capacity is what
#: ``torch.cuda.get_device_properties(0).total_memory`` reports on an
#: "NVIDIA H100 80GB HBM3" at a 700.00 W power limit (``nvidia-smi
#: --query-gpu=name,power.limit``), read by ``chip_smoke.py``.
H100 = HardwareModel(name="h100", peak_flops_per_s=989e12,
                     hbm_bytes_per_s=3.35e12, ici_bytes_per_s=450e9,
                     dcn_bytes_per_s=50e9,
                     hbm_capacity_bytes=85_017_493_504)

#: The CPU twin: order-of-magnitude figures for the host the tests run
#: on, so that device-keyed selection has somewhere warning-free to land
#: off the card.
CPU_TWIN = HardwareModel(name="cpu-twin", peak_flops_per_s=1e12,
                         hbm_bytes_per_s=50e9, ici_bytes_per_s=10e9,
                         dcn_bytes_per_s=1e9, hbm_capacity_bytes=None)

#: Builtin presets by name: the ``HOROVOD_HW_PRESET`` vocabulary.
HW_PRESETS: Dict[str, HardwareModel] = {"h100": H100, "cpu-twin": CPU_TWIN}

#: Device-name substrings (``torch.cuda.get_device_name()``, or "cpu")
#: -> preset name, checked in order; the first match wins.
_DEVICE_KIND_PRESETS: Tuple[Tuple[str, str], ...] = (
    ("h100", "h100"),
    ("cpu", "cpu-twin"),
)


def preset_for_device_kind(device_kind: Optional[str],
                           warn: bool = True
                           ) -> Optional[HardwareModel]:
    """The builtin :class:`HardwareModel` for one device name, or ``None``
    for an unrecognized device, after a loud :class:`UserWarning`
    (``warn=True``): an unknown device must not silently price as an
    H100 (calibrate it instead)."""
    kind = (device_kind or "").lower()
    for needle, name in _DEVICE_KIND_PRESETS:
        if needle in kind:
            return HW_PRESETS[name]
    if warn and device_kind:
        warnings.warn(
            f"unrecognized device_kind {device_kind!r}: no builtin "
            f"HardwareModel preset — run calibration.measure_artifact and "
            f"set HOROVOD_CALIBRATION_PATH (or force one of "
            f"{sorted(HW_PRESETS)} via HOROVOD_HW_PRESET); pricing "
            f"falls back to h100 constants until then",
            UserWarning, stacklevel=2)
    return None


def _local_device_kind() -> Optional[str]:
    """``torch.cuda.get_device_name(0)`` when torch is loaded and sees a
    card, else None (this module imports no torch itself)."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(0)


def resolve_hardware_model(calibration_path: Optional[str] = None,
                           preset: Optional[str] = None,
                           device_kind: Optional[str] = None,
                           default: Optional[HardwareModel] = None
                           ) -> HardwareModel:
    """Resolve the hardware model every pricing consumer should use:

    1. a calibration artifact: ``calibration_path``, else the
       ``HOROVOD_CALIBRATION_PATH`` knob (an unreadable or invalid
       artifact raises);
    2. a named preset: ``preset``, else ``HOROVOD_HW_PRESET`` (an unknown
       name raises, naming the port's presets);
    3. the builtin preset matching ``device_kind``, which defaults to the
       name of the card torch sees (unrecognized names warn and fall
       through);
    4. ``default`` (:data:`H100`).
    """
    path = calibration_path or os.environ.get("HOROVOD_CALIBRATION_PATH")
    if path:
        try:
            return HardwareModel.from_calibration(path)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            raise ValueError(
                f"HOROVOD_CALIBRATION_PATH={path!r} does not load as a "
                f"calibration artifact: {e}") from e
    name = preset or os.environ.get("HOROVOD_HW_PRESET")
    if name:
        hw = HW_PRESETS.get(name.strip().lower())
        if hw is None:
            raise ValueError(
                f"unknown HOROVOD_HW_PRESET {name!r}: expected one of "
                f"{sorted(HW_PRESETS)}")
        return hw
    kind = device_kind or _local_device_kind()
    if kind:
        hw = preset_for_device_kind(kind)
        if hw is not None:
            return hw
    return H100 if default is None else default


# -- calibration-artifact plumbing (the fits live in analysis/
#    calibration.py; the consumers here read artifacts directly so the
#    import stays one-way) ---------------------------------------------------


#: Fields every calibration artifact must carry.
CALIBRATION_SCHEMA_VERSION = 1
_CALIBRATION_REQUIRED = (
    "schema_version", "kind", "device_kind", "platform", "n_devices",
    "mesh_shape", "level_order", "levels", "matmul_flops_per_s",
    "hbm_bytes_per_s", "source",
)
#: Identity fields whose digest keys an artifact to its hardware: two
#: artifacts calibrated on different hardware are never compared.
CALIBRATION_IDENTITY_FIELDS = (
    "device_kind", "platform", "n_devices", "mesh_shape",
)


def _calibration_schema_errors(data: Dict) -> List[str]:
    """Schema errors of one calibration-artifact dict ([] = valid).
    The full check (per-level fit fields) lives in
    ``analysis/calibration.validate_calibration``; this is the subset
    the consumers need before trusting the numbers."""
    errs = []
    if not isinstance(data, dict):
        return ["artifact is not a JSON object"]
    for f in _CALIBRATION_REQUIRED:
        if f not in data:
            errs.append(f"missing field {f!r}")
    if errs:
        return errs
    if data["kind"] != "horovod_calibration":
        errs.append(f"kind must be 'horovod_calibration', got "
                    f"{data['kind']!r}")
    if int(data["schema_version"]) > CALIBRATION_SCHEMA_VERSION:
        errs.append(
            f"schema_version {data['schema_version']} is newer than "
            f"this reader ({CALIBRATION_SCHEMA_VERSION})")
    order = data["level_order"]
    if not order or not isinstance(order, (list, tuple)):
        errs.append("level_order must be a non-empty list "
                    "(innermost level first)")
    elif set(order) != set(data["levels"].keys()):
        errs.append(f"level_order {list(order)} does not match levels "
                    f"{sorted(data['levels'])}")
    for val in ("matmul_flops_per_s", "hbm_bytes_per_s"):
        try:
            if float(data[val]) <= 0:
                errs.append(f"{val} must be > 0")
        except (TypeError, ValueError):
            errs.append(f"{val} is not a number")
    return errs


def calibration_fingerprint(data: Dict) -> str:
    """Stable identity digest of one calibration artifact
    (:data:`CALIBRATION_IDENTITY_FIELDS`)."""
    import hashlib

    ident = {f: data.get(f) for f in CALIBRATION_IDENTITY_FIELDS}
    blob = json.dumps(ident, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def calibration_level_bandwidths(data: Dict) -> Dict[str, float]:
    """Fitted bytes/s per topology level from one calibration artifact:
    the reduce-scatter beta when present (the collective the exchange
    composes), else the first fitted collective at that level."""
    out: Dict[str, float] = {}
    for name in data["level_order"]:
        fits = data["levels"][name].get("collectives", {})
        fit = fits.get("reduce_scatter") or next(iter(fits.values()), None)
        if fit is None:
            raise ValueError(f"calibration level {name!r} carries no "
                             f"collective fits")
        out[name] = float(fit["beta_bytes_per_s"])
    return out


# -- exchange wire bytes per level ------------------------------------------


def _ring_factor(n: int) -> float:
    return (n - 1) / n if n > 1 else 0.0


@dataclasses.dataclass(frozen=True)
class WireBytes:
    """Per-chip bytes on each fabric level for one gradient exchange
    (reduce-scatter + allgather, i.e. one logical allreduce)."""

    ici: float
    dcn: float

    @property
    def total(self) -> float:
        return self.ici + self.dcn


def exchange_wire_bytes(payload_bytes: float,
                        n_dcn: int = 1,
                        n_ici: int = 1,
                        hierarchy: str = "flat",
                        wire_bits_dcn: int = 8,
                        elem_bits: int = 32) -> WireBytes:
    """Price one full gradient exchange per fabric level.

    Both modes decompose hierarchically, as the layout's ``local`` and
    ``cross`` groups do: a ring over ``n_ici`` devices inside a node and
    a ring over ``n_dcn`` nodes, each costing ``2·(n−1)/n·(bytes
    carried)`` per device.

    * ``flat``: the DCN hop carries the **full** payload at the element
      width — ``2·(n_dcn−1)/n_dcn·B``.
    * ``two_level``: the intra-slice reduce-scatter leaves only the
      ``1/n_ici`` partial-sum shard to cross DCN, quantized to
      ``wire_bits_dcn`` (int8 by default — the PR 2 DCN codec):
      ``2·(n_dcn−1)/n_dcn·(B/n_ici)·(wire/elem)``.  This is the
      correction :mod:`~horovod_tpu_torch.utils.scaling` routes through.
    """
    if hierarchy not in ("flat", "two_level"):
        raise ValueError(f"hierarchy must be flat|two_level, got "
                         f"{hierarchy!r}")
    n_dcn, n_ici = max(1, int(n_dcn)), max(1, int(n_ici))
    if hierarchy == "flat":
        # single scope, decomposed per fabric with the FULL payload on
        # both hops — NOT a hierarchical tree (no per-level shrink)
        return WireBytes(
            ici=2.0 * _ring_factor(n_ici) * payload_bytes,
            dcn=2.0 * _ring_factor(n_dcn) * payload_bytes)
    # two_level IS the 2-deep degenerate tree: full precision inside,
    # the wire codec on the outermost (slowest) hop
    by_level = exchange_wire_by_level(
        payload_bytes,
        (("ici", n_ici, None), ("dcn", n_dcn, wire_bits_dcn)),
        elem_bits=elem_bits)
    return WireBytes(ici=by_level["ici"], dcn=by_level["dcn"])


#: Level spec accepted by the tree pricers: ``(name, extent)`` or
#: ``(name, extent, wire_bits|None)`` tuples, innermost level FIRST
#: (chip < slice < pod < cluster) — or any object with ``.name`` /
#: ``.extent`` / ``.wire_bits`` attributes (``runtime/topology.
#: TopologyLevel`` duck-types in without this module importing JAX).
LevelSpec = Sequence


def _level_triples(levels: LevelSpec
                   ) -> List[Tuple[str, int, Optional[int]]]:
    out = []
    for lv in levels:
        if hasattr(lv, "name") and hasattr(lv, "extent"):
            out.append((str(lv.name), max(1, int(lv.extent)),
                        getattr(lv, "wire_bits", None)))
        else:
            name, extent = lv[0], lv[1]
            bits = lv[2] if len(lv) > 2 else None
            out.append((str(name), max(1, int(extent)), bits))
    if not out:
        raise ValueError("level tree must have at least one level")
    return out


def exchange_wire_by_level(payload_bytes: float,
                           levels: LevelSpec,
                           elem_bits: int = 32) -> Dict[str, float]:
    """Price one hierarchical gradient exchange over an arbitrary
    N-level topology tree — per-level per-chip bytes, keyed by level
    name.

    ``levels`` is innermost-first (:data:`LevelSpec`).  Level ℓ
    reduce-scatters (and later all-gathers) the block surviving the
    inner levels — ``payload / ∏ inner extents`` — around its own ring
    at its configured wire width:
    ``2·(nℓ−1)/nℓ·(B/∏inner)·(bitsℓ/elem)``.  A 2-level
    ``(ici, dcn)`` tree reproduces :func:`exchange_wire_bytes`'s
    ``two_level`` numbers exactly (the degenerate-tree pin
    ``tests/test_calibration.py`` holds)."""
    out: Dict[str, float] = {}
    inner = 1
    for name, extent, bits in _level_triples(levels):
        width = (bits if bits else elem_bits) / elem_bits
        out[name] = (2.0 * _ring_factor(extent)
                     * (float(payload_bytes) / inner) * width)
        inner *= extent
    return out


# -- a traced step's cost (layer 1) -----------------------------------------


def _op_wire_bytes(op, world: int) -> float:
    """Per-rank wire bytes of one recorded collective
    (``utils/trace.CollectiveOp``) from its bytes, JAX's convention: a
    reduce-scatter's are its result per shard (input = bytes·g), an
    all-reduce's and an all-gather's the full payload."""
    g = op.group_size or world
    if g <= 1:
        return 0.0
    if op.kind == "all-reduce":
        return 2.0 * _ring_factor(g) * op.bytes
    if op.kind == "reduce-scatter":
        return (g - 1) * op.bytes
    if op.kind in ("all-gather", "all-to-all"):
        return _ring_factor(g) * op.bytes
    # permute / broadcast: the payload crosses once
    return float(op.bytes)


def group_stride(ranks: Optional[Sequence[int]]) -> Optional[int]:
    """The global-rank step between consecutive members of a group, or
    None when unknown (no ranks, a group of one, uneven spacing): JAX's
    ``replica_group_stride``.  On a row-major layout (the world's
    ``(cross, local)`` layout, a ``TreeLayout``) level ℓ's groups step by
    the product of the extents inside it, so levels of equal extent are
    told apart by it."""
    if not ranks or len(ranks) < 2:
        return None
    stride = ranks[1] - ranks[0]
    if any(b - a != stride for a, b in zip(ranks, ranks[1:])):
        return None
    return stride


def collective_wire_by_level(ops: Sequence,
                             n_dcn: int = 1,
                             n_ici: int = 1,
                             topology: Optional[LevelSpec] = None
                             ) -> Dict[str, float]:
    """Attribute each recorded collective's wire bytes to a level of the
    topology tree (JAX ``collective_wire_by_level``).  ``topology`` is an
    innermost-first :data:`LevelSpec`; the default is the world's
    ``(ici, dcn)`` layout, JAX's keys.

    Level ℓ's groups on a row-major layout (the ``(cross, local)`` layout,
    a ``TreeLayout``) have ``extentℓ`` ranks stepping by the product of the
    extents inside it; an op is booked on the level whose size matches its
    group's, the stride (:func:`group_stride` of its global ranks)
    deciding between levels of equal extent.  Ops matching no level (a
    world-sized flat collective) ride the innermost fabric."""
    if topology is None:
        n_dcn, n_ici = max(1, int(n_dcn)), max(1, int(n_ici))
        topology = (("ici", n_ici, None), ("dcn", n_dcn, None))
    triples = _level_triples(topology)
    level_sig: List[Tuple[str, int, int]] = []   # (name, size, stride)
    world = 1
    for name, extent, _ in triples:
        level_sig.append((name, extent, world))
        world *= extent
    innermost = triples[0][0]
    out: Dict[str, float] = {name: 0.0 for name, _, _ in triples}
    for op in ops:
        stride = group_stride(op.ranks)
        candidates = [(name, sz, st) for name, sz, st in level_sig
                      if sz > 1 and op.group_size == sz]
        level = innermost
        if len(candidates) == 1 and (
                stride is None or candidates[0][2] == stride):
            level = candidates[0][0]
        elif len(candidates) > 1:
            for name, _, st in candidates:
                if stride == st:
                    level = name
                    break
        out[level] += _op_wire_bytes(op, world)
    return out


@dataclasses.dataclass(frozen=True)
class ModuleCost:
    """The cost of one traced step (JAX ``ModuleCost``): its counted
    FLOPs, its wire bytes by level, and its measured memory high-water
    (JAX's is a static estimate)."""

    flops: int                        # countable matmul-class FLOPs
    wire_bytes: Dict[str, float]      # per-level collective bytes
    memory_high_water_bytes: int      # measured peak above the step's start

    def predicted_step_time_s(self, hw: HardwareModel = H100,
                              overlap_fraction: float = 0.0,
                              efficiency: float = 1.0) -> float:
        """Roofline step time: compute at ``efficiency × peak`` plus the
        exposed share of the wire time, the innermost level at the node's
        fabric rate and every outer level at the network's
        (:func:`level_bandwidths`' rule)."""
        compute = self.flops / (hw.peak_flops_per_s * max(efficiency,
                                                          1e-9))
        wire = sum(b / (hw.ici_bytes_per_s if i == 0 else
                        hw.dcn_bytes_per_s)
                   for i, b in enumerate(self.wire_bytes.values()))
        return compute + wire * (1.0 - overlap_fraction)


def module_cost(trace, n_dcn: int = 1, n_ici: int = 1,
                topology: Optional[LevelSpec] = None) -> ModuleCost:
    """The three quantities the roofline needs from one traced step
    (``utils/trace.StepTrace``, JAX ``module_cost`` over HLO text): its
    FLOPs, its wire bytes by level of ``topology`` (default: the ``(ici,
    dcn)`` layout of ``n_ici`` × ``n_dcn``) and its memory high-water."""
    return ModuleCost(
        flops=int(trace.flops),
        wire_bytes=collective_wire_by_level(trace.ops, n_dcn=n_dcn,
                                            n_ici=n_ici, topology=topology),
        memory_high_water_bytes=int(trace.memory_high_water_bytes))


def level_bandwidths(levels: LevelSpec,
                     hw: HardwareModel = H100) -> Dict[str, float]:
    """Default bytes/s per level when no calibration artifact supplies
    measured ones: the innermost level rides ICI, every outer hop the
    DCN budget (the conservative choice — a middle fabric is at least
    as fast as the slowest one).  A calibrated model replaces this via
    :func:`calibration_level_bandwidths`."""
    triples = _level_triples(levels)
    return {name: (hw.ici_bytes_per_s if i == 0 else hw.dcn_bytes_per_s)
            for i, (name, _, _) in enumerate(triples)}


def exchange_time_by_level(wire_by_level: Dict[str, float],
                           bandwidths: Dict[str, float]) -> float:
    """Serial wire seconds of an N-level exchange: each level at its
    own fabric bandwidth (levels cannot overlap each other — level
    ℓ+1 consumes level ℓ's output, exactly like
    :func:`exchange_time_s`).  ``bandwidths`` maps level name →
    bytes/s (:func:`level_bandwidths` or a calibration artifact's
    :func:`calibration_level_bandwidths`)."""
    t = 0.0
    for name, b in wire_by_level.items():
        bw = bandwidths.get(name)
        if bw is None or bw <= 0:
            raise ValueError(f"no bandwidth for level {name!r}")
        t += b / bw
    return t


def exchange_time_s(wire: WireBytes, hw: HardwareModel = H100) -> float:
    """Serial wire time of one exchange: each level at its own fabric
    bandwidth (the levels cannot overlap each other — the DCN phase
    consumes the ICI phase's output)."""
    return wire.ici / hw.ici_bytes_per_s + wire.dcn / hw.dcn_bytes_per_s


#: Tile count of the tile-fused exchange schedule — mirrors
#: ``ops.collectives.FUSED_TAIL_TILES`` (this module stays stdlib-only,
#: so the constant is duplicated by value; docs/fused_kernels.md).
FUSED_TILE_COUNT = 4


def fused_tail_exchange_s(wire_s: float, compute_s: float,
                          n_tiles: int = FUSED_TILE_COUNT) -> float:
    """Overlap-aware roofline of the tile-fused exchange
    (docs/fused_kernels.md): with the wire split into ``n_tiles``
    sub-exchanges interleaved with per-tile compute, tile *k*'s
    transfer hides under tile *k+1*'s work — only the FIRST tile's
    share (``wire/n_tiles``, nothing precedes it) plus whatever wire
    exceeds the available compute stays exposed.  ``n_tiles <= 1`` is
    the unfused serial tail: the whole ``wire_s`` exposed.  This is
    the ceiling the autotuner uses to prune the
    ``fused_collectives`` axis without hardware
    (:func:`score_exchange_schedule`)."""
    wire_s = max(0.0, float(wire_s))
    if n_tiles <= 1 or wire_s == 0.0:
        return wire_s
    startup = wire_s / n_tiles
    return startup + max(0.0, wire_s - max(0.0, float(compute_s)))


# -- adasum reduction-operator pricing --------------------------------------


#: Statistical-efficiency credit of the adasum operator, as a fraction
#: of per-step compute seconds.  AdaSum buys nothing at a fixed batch —
#: it strictly *adds* wire (the dot/norm pairwise exchange below) — its
#: value is that it holds the loss trajectory at 2–4× the global batch
#: where plain sum degrades (docs/adasum.md, the pinned convergence
#: test).  The autotuner's objective is throughput at the sampled
#: batch, so the model books the batch-scaling headroom as a credit
#: proportional to compute seconds: compute_s grows linearly with the
#: per-chip batch while the exchange wire does not, which is exactly
#: what makes the ``reduction`` axis flip to adasum only above a batch
#: crossover — small batches never pay the extra DCN round.
ADASUM_COMPUTE_CREDIT_FRACTION = 0.05


def adasum_extra_wire_bytes(payload_bytes: float,
                            n_dcn: int = 1,
                            n_ici: int = 1) -> float:
    """Extra per-chip DCN bytes the adasum outer-level exchange moves
    *beyond* the plain ring reduce-scatter it replaces.

    The operator is pairwise and order-sensitive, so the outer level
    cannot ring-RS 1/n-sized shards: it runs a recursive-halving
    doubling schedule (``ops.collectives._adasum_psum_scatter``) that
    ppermutes the **full** inner-reduced block every round —
    ``⌈log2(n_dcn)⌉ · (payload/n_ici)`` per chip, each round carrying
    the operands the per-pair fp32 dot/norms are computed from (the
    "extra dot/norm round" is this full-block traffic; the scalar
    coefficients themselves ride along for free).  The ring RS it
    displaces would have moved ``(n_dcn−1)/n_dcn`` of the same block,
    so the extra is the difference, floored at 0.  ``n_dcn <= 1``
    prices 0: a single-slice world degenerates adasum to plain sum
    bit-for-bit and the schedule never engages."""
    n_dcn, n_ici = max(1, int(n_dcn)), max(1, int(n_ici))
    if n_dcn <= 1:
        return 0.0
    block = float(payload_bytes) / n_ici
    rounds = math.ceil(math.log2(n_dcn))
    return max(0.0, (rounds - _ring_factor(n_dcn)) * block)


# -- parallelism-plan pricing -----------------------------------------------


#: Plan-grammar keys — mirrors ``parallel/plan.PLAN_KEYS`` (this module
#: stays stdlib-only, so the grammar is duplicated by value like
#: :data:`FUSED_TILE_COUNT`; ``v`` is the interleaved-1F1B
#: virtual-stage count).
PLAN_GRAMMAR_KEYS = ("dp", "pp", "fsdp", "ep", "sp", "tp", "v")

#: Microbatch count the plan scorer assumes when the caller does not
#: pin one — matches the bench pipeline probe's default depth.
PLAN_SCORE_MICROBATCHES = 8

#: Wire bits per ``HOROVOD_EXCHANGE_WIRE_DTYPE`` value — the
#: ``wire_dtype`` autotune axis's pricing table (fp32 = no wire
#: compression; int8 and fp8_e4m3 both move one byte per element, so
#: the model ranks them identically and the measurement breaks the
#: tie).
WIRE_DTYPE_BITS = {"fp32": 32, "int8": 8, "fp8_e4m3": 8}


def parse_plan(plan: Union[str, Dict]) -> Dict[str, int]:
    """Parse the ``HOROVOD_PLAN`` grammar into a full extent dict
    (every :data:`PLAN_GRAMMAR_KEYS` key, absent axes at 1).  The
    stdlib mirror of ``parallel/plan.ShardingPlan.from_string`` for the
    analysis layer; ``dp=?`` (an unresolved plan string) prices as
    ``dp=1``."""
    if isinstance(plan, dict):
        ext = dict(plan)
    else:
        ext = {}
        for item in str(plan).split(","):
            item = item.strip()
            if not item:
                continue
            key, sep, val = item.partition("=")
            key = key.strip()
            if not sep or key not in PLAN_GRAMMAR_KEYS:
                raise ValueError(
                    f"bad plan term {item!r}: expected axis=extent "
                    f"with axis in {', '.join(PLAN_GRAMMAR_KEYS)}")
            if key in ext:
                raise ValueError(f"duplicate plan axis {key!r} in "
                                 f"{plan!r}")
            v = val.strip()
            ext[key] = 1 if v == "?" else int(v)
    out = {}
    for k in PLAN_GRAMMAR_KEYS:
        raw = ext.get(k)
        v = 1 if raw is None else int(raw)
        if v < 1:
            raise ValueError(f"plan axis {k} must be >= 1, got {v}")
        out[k] = v
    return out


def pipeline_bubble_fraction(stages: int, microbatches: int,
                             virtual_stages: int = 1) -> float:
    """Idle share of the pipeline schedule, ``(s-1)/(v*m+s-1)`` —
    mirrors ``parallel/pipeline.bubble_fraction`` by value (GPipe at
    ``v=1``, interleaved-1F1B at ``v>1``; docs/parallelism.md)."""
    stages, microbatches = max(1, int(stages)), max(1, int(microbatches))
    virtual_stages = max(1, int(virtual_stages))
    return (stages - 1) / (virtual_stages * microbatches + stages - 1)


def plan_exchange_wire_bytes(plan: Union[str, Dict],
                             payload_bytes: float,
                             n_dcn: int = 1,
                             n_ici: int = 1,
                             wire_bits_dcn: int = 8,
                             topology: Optional[LevelSpec] = None
                             ) -> Union[WireBytes, Dict[str, float]]:
    """Gradient-exchange wire bytes under a parallelism plan.

    The model axes (pp/ep/sp/tp) shard the parameters, so each data
    replica exchanges only ``payload / model_extent`` bytes.  The data
    axes (dp × fsdp) then map onto the fabric DCN-outer/ICI-inner
    (the ``AXIS_ORDER`` layout ``parallel/mesh.py`` realizes): ``dp``
    absorbs the DCN extent first, the remainder rides ICI, and the
    exchange goes two-level exactly when both derived extents exceed
    1 — the same decision ``resolve_hierarchy`` makes at trace time.

    ``topology`` (an innermost-first :data:`LevelSpec` whose extents
    factor the plan's data world) prices the exchange over that
    N-level tree instead and changes the return to the per-level dict
    of :func:`exchange_wire_by_level` — the pricing the N-level
    resolved topology (``runtime/topology.resolve_topology``) feeds
    in; the 2-level default keeps the :class:`WireBytes` contract.
    """
    ext = parse_plan(plan)
    model = ext["pp"] * ext["ep"] * ext["sp"] * ext["tp"]
    per_replica = float(payload_bytes) / max(1, model)
    data_world = ext["dp"] * ext["fsdp"]
    if topology is not None:
        triples = _level_triples(topology)
        tree_world = 1
        for _, extent, _ in triples:
            tree_world *= extent
        if tree_world != data_world:
            raise ValueError(
                f"topology world {tree_world} does not factor the "
                f"plan's data world {data_world} "
                f"(dp={ext['dp']}, fsdp={ext['fsdp']})")
        return exchange_wire_by_level(per_replica, triples)
    d_dcn = min(ext["dp"], max(1, int(n_dcn)))
    while data_world % d_dcn:
        d_dcn -= 1
    d_ici = max(1, data_world // d_dcn)
    hierarchy = "two_level" if d_dcn > 1 and d_ici > 1 else "flat"
    return exchange_wire_bytes(per_replica, n_dcn=d_dcn, n_ici=d_ici,
                               hierarchy=hierarchy,
                               wire_bits_dcn=wire_bits_dcn)


def plan_cost_s(plan: Union[str, Dict],
                payload_bytes: float,
                n_dcn: int = 1,
                n_ici: int = 1,
                compute_s: float = 0.0,
                microbatches: int = PLAN_SCORE_MICROBATCHES,
                hw: HardwareModel = H100,
                wire_bits_dcn: int = 8,
                reduction: str = "sum") -> float:
    """Predicted per-step seconds of one plan: compute stretched by the
    pipeline bubble (``t / (1 - bubble)`` — the idle ticks are pure
    loss) plus the serial wire time of the plan-scoped gradient
    exchange.  The quantity ``ThroughputAutotuner(predict=)`` ranks the
    ``plan`` axis with (:func:`score_exchange_schedule`), and the
    1F1B-beats-GPipe acceptance check reads straight off: same plan
    with ``v>1`` has a strictly smaller bubble term.
    ``reduction="adasum"`` adds the outer-level dot/norm round's extra
    DCN wire time (:func:`adasum_extra_wire_bytes`, priced under the
    plan's derived dp factorization) — a pure step-time penalty here;
    the batch-scaling *credit* lives in the ranking-side
    :func:`score_exchange_schedule`, not in the honest per-step
    clock."""
    ext = parse_plan(plan)
    bubble = 0.0
    if ext["pp"] > 1:
        bubble = pipeline_bubble_fraction(ext["pp"], microbatches,
                                          ext["v"])
    wire = plan_exchange_wire_bytes(plan, payload_bytes, n_dcn=n_dcn,
                                    n_ici=n_ici,
                                    wire_bits_dcn=wire_bits_dcn)
    t = float(compute_s) / (1.0 - bubble) + exchange_time_s(wire, hw)
    if reduction == "adasum":
        model = ext["pp"] * ext["ep"] * ext["sp"] * ext["tp"]
        per_replica = float(payload_bytes) / max(1, model)
        data_world = ext["dp"] * ext["fsdp"]
        d_dcn = min(ext["dp"], max(1, int(n_dcn)))
        while data_world % d_dcn:
            d_dcn -= 1
        d_ici = max(1, data_world // d_dcn)
        t += adasum_extra_wire_bytes(per_replica, n_dcn=d_dcn,
                                     n_ici=d_ici) / hw.dcn_bytes_per_s
    return t


def rank_plans(plans: Sequence[Union[str, Dict]],
               payload_bytes: float,
               n_dcn: int = 1,
               n_ici: int = 1,
               compute_s: float = 0.0,
               microbatches: int = PLAN_SCORE_MICROBATCHES,
               hw: HardwareModel = H100,
               wire_bits_dcn: int = 8
               ) -> List[Tuple[float, Union[str, Dict]]]:
    """Score each plan with :func:`plan_cost_s` and return
    ``(cost_s, plan)`` pairs sorted cheapest-first.  The sort is
    stable, so a caller that pre-orders its candidates by preference
    (``ShardingPlan.degrade_candidates`` puts dp-shrink before
    fsdp-shrink at equal world size) gets that preference as the
    tie-break for free."""
    scored = [(plan_cost_s(p, payload_bytes, n_dcn=n_dcn, n_ici=n_ici,
                           compute_s=compute_s,
                           microbatches=microbatches, hw=hw,
                           wire_bits_dcn=wire_bits_dcn), p)
              for p in plans]
    scored.sort(key=lambda cp: cp[0])
    return scored


# -- plan memory: the HBM roofline ------------------------------------------


#: Remat policy vocabulary — mirrors ``memory/remat.REMAT_POLICIES`` by
#: value (this module stays stdlib-only, like :data:`PLAN_GRAMMAR_KEYS`).
REMAT_POLICIES = ("none", "dots", "full", "offload")

#: Share of the remat-none activation footprint still resident in HBM
#: under each policy.  The JAX package's values, kept as parity data
#: (``chip_smoke.py`` phase 18 prints the H100's measured shares beside
#: them; ``PERF.md``).  JAX calibrated them against the linear-scan
#: ``utils/hlo.memory_high_water`` estimate of the CPU-twin
#: transformer's compiled dumps (the same estimator
#: :func:`plan_memory_bytes` is validated against, so model and
#: measurement share one definition of "activation bytes"): ``full``
#: keeps the per-block backward-recompute peak plus the saved block
#: inputs; ``dots`` additionally keeps every matmul output; ``offload``
#: streams the dots residuals to pinned host memory, leaving roughly
#: the ``full`` residency on-device.
REMAT_ACTIVATION_FRACTION = {
    "none": 1.0, "dots": 0.82, "full": 0.31, "offload": 0.41,
}

#: Fractional step-time penalty of the policy's recomputation (the
#: JAX package's values, as above; plus,
#: for ``offload``, the un-hidden share of the D2H/H2D stream):
#: ``dots`` replays the cheap elementwise ops only, ``full`` replays
#: each block's forward (~1/3 of the fwd+bwd budget).
REMAT_RECOMPUTE_OVERHEAD = {
    "none": 0.0, "dots": 0.12, "full": 0.30, "offload": 0.34,
}

#: Resident share of an offloaded optimizer shard **during the step
#: window**: 1.0 — no high-water credit.  The streaming engine
#: (``memory/offload.py``) retains the device reference until
#: ``fetch()`` (the degrade contract) and ``fetch()`` restores the
#: whole shard to device *before* the step that consumes it, so the
#: per-step HBM high-water still holds the full shard; the host
#: round-trip only parks it between steps.  Charging less would let
#: the budgeted planner call configs feasible that OOM in practice —
#: ``bench.py --hbm-budget`` validates the offload=True prediction
#: against the measured high-water to keep this honest.  An engine
#: that streamed slot *buckets* through the update phase could earn a
#: fraction < 1 here; until one exists, offload is HBM-neutral in the
#: roofline and the planner never profits from it.
OFFLOAD_RESIDENT_FRACTION = 1.0


@dataclasses.dataclass(frozen=True)
class MemoryBytes:
    """Per-device HBM high-water decomposition of one plan — the four
    components the budget trades against each other, plus the exchange
    staging.  ``tightest`` names the dominant component, the axis an
    infeasibility error points at (``memory/planner.py``).

    MoE plans add two components (both 0.0 for dense models):
    ``expert_params`` — the per-device expert-parameter shard (their
    grads/optimizer slots fold into ``grads``/``optimizer``) — and
    ``moe_buffers``, the static ``(E, C, d)`` dispatch + combine
    capacity buckets, which are ``ep``-invariant per device (each chip
    always stages ``E·C·d`` slots: all experts' slots before the
    exchange, or ``ep`` source tiles of its ``E/ep`` experts after)."""

    params: float
    grads: float
    optimizer: float
    activations: float
    exchange: float
    expert_params: float = 0.0
    moe_buffers: float = 0.0

    @property
    def total(self) -> float:
        return (self.params + self.grads + self.optimizer
                + self.activations + self.exchange
                + self.expert_params + self.moe_buffers)

    @property
    def tightest(self) -> str:
        """Name of the largest component (deterministic field-order
        tie-break)."""
        return max(dataclasses.asdict(self).items(),
                   key=lambda kv: (kv[1], kv[0]))[0]


def plan_memory_bytes(plan: Union[str, Dict], *,
                      param_bytes: float,
                      activation_bytes: float,
                      remat_policy: str = "none",
                      microbatches: int = 1,
                      optimizer_slots: int = 2,
                      shard_optimizer_states: bool = False,
                      offload_optimizer: bool = False,
                      exchange_bucket_bytes: Optional[float] = None,
                      expert_param_bytes: float = 0.0,
                      moe_capacity_buffer_bytes: float = 0.0
                      ) -> MemoryBytes:
    """Predicted per-device HBM high-water of one plan — the memory
    twin of :func:`plan_cost_s`, and the quantity the feasibility
    predicate (:func:`plan_fits`) holds under ``HOROVOD_HBM_BUDGET_BYTES``.

    Inputs are *unsharded single-replica* quantities: ``param_bytes``
    the whole model's parameters, ``activation_bytes`` the whole
    network's activation footprint for one device's batch shard at
    ``remat_policy="none"`` and ``microbatches=1``.  The plan then
    shards them:

    * params/grads divide over the parameter-sharding axes
      (``tp·pp·ep·fsdp`` — ``ep`` idealized as sharding every layer,
      ``sp`` replicates parameters);
    * optimizer state is ``optimizer_slots`` × the param shard,
      further ÷ ``dp`` under the ZeRO sharded exchange;
      ``offload_optimizer`` charges
      :data:`OFFLOAD_RESIDENT_FRACTION` = 1.0 of it — host streaming
      parks the shard *between* steps but restores it whole before the
      step (``memory/offload.py``), so it buys no step-window
      high-water;
    * activations scale by the policy's residency fraction
      (:data:`REMAT_ACTIVATION_FRACTION`), divide over ``sp`` and the
      microbatch count, and a pipeline holds ``min(pp, m)`` in-flight
      microbatches of its ``1/pp`` layer slice (the 1F1B steady
      state);
    * exchange staging is the double-buffered bucket pair when the
      bucketed exchange is on, else one grad-shard-sized fused buffer
      whenever a data axis exists;
    * ``expert_param_bytes`` (MoE plans: the expert FFN weights, which
      ``ep`` *actually* shards — pass the dense remainder as
      ``param_bytes``) divides over the same ``tp·pp·ep·fsdp`` axes,
      with grads and optimizer slots folded into those components;
      ``moe_capacity_buffer_bytes`` (the static dispatch + combine
      ``(E, C, d)`` buckets, already per-device and ``ep``-invariant:
      ``2·E·C·d·elem_bytes``) is charged as-is.

    The JAX package validated it against XLA's compiled buffers (within
    25 %; docs/memory.md lists the approximations); on the H100,
    ``chip_smoke.py`` phase 18 prints it beside ``max_memory_allocated``.
    """
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat policy {remat_policy!r}: expected one of "
            f"{', '.join(REMAT_POLICIES)}")
    ext = parse_plan(plan)
    microbatches = max(1, int(microbatches))
    param_shard_axes = ext["tp"] * ext["pp"] * ext["ep"] * ext["fsdp"]
    params = float(param_bytes) / param_shard_axes
    expert_params = float(expert_param_bytes) / param_shard_axes
    grads = params + expert_params
    optimizer = max(0, int(optimizer_slots)) * (params + expert_params)
    if shard_optimizer_states:
        optimizer /= ext["dp"]
    if offload_optimizer:
        optimizer *= OFFLOAD_RESIDENT_FRACTION
    frac = REMAT_ACTIVATION_FRACTION[remat_policy]
    act_per_mb = float(activation_bytes) * frac \
        / (microbatches * ext["sp"])
    in_flight = min(ext["pp"], microbatches)
    activations = act_per_mb / ext["pp"] * in_flight
    data_world = ext["dp"] * ext["fsdp"]
    if exchange_bucket_bytes:
        exchange = 2.0 * float(exchange_bucket_bytes)
    else:
        exchange = grads if data_world > 1 else 0.0
    return MemoryBytes(params=params, grads=grads, optimizer=optimizer,
                       activations=activations, exchange=exchange,
                       expert_params=expert_params,
                       moe_buffers=float(moe_capacity_buffer_bytes))


def plan_fits(mem: Union[MemoryBytes, float],
              budget_bytes: Optional[float] = None,
              hw: HardwareModel = H100) -> bool:
    """Feasibility predicate: does the predicted high-water fit the
    budget?  ``budget_bytes`` (the HOROVOD_HBM_BUDGET_BYTES knob) rules
    when given; otherwise the hardware model's capacity; no capacity
    anywhere = everything fits (the pre-memory-plane behavior)."""
    total = mem.total if isinstance(mem, MemoryBytes) else float(mem)
    cap = budget_bytes if budget_bytes is not None \
        else hw.hbm_capacity_bytes
    if cap is None:
        return True
    return total <= float(cap)


def score_exchange_schedule(point: Dict,
                            payload_bytes: float,
                            n_dcn: int = 1,
                            n_ici: int = 1,
                            compute_s: float = 0.0,
                            hw: HardwareModel = H100,
                            n_tiles: int = FUSED_TILE_COUNT,
                            sp_attn_wire_s: float = 0.0,
                            sp_attn_compute_s: float = 0.0
                            ) -> Optional[float]:
    """Rank one autotune sample point by its predicted *exposed*
    exchange seconds (negated — higher is better, matching the
    measured-rate objective).  ``point`` is a bench-autotuner sample
    (``{"hierarchy": ..., "fused_collectives": ..., "wire_dtype": ...,
    "plan": ..., ...}``); knobs the exchange model does not price
    (steps_per_call, flash_block, bucket cap) leave the score
    unchanged, so per-axis scans of those knobs see constant scores
    and stay fully measured.  ``wire_dtype`` prices the codec width
    (:data:`WIRE_DTYPE_BITS`): the DCN hop in two_level, the whole
    single-scope wire in flat (the flat quantized path compresses ICI
    too).  A ``plan`` knob reprices the exchange under that plan's
    factorization and adds the pipeline bubble penalty
    (:func:`plan_cost_s`); a plan with ``sp>1`` additionally charges
    the attention K/V ring — ``sp_attn_wire_s``/``sp_attn_compute_s``
    (from :func:`sp_ring_wire_bytes` / :func:`sp_attention_compute_s`,
    priced for sp=1 by the caller and rescaled here to the sampled
    extent) exposed per :func:`sp_ring_exposed_s`, fused when the
    point's ``fused_collectives`` is ``"on"`` — the fused-vs-unfused
    ring the dp×sp autotune prunes on.  A ``reduction`` knob
    (``"sum"`` | ``"adasum"``) charges the adasum outer-level exchange
    its extra DCN wire (:func:`adasum_extra_wire_bytes`) and credits
    its batch-scaling headroom
    (:data:`ADASUM_COMPUTE_CREDIT_FRACTION` × ``compute_s``) — since
    ``compute_s`` grows with the per-chip batch and the wire penalty
    does not, the axis flips to adasum only above a batch crossover.
    Returns ``None`` when the
    point carries no
    exchange knob at all — the caller then skips pruning entirely (the
    ParameterManager ``predict=`` contract: a predictor that cannot
    rank must not narrow the grid)."""
    hierarchy = point.get("hierarchy")
    fused = point.get("fused_collectives")
    wire_dtype = point.get("wire_dtype")
    plan = point.get("plan")
    reduction = point.get("reduction")
    if hierarchy is None and fused is None and wire_dtype is None \
            and plan is None and reduction is None:
        return None

    def _with_reduction(score: float) -> float:
        if reduction != "adasum":
            return score
        extra_s = adasum_extra_wire_bytes(
            float(payload_bytes), n_dcn=n_dcn, n_ici=n_ici) \
            / hw.dcn_bytes_per_s
        return (score - extra_s
                + ADASUM_COMPUTE_CREDIT_FRACTION * float(compute_s))

    wire_bits = WIRE_DTYPE_BITS.get(wire_dtype, 8)
    if plan is not None:
        ext = parse_plan(plan)
        bubble = 0.0
        if ext["pp"] > 1:
            bubble = pipeline_bubble_fraction(
                ext["pp"], PLAN_SCORE_MICROBATCHES, ext["v"])
        wire = plan_exchange_wire_bytes(plan, float(payload_bytes),
                                        n_dcn=n_dcn, n_ici=n_ici,
                                        wire_bits_dcn=wire_bits)
        exch = exchange_time_s(wire, hw)
        if fused == "on":
            exch = fused_tail_exchange_s(exch, compute_s, n_tiles)
        sp_cost = 0.0
        if ext["sp"] > 1 and (sp_attn_wire_s or sp_attn_compute_s):
            # inputs are the sp=1 (whole-sequence, one-chip) quantities:
            # wire = seconds to move the full K+V once at ICI rate,
            # compute = the full t_global² attention; the sampled sp
            # extent rescales them — per-chip ring wire is the
            # (sp−1)/sp ring factor of the full volume, per-chip
            # compute divides by sp (each rank owns t_global/sp queries)
            sp_w = float(sp_attn_wire_s) * _ring_factor(ext["sp"])
            sp_c = float(sp_attn_compute_s) / ext["sp"]
            sp_cost = sp_c + sp_ring_exposed_s(
                sp_w, sp_c, ext["sp"], fused=(fused == "on"))
        # penalty form of the bubble stretch: the constant compute_s
        # offset cancels in the ranking
        return _with_reduction(
            -(float(compute_s) * bubble / (1.0 - bubble) + exch
              + sp_cost))
    hierarchy = hierarchy if hierarchy in ("flat", "two_level") else "flat"
    wire = exchange_wire_bytes(float(payload_bytes), n_dcn=n_dcn,
                               n_ici=n_ici, hierarchy=hierarchy,
                               wire_bits_dcn=wire_bits)
    if hierarchy == "flat" and wire_dtype in ("int8", "fp8_e4m3"):
        # flat quantization compresses the single-scope wire everywhere
        wire = WireBytes(ici=wire.ici * wire_bits / 32.0,
                         dcn=wire.dcn * wire_bits / 32.0)
    serial = exchange_time_s(wire, hw)
    if fused == "on":
        return _with_reduction(
            -fused_tail_exchange_s(serial, compute_s, n_tiles))
    return _with_reduction(-serial)


# -- sequence-parallel (sp ring) pricing ------------------------------------


def sp_ring_wire_bytes(seq_local: int, heads: int, head_dim: int,
                       sp: int, batch: int = 1,
                       elem_bits: int = 32) -> float:
    """Per-chip K/V ring wire bytes of one sp attention forward.

    Each of the ``sp−1`` ring hops moves this chip's K *and* V block
    (``b·t_local·h·d`` elements each):
    ``2·(sp−1)·b·t_local·h·d·elem_bytes``.  The fused ring-flash path
    moves exactly the same bytes as the jnp formulation — fusion
    changes the *exposure* (:func:`sp_ring_exposed_s`), never the
    volume — so this is the honest wire gauge for both schedules.
    ``sp <= 1`` prices 0 (the sequence is local, nothing crosses the
    wire)."""
    sp = max(1, int(sp))
    if sp == 1:
        return 0.0
    block = (max(1, int(batch)) * int(seq_local) * int(heads)
             * int(head_dim) * (elem_bits / 8.0))
    return 2.0 * (sp - 1) * block


def sp_attention_compute_s(seq_global: int, heads: int, head_dim: int,
                           sp: int, batch: int = 1,
                           causal: bool = False,
                           hw: HardwareModel = H100) -> float:
    """Per-chip attention forward seconds under ``sp``-way sequence
    parallelism: the full ``4·b·t_global²·h·d`` FLOPs (QKᵀ + PV, two
    FLOPs per MAC) divide evenly over the sp ranks — each rank's
    ``t_global/sp`` queries visit every K/V block exactly once around
    the ring.  ``causal`` halves the live score area (under the zigzag
    layout the halving is per-rank exact; under the contiguous layout
    it holds in aggregate while the per-rank work skews)."""
    flops = (4.0 * max(1, int(batch)) * float(seq_global) ** 2
             * int(heads) * int(head_dim)) / max(1, int(sp))
    if causal:
        flops *= 0.5
    return flops / hw.peak_flops_per_s


def sp_ring_exposed_s(wire_s: float, compute_s: float, sp: int,
                      fused: bool = True) -> float:
    """Exposed (un-overlapped) seconds of the sp K/V ring: the fused
    ring-flash path pre-issues the next block's ``ppermute`` before
    the current block's flash kernel, so hop *k* hides under block
    *k*'s compute — the serial-tail credit is exactly
    :func:`fused_tail_exchange_s` with the ring's ``sp`` steps as
    tiles; unfused (the jnp scan), every hop sits serially between
    steps and the whole wire is exposed."""
    if not fused:
        return max(0.0, float(wire_s))
    return fused_tail_exchange_s(wire_s, compute_s,
                                 n_tiles=max(1, int(sp)))


# -- MoE expert-dispatch pricing --------------------------------------------


def moe_capacity(tokens: int, num_experts: int,
                 capacity_factor: float = 1.25) -> int:
    """Per-expert capacity bucket, ``max(1, ceil(cf·tokens/E))`` —
    mirrors ``parallel/expert.expert_parallel_ffn`` by value (this
    module stays stdlib-only, like :data:`PLAN_GRAMMAR_KEYS`)."""
    tokens, num_experts = max(1, int(tokens)), max(1, int(num_experts))
    return int(max(1, -(-float(capacity_factor) * tokens
                        // num_experts)))


def moe_dispatch_wire_bytes(tokens: int, d_model: int, num_experts: int,
                            ep: int, capacity_factor: float = 1.25,
                            elem_bits: int = 32,
                            capacity: Optional[int] = None) -> float:
    """Per-chip wire bytes of one MoE dispatch + combine exchange.

    Each of the ``ep−1`` ring hops moves one ``(E/ep, C, d)`` source
    tile, in both directions (route → expert, expert output → origin):
    ``2·(ep−1)·(E/ep)·C·d·elem_bytes``.  The boundary-wide
    ``all_to_all`` moves exactly the same bytes (each chip ships
    ``ep−1`` of its ``ep`` tiles, twice) — the fused ring changes the
    *exposure* (:func:`moe_dispatch_exposed_s`), never the volume, so
    this is the honest ``hvd_moe_ep_wire_bytes`` gauge for both
    schedules.  ``tokens`` is the per-chip token count; ``ep <= 1``
    prices 0 (local experts, nothing crosses the wire)."""
    ep = max(1, int(ep))
    if ep == 1:
        return 0.0
    if capacity is None:
        capacity = moe_capacity(tokens, num_experts, capacity_factor)
    e_local = max(1, int(num_experts) // ep)
    tile = e_local * int(capacity) * int(d_model) * (elem_bits / 8.0)
    return 2.0 * (ep - 1) * tile


def moe_expert_compute_s(tokens: int, d_model: int, d_ff: int,
                         num_experts: int, ep: int,
                         capacity_factor: float = 1.25,
                         hw: HardwareModel = H100,
                         capacity: Optional[int] = None) -> float:
    """Per-chip expert-FFN forward seconds: ``E/ep`` local experts each
    process up to ``ep·C`` routed slots through the two ``d×d_ff``
    matmuls (``4·d·d_ff`` FLOPs per slot).  The compute the fused ring
    hides hops under — and the term that grows linearly with the
    ``capacity_factor`` autotune axis."""
    ep = max(1, int(ep))
    if capacity is None:
        capacity = moe_capacity(tokens, num_experts, capacity_factor)
    e_local = max(1, int(num_experts) // ep)
    flops = e_local * ep * int(capacity) * 4.0 * int(d_model) * int(d_ff)
    return flops / hw.peak_flops_per_s


def moe_dispatch_exposed_s(wire_s: float, compute_s: float, ep: int,
                           fused: bool = True) -> float:
    """Exposed (un-overlapped) seconds of the dispatch + combine
    exchange: the fused ``a2a ⊗ expert-matmul`` ring streams one tile
    per hop while the previous tile's expert matmul computes, so the
    serial-tail credit is exactly :func:`fused_tail_exchange_s` with
    the ring's ``ep`` tiles; unfused, the whole boundary-wide
    ``all_to_all`` wire is exposed (nothing overlaps it)."""
    if not fused:
        return max(0.0, float(wire_s))
    return fused_tail_exchange_s(wire_s, compute_s,
                                 n_tiles=max(1, int(ep)))


def score_moe_schedule(point: Dict, *,
                       tokens: int,
                       d_model: int,
                       d_ff: int,
                       num_experts: int,
                       ep: int = 1,
                       fused: bool = True,
                       hw: HardwareModel = H100,
                       elem_bits: int = 32) -> Optional[float]:
    """Rank one MoE autotune sample point (``{"capacity_factor": ...}``
    and/or ``{"tokens_per_expert": ...}``) by its predicted per-step
    MoE seconds, negated — the ``bench --autotune`` pruning twin of
    :func:`score_exchange_schedule` for the routing axes.
    ``tokens_per_expert`` sets the nominal per-expert workload (scaled
    by ``capacity_factor`` slack when both are sampled);
    ``capacity_factor`` alone derives it via :func:`moe_capacity`.
    Returns
    ``None`` when the point carries neither knob (the ``predict=``
    contract: a predictor that cannot rank must not narrow the
    grid)."""
    cf = point.get("capacity_factor")
    tpe = point.get("tokens_per_expert")
    if cf is None and tpe is None:
        return None
    if tpe is not None:
        # cf composes with tpe when both knobs land in one point: tpe
        # is the nominal per-expert workload, cf the slack multiplier —
        # pinning capacity to tpe alone would score a cf scan flat and
        # prune nothing
        slack = float(cf) if cf is not None else 1.0
        capacity = int(max(1, -(-slack * int(tpe) // 1)))
    else:
        capacity = moe_capacity(tokens, num_experts, float(cf))
    wire_bytes = moe_dispatch_wire_bytes(
        tokens, d_model, num_experts, ep, elem_bits=elem_bits,
        capacity=capacity)
    wire_s = wire_bytes / hw.ici_bytes_per_s
    compute_s = moe_expert_compute_s(
        tokens, d_model, d_ff, num_experts, ep, hw=hw,
        capacity=capacity)
    exposed = moe_dispatch_exposed_s(wire_s, compute_s, ep, fused=fused)
    return -(compute_s + exposed)
