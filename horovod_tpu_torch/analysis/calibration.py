"""Measured hardware model: collective microbenchmark fitting (a copy of
``horovod_tpu/analysis/calibration.py``, with the measured sweep of
``bench.py --calibrate`` (``run_calibrate``) as :func:`measure_artifact`).

Instead of trusting the preset constants of :data:`~horovod_tpu_torch.
analysis.cost_model.H100`, :func:`measure_artifact` times every
collective the exchange is built from (allreduce, reduce-scatter,
all-gather, a ring permute, all-to-all) on each level of the world's
layout (``local``: the ranks of a node, ``cross``: one rank a node)
across a message-size sweep, plus the bf16 matmul rate and the memory
stream rate, and this module fits the alpha-beta model per (level,
collective)::

    t(n) = alpha + n / beta            # latency + bytes/bandwidth

by closed-form least squares (:func:`fit_alpha_beta`).  The fits are
saved as a versioned JSON artifact (:func:`build_artifact`) that
``HardwareModel.from_calibration`` turns back into roofline constants
(``HOROVOD_CALIBRATION_PATH``; :func:`~horovod_tpu_torch.analysis.
cost_model.resolve_hardware_model`).

Everything but :func:`measure_artifact` is stdlib only and needs no
device.  Artifacts carry no wall-clock fields: the same simulated sweep
on the same seed serializes bit-identically.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

from horovod_tpu_torch.analysis import cost_model as CM

#: The collectives the sweep measures per level — the exchange's
#: building blocks (docs/calibration.md "Sweep design").
CALIBRATED_COLLECTIVES = ("allreduce", "reduce_scatter", "all_gather",
                         "ppermute", "all_to_all")

#: Default message-size sweep (bytes): 8 log-spaced points from 64 KiB
#: to 128 MiB — small enough to expose alpha, large enough to pin beta.
DEFAULT_SWEEP_BYTES = tuple(2 ** p for p in range(16, 28, 2)) + \
    (2 ** 27,)


@dataclasses.dataclass(frozen=True)
class LevelFit:
    """One fitted alpha-beta curve: ``t(n) = alpha_s + n /
    beta_bytes_per_s``.  ``residual`` is the RMS relative error of the
    fit over its own points — the staleness/quality signal the
    artifact carries per curve."""

    collective: str
    alpha_s: float
    beta_bytes_per_s: float
    residual: float
    n_points: int

    def predict_s(self, nbytes: float) -> float:
        return self.alpha_s + float(nbytes) / self.beta_bytes_per_s

    def as_json(self) -> Dict:
        return {"alpha_s": self.alpha_s,
                "beta_bytes_per_s": self.beta_bytes_per_s,
                "residual": self.residual,
                "n_points": self.n_points}


def fit_alpha_beta(sizes_bytes: Sequence[float],
                   times_s: Sequence[float]) -> Tuple[float, float, float]:
    """Closed-form least-squares fit of ``t(n) = alpha + n/beta``.

    Returns ``(alpha_s, beta_bytes_per_s, rms_relative_residual)``.
    The slope of the ``t``-on-``n`` regression is ``1/beta``, the
    intercept ``alpha`` (clamped at 0 — a negative latency is noise,
    not physics).  Degenerate inputs raise: a sweep needs >= 2
    distinct sizes to separate latency from bandwidth."""
    xs = [float(x) for x in sizes_bytes]
    ys = [float(y) for y in times_s]
    if len(xs) != len(ys) or len(xs) < 2:
        raise ValueError("fit needs >= 2 (size, time) pairs")
    xbar = sum(xs) / len(xs)
    ybar = sum(ys) / len(ys)
    sxx = sum((x - xbar) ** 2 for x in xs)
    if sxx == 0:
        raise ValueError("fit needs >= 2 distinct sizes")
    slope = sum((x - xbar) * (y - ybar)
                for x, y in zip(xs, ys)) / sxx
    if slope <= 0:
        raise ValueError(
            "non-positive time-vs-bytes slope: the sweep did not "
            "resolve a bandwidth (measure larger messages)")
    alpha = max(0.0, ybar - slope * xbar)
    beta = 1.0 / slope
    sq = 0.0
    for x, y in zip(xs, ys):
        pred = alpha + x * slope
        sq += ((pred - y) / y) ** 2 if y > 0 else 0.0
    residual = math.sqrt(sq / len(xs))
    return alpha, beta, residual


def fit_level(collective: str,
              sizes_bytes: Sequence[float],
              times_s: Sequence[float]) -> LevelFit:
    alpha, beta, residual = fit_alpha_beta(sizes_bytes, times_s)
    return LevelFit(collective=collective, alpha_s=alpha,
                    beta_bytes_per_s=beta, residual=residual,
                    n_points=len(list(sizes_bytes)))


# -- simulated measurements (the deterministic CI path) ---------------------


#: Per-collective latency/bandwidth scale relative to the fabric's
#: reduce-scatter curve — the shape the simulator gives synthetic
#: sweeps (an allreduce moves ~2x the RS wire; a ppermute has no
#: reduction tree, so less latency).
_SIM_COLLECTIVE_SHAPE = {
    "allreduce": (1.5, 0.5), "reduce_scatter": (1.0, 1.0),
    "all_gather": (1.0, 1.0), "ppermute": (0.5, 1.2),
    "all_to_all": (1.2, 0.8),
}


def simulate_sweep(alpha_s: float, beta_bytes_per_s: float,
                   sizes_bytes: Sequence[float], seed: int,
                   rel_noise: float = 5e-4) -> List[float]:
    """Synthetic measured times for a known alpha-beta truth, with
    seeded multiplicative noise — the pure-sim calibration source
    (:func:`simulated_calibration`).
    Deterministic: same ``(alpha, beta, sizes, seed, rel_noise)`` →
    bit-identical floats."""
    rng = random.Random(seed)
    out = []
    for n in sizes_bytes:
        t = alpha_s + float(n) / beta_bytes_per_s
        out.append(t * (1.0 + rng.uniform(-rel_noise, rel_noise)))
    return out


def simulate_level_measurements(level_bw_bytes_per_s: float,
                                level_alpha_s: float,
                                sizes_bytes: Sequence[float],
                                seed: int,
                                rel_noise: float = 5e-4
                                ) -> Dict[str, Tuple[List[float],
                                                     List[float]]]:
    """One level's full collective sweep from its fabric truth:
    ``{collective: (sizes, times)}``, each collective's curve shaped
    by :data:`_SIM_COLLECTIVE_SHAPE` and independently seeded."""
    out = {}
    for i, coll in enumerate(CALIBRATED_COLLECTIVES):
        a_scale, b_scale = _SIM_COLLECTIVE_SHAPE[coll]
        times = simulate_sweep(level_alpha_s * a_scale,
                               level_bw_bytes_per_s * b_scale,
                               sizes_bytes, seed=seed * 1000 + i,
                               rel_noise=rel_noise)
        out[coll] = (list(float(s) for s in sizes_bytes), times)
    return out


# -- the artifact -----------------------------------------------------------


def build_artifact(*,
                   device_kind: str,
                   platform: str,
                   n_devices: int,
                   mesh_shape: Sequence[int],
                   level_order: Sequence[str],
                   level_fits: Dict[str, Sequence[LevelFit]],
                   level_extents: Dict[str, int],
                   matmul_flops_per_s: float,
                   hbm_bytes_per_s: float,
                   source: str,
                   seed: Optional[int] = None,
                   torch_version: Optional[str] = None,
                   cuda_version: Optional[str] = None) -> Dict:
    """Assemble one versioned calibration artifact (docs/calibration.md
    "Artifact schema").  ``level_order`` is innermost-first; ``source``
    is ``"measured"`` or ``"simulated"``.  No wall-clock fields — the
    artifact of a seeded sim run is bit-reproducible."""
    if source not in ("measured", "simulated"):
        raise ValueError(f"source must be measured|simulated, got "
                         f"{source!r}")
    levels = {}
    residual_max = 0.0
    for name in level_order:
        fits = {f.collective: f.as_json() for f in level_fits[name]}
        residual_max = max(
            [residual_max] + [f.residual for f in level_fits[name]])
        levels[name] = {"extent": int(level_extents[name]),
                        "collectives": fits}
    art = {
        "schema_version": CM.CALIBRATION_SCHEMA_VERSION,
        "kind": "horovod_calibration",
        "device_kind": str(device_kind),
        "platform": str(platform),
        "n_devices": int(n_devices),
        "mesh_shape": [int(s) for s in mesh_shape],
        "level_order": [str(n) for n in level_order],
        "levels": levels,
        "matmul_flops_per_s": float(matmul_flops_per_s),
        "hbm_bytes_per_s": float(hbm_bytes_per_s),
        "fit_residual_max": residual_max,
        "source": source,
        "seed": seed,
        "torch_version": torch_version,
        "cuda_version": cuda_version,
    }
    art["calibration_fingerprint"] = CM.calibration_fingerprint(art)
    return art


def validate_calibration(data: Dict) -> List[str]:
    """Full schema check of one calibration artifact — the consumer
    subset (:func:`cost_model._calibration_schema_errors`) plus the
    per-level fit fields.  Returns the error
    list ([] = valid)."""
    errs = CM._calibration_schema_errors(data)
    if errs:
        return errs
    for name in data["level_order"]:
        lv = data["levels"][name]
        if int(lv.get("extent", 0)) < 1:
            errs.append(f"level {name!r}: extent must be >= 1")
        colls = lv.get("collectives", {})
        if not colls:
            errs.append(f"level {name!r}: no collective fits")
        for coll, fit in colls.items():
            for field in ("alpha_s", "beta_bytes_per_s", "residual",
                          "n_points"):
                if field not in fit:
                    errs.append(
                        f"level {name!r} {coll}: missing {field!r}")
            try:
                if float(fit.get("beta_bytes_per_s", 0)) <= 0:
                    errs.append(
                        f"level {name!r} {coll}: beta must be > 0")
                if float(fit.get("alpha_s", 0)) < 0:
                    errs.append(
                        f"level {name!r} {coll}: alpha must be >= 0")
            except (TypeError, ValueError):
                errs.append(f"level {name!r} {coll}: non-numeric fit")
    fp = data.get("calibration_fingerprint")
    if fp is not None and fp != CM.calibration_fingerprint(data):
        errs.append("calibration_fingerprint does not match the "
                    "identity fields")
    return errs


def save_artifact(data: Dict, path: str) -> None:
    """Atomic JSON write (tmp + rename), sorted keys — byte-stable."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def load_artifact(path: str) -> Dict:
    with open(path) as f:
        data = json.load(f)
    errs = validate_calibration(data)
    if errs:
        raise ValueError(f"{path}: " + "; ".join(errs))
    return data


# -- the pure-sim calibrate→fit→price pipeline ----------------------------


def simulated_calibration(hw: CM.HardwareModel = CM.H100,
                          level_order: Sequence[str] = ("local", "cross"),
                          level_extents: Optional[Dict[str, int]] = None,
                          seed: int = 17,
                          sizes_bytes: Sequence[float] =
                          DEFAULT_SWEEP_BYTES,
                          rel_noise: float = 5e-4) -> Dict:
    """The whole pipeline without hardware: simulate each level's sweep
    from a preset's truth, fit, assemble the artifact.  Innermost
    level takes the preset's in-node (``ici``) figures, every outer level
    the between-node (``dcn``)
    figures (matching :func:`cost_model.level_bandwidths`)."""
    level_extents = dict(level_extents or
                         {n: 2 for n in level_order})
    n_devices = 1
    for n in level_order:
        n_devices *= level_extents[n]
    level_fits: Dict[str, List[LevelFit]] = {}
    for li, name in enumerate(level_order):
        bw = hw.ici_bytes_per_s if li == 0 else hw.dcn_bytes_per_s
        alpha = 2e-6 if li == 0 else 50e-6   # in a node ~µs, between nodes ~tens
        sweeps = simulate_level_measurements(
            bw, alpha, sizes_bytes, seed=seed + li,
            rel_noise=rel_noise)
        level_fits[name] = [fit_level(coll, sizes, times)
                            for coll, (sizes, times) in sweeps.items()]
    return build_artifact(
        device_kind=f"simulated:{hw.name}", platform="sim",
        n_devices=n_devices,
        mesh_shape=[level_extents[n] for n in reversed(level_order)],
        level_order=level_order, level_fits=level_fits,
        level_extents=level_extents,
        matmul_flops_per_s=hw.peak_flops_per_s,
        hbm_bytes_per_s=hw.hbm_bytes_per_s,
        source="simulated", seed=seed)


# -- the measured sweep -----------------------------------------------------


#: The largest message a sweep times over gloo (the host plane is slow, as
#: the JAX package caps its sweep off the TPU).
HOST_MAX_BYTES = 2 ** 22


def _timer(torch, device):
    """``time_s(fn, reps)``: the best of ``reps`` timed calls after one
    warm call, with CUDA events on a card and the host clock on the CPU."""
    import time

    def time_s(fn, reps: int = 3) -> float:
        fn()
        best = float("inf")
        for _ in range(reps):
            if device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                fn()
                best = min(best, time.perf_counter() - t0)
        return best

    return time_s


def _collective(dist, C, coll: str, x, group, n: int):
    """A closure that runs one collective of ``x`` (flat fp32) over
    ``group`` of extent ``n``."""
    if coll == "allreduce":
        return lambda: dist.all_reduce(x, group=group)
    if coll == "reduce_scatter":
        out = x.new_empty(x.numel() // n)
        return lambda: C._reduce_scatter_tensor(out, x, group)
    if coll == "all_gather":
        part = x[: x.numel() // n]
        out = x.new_empty(part.numel() * n)
        return lambda: C._all_gather_tensor(out, part, group)
    if coll == "ppermute":
        me = dist.get_rank(group)
        nxt = dist.get_global_rank(group, (me + 1) % n)
        prv = dist.get_global_rank(group, (me - 1) % n)
        recv = x.new_empty(x.shape)

        def ring():
            ops = [dist.P2POp(dist.isend, x, nxt, group),
                   dist.P2POp(dist.irecv, recv, prv, group)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()

        return ring
    out = x.new_empty(x.numel())
    return lambda: dist.all_to_all_single(out, x, group=group)


def measure_rates(device, reps: int = 3, matmul_k: Optional[int] = None,
                  stream_elems: Optional[int] = None) -> Tuple[float, float]:
    """This device's ``(matmul FLOP/s, memory bytes/s)``: a bf16
    ``torch.matmul`` of two ``matmul_k``-square operands (4096 on a card,
    256 on the CPU) and an fp32 multiply over ``stream_elems`` elements
    (2**26 on a card, 2**20 on the CPU), read and write counted, each the
    best of ``reps`` after a warm call (:func:`_timer`)."""
    import torch

    on_card = device.type == "cuda"
    time_s = _timer(torch, device)
    k = matmul_k or (4096 if on_card else 256)
    a = torch.ones((k, k), dtype=torch.bfloat16, device=device)
    t_mm = time_s(lambda: torch.matmul(a, a), reps)
    elems = stream_elems or (2 ** 26 if on_card else 2 ** 20)
    v = torch.ones(elems, dtype=torch.float32, device=device)
    o = torch.empty_like(v)
    t_hbm = time_s(lambda: torch.mul(v, 1.0000001, out=o), reps)
    return 2.0 * k ** 3 / t_mm, 8.0 * elems / t_hbm


def measure_artifact(out_path: Optional[str] = None,
                     sizes_bytes: Optional[Sequence[int]] = None,
                     reps: int = 3,
                     matmul_k: Optional[int] = None,
                     stream_elems: Optional[int] = None) -> Dict:
    """The measured calibration of this world (``bench.py``'s
    ``run_calibrate``): every collective of :data:`CALIBRATED_COLLECTIVES`
    timed on each layout level of extent > 1 across ``sizes_bytes``
    (default :data:`DEFAULT_SWEEP_BYTES`, capped at
    :data:`HOST_MAX_BYTES` over gloo), each size's time the slowest rank's
    best of ``reps``; and :func:`measure_rates`, the slowest rank's.
    Every rank of the world calls it and gets the
    same artifact; with ``out_path``, rank 0 saves it.  Raises
    ``ValueError`` on a world whose every level has extent 1, and on a
    world of more than one node whose ranks are not laid out in rank
    order (``runtime/state.layout_group``)."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.runtime import state

    st = state.global_state()
    device = st.device
    extents = {"local": st.local_size, "cross": st.cross_size}
    # innermost-first, extent-1 levels dropped: a sweep over a level of
    # one rank times a no-op and the fit cannot separate alpha from beta
    level_names = [n for n in ("local", "cross") if extents[n] > 1]
    if not level_names:
        raise ValueError("measure_artifact needs a multi-device mesh to "
                         "time collectives; use simulated_calibration for "
                         "the deterministic single-device path")
    on_card = device.type == "cuda"
    cap = 2 ** 27 if on_card else HOST_MAX_BYTES
    sweep = [int(s) for s in (sizes_bytes or DEFAULT_SWEEP_BYTES)
             if s <= cap]
    time_s = _timer(torch, device)
    times: Dict[Tuple[str, str], List[float]] = {}
    level_sizes: Dict[str, List[float]] = {}
    for name in level_names:
        group = st.layout_group(name)
        n = extents[name]
        counts = [max(n, nbytes // 4) for nbytes in sweep]
        counts = [c + (-c) % n for c in counts]     # a2a/RS divisibility
        level_sizes[name] = [4.0 * c for c in counts]
        for coll in CALIBRATED_COLLECTIVES:
            times[(name, coll)] = [
                time_s(_collective(dist, C, coll, torch.ones(
                    c, dtype=torch.float32, device=device), group, n), reps)
                for c in counts]
    # the slowest rank's time of each point, so every rank fits the same
    keys = list(times)
    flat = torch.tensor([t for k in keys for t in times[k]],
                        dtype=torch.float64, device=device)
    dist.all_reduce(flat, op=dist.ReduceOp.MAX)
    flat = flat.tolist()
    level_fits: Dict[str, List[LevelFit]] = {n: [] for n in level_names}
    for i, (name, coll) in enumerate(keys):
        level_fits[name].append(fit_level(
            coll, level_sizes[name],
            flat[i * len(sweep):(i + 1) * len(sweep)]))

    rates = torch.tensor(measure_rates(device, reps, matmul_k, stream_elems),
                         dtype=torch.float64, device=device)
    dist.all_reduce(rates, op=dist.ReduceOp.MIN)
    matmul_flops, hbm_rate = rates.tolist()

    art = build_artifact(
        device_kind=(torch.cuda.get_device_name(device) if on_card
                     else "cpu"),
        platform="gpu" if on_card else "cpu",
        n_devices=st.size,
        mesh_shape=[st.cross_size, st.local_size],
        level_order=level_names,
        level_fits=level_fits,
        level_extents={n: extents[n] for n in level_names},
        matmul_flops_per_s=matmul_flops,
        hbm_bytes_per_s=hbm_rate,
        source="measured",
        torch_version=torch.__version__,
        cuda_version=torch.version.cuda)
    errs = validate_calibration(art)
    if errs:
        raise ValueError("measure_artifact produced an invalid artifact: "
                         + "; ".join(errs))
    if out_path and st.rank == 0:
        save_artifact(art, out_path)
    return art
