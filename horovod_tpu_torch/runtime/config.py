"""Runtime configuration from the ``HOROVOD_*`` environment contract.

The part of ``horovod_tpu/runtime/config.py`` the PyTorch port reads: the
launcher's identity knobs, the coordinator address, the fusion threshold,
the eager plane's cycle time, negotiation-cache capacity and data plane, the
sharded exchange's bucket cap, topology, wire codec, per-level codecs and
reduction operator, the fused-collectives mode, the sequence-parallel ring's layout,
the parallelism plan, the MoE dispatch knobs, the input pipeline's
prefetch depth and thread count, the runtime tools (the timeline, the
stall inspector, the parameter manager and the metrics exporters, with the
set of knobs the user fixed), the memory plane, the hardware model and
the training-state guard and the chaos layer's fault plan (the serving
plane's knobs and the core sets of ``HOROVOD_THREAD_AFFINITY`` are read
where they are used),
under the same ``HOROVOD_*`` names and with the same defaults, so one
environment drives both packages (the degrade knobs are read where they
are used, as in the JAX package).  A knob
joins ``KNOWN_KNOBS`` and ``Config`` in the slice that ports the subsystem
reading it.  When ``HOROVOD_RANK`` is unset, the identity falls back to the
PMIx, OpenMPI or MPICH variables that ``mpirun`` and ``jsrun`` give each rank
(``runner/cluster_env.jsm_identity``), as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


# The HOROVOD_* variables the port reads (reference knob table
# common.h:64-90); every other one the JAX package knows is ignored here.
KNOWN_KNOBS = frozenset({
    # -- process identity (set by the launcher)
    "HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
    "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK", "HOROVOD_CROSS_SIZE",
    "HOROVOD_COORDINATOR_ADDR",
    # -- fusion
    "HOROVOD_FUSION_THRESHOLD",
    # -- the compile cache's store (runtime/compile_cache.py)
    "HOROVOD_COMPILE_CACHE", "HOROVOD_COMPILE_CACHE_DIR",
    # -- the chaos layer's plan (faults/plan.py)
    "HOROVOD_FAULT_PLAN",
    # -- this worker's core set, applied by init() (utils/affinity.py)
    "HOROVOD_THREAD_AFFINITY",
    # -- the eager plane (ops/eager.py, ops/bucketing.py, ops/op_manager.py)
    "HOROVOD_CYCLE_TIME", "HOROVOD_CACHE_CAPACITY", "HOROVOD_TPU_OPERATIONS",
    # -- the sharded exchange (optim/optimizer.py, ops/collectives.py)
    "HOROVOD_EXCHANGE_BUCKET_BYTES", "HOROVOD_EXCHANGE_HIERARCHY",
    "HOROVOD_EXCHANGE_WIRE_DTYPE", "HOROVOD_EXCHANGE_REDUCTION",
    "HOROVOD_EXCHANGE_LEVEL_CODECS",
    # -- tile-fused matmul⊗collective rings (ops/fused_collectives.py)
    "HOROVOD_FUSED_COLLECTIVES",
    # -- the sp ring's sequence layout (parallel/ring_attention.py)
    "HOROVOD_SP_LAYOUT",
    # -- the parallelism plan (parallel/plan.py, DistributedTrainStep)
    "HOROVOD_PLAN",
    # -- MoE expert-parallel dispatch (models/moe.py; DistributedTrainStep's
    #    moe_fused / moe_capacity_factor, applied to the model it trains)
    "HOROVOD_MOE_FUSED_DISPATCH", "HOROVOD_MOE_CAPACITY_FACTOR",
    # -- the input pipeline (data/prefetch.py)
    "HOROVOD_PREFETCH_DEPTH", "HOROVOD_INPUT_THREADS",
    # -- the row-sparse exchange's dropped-rows warning (optim/optimizer.py)
    "HOROVOD_DEBUG_SPARSE",
    # -- the launcher (runner/): the controller stamp it gives each worker,
    #    run()'s service address and key, the probe task's key, the
    #    discovery cache's lifetime, the LSF node shape, its logger
    "HOROVOD_CONTROLLER", "HOROVOD_SECRET_KEY", "HOROVOD_RUN_SECRET",
    "HOROVOD_RUN_SERVICE_ADDR", "HOROVOD_TPU_DISCOVERY_CACHE_TTL",
    "HOROVOD_LSF_ACCELERATORS_PER_NODE", "HOROVOD_LSF_CORES_PER_NODE",
    "HOROVOD_LSF_THREADS_PER_CORE", "HOROVOD_LOG_LEVEL",
    "HOROVOD_LOG_HIDE_TIME",
    # -- the elastic runtime (elastic/, runtime/distributed.py): the
    #    driver's and the worker's addresses, the generation, the health
    #    plane's timings, the host quarantine, the worker's host name
    "HOROVOD_ELASTIC", "HOROVOD_ELASTIC_DRIVER_ADDR",
    "HOROVOD_ELASTIC_NOTIFY_ADDR", "HOROVOD_ELASTIC_GENERATION",
    "HOROVOD_ELASTIC_START_TIMEOUT", "HOROVOD_ELASTIC_HEARTBEAT_TIMEOUT",
    "HOROVOD_ELASTIC_HEARTBEAT_INTERVAL",
    "HOROVOD_ELASTIC_HEARTBEAT_SUSPECT_MISSES",
    "HOROVOD_ELASTIC_HEARTBEAT_DEAD_S",
    "HOROVOD_ELASTIC_PROGRESS_TIMEOUT_S",
    "HOROVOD_ELASTIC_DEPART_GRACE_S",
    "HOROVOD_ELASTIC_STRAGGLER_RATIO",
    "HOROVOD_QUARANTINE_BASE_S", "HOROVOD_QUARANTINE_MAX_S",
    "HOROVOD_QUARANTINE_PROBATION_S", "HOROVOD_QUARANTINE_DISABLE",
    "HOROVOD_HOSTNAME",
    # -- the runtime tools (utils/timeline.py, utils/stall.py,
    #    utils/autotune.py, telemetry/export.py)
    "HOROVOD_TIMELINE", "HOROVOD_TIMELINE_MARK_CYCLES",
    "HOROVOD_TIMELINE_PYTHON", "HOROVOD_STALL_CHECK_DISABLE",
    "HOROVOD_STALL_CHECK_TIME_SECONDS", "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS",
    "HOROVOD_AUTOTUNE", "HOROVOD_AUTOTUNE_LOG",
    "HOROVOD_AUTOTUNE_WARMUP_SAMPLES", "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES",
    "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE",
    "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", "HOROVOD_METRICS",
    "HOROVOD_METRICS_PORT", "HOROVOD_METRICS_LOG",
    "HOROVOD_METRICS_INTERVAL_S", "HOROVOD_RUN_ID",
    # -- the hardware model (analysis/cost_model.py): calibration artifact
    #    > preset > the card's preset > h100
    "HOROVOD_CALIBRATION_PATH", "HOROVOD_HW_PRESET",
    # -- plan-aware graceful degradation (elastic/degrade.py)
    "HOROVOD_DEGRADE", "HOROVOD_DEGRADE_WAIT_S",
    "HOROVOD_DEGRADE_MIN_DATA_EXTENT", "HOROVOD_DEGRADE_PROMOTE",
    # -- the memory plane (memory/): remat tier, the planner's budget,
    #    host offload
    "HOROVOD_REMAT_POLICY", "HOROVOD_HBM_BUDGET_BYTES",
    "HOROVOD_OFFLOAD_OPTIMIZER", "HOROVOD_OFFLOAD_DEPTH",
    # -- the training-state guard (guard/, DistributedTrainStep(guard=))
    "HOROVOD_GUARD", "HOROVOD_GUARD_POLICY",
    "HOROVOD_GUARD_CHECK_INTERVAL", "HOROVOD_GUARD_ZSCORE",
    "HOROVOD_GUARD_WARMUP_STEPS", "HOROVOD_GUARD_EMA",
    "HOROVOD_GUARD_PREEMPT",
    # -- the serving plane (serve/): read where they are used, as in the
    #    JAX package
    "HOROVOD_SERVE_QUEUE_DEPTH", "HOROVOD_SERVE_MAX_REQUEUES",
    "HOROVOD_SERVE_MAX_BATCH", "HOROVOD_SERVE_DRAIN_TIMEOUT_S",
    "HOROVOD_SERVE_SCALE_UP_DEPTH", "HOROVOD_SERVE_SCALE_DOWN_DEPTH",
    "HOROVOD_SERVE_OVERLOAD_FRACTION", "HOROVOD_SERVE_REFRESH_VERIFY",
    "HOROVOD_SERVE_SCALE_HOLD_S", "HOROVOD_SERVE_SCALE_COOLDOWN_S",
    "HOROVOD_SERVE_SCALE_MIN_REPLICAS",
    "HOROVOD_SERVE_SCALE_MAX_REPLICAS",
})

#: the launcher's stamp on every worker (``HOROVOD_CONTROLLER``): the
#: port's control plane is a gloo group, as under reference Horovod's
#: ``gloo_run``
CONTROLLER = "gloo"


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return float(v)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {v!r}")


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {v!r}")


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v.lower() in ("1", "true", "yes", "on")


#: the knobs a set ``HOROVOD_*`` variable fixes: the parameter manager
#: never tunes them (reference "fixed" flag, ``operations.cc:436``)
_FIXABLE = (
    ("HOROVOD_FUSION_THRESHOLD", "fusion_threshold_bytes"),
    ("HOROVOD_CYCLE_TIME", "cycle_time_ms"),
    ("HOROVOD_CACHE_CAPACITY", "cache_capacity"),
    ("HOROVOD_EXCHANGE_BUCKET_BYTES", "exchange_bucket_bytes"),
    ("HOROVOD_EXCHANGE_HIERARCHY", "exchange_hierarchy"),
    ("HOROVOD_EXCHANGE_WIRE_DTYPE", "exchange_wire_dtype"),
    ("HOROVOD_EXCHANGE_LEVEL_CODECS", "exchange_level_codecs"),
    ("HOROVOD_EXCHANGE_REDUCTION", "exchange_reduction"),
    ("HOROVOD_FUSED_COLLECTIVES", "fused_collectives"),
    ("HOROVOD_PLAN", "plan"),
    ("HOROVOD_REMAT_POLICY", "remat_policy"),
    ("HOROVOD_OFFLOAD_OPTIMIZER", "offload_optimizer"),
)


@dataclasses.dataclass
class Config:
    """The port's runtime knobs, resolved once at ``init()`` time.

    Mirrors the env contract in the reference (``common.h:64-90``,
    ``gloo_context.cc:47-55``).
    """

    # -- process identity (set by the launcher; reference gloo_context.cc:47-55)
    rank: Optional[int] = None
    size: Optional[int] = None
    local_rank: Optional[int] = None
    local_size: Optional[int] = None
    cross_rank: Optional[int] = None
    cross_size: Optional[int] = None

    # -- rendezvous of the torch.distributed process group (host:port)
    coordinator_addr: Optional[str] = None

    # -- the eager plane's data plane (ops/op_manager.py): "XLA", the JAX
    # package's name for its device plane, selects the port's (NCCL on a
    # card, the world's gloo group on the CPU); "HOST" gathers over the
    # host gloo group and reduces on the host
    tpu_operations: str = "XLA"

    # -- fusion / bucketing (reference: 64 MiB default, operations.cc:432)
    fusion_threshold_bytes: int = 64 * 1024 * 1024
    # advisory, as in the JAX package: the eager Bucketer has no background
    # thread and flushes at the byte threshold and on synchronize/poll
    cycle_time_ms: float = 5.0
    # bounds the eager negotiation caches (reference response-cache
    # capacity, response_cache.h); both clear together past this many
    # validated collectives, at the same cycle on every rank.  The same
    # value bounds the captured graphs of the in-memory executable layer
    # and the entries of the disk store (runtime/compile_cache.py)
    cache_capacity: int = 1024

    # -- warm-start compile cache (runtime/compile_cache.py): the store of
    # the compiled kernel and native libraries, shared across process
    # restarts and elastic generations; disabled, a process builds into a
    # directory of its own, removed at exit
    compile_cache_enabled: bool = True
    compile_cache_dir: Optional[str] = None   # None → <repo>/build

    # -- the sharded exchange (shard_optimizer_states=True): bucket byte
    # cap (None: one bucket) and topology ("auto" resolves against the
    # world's (cross, local) extents, runtime/topology.py), read by
    # DistributedTrainStep; the wire codec of Compression.int8 ("int8" or
    # "fp8_e4m3"), the combine operator ("sum" or "adasum") and the
    # per-level codecs ("cross=int8,local=fp32",
    # topology.parse_level_codecs)
    exchange_bucket_bytes: Optional[int] = None
    exchange_hierarchy: str = "auto"
    exchange_wire_dtype: str = "int8"
    exchange_reduction: str = "sum"
    exchange_level_codecs: Optional[str] = None

    # -- tile-fused rings at the tensor-parallel boundaries: "auto",
    # "on" or "off" (ops/fused_collectives.resolve_fused_collectives)
    fused_collectives: str = "auto"

    # -- the parallelism plan's HOROVOD_PLAN string (parallel/plan.py), read
    # by DistributedTrainStep when no plan is passed
    plan: Optional[str] = None

    # -- the input pipeline (data/prefetch.py): prefetch queue bound and
    # batch-assembly thread count
    prefetch_depth: int = 2
    input_threads: int = 2

    # -- elastic (HOROVOD_ELASTIC, set by the elastic launcher): the
    # world's process group rendezvouses on the driver's store
    # (runtime/distributed.py)
    elastic_enabled: bool = False

    # -- autotune (reference parameter_manager.h:58-78): the eager
    # Bucketer's fusion threshold and cycle time, tuned online
    autotune: bool = False
    autotune_log: Optional[str] = None
    autotune_warmup_samples: int = 3
    autotune_bayes_opt_max_samples: int = 20
    autotune_gaussian_process_noise: float = 0.8
    autotune_steps_per_sample: int = 10

    # -- the telemetry plane's exporters (telemetry/export.py):
    # metrics_enabled None = auto (on iff an exporter is configured);
    # port 0 = no Prometheus endpoint; log None = no JSONL snapshots
    metrics_enabled: Optional[bool] = None
    metrics_port: int = 0
    metrics_log: Optional[str] = None
    metrics_interval_s: float = 10.0
    run_id: Optional[str] = None

    # -- timeline (reference operations.cc:417-424)
    timeline_filename: Optional[str] = None
    timeline_mark_cycles: bool = False

    # -- stall inspector (reference stall_inspector.h:73-81)
    stall_check_enabled: bool = True
    stall_warning_time_seconds: float = 60.0
    stall_shutdown_time_seconds: float = 0.0  # 0 = never

    # -- the memory plane (memory/): remat tier (None = model/step
    # default), the budget the planner must fit (None = the device's
    # capacity), host offload of the optimizer state and its ring depth
    remat_policy: Optional[str] = None
    hbm_budget_bytes: Optional[int] = None
    offload_optimizer: bool = False
    offload_depth: int = 2

    # -- the hardware model (analysis/cost_model.py): a calibration
    # artifact's path and/or a preset name ("h100", "cpu-twin")
    calibration_path: Optional[str] = None
    hw_preset: Optional[str] = None

    # -- the training-state guard (guard/): numerics guardian, replica
    # checksums, rollback-and-replay, preemption grace
    guard_enabled: bool = False
    guard_policy: str = "rollback"       # skip_step | rollback | abort
    guard_check_interval: int = 10       # replica-checksum cadence (steps)
    guard_zscore: float = 6.0            # grad-norm spike threshold
    guard_warmup_steps: int = 10         # steps before spike detection arms
    guard_ema: float = 0.99              # EMA decay for the norm baseline
    guard_preempt: bool = True           # SIGTERM graceful-departure handler

    # -- the chaos layer (faults/plan.py): the HOROVOD_FAULT_PLAN text,
    # loaded by init() (None = no plan)
    fault_plan: Optional[str] = None

    # knobs the user set explicitly, which autotune must not touch
    fixed_knobs: frozenset = frozenset()

    @staticmethod
    def from_env() -> "Config":
        def opt_int(name: str) -> Optional[int]:
            v = os.environ.get(name)
            return int(v) if v not in (None, "") else None

        # Identity fallback for mpirun/jsrun launches (hvdrun --mpi,
        # --jsrun): the ranks carry PMIX_*/OMPI_*/PMI_* variables in place
        # of HOROVOD_RANK and the local extent
        jsm = None
        if opt_int("HOROVOD_RANK") is None:
            from horovod_tpu_torch.runner.cluster_env import jsm_identity

            jsm = jsm_identity()

        return Config(
            rank=opt_int("HOROVOD_RANK") if jsm is None else jsm["rank"],
            size=opt_int("HOROVOD_SIZE") if jsm is None else jsm["size"],
            local_rank=opt_int("HOROVOD_LOCAL_RANK")
            if jsm is None else jsm["local_rank"],
            local_size=opt_int("HOROVOD_LOCAL_SIZE")
            if jsm is None else jsm["local_size"],
            cross_rank=opt_int("HOROVOD_CROSS_RANK"),
            cross_size=opt_int("HOROVOD_CROSS_SIZE"),
            coordinator_addr=os.environ.get("HOROVOD_COORDINATOR_ADDR"),
            tpu_operations=os.environ.get("HOROVOD_TPU_OPERATIONS",
                                          "XLA").upper(),
            fusion_threshold_bytes=_env_int(
                "HOROVOD_FUSION_THRESHOLD", 64 * 1024 * 1024),
            cycle_time_ms=_env_float("HOROVOD_CYCLE_TIME", 5.0),
            cache_capacity=_env_int("HOROVOD_CACHE_CAPACITY", 1024),
            compile_cache_enabled=_env_bool("HOROVOD_COMPILE_CACHE", True),
            compile_cache_dir=os.environ.get("HOROVOD_COMPILE_CACHE_DIR"),
            exchange_bucket_bytes=opt_int("HOROVOD_EXCHANGE_BUCKET_BYTES"),
            exchange_hierarchy=os.environ.get(
                "HOROVOD_EXCHANGE_HIERARCHY", "auto").lower(),
            exchange_wire_dtype=os.environ.get(
                "HOROVOD_EXCHANGE_WIRE_DTYPE", "int8").lower(),
            exchange_reduction=os.environ.get(
                "HOROVOD_EXCHANGE_REDUCTION", "sum").lower(),
            exchange_level_codecs=os.environ.get(
                "HOROVOD_EXCHANGE_LEVEL_CODECS") or None,
            fused_collectives=os.environ.get(
                "HOROVOD_FUSED_COLLECTIVES", "auto").lower(),
            plan=os.environ.get("HOROVOD_PLAN"),
            prefetch_depth=_env_int("HOROVOD_PREFETCH_DEPTH", 2),
            input_threads=_env_int("HOROVOD_INPUT_THREADS", 2),
            elastic_enabled=_env_bool("HOROVOD_ELASTIC", False),
            autotune=_env_bool("HOROVOD_AUTOTUNE", False),
            autotune_log=os.environ.get("HOROVOD_AUTOTUNE_LOG"),
            autotune_warmup_samples=_env_int(
                "HOROVOD_AUTOTUNE_WARMUP_SAMPLES", 3),
            autotune_bayes_opt_max_samples=_env_int(
                "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", 20),
            autotune_gaussian_process_noise=_env_float(
                "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE", 0.8),
            autotune_steps_per_sample=_env_int(
                "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", 10),
            metrics_enabled=(None if os.environ.get("HOROVOD_METRICS")
                             in (None, "") else
                             _env_bool("HOROVOD_METRICS", False)),
            metrics_port=_env_int("HOROVOD_METRICS_PORT", 0),
            metrics_log=os.environ.get("HOROVOD_METRICS_LOG"),
            metrics_interval_s=_env_float("HOROVOD_METRICS_INTERVAL_S",
                                          10.0),
            run_id=os.environ.get("HOROVOD_RUN_ID"),
            timeline_filename=os.environ.get("HOROVOD_TIMELINE"),
            timeline_mark_cycles=_env_bool("HOROVOD_TIMELINE_MARK_CYCLES",
                                           False),
            stall_check_enabled=not _env_bool("HOROVOD_STALL_CHECK_DISABLE",
                                              False),
            stall_warning_time_seconds=_env_float(
                "HOROVOD_STALL_CHECK_TIME_SECONDS", 60.0),
            stall_shutdown_time_seconds=_env_float(
                "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", 0.0),
            remat_policy=os.environ.get("HOROVOD_REMAT_POLICY") or None,
            hbm_budget_bytes=opt_int("HOROVOD_HBM_BUDGET_BYTES"),
            offload_optimizer=_env_bool("HOROVOD_OFFLOAD_OPTIMIZER", False),
            offload_depth=_env_int("HOROVOD_OFFLOAD_DEPTH", 2),
            calibration_path=os.environ.get("HOROVOD_CALIBRATION_PATH")
            or None,
            hw_preset=os.environ.get("HOROVOD_HW_PRESET") or None,
            guard_enabled=_env_bool("HOROVOD_GUARD", False),
            guard_policy=os.environ.get("HOROVOD_GUARD_POLICY",
                                        "rollback").lower(),
            guard_check_interval=_env_int("HOROVOD_GUARD_CHECK_INTERVAL",
                                          10),
            guard_zscore=_env_float("HOROVOD_GUARD_ZSCORE", 6.0),
            guard_warmup_steps=_env_int("HOROVOD_GUARD_WARMUP_STEPS", 10),
            guard_ema=_env_float("HOROVOD_GUARD_EMA", 0.99),
            guard_preempt=_env_bool("HOROVOD_GUARD_PREEMPT", True),
            fault_plan=os.environ.get("HOROVOD_FAULT_PLAN"),
            fixed_knobs=frozenset(
                knob for name, knob in _FIXABLE
                if os.environ.get(name) not in (None, "")),
        )


# The sp ring's layout is read when the ring is dispatched, not at init(),
# as in the JAX package (parallel/ring_attention.py), so a knob set after
# init() still steers the next call.

def sp_layout() -> str:
    """``HOROVOD_SP_LAYOUT``: the sp ring's sequence layout, default
    ``contiguous``."""
    return os.environ.get("HOROVOD_SP_LAYOUT", "contiguous")
