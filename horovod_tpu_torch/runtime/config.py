"""Runtime configuration from the ``HOROVOD_*`` environment contract.

The part of ``horovod_tpu/runtime/config.py`` the PyTorch port reads: the
launcher's identity knobs, the coordinator address, the fusion threshold,
the eager plane's cycle time, negotiation-cache capacity and data plane, the
sharded exchange's bucket cap, topology, wire codec and reduction
operator, the fused-collectives mode, the sequence-parallel ring's layout,
the parallelism plan and the MoE dispatch knobs, under the same ``HOROVOD_*`` names and
with the same defaults, so one environment drives both packages.  A knob
joins ``KNOWN_KNOBS`` and ``Config`` in the slice that ports the subsystem reading it.  The JAX
package's jsrun/PMIx identity fallback is not copied: the port's launcher
contract is the ``HOROVOD_*`` variables alone.
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
    # -- the eager plane (ops/eager.py, ops/bucketing.py, ops/op_manager.py)
    "HOROVOD_CYCLE_TIME", "HOROVOD_CACHE_CAPACITY", "HOROVOD_TPU_OPERATIONS",
    # -- the sharded exchange (optim/optimizer.py, ops/collectives.py)
    "HOROVOD_EXCHANGE_BUCKET_BYTES", "HOROVOD_EXCHANGE_HIERARCHY",
    "HOROVOD_EXCHANGE_WIRE_DTYPE", "HOROVOD_EXCHANGE_REDUCTION",
    # -- tile-fused matmul⊗collective rings (ops/fused_collectives.py)
    "HOROVOD_FUSED_COLLECTIVES",
    # -- the sp ring's sequence layout (parallel/ring_attention.py)
    "HOROVOD_SP_LAYOUT",
    # -- the parallelism plan (parallel/plan.py, DistributedTrainStep)
    "HOROVOD_PLAN",
    # -- MoE expert-parallel dispatch (models/moe.py; DistributedTrainStep's
    #    moe_fused / moe_capacity_factor, applied to the model it trains)
    "HOROVOD_MOE_FUSED_DISPATCH", "HOROVOD_MOE_CAPACITY_FACTOR",
})


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
    # validated collectives, at the same cycle on every rank
    cache_capacity: int = 1024

    # -- the sharded exchange (shard_optimizer_states=True): bucket byte
    # cap (None: one bucket) and topology ("auto" resolves against the
    # world's (cross, local) extents, runtime/topology.py), read by
    # DistributedTrainStep; the wire codec of Compression.int8 ("int8" or
    # "fp8_e4m3") and the combine operator ("sum" or "adasum")
    exchange_bucket_bytes: Optional[int] = None
    exchange_hierarchy: str = "auto"
    exchange_wire_dtype: str = "int8"
    exchange_reduction: str = "sum"

    # -- tile-fused rings at the tensor-parallel boundaries: "auto",
    # "on" or "off" (ops/fused_collectives.resolve_fused_collectives)
    fused_collectives: str = "auto"

    # -- the parallelism plan's HOROVOD_PLAN string (parallel/plan.py), read
    # by DistributedTrainStep when no plan is passed
    plan: Optional[str] = None

    @staticmethod
    def from_env() -> "Config":
        def opt_int(name: str) -> Optional[int]:
            v = os.environ.get(name)
            return int(v) if v not in (None, "") else None

        return Config(
            rank=opt_int("HOROVOD_RANK"),
            size=opt_int("HOROVOD_SIZE"),
            local_rank=opt_int("HOROVOD_LOCAL_RANK"),
            local_size=opt_int("HOROVOD_LOCAL_SIZE"),
            cross_rank=opt_int("HOROVOD_CROSS_RANK"),
            cross_size=opt_int("HOROVOD_CROSS_SIZE"),
            coordinator_addr=os.environ.get("HOROVOD_COORDINATOR_ADDR"),
            tpu_operations=os.environ.get("HOROVOD_TPU_OPERATIONS",
                                          "XLA").upper(),
            fusion_threshold_bytes=_env_int(
                "HOROVOD_FUSION_THRESHOLD", 64 * 1024 * 1024),
            cycle_time_ms=_env_float("HOROVOD_CYCLE_TIME", 5.0),
            cache_capacity=_env_int("HOROVOD_CACHE_CAPACITY", 1024),
            exchange_bucket_bytes=opt_int("HOROVOD_EXCHANGE_BUCKET_BYTES"),
            exchange_hierarchy=os.environ.get(
                "HOROVOD_EXCHANGE_HIERARCHY", "auto").lower(),
            exchange_wire_dtype=os.environ.get(
                "HOROVOD_EXCHANGE_WIRE_DTYPE", "int8").lower(),
            exchange_reduction=os.environ.get(
                "HOROVOD_EXCHANGE_REDUCTION", "sum").lower(),
            fused_collectives=os.environ.get(
                "HOROVOD_FUSED_COLLECTIVES", "auto").lower(),
            plan=os.environ.get("HOROVOD_PLAN"),
        )


# The sp ring's layout is read when the ring is dispatched, not at init(),
# as in the JAX package (parallel/ring_attention.py), so a knob set after
# init() still steers the next call.

def sp_layout() -> str:
    """``HOROVOD_SP_LAYOUT``: the sp ring's sequence layout, default
    ``contiguous``."""
    return os.environ.get("HOROVOD_SP_LAYOUT", "contiguous")
