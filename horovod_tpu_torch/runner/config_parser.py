"""CLI args / YAML config → ``HOROVOD_*`` env plumbing
(``horovod_tpu/runner/config_parser.py``).

Reference: ``horovod/runner/common/util/config_parser.py`` — a YAML
``--config-file`` populates defaults for CLI args, and resolved args are
exported as the env vars the core reads.  The mapping is the JAX
package's, flag for flag and variable for variable, so that one command
line drives both packages; a worker of the port reads those of the
variables that ``runtime/config.py`` lists (the fusion threshold, cycle
time, cache capacity and data plane) and ignores the JAX package's others
(autotune, timeline, stall check, the TPU mesh shape).
"""

from __future__ import annotations

from typing import Any, Dict

# YAML section.key → (CLI arg attribute, env var)
_PARAMS = [
    ("fusion.threshold_mb", "fusion_threshold_mb", "HOROVOD_FUSION_THRESHOLD"),
    ("fusion.cycle_time_ms", "cycle_time_ms", "HOROVOD_CYCLE_TIME"),
    ("cache.capacity", "cache_capacity", "HOROVOD_CACHE_CAPACITY"),
    ("autotune.enabled", "autotune", "HOROVOD_AUTOTUNE"),
    ("autotune.log_file", "autotune_log_file", "HOROVOD_AUTOTUNE_LOG"),
    ("autotune.warmup_samples", "autotune_warmup_samples",
     "HOROVOD_AUTOTUNE_WARMUP_SAMPLES"),
    ("autotune.steps_per_sample", "autotune_steps_per_sample",
     "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE"),
    ("autotune.bayes_opt_max_samples", "autotune_bayes_opt_max_samples",
     "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES"),
    ("autotune.gaussian_process_noise", "autotune_gaussian_process_noise",
     "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE"),
    ("logging.level", "log_level", "HOROVOD_LOG_LEVEL"),
    ("logging.hide_timestamp", "log_hide_timestamp",
     "HOROVOD_LOG_HIDE_TIME"),
    ("timeline.filename", "timeline_filename", "HOROVOD_TIMELINE"),
    ("timeline.mark_cycles", "timeline_mark_cycles",
     "HOROVOD_TIMELINE_MARK_CYCLES"),
    ("stall_check.disable", "no_stall_check", "HOROVOD_STALL_CHECK_DISABLE"),
    ("stall_check.warning_time_seconds", "stall_warning_time_seconds",
     "HOROVOD_STALL_CHECK_TIME_SECONDS"),
    ("stall_check.shutdown_time_seconds", "stall_shutdown_time_seconds",
     "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS"),
    ("library_options.mesh_shape", "mesh_shape", "HOROVOD_TPU_MESH_SHAPE"),
    ("library_options.tpu_operations", "tpu_operations",
     "HOROVOD_TPU_OPERATIONS"),
]


def load_config_file(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def apply_config_defaults(args, config: Dict[str, Any]) -> None:
    """Fill unset CLI args from the YAML config (CLI wins — reference
    ``config_parser`` precedence)."""
    for dotted, attr, _ in _PARAMS:
        if getattr(args, attr, None) is not None:
            continue
        section, _, key = dotted.partition(".")
        value = (config.get(section) or {}).get(key)
        if value is not None:
            setattr(args, attr, value)


def set_env_from_args(env: Dict[str, str], args) -> Dict[str, str]:
    """Export resolved args as the worker env contract (reference
    ``set_env_from_args``)."""
    for _, attr, env_var in _PARAMS:
        value = getattr(args, attr, None)
        if value is None:
            continue
        if isinstance(value, bool):
            if value:
                env[env_var] = "1"
        elif attr == "fusion_threshold_mb":
            env[env_var] = str(int(value) * 1024 * 1024)
        else:
            env[env_var] = str(value)
    # --disable-cache is the reference's spelling for cache capacity 0
    if getattr(args, "disable_cache", None):
        env["HOROVOD_CACHE_CAPACITY"] = "0"
    # restrict gloo's CPU collectives to the requested interfaces
    if getattr(args, "nics", None):
        env["GLOO_SOCKET_IFNAME"] = args.nics
    return env
