"""Leveled, per-rank-prefixed logging (``horovod_tpu/utils/logging.py``).

The launcher's logger: TRACE..FATAL levels selected by the
``HOROVOD_LOG_LEVEL`` env var, optional timestamp hiding via
``HOROVOD_LOG_HIDE_TIME``, and a ``[rank]`` prefix on every line so
interleaved multi-process output stays attributable.  The JAX package
also appends its telemetry run context to each line; the port has no run
context, so its lines stop at the rank.
"""

from __future__ import annotations

import logging
import os
import sys
import time

TRACE = 5
DEBUG = logging.DEBUG
INFO = logging.INFO
WARNING = logging.WARNING
ERROR = logging.ERROR
FATAL = logging.CRITICAL

_LEVELS = {
    "trace": TRACE,
    "debug": DEBUG,
    "info": INFO,
    "warning": WARNING,
    "error": ERROR,
    "fatal": FATAL,
}

logging.addLevelName(TRACE, "TRACE")

_logger: logging.Logger | None = None


class _RankFilter(logging.Filter):
    """Injects the current process rank into every record."""

    def filter(self, record: logging.LogRecord) -> bool:
        from horovod_tpu_torch.runtime import state

        record.rank = state.global_state().rank if state.is_initialized() \
            else -1
        return True


class _Formatter(logging.Formatter):
    def __init__(self, hide_time: bool):
        self._hide_time = hide_time
        super().__init__()

    def format(self, record: logging.LogRecord) -> str:
        rank = getattr(record, "rank", -1)
        prefix = f"[{record.levelname}"
        if not self._hide_time:
            ts = time.strftime("%Y-%m-%d %H:%M:%S",
                               time.localtime(record.created))
            prefix += f" {ts}.{int(record.msecs):03d}"
        if rank >= 0:
            prefix += f" rank {rank}"
        return f"{prefix}] {record.getMessage()}"


def get_logger() -> logging.Logger:
    """Return the process-wide launcher logger, configuring it on first
    use."""
    global _logger
    if _logger is not None:
        return _logger
    logger = logging.getLogger("horovod_tpu_torch.runner")
    level_name = os.environ.get("HOROVOD_LOG_LEVEL", "warning").lower()
    logger.setLevel(_LEVELS.get(level_name, WARNING))
    handler = logging.StreamHandler(sys.stderr)
    hide_time = os.environ.get("HOROVOD_LOG_HIDE_TIME", "0") in ("1", "true")
    handler.setFormatter(_Formatter(hide_time))
    handler.addFilter(_RankFilter())
    logger.addHandler(handler)
    logger.propagate = False
    _logger = logger
    return logger


def trace(msg: str, *args) -> None:
    get_logger().log(TRACE, msg, *args)


def debug(msg: str, *args) -> None:
    get_logger().debug(msg, *args)


def info(msg: str, *args) -> None:
    get_logger().info(msg, *args)


def warning(msg: str, *args) -> None:
    get_logger().warning(msg, *args)


def error(msg: str, *args) -> None:
    get_logger().error(msg, *args)
