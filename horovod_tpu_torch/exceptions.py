"""The two control-flow exceptions of elastic training (reference
``horovod/common/exceptions.py``)."""

from __future__ import annotations


class HorovodInternalError(Exception):
    """Internal error raised from a collective — under elastic training this
    triggers state restore + reinitialization (reference ``exceptions.py:18``)."""


class HostsUpdatedInterrupt(Exception):
    """Raised between batches when the host set changed; training continues
    with current (not rolled back) state after re-rendezvous (reference
    ``exceptions.py:26``)."""

    def __init__(self, skip_sync: bool = False):
        super().__init__()
        self.skip_sync = skip_sync


class HorovodTpuError(RuntimeError):
    """Generic framework error."""
