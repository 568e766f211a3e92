"""Process execution with whole-tree cleanup
(``horovod_tpu/runner/safe_shell_exec.py``).

Reference: ``horovod/runner/common/util/safe_shell_exec.py`` — start the
child in a session of its own so that it owns a process group, SIGTERM
the group on termination with a grace period, then SIGKILL
(``GRACEFUL_TERMINATION_TIME_S``).  A rank that waits inside
``init_process_group`` for a peer that died is killed this way when the
launcher's abort event fires, instead of sitting out torch's rendezvous
timeout.  The reference adds a middleman process to survive launcher
death; here the child's group is terminated when the launcher is
interrupted (Ctrl-C, or SIGTERM, which ``hvdrun`` turns into one), since
a child in its own session sees no signal meant for the launcher.  The
JAX package's registry for a ``terminate_all`` that nothing calls is not
copied.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import Dict, IO, List, Optional

GRACEFUL_TERMINATION_TIME_S = 5.0


def terminate(proc: subprocess.Popen,
              grace_s: float = GRACEFUL_TERMINATION_TIME_S) -> None:
    """SIGTERM the child's process group, escalate to SIGKILL after the
    grace period (reference semantics)."""
    if proc.poll() is not None:
        return
    try:
        os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
    except (ProcessLookupError, PermissionError):
        return
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            return
        time.sleep(0.05)
    try:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass


def execute(command: List[str], env: Optional[Dict[str, str]] = None,
            stdout: Optional[IO] = None, stderr: Optional[IO] = None,
            events: Optional[list] = None) -> int:
    """Run to completion in a process group of its own; on any event in
    ``events`` (``threading.Event``), or an interrupt of this thread,
    terminate the whole tree.  Returns the exit code."""
    proc = subprocess.Popen(
        command, env=env,
        stdout=stdout if stdout is not None else sys.stdout,
        stderr=stderr if stderr is not None else sys.stderr,
        start_new_session=True)   # child leads its own process group
    try:
        if not events:
            return proc.wait()
        while True:
            try:
                return proc.wait(timeout=0.25)
            except subprocess.TimeoutExpired:
                if any(e.is_set() for e in events):
                    terminate(proc)
                    return proc.wait()
    except BaseException:
        terminate(proc)
        raise
