"""jsrun/LSF launch path (``horovod_tpu/runner/js_run.py``).

Reference: ``horovod/runner/js_run.py`` — on LSF clusters the launcher
does not ssh-fan-out itself; it composes a single ``jsrun`` command with
an ERF rankfile (``generate_jsrun_rankfile``, ``js_run.py:96``) that
pins each rank to a host and a cpu range, and jsrun places the
processes.  The rankfile is the JAX package's byte for byte, and the
command has its shape; instead of ``--smpiargs`` MPI plumbing the
workers get their identity from the PMIx/JSM environment
(``cluster_env.jsm_identity``, read by ``Config.from_env``) and
rendezvous through ``HOROVOD_COORDINATOR_ADDR`` like every other launch
path.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import List, Optional

from horovod_tpu_torch.runner.cluster_env import LSFUtils
from horovod_tpu_torch.runner.hosts import HostInfo


def is_jsrun_installed() -> bool:
    """True if the ``jsrun`` launcher exists (reference
    ``is_jsrun_installed``)."""
    return shutil.which("jsrun") is not None


def generate_jsrun_rankfile(hosts: List[HostInfo], np: int,
                            path: Optional[str] = None,
                            cores_per_node: Optional[int] = None,
                            threads_per_core: Optional[int] = None,
                            accelerators_per_node: Optional[int] = None,
                            ) -> str:
    """Write the ERF rankfile splitting cores among ranks (reference
    ``generate_jsrun_rankfile`` — same header directives and ``rank:``
    line format, with slot validation against the per-node accelerator
    count)."""
    cores = cores_per_node or LSFUtils.get_num_cores()
    threads = threads_per_core or LSFUtils.get_num_threads()
    accels = accelerators_per_node or LSFUtils.get_num_accelerators()
    cpu_per_slot = max((cores * threads) // max(accels, 1), 1)

    validated: List[HostInfo] = []
    remaining = np
    for h in hosts:
        if h.slots > accels:
            raise ValueError(
                f"host '{h.hostname}' requests {h.slots} slots but each "
                f"node exposes only {accels} accelerator(s); cap its slot "
                f"count at the per-node accelerator count")
        needed = min(h.slots, remaining)
        validated.append(HostInfo(h.hostname, needed))
        remaining -= needed
        if remaining == 0:
            break
    if remaining != 0:
        raise ValueError(
            f"the host list provides too few slots for -np {np}: "
            f"{np - remaining} available across {len(validated)} host(s)")

    if path is None:
        fd, path = tempfile.mkstemp(prefix="hvd_jsrun_", suffix=".erf")
        os.close(fd)
    with open(path, "w") as f:
        f.write("overlapping_rs: allow\n")
        f.write("cpu_index_using: logical\n")
        rank = 0
        for h in validated:
            cpu = 0
            f.write("\n")
            for _ in range(h.slots):
                f.write(f"rank: {rank}: {{ hostname: {h.hostname}; "
                        f"cpu: {{{cpu}-{cpu + cpu_per_slot - 1}}} ; "
                        f"gpu: * ; mem: * }}\n")
                rank += 1
                cpu += cpu_per_slot
    return path


def js_run_command(command: List[str], rankfile: str,
                   output_filename: Optional[str] = None,
                   smpiargs: Optional[str] = None) -> List[str]:
    """Compose the jsrun invocation (reference ``js_run`` command
    string, ``js_run.py:73-84``) as an argv list."""
    cmd = ["jsrun", "--erf_input", rankfile]
    if output_filename:
        cmd += ["--stdio_stderr", output_filename,
                "--stdio_stdout", output_filename]
    if smpiargs:
        # argv goes to exec without a shell — pass the value raw (the
        # reference shell-quotes because it builds a shell string)
        cmd += ["--smpiargs", smpiargs]
    cmd += list(command)
    return cmd


def js_run(args, hosts: List[HostInfo], env: dict,
           stdout=None, stderr=None) -> int:
    """Launch the training command through jsrun (reference ``js_run``).

    The env carries ``HOROVOD_COORDINATOR_ADDR`` + ``HOROVOD_SIZE``;
    per-rank identity comes from the PMIx/JSM variables jsrun sets
    (``cluster_env.jsm_identity``)."""
    from horovod_tpu_torch.runner import safe_shell_exec

    if not is_jsrun_installed():
        raise RuntimeError(
            "horovod_tpu_torch does not find the jsrun command.\n\n"
            "Please, make sure you are running on a cluster with jsrun "
            "installed or use one of the other launchers.")
    rankfile = generate_jsrun_rankfile(hosts, args.np)
    cmd = js_run_command(args.command, rankfile,
                         output_filename=args.output_filename)
    if args.verbose:
        import sys

        print("[launcher] " + " ".join(cmd), file=sys.stderr)
    return safe_shell_exec.execute(cmd, env=env, stdout=stdout,
                                   stderr=stderr)
