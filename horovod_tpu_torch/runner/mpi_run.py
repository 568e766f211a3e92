"""mpirun launch path (``horovod_tpu/runner/mpi_run.py``).

Reference: ``horovod/runner/mpi_run.py`` — detect the MPI implementation
(``mpirun --version``), compose a single ``mpirun -np N -H host:slots,…
-bind-to none -map-by slot -x ENV… command`` line and exec it; mpirun
owns process placement.  The MCA transport knobs that exist to steer
Open MPI's BTLs stay OpenMPI-conditional, and workers get their identity
from the OMPI/PMIx/MPICH env (``cluster_env.jsm_identity``, read by
``Config.from_env``) plus the coordinator address forwarded with ``-x``.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Dict, List, Optional

from horovod_tpu_torch.runner.hosts import HostInfo

_MPI_NOT_FOUND_MSG = (
    "horovod_tpu_torch does not find an installed MPI.\n\n"
    "Choose one of:\n"
    "1. Install Open MPI or another MPI implementation.\n"
    "2. Use the built-in launcher (drop --mpi).\n"
    "3. Use --jsrun on LSF clusters.")

# env vars forwarded to every rank (reference nccl_socket/path/pythonpath
# forwarding, mpi_run.py:185-199): what a CUDA/NCCL worker of the port
# reads — the launcher's contract (HOROVOD_), gloo's and NCCL's socket and
# transport knobs, torch's own (TORCH_, PYTORCH_ such as the allocator's)
# and CUDA_ (CUDA_VISIBLE_DEVICES and friends: every rank of a node gets
# the same list, and local_rank indexes into it, so forwarding it is
# harmless).  True prefixes vs exact names are kept separate so e.g.
# PATH_INFO is not swept up by a bare "PATH" prefix.
_FORWARD_PREFIXES = ("HOROVOD_", "GLOO_", "NCCL_", "TORCH_", "PYTORCH_",
                     "CUDA_")
_FORWARD_EXACT = ("PYTHONPATH", "PATH", "LD_LIBRARY_PATH")


def forwarded_vars(env: Dict[str, str]) -> List[str]:
    """The names in ``env`` that a rank on another host is given: by
    mpirun here, by the ssh fan-out's remote command in ``launch.py``."""
    return [var for var in sorted(env)
            if var in _FORWARD_EXACT or var.startswith(_FORWARD_PREFIXES)]


def is_mpirun_installed() -> bool:
    return shutil.which("mpirun") is not None


def detect_mpi_implementation() -> str:
    """Identify the installed MPI from ``mpirun --version`` (reference
    ``_get_mpi_implementation``, ``mpi_run.py:113-130``): ``"openmpi"``,
    ``"spectrum"``, ``"mpich"``, or ``"unknown"``."""
    try:
        out = subprocess.run(["mpirun", "--version"],
                             capture_output=True, text=True,
                             timeout=10).stdout
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    if "Open MPI" in out or "OpenRTE" in out:
        return "openmpi"
    if "Spectrum MPI" in out:
        return "spectrum"
    if "MPICH" in out or "HYDRA" in out:
        return "mpich"
    return "unknown"


def mpi_implementation_flags(env: Optional[Dict[str, str]] = None,
                             impl: Optional[str] = None) -> List[str]:
    """Implementation-specific placement flags (reference
    ``_get_mpi_implementation_flags`` composes per-implementation flag
    sets for OpenMPI/Spectrum/MPICH, ``mpi_run.py:112-119``).  MPICH's
    hydra understands ``-bind-to``/``-map-by`` but none of the OpenMPI
    MCA/``--tag-output`` spellings."""
    impl = impl or detect_mpi_implementation()
    if impl in ("openmpi", "spectrum"):
        return ["--allow-run-as-root", "--tag-output",
                "-bind-to", "none", "-map-by", "slot",
                "-mca", "pml", "ob1", "-mca", "btl", "^openib"]
    if impl == "mpich":
        return ["-bind-to", "none", "-map-by", "slot"]
    raise RuntimeError(
        "Unsupported MPI implementation for --mpi (need Open MPI, IBM "
        "Spectrum MPI, or MPICH — the launch relies on their env "
        "forwarding and per-rank identity env). Detected: " + impl)


def mpi_run_command(np: int, hosts: List[HostInfo], command: List[str],
                    env: Dict[str, str],
                    impl_flags: Optional[List[str]] = None,
                    nics: Optional[str] = None,
                    extra_mpi_args: Optional[str] = None,
                    ssh_port: Optional[int] = None,
                    ssh_identity_file: Optional[str] = None,
                    impl: Optional[str] = None) -> List[str]:
    """Compose the mpirun argv (reference ``mpi_run.py:122-218``).

    OpenMPI/Spectrum forward env with repeated ``-x VAR``; MPICH's hydra
    takes one ``-genvlist V1,V2,…`` and spells the NIC filter ``-iface``
    instead of an MCA knob.
    """
    import shlex

    impl = impl or detect_mpi_implementation()
    cmd = ["mpirun"]
    cmd += impl_flags if impl_flags is not None \
        else mpi_implementation_flags(env, impl=impl)
    cmd += ["-np", str(np),
            "-H", ",".join(f"{h.hostname}:{h.slots}" for h in hosts)]
    if nics:
        if impl == "mpich":
            cmd += ["-iface", nics.split(",")[0]]
        else:
            cmd += ["-mca", "btl_tcp_if_include", nics]
    if ssh_port or ssh_identity_file:
        if impl == "mpich":
            # hydra has no per-arg rsh passthrough; dialing default ssh
            # settings behind the user's back would connect differently
            # than requested
            raise ValueError(
                "ssh_port/ssh_identity_file cannot be forwarded to MPICH's "
                "hydra launcher; configure them in ~/.ssh/config for the "
                "target hosts instead")
        # mpirun's rsh agent must dial the same ssh settings the user
        # gave the launcher (reference forwards them via plm_rsh_args)
        rsh = []
        if ssh_port:
            rsh += ["-p", str(ssh_port)]
        if ssh_identity_file:
            rsh += ["-i", ssh_identity_file]
        cmd += ["-mca", "plm_rsh_args", " ".join(rsh)]
    fwd = forwarded_vars(env)
    if impl == "mpich":
        if fwd:
            cmd += ["-genvlist", ",".join(fwd)]
    else:
        for var in fwd:
            cmd += ["-x", var]
    if extra_mpi_args:
        cmd += shlex.split(extra_mpi_args)
    cmd += list(command)
    return cmd


def mpi_run(args, hosts: List[HostInfo], env: Dict[str, str],
            stdout=None, stderr=None) -> int:
    import os

    from horovod_tpu_torch.runner import safe_shell_exec

    if not is_mpirun_installed():
        raise RuntimeError(_MPI_NOT_FOUND_MSG)
    cmd = mpi_run_command(args.np, hosts, args.command, env,
                          nics=args.nics, extra_mpi_args=args.mpi_args,
                          ssh_port=args.ssh_port,
                          ssh_identity_file=args.ssh_identity_file)
    if args.verbose:
        import sys

        print("[launcher] " + " ".join(cmd), file=sys.stderr)
    opened = []
    if args.output_filename and stdout is None:
        # ranks' output is tagged by mpirun (--tag-output); capture the
        # combined streams under the requested directory like the other
        # launch paths do per rank
        os.makedirs(args.output_filename, exist_ok=True)
        stdout = open(os.path.join(args.output_filename, "mpirun.out"),
                      "wb")
        stderr = open(os.path.join(args.output_filename, "mpirun.err"),
                      "wb")
        opened = [stdout, stderr]
    try:
        return safe_shell_exec.execute(cmd, env=env, stdout=stdout,
                                       stderr=stderr)
    finally:
        for f in opened:
            f.close()
