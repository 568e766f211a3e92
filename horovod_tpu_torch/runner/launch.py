"""``hvdrun`` for the PyTorch port — the launcher CLI
(``horovod_tpu/runner/launch.py``; reference ``horovodrun``).

Reference: ``horovod/runner/launch.py`` (``parse_args:212``,
``_run_static:484``, ``run_commandline:715``).  The JAX package's launcher
with the same flags: host/hostfile parsing, config-file → env plumbing,
per-slot env contract (``gloo_context.cc:47-55``), process fan-out over
ssh with fail-fast teardown, the ``--mpi`` and ``--jsrun`` branches, and
the coordinator address that rank 0's ``TCPStore`` binds
(``runtime/state.py``) in place of the gloo rendezvous server.  The
launcher starts workers and does not choose their device: a worker's
``hvd.init()`` takes ``cuda:<local_rank>``.

Usage::

    python -m horovod_tpu_torch.runner -np 4 python train.py
    python -m horovod_tpu_torch.runner -np 4 -H h1:2,h2:2 python train.py
    python -m horovod_tpu_torch.runner -np 8 --mpi python train.py

    python -m horovod_tpu_torch.runner -np 4 --min-np 2 --max-np 8 \
        --host-discovery-script ./hosts.sh python train.py

Any elastic flag (``--min-np``, ``--max-np``, ``--host-discovery-script``,
``--slots-per-host``, ``--elastic-timeout``, ``--reset-limit``) launches
through the elastic driver (``elastic/launch.py``): the training script
runs its loop under ``hvd.elastic.run``.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import sys
import threading
from typing import Dict, List, Optional

from horovod_tpu_torch.runner import config_parser, mpi_run, safe_shell_exec
from horovod_tpu_torch.runner.hosts import (
    HostInfo,
    SlotInfo,
    get_host_assignments,
    parse_hostfile,
    parse_hosts,
)
from horovod_tpu_torch.runtime.config import CONTROLLER

_LOCAL_NAMES = ("localhost", "127.0.0.1", "::1")

#: ``--elastic-timeout``'s default, the JAX launcher's
ELASTIC_TIMEOUT_S = 600


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="hvdrun",
        description="Launch a horovod_tpu_torch distributed job.")
    p.add_argument("-v", "--version", action="store_true")
    p.add_argument("-np", "--num-proc", type=int, dest="np",
                   help="total number of worker processes")
    p.add_argument("-H", "--hosts", dest="hosts",
                   help='host list "h1:slots,h2:slots"; default localhost')
    p.add_argument("--hostfile", dest="hostfile",
                   help="file with one 'host slots=N' per line")
    p.add_argument("--ssh-port", type=int, default=None)
    p.add_argument("-i", "--ssh-identity-file", dest="ssh_identity_file",
                   help="ssh private key for remote worker launch")
    p.add_argument("--gloo", action="store_true", dest="use_gloo",
                   help="use the built-in launcher fan-out (the default; "
                        "accepted for reference CLI compatibility)")
    p.add_argument("--mpi", action="store_true", dest="use_mpi",
                   help="launch through mpirun (workers read identity "
                        "from the OMPI/PMIx env)")
    p.add_argument("--jsrun", action="store_true",
                   help="launch through jsrun with an ERF rankfile "
                        "(LSF clusters)")
    p.add_argument("--mpi-args", dest="mpi_args",
                   help="extra arguments appended to mpirun")
    p.add_argument("--network-interface", dest="nics",
                   help="comma-separated interfaces to restrict control "
                        "and data traffic to (narrows NIC discovery and "
                        "pins GLOO_SOCKET_IFNAME)")
    p.add_argument("--start-timeout", type=int, default=30)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--output-filename", dest="output_filename",
                   help="per-rank stdout/stderr directory")
    p.add_argument("--config-file", dest="config_file")
    p.add_argument("--check-build", action="store_true",
                   help="print capability report and exit")

    # elastic (reference --min-np/--max-np/--host-discovery-script)
    p.add_argument("--min-np", type=int, dest="min_np")
    p.add_argument("--max-np", type=int, dest="max_np")
    p.add_argument("--slots-per-host", type=int, dest="slots",
                   help="default slot count for discovered hosts")
    p.add_argument("--host-discovery-script", dest="host_discovery_script")
    p.add_argument("--elastic-timeout", type=int,
                   default=ELASTIC_TIMEOUT_S)
    p.add_argument("--reset-limit", type=int, dest="reset_limit",
                   help="stop after this many elastic resets (reference "
                        "--reset-limit)")

    # knobs → env (reference config_parser flag set)
    p.add_argument("--fusion-threshold-mb", type=int,
                   dest="fusion_threshold_mb")
    p.add_argument("--cycle-time-ms", type=float, dest="cycle_time_ms")
    p.add_argument("--cache-capacity", type=int, dest="cache_capacity")
    p.add_argument("--disable-cache", action="store_const", const=True,
                   dest="disable_cache",
                   help="re-run launch-time discovery (NIC ring probe) "
                        "instead of using cached results (reference "
                        "--disable-cache), and disable the "
                        "response-cache analogue "
                        "(sets HOROVOD_CACHE_CAPACITY=0)")
    p.add_argument("--autotune", action="store_const", const=True,
                   dest="autotune")
    p.add_argument("--autotune-log-file", dest="autotune_log_file")
    p.add_argument("--autotune-warmup-samples", type=int,
                   dest="autotune_warmup_samples")
    p.add_argument("--autotune-steps-per-sample", type=int,
                   dest="autotune_steps_per_sample")
    p.add_argument("--autotune-bayes-opt-max-samples", type=int,
                   dest="autotune_bayes_opt_max_samples")
    p.add_argument("--autotune-gaussian-process-noise", type=float,
                   dest="autotune_gaussian_process_noise")
    p.add_argument("--log-level", dest="log_level",
                   choices=["trace", "debug", "info", "warning", "error",
                            "fatal"])
    p.add_argument("--log-hide-timestamp", action="store_const", const=True,
                   dest="log_hide_timestamp")
    p.add_argument("--timeline-filename", dest="timeline_filename")
    p.add_argument("--timeline-mark-cycles", action="store_const", const=True,
                   dest="timeline_mark_cycles")
    p.add_argument("--no-stall-check", action="store_const", const=True,
                   dest="no_stall_check")
    p.add_argument("--stall-warning-time-seconds", type=float,
                   dest="stall_warning_time_seconds")
    p.add_argument("--stall-shutdown-time-seconds", type=float,
                   dest="stall_shutdown_time_seconds")
    p.add_argument("--mesh-shape", dest="mesh_shape",
                   help='the JAX package\'s TPU mesh override "dcn,ici"; '
                        'accepted so reference command lines parse, '
                        'exported as HOROVOD_TPU_MESH_SHAPE, and ignored '
                        'by the port (one process per GPU)')
    p.add_argument("--tpu-operations", dest="tpu_operations",
                   help="the eager collectives' data plane "
                        "(HOROVOD_TPU_OPERATIONS): XLA selects the port's "
                        "device plane (NCCL on a card, the world's gloo "
                        "group on the CPU), HOST the host gloo group")

    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="training command")
    return p.parse_args(argv)


def _resolve_hosts(args) -> List[HostInfo]:
    if args.hosts and args.hostfile:
        raise ValueError("specify --hosts or --hostfile, not both")
    if args.hostfile:
        return parse_hostfile(args.hostfile)
    if args.hosts:
        return parse_hosts(args.hosts)
    from horovod_tpu_torch.runner.cluster_env import detect_cluster_hosts

    detected = detect_cluster_hosts()
    if detected:   # LSF: host list with zero flags
        return detected
    return [HostInfo("localhost", args.np)]


def _is_local(hostname: str) -> bool:
    return hostname in _LOCAL_NAMES or hostname == socket.gethostname()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _coordinator_addr(hosts: List[HostInfo]) -> str:
    """Rank 0's ``TCPStore`` address on rank 0's host (the
    rendezvous-server analogue, reference ``gloo_run.py:213``).  The port
    is free on the launcher's host when picked; rank 0 binds it a moment
    later through ``init_process_group("tcp://...")``."""
    head = hosts[0].hostname
    if _is_local(head):
        head = "127.0.0.1"
    return f"{head}:{_free_port()}"


def _discover_coordinator_addr(hosts: List[HostInfo], args) -> str:
    """Multi-host coordinator addressing via the NIC ring probe: start a
    probe task on every host (ssh for remote ones), compute the
    interfaces every consecutive pair can route over, and address the
    coordinator by rank-0's IP on a common interface (reference
    ``get_common_interfaces`` + driver/task services,
    ``driver_service.py:124-193``) — instead of hoping ``hosts[0]``'s
    name resolves identically from every worker."""
    import subprocess

    from horovod_tpu_torch.runner.driver_service import (
        probe_common_and_rank0,
    )
    from horovod_tpu_torch.runner.network import make_secret_key

    hostnames = [h.hostname for h in hosts]
    if all(_is_local(h) for h in hostnames):
        return _coordinator_addr(hosts)
    key = make_secret_key()
    requested_nics = set(args.nics.split(",")) if args.nics else None
    procs = []

    def spawn(host: str, index: int, driver_addrs: str) -> None:
        # the key rides the command line, not the env — ssh does not
        # forward env vars (the reference ships settings incl. the key
        # base64-encoded in the remote command, driver_service.py:49-84)
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.probe_task",
               driver_addrs, str(index), key]
        slot = SlotInfo(hostname=host, rank=index, local_rank=0,
                        cross_rank=0, size=len(hostnames), local_size=1,
                        cross_size=len(hostnames))
        full = build_worker_command(slot, cmd, args.ssh_port,
                                    args.ssh_identity_file)
        procs.append(subprocess.Popen(full,
                                      stdout=subprocess.DEVNULL,
                                      stderr=subprocess.DEVNULL))

    try:
        # repeated launches against one host set skip the ssh+probe
        # round trip via the on-disk TTL cache (reference
        # runner/util/cache.py; --disable-cache forces a fresh probe)
        cache = None
        if not getattr(args, "disable_cache", None):
            from horovod_tpu_torch.runner.cache import DiscoveryCache

            cache = DiscoveryCache()
        common, rank0_ips = probe_common_and_rank0(
            hostnames, spawn, key, cache=cache,
            validate_port=args.ssh_port or 22)
        if requested_nics is not None:
            # --network-interface: the user's list wins, but the probe
            # still supplies rank-0's IP on that interface (the launcher
            # cannot know it otherwise) and fails loudly if the requested
            # interface is not mutually routable
            narrowed = [i for i in common if i in requested_nics]
            if not narrowed:
                raise RuntimeError(
                    f"--network-interface {args.nics} matches none of "
                    f"the mutually-routable interfaces {common}")
            common = narrowed
        iface = next(i for i in common if i in rank0_ips)
        ip = rank0_ips[iface]
        if args.verbose:
            print(f"[launcher] common interfaces: {common}; coordinator "
                  f"on {ip}", file=sys.stderr)
        return f"{ip}:{_free_port()}"
    finally:
        # reap without masking the primary error: stragglers get
        # terminated, then killed — never re-raise from cleanup
        for p in procs:
            try:
                p.wait(timeout=5)
            except Exception:
                p.terminate()
                try:
                    p.wait(timeout=2)
                except Exception:
                    p.kill()


def build_worker_command(slot: SlotInfo, command: List[str],
                         ssh_port: Optional[int] = None,
                         ssh_identity_file: Optional[str] = None,
                         env: Optional[Dict[str, str]] = None
                         ) -> List[str]:
    """Local slots exec directly; remote slots go through ssh (reference
    ``gloo_run.py:113-180`` ssh/exec split).  Remote args are
    ``shlex.quote``d — naive single-quoting corrupts any argument that
    itself contains a quote.

    ssh forwards none of its own environment, so a remote slot's ``env``
    rides its command, after a ``cd`` to the launcher's directory:
    ``cd DIR && env K=V ... command`` (reference ``gloo_run``'s
    ``_slot_info_to_command_fn`` and ``get_remote_command``).  The JAX
    launcher's remote command carries no variable, and its remote ranks
    start without their ``HOROVOD_RANK``."""
    import shlex

    if _is_local(slot.hostname):
        return list(command)
    ssh = ["ssh", "-o", "StrictHostKeyChecking=no"]
    if ssh_identity_file:
        ssh += ["-i", ssh_identity_file]
    if ssh_port:
        # options must precede the destination — ssh stops parsing at it
        ssh += ["-p", str(ssh_port)]
    ssh.append(slot.hostname)
    remote = " ".join(shlex.quote(c) for c in command)
    if env:
        remote = "cd {} && env {} {}".format(
            shlex.quote(os.getcwd()),
            " ".join(shlex.quote(f"{k}={v}") for k, v in env.items()),
            remote)
    return ssh + [remote]


SSH_CHECK_TIMEOUT_S = 30


def check_all_hosts_ssh_successful(hostnames: List[str],
                                   ssh_port: Optional[int] = None,
                                   ssh_identity_file: Optional[str] = None,
                                   runner=None) -> None:
    """Verify every remote host is ssh-reachable before fan-out
    (reference ``_check_all_hosts_ssh_successful``, ``launch.py:55-104``)
    — one bad host should fail the launch immediately with a named
    culprit, not hang N-1 healthy workers.  ``runner`` is injectable for
    tests; defaults to running the composed ssh command."""
    import shlex
    import subprocess

    def default_runner(cmd: List[str]) -> int:
        try:
            return subprocess.run(
                cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                timeout=SSH_CHECK_TIMEOUT_S).returncode
        except subprocess.TimeoutExpired:
            return 255

    run = runner or default_runner
    remote = [h for h in hostnames if not _is_local(h)]
    results: Dict[str, int] = {}
    lock = threading.Lock()

    def check(host: str) -> None:
        cmd = ["ssh", "-o", "BatchMode=yes",
               "-o", "StrictHostKeyChecking=no"]
        if ssh_identity_file:
            cmd += ["-i", ssh_identity_file]
        if ssh_port:
            cmd += ["-p", str(ssh_port)]
        cmd += [host, shlex.quote("true")]
        rc = run(cmd)
        with lock:
            results[host] = rc

    threads = [threading.Thread(target=check, args=(h,), daemon=True)
               for h in remote]
    for t in threads:
        t.start()
    for t in threads:
        t.join(SSH_CHECK_TIMEOUT_S + 5)
    failed = sorted(h for h, rc in results.items() if rc != 0)
    failed += sorted(h for h in remote if h not in results)
    if failed:
        raise RuntimeError(
            "SSH was unable to connect to hosts: {}\n"
            "Check that every host is reachable, accepts passwordless "
            "ssh, and that --ssh-port matches.".format(", ".join(failed)))


def build_worker_env(slot: SlotInfo, base_env: Dict[str, str],
                     coordinator_addr: str) -> Dict[str, str]:
    env = dict(base_env)
    env.update(slot.to_env())
    env["HOROVOD_COORDINATOR_ADDR"] = coordinator_addr
    # the port's control plane is a gloo group (reference gloo_run stamps
    # "gloo"); HOROVOD_RANK/SIZE name the process world, one per GPU
    env["HOROVOD_CONTROLLER"] = CONTROLLER
    return env


def _run_jsrun(args, hosts: List[HostInfo]) -> int:
    """LSF/jsrun launch: one jsrun command with an ERF rankfile places
    every rank; workers read identity from the PMIx env (reference
    ``run_controller`` jsrun branch, ``launch.py:632`` + ``js_run.py``)."""
    from horovod_tpu_torch.runner import js_run

    env = config_parser.set_env_from_args(dict(os.environ), args)
    env["HOROVOD_COORDINATOR_ADDR"] = _coordinator_addr(hosts)
    env["HOROVOD_SIZE"] = str(args.np)
    return js_run.js_run(args, hosts, env)


def _run_mpi(args, hosts: List[HostInfo]) -> int:
    """mpirun launch: mpirun places the ranks; workers read identity
    from the OMPI/PMIx env (reference ``mpi_run.py``)."""
    env = config_parser.set_env_from_args(dict(os.environ), args)
    env["HOROVOD_COORDINATOR_ADDR"] = _coordinator_addr(hosts)
    env["HOROVOD_SIZE"] = str(args.np)
    return mpi_run.mpi_run(args, hosts, env)


def _run_static(args) -> int:
    hosts = _resolve_hosts(args)
    if args.jsrun:
        return _run_jsrun(args, hosts)
    if args.use_mpi:
        return _run_mpi(args, hosts)
    check_all_hosts_ssh_successful([h.hostname for h in hosts],
                                   args.ssh_port, args.ssh_identity_file)
    assignments = get_host_assignments(hosts, args.np, args.np)
    coordinator = _discover_coordinator_addr(hosts, args)
    base_env = config_parser.set_env_from_args(dict(os.environ), args)

    if args.verbose:
        for s in assignments:
            print(f"[launcher] rank {s.rank} -> {s.hostname} "
                  f"(local {s.local_rank}/{s.local_size})", file=sys.stderr)

    failures: List[int] = []
    abort = threading.Event()
    out_dir = args.output_filename
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    def run_slot(slot: SlotInfo, done: threading.Event):
        try:
            env = build_worker_env(slot, base_env, coordinator)
            cmd = build_worker_command(
                slot, args.command, args.ssh_port, args.ssh_identity_file,
                env={k: env[k] for k in mpi_run.forwarded_vars(env)})
            stdout = stderr = None
            if out_dir:
                stdout = open(os.path.join(out_dir, f"rank.{slot.rank}.out"),
                              "wb")
                stderr = open(os.path.join(out_dir, f"rank.{slot.rank}.err"),
                              "wb")
            try:
                rc = safe_shell_exec.execute(cmd, env=env, stdout=stdout,
                                             stderr=stderr, events=[abort])
            finally:
                for f in (stdout, stderr):
                    if f:
                        f.close()
            if rc != 0:
                failures.append(rc)
                abort.set()   # fail fast: kill the whole job (reference
                #               gloo_run kills all on any failure)
        finally:
            done.set()

    # Each slot's thread sets its event when its worker has ended.  The
    # launcher waits on the events, not on Thread.join: a join that an
    # interrupt breaks marks the thread stopped, and a second join would
    # then return while the worker still runs.
    finished: List[threading.Event] = []
    try:
        for slot in assignments:
            done = threading.Event()
            threading.Thread(target=run_slot, args=(slot, done),
                             daemon=True).start()
            finished.append(done)
        for done in finished:
            done.wait()
    finally:
        # an interrupted launcher ends its job: the workers run in
        # sessions of their own and see no signal meant for the launcher
        abort.set()
        for done in finished:
            done.wait()
    return failures[0] if failures else 0


def _check_build() -> int:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import op_manager

    print("horovod_tpu_torch v" + hvd.__version__)
    print("Available backends:")
    print(f"    [{'X' if hvd.cuda_built() else ' '}] CUDA")
    print(f"    [{'X' if hvd.nccl_built() else ' '}] NCCL")
    print(f"    [{'X' if hvd.gloo_built() else ' '}] Gloo")
    print(f"    [{'X' if hvd.mpi_built() else ' '}] MPI")
    print(f"Eager data plane (HOROVOD_TPU_OPERATIONS): "
          f"{op_manager.current_operations()}")
    return 0


def run_commandline(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.version:
        import horovod_tpu_torch as hvd

        print(hvd.__version__)
        return 0
    if args.check_build:
        return _check_build()
    if args.config_file:
        config_parser.apply_config_defaults(
            args, config_parser.load_config_file(args.config_file))
    if not args.command:
        raise SystemExit("no training command given")
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    if args.np is None and not args.host_discovery_script:
        raise SystemExit("-np is required")
    # any elastic flag launches through the elastic driver
    if (args.host_discovery_script or args.min_np or args.max_np
            or args.slots is not None or args.reset_limit is not None
            or args.elastic_timeout != ELASTIC_TIMEOUT_S):
        from horovod_tpu_torch.elastic.launch import run_elastic

        return run_elastic(args)
    return _run_static(args)


def main() -> None:
    # SIGTERM tears the job down as Ctrl-C does
    signal.signal(signal.SIGTERM, signal.default_int_handler)
    sys.exit(run_commandline())


if __name__ == "__main__":
    main()
