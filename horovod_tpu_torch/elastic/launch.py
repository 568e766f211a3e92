"""Elastic launch path of the port's launcher (a copy of
``horovod_tpu/elastic/launch.py``; every generation's workers share the
compile cache's store, ``runtime/compile_cache.py``).  Under
``HOROVOD_DEGRADE=1`` the
launcher attaches a :class:`~horovod_tpu_torch.elastic.degrade.
DegradeController` to its driver, which the JAX launcher leaves to its
caller.

Reference: ``horovod/runner/gloo_run.py:274 launch_gloo_elastic`` —
rendezvous server + ``ElasticDriver`` + per-slot worker exec with the
elastic env contract.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

from horovod_tpu_torch.elastic import degrade
from horovod_tpu_torch.elastic.discovery import FixedHosts, HostDiscoveryScript
from horovod_tpu_torch.elastic.driver import ElasticDriver
from horovod_tpu_torch.runner import config_parser, safe_shell_exec
from horovod_tpu_torch.runner.hosts import SlotInfo, parse_hosts
from horovod_tpu_torch.runner.launch import build_worker_command
from horovod_tpu_torch.runner.network import make_secret_key


def run_elastic(args) -> int:
    min_np = args.min_np or args.np
    if not min_np:
        raise SystemExit("elastic mode needs --min-np or -np")
    if args.host_discovery_script:
        discovery = HostDiscoveryScript(args.host_discovery_script,
                                        default_slots=args.slots or 1)
    elif args.hosts:
        discovery = FixedHosts(
            {h.hostname: h.slots for h in parse_hosts(args.hosts)})
    else:
        raise SystemExit(
            "elastic mode needs --host-discovery-script or -H hosts")

    key = make_secret_key()
    from horovod_tpu_torch.elastic.driver import START_TIMEOUT_S

    start_timeout = float(os.environ.get("HOROVOD_ELASTIC_START_TIMEOUT",
                                         START_TIMEOUT_S))
    driver = ElasticDriver(discovery, min_np, args.max_np,
                           timeout=args.elastic_timeout,
                           reset_limit=args.reset_limit or 0,
                           secret_key=key,
                           start_timeout=start_timeout)
    base_env = config_parser.set_env_from_args(dict(os.environ), args)
    if degrade.enabled():
        # plan-aware degradation: the driver re-resolves the plan at each
        # reassignment, from the launch's plan (HOROVOD_PLAN, else dp over
        # the starting world)
        n = args.np or min_np
        controller = degrade.DegradeController(
            degrade.DegradedPlanResolver.from_env(
                base_env.get("HOROVOD_PLAN") or f"dp={n}", n))
        driver.set_degrade_controller(controller)
    driver_host, driver_port = driver.address
    out_dir: Optional[str] = args.output_filename
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    def create_worker_fn(slot: SlotInfo, coordinator: str,
                         generation: int, abort_event=None) -> int:
        env = dict(base_env)
        env.update(slot.to_env())
        plan = driver.degrade_controller and \
            driver.degrade_controller.current_plan.to_string()
        if plan:        # a joiner starts at the generation's plan
            env["HOROVOD_PLAN"] = plan
        env.update({
            "HOROVOD_COORDINATOR_ADDR": coordinator,
            "HOROVOD_ELASTIC": "1",
            "HOROVOD_SECRET_KEY": key,
            "HOROVOD_ELASTIC_DRIVER_ADDR": f"{driver_host}:{driver_port}",
            "HOROVOD_ELASTIC_NOTIFY_ADDR": "1",
            "HOROVOD_ELASTIC_GENERATION": str(generation),
        })
        # pin the compile cache's store for every generation's workers: a
        # respawned worker then loads the kernel and native libraries that
        # an earlier generation built instead of running the compilers
        # (runtime/compile_cache.py; HOROVOD_COMPILE_CACHE=0 opts out)
        from horovod_tpu_torch.runtime import compile_cache

        env.setdefault("HOROVOD_COMPILE_CACHE_DIR",
                       compile_cache.default_dir())
        cmd = build_worker_command(slot, args.command, args.ssh_port,
                                   getattr(args, "ssh_identity_file", None))
        stdout = stderr = None
        if out_dir:
            stdout = open(os.path.join(out_dir, f"rank.{slot.rank}.out"), "ab")
            stderr = open(os.path.join(out_dir, f"rank.{slot.rank}.err"), "ab")
        events = [abort_event] if abort_event is not None else None
        try:
            return safe_shell_exec.execute(cmd, env=env, stdout=stdout,
                                           stderr=stderr, events=events)
        finally:
            for f in (stdout, stderr):
                if f:
                    f.close()

    if args.verbose:
        print(f"[launcher] elastic driver at {driver_host}:{driver_port}, "
              f"min_np={min_np} max_np={args.max_np}", file=sys.stderr)
    driver.start(args.np or min_np, create_worker_fn)
    return driver.wait_for_completion()
