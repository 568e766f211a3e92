"""Elastic end-to-end through the port's launcher: real process churn
over gloo, the JAX package's ``tests/test_elastic_e2e.py`` scenarios
with the same assertions on world-size transitions and state continuity.

The "hosts" are ``localhost`` and ``127.0.0.1`` (and this machine's
hostname): distinct host names on one machine, the reference's trick.
A bash discovery script's output depends on the number of epochs
already logged; ``tests/torch_elastic_worker.py`` trains under
``hvd.elastic.run`` and logs each epoch.  Every generation's gloo world
rendezvouses on a fresh store the driver hosts.

Every scenario is one launcher process started once for the module, two
at a time, each in a session of its own under its own timeout: at the
timeout its whole process group is killed and the scenario fails.
"""

import json
import os
import signal
import socket
import stat
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_elastic_worker.py")
#: seconds a scenario may take, the launch and every generation included
SCENARIO_TIMEOUT_S = 120

# Reference DISCOVERY_SCRIPT_TEMPLATE: epoch = logged line count.
DISCOVERY_TEMPLATE = """#!/bin/bash
epoch=0
if [ -f {logfile} ]; then
    epoch=$(< {logfile} wc -l | tr -d '[:space:]')
fi
"""


def write_discovery_script(path, logfile, schedule):
    lines = [DISCOVERY_TEMPLATE.format(logfile=logfile)]
    fixed = [(e, h) for e, h in schedule if e is not None]
    default = schedule[-1][1]
    for i, (epoch, hosts) in enumerate(fixed):
        kw = "if" if i == 0 else "elif"
        lines.append(f'{kw} [ "$epoch" == "{epoch}" ]; then')
        lines.extend(f'echo "{h}"' for h in hosts)
    if fixed:
        lines.append("else")
        lines.extend(f'echo "{h}"' for h in default)
        lines.append("fi")
    else:
        lines.extend(f'echo "{h}"' for h in default)
    path.write_text("\n".join(lines) + "\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)


def run_elastic(tmp_path, discovery_schedule, np=1, min_np=1, max_np=2,
                exit_schedule=None, exit_mode="exception", epochs=3,
                timeout=SCENARIO_TIMEOUT_S, extra_args=(), extra_env=None,
                worker_args=(), root=REPO):
    """One launch: its return code (or how it timed out), output, rank
    0's epoch records, every rank's records and the workers' logs.  The
    launcher and the workers import the package of the checkout at
    ``root`` (this one by default) and run this checkout's worker."""
    logfile = tmp_path / "log.jsonl"
    disc = tmp_path / "discover.sh"
    write_discovery_script(disc, logfile, discovery_schedule)
    out_dir = tmp_path / "out"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_", "XLA_", "JAX_"))}
    env["PYTHONPATH"] = root + ":" + os.path.join(REPO, "tests")
    env["HOROVOD_ELASTIC_HEARTBEAT_TIMEOUT"] = "5"
    env["HOROVOD_ELASTIC_START_TIMEOUT"] = "60"
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra_env or {})
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner",
           "-np", str(np), "--min-np", str(min_np), "--max-np", str(max_np),
           "--host-discovery-script", str(disc),
           "--output-filename", str(out_dir),
           *extra_args,
           "--", sys.executable, WORKER,
           "--logfile", str(logfile),
           "--rank-logfile", str(tmp_path / "ranks.jsonl"),
           "--epochs", str(epochs),
           "--discovery-schedule", json.dumps(discovery_schedule),
           "--exit-schedule", json.dumps(exit_schedule or {}),
           "--exit-mode", exit_mode, *worker_args]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            start_new_session=True, cwd=root)
    try:
        out, err = proc.communicate(timeout=timeout)
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        rc = f"timed out after {timeout} s"
    t_return = time.time()
    _kill_workers(out_dir)
    results = []
    if logfile.exists():
        results = [json.loads(line) for line in
                   logfile.read_text().splitlines()]
    ranks = []
    if (tmp_path / "ranks.jsonl").exists():
        ranks = [json.loads(line) for line in
                 (tmp_path / "ranks.jsonl").read_text().splitlines()]
    return {"rc": rc, "stdout": out, "stderr": err, "results": results,
            "ranks": ranks, "logs": worker_logs(tmp_path),
            "t_return": t_return}


def _kill_workers(out_dir):
    """Workers run in sessions of their own: a launcher killed at its
    timeout leaves them, so every process whose command names this
    scenario's directory is killed too."""
    tag = str(out_dir.parent)
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmdline = f.read().decode(errors="replace")
        except OSError:
            continue
        if tag in cmdline and int(pid) != os.getpid():
            try:
                os.kill(int(pid), signal.SIGKILL)
            except OSError:
                pass


def worker_logs(tmp_path):
    out_dir = tmp_path / "out"
    if not out_dir.exists():
        return ""
    return "\n".join(
        f"== {p.name} ==\n{p.read_text()[-2000:]}"
        for p in sorted(out_dir.iterdir()))


THIRD = socket.gethostname()
TWO_HOSTS = ["localhost:1", "127.0.0.1:1"]

#: name -> run_elastic's keyword arguments (the JAX file's scenarios)
SCENARIOS = {
    "growth_to_three_and_back": dict(
        discovery_schedule=[(0, TWO_HOSTS),
                            (1, TWO_HOSTS + [f"{THIRD}:1"]),
                            (None, TWO_HOSTS)],
        np=2, min_np=2, max_np=3),
    "hosts_added_and_removed": dict(
        discovery_schedule=[(0, ["localhost:1"]), (1, TWO_HOSTS),
                            (None, ["127.0.0.1:1"])]),
    "all_ranks_failure": dict(
        discovery_schedule=[(None, TWO_HOSTS)], np=2, min_np=1, max_np=2,
        exit_schedule={"1,0": [0, 1]}, exit_mode="exception"),
    "reset_limit": dict(
        discovery_schedule=[(None, TWO_HOSTS)], np=2, min_np=1, max_np=2,
        exit_schedule={"1,0": [0], "2,0": [1]},
        extra_args=("--reset-limit", "1")),
    "host_data_plane": dict(
        discovery_schedule=[(0, ["localhost:1"]), (None, TWO_HOSTS)],
        extra_env={"HOROVOD_TPU_OPERATIONS": "HOST"}),
    "single_rank_failure_exception": dict(
        discovery_schedule=[(None, TWO_HOSTS)], np=2, min_np=1, max_np=2,
        exit_schedule={"1,0": [0]}, exit_mode="exception"),
    "single_rank_failure_kill": dict(
        discovery_schedule=[(None, TWO_HOSTS)], np=2, min_np=1, max_np=2,
        exit_schedule={"1,0": [0]}, exit_mode="kill"),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    # the directories first: tmp_path_factory is not safe across threads
    dirs = {name: tmp_path_factory.mktemp(name) for name in SCENARIOS}

    def one(name):
        return run_elastic(dirs[name], **SCENARIOS[name])

    with ThreadPoolExecutor(max_workers=2) as pool:
        return dict(zip(SCENARIOS, pool.map(one, SCENARIOS)))


def _ok(run):
    assert run["rc"] == 0, (run["stderr"][-3000:] + run["logs"])


def test_growth_to_three_and_back(runs):
    """2→3 growth with both survivors keeping their ranks while a third
    worker joins as rank 2, then 3→2 removal with ranks again stable."""
    run = runs["growth_to_three_and_back"]
    _ok(run)
    results = run["results"]
    assert [r["size"] for r in results] == [2, 3, 2], results
    assert [r["rendezvous"] for r in results] == [1, 2, 3]
    by_epoch = {}
    for rec in run["ranks"]:
        if "epoch" in rec and "event" not in rec:
            by_epoch.setdefault(rec["epoch"], set()).add(
                (rec["start_rank"], rec["rank"]))
    assert by_epoch[0] == {(0, 0), (1, 1)}
    assert by_epoch[1] == {(0, 0), (1, 1), (2, 2)}
    assert by_epoch[2] == {(0, 0), (1, 1)}
    assert results[2]["w"] == pytest.approx(6.0)


def test_hosts_added_and_removed(runs):
    """The world grows 1→2 when discovery adds a host and shrinks 2→1
    when the original (rank-0) host is removed; epoch and state survive
    every transition."""
    run = runs["hosts_added_and_removed"]
    _ok(run)
    results = run["results"]
    assert len(results) == 3, results
    assert (results[0]["epoch"], results[0]["size"],
            results[0]["hostname"], results[0]["start_rank"]) == \
        (0, 1, "localhost", 0)
    assert (results[1]["epoch"], results[1]["size"],
            results[1]["hostname"], results[1]["rendezvous"]) == \
        (1, 2, "localhost", 2)
    assert (results[2]["epoch"], results[2]["size"],
            results[2]["hostname"], results[2]["start_rank"],
            results[2]["rendezvous"]) == (2, 1, "127.0.0.1", 1, 3)
    assert results[2]["w"] == pytest.approx(6.0)


def test_all_ranks_failure_fails_job(runs):
    """Every host failing leaves no state carrier: the launcher exits
    non-zero, and does not hang."""
    run = runs["all_ranks_failure"]
    assert isinstance(run["rc"], int) and run["rc"] != 0, run["rc"]
    assert len(run["results"]) == 1


def test_reset_limit_stops_job(runs):
    """``--reset-limit 1``: the first failure takes the one reset, the
    second stops the job with a non-zero exit."""
    run = runs["reset_limit"]
    assert isinstance(run["rc"], int) and run["rc"] != 0, run["rc"]


def test_host_data_plane_survives_churn(runs):
    """``HOROVOD_TPU_OPERATIONS=HOST`` under elastic growth: the host data
    plane re-forms with the world."""
    run = runs["host_data_plane"]
    _ok(run)
    results = run["results"]
    assert [r["size"] for r in results] == [1, 2, 2], results
    assert results[-1]["w"] == pytest.approx(6.0)


@pytest.mark.parametrize("exit_mode", ["exception", "kill"])
def test_single_rank_failure(runs, exit_mode):
    """A worker's death (an exception, or SIGKILL) mid-epoch: its host is
    blacklisted, the survivor's collective raises HorovodInternalError,
    it restores the committed state and finishes alone."""
    run = runs[f"single_rank_failure_{exit_mode}"]
    _ok(run)
    results = run["results"]
    assert len(results) == 3, results
    assert (results[0]["epoch"], results[0]["size"],
            results[0]["start_rank"], results[0]["rendezvous"]) == \
        (0, 2, 0, 1)
    for r, epoch in zip(results[1:], (1, 2)):
        assert (r["epoch"], r["size"], r["start_rank"], r["hostname"],
                r["rendezvous"]) == (epoch, 1, 1, "127.0.0.1", 2)
    assert results[2]["w"] == pytest.approx(6.0)
