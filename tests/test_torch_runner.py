"""The port's launcher (``horovod_tpu_torch/runner``) held against the JAX
package's (``horovod_tpu/runner``), and the worlds it starts.

* Parity: the same inputs through both packages' host parsing and
  assignment, worker commands, ssh check, argument parsing, config-file
  and flag → env mapping, mpirun and jsrun commands and rankfiles, the
  PMIx/OpenMPI/MPICH identity and ``Config.from_env``'s identity give
  equal outputs.  Where the port differs on purpose, the test says so and
  checks only the difference: the controller stamp (``gloo``, not
  ``jax``), the variables mpirun forwards (CUDA/NCCL/torch, not
  JAX/TPU/XLA), the module names in child commands, and the TPU pod
  host list (left out).
* The control plane: a ``BasicService``/``BasicClient`` round trip, a
  wrong key refused, the discovery cache, the ring probe on localhost and
  its connect retried through the port's ``probe.connect`` fault site.
* Worlds over gloo, started once for the module, two at a time: ``python -m
  horovod_tpu_torch.runner -np 2`` and ``-np 4`` against
  ``spawn_world`` at the same size (identity equal to the launcher's
  ``SlotInfo``, losses and weights after 3 steps bit for bit), two
  "hosts" on localhost, a world of 2 from mpirun's environment alone (no
  ``HOROVOD_RANK``; on a tree without the PMIx fallback every rank is
  rank 0 and the world never forms), ``--mpi`` and ``--jsrun`` through
  stand-ins for ``mpirun`` and ``jsrun``, and fail-fast teardown.

Everything compares exactly: the launcher moves no numbers."""

import dataclasses
import json
import logging
import os
import pickle
import shlex
import subprocess
import sys
import textwrap
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from horovod_tpu.runner import cluster_env as JCE
from horovod_tpu.runner import config_parser as JCP
from horovod_tpu.runner import hosts as JH
from horovod_tpu.runner import js_run as JJS
from horovod_tpu.runner import launch as JL
from horovod_tpu.runner import mpi_run as JMPI
from horovod_tpu.runtime import config as JCfg
from horovod_tpu.runtime import retry as JR
from horovod_tpu_torch.runner import cluster_env as TCE
from horovod_tpu_torch.runner import config_parser as TCP
from horovod_tpu_torch.runner import hosts as TH
from horovod_tpu_torch.runner import js_run as TJS
from horovod_tpu_torch.runner import launch as TL
from horovod_tpu_torch.runner import mpi_run as TMPI
from horovod_tpu_torch.runtime import config as TCfg
from horovod_tpu_torch.runtime import retry as TR

from torch_port_workers import rank_fails, rank_identity, spawn_world

ROOT = Path(__file__).resolve().parents[1]
WORKER = str(ROOT / "tests" / "torch_port_workers.py")
#: every world the module starts must end within this many seconds
WORLD_TIMEOUT_S = 120
#: fail-fast: the launcher returns the failing rank's code within this
#: many seconds of its start (torch's own rendezvous timeout is 30 min)
FAIL_FAST_S = 45
HOST_STRINGS = ["h1:2,h2:4,h3", "localhost:4", "a:1,b:1,c:1,d:1",
                "localhost:2,127.0.0.1:2", " h1:2 , h2:2 "]
ASSIGN_CASES = [("h1:2,h2:2", 4), ("h1:2,h2:2", 3), ("h1:4", 1),
                ("h1:1,h2:3,h3:2", 5), ("h1:2", 4), ("a:1,b:1", 2)]
#: tests/test_runner.py's TestFlagParity and knob lists, and more
ARGVS = [
    ["-np", "2", "--disable-cache", "--network-interface", "eth0,lo",
     "-i", "/root/.ssh/key", "--slots-per-host", "4",
     "--reset-limit", "3", "--log-level", "debug",
     "--log-hide-timestamp", "--autotune-warmup-samples", "5",
     "--autotune-steps-per-sample", "20",
     "--autotune-bayes-opt-max-samples", "30",
     "--autotune-gaussian-process-noise", "0.5",
     "--gloo", "--", "python", "t.py"],
    ["-np", "4", "-H", "h1:4", "--fusion-threshold-mb", "32",
     "--autotune", "--timeline-filename", "/tmp/t.json",
     "--", "python", "train.py"],
    ["-np", "8", "--hostfile", "hf", "--ssh-port", "2222", "--mpi",
     "--mpi-args=--oversubscribe", "--cycle-time-ms", "2.5",
     "--cache-capacity", "64", "--no-stall-check",
     "--stall-warning-time-seconds", "30",
     "--stall-shutdown-time-seconds", "90", "--timeline-mark-cycles",
     "--mesh-shape", "2,4", "--tpu-operations", "HOST",
     "--output-filename", "out", "--verbose", "--start-timeout", "5",
     "python", "train.py", "--lr", "0.1"],
    ["-np", "2", "--jsrun", "--config-file", "c.yaml", "--", "python",
     "t.py"],
    ["--check-build"], ["-v"],
]


def _rows(xs):
    return [dataclasses.asdict(x) for x in xs]


def _raises(fn, *args, **kwargs):
    """(exception type name, message) of ``fn``'s error, or its result."""
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 - compared between packages
        return (type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# parity with horovod_tpu.runner
# ---------------------------------------------------------------------------

class TestHosts:
    @pytest.mark.parametrize("hosts", HOST_STRINGS)
    def test_parse_hosts(self, hosts):
        assert _rows(TH.parse_hosts(hosts)) == _rows(JH.parse_hosts(hosts))

    def test_parse_hostfile(self, tmp_path):
        f = tmp_path / "hostfile"
        f.write_text(textwrap.dedent("""\
            # comment
            h1 slots=2
            h2:4
              h3 slots = 3   # trailing comment

            h4
        """))
        assert _rows(TH.parse_hostfile(str(f))) == \
            _rows(JH.parse_hostfile(str(f)))

    @pytest.mark.parametrize("hosts,np_", ASSIGN_CASES)
    @pytest.mark.parametrize("max_np", [None, 3, 6])
    def test_assignments_and_env(self, hosts, np_, max_np):
        def assign(mod):
            return _raises(lambda: [
                (dataclasses.asdict(s), s.to_env())
                for s in mod.get_host_assignments(mod.parse_hosts(hosts),
                                                  np_, max_np)])

        assert assign(TH) == assign(JH)


class TestCommands:
    @pytest.mark.parametrize("host", ["localhost", "127.0.0.1", "worker-7"])
    @pytest.mark.parametrize("port,identity", [(None, None), (2222, None),
                                               (None, "/k.pem"),
                                               (22, "/k.pem")])
    def test_build_worker_command(self, host, port, identity):
        cmd = ["python", "-c", "print('hello world')", "--flag=a b"]
        t = TH.get_host_assignments([TH.HostInfo(host, 1)], 1)[0]
        j = JH.get_host_assignments([JH.HostInfo(host, 1)], 1)[0]
        assert TL.build_worker_command(t, cmd, port, identity) == \
            JL.build_worker_command(j, cmd, port, identity)

    def test_remote_slot_carries_its_contract(self, monkeypatch, tmp_path):
        """A departure from the JAX launcher, whose remote command carries
        no variable: ssh forwards none of the client's environment, so a
        remote rank would start with no ``HOROVOD_RANK``.  The port's
        remote command sets the slot's contract and what mpirun would
        forward, after a ``cd`` to the launcher's directory; a shell with
        nothing else in its environment runs the rank with it."""
        keys = ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
                "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK",
                "HOROVOD_CROSS_SIZE", "HOROVOD_COORDINATOR_ADDR",
                "HOROVOD_CONTROLLER", "NCCL_DEBUG", "UNRELATED_VAR")
        show = ("import json, os; print(json.dumps([os.getcwd(), "
                f"{{k: os.environ.get(k) for k in {keys!r}}}]))")
        launched = []
        monkeypatch.chdir(tmp_path)
        monkeypatch.setenv("NCCL_DEBUG", "INFO")
        monkeypatch.setenv("UNRELATED_VAR", "x")
        monkeypatch.setattr(TL, "check_all_hosts_ssh_successful",
                            lambda *a, **k: None)
        monkeypatch.setattr(TL, "_discover_coordinator_addr",
                            lambda hosts, args: "10.0.0.1:1234")
        monkeypatch.setattr(TL.safe_shell_exec, "execute",
                            lambda cmd, env=None, **kw:
                            launched.append((cmd, env)) or 0)
        assert TL.run_commandline(["-np", "2", "-H", "localhost:1,w7:1",
                                   "--", sys.executable, "-c", show]) == 0
        (local, local_env), (remote, _) = sorted(
            launched, key=lambda c: c[0][0] == "ssh")
        assert local == [sys.executable, "-c", show]
        assert local_env["HOROVOD_RANK"] == "0"
        assert remote[:-1] == ["ssh", "-o", "StrictHostKeyChecking=no",
                               "w7"]
        out = subprocess.run(["sh", "-c", remote[-1]],
                             env={"PATH": "/usr/bin:/bin"},
                             capture_output=True, text=True, check=True)
        cwd, seen = json.loads(out.stdout)
        assert cwd == str(tmp_path)
        assert seen == {"HOROVOD_RANK": "1", "HOROVOD_SIZE": "2",
                        "HOROVOD_LOCAL_RANK": "0", "HOROVOD_LOCAL_SIZE": "1",
                        "HOROVOD_CROSS_RANK": "1", "HOROVOD_CROSS_SIZE": "2",
                        "HOROVOD_COORDINATOR_ADDR": "10.0.0.1:1234",
                        "HOROVOD_CONTROLLER": "gloo", "NCCL_DEBUG": "INFO",
                        "UNRELATED_VAR": None}
        # the JAX launcher's remote command is the rank's command alone
        j = JH.get_host_assignments(JH.parse_hosts("localhost:1,w7:1"), 2)
        bare = JL.build_worker_command(j[1], [sys.executable, "-c", show])
        assert bare[:-1] == remote[:-1]
        assert bare[-1] == shlex.join([sys.executable, "-c", show])
        assert remote[-1].endswith(" " + bare[-1])

    @pytest.mark.parametrize("bad", [(), ("badhost",), ("goodhost",
                                                         "badhost")])
    def test_ssh_check(self, bad):
        def check(mod):
            calls = []

            def runner(cmd):
                calls.append(cmd)
                return 255 if any(b in cmd for b in bad) else 0

            out = _raises(mod.check_all_hosts_ssh_successful,
                          ["localhost", "goodhost", "badhost"],
                          ssh_port=2222, ssh_identity_file="/k.pem",
                          runner=runner)
            return out, sorted(calls)

        assert check(TL) == check(JL)

    def test_worker_env_differs_in_the_controller_only(self):
        """The port stamps ``gloo`` (its control plane is a gloo group, as
        reference Horovod's gloo_run stamps it); JAX stamps ``jax``."""
        t = TH.get_host_assignments([TH.HostInfo("h1", 2)], 2)[1]
        j = JH.get_host_assignments([JH.HostInfo("h1", 2)], 2)[1]
        got = TL.build_worker_env(t, {"PATH": "/bin"}, "10.0.0.1:1234")
        want = JL.build_worker_env(j, {"PATH": "/bin"}, "10.0.0.1:1234")
        assert (got.pop("HOROVOD_CONTROLLER"),
                want.pop("HOROVOD_CONTROLLER")) == ("gloo", "jax")
        assert got == want
        assert "HOROVOD_CONTROLLER" in TCfg.KNOWN_KNOBS

    @pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
    def test_parse_args_and_env(self, argv):
        t, j = TL.parse_args(argv), JL.parse_args(argv)
        assert vars(t) == vars(j)
        assert TCP.set_env_from_args({"X": "1"}, t) == \
            JCP.set_env_from_args({"X": "1"}, j)

    def test_config_file_cli_wins(self, tmp_path):
        cfg = tmp_path / "cfg.yaml"
        cfg.write_text(textwrap.dedent("""\
            fusion:
              threshold_mb: 16
              cycle_time_ms: 2.5
            timeline:
              filename: /tmp/from_config.json
            library_options:
              tpu_operations: host
            stall_check:
              disable: true
        """))
        argv = ["-np", "1", "--fusion-threshold-mb", "64", "--config-file",
                str(cfg), "--", "true"]
        envs = []
        for launch, cp in ((TL, TCP), (JL, JCP)):
            args = launch.parse_args(argv)
            cp.apply_config_defaults(args, cp.load_config_file(str(cfg)))
            envs.append((vars(args), cp.set_env_from_args({}, args)))
        assert envs[0] == envs[1]
        assert envs[0][1]["HOROVOD_FUSION_THRESHOLD"] == str(64 << 20)

    def test_elastic_flags_raise_before_launch(self, monkeypatch):
        """Each elastic flag sends the launch through the elastic driver's
        ``run_elastic``, with the flag's value parsed, before any host is
        resolved or process started (monkeypatched: nothing launches)."""
        from horovod_tpu_torch.elastic import launch as TEL

        def no_launch(*a, **k):
            raise AssertionError("launched")

        seen = []
        monkeypatch.setattr(TL, "_run_static", no_launch)
        monkeypatch.setattr(TL.safe_shell_exec, "execute", no_launch)
        monkeypatch.setattr(TEL, "run_elastic",
                            lambda args: seen.append(args) or 7)
        for flags, field, value in (
                (["--min-np", "1"], "min_np", 1),
                (["--max-np", "4"], "max_np", 4),
                (["--host-discovery-script", "./d.sh"],
                 "host_discovery_script", "./d.sh"),
                (["--slots-per-host", "2"], "slots", 2),
                (["--elastic-timeout", "60"], "elastic_timeout", 60),
                (["--reset-limit", "3"], "reset_limit", 3)):
            assert TL.run_commandline(["-np", "2", *flags, "--", "true"]) \
                == 7
            assert getattr(seen[-1], field) == value
            assert seen[-1].command == ["true"]
        assert len(seen) == 6

    def test_check_build(self, capsys):
        """The port's version, CUDA/NCCL/Gloo/MPI and the eager data plane,
        without importing the JAX package's launcher."""
        assert TL.run_commandline(["--check-build"]) == 0
        out = capsys.readouterr().out
        import horovod_tpu_torch as hvd

        assert f"horovod_tpu_torch v{hvd.__version__}" in out
        for name in ("CUDA", "NCCL", "Gloo", "MPI"):
            assert f"] {name}" in out
        assert "[X] Gloo" in out
        assert "Eager data plane (HOROVOD_TPU_OPERATIONS): XLA" in out
        assert "TPU" not in out.replace("HOROVOD_TPU_OPERATIONS", "")

    def test_child_commands_name_the_port(self, monkeypatch):
        """The probe task and run()'s task are the port's modules, never
        the JAX package's."""
        import horovod_tpu_torch.runner.api as api
        import horovod_tpu_torch.runner.driver_service as ds

        cmds = []

        class FakePopen:
            def __init__(self, cmd, **kw):
                cmds.append(cmd)

            def wait(self, timeout=None):
                return 0

        def fake_probe(hostnames, spawn, key, **kw):
            for i, h in enumerate(hostnames):
                spawn(h, i, "10.0.0.9:1")
            return ["eth0"], {"eth0": "10.0.0.1"}

        monkeypatch.setattr(subprocess, "Popen", FakePopen)
        monkeypatch.setattr(ds, "probe_common_and_rank0", fake_probe)
        args = TL.parse_args(["-np", "2", "-H", "w1:1,w2:1",
                              "--disable-cache", "--", "true"])
        addr = TL._discover_coordinator_addr(TL.parse_hosts(args.hosts),
                                             args)
        assert addr.startswith("10.0.0.1:")
        assert [c[:4] for c in cmds] == [["ssh", "-o",
                                          "StrictHostKeyChecking=no", h]
                                         for h in ("w1", "w2")]
        assert cmds[0][-1].startswith(
            f"{sys.executable} -m horovod_tpu_torch.runner.probe_task "
            f"10.0.0.9:1 0 ")

        seen = []
        monkeypatch.setattr(api.launch_mod, "run_commandline",
                            lambda argv: seen.append(argv) or 1)
        with pytest.raises(RuntimeError, match="exit code 1"):
            api.run(rank_identity, args=("x",), np=2)
        assert seen[0][-2:] == ["-m", "horovod_tpu_torch.runner.run_task"]


class TestMpiRun:
    ENV = {"HOROVOD_COORDINATOR_ADDR": "10.0.0.1:1234",
           "HOROVOD_SIZE": "4", "PYTHONPATH": "/x", "PATH": "/bin",
           "LD_LIBRARY_PATH": "/l", "HOME": "/root", "PATH_INFO": "p",
           "GLOO_SOCKET_IFNAME": "eth0"}
    #: what one package forwards and the other does not
    OWN = {"JAX_PLATFORMS": "tpu", "TPU_NAME": "t", "XLA_FLAGS": "-x",
           "NCCL_DEBUG": "INFO", "TORCH_NCCL_ASYNC_ERROR_HANDLING": "1",
           "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True",
           "CUDA_VISIBLE_DEVICES": "0,1,2,3"}

    @pytest.mark.parametrize("impl", ["openmpi", "spectrum", "mpich"])
    @pytest.mark.parametrize("nics,extra,ssh", [
        (None, None, (None, None)), ("eth0", "--oversubscribe", (None,
                                                                 None)),
        ("eth0,eth1", None, (2222, "/k.pem")), (None, None, (None,
                                                             "/k.pem"))])
    def test_command(self, impl, nics, extra, ssh):
        def cmd(mod):
            return _raises(
                mod.mpi_run_command, 4,
                [mod.HostInfo("h1", 2), mod.HostInfo("h2", 2)],
                ["python", "train.py"], dict(self.ENV),
                impl_flags=mod.mpi_implementation_flags(impl=impl),
                nics=nics, extra_mpi_args=extra, ssh_port=ssh[0],
                ssh_identity_file=ssh[1], impl=impl)

        assert cmd(TMPI) == cmd(JMPI)

    @pytest.mark.parametrize("impl", ["openmpi", "mpich"])
    def test_forwarded_prefixes_differ_on_purpose(self, impl):
        """The port forwards what a CUDA/NCCL worker reads; JAX forwards
        JAX_/TPU_/XLA_.  Only those variables tell the two apart."""
        def forwarded(mod):
            cmd = mod.mpi_run_command(
                2, [mod.HostInfo("h1", 2)], ["t"],
                {**self.ENV, **self.OWN}, impl_flags=[], impl=impl)
            if impl == "mpich":
                return set(cmd[cmd.index("-genvlist") + 1].split(","))
            return {cmd[i + 1] for i, a in enumerate(cmd) if a == "-x"}

        common = {"HOROVOD_COORDINATOR_ADDR", "HOROVOD_SIZE", "PYTHONPATH",
                  "PATH", "LD_LIBRARY_PATH", "GLOO_SOCKET_IFNAME"}
        assert forwarded(TMPI) == common | {
            "NCCL_DEBUG", "TORCH_NCCL_ASYNC_ERROR_HANDLING",
            "PYTORCH_CUDA_ALLOC_CONF", "CUDA_VISIBLE_DEVICES"}
        assert forwarded(JMPI) == common | {"JAX_PLATFORMS", "TPU_NAME",
                                            "XLA_FLAGS"}

    @pytest.mark.parametrize("impl", ["openmpi", "spectrum", "mpich",
                                      "unknown"])
    def test_flags_and_detection(self, impl, monkeypatch):
        assert _raises(TMPI.mpi_implementation_flags, impl=impl) == \
            _raises(JMPI.mpi_implementation_flags, impl=impl)
        text = {"openmpi": "mpirun (Open MPI) 4.1.4",
                "spectrum": "mpirun (IBM Spectrum MPI) 10.3",
                "mpich": "HYDRA build details:\n    Version: 4.1",
                "unknown": "something else"}[impl]
        for mod in (TMPI, JMPI):
            monkeypatch.setattr(
                mod.subprocess, "run",
                lambda *a, **k: subprocess.CompletedProcess(
                    a, 0, stdout=text, stderr=""))
            assert mod.detect_mpi_implementation() == impl

    def test_mpi_flag_without_mpirun_errors(self, monkeypatch):
        monkeypatch.setattr(TMPI.shutil, "which", lambda _: None)
        with pytest.raises(RuntimeError, match="does not find an installed"):
            TL.run_commandline(["-np", "2", "--mpi", "--", "python", "t.py"])


class TestJsRun:
    @pytest.mark.parametrize("hosts,np_,shape", [
        ("host1:2,host2:2", 3, (4, 2, 2)), ("h:4", 4, (16, 1, 4)),
        ("a:1,b:1,c:1", 3, (8, 2, 1)), ("h:8", 8, (4, 1, 4)),
        ("h:2", 4, (4, 1, 2)), ("a:2,b:2", 4, (None, None, None))])
    def test_rankfile_bytes(self, tmp_path, monkeypatch, hosts, np_, shape):
        """The ERF rankfile is the JAX package's byte for byte, errors
        included (node shape from the arguments, else the LSF env)."""
        monkeypatch.setenv("HOROVOD_LSF_CORES_PER_NODE", "6")
        texts = []
        for mod, name in ((TJS, "t.erf"), (JJS, "j.erf")):
            path = tmp_path / name
            out = _raises(mod.generate_jsrun_rankfile,
                          [mod.HostInfo(h.hostname, h.slots)
                           for h in JH.parse_hosts(hosts)], np_,
                          path=str(path), cores_per_node=shape[0],
                          threads_per_core=shape[1],
                          accelerators_per_node=shape[2])
            texts.append((out[0], path.read_bytes() if out[0] == "ok"
                          else out[1]))
        assert texts[0] == texts[1]

    @pytest.mark.parametrize("out,smpi", [(None, None), ("/tmp/o", None),
                                          (None, "-gpu"), ("/o", "-x y")])
    def test_command(self, out, smpi):
        assert TJS.js_run_command(["python", "t.py"], "/tmp/rf.erf", out,
                                  smpi) == \
            JJS.js_run_command(["python", "t.py"], "/tmp/rf.erf", out, smpi)

    def test_jsrun_without_jsrun_errors(self, monkeypatch):
        monkeypatch.setattr(TJS.shutil, "which", lambda _: None)
        with pytest.raises(RuntimeError, match="jsrun"):
            TL.run_commandline(["-np", "2", "--jsrun", "--", "t"])


IDENTITY_VARS = ("PMIX_RANK", "PMIX_SIZE", "PMIX_LOCAL_RANK",
                 "PMIX_LOCAL_SIZE", "OMPI_COMM_WORLD_RANK",
                 "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK",
                 "OMPI_COMM_WORLD_LOCAL_SIZE", "PMI_RANK", "PMI_SIZE",
                 "MPI_LOCALRANKID", "MPI_LOCALNRANKS", "HOROVOD_RANK",
                 "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK", "HOROVOD_LOCAL_SIZE",
                 "HOROVOD_CROSS_RANK", "HOROVOD_CROSS_SIZE", "LSB_JOBID",
                 "LSB_MCPU_HOSTS", "TPU_WORKER_HOSTNAMES")
SPELLINGS = {
    "pmix": {"PMIX_RANK": "5", "PMIX_SIZE": "8", "PMIX_LOCAL_RANK": "1",
             "PMIX_LOCAL_SIZE": "4"},
    "ompi": {"OMPI_COMM_WORLD_RANK": "5", "OMPI_COMM_WORLD_SIZE": "8",
             "OMPI_COMM_WORLD_LOCAL_RANK": "1",
             "OMPI_COMM_WORLD_LOCAL_SIZE": "4"},
    "mpich": {"PMI_RANK": "5", "PMI_SIZE": "8", "MPI_LOCALRANKID": "1",
              "MPI_LOCALNRANKS": "4"},
    "ompi_no_local": {"OMPI_COMM_WORLD_RANK": "2",
                      "OMPI_COMM_WORLD_SIZE": "3"},
    "pmix_and_ompi": {"PMIX_RANK": "1", "PMIX_SIZE": "2",
                      "OMPI_COMM_WORLD_RANK": "7",
                      "OMPI_COMM_WORLD_SIZE": "9"},
    "none": {},
}


@pytest.fixture
def clean_env(monkeypatch):
    for v in IDENTITY_VARS:
        monkeypatch.delenv(v, raising=False)
    return monkeypatch


class TestIdentity:
    @pytest.mark.parametrize("spelling", sorted(SPELLINGS))
    def test_jsm_identity(self, clean_env, spelling):
        for k, v in SPELLINGS[spelling].items():
            clean_env.setenv(k, v)
        assert TCE.jsm_identity() == JCE.jsm_identity()

    @pytest.mark.parametrize("spelling", sorted(SPELLINGS))
    @pytest.mark.parametrize("horovod_rank", [False, True])
    def test_config_identity(self, clean_env, spelling, horovod_rank):
        """``Config.from_env``'s identity: the PMIx/OMPI/MPICH fallback
        when ``HOROVOD_RANK`` is unset, the HOROVOD_* variables when it
        is set, as in the JAX package."""
        for k, v in SPELLINGS[spelling].items():
            clean_env.setenv(k, v)
        clean_env.setenv("HOROVOD_SIZE", "8")
        clean_env.setenv("HOROVOD_LOCAL_SIZE", "2")
        clean_env.setenv("HOROVOD_CROSS_RANK", "1")
        if horovod_rank:
            clean_env.setenv("HOROVOD_RANK", "3")
            clean_env.setenv("HOROVOD_LOCAL_RANK", "1")
        fields = ("rank", "size", "local_rank", "local_size", "cross_rank",
                  "cross_size", "coordinator_addr")
        t, j = TCfg.Config.from_env(), JCfg.Config.from_env()
        assert [getattr(t, f) for f in fields] == \
            [getattr(j, f) for f in fields]
        if spelling != "none" and not horovod_rank:
            assert t.rank == TCE.jsm_identity()["rank"]

    def test_world_of_one_binds_no_port(self, clean_env):
        """``hvdrun -np 1`` gives its rank a coordinator address picked
        free on the launcher's host; a world of one rendezvouses with
        nobody, so ``hvd.init()`` binds no store there and starts even
        when another socket took that port in between."""
        import socket

        import torch

        import horovod_tpu_torch as hvd

        with socket.socket() as taken:
            taken.bind(("127.0.0.1", 0))
            taken.listen(1)
            clean_env.setenv("HOROVOD_RANK", "0")
            clean_env.setenv("HOROVOD_SIZE", "1")
            clean_env.setenv("HOROVOD_COORDINATOR_ADDR",
                             f"127.0.0.1:{taken.getsockname()[1]}")
            hvd.init(device="cpu")
            try:
                assert (hvd.rank(), hvd.size(), hvd.local_size()) == (0, 1, 1)
                assert torch.equal(hvd.allreduce(torch.arange(3.0),
                                                 op=hvd.Sum),
                                   torch.arange(3.0))
            finally:
                hvd.shutdown()

    def test_lsf_hosts(self, clean_env):
        clean_env.setenv("LSB_JOBID", "1234")
        clean_env.setenv("LSB_MCPU_HOSTS", "batch1 1 node1 4 node2 4")
        assert _rows(TCE.detect_cluster_hosts()) == \
            _rows(JCE.detect_cluster_hosts()) == \
            [{"hostname": "node1", "slots": 4},
             {"hostname": "node2", "slots": 4}]
        for name in ("get_num_cores", "get_num_threads",
                     "get_num_accelerators"):
            assert getattr(TCE.LSFUtils, name)() == \
                getattr(JCE.LSFUtils, name)()
        clean_env.setenv("HOROVOD_LSF_ACCELERATORS_PER_NODE", "8")
        assert TCE.LSFUtils.get_num_accelerators() == 8

    def test_no_cluster(self, clean_env):
        assert TCE.detect_cluster_hosts() is None
        assert JCE.detect_cluster_hosts() is None

    def test_tpu_pod_branch_left_out(self, clean_env):
        """The port runs on GPU hosts: a TPU pod's host list is not one
        of its clusters."""
        clean_env.setenv("TPU_WORKER_HOSTNAMES", "t0,t1,t2,t3")
        assert [h.hostname for h in JCE.detect_cluster_hosts()] == \
            ["t0", "t1", "t2", "t3"]
        assert TCE.detect_cluster_hosts() is None
        assert not hasattr(TCE, "TpuPodUtils")


class TestRetry:
    @pytest.mark.parametrize("jitter", [True, False])
    def test_backoff_matches_jax(self, jitter):
        """For the same explicit policy the port's backoff is JAX's; the
        port reads no ``HOROVOD_RETRY_*`` knob, each caller states its
        policy."""
        kw = dict(max_attempts=3, base_s=0.1, max_s=5.0, deadline_s=30.0,
                  jitter=jitter, seed=3)
        t, j = TR.RetryPolicy(**kw), JR.RetryPolicy(**kw)
        assert [t.backoff_s(a) for a in range(8)] == \
            [j.backoff_s(a) for a in range(8)]
        from horovod_tpu_torch.runner import driver_service as TDS

        probe = (TDS.PROBE_ATTEMPTS, TDS.PROBE_BASE_S, TDS.PROBE_MAX_S)
        jdefault = JR.RetryPolicy()
        assert probe == (jdefault.max_attempts, jdefault.base_s,
                         jdefault.max_s)
        assert TDS.PROBE_DEADLINE_S == 30.0
        assert not any(k.startswith("HOROVOD_RETRY_")
                       for k in TCfg.KNOWN_KNOBS)

    def test_retries_then_raises(self):
        sleeps, calls = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("refused")
            return "up"

        p = TR.RetryPolicy(max_attempts=5, base_s=0.1, max_s=5.0,
                           deadline_s=0, jitter=False, sleep=sleeps.append)
        assert p.call(flaky) == "up" and sleeps == [0.1, 0.2]
        with pytest.raises(ValueError):
            p.call(lambda: (_ for _ in ()).throw(ValueError("bug")))
        with pytest.raises(OSError):
            TR.RetryPolicy(max_attempts=2, base_s=0.1, max_s=5.0,
                           deadline_s=0, jitter=False,
                           sleep=lambda s: None).call(
                lambda: (_ for _ in ()).throw(OSError("down")))


# ---------------------------------------------------------------------------
# the control plane
# ---------------------------------------------------------------------------

class TestNetwork:
    def test_round_trip_and_wrong_key(self):
        from horovod_tpu_torch.runner.network import (
            BasicClient,
            BasicService,
            make_secret_key,
        )

        key = make_secret_key()
        svc = BasicService("t", key, lambda req: ("echo", req),
                           host="127.0.0.1")
        svc.start()
        try:
            addr = ("127.0.0.1", svc.port)
            assert BasicClient(addr, key).request({"a": [1, 2]}) == \
                ("echo", {"a": [1, 2]})
            assert BasicClient(addr, key).ping()
            with pytest.raises((EOFError, ConnectionError)):
                BasicClient(addr, "not-the-key", timeout_s=5).request("x")
        finally:
            svc.shutdown()

    def test_cache_round_trip_expiry_and_own_directory(self, tmp_path,
                                                       monkeypatch):
        from horovod_tpu.runner import cache as jcache
        from horovod_tpu_torch.runner import cache as tcache

        path = str(tmp_path / "c.json")
        c = tcache.DiscoveryCache(path=path, ttl_s=3600)
        assert c.get({"probe": ["a"]}) is None
        c.put({"probe": ["a"]}, {"common": ["lo"], "rank0": {"lo": "1.1"}})
        assert c.get({"probe": ["a"]})["common"] == ["lo"]
        c.put({"b": 1, "a": 2}, "v")
        assert tcache.DiscoveryCache(path=path, ttl_s=3600).get(
            {"a": 2, "b": 1}) == "v"
        short = tcache.DiscoveryCache(path=path, ttl_s=0.05)
        short.put({"probe": ["x"]}, "soon-stale")
        time.sleep(0.1)
        assert short.get({"probe": ["x"]}) is None
        Path(path).write_text("{not json")
        assert tcache.DiscoveryCache(path=path).get({"probe": ["a"]}) is None
        # the port's cache lives beside the JAX package's, never in it
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
        assert tcache._default_path() == \
            str(tmp_path / "horovod_tpu_torch" / "discovery_cache.json")
        assert jcache._default_path() == \
            str(tmp_path / "horovod_tpu" / "discovery_cache.json")

    def test_ring_probe_with_a_refused_connect_retried(self, caplog):
        """Three probe tasks on localhost find a common interface; the
        first task's first connect raises through ``probe.connect`` and
        is retried under the RetryPolicy."""
        from horovod_tpu_torch import faults
        from horovod_tpu_torch.runner.driver_service import (
            discover_common_interfaces,
            run_probe_task,
        )

        plan = faults.FaultPlan(seed=0, sim=True).add(
            "probe.connect", "raise", "ConnectionRefusedError", at=1)
        faults.set_plan(plan)
        caplog.set_level(logging.WARNING, "horovod_tpu_torch.runtime.retry")
        threads = []

        def spawn(host, index, driver_addr):
            t = threading.Thread(target=run_probe_task,
                                 args=(driver_addr, index, "k"),
                                 daemon=True)
            t.start()
            threads.append(t)

        try:
            common, driver = discover_common_interfaces(
                ["localhost"] * 3, spawn, secret_key="k", timeout_s=30)
            try:
                assert common
                assert any(i in driver.task_address(0) for i in common)
            finally:
                driver.shutdown()
            assert [f[:2] for f in plan.fired] == [("probe.connect", 1)]
            retried = [r.getMessage() for r in caplog.records
                       if r.name == "horovod_tpu_torch.runtime.retry"]
            assert len(retried) == 1 and retried[0].startswith(
                "driver-probe: attempt 1/5 failed (ConnectionRefusedError")
        finally:
            faults.clear_plan()
            for t in threads:
                t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)


class TestRunApi:
    def test_closure_without_cloudpickle_names_it(self, monkeypatch):
        """Without cloudpickle, run() pickles with pickle: a module-level
        function travels by reference, a closure raises naming
        cloudpickle."""
        from horovod_tpu_torch.runner.api import dumps_function

        monkeypatch.setitem(sys.modules, "cloudpickle", None)
        fn, args, kwargs = pickle.loads(
            dumps_function(rank_identity, ("a",), {}))
        assert fn is rank_identity and args == ("a",)
        y = 3
        with pytest.raises(TypeError, match="cloudpickle"):
            dumps_function(lambda x: x + y)

    def test_closure_with_cloudpickle(self):
        cloudpickle = pytest.importorskip("cloudpickle")
        from horovod_tpu_torch.runner.api import dumps_function

        y = 3
        fn, args, _ = pickle.loads(dumps_function(lambda x: x + y, (4,)))
        assert fn(*args) == 7 and cloudpickle is not None


# ---------------------------------------------------------------------------
# worlds started by the launcher
# ---------------------------------------------------------------------------

FAKE_MPIRUN = '''\
"""A stand-in for Open MPI's mpirun on one node: starts -np ranks of the
command with only the -x variables and Open MPI's identity variables."""
import os, subprocess, sys
argv = sys.argv[1:]
if argv == ["--version"]:
    print("mpirun (Open MPI) 4.1.4")
    sys.exit(0)
arity = {"-np": 1, "-H": 1, "-bind-to": 1, "-map-by": 1, "-x": 1,
         "-mca": 2}
flags = {"--allow-run-as-root", "--tag-output"}
i, n, fwd = 0, 0, []
while i < len(argv) and (argv[i] in arity or argv[i] in flags):
    if argv[i] == "-np":
        n = int(argv[i + 1])
    if argv[i] == "-x":
        fwd.append(argv[i + 1])
    i += 1 + arity.get(argv[i], 0)
procs = []
for r in range(n):
    env = {k: os.environ[k] for k in fwd if k in os.environ}
    env.update(OMPI_COMM_WORLD_RANK=str(r), OMPI_COMM_WORLD_SIZE=str(n),
               OMPI_COMM_WORLD_LOCAL_RANK=str(r),
               OMPI_COMM_WORLD_LOCAL_SIZE=str(n))
    procs.append(subprocess.Popen(argv[i:], env=env))
codes = [p.wait() for p in procs]
sys.exit(next((c for c in codes if c), 0))
'''

FAKE_JSRUN = '''\
"""A stand-in for LSF's jsrun: places the ranks of the ERF rankfile and
gives each PMIx's identity variables."""
import os, re, subprocess, sys
argv = sys.argv[1:]
i, rankfile = 0, None
while argv[i].startswith("--"):
    if argv[i] == "--erf_input":
        rankfile = argv[i + 1]
    i += 2
hosts = re.findall(r"^rank: (\\d+): \\{ hostname: ([^;]+);",
                   open(rankfile).read(), re.M)
procs = []
for rank, host in hosts:
    peers = [r for r, h in hosts if h == host]
    env = dict(os.environ, PMIX_RANK=rank, PMIX_SIZE=str(len(hosts)),
               PMIX_LOCAL_RANK=str(peers.index(rank)),
               PMIX_LOCAL_SIZE=str(len(peers)))
    procs.append(subprocess.Popen(argv[i:], env=env))
codes = [p.wait() for p in procs]
sys.exit(next((c for c in codes if c), 0))
'''


def _launch(tmp: Path, name: str, launcher_args, fn: str, steps: int,
            path_dir=None, **env_vars) -> dict:
    """``python -m horovod_tpu_torch.runner LAUNCHER_ARGS python
    torch_port_workers.py FN OUT STEPS``; returns its exit code, seconds,
    output and each rank's pickled result."""
    out = tmp / name
    out.mkdir()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("HOROVOD_RANK", "OMPI_", "PMIX_", "PMI_"))}
    env["PYTHONPATH"] = f"{ROOT}{os.pathsep}{ROOT / 'tests'}"
    if path_dir is not None:
        env["PATH"] = f"{path_dir}{os.pathsep}{env.get('PATH', '')}"
    env.update(env_vars)
    # at a lower priority: the worlds' bursts of processes must not starve
    # the wall-clock tests that other test workers run meanwhile
    cmd = ["nice", "-n", "10", sys.executable, "-m",
           "horovod_tpu_torch.runner", *launcher_args, sys.executable,
           WORKER, fn, str(out), str(steps)]
    t0 = time.monotonic()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        log, _ = proc.communicate(timeout=WORLD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.terminate()     # the launcher ends its workers
        try:
            proc.communicate(timeout=60)
        finally:
            proc.kill()
            proc.wait()
        raise
    res = {"rc": proc.returncode, "s": time.monotonic() - t0,
           "log": log, "dir": out, "ranks": {}}
    for f in sorted(out.glob("rank.*.pkl")):
        res["ranks"][int(f.name.split(".")[1])] = pickle.loads(
            f.read_bytes())
    return res


def _tool(tmp: Path, name: str, source: str) -> Path:
    d = tmp / f"bin_{name}"
    d.mkdir()
    exe = d / name
    exe.write_text(f"#!{sys.executable}\n{source}")
    exe.chmod(0o755)
    return d


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world of this module, two at a time: the spawned
    references, the launched worlds and the mpirun-environment world."""
    tmp = tmp_path_factory.mktemp("launched")
    mpirun, jsrun = _tool(tmp, "mpirun", FAKE_MPIRUN), \
        _tool(tmp, "jsrun", FAKE_JSRUN)
    jobs = {
        "ref2": lambda: spawn_world("run_launch", 2, args=(3,),
                                    timeout=WORLD_TIMEOUT_S),
        "ref4": lambda: spawn_world("run_launch", 4, args=(3,),
                                    timeout=WORLD_TIMEOUT_S),
        "np2": lambda: _launch(tmp, "np2", ["-np", "2"], "run_launch", 3),
        "np4": lambda: _launch(tmp, "np4", ["-np", "4"], "run_launch", 3),
        "two_hosts": lambda: _launch(
            tmp, "two_hosts", ["-np", "4", "-H", "localhost:2,127.0.0.1:2",
                               "--output-filename", str(tmp / "logs")],
            "run_launch", 0),
        "mpirun_env": lambda: spawn_world(
            "run_launch", 2, args=(3,), launch={"mpirun": 2},
            timeout=60),
        "mpi": lambda: _launch(tmp, "mpi", ["-np", "2", "--mpi"],
                               "run_launch", 3, path_dir=mpirun),
        # a node of two GPUs (the rankfile caps a host's slots at it)
        "jsrun": lambda: _launch(tmp, "jsrun", ["-np", "2", "--jsrun"],
                                 "run_launch", 0, path_dir=jsrun,
                                 HOROVOD_LSF_ACCELERATORS_PER_NODE="2"),
        "fail_fast": lambda: _launch(tmp, "fail_fast", ["-np", "2"],
                                     "fail_fast", 0),
    }
    with ThreadPoolExecutor(max_workers=2) as pool:
        futs = {k: pool.submit(fn) for k, fn in jobs.items()}
        out = {}
        for k, f in futs.items():
            try:
                out[k] = f.result()
            except Exception as e:  # noqa: BLE001 - raised by its test
                out[k] = e
    out["logs"] = tmp / "logs"
    return out


def _world(worlds, name):
    w = worlds[name]
    if isinstance(w, Exception):
        raise w
    return w


def _launched(worlds, name, world):
    res = _world(worlds, name)
    assert res["rc"] == 0, res["log"][-3000:]
    assert sorted(res["ranks"]) == list(range(world)), res["log"][-3000:]
    return [res["ranks"][r] for r in range(world)]


def _identity(out) -> dict:
    return {k: out[k] for k in ("rank", "size", "local_rank", "local_size",
                                "cross_rank", "cross_size")}


def _assert_same_training(got, want):
    for g, w in zip(got, want):
        assert g["losses"] == w["losses"]
        assert g["params"].keys() == w["params"].keys()
        for k in w["params"]:
            np.testing.assert_array_equal(g["params"][k], w["params"][k],
                                          err_msg=k)


class TestLaunchedWorlds:
    @pytest.mark.parametrize("world", [2, 4])
    def test_launched_world_equals_spawned(self, worlds, world):
        """``-np N`` on localhost: each rank's identity is its SlotInfo,
        it found the launcher's variables and the port's controller
        stamp, and 3 steps train bit for bit like spawn_world's world of
        the same size."""
        got = _launched(worlds, f"np{world}", world)
        slots = TH.get_host_assignments([TH.HostInfo("localhost", world)],
                                        world)
        for out, slot in zip(got, slots):
            assert _identity(out) == {
                k: getattr(slot, k) for k in _identity(out)}
            assert out["env"] == {**slot.to_env(),
                                  "HOROVOD_CONTROLLER": "gloo",
                                  "HOROVOD_COORDINATOR_ADDR":
                                  got[0]["env"]["HOROVOD_COORDINATOR_ADDR"]}
            assert out["env"]["HOROVOD_COORDINATOR_ADDR"].startswith(
                "127.0.0.1:")
            assert out["device"] == "cpu" and out["is_homogeneous"]
        assert got[0]["losses"][-1] < got[0]["losses"][0]
        _assert_same_training(got, _world(worlds, f"ref{world}"))

    def test_two_hosts_on_localhost(self, worlds):
        """``-H localhost:2,127.0.0.1:2``: local ranks 0,1,0,1, local size
        2, cross size 2, homogeneous; ``--output-filename`` keeps each
        rank's streams."""
        got = _launched(worlds, "two_hosts", 4)
        assert [(o["local_rank"], o["local_size"], o["cross_rank"],
                 o["cross_size"], o["is_homogeneous"]) for o in got] == \
            [(0, 2, 0, 2, True), (1, 2, 0, 2, True), (0, 2, 1, 2, True),
             (1, 2, 1, 2, True)]
        assert [o["env"]["HOROVOD_HOSTNAME"] for o in got] == \
            ["localhost", "localhost", "127.0.0.1", "127.0.0.1"]
        logs = worlds["logs"]
        for r in range(4):
            assert f"rank {r} of 4 done" in \
                (logs / f"rank.{r}.out").read_text()
            assert (logs / f"rank.{r}.err").exists()

    def test_mpirun_environment_world(self, worlds):
        """What mpirun -x gives each rank (OMPI_COMM_WORLD_*, HOROVOD_SIZE,
        HOROVOD_COORDINATOR_ADDR, no HOROVOD_RANK): ranks 0 and 1, local
        ranks from Open MPI's, and 3 steps bit for bit like the HOROVOD_*
        world of 2.  Without the PMIx/OMPI fallback both ranks are rank 0
        and the world never forms."""
        got = _world(worlds, "mpirun_env")
        assert [_identity(o) for o in got] == [
            dict(rank=r, size=2, local_rank=r, local_size=2, cross_rank=0,
                 cross_size=1) for r in range(2)]
        assert all(o["env"]["HOROVOD_RANK"] is None for o in got)
        _assert_same_training(got, _world(worlds, "ref2"))

    def test_mpi_branch(self, worlds):
        """``--mpi`` through a stand-in mpirun that gives each rank only
        the forwarded variables and Open MPI's identity: the same
        training as the HOROVOD_* world of 2."""
        got = _launched(worlds, "mpi", 2)
        assert [_identity(o) for o in got] == [
            dict(rank=r, size=2, local_rank=r, local_size=2, cross_rank=0,
                 cross_size=1) for r in range(2)]
        assert all(o["env"]["HOROVOD_RANK"] is None for o in got)
        _assert_same_training(got, _world(worlds, "ref2"))

    def test_jsrun_branch(self, worlds):
        """``--jsrun`` through a stand-in jsrun that places the ERF
        rankfile's ranks with PMIx's identity."""
        got = _launched(worlds, "jsrun", 2)
        assert [_identity(o) for o in got] == [
            dict(rank=r, size=2, local_rank=r, local_size=2, cross_rank=0,
                 cross_size=1) for r in range(2)]
        assert all(o["env"]["HOROVOD_RANK"] is None for o in got)

    def test_fail_fast(self, worlds):
        """Rank 1 exits 3 while rank 0 waits in ``hvd.init()`` for it: the
        launcher returns 3 within FAIL_FAST_S and rank 0 is gone."""
        res = _world(worlds, "fail_fast")
        assert res["rc"] == 3, res["log"][-3000:]
        assert res["s"] < FAIL_FAST_S, res["s"]
        pid = int((res["dir"] / "rank.0.pid").read_text())
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_sigterm_to_the_launcher_ends_its_workers(tmp_path):
    """SIGTERM to ``hvdrun`` (as Ctrl-C) terminates the workers' process
    groups, which run in sessions of their own, and the launcher exits."""
    import signal

    code = ("import os, sys, time; open(os.path.join(sys.argv[1], "
            "os.environ['HOROVOD_RANK'] + '.pid'), 'w').write("
            "str(os.getpid())); time.sleep(120)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 60
        while len(list(tmp_path.glob("*.pid"))) < 2 and \
                time.monotonic() < deadline:
            time.sleep(0.1)
        pids = [int(f.read_text()) for f in sorted(tmp_path.glob("*.pid"))]
        assert len(pids) == 2
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
    finally:
        proc.kill()
        proc.wait()
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


class TestRunWorlds:
    def _env(self):
        return {"PYTHONPATH": f"{ROOT}{os.pathsep}{ROOT / 'tests'}"}

    def test_run_returns_each_rank(self, monkeypatch):
        """run() with pickle (cloudpickle hidden): a module-level function
        by reference, each rank's result in rank order."""
        from horovod_tpu_torch.runner import run

        monkeypatch.setitem(sys.modules, "cloudpickle", None)
        before = dict(os.environ)
        assert run(rank_identity, args=("t",), np=2,
                   extra_env=self._env()) == [
            {"tag": "t", "rank": r, "size": 2, "local_rank": r}
            for r in range(2)]
        assert dict(os.environ) == before

    def test_run_failure_propagates(self):
        from horovod_tpu_torch.runner import run

        with pytest.raises(RuntimeError, match="exit code 1"):
            run(rank_fails, args=(3,), np=2, extra_env=self._env())
