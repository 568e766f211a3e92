"""The multi-process harness of the port's tests (``tests/
torch_port_workers.py``): a spawned rank takes its place in its world from
what ``spawn_world`` sets, never from launcher variables that the test
process holds (a test that ran an elastic worker or a launcher in-process
leaves them behind, and every later world of that process would inherit
them)."""

import pytest

from torch_port_workers import LAUNCH_ENV, spawn_world

#: launcher variables a test process may hold: a foreign HOROVOD_*
#: identity, torchrun's and Open MPI's
POLLUTION = {"HOROVOD_RANK": "5", "HOROVOD_SIZE": "8",
             "HOROVOD_LOCAL_RANK": "1", "HOROVOD_LOCAL_SIZE": "3",
             "HOROVOD_CROSS_RANK": "1", "HOROVOD_CROSS_SIZE": "5",
             "HOROVOD_ELASTIC": "1", "LOCAL_WORLD_SIZE": "3",
             "LOCAL_RANK": "2", "RANK": "7", "WORLD_SIZE": "9",
             "OMPI_COMM_WORLD_RANK": "3", "OMPI_COMM_WORLD_SIZE": "6"}


@pytest.fixture(scope="module")
def polluted_worlds():
    """A caller-made world of 4 over two hosts (no launcher variable of its
    own) and a world of 2 through the ``HOROVOD_*`` contract, each spawned
    from a test process that holds ``POLLUTION``."""
    mp = pytest.MonkeyPatch()
    try:
        for k, v in POLLUTION.items():
            mp.setenv(k, v)
        caller = spawn_world("run_identity", world=4,
                             launch={"hosts": ["a", "a", "b", "b"]},
                             timeout=180)
        contract = spawn_world("run_identity", world=2, timeout=180)
    finally:
        mp.undo()
    return caller, contract


def test_launch_env_covers_the_runtimes_readers():
    """Every variable the runtime's identity reads is cleared."""
    for name in ("HOROVOD_RANK", "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK",
                 "LOCAL_WORLD_SIZE", "PMIX_RANK", "OMPI_COMM_WORLD_RANK",
                 "PMI_RANK"):
        assert name in LAUNCH_ENV


def test_caller_world_ignores_the_test_process_variables(polluted_worlds):
    """The caller-made world's identity is its group's and its hosts':
    none of the test process's launcher variables reached a rank."""
    caller, _ = polluted_worlds
    got = [(o["rank"], o["size"], o["local_rank"], o["local_size"],
            o["cross_rank"], o["cross_size"]) for o in caller]
    assert got == [(0, 4, 0, 2, 0, 2), (1, 4, 1, 2, 0, 2),
                   (2, 4, 0, 2, 1, 2), (3, 4, 1, 2, 1, 2)]
    assert all(o["launch_env"] == [] for o in caller)


def test_contract_world_sees_only_its_own_variables(polluted_worlds):
    """Through the ``HOROVOD_*`` contract a rank sees the variables
    ``spawn_world`` set for it, and its data plane reads its identity."""
    _, contract = polluted_worlds
    for r, o in enumerate(contract):
        assert (o["rank"], o["size"], o["local_rank"], o["local_size"],
                o["cross_rank"], o["cross_size"]) == (r, 2, r, 2, 0, 1)
        assert o["launch_env"] == sorted(
            ["HOROVOD_COORDINATOR_ADDR", "HOROVOD_LOCAL_RANK",
             "HOROVOD_LOCAL_SIZE", "HOROVOD_RANK", "HOROVOD_SIZE"])
        assert tuple(o["ds"]) == (r, 2)
        for k in o["global"]:
            assert (o["local"][k] == o["global"][k]).all()
