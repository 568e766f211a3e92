"""Cluster scheduler introspection: derive hosts and identity from the
environment (``horovod_tpu/runner/cluster_env.py``).

Reference: ``horovod/runner/util/lsf.py`` (``LSFUtils`` reads
``LSB_MCPU_HOSTS``/``CSM_ALLOCATION_ID`` to build the host list for
jsrun/LSF clusters) and ``js_run.py``.  :func:`jsm_identity` is the worker
side of the ``--mpi`` and ``--jsrun`` launches: ``Config.from_env`` reads
a rank's identity from it when ``HOROVOD_RANK`` is unset.

The JAX package also reads a TPU pod's host list
(``TPU_WORKER_HOSTNAMES``); the port runs on GPU hosts and leaves that
branch out, so outside LSF ``hvdrun`` takes ``-H``/``--hostfile`` or
localhost.  ``HOROVOD_LSF_ACCELERATORS_PER_NODE`` keeps its name and
counts GPUs.
"""

from __future__ import annotations

import os
from typing import List, Optional

from horovod_tpu_torch.runner.hosts import HostInfo


class LSFUtils:
    """LSF batch-system introspection (reference ``LSFUtils``)."""

    @staticmethod
    def using_lsf() -> bool:
        return "LSB_JOBID" in os.environ

    @staticmethod
    def get_compute_hosts() -> List[HostInfo]:
        """Parse ``LSB_MCPU_HOSTS`` ("batch_host 1 host1 N host2 N ...");
        the first entry is the launch/batch node and carries no compute
        slots (reference ``lsf.py`` skips it)."""
        raw = os.environ.get("LSB_MCPU_HOSTS", "").split()
        pairs = list(zip(raw[0::2], raw[1::2]))
        return [HostInfo(h, int(s)) for h, s in pairs[1:]]

    # Node-shape introspection for the jsrun ERF rankfile (reference
    # queries CSM allocation + remote lscpu, ``lsf.py:42-103``; here the
    # values come from the LSF/user env with local-machine fallbacks).
    @staticmethod
    def get_num_cores() -> int:
        v = os.environ.get("HOROVOD_LSF_CORES_PER_NODE")
        if v:
            return int(v)
        return os.cpu_count() or 1

    @staticmethod
    def get_num_threads() -> int:
        return int(os.environ.get("HOROVOD_LSF_THREADS_PER_CORE", "1"))

    @staticmethod
    def get_num_accelerators() -> int:
        """GPUs per node — bounds the slot count a host may carry in the
        rankfile (reference ``get_num_gpus``)."""
        v = os.environ.get("HOROVOD_LSF_ACCELERATORS_PER_NODE")
        if v:
            return int(v)
        hosts = LSFUtils.get_compute_hosts()
        return max((h.slots for h in hosts), default=1)


def jsm_identity() -> Optional[dict]:
    """Per-process identity from the PMIx/JSM env that ``jsrun`` (and
    OpenMPI's or MPICH's mpirun) set on each spawned rank — the
    worker-side half of the ``--jsrun`` and ``--mpi`` launch paths.
    Returns ``{rank, size, local_rank, local_size}`` or None outside such
    a launcher."""
    for rank_var, size_var, lrank_var, lsize_var in (
            ("PMIX_RANK", "PMIX_SIZE", "PMIX_LOCAL_RANK", "PMIX_LOCAL_SIZE"),
            ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",
             "OMPI_COMM_WORLD_LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_SIZE"),
            # MPICH hydra (reference supports MPICH, mpi_run.py:117)
            ("PMI_RANK", "PMI_SIZE",
             "MPI_LOCALRANKID", "MPI_LOCALNRANKS"),
    ):
        if rank_var in os.environ and size_var in os.environ:
            return {
                "rank": int(os.environ[rank_var]),
                "size": int(os.environ[size_var]),
                "local_rank": int(os.environ.get(lrank_var, "0")),
                "local_size": int(os.environ.get(lsize_var, "1")),
            }
    return None


def detect_cluster_hosts() -> Optional[List[HostInfo]]:
    """Host list from the ambient scheduler, or None outside any cluster
    (the ``hvdrun`` no-flags path on LSF)."""
    if LSFUtils.using_lsf():
        hosts = LSFUtils.get_compute_hosts()
        if hosts:
            return hosts
    return None
