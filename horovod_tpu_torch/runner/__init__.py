"""The port's launcher (``horovod_tpu/runner``): the ``hvdrun`` CLI
(``python -m horovod_tpu_torch.runner``), host assignment, the ssh
fan-out, the ``--mpi`` and ``--jsrun`` branches, the NIC ring probe and
the rendezvous address.

Reference: ``horovod/runner/`` (launch.py CLI, gloo_run/mpi_run, driver
and task services).  Programmatic entry:
``horovod_tpu_torch.runner.run(fn, np=4)`` (reference ``horovod.run``,
``runner/__init__.py:90``).  Elastic launch is not ported yet.
"""

from horovod_tpu_torch.runner.api import run

__all__ = ["run"]
