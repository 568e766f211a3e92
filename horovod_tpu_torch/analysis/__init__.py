"""The analysis layer of the port (``horovod_tpu/analysis``): the cost
model (:mod:`~horovod_tpu_torch.analysis.cost_model`: the H100 hardware
model, the exchange's wire bytes per level, a traced step's cost, plan
pricing and the plan's memory high-water), calibration
(:mod:`~horovod_tpu_torch.analysis.calibration`: alpha-beta fits of the
measured collectives, the artifact, the simulator) and the trace lint
(:mod:`~horovod_tpu_torch.analysis.trace_lint`: JAX's HLO001-HLO007 over
a step's record and over bench artifacts).  The JAX package's lint
engine and perf gate are not ported yet.
"""
