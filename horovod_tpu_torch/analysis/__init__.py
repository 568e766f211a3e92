"""The analysis layer of the port (``horovod_tpu/analysis``): the cost
model (:mod:`~horovod_tpu_torch.analysis.cost_model`: the H100 hardware
model, the exchange's wire bytes per level, plan pricing and the plan's
memory high-water) and calibration
(:mod:`~horovod_tpu_torch.analysis.calibration`: alpha-beta fits of the
measured collectives, the artifact, the simulator).  The JAX package's
lint engine, HLO rules and perf gate are not ported yet.
"""
