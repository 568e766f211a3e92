#!/usr/bin/env python3
"""Smoke run of horovod_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. build the CUDA kernels from ``horovod_tpu_torch/ops/csrc`` (seconds
   printed, with the compiler's register and spill report and, from the
   SASS, what the warp-specialised kernels' and kernel 5's code uses);
2. hold each kernel against its plain PyTorch version at the shapes the
   training paths give it: ``fused_scale`` on a 64 MiB fp32 bucket, an odd
   length and a bf16 cast; flash forward (a warp-specialised TMA +
   ``wgmma`` design), dQ and dK/dV (TMA + ``wgmma``, one warpgroup a
   block; dQ also computes delta from O, held against ``flash_delta``)
   at b6 h16 t1024 d128 bf16, causal (plus small off-grid
   shapes, the forward's 128-row tile edges, ``FLASH_EDGES``, and the
   backward's 64-row ones, ``BWD_EDGES``);
   ``fused_conv_bn_relu_bwd`` at ResNet-50's fused segments,
   128x28x28x128 and 128x14x14x256 bf16 (plus ragged shapes);
   ``pallas_matmul`` (a warp-specialised TMA + ``wgmma`` design) at the
   tensor-parallel path's four projections
   (6144 tokens by 2048-8192 features) in the three layouts of a linear
   layer (forward, dX, dW), with bf16 and fp32 output (plus ragged shapes);
   the flash kernels' global-positions variant at b6 h16 t1024 d128 bf16,
   causal, for the sp ring's position pairs (arange; zigzag world 4, rank
   1's queries against rank 3's block and rank 2 against its own;
   contiguous rank 0 against rank 1's block, where every row is masked and
   O, lse and the gradients must be exactly 0, the sentinel and 0), from
   the plain forward's lse (plus an off-grid shape and the backward's edges);
3. time each kernel beside its bound (the larger of bytes over 3.35 TB/s
   and products over 989 TFLOP/s; for the flash kernels, with and without
   positions, and the matmul also the kernel/library ratio, achieved
   TFLOP/s and share of bound), its plain version and, where one exists, a
   single PyTorch call computing the same function; ``fused_scale`` and
   the conv backward as profiler device time, the others with CUDA events:
   ``fused_scale`` on a 64 MiB fp32 bucket out of place and in place and
   over the transformer step's own buckets (each a tensor of its own) in
   place, launch-weighted, beside
   ``x.float().mul(f).to(dt)``; the conv backward split by launch (each
   GEMM's TFLOP/s) beside autograd through the unfused segment;
   for the matmul, ``torch.matmul``; for the flash forward, SDPA; for dQ
   and dK/dV, SDPA's backward alone, which computes the pair's dQ, dK and
   dV in one call, with the pair's ratio to it; for the positions variant,
   SDPA with the boolean mask; and one layer's attention forward +
   backward through the fused sp ring at sp = 1, the plain ring and
   ``flash_attention``;
4. train the 870.9M TransformerLM (16 layers, d_model 2048, 16 heads,
   seq 1024, batch 6) through the five-line recipe on a world of one:
   ``init`` (NCCL), ``DistributedOptimizer(AdamW(3e-4, weight_decay=1e-4),
   gradient_predivide_factor=2.0)``, whose gradient hooks launch each
   bucket's exchange on a side stream while backward runs,
   ``broadcast_variables``, a few steps on a fixed batch (the loss must
   fall; every kernel of the path must be launched, each flash kernel
   exactly 16 times a step; every bucket must launch from a hook), the
   profiled step's exchange kernels and the part of them that ran under
   backward's, the same weights under dense attention for comparison, a
   rank-0 checkpoint round trip, and then phase 9;
5. train ResNet-50 at ``bench.py``'s configuration (224 px, batch 128,
   bf16, space-to-depth stem, ``--fused-bwd``, inference-mode BN) through
   the same recipe with ``SGD(0.01, momentum=0.9)``, 6 steps on a fixed
   batch (the loss must fall; the fused backward kernel must run exactly 8
   times a step), and the same weights with ``fused_bwd=False`` for
   comparison;
6. train the same 870.9M TransformerLM through the tensor-parallel
   execution mode, ``fused_tp_apply`` on a tp group of one, with flash
   attention and the same recipe, 5 steps (the loss must fall; the matmul
   kernel must run exactly 192 times a step, 4 projections x 16 layers x
   forward, dX and dW, and each flash kernel 16 times), and the same
   weights through ``TransformerLM``'s own forward for comparison;
7. train the same 870.9M TransformerLM with ``attention_impl="ring"`` on an
   sp group of one through ``DistributedTrainStep(plan="sp=1")``, with the
   weights, batch and AdamW of phase 4, 5 steps (the loss must fall; each
   step must launch each positions kernel exactly 16 times and the flash
   kernels without positions never), and hold its first step's loss and
   gradients against phase 4's (1e-5 relative; bit-exact expected, and
   logged);
8. train the same 870.9M TransformerLM through the sharded exchange,
   ``DistributedOptimizer(AdamW, gradient_predivide_factor=2.0,
   shard_optimizer_states=True)``, with phase 4's weights and batch, 5 steps
   in two cases: (a) the fp32 wire in one bucket, whose losses must equal
   phase 4's bit for bit; (b) ``Compression.int8`` with error feedback
   and 64 MiB buckets, whose loss must fall and end within
   ``ZERO_INT8_TOL`` of case (a)'s 5-step drop.  Each case must launch
   ``fused_scale`` twice a group a step and each flash kernel 16 times a
   step; each prints step time, tokens/s, peak memory and the profiled
   step's device time split into reduce-scatter, codec passes, allgather,
   shard AdamW and the rest;
9. the overlapped exchange and the eager surface, on phase 4's model:
   (a) one step's hook-exchanged gradients against
   ``distributed_gradients`` applied to the same loss's gradients from
   ``torch.autograd.grad``, which fires no hook, bit for bit; (b) every
   gradient (fp32, ~3.5 GB) through ``hvd.allreduce_async(g,
   prescale_factor=0.5, postscale_factor=2.0)`` and ``synchronize``, bit
   for bit against ``distributed_gradients`` with the same factors, with
   the Bucketer's groups, its ``fused_scale`` launches (two a group) and
   the wall and device ms of both; (c) ``broadcast_async``,
   ``alltoall_async`` with splits, ``allgather``, ``allgather_object``,
   ``join``, ``poll`` on an in-flight handle, the duplicate-name error and
   a CPU tensor through the host plane, each against its expected value;
10. the Switch-MoE LM at ``bench.py --model moe``'s defaults (12 layers,
   d_model 1024, 8 heads, d_ff 4096, 8 experts every second block,
   capacity factor 1.25, seq 1024, batch 16, bf16, flash; 536.2M
   parameters): (a) 5 steps through the hook path with
   ``gradient_predivide_factor=2.0`` (the loss, CE + 0.01·aux, must fall;
   each flash kernel exactly 12 times a step, ``fused_scale`` twice a
   bucket, every bucket from its hook), with the drop fractions, the
   expert shares and a profiled step whose device time has routing as a
   category of its own; (b) ``expert_chunk_mlp`` at one layer's dispatch
   shape, (8, 2560, 1024) x 4096, through kernel 6 (16 launches), held
   against the batched-einsum expert body under kernel 6's limits and
   timed beside it; (c) the same LM with ``shard_optimizer_states=True``:
   one step, ``save_sharded`` and ``save`` on the async writer, a second
   step, then a fresh model and wrapper restore and repeat it, bit for bit
   (at 4 of the 12 layers, ``MOE_CKPT_LAYERS``, to keep the script's
   time; fewer if the temporary directory's disk is short); every
   number printed with the card's name and power limit;
11. the input plane and SyncBatchNorm: (a) phase 5's ResNet-50 fed from
   host memory, as ``bench.py --model resnet50 --fused-bwd --input-mode
   host`` feeds it: 512 seeded fp32 images in an ``ArraySource`` through
   ``ShardedDataset(batch_size=128, seed=broadcast_seed(0))`` and
   ``PrefetchIterator(depth=2, threads=2, place=step.shard_local_batch)``,
   with ``gradient_predivide_factor=2.0`` so that the exchange scales each
   bucket twice at a world of one; 2 + 8 steps across two epoch
   boundaries (kernel 5 exactly 8 times a step, ``fused_scale`` twice a
   bucket, the losses finite), the pinned staging buffers and the copy
   stream, the median stall of the timed steps (``input_stall_s``), img/s
   fed and on a resident batch, two profiled fed steps whose batch copies
   must be pinned copies off the main stream, a synchronous control (the
   seeded weights again, the same batches placed inline and fenced) whose
   losses must equal the fed run's (``FED_LOSS_TOL``; bit-exact expected,
   logged), and the H2D probe (``utils/input_probe.py``) under
   ``bench.py``'s field names; (b) ``SyncBatchNorm`` on a world of one at
   ResNet-50's BatchNorm shapes (``SYNC_BN_SHAPES``, bf16, channels last)
   against ``BatchNorm(train=True)``: output, running statistics and the
   input, scale and bias gradients within ``SYNC_BN_TOL`` (bit-exact
   expected, logged), one all-reduce in the forward and one in the
   backward, forward + backward timed beside BatchNorm;
12. the launcher: (a) phase 4's recipe (the 870.9M TransformerLM, the same
   seed, weights, batch, AdamW, predivide 2.0 and hook path, 5 steps)
   started by ``python -m horovod_tpu_torch.runner -np 1 python
   chip_smoke.py --launched OUT``, whose worker checks the launcher's
   variables and the port's controller stamp and calls ``hvd.init()``
   with no device: its losses must equal phase 4's bit for bit, each
   flash kernel launch 16 times a step and ``fused_scale`` 132, and the
   identity be rank 0 of 1, local 0 of 1, on ``cuda:0`` (launch to first
   step beside phase 4's in-process init to first step, step ms, tokens/s
   and peak memory printed); (b) ``horovod_tpu_torch.runner.run`` of
   :func:`card_identity` on one rank; (c) ``--check-build`` must report
   CUDA and NCCL; (d) a rank that exits 3 must make the launcher return
   3;
13. Adasum and the row-sparse exchange: (a) phase 4's recipe (the same
   seed, weights, batch and AdamW, 5 steps) through
   ``DistributedAdasumOptimizer(AdamW)`` and
   ``DistributedTrainStep(op=None)``: at a world of one Adasum is the
   identity, so its first loss must be phase 4's, its parameters after the
   first step ``start + (local - start)`` of phase 4's bit for bit, and its
   losses phase 4's within ``ADASUM_LOSS_TOL`` (bit-exactness logged);
   each flash kernel must launch 16 times a step,
   and the step time beside phase 4's, the peak memory and the delta
   machinery's device time (stash, subtract, add: 8 bytes moved a
   parameter byte) against its bound are printed; (b) Adasum's combine of
   the model's 98 gradients from two seeded batches (``adasum_tree`` over
   two rows per tensor, the cross level's function) against the same call
   on the CPU in fp32 within ``combine_tol`` per tensor, bitwise symmetric
   on the card, its time (CUDA events, and one call's kernels under the
   profiler) against its bound (both sets read twice, one written) and its
   launches; (c) a 32000 x 2048 fp32 untied
   embedding's gradient from phase 4's batch shape through
   ``DistributedOptimizer(SGD, sparse_params={"embedding": 6144})``
   against the dense exchange, bit for bit, both timed, and whether the
   sparse path synced with the host (``torch.cuda.set_sync_debug_mode``);
   every number printed with the card's name and power limit;
14. the two-level sharded exchange: phase 8's two cases (the same
   weights, batch, AdamW, predivide 2.0, 5 steps) through
   ``DistributedOptimizer(..., shard_optimizer_states=True,
   hierarchy="two_level")`` and ``DistributedTrainStep``, whose
   ``exchange_hierarchy`` must read ``"two_level"``: at a world of one
   both levels are one rank, so (a) the fp32 wire must equal phase 8
   (a)'s losses bit for bit, and (b) ``Compression.int8`` with error
   feedback, 64 MiB buckets and ``reduction="adasum"`` quantizes the local
   hop and the cross hop (as JAX's two-level exchange does at any extent)
   and must end within ``ZERO_INT8_TOL`` of (a)'s drop (its distance
   from phase 8 (b) logged); ``fused_scale`` twice a group a step and each
   flash kernel 16 times a step; step time beside phase 8's in the same
   call, tokens/s, peak memory and the profiled step's split under the
   exchange's ranges, with the card's name and power limit;
15. tp and fsdp in the step's plan, and the ViT: (a) phase 4's recipe (the
   same seed, weights, batch, AdamW, predivide 2.0 and hook path, 5 steps)
   with the 870.9M LM built with the tp group of ``plan.build_mesh()`` for
   ``plan="tp=1"`` (a group of one: the ``ColumnParallelDense``/
   ``RowParallelDense`` modules with no collective) through
   ``DistributedTrainStep(mode="pjit", plan="tp=1")``: its losses must
   equal phase 4's bit for bit, each flash kernel 16 launches a step; its
   step time beside phase 4's and one profiled step's idle share;
   (b) ViT-B/16 at ``bench.py --model vit``'s defaults (224 px, 196
   patches, batch 128, bf16, flash) through ``DistributedTrainStep`` with
   ``AdamW(3e-4, weight_decay=1e-4)``, 5 steps (finite, falling losses;
   each flash kernel exactly 12 launches a step, non-causal), img/s, peak
   memory and a profiled step, and the same weights under dense attention
   (loss within 5e-3 relative, gradients 2e-2 normwise, phase 6's
   limits); (c) the three flash kernels timed non-causal at ViT's shape
   (b128 t196 h12 d64) beside SDPA without a mask and the bound (the same
   shape is held against the plain versions in phase 2);
16. (a) phase 4's recipe under ``hvd.elastic.run``, interrupted and
   restored, and (b) the 16 blocks through ``interleaved_1f1b`` and gpipe
   on a pp group of one;
17. the runtime tools on phase 4's model, weights and batch, right after
   phase 9 (``phase_tools``): (a) phase 9 (b)'s eager pass over the 98
   gradients under ``start_timeline`` with the native writer (it must be
   the one that ran) and then the Python writer, each bit for bit the pass
   with the timeline off, three wall-clock readings each way, and a
   NEGOTIATE and an ``NCCL_ALLREDUCE`` span for every gradient in the
   native trace with no event dropped; (b) one pass under
   ``torch.profiler`` holding the timeline's ``record_function`` ranges;
   (c) a world made anew with ``HOROVOD_AUTOTUNE=1`` (4 dispatches a
   sample, 2 Bayesian samples), passes until the parameter manager is
   done, every result bit for bit, its log and chosen point; (d)
   ``ThroughputAutotuner`` over the sharded exchange's
   ``exchange_bucket_bytes`` at 16, 64 and 256 MiB, three timed steps
   each (tokens/s, a reading); (e) with the metrics exporters on, a
   rank-0 checkpoint of the model: the saves counter rises by one, the
   stall histogram's sum is ``last_stall_s``, the JSONL snapshot is
   written and the Prometheus endpoint on localhost is scraped once;
   every number with the card's name and power limit;
18. the planning and memory plane on phase 4's recipe
   (``phase_memory``): (a) each remat tier (``none``, ``dots``, ``full``,
   ``offload``) 3 steps, losses bit for bit ``none``'s, the flash forward
   twice a block a step under remat, step time, peak memory, the measured
   activation share and overhead beside the cost model's constants, the
   offload tier's host bytes (its activations under ``dots``'); (b) the planner
   under ``HOROVOD_HBM_BUDGET_BYTES`` between none's and full's peaks,
   its tier trained through ``HOROVOD_REMAT_POLICY`` under the budget;
   (c) ``HostOffloadEngine`` round-tripping AdamW's state, bit-exact, GB/s
   each way; (d) the card's rates and memory beside the H100 preset;
19. the training-state guard and the serving plane (``phase_guard``,
   ``phase_serve``): (a) phase 4's recipe through the step's ``guard=``
   (skip_step), its losses bit for bit, a non-finite and a spiked step
   skipped with the parameters' and AdamW's fingerprints unchanged, the
   norm against ``vector_norm``, guarded against unguarded step ms; (b)
   the card's fingerprint of 10.45 GB against the host's; (c)
   rollback-and-replay at 4 of the 16 layers, bit for bit a fault-free
   run; (d) the 870.9M LM served by two replicas through
   ``ExecutableCache.from_module`` with a crash mid-load; (e) a fleet of
   the LM and ViT-B/16 with a live weight flip and a corrupt one caught;
20. the executable plane (``phase_graph``): (a) phase 4's recipe with
   ``AdamW(capturable=True)`` through ``steps_per_call=4``, the step
   captured as a CUDA graph and replayed, two calls against eight eager
   calls bit for bit (losses, parameters, AdamW's state), the capture's
   seconds, ms a step and host ms a call both ways, the peaks, a replayed
   call's kernel launches from the profiler (4 x the step's) and the
   in-memory layer's hits and misses; (b) the compile cache's warm start:
   phase 12 (a)'s fresh process loaded the kernel library that phase 1
   built into the store (a hit, 0 s of compiling); (c) phase 19 (d)'s 48
   requests in six batches through ``ExecutableCache.from_module``'s graph
   executors and the eager forward, bit for bit, requests/s both ways;
21. the overlap probe and the affinity knob (``phase_probe``): (a)
   ``measure_overlap`` on phase 4's recipe at full width (the 870.9M LM,
   batch 6 x 1024, bf16, flat at a world of one, where the exchange moves
   no bytes across cards): the three medians, the fraction, the exposed
   tail, the payload, the bench fields as one JSON line, the kernels'
   launches over one call of each program from the profiler, and the fused
   program's fingerprint against that of backward followed by the
   exchange run on its own, bit for bit, each median taken without the
   fingerprint pass the program ends in; (b) one worker launched through
   ``python -m horovod_tpu_torch.runner -np 1`` with
   ``HOROVOD_THREAD_AFFINITY`` set to the first half of this process's
   cores: after ``hvd.init()`` every thread it holds, those made before
   (torch's intra-op pool) and since (the CUDA driver's, NCCL's), is
   pinned to that set, and it takes one step of a small LM;
22. the kernels as dispatcher ops and the AOT executable store
   (``phase_aot``): (a) each ``torch.ops.hvd_torch`` op called directly
   equals its wrapper bit for bit at the main path's shapes (a 64 MiB
   bucket, b6 h16 t1024 d128 with and without positions, kernel 5's 28x28
   segment, the qkv projection), one launch a call; phase 4's step ms and
   launches a step through the ops, phase 18's flash forwards a tiered
   step; (b) the 870.9M LM at t 1024, buckets 4 and 8, exported and
   compiled by AOTInductor through ``ExecutableCache.from_exported`` into a
   fresh ``HOROVOD_COMPILE_CACHE_DIR`` (compile seconds), 16
   ``hvd_torch::flash_fwd`` launches a batch, each batch within the served
   limits of the plain path; a fresh process (``--aot-load``) loads both
   executables from the store (hits, nothing compiled: load seconds) and
   serves the same batches; (c) a weight flip runs on the same executables
   and rebuilds them as hits; (d) requests/s of the AOT executors beside
   ``from_module``'s graph executors and the eager forward;
23. the step's own record (``phase_trace``): phase 4's recipe at full
   width (the 870.9M LM, bf16, 6 x 1024 tokens, flash) after one warm step,
   one step through ``DistributedTrainStep.trace``: its FLOPs by op against
   the analytic count from the recipe's shapes (within
   ``TRACE_FLOP_TOL``; the flash ops exactly 6·2·B·h·t²·d·L), TFLOP/s and
   share of the H100 model's peak at the traced step's time and at one
   untraced step's, the measured memory high-water (the allocation
   events) above what was live at the step's start against
   ``max_memory_allocated`` over the same step, ``module_cost``'s
   predicted step time, the lint's findings (none at a world of one), the
   kernels the trace saw (each flash kernel 16 launches), and each flop
   formula against the dense computation it replaces (attention at the
   recipe's shape, kernels 5 and 6 at ``FLOP_CHECK_SMALL``); one traced
   step, no repeats, to keep the phase near its 30 s budget; (b) a small
   LM's sharded step traced at a world of one (``TRACE_SMALL_LM``), its
   collectives' device windows and serial tail reported;
24. print the card's name and power limit, the kernels' JSON line, and last
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.  Needs one card.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# the profiler helpers and the sharded exchange's ranges (ZERO_RANGES) live
# in the port's trace module; they stay importable from here
from horovod_tpu_torch.utils.trace import (  # noqa: F401
    ZERO_RANGES,
    is_annotation,
    launched_kernels,
    range_kernels,
    split_ranges,
)

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (data sheet)
PEAK_FP32_FLOPS = 67e12       # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
SEED = 0
FULL = dict(batch=6, seq=1024, heads=16, head_dim=128, layers=16,
            d_model=2048, vocab=32_000)
# bench.py's ResNet-50: batch 128 per GPU (bench.py:2712), 224 px (:2714)
RESNET = dict(batch=128, image=224, steps=6)
# the kernels each training path launches, read after its own run
TRANSFORMER_KERNELS = ("fused_scale", "flash_fwd", "flash_bwd_dq",
                       "flash_bwd_dkv")
RESNET_KERNELS = ("fused_conv_bn_relu_bwd",)
TP_KERNELS = ("pallas_matmul", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
SP_KERNELS = ("flash_fwd_pos", "flash_bwd_dq_pos", "flash_bwd_dkv_pos")
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# Case (b)'s last loss may lie within this share of case (a)'s 5-step loss
# drop from case (a)'s last loss.  The CPU parity test
# (tests/test_torch_zero.py, test_int8_wire_with_error_feedback_stays_near_
# fp32) runs this recipe at this vocabulary and half the width (one layer,
# d_model 1024) and holds it to 5 % (it read 1.9 %): wider tensors put more
# of their elements under one int8 step of their shared scale, to wait in
# the residual, so twice the width gets twice the CPU limit.
ZERO_INT8_TOL = 1e-1

# pallas_matmul at the tp path's projections, (m, k, n) of the forward
# x (m, k) @ weightᵀ (k, n); each runs 16 times a step in each layout
MM_MAIN = {"qkv": (6144, 2048, 6144), "proj": (6144, 2048, 2048),
           "wi": (6144, 2048, 8192), "wo": (6144, 8192, 2048)}
MM_LAYERS = FULL["layers"]
MM_LAYOUTS = ("fwd", "dx", "dw")
# the forward's 128-row tiles at their edges: a t that straddles a tile,
# the d64 template over a long non-causal t, and two whole tiles of one head
FLASH_EDGES = [((1, 136, 2, 128), True), ((2, 1000, 4, 64), False),
               ((1, 256, 1, 128), True)]
# the backward's 64-row tiles at their edges: one row past a tile, a block
# whose second 64-row half is past t (136 = 128 + 8), a t under one tile,
# both head_dims; the even ones also carry the positions pairs
BWD_EDGES = [((1, 65, 2, 128), True), ((2, 136, 3, 64), True),
             ((1, 40, 2, 128), True), ((1, 40, 2, 64), False)]
# bench.py --model moe's defaults (bench.py:2948-2966, run_moe :1086-1099):
# 12 layers, d_model 1024, 8 heads of 128, d_ff 4096, 8 experts, every
# second block MoE, capacity factor 1.25, seq 1024, batch 16
MOE = dict(batch=16, seq=1024, heads=8, layers=12, d_model=1024, d_ff=4096,
           experts=8, moe_every=2, capacity_factor=1.25, vocab=32_000,
           aux=0.01, steps=5)
# phase 10 (c)'s depth: 4 of the 12 layers (two MoE blocks) since phase 15
# joined, to keep the script's time; the round trip is the same at any depth
MOE_CKPT_LAYERS = 4
# phase 10 (b): expert_chunk_mlp at one MoE layer's shapes on one card:
# every expert local, capacity ceil(1.25 * 16384 / 8)
CHUNK = dict(e_local=8, capacity=2560, d=1024, f=4096)
# ViT-B/16 at bench.py --model vit's defaults (bench.py:871-876, 2946):
# 224 px, patch 16 (196 patches), 12 layers, 12 heads of 64, d_model 768,
# d_ff 3072, 1000 classes, batch 128, bf16
VIT = dict(batch=128, image=224, steps=5, layers=12)
VIT_FLASH = (VIT["batch"], 196, 12, 64)       # flash's (b, t, h, d)
# the card's name and power limit (nvidia-smi), printed beside the numbers
# of phases 8 and 10-14
CARD = ""
# ragged shapes: M edges of 8, 24 and 136 rows in the forward and dX, and a
# 24-row M edge in dW (its n); a layout whose call falls outside the
# dispatch rule takes the plain version and is not checked
MM_RAGGED = [(8, 128, 128), (24, 384, 640), (136, 256, 384),
             (256, 128, 24)]


def check_flash_launches(counts: dict, steps: int, path: str,
                         layers: int = FULL["layers"]) -> None:
    """Each flash kernel without positions launched once a layer a step,
    and no positions variant."""
    want = dict.fromkeys(FLASH_KERNELS, layers * steps)
    want.update(dict.fromkeys(SP_KERNELS, 0))
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{path}: flash launches {got}, want {want}")


def log(msg: str) -> None:
    print(msg, flush=True)


def full_config(torch, attention_impl: str):
    """The 870.9M TransformerLM's configuration (``FULL``) in bf16."""
    from horovod_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(vocab_size=FULL["vocab"],
                             num_layers=FULL["layers"],
                             num_heads=FULL["heads"],
                             d_model=FULL["d_model"],
                             d_ff=4 * FULL["d_model"],
                             max_seq_len=FULL["seq"], dtype=torch.bfloat16,
                             attention_impl=attention_impl)


def bound_ms(nbytes: float, flops: float,
             peak_flops: float = PEAK_BF16_FLOPS) -> tuple:
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def efficiency(r: dict, flops: float) -> str:
    """A timed row's kernel/library ratio, achieved TFLOP/s and share of
    its bound."""
    lib = r.get("library_ms")
    ratio = f"{r['ms'] / lib:.2f}x its library call" if lib else \
        "no library call"
    return (f"{ratio}, {flops / r['ms'] / 1e9:.0f} TFLOP/s, "
            f"{100 * r['bound_ms'] / r['ms']:.1f} % of bound")


def fmt_ms(ms) -> str:
    """A reading in ms, or "not measured"."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_name(mangled: str) -> str:
    """``flash_bwd_dq_kernel<128, pos>``, ``cbr_dgrad`` and the like from a
    mangled name."""
    m = re.search(r"\d((?:flash|mm|scale|cbr)_[a-z0-9_]*?)[IE]"
                  r"(?:Li(\d+)ELb(\d))?", mangled) or \
        re.search(r"::((?:flash|mm|scale|cbr)_[a-z0-9_]*)"
                  r"(?:<(\d+), (true|false)>)?", mangled)
    if not m:
        return mangled[:60]
    if m[2] is None:
        return m[1]
    return f"{m[1]}<{m[2]}{', pos' if m[3] in ('1', 'true') else ''}>"


def sass_report(lib_path) -> None:
    """For each warp-specialised kernel of the library and each of kernel
    5's (``cbr_*``), from its SASS (``cuobjdump -sass``): the highest
    register its code names, its setmaxnreg instructions and its
    local-memory (spill) accesses.  ptxas reports 168 registers for every
    384-thread kernel whatever setmaxnreg asks; the SASS shows what the
    consumer warpgroups use."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(lib_path)],
                              capture_output=True, text=True,
                              timeout=300).stdout
    except OSError as e:
        log(f"  sass: not read ({e})")
        return
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = chunk.split("\n", 1)
        if "USETMAXREG" not in body and "cbr_" not in name:
            continue
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", body)]
        setmaxnreg = sorted({" ".join(i.split()) for i in
                             re.findall(r"USETMAXREG[^;]*", body)})
        log(f"  sass: {kernel_name(name)}: highest register R{max(regs)}, "
            f"{setmaxnreg}, {len(re.findall(r'\bSTL', body))} STL / "
            f"{len(re.findall(r'\bLDL', body))} LDL")


def device_rows(prof) -> list:
    """(device ms, count, name) of each kernel a torch.profiler run saw;
    annotations such as "Optimizer.step#AdamW.step", and the device side
    of a ``record_function`` range (which ``key_averages`` files under the
    range's name), span the kernels under them and would count twice
    (kernel names may hold "#" too: "{lambda()#1}")."""
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0 and not is_annotation(e.key) and \
                str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((us / 1e3, e.count, e.key))
    return rows


def device_split(torch, fn, iters: int = 20, warmup: int = 3,
                 tries: int = 3) -> dict:
    """{kernel: device ms per call of ``fn``} over ``iters`` calls under
    torch.profiler, the port's kernels by :func:`kernel_name`.  Every
    kernel of ``fn`` runs the same number of times each call, so a trace
    in which one ran a number of times that is not a multiple of
    ``iters`` has lost records (on an H100 it read 30 % of a call's
    time): it is taken again, up to ``tries`` times, and then fails."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        if rows and all(count % iters == 0 for _, count, _ in rows):
            break
        log(f"  profiler: a trace lost kernel records "
            f"{sorted({count for _, count, _ in rows})} for {iters} calls;"
            f" taken again")
    else:
        raise RuntimeError(f"torch.profiler lost kernel records in "
                           f"{tries} traces")
    split: dict = {}
    for ms, _, key in rows:
        name = kernel_name(key)
        split[name] = split.get(name, 0.0) + ms / iters
    return split


def device_ms(torch, fn, iters: int = 20, warmup: int = 3,
              tries: int = 3) -> float:
    """The device time of one call of ``fn``: its kernels' own time under
    torch.profiler over ``iters`` calls.  For a call whose host work
    between kernels can outlast them (autograd's backward of SDPA), CUDA
    events around a loop would time the host instead."""
    return sum(device_split(torch, fn, iters, warmup, tries).values())


def phase_build():
    from horovod_tpu_torch.ops import build

    from horovod_tpu_torch.runtime import compile_cache

    lib_path = build.build()
    build.load_library()
    log(f"build: {build.build_seconds:.1f} s -> {lib_path.name} in the "
        f"compile cache's store {lib_path.parent} ("
        f"{'hit' if build.library_hit else 'miss'}; "
        f"{compile_cache.stats()})")
    report = lib_path.with_suffix(".log")
    if report.exists():
        for line in report.read_text().splitlines():
            if "Function properties for" in line:
                log("  ptxas: " + kernel_name(line.split("for", 1)[1]))
            elif "registers" in line or "spill" in line.lower() or \
                    "warning" in line:
                log("  ptxas:   " + line.split(":", 1)[-1].strip())
    sass_report(lib_path)


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# Flash tolerances.  O, dQ, dK and dV are bf16: each output is rounded once
# (up to one ulp, 2^-7 relative, where the two versions' fp32 sums round
# differently), summed in another order, and built from bf16 P and dS whose
# roundings may differ by one ulp, which moves a small entry by several of
# its own ulps.  Two conditions:
#  * normwise, ||got - want|| / ||want|| <= FLASH_NORM_TOL;
#  * elementwise, |got - want| <= FLASH_RTOL |want| + FLASH_ATOL rms(want),
#    so a small entry is held to its own size and not to the largest one.
# lse is fp32 in the log domain: its absolute error is the relative error
# of the row's softmax sum, held to LSE_ATOL.
FLASH_NORM_TOL = 1e-2
FLASH_RTOL = 2e-2
FLASH_ATOL = 1e-1
LSE_ATOL = 1e-3


# delta = rowsum(dO∘O) is an fp32 sum of d products in both versions, in
# another order (the kernel: four quarter sums of fused multiply-adds, then
# the quad's butterfly).  Each order is within d·2^-24 of the exact sum
# relative to the sum of the terms' magnitudes, so at d <= 128 the two agree
# within DELTA_TOL · Σ|dO∘O| of each row (2·128·2^-24 = 1.5e-5).
DELTA_TOL = 2e-5


def delta_agreement(torch, got, out, do) -> list:
    """(reading, limit) for the delta the dQ kernel computed from ``out``
    against ``flash_delta``: the worst row's |got - want| / (DELTA_TOL ·
    Σ|dO∘O|), a row of zeros held to exact zero."""
    from horovod_tpu_torch.ops import kernels as K

    diff = (got - K.flash_delta(out, do)).abs()
    mag = K.flash_delta(out.abs(), do.abs())
    return [("delta_ratio",
             float((diff / (DELTA_TOL * mag).clamp_min(1e-30)).max()), 1.0)]


def flash_agreement(torch, got, want, is_lse: bool) -> tuple:
    """(reading, limit) pairs for one flash output against its plain
    version; the output agrees when every reading is within its limit."""
    diff = (got.float() - want.float()).abs()
    if is_lse:
        return [("max_abs", float(diff.max()), LSE_ATOL)]
    w = want.float()
    rms = float(w.pow(2).mean().sqrt())
    return [("norm_rel", float(diff.norm() / w.norm()), FLASH_NORM_TOL),
            ("elem_ratio", float((diff / (FLASH_RTOL * w.abs()
                                          + FLASH_ATOL * rms)).max()), 1.0)]


# Kernel 5 (fused conv3x3 + BN + relu backward), (n, h, w, cin, c): the
# ResNet-50 segments that the dispatch rule fuses at 224 px, batch 128, with
# their launches per step, and a ragged shape.
CBR_MAIN = {(128, 28, 28, 128, 128): 3, (128, 14, 14, 256, 256): 5}
CBR_RAGGED = [(3, 10, 10, 128, 128), (2, 7, 9, 256, 128)]
# Kernel 5 tolerances, (normwise, rtol, atol as a share of rms(want)).
# dy = bf16(dz·seff) is the same fp32 product in both versions, and both
# multiply bf16 dy by bf16 W and bf16 a exactly; only the fp32 sums run in
# another order.  da is bf16: one rounding of nearly equal sums, up to one
# ulp (2^-7 relative) apart.  dW, dgamma and dbeta are fp32 sums over up to
# 100,352 rows: relative differences of order 1e-6.
CBR_TOL = {"da": (1e-2, 1e-2, 1e-2), "dW": (1e-4, 1e-3, 1e-3),
           "dgamma": (1e-4, 1e-3, 1e-3), "dbeta": (1e-4, 1e-3, 1e-3)}
CBR_OUTPUTS = ("da", "dW", "dgamma", "dbeta")


def cbr_inputs(torch, shape, seed: int, device: str = "cuda"):
    """``(db, b, a, w, gamma, beta, scale_eff)`` for kernel 5 at ``shape``:
    bf16 activations with ``b`` the segment's own forward output, fp32
    weights at lecun scale, and channel 0 at gamma 0 and beta 0.25 (exact
    in bf16), so its relu output is 0.25 everywhere and its dgamma is
    pinned to 0 by the kernel's guard, not left to 0/0."""
    from horovod_tpu_torch.ops import kernels as K

    n, h, w, cin, c = shape
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=gen, device=device)

    a = torch.relu(randn(n, h, w, cin)).to(torch.bfloat16)
    wgt = randn(3, 3, cin, c) * (9 * cin) ** -0.5
    gamma = 1.0 + 0.1 * randn(c)
    beta, mean = 0.1 * randn(c), 0.1 * randn(c)
    gamma[0], beta[0] = 0.0, 0.25
    var = 0.5 + torch.rand(c, generator=gen, device=device)
    with torch.no_grad():
        b = K.fused_conv_bn_relu(a, wgt, gamma, beta, mean, var).contiguous()
    db = randn(n, h, w, c).to(torch.bfloat16)
    return db, b, a, wgt, gamma, beta, gamma / torch.sqrt(var + 1e-5)


def cbr_agreement(torch, name: str, got, want) -> list:
    """(reading, limit) pairs for one output of kernel 5 against its plain
    version: normwise ||got - want|| / ||want||, and elementwise
    |got - want| / (rtol |want| + atol rms(want)) against 1."""
    norm_tol, rtol, atol = CBR_TOL[name]
    w = want.float()
    diff = (got.float() - w).abs()
    rms = float(w.pow(2).mean().sqrt())
    return [("norm_rel", float(diff.norm() / w.norm()), norm_tol),
            ("elem_ratio", float((diff / (rtol * w.abs() + atol * rms)).max()),
             1.0)]


def cbr_work(shape) -> tuple:
    """(bytes, operations) of one kernel-5 call: db, b, a and da in bf16,
    W and dW in fp32, five fp32 channel vectors; two implicit GEMMs of
    2·rows·cin·9c operations."""
    n, h, w, cin, c = shape
    rows = n * h * w
    nbytes = 2 * rows * (2 * c + 2 * cin) + 2 * 9 * cin * c * 4 + 5 * c * 4
    return nbytes, 2 * 2 * rows * cin * 9 * c


def check_cbr(torch, errs: dict) -> None:
    from horovod_tpu_torch.ops import kernels as K

    for shape in [*CBR_MAIN, *CBR_RAGGED]:
        args = cbr_inputs(torch, shape, seed=SEED + 2)
        got = K.fused_conv_bn_relu_bwd(*args)
        want = K.fused_conv_bn_relu_bwd_plain(*args)
        torch.cuda.synchronize()
        failed = []
        for name, g, w in zip(CBR_OUTPUTS, got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"conv_bn_relu_bwd {name} at {shape}: "
                                     f"{g.dtype} {tuple(g.shape)} vs "
                                     f"{w.dtype} {tuple(w.shape)}")
            readings = cbr_agreement(torch, name, g, w)
            err = max_err(torch, g, w)
            log(f"check fused_conv_bn_relu_bwd {name} {shape}: max_abs_err "
                f"{err:.3e} (largest entry {float(w.float().abs().max()):.3e}"
                f"); " + ", ".join(f"{key} {val:.3e} (tol {lim:.0e})"
                                   for key, val, lim in readings))
            if not all(val <= lim for _, val, lim in readings):
                failed.append(name)
            if shape in CBR_MAIN:
                errs["fused_conv_bn_relu_bwd"] = max(
                    errs.get("fused_conv_bn_relu_bwd", 0.0), err)
        if float(got[2][0]) != 0.0:
            failed.append("dgamma of the gamma = 0 channel")
        if failed:
            raise AssertionError(f"conv_bn_relu_bwd {failed} disagree with "
                                 f"plain at {shape}")


def mm_operands(torch, mkn, layout: str, seed: int, device: str = "cuda"):
    """``(a, b)`` for ``pallas_matmul(a, b)`` in one layout of a linear
    layer y = x @ weightᵀ with x (m, k), weight (n, k), dy (m, n), all
    bf16: ``fwd`` x @ weightᵀ (weight read transposed in place), ``dx``
    dy @ weight, ``dw`` dyᵀ @ x (dy read transposed in place)."""
    m, k, n = mkn
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(m, k, generator=gen, device=device).bfloat16()
    weight = (torch.randn(n, k, generator=gen, device=device)
              * k ** -0.5).bfloat16()
    dy = torch.randn(m, n, generator=gen, device=device).bfloat16()
    return {"fwd": (x, weight.t()), "dx": (dy, weight),
            "dw": (dy.t(), x)}[layout]


# pallas_matmul tolerances.  Both versions multiply the same bf16 values
# exactly and sum in fp32, in another order (the plain side is cuBLAS's
# SGEMM, whose order its own heuristics pick): a sound kernel read up to
# 9.2e-6 normwise with fp32 output on an H100, so MM_F32_TOL leaves 5x room
# under a limit still far below a fault.  A bf16 result is rounded once
# from nearly equal sums, so an entry moves by at most one bf16 step (2^-8
# relative) and almost all by none.  A lost K step of 32 at K = 2048 moves
# the result by sqrt(32/2048) = 1.25e-1 normwise; planted, it read 7.2e-2
# at the smallest.
MM_BF16_TOL = (5e-3, 1e-2, 1e-2)    # normwise, rtol, atol as a share of rms
MM_F32_TOL = 5e-5


def mm_agreement(torch, got, want) -> list:
    """(reading, limit) pairs for the matmul against its plain version."""
    w = want.float()
    diff = (got.float() - w).abs()
    norm_rel = float(diff.norm() / w.norm())
    if got.dtype == torch.float32:
        return [("norm_rel", norm_rel, MM_F32_TOL)]
    norm_tol, rtol, atol = MM_BF16_TOL
    rms = float(w.pow(2).mean().sqrt())
    return [("norm_rel", norm_rel, norm_tol),
            ("elem_ratio", float((diff / (rtol * w.abs() + atol * rms)).max()),
             1.0)]


def check_mm(torch, errs: dict) -> None:
    from horovod_tpu_torch.ops import kernels as K

    shapes = [(name, mkn) for name, mkn in MM_MAIN.items()] + \
        [("ragged", mkn) for mkn in MM_RAGGED]
    failed = []
    for name, mkn in shapes:
        for layout in MM_LAYOUTS:
            a, b = mm_operands(torch, mkn, layout, seed=SEED + 4)
            if not K.mm_fits(a.shape[0], a.shape[1], b.shape[1]):
                continue
            for out_dtype in (torch.bfloat16, torch.float32):
                before = K.pallas_matmul.launches
                got = K.pallas_matmul(a, b, out_dtype)
                want = K.pallas_matmul_plain(a, b, out_dtype)
                torch.cuda.synchronize()
                if K.pallas_matmul.launches != before + 1:
                    raise AssertionError("pallas_matmul did not launch")
                readings = mm_agreement(torch, got, want)
                err = max_err(torch, got, want)
                log(f"check pallas_matmul {name} {mkn} {layout} "
                    f"{str(out_dtype)[6:]}: max_abs_err {err:.3e} (largest "
                    f"entry {float(want.float().abs().max()):.3e}); " +
                    ", ".join(f"{key} {val:.3e} (tol {lim:.0e})"
                              for key, val, lim in readings))
                if not all(val <= lim for _, val, lim in readings):
                    failed.append((name, mkn, layout, str(out_dtype)))
                if name != "ragged" and out_dtype == torch.bfloat16:
                    errs["pallas_matmul"] = max(
                        errs.get("pallas_matmul", 0.0), err)
                del got, want
    if failed:
        raise AssertionError(f"pallas_matmul disagrees with plain: {failed}")


def pos_pairs(torch, t: int, device: str = "cuda") -> dict:
    """(qpos, kpos) of the sp ring's launches at a shard of ``t``: (a)
    ``arange`` (the sp = 1 path), (b) zigzag world 4, rank 1's queries
    against rank 3's block (some rows see no key), (c) zigzag rank 2
    against its own block, (d) contiguous rank 0 against rank 1's block
    (every row masked; the ring skips this launch)."""
    from horovod_tpu_torch.ops.fused_collectives import ring_layout_positions

    def pos(rank, layout):
        return ring_layout_positions(rank, 4, t, layout, device)

    return {"a": (pos(0, "contiguous"), pos(0, "contiguous")),
            "b": (pos(1, "zigzag"), pos(3, "zigzag")),
            "c": (pos(2, "zigzag"), pos(2, "zigzag")),
            "d": (pos(0, "contiguous"), pos(1, "contiguous"))}


def flash_outputs(torch, q, k, v, do, causal, scale, qpos=None,
                  kpos=None) -> dict:
    """The flash kernels and their plain versions on one input: the
    backward from the plain forward's O and lse as the autograd glue and
    the ring pass theirs, dQ computing delta from O, dK/dV reading it;
    the plain versions from ``flash_delta``.  {kernel: [(label, got, want),
    ...]}, the kernels named as the launch counters name them; "delta" is
    held by :func:`delta_agreement`."""
    from horovod_tpu_torch.ops import kernels as K

    suffix = "" if qpos is None else "_pos"
    pos = (qpos, kpos)
    o, lse = K.flash_fwd(q, k, v, causal, scale, *pos)
    o_ref, lse_ref = K.flash_fwd_plain(q, k, v, causal, scale, *pos)
    dq, delta = K.flash_bwd_dq(q, k, v, do, lse_ref, None, causal, scale,
                               *pos, out=o_ref)
    dk, dv = K.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal, scale,
                             *pos)
    args = (q, k, v, do, lse_ref, K.flash_delta(o_ref, do), causal, scale,
            *pos)
    dq_ref = K.flash_bwd_dq_plain(*args)
    dk_ref, dv_ref = K.flash_bwd_dkv_plain(*args)
    torch.cuda.synchronize()
    return {"flash_fwd" + suffix: [("O", o, o_ref), ("lse", lse, lse_ref)],
            "flash_bwd_dq" + suffix: [("dQ", dq, dq_ref),
                                      ("delta", delta, (o_ref, do))],
            "flash_bwd_dkv" + suffix: [("dK", dk, dk_ref),
                                       ("dV", dv, dv_ref)]}


def flash_readings(torch, label, got, want) -> list:
    """(reading, limit) pairs of one output of :func:`flash_outputs`."""
    if label == "delta":
        return delta_agreement(torch, got, *want)
    return flash_agreement(torch, got, want, label == "lse")


def check_flash_pos(torch, errs: dict, gen) -> None:
    """The positions variant at the main shape for pairs (a)-(d) and at an
    off-grid shape for (b), within the flash limits; pair (d) must give O =
    0, lse = the sentinel and gradients 0 exactly."""
    from horovod_tpu_torch.ops import kernels as K

    b, t, h, d = FULL["batch"], FULL["seq"], FULL["heads"], FULL["head_dim"]
    sentinel = torch.tensor(K.NEG_INF, dtype=torch.float32)
    cases = [((b, t, h, d), pair) for pair in "abcd"] + \
        [((2, 200, 3, 64), "b")] + \
        [(shape, pair) for shape, _ in BWD_EDGES if shape[1] % 2 == 0
         for pair in "bd"]
    failed = []
    for shape, pair in cases:
        qpos, kpos = pos_pairs(torch, shape[1])[pair]
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        results = flash_outputs(torch, q, k, v, do, True, shape[-1] ** -0.5,
                                qpos, kpos)
        for name, outputs in results.items():
            for label, got, want in outputs:
                if label == "delta":
                    readings = flash_readings(torch, label, got, want)
                    log(f"check {name} delta {shape} pair {pair}: " +
                        ", ".join(f"{key} {val:.3e} (tol {lim:.0e})"
                                  for key, val, lim in readings))
                    if not all(val <= lim for _, val, lim in readings):
                        failed.append((name, label, shape, pair))
                    continue
                err = max_err(torch, got, want)
                if pair == "d":
                    exact = float(sentinel) if label == "lse" else 0.0
                    ok = bool((got.float() == exact).all())
                    log(f"check {name} {label} {shape} pair {pair}: all "
                        f"{'the sentinel' if label == 'lse' else 'zero'}: "
                        f"{ok}")
                    readings = [] if ok else [("exact", 1.0, 0.0)]
                else:
                    readings = flash_agreement(torch, got, want,
                                               label == "lse")
                    log(f"check {name} {label} {shape} pair {pair}: "
                        f"max_abs_err {err:.3e} (largest entry "
                        f"{float(want.float().abs().max()):.3e}); " +
                        ", ".join(f"{key} {val:.3e} (tol {lim:.0e})"
                                  for key, val, lim in readings))
                if not all(val <= lim for _, val, lim in readings):
                    failed.append((name, label, shape, pair))
                if shape[1] == t:
                    errs[name] = max(errs.get(name, 0.0), err)
        del results, q, k, v, do
    if failed:
        raise AssertionError(f"positions kernels disagree with plain: "
                             f"{failed}")


def phase_check(torch):
    """Each kernel against its plain version; returns per-kernel errors."""
    from horovod_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = {}

    # fused_scale: the same fp32 product and round-to-nearest-even cast in
    # both versions, so tolerance 0, out of place and in place (the
    # exchange scales each bucket in place)
    f32, bf16 = torch.float32, torch.bfloat16
    n_bucket = 64 * 1024 * 1024 // 4
    cases = [("64MiB f32", n_bucket, 0.5, f32, f32, False),
             ("64MiB f32 in place", n_bucket, 0.5, f32, f32, True),
             ("odd f32", 1_000_003, 1.7, f32, f32, False),
             ("64MiB f32->bf16", n_bucket, 0.5, f32, bf16, False),
             ("odd bf16->f32", 999_999, 0.25, bf16, f32, False),
             ("odd bf16 in place", 999_999, 0.25, bf16, bf16, True)]
    worst = 0.0
    for name, n, f, in_dtype, out_dtype, in_place in cases:
        x = torch.randn(n, generator=gen, device=dev).to(in_dtype)
        want = K.fused_scale_plain(x, f, out_dtype)
        got = K.fused_scale(x, f, out_dtype, out=x if in_place else None)
        torch.cuda.synchronize()
        if in_place and got.data_ptr() != x.data_ptr():
            raise AssertionError(f"fused_scale {name} did not write x")
        err = max_err(torch, got, want)
        log(f"check fused_scale {name}: max_abs_err {err:.3e} (tol 0)")
        if not err == 0.0:
            raise AssertionError(f"fused_scale {name} disagrees with plain")
        worst = max(worst, err)
    errs["fused_scale"] = worst

    # flash at the main path's shapes, then small off-grid ones and the
    # tile edges
    b, t, h, d = FULL["batch"], FULL["seq"], FULL["heads"], FULL["head_dim"]
    shapes = [((b, t, h, d), True, True), (VIT_FLASH, False, False),
              ((2, 256, 4, 128), False, False),
              ((2, 200, 3, 64), True, False), ((1, 24, 2, 64), True, False),
              *[(shape, causal, False)
                for shape, causal in FLASH_EDGES + BWD_EDGES]]
    for shape, causal, main in shapes:
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        results = flash_outputs(torch, q, k, v, do, causal,
                                shape[-1] ** -0.5)
        failed = []
        for name, outputs in results.items():
            for label, got, want in outputs:
                readings = flash_readings(torch, label, got, want)
                detail = "" if label == "delta" else (
                    f"max_abs_err {max_err(torch, got, want):.3e} (largest "
                    f"entry {float(want.float().abs().max()):.3e}); ")
                log(f"check {name} {label} {shape} causal={causal}: "
                    f"{detail}" + ", ".join(
                        f"{key} {val:.3e} (tol {lim:.0e})"
                        for key, val, lim in readings))
                if not all(val <= lim for _, val, lim in readings):
                    failed.append(f"{name} {label}")
                if main and label != "delta":
                    errs[name] = max(errs.get(name, 0.0),
                                     max_err(torch, got, want))
        if failed:
            raise AssertionError(f"{failed} disagree with plain at {shape}")
    check_flash_pos(torch, errs, gen)
    check_cbr(torch, errs)
    check_mm(torch, errs)
    return errs


def time_cbr(torch) -> dict:
    """Kernel 5 at each main-path shape, as profiler device time: the
    call split by launch (each GEMM with its TFLOP/s; the weight's cast
    and transpose, which the wrapper runs, appear under their own names),
    the plain version, and the yardstick, autograd through the unfused
    segment as the ``fused_bwd=False`` model runs it (cuDNN dgrad and
    wgrad plus the BN and relu passes; no single PyTorch call computes
    this function, and the port never calls it).  Returns the
    launch-weighted mean per call over one training step's 8 launches,
    which is what the kernels' JSON line carries."""
    from horovod_tpu_torch.models.resnet import BatchNorm, Conv
    from horovod_tpu_torch.ops import kernels as K

    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0)
    work = [0.0, 0.0]
    per_step = sum(CBR_MAIN.values())
    for shape, count in CBR_MAIN.items():
        args = cbr_inputs(torch, shape, seed=SEED + 3)
        db, _, a, wgt, gamma, beta, _ = args
        n, h, w, cin, c = shape
        conv = Conv(cin, c, 3, dtype=torch.bfloat16, device="cuda")
        norm = BatchNorm(c, dtype=torch.bfloat16, device="cuda")
        with torch.no_grad():
            conv.weight.copy_(wgt.permute(3, 2, 0, 1))
            norm.scale.copy_(gamma)
            norm.bias.copy_(beta)
            norm.mean.normal_(0.0, 0.1)
            norm.var.uniform_(0.5, 1.5)
        x = a.permute(0, 3, 1, 2).detach().requires_grad_()
        seg = torch.relu(norm(conv(x), train=False))
        leaves = (x, conv.weight, norm.scale, norm.bias, norm.mean, norm.var)
        dseg = db.permute(0, 3, 1, 2)

        def unfused_bwd():
            torch.autograd.grad(seg, leaves, dseg, retain_graph=True)

        split = device_split(torch, lambda: K.fused_conv_bn_relu_bwd(*args))
        r = dict(ms=sum(split.values()),
                 plain_ms=device_ms(torch, lambda: K.fused_conv_bn_relu_bwd_plain(
                     *args), iters=5),
                 library_ms=device_ms(torch, unfused_bwd))
        bms, by = bound_ms(*cbr_work(shape))
        gemm_flops = cbr_work(shape)[1] / 2
        log(f"time fused_conv_bn_relu_bwd at {shape} ({count}/step), device "
            f"time: {r['ms']:.4f} ms ({100 * bms / r['ms']:.1f} % of bound "
            f"{bms:.4f} ms by {by}; plain {r['plain_ms']:.4f} ms, unfused "
            f"autograd {r['library_ms']:.4f} ms; kernel between CUDA events "
            f"{cuda_ms(torch, lambda: K.fused_conv_bn_relu_bwd(*args)):.4f} "
            f"ms)")
        for name, ms in sorted(split.items(), key=lambda kv: -kv[1]):
            rate = f", {gemm_flops / ms / 1e9:.0f} TFLOP/s" if \
                name.startswith(("cbr_dgrad", "cbr_wgrad")) else ""
            log(f"time   {name[:70]}: {ms:.4f} ms{rate}")
        for key in total:
            total[key] += r[key] * count / per_step
        for i, amount in enumerate(cbr_work(shape)):
            work[i] += amount * count / per_step
        del args, seg, x, dseg
    total["bound_ms"], total["bound_by"] = bound_ms(*work)
    log(f"time fused_conv_bn_relu_bwd, launch-weighted mean: "
        f"{total['ms']:.4f} ms ({100 * total['bound_ms'] / total['ms']:.1f} "
        f"% of bound), unfused autograd {total['library_ms']:.4f} ms, "
        f"{per_step} launches a step: {total['ms'] * per_step:.2f} ms")
    return total


def scale_buckets(torch) -> list:
    """Element counts of the fp32 buckets that the transformer step's
    exchange scales: ``plan_buckets`` over the 870.9M model's fp32
    gradients (its parameters' sizes, in parameter order) at the
    runtime's default fusion threshold.  Each is scaled twice a step, in
    place (phase 4's ``gradient_predivide_factor``)."""
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.ops.bucketing import plan_buckets
    from horovod_tpu_torch.runtime.config import Config

    sizes = [p.numel() for p in TransformerLM(
        full_config(torch, "flash"), device="meta").parameters()]
    plan = plan_buckets([4 * n for n in sizes],
                        Config().fusion_threshold_bytes)
    return [sum(sizes[i] for i in bucket) for bucket in plan]


def time_scale(torch) -> dict:
    """``fused_scale`` as profiler device time beside its plain version
    and its library call, ``x.float().mul(f).to(dt)`` (``x.mul_(f)`` in
    place, which is the same function for fp32): on one 64 MiB fp32 bucket
    out of place and in place, then over the transformer step's own
    buckets (:func:`scale_buckets`), in place as the exchange scales them,
    a sweep over all of them per call, so that the mean per launch is
    launch-weighted.  Returns the step's buckets' row, which the JSON line
    carries."""
    from horovod_tpu_torch.ops import kernels as K

    f = 0.5
    n = 64 * 1024 * 1024 // 4
    x = torch.randn(n, generator=torch.Generator(device="cuda").manual_seed(
        SEED + 1), device="cuda")
    bms, by = bound_ms(2 * 4 * n, n, PEAK_FP32_FLOPS)
    for label, kernel, library in (
            ("out of place", lambda: K.fused_scale(x, f),
             lambda: x.float().mul(f).to(x.dtype)),
            ("in place", lambda: K.fused_scale(x, f, out=x),
             lambda: x.mul_(f))):
        ms, lib = device_ms(torch, kernel), device_ms(torch, library)
        log(f"time fused_scale 64 MiB f32 {label}, device time: {ms:.4f} ms "
            f"({100 * bms / ms:.1f} % of bound {bms:.4f} ms by {by}), library "
            f"{lib:.4f} ms ({ms / lib:.3f}x), kernel between CUDA events "
            f"{cuda_ms(torch, kernel):.4f} ms")
    del x
    sizes = scale_buckets(torch)
    # a tensor of its own for each bucket, as the exchange packs them
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    views = [torch.randn(m, generator=gen, device="cuda") for m in sizes]
    assert [v.numel() for v in views] == sizes

    def sweep(fn):
        def run():
            for v in views:
                fn(v)
        return run

    r = dict(ms=device_ms(torch, sweep(lambda v: K.fused_scale(v, f, out=v)),
                          iters=5) / len(views),
             plain_ms=device_ms(torch, sweep(lambda v: K.fused_scale_plain(
                 v, f, v.dtype)), iters=5) / len(views),
             library_ms=device_ms(torch, sweep(lambda v: v.mul_(f)),
                                  iters=5) / len(views))
    mean = sum(sizes) / len(sizes)
    r["bound_ms"], r["bound_by"] = bound_ms(2 * 4 * mean, mean,
                                            PEAK_FP32_FLOPS)
    log(f"time fused_scale over the step's {len(sizes)} buckets ({min(sizes)}"
        f"-{max(sizes)} fp32 values, mean {mean:.0f}), in place, device time "
        f"per launch: {r['ms']:.4f} ms ({100 * r['bound_ms'] / r['ms']:.1f} % "
        f"of bound {r['bound_ms']:.4f} ms), library {r['library_ms']:.4f} ms "
        f"({r['ms'] / r['library_ms']:.3f}x), plain {r['plain_ms']:.4f} ms; "
        f"{2 * len(sizes)} launches a step: {2 * len(sizes) * r['ms']:.2f} ms")
    del views
    return r


def time_mm(torch) -> dict:
    """pallas_matmul at each main-path shape and layout: kernel, plain and
    ``torch.matmul`` (cuBLAS, the yardstick; the port never calls it for
    these products).  Every (shape, layout) runs 16 times a step, so the
    launch-weighted mean is the plain mean over the 12."""
    from horovod_tpu_torch.ops import kernels as K

    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0)
    work = [0.0, 0.0]
    cells = [(name, mkn, layout) for name, mkn in MM_MAIN.items()
             for layout in MM_LAYOUTS]
    for name, mkn, layout in cells:
        a, b = mm_operands(torch, mkn, layout, seed=SEED + 5)
        (m, k), n = a.shape, b.shape[1]
        r = dict(ms=cuda_ms(torch, lambda: K.pallas_matmul(a, b)),
                 plain_ms=cuda_ms(torch, lambda: K.pallas_matmul_plain(
                     a, b, torch.bfloat16), iters=5),
                 library_ms=cuda_ms(torch, lambda: torch.matmul(a, b)))
        nbytes, flops = 2 * (m * k + k * n + m * n), 2 * m * k * n
        bms, by = bound_ms(nbytes, flops)
        same = torch.equal(K.pallas_matmul(a, b), torch.matmul(a, b))
        log(f"time pallas_matmul {name} {layout} ({m}x{k})@({k}x{n}): "
            f"{r['ms']:.4f} ms ({efficiency(dict(r, bound_ms=bms), flops)}; "
            f"bound {bms:.4f} ms by {by}, plain {r['plain_ms']:.4f} ms, "
            f"torch.matmul {r['library_ms']:.4f} ms, its result bit for "
            f"bit the kernel's: {same})")
        for key in total:
            total[key] += r[key] / len(cells)
        work[0] += nbytes / len(cells)
        work[1] += flops / len(cells)
        del a, b
    total["bound_ms"], total["bound_by"] = bound_ms(*work)
    log(f"time pallas_matmul, launch-weighted mean: {total['ms']:.4f} ms "
        f"({efficiency(total, work[1])})")
    log(f"time pallas_matmul per step: {len(cells) * MM_LAYERS} launches, "
        f"kernel {total['ms'] * len(cells) * MM_LAYERS:.2f} ms, bound "
        f"{total['bound_ms'] * len(cells) * MM_LAYERS:.2f} ms, torch.matmul "
        f"{total['library_ms'] * len(cells) * MM_LAYERS:.2f} ms")
    return total


def time_flash(torch, q, k, v, do, scale, qpos=None, kpos=None,
               causal: bool = True) -> dict:
    """The three flash kernels (with ``qpos``/``kpos`` their positions
    variant), causal or not, at one input: kernel, plain and library ms
    beside the bound.  The library call is SDPA (causal, with the boolean
    mask the positions give, or with no mask) for the forward and, for dQ
    and dK/dV, SDPA's backward
    alone (``torch.autograd.grad`` on a retained graph, its device time:
    :func:`device_ms`), which computes the pair's dQ, dK and dV in one
    call; dQ is timed as the autograd glue runs it, computing delta from
    O.  The bound counts the products of the
    visible (q, k) pairs only: that is the work the function needs,
    whatever tiles a kernel chooses not to skip.  Prints each row's
    kernel/library ratio, TFLOP/s and share of bound, and the pair's."""
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import kernels as K

    b, t, h, d = q.shape
    suffix, pos = ("", ()) if qpos is None else ("_pos", (qpos, kpos))
    mask = qpos[:, None] >= kpos[None, :] if pos else torch.ones(
        t, t, dtype=torch.bool, device=q.device)
    if causal and not pos:
        mask = mask.tril()
    visible = float(mask.sum()) / (t * t)
    prod = 2 * b * h * t * t * d * visible      # one visible t x t x d product
    tile, rows, nbytes_pos = b * t * h * d * 2, b * h * t * 4, 4 * len(pos) * t
    o, lse = K.flash_fwd(q, k, v, causal, scale, *pos)
    qt, kt, vt, dot = (a.transpose(1, 2) for a in (q, k, v, do))
    how = dict(attn_mask=mask) if pos else dict(is_causal=causal)
    qg, kg, vg = (a.detach().requires_grad_() for a in (qt, kt, vt))
    y = F.scaled_dot_product_attention(qg, kg, vg, **how)

    def sdpa_bwd():
        torch.autograd.grad(y, (qg, kg, vg), dot, retain_graph=True)

    if causal:
        sdpa_bwd_ms = device_ms(torch, sdpa_bwd)
    else:
        # at ViT's shape the profiler drops a few records of some traces
        # of 20 calls; 10-call traces and more tries, then CUDA events
        # around a loop of calls: at this shape each call's kernels
        # outlast autograd's host glue, so the queue never drains and the
        # events read device time
        try:
            sdpa_bwd_ms = device_ms(torch, sdpa_bwd, iters=10, tries=6)
        except RuntimeError as e:
            sdpa_bwd_ms = cuda_ms(torch, sdpa_bwd)
            log(f"  SDPA's backward by CUDA events, {sdpa_bwd_ms:.4f} ms "
                f"(the profiler gave no reading: {e})")
    _, delta = K.flash_bwd_dq(q, k, v, do, lse, None, causal, scale, *pos,
                              out=o)
    args = (q, k, v, do, lse, delta, causal, scale, *pos)
    r = {"flash_fwd" + suffix: dict(
             ms=cuda_ms(torch, lambda: K.flash_fwd(q, k, v, causal, scale,
                                                   *pos)),
             plain_ms=cuda_ms(torch, lambda: K.flash_fwd_plain(
                 q, k, v, causal, scale, *pos), iters=5),
             library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, **how)),
             work=(4 * tile + rows + nbytes_pos, 2 * prod)),
         "flash_bwd_dq" + suffix: dict(
             ms=cuda_ms(torch, lambda: K.flash_bwd_dq(
                 q, k, v, do, lse, None, causal, scale, *pos, out=o)),
             plain_ms=cuda_ms(torch, lambda: K.flash_bwd_dq_plain(
                 q, k, v, do, lse, K.flash_delta(o, do), causal, scale,
                 *pos), iters=5),
             library_ms=sdpa_bwd_ms,
             work=(6 * tile + 2 * rows + nbytes_pos, 3 * prod)),
         "flash_bwd_dkv" + suffix: dict(
             ms=cuda_ms(torch, lambda: K.flash_bwd_dkv(*args)),
             plain_ms=cuda_ms(torch, lambda: K.flash_bwd_dkv_plain(*args),
                              iters=5),
             library_ms=sdpa_bwd_ms,
             work=(6 * tile + 2 * rows + nbytes_pos, 4 * prod))}
    for name, row in r.items():
        nbytes, flops = row.pop("work")
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
        log(f"time {name}: {row['ms']:.4f} ms ({efficiency(row, flops)}; "
            f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} over the "
            f"{visible:.4f} of the grid the mask shows, plain "
            f"{row['plain_ms']:.4f} ms, library {fmt_ms(row['library_ms'])})")
    dq, dkv = r["flash_bwd_dq" + suffix], r["flash_bwd_dkv" + suffix]
    pair = dict(ms=dq["ms"] + dkv["ms"], library_ms=sdpa_bwd_ms,
                bound_ms=dq["bound_ms"] + dkv["bound_ms"])
    log(f"time flash backward pair{suffix} (dQ + dK/dV): {pair['ms']:.4f} ms "
        f"({efficiency(pair, 7 * prod)}; SDPA's backward alone "
        f"{fmt_ms(sdpa_bwd_ms)} of device time, "
        f"{cuda_ms(torch, sdpa_bwd):.4f} ms between CUDA events)")
    del y, qg, kg, vg
    return r


def time_flash_pos(torch) -> dict:
    """The positions kernels at the main shape for pairs (a) and (b)
    (:func:`time_flash`), with the kernels' and SDPA's forward + backward as
    a total; then one layer's attention forward + backward through the
    fused sp ring at sp = 1, the plain ring and ``flash_attention``.
    Returns pair (a)'s rows, the sp = 1 path's."""
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.parallel.ring_attention import (
        _PlainRing,
        ring_attention,
    )

    b, t, h, d = FULL["batch"], FULL["seq"], FULL["heads"], FULL["head_dim"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    q, k, v, do = (torch.randn((b, t, h, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    qt, kt, vt, dot = (a.transpose(1, 2) for a in (q, k, v, do))
    out = {}
    for pair in "ab":
        qpos, kpos = pos_pairs(torch, t)[pair]
        mask = qpos[:, None] >= kpos[None, :]
        log(f"time flash positions pair {pair}:")
        rows_ = time_flash(torch, q, k, v, do, scale, qpos, kpos)
        qg, kg, vg = (a.detach().requires_grad_() for a in (qt, kt, vt))

        def sdpa_fwd_bwd():
            y = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
            torch.autograd.grad(y, (qg, kg, vg), dot)

        def ours_fwd_bwd():
            oo, ll = K.flash_fwd(q, k, v, True, scale, qpos, kpos)
            _, dd = K.flash_bwd_dq(q, k, v, do, ll, None, True, scale, qpos,
                                   kpos, out=oo)
            K.flash_bwd_dkv(q, k, v, do, ll, dd, True, scale, qpos, kpos)

        log(f"time flash positions fwd+bwd pair {pair}, device time: kernels "
            f"{device_ms(torch, ours_fwd_bwd):.4f} ms, SDPA with the mask "
            f"{device_ms(torch, sdpa_fwd_bwd):.4f} ms")
        if pair == "a":
            out = rows_
        del qg, kg, vg

    # one layer's attention, forward + backward, three ways
    leaves = [a.detach().requires_grad_() for a in (q, k, v)]
    ways = {"fused sp ring at sp = 1": lambda a, b_, c: ring_attention(
                a, b_, c, causal=True),
            "plain ring at sp = 1": lambda a, b_, c: _PlainRing.apply(
                a, b_, c, None, True, scale, "contiguous"),
            "flash_attention": lambda a, b_, c: K.flash_attention(
                a, b_, c, causal=True)}
    for label, fn in ways.items():
        def fwd_bwd():
            torch.autograd.grad(fn(*leaves), leaves, do)

        log(f"time one layer's attention fwd+bwd through the {label}: "
            f"{cuda_ms(torch, fwd_bwd, iters=10):.4f} ms")
    return out


def phase_time(torch):
    """Kernel, plain and library times at the main path's shapes."""
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    out = {}

    out["fused_scale"] = time_scale(torch)
    b, t, h, d = FULL["batch"], FULL["seq"], FULL["heads"], FULL["head_dim"]
    q, k, v, do = (torch.randn((b, t, h, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    out.update(time_flash(torch, q, k, v, do, scale))
    qg, kg, vg = (a.detach().transpose(1, 2).requires_grad_()
                  for a in (q, k, v))

    def sdpa_fwd_bwd():
        y = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(y, (qg, kg, vg), do.transpose(1, 2))

    def ours_fwd_bwd():
        oo, ll = K.flash_fwd(q, k, v, True, scale)
        _, dd = K.flash_bwd_dq(q, k, v, do, ll, None, True, scale, out=oo)
        K.flash_bwd_dkv(q, k, v, do, ll, dd, True, scale)

    log(f"time flash fwd+bwd at b{b} h{h} t{t} d{d}, device time: kernels "
        f"{device_ms(torch, ours_fwd_bwd):.4f} ms, "
        f"scaled_dot_product_attention {device_ms(torch, sdpa_fwd_bwd):.4f} "
        f"ms")
    del q, k, v, do, qg, kg, vg
    out["fused_conv_bn_relu_bwd"] = time_cbr(torch)
    out["pallas_matmul"] = time_mm(torch)
    out.update(time_flash_pos(torch))
    for name, r in out.items():
        log(f"time {name}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms "
            f"by {r['bound_by']}, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']})")
    return out


# the MoE layers' routing kernels, by name: the router's softmax over 8
# experts (a warp softmax; the loss's over 32000 is another kernel), its
# argmax, the slot cumsum, the gather of the gate, the dispatch scatter and
# the combine gather, forward and backward (index_put with accumulate sorts
# its indices; the embedding's backward sorts with the same cub kernels)
MOE_ROUTING = (("softmax_warp", "routing"), ("argmax", "routing"),
               ("scan", "routing"), ("scatter_gather", "routing"),
               ("index_elementwise", "routing"),
               ("indexing_backward", "routing"), ("index_put", "routing"),
               ("radix", "routing"))


def _category(name: str, extra=()) -> str:
    lowered = name.lower()
    for key, cat in tuple(extra) + (("mm_kernel", "pallas_matmul kernel"),
                     ("flash_", "flash kernels"), ("scale_", "fused_scale"),
                     ("cbr_", "conv_bn_relu_bwd kernel"),
                     ("conv", "convolution"), ("fprop", "convolution"),
                     ("dgrad", "convolution"), ("wgrad", "convolution"),
                     ("nccl", "nccl"), ("gemm", "matmul"), ("xmma", "matmul"),
                     ("nvjet", "matmul"), ("cutlass", "matmul"),
                     ("adam", "optimizer"), ("multi_tensor", "optimizer"),
                     ("cat", "pack/unpack"), ("copy", "copy/cast"),
                     ("memcpy", "copy/cast"),
                     ("reduce", "reductions")):
        if key in lowered:
            return cat
    return "other elementwise"


def stream_overlap(prof) -> dict:
    """Device ms of the kernels and copies off the main stream (the main
    stream runs the most device time: forward, backward and the update;
    the others are the exchange's side stream and NCCL's), how much of
    that ran while a main-stream kernel or copy ran, and how much ran
    after backward's last kernel, before the update's first (exposed),
    from the trace's records."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    streams: dict = {}
    for ev in events:
        if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and \
                "dur" in ev:
            streams.setdefault(ev.get("args", {}).get("stream"), []).append(
                (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                 ev.get("name", "")))
    if not streams:
        return {}
    main = max(streams, key=lambda k: sum(e - b for b, e, _ in streams[k]))
    merged: list = []
    for b, e, _ in sorted(streams[main]):
        if merged and b <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([b, e])
    starts = [b for b, _ in merged]
    # the update starts with the optimizer's first kernel, after the
    # exchange; backward ends with the main stream's last kernel before it
    update = min((b for b, _, n in streams[main]
                  if _category(n) == "optimizer"), default=math.inf)
    bwd_end = max((e for _, e, _ in streams[main] if e <= update),
                  default=-math.inf)
    side = [k for sid, ks in streams.items() if sid != main for k in ks]
    # host-to-device copies: CUPTI names their source memory ("Memcpy HtoD
    # (Pinned -> Device)" or "(Pageable -> Device)")
    h2d = [{"pinned": "Pinned" in ev.get("name", ""),
            "side": ev.get("args", {}).get("stream") != main,
            "mb": float(ev.get("args", {}).get("bytes", 0)) / 1e6,
            "ms": float(ev["dur"]) / 1e3}
           for ev in events if ev.get("cat") == "gpu_memcpy" and
           "HtoD" in ev.get("name", "") and "dur" in ev]
    total = under = exposed = 0.0
    names: dict = {}
    for b, e, name in side:
        total += e - b
        names[_category(name)] = names.get(_category(name), 0.0) + e - b
        exposed += max(0.0, min(e, update) - max(b, bwd_end))
        i = max(bisect.bisect_right(starts, b) - 1, 0)
        while i < len(merged) and merged[i][0] < e:
            under += max(0.0, min(e, merged[i][1]) - max(b, merged[i][0]))
            i += 1
    return {"exchange_ms": total / 1e3, "under_backward_ms": under / 1e3,
            "exposed_ms": exposed / 1e3, "streams": len(streams),
            "exchange_split_ms": {k: v / 1e3 for k, v in names.items()},
            "h2d": h2d}


def no_hook_grads(torch, model, loss) -> dict:
    """{name: gradient} of ``loss`` by ``torch.autograd.grad``, which fires
    no post-accumulate-grad hook: a parity check's backward stays out of
    the DistributedOptimizer's exchange."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return {n: g for (n, _), g in zip(named, grads)}


def profile_step(torch, run, focus: str = "", ranges=None,
                 streams: bool = False, categories=()) -> dict:
    """One more training step under torch.profiler: device time by kernel
    and by category, and the device's busy share of the step's wall time;
    every kernel whose name holds ``focus`` is listed too.  With
    ``ranges`` ({record_function name: part}), also the device time of
    the kernels launched under each range, and the rest of the busy time;
    returns {part: ms} with "busy" and "wall".  With ``streams``, also
    :func:`stream_overlap`'s readings.  ``categories`` are (name fragment,
    category) pairs read before the default ones; the split by category is
    returned under "categories"."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    log(f"profile: step wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / wall_ms:.1f} %), idle {100 - 100 * busy / wall_ms:.1f} "
        f"%, {sum(r[1] for r in rows)} device operations")
    cats: dict = {}
    for ms, _, key in rows:
        cat = _category(key, categories)
        cats[cat] = cats.get(cat, 0.0) + ms
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        log(f"profile: {cat:18s} {ms:8.2f} ms ({100 * ms / busy:.1f} %)")
    ranked = sorted(rows, reverse=True)
    for ms, count, key in ranked[:12] + [r for r in ranked[12:]
                                         if focus and focus in r[2]]:
        log(f"profile:   {ms:8.2f} ms x{count:<4d} {key[:90]}")
    split = {"wall": wall_ms, "busy": busy, "categories": cats}
    if streams:
        split.update(stream_overlap(prof))
        log(f"profile streams: {split.get('streams')} streams with kernels;"
            f" off the main stream {split.get('exchange_ms', 0.0):.2f} ms "
            f"of kernels, {split.get('under_backward_ms', 0.0):.2f} ms of "
            f"it under main-stream (backward) kernels, "
            f"{split.get('exposed_ms', 0.0):.2f} ms after backward's last "
            f"kernel, before the update; by category "
            f"{json.dumps(split.get('exchange_split_ms', {}))}")
    if ranges:
        # the kernels launched under each range's host side; its device
        # side spans them, idle gaps included, and is logged apart
        parts, top, span = split_ranges(prof.events(), ranges, busy)
        split.update(parts)
        log("profile split: " + ", ".join(
            f"{part} {split[part]:.2f} ms" for part in
            list(ranges.values()) + ["rest"]) + f" of {busy:.2f} ms busy")
        log("profile split: device-side spans " + ", ".join(
            f"{part} {ms:.2f} ms" for part, ms in span.items()))
        for part, names in top.items():
            for name, ms in sorted(names.items(), key=lambda kv: -kv[1])[:3]:
                log(f"profile split:   {part}: {ms:8.2f} ms {name[:80]}")
    return split


def recipe(torch, hvd, steps: int = 5, on_step=None,
           adasum: bool = False, plan=None, remat_policy=None,
           guard=None, loss_scale=None, capturable: bool = False,
           steps_per_call: int = 1) -> dict:
    """Phase 4's five-line recipe at full width on this process's card:
    the seeded 870.9M TransformerLM, ``DistributedOptimizer(AdamW(3e-4,
    weight_decay=1e-4), gradient_predivide_factor=2.0)`` on the hook path,
    ``init`` and ``steps`` steps on the seeded batch; ``on_step(i, model)``
    after each.  With ``adasum`` the optimizer is
    ``DistributedAdasumOptimizer(AdamW(3e-4, weight_decay=1e-4))`` and the
    step ``DistributedTrainStep(op=None)`` (phase 13 (a)).  With ``plan``
    the model is built with the tp group of ``plan.build_mesh()`` and the
    step is ``DistributedTrainStep(mode="pjit", plan=plan, mesh=...)``
    (phase 15 (a)).  ``remat_policy`` is the model's remat tier (phase
    18).  ``guard`` is the step's ``guard=``, and ``loss_scale`` a list
    whose one value the loss is multiplied by at each call (phase 19
    (a): 1.0 leaves every bit of the loss and gradients as they are).
    ``capturable`` builds AdamW with ``capturable=True`` and
    ``steps_per_call`` is the step's (phase 20 (a): ``steps`` calls of that
    many steps each).  Returns the
    model, the wrapper, the step, the batch, the losses, each call's
    seconds (to the loss on the host) and host seconds (to the call's
    return), its bucket sources, the wall clock at the first call's end,
    the launch counts from ``init`` on and the peak memory."""
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.ops import kernels as K

    dev = hvd.device()
    cfg = full_config(torch, "flash")
    cfg.remat_policy = remat_policy
    gen = torch.Generator(device=dev).manual_seed(SEED)
    planned = {}
    if plan is not None:
        from horovod_tpu_torch.parallel.plan import ShardingPlan

        mesh = ShardingPlan.from_string(plan).resolve(hvd.size()) \
            .build_mesh()
        planned = dict(plan=plan, mesh=mesh, mode="pjit")
    model = TransformerLM(cfg, device=dev, generator=gen,
                          tp_group=planned["mesh"].group("tp")
                          if planned else None)
    adamw = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4,
                              capturable=capturable)
    if adasum:
        opt = hvd.DistributedAdasumOptimizer(adamw)
    else:
        opt = hvd.DistributedOptimizer(adamw, gradient_predivide_factor=2.0)

    def loss_fn(m, batch):
        if loss_scale is not None:
            return lm_loss(m, batch) * loss_scale[0]
        return lm_loss(m, batch)

    step = hvd.DistributedTrainStep(loss_fn, opt,
                                    op=None if adasum else hvd.Average,
                                    guard=guard,
                                    steps_per_call=steps_per_call, **planned)
    tokens = torch.randint(0, cfg.vocab_size,
                           (FULL["batch"], FULL["seq"] + 1),
                           generator=torch.Generator().manual_seed(SEED))

    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    model, opt = step.init(model)
    batch = step.shard_batch(tokens)
    losses, times, host, sources, first_end = [], [], [], [], None
    for i in range(steps):
        t0 = time.perf_counter()
        model, opt, loss = step(model, opt, batch)
        host.append(time.perf_counter() - t0)
        losses.append(float(loss))           # synchronises
        times.append(time.perf_counter() - t0)
        first_end = first_end or time.time()
        sources.append([src for _, src in getattr(opt, "launches", [])])
        if on_step is not None:
            on_step(i, model)
    return dict(cfg=cfg, model=model, opt=opt, step=step, batch=batch,
                loss_fn=loss_fn, losses=losses, times=times, host=host,
                sources=sources, first_end=first_end,
                counts=K.launch_counts(),
                peak=torch.cuda.max_memory_allocated())


def phase_train(torch):
    """The five-line recipe at full width; returns the launch counts, the
    summary, the first step's loss and gradients (phase 7's reference),
    phase 9's summary and the parameters after the first step on the host
    (phase 13's reference)."""
    import horovod_tpu_torch as hvd

    t_init = time.time()
    hvd.init()
    dev = hvd.device()
    log(f"init: rank {hvd.rank()} of {hvd.size()} on {dev}")
    firsts = []

    def keep_first(i, model):
        if i == 0:      # the sp phase's reference: this step's gradients;
            # phase 13's: the parameters after it
            firsts.append(flat_grads(torch, model))
            firsts.append(flat_params(torch, model))

    r = recipe(torch, hvd, on_step=keep_first)
    cfg, model, opt, step, batch, loss_fn = (
        r[k] for k in ("cfg", "model", "opt", "step", "batch", "loss_fn"))
    losses, times, sources = r["losses"], r["times"], r["sources"]
    counts, peak = r["counts"], r["peak"]
    step1_params = firsts.pop()
    first = (losses[0], firsts.pop())
    init_to_first_s = r["first_end"] - t_init
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: {n_params / 1e6:.1f}M params, {cfg.num_layers}L/"
        f"{cfg.d_model}d/{cfg.num_heads}h, seq {FULL['seq']}, "
        f"batch {FULL['batch']}, attention {cfg.attention_impl}")
    log(f"train: losses {losses}")
    log(f"train: launches on the main path {counts}")
    n_buckets = len(opt._buckets)
    hooks = [src.count("hook") for src in sources]
    at_sync = [src.count("synchronize") for src in sources]
    log(f"train: {n_buckets} buckets a step; launched from hooks before "
        f"backward returned {hooks}, at synchronize() {at_sync}")
    if hooks != [n_buckets] * len(losses) or any(at_sync):
        raise AssertionError("a bucket did not launch from its hook")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite loss")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    missing = [k for k in TRANSFORMER_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    check_flash_launches(counts, len(losses), "train")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    tokens_per_step = FULL["batch"] * FULL["seq"]
    log(f"train: step {steady * 1e3:.1f} ms (median of steps 2-5; first "
        f"{times[0] * 1e3:.1f} ms), {tokens_per_step / steady:.0f} tokens/s, "
        f"peak memory {peak / 2**30:.2f} GiB")

    profiled = profile_step(
        torch, lambda: float(step(model, opt, batch)[2]), streams=True)

    # the same weights under dense attention: loss and gradients in bf16.
    # Tolerance: the two differ only inside attention (online vs one-pass
    # softmax, bf16 rounding of P and dS), 1e-2 relative on the loss and
    # 5e-2 relative L2 over all gradients.
    grads = {}
    for impl in ("flash", "dense"):
        cfg.attention_impl = impl
        loss = loss_fn(model, batch)
        grads[impl] = (float(loss.detach()), torch.cat(
            [g.float().reshape(-1)
             for g in no_hook_grads(torch, model, loss).values()]))
    cfg.attention_impl = "flash"
    (lf, gf), (ld, gd) = grads["flash"], grads["dense"]
    loss_rel = abs(lf - ld) / abs(ld)
    grad_rel = float((gf - gd).norm() / gd.norm())
    log(f"parity flash vs dense: loss {lf:.6f} vs {ld:.6f} (rel "
        f"{loss_rel:.3e}, tol 1e-2), grads rel L2 {grad_rel:.3e} (tol 5e-2)")
    if not (loss_rel <= 1e-2 and grad_rel <= 5e-2):
        raise AssertionError("flash and dense training paths disagree")
    del grads, gf, gd
    model.zero_grad(set_to_none=True)

    # rank-0 checkpoint round trip
    ckpt_dir = tempfile.mkdtemp(prefix="hvd_torch_ckpt_")
    try:
        ckpt = hvd.checkpoint.Checkpointer(ckpt_dir)
        state = {"model": model.state_dict(), "opt": opt.state_dict(),
                 "step": 5}
        t0 = time.perf_counter()
        ckpt.save(5, state)
        restored = ckpt.restore(map_location=dev)
        log(f"checkpoint: save+restore {time.perf_counter() - t0:.1f} s, "
            f"latest step {ckpt.latest_step()}")
        for name, ten in state["model"].items():
            if not torch.equal(restored["model"][name], ten):
                raise AssertionError(f"checkpoint changed {name}")
        for pid, st in state["opt"]["state"].items():
            for key, val in st.items():
                if not torch.equal(restored["opt"]["state"][pid][key].to(
                        val.device), val):
                    raise AssertionError(f"checkpoint changed opt {pid}/{key}")
        if restored["step"] != 5:
            raise AssertionError("checkpoint changed the step")
        del restored
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    eager = phase_eager(torch, hvd, model, opt, loss_fn, batch)
    t0 = time.perf_counter()
    tools = phase_tools(torch, hvd, model, loss_fn, batch,
                        opt.prescale_factor, opt.postscale_factor)
    tools["seconds"] = round(time.perf_counter() - t0, 1)
    hvd.shutdown()
    eager["tools"] = tools
    return counts, dict(step_ms=steady * 1e3,
                        tokens_per_s=tokens_per_step / steady,
                        init_to_first_step_s=init_to_first_s,
                        peak_gib=peak / 2**30, losses=losses,
                        buckets=n_buckets, hook_launches=hooks,
                        idle_share=1 - profiled["busy"] / profiled["wall"],
                        exchange_ms=profiled.get("exchange_ms"),
                        exchange_under_backward_ms=profiled.get(
                            "under_backward_ms"),
                        exchange_exposed_ms=profiled.get("exposed_ms")), \
        first, eager, step1_params


def phase_eager(torch, hvd, model, opt, loss_fn, batch) -> dict:
    """Phase 9 on phase 4's model, weights and batch: (a) the hook path
    against ``distributed_gradients``, (b) the eager plane over every
    gradient, (c) the rest of the eager surface.  Returns its readings."""
    from horovod_tpu_torch.exceptions import HorovodInternalError
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.ops import op_manager
    from horovod_tpu_torch.ops.bucketing import global_bucketer
    from horovod_tpu_torch.optim import distributed_gradients

    pre, post = opt.prescale_factor, opt.postscale_factor
    out = {}
    # (a) one step's gradients from a backward that fires no hook, through
    # the step-time exchange, against the hooks' exchange of the same loss
    params = [p for p in model.parameters() if p.requires_grad]
    ref = list(no_hook_grads(torch, model, loss_fn(model, batch)).values())
    distributed_gradients(ref, prescale_factor=pre, postscale_factor=post)
    opt.zero_grad(set_to_none=True)
    loss_fn(model, batch).backward()
    hooked = [src for _, src in opt.launches]
    opt.synchronize()
    exact = all(torch.equal(p.grad, r) for p, r in zip(params, ref))
    del ref
    log(f"eager (a): hook path vs distributed_gradients on one step: "
        f"{hooked.count('hook')} of {len(opt._buckets)} buckets from hooks "
        f"before backward returned, bit-exact: {exact}")
    if not exact or hooked != ["hook"] * len(opt._buckets):
        raise AssertionError("the hook path and the step-time exchange "
                             "disagree")
    out["hook_exact"] = exact

    # (b) every gradient through the eager plane, against the step-time
    # exchange with the same factors: the same fused_scale passes around a
    # one-rank all-reduce, so bit for bit
    grads = [p.grad for p in params]

    def eager_run():
        hs = [hvd.allreduce_async(g, name=f"grad.{i}", prescale_factor=pre,
                                  postscale_factor=post)
              for i, g in enumerate(grads)]
        return [hvd.synchronize(h) for h in hs]

    K.reset_launch_counts()
    groups0 = global_bucketer().groups
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eager_run()
    torch.cuda.synchronize()
    wall_eager = (time.perf_counter() - t0) * 1e3
    groups = global_bucketer().groups - groups0
    launches = K.fused_scale.launches
    refs = [g.clone() for g in grads]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    distributed_gradients(refs, prescale_factor=pre, postscale_factor=post)
    torch.cuda.synchronize()
    wall_ref = (time.perf_counter() - t0) * 1e3
    exact = all(torch.equal(o, r) for o, r in zip(outs, refs))
    del outs

    def one_call(fn) -> float:
        # the device time of one call, profiled alone: the median of three
        # such readings is kept, and each call's largest kernels logged
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        log("  one call: " + ", ".join(
            f"{kernel_name(key)[:32]} x{count} {ms:.2f} ms"
            for ms, count, key in sorted(rows, reverse=True)[:6]))
        return sum(ms for ms, _, _ in rows)

    eager_run()
    dev_eager = sorted(one_call(eager_run) for _ in range(3))[1]
    ref_run = lambda: distributed_gradients(  # noqa: E731
        refs, prescale_factor=pre, postscale_factor=post)
    ref_run()
    dev_ref = sorted(one_call(ref_run) for _ in range(3))[1]
    del refs
    n_values = sum(g.numel() for g in grads)
    log(f"eager (b): {len(grads)} gradients, {n_values / 1e6:.1f}M fp32 "
        f"values through allreduce_async(prescale {pre}, postscale {post}):"
        f" {groups} Bucketer groups, {launches} fused_scale launches (want "
        f"{2 * groups}); wall {wall_eager:.2f} ms vs distributed_gradients "
        f"{wall_ref:.2f} ms; device {dev_eager:.2f} ms vs {dev_ref:.2f} "
        f"ms; "
        f"bit-exact: {exact}")
    if not exact:
        raise AssertionError("the eager plane and distributed_gradients "
                             "disagree")
    if launches != 2 * groups or groups == 0:
        raise AssertionError(f"{launches} fused_scale launches for "
                             f"{groups} groups")
    out.update(groups=groups, fused_scale=launches, wall_ms=wall_eager,
               ref_wall_ms=wall_ref, device_ms=dev_eager,
               ref_device_ms=dev_ref, eager_exact=exact)
    opt.zero_grad(set_to_none=True)
    del grads

    # (c) the rest of the surface, each against its expected value
    dev = hvd.device()
    x = torch.arange(12.0, device=dev).reshape(6, 2)
    checks = {}
    hb = hvd.broadcast_async(x, 0, name="p9.bc")
    ht = hvd.alltoall_async(x, splits=[6], name="p9.a2a")
    checks["broadcast_async"] = torch.equal(hvd.synchronize(hb), x)
    checks["alltoall_async"] = torch.equal(hvd.synchronize(ht), x)
    checks["allgather"] = torch.equal(hvd.allgather(x[:5], name="p9.ag"),
                                      x[:5])
    checks["allgather_object"] = \
        hvd.allgather_object({"rank": 0}) == [{"rank": 0}]
    checks["join"] = hvd.join() == 0
    big = torch.randn(16 << 20, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    h = hvd.allreduce_async(big, name="p9.poll")   # 64 MiB: dispatched
    t0 = time.perf_counter()
    in_flight = hvd.poll(h)
    poll_us = (time.perf_counter() - t0) * 1e6
    checks["poll"] = torch.equal(hvd.synchronize(h), big) and hvd.poll(h)
    h1 = hvd.allreduce_async(x, name="p9.dup")
    try:
        hvd.allreduce_async(x, name="p9.dup")
        checks["duplicate_name"] = False
    except HorovodInternalError as err:
        checks["duplicate_name"] = "same name" in str(err)
    hvd.synchronize(h1)
    before = K.fused_scale.launches
    cpu = torch.arange(4.0)
    checks["cpu_host_plane"] = (
        op_manager.current_operations(cpu) == "HOST" and
        torch.equal(hvd.allreduce(cpu, name="p9.cpu", prescale_factor=2.0),
                    2 * cpu) and K.fused_scale.launches == before)
    log(f"eager (c): {checks}; poll on an in-flight 64 MiB handle returned "
        f"{in_flight} in {poll_us:.1f} us")
    if not all(checks.values()):
        raise AssertionError(f"eager surface checks failed: {checks}")
    out.update(checks=checks, poll_in_flight=in_flight, poll_us=poll_us)
    return out


def _prom_values(text: str) -> dict:
    """The samples of a Prometheus text exposition, ``{series: value}``;
    raises on a line that does not parse."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        series, value = line.rsplit(" ", 1)
        out[series] = float(value)
    return out


def phase_tools(torch, hvd, model, loss_fn, batch, pre, post) -> dict:
    """Phase 17, the runtime tools on phase 4's model, weights and batch:
    (a) phase 9 (b)'s eager pass over every gradient under
    ``start_timeline`` with the native writer (which must be the one that
    ran), then the Python writer, each against the pass with the timeline
    off bit for bit, the wall ms of three passes each way, and the native
    trace's NEGOTIATE and NCCL_ALLREDUCE span for every gradient, with no
    event dropped; (b) one pass under ``torch.profiler``, whose events
    hold the timeline's ``record_function`` ranges; (c) a world made anew
    with ``HOROVOD_AUTOTUNE=1`` (and the metrics exporters on), passes
    until the parameter manager is done, every result bit for bit; (d)
    ``ThroughputAutotuner`` over the sharded exchange's
    ``exchange_bucket_bytes`` at three values, three timed steps each;
    (e) a rank-0 checkpoint of the model with metrics on: the saves
    counter rises by one, the stall histogram's sum is the save's
    ``last_stall_s``, the JSONL snapshot is written and the Prometheus
    endpoint is scraped once.  Returns the readings."""
    import socket
    import urllib.request

    from horovod_tpu_torch import native, telemetry
    from horovod_tpu_torch.utils import timeline as tl
    from horovod_tpu_torch.utils.bench_autotune import ThroughputAutotuner

    out = {}
    grads = list(no_hook_grads(torch, model, loss_fn(model, batch)).values())
    names = [f"grad.{i}" for i in range(len(grads))]

    def eager_pass():
        hs = [hvd.allreduce_async(g, name=n, prescale_factor=pre,
                                  postscale_factor=post)
              for n, g in zip(names, grads)]
        return [hvd.synchronize(h) for h in hs]

    def timed_passes():
        results, ms = None, []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = eager_pass()
            torch.cuda.synchronize()
            ms.append(round((time.perf_counter() - t0) * 1e3, 3))
        return results, ms

    # (a) the timeline: off, the native writer, the Python writer
    tmp = tempfile.mkdtemp(prefix="hvd_torch_tools_")
    try:
        eager_pass()                                  # warm-up
        want, out["off_ms"] = timed_passes()
        st = hvd._state.global_state()
        os.environ.pop("HOROVOD_TIMELINE_PYTHON", None)
        hvd.start_timeline(os.path.join(tmp, "native.json"))
        writer = type(st.timeline).__name__
        if writer != "NativeTimeline":
            raise AssertionError(f"the timeline's writer is {writer}, not "
                                 f"the native one: {native.native_error()}")
        got, out["native_ms"] = timed_passes()
        dropped = st.timeline.dropped_events
        hvd.stop_timeline()
        exact_native = all(torch.equal(a, b) for a, b in zip(got, want))
        os.environ["HOROVOD_TIMELINE_PYTHON"] = "1"
        try:
            hvd.start_timeline(os.path.join(tmp, "python.json"))
        finally:
            os.environ.pop("HOROVOD_TIMELINE_PYTHON")
        got, out["python_ms"] = timed_passes()
        hvd.stop_timeline()
        exact_python = all(torch.equal(a, b) for a, b in zip(got, want))
        del got
        events = tl.load_trace(os.path.join(tmp, "native.json"))
        spans = {}
        for e in events:
            if e["ph"] == "B":
                spans.setdefault(e["tid"], set()).add(e["name"])
        activity = tl.collective_activity(tl.ALLREDUCE, "nccl")
        complete = sum(spans.get(n, set()) >= {"NEGOTIATE", activity}
                       for n in names)
        drop_rows = [e for e in events
                     if str(e.get("name", "")).startswith("DROPPED_")]
        log(f"tools (a) [{CARD}]: the eager pass over {len(grads)} "
            f"gradients, wall ms x3: timeline off {out['off_ms']}, native "
            f"writer {out['native_ms']}, Python writer {out['python_ms']}; "
            f"native trace {len(events)} events, NEGOTIATE + {activity} "
            f"spans for {complete} of {len(names)} gradients, dropped "
            f"{dropped} (+{len(drop_rows)} DROPPED rows); bit-exact with "
            f"the timeline off: native {exact_native}, Python "
            f"{exact_python}; library built in "
            f"{native.build_seconds:.1f} s")
        if not (exact_native and exact_python):
            raise AssertionError("the timeline changed the eager results")
        if complete != len(names) or dropped or drop_rows:
            raise AssertionError("the native trace lacks spans or dropped "
                                 "events")
        out.update(trace_events=len(events), spans_complete=complete,
                   dropped=dropped, exact=exact_native and exact_python)

        # (b) the timeline's ranges in a profiler trace
        from torch.profiler import ProfilerActivity, profile

        hvd.start_timeline(os.path.join(tmp, "profiled.json"))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eager_pass()
            torch.cuda.synchronize()
        hvd.stop_timeline()
        ranges = [e for e in prof.events() if e.name.startswith("hvd:")]
        negotiate = sum(e.name.startswith("hvd:NEGOTIATE:") for e in ranges)
        collective = sum(e.name.startswith(f"hvd:{activity}:")
                         for e in ranges)
        log(f"tools (b): the profiled pass holds {len(ranges)} timeline "
            f"ranges, {negotiate} NEGOTIATE and {collective} {activity}")
        if negotiate < len(names) or collective < len(names):
            raise AssertionError("the timeline's ranges are not in the "
                                 "profiler's events")
        out.update(profiler_ranges=len(ranges))

        # (c) online autotune, and (e)'s exporters, in a world made anew
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        knobs = {"HOROVOD_AUTOTUNE": "1",
                 "HOROVOD_AUTOTUNE_LOG": os.path.join(tmp, "autotune.csv"),
                 "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "4",
                 "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "2",
                 "HOROVOD_METRICS_PORT": str(port),
                 "HOROVOD_METRICS_LOG": os.path.join(tmp, "metrics.jsonl")}
        saved = {k: os.environ.get(k) for k in knobs}
        hvd.shutdown()
        os.environ.update(knobs)
        try:
            hvd.init()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        st = hvd._state.global_state()
        pm = st.parameter_manager
        passes, exact = 0, True
        while pm.active and passes < 60:
            exact &= all(torch.equal(a, b)
                         for a, b in zip(eager_pass(), want))
            passes += 1
        with open(knobs["HOROVOD_AUTOTUNE_LOG"]) as f:
            rows = f.read().strip().splitlines()
        chosen = (st.config.fusion_threshold_bytes, st.config.cycle_time_ms)
        log(f"tools (c) [{CARD}]: autotune done after {passes} passes "
            f"(active {pm.active}), every result bit-exact: {exact}; log:")
        for row in rows:
            log(f"  {row}")
        log(f"tools (c): chosen fusion_threshold {chosen[0]} B, cycle "
            f"{chosen[1]} ms")
        if pm.active or not exact:
            raise AssertionError("online autotune did not finish exactly")
        out.update(autotune_passes=passes, autotune_rows=rows[1:],
                   autotune_chosen=chosen)
        del want
        grads.clear()

        # (d) offline autotune of the sharded exchange's bucket bytes
        from horovod_tpu_torch.models.transformer import TransformerLM

        def measure(point):
            m = TransformerLM(full_config(torch, "flash"), device=hvd.device(),
                              generator=torch.Generator(
                                  device=hvd.device()).manual_seed(SEED))
            o = hvd.DistributedOptimizer(
                torch.optim.AdamW(m.parameters(), lr=3e-4,
                                  weight_decay=1e-4),
                gradient_predivide_factor=2.0, shard_optimizer_states=True,
                exchange_bucket_bytes=point["exchange_bucket_bytes"])
            step = hvd.DistributedTrainStep(loss_fn, o)
            m, o = step.init(m)
            float(step(m, o, batch)[2])               # warm-up
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                float(step(m, o, batch)[2])
                times.append(time.perf_counter() - t0)
            del m, o, step
            torch.cuda.empty_cache()
            return FULL["batch"] * FULL["seq"] / statistics.median(times)

        values = [16 << 20, 64 << 20, 256 << 20]
        tuner = ThroughputAutotuner(
            measure, {"exchange_bucket_bytes": values},
            log_path=os.path.join(tmp, "offline.csv"))
        best, rate = tuner.run()
        with open(os.path.join(tmp, "offline.csv")) as f:
            offline = f.read().strip().splitlines()
        log(f"tools (d) [{CARD}]: sharded exchange tokens/s by "
            f"exchange_bucket_bytes (three timed steps each, median):")
        for row in offline:
            log(f"  {row}")
        log(f"tools (d): picked {best} at {rate:.0f} tokens/s (a reading, "
            f"not a claim)")
        out.update(offline_rows=offline[1:], offline_best=best,
                   offline_tokens_per_s=rate)

        # (e) metrics around a rank-0 checkpoint
        reg = telemetry.default_registry()
        saves0 = reg.value("hvd_checkpoint_saves_total")
        stall0 = reg.snapshot()["histograms"].get(
            "hvd_checkpoint_stall_seconds", {}).get("sum", 0.0)
        ckpt = hvd.checkpoint.Checkpointer(os.path.join(tmp, "ckpt"))
        ckpt.save(1, {"model": model.state_dict()})
        ckpt.wait()
        saves = reg.value("hvd_checkpoint_saves_total") - saves0
        stall = reg.snapshot()["histograms"][
            "hvd_checkpoint_stall_seconds"]["sum"] - stall0
        body = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                      timeout=10).read().decode()
        scraped = _prom_values(body)
        hvd.shutdown()
        telemetry.disable()       # the later phases run with metrics off
        with open(knobs["HOROVOD_METRICS_LOG"]) as f:
            snapshots = [json.loads(line) for line in f if line.strip()]
        log(f"tools (e) [{CARD}]: saves_total +{saves:g}, stall histogram "
            f"sum {stall!r} s vs last_stall_s {ckpt.last_stall_s!r} s, "
            f"write {ckpt.last_write_s:.3f} s; {len(snapshots)} JSONL "
            f"snapshot(s), last saves_total "
            f"{snapshots[-1]['counters'].get('hvd_checkpoint_saves_total')}"
            f"; endpoint :{port} served {len(scraped)} samples, saves_total "
            f"{scraped.get('hvd_checkpoint_saves_total')}")
        if saves != 1 or abs(stall - ckpt.last_stall_s) > 1e-9 or \
                not snapshots or \
                scraped.get("hvd_checkpoint_saves_total") != saves0 + 1:
            raise AssertionError("the checkpoint's metrics disagree")
        out.update(ckpt_stall_s=ckpt.last_stall_s,
                   ckpt_write_s=ckpt.last_write_s, snapshots=len(snapshots),
                   scraped=len(scraped))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def flat_params(torch, model):
    """Every parameter as one fp32 vector in parameter order, on the
    host."""
    return torch.cat([p.detach().float().reshape(-1).cpu()
                      for p in model.parameters()])


def flat_grads(torch, model):
    """Every parameter's gradient as one fp32 vector in parameter order, on
    the host, so that holding it moves no phase's peak device memory."""
    return torch.cat([p.grad.float().reshape(-1).cpu()
                      for p in model.parameters()])


def phase_sp_train(torch, first):
    """The 870.9M TransformerLM with ring attention on an sp group of one,
    trained by the five-line recipe under ``plan="sp=1"`` with phase 4's
    weights, batch and AdamW; ``first`` is phase 4's first-step (loss,
    gradients).  Returns the launch counts of its run and its summary."""
    import horovod_tpu_torch as hvd
    import torch.nn.functional as F

    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh

    hvd.init()
    dev = hvd.device()
    mesh = make_parallel_mesh(sp=1)
    cfg = full_config(torch, "ring")
    model = TransformerLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED), sp_group=mesh.group("sp"))
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4),
        gradient_predivide_factor=2.0)

    def sp_loss(m, batch):
        inputs = batch["inputs"]
        t = inputs.shape[1]
        positions = mesh.index("sp") * t + torch.arange(t, device=dev)
        logits = m(inputs, positions)
        return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                               batch["labels"].reshape(-1))

    step = hvd.DistributedTrainStep(sp_loss, opt, plan="sp=1", mesh=mesh)
    log(f"sp: ring attention on an sp group of {mesh.shape['sp']} (plan "
        f"{step.plan.to_string()}, layout {cfg.sp_layout or 'from env'})")
    tokens = torch.randint(0, cfg.vocab_size,
                           (FULL["batch"], FULL["seq"] + 1),
                           generator=torch.Generator().manual_seed(SEED))
    steps = 5
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    model, opt = step.init(model)
    batch = step.shard_batch({"inputs": tokens[:, :-1],
                              "labels": tokens[:, 1:]})
    losses, times, per_step = [], [], []
    for i in range(steps):
        before = K.launch_counts()
        t0 = time.perf_counter()
        model, opt, loss = step(model, opt, batch)
        losses.append(float(loss))           # synchronises
        times.append(time.perf_counter() - t0)
        after = K.launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        if i == 0:
            loss0, grads0 = losses[0], flat_grads(torch, model)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"sp: losses {losses}")
    log(f"sp: launches on the sp path {counts}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite sp loss")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"sp loss did not fall: {losses}")
    want = FULL["layers"]
    for i, c in enumerate(per_step):
        if any(c[k] != want for k in SP_KERNELS) or \
                any(c[k] for k in FLASH_KERNELS):
            raise AssertionError(f"sp step {i + 1} launched {c}; want "
                                 f"{want} of each positions kernel and no "
                                 f"flash kernel without positions")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    tokens_per_step = FULL["batch"] * FULL["seq"]
    log(f"sp: step {steady * 1e3:.1f} ms (median of steps 2-5; first "
        f"{times[0] * 1e3:.1f} ms), {tokens_per_step / steady:.0f} tokens/s, "
        f"peak memory {peak / 2**30:.2f} GiB")

    profile_step(torch, lambda: float(step(model, opt, batch)[2]), "flash_")

    # the first step against phase 4's (flash attention, same weights and
    # batch): masked tiles add exact zeros and one partial merges into the
    # sentinel exactly, so bit-exact is expected; the limit is 1e-5
    loss_ref, grads_ref = first
    loss_rel = abs(loss0 - loss_ref) / abs(loss_ref)
    grad_rel = float((grads0 - grads_ref).norm() / grads_ref.norm())
    bit_exact = loss0 == loss_ref and bool(torch.equal(grads0, grads_ref))
    log(f"parity sp ring (sp = 1) vs flash, first step: loss {loss0!r} vs "
        f"{loss_ref!r} (rel {loss_rel:.3e}, tol 1e-5), grads rel L2 "
        f"{grad_rel:.3e} (tol 1e-5), bit-exact: {bit_exact}")
    if not (loss_rel <= 1e-5 and grad_rel <= 1e-5):
        raise AssertionError("the sp ring at sp = 1 and flash disagree")
    del grads0
    hvd.shutdown()
    return counts, dict(step_ms=steady * 1e3,
                        tokens_per_s=tokens_per_step / steady,
                        peak_gib=peak / 2**30, losses=losses,
                        first_step_ms=times[0] * 1e3, loss_rel=loss_rel,
                        grad_rel=grad_rel, bit_exact=bit_exact)


def zero_cases(torch, hvd, tag: str, cases: dict) -> dict:
    """The 870.9M TransformerLM through the sharded exchange at a world of
    one, with phase 4's weights, batch and recipe, once for each of
    ``cases`` ({name: DistributedOptimizer options}): 5 steps, then a
    profiled one.  Checks the loss falls, the flash launches and
    ``fused_scale`` twice a group a step; returns each case's summary."""
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.ops import kernels as K

    dev = hvd.device()
    cfg = full_config(torch, "flash")
    tokens = torch.randint(0, cfg.vocab_size,
                           (FULL["batch"], FULL["seq"] + 1),
                           generator=torch.Generator().manual_seed(SEED))
    steps, out = 5, {}
    for name, kw in cases.items():
        label = f"{tag} ({name})"
        model = TransformerLM(cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(SEED))
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=3e-4,
                              weight_decay=1e-4),
            gradient_predivide_factor=2.0, shard_optimizer_states=True, **kw)
        step = hvd.DistributedTrainStep(lambda m, b: lm_loss(m, b), opt)
        groups = len(opt.spec.groups)
        log(f"{label}: {groups} group(s), "
            f"{sum(g.padded for g in opt.spec.groups) / 1e6:.1f}M values, "
            f"options {sorted(kw)}, exchange {step.exchange_hierarchy}")
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        model, opt = step.init(model)
        batch = step.shard_batch(tokens)
        losses, times = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            model, opt, loss = step(model, opt, batch)
            losses.append(float(loss))           # synchronises
            times.append(time.perf_counter() - t0)
        counts = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        log(f"{label}: losses {losses}")
        log(f"{label}: launches {counts}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{label}: non-finite loss")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{label}: loss did not fall: {losses}")
        check_flash_launches(counts, steps, label)
        # a prescale of each group's buffer and a postscale of its shard
        if counts["fused_scale"] != 2 * groups * steps:
            raise AssertionError(
                f"{label}: {counts['fused_scale']} fused_scale launches, "
                f"want {2 * groups * steps}")
        steady = sorted(times[1:])[len(times[1:]) // 2]
        tokens_per_step = FULL["batch"] * FULL["seq"]
        log(f"{label}: step {steady * 1e3:.1f} ms (median of steps 2-5; "
            f"first {times[0] * 1e3:.1f} ms), "
            f"{tokens_per_step / steady:.0f} tokens/s, peak memory "
            f"{peak / 2**30:.2f} GiB, fused_scale "
            f"{counts['fused_scale'] // steps} a step [{CARD}]")
        split = profile_step(torch, lambda: float(step(model, opt, batch)[2]),
                             "scale_", ZERO_RANGES)
        out[name] = dict(step_ms=steady * 1e3,
                         tokens_per_s=tokens_per_step / steady,
                         peak_gib=peak / 2**30, losses=losses,
                         first_step_ms=times[0] * 1e3, groups=groups,
                         fused_scale_per_step=counts["fused_scale"] // steps,
                         exchange=step.exchange_hierarchy, split_ms=split)
        del model, opt, step, batch
        torch.cuda.empty_cache()
    return out


def phase_zero_train(torch, ref_losses):
    """Phase 8: the 870.9M TransformerLM through the sharded exchange at a
    world of one, (a) the fp32 wire and (b) int8 + error feedback in 64
    MiB buckets; ``ref_losses`` are phase 4's.  Returns each case's
    summary."""
    import horovod_tpu_torch as hvd

    hvd.init()
    out = zero_cases(torch, hvd, "zero", {
        "a": {}, "b": dict(compression=hvd.Compression.int8,
                           error_feedback=True,
                           exchange_bucket_bytes=64 << 20)})
    a, b = out["a"]["losses"], out["b"]["losses"]
    # (a): the same elementwise AdamW on one flat shard, on the same
    # gradients (the scale passes and a reduce-scatter of one rank are
    # exact), so phase 4's losses bit for bit
    log(f"parity zero (a) vs phase 4: {a} vs {ref_losses}, bit-exact: "
        f"{a == ref_losses}")
    if a != ref_losses:
        raise AssertionError("the sharded fp32 exchange and phase 4 disagree")
    drop = a[0] - a[-1]
    dev_b = abs(b[-1] - a[-1])
    log(f"parity zero (b) vs (a): last loss {b[-1]!r} vs {a[-1]!r}, "
        f"{dev_b:.3e} = {dev_b / drop:.3e} of (a)'s drop {drop:.4f} (tol "
        f"{ZERO_INT8_TOL})")
    if not dev_b <= ZERO_INT8_TOL * drop:
        raise AssertionError("the int8 wire strays from the fp32 one")
    out["b"]["drop_share"] = dev_b / drop
    hvd.shutdown()
    return out


def phase_hier_train(torch, zero: dict) -> dict:
    """Phase 14: phase 8's two cases through the two-level exchange
    (``hierarchy="two_level"``), (b) with ``reduction="adasum"``; ``zero``
    is phase 8's summary.  At a world of one each level is one rank: (a)
    must equal phase 8 (a)'s losses bit for bit, (b) quantizes the local
    hop (its residual fed back) and again the cross hop, as JAX's
    two-level exchange does at any extent, and must end within
    ``ZERO_INT8_TOL`` of (a)'s drop; its distance from phase 8 (b) is
    logged.  Step times beside phase 8's, in this call."""
    import horovod_tpu_torch as hvd

    hvd.init()
    out = zero_cases(torch, hvd, "hier", {
        "a": dict(hierarchy="two_level"),
        "b": dict(hierarchy="two_level", compression=hvd.Compression.int8,
                  error_feedback=True, exchange_bucket_bytes=64 << 20,
                  reduction="adasum")})
    hvd.shutdown()
    for name in ("a", "b"):
        if out[name]["exchange"] != "two_level":
            raise AssertionError(f"hier ({name}): the step runs "
                                 f"{out[name]['exchange']}")
        log(f"hier ({name}) vs zero ({name}) [{CARD}]: step "
            f"{out[name]['step_ms']:.1f} ms against "
            f"{zero[name]['step_ms']:.1f} ms "
            f"({out[name]['step_ms'] / zero[name]['step_ms'] - 1:+.1%}), "
            f"peak {out[name]['peak_gib']:.2f} against "
            f"{zero[name]['peak_gib']:.2f} GiB")
    a, b = out["a"]["losses"], out["b"]["losses"]
    log(f"parity hier (a) vs zero (a): {a} vs {zero['a']['losses']}, "
        f"bit-exact: {a == zero['a']['losses']}")
    if a != zero["a"]["losses"]:
        raise AssertionError("the two-level fp32 exchange and phase 8 (a) "
                             "disagree")
    drop = a[0] - a[-1]
    dev_b = abs(b[-1] - a[-1])
    log(f"parity hier (b) vs (a): last loss {b[-1]!r} vs {a[-1]!r}, "
        f"{dev_b:.3e} = {dev_b / drop:.3e} of (a)'s drop {drop:.4f} (tol "
        f"{ZERO_INT8_TOL}); vs zero (b): "
        f"{max(abs(x - y) for x, y in zip(b, zero['b']['losses'])):.3e} "
        f"at most, bit-exact: {b == zero['b']['losses']}")
    if not dev_b <= ZERO_INT8_TOL * drop:
        raise AssertionError("the two-level int8 wire strays from the fp32 "
                             "one")
    out["b"]["drop_share"] = dev_b / drop
    return out


def vit_train(torch, hvd) -> tuple:
    """Phase 15 (b): ViT-B/16 at ``VIT`` through ``DistributedTrainStep``
    (AdamW(3e-4, weight_decay=1e-4), which the step wraps; pjit), flash
    attention on 196 patches; the parity with dense attention on the same
    weights.  Returns (summary, launch counts of the run)."""
    from horovod_tpu_torch.models.vit import ViT_B16, vit_loss
    from horovod_tpu_torch.ops import kernels as K

    dev = hvd.device()
    model = ViT_B16(dtype=torch.bfloat16, attention_impl="flash",
                    device=dev, generator=torch.Generator(
                        device=dev).manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    step = hvd.DistributedTrainStep(vit_loss, torch.optim.AdamW(
        model.parameters(), lr=3e-4, weight_decay=1e-4))
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    n, px = VIT["batch"], VIT["image"]
    images = {"x": torch.rand((n, px, px, 3), generator=gen, device=dev),
              "y": torch.randint(0, 1000, (n,), generator=gen, device=dev)}
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    model, opt = step.init(model)
    batch = step.shard_batch(images)
    losses, times = [], []
    for _ in range(VIT["steps"]):
        t0 = time.perf_counter()
        model, opt, loss = step(model, opt, batch)
        losses.append(float(loss))           # synchronises
        times.append(time.perf_counter() - t0)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"vit: ViT-B/16, {n_params / 1e6:.1f}M params, {px} px -> 196 "
        f"patches, batch {n}, bf16, flash, mode {step.mode}")
    log(f"vit: losses {losses}")
    log(f"vit: launches {counts}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite ViT loss")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"ViT loss did not fall: {losses}")
    check_flash_launches(counts, VIT["steps"], "vit", layers=VIT["layers"])
    steady = sorted(times[1:])[len(times[1:]) // 2]
    log(f"vit [{CARD}]: step {steady * 1e3:.1f} ms (median of steps 2-5; "
        f"first {times[0] * 1e3:.1f} ms), {n / steady:.1f} img/s, peak "
        f"memory {peak / 2**30:.2f} GiB")
    profiled = profile_step(torch, lambda: float(step(model, opt, batch)[2]),
                            "flash")

    # the same weights under dense attention, phase 6's limits: 5e-3
    # relative on the loss, 2e-2 relative L2 over all gradients
    grads = {}
    for impl in ("flash", "dense"):
        for block in model.layers:
            block.attn.cfg.attention_impl = impl
        loss = vit_loss(model, batch)
        grads[impl] = (float(loss.detach()), torch.cat(
            [g.float().reshape(-1)
             for g in no_hook_grads(torch, model, loss).values()]))
    for block in model.layers:
        block.attn.cfg.attention_impl = "flash"
    (lf, gf), (ld, gd) = grads["flash"], grads["dense"]
    loss_rel = abs(lf - ld) / abs(ld)
    grad_rel = float((gf - gd).norm() / gd.norm())
    log(f"parity vit flash vs dense: loss {lf:.6f} vs {ld:.6f} (rel "
        f"{loss_rel:.3e}, tol 5e-3), grads rel L2 {grad_rel:.3e} (tol 2e-2)")
    if not (loss_rel <= 5e-3 and grad_rel <= 2e-2):
        raise AssertionError("ViT flash and dense paths disagree")
    del grads, gf, gd, model, opt, step, batch, images
    return dict(step_ms=steady * 1e3, img_per_s=n / steady,
                first_step_ms=times[0] * 1e3, peak_gib=peak / 2**30,
                losses=losses, params_m=n_params / 1e6,
                idle_share=1 - profiled["busy"] / profiled["wall"],
                loss_rel=loss_rel, grad_rel=grad_rel), counts


def phase_model_parallel(torch, train: dict) -> dict:
    """Phase 15: (a) phase 4's recipe with the 870.9M LM built with a tp
    group of one through ``DistributedTrainStep(mode="pjit", plan="tp=1")``,
    whose losses must equal phase 4's bit for bit; (b) ViT-B/16
    (:func:`vit_train`); (c) the flash kernels non-causal at ViT's shape
    against SDPA and the bound.  ``train`` is phase 4's summary."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.parallel.tensor_parallel import tp_modules

    hvd.init()
    r = recipe(torch, hvd, plan="tp=1")
    losses, times, step = r["losses"], r["times"], r["step"]
    extents = [m.tp for m in tp_modules(r["model"])]
    log(f"mp (a): plan {step.plan.to_string()}, mode {step.mode}, "
        f"{len(extents)} tensor-parallel modules at tp {set(extents)}")
    log(f"mp (a): losses {losses}; phase 4 {train['losses']}; bit-exact: "
        f"{losses == train['losses']}")
    log(f"mp (a): launches {r['counts']}")
    if step.mode != "pjit" or set(extents) != {1} or \
            len(extents) != 4 * FULL["layers"]:
        raise AssertionError("the tp=1 plan did not build the pjit step over "
                             "the tensor-parallel modules")
    if losses != train["losses"]:
        raise AssertionError("the tp=1 plan's losses differ from phase 4's")
    check_flash_launches(r["counts"], len(losses), "mp (a)")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    log(f"mp (a) [{CARD}]: step {steady * 1e3:.1f} ms (phase 4 "
        f"{train['step_ms']:.1f} ms; steps "
        f"{[round(t * 1e3, 1) for t in times]}), peak "
        f"{r['peak'] / 2**30:.2f} GiB")
    model, opt, batch = r["model"], r["opt"], r["batch"]
    profiled = profile_step(torch, lambda: float(step(model, opt, batch)[2]))
    idle = 1 - profiled["busy"] / profiled["wall"]
    log(f"mp (a): idle share {idle:.3f} (phase 4 {train['idle_share']:.3f})")
    out = {"a": dict(losses=losses, step_ms=steady * 1e3,
                     peak_gib=r["peak"] / 2**30, idle_share=idle,
                     busy_ms=profiled["busy"])}
    del r, step, model, opt, batch
    torch.cuda.empty_cache()
    out["b"], vit_counts = vit_train(torch, hvd)
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    q, k, v, do = (torch.randn(VIT_FLASH, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    log(f"time flash non-causal at ViT's b{VIT_FLASH[0]} t{VIT_FLASH[1]} "
        f"h{VIT_FLASH[2]} d{VIT_FLASH[3]} [{CARD}]:")
    out["c"] = time_flash(torch, q, k, v, do, VIT_FLASH[-1] ** -0.5,
                          causal=False)
    for name, row in out["c"].items():
        row["launches"] = vit_counts[name]
    del q, k, v, do
    hvd.shutdown()
    return out


def phase_tp_train(torch):
    """The 870.9M TransformerLM through ``fused_tp_apply`` on a tp group of
    one, trained by the five-line recipe; returns the launch counts of its
    run and its summary."""
    import horovod_tpu_torch as hvd
    import torch.nn.functional as F

    from horovod_tpu_torch.models.transformer import (
        TransformerLM,
        fused_tp_apply,
        lm_loss,
    )
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.ops.fused_collectives import \
        resolve_fused_collectives
    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh

    hvd.init()
    dev = hvd.device()
    mesh = make_parallel_mesh(tp=1)
    cfg = full_config(torch, "flash")
    model = TransformerLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    log(f"tp: fused_tp_apply on a tp group of {mesh.shape['tp']} (dp "
        f"{mesh.shape['dp']}), fused collectives "
        f"{resolve_fused_collectives()}")
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4),
        gradient_predivide_factor=2.0)

    def tp_loss(m, batch):
        logits = fused_tp_apply(m, cfg, batch[:, :-1], mesh=mesh)
        return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                               batch[:, 1:].reshape(-1))

    step = hvd.DistributedTrainStep(tp_loss, opt)
    tokens = torch.randint(0, cfg.vocab_size,
                           (FULL["batch"], FULL["seq"] + 1),
                           generator=torch.Generator().manual_seed(SEED))
    steps = 5
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    model, opt = step.init(model)
    batch = step.shard_batch(tokens)
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        model, opt, loss = step(model, opt, batch)
        losses.append(float(loss))           # synchronises
        times.append(time.perf_counter() - t0)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"tp: losses {losses}")
    log(f"tp: launches on the tp path {counts}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite tp loss")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"tp loss did not fall: {losses}")
    want = 4 * MM_LAYERS * 3 * steps
    if counts["pallas_matmul"] != want:
        raise AssertionError(f"pallas_matmul launched "
                             f"{counts['pallas_matmul']} times, want {want}")
    missing = [k for k in TP_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the tp path: "
                             f"{missing}")
    check_flash_launches(counts, steps, "tp")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    tokens_per_step = FULL["batch"] * FULL["seq"]
    log(f"tp: step {steady * 1e3:.1f} ms (median of steps 2-5; first "
        f"{times[0] * 1e3:.1f} ms), {tokens_per_step / steady:.0f} tokens/s, "
        f"peak memory {peak / 2**30:.2f} GiB")

    profile_step(torch, lambda: float(step(model, opt, batch)[2]),
                 "mm_kernel")

    # the same weights through TransformerLM's forward (cuBLAS F.linear):
    # the two differ only in the order of the GEMMs' fp32 sums before each
    # bf16 rounding, so 5e-3 relative on the loss and 2e-2 relative L2 over
    # all gradients
    grads = {}
    for name, fn in (("tp", tp_loss), ("model", lm_loss)):
        loss = fn(model, batch)
        grads[name] = (float(loss.detach()), torch.cat(
            [g.float().reshape(-1)
             for g in no_hook_grads(torch, model, loss).values()]))
    (lt, gt), (lm, gm) = grads["tp"], grads["model"]
    loss_rel = abs(lt - lm) / abs(lm)
    grad_rel = float((gt - gm).norm() / gm.norm())
    log(f"parity fused_tp_apply vs TransformerLM: loss {lt:.6f} vs {lm:.6f} "
        f"(rel {loss_rel:.3e}, tol 5e-3), grads rel L2 {grad_rel:.3e} "
        f"(tol 2e-2)")
    if not (loss_rel <= 5e-3 and grad_rel <= 2e-2):
        raise AssertionError("fused_tp_apply and TransformerLM disagree")
    del grads, gt, gm
    model.zero_grad(set_to_none=True)
    hvd.shutdown()
    return counts, dict(step_ms=steady * 1e3,
                        tokens_per_s=tokens_per_step / steady,
                        peak_gib=peak / 2**30, losses=losses,
                        first_step_ms=times[0] * 1e3,
                        loss_rel=loss_rel, grad_rel=grad_rel)


def moe_config(torch, layers=None):
    """bench.py --model moe's configuration in bf16 with flash attention
    (``layers`` cuts the depth)."""
    from horovod_tpu_torch.models.moe import MoEConfig

    return MoEConfig(vocab_size=MOE["vocab"],
                     num_layers=layers or MOE["layers"],
                     num_heads=MOE["heads"], d_model=MOE["d_model"],
                     d_ff=MOE["d_ff"], max_seq_len=MOE["seq"],
                     dtype=torch.bfloat16, attention_impl="flash",
                     num_experts=MOE["experts"],
                     capacity_factor=MOE["capacity_factor"],
                     moe_every=MOE["moe_every"])


def moe_loss(m, batch):
    """bench.py run_moe's loss: cross-entropy + 0.01 · the mean aux."""
    from horovod_tpu_torch.models.moe import moe_aux_loss
    from horovod_tpu_torch.models.transformer import lm_loss

    return lm_loss(m, batch) + MOE["aux"] * moe_aux_loss(m)


def moe_tokens(torch, vocab: int):
    return torch.randint(0, vocab, (MOE["batch"], MOE["seq"] + 1),
                         generator=torch.Generator().manual_seed(SEED))


def phase_moe(torch) -> tuple:
    """Phase 10 on one card: (a) the Switch-MoE LM at bench.py's defaults,
    five steps through the hook path; (b) expert_chunk_mlp at one layer's
    shapes through kernel 6; (c) a sharded checkpoint round trip.  Returns
    (the launch counts of (a), those of (b), the summary)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.moe import MoETransformerLM, moe_layers
    from horovod_tpu_torch.ops import kernels as K

    hvd.init()
    dev = hvd.device()
    tag = f"moe [{CARD}]"
    cfg = moe_config(torch)
    model = MoETransformerLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    n_expert = sum(m.w1.numel() + m.w2.numel() for m in moe_layers(model))
    active = n_params - n_expert * (cfg.num_experts - 1) // cfg.num_experts
    log(f"{tag}: (a) {n_params / 1e6:.1f}M params, {active / 1e6:.1f}M "
        f"active a token, {cfg.num_layers}L/{cfg.d_model}d/"
        f"{cfg.num_heads}h, d_ff {cfg.d_ff}, {cfg.num_experts} experts "
        f"every {cfg.moe_every} blocks, cf {cfg.capacity_factor}, seq "
        f"{MOE['seq']}, batch {MOE['batch']}, attention "
        f"{cfg.attention_impl}")
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4),
        gradient_predivide_factor=2.0)
    step = hvd.DistributedTrainStep(moe_loss, opt)
    tokens = moe_tokens(torch, cfg.vocab_size)
    steps = MOE["steps"]
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    model, opt = step.init(model)
    batch = step.shard_batch(tokens)
    losses, times, sources = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        model, opt, loss = step(model, opt, batch)
        losses.append(float(loss))           # synchronises
        times.append(time.perf_counter() - t0)
        sources.append([src for _, src in opt.launches])
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"{tag}: (a) losses {losses}")
    log(f"{tag}: (a) launches on the MoE path {counts}")
    n_buckets = len(opt._buckets)
    hooks = [src.count("hook") for src in sources]
    if hooks != [n_buckets] * steps:
        raise AssertionError(f"moe: buckets from hooks {hooks}, want "
                             f"{n_buckets} a step")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("moe: non-finite loss")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"moe: loss did not fall: {losses}")
    check_flash_launches(counts, steps, "moe (a)", layers=cfg.num_layers)
    if counts["fused_scale"] != 2 * n_buckets * steps:
        raise AssertionError(f"moe: {counts['fused_scale']} fused_scale "
                             f"launches, want {2 * n_buckets * steps}")
    drops = [float(m.moe_drop_fraction) for m in moe_layers(model)]
    shares = [[round(float(v), 4) for v in m.moe_expert_fraction]
              for m in moe_layers(model)]
    steady = sorted(times[1:])[len(times[1:]) // 2]
    tokens_per_step = MOE["batch"] * MOE["seq"]
    log(f"{tag}: (a) step {steady * 1e3:.1f} ms (median of steps 2-5; "
        f"first {times[0] * 1e3:.1f} ms), {tokens_per_step / steady:.0f} "
        f"tokens/s, peak memory {peak / 2**30:.2f} GiB; {n_buckets} buckets "
        f"a step, all from hooks; fused_scale {counts['fused_scale'] // steps}"
        f" a step, each flash kernel {counts['flash_fwd'] // steps} a step")
    log(f"{tag}: (a) after step {steps}: drop fraction by MoE layer "
        f"{[round(d, 4) for d in drops]}, per-expert shares {shares}")
    profiled = profile_step(torch, lambda: float(step(model, opt, batch)[2]),
                            categories=MOE_ROUTING)
    idle = 1 - profiled["busy"] / profiled["wall"]
    log(f"{tag}: (a) profiled step: idle {100 * idle:.1f} %, device ms by "
        f"category {json.dumps({k: round(v, 2) for k, v in sorted(profiled['categories'].items(), key=lambda kv: -kv[1])})}")
    summary = dict(params_m=n_params / 1e6, active_params_m=active / 1e6,
                   step_ms=steady * 1e3, first_step_ms=times[0] * 1e3,
                   tokens_per_s=tokens_per_step / steady,
                   peak_gib=peak / 2**30, losses=losses, buckets=n_buckets,
                   idle_share=idle, drop_fraction=drops,
                   expert_shares=shares,
                   device_ms=profiled["categories"])
    del model, opt, step, batch
    torch.cuda.empty_cache()

    chunk_counts, summary["chunk"] = moe_chunk(torch, tag, dev)
    torch.cuda.empty_cache()
    summary["checkpoint"] = moe_checkpoint(torch, hvd, tag)
    hvd.shutdown()
    return counts, chunk_counts, summary


def moe_chunk(torch, tag: str, dev) -> tuple:
    """Phase 10 (b): expert_chunk_mlp at ``CHUNK``'s shapes in bf16, its
    launches counted from one call, held against the batched-einsum expert
    body under kernel 6's limits, both timed.  Returns (the counts of the
    call, the summary)."""
    from horovod_tpu_torch.models.moe import _expert_mlp
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.ops.fused_collectives import expert_chunk_mlp

    e, c, d, f = (CHUNK[k] for k in ("e_local", "capacity", "d", "f"))
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    chunk = torch.randn(e, c, d, generator=gen, device=dev).bfloat16()
    w1 = (torch.randn(e, d, f, generator=gen, device=dev)
          * (e * d) ** -0.5).bfloat16()
    w2 = (torch.randn(e, f, d, generator=gen, device=dev)
          * (e * f) ** -0.5).bfloat16()
    K.reset_launch_counts()
    got = expert_chunk_mlp(chunk, w1, w2)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    if counts["pallas_matmul"] != 2 * e:
        raise AssertionError(f"expert_chunk_mlp launched kernel 6 "
                             f"{counts['pallas_matmul']} times, want {2 * e}")
    want = _expert_mlp(chunk, w1, w2)
    readings = mm_agreement(torch, got, want)
    err = max_err(torch, got, want)
    log(f"{tag}: (b) expert_chunk_mlp ({e}, {c}, {d}) x f {f} bf16: "
        f"{counts['pallas_matmul']} kernel-6 launches; against the einsum "
        f"body max_abs_err {err:.3e} (largest entry "
        f"{float(want.float().abs().max()):.3e}); " +
        ", ".join(f"{key} {val:.3e} (tol {lim:.0e})"
                  for key, val, lim in readings))
    if not all(val <= lim for _, val, lim in readings):
        raise AssertionError("expert_chunk_mlp and the einsum body disagree")
    del got, want
    def plain():
        return torch.stack([K.pallas_matmul_plain(torch.nn.functional.gelu(
            K.pallas_matmul_plain(chunk[i], w1[i], torch.bfloat16),
            approximate="tanh"), w2[i], torch.bfloat16) for i in range(e)])

    ms = cuda_ms(torch, lambda: expert_chunk_mlp(chunk, w1, w2))
    body_ms = cuda_ms(torch, lambda: _expert_mlp(chunk, w1, w2))
    plain_ms = cuda_ms(torch, plain, iters=5)
    flops = 4 * e * c * d * f
    nbytes = 2 * (2 * e * c * d + 2 * e * d * f + e * c * f * 2)
    bms, by = bound_ms(nbytes, flops)
    # its parts, each timed alone: the eight (c, d) @ (d, f) products, the
    # eight gelus, the eight (c, f) @ (f, d) products
    h = [K.pallas_matmul(chunk[i], w1[i]) for i in range(e)]
    g = [torch.nn.functional.gelu(x, approximate="tanh") for x in h]
    parts = {
        "up": cuda_ms(torch, lambda: [K.pallas_matmul(chunk[i], w1[i])
                                      for i in range(e)]),
        "gelu": cuda_ms(torch, lambda: [torch.nn.functional.gelu(
            x, approximate="tanh") for x in h]),
        "down": cuda_ms(torch, lambda: [K.pallas_matmul(
            x, w2[i], out_dtype=torch.bfloat16) for i, x in enumerate(g)])}
    del h, g
    log(f"{tag}: (b) expert_chunk_mlp {ms:.4f} ms ({flops / ms / 1e9:.0f} "
        f"TFLOP/s, {100 * bms / ms:.1f} % of bound {bms:.4f} ms by {by}), "
        f"einsum body (cuBLAS) {body_ms:.4f} ms ({ms / body_ms:.2f}x), "
        f"plain loop {plain_ms:.4f} ms; its parts alone: the up products "
        f"{parts['up']:.4f} ms ({flops / 2 / parts['up'] / 1e9:.0f} "
        f"TFLOP/s), gelu {parts['gelu']:.4f} ms, the down products "
        f"{parts['down']:.4f} ms ({flops / 2 / parts['down'] / 1e9:.0f} "
        f"TFLOP/s)")
    return counts, dict(ms=ms, einsum_ms=body_ms, plain_ms=plain_ms,
                        parts_ms=parts, bound_ms=bms,
                        launches=counts["pallas_matmul"], max_abs_err=err)


def moe_checkpoint(torch, hvd, tag: str) -> dict:
    """Phase 10 (c): the MoE recipe with shard_optimizer_states=True at
    full width at ``MOE_CKPT_LAYERS`` layers (fewer when the temporary
    directory's disk is short):
    one step, save_sharded and the parameters (async), a second step; then
    a fresh model and wrapper restore both and take that second step, which
    must equal the first run's bit for bit."""
    from horovod_tpu_torch.checkpoint import Checkpointer
    from horovod_tpu_torch.models.moe import MoETransformerLM
    from horovod_tpu_torch.ops import kernels as K

    dev = hvd.device()
    root = tempfile.mkdtemp(prefix="hvd_torch_moe_ckpt_")
    try:
        layers = MOE_CKPT_LAYERS
        free = shutil.disk_usage(root).free
        while True:
            cfg = moe_config(torch, layers)
            n = sum(p.numel() for p in MoETransformerLM(
                cfg, device="meta").parameters())
            need = 3 * 4 * n * 1.2       # params + AdamW's two moments, fp32
            if need < free or layers <= 2:
                break
            layers -= 2
        log(f"{tag}: (c) {layers} of {MOE['layers']} layers "
            f"({n / 1e6:.1f}M params, ~{need / 2**30:.1f} GiB to write, "
            f"{free / 2**30:.1f} GiB free)" +
            (": cut for time" if layers == MOE_CKPT_LAYERS
             else ": cut for time and the disk"))
        tokens = moe_tokens(torch, cfg.vocab_size)

        def build():
            model = MoETransformerLM(cfg, device=dev, generator=torch.Generator(
                device=dev).manual_seed(SEED))
            opt = hvd.DistributedOptimizer(
                torch.optim.AdamW(model.parameters(), lr=3e-4,
                                  weight_decay=1e-4),
                gradient_predivide_factor=2.0, shard_optimizer_states=True)
            step = hvd.DistributedTrainStep(moe_loss, opt)
            model, opt = step.init(model)
            return model, opt, step, step.shard_batch(tokens)

        model, opt, step, batch = build()
        # two writers, so that neither save waits for the other's write
        states = Checkpointer(os.path.join(root, "state"))
        params = Checkpointer(os.path.join(root, "params"))
        K.reset_launch_counts()
        first = float(step(model, opt, batch)[2])
        groups = len(opt.spec.groups)
        if K.launch_counts()["fused_scale"] != 2 * groups:
            raise AssertionError("moe (c): fused_scale not in every group")
        states.save_sharded(1, opt.sharded_state_dict(), opt.shard_index,
                            hvd.size(), plan="dp=1")
        params.save(1, {"model": model.state_dict()})
        stall = (states.last_stall_s, params.last_stall_s)
        ref = float(step(model, opt, batch)[2])   # while the writes run
        states.wait()
        params.wait()
        write_s = (states.last_write_s, params.last_write_s)
        ref_params = {k: v.detach().cpu() for k, v in
                      model.state_dict().items()}
        nbytes = sum(os.path.getsize(os.path.join(dp, fn))
                     for dp, _, fns in os.walk(root) for fn in fns)
        del model, opt, step, batch
        torch.cuda.empty_cache()

        model, opt, step, batch = build()
        t0 = time.perf_counter()
        model.load_state_dict(params.restore(step=1)["model"])
        opt.load_sharded_state_dict(states.restore_sharded(
            opt.sharded_state_template(), opt.shard_index, hvd.size(),
            plan="dp=1"))
        restore_s = time.perf_counter() - t0
        got = float(step(model, opt, batch)[2])
        same = got == ref and all(
            torch.equal(v.detach().cpu(), ref_params[k])
            for k, v in model.state_dict().items())
        log(f"{tag}: (c) {groups} group(s); last_stall_s (the host "
            f"copy) {stall[0]:.3f} s sharded state, {stall[1]:.3f} s "
            f"parameters, against last_write_s (in the background, beside "
            f"the second step) {write_s[0]:.3f} s and {write_s[1]:.3f} s; "
            f"{nbytes / 1e9:.2f} GB written; restore {restore_s:.2f} s; "
            f"losses: first "
            f"{first!r}, second {ref!r}, second after restore {got!r}; "
            f"bit-exact: {same}")
        if not same:
            raise AssertionError("moe (c): the restored run differs")
        del model, opt, step, batch, ref_params
        torch.cuda.empty_cache()
        return dict(layers=layers, groups=groups, stall_s=stall,
                    write_s=write_s, restore_s=restore_s, bytes=nbytes,
                    bit_exact=same)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_resnet(torch):
    """ResNet-50 at bench.py's configuration through the five-line recipe;
    returns the launch counts of its run and its summary."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.resnet import (
        ResNet50,
        resnet_loss,
        unfused_state_dict,
    )
    from horovod_tpu_torch.ops import kernels as K

    hvd.init()
    dev = hvd.device()
    batch_size, image = RESNET["batch"], RESNET["image"]
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                     space_to_depth=True, fused_bwd=True, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"resnet: ResNet-50 {n_params / 1e6:.3f}M params + BN statistics "
        f"as parameters, {image} px, batch {batch_size}, bf16, "
        f"space_to_depth, fused_bwd, train=False")
    opt = hvd.DistributedOptimizer(torch.optim.SGD(
        model.parameters(), lr=0.01 * hvd.size(), momentum=0.9))
    hvd.broadcast_variables(model, root_rank=0)
    step = hvd.DistributedTrainStep(resnet_loss, opt)
    cpu = torch.Generator().manual_seed(SEED)
    images = torch.rand((batch_size, image, image, 3), generator=cpu)
    labels = torch.randint(0, 1000, (batch_size,), generator=cpu)

    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    model, opt = step.init(model)
    batch = step.shard_batch({"x": images, "y": labels})
    losses, times = [], []
    for _ in range(RESNET["steps"]):
        t0 = time.perf_counter()
        model, opt, loss = step(model, opt, batch)
        losses.append(float(loss))           # synchronises
        times.append(time.perf_counter() - t0)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"resnet: losses {losses}")
    log(f"resnet: launches on the main path {counts}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite ResNet loss")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"ResNet loss did not fall: {losses}")
    want = sum(CBR_MAIN.values()) * RESNET["steps"]
    if counts["fused_conv_bn_relu_bwd"] != want:
        raise AssertionError(f"fused_conv_bn_relu_bwd launched "
                             f"{counts['fused_conv_bn_relu_bwd']} times, "
                             f"want {want}")
    steady = sorted(times[1:5])[1:3]
    steady = sum(steady) / 2                  # median of steps 2-5
    log(f"resnet: step {steady * 1e3:.1f} ms (median of steps 2-5; first "
        f"{times[0] * 1e3:.1f} ms), {batch_size / steady:.0f} img/s, peak "
        f"memory {peak / 2**30:.2f} GiB")

    profile_step(torch, lambda: float(step(model, opt, batch)[2]), "cbr_")

    # the same weights with fused_bwd=False, the bench default: loss and
    # gradients of every parameter in bf16.  The two differ only inside the
    # 13 stride-1 3x3 segments (where bf16 rounds dy and da, and the
    # kernel's fp32 dW), so 1e-2 relative on the loss and 5e-2 relative L2
    # over all gradients, leaving out the fused segments' mean/var, whose
    # gradients are 0 by design.
    unfused = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                       space_to_depth=True, fused_bwd=False, device=dev)
    unfused.load_state_dict(unfused_state_dict(model.state_dict()))
    segments = [n for n, _ in model.named_parameters()
                if ".FusedConvBnRelu3x3_0." in n]
    fused_stats = [n for n in segments if n.endswith((".mean", ".var"))]
    zero_by_design = set(unfused_state_dict(dict.fromkeys(fused_stats)))
    own = set(unfused_state_dict(dict.fromkeys(segments))) - zero_by_design
    grads, parity = {}, {}
    for name, m in (("fused", model), ("unfused", unfused)):
        loss = resnet_loss(m, batch)
        named = no_hook_grads(torch, m, loss)
        if name == "fused":
            if any(named[n].any() for n in fused_stats):
                raise AssertionError("a fused segment's mean/var gradient "
                                     "is not 0")
            named = unfused_state_dict(named)
        parity[name] = float(loss.detach())
        grads[name] = {n: g.float() for n, g in named.items()
                       if n not in zero_by_design}
    lf, lu = parity["fused"], parity["unfused"]
    loss_rel = abs(lf - lu) / abs(lu)
    readings = []
    for label, names in (("all", sorted(grads["unfused"])),
                         ("fused segments' W/scale/bias", sorted(own))):
        gf = torch.cat([grads["fused"][n].reshape(-1) for n in names])
        gu = torch.cat([grads["unfused"][n].reshape(-1) for n in names])
        readings.append((label, float((gf - gu).norm() / gu.norm()),
                         gf.numel()))
    log(f"parity fused vs unfused backward: loss {lf:.6f} vs {lu:.6f} (rel "
        f"{loss_rel:.3e}, tol 1e-2); " + "; ".join(
            f"grads rel L2 {rel:.3e} over {label} ({n} values, tol 5e-2)"
            for label, rel, n in readings))
    if not (loss_rel <= 1e-2 and all(r <= 5e-2 for _, r, _ in readings)):
        raise AssertionError("fused and unfused ResNet backward disagree")
    del grads, unfused
    model.zero_grad(set_to_none=True)
    hvd.shutdown()
    return counts, dict(step_ms=steady * 1e3, img_per_s=batch_size / steady,
                        peak_gib=peak / 2**30, losses=losses,
                        first_step_ms=times[0] * 1e3)


# phase 11: bench.py --model resnet50 --fused-bwd --input-mode host
# (bench.py:220-315, :557-570): an ArraySource over seeded fp32 images
# (bench.py:213-219) through ShardedDataset -> PrefetchIterator; 512 rows
# are 4 steps an epoch, so the 10 steps cross two epoch boundaries
FED = dict(rows=512, warmup=2, steps=8, depth=2, threads=2)
# the fed losses against the synchronous control's (the same weights and
# batches, placed inline): bit-exact expected, logged
FED_LOSS_TOL = 1e-5
# phase 11 (b): SyncBatchNorm at ResNet-50's BatchNorm shapes (N, C, H, W),
# bf16, channels last, against the port's BatchNorm(train=True): the same
# fp32 operations in the same order at a world of one, so bit-exact is
# expected; held normwise and logged
SYNC_BN_SHAPES = [(128, 256, 56, 56), (128, 512, 28, 28), (128, 2048, 7, 7)]
SYNC_BN_TOL = 1e-5


def _rand_images(np, rng, n: int, hw: int):
    """(n, hw, hw, 3) float32 uniform images in chunks of 64, as
    bench.py's ``_rand_images`` makes them."""
    out = np.empty((n, hw, hw, 3), np.float32)
    for i in range(0, n, 64):
        out[i:i + 64] = rng.rand(min(64, n - i), hw, hw, 3)
    return out


def phase_fed(torch, resident: dict) -> tuple:
    """ResNet-50 at phase 5's configuration, fed from host memory through
    the input plane; returns the launch counts of the fed run and its
    summary.  ``resident`` is phase 5's summary."""
    import numpy as np

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.data import (
        ArraySource,
        PrefetchIterator,
        ShardedDataset,
        broadcast_seed,
    )
    from horovod_tpu_torch.data.prefetch import CardStager
    from horovod_tpu_torch.models.resnet import ResNet50, resnet_loss
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.utils.input_probe import (
        fence_batch,
        measure_h2d_overlap,
    )

    hvd.init()
    dev = hvd.device()
    batch_size, image = RESNET["batch"], RESNET["image"]
    rng = np.random.RandomState(SEED)
    host = {"x": _rand_images(np, rng, FED["rows"], image),
            "y": rng.randint(0, 1000, (FED["rows"],)).astype(np.int32)}
    init = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                    space_to_depth=True, fused_bwd=True, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED)
                    ).state_dict()

    def recipe():
        """A model with the seeded weights and the five-line recipe; the
        predivide keeps the exchange's two scale passes a bucket at a world
        of one, as phase 4's does."""
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                         space_to_depth=True, fused_bwd=True, device=dev)
        model.load_state_dict(init)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.01 * hvd.size(),
                            momentum=0.9), gradient_predivide_factor=2.0)
        hvd.broadcast_variables(model, root_rank=0)
        step = hvd.DistributedTrainStep(resnet_loss, opt)
        model, opt = step.init(model)
        return model, opt, step

    model, opt, step = recipe()
    ds = ShardedDataset(ArraySource(host), batch_size=batch_size,
                        seed=broadcast_seed(0))
    n_steps = FED["warmup"] + FED["steps"]
    log(f"fed: ResNet-50 from {FED['rows']} host fp32 images "
        f"({host['x'].nbytes / 1e6:.1f} MB) through ShardedDataset -> "
        f"PrefetchIterator(depth {FED['depth']}, threads {FED['threads']}, "
        f"place=step.shard_local_batch), {ds.steps_per_epoch} steps an "
        f"epoch, {FED['warmup']} + {FED['steps']} steps")

    torch.cuda.synchronize()
    K.reset_launch_counts()
    feed = PrefetchIterator(ds.iter_epochs(), place=step.shard_local_batch,
                            depth=FED["depth"], threads=FED["threads"],
                            name="resnet")
    losses, times = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        model, opt, loss = step(model, opt, next(feed))
        losses.append(float(loss))           # synchronises
        times.append(time.perf_counter() - t0)
    counts = K.launch_counts()
    n_buckets = len(opt._buckets)
    log(f"fed: losses {losses}")
    log(f"fed: launches on the fed path {counts}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite fed ResNet loss")
    want = {"fused_conv_bn_relu_bwd": sum(CBR_MAIN.values()) * n_steps,
            "fused_scale": 2 * n_buckets * n_steps}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"fed path launches {got}, want {want} "
                             f"({n_buckets} buckets a step)")
    stager = feed.stager
    slots = [s for ring in stager._rings.values() for s in ring]
    main_stream = torch.cuda.current_stream(dev)
    if stager.stream.stream_id == main_stream.stream_id or \
            not slots or not all(s.buf.is_pinned() for s in slots):
        raise AssertionError("the feed's copies are not on a stream of "
                             "their own from pinned buffers")
    timed_stall = feed.stall_samples[FED["warmup"]:n_steps]
    stall = statistics.median(timed_stall)
    step_s = statistics.median(times[FED["warmup"]:])
    log(f"fed: {len(slots)} pinned staging buffers "
        f"({sum(s.buf.numel() * s.buf.element_size() for s in slots) / 1e6:.1f}"
        f" MB) for {len(stager._rings)} leaves; copy stream "
        f"{stager.stream.stream_id}, consumer stream {main_stream.stream_id}")
    log(f"fed: step {step_s * 1e3:.2f} ms (median of the {FED['steps']} "
        f"timed steps; steps {[round(t * 1e3, 2) for t in times]}), "
        f"{batch_size / step_s:.1f} img/s fed; input_stall_s {stall:.6f} "
        f"(median; timed window {[round(t * 1e3, 3) for t in timed_stall]} "
        f"ms)")

    # two fed steps under the profiler: the copy of a later batch is
    # issued once next() frees a place in the queue, after the source's
    # take, and lands within them
    profiled = profile_step(
        torch, lambda: [float(step(model, opt, next(feed))[2])
                        for _ in range(2)], "cbr_", streams=True)
    big = [c for c in profiled.get("h2d", []) if c["mb"] >= 1.0]
    log(f"fed: the two profiled steps' host-to-device copies of 1 MB and "
        f"more {big}")
    if not big or not all(c["pinned"] and c["side"] for c in big):
        raise AssertionError("the profiled fed step's batch copies are not "
                             "pinned copies off the main stream")
    feed.close()

    # the same model on one resident batch, timed as phase 5 times
    batch = step.shard_local_batch(ds.source.take(np.arange(batch_size)))
    res_times = []
    for _ in range(RESNET["steps"]):
        t0 = time.perf_counter()
        model, opt, loss = step(model, opt, batch)
        float(loss)
        res_times.append(time.perf_counter() - t0)
    res_s = sorted(res_times[1:5])[1:3]
    res_s = sum(res_s) / 2
    del batch
    log(f"fed: resident batch {res_s * 1e3:.2f} ms a step (median of steps "
        f"2-5), {batch_size / res_s:.1f} img/s; phase 5 "
        f"{resident['img_per_s']:.1f} img/s; fed/resident "
        f"{res_s / step_s:.4f}")

    # the synchronous control: the seeded weights again, the same batches
    # in the same order, each placed inline and fenced
    del model, opt, step
    torch.cuda.empty_cache()
    model, opt, step = recipe()
    gen = ds.iter_epochs()
    sync_losses, sync = [], []
    for i in range(n_steps):
        t0 = time.perf_counter()
        b = step.shard_local_batch(next(gen))
        fence_batch(b)
        dt = time.perf_counter() - t0
        model, opt, loss = step(model, opt, b)
        sync_losses.append(float(loss))
        if i >= FED["warmup"]:
            sync.append(dt)
    sync_stall = statistics.median(sync)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, sync_losses))
    exact = sum(a == b for a, b in zip(losses, sync_losses))
    log(f"fed: synchronous control losses {sync_losses}; {exact} of "
        f"{n_steps} bit-exact with the fed run, max rel {rel:.3e} (tol "
        f"{FED_LOSS_TOL:g}); input_stall_sync_s {sync_stall:.6f} (timed "
        f"window {[round(t * 1e3, 3) for t in sync]} ms)")
    if not rel <= FED_LOSS_TOL:
        raise AssertionError("the fed losses differ from the synchronous "
                             "control's")

    # the H2D probe (utils/input_probe.py) through the feed's own staging
    stager = CardStager(dev, step.shard_local_batch,
                        FED["depth"] + FED["threads"])
    holder = [(model, opt)]

    def probe_step(b):
        m, o, loss = step(holder[0][0], holder[0][1], b)
        holder[0] = (m, o)
        return loss

    gen2 = ds.iter_epochs()
    probe = measure_h2d_overlap(probe_step, lambda: next(gen2),
                                lambda h: stager.place(h)[0])
    stager.close()
    fields = {"input_mode": "host", "input_stall_s": stall,
              "input_stall_sync_s": sync_stall,
              "input_stall_speedup":
                  sync_stall / stall if stall > 0 else None,
              "prefetch_depth": FED["depth"], **probe.as_bench_fields()}
    log(f"fed: {json.dumps(fields)}")
    log(f"fed: h2d probe both_s {probe.both_s:.6f}")
    del model, opt, step, holder
    hvd.shutdown()
    return counts, dict(
        fields, step_ms=step_s * 1e3, img_per_s_fed=batch_size / step_s,
        img_per_s_resident=batch_size / res_s,
        img_per_s_phase5=resident["img_per_s"], h2d_both_s=probe.both_s,
        losses=losses, sync_losses=sync_losses, losses_bit_exact=exact,
        idle_pct=100 - 100 * profiled["busy"] / profiled["wall"],
        h2d_copies=big, buckets=n_buckets)


def _rel(a, b) -> float:
    """Normwise relative difference of two tensors, in fp32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def sync_bn_parity(torch, shape, seed: int = SEED) -> dict:
    """SyncBatchNorm against the port's BatchNorm(train=True) on the same
    bf16 channels-last input of ``shape`` on the runtime's card: the
    normwise difference of the output, the running statistics and the
    gradients of ``(y·g).sum()`` for the input, scale and bias, and which
    of them are bit-exact; the all-reduces of a forward and of a backward
    under torch.profiler; forward + backward ms of both (CUDA events)."""
    from torch.profiler import ProfilerActivity, profile

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.resnet import BatchNorm

    dev = hvd.device()
    c = shape[1]
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    g = torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    stats = {"scale": 1 + 0.1 * torch.randn(c, generator=gen, device=dev),
             "bias": 0.1 * torch.randn(c, generator=gen, device=dev),
             "mean": 0.1 * torch.randn(c, generator=gen, device=dev),
             "var": 1 + 0.1 * torch.rand(c, generator=gen, device=dev)}
    sync = hvd.SyncBatchNorm(c, device=dev)
    plain = BatchNorm(c, dtype=torch.bfloat16, device=dev)
    for m in (sync, plain):
        m.load_state_dict(stats)

    def run(m, train_kw, xin):
        xin = xin.detach().clone().requires_grad_()
        y = m(xin, **train_kw)
        (y.float() * g.float()).sum().backward()
        return y, xin.grad

    out = {}
    ys, dxs = run(sync, {}, x)
    yp, dxp = run(plain, {"train": True}, x)
    pairs = {"y": (ys, yp), "mean": (sync.mean, plain.mean),
             "var": (sync.var, plain.var), "dx": (dxs, dxp),
             "dscale": (sync.scale.grad, plain.scale.grad),
             "dbias": (sync.bias.grad, plain.bias.grad)}
    out["rel"] = {k: _rel(a.detach(), b.detach()) for k, (a, b) in
                  pairs.items()}
    out["exact"] = sorted(k for k, (a, b) in pairs.items()
                          if torch.equal(a.detach(), b.detach()))

    def collectives(fn) -> int:
        """The all-reduces ``fn`` issued: the c10d op's host events (the
        NCCL process group's own events where the trace lacks them)."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names: dict = {}
        for e in prof.events():
            if "allreduce" in e.name or "all_reduce" in e.name:
                names[e.name] = names.get(e.name, 0) + 1
        out.setdefault("allreduce_events", []).append(names)
        return names.get("c10d::allreduce_") or \
            names.get("nccl:all_reduce", 0)

    xin = x.detach().clone().requires_grad_()
    box = {}
    out["allreduce_fwd"] = collectives(
        lambda: box.setdefault("y", sync(xin)))
    out["allreduce_bwd"] = collectives(
        lambda: (box["y"].float() * g.float()).sum().backward())
    del box

    def fwd_bwd(m, kw):
        return lambda: run(m, kw, x)

    out["ms"] = cuda_ms(torch, fwd_bwd(sync, {}), iters=10)
    out["plain_ms"] = cuda_ms(torch, fwd_bwd(plain, {"train": True}),
                              iters=10)
    return out


def phase_sync_bn(torch) -> dict:
    """Phase 11 (b): SyncBatchNorm on a world of one at ResNet-50's
    BatchNorm shapes, held against BatchNorm and timed beside it."""
    import horovod_tpu_torch as hvd

    hvd.init()
    summary = {}
    for shape in SYNC_BN_SHAPES:
        r = sync_bn_parity(torch, shape)
        key = "x".join(map(str, shape))
        summary[key] = r
        log(f"sync_bn {key} bf16 channels-last [{CARD}]: rel "
            f"{json.dumps({k: float(f'{v:.3e}') for k, v in r['rel'].items()})}"
            f" (tol {SYNC_BN_TOL:g}), bit-exact {r['exact']}; all-reduces "
            f"forward {r['allreduce_fwd']}, backward {r['allreduce_bwd']}; "
            f"forward + backward {r['ms']:.4f} ms, BatchNorm "
            f"{r['plain_ms']:.4f} ms")
        if max(r["rel"].values()) > SYNC_BN_TOL:
            raise AssertionError(f"SyncBatchNorm differs from BatchNorm at "
                                 f"{key}: {r['rel']}")
        if (r["allreduce_fwd"], r["allreduce_bwd"]) != (1, 1):
            raise AssertionError(f"SyncBatchNorm at {key}: all-reduces "
                                 f"forward {r['allreduce_fwd']}, backward "
                                 f"{r['allreduce_bwd']}, want 1 and 1")
    torch.cuda.empty_cache()
    hvd.shutdown()
    return summary


# phase 12: the launcher's variables that the launched worker must find
LAUNCH_VARS = ("HOROVOD_HOSTNAME", "HOROVOD_RANK", "HOROVOD_SIZE",
               "HOROVOD_LOCAL_RANK", "HOROVOD_LOCAL_SIZE",
               "HOROVOD_CROSS_RANK", "HOROVOD_CROSS_SIZE",
               "HOROVOD_COORDINATOR_ADDR", "HOROVOD_CONTROLLER")
# phase 12 (a)'s launched run must end within this many seconds
LAUNCH_TIMEOUT_S = 400
# each step of phase 4's recipe: 16 launches of each flash kernel, and
# fused_scale twice (predivide 2.0) over each of 66 buckets
LAUNCHES_A_STEP = {"flash_fwd": 16, "flash_bwd_dq": 16, "flash_bwd_dkv": 16,
                   "fused_scale": 132}


def launched_worker(torch, out_path: str) -> int:
    """``chip_smoke.py --launched OUT``: phase 12 (a)'s worker, started by
    ``python -m horovod_tpu_torch.runner -np 1``.  Checks the launcher's
    variables and the port's controller stamp, calls ``hvd.init()`` with
    no device (so ``cuda:<local_rank>``), trains phase 4's recipe 5
    steps, and writes the losses, identity, launches, step ms, tokens/s
    and peak memory to ``OUT`` as JSON."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.runtime.config import CONTROLLER

    t_worker = time.time()
    missing = [k for k in LAUNCH_VARS if not os.environ.get(k)]
    if missing:
        raise AssertionError(f"launched without {missing}")
    if os.environ["HOROVOD_CONTROLLER"] != CONTROLLER:
        raise AssertionError(f"controller {os.environ['HOROVOD_CONTROLLER']}"
                             f", want {CONTROLLER}")
    from horovod_tpu_torch.ops import build

    hvd.init()
    t_init = time.time()
    r = recipe(torch, hvd)
    steps = len(r["losses"])
    store = dict(build_seconds=build.build_seconds,
                 library_hit=build.library_hit,
                 library=build.library_path().name,
                 cache_stats=hvd.cache_stats())
    steady = statistics.median(r["times"][1:])
    out = dict(
        losses=r["losses"],
        identity=dict(rank=hvd.rank(), size=hvd.size(),
                      local_rank=hvd.local_rank(),
                      local_size=hvd.local_size(),
                      device=str(hvd.device())),
        env={k: os.environ[k] for k in LAUNCH_VARS},
        launches={k: r["counts"][k] for k in LAUNCHES_A_STEP},
        launches_a_step={k: r["counts"][k] / steps for k in LAUNCHES_A_STEP},
        step_ms=steady * 1e3, first_step_ms=r["times"][0] * 1e3,
        tokens_per_s=FULL["batch"] * FULL["seq"] / steady,
        peak_gib=r["peak"] / 2**30, worker_start=t_worker,
        init_s=t_init - t_worker, first_end=r["first_end"], store=store)
    del r
    hvd.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)
    log(f"launched worker: losses {out['losses']}")
    return 0


def card_identity() -> dict:
    """Phase 12 (b)'s function for ``horovod_tpu_torch.runner.run``: the
    rank's identity, its card, and an ``hvd.allreduce`` of a CUDA tensor
    (the sum of ``arange(4) + rank`` over the ranks)."""
    import torch

    import horovod_tpu_torch as hvd

    hvd.init()
    try:
        dev = hvd.device()
        x = torch.arange(4, dtype=torch.float32, device=dev) + hvd.rank()
        y = hvd.allreduce(x, op=hvd.Sum)
        return dict(rank=hvd.rank(), size=hvd.size(),
                    local_rank=hvd.local_rank(), device=str(dev),
                    name=torch.cuda.get_device_name(dev),
                    allreduce=y.cpu().tolist(), on_card=y.is_cuda)
    finally:
        hvd.shutdown()


def _hvdrun(args, timeout: float, env=None) -> subprocess.CompletedProcess:
    """``python -m horovod_tpu_torch.runner ARGS`` (under ``env``, else
    this process's environment); past ``timeout`` the launcher gets
    SIGTERM, which ends its workers too, and this raises."""
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", *args]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.terminate()
        try:
            proc.communicate(timeout=60)
        finally:
            proc.kill()
            proc.wait()
        raise
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def phase_launch(torch, train: dict) -> dict:
    """Phase 12: (a) phase 4's recipe launched through ``python -m
    horovod_tpu_torch.runner -np 1``, its losses held against phase 4's
    bit for bit; (b) ``run(card_identity, np=1)``; (c) ``--check-build``;
    (d) a rank that exits 3 makes the launcher return 3."""
    import chip_smoke
    from horovod_tpu_torch.runner import run

    log(f"launch: parent holds {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB on the card before the launch")
    out_dir = tempfile.mkdtemp(prefix="hvd_torch_launch_")
    try:
        out_json = os.path.join(out_dir, "launched.json")
        t_launch = time.time()
        proc = _hvdrun(["-np", "1", sys.executable,
                        os.path.abspath(__file__), "--launched", out_json],
                       LAUNCH_TIMEOUT_S)
        wall = time.time() - t_launch
        for line in proc.stdout.splitlines()[-3:]:
            log(f"launch (a) worker: {line}")
        if proc.returncode != 0 or not os.path.exists(out_json):
            print(proc.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"launched recipe: launcher rc "
                                 f"{proc.returncode}")
        with open(out_json) as f:
            res = json.load(f)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    want_id = dict(rank=0, size=1, local_rank=0, local_size=1,
                   device="cuda:0")
    first_s = res["first_end"] - t_launch
    log(f"launch (a) [{CARD}]: identity {res['identity']}, controller "
        f"{res['env']['HOROVOD_CONTROLLER']}, coordinator "
        f"{res['env']['HOROVOD_COORDINATOR_ADDR']}")
    log(f"launch (a) [{CARD}]: losses {res['losses']} vs phase 4's "
        f"{train['losses']}, bit-exact: {res['losses'] == train['losses']}")
    log(f"launch (a) [{CARD}]: launches a step {res['launches_a_step']}")
    log(f"launch (a) [{CARD}]: step {res['step_ms']:.1f} ms (phase 4 "
        f"{train['step_ms']:.1f} ms), {res['tokens_per_s']:.0f} tokens/s, "
        f"peak {res['peak_gib']:.2f} GiB (phase 4 {train['peak_gib']:.2f}); "
        f"launch to first step {first_s:.2f} s (worker start "
        f"{res['worker_start'] - t_launch:.2f} s, its init "
        f"{res['init_s']:.2f} s, "
        f"first step {res['first_step_ms'] / 1e3:.2f} s); phase 4's "
        f"in-process init to first step {train['init_to_first_step_s']:.2f}"
        f" s; launcher wall {wall:.2f} s")
    if res["identity"] != want_id:
        raise AssertionError(f"launched identity {res['identity']}")
    if res["losses"] != train["losses"]:
        raise AssertionError("the launched recipe and phase 4 disagree")
    if res["launches_a_step"] != LAUNCHES_A_STEP:
        raise AssertionError(f"launched launches {res['launches_a_step']}, "
                             f"want {LAUNCHES_A_STEP}")

    t0 = time.time()
    got = run(chip_smoke.card_identity, np=1)
    run_s = time.time() - t0
    log(f"launch (b) [{CARD}]: run(card_identity, np=1) -> {got} in "
        f"{run_s:.2f} s")
    want = dict(rank=0, size=1, local_rank=0, device="cuda:0",
                name=torch.cuda.get_device_name(0),
                allreduce=[0.0, 1.0, 2.0, 3.0], on_card=True)
    if got != [want]:
        raise AssertionError(f"run() returned {got}, want {[want]}")

    build = _hvdrun(["--check-build"], 120)
    log("launch (c): " + " | ".join(build.stdout.splitlines()))
    if build.returncode != 0 or "[X] CUDA" not in build.stdout or \
            "[X] NCCL" not in build.stdout:
        raise AssertionError("--check-build does not report CUDA and NCCL")

    t0 = time.time()
    fail = _hvdrun(["-np", "1", sys.executable, "-c",
                    "import sys; sys.exit(3)"], 120)
    log(f"launch (d): a rank that exits 3 -> launcher rc "
        f"{fail.returncode} in {time.time() - t0:.2f} s")
    if fail.returncode != 3:
        raise AssertionError(f"fail-fast: launcher rc {fail.returncode}")
    return dict(losses_bit_exact=True, launch_to_first_step_s=first_s,
                worker_start_s=res["worker_start"] - t_launch,
                worker_init_s=res["init_s"],
                phase4_init_to_first_step_s=train["init_to_first_step_s"],
                step_ms=res["step_ms"], phase4_step_ms=train["step_ms"],
                tokens_per_s=res["tokens_per_s"], peak_gib=res["peak_gib"],
                launches_a_step=res["launches_a_step"], run_s=run_s,
                launcher_wall_s=wall, store=res["store"])


# phase 13 (a): the delta form against phase 4.  At a world of one Adasum
# is the identity, and after the first step the parameters must be
# start + (local - start) computed from phase 4's, bit for bit: that is
# local wherever the subtraction is exact (Sterbenz: local within a factor
# 2 of start) and one fp32 step off for weights near zero (on an H100,
# 0.84 % of them, by at most 2.9e-11; 1,207 changed their bf16 value).
# From the second step on, AdamW's update of an element whose gradient
# sits at the fp32 noise floor flips with such a change (more than half
# the parameters differed after step 2, by up to 2 lr), so the two
# trajectories drift apart like two runs from a perturbed weight: the
# five losses read up to 1.3e-4 apart.  A fault of the form (Adasum not
# the identity, a delta applied twice or lost) moves step 2's loss by a
# share of its 6 % drop.
ADASUM_LOSS_TOL = 1e-3
# phase 13 (b): two seeded batches of phase 4's shape give the two
# gradient sets of the combine
COMBINE_SEEDS = (1, 2)
# phase 13 (c): the untied embedding table (vocab x d_model, fp32) of the
# sparse path, phase 4's batch of tokens and the bound on touched rows
SPARSE_TABLE = (FULL["vocab"], FULL["d_model"])
SPARSE_MAX_ROWS = FULL["batch"] * FULL["seq"]


def combine_tol(n: int) -> float:
    """Phase 13 (b)'s normwise limit for a tensor of ``n`` elements, card
    against CPU: each side sums the three fp32 dot products of ``n`` terms
    in its own order (cuBLAS in a tree, the CPU's BLAS in a few vector
    accumulators), whose rounding errors walk as sqrt(n) ulps; four such
    walks move the coefficients, and the combine itself rounds a few times
    (2^-24 each)."""
    return 2.0 ** -24 * (8 + 4 * math.sqrt(n))


def one_call_profile(torch, fn) -> tuple:
    """(device ms, kernels launched) of one call of ``fn`` after a warm-up
    call, under torch.profiler: the kernels' own time, without the gaps
    between them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    return sum(ms for ms, _, _ in rows), sum(count for _, count, _ in rows)


def phase_adasum(torch, train: dict, step1_params) -> dict:
    """Phase 13: (a) phase 4's recipe through
    ``DistributedAdasumOptimizer(AdamW)`` and ``DistributedTrainStep(
    op=None)``, its losses against phase 4's, the flash launches, step
    time, peak memory and the delta machinery's device time against its
    bytes; (b) Adasum's combine over the model's 98 gradients from two
    seeded batches (``adasum_tree`` of two rows per tensor, the function
    the cross level runs) against the same call on the CPU in fp32, its
    bitwise symmetry, device time, bound and launches; (c) an untied
    32000 x 2048 fp32 embedding's gradient (computed once) through
    ``DistributedOptimizer(SGD, sparse_params={"embedding": 6144})``
    against the dense exchange, bit for bit, both timed, and whether the
    sparse path synced with the host."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import adasum as A
    from horovod_tpu_torch.optim.optimizer import distributed_gradients

    from horovod_tpu_torch.models.transformer import TransformerLM

    hvd.init()
    dev = hvd.device()
    out = {}

    # (a) the recipe through the delta form; the seeded initial weights on
    # the host first, and the parameters after the first step
    start = flat_params(torch, TransformerLM(
        full_config(torch, "flash"), device=dev,
        generator=torch.Generator(device=dev).manual_seed(SEED)))
    torch.cuda.empty_cache()
    firsts = []
    r = recipe(torch, hvd, adasum=True,
               on_step=lambda i, m: firsts.append(flat_params(torch, m))
               if i == 0 else None)
    model, opt, counts = r["model"], r["opt"], r["counts"]
    losses, steps = r["losses"], len(r["losses"])
    want = start + (step1_params - start)
    first_exact = torch.equal(firsts[0], want)
    moved = int((firsts[0] != step1_params).sum())
    del start, want, firsts
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, train["losses"]))
    steady = statistics.median(r["times"][1:])
    log(f"adasum (a) [{CARD}]: parameters after step 1 equal start + "
        f"(local - start) of phase 4's step bit for bit: {first_exact}; "
        f"{moved} of {step1_params.numel()} differ from phase 4's "
        f"({100 * moved / step1_params.numel():.2f} %)")
    log(f"adasum (a) [{CARD}]: losses {losses} vs phase 4's "
        f"{train['losses']}: max rel {rel:.3e} (tol {ADASUM_LOSS_TOL}), "
        f"bit-exact: {losses == train['losses']}")
    check_flash_launches(counts, steps, "adasum (a)")
    log(f"adasum (a) [{CARD}]: launches a step "
        f"{ {k: counts[k] / steps for k in TRANSFORMER_KERNELS} }")
    if not first_exact or losses[0] != train["losses"][0]:
        raise AssertionError("the delta form's first step is not phase 4's")
    if rel > ADASUM_LOSS_TOL or not all(math.isfinite(x) for x in losses):
        raise AssertionError("the delta form and phase 4 disagree")
    params, start = opt._params, opt._start
    n_bytes = sum(p.numel() * p.element_size() for p in params)

    @torch.no_grad()
    def delta_only():
        # stash, subtract, add: p -> 0 -> p, exactly
        torch._foreach_copy_(start, params)
        torch._foreach_sub_(params, start)
        torch._foreach_add_(params, start)

    # CUDA events: three launches of a few multi-tensor kernels each, ~9 ms
    # of device work that the host's launches run well ahead of
    delta_ms = cuda_ms(torch, delta_only, iters=10, warmup=2)
    delta_bound, _ = bound_ms(8 * n_bytes, 0)
    log(f"adasum (a) [{CARD}]: step {steady * 1e3:.1f} ms (phase 4 "
        f"{train['step_ms']:.1f} ms in this call), peak "
        f"{r['peak'] / 2**30:.2f} GiB (phase 4 {train['peak_gib']:.2f}); "
        f"stash + subtract + add {delta_ms:.3f} ms (CUDA events) for "
        f"{8 * n_bytes / 1e9:.2f} GB (bound {delta_bound:.3f} ms, "
        f"{100 * delta_bound / delta_ms:.1f} % of it)")
    out["a"] = dict(losses=losses, max_rel=rel,
                    bit_exact=losses == train["losses"],
                    step1_exact=first_exact, step1_moved=moved,
                    step_ms=steady * 1e3, phase4_step_ms=train["step_ms"],
                    peak_gib=r["peak"] / 2**30,
                    phase4_peak_gib=train["peak_gib"],
                    launches_a_step={k: counts[k] / steps
                                     for k in TRANSFORMER_KERNELS},
                    delta_ms=delta_ms, delta_bound_ms=delta_bound,
                    delta_gb=8 * n_bytes / 1e9)

    # (b) the combine at full width
    loss_fn, cfg = r["loss_fn"], r["cfg"]
    model.zero_grad(set_to_none=True)
    sets = []
    for seed in COMBINE_SEEDS:
        tokens = torch.randint(0, cfg.vocab_size,
                               (FULL["batch"], FULL["seq"] + 1),
                               generator=torch.Generator().manual_seed(seed))
        loss = loss_fn(model, tokens.to(dev))
        sets.append([g.detach() for g in
                     no_hook_grads(torch, model, loss).values()])
        del loss
    del r, opt, params, start
    ga, gb = sets
    combine = lambda: [A.adasum_tree([a, b])  # noqa: E731
                       for a, b in zip(ga, gb)]
    got = combine()
    sym = all(torch.equal(x, A.adasum_pair(b, a))
              for x, a, b in zip(got, ga, gb))
    got = [x.cpu() for x in got]
    worst, worst_name = -1.0, None
    for i, (x, a, b) in enumerate(zip(got, ga, gb)):
        want = A.adasum_tree([a.cpu(), b.cpu()])
        err = float((x - want).norm() / want.norm().clamp_min(1e-30))
        if err / combine_tol(x.numel()) > worst:
            worst, worst_name = err / combine_tol(x.numel()), (i, err)
        if err > combine_tol(x.numel()):
            raise AssertionError(f"combine tensor {i} ({x.numel()} values):"
                                 f" {err:.3e} normwise from the CPU's, over "
                                 f"{combine_tol(x.numel()):.3e}")
    del got
    set_bytes = sum(g.numel() * g.element_size() for g in ga)
    comb_ms = cuda_ms(torch, combine, iters=5, warmup=1)
    comb_device_ms, comb_launches = one_call_profile(torch, combine)
    comb_bound, _ = bound_ms(5 * set_bytes, 0)
    log(f"adasum (b) [{CARD}]: {len(ga)} tensors, "
        f"{set_bytes / 1e9:.2f} GB a set; against the CPU in fp32 within "
        f"each tensor's limit (worst {worst:.3f} of its limit: tensor "
        f"{worst_name[0]}, {worst_name[1]:.3e} normwise); bitwise "
        f"symmetric: {sym}; {comb_ms:.3f} ms between CUDA events, "
        f"{comb_device_ms:.3f} ms of kernels (profiler, one call), for "
        f"{5 * set_bytes / 1e9:.2f} GB (bound {comb_bound:.3f} ms, "
        f"{100 * comb_bound / comb_device_ms:.1f} % of the kernels' time), "
        f"{comb_launches} launches a combine "
        f"({comb_launches / len(ga):.1f} a tensor)")
    if not sym:
        raise AssertionError("adasum_pair(a, b) != adasum_pair(b, a)")
    out["b"] = dict(tensors=len(ga), set_gb=set_bytes / 1e9,
                    worst_share_of_limit=worst, symmetric=sym,
                    ms=comb_ms, device_ms=comb_device_ms,
                    bound_ms=comb_bound, launches=comb_launches)
    del sets, ga, gb, model
    torch.cuda.empty_cache()

    # (c) the row-sparse exchange at the LM's table
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tokens = torch.randint(0, SPARSE_TABLE[0],
                           (FULL["batch"], FULL["seq"]),
                           generator=torch.Generator().manual_seed(SEED))
    tokens = tokens.to(dev)
    weight0 = torch.randn(SPARSE_TABLE, generator=gen, device=dev) * 0.02
    # one gradient for both exchanges (the embedding's backward is computed
    # once), handed to each wrapper as a gradient that no hook saw
    leaf = weight0.clone().requires_grad_(True)
    g0, = torch.autograd.grad(torch.nn.functional.embedding(
        tokens, leaf).square().mean(), leaf)
    del leaf
    results, grads = {}, {}
    for name, sparse in (("dense", None),
                         ("sparse", {"embedding": SPARSE_MAX_ROWS})):
        table = torch.nn.Embedding(*SPARSE_TABLE, device=dev)
        with torch.no_grad():
            table.weight.copy_(weight0)
        model = torch.nn.ModuleDict({"embedding": table})
        sgd = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=1.0),
            named_parameters=model.named_parameters(), sparse_params=sparse)
        table.weight.grad = g0.clone()
        sgd.synchronize()
        grads[name] = table.weight.grad.clone()
        sgd.step()
        results[name] = table.weight.detach().clone()
        del model, sgd, table
    touched = int(torch.unique(tokens).numel())
    exact = torch.equal(grads["dense"], grads["sparse"]) and \
        torch.equal(results["dense"], results["sparse"])
    g = grads["dense"]

    def dense_exchange():
        distributed_gradients([g.clone()])

    def sparse_exchange():
        distributed_gradients({"embedding.weight": g.clone()},
                              sparse_params={"embedding": SPARSE_MAX_ROWS})

    dense_ms = cuda_ms(torch, dense_exchange)
    sparse_ms = cuda_ms(torch, sparse_exchange)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sparse_exchange()
        synced = False
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        synced = True
        log(f"adasum (c): the sparse path synced: {str(e)[:300]}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"adasum (c) [{CARD}]: {SPARSE_TABLE[0]} x {SPARSE_TABLE[1]} fp32 "
        f"table, {touched} rows touched, max_rows {SPARSE_MAX_ROWS}: sparse "
        f"vs dense gradient and SGD step bit-exact: {exact}; exchange "
        f"{sparse_ms:.3f} ms sparse vs {dense_ms:.3f} ms dense (CUDA "
        f"events, each with its gradient copy); the sparse path synced "
        f"with the host: {synced}")
    if not exact:
        raise AssertionError("the sparse and dense exchanges disagree")
    out["c"] = dict(touched_rows=touched, bit_exact=exact,
                    sparse_ms=sparse_ms, dense_ms=dense_ms,
                    host_sync=synced)
    del grads, results, g, g0, weight0
    hvd.shutdown()
    return out


def phase_elastic(torch, train: dict) -> dict:
    """Phase 16 (a): phase 4's recipe under ``hvd.elastic.run`` with a
    ``TorchState`` over the model and AdamW, a commit after each step.
    After commit 3, step 4 runs and the training function raises
    ``HorovodInternalError`` before committing it: ``run`` restores commit
    3, resets the runtime (a new NCCL world of one), rebuilds the
    optimizer's wrapper and the step in the reset callback, and runs
    steps 4 and 5 again.  The five committed losses must be phase 4's
    bit for bit, and the restored parameters and AdamW state commit 3's
    snapshot; each flash kernel launches 16 times and ``fused_scale`` 132
    times a step run.  Returns the summary."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.elastic import state as ES
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.ops import kernels as K

    hvd.init()
    dev = hvd.device()
    cfg = full_config(torch, "flash")
    model = TransformerLM(cfg, device=dev,
                          generator=torch.Generator(device=dev)
                          .manual_seed(SEED))
    adamw = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4)
    tokens = torch.randint(0, cfg.vocab_size,
                           (FULL["batch"], FULL["seq"] + 1),
                           generator=torch.Generator().manual_seed(SEED))
    parts: dict = {}

    def build():
        """This world's wrapper and step, as phase 4 builds them (the
        reset callback builds them again for the new world)."""
        opt = hvd.DistributedOptimizer(adamw, gradient_predivide_factor=2.0)
        step = hvd.DistributedTrainStep(lambda m, b: lm_loss(m, b), opt,
                                        op=hvd.Average)
        m, opt = step.init(model)
        if m is not model:
            raise AssertionError("init replaced the model")
        parts.update(step=step, opt=opt, batch=step.shard_batch(tokens))

    def same_as_snapshot(label: str) -> None:
        """The live parameters and AdamW state equal the committed host
        snapshot bit for bit."""
        live = {"model": model.state_dict(), "optimizer": adamw.state_dict()}
        snap = dict(ES._tensor_paths(state._snapshot))
        got = dict(ES._tensor_paths(live))
        if got.keys() != snap.keys():
            raise AssertionError(f"{label}: the snapshot's tensors differ")
        bad = [k for k, t in got.items()
               if not torch.equal(t, snap[k].to(t.device, non_blocking=True))]
        if bad:
            raise AssertionError(f"{label}: {len(bad)} tensors differ from "
                                 f"the snapshot, e.g. {bad[:3]}")

    state = hvd.elastic.TorchState(model, adamw, step=0)
    marks: dict = {"commit_s": [], "losses": {}, "raised": False}

    def on_reset():
        marks["restored_check_s"] = time.perf_counter()
        same_as_snapshot("restored")
        marks["restored_check_s"] = time.perf_counter() - \
            marks["restored_check_s"]
        marks["restore_s"] = state.last_restore_s
        build()

    state.register_reset_callbacks([on_reset])
    build()
    K.reset_launch_counts()
    runs = []

    @hvd.elastic.run
    def training(state):
        while state.step < 5:
            step, opt, batch = parts["step"], parts["opt"], parts["batch"]
            _, _, loss = step(model, opt, batch)
            loss = float(loss)                       # synchronises
            runs.append(state.step + 1)
            if "t_fail" in marks and "reset_to_first_step_s" not in marks:
                marks["reset_to_first_step_s"] = \
                    time.perf_counter() - marks["t_fail"]
            state.step += 1
            if state.step == 4 and not marks["raised"]:
                marks["raised"] = True
                marks["t_fail"] = time.perf_counter()
                raise hvd.HorovodInternalError("a peer died (rehearsed)")
            marks["losses"][state.step] = loss
            state.commit()
            marks["commit_s"].append(
                (state.last_commit_s, state.last_commit_bytes))
            if state.step == 3:
                same_as_snapshot("commit 3")

    training(state)
    counts = K.launch_counts()
    losses = [marks["losses"][k] for k in range(1, 6)]
    log(f"elastic: committed losses {losses} vs phase 4's "
        f"{train['losses']}, bit-exact {losses == train['losses']}; "
        f"steps run {runs}")
    if losses != train["losses"]:
        raise AssertionError("the interrupted elastic run and phase 4 "
                             "disagree")
    steps = len(runs)
    check_flash_launches(counts, steps, "elastic")
    # a prescale and a postscale of each of phase 4's buckets a step
    if counts["fused_scale"] != 2 * train["buckets"] * steps:
        raise AssertionError(f"elastic: {counts['fused_scale']} fused_scale "
                             f"launches over {steps} steps, want "
                             f"{2 * train['buckets'] * steps}")
    (first_s, nbytes), rest = marks["commit_s"][0], marks["commit_s"][1:]
    steady = sorted(s for s, _ in rest)[len(rest) // 2]
    out = dict(losses=losses, steps_run=runs, commit_bytes=nbytes,
               first_commit_s=first_s, commit_s=steady,
               commit_gb_per_s=nbytes / steady / 1e9,
               restore_s=marks["restore_s"],
               restore_gb_per_s=nbytes / marks["restore_s"] / 1e9,
               reset_s=ES.last_reset_s,
               reset_to_first_step_s=marks["reset_to_first_step_s"],
               restored_check_s=marks["restored_check_s"],
               launches={k: counts[k] for k in TRANSFORMER_KERNELS})
    log(f"elastic: commit {nbytes / 1e9:.2f} GB in {steady:.3f} s "
        f"({out['commit_gb_per_s']:.1f} GB/s; the first, with the pinned "
        f"buffers' allocation, {first_s:.3f} s), restore "
        f"{out['restore_s']:.3f} s ({out['restore_gb_per_s']:.1f} GB/s), "
        f"reset {ES.last_reset_s:.3f} s, failure to the next step's end "
        f"{out['reset_to_first_step_s']:.3f} s [{CARD}]")
    del parts, state, model, adamw
    hvd.shutdown()
    return out


def phase_pipeline(torch, train: dict, first) -> dict:
    """Phase 16 (b): the 870.9M model's 16 blocks through
    ``interleaved_1f1b`` on a pp group of one, four chunks of four blocks
    (v = 4), the batch of 6 as six microbatches of one sequence; the
    embedding and the head outside the pipe; AdamW, 3 steps.  The first
    loss within 1e-3 relative of phase 4's (the microbatches' sum order
    differs), the first step's gradients within 2e-2 normwise of phase
    4's (``first``), ``gpipe`` (v = 1, one chunk of 16 blocks) the same
    first loss as v = 4 bit for bit, and 96 launches of each flash
    kernel a step.  Returns the summary."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.stages import lm_chunks, pipeline_lm_loss
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.ops import kernels as K

    hvd.init()
    dev = hvd.device()
    cfg = full_config(torch, "flash")
    model = TransformerLM(cfg, device=dev,
                          generator=torch.Generator(device=dev)
                          .manual_seed(SEED))
    batch = torch.randint(0, cfg.vocab_size,
                          (FULL["batch"], FULL["seq"] + 1),
                          generator=torch.Generator().manual_seed(SEED)
                          ).to(dev)
    m = FULL["batch"]
    chunks = lm_chunks(model, None, 4)
    with torch.no_grad():
        by_v = {v: float(pipeline_lm_loss(model, batch, lm_chunks(
            model, None, v), m)) for v in (1, 4)}
    log(f"pipeline: first loss gpipe (v = 1) {by_v[1]!r}, interleaved "
        f"(v = 4) {by_v[4]!r}, bit-exact {by_v[1] == by_v[4]}")
    if by_v[1] != by_v[4]:
        raise AssertionError("gpipe and the interleaved schedule disagree")
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    losses, times, grads = [], [], None
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = pipeline_lm_loss(model, batch, chunks, m)
        loss.backward()
        if i == 0:
            grads = flat_grads(torch, model)
        opt.step()
        losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check_flash_launches(counts, 3 * m, "pipeline")
    rel = abs(losses[0] - train["losses"][0]) / abs(train["losses"][0])
    grad_rel = float((grads - first[1]).norm() / first[1].norm())
    steady = sorted(times[1:])[len(times[1:]) // 2]
    log(f"pipeline: losses {losses}; first vs phase 4's "
        f"{train['losses'][0]!r}: rel {rel:.3e} (tol 1e-3); first-step "
        f"gradients rel L2 {grad_rel:.3e} (tol 2e-2); step "
        f"{steady * 1e3:.1f} ms (phase 4's {train['step_ms']:.1f} ms), "
        f"peak memory {peak / 2**30:.2f} GiB [{CARD}]")
    if not (rel <= 1e-3 and grad_rel <= 2e-2):
        raise AssertionError("the pipeline and phase 4 disagree")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("non-finite pipeline loss")
    del model, opt, chunks, grads
    hvd.shutdown()
    return dict(losses=losses, first_loss_rel=rel, grad_rel=grad_rel,
                gpipe_equals_v4=by_v[1] == by_v[4], step_ms=steady * 1e3,
                phase4_step_ms=train["step_ms"], peak_gib=peak / 2**30,
                launches={k: counts[k] for k in FLASH_KERNELS})


# phase 18: the remat tiers run 3 steps each; the planner's budget lies
# halfway between none's and full's measured peaks
REMAT_TIERS = ("none", "dots", "full", "offload")
REMAT_STEPS = 3


def remat_tier(torch, hvd, tier, env_policy: bool = False) -> dict:
    """Phase 4's recipe under one remat tier (the model's
    ``remat_policy``; with ``env_policy`` through ``HOROVOD_REMAT_POLICY``
    instead), ``REMAT_STEPS`` steps: losses, step seconds, peak memory,
    the state resident after a step (parameters, gradients, AdamW's state,
    the exchange's buffers), flash launches a step, the offload tier's
    host bytes; then one more forward, whose resident growth is the
    activations the tier keeps for backward (the saved tensors, the
    logits and the loss); and the model, optimizer, step and batch."""
    from horovod_tpu_torch.memory.remat import OffloadStats
    from horovod_tpu_torch.ops import kernels as K

    OffloadStats.reset()
    if env_policy:
        os.environ["HOROVOD_REMAT_POLICY"] = tier
    try:
        r = recipe(torch, hvd, steps=REMAT_STEPS,
                   remat_policy=None if env_policy else tier)
    finally:
        os.environ.pop("HOROVOD_REMAT_POLICY", None)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    host = (OffloadStats.d2h_bytes, OffloadStats.h2d_bytes)
    state = torch.cuda.memory_allocated()
    if env_policy:
        os.environ["HOROVOD_REMAT_POLICY"] = tier
    try:
        loss = r["loss_fn"](r["model"], r["batch"])
        torch.cuda.synchronize()
        activations = torch.cuda.memory_allocated() - state
        del loss
    finally:
        os.environ.pop("HOROVOD_REMAT_POLICY", None)
    out = dict(tier=tier, losses=r["losses"],
               step_ms=statistics.median(r["times"][1:]) * 1e3,
               peak=r["peak"], state=state, activations=activations,
               launches={k: counts[k] / REMAT_STEPS for k in FLASH_KERNELS},
               counts=counts, host_d2h=host[0], host_h2d=host[1],
               param_bytes=sum(p.numel() * p.element_size()
                               for p in r["model"].parameters()),
               step_policy=r["step"].remat_policy)
    out["keep"] = (r["model"], r["opt"], r["step"], r["batch"])
    return out


def phase_memory(torch, train: dict) -> dict:
    """Phase 18, the planning and memory plane on phase 4's recipe (the
    870.9M LM, seq 1024, batch 6, seed, weights, batch, AdamW, predivide
    2.0, the hook path) at a world of one.  (a) ``none``, ``dots``,
    ``full`` and ``offload`` through ``TransformerConfig(remat_policy=)``,
    ``REMAT_STEPS`` steps each: every tier's losses equal ``none``'s bit
    for bit (recompute replays the same kernels on the same inputs), each
    flash forward launches twice a block a step under a remat tier (32,
    against 16) and each backward kernel 16 times; the step time, peak
    memory, the activations a forward keeps for backward and their share
    of ``none``'s beside ``REMAT_ACTIVATION_FRACTION`` (offload's and
    full's below dots', dots' below none's), the step-time overhead beside
    ``REMAT_RECOMPUTE_OVERHEAD``, and the offload tier's host bytes.  (b)
    ``HOROVOD_HBM_BUDGET_BYTES`` halfway between none's and full's
    measured peaks: ``search_memory_plans(["dp=1"])`` with the model's
    parameter bytes, none's activations and its step time must pick a
    tier whose training, through ``HOROVOD_REMAT_POLICY``, peaks under the
    budget; the predicted and measured high-water.  (c)
    ``HostOffloadEngine`` round-trips a copy of AdamW's state after step
    3, bit-exact: GB/s each way (the second of two round trips, once the
    host buffers are pinned), and, timed beside a step alone, a step with
    the copy in flight and the fetch's stall after it (whether the copy
    hid under the step, printed, not asserted).  (d) The card's matmul
    and memory rates (``calibration.measure_rates``) beside the H100
    preset's, the card's memory against the preset's capacity, and
    ``resolve_hardware_model()`` on the card.  Returns the summary."""
    import gc

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import calibration as CAL
    from horovod_tpu_torch.analysis import cost_model as CM
    from horovod_tpu_torch.memory import HostOffloadEngine, search_memory_plans

    hvd.init()
    dev = hvd.device()
    gib = 2 ** 30
    runs = {}
    for tier in REMAT_TIERS:
        run = remat_tier(torch, hvd, tier)
        run.pop("keep")
        runs[tier] = run
        gc.collect()
        torch.cuda.empty_cache()
    none = runs["none"]
    counts = {k: sum(r["counts"][k] for r in runs.values())
              for k in FLASH_KERNELS}
    rows = {}
    for tier, run in runs.items():
        share = run["activations"] / none["activations"]
        overhead = run["step_ms"] / none["step_ms"] - 1
        rows[tier] = dict(
            losses=run["losses"], step_ms=run["step_ms"],
            peak_gib=run["peak"] / gib, state_gib=run["state"] / gib,
            activation_gib=run["activations"] / gib,
            flash_launches_a_step=run["launches"],
            activation_share=share,
            model_activation_fraction=CM.REMAT_ACTIVATION_FRACTION[tier],
            overhead=overhead,
            model_recompute_overhead=CM.REMAT_RECOMPUTE_OVERHEAD[tier],
            host_d2h_bytes=run["host_d2h"], host_h2d_bytes=run["host_h2d"])
        log(f"memory (a) {tier}: losses {run['losses']}, step "
            f"{run['step_ms']:.1f} ms (overhead {100 * overhead:.1f} %, "
            f"model {100 * CM.REMAT_RECOMPUTE_OVERHEAD[tier]:.0f} %), peak "
            f"{run['peak'] / gib:.2f} GiB, state after a step "
            f"{run['state'] / gib:.2f} GiB, a forward's activations "
            f"{run['activations'] / gib:.2f} GiB, share {share:.3f} "
            f"(model {CM.REMAT_ACTIVATION_FRACTION[tier]}), flash launches "
            f"a step {run['launches']}, host bytes d2h {run['host_d2h']} "
            f"h2d {run['host_h2d']} [{CARD}]")
        if run["losses"] != none["losses"]:
            raise AssertionError(f"remat {tier}: losses {run['losses']} "
                                 f"differ from none's {none['losses']}")
        fwd = FULL["layers"] * (1 if tier == "none" else 2)
        want = {"flash_fwd": fwd, "flash_bwd_dq": FULL["layers"],
                "flash_bwd_dkv": FULL["layers"]}
        if run["launches"] != want:
            raise AssertionError(f"remat {tier}: flash launches a step "
                                 f"{run['launches']}, want {want}")
    log(f"memory (a): none's losses against phase 4's first "
        f"{REMAT_STEPS}: bit-exact "
        f"{none['losses'] == train['losses'][:REMAT_STEPS]}")
    if runs["offload"]["host_d2h"] == 0:
        raise AssertionError("the offload tier copied nothing to the host")
    act = {t: run["activations"] for t, run in runs.items()}
    if not (act["offload"] < act["dots"] < act["none"]
            and act["full"] < act["dots"]):
        raise AssertionError(f"the tiers' activations {act} are not "
                             f"ordered none > dots > offload, full")

    # (b) the planner under a budget between none's and full's peaks
    budget = (none["peak"] + runs["full"]["peak"]) // 2
    os.environ["HOROVOD_HBM_BUDGET_BYTES"] = str(budget)
    try:
        pick = search_memory_plans(["dp=1"], param_bytes=none["param_bytes"],
                                   activation_bytes=none["activations"],
                                   compute_s=none["step_ms"] / 1e3,
                                   microbatches=(1,), offload=(False,))
        chosen = remat_tier(torch, hvd, pick.remat_policy, env_policy=True)
    finally:
        os.environ.pop("HOROVOD_HBM_BUDGET_BYTES", None)
    model, opt, step, batch = chosen.pop("keep")
    log(f"memory (b): budget {budget / gib:.2f} GiB; the planner picked "
        f"{pick.summary()}; predicted high-water {pick.total_bytes / gib:.2f}"
        f" GiB, measured {chosen['peak'] / gib:.2f} GiB through "
        f"HOROVOD_REMAT_POLICY (the step's policy "
        f"{chosen['step_policy']!r}) [{CARD}]")
    if pick.remat_policy == "none" or chosen["peak"] > budget:
        raise AssertionError("the planner's tier does not fit the budget")
    if chosen["losses"] != none["losses"]:
        raise AssertionError("the planned tier's losses differ from none's")

    # (c) host offload of AdamW's state around a fourth step
    inner = opt.optimizer
    state = {pid: {k: v.clone() for k, v in st.items()}
             for pid, st in inner.state_dict()["state"].items()}
    nbytes = sum(v.numel() * v.element_size() for st in state.values()
                 for v in st.values() if v.is_cuda)
    with HostOffloadEngine(name="adamw", depth=2) as engine:
        # two timed round trips: the first pins the host buffers, which
        # the engine reuses from then on; the second's rates are kept
        for tag in ("pin", "timed"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.offload(tag, state)
            engine.wait(tag)
            d2h_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = engine.fetch(tag, None)
            torch.cuda.synchronize()
            h2d_s = time.perf_counter() - t0
            log(f"memory (c): round trip {tag!r}: D2H {d2h_s:.3f} s, H2D "
                f"{h2d_s:.3f} s")
            # step 4 alone, then step 5 with the copy of step 3's state in
        # flight on the side stream
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(model, opt, batch)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        engine.offload(3, state)
        step(model, opt, batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        stall0 = engine.stall_s
        restored = engine.fetch(3, None)
        torch.cuda.synchronize()
        stall = engine.stall_s - stall0
        fallbacks = engine.fallbacks
    exact = fallbacks == 0 and all(
        torch.equal(restored[pid][k], v) for pid, st in state.items()
        for k, v in st.items())
    hidden = stall < 0.1 * plain_s and step_s < 1.1 * plain_s
    log(f"memory (c): AdamW's state after step 3, {nbytes / 1e9:.3f} GB on "
        f"the card: D2H {d2h_s:.3f} s ({nbytes / d2h_s / 1e9:.2f} GB/s), "
        f"H2D {h2d_s:.3f} s ({nbytes / h2d_s / 1e9:.2f} GB/s); round trip "
        f"bit-exact {exact}; a step {plain_s * 1e3:.1f} ms alone, "
        f"{step_s * 1e3:.1f} ms with the copy in flight, then the fetch "
        f"stalled {stall * 1e3:.1f} ms: the copy "
        f"{'hid' if hidden else 'did not hide'} under the step [{CARD}]")
    if not exact:
        raise AssertionError("the offload round trip is not bit-exact")
    del model, opt, step, batch, state, restored, inner
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the card's rates beside the preset's
    mm, hbm = CAL.measure_rates(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    resolved = CM.resolve_hardware_model()
    log(f"memory (d): bf16 matmul {mm / 1e12:.1f} TFLOP/s (preset "
        f"{CM.H100.peak_flops_per_s / 1e12:.0f}), memory stream "
        f"{hbm / 1e12:.3f} TB/s (preset {CM.H100.hbm_bytes_per_s / 1e12:.2f}"
        f"); total memory {total} B (preset "
        f"{CM.H100.hbm_capacity_bytes}); resolve_hardware_model() -> "
        f"{resolved.name} [{CARD}]")
    if resolved is not CM.H100:
        raise AssertionError(f"the card resolves to {resolved.name}")
    if total != CM.H100.hbm_capacity_bytes:
        raise AssertionError(f"the card reports {total} B, the H100 preset "
                             f"{CM.H100.hbm_capacity_bytes}")
    hvd.shutdown()
    return dict(tiers=rows, budget_gib=budget / gib,
                planned=dict(tier=pick.remat_policy,
                             predicted_gib=pick.total_bytes / gib,
                             measured_gib=chosen["peak"] / gib,
                             step_ms=chosen["step_ms"]),
                offload=dict(bytes=nbytes, d2h_gbs=nbytes / d2h_s / 1e9,
                             h2d_gbs=nbytes / h2d_s / 1e9, exact=exact,
                             step_ms=plain_s * 1e3,
                             step_with_copy_ms=step_s * 1e3,
                             stall_ms=stall * 1e3, hidden=hidden),
                rates=dict(matmul_tflops=mm / 1e12, hbm_tbs=hbm / 1e12,
                           total_memory=total),
                launches=counts)


#: phase 19: the guarded step's schedule after phase 4's five clean steps
#: (a non-finite loss, a spike past the limit, then a clean step), the
#: rollback run's cut model and schedule, and the served load
GUARD_SCALES = (float("nan"), 1e3, 1.0)
GUARD_VERDICTS = ("nonfinite", "spike", "ok")
GNORM_RTOL = 1e-5
ROLLBACK = dict(layers=4, steps=6, every=2, interval=3, nan_at=5)
SERVE = dict(requests=48, lens=(1024, 512), buckets=(1, 2, 4, 8),
             crash_at=3)
FLEET = dict(lm_requests=24, vit_requests=64, lm_wave=3, vit_wave=8,
             vit_buckets=(1, 2, 4, 8, 16, 32), corrupt_at=2)
#: a served batch's logits against the plain path's (the same model and
#: padded batch, ``flash_fwd_plain`` in the kernel's place): a path's
#: output against its twin's, as phase 4 holds the flash path's gradients
#: against the dense path's (5e-2 normwise); each element within one
#: flash call's elementwise limit.  (FLASH_NORM_TOL holds one kernel
#: call; through the LM's 16 bf16 layers one batch of the first card run
#: read 1.005e-2 against it.)
SERVE_NORM_TOL = 5e-2


def _tree_bytes(torch, tree) -> int:
    from horovod_tpu_torch.utils import pytree

    return sum(t.numel() * t.element_size() for t in pytree.leaves(tree)
               if torch.is_tensor(t))


def phase_guard(torch, train: dict) -> dict:
    """Phase 19 (a)-(c), the training-state guard on phase 4's recipe.
    (a) ``TrainingGuard(policy="skip_step", warmup_steps=2)`` through the
    step's ``guard=``: the five clean steps give phase 4's losses bit for
    bit; the norm agrees with ``torch.linalg.vector_norm`` of the reduced
    gradients within GNORM_RTOL; then a non-finite loss and a spike past
    the limit are skipped, the device fingerprints of the parameters and
    of AdamW's state equal to those from before each, and a clean step
    moves them; each flash kernel 16 launches a call and ``fused_scale``
    twice a bucket, every call (the exchange runs before the verdict);
    guarded and unguarded steps timed in turns on the same model.  (b)
    The fingerprint of the parameters and AdamW's state (10.45 GB) on the
    card, against the host's numpy arithmetic over copies of the same
    tensors, bit for bit, both timed.  (c) Rollback-and-replay at the
    870.9M LM's width with ROLLBACK's layers (each checkpoint writes the
    parameters and AdamW's state): ``TorchState`` with a checkpoint every
    2 commits, policy ``rollback``, a replica check every 3 steps; a
    non-finite loss at step 5 raises ``GuardRollback`` before anything
    moves, ``guard.rollback()`` restores the pinned last-good step and the
    loop replays; the final parameters equal a fault-free run's bit for
    bit.  Returns the summary and the launch counts of (a)."""
    import gc

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.guard import TrainingGuard, fingerprint
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.utils import pytree

    hvd.init()
    scale = [1.0]
    guard = TrainingGuard(policy="skip_step", warmup_steps=2)
    r = recipe(torch, hvd, guard=guard, loss_scale=scale)
    model, opt, step, batch = (r[k] for k in ("model", "opt", "step",
                                              "batch"))
    log(f"guard (a): losses {r['losses']} (phase 4's bit for bit: "
        f"{r['losses'] == train['losses']}), norms "
        f"{guard.numerics.last_gnorm}")
    if r["losses"] != train["losses"]:
        raise AssertionError(f"guarded losses {r['losses']} differ from "
                             f"phase 4's {train['losses']}")
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    want = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads])))
    rel = abs(guard.numerics.last_gnorm - want) / want
    log(f"guard (a): norm {guard.numerics.last_gnorm!r} against "
        f"vector_norm of the reduced gradients {want!r}: rel {rel:.3e} "
        f"(tol {GNORM_RTOL})")
    if rel > GNORM_RTOL:
        raise AssertionError("the guarded norm is not the reduced "
                             "gradients' norm")
    del grads

    def state_fp():
        """The parameters' fingerprint and AdamW state's."""
        return (fingerprint(model.state_dict()),
                fingerprint(opt.state_dict()))

    verdicts, unchanged = [], []
    for s in GUARD_SCALES:
        scale[0] = s
        before = state_fp()
        limit = guard.current_limit()
        step(model, opt, batch)
        after = state_fp()
        verdicts.append(guard.numerics.last_verdict)
        unchanged.append(before == after)
        if (before[0] == after[0]) != (before[1] == after[1]):
            raise AssertionError("a step moved the parameters or AdamW's "
                                 "state alone")
        log(f"guard (a): loss scale {s}: norm {guard.numerics.last_gnorm!r}"
            f", limit {limit!r}, verdict {verdicts[-1]}, state unchanged "
            f"{before == after}")
    scale[0] = 1.0
    calls = len(r["losses"]) + len(GUARD_SCALES)
    counts = K.launch_counts()
    buckets = len(opt._buckets)
    want_counts = {"fused_scale": 2 * buckets * calls,
                   **dict.fromkeys(FLASH_KERNELS, FULL["layers"] * calls)}
    got_counts = {k: counts[k] for k in want_counts}
    log(f"guard (a): launches over {calls} calls {got_counts} (want "
        f"{want_counts}: {buckets} buckets)")
    if verdicts != list(GUARD_VERDICTS) or \
            unchanged != [v != "ok" for v in verdicts]:
        raise AssertionError(f"guard verdicts {verdicts}, unchanged "
                             f"{unchanged}")
    if got_counts != want_counts:
        raise AssertionError("guarded step launches differ")

    plain = hvd.DistributedTrainStep(r["loss_fn"], opt)
    times = {"guarded": [], "unguarded": []}
    for name in ("guarded", "unguarded", "unguarded", "guarded",
                 "guarded", "unguarded"):
        run = step if name == "guarded" else plain
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(run(model, opt, batch)[2])
        times[name].append((time.perf_counter() - t0) * 1e3)
    step_ms = {k: statistics.median(v) for k, v in times.items()}
    log(f"guard (a) [{CARD}]: step ms guarded {times['guarded']}, "
        f"unguarded {times['unguarded']} (medians {step_ms})")

    # (b) the fingerprint of the parameters and AdamW's state
    tree = [model.state_dict(), opt.state_dict()]
    nbytes = _tree_bytes(torch, tree)
    device_ms = cuda_ms(torch, lambda: fingerprint(tree), iters=3,
                        warmup=1)
    device_fp = fingerprint(tree)
    t0 = time.perf_counter()
    host_tree = pytree.map_leaves(
        tree, lambda i, t: t.cpu() if torch.is_tensor(t) else t)
    host_fp = fingerprint(host_tree)
    host_s = time.perf_counter() - t0
    log(f"guard (b) [{CARD}]: fingerprint of {nbytes / 1e9:.2f} GB "
        f"(parameters and AdamW state): card {device_ms:.1f} ms "
        f"({nbytes / device_ms / 1e6:.0f} GB/s), host copy + numpy "
        f"{host_s:.1f} s; {device_fp:#x} == {host_fp:#x}: "
        f"{device_fp == host_fp}")
    if device_fp != host_fp:
        raise AssertionError("the card's fingerprint differs from the "
                             "host's")
    del model, opt, step, plain, batch, tree, host_tree, r
    gc.collect()
    torch.cuda.empty_cache()

    rollback = guard_rollback(torch, hvd)
    hvd.shutdown()
    return dict(losses=train["losses"], verdicts=verdicts,
                step_ms=step_ms, gnorm_rel=rel,
                fingerprint=dict(bytes=nbytes, device_ms=device_ms,
                                 host_s=host_s),
                rollback=rollback), got_counts


def guard_rollback(torch, hvd) -> dict:
    """Phase 19 (c) (``phase_guard``): the fault-free run, then the run
    with the non-finite step; the summary."""
    import dataclasses
    import gc

    from horovod_tpu_torch.checkpoint import Checkpointer
    from horovod_tpu_torch.elastic import TorchState
    from horovod_tpu_torch.guard import (
        GuardRollback,
        RollbackManager,
        TrainingGuard,
        fingerprint,
    )
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss

    rb = ROLLBACK
    dev = hvd.device()
    cfg = dataclasses.replace(full_config(torch, "flash"),
                              num_layers=rb["layers"])
    root = tempfile.mkdtemp(prefix="hvd_torch_guard_")

    def run(fault: bool) -> dict:
        model = TransformerLM(cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(SEED))
        adamw = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                  weight_decay=1e-4)
        opt = hvd.DistributedOptimizer(adamw, gradient_predivide_factor=2.0)
        scale = [1.0]
        state = guard = ckpt = None
        if fault:
            ckpt = Checkpointer(os.path.join(root, "ckpt"))
            state = TorchState(model, adamw, checkpointer=ckpt,
                               checkpoint_every=rb["every"])
            guard = TrainingGuard(policy="rollback", warmup_steps=2,
                                  check_interval=rb["interval"],
                                  rollback=RollbackManager(state))
        step = hvd.DistributedTrainStep(
            lambda m, b: lm_loss(m, b) * scale[0], opt, guard=guard)
        model, opt = step.init(model)
        done, fired, events = 0, False, []
        while done < rb["steps"]:
            s = done + 1
            tokens = torch.randint(
                0, cfg.vocab_size, (FULL["batch"], FULL["seq"] + 1),
                generator=torch.Generator().manual_seed(SEED + s))
            scale[0] = float("nan") if fault and s == rb["nan_at"] \
                and not fired else 1.0
            try:
                step(model, opt, step.shard_batch(tokens))
            except GuardRollback as e:
                fired = True
                pinned = ckpt.pinned_steps()
                t0 = time.perf_counter()
                state.wait()
                replayed = guard.rollback(reason="nonfinite")
                torch.cuda.synchronize()
                events.append(dict(step=s, kind=e.kind, pinned=pinned,
                                   replayed=replayed,
                                   restored=state._commit_count,
                                   seconds=time.perf_counter() - t0))
                done = state._commit_count
                continue
            if fault:
                state.commit()
                guard.note_commit()
                guard.check_replicas(s, model.state_dict())
                done = state._commit_count
            else:
                done = s
        if fault:
            state.wait()
        out = dict(fp=fingerprint(model.state_dict()), events=events,
                   checkpoint_bytes=state.last_commit_bytes if fault
                   else None, pinned=ckpt.pinned_steps() if fault else None)
        del model, opt, step, adamw
        gc.collect()
        torch.cuda.empty_cache()
        return out

    try:
        clean = run(False)
        faulty = run(True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ev = faulty["events"]
    log(f"guard (c) [{CARD}]: {rb['layers']} of {FULL['layers']} layers, "
        f"{faulty['checkpoint_bytes'] / 1e9:.2f} GB a commit and "
        f"checkpoint; events {json.dumps(ev)}; final fingerprint "
        f"{faulty['fp']:#x}, fault-free {clean['fp']:#x}; pinned at the "
        f"end {faulty['pinned']}")
    if len(ev) != 1 or ev[0]["kind"] != "nonfinite" or \
            ev[0]["restored"] != ev[0]["pinned"][0] or \
            faulty["fp"] != clean["fp"]:
        raise AssertionError("rollback-and-replay did not give the "
                             "fault-free parameters")
    return dict(events=ev, checkpoint_bytes=faulty["checkpoint_bytes"],
                layers=rb["layers"])


def _last_logits(torch, lm):
    class Served(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lm = lm

        def forward(self, tokens):
            return self.lm(tokens)[:, -1]

    return Served()


def served_agreement(torch, got, want) -> tuple:
    """(normwise, elementwise ratio, argmax rows checked, argmax rows
    equal) of served logits against the plain path's: SERVE_NORM_TOL and
    the flash elementwise limit (FLASH_RTOL·|want| + FLASH_ATOL·rms), and
    the argmax equal wherever the plain top-2 margin exceeds that
    limit."""
    readings = dict((n, v) for n, v, _ in
                    flash_agreement(torch, got, want, False))
    w = want.float()
    top = w.topk(2, dim=-1)
    rms = w.pow(2).mean(-1).sqrt()
    limit = FLASH_RTOL * top.values[:, 0].abs() + FLASH_ATOL * rms
    clear = (top.values[:, 0] - top.values[:, 1]) > limit
    same = got.float().argmax(-1) == top.indices[:, 0]
    return (readings["norm_rel"], readings["elem_ratio"],
            int(clear.sum()), int((same & clear).sum()))


def _check_batches(torch, records, reference, label: str, dev) -> dict:
    """Each recorded batch (payloads, results, bucket) against
    ``reference(padded_batch on dev, record)``: the worst readings."""
    worst = [0.0, 0.0, 0, 0]
    for rec in records:
        pads = rec["payloads"] + [rec["payloads"][-1]] * (
            rec["padded"] - len(rec["payloads"]))
        with torch.inference_mode():
            want = reference(torch.stack(pads).to(dev), rec)
        got = torch.stack(rec["results"])
        norm, elem, checked, equal = served_agreement(
            torch, got, want[:len(rec["results"])])
        worst = [max(worst[0], norm), max(worst[1], elem),
                 worst[2] + checked, worst[3] + equal]
    log(f"serve {label}: {len(records)} batches against the plain path: "
        f"worst normwise {worst[0]:.3e} (tol {SERVE_NORM_TOL}), worst "
        f"elementwise ratio {worst[1]:.3f} (tol 1), argmax equal in "
        f"{worst[3]} of the {worst[2]} rows whose margin clears the limit")
    if worst[0] > SERVE_NORM_TOL or worst[1] > 1.0 or worst[2] != worst[3]:
        raise AssertionError(f"served {label} results outside the limits")
    return dict(norm_rel=worst[0], elem_ratio=worst[1],
                argmax_rows=worst[2])


def _latencies(responses) -> dict:
    lat = sorted(r.latency_s for r in responses)
    return dict(p50_ms=1e3 * lat[len(lat) // 2],
                p99_ms=1e3 * lat[min(len(lat) - 1,
                                     int(0.99 * (len(lat) - 1) + 0.5))])


def phase_serve(torch) -> tuple:
    """Phase 19 (d)-(e), the serving plane on one card.  (d) The 870.9M LM
    at full width behind a ``ReplicaPool`` of two in-process replicas and
    a ``ContinuousBatcher`` over ``ExecutableCache.from_module``'s graph
    executors (buckets SERVE["buckets"], every bucket built, its graph
    captured, before the load): 48 seeded
    requests of 1024 and 512 tokens (two signatures), a result the last
    position's logits, a ``serve.batch`` crash on a replica mid-load.
    Every request answered exactly once, the crashed lease requeued once;
    each batch within SERVE_NORM_TOL and the flash elementwise limit of
    the plain path's forward of the same padded batch (``flash_fwd_plain``
    in the kernel's place); 16 flash-forward launches a batch, replayed
    (a replay counts the launches its capture recorded).  (e) A
    ``FleetBatcher`` over the LM and ViT-B/16 (224 px, buckets up to 32,
    12 non-causal flash forwards a batch); a ``WeightRefresher`` staging
    through ``HostOffloadEngine`` flips the LM's weights mid-load, and a
    second stage, corrupted by a ``serve.refresh`` fault, is caught by the
    fingerprint verify, rolled back and quarantined; every response
    carries the fingerprint of the weights its batch ran on, and each
    batch equals, bit for bit, a forward of its padded batch on those
    weights.  Returns the summary and the flash launches."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import faults
    from horovod_tpu_torch.guard import fingerprint
    from horovod_tpu_torch.memory import HostOffloadEngine
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.models.vit import ViT_B16
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.serve import (
        AdmissionQueue,
        ContinuousBatcher,
        ExecutableCache,
        FleetBatcher,
        InferenceRequest,
        MultiTenantQueue,
        Replica,
        ReplicaPool,
        WeightRefresher,
    )

    hvd.init()
    dev = hvd.device()

    def launched() -> int:
        return K.launch_counts()["flash_fwd"]

    first = launched()
    cfg = full_config(torch, "flash")
    lm = TransformerLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    served = _last_logits(torch, lm)
    layers = FULL["layers"]

    def tokens_example(signature, padded):
        return torch.zeros((padded,) + tuple(signature[0]),
                           dtype=torch.long)

    def plain_lm(x, rec):
        with _plain_flash():
            return served(x)

    # (d) two replicas over one executable cache, a crash mid-load
    cache = ExecutableCache.from_module(served, tokens_example,
                                        bucket_sizes=SERVE["buckets"])
    t0 = time.perf_counter()
    start = launched()
    for n in SERVE["lens"]:
        for b in SERVE["buckets"]:
            cache.get(((n,), "torch.int64"), b)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = launched() - start
    built = dict(captures=cache.graphs.misses, hits=cache.graphs.hits)
    records = []

    def run(payloads):
        results = cache.run(payloads)
        records.append(dict(payloads=list(payloads), results=results,
                            padded=cache.padded_size(len(payloads))))
        return results

    queue = AdmissionQueue(depth=64, max_requeues=3)
    pool = ReplicaPool(queue, drain_timeout_s=5.0)
    for i in range(2):
        pool.add_replica(Replica(f"lm-{i}", run, host=f"card-{i}"))
    got = {}
    batcher = ContinuousBatcher(
        queue, pool, max_batch=max(SERVE["buckets"]),
        on_response=lambda r: got.setdefault(r.request_id, []).append(r))
    gen = torch.Generator().manual_seed(SEED + 19)
    reqs = [InferenceRequest(f"lm-{i:02d}", torch.randint(
        0, cfg.vocab_size, (SERVE["lens"][i % 2],), generator=gen))
        for i in range(SERVE["requests"])]
    start, misses0 = launched(), cache.graphs.misses
    hits0 = cache.graphs.hits
    faults.set_plan(faults.FaultPlan(sim=True).add(
        "serve.batch", "crash", at=SERVE["crash_at"]))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in reqs:
            if queue.submit(r) != "admitted":
                raise AssertionError(f"request {r.request_id} shed")
        while len(queue):
            batcher.step()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        faults.clear_plan()
    launches = launched() - start
    loaded = dict(captures=cache.graphs.misses - misses0,
                  replays=cache.graphs.hits - hits0)
    responses = [rs[0] for rs in got.values()]
    requeued = sorted(r.request_id for r in responses if r.requeues)
    dead = [r.name for r in pool.replicas() if not r.alive]
    occupancy = statistics.mean(len(rec["payloads"]) for rec in records)
    lm_serve = dict(requests_per_s=len(reqs) / load_s, load_s=load_s,
                    batches=len(records), occupancy=occupancy,
                    requeued=len(requeued), dead=dead, build_s=build_s,
                    flash_launches=launches, graphs=dict(
                        build=built, load=loaded),
                    **_latencies(responses))
    log(f"serve (d) [{CARD}]: {len(reqs)} requests of {SERVE['lens']} "
        f"tokens in {load_s:.3f} s ({lm_serve['requests_per_s']:.1f} "
        f"requests/s), p50 {lm_serve['p50_ms']:.1f} ms, p99 "
        f"{lm_serve['p99_ms']:.1f} ms, {len(records)} batches, mean "
        f"occupancy {occupancy:.2f}; replica dead {dead}, requeued "
        f"{len(requeued)} {requeued}; flash forwards {launches} "
        f"({launches / max(len(records), 1):.1f} a batch); the "
        f"{len(cache)} executables built in {build_s:.2f} s "
        f"({build_launches} flash forwards); graphs: build {built}, load "
        f"{loaded}")
    if sorted(got) != sorted(r.request_id for r in reqs) or \
            any(len(v) != 1 for v in got.values()):
        raise AssertionError("a request was lost or answered twice")
    if len(dead) != 1 or not requeued or \
            any(r.requeues != 1 for r in responses if r.requeues):
        raise AssertionError("the crash did not requeue its lease once")
    # each bucket's build runs one forward eagerly (the capture's warm-up)
    # and records one in its graph; the load only replays
    if launches != layers * len(records) or \
            build_launches != layers * len(cache) or \
            built["captures"] != len(cache) or loaded["captures"] != 0:
        raise AssertionError("served flash forwards are not 16 a batch")
    lm_serve["agreement"] = _check_batches(torch, records, plain_lm, "(d)",
                                           dev)

    # (e) the fleet: the LM and ViT-B/16, a weight flip and a corrupt one
    vit = ViT_B16(dtype=torch.bfloat16, attention_impl="flash", device=dev,
                  image_size=VIT["image"],
                  generator=torch.Generator(device=dev).manual_seed(SEED))
    vit_layers = VIT["layers"]
    px = VIT["image"]

    def image_example(signature, padded):
        return torch.zeros((padded,) + tuple(signature[0]))

    caches = {"lm": cache,
              "vit": ExecutableCache.from_module(
                  vit, image_example, bucket_sizes=FLEET["vit_buckets"])}
    for b in FLEET["vit_buckets"]:
        caches["vit"].get(((px, px, 3), "torch.float32"), b)
    fleet_records = []

    def fleet_run(payloads, model_id=None, weights=None):
        results = caches[model_id].run(payloads, weights=weights)
        fleet_records.append(dict(
            model=model_id, payloads=list(payloads), results=results,
            weights=weights,
            padded=caches[model_id].padded_size(len(payloads))))
        return results

    engine = HostOffloadEngine(name="refresh")
    refresher = WeightRefresher(engine=engine)
    old = {k: v for k, v in served.state_dict().items()}
    fp_of = {id(old): refresher.register("lm", old)}
    fleet = MultiTenantQueue()
    fleet.add_model("lm", weight=2.0, slo_class="batch", depth=64)
    fleet.add_model("vit", weight=1.0, slo_class="batch", depth=64)
    fpool = ReplicaPool(fleet, drain_timeout_s=5.0)
    for i in range(2):
        fpool.add_replica(Replica(f"fleet-{i}", fleet_run, host=f"card-{i}"))
    fgot = {}
    fbatcher = FleetBatcher(
        fleet, fpool, refresher=refresher, max_batch=32,
        on_response=lambda r: fgot.setdefault(r.request_id, []).append(r))
    gen = torch.Generator().manual_seed(SEED + 20)
    freqs_lm = [InferenceRequest(f"lm-{i:02d}", torch.randint(
        0, cfg.vocab_size, (SERVE["lens"][0],), generator=gen),
        model_id="lm") for i in range(FLEET["lm_requests"])]
    freqs_vit = [InferenceRequest(f"vit-{i:02d}", torch.rand(
        (px, px, 3), generator=gen), model_id="vit")
        for i in range(FLEET["vit_requests"])]
    freqs = freqs_lm + freqs_vit
    flips = []
    real_flip = refresher.maybe_flip

    def timed_flip(model_id):
        pending = refresher.pending(model_id)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = real_flip(model_id)
        torch.cuda.synchronize()
        if pending:
            flips.append(dict(model=model_id, committed=done,
                              ms=(time.perf_counter() - t0) * 1e3))
        return done

    refresher.maybe_flip = timed_flip
    stages = []

    def stage(version: int):
        g = torch.Generator(device=dev).manual_seed(SEED + 100 + version)
        new = {k: (v + 1e-3 * torch.randn(v.shape, generator=g, device=dev,
                                          dtype=v.dtype)
                   if v.is_floating_point() else v.clone())
               for k, v in old.items()}
        nbytes = _tree_bytes(torch, new)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tag = refresher.stage("lm", new, tag=f"lm-v{version}")
        torch.cuda.synchronize()
        stages.append(dict(tag=tag, bytes=nbytes,
                           seconds=time.perf_counter() - t0))
        return new

    start = launched()
    misses0 = {m: c.graphs.misses for m, c in caches.items()}
    faults.set_plan(faults.FaultPlan(seed=SEED).add(
        "serve.refresh", "corrupt", at=FLEET["corrupt_at"], arg=1.0))
    try:
        # open-loop arrivals: a wave of each tenant's requests before each
        # engine step, so the LM runs several small batches
        waves = [freqs_lm[i:i + FLEET["lm_wave"]] +
                 freqs_vit[j:j + FLEET["vit_wave"]]
                 for i, j in zip(range(0, len(freqs_lm), FLEET["lm_wave"]),
                                 range(0, len(freqs_vit),
                                       FLEET["vit_wave"]))]
        lm_batches, staged = 0, None
        while waves or len(fleet):
            for r in (waves.pop(0) if waves else []):
                if fleet.submit(r) != "admitted":
                    raise AssertionError(f"request {r.request_id} shed")
            resp = fbatcher.step()
            active, active_fp = refresher.active("lm")
            fp_of.setdefault(id(active), active_fp)
            if resp and resp[0].model_id == "lm":
                lm_batches += 1
                if lm_batches == 1:
                    staged = stage(1)
                elif lm_batches == 2:
                    stage(2)
        torch.cuda.synchronize()
    finally:
        faults.clear_plan()
        engine.close()
    fleet_launches = launched() - start
    fleet_graphs = {m: dict(captures=c.graphs.misses - misses0[m],
                            held=len(c.graphs)) for m, c in caches.items()}
    by_model = {m: [rec for rec in fleet_records if rec["model"] == m]
                for m in ("lm", "vit")}
    fresponses = {rid: rs for rid, rs in fgot.items()}
    fps_seen = sorted({rs[0].weights_fp for rid, rs in fresponses.items()
                       if rid.startswith("lm")})
    log(f"serve (e) [{CARD}]: {len(freqs)} requests, batches "
        f"{ {m: len(v) for m, v in by_model.items()} }, flips "
        f"{refresher.flips}, rollbacks {refresher.rollbacks}, quarantined "
        f"{refresher.quarantined}; the LM's responses carried "
        f"{[hex(f) for f in fps_seen]}; stages "
        f"{[(s['tag'], round(s['bytes'] / s['seconds'] / 1e9, 2)) for s in stages]}"
        f" GB/s a round trip through the engine; flips {flips}; flash "
        f"forwards {fleet_launches}; graphs {fleet_graphs}")
    if sorted(fresponses) != sorted(r.request_id for r in freqs) or \
            any(len(v) != 1 for v in fresponses.values()):
        raise AssertionError("a fleet request was lost or answered twice")
    if refresher.flips != 1 or refresher.rollbacks != 1 or \
            refresher.quarantined != [("lm", stages[1]["tag"])]:
        raise AssertionError("the flip and the corrupt stage's rollback "
                             "did not happen as staged")
    if len(fps_seen) != 2 or refresher.fingerprint_of("lm") != \
            fingerprint(staged):
        raise AssertionError("the LM's responses do not carry the old and "
                             "the flipped weights' fingerprints")
    # the batches' forwards are replays; a capture with weights met for
    # the first time (the LM's first weights, the flip) adds its warm-up;
    # a flip drops the old weights' graphs, so the LM's cache holds at
    # most one graph a bucket
    want = layers * len(by_model["lm"]) + vit_layers * len(by_model["vit"])
    warm = layers * fleet_graphs["lm"]["captures"] + \
        vit_layers * fleet_graphs["vit"]["captures"]
    if fleet_launches != want + warm or \
            fleet_graphs["lm"]["captures"] < 2 or \
            fleet_graphs["lm"]["held"] > len(SERVE["buckets"]):
        raise AssertionError(f"fleet flash forwards {fleet_launches}, want "
                             f"{want} replayed and {warm} warm-ups; graphs "
                             f"{fleet_graphs}")
    # each LM batch equals its padded batch's forward on the weights it
    # ran on (bit for bit: the same kernels on the same inputs), and each
    # of its responses carries those weights' fingerprint
    carried = {}
    for rec in by_model["lm"]:
        pads = rec["payloads"] + [rec["payloads"][-1]] * (
            rec["padded"] - len(rec["payloads"]))
        with torch.inference_mode():
            again = torch.func.functional_call(
                served, rec["weights"], (torch.stack(pads).to(dev),))
        if not torch.equal(torch.stack(rec["results"]),
                           again[:len(rec["results"])]):
            raise AssertionError("an LM batch differs from a forward on "
                                 "the weights it ran on")
        for p, res in zip(rec["payloads"], rec["results"]):
            carried[id(res)] = fp_of[id(rec["weights"])]
    for rid, rs in fresponses.items():
        if rid.startswith("lm") and carried[id(rs[0].result)] != \
                rs[0].weights_fp:
            raise AssertionError(f"{rid} carries another fingerprint than "
                                 f"its weights'")
    vit_agreement = _check_batches(
        torch, by_model["vit"], lambda x, rec: _plain_vit(vit, x), "(e) vit",
        dev)
    fleet_summary = dict(
        batches={m: len(v) for m, v in by_model.items()},
        occupancy={m: statistics.mean(len(r["payloads"]) for r in v)
                   for m, v in by_model.items()},
        flips=flips, stages=[dict(s, gb_per_s=s["bytes"] / s["seconds"]
                                  / 1e9) for s in stages],
        flash_launches=fleet_launches, graphs=fleet_graphs,
        vit_agreement=vit_agreement,
        **_latencies([rs[0] for rs in fresponses.values()]))
    total = launched() - first
    del caches, cache
    hvd.shutdown()
    return dict(lm=lm_serve, fleet=fleet_summary), {"flash_fwd": total}


def _plain_vit(vit, x):
    with _plain_flash():
        return vit(x)


class _plain_flash:
    """Inside: ``flash_fwd`` computes its plain PyTorch version on any
    device (the served paths' reference forward: the same model and
    inputs, the kernel's twin in its place)."""

    def __enter__(self):
        from horovod_tpu_torch.ops import kernels as K

        self._kernel = K.flash_fwd
        K.flash_fwd = K.flash_fwd_plain

    def __exit__(self, *exc):
        from horovod_tpu_torch.ops import kernels as K

        K.flash_fwd = self._kernel
        return False


#: phase 20 (a): calls of steps_per_call=GRAPH_K against GRAPH_CALLS x
#: GRAPH_K eager calls
GRAPH_K = 4
GRAPH_CALLS = 2
#: phase 20 (a): calls under a float lr that changes every call, and how
#: far the card's reserved memory may move across them (a graph kept
#: beyond its key holds the step's activations, 11.49 GiB, and gradients)
GRAPH_SCHEDULED = 3
GRAPH_SLACK = 2**30
#: the kernels of phase 4's step, by their device symbols' names
GRAPH_SYMBOLS = {"scale_vec_kernel": "fused_scale",
                 "flash_fwd_kernel": "flash_fwd",
                 "flash_bwd_dq_kernel": "flash_bwd_dq",
                 "flash_bwd_dkv_kernel": "flash_bwd_dkv"}


def profiled_launches(prof) -> dict:
    """{kernel: device launches} of kernels 1-4 in a profiler run,
    counted from its device events (a replayed graph's kernels are device
    events with no host-side launch of their own); the flash kernels'
    positions variant is not counted."""
    out = {name: 0 for name in GRAPH_SYMBOLS.values()}
    for e in prof.events():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        name = kernel_name(e.name)
        if ", pos>" in name:
            continue
        for symbol, kernel in GRAPH_SYMBOLS.items():
            if name.startswith(symbol):
                out[kernel] += 1
    return out


def _leaf_diffs(torch, got, want) -> list:
    return [(i, float((a.float() - b.float()).abs().max()))
            for i, (a, b) in enumerate(zip(got, want)) if not torch.equal(a, b)]


def phase_graph(torch, launch: dict) -> tuple:
    """Phase 20, the executable plane.  (a) Phase 4's recipe with
    ``AdamW(capturable=True)``: GRAPH_CALLS calls of
    ``steps_per_call=GRAPH_K`` (the first runs one step eagerly, captures
    the step and replays it GRAPH_K - 1 times; the second replays it
    GRAPH_K times) against GRAPH_CALLS x GRAPH_K eager calls from the same
    weights and batch: each call's loss and the final parameters and
    AdamW state bit for bit; the capture's seconds, ms a step and host ms
    a call both ways, the peaks, and one more replayed call under the
    profiler, whose kernel 1-4 launches must be GRAPH_K x phase 4's step's
    and equal the capture's record x GRAPH_K and the wrappers' counts; the
    in-memory layer's hits and misses; then GRAPH_SCHEDULED calls whose
    float lr changes each call: each captures anew, and the card's
    reserved memory (its cache emptied) stays within GRAPH_SLACK of the
    first's, for the step keeps one graph.  (b) The warm start: phase 1 built the kernel library into
    the compile cache's store, and phase 12 (a)'s launched worker, a fresh
    process, must have loaded it from there (a hit, no compiling).  (c)
    Phase 19 (d)'s 48 requests, six batches of 8, through
    ``ExecutableCache.from_module``'s graph executors and through the
    eager forward: bit for bit, requests/s both ways in turns, captures
    and hits.  Returns the summary and the launches that ran."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.ops import build
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.serve import ExecutableCache
    from torch.profiler import ProfilerActivity, profile

    counts = {name: 0 for name in GRAPH_SYMBOLS.values()}

    def add(launches):
        for name, n in launches.items():
            if name in counts:
                counts[name] += n

    # (a) eight eager calls, then two calls of four steps
    hvd.init()
    eager = recipe(torch, hvd, steps=GRAPH_CALLS * GRAPH_K, capturable=True)
    add(eager["counts"])
    # kept on the host, so that they do not count in the graph's peak
    want_params = [p.detach().cpu() for p in eager["model"].parameters()]
    want_state = [t.detach().cpu() for st in
                  eager["opt"].optimizer.state.values() for t in st.values()]
    eager_summary = dict(
        step_ms=1e3 * statistics.median(eager["times"][1:]),
        host_ms=1e3 * statistics.median(eager["host"][1:]),
        peak_gib=eager["peak"] / 2**30)
    want_losses = eager["losses"][GRAPH_K - 1::GRAPH_K]
    del eager
    torch.cuda.empty_cache()
    stats0 = hvd.cache_stats()
    r = recipe(torch, hvd, steps=GRAPH_CALLS, capturable=True,
               steps_per_call=GRAPH_K)
    step, model, opt, batch = r["step"], r["model"], r["opt"], r["batch"]
    (captured,) = step.graphs.values()
    diffs = _leaf_diffs(torch, [p.detach().cpu() for p in model.parameters()],
                        want_params)
    state = [t.detach().cpu() for st in opt.optimizer.state.values()
             for t in st.values()]
    state_diffs = _leaf_diffs(torch, state, want_state)
    del state
    graph_summary = dict(
        step_ms=1e3 * r["times"][-1] / GRAPH_K,
        host_ms=1e3 * r["host"][-1],
        first_call_s=r["times"][0],
        capture_s=captured.graph.seconds,
        peak_gib=r["peak"] / 2**30)
    log(f"graph (a) [{CARD}]: losses {r['losses']} vs the eager calls' "
        f"{want_losses}; capture {captured.graph.seconds:.2f} s, first "
        f"call {r['times'][0]:.2f} s; ms a step: graph "
        f"{graph_summary['step_ms']:.1f}, eager {eager_summary['step_ms']:.1f}"
        f"; host ms a call: graph {graph_summary['host_ms']:.1f} (a call of "
        f"{GRAPH_K} steps), eager {eager_summary['host_ms']:.1f} (one step);"
        f" peak: graph {graph_summary['peak_gib']:.2f} GiB, eager "
        f"{eager_summary['peak_gib']:.2f} GiB")
    if r["losses"] != want_losses or diffs or state_diffs:
        for i, d in diffs[:20]:
            log(f"graph (a): parameter {i} differs by up to {d:.3e}")
        for i, d in state_diffs[:20]:
            log(f"graph (a): AdamW state tensor {i} differs by up to {d:.3e}")
        raise AssertionError(
            f"steps_per_call={GRAPH_K} is not bit for bit {GRAPH_K} eager "
            f"calls: losses {r['losses']} vs {want_losses}, "
            f"{len(diffs)} parameters and {len(state_diffs)} state tensors "
            f"differ (the replayed step runs other kernels or other "
            f"inputs than the eager one)")
    del want_params, want_state
    # the host's share of a graph call: the key's hash, and GRAPH_K bare
    # replays (they step the model on; the check is done)
    from horovod_tpu_torch.runtime import compile_cache

    t0 = time.perf_counter()
    for _ in range(10):
        compile_cache.executable_key(step._aot_extras(), model=model,
                                     optimizer=opt, batch=batch)
    key_ms = (time.perf_counter() - t0) * 1e2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GRAPH_K):
        captured.graph.replay()
    replay_host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    graph_summary.update(key_ms=key_ms, replays_host_ms=replay_host_ms)
    log(f"graph (a) [{CARD}]: host ms of a call's parts: the key "
        f"{key_ms:.2f}, {GRAPH_K} bare replays {replay_host_ms:.2f}")
    # one more call under the profiler: GRAPH_K replays
    torch.cuda.synchronize()
    before = K.launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model, opt, loss = step(model, opt, batch)
        float(loss)
    replayed = profiled_launches(prof)
    want = {k: GRAPH_K * n for k, n in LAUNCHES_A_STEP.items()}
    record = {k: GRAPH_K * captured.graph.launches.get(k, 0) for k in want}
    counted = {k: K.launch_counts()[k] - before[k] for k in want}
    stats1 = hvd.cache_stats()
    memory = dict(hits=stats1["hits"] - stats0["hits"],
                  misses=stats1["misses"] - stats0["misses"])
    log(f"graph (a) [{CARD}]: one replayed call of {GRAPH_K} steps under "
        f"the profiler: {replayed} (want {want}; the capture's record x "
        f"{GRAPH_K}: {record}; the wrappers' counts {counted}); in-memory "
        f"layer {memory}, {step.replays} replays")
    if replayed != want or record != want or counted != want:
        raise AssertionError(f"a replayed call launched {replayed}, want "
                             f"{want}")
    # the first call misses; the second and the profiled one hit
    if memory != dict(hits=GRAPH_CALLS, misses=1):
        raise AssertionError(f"in-memory layer {memory}")
    # a float lr that changes every call (a scheduler's) captures every
    # call; the step keeps one graph, so what the card reserves stays
    del captured, prof
    reserved, losses = [], []
    for _ in range(GRAPH_SCHEDULED):
        for g in opt.param_groups:
            g["lr"] *= 0.5
        model, opt, loss = step(model, opt, batch)
        losses.append(float(loss))
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved())
    stats2 = hvd.cache_stats()
    scheduled = dict(losses=losses, reserved_gib=[b / 2**30 for b in
                                                  reserved],
                     misses=stats2["misses"] - stats1["misses"],
                     graphs=len(step.graphs))
    log(f"graph (a) [{CARD}]: {GRAPH_SCHEDULED} calls, the lr halved "
        f"before each: {scheduled}")
    if scheduled["misses"] != GRAPH_SCHEDULED or scheduled["graphs"] != 1 \
            or not all(math.isfinite(x) for x in losses) or \
            max(reserved) - reserved[0] > GRAPH_SLACK:
        raise AssertionError(f"a float lr schedule under steps_per_call="
                             f"{GRAPH_K}: {scheduled}")
    graph_summary["scheduled"] = scheduled
    # the launches that ran since the recipe's start: each replay counted
    # its graph's record, the bare ones too
    add(K.launch_counts())
    del r, step, model, opt, batch, loss
    hvd.shutdown()
    torch.cuda.empty_cache()
    graph_summary.update(replayed_launches=replayed, memory_layer=memory)

    # (b) the warm start: phase 12 (a)'s fresh process against phase 1
    store = launch["store"]
    log(f"graph (b) [{CARD}]: phase 1 built {build.library_path().name} in "
        f"{build.build_seconds:.1f} s ({'hit' if build.library_hit else 'miss'}"
        f"); phase 12 (a)'s launched worker: {store}, launch to first step "
        f"{launch['launch_to_first_step_s']:.2f} s")
    if not store["library_hit"] or store["build_seconds"] != 0 or \
            store["library"] != build.library_path().name or \
            store["cache_stats"]["aot_disk_hits"] != 1:
        raise AssertionError(f"the launched worker did not load the kernel "
                             f"library from the store: {store}")
    warm = dict(phase1_build_s=build.build_seconds,
                phase1_hit=build.library_hit,
                worker_build_s=store["build_seconds"],
                worker_hit=store["library_hit"],
                worker_launch_to_first_step_s=launch[
                    "launch_to_first_step_s"])

    # (c) graph executors against the eager forward
    hvd.init()
    dev = hvd.device()
    cfg = full_config(torch, "flash")
    lm = TransformerLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    served = _last_logits(torch, lm)
    cache = ExecutableCache.from_module(
        served, lambda sig, n: torch.zeros((n,) + tuple(sig[0]),
                                           dtype=torch.long),
        bucket_sizes=SERVE["buckets"])
    gen = torch.Generator().manual_seed(SEED + 19)
    reqs = [torch.randint(0, cfg.vocab_size, (SERVE["lens"][i % 2],),
                          generator=gen)
            for i in range(SERVE["requests"])]
    width = max(SERVE["buckets"])
    batches = [reqs[i::2][j:j + width] for i in range(2)
               for j in range(0, SERVE["requests"] // 2, width)]
    stats0 = hvd.cache_stats()
    start = K.launch_counts()["flash_fwd"]
    t0 = time.perf_counter()
    for n in SERVE["lens"]:
        cache.get(((n,), "torch.int64"), width)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0

    def graph_pass():
        return [cache.run(b) for b in batches]

    def eager_pass():
        with torch.inference_mode():
            return [list(served(torch.stack(b).to(dev)).unbind(0))
                    for b in batches]

    passes = {"eager": [], "graph": []}
    outs = {}
    for how in ("eager", "graph", "graph", "eager"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[how] = (graph_pass if how == "graph" else eager_pass)()
        torch.cuda.synchronize()
        passes[how].append(time.perf_counter() - t0)
    ran = K.launch_counts()["flash_fwd"] - start
    stats1 = hvd.cache_stats()
    same = all(torch.equal(torch.stack(g), torch.stack(e))
               for g, e in zip(outs["graph"], outs["eager"]))
    rps = {how: len(reqs) / statistics.mean(t) for how, t in passes.items()}
    serve_summary = dict(
        batches=len(batches), requests_per_s=rps, capture_s=capture_s,
        captures=cache.graphs.misses, replays=cache.graphs.hits,
        hits=stats1["hits"] - stats0["hits"],
        misses=stats1["misses"] - stats0["misses"], launches=ran,
        bit_exact=same)
    log(f"graph (c) [{CARD}]: {len(reqs)} requests in {len(batches)} batches"
        f" of {width}: requests/s graph {rps['graph']:.1f}, eager "
        f"{rps['eager']:.1f} (two passes each, in turns); {serve_summary['captures']} "
        f"captures in {capture_s:.2f} s, {serve_summary['hits']} hits, "
        f"{serve_summary['misses']} misses; flash forwards {ran}; bit for "
        f"bit: {same}")
    if not same:
        raise AssertionError("graph executors and the eager forward differ")
    # the captures' warm-ups, then two graph and two eager passes
    if serve_summary["captures"] != 2 or serve_summary["misses"] != 2 or \
            serve_summary["hits"] != 2 * len(batches) or \
            ran != FULL["layers"] * (2 + 4 * len(batches)):
        raise AssertionError(f"graph executors: {serve_summary}")
    counts["flash_fwd"] += ran
    del cache, served, lm, outs
    hvd.shutdown()
    log("graph: phase 20 runs at full width and cut nothing (phase 4's 16 "
        "layers, batch 6 x 1024; phase 19 (d)'s 48 requests)")
    return dict(step=dict(graph=graph_summary, eager=eager_summary),
                warm_start=warm, serve=serve_summary), counts


# phase 21 (a): the probe's calls after its warm-up calls, each program
PROBE = dict(iters=5, warmup=2)
# phase 21 (b): the launched worker's small LM (flash at head dim 64) and
# its time limit
AFFINITY_LM = dict(vocab=1024, layers=2, heads=4, d_model=256, seq=256,
                   batch=2)
AFFINITY_TIMEOUT_S = 300


def affinity_worker(torch, out_path: str) -> int:
    """``chip_smoke.py --affinity OUT``: phase 21 (b)'s worker, started by
    ``python -m horovod_tpu_torch.runner -np 1`` with
    ``HOROVOD_THREAD_AFFINITY`` set.  Calls ``hvd.init()`` on the card,
    reads its own core set, takes one step of the small LM of
    :data:`AFFINITY_LM` through ``DistributedTrainStep``, reads the core
    set of every thread it then holds, those made before ``init()`` (the
    intra-op pool that importing torch starts, which ``init()`` pins one
    by one) apart from those made after (the CUDA driver's and NCCL's
    among them, which inherit the mask), and writes them with the knob,
    the loss and the launches to ``OUT`` as JSON."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        lm_loss,
    )
    from horovod_tpu_torch.ops import kernels as K

    def masks() -> dict:
        out = {}
        for tid in os.listdir("/proc/self/task"):
            try:
                out[tid] = sorted(os.sched_getaffinity(int(tid)))
            except OSError:         # the thread ended meanwhile
                pass
        return out

    before = masks()
    hvd.init()
    pinned = sorted(os.sched_getaffinity(0))
    a = AFFINITY_LM
    dev = hvd.device()
    cfg = TransformerConfig(vocab_size=a["vocab"], num_layers=a["layers"],
                            num_heads=a["heads"], d_model=a["d_model"],
                            d_ff=4 * a["d_model"], max_seq_len=a["seq"],
                            dtype=torch.bfloat16, attention_impl="flash")
    model = TransformerLM(cfg, device=dev,
                          generator=torch.Generator(device=dev)
                          .manual_seed(SEED))
    step = hvd.DistributedTrainStep(lm_loss, hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4)))
    K.reset_launch_counts()
    model, opt = step.init(model)
    tokens = torch.randint(0, a["vocab"], (a["batch"], a["seq"] + 1),
                           generator=torch.Generator().manual_seed(SEED))
    model, opt, loss = step(model, opt, step.shard_batch(tokens))
    loss = float(loss)
    after = masks()
    out = dict(knob=os.environ.get("HOROVOD_THREAD_AFFINITY"),
               pinned=pinned, loss=loss, launches=K.launch_counts(),
               device=str(dev), main=str(os.getpid()),
               older={t: m for t, m in after.items() if t in before},
               newer={t: m for t, m in after.items() if t not in before})
    hvd.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def phase_probe(torch) -> tuple:
    """Phase 21: (a) the overlap probe on phase 4's recipe at full width,
    (b) ``HOROVOD_THREAD_AFFINITY`` in a launched worker.  Returns the
    summary and the wrappers' launch counts over (a)'s programs."""
    import horovod_tpu_torch as hvd
    from torch.profiler import ProfilerActivity, profile

    from horovod_tpu_torch.models.transformer import lm_loss
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.utils import overlap_probe as OP

    hvd.init()
    out = {}
    try:
        r = recipe(torch, hvd, steps=0)
        model, batch = r["model"], r["batch"]
        del r
        K.reset_launch_counts()
        rep = OP.measure_overlap(lm_loss, model, batch, **PROBE)
        counts = K.launch_counts()
        fields = rep.as_bench_fields()
        log(f"probe (a) [{CARD}]: backward {rep.backward_s * 1e3:.2f} ms, "
            f"exchange {rep.exchange_s * 1e3:.2f} ms, fused "
            f"{rep.fused_s * 1e3:.2f} ms (medians of {PROBE['iters']} calls "
            f"after {PROBE['warmup']}, host clock fenced by a host read, "
            f"each without the fingerprint pass and read it ends in, "
            f"{rep.fingerprint_s * 1e3:.2f} ms alone); overlap fraction {rep.overlap_fraction:.4f}, exposed tail "
            f"{rep.tail_exchange_s * 1e3:.2f} ms, payload "
            f"{rep.payload_bytes} B, {rep.hierarchy} at a world of "
            f"{rep.world}: the exchange moves no bytes across cards, its "
            f"time is the buckets' packing and the one-rank collectives")
        log(f"probe (a) bench fields [{CARD}]: {json.dumps(fields)}")
        pr = OP.overlap_programs(lm_loss, model, batch)
        per_program = {}
        for name in ("backward_only", "exchange_only", "fused"):
            fn = getattr(pr, name)
            float(fn())
            K.reset_launch_counts()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                float(fn())
            per_program[name] = dict(profiler=profiled_launches(prof),
                                     wrappers=K.launch_counts())
        log(f"probe (a) launches over one call of each program [{CARD}]: "
            f"{json.dumps(per_program)}")
        # the fused program against backward, then the exchange on its own
        fused = float(pr.fused())
        trainable = [p for p in model.parameters() if p.requires_grad]
        grads = torch.autograd.grad(lm_loss(model, batch), trainable)
        shards, spec = C.grouped_reducescatter(list(grads), op=C.Average,
                                               spec=pr.spec)
        apart = float(OP.fingerprint(C.grouped_allgather(shards, spec)))
        del grads, shards, pr
        log(f"probe (a) [{CARD}]: fused fingerprint {fused!r}, backward "
            f"then the exchange {apart!r}, equal: {fused == apart}")
        out["a"] = dict(fields, payload_bytes=rep.payload_bytes,
                        fingerprint_s=rep.fingerprint_s,
                        launches=per_program, fused_fingerprint=fused,
                        apart_fingerprint=apart)
        del model, batch
    finally:
        hvd.shutdown()
    torch.cuda.empty_cache()
    if fused != apart:
        raise AssertionError("the fused program's fingerprint is not that "
                             "of backward followed by the exchange")
    for name in ("backward_only", "fused"):
        for kernel in FLASH_KERNELS:
            got = per_program[name]["profiler"][kernel]
            if got != FULL["layers"] or \
                    per_program[name]["wrappers"][kernel] != got:
                raise AssertionError(f"probe {name}: {kernel} launched "
                                     f"{per_program[name]}, want "
                                     f"{FULL['layers']} a call")
    if any(per_program["exchange_only"]["profiler"][k]
           for k in FLASH_KERNELS):
        raise AssertionError("the exchange-only program ran attention")
    if rep.hierarchy != "flat" or rep.rs_scopes != (1,) or \
            rep.wire_bytes_ici or rep.wire_bytes_dcn or \
            not 0.0 <= rep.overlap_fraction <= 1.0:
        raise AssertionError(f"probe report {rep}")

    cores = sorted(os.sched_getaffinity(0))
    given = cores[:max(1, len(cores) // 2)]
    out_dir = tempfile.mkdtemp(prefix="hvd_torch_affinity_")
    try:
        out_json = os.path.join(out_dir, "affinity.json")
        proc = _hvdrun(["-np", "1", sys.executable, os.path.abspath(__file__),
                        "--affinity", out_json], AFFINITY_TIMEOUT_S,
                       env=dict(os.environ, HOROVOD_THREAD_AFFINITY=",".join(
                           str(c) for c in given)))
        if proc.returncode != 0 or not os.path.exists(out_json):
            print(proc.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"affinity worker: launcher rc "
                                 f"{proc.returncode}")
        with open(out_json) as f:
            res = json.load(f)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    newer = {tuple(m) for m in res["newer"].values()}
    older = {t: m for t, m in res["older"].items() if t != res["main"]}
    log(f"probe (b) [{CARD}]: this process's cores {cores}; the worker was "
        f"given HOROVOD_THREAD_AFFINITY={res['knob']} and after init() "
        f"holds {res['pinned']}; after a step its {len(res['newer'])} "
        f"threads made since init() hold {sorted(newer)}, its "
        f"{len(older)} other threads made before it (torch's import) "
        f"hold {sorted({tuple(m) for m in older.values()})}; the small "
        f"LM's "
        f"loss {res['loss']}, launches {res['launches']} on "
        f"{res['device']}")
    out["b"] = dict(cores=len(cores), given=given, pinned=res["pinned"],
                    newer=len(res["newer"]), older=len(older),
                    loss=res["loss"])
    every = newer | {tuple(m) for m in res["older"].values()}
    if res["pinned"] != given or every != {tuple(given)}:
        raise AssertionError(f"the worker holds {res['pinned']} and its "
                             f"threads {sorted(every)}, given {given}")
    if not math.isfinite(res["loss"]) or not all(
            res["launches"][k] for k in FLASH_KERNELS):
        raise AssertionError(f"affinity worker step: {res}")
    return out, counts


#: phase 22: the kernels as ``hvd_torch`` ops at the main path's shapes,
#: and the served LM's AOT executables: one signature of 1024 tokens, two
#: buckets, the requests served through each set of executors (half in
#: batches of each bucket), the layers exported (the full 16: a cut for
#: the compile's time would be listed here), the fresh process's limit
AOT = dict(len=1024, buckets=(4, 8), requests=32, layers=FULL["layers"])
AOT_LOAD_TIMEOUT_S = 600
#: the weight flip of 22 (c): each weight plus this much noise
AOT_FLIP = 1e-2


def op_parity(torch) -> dict:
    """Phase 22 (a): each ``torch.ops.hvd_torch`` op called directly
    against its wrapper on the same inputs at the main path's shapes, bit
    for bit, and one launch counted a call of either (the op's CUDA kernel
    counts it).  These comparison launches are not the main path's: the
    counts are restored after."""
    from horovod_tpu_torch.ops import kernels as K

    ops = torch.ops.hvd_torch
    saved = K.launch_counts()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    out = {}

    def same(name, got, want, counter, calls=2):
        before = K.launch_counts()[counter]
        got, want = got(), want()
        launched = K.launch_counts()[counter] - before
        pairs = list(zip(got, want)) if isinstance(got, tuple) \
            else [(got, want)]
        equal = all(torch.equal(g, w) for g, w in pairs)
        out[name] = dict(bit_exact=equal, launches=launched)
        if not equal or launched != calls:
            raise AssertionError(f"op {name}: equal {equal}, launches "
                                 f"{launched} for {calls} calls")

    bucket = torch.randn(16 * 2**20, device="cuda", generator=gen)
    for cast in (torch.float32, torch.bfloat16):
        def by_op(cast=cast):
            y = torch.empty(bucket.shape, dtype=cast, device="cuda")
            ops.fused_scale(y, bucket, 0.5)
            return y

        same(f"fused_scale->{str(cast)[6:]}", by_op,
             lambda cast=cast: K.fused_scale(bucket, 0.5, cast),
             "fused_scale")

    def inplace_op():
        y = bucket.clone()
        ops.fused_scale(y, None, 0.5)
        return y

    def inplace_wrapper():
        y = bucket.clone()
        return K.fused_scale(y, 0.5, out=y)

    same("fused_scale in place", inplace_op, inplace_wrapper, "fused_scale")
    b, t, h, d = FULL["batch"], FULL["seq"], FULL["heads"], FULL["head_dim"]
    q, k, v, do = (torch.randn(b, t, h, d, device="cuda", generator=gen,
                               dtype=torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    pos = pos_pairs(torch, t)
    for tag, (qpos, kpos) in (("", (None, None)),
                              ("_pos", pos["b"])):
        o, lse = K.flash_fwd(q, k, v, True, scale, qpos, kpos)
        same("flash_fwd" + tag,
             lambda: ops.flash_fwd(q, k, v, True, scale, qpos, kpos),
             lambda: K.flash_fwd(q, k, v, True, scale, qpos, kpos),
             "flash_fwd" + tag)
        same("flash_bwd_dq" + tag,
             lambda: ops.flash_bwd_dq(q, k, v, do, lse, None, True, scale,
                                      qpos, kpos, o),
             lambda: K.flash_bwd_dq(q, k, v, do, lse, None, True, scale,
                                    qpos, kpos, out=o),
             "flash_bwd_dq" + tag)
        _, delta = K.flash_bwd_dq(q, k, v, do, lse, None, True, scale, qpos,
                                  kpos, out=o)
        same("flash_bwd_dkv" + tag,
             lambda: ops.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale,
                                       qpos, kpos),
             lambda: K.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale,
                                     qpos, kpos),
             "flash_bwd_dkv" + tag)
    del q, k, v, do, o, lse, delta
    shape = next(iter(CBR_MAIN))
    cbr = cbr_inputs(torch, shape, SEED + 22)
    same("cbr_bwd", lambda: ops.cbr_bwd(*cbr),
         lambda: K.fused_conv_bn_relu_bwd(*cbr), "fused_conv_bn_relu_bwd")
    del cbr
    m, kk, n = MM_MAIN["qkv"]
    x, w = mm_operands(torch, (m, kk, n), "fwd", SEED + 22)
    for dt in (torch.bfloat16, torch.float32):
        same(f"pallas_matmul->{str(dt)[6:]}",
             lambda dt=dt: ops.pallas_matmul(x, w, dt),
             lambda dt=dt: K.pallas_matmul(x, w, dt), "pallas_matmul")

    def into_out():
        y = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
        ops.pallas_matmul_out(x, w, y)
        return y

    same("pallas_matmul_out", into_out,
         lambda: K.pallas_matmul(x, w, torch.bfloat16), "pallas_matmul")
    out["dispatch_host_us"] = dispatch_cost(torch, gen)
    K.reset_launch_counts()
    K.add_launch_counts(saved)
    log(f"aot (a) [{CARD}]: every op through torch.ops.hvd_torch equals its "
        f"wrapper bit for bit at the main path's shapes, one launch a call: "
        f"{json.dumps(out)}")
    return out


def dispatch_cost(torch, gen, calls: int = 200) -> dict:
    """Host µs a call of the wrapper (through the dispatcher's op) and of
    the op's CUDA kernel called bare, on the host clock before a sync,
    medians of four passes in turns (op, bare, bare, op): the flash
    forward at b6 h16 t1024 d128 and ``fused_scale`` in place on a 1 MiB
    bucket (its kernel takes ~5 µs: the loop is host-bound).  The
    difference times phase 4's launches a step (48 flash, 132 scale) is
    the host time the dispatcher adds to a step."""
    from horovod_tpu_torch.ops import kernels as K

    b, t, h, d = FULL["batch"], FULL["seq"], FULL["heads"], FULL["head_dim"]
    q = torch.randn(b, t, h, d, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    x = torch.randn(2**18, device="cuda", generator=gen)
    cases = {"flash_fwd": (lambda: K.flash_fwd(q, q, q, True, 0.1),
                           lambda: K._launch_flash_fwd(q, q, q, True, 0.1)),
             "fused_scale": (lambda: K.fused_scale(x, 1.0, out=x),
                             lambda: K._launch_fused_scale(x, 1.0, x.dtype,
                                                           x))}
    out = {}
    for name, (op, bare) in cases.items():
        runs = {"op": [], "bare": []}
        for how in ("op", "bare", "bare", "op"):
            fn = op if how == "op" else bare
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            runs[how].append(1e6 * (time.perf_counter() - t0) / calls)
            torch.cuda.synchronize()
        out[name] = {how: statistics.median(v) for how, v in runs.items()}
    per_step = (48 * (out["flash_fwd"]["op"] - out["flash_fwd"]["bare"]) +
                132 * (out["fused_scale"]["op"] -
                       out["fused_scale"]["bare"])) / 1e3
    out["added_host_ms_a_step"] = per_step
    return out


def aot_model(torch, dev):
    """The served 870.9M LM of phase 19 (d) at AOT["layers"], seeded."""
    from horovod_tpu_torch.models.transformer import TransformerLM

    cfg = dataclasses.replace(full_config(torch, "flash"),
                              num_layers=AOT["layers"])
    lm = TransformerLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    return cfg, _last_logits(torch, lm)


def aot_batches(torch, vocab: int) -> list:
    """AOT["requests"] seeded requests of AOT["len"] tokens, half in
    batches of each bucket."""
    gen = torch.Generator().manual_seed(SEED + 22)
    reqs = [torch.randint(0, vocab, (AOT["len"],), generator=gen)
            for _ in range(AOT["requests"])]
    half = len(reqs) // len(AOT["buckets"])
    out = []
    for i, bucket in enumerate(AOT["buckets"]):
        part = reqs[i * half:(i + 1) * half]
        out += [part[j:j + bucket] for j in range(0, len(part), bucket)]
    return out


def _tokens_example(torch):
    return lambda sig, n: torch.zeros((n,) + tuple(sig[0]),
                                      dtype=torch.long)


def aot_serve(torch, cache, served, batches, dev, label: str,
              weights=None) -> dict:
    """Every batch through ``cache``'s executors (with ``weights`` when
    given): 16 flash-forward launches a batch, each batch within the
    served limits of the plain path's forward of its padded batch on the
    same weights."""
    from horovod_tpu_torch.ops import kernels as K

    records = []
    start = K.launch_counts()["flash_fwd"]
    for batch in batches:
        kw = {} if weights is None else {"weights": weights}
        records.append(dict(payloads=batch, results=cache.run(batch, **kw),
                            padded=cache.padded_size(len(batch))))
    launches = K.launch_counts()["flash_fwd"] - start

    def plain(x, rec):
        with _plain_flash():
            if weights is None:
                return served(x)
            return torch.func.functional_call(served, weights, (x,))

    readings = _check_batches(torch, records, plain, label, dev)
    if launches != AOT["layers"] * len(batches):
        raise AssertionError(f"{label}: {launches} flash forwards for "
                             f"{len(batches)} batches")
    return dict(readings, launches=launches, batches=len(batches))


def aot_worker(torch, out_path: str) -> int:
    """``chip_smoke.py --aot-load OUT``: phase 22 (b)'s fresh process.  Loads
    the executables phase 22 stored (``HOROVOD_COMPILE_CACHE_DIR``) through
    ``ExecutableCache.from_exported`` (each a hit: nothing compiles),
    serves :func:`aot_batches` against the plain path, and writes the
    seconds, the store's counters and the readings to ``OUT`` as JSON."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import build
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.runtime import compile_cache
    from horovod_tpu_torch.serve import ExecutableCache

    hvd.init()
    dev = hvd.device()
    cfg, served = aot_model(torch, dev)
    cache = ExecutableCache.from_exported(served, _tokens_example(torch),
                                          bucket_sizes=AOT["buckets"])
    K.reset_launch_counts()
    t0 = time.perf_counter()
    for bucket in AOT["buckets"]:
        cache.get(((AOT["len"],), "torch.int64"), bucket)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    loaded = dict(load_s=load_s, store=compile_cache.stats(),
                  stages=compile_cache.aot_seconds(),
                  entries=compile_cache.executable_count(),
                  kernel_build_s=build.build_seconds)
    batches = aot_batches(torch, cfg.vocab_size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served_out = aot_serve(torch, cache, served, batches, dev,
                           "aot (b) fresh process")
    out = dict(loaded, serve=served_out,
               serve_s=time.perf_counter() - t0,
               kernel_library_hit=build.library_hit,
               launches=K.launch_counts())
    hvd.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def phase_aot(torch, train=None, phase4=None, memory=None) -> tuple:
    """Phase 22: the kernels as dispatcher ops and the AOT executable
    store.  (a) :func:`op_parity`; phase 4's step with the ops (its ms
    beside the 145.9 ms of PERF.md's profiled step, its launches a step)
    and phase 18's flash forwards a tiered step, read from their phases.
    (b) The 870.9M LM at
    t = AOT["len"], buckets AOT["buckets"], exported and compiled by
    AOTInductor through ``ExecutableCache.from_exported`` into a fresh
    ``HOROVOD_COMPILE_CACHE_DIR`` (holding phase 1's kernel library,
    copied, so that no process there compiles kernels): the compile
    seconds; each batch within the served limits of the plain path, 16
    flash forwards a batch through ``hvd_torch::flash_fwd``; then a fresh
    process (``--aot-load``) loads both executables (hits, nothing
    compiled) and serves the same batches.  (c) A weight flip: the
    executors run flipped weights against the plain path on them, and the
    model holding them builds its executors as hits, no new entry.  (d)
    requests/s of the AOT executors beside ``from_module``'s graph
    executors and the eager forward, in turns.  Returns the summary and
    the flash forwards the main path ran."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import build
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.runtime import compile_cache
    from horovod_tpu_torch.serve import ExecutableCache

    log(f"aot: torch {torch.__version__}, triton "
        f"{compile_cache._triton_version()}, CUDA {torch.version.cuda}")
    summary = dict(ops=op_parity(torch))
    if train is not None:
        steps = len(train["losses"])
        a_step = {k: phase4[k] / steps for k in TRANSFORMER_KERNELS}
        tiers = {tier: row["flash_launches_a_step"]["flash_fwd"]
                 for tier, row in memory["tiers"].items()}
        summary.update(phase4_step_ms=train["step_ms"],
                       phase4_launches_a_step=a_step, remat_flash_fwd=tiers)
        log(f"aot (a) [{CARD}]: phase 4's step through the ops "
            f"{train['step_ms']:.1f} ms (PERF.md's profiled step: 145.9 ms), "
            f"launches a step {a_step}; phase 18's flash forwards a step by "
            f"tier {tiers}")
        want = {"fused_scale": 132, "flash_fwd": FULL["layers"],
                "flash_bwd_dq": FULL["layers"],
                "flash_bwd_dkv": FULL["layers"]}
        if a_step != want or any(
                n != (FULL["layers"] if tier == "none" else
                      2 * FULL["layers"]) for tier, n in tiers.items()):
            raise AssertionError("phase 4's or phase 18's launches moved")

    store = tempfile.mkdtemp(prefix="hvd_torch_aot_")
    for f in compile_cache._entry_files(build.library_path()):
        if f.exists():
            shutil.copy2(f, store)
    saved_env = os.environ.get("HOROVOD_COMPILE_CACHE_DIR")
    os.environ["HOROVOD_COMPILE_CACHE_DIR"] = store
    flash0 = K.launch_counts()["flash_fwd"]
    hvd.init()
    try:
        dev = hvd.device()
        cfg, served = aot_model(torch, dev)
        batches = aot_batches(torch, cfg.vocab_size)
        sig = ((AOT["len"],), "torch.int64")
        stats0, stages0 = compile_cache.stats(), compile_cache.aot_seconds()
        cache = ExecutableCache.from_exported(
            served, _tokens_example(torch), bucket_sizes=AOT["buckets"])
        compile_s = {}
        for bucket in AOT["buckets"]:
            t0 = time.perf_counter()
            cache.get(sig, bucket)
            torch.cuda.synchronize()
            compile_s[bucket] = time.perf_counter() - t0
        stats1 = compile_cache.stats()
        stages = {k: v - stages0[k]
                  for k, v in compile_cache.aot_seconds().items()}
        entries = compile_cache.executable_count(store)
        aot = aot_serve(torch, cache, served, batches, dev, "aot (b)")
        log(f"aot (b) [{CARD}]: {AOT['layers']} layers, t {AOT['len']}, "
            f"export + AOTInductor compile + load s by bucket {compile_s} "
            f"(stages summed {stages}); "
            f"store {stats0} -> {stats1}, {entries} entries; "
            f"{json.dumps(aot)}")
        if entries != len(AOT["buckets"]) or stats1 != dict(
                stats0, aot_disk_misses=stats0["aot_disk_misses"] +
                len(AOT["buckets"])):
            raise AssertionError("aot (b): the compile did not miss and "
                                 "store each bucket")
        graph_text = str(torch.export.export(
            compile_cache._as_module(
                lambda x, w: torch.func.functional_call(served, w, (x,))), (
                torch.zeros((AOT["buckets"][0], AOT["len"]),
                            dtype=torch.long, device=dev),
                _weights(served))).graph)
        nodes = dict(flash=graph_text.count("hvd_torch.flash_fwd"),
                     sdpa=graph_text.count("scaled_dot_product"))
        if nodes != dict(flash=AOT["layers"], sdpa=0):
            raise AssertionError(f"aot (b): the exported graph holds "
                                 f"{nodes}")

        out_dir = tempfile.mkdtemp(prefix="hvd_torch_aot_out_")
        try:
            out_json = os.path.join(out_dir, "aot.json")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--aot-load",
                 out_json], capture_output=True, text=True,
                timeout=AOT_LOAD_TIMEOUT_S)
            wall = time.perf_counter() - t0
            if proc.returncode != 0 or not os.path.exists(out_json):
                print(proc.stdout[-4000:], proc.stderr[-4000:],
                      file=sys.stderr)
                raise AssertionError(f"aot (b): the fresh process exited "
                                     f"{proc.returncode}")
            with open(out_json) as f:
                fresh = json.load(f)
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        fresh["process_s"] = wall
        log(f"aot (b) fresh process [{CARD}]: {wall:.1f} s in all; loaded "
            f"{len(AOT['buckets'])} executables in {fresh['load_s']:.2f} s "
            f"(stages {fresh['stages']}), store "
            f"{fresh['store']}, kernel library hit "
            f"{fresh['kernel_library_hit']} ({fresh['kernel_build_s']} s of "
            f"nvcc); served {json.dumps(fresh['serve'])}")
        # the kernel library loads at the first launch, after these reads
        if fresh["store"] != {"aot_disk_hits": len(AOT["buckets"]),
                              "aot_disk_misses": 0} or \
                fresh["kernel_build_s"] or not fresh["kernel_library_hit"] or \
                fresh["entries"] != len(AOT["buckets"]):
            raise AssertionError(f"aot (b): the fresh process compiled: "
                                 f"{fresh}")

        # (d) AOT executors beside from_module's graph executors and eager
        graph_cache = ExecutableCache.from_module(
            served, _tokens_example(torch), bucket_sizes=AOT["buckets"])
        for bucket in AOT["buckets"]:
            graph_cache.get(sig, bucket)

        def eager_pass():
            with torch.inference_mode():
                return [list(served(torch.stack(b).to(dev)).unbind(0))
                        for b in batches]

        runs = {"aot": lambda: [cache.run(b) for b in batches],
                "graph": lambda: [graph_cache.run(b) for b in batches],
                "eager": eager_pass}
        passes = {how: [] for how in runs}
        outs = {}
        start = K.launch_counts()["flash_fwd"]
        for how in ("aot", "graph", "eager", "eager", "graph", "aot"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[how] = runs[how]()
            torch.cuda.synchronize()
            passes[how].append(time.perf_counter() - t0)
        rates = {how: AOT["requests"] / statistics.mean(t)
                 for how, t in passes.items()}
        ran = K.launch_counts()["flash_fwd"] - start
        diff = max(max_err(torch, torch.stack(a), torch.stack(e))
                   for a, e in zip(outs["aot"], outs["eager"]))
        log(f"aot (d) [{CARD}]: requests/s AOT {rates['aot']:.1f}, graph "
            f"{rates['graph']:.1f}, eager {rates['eager']:.1f} ("
            f"{AOT['requests']} requests in {len(batches)} batches, two "
            f"passes each in turns); AOT against eager max abs "
            f"{diff:.3e}; flash forwards {ran}")
        if ran != 6 * AOT["layers"] * len(batches):
            raise AssertionError(f"aot (d): {ran} flash forwards")
        del graph_cache, outs

        # (c) a weight flip: the same executables, then a hit
        gen = torch.Generator(device=dev).manual_seed(SEED + 23)
        own = _weights(served)
        flipped = {n: t + AOT_FLIP * torch.randn(t.shape, device=dev,
                                                 generator=gen)
                   if t.is_floating_point() else t for n, t in own.items()}
        builds = len(cache)
        flip = aot_serve(torch, cache, served, batches[-1:], dev,
                         "aot (c) flipped weights", weights=flipped)
        with torch.no_grad():
            for n, t in own.items():
                t.copy_(flipped[n])
        del flipped
        stats2 = compile_cache.stats()
        again = ExecutableCache.from_exported(
            served, _tokens_example(torch), bucket_sizes=AOT["buckets"])
        for bucket in AOT["buckets"]:
            again.get(sig, bucket)
        stats3 = compile_cache.stats()
        flip.update(builds_before=builds, builds_after=len(cache),
                    entries=compile_cache.executable_count(store),
                    hits=stats3["aot_disk_hits"] - stats2["aot_disk_hits"],
                    misses=stats3["aot_disk_misses"] -
                    stats2["aot_disk_misses"])
        log(f"aot (c) [{CARD}]: flipped weights through the same "
            f"executables {json.dumps(flip)}")
        if flip["builds_after"] != builds or flip["hits"] != len(
                AOT["buckets"]) or flip["misses"] or \
                flip["entries"] != len(AOT["buckets"]):
            raise AssertionError(f"aot (c): a flip compiled: {flip}")
        launches = K.launch_counts()["flash_fwd"] - flash0
        del cache, again, served
    finally:
        hvd.shutdown()
        if saved_env is None:
            os.environ.pop("HOROVOD_COMPILE_CACHE_DIR", None)
        else:
            os.environ["HOROVOD_COMPILE_CACHE_DIR"] = saved_env
        shutil.rmtree(store, ignore_errors=True)
    summary.update(compile_s=compile_s, stages=stages, serve=aot, fresh=fresh,
                   requests_per_s=rates, aot_vs_eager_max_abs=diff,
                   flip=flip, graph_nodes=nodes, layers=AOT["layers"])
    return summary, {"flash_fwd": launches}


#: phase 23: the traced step's FLOPs against the analytic count from the
#: recipe's shapes (relative), and the flop formulas' check at small shapes
#: for the kernels off the transformer path (kernel 5 at one of its 28x28
#: segments' channel counts, kernel 6 at one 256-cube)
TRACE_FLOP_TOL = 1e-3
FLOP_CHECK_SMALL = dict(attn=(2, 256, 4, 128), cbr=(2, 8, 8, 128, 128),
                        mm=(256, 256, 256))


def analytic_step_flops(b: int, t: int, layers: int, heads: int,
                        head_dim: int, d_model: int, d_ff: int,
                        vocab: int) -> dict:
    """The matmul-class FLOPs of one forward and backward of the
    TransformerLM from its shapes, backward twice the forward: the
    projections (qkv, out, the MLP's two) and the tied head's
    ``2·d·vocab`` a token, and attention's two products
    ``2·b·heads·t²·head_dim`` each a layer (causal masking does not halve
    them, torch's SDPA convention)."""
    tokens = b * t
    linear = 3 * tokens * layers * 2 * d_model * (4 * d_model + 2 * d_ff)
    attention = 3 * layers * 2 * (2 * b * heads * t * t * head_dim)
    head = 3 * tokens * 2 * d_model * vocab
    return dict(linear=linear, attention=attention, head=head,
                total=linear + attention + head)


def flop_check(torch, dev, attn, cbr, mm) -> dict:
    """Each kernel's FLOPs as its flop formula counts them
    (``utils/trace.module_flops`` over a call of the wrapper on ``dev``,
    which launches the kernel on a card) against the dense computation it
    replaces: attention's forward and its backward through autograd of
    ``reference_attention`` at ``attn`` = (b, t, h, d), causal, bf16;
    kernel 5's plain backward (``convolution_backward``) at ``cbr`` = (n,
    h, w, cin, c); kernel 6's plain product at ``mm`` = (m, k, n).
    Returns {name: [kernel FLOPs, dense FLOPs]}."""
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.parallel.ring_attention import \
        reference_attention
    from horovod_tpu_torch.utils import trace as T

    b, t, h, d = attn
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v, do = (torch.randn(b, t, h, d, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    out, lse = K.flash_fwd(q, k, v, True, scale)

    def kernel_bwd():
        _, delta = K.flash_bwd_dq(q, k, v, do, lse, None, True, scale,
                                  out=out)
        K.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale)

    qq, kk, vv = (x.detach().clone().requires_grad_() for x in (q, k, v))
    res = {"flash_fwd": [
        T.module_flops(K.flash_fwd, q, k, v, True, scale),
        T.module_flops(reference_attention, q, k, v, causal=True,
                       scale=scale)]}
    dense = reference_attention(qq, kk, vv, causal=True, scale=scale)
    res["flash_bwd"] = [T.module_flops(kernel_bwd), T.module_flops(
        torch.autograd.grad, dense, (qq, kk, vv), do)]
    cbr_args = cbr_inputs(torch, cbr, SEED, device=str(dev))
    res["cbr_bwd"] = [
        T.module_flops(K.fused_conv_bn_relu_bwd, *cbr_args),
        T.module_flops(K.fused_conv_bn_relu_bwd_plain, *cbr_args)]
    x, w = mm_operands(torch, mm, "fwd", SEED, device=str(dev))
    with torch.no_grad():
        res["pallas_matmul"] = [
            T.module_flops(K.pallas_matmul, x, w),
            T.module_flops(K.pallas_matmul_plain, x, w, torch.bfloat16)]
    return res


#: phase 23 (b): a small LM (flash at head dim 128) whose sharded step is
#: traced at a world of one, to read its collectives' device windows
TRACE_SMALL_LM = dict(vocab=512, layers=2, heads=4, d_model=512, seq=256,
                      batch=4)


def traced_sharded_small(torch, hvd) -> dict:
    """Phase 23 (b): one warm and one traced step of the sharded exchange
    on :data:`TRACE_SMALL_LM`: its collectives with their device windows
    (the NCCL kernels each op's range launched) and the serial tail (0:
    at a world of one no group has more than one rank)."""
    from horovod_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        lm_loss,
    )
    from horovod_tpu_torch.utils import trace as T

    c, dev = TRACE_SMALL_LM, hvd.device()
    cfg = TransformerConfig(vocab_size=c["vocab"], num_layers=c["layers"],
                            num_heads=c["heads"], d_model=c["d_model"],
                            d_ff=4 * c["d_model"], max_seq_len=c["seq"],
                            dtype=torch.bfloat16, attention_impl="flash")
    model = TransformerLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    step = hvd.DistributedTrainStep(
        lm_loss, torch.optim.AdamW(model.parameters(), lr=3e-4),
        shard_optimizer_states=True)
    model, opt = step.init(model)
    batch = step.shard_batch(torch.randint(
        0, c["vocab"], (c["batch"], c["seq"] + 1),
        generator=torch.Generator().manual_seed(SEED)))
    step(model, opt, batch)
    _, tr = step.trace(model, opt, batch)
    return dict(ops=[(o.kind, o.bytes, o.stream, o.interval)
                     for o in tr.ops],
                placed=sum(o.interval is not None for o in tr.ops),
                serial_tail=T.serial_tail_collectives(tr))


def trace_launches(kernels) -> dict:
    """{kernel: launches} of kernels 1-4 among a trace's device kernels
    (the flash kernels' positions variant apart)."""
    out = {name: 0 for name in GRAPH_SYMBOLS.values()}
    for k in kernels:
        name = kernel_name(k.name)
        if ", pos>" in name:
            continue
        for symbol, kernel in GRAPH_SYMBOLS.items():
            if name.startswith(symbol):
                out[kernel] += 1
    return out


def phase_trace(torch) -> tuple:
    """Phase 23: phase 4's recipe at full width (one warm step), then one
    step through ``DistributedTrainStep.trace``: FLOPs by op against the
    analytic count, TFLOP/s and share of the H100 model's peak at the
    traced step's time (and at an untraced step's), the measured memory
    high-water against ``max_memory_allocated``, ``module_cost``'s
    predicted step time, the lint's findings, the kernels the trace saw,
    and the flop formulas against their dense counts at the recipe's
    attention shape and small shapes.  Returns the summary and the
    wrappers' launches over the traced step."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import cost_model as CM
    from horovod_tpu_torch.analysis.trace_lint import lint_trace
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.utils import trace as T

    hvd.init()
    try:
        r = recipe(torch, hvd, steps=1)
        model, opt, step, batch = r["model"], r["opt"], r["step"], \
            r["batch"]
        del r
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        loss, tr = step.trace(model, opt, batch)
        loss = float(loss)
        counts = K.launch_counts()
        max_alloc = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        model, opt, plain_loss = step(model, opt, batch)
        float(plain_loss)
        plain_s = time.perf_counter() - t0
        grad_bytes = sum(p.numel() * p.element_size()
                         for p in model.parameters())
        findings = [f.format() for f in lint_trace(tr,
                                                   grad_bytes=grad_bytes)]
        cost = CM.module_cost(tr)
        dev = hvd.device()
        del model, opt, step, batch
        torch.cuda.empty_cache()
        sharded = traced_sharded_small(torch, hvd)
        checks = {"main": flop_check(torch, dev, (FULL["batch"], FULL["seq"],
                                                  FULL["heads"],
                                                  FULL["head_dim"]),
                                     FLOP_CHECK_SMALL["cbr"],
                                     FLOP_CHECK_SMALL["mm"])}
    finally:
        hvd.shutdown()
    want = analytic_step_flops(FULL["batch"], FULL["seq"], FULL["layers"],
                               FULL["heads"], FULL["head_dim"],
                               FULL["d_model"], 4 * FULL["d_model"],
                               FULL["vocab"])
    flash = sum(n for op, n in tr.flops_by_op.items() if "flash" in op)
    flash_want = 6 * (2 * FULL["batch"] * FULL["heads"] * FULL["seq"] ** 2
                      * FULL["head_dim"]) * FULL["layers"]
    seen = trace_launches(tr.kernels)
    peak = (tr.memory_base_bytes or 0) + tr.memory_high_water_bytes
    summary = dict(
        loss=loss, flops=tr.flops, flops_by_op=tr.flops_by_op,
        analytic=want, flash_flops=flash, flash_want=flash_want,
        traced_s=tr.seconds, untraced_s=plain_s,
        tflops_traced=tr.flops / tr.seconds / 1e12,
        tflops_untraced=tr.flops / plain_s / 1e12,
        peak_share_traced=tr.flops / tr.seconds / CM.H100.peak_flops_per_s,
        peak_share_untraced=tr.flops / plain_s / CM.H100.peak_flops_per_s,
        memory_base=tr.memory_base_bytes,
        memory_high_water=tr.memory_high_water_bytes, memory_peak=peak,
        max_memory_allocated=max_alloc,
        predicted_s=cost.predicted_step_time_s(CM.H100),
        wire=cost.wire_bytes, findings=findings, ops=len(tr.ops),
        placed=sum(o.interval is not None for o in tr.ops),
        kernels=len(tr.kernels), seen=seen, wrappers=counts,
        serial_tail=T.serial_tail_collectives(tr), flop_check=checks,
        sharded_small=sharded)
    log(f"trace (23) [{CARD}]: {tr.flops} FLOPs counted in one traced step "
        f"against {want['total']} from the recipe's shapes "
        f"({json.dumps(want)}); by op {json.dumps(tr.flops_by_op)}; flash "
        f"ops {flash} (want 6·2·B·h·t²·d·L = {flash_want})")
    log(f"trace (23) [{CARD}]: traced step {tr.seconds:.4f} s -> "
        f"{summary['tflops_traced']:.1f} TFLOP/s, "
        f"{100 * summary['peak_share_traced']:.2f} % of the H100 model's "
        f"989 TFLOP/s; an untraced step {plain_s:.4f} s -> "
        f"{summary['tflops_untraced']:.1f} TFLOP/s, "
        f"{100 * summary['peak_share_untraced']:.2f} %; module_cost "
        f"predicts {summary['predicted_s'] * 1e3:.2f} ms (compute at peak, "
        f"wire {cost.wire_bytes})")
    log(f"trace (23) [{CARD}]: memory {tr.memory_base_bytes} B live at the "
        f"step's start + {tr.memory_high_water_bytes} B measured high-water "
        f"(allocation events) = {peak} B, max_memory_allocated {max_alloc} "
        f"B over the same step ({peak - max_alloc:+d} B)")
    log(f"trace (23) [{CARD}]: {len(tr.ops)} collectives "
        f"{json.dumps(dict(collections.Counter(o.kind for o in tr.ops)))} "
        f"({summary['placed']} with a device window), "
        f"{len(tr.kernels)} kernels, kernels 1-4 in the trace {seen}, "
        f"wrappers {json.dumps(counts)}; lint findings {findings}; "
        f"flop formulas against dense counts {json.dumps(checks)}")
    log(f"trace (23) (b) [{CARD}]: the small LM's sharded step at a world "
        f"of one: {json.dumps(sharded)}")
    bad = []
    if abs(tr.flops - want["total"]) > TRACE_FLOP_TOL * want["total"]:
        bad.append(f"FLOPs {tr.flops} vs analytic {want['total']}")
    if flash != flash_want:
        bad.append(f"flash FLOPs {flash} vs {flash_want}")
    for kernel in FLASH_KERNELS:
        if seen[kernel] != FULL["layers"] or counts[kernel] != FULL["layers"]:
            bad.append(f"{kernel}: trace {seen[kernel]}, wrapper "
                       f"{counts[kernel]}, want {FULL['layers']}")
    if findings:
        bad.append(f"lint findings {findings}")
    for name, (got, dense) in checks["main"].items():
        if got != dense or got <= 0:
            bad.append(f"flop formula {name}: {got} vs dense {dense}")
    if not tr.memory_high_water_bytes > 0:
        bad.append("no allocation measured")
    if bad:
        raise AssertionError(f"phase 23: {bad}")
    return summary, counts


def _weights(served) -> dict:
    return {**dict(served.named_parameters()),
            **dict(served.named_buffers())}


def main() -> int:
    global CARD
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--launched"]:
        return launched_worker(torch, sys.argv[2])
    if sys.argv[1:2] == ["--affinity"]:
        return affinity_worker(torch, sys.argv[2])
    if sys.argv[1:2] == ["--aot-load"]:
        return aot_worker(torch, sys.argv[2])
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    CARD = smi.splitlines()[0]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    seconds = {}

    def timed(name, fn, *args):
        """``fn(*args)``, its seconds kept under ``name``, then the card's
        cache emptied for the next phase."""
        t0 = time.perf_counter()
        result = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        torch.cuda.empty_cache()
        return result

    timed("1 build", phase_build)
    errs = timed("2 check", phase_check, torch)
    timing = timed("3 time", phase_time, torch)
    counts, train, first, eager, step1_params = timed("4+9+17 train",
                                                      phase_train, torch)
    phase4 = dict(counts)
    tools = eager.pop("tools")
    seconds["17 tools"] = tools["seconds"]
    resnet_counts, resnet = timed("5 resnet", phase_resnet, torch)
    for name in RESNET_KERNELS:
        counts[name] = resnet_counts[name]
    tp_counts, tp = timed("6 tp", phase_tp_train, torch)
    counts["pallas_matmul"] = tp_counts["pallas_matmul"]
    sp_counts, sp = timed("7 sp", phase_sp_train, torch, first)
    for name in SP_KERNELS:
        counts[name] = sp_counts[name]
    zero = timed("8 zero", phase_zero_train, torch, train["losses"])
    moe_counts, chunk_counts, moe = timed("10 moe", phase_moe, torch)
    fed_counts, fed = timed("11a fed", phase_fed, torch, resnet)
    for name in ("fused_scale", "fused_conv_bn_relu_bwd"):
        counts[name] += fed_counts[name]
    sync_bn = timed("11b sync_bn", phase_sync_bn, torch)
    launch = timed("12 launch", phase_launch, torch, train)
    adasum = timed("13 adasum", phase_adasum, torch, train, step1_params)
    del step1_params
    hier = timed("14 hier", phase_hier_train, torch, zero)
    mp = timed("15 mp", phase_model_parallel, torch, train)
    elastic = timed("16a elastic", phase_elastic, torch, train)
    pipeline = timed("16b pipeline", phase_pipeline, torch, train, first)
    del first
    memory = timed("18 memory", phase_memory, torch, train)
    for name, n in memory.pop("launches").items():
        counts[name] += n
    guard, guard_counts = timed("19a guard", phase_guard, torch, train)
    serve, serve_counts = timed("19b serve", phase_serve, torch)
    graph, graph_counts = timed("20 graph", phase_graph, torch, launch)
    probe, probe_counts = timed("21 probe", phase_probe, torch)
    aot, aot_counts = timed("22 aot", phase_aot, torch, train, phase4,
                            memory)
    traced, trace_counts = timed("23 trace", phase_trace, torch)
    for name, n in list(guard_counts.items()) + list(serve_counts.items()) \
            + list(graph_counts.items()) + list(probe_counts.items()) \
            + list(aot_counts.items()) + list(trace_counts.items()):
        counts[name] += n
    # the kernels line's kernel-6 row stays the tp phase's: its ms and
    # bound are the tp shapes'; phase 10 (b)'s launches and readings are
    # the moe summary's "chunk"
    log(f"moe: kernel 6 launches: tp phase {counts['pallas_matmul']}, "
        f"expert_chunk_mlp {chunk_counts['pallas_matmul']}; the MoE path "
        f"{ {k: moe_counts[k] for k in TRANSFORMER_KERNELS} }")

    csrc = "horovod_tpu_torch/ops/csrc/"
    tpu = "horovod_tpu/ops/pallas_kernels.py:"
    sources = {"fused_scale": (csrc + "fused_scale.cu", tpu + "55"),
               "flash_fwd": (csrc + "flash_attention.cu", tpu + "84"),
               "flash_bwd_dq": (csrc + "flash_attention.cu", tpu + "213"),
               "flash_bwd_dkv": (csrc + "flash_attention.cu", tpu + "269"),
               "fused_conv_bn_relu_bwd": (csrc + "conv_bn_relu_bwd.cu",
                                          tpu + "503"),
               "pallas_matmul": (csrc + "matmul.cu", tpu + "778"),
               "flash_fwd_pos": (csrc + "flash_attention.cu", tpu + "103"),
               "flash_bwd_dq_pos": (csrc + "flash_attention.cu",
                                    tpu + "232"),
               "flash_bwd_dkv_pos": (csrc + "flash_attention.cu",
                                     tpu + "286")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = timing[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": errs[name], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    log(f"train summary: {json.dumps(train)}")
    log(f"resnet summary: {json.dumps(resnet)}")
    log(f"tp summary: {json.dumps(tp)}")
    log(f"sp summary: {json.dumps(sp)}")
    log(f"zero summary: {json.dumps(zero)}")
    log(f"eager summary: {json.dumps(eager)}")
    log(f"moe summary [{CARD}]: {json.dumps(moe)}")
    log(f"fed summary [{CARD}]: {json.dumps(fed)}")
    log(f"sync_bn summary [{CARD}]: {json.dumps(sync_bn)}")
    log(f"launch summary [{CARD}]: {json.dumps(launch)}")
    log(f"adasum summary [{CARD}]: {json.dumps(adasum)}")
    log(f"hier summary [{CARD}]: {json.dumps(hier)}")
    log(f"mp summary [{CARD}]: {json.dumps(mp)}")
    log(f"elastic summary [{CARD}]: {json.dumps(elastic)}")
    log(f"pipeline summary [{CARD}]: {json.dumps(pipeline)}")
    log(f"tools summary [{CARD}]: {json.dumps(tools)}")
    log(f"memory summary [{CARD}]: {json.dumps(memory)}")
    log(f"guard summary [{CARD}]: {json.dumps(guard)}")
    log(f"serve summary [{CARD}]: {json.dumps(serve)}")
    log(f"graph summary [{CARD}]: {json.dumps(graph)}")
    log(f"probe summary [{CARD}]: {json.dumps(probe)}")
    log(f"aot summary [{CARD}]: {json.dumps(aot)}")
    log(f"trace summary [{CARD}]: {json.dumps(traced)}")
    log(f"phase seconds: {json.dumps(seconds)}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
