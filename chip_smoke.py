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
16. print the card's name and power limit, the kernels' JSON line, and last
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.  Needs one card.
"""

from __future__ import annotations

import bisect
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
# the sharded exchange's record_function ranges (ops/collectives.py,
# optim/optimizer.py) and the parts of a step they name
ZERO_RANGES = {"hvd.reduce_scatter": "reduce-scatter",
               "hvd.wire_codec": "codec passes",
               "hvd.allgather": "allgather",
               "hvd.shard_update": "shard AdamW"}
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
        if us > 0 and not re.fullmatch(r"[\w.]+#[\w.]+", e.key) and \
                e.key not in ZERO_RANGES and \
                str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((us / 1e3, e.count, e.key))
    return rows


def range_kernels(event) -> list:
    """(name, device us) of the kernels a host-side profiler event and its
    children launched.  The device side of an annotation (a
    ``record_function`` range, "Optimizer.step#AdamW.step") may be filed
    among an event's kernels; it spans kernels counted already, so it is
    left out (``FunctionEvent.device_time_total`` keeps it: on the
    sharded phase it read more than the step)."""
    own = [(k.name, k.duration) for k in event.kernels
           if k.name not in ZERO_RANGES and
           not re.fullmatch(r"[\w.]+#[\w.]+", k.name)]
    return own + [k for c in event.cpu_children for k in range_kernels(c)]


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

    lib_path = build.build()
    build.load_library()
    log(f"build: {build.build_seconds:.1f} s -> {lib_path.name}")
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
        span = dict.fromkeys(ranges.values(), 0.0)
        top: dict = {part: {} for part in ranges.values()}
        for part in ranges.values():
            split[part] = 0.0
        for e in prof.events():
            if e.name not in ranges:
                continue
            part = ranges[e.name]
            if str(e.device_type).endswith("CPU"):
                for name, us in range_kernels(e):
                    split[part] += us / 1e3
                    top[part][name] = top[part].get(name, 0.0) + us / 1e3
            else:
                span[part] += e.time_range.elapsed_us() / 1e3
        split["rest"] = busy - sum(split[p] for p in ranges.values())
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
           adasum: bool = False, plan=None) -> dict:
    """Phase 4's five-line recipe at full width on this process's card:
    the seeded 870.9M TransformerLM, ``DistributedOptimizer(AdamW(3e-4,
    weight_decay=1e-4), gradient_predivide_factor=2.0)`` on the hook path,
    ``init`` and ``steps`` steps on the seeded batch; ``on_step(i, model)``
    after each.  With ``adasum`` the optimizer is
    ``DistributedAdasumOptimizer(AdamW(3e-4, weight_decay=1e-4))`` and the
    step ``DistributedTrainStep(op=None)`` (phase 13 (a)).  With ``plan``
    the model is built with the tp group of ``plan.build_mesh()`` and the
    step is ``DistributedTrainStep(mode="pjit", plan=plan, mesh=...)``
    (phase 15 (a)).  Returns the
    model, the wrapper, the step, the batch, the losses, each step's
    seconds and bucket sources, the wall clock at the first step's end,
    the launch counts from ``init`` on and the peak memory."""
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.ops import kernels as K

    dev = hvd.device()
    cfg = full_config(torch, "flash")
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
    adamw = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4)
    if adasum:
        opt = hvd.DistributedAdasumOptimizer(adamw)
    else:
        opt = hvd.DistributedOptimizer(adamw, gradient_predivide_factor=2.0)

    def loss_fn(m, batch):
        return lm_loss(m, batch)

    step = hvd.DistributedTrainStep(loss_fn, opt,
                                    op=None if adasum else hvd.Average,
                                    **planned)
    tokens = torch.randint(0, cfg.vocab_size,
                           (FULL["batch"], FULL["seq"] + 1),
                           generator=torch.Generator().manual_seed(SEED))

    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    model, opt = step.init(model)
    batch = step.shard_batch(tokens)
    losses, times, sources, first_end = [], [], [], None
    for i in range(steps):
        t0 = time.perf_counter()
        model, opt, loss = step(model, opt, batch)
        losses.append(float(loss))           # synchronises
        times.append(time.perf_counter() - t0)
        first_end = first_end or time.time()
        sources.append([src for _, src in getattr(opt, "launches", [])])
        if on_step is not None:
            on_step(i, model)
    return dict(cfg=cfg, model=model, opt=opt, step=step, batch=batch,
                loss_fn=loss_fn, losses=losses, times=times,
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
    hvd.shutdown()
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
    hvd.init()
    t_init = time.time()
    r = recipe(torch, hvd)
    steps = len(r["losses"])
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
        init_s=t_init - t_worker, first_end=r["first_end"])
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


def _hvdrun(args, timeout: float) -> subprocess.CompletedProcess:
    """``python -m horovod_tpu_torch.runner ARGS``; past ``timeout`` the
    launcher gets SIGTERM, which ends its workers too, and this raises."""
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", *args]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
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
                launcher_wall_s=wall)


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--launched"]:
        return launched_worker(torch, sys.argv[2])
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    global CARD
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
    counts, train, first, eager, step1_params = timed("4+9 train",
                                                      phase_train, torch)
    resnet_counts, resnet = timed("5 resnet", phase_resnet, torch)
    for name in RESNET_KERNELS:
        counts[name] = resnet_counts[name]
    tp_counts, tp = timed("6 tp", phase_tp_train, torch)
    counts["pallas_matmul"] = tp_counts["pallas_matmul"]
    sp_counts, sp = timed("7 sp", phase_sp_train, torch, first)
    del first
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
