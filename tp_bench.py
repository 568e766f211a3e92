#!/usr/bin/env python3
"""Tile-fused against unfused tensor-parallel boundary collectives.

    python3 tp_bench.py [--cards 4] [--iters 20]

Starts one process per card (NCCL, ``hvd.init`` through the ``HOROVOD_*``
launcher variables), lays them out as one tp group and times, with CUDA
events on every rank after a barrier (the slowest rank's reading is
kept; fused and unfused alternate as fused, unfused, unfused, fused, and
both readings of each are printed):

1. ``allgather_matmul`` and ``matmul_reducescatter`` at the 870.9M
   TransformerLM's four projections as ``fused_tp_apply`` shards them
   (6144 tokens, batch 6 x seq 1024), the fused ring against the unfused
   pair (``all_gather_into_tensor`` then the kernel, or the kernel then
   ``reduce_scatter_tensor``), forward only, beside the unfused pair's
   product alone (the kernel on the full-token operand);
2. ``fused_tp_apply`` at full width (16 layers, d_model 2048, 16 heads,
   d_ff 8192, vocab 32000, bf16, flash attention), forward and forward +
   backward of the next-token loss, fused against unfused.

Weights and tokens are random, from a fixed seed.  Prints the card's name
and power limit, then one JSON object with every reading.  Needs
``--cards`` CUDA cards; stops every process it starts.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

FULL = dict(batch=6, seq=1024, heads=16, layers=16, d_model=2048,
            vocab=32_000)
ABBA = (True, False, False, True)         # fused?, in the order timed


def _ms(torch, dist, fn, iters: int) -> float:
    """Mean ms of ``fn`` on this rank, after warm-up and a barrier; the
    slowest rank's mean is returned on every rank."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    dist.barrier()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    t = torch.tensor([start.elapsed_time(end) / iters], device="cuda")
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def worker(iters: int) -> None:
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        fused_tp_apply,
    )
    from horovod_tpu_torch.ops import fused_collectives as FC
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh

    hvd.init()
    dev, rank, tp = hvd.device(), hvd.rank(), hvd.size()
    mesh = make_parallel_mesh(tp=tp)
    group = mesh.group("tp")
    d, ff = FULL["d_model"], 4 * FULL["d_model"]
    m = FULL["batch"] * FULL["seq"]
    gen = torch.Generator(device=dev).manual_seed(rank)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).bfloat16()

    # (name, op, rows of x on this rank, k, n) as fused_tp_apply calls them
    ops = [("qkv", "allgather", m // tp, d, 3 * d // tp),
           ("proj", "reducescatter", m, d // tp, d),
           ("wi", "allgather", m // tp, d, ff // tp),
           ("wo", "reducescatter", m, ff // tp, d)]
    out = {"cards": tp, "ops": {}}
    for name, op, rows, k, n in ops:
        x, w = rand(rows, k), rand(k, n, scale=k ** -0.5)
        full = rand(rows * tp, k) if op == "allgather" else x
        fn = FC.allgather_matmul if op == "allgather" else \
            FC.matmul_reducescatter
        r = {"op": op, "x": [rows, k], "w": [k, n], "fused_ms": [],
             "unfused_ms": []}
        for fused in ABBA:
            r["fused_ms" if fused else "unfused_ms"].append(_ms(
                torch, dist, lambda: fn(x, w, group, fused=fused), iters))
        r["kernel_ms"] = _ms(torch, dist, lambda: K.pallas_matmul(full, w),
                             iters)
        out["ops"][name] = r
        del x, w, full

    cfg = TransformerConfig(vocab_size=FULL["vocab"],
                            num_layers=FULL["layers"],
                            num_heads=FULL["heads"], d_model=d, d_ff=ff,
                            max_seq_len=FULL["seq"], dtype=torch.bfloat16,
                            attention_impl="flash")
    model = TransformerLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size,
                           (FULL["batch"], FULL["seq"] + 1), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))

    def forward(fused):
        with torch.no_grad():
            fused_tp_apply(model, cfg, tokens[:, :-1], fused=fused, mesh=mesh)

    def forward_backward(fused):
        model.zero_grad(set_to_none=True)
        logits = fused_tp_apply(model, cfg, tokens[:, :-1], fused=fused,
                                mesh=mesh)
        F.cross_entropy(logits.float().reshape(-1, cfg.vocab_size),
                        tokens[:, 1:].reshape(-1)).backward()

    model_ms = {}
    for label, fn in (("forward", forward),
                      ("forward_backward", forward_backward)):
        for fused in ABBA:
            model_ms.setdefault(
                f"{label}_{'fused' if fused else 'unfused'}_ms", []).append(
                _ms(torch, dist, lambda: fn(fused), max(3, iters // 2)))
    torch.cuda.synchronize()
    out["fused_tp_apply"] = model_ms
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if rank == 0:
        print(json.dumps(out), flush=True)
    hvd.shutdown()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.iters)
        return 0

    import torch

    if torch.cuda.device_count() < args.cards:
        print(f"tp_bench: needs {args.cards} CUDA cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    from horovod_tpu_torch.ops import build

    build.build()                     # once, before the ranks load it
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(args.cards):
        env = dict(os.environ, HOROVOD_RANK=str(rank),
                   HOROVOD_SIZE=str(args.cards),
                   HOROVOD_LOCAL_RANK=str(rank),
                   HOROVOD_LOCAL_SIZE=str(args.cards),
                   HOROVOD_COORDINATOR_ADDR=f"localhost:{port}")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--iters", str(args.iters)], env=env))
    deadline = time.monotonic() + args.timeout
    rcs = []
    try:
        for p in procs:
            rcs.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        print("tp_bench: timed out", file=sys.stderr)
        rcs.append(124)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return max(rcs) if any(rcs) else 0


if __name__ == "__main__":
    sys.exit(main())
