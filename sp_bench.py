#!/usr/bin/env python3
"""The sequence-parallel ring at full width on four cards.

    python3 sp_bench.py [--cards 4] [--iters 10]

Starts one process per card (NCCL, ``hvd.init`` through the ``HOROVOD_*``
launcher variables), lays them out as one sp group and trains the 870.9M
TransformerLM (16 layers, d_model 2048, 16 heads of 128, d_ff 8192, vocab
32000, bf16, fp32 parameters) at seq 4096, batch 1, through
``DistributedTrainStep`` with ``attention_impl="ring"``, 1024 tokens a
rank, in the ``contiguous`` and then the ``zigzag`` layout.  For each it
prints every rank's step time (host clock around a step ending in a device
sync, median over ``--iters`` steps after two warm-up steps), the slowest
rank and tokens/s by it, with each rank's kernel launches a ring pass
(``ring_step_schedule``); beside them the cost of one ring hop (the K and V
blocks of one layer, 2 x 4 MiB, one ``batch_isend_irecv`` pair, CUDA
events).  Then one card trains the same model on the whole sequence
through ``flash_attention`` for comparison.

Weights and tokens are random, from a fixed seed.  Prints the card's name
and power limit, then one JSON object per run.  Needs ``--cards`` CUDA
cards; stops every process it starts.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

FULL = dict(batch=1, seq=4096, heads=16, layers=16, d_model=2048,
            vocab=32_000)


def worker(iters: int) -> None:
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )
    from horovod_tpu_torch.ops import fused_collectives as FC
    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh

    hvd.init()
    dev, rank, sp = hvd.device(), hvd.rank(), hvd.size()
    mesh = make_parallel_mesh(sp=sp)
    group = mesh.group("sp")
    b, t = FULL["batch"], FULL["seq"]
    t_local = t // sp
    hd = FULL["d_model"] // FULL["heads"]
    out = {"cards": sp, "seq": t, "batch": b, "runs": {}}

    if sp > 1:
        gen = torch.Generator(device=dev).manual_seed(rank)
        kv = [torch.randn(b, t_local, FULL["heads"], hd, generator=gen,
                          device=dev).bfloat16() for _ in range(2)]

        def hop():
            _, requests = FC._hop(kv, group, (rank + 1) % sp, (rank - 1) % sp)
            FC._wait(requests)

        for _ in range(3):
            hop()
        torch.cuda.synchronize()
        dist.barrier()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            hop()
        end.record()
        end.synchronize()
        out["hop_ms"] = start.elapsed_time(end) / 20
        out["hop_bytes"] = 2 * kv[0].numel() * 2

    tokens = torch.randint(0, FULL["vocab"], (b, t + 1),
                           generator=torch.Generator().manual_seed(1))
    layouts = FC.RING_LAYOUTS if sp > 1 else ("contiguous",)
    for layout in layouts:
        cfg = TransformerConfig(
            vocab_size=FULL["vocab"], num_layers=FULL["layers"],
            num_heads=FULL["heads"], d_model=FULL["d_model"],
            d_ff=4 * FULL["d_model"], max_seq_len=t, dtype=torch.bfloat16,
            attention_impl="ring" if sp > 1 else "flash", sp_layout=layout)
        model = TransformerLM(cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(0), sp_group=group)
        opt = hvd.DistributedOptimizer(torch.optim.AdamW(
            model.parameters(), lr=3e-4, weight_decay=1e-4))
        positions = FC.ring_layout_positions(rank, sp, t_local, layout,
                                             dev).long()

        def loss_fn(m, batch):
            logits = m(batch["inputs"], positions)
            return F.cross_entropy(
                logits.float().reshape(-1, logits.shape[-1]),
                batch["labels"].reshape(-1))

        step = hvd.DistributedTrainStep(loss_fn, opt, mesh=mesh)
        model, opt = step.init(model)
        order = FC.zigzag_sequence_indices(sp, t) if layout == "zigzag" \
            else slice(None)
        batch = step.shard_batch({"inputs": tokens[:, :-1][:, order],
                                  "labels": tokens[:, 1:][:, order]})
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for i in range(iters + 2):
            dist.barrier()
            t0 = time.perf_counter()
            model, opt, loss = step(model, opt, batch)
            losses.append(float(loss))               # synchronises
            if i >= 2:
                times.append(time.perf_counter() - t0)
        mine = sorted(times)[len(times) // 2] * 1e3
        gathered = [None] * sp
        dist.all_gather_object(gathered, mine)
        slowest = max(gathered)
        out["runs"][layout if sp > 1 else "flash"] = {
            "attention": cfg.attention_impl,
            "launches_by_rank": [sp - n for n in FC.ring_step_schedule(
                sp, True, layout)["skipped_by_rank"]],
            "step_ms_by_rank": gathered,
            "slowest_rank": gathered.index(slowest), "step_ms": slowest,
            "tokens_per_s": b * t / (slowest / 1e3), "losses": losses,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        del model, opt, step, batch
        torch.cuda.empty_cache()
    if rank == 0:
        print(json.dumps(out), flush=True)
    hvd.shutdown()


def _launch(cards: int, iters: int, timeout: float) -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(cards):
        env = dict(os.environ, HOROVOD_RANK=str(rank),
                   HOROVOD_SIZE=str(cards), HOROVOD_LOCAL_RANK=str(rank),
                   HOROVOD_LOCAL_SIZE=str(cards),
                   HOROVOD_COORDINATOR_ADDR=f"localhost:{port}")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--iters", str(iters)], env=env))
    deadline = time.monotonic() + timeout
    rcs = []
    try:
        for p in procs:
            rcs.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        print("sp_bench: timed out", file=sys.stderr)
        rcs.append(124)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return max(rcs) if any(rcs) else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.iters)
        return 0

    import torch

    if torch.cuda.device_count() < args.cards:
        print(f"sp_bench: needs {args.cards} CUDA cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    from horovod_tpu_torch.ops import build

    build.build()                     # once, before the ranks load it
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    rc = _launch(args.cards, args.iters, args.timeout)
    if rc or args.cards == 1:
        return rc
    return _launch(1, args.iters, args.timeout)


if __name__ == "__main__":
    sys.exit(main())
