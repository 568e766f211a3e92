#!/usr/bin/env python3
"""The fused expert ring against the two all_to_alls at expert parallelism.

    python3 ep_bench.py [--cards 4] [--iters 20] [--cpu]

Starts one process per card (NCCL, ``hvd.init`` through the ``HOROVOD_*``
launcher variables), lays them out as one ep group and times, with CUDA
events on every rank after a barrier (the slowest rank's reading is
kept; fused and unfused alternate as fused, unfused, unfused, fused, and
both readings of each are printed):

1. ``expert_alltoall_ffn`` at one MoE layer of ``bench.py --model moe``
   (8 experts, d_model 1024, d_ff 4096, capacity factor 1.25; the global
   batch of 16 x 1024 tokens split over the ep ranks, so each rank routes
   16384 / ep tokens into a ``(ep, 8 / ep, capacity, 1024)`` bf16
   dispatch buffer), the fused ring against the all_to_all pair, forward
   and forward + backward, beside the pair's two all_to_alls alone and the
   expert body alone on the pair's ``(8 / ep, ep · capacity, 1024)``
   buffer;
2. the MoE LM at those widths (12 layers, 8 heads, vocab 32000, bf16,
   flash attention, fp32 parameters) over the ep group, forward +
   backward of CE + 0.01 · aux on this rank's 16 / ep rows, fused against
   unfused.

Weights and tokens are random, from a fixed seed.  Prints the card's name
and power limit, then one JSON object with every reading.  ``--cpu`` runs
the same program over gloo on the CPU at a small size (a check of the
program, whose times mean nothing).  Stops every process it starts.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

FULL = dict(batch=16, seq=1024, heads=8, layers=12, d_model=1024, d_ff=4096,
            experts=8, moe_every=2, capacity_factor=1.25, vocab=32_000,
            aux=0.01)
SMALL = dict(FULL, batch=8, seq=32, heads=2, layers=2, d_model=64, d_ff=128,
             vocab=256)
ABBA = (True, False, False, True)         # fused?, in the order timed


def _ms(torch, dist, fn, iters: int) -> float:
    """Mean ms of ``fn`` on this rank, after warm-up and a barrier; the
    slowest rank's mean is returned on every rank."""
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    for _ in range(3):
        fn()
    if cuda:
        torch.cuda.synchronize()
    dist.barrier()
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    else:
        t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    if cuda:
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
    else:
        ms = (time.perf_counter() - t0) * 1e3 / iters
    t = torch.tensor([ms], device="cuda" if cuda else "cpu")
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def worker(iters: int, cpu: bool) -> None:
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.moe import (
        MoEConfig,
        MoETransformerLM,
        _expert_mlp,
        moe_aux_loss,
    )
    from horovod_tpu_torch.models.transformer import lm_loss
    from horovod_tpu_torch.ops.fused_collectives import expert_alltoall_ffn
    from horovod_tpu_torch.parallel.expert import moe_capacity
    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh

    size = SMALL if cpu else FULL
    hvd.init(device="cpu" if cpu else None)
    dev, rank, ep = hvd.device(), hvd.rank(), hvd.size()
    mesh = make_parallel_mesh(ep=ep)
    group = mesh.group("ep")
    d, f, e = size["d_model"], size["d_ff"], size["experts"]
    e_local = e // ep
    tokens_local = size["batch"] * size["seq"] // ep
    cap = moe_capacity(tokens_local, e, size["capacity_factor"])
    gen = torch.Generator(device=dev).manual_seed(rank)

    def rand(*shape, scale=1.0, grad=False):
        x = (torch.randn(shape, generator=gen, device=dev) * scale)
        return x.bfloat16().requires_grad_(grad)

    disp = rand(ep, e_local, cap, d, grad=True)
    w1 = rand(e_local, d, f, scale=(e * d) ** -0.5, grad=True)
    w2 = rand(e_local, f, d, scale=(e * f) ** -0.5, grad=True)
    g_out = rand(ep, e_local, cap, d)

    def expert_fn(buffers):
        return _expert_mlp(buffers, w1, w2)

    def exchange(fused):
        with torch.no_grad():
            expert_alltoall_ffn(disp, expert_fn, group, fused=fused,
                                params=(w1, w2))

    def exchange_backward(fused):
        out = expert_alltoall_ffn(disp, expert_fn, group, fused=fused,
                                  params=(w1, w2))
        torch.autograd.grad(out, (disp, w1, w2), g_out)

    def pair_alone():
        got = torch.empty_like(disp)
        dist.all_to_all_single(got, disp.detach(), group=group)
        dist.all_to_all_single(torch.empty_like(got), got, group=group)

    body_in = rand(e_local, ep * cap, d)

    def body_alone():
        with torch.no_grad():
            expert_fn(body_in)

    out = {"cards": ep, "device": str(dev),
           "dispatch": [ep, e_local, cap, d], "d_ff": f, "exchange": {}}
    for label, fn in (("forward", exchange),
                      ("forward_backward", exchange_backward)):
        for fused in ABBA:
            out["exchange"].setdefault(
                f"{label}_{'fused' if fused else 'unfused'}_ms", []).append(
                _ms(torch, dist, lambda: fn(fused), iters))
    out["exchange"]["all_to_all_pair_ms"] = _ms(torch, dist, pair_alone,
                                                iters)
    out["exchange"]["expert_body_ms"] = _ms(torch, dist, body_alone, iters)
    del disp, w1, w2, g_out, body_in

    model_ms = {}
    for fused in ABBA:
        cfg = MoEConfig(vocab_size=size["vocab"], num_layers=size["layers"],
                        num_heads=size["heads"], d_model=d, d_ff=f,
                        max_seq_len=size["seq"], dtype=torch.bfloat16,
                        attention_impl="dense" if cpu else "flash",
                        num_experts=e, capacity_factor=size["capacity_factor"],
                        moe_every=size["moe_every"],
                        fused_dispatch="on" if fused else "off")
        model = MoETransformerLM(cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(0), ep_group=group)
        rows = size["batch"] // ep
        batch = torch.randint(0, cfg.vocab_size, (rows, size["seq"] + 1),
                              device=dev, generator=torch.Generator(
                                  device=dev).manual_seed(1 + rank))

        def forward_backward():
            model.zero_grad(set_to_none=True)
            (lm_loss(model, batch)
             + size["aux"] * moe_aux_loss(model)).backward()

        model_ms.setdefault(
            f"forward_backward_{'fused' if fused else 'unfused'}_ms",
            []).append(_ms(torch, dist, forward_backward,
                           max(3, iters // 2)))
        del model
    out["moe_lm"] = dict(model_ms, rows_a_rank=size["batch"] // ep,
                         layers=size["layers"])
    if not cpu:
        torch.cuda.synchronize()
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if rank == 0:
        print(json.dumps(out), flush=True)
    hvd.shutdown()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo processes on the CPU at a small size")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.iters, args.cpu)
        return 0

    import torch

    if not args.cpu:
        if torch.cuda.device_count() < args.cards:
            print(f"ep_bench: needs {args.cards} CUDA cards, found "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 1
        from horovod_tpu_torch.ops import build

        build.build()                 # once, before the ranks load it
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip(),
              flush=True)
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
             "--iters", str(args.iters)] + (["--cpu"] if args.cpu else []),
            env=env))
    deadline = time.monotonic() + args.timeout
    rcs = []
    try:
        for p in procs:
            rcs.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        print("ep_bench: timed out", file=sys.stderr)
        rcs.append(124)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return max(rcs) if any(rcs) else 0


if __name__ == "__main__":
    sys.exit(main())
