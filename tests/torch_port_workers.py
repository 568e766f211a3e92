"""Multi-process worlds for the PyTorch port's tests (imported by the
``test_torch_*`` files; not collected itself).

:func:`spawn_world` starts ``world`` fresh processes (``spawn``), each of
which initializes ``horovod_tpu_torch`` through the launcher's environment
contract — on the CPU over gloo, or one card per rank over NCCL — runs one
of the functions below and sends its result back.  Only torch and numpy
are imported here, so a worker starts without JAX.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import socket
import time
import traceback

import numpy as np


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(fn_name, rank, world, port, results, args, device):
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(world),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_LOCAL_SIZE=str(world),
                      HOROVOD_COORDINATOR_ADDR=f"localhost:{port}")
    try:
        import horovod_tpu_torch as hvd

        hvd.init(device=device)
        try:
            results.put((rank, True, globals()[fn_name](hvd, *args)))
        finally:
            hvd.shutdown()
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn_world(fn_name: str, world: int = 2, args=(),
                timeout: float = 120.0, device: str = "cpu") -> list:
    """Run ``fn_name(hvd, *args)`` on every rank of a world on ``device``
    (``"cpu"``: gloo; ``"cuda"``: NCCL, card ``rank`` for rank ``rank``);
    returns the results ordered by rank, or raises with a failing rank's
    traceback."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker,
                         args=(fn_name, r, world, port, results, args,
                               device))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:       # drain before joining
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} exited without a "
                                       f"result")
                if time.monotonic() > deadline:
                    raise RuntimeError(f"world of {world} timed out after "
                                       f"{timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            got[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [got[r] for r in range(world)]


# ---------------------------------------------------------------------------
# inputs shared by the workers and the tests
# ---------------------------------------------------------------------------

def exchange_inputs(rank: int):
    """Rank ``rank``'s tensors for the exchange tests: two fp32 tensors of
    odd sizes, one bf16, one int32."""
    rng = np.random.RandomState(100 + rank)
    return [rng.randn(3, 7).astype(np.float32),
            rng.randn(11).astype(np.float32),
            rng.randn(5).astype(np.float32),
            rng.randint(-50, 50, (4,)).astype(np.int32)]


#: (op name, prescale, postscale, compression name) cases of the exchange
EXCHANGE_CASES = [("Average", None, None, None), ("Sum", None, None, None),
                  ("Average", 0.5, 3.0, None), ("Sum", 0.25, None, None),
                  ("Average", None, None, "fp16"),
                  ("Average", 0.5, 2.0, "bf16"), ("Max", None, None, None)]


def _bf16(x):
    import torch

    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def exchange_expected(case, world):
    """numpy oracle of grouped_allreduce over ``world`` ranks' inputs."""
    op, pre, post, _ = case
    ins = [exchange_inputs(r) for r in range(world)]
    out = []
    for j in range(4):
        xs = [x[j] for x in ins]
        if j == 2:
            xs = [_bf16(x) for x in xs]
        if op == "Max":
            out.append(np.max(xs, axis=0))
            continue
        if j == 3:          # int32: scaled through doubles, truncated
            xs = [(x * (pre or 1.0)).astype(np.int32) for x in xs]
            total = np.sum(xs, axis=0)
            f = (post or 1.0) / (world if op == "Average" else 1)
            out.append((total * f).astype(np.int32))
            continue
        total = np.sum([x.astype(np.float64) * (pre or 1.0) for x in xs],
                       axis=0)
        f = (post or 1.0) / (world if op == "Average" else 1)
        out.append(total * f)
    return out


def exchange_tolerance(case, j):
    """fp32: a few roundings (1e-5); the bf16 tensor or a bf16 wire: bf16
    rounding of inputs and of the sum (2e-2); an fp16 wire: 2e-3."""
    comp = case[3]
    if j == 3:
        return 0.0, 0.0
    if j == 2 or comp == "bf16":
        return 2e-2, 2e-2
    if comp == "fp16":
        return 2e-3, 2e-3
    return 1e-5, 1e-5


def check_exchange(got, case, world):
    for j, (g, want) in enumerate(zip(got, exchange_expected(case, world))):
        rtol, atol = exchange_tolerance(case, j)
        np.testing.assert_allclose(np.asarray(g, np.float64), want,
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{case} {j}")


def run_exchange(hvd):
    import torch

    from horovod_tpu_torch.ops.collectives import ReduceOp

    dev = hvd.device()
    xs = exchange_inputs(hvd.rank())
    out = {}
    for i, (op, pre, post, comp) in enumerate(EXCHANGE_CASES):
        ts = [torch.from_numpy(x).to(dev) for x in xs]
        ts[2] = ts[2].to(torch.bfloat16)
        red = hvd.grouped_allreduce(
            ts, op=ReduceOp[op.upper()], prescale_factor=pre,
            postscale_factor=post,
            compression=getattr(hvd.Compression, comp) if comp else None)
        out[i] = [(r.float() if r.is_floating_point() else r).cpu().numpy()
                  for r in red]
    out["allgather"] = hvd.allgather(
        torch.from_numpy(xs[0]).to(dev)).cpu().numpy()
    out["broadcast"] = hvd.broadcast(torch.from_numpy(xs[1]).to(dev),
                                     root_rank=1).cpu().numpy()
    tree = {"w": torch.from_numpy(xs[0]).to(dev),
            "b": [torch.from_numpy(xs[1]).to(dev)]}
    hvd.broadcast_variables(tree, root_rank=0)
    out["broadcast_variables"] = [tree["w"].cpu().numpy(),
                                  tree["b"][0].cpu().numpy()]
    out["broadcast_object"] = hvd.broadcast_object(
        {"rank": hvd.rank()}, root_rank=1)
    hvd.barrier()
    return out


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

# head_dim 64: a size the CUDA flash kernels take
TRAIN_SIZES = dict(vocab_size=128, num_layers=2, num_heads=2, d_model=128,
                   d_ff=512, max_seq_len=32)


def train_tokens():
    return np.random.RandomState(7).randint(0, 128, (4, 33)).astype(np.int64)


def run_train(hvd, steps: int, seed: int = 0, init_rank_seed: bool = False):
    """``steps`` AdamW steps of DistributedTrainStep on the global batch of
    :func:`train_tokens`; returns (losses, state_dict as numpy).  With
    ``init_rank_seed`` each rank draws different weights, which the step's
    ``init`` must overwrite with rank 0's.  fp32 on the CPU, bf16 compute
    (the flash kernels' type) on a card."""
    import torch

    from horovod_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        lm_loss,
    )

    dev = hvd.device()
    cfg = TransformerConfig(
        dtype=torch.float32 if dev.type == "cpu" else torch.bfloat16,
        attention_impl="flash", **TRAIN_SIZES)
    gen_seed = seed + (hvd.rank() if init_rank_seed else 0)
    model = TransformerLM(cfg, generator=torch.Generator().manual_seed(
        gen_seed)).to(dev)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4)
    step = hvd.DistributedTrainStep(lambda m, b: lm_loss(m, b), opt)
    model, opt = step.init(model)
    batch = step.shard_batch(train_tokens())
    losses = []
    for _ in range(steps):
        model, opt, loss = step(model, opt, batch)
        losses.append(float(loss))
    return losses, {k: v.cpu().numpy().copy() for k, v in
                    model.state_dict().items()}


def resnet_batch(n: int, image: int, seed: int):
    """``n`` NHWC fp32 images in [0, 1) and int64 labels of 10 classes."""
    rng = np.random.RandomState(seed)
    return (rng.rand(n, image, image, 3).astype(np.float32),
            rng.randint(0, 10, (n,)).astype(np.int64))


def run_train_resnet(hvd, steps: int):
    """``steps`` SGD(0.01, momentum=0.9) steps of DistributedTrainStep on a
    narrow fp32 ResNet (two stages of one block, 128 filters, s2d,
    fused_bwd, inference-mode BN) over the global batch of 8 images of
    32 px; each rank draws different weights, which ``init`` overwrites
    with rank 0's.  Returns (losses, state_dict as numpy)."""
    import torch

    from horovod_tpu_torch.models.resnet import ResNet, resnet_loss

    model = ResNet([1, 1], num_classes=10, num_filters=128,
                   space_to_depth=True, fused_bwd=True,
                   generator=torch.Generator().manual_seed(hvd.rank()))
    with torch.no_grad():       # move BN off its init, where the last
        for n, p in model.named_parameters():     # scale of a block is 0
            if n.endswith((".scale", ".var")):
                p.add_(0.25)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    step = hvd.DistributedTrainStep(resnet_loss, opt)
    model, opt = step.init(model)
    x, y = resnet_batch(8, 32, seed=9)
    batch = step.shard_batch({"x": x, "y": y})
    losses = []
    for _ in range(steps):
        model, opt, loss = step(model, opt, batch)
        losses.append(float(loss))
    return losses, {k: v.cpu().numpy().copy() for k, v in
                    model.state_dict().items()}
