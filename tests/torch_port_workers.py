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

    from horovod_tpu_torch.ops import collectives as C
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
    out["allgather"] = C.allgather(
        torch.from_numpy(xs[0]).to(dev)).cpu().numpy()
    out["broadcast"] = C.broadcast(torch.from_numpy(xs[1]).to(dev),
                                   root_rank=1).cpu().numpy()
    tree = {"w": torch.from_numpy(xs[0]).to(dev),
            "b": [torch.from_numpy(xs[1]).to(dev)]}
    hvd.broadcast_variables(tree, root_rank=0)
    out["broadcast_variables"] = [tree["w"].cpu().numpy(),
                                  tree["b"][0].cpu().numpy()]
    out["broadcast_object"] = hvd.broadcast_object(
        {"rank": hvd.rank()}, root_rank=1)
    C.barrier()
    return out


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

def assert_adam_close(got, want, name, steps=3, lr=3e-4, atol=3e-6):
    """Parameters after ``steps`` AdamW steps agree to ``atol``, except
    elements whose gradient sits at the fp32 noise floor: Adam divides by
    the gradient's own magnitude, so there the two sides may step
    differently.  Those are at most 0.1% of the elements and never more
    than the ``steps`` steps of ``lr`` apart."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (diff > atol).mean() <= 1e-3, (name, float(diff.max()))
    assert diff.max() <= steps * lr * 1.01, (name, float(diff.max()))


# head_dim 64: a size the CUDA flash kernels take
TRAIN_SIZES = dict(vocab_size=128, num_layers=2, num_heads=2, d_model=128,
                   d_ff=512, max_seq_len=32)


def train_tokens():
    return np.random.RandomState(7).randint(0, 128, (4, 33)).astype(np.int64)


def run_train(hvd, steps: int, seed: int = 0, init_rank_seed: bool = False,
              sharded: bool = False):
    """``steps`` AdamW steps of DistributedTrainStep on the global batch of
    :func:`train_tokens`; returns (losses, state_dict as numpy).  With
    ``init_rank_seed`` each rank draws different weights, which the step's
    ``init`` must overwrite with rank 0's; ``sharded`` takes the sharded
    exchange (``shard_optimizer_states=True``).  fp32 on the CPU, bf16
    compute (the flash kernels' type) on a card."""
    losses, params, _ = train_lm(hvd, steps, seed, init_rank_seed,
                                 shard_optimizer_states=sharded)
    return losses, params


def train_lm(hvd, steps: int, seed: int = 0, init_rank_seed: bool = False,
             **opt_kwargs):
    """:func:`run_train` with ``opt_kwargs`` for DistributedOptimizer;
    returns (losses, state_dict as numpy, the wrapped optimizer)."""
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
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4),
        **opt_kwargs)
    step = hvd.DistributedTrainStep(lambda m, b: lm_loss(m, b), opt)
    model, opt = step.init(model)
    batch = step.shard_batch(train_tokens())
    losses = []
    for _ in range(steps):
        model, opt, loss = step(model, opt, batch)
        losses.append(float(loss))
    return losses, {k: v.cpu().numpy().copy() for k, v in
                    model.state_dict().items()}, opt


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


# ---------------------------------------------------------------------------
# tensor parallelism: the ring ops and fused_tp_apply
# ---------------------------------------------------------------------------

# fp32 on the CPU: 4 heads of 16, so tp = 2 and 4 divide heads, seq and d_ff
TP_SIZES = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=64,
                d_ff=128, max_seq_len=16)


def ring_inputs(world: int) -> dict:
    """Per-rank operands of the ring ops, stacked over ranks (dim 0): the
    row-parallel ``x`` (64, 16) and its ``w`` (16, 8), and the
    column-parallel row shard ``xs`` (4, 16), as the JAX package's
    TestFusedMatmulCollectives sizes them, but different on every rank so
    that tile ownership shows."""
    rng = np.random.RandomState(50 + world)
    return {"x": rng.randn(world, 64, 16).astype(np.float32),
            "w": rng.randn(world, 16, 8).astype(np.float32),
            "xs": rng.randn(world, 4, 16).astype(np.float32)}


def _ring_outputs(fc, x, w, xs, group, fused):
    """Both ring ops and the gradients of ``sum(rs²) + sum(ag²)``."""
    xg, wg, xsg = (t.detach().clone().requires_grad_() for t in (x, w, xs))
    rs = fc.matmul_reducescatter(xg, wg, group, fused=fused)
    ag = fc.allgather_matmul(xsg, wg, group, fused=fused)
    (rs.float().pow(2).sum() + ag.float().pow(2).sum()).backward()
    return {"rs": rs.detach().float().cpu().numpy(),
            "ag": ag.detach().float().cpu().numpy(),
            "grads": [t.grad.float().cpu().numpy() for t in (xg, wg, xsg)]}


def run_tp(hvd, params, tokens):
    """On a gloo world: the mesh layout, both ring ops fused and unfused
    with their gradients on :func:`ring_inputs`, a bf16 reduce-scatter,
    and ``fused_tp_apply``'s logits at tp = world for the flax ``params`` (as
    numpy) in dense and flash attention, fused and unfused."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.models import transformer as TT
    from horovod_tpu_torch.models.convert import params_from_flax
    from horovod_tpu_torch.ops import fused_collectives as FC
    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh

    world, rank = hvd.size(), hvd.rank()
    mesh = make_parallel_mesh(tp=world)
    group = mesh.group("tp")
    out = {"coords": mesh.coords,
           "tp_ranks": dist.get_process_group_ranks(group)}
    if world == 4:
        m2 = make_parallel_mesh(tp=2)
        out["dp2tp2"] = (m2.coords, m2.shape,
                         dist.get_process_group_ranks(m2.group("tp")),
                         dist.get_process_group_ranks(m2.group("dp")))
    inp = {k: torch.from_numpy(v[rank]) for k, v in
           ring_inputs(world).items()}
    for fused in (True, False):
        out[fused] = _ring_outputs(FC, inp["x"], inp["w"], inp["xs"], group,
                                   fused)
    out["rs_bf16"] = FC.matmul_reducescatter(
        inp["x"].bfloat16(), inp["w"].bfloat16(), group).float().numpy()
    out["launches"] = (FC.matmul_reducescatter.launches,
                       FC.allgather_matmul.launches)
    tok = torch.from_numpy(tokens).long()
    for impl in ("dense", "flash"):
        cfg = TT.TransformerConfig(dtype=torch.float32, attention_impl=impl,
                                   **TP_SIZES)
        model = TT.TransformerLM(cfg)
        model.load_state_dict(params_from_flax(params))
        with torch.no_grad():
            for fused in (True, False):
                out[("logits", impl, fused)] = TT.fused_tp_apply(
                    model, cfg, tok, fused=fused, mesh=mesh).numpy()
    try:
        TT.fused_tp_apply(model, cfg, tok[:, :world + 1], mesh=mesh)
    except ValueError as e:
        out["divisibility_error"] = str(e)
    return out


# on-contract at tp = 4: d_model/4 = 128 (one head of 128 per rank),
# d_ff/4 = 512 and 3·d_model/4 = 384 are multiples of 128
TP_NCCL_SIZES = dict(vocab_size=512, num_layers=2, num_heads=4, d_model=512,
                     d_ff=2048, max_seq_len=256)


def run_tp_nccl(hvd):
    """On a world of cards: ``fused_tp_apply`` at tp = world and at tp = 1
    on the same bf16 weights (flash attention), and both ring ops fused and
    unfused on on-contract bf16 operands; returns what the test compares
    and the kernel's launches."""
    import torch

    from horovod_tpu_torch.models import transformer as TT
    from horovod_tpu_torch.ops import fused_collectives as FC
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh

    dev, rank = hvd.device(), hvd.rank()
    mesh = make_parallel_mesh(tp=hvd.size())
    group = mesh.group("tp")
    cfg = TT.TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                               **TP_NCCL_SIZES)
    model = TT.TransformerLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device=dev,
                           generator=torch.Generator(
                               device=dev).manual_seed(1))
    K.reset_launch_counts()
    with torch.no_grad():
        tp = TT.fused_tp_apply(model, cfg, tokens, fused=True, mesh=mesh)
        launches = K.pallas_matmul.launches
        one = TT.fused_tp_apply(model, cfg, tokens, fused=True)
    out = {"logits_tp": tp.float().cpu().numpy(),
           "logits_1": one.float().cpu().numpy(), "launches": launches}
    gen = torch.Generator(device=dev).manual_seed(10 + rank)
    x = torch.randn(512, 256, device=dev, generator=gen).bfloat16()
    w = (torch.randn(256, 384, device=dev, generator=gen) / 16).bfloat16()
    xs = torch.randn(128, 256, device=dev, generator=gen).bfloat16()
    for fused in (True, False):
        out[fused] = _ring_outputs(FC, x, w, xs, group, fused)
    return out


# ---------------------------------------------------------------------------
# sequence parallelism: the sp ring, Ulysses and sp as a plan axis
# ---------------------------------------------------------------------------

#: (sp, global seq, causal, layout) of the fused ring's cases: the JAX
#: package's TestRingFlashParity grid, the tile-straddling shard lengths 8
#: and 40, and single-query shards (TestRingNaNGuard)
FUSED_RING_CASES = [(sp, t, causal, layout)
                    for sp, t in ((2, 64), (4, 128), (4, 96))
                    for causal in (False, True)
                    for layout in ("contiguous", "zigzag")] + \
    [(2, 16, True, "contiguous"), (2, 80, True, "contiguous"),
     (4, 4, True, "contiguous")]
#: the plain ring's cases, against the JAX jnp ring
PLAIN_RING_CASES = [(4, 64, False, "contiguous"), (4, 64, True, "contiguous"),
                    (4, 64, True, "zigzag"), (2, 64, True, "contiguous"),
                    (4, 4, True, "contiguous")]
#: Ulysses at sequences off the tile grid over 4 shards (t_local 6 and 34)
ULYSSES_CASES = [(4, t, causal) for t in (24, 136) for causal in (False, True)]
#: the sp TransformerLM: (sp, attention_impl, layout)
SP_LM_CASES = [(2, "ring", "contiguous"), (2, "ring", "zigzag"),
               (4, "ring", "contiguous"), (4, "ring", "zigzag"),
               (4, "ulysses", "contiguous")]


def sp_qkv(t: int, seed: int = 0, b: int = 2, h: int = 4, d: int = 16):
    """Global fp32 ``(b, t, h, d)`` q, k, v and an output cotangent g."""
    rng = np.random.RandomState(seed + t)
    return [rng.randn(b, t, h, d).astype(np.float32) for _ in range(4)]


def sp_order(world: int, t: int, layout: str) -> np.ndarray:
    """The global sequence order whose contiguous sharding gives each rank
    its ``layout`` shard."""
    if layout == "contiguous":
        return np.arange(t)
    from horovod_tpu_torch.ops.fused_collectives import \
        zigzag_sequence_indices

    return zigzag_sequence_indices(world, t).numpy()


def sp_shard(x: np.ndarray, world: int, rank: int, layout: str):
    """Rank ``rank``'s shard (dim 1) of the global ``x`` under ``layout``."""
    t = x.shape[1]
    x = x[:, sp_order(world, t, layout)]
    n = t // world
    return np.ascontiguousarray(x[:, rank * n:(rank + 1) * n])


def _attn_grads(fn, q, k, v, g):
    """``fn``'s output and the q, k, v gradients for the cotangent g."""
    import torch

    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*leaves)
    out.backward(torch.from_numpy(g))
    return [out.detach().numpy()] + [a.grad.numpy() for a in leaves]


SP_TRAIN_SIZES = dict(vocab_size=64, num_layers=1, num_heads=4, d_model=32,
                      d_ff=128, max_seq_len=32)


def sp_train_rows():
    """4 sequences of 33 tokens: the global batch of the sp train step."""
    return np.random.RandomState(0).randint(0, 64, (4, 33)).astype(np.int64)


def _sp_train(hvd, plan, impl, rows, mesh=None):
    """3 AdamW steps of DistributedTrainStep under ``plan`` (and ``mesh``)
    on ``{"inputs", "labels"}`` of ``rows``; the model runs over the
    mesh's sp group.  Returns (losses, state_dict as numpy)."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.models import transformer as TT

    cfg = TT.TransformerConfig(dtype=torch.float32, attention_impl=impl,
                               **SP_TRAIN_SIZES)
    model = TT.TransformerLM(
        cfg, generator=torch.Generator().manual_seed(0),
        sp_group=mesh.group("sp") if mesh is not None else None)

    def loss_fn(m, batch):
        inputs = batch["inputs"]
        t = inputs.shape[1]
        positions = step.mesh.index("sp") * t + torch.arange(t)
        logits = m(inputs, positions)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               batch["labels"].reshape(-1))

    step = hvd.DistributedTrainStep(
        loss_fn, torch.optim.AdamW(model.parameters(), lr=1e-2), plan=plan,
        mesh=mesh)
    model, opt = step.init(model)
    batch = step.shard_batch({"inputs": rows[:, :-1], "labels": rows[:, 1:]})
    losses = []
    for _ in range(3):
        model, opt, loss = step(model, opt, batch)
        losses.append(float(loss))
    return losses, {k: v.numpy().copy() for k, v in model.state_dict().items()}


def run_sp(hvd, params, tokens):
    """On a gloo world: the fused ring, the plain ring and Ulysses on their
    cases of this world's size (outputs and q/k/v gradients of this rank's
    shard), the sp TransformerLM's logits, loss and averaged gradients for
    the flax ``params`` on ``tokens``, and at a world of 4 the train step
    under ``plan="dp=2,sp=2"`` beside its dp-only dense twin and the plans
    the step rejects."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from horovod_tpu_torch.models import transformer as TT
    from horovod_tpu_torch.models.convert import params_from_flax
    from horovod_tpu_torch.ops import fused_collectives as FC
    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh
    from horovod_tpu_torch.parallel.ring_attention import (
        _PlainRing,
        ring_attention,
    )
    from horovod_tpu_torch.parallel.ulysses import ulysses_attention

    # one intra-op thread a rank: the ranks' thread pools would otherwise
    # oversubscribe the host's cores (21.7 s against 2.5 s at a world of 4)
    torch.set_num_threads(1)
    world, rank = hvd.size(), hvd.rank()
    group = make_parallel_mesh(sp=world).group("sp")
    out = {}

    def shards(case_t, layout):
        return [sp_shard(a, world, rank, layout) for a in sp_qkv(case_t)]

    for case in FUSED_RING_CASES:
        sp, t, causal, layout = case
        if sp == world:
            before = FC.ring_flash_attention.launches
            out[("fused",) + case] = _attn_grads(
                lambda q, k, v: ring_attention(q, k, v, group, causal=causal,
                                               layout=layout),
                *shards(t, layout))
            out[("fused_launches",) + case] = \
                FC.ring_flash_attention.launches - before
    for case in PLAIN_RING_CASES:
        sp, t, causal, layout = case
        if sp == world:
            before = FC.ring_flash_attention.launches
            out[("plain",) + case] = _attn_grads(
                lambda q, k, v: _PlainRing.apply(q, k, v, group, causal,
                                                 q.shape[-1] ** -0.5, layout),
                *shards(t, layout))
            assert FC.ring_flash_attention.launches == before
    for case in ULYSSES_CASES:
        sp, t, causal = case
        if sp == world:
            out[("ulysses",) + case] = _attn_grads(
                lambda q, k, v: ulysses_attention(q, k, v, group,
                                                  causal=causal),
                *shards(t, "contiguous"))

    state = params_from_flax(params)
    for case in SP_LM_CASES:
        sp, impl, layout = case
        if sp != world:
            continue
        cfg = TT.TransformerConfig(dtype=torch.float32, attention_impl=impl,
                                   sp_layout=layout, **TP_SIZES)
        model = TT.TransformerLM(cfg, sp_group=group)
        model.load_state_dict(state)
        inputs = torch.from_numpy(sp_shard(tokens[:, :-1], world, rank,
                                           layout))
        labels = torch.from_numpy(sp_shard(tokens[:, 1:], world, rank,
                                           layout))
        t_local = inputs.shape[1]
        positions = FC.ring_layout_positions(rank, world, t_local, layout)
        logits = model(inputs.long(), positions)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.long().reshape(-1))
        loss.backward()
        grads = {}
        for name, p in model.named_parameters():
            dist.all_reduce(p.grad, group=group)
            grads[name] = (p.grad / world).numpy()
        total = loss.detach().clone()
        dist.all_reduce(total, group=group)
        out[("lm",) + case] = (logits.detach().numpy(),
                               float(total) / world, grads)

    if world == 4:
        rows = sp_train_rows()
        mesh = make_parallel_mesh(dp=2, sp=2)
        out["train_sp"] = _sp_train(hvd, "dp=2,sp=2", "ring", rows, mesh)
        step = hvd.DistributedTrainStep(lambda m, b: m, torch.optim.SGD(
            [torch.zeros(1, requires_grad=True)], lr=0.1), mesh=mesh)
        os.environ["HOROVOD_SP_LAYOUT"] = "zigzag"
        try:
            step.shard_batch(rows)
        except ValueError as e:
            out["zigzag_error"] = str(e)
        finally:
            del os.environ["HOROVOD_SP_LAYOUT"]
        out["train_dense"] = _sp_train(hvd, "dp=4", "dense",
                                       np.tile(rows, (2, 1)))
        errors = {}
        for plan in ("dp=2,tp=2", "pp=2", "ep=2,sp=2", "ep=2,tp=2"):
            try:
                hvd.DistributedTrainStep(lambda m, b: m, torch.optim.SGD(
                    [torch.zeros(1, requires_grad=True)], lr=0.1), plan=plan)
            except ValueError as e:
                errors[plan] = str(e)
        out["plan_errors"] = errors
    return out


# the NCCL sp case: 2 layers, d_model 512, 4 heads of 128, seq 4096 (1024 a
# rank at sp = 4), batch 2, bf16
SP_NCCL_SIZES = dict(vocab_size=512, num_layers=2, num_heads=4, d_model=512,
                     d_ff=2048, max_seq_len=4096)


def _normwise(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def run_sp_nccl(hvd):
    """On a world of cards (sp = world): ``ring_flash_attention`` in both
    layouts, causal, against ``flash_attention`` on the full sequence on
    this rank (output and q/k/v gradients of this rank's shard, normwise),
    and 3 SGD steps of the ring TransformerLM under ``plan="sp=<world>"``
    in both layouts against the same model trained here alone on the full
    sequence through flash attention (losses and parameter updates)."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.models import transformer as TT
    from horovod_tpu_torch.ops import fused_collectives as FC
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh

    dev, rank, world = hvd.device(), hvd.rank(), hvd.size()
    mesh = make_parallel_mesh(sp=world)
    group = mesh.group("sp")
    b, t, h, d = 2, SP_NCCL_SIZES["max_seq_len"], 4, 128
    n = t // world
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, g = (torch.randn(b, t, h, d, generator=gen, device=dev)
                  .bfloat16() for _ in range(4))
    out = {"attention": {}, "train": {}}
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    full = K.flash_attention(*leaves, causal=True)
    full.backward(g)
    want = [full.detach()] + [x.grad for x in leaves]
    for layout in FC.RING_LAYOUTS:
        order = torch.arange(t) if layout == "contiguous" else \
            FC.zigzag_sequence_indices(world, t)
        mine = order[rank * n:(rank + 1) * n].to(dev)
        shard = [x[:, mine].contiguous().requires_grad_() for x in (q, k, v)]
        K.reset_launch_counts()
        o = FC.ring_flash_attention(*shard, group, causal=True,
                                    layout=layout)
        o.backward(g[:, mine].contiguous())
        got = [o.detach()] + [x.grad for x in shard]
        out["attention"][layout] = {
            "normwise": [_normwise(a, w[:, mine]) for a, w in zip(got, want)],
            "finite": bool(torch.isfinite(got[0]).all()),
            "launches": K.launch_counts()}

    tokens = torch.randint(0, SP_NCCL_SIZES["vocab_size"], (b, t + 1),
                           generator=torch.Generator().manual_seed(1))

    def train(impl, layout, step_plan):
        cfg = TT.TransformerConfig(dtype=torch.bfloat16, attention_impl=impl,
                                   sp_layout=layout, **SP_NCCL_SIZES)
        model = TT.TransformerLM(cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(2),
            sp_group=group if step_plan else None)
        init = {k_: p.detach().clone() for k_, p in model.named_parameters()}
        opt = torch.optim.SGD(model.parameters(), lr=0.5)
        order = torch.arange(t) if layout != "zigzag" else \
            FC.zigzag_sequence_indices(world, t)
        inputs, labels = tokens[:, :-1][:, order], tokens[:, 1:][:, order]
        t_local = t // world if step_plan else t
        me = rank if step_plan else 0
        positions = FC.ring_layout_positions(
            me, world if step_plan else 1, t_local, layout or "contiguous",
            dev).long()

        def loss_fn(m, batch):
            logits = m(batch["inputs"], positions)
            return F.cross_entropy(
                logits.float().reshape(-1, logits.shape[-1]),
                batch["labels"].reshape(-1))

        losses = []
        if step_plan:
            step = hvd.DistributedTrainStep(loss_fn, opt, plan=step_plan,
                                            mesh=mesh)
            model, opt = step.init(model)
            batch = step.shard_batch({"inputs": inputs, "labels": labels})
            for _ in range(3):
                model, opt, loss = step(model, opt, batch)
                losses.append(float(loss))
        else:
            batch = {"inputs": inputs.to(dev), "labels": labels.to(dev)}
            for _ in range(3):
                opt.zero_grad(set_to_none=True)
                loss = loss_fn(model, batch)
                loss.backward()
                opt.step()
                losses.append(float(loss.detach()))
        return losses, {k_: p.detach() - init[k_]
                        for k_, p in model.named_parameters()}

    ref_losses, ref_updates = train("flash", None, None)
    for layout in FC.RING_LAYOUTS:
        losses, updates = train("ring", layout, f"sp={world}")
        out["train"][layout] = {
            "losses": losses, "ref_losses": ref_losses,
            "updates_normwise": _normwise(
                torch.cat([u.reshape(-1) for u in updates.values()]),
                torch.cat([ref_updates[k_].reshape(-1)
                           for k_ in updates]))}
    return out


# ---------------------------------------------------------------------------
# the sharded exchange: primitives, codec, ZeRO-style optimizer
# ---------------------------------------------------------------------------

#: segment lengths of the codec's flat input per world (its length is
#: 24 × world), the middle one scaled to 1e-3 so that a shared scale would
#: round it to zero
def codec_segments(world: int) -> tuple:
    return (5, 11, 24 * world - 16)


def zero_inputs(world: int) -> dict:
    """Every rank's inputs of :func:`run_zero`, stacked over ranks (dim 0).
    Floats of the exact checks are multiples of 1/8 below 8, so that every
    sum is exact in any order."""
    rng = np.random.RandomState(300 + world)

    def eighths(*shape):
        return (rng.randint(-64, 64, shape) / 8).astype(np.float32)

    base64 = rng.randint(-2 ** 62, 2 ** 62, (16,), dtype=np.int64)
    base64[::3] |= np.int64(-2 ** 63)            # the sign bit set
    flips = rng.rand(world, 16, 64) < 0.05
    weights = np.array([1 << k for k in range(63)] + [-(1 << 63)],
                       dtype=object)
    bits64 = np.stack([base64 ^ np.array(
        [int((f * weights).sum()) for f in flips[r]], dtype=object)
        .astype(np.int64) for r in range(world)])
    codec = rng.randn(world, 24 * world).astype(np.float32)
    codec[:, 5:16] *= 1e-3
    return {
        "rs": eighths(world, 3 * world, 2 * world),
        "rs_int": rng.randint(-1000, 1000, (world, 2 * world, 3))
        .astype(np.int32),
        "ag": eighths(world, 3, 2),
        "v": rng.randn(world, 5, 3).astype(np.float32),
        "a2a": eighths(world, 2 * world, 3 * world, 2),
        "a2av": rng.randn(world, world, 4, 2).astype(np.float32),
        "a2av_counts": rng.randint(0, 5, (world, world)).astype(np.int32),
        "bits32": (bits64 >> 17).astype(np.int32),
        "bits64": bits64,
        "bool": rng.rand(world, 16) > 0.2,
        "codec": codec,
        "resid": (rng.randn(world, 24 * world) * 1e-2).astype(np.float32),
        "tail": eighths(world, 8 * world + 3),
    }


#: (reducescatter op, scatter dim), (alltoall split, concat) cases
RS_CASES = [("Sum", 0), ("Average", 0), ("Sum", 1), ("Average", 1)]
A2A_CASES = [(0, 0), (1, 0), (0, 1), (1, 2)]
WIRES = ("int8", "fp8_e4m3")


def mlp_params() -> dict:
    """The JAX package's test MLP (tests/test_optimizer.py make_params) at
    the same shapes, drawn with numpy; keys in JAX's leaf order."""
    rng = np.random.RandomState(7)
    return {"b1": np.zeros(16, np.float32), "b2": np.zeros(1, np.float32),
            "w1": (rng.randn(4, 16) * 0.1).astype(np.float32),
            "w2": (rng.randn(16, 1) * 0.1).astype(np.float32)}


def mlp_batch(n: int = 64, seed: int = 0):
    """tests/test_optimizer.py make_batch."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    y = (x.sum(axis=1, keepdims=True) > 0).astype(np.float32)
    return x, y


def mlp_loss(m, batch):
    import torch

    h = torch.tanh(batch["x"] @ m["w1"] + m["b1"])
    return torch.mean((h @ m["w2"] + m["b2"] - batch["y"]) ** 2)


#: the MLP trainings of :func:`mlp_train`: name -> (optimizer, steps, step
#: options); "_dense" names take the replicated exchange
MLP_CASES = {
    "adamw_dense": ("adamw", 8, {}),
    "adamw": ("adamw", 8, {"shard_optimizer_states": True}),
    "adamw_b64": ("adamw", 8, {"shard_optimizer_states": True,
                               "exchange_bucket_bytes": 64}),
    "adamw_b64_on": ("adamw", 8, {"shard_optimizer_states": True,
                                  "exchange_bucket_bytes": 64,
                                  "fused_collectives": "on"}),
    "sgdm_dense": ("sgdm", 8, {}),
    "sgdm": ("sgdm", 8, {"shard_optimizer_states": True}),
    "adamw3_dense": ("adamw", 3, {}),
    "int8": ("adamw", 3, {"shard_optimizer_states": True,
                          "compression": "int8"}),
    "int8_ef": ("adamw", 3, {"shard_optimizer_states": True,
                             "compression": "int8", "error_feedback": True,
                             "exchange_bucket_bytes": 64}),
    "fp8_ef": ("adamw", 3, {"shard_optimizer_states": True,
                            "compression": "int8", "error_feedback": True,
                            "wire": "fp8_e4m3"}),
}


def mlp_train(hvd, name: str):
    """``MLP_CASES[name]`` through DistributedTrainStep on the global
    batch of :func:`mlp_batch`; returns (last loss, parameters as numpy)."""
    import torch

    opt_name, steps, kw = MLP_CASES[name]
    kw = dict(kw)
    cfg = hvd._state.global_state().config
    wire, cfg.exchange_wire_dtype = cfg.exchange_wire_dtype, \
        kw.pop("wire", "int8")
    if "compression" in kw:
        kw["compression"] = getattr(hvd.Compression, kw["compression"])
    try:
        model = torch.nn.ParameterDict({
            k: torch.nn.Parameter(torch.from_numpy(v.copy()))
            for k, v in mlp_params().items()})
        opt = torch.optim.AdamW(model.parameters(), lr=1e-2,
                                weight_decay=1e-4) if opt_name == "adamw" \
            else torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
        step = hvd.DistributedTrainStep(mlp_loss, opt, **kw)
        model, opt = step.init(model)
        x, y = mlp_batch()
        batch = step.shard_batch({"x": x, "y": y})
        for _ in range(steps):
            model, opt, loss = step(model, opt, batch)
    finally:
        cfg.exchange_wire_dtype = wire
    return float(loss), {k: v.detach().numpy().copy()
                         for k, v in model.items()}


def mlp_micro_steps(hvd, sharded: bool):
    """The plain optimizer wrapper, backward_passes_per_step=2: two
    micro-batches of this rank's rows, then one exchange and update; two
    such steps.  Returns the parameters as numpy."""
    import torch

    model = torch.nn.ParameterDict({
        k: torch.nn.Parameter(torch.from_numpy(v.copy()))
        for k, v in mlp_params().items()})
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=1e-4),
        backward_passes_per_step=2, shard_optimizer_states=sharded)
    x, y = mlp_batch()
    n = len(x) // hvd.size()
    x, y = x[hvd.rank() * n:(hvd.rank() + 1) * n], \
        y[hvd.rank() * n:(hvd.rank() + 1) * n]
    for _ in range(2):
        for half in (slice(0, n // 2), slice(n // 2, n)):
            opt.zero_grad(set_to_none=True)
            mlp_loss(model, {"x": torch.from_numpy(x[half]),
                             "y": torch.from_numpy(y[half])}).backward()
            opt.step()
    return {k: v.detach().numpy().copy() for k, v in model.items()}


def mlp_frozen(hvd, sharded: bool):
    """Three AdamW steps (weight decay 0.1) through DistributedTrainStep
    with ``w1`` frozen (``requires_grad=False``) before the optimizer is
    built; returns (parameters as numpy, the leaves the sharded plan
    covers or None)."""
    import torch

    model = torch.nn.ParameterDict({
        k: torch.nn.Parameter(torch.from_numpy(v.copy()))
        for k, v in mlp_params().items()})
    model["w1"].requires_grad_(False)
    step = hvd.DistributedTrainStep(
        mlp_loss, torch.optim.AdamW(model.parameters(), lr=1e-2,
                                    weight_decay=0.1),
        shard_optimizer_states=sharded)
    model, opt = step.init(model)
    x, y = mlp_batch()
    batch = step.shard_batch({"x": x, "y": y})
    for _ in range(3):
        model, opt, _ = step(model, opt, batch)
    return {k: v.detach().numpy().copy() for k, v in model.items()}, \
        opt.spec.num_leaves if sharded else None


def _init_keeps_shard_state(hvd):
    """One sharded AdamW step, then ``init`` again: each rank's exp_avg
    shard before and after."""
    import torch

    model = torch.nn.ParameterDict({
        k: torch.nn.Parameter(torch.from_numpy(v.copy()))
        for k, v in mlp_params().items()})
    step = hvd.DistributedTrainStep(
        mlp_loss, torch.optim.AdamW(model.parameters(), lr=1e-2),
        shard_optimizer_states=True)
    model, opt = step.init(model)
    x, y = mlp_batch()
    model, opt, _ = step(model, opt, step.shard_batch({"x": x, "y": y}))
    inner = opt.sharded_state.inner

    def moments():
        return [inner.state[p]["exp_avg"].clone().numpy()
                for p in opt.sharded_state.shards.values()]

    before = moments()
    step.init(model)
    return before, moments()


def run_zero(hvd):
    """On a gloo world: every primitive and codec function on
    :func:`zero_inputs`, the replicated int8 wire, the MLP trainings of
    :data:`MLP_CASES`, a frozen parameter, the micro-stepped wrapper, the
    transformer trained sharded (world 2) and ``init`` on a sharded
    state."""
    import torch

    from horovod_tpu_torch.ops import collectives as C

    torch.set_num_threads(1)
    world, rank = hvd.size(), hvd.rank()
    inp = zero_inputs(world)

    def t(k):
        return torch.from_numpy(np.ascontiguousarray(inp[k][rank]))

    def np_(x):
        return x.numpy().copy()

    out = {}
    for op, d in RS_CASES:
        out[("rs", op, d)] = np_(C.reducescatter(
            t("rs"), op=C.ReduceOp[op.upper()], scatter_dimension=d))
    out["rs_int"] = np_(C.reducescatter(t("rs_int")))
    out["ag"] = (np_(C.allgather(t("ag"))),
                 np_(C.allgather(t("ag"), tiled=False)))
    gathered, counts = C.allgather_v(t("v")[:rank + 1], rank + 1, 5)
    out["agv"] = (np_(gathered), np_(counts),
                  np_(C.allgather_v_compact(gathered, counts)),
                  np_(C.allgather_v_mask(counts, 5)))
    for s, c in A2A_CASES:
        out[("a2a", s, c)] = np_(C.alltoall(t("a2a"), s, c))
    recv, rc = C.alltoall_v(t("a2av"), t("a2av_counts"), 4)
    out["a2av"] = (np_(recv), np_(rc))
    for k in ("bits32", "bits64", "bool"):
        out[("and", k)] = np_(C.bitwise_and(t(k)))
        out[("or", k)] = np_(C.bitwise_or(t(k)))
    out["and_low"] = np_(C.bitwise_and(t("bits32"), nbits=12))
    segs = codec_segments(world)
    for wire in WIRES:
        for sg in ((), segs):
            out[("qar", wire, sg)] = np_(C.quantized_allreduce(
                t("codec"), segments=sg, wire_dtype=wire))
            out[("qrs", wire, sg)] = np_(C.quantized_reducescatter(
                t("codec"), op=C.Sum, segments=sg, wire_dtype=wire))
            y, r = C.ef_quantized_reducescatter(
                t("codec"), residual=t("resid").clone(), segments=sg,
                wire_dtype=wire)
            y0, r0 = C.ef_quantized_reducescatter(
                t("codec"), segments=sg, wire_dtype=wire)
            out[("ef", wire, sg)] = (np_(y), np_(r), np_(y0), np_(r0))
    xs = [t("codec")[:5], t("codec")[5:16], t("codec")[16:]]
    out["gar_int8"] = [np_(v) for v in C.grouped_allreduce(
        xs, op=C.Average, quantized_bits=8)]
    out["gar_int8_int"] = np_(C.grouped_allreduce(
        [t("rs_int")], op=C.Sum, compression=hvd.Compression.int8)[0])

    for name in MLP_CASES:
        out[("mlp", name)] = mlp_train(hvd, name)
    out["micro"] = (mlp_micro_steps(hvd, True), mlp_micro_steps(hvd, False))
    out["frozen"] = (mlp_frozen(hvd, True), mlp_frozen(hvd, False))
    out["init"] = _init_keeps_shard_state(hvd)
    if world == 2:
        out["train"] = run_train(hvd, 3, 0, True, True)
    return out


def state_bytes(optimizer) -> int:
    """Bytes of an optimizer's per-element state (tensors of rank >= 1;
    AdamW's step counters are scalars)."""
    return sum(v.numel() * v.element_size()
               for st in optimizer.state.values() for v in st.values()
               if hasattr(v, "dim") and v.dim() >= 1)


def run_codec(hvd):
    """On a world of one, on the runtime's device: every codec function on
    :func:`zero_inputs` of one rank, and the bitwise pair (over NCCL's SUM
    on a card); returns numpy."""
    import torch

    from horovod_tpu_torch.ops import collectives as C

    dev = hvd.device()
    inp = zero_inputs(1)

    def t(k):
        return torch.from_numpy(np.ascontiguousarray(inp[k][0])).to(dev)

    out = {}
    for wire in WIRES:
        for sg in ((), codec_segments(1)):
            out[("qar", wire, sg)] = C.quantized_allreduce(
                t("codec"), segments=sg, wire_dtype=wire).cpu().numpy()
            y, r = C.ef_quantized_reducescatter(
                t("codec"), residual=t("resid").clone(), segments=sg,
                wire_dtype=wire)
            out[("ef", wire, sg)] = (y.cpu().numpy(), r.cpu().numpy())
    for k in ("bits32", "bits64", "bool"):
        out[("and", k)] = C.bitwise_and(t(k)).cpu().numpy()
        out[("or", k)] = C.bitwise_or(t(k)).cpu().numpy()
    return out


def run_zero_nccl(hvd):
    """On a world of cards: the primitives on :func:`zero_inputs`, and the
    small transformer trained 3 steps replicated and sharded (bf16
    compute), with each one's optimizer-state bytes and the sharded plan's
    padded lengths."""
    import torch

    from horovod_tpu_torch.ops import collectives as C

    world, rank, dev = hvd.size(), hvd.rank(), hvd.device()
    inp = zero_inputs(world)

    def t(k):
        return torch.from_numpy(np.ascontiguousarray(inp[k][rank])).to(dev)

    out = {"rs": C.reducescatter(t("rs")).cpu().numpy(),
           "a2a": C.alltoall(t("a2a"), 1, 2).cpu().numpy(),
           "and": C.bitwise_and(t("bits64")).cpu().numpy(),
           "or": C.bitwise_or(t("bits32")).cpu().numpy()}
    for sharded in (False, True):
        losses, params, opt = train_lm(hvd, 3, 0, True,
                                       shard_optimizer_states=sharded)
        inner = opt.sharded_state.inner if sharded else opt.optimizer
        out[sharded] = {"losses": losses, "params": params,
                        "state_bytes": state_bytes(inner)}
        if sharded:
            out["padded"] = [g.padded for g in opt.spec.groups]
            out["n_params"] = sum(p.numel() for p in opt._trainable)
    return out


# ---------------------------------------------------------------------------
# the eager plane (tests/test_torch_eager.py)
# ---------------------------------------------------------------------------

def eager_rows(rank: int) -> dict:
    """Rank ``rank``'s tensors for the eager reductions."""
    rng = np.random.RandomState(200 + rank)
    return {"f32": rng.randn(5).astype(np.float32),
            "f16": rng.randn(6).astype(np.float16),
            "i32": rng.randint(-50, 50, (4,)).astype(np.int32),
            "i64": rng.randint(-2**40, 2**40, (3,)).astype(np.int64),
            "pos": (rng.rand(4) + 0.5).astype(np.float32)}


#: (tensor, op, prescale, postscale) of the eager reductions
EAGER_CASES = [("f32", "Sum", None, None), ("f32", "Average", None, None),
               ("f32", "Average", 0.5, 3.0), ("f32", "Sum", 0.0, None),
               ("f32", "Sum", None, 0.0), ("f16", "Average", None, None),
               ("f16", "Sum", 0.5, 2.0), ("i32", "Average", None, None),
               ("i32", "Sum", 2.5, None), ("i64", "Sum", None, None),
               ("f32", "Min", None, None), ("f32", "Max", 2.0, None),
               ("pos", "Product", None, None), ("f32", "Adasum", None, None)]


def _adasum_np(rows):
    def combine(a, b):
        dot, an, bn = a @ b, a @ a, b @ b
        ac = 1.0 - dot / (2.0 * an + 1e-30) if an >= 1e-30 else 1.0
        bc = 1.0 - dot / (2.0 * bn + 1e-30) if bn >= 1e-30 else 1.0
        return ac * a + bc * b

    vals = [r.astype(np.float64) for r in rows]
    while len(vals) > 1:
        nxt = [combine(vals[i], vals[i + 1])
               for i in range(0, len(vals) - 1, 2)]
        if len(vals) % 2:
            nxt.append(vals[-1])
        vals = nxt
    return vals[0]


def eager_expected(case, world: int) -> np.ndarray:
    """numpy oracle of an eager reduction over ``world`` ranks (float64
    inside, the tensor's dtype out; integers truncate as the eager plane
    casts back)."""
    key, op, pre, post = case
    rows = [eager_rows(r)[key] for r in range(world)]
    dtype = rows[0].dtype
    x = np.stack(rows).astype(np.float64) * (1.0 if pre is None else pre)
    if op == "Adasum":
        y = _adasum_np(list(x))
    else:
        y = {"Sum": np.sum, "Average": np.mean, "Min": np.min,
             "Max": np.max, "Product": np.prod}[op](x, axis=0)
    y = y * (1.0 if post is None else post)
    return np.trunc(y).astype(dtype) if np.issubdtype(dtype, np.integer) \
        else y.astype(dtype)


def eager_tolerance(key: str, op: str) -> float:
    """Integers exact; fp32 sums in another order (1e-6); Adasum's fp32
    dot products (1e-5); fp16 a rounding of each partial sum (2e-3)."""
    if key in ("i32", "i64"):
        return 0.0
    if key == "f16":
        return 2e-3
    return 1e-5 if op == "Adasum" else 1e-6


def _splits(world: int) -> np.ndarray:
    """Rows rank s sends rank d: (s + d) % 3, zero for some pairs."""
    return np.array([[(s + d) % 3 for d in range(world)]
                     for s in range(world)], np.int64)


def _caught(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the text is the result
        return f"{type(e).__name__}: {e}"
    return "no error"


def _eager_reductions(hvd, out: dict, plane: str) -> None:
    import torch

    from horovod_tpu_torch.ops.collectives import ReduceOp

    rows = eager_rows(hvd.rank())
    for i, (key, op, pre, post) in enumerate(EAGER_CASES):
        y = hvd.allreduce(torch.from_numpy(rows[key]).to(hvd.device()),
                          name=f"{plane}.r{i}", op=ReduceOp[op.upper()],
                          prescale_factor=pre, postscale_factor=post)
        out[(plane, i)] = (str(y.dtype), y.cpu().numpy())


def run_eager(hvd):
    """The eager plane's scenarios (tests/test_multiprocess.py) on this
    rank; returns what each gave."""
    import torch

    from horovod_tpu_torch.ops.bucketing import global_bucketer

    torch.set_num_threads(1)   # or the ranks oversubscribe the cores
    r, world, dev = hvd.rank(), hvd.size(), hvd.device()
    cfg = hvd._state.global_state().config
    out = {}

    def full(shape, value):
        return torch.full(shape, value, device=dev)

    def np_(t):
        return t.cpu().numpy()

    _eager_reductions(hvd, out, "XLA")
    # variable allgather, broadcast, alltoall with uneven and zero splits
    out["ag"] = np_(hvd.allgather(full((r + 1, 2), float(r)), name="ag"))
    out["ag_int"] = np_(hvd.allgather(
        torch.arange(r + 1, dtype=torch.int32, device=dev), name="ag.int"))
    out["bc"] = np_(hvd.broadcast(full((3,), float(r * 10)), root_rank=1,
                                  name="bc"))
    splits = _splits(world)[r]
    x = torch.arange(int(splits.sum()), dtype=torch.float32,
                     device=dev) + 100 * r
    out["a2a"] = np_(hvd.alltoall(x, splits=splits.tolist(), name="a2a"))
    out["a2a_int"] = np_(hvd.alltoall(x.to(torch.int64),
                                      splits=splits.tolist(),
                                      name="a2a.int"))
    # the async variants give the same results
    hg = hvd.allgather_async(full((r + 1, 2), float(r)), name="ag.a")
    hb = hvd.broadcast_async(full((3,), float(r * 10)), root_rank=1,
                             name="bc.a")
    ht = hvd.alltoall_async(x, splits=splits.tolist(), name="a2a.a")
    out["async"] = [np_(hvd.synchronize(h)) for h in (hg, hb, ht)]
    # a bucketed allreduce interleaved with a broadcast negotiated at
    # submission, synchronized in either order
    ar = hvd.allreduce_async(full((2,), float(r + 1)), op=hvd.Sum,
                             name="ilv.ar")
    bc = hvd.broadcast_async(full((2,), float(r + 5)), root_rank=0,
                             name="ilv.bc")
    out["ilv"] = [np_(hvd.synchronize(ar)), np_(hvd.synchronize(bc))]
    # many submissions fused at the byte threshold, in submission order
    before = global_bucketer().groups
    threshold, cfg.fusion_threshold_bytes = cfg.fusion_threshold_bytes, 40
    handles = [hvd.allreduce_async(full((3,), float(i + r)),
                                   name=f"g.{i}") for i in range(10)]
    out["fused"] = [np_(hvd.synchronize(h)) for h in handles]
    out["fused_groups"] = global_bucketer().groups - before
    cfg.fusion_threshold_bytes = threshold
    # the natural loop: an output fed into the next collective
    w = torch.zeros(4, device=dev)
    for i in range(3):
        w = w - 0.5 * hvd.allreduce(w + (r + 1), name=f"loop.{i}")
    out["loop"] = np_(w)
    out["loop_bc"] = np_(hvd.broadcast(w, root_rank=0, name="loop.bc"))
    hvd.barrier()
    out["objects"] = hvd.allgather_object({"rank": r})
    # a shape that differs on rank 0: every rank raises
    out["mismatch"] = _caught(lambda: hvd.allreduce(
        torch.ones(4 if r == 0 else 5, device=dev), name="bad"))
    # join with uneven batches: rank r has r + 2; the last rank averages
    # alone at the end, divided by the whole world
    sums = []
    for i in range(r + 2):
        sums.append(float(hvd.allreduce(full((3,), float(r + 1)),
                                        op=hvd.Sum, name=f"j.{i}")[0]))
    out["join_sums"] = sums
    if r == world - 1:
        out["join_avg"] = float(hvd.allreduce(full((3,), 2.0),
                                              name="j.avg")[0])
    out["join_last"] = hvd.join()
    # join with an allgather, then with Max: the same error on every rank
    for kind in ("allgather", "max"):
        if r == world - 1:
            fn = (lambda: hvd.allgather(torch.ones(2, 2, device=dev),
                                        name="ag.join")) \
                if kind == "allgather" else \
                (lambda: hvd.allreduce(torch.ones(2, device=dev),
                                       op=hvd.ReduceOp.MAX,
                                       name="max.join"))
            out[f"join_{kind}"] = _caught(fn)
            out[f"join_{kind}_last"] = hvd.join()
        else:
            out[f"join_{kind}"] = _caught(hvd.join)
            out[f"join_{kind}_last"] = hvd.join()
    out["stats"] = hvd.cache_stats()
    # HOROVOD_TPU_OPERATIONS=HOST: the same collectives over the host group
    cfg.tpu_operations = "HOST"
    out["host_plane"] = hvd.current_operations()
    _eager_reductions(hvd, out, "HOST")
    out["host"] = [
        np_(hvd.allgather(full((r + 1, 2), float(r)), name="h.ag")),
        np_(hvd.broadcast(full((3,), float(r * 7)), root_rank=1,
                          name="h.bc")),
        np_(hvd.alltoall(x, splits=splits.tolist(), name="h.a2a"))]
    hvd.barrier()
    cfg.tpu_operations = "XLA"
    out["eager_in_flight"] = len(hvd._state.global_state().eager.in_flight)
    return out


# ---------------------------------------------------------------------------
# the hook-fired exchange (tests/test_torch_overlap.py)
# ---------------------------------------------------------------------------

#: DistributedOptimizer options of each overlap case
OVERLAP_CASES = {
    "plain": {},
    "predivide": {"gradient_predivide_factor": 2.0},
    "bpps2": {"backward_passes_per_step": 2},
    "sync_then_step": {"gradient_predivide_factor": 2.0},
    "unused_frozen": {},
    "fp16": {"compression": "fp16"},
    "int8": {"compression": "int8"},
}
#: the fusion threshold each model runs under: one bucket a parameter for
#: the MLP (its hooks fire out of plan order), a few for the transformer
OVERLAP_THRESHOLDS = {"mlp": 1, "lm": 64 * 1024}


def _overlap_model(name: str, case: str):
    """(module, loss(module, micro-batch index)) with this rank's data."""
    import torch

    from horovod_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        lm_loss,
    )
    from horovod_tpu_torch.runtime import state

    rank, dev = state.global_state().rank, state.global_state().device
    if name == "mlp":
        model = torch.nn.ParameterDict({
            k: torch.nn.Parameter(torch.from_numpy(v.copy()).to(dev))
            for k, v in mlp_params().items()})
        if case == "unused_frozen":
            model["w1"].requires_grad_(False)
            model["unused"] = torch.nn.Parameter(torch.ones(3, device=dev))
        x, y = mlp_batch(n=16, seed=rank)

        def loss(m, k):
            rows = slice(8 * k, 8 * k + 8)
            return mlp_loss(m, {"x": torch.from_numpy(x[rows]).to(dev),
                                "y": torch.from_numpy(y[rows]).to(dev)})
        return model, loss
    # fp32 on the CPU, bf16 compute (the flash kernels' type) on a card
    model = TransformerLM(
        TransformerConfig(dtype=torch.float32 if dev.type == "cpu"
                          else torch.bfloat16, attention_impl="flash",
                          **TRAIN_SIZES),
        generator=torch.Generator().manual_seed(0)).to(dev)
    if case == "unused_frozen":
        model.layers[1].ln2.scale.requires_grad_(False)
        model.layers[0].unused = torch.nn.Parameter(torch.ones(3, device=dev))
    tok = torch.from_numpy(
        np.random.RandomState(rank).randint(0, 128, (4, 17))).to(dev)

    def loss(m, k):
        return lm_loss(m, tok[2 * k:2 * k + 2])
    return model, loss


def overlap_case(hvd, name: str, case: str) -> dict:
    """One overlap case: the hook path's gradients against
    ``distributed_gradients`` applied to the same gradients from a
    wrapper-free copy of the model; returns whether they are equal bit for
    bit, which parameters have none, the launches, the order the hooks
    fired in, and how many bucket reductions ran."""
    import copy

    import torch

    from horovod_tpu_torch.optim import optimizer as TO

    cfg = hvd._state.global_state().config
    threshold = OVERLAP_THRESHOLDS[name]
    cfg.fusion_threshold_bytes = threshold
    kw = dict(OVERLAP_CASES[case])
    if "compression" in kw:
        kw["compression"] = getattr(hvd.Compression, kw["compression"])
    passes = kw.get("backward_passes_per_step", 1)
    model, loss = _overlap_model(name, case)
    ref = copy.deepcopy(model)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.0), **kw)
    fired, calls = [], []
    real_on_grad, real_reduce = opt._on_grad, TO.C.grouped_allreduce
    opt._on_grad = lambda i, p: (fired.append(i), real_on_grad(i, p))

    def counting(xs, **k):
        calls.append(len(xs))
        return real_reduce(xs, **k)

    TO.C.grouped_allreduce = counting
    try:
        launches_after_backward = None
        for k in range(passes):
            opt.zero_grad(set_to_none=True)
            loss(model, k).backward()
            launches_after_backward = [src for _, src in opt.launches]
            if case == "sync_then_step":
                opt.synchronize()
            opt.step()
    finally:
        TO.C.grouped_allreduce = real_reduce
    # the reference: today's accumulation, then distributed_gradients
    acc = None
    for k in range(passes):
        ref.zero_grad(set_to_none=True)
        loss(ref, k).backward()
        grads = [p.grad for p in ref.parameters()]
        acc = [None if g is None else g.clone() for g in grads] \
            if acc is None else [a if g is None else a.add_(g)
                                 for a, g in zip(acc, grads)]
    for p, a in zip(ref.parameters(), acc):
        p.grad = None if a is None else a.div_(passes)
    pre, post = kw.get("prescale_factor"), kw.get("postscale_factor")
    if "gradient_predivide_factor" in kw:
        pre, post = 0.5, 2.0
    TO.distributed_gradients(
        [p.grad for p in ref.parameters() if p.grad is not None],
        compression=kw.get("compression"), prescale_factor=pre,
        postscale_factor=post, bucket_bytes=threshold)
    got = [p.grad for p in model.parameters()]
    want = [p.grad for p in ref.parameters()]
    exact = all((g is None and w is None) or
                (g is not None and w is not None and torch.equal(g, w))
                for g, w in zip(got, want))
    buckets = opt._buckets
    return {"exact": exact,
            "no_grad": [i for i, g in enumerate(got) if g is None],
            "frozen_or_unused": [
                i for i, (n, p) in enumerate(model.named_parameters())
                if not p.requires_grad or n.endswith("unused")],
            "launches": [(ids, src) for ids, src in opt.launches],
            "after_backward": launches_after_backward,
            "buckets": buckets,
            "fired_buckets": [opt._bucket_of[i] for i in fired],
            "reductions": len(calls)}


def run_overlap(hvd):
    """Every overlap case on both models, and join_step on this rank's
    gradients (rank 1 has no data)."""
    import torch

    torch.set_num_threads(1)   # or the ranks oversubscribe the cores
    out = {(name, case): overlap_case(hvd, name, case)
           for name in OVERLAP_THRESHOLDS for case in OVERLAP_CASES}
    g = join_step_inputs(hvd.rank())
    got = hvd.join_step({k: torch.from_numpy(v).to(hvd.device())
                         for k, v in g.items()}, hvd.rank() != 1)
    out["join_step"] = {k: v.cpu().numpy() for k, v in got.items()}
    return out


def join_step_inputs(rank: int) -> dict:
    rng = np.random.RandomState(300 + rank)
    return {"a": rng.randn(3, 5).astype(np.float32),
            "b": rng.randn(7).astype(np.float32)}


def check_eager_reduction(outs, world: int, plane: str, i: int) -> None:
    case = EAGER_CASES[i]
    want = eager_expected(case, world)
    tol = eager_tolerance(case[0], case[1])
    for out in outs:
        dtype, got = out[(plane, i)]
        assert dtype.removeprefix("torch.") == str(want.dtype)
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), rtol=tol,
                                   atol=tol, err_msg=str(case))


def _rows_to(world: int, me: int) -> np.ndarray:
    sp = _splits(world)
    parts = []
    for src in range(world):
        start = int(sp[src][:me].sum())
        parts.append(np.arange(start, start + sp[src][me],
                               dtype=np.float32) + 100 * src)
    return np.concatenate(parts)


def _check_movement(outs, world):
    """Variable allgather, broadcast from rank 1, alltoall with uneven and
    zero splits (float and int64), their async variants, and the same on
    the host plane."""
    ag = np.concatenate([np.full((r + 1, 2), float(r), np.float32)
                         for r in range(world)])
    for me, out in enumerate(outs):
        np.testing.assert_array_equal(out["ag"], ag)
        np.testing.assert_array_equal(out["ag_int"], np.concatenate(
            [np.arange(r + 1, dtype=np.int32) for r in range(world)]))
        np.testing.assert_array_equal(out["bc"], 10.0)
        np.testing.assert_array_equal(out["a2a"], _rows_to(world, me))
        np.testing.assert_array_equal(out["a2a_int"], _rows_to(world, me))
        for got, want in zip(out["async"],
                             (ag, np.full(3, 10.0), _rows_to(world, me))):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(out["host"], (ag, np.full(3, 7.0),
                                           _rows_to(world, me))):
            np.testing.assert_array_equal(got, want)
        assert out["host_plane"] == "HOST"


def _check_bucketed_and_interleaved(outs, world):
    """A bucketed allreduce interleaved with a broadcast negotiated at
    submission; ten submissions fused at a 40-byte threshold into 3
    groups."""
    total = world * (world + 1) / 2
    for out in outs:
        np.testing.assert_array_equal(out["ilv"][0], total)
        np.testing.assert_array_equal(out["ilv"][1], 5.0)
        for i, got in enumerate(out["fused"]):
            np.testing.assert_array_equal(got, i + (world - 1) / 2)
        assert out["fused_groups"] == 3


def _check_output_feeds_next(outs, world):
    w = np.zeros(4)
    mean = (world + 1) / 2
    for _ in range(3):
        w = w - 0.5 * (w + mean)
    for out in outs:
        np.testing.assert_allclose(out["loop"], w, rtol=1e-6)
        np.testing.assert_array_equal(out["loop_bc"], outs[0]["loop"])


def _check_objects_and_stats(outs, world):
    for out in outs:
        assert out["objects"] == [{"rank": r} for r in range(world)]
        assert out["stats"]["misses"] > 0
        assert out["eager_in_flight"] == 0


def _check_mismatch(outs, world):
    """A shape that differs on rank 0: HorovodInternalError on every
    rank."""
    for out in outs:
        assert out["mismatch"].startswith(
            "HorovodInternalError: Mismatched allreduce"), out["mismatch"]


def _check_join_uneven(outs, world):
    """Joined ranks add zeros: the sums hold only the ranks still present;
    the last rank's Average divides by the whole world; join returns the
    last rank to join."""
    for r, out in enumerate(outs):
        want = [float(sum(q + 1 for q in range(world) if q + 2 > i))
                for i in range(r + 2)]
        assert out["join_sums"] == want
        assert out["join_last"] == world - 1
    assert outs[-1]["join_avg"] == 2.0 / world


def _check_join_errors(outs, world):
    """An allgather, or a Max, while the others are joined: the
    reference's error on the active rank and on every joined rank; all
    then join again, aligned, and the last rank is returned."""
    for kind, text in (
            ("allgather", "HorovodInternalError: Allgather is not supported "
                          "with Join at this time."),
            ("max", "HorovodInternalError: Allreduce op MAX is not "
                    "supported with Join")):
        for out in outs:
            assert out[f"join_{kind}"].startswith(text), out[f"join_{kind}"]
            assert out[f"join_{kind}_last"] == world - 1


#: the eager scenarios' checks over every rank's :func:`run_eager` result
EAGER_CHECKS = {"movement": _check_movement,
                "bucketed_and_interleaved": _check_bucketed_and_interleaved,
                "output_feeds_next": _check_output_feeds_next,
                "objects_and_stats": _check_objects_and_stats,
                "mismatch": _check_mismatch,
                "join_uneven": _check_join_uneven,
                "join_errors": _check_join_errors}


def check_overlap(res: dict, name: str, case: str) -> None:
    """An :func:`overlap_case` result: bit for bit equal to
    ``distributed_gradients``; with every gradient present, every bucket
    launched from a hook before backward returned, in plan order, once
    (no second exchange after an explicit synchronize)."""
    assert res["exact"], (name, case)
    n_buckets = len(res["buckets"])
    if case == "unused_frozen":
        # a frozen parameter (left out of the plan) and an unused one keep
        # .grad None; the unused one's bucket never completes, so it and
        # the buckets after it launch at synchronize, replanned
        assert res["no_grad"] == res["frozen_or_unused"]
        assert len(res["no_grad"]) == 2
        assert [src for _, src in res["launches"]][-1] == "synchronize"
        return
    assert res["no_grad"] == []
    assert [ids for ids, _ in res["launches"]] == res["buckets"]
    assert res["after_backward"] == ["hook"] * n_buckets
    assert res["reductions"] == n_buckets


def run_eager_card(hvd):
    """On one card (an NCCL world of one): which planes, NCCL calls, host
    gathers and ``fused_scale`` launches each eager call takes; ``poll`` on
    an in-flight handle."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.ops import op_manager

    dev, cfg = hvd.device(), hvd._state.global_state().config
    host, nccl = [], []
    real_host, real_ar = op_manager._host_allgather, dist.all_reduce
    op_manager._host_allgather = lambda x: (host.append(x.device.type),
                                            real_host(x))[1]

    def all_reduce(t, *a, **k):
        nccl.append(t.device.type)
        return real_ar(t, *a, **k)

    dist.all_reduce = all_reduce
    out = {}
    x = torch.randn(1 << 20, device=dev)

    def run(tag, t):
        host.clear()
        nccl.clear()
        before = K.fused_scale.launches
        y = hvd.allreduce(t, name=tag, prescale_factor=0.5,
                          postscale_factor=2.0)
        out[tag] = {"plane": op_manager.current_operations(t),
                    "host": list(host), "nccl": list(nccl),
                    "fused_scale": K.fused_scale.launches - before,
                    "exact": bool(torch.equal(y, t)),
                    "device": y.device.type}

    run("card", x)
    run("cpu", torch.arange(8.0))
    cfg.tpu_operations = "HOST"
    run("card_host", x)
    cfg.tpu_operations = "XLA"
    big = torch.randn(16 << 20, device=dev)      # 64 MiB: dispatched now
    h = hvd.allreduce_async(big, name="big")
    out["poll_in_flight"] = hvd.poll(h)
    out["big_exact"] = bool(torch.equal(hvd.synchronize(h), big))
    out["poll_done"] = hvd.poll(h)
    dist.all_reduce = real_ar
    return out


#: a wider LM than TRAIN_SIZES for timing the exchange over NCCL
OVERLAP_TIMING_SIZES = dict(vocab_size=8192, num_layers=4, num_heads=8,
                            d_model=1024, d_ff=4096, max_seq_len=512)


def run_overlap_nccl(hvd):
    """:func:`run_overlap` on the cards, then the step of a wider LM (bf16
    compute, AdamW) timed with the hook-fired exchange and with the
    step-time one (``distributed_gradients`` after backward), in turns:
    median ms of 10 steps after 3, twice each."""
    import time

    import torch

    from horovod_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        lm_loss,
    )
    from horovod_tpu_torch.optim import distributed_gradients

    out = run_overlap(hvd)
    dev = hvd.device()
    tok = torch.from_numpy(np.random.RandomState(hvd.rank()).randint(
        0, 8192, (4, 513))).to(dev)
    timing = {"hooks": [], "step_time": []}
    for mode in ("hooks", "step_time", "step_time", "hooks"):
        model = TransformerLM(TransformerConfig(
            dtype=torch.bfloat16, attention_impl="flash",
            **OVERLAP_TIMING_SIZES),
            generator=torch.Generator().manual_seed(0)).to(dev)
        inner = torch.optim.AdamW(model.parameters(), lr=1e-4)
        opt = hvd.DistributedOptimizer(inner) if mode == "hooks" else inner
        ms = []
        for i in range(13):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            lm_loss(model, tok).backward()
            if mode == "step_time":
                distributed_gradients([p.grad for p in model.parameters()
                                       if p.grad is not None])
            opt.step()
            torch.cuda.synchronize()
            if i >= 3:
                ms.append((time.perf_counter() - t0) * 1e3)
        timing[mode].append(sorted(ms)[len(ms) // 2])
        del model, opt, inner
    out["timing_ms"] = timing
    return out


# ---------------------------------------------------------------------------
# the hook-fired exchange against the step-time one, timed on one card
# ---------------------------------------------------------------------------

def _bench_transformer(torch, hvd, tp: bool):
    import torch.nn.functional as F

    from chip_smoke import FULL, SEED, full_config
    from horovod_tpu_torch.models.transformer import (
        TransformerLM,
        fused_tp_apply,
        lm_loss,
    )
    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh

    dev = hvd.device()
    cfg = full_config(torch, "flash")
    model = TransformerLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    tokens = torch.randint(0, cfg.vocab_size,
                           (FULL["batch"], FULL["seq"] + 1),
                           generator=torch.Generator().manual_seed(SEED)
                           ).to(dev)
    if tp:
        mesh = make_parallel_mesh(tp=1)

        def loss():
            logits = fused_tp_apply(model, cfg, tokens[:, :-1], mesh=mesh)
            return F.cross_entropy(
                logits.float().reshape(-1, logits.shape[-1]),
                tokens[:, 1:].reshape(-1))
    else:
        def loss():
            return lm_loss(model, tokens)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4)
    return model, opt, loss, 2.0


def _bench_resnet(torch, hvd):
    from chip_smoke import RESNET, SEED
    from horovod_tpu_torch.models.resnet import ResNet50, resnet_loss

    dev = hvd.device()
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                     space_to_depth=True, fused_bwd=True, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(SEED))
    cpu = torch.Generator().manual_seed(SEED)
    n, px = RESNET["batch"], RESNET["image"]
    batch = {"x": torch.rand((n, px, px, 3), generator=cpu).to(dev),
             "y": torch.randint(0, 1000, (n,), generator=cpu).to(dev)}
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    return model, opt, lambda: resnet_loss(model, batch), None


def _bench_turn(torch, hvd, build, mode: str, steps: int) -> float:
    """Median step ms of ``steps`` steps after two, from a fresh model:
    ``hooks`` wraps the optimizer in DistributedOptimizer; ``step_time``
    keeps it unwrapped and calls distributed_gradients (the same buckets,
    factors and kernels) after backward, as ``step()`` ran the exchange
    before the hooks."""
    import time

    from horovod_tpu_torch.optim import distributed_gradients

    model, inner, loss, predivide = build()
    kw = {} if predivide is None else \
        {"gradient_predivide_factor": predivide}
    opt = hvd.DistributedOptimizer(inner, **kw) if mode == "hooks" \
        else inner
    pre, post = (None, None) if predivide is None else \
        (1.0 / predivide, predivide)
    times = []
    for i in range(steps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss().backward()
        if mode == "step_time":
            distributed_gradients(
                [p.grad for p in model.parameters() if p.grad is not None],
                prescale_factor=pre, postscale_factor=post)
        opt.step()
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    del model, opt, inner, loss
    torch.cuda.empty_cache()
    return sorted(times)[len(times) // 2]


def run_overlap_bench(hvd, steps: int = 8, turns: int = 4):
    """chip_smoke.py's one-card training paths at full width (the 870.9M
    TransformerLM through flash and through ``fused_tp_apply`` at tp = 1,
    ResNet-50 at 224 px, batch 128, ``fused_bwd``), each timed with the
    hook-fired exchange and with the step-time one in turns (hooks,
    step-time, step-time, hooks, ...): {path: {mode: [median ms of each
    turn]}}, with the card's name."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    paths = {"transformer": lambda: _bench_transformer(torch, hvd, False),
             "tp": lambda: _bench_transformer(torch, hvd, True),
             "resnet": lambda: _bench_resnet(torch, hvd)}
    order = []
    for t in range(turns // 2):
        order += ["hooks", "step_time"] if t % 2 == 0 else \
            ["step_time", "hooks"]
    out = {"device": torch.cuda.get_device_name(0)}
    for path, build in paths.items():
        got = {"hooks": [], "step_time": []}
        for mode in order:
            got[mode].append(_bench_turn(torch, hvd, build, mode, steps))
        out[path] = got
    return out


# ---------------------------------------------------------------------------
# sharded checkpoints (tests/test_torch_checkpoint.py)
# ---------------------------------------------------------------------------

#: the sharded MLP's exchange buckets: 16 floats, so the plan has groups
#: of 1 to 16 values whose padded lengths change with the world size
CKPT_BUCKET_BYTES = 64
CKPT_LR = 3e-4


def _ckpt_mlp(hvd, **kw):
    """The test MLP wrapped for the sharded exchange through
    DistributedTrainStep, initialized; returns (step, model, optimizer,
    this rank's batch)."""
    import torch

    model = torch.nn.ParameterDict({
        k: torch.nn.Parameter(torch.from_numpy(v.copy()).to(hvd.device()))
        for k, v in mlp_params().items()})
    step = hvd.DistributedTrainStep(
        mlp_loss, torch.optim.AdamW(model.parameters(), lr=CKPT_LR,
                                    weight_decay=1e-4),
        shard_optimizer_states=True,
        exchange_bucket_bytes=CKPT_BUCKET_BYTES, **kw)
    model, opt = step.init(model)
    x, y = mlp_batch()
    return step, model, opt, step.shard_batch({"x": x, "y": y})


def _np_tree(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return tree


def _params_np(model):
    return {k: v.detach().cpu().numpy().copy() for k, v in model.items()}


def run_ckpt_save(hvd, directory: str):
    """On a gloo world: the sharded MLP trains 2 steps and every rank saves
    its shard (step 2, plan ``dp=<world>``) and rank 0 the parameters; then
    one more step, the continuation a restore must reproduce.  With int8 +
    error feedback, a same-world round trip into a fresh wrapper.  Rank 0's
    state read back on every rank by ``restore_and_broadcast``, and the
    latest step agreed by ``_resolve_step``."""
    import torch

    from horovod_tpu_torch.checkpoint import Checkpointer

    torch.set_num_threads(1)
    world, rank = hvd.size(), hvd.rank()
    out = {}
    step, model, opt, batch = _ckpt_mlp(hvd)
    for _ in range(2):
        model, opt, _ = step(model, opt, batch)
    ckpt = Checkpointer(os.path.join(directory, "adamw"))
    ckpt.save_sharded(2, opt.sharded_state_dict(), rank, world,
                      plan=f"dp={world}")
    ckpt.save(2, {"model": model.state_dict()})
    ckpt.wait()
    hvd.barrier()
    out["state"] = _np_tree(opt.sharded_state_dict())
    out["groups"] = [(g.key, g.padded, g.shard, sum(g.sizes))
                     for g in opt.spec.groups]
    out["params2"] = _params_np(model)
    model, opt, _ = step(model, opt, batch)
    out["params3"] = _params_np(model)

    # int8 wire with error feedback: the residuals round-trip at this world
    step, model, opt, batch = _ckpt_mlp(hvd, compression=hvd.Compression.int8,
                                        error_feedback=True)
    for _ in range(2):
        model, opt, _ = step(model, opt, batch)
    ef = Checkpointer(os.path.join(directory, "ef"), async_save=False)
    ef.save_sharded(2, opt.sharded_state_dict(), rank, world)
    hvd.barrier()
    _, _, fresh, _ = _ckpt_mlp(hvd, compression=hvd.Compression.int8,
                               error_feedback=True)
    template = fresh.sharded_state_template()
    fresh.load_sharded_state_dict(ef.restore_sharded(template, rank, world))
    out["ef"] = (_np_tree(opt.sharded_state_dict()),
                 _np_tree(fresh.sharded_state_dict()))

    # replicated state: the root reads, every rank receives
    rb = Checkpointer(os.path.join(directory, "replicated"))
    rb.save(5, {"w": torch.arange(6.0).reshape(2, 3), "n": 5,
                "tag": "five"})
    rb.wait()
    hvd.barrier()
    out["broadcast"] = _np_tree(rb.restore_and_broadcast(
        {"w": torch.zeros(2, 3), "n": 0, "tag": ""}))
    out["resolved"] = rb._resolve_step()
    return out


def run_ckpt_restore(hvd, directory: str):
    """On a gloo world of another size than the saving one: a fresh
    sharded MLP (no step taken, so its optimizer has no state yet) restores
    the parameters and its shard of the saved state, then takes one step;
    returns the restored shard state and the parameters after the step."""
    import torch

    from horovod_tpu_torch.checkpoint import Checkpointer

    torch.set_num_threads(1)
    world, rank = hvd.size(), hvd.rank()
    step, model, opt, batch = _ckpt_mlp(hvd)
    ckpt = Checkpointer(os.path.join(directory, "adamw"))
    template = opt.sharded_state_template()
    shapes = {k: {n: tuple(t.shape) for n, t in v.items()}
              for k, v in template["state"].items()}
    restored = ckpt.restore_sharded(template, rank, world,
                                    plan=f"dp={world}")
    opt.load_sharded_state_dict(restored)
    model.load_state_dict(ckpt.restore()["model"])
    state = _np_tree(opt.sharded_state_dict())
    model, opt, _ = step(model, opt, batch)
    return {"shapes": shapes, "state": state, "params": _params_np(model),
            "groups": [(g.key, g.padded, g.shard, sum(g.sizes))
                       for g in opt.spec.groups]}


# ---------------------------------------------------------------------------
# the Switch-MoE LM and expert parallelism (tests/test_torch_moe.py)
# ---------------------------------------------------------------------------

#: the small MoE LM of the parity tests (tests/test_moe.py tiny_cfg, with 8
#: experts so that ep = 2 and 4 divide them)
MOE_LM = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32,
              d_ff=64, max_seq_len=16, num_experts=8, capacity_factor=1.25,
              moe_every=2)
MOE_LR = 3e-4
MOE_STEPS = 2
MOE_AUX = 0.01


def moe_ffn_x(world: int) -> np.ndarray:
    """(world, 8, 32) tokens, one row of 8 a rank."""
    return np.random.RandomState(40 + world).randn(world, 8, 32).astype(
        np.float32)


def moe_tokens() -> np.ndarray:
    """The LM's global batch: 8 rows of 9 tokens."""
    return np.random.RandomState(41).randint(0, 64, (8, 9)).astype(np.int64)


def ring_expert_inputs(world: int, e_local: int = 2, cap: int = 3,
                       d: int = 4, f: int = 8) -> tuple:
    """tests/test_pallas_kernels.py's ring inputs: every rank's
    (world, e_local, cap, d) dispatch buffer and its experts' weights."""
    rng = np.random.RandomState(0)
    disp = rng.standard_normal((world, world, e_local, cap, d)).astype(
        np.float32)
    w1 = (rng.standard_normal((world, e_local, d, f)) * 0.3).astype(
        np.float32)
    w2 = (rng.standard_normal((world, e_local, f, d)) * 0.3).astype(
        np.float32)
    return disp, w1, w2


def moe_lm_loss(model, batch):
    import torch.nn.functional as F

    from horovod_tpu_torch.models.moe import moe_aux_loss

    logits = model(batch[:, :-1])
    ce = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                         batch[:, 1:].reshape(-1))
    return ce + MOE_AUX * moe_aux_loss(model)


def _moe_ffn_case(hvd, ffn_params, cf: float, fused: bool):
    """This rank's row through an ep SwitchFFN over the world: output, drop
    fraction, and the world's summed gradients of sum(y²) over the router,
    the experts and this rank's tokens."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.models.moe import MoEConfig, SwitchFFN

    world, rank = hvd.size(), hvd.rank()
    cfg = MoEConfig(dtype=torch.float32, d_model=32, d_ff=64, num_experts=8,
                    capacity_factor=cf,
                    fused_dispatch="on" if fused else "off")
    ffn = SwitchFFN(cfg, ep_group=dist.group.WORLD)
    ffn.load_state_dict({k: torch.from_numpy(v) for k, v in
                         ffn_params.items()})
    x = torch.from_numpy(moe_ffn_x(world)[rank:rank + 1]).requires_grad_()
    y = ffn(x)
    grads = torch.autograd.grad((y ** 2).sum(),
                                [ffn.gate, ffn.w1, ffn.w2, x])
    summed = []
    for g in grads[:3]:
        g = g.clone()
        dist.all_reduce(g)
        summed.append(g.numpy())
    return (y.detach().numpy(), float(ffn.moe_drop_fraction), summed,
            grads[3].numpy())


def _moe_ring_case(hvd, fused: bool):
    """expert_alltoall_ffn on :func:`ring_expert_inputs`: this rank's
    output and the gradients of sum(out²) by its dispatch and experts."""
    import torch

    from horovod_tpu_torch.ops.fused_collectives import expert_alltoall_ffn

    world, rank = hvd.size(), hvd.rank()
    disp, w1, w2 = (torch.from_numpy(a[rank]).requires_grad_()
                    for a in ring_expert_inputs(world))

    def expert_fn(t):
        h = torch.einsum("ecd,edf->ecf", t, w1)
        return torch.einsum("ecf,efd->ecd",
                            torch.nn.functional.gelu(h, approximate="tanh"),
                            w2)

    import torch.distributed as dist

    out = expert_alltoall_ffn(disp, expert_fn, dist.group.WORLD,
                              fused=fused, params=(w1, w2))
    grads = torch.autograd.grad((out ** 2).sum(), [disp, w1, w2])
    with torch.no_grad():
        plain = expert_alltoall_ffn(disp, expert_fn, dist.group.WORLD,
                                    fused=fused, params=(w1, w2))
    assert not plain.requires_grad
    return out.detach().numpy(), [g.numpy() for g in grads], plain.numpy()


def _moe_train(hvd, lm_params, plan: str, fused: bool):
    """MOE_STEPS AdamW steps of the MoE LM under ``plan`` through
    DistributedTrainStep on :func:`moe_tokens`, the fused ring chosen by
    the step's ``moe_fused`` over a model configured unfused; (losses,
    parameters, the fused rings constructed)."""
    import torch

    from horovod_tpu_torch.models.moe import MoEConfig, MoETransformerLM
    from horovod_tpu_torch.ops.fused_collectives import expert_alltoall_ffn
    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh
    from horovod_tpu_torch.parallel.plan import ShardingPlan

    cfg = MoEConfig(dtype=torch.float32, attention_impl="dense",
                    fused_dispatch="off", **MOE_LM)
    p = ShardingPlan.from_string(plan).resolve(hvd.size())
    mesh = make_parallel_mesh(dp=p.dp, ep=p.ep)
    model = MoETransformerLM(cfg, ep_group=mesh.group("ep"))
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in lm_params.items()})
    step = hvd.DistributedTrainStep(
        moe_lm_loss, torch.optim.AdamW(model.parameters(), lr=MOE_LR,
                                       weight_decay=1e-4),
        plan=plan, mesh=mesh, moe_fused="on" if fused else None)
    model, opt = step.init(model)
    batch = step.shard_batch(moe_tokens())
    losses = []
    rings = expert_alltoall_ffn.launches
    for _ in range(MOE_STEPS):
        model, opt, loss = step(model, opt, batch)
        losses.append(float(loss))
    return losses, {k: v.detach().numpy().copy()
                    for k, v in model.state_dict().items()}, \
        expert_alltoall_ffn.launches - rings


def run_moe(hvd, ffn_params, lm_params):
    """On a gloo world, an ep group of the whole world: the ep SwitchFFN
    (fused and unfused, ample and tight capacity), expert_alltoall_ffn on
    its own, the LM trained under ``ep=<world>`` (and ``dp=2,ep=2`` and the
    fused ring at world 4), and the errors."""
    import torch

    torch.set_num_threads(1)
    world = hvd.size()
    out = {}
    for cf in (16.0, 1.0):
        for fused in (False, True):
            out[("ffn", cf, fused)] = _moe_ffn_case(hvd, ffn_params, cf,
                                                    fused)
    for fused in (False, True):
        out[("ring", fused)] = _moe_ring_case(hvd, fused)
    plans = [(f"ep={world}", False)]
    if world == 4:
        plans += [("dp=2,ep=2", False), ("ep=4", True)]
    for plan, fused in plans:
        out[("train", plan, fused)] = _moe_train(hvd, lm_params, plan, fused)
    errors = {}
    import torch.distributed as dist

    from horovod_tpu_torch.parallel.expert import expert_parallel_ffn

    try:
        expert_parallel_ffn(torch.zeros(4, 32), torch.zeros(32, 3),
                            lambda t: t, 3, group=dist.group.WORLD)
    except ValueError as e:
        errors["divisible"] = str(e)
    try:
        hvd.DistributedTrainStep(moe_lm_loss, torch.optim.AdamW(
            [torch.zeros(2, requires_grad=True)]), plan=f"ep={world}",
            shard_optimizer_states=True)
    except NotImplementedError as e:
        errors["sharded"] = str(e)
    out["errors"] = errors
    return out


def _moe_card_model(dev, ep_group=None, fused: bool = False):
    """The fp32 MoE LM of MOE_LM on ``dev``, dense attention, weights from
    seed 0 (the same on every rank)."""
    import torch

    from horovod_tpu_torch.models.moe import MoEConfig, MoETransformerLM

    cfg = MoEConfig(dtype=torch.float32, attention_impl="dense",
                    fused_dispatch="on" if fused else "off", **MOE_LM)
    return MoETransformerLM(cfg, generator=torch.Generator().manual_seed(0),
                            ep_group=ep_group).to(dev)


def run_moe_nccl(hvd, directory: str):
    """On a world of cards: this rank's two rows of :func:`moe_tokens`
    through the fp32 MoE LM in local mode and over an ep group of the whole
    world (unfused and fused), each loss and the world's summed gradients;
    then the sharded MLP trained 2 steps at this world, saved, and (ranks 0
    and 1) restored at shard_count 2 into targets sized by the fusion spec
    at 2."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.checkpoint import Checkpointer
    from horovod_tpu_torch.ops import collectives as C

    torch.backends.cuda.matmul.allow_tf32 = False
    world, rank, dev = hvd.size(), hvd.rank(), hvd.device()
    rows = moe_tokens().shape[0] // world
    shard = torch.from_numpy(moe_tokens()[rank * rows:(rank + 1) * rows]).to(
        dev)
    out = {}
    for name, kw in (("local", {}),
                     ("ep", dict(ep_group=dist.group.WORLD)),
                     ("ep_fused", dict(ep_group=dist.group.WORLD,
                                       fused=True))):
        model = _moe_card_model(dev, **kw)
        loss = moe_lm_loss(model, shard)
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, list(model.parameters()))
        summed = {}
        for n, g in zip(names, grads):
            g = g.clone()
            dist.all_reduce(g)
            summed[n] = g.cpu().numpy()
        out[name] = (float(loss), summed)

    step, model, opt, batch = _ckpt_mlp(hvd)
    for _ in range(2):
        model, opt, _ = step(model, opt, batch)
    ckpt = Checkpointer(os.path.join(directory, "zero"))
    ckpt.save_sharded(2, opt.sharded_state_dict(), rank, world,
                      plan=f"dp={world}")
    ckpt.wait()
    hvd.barrier()
    out["saved"] = _np_tree(opt.sharded_state_dict())
    if rank < 2:
        leaves = [torch.from_numpy(v) for v in mlp_params().values()]
        spec = C.make_fusion_spec(leaves, 2, CKPT_BUCKET_BYTES)
        target = {"state": {g.key: {"step": torch.tensor(0.0),
                                    "exp_avg": torch.zeros(g.shard),
                                    "exp_avg_sq": torch.zeros(g.shard)}
                            for g in spec.groups}}
        out["restored"] = _np_tree(ckpt.restore_sharded(
            target, rank, 2, step=2, plan="dp=2"))
        out["groups2"] = [(g.key, g.padded, g.shard) for g in spec.groups]
    return out
