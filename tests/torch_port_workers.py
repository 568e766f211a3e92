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


#: the JAX package's own g++ flags (``horovod_tpu/native/__init__.py``
#: ``_build``)
JAX_NATIVE_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_jax_native_dir = None


def jax_native():
    """The JAX package's native module with its library built for this
    process alone.

    The JAX package builds ``libhvd_tpu_native.so`` beside its source, in
    place, and takes any file there that is newer than the source; a
    failed load is remembered for the rest of the process.  Under xdist
    every worker imports ``tests/test_native.py``, whose ``skipif`` builds
    the library, so six compilers write one file at once and a worker can
    load it half written ("file too short") and lose the library for the
    rest of its run.  Here the source is compiled with the JAX package's
    flags into a directory of this process, through a temporary file and
    a rename; the module is pointed at that file, its remembered result
    reset, and loaded.  Without ``g++`` the module stays unbuilt, and a
    caller that needs it fails as before."""
    import atexit
    import shutil
    import subprocess
    import tempfile

    from horovod_tpu import native as JN

    global _jax_native_dir
    if _jax_native_dir is not None:
        return JN
    private = tempfile.mkdtemp(prefix=f"hvd_jax_native_{os.getpid()}_")
    atexit.register(shutil.rmtree, private, True)
    _jax_native_dir = private
    lib = os.path.join(private, "libhvd_tpu_native.so")
    tmp = lib + ".tmp"
    cxx = shutil.which("g++")
    built = cxx is not None and subprocess.run(
        [cxx, *JAX_NATIVE_FLAGS, JN._SRC, "-o", tmp],
        capture_output=True, timeout=300).returncode == 0
    if built:
        os.replace(tmp, lib)
    with JN._lib_lock:
        JN._LIB = lib
        JN._lib = None
        JN._build_failed = not built
    JN.load()
    return JN


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _caller_group(rank, world, port, device, launch):
    """The process group a caller makes before ``hvd.init()``, with no
    ``HOROVOD_*`` variable: torchrun's ``LOCAL_*``/``RANK``/``WORLD_SIZE``
    when ``launch["local_world_size"]`` is set, and with
    ``launch["hosts"]`` this rank's hostname one of that many."""
    import socket

    import torch.distributed as dist

    local = launch.get("local_world_size")
    if local:
        os.environ.update(LOCAL_RANK=str(rank % local),
                          LOCAL_WORLD_SIZE=str(local), RANK=str(rank),
                          WORLD_SIZE=str(world))
    hosts = launch.get("hosts")
    if hosts:
        socket.gethostname = lambda: hosts[rank]
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)


def _mpirun_env(rank, world, port, local_size):
    """What ``hvdrun --mpi`` gives a rank through ``mpirun -x`` and Open
    MPI's own identity variables: no ``HOROVOD_RANK``."""
    os.environ.update(OMPI_COMM_WORLD_RANK=str(rank),
                      OMPI_COMM_WORLD_SIZE=str(world),
                      OMPI_COMM_WORLD_LOCAL_RANK=str(rank % local_size),
                      OMPI_COMM_WORLD_LOCAL_SIZE=str(local_size),
                      HOROVOD_SIZE=str(world),
                      HOROVOD_COORDINATOR_ADDR=f"localhost:{port}")


def _layout_env(rank, device, layout):
    """``HOROVOD_LOCAL_*``/``HOROVOD_CROSS_*`` of rank ``rank`` in a world
    laid out as ``layout = (cross, local)``, row-major, and on
    ``device="cuda"`` its node's cards, so that ``cuda:<local_rank>`` is
    card ``rank`` whichever node the rank is on."""
    cross, local = layout
    node = rank // local
    os.environ.update(HOROVOD_LOCAL_RANK=str(rank % local),
                      HOROVOD_LOCAL_SIZE=str(local),
                      HOROVOD_CROSS_RANK=str(node),
                      HOROVOD_CROSS_SIZE=str(cross))
    if device == "cuda":
        os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(
            str(node * local + j) for j in range(local))


#: the variables through which a launcher places a process in a world:
#: the ``HOROVOD_*`` identity and rendezvous contract (the elastic ones
#: too), torchrun's, and those of mpirun and jsrun that the runtime reads
#: (``runner/cluster_env.jsm_identity``)
LAUNCH_ENV = (
    "HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
    "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK", "HOROVOD_CROSS_SIZE",
    "HOROVOD_COORDINATOR_ADDR", "HOROVOD_HOSTNAME", "HOROVOD_ELASTIC",
    "HOROVOD_ELASTIC_GENERATION", "HOROVOD_ELASTIC_DRIVER_ADDR",
    "HOROVOD_ELASTIC_NOTIFY_ADDR", "RANK", "WORLD_SIZE", "LOCAL_RANK",
    "LOCAL_WORLD_SIZE", "GROUP_RANK", "MASTER_ADDR", "MASTER_PORT",
    "PMIX_RANK", "PMIX_SIZE", "PMIX_LOCAL_RANK", "PMIX_LOCAL_SIZE",
    "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",
    "OMPI_COMM_WORLD_LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_SIZE",
    "PMI_RANK", "PMI_SIZE", "MPI_LOCALRANKID", "MPI_LOCALNRANKS")


def _worker(fn_name, rank, world, port, results, args, device, launch,
            layout=None):
    # a rank takes its place in its world from what spawn_world sets
    # below, never from what the test process holds (a test that ran an
    # elastic worker or a launcher in-process, or a world the test
    # process is in)
    for name in LAUNCH_ENV:
        os.environ.pop(name, None)
    caller = launch is not None and "mpirun" not in launch
    if launch is None:
        os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(world),
                          HOROVOD_LOCAL_RANK=str(rank),
                          HOROVOD_LOCAL_SIZE=str(world),
                          HOROVOD_COORDINATOR_ADDR=f"localhost:{port}")
        if layout is not None:
            _layout_env(rank, device, layout)
    elif not caller:
        _mpirun_env(rank, world, port, launch["mpirun"])
    try:
        if caller:
            _caller_group(rank, world, port, device, launch)
        import horovod_tpu_torch as hvd

        hvd.init(device=device)
        try:
            out = globals()[fn_name](hvd, *args)
            # no rank leaves (and takes down rank 0's store) while another
            # still rendezvouses through it, e.g. for a subgroup (a
            # function that shut the world down has made its own barrier)
            import torch.distributed as dist

            if hvd.is_initialized():
                dist.barrier(group=hvd._state.global_state().host_group)
            results.put((rank, True, out))
        finally:
            hvd.shutdown()
            if caller:
                import torch.distributed as dist

                dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn_world(fn_name: str, world: int = 2, args=(),
                timeout: float = 120.0, device: str = "cpu",
                launch=None, layout=None, dies=()) -> list:
    """Run ``fn_name(hvd, *args)`` on every rank of a world on ``device``
    (``"cpu"``: gloo; ``"cuda"``: NCCL, card ``rank`` for rank ``rank``);
    returns the results ordered by rank, or raises with a failing rank's
    traceback.  Each rank starts without the test process's launcher
    variables (:data:`LAUNCH_ENV`).  The world starts through the
    launcher's ``HOROVOD_*`` contract, or with ``launch`` (a dict, see
    :func:`_caller_group`) from
    a process group that each rank makes before ``hvd.init()``, or with
    ``launch={"mpirun": local_size}`` from what ``mpirun -x`` gives each
    rank (:func:`_mpirun_env`).  Through the ``HOROVOD_*`` contract the
    world is one node of ``world`` ranks unless ``layout=(cross, local)``
    lays it out as ``cross`` nodes of ``local`` ranks
    (:func:`_layout_env`).  The ranks in ``dies`` may exit without a
    result (a dead peer's drill): theirs is None."""
    if layout is not None and layout[0] * layout[1] != world:
        raise ValueError(f"layout {layout} does not cover {world} ranks")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker,
                         args=(fn_name, r, world, port, results, args,
                               device, launch, layout))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world - len(dies):     # drain before joining
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and r not in dies and
                        p.exitcode is not None]
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
    return [got.get(r) for r in range(world)]


def port_test_module(name: str, subs=()) -> "types.ModuleType":
    """``tests/<name>`` (or ``<name>`` under the repository's root when it
    has a directory), each ``(pattern, new)`` of ``subs`` replaced (a
    regular expression, which must match), its imports of the JAX package
    pointed at the port, run as a module of its own: the JAX package's
    tests or seeded scenarios of a plane, against the port's modules."""
    import re
    import types
    from pathlib import Path

    tests = Path(__file__).resolve().parent
    path = tests / name if "/" not in name else tests.parent / name
    src = path.read_text()
    for pattern, new in subs:
        src, n = re.subn(pattern, new, src)
        if not n:
            raise ValueError(f"tests/{name} has no {pattern!r}")
    src = re.sub(r"\bhorovod_tpu\b(?!_torch)", "horovod_tpu_torch", src)
    mod = types.ModuleType(f"port_{path.stem}")
    mod.__file__ = str(path)
    exec(compile(src, f"port of {name}", "exec"), mod.__dict__)
    return mod


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
        # each plan under the default mode (its mode, or the refusal) and
        # under mode="shard_map" (the refusal, or the mode)
        for key, kw in (("default_plan_errors", {}),
                        ("plan_errors", {"mode": "shard_map"})):
            errors = {}
            for plan in ("dp=2,tp=2", "pp=2", "ep=2,sp=2", "ep=2,tp=2"):
                try:
                    errors[plan] = hvd.DistributedTrainStep(
                        lambda m, b: m, torch.optim.SGD(
                            [torch.zeros(1, requires_grad=True)], lr=0.1),
                        plan=plan, **kw).mode
                except ValueError as e:
                    errors[plan] = str(e)
            out[key] = errors
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
    world = hvd.size()
    out = {}
    step, model, opt, batch = _ckpt_mlp(hvd)
    for _ in range(2):
        model, opt, _ = step(model, opt, batch)
    ckpt = Checkpointer(os.path.join(directory, "adamw"))
    ckpt.save_sharded(2, opt.sharded_state_dict(), opt.shard_index, world,
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
    ef.save_sharded(2, opt.sharded_state_dict(), opt.shard_index, world)
    hvd.barrier()
    _, _, fresh, _ = _ckpt_mlp(hvd, compression=hvd.Compression.int8,
                               error_feedback=True)
    template = fresh.sharded_state_template()
    fresh.load_sharded_state_dict(ef.restore_sharded(template,
                                                     fresh.shard_index, world))
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
    world = hvd.size()
    step, model, opt, batch = _ckpt_mlp(hvd)
    ckpt = Checkpointer(os.path.join(directory, "adamw"))
    template = opt.sharded_state_template()
    shapes = {k: {n: tuple(t.shape) for n, t in v.items()}
              for k, v in template["state"].items()}
    restored = ckpt.restore_sharded(template, opt.shard_index, world,
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
    for key, mode in (("sharded", None), ("sharded_pjit", "pjit")):
        try:
            hvd.DistributedTrainStep(moe_lm_loss, torch.optim.AdamW(
                [torch.zeros(2, requires_grad=True)]), plan=f"ep={world}",
                shard_optimizer_states=True, mode=mode)
        except ValueError as e:
            errors[key] = str(e)
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
    ckpt.save_sharded(2, opt.sharded_state_dict(), opt.shard_index, world,
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


# ---------------------------------------------------------------------------
# the input plane and the identity of a world made by the caller
# ---------------------------------------------------------------------------

#: rows of the data tests' source, and its per-rank batch
DATA_ROWS, DATA_BATCH = 48, 3
IDENTITY_QUERIES = ("rank", "size", "local_rank", "local_size", "cross_rank",
                    "cross_size", "process_rank", "process_count",
                    "is_homogeneous")
PROBES = ("nccl_built", "gloo_built", "gloo_enabled", "cuda_built",
          "mpi_built", "mpi_enabled", "ddl_built", "ccl_built", "rocm_built",
          "mpi_threads_supported")


def data_columns() -> dict:
    """The data tests' source: a dict of columns, row i's values i-based."""
    rows = np.arange(DATA_ROWS)
    return {"x": np.stack([rows, rows * 10, rows * 100], 1)
            .astype(np.float32),
            "y": (rows * 7).astype(np.int64)}


def sp_tokens(rows: int) -> np.ndarray:
    return np.arange(rows * 8, dtype=np.int64).reshape(rows, 8)


def run_identity(hvd):
    """The rank's identity, the probes, the launcher variables it sees,
    and the input plane under it: the
    broadcast seed, a ShardedDataset's default rank and world, five
    batches through a PrefetchIterator placing with ``shard_local_batch``,
    and ``shard_local_batch`` against ``shard_batch`` of the concatenated
    rows, without a plan and under an sp plan."""
    import torch

    from horovod_tpu_torch.data import (
        ArraySource,
        PrefetchIterator,
        ShardedDataset,
        broadcast_seed,
    )

    torch.set_num_threads(1)   # or the ranks oversubscribe the cores
    rank, world = hvd.rank(), hvd.size()
    out = {k: getattr(hvd, k)() for k in IDENTITY_QUERIES}
    out["probes"] = {k: getattr(hvd, k)() for k in PROBES}
    out["device"] = str(hvd.device())
    out["launch_env"] = sorted(k for k in LAUNCH_ENV if k in os.environ)
    out["seed"] = broadcast_seed(100 + rank)
    ds = ShardedDataset(ArraySource(data_columns()), batch_size=DATA_BATCH,
                        seed=out["seed"])
    out["ds"] = (ds.rank, ds.world)
    model = torch.nn.Linear(3, 1)
    step = hvd.DistributedTrainStep(lambda m, b: m(b["x"]).mean(),
                                    torch.optim.SGD(model.parameters(),
                                                    lr=0.1))
    with PrefetchIterator(ds.iter_epochs(), place=step.shard_local_batch,
                          depth=2, threads=2) as feed:
        out["fed"] = [{k: v.numpy() for k, v in next(feed).items()}
                      for _ in range(2 * ds.steps_per_epoch + 1)]
    cols = data_columns()
    mine = {k: v[rank * DATA_BATCH:(rank + 1) * DATA_BATCH]
            for k, v in cols.items()}
    every = {k: v[:world * DATA_BATCH] for k, v in cols.items()}
    out["local"] = {k: v.numpy() for k, v in
                    step.shard_local_batch(mine).items()}
    out["global"] = {k: v.numpy() for k, v in
                     step.shard_batch(every).items()}
    sp = hvd.DistributedTrainStep(
        lambda m, b: m(b).mean(),
        torch.optim.SGD(torch.nn.Linear(8, 1).parameters(), lr=0.1),
        plan="sp=2" if world == 2 else "dp=2,sp=2")
    dp = sp.mesh.index("dp")
    tokens = sp_tokens(sp.plan.dp * 2)
    out["sp_local"] = sp.shard_local_batch(tokens[dp * 2:(dp + 1) * 2]) \
        .numpy()
    out["sp_global"] = sp.shard_batch(tokens).numpy()
    return out


# ---------------------------------------------------------------------------
# SyncBatchNorm
# ---------------------------------------------------------------------------

#: (rows a rank, channels, height, width) of the SyncBatchNorm tests
SYNC_BN_SHAPE = (2, 6, 5, 5)


def sync_bn_inputs(world: int) -> dict:
    """The global NCHW input and upstream gradient, the module's
    parameters and running statistics, and the unequal-counts input (rank
    r holds r + 1 rows of ``u``)."""
    b, c, h, w = SYNC_BN_SHAPE
    rng = np.random.RandomState(40 + world)
    # channels with distinct offsets and spreads, so that per-rank
    # statistics would differ from the global ones
    x = rng.randn(world * b, c, h, w) * (1 + np.arange(c))[:, None, None] \
        + np.arange(world * b)[:, None, None, None] * 0.3
    rows = world * (world + 1) // 2
    u = rng.randn(rows, c, h, w) + np.arange(rows)[:, None, None, None]
    return {"x": x.astype(np.float32),
            "g": rng.randn(world * b, c, h, w).astype(np.float32),
            "scale": (1 + 0.1 * rng.randn(c)).astype(np.float32),
            "bias": (0.1 * rng.randn(c)).astype(np.float32),
            "mean": (0.1 * rng.randn(c)).astype(np.float32),
            "var": (1 + 0.1 * rng.rand(c)).astype(np.float32),
            "u": u.astype(np.float32),
            "gm": rng.randn(c).astype(np.float32),
            "gv": rng.randn(c).astype(np.float32)}


def sync_bn_module(torch, inp: dict, **kw):
    from horovod_tpu_torch.optim import SyncBatchNorm

    bn = SyncBatchNorm(inp["scale"].size, **kw)
    bn.load_state_dict({k: torch.from_numpy(inp[k].copy())
                        for k in ("scale", "bias", "mean", "var")})
    return bn


def sync_bn_grads(torch, bn, x, g, **kw) -> dict:
    """Output, running statistics and the gradients of ``(y·g).sum()``
    with respect to the input, scale and bias."""
    x = x.detach().clone().requires_grad_()
    y = bn(x, **kw)
    (y * g).sum().backward()
    return {"y": _host(y), "dx": _host(x.grad), "dscale": _host(bn.scale.grad),
            "dbias": _host(bn.bias.grad), "mean": _host(bn.mean),
            "var": _host(bn.var)}


def _host(t) -> np.ndarray:
    return t.detach().float().cpu().numpy().copy()


def run_sync_bn(hvd):
    """SyncBatchNorm on this rank's rows (channels-last, on the runtime's
    device), counting the collective calls of a forward, a backward and a
    running-average forward; ``sync_batch_stats`` with unequal per-rank
    rows; and at a world of 4 the module over a group of two ranks."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.optim import sync_batch_stats

    torch.set_num_threads(1)   # or the ranks oversubscribe the cores
    rank, world, dev = hvd.rank(), hvd.size(), hvd.device()
    inp = sync_bn_inputs(world)
    b = SYNC_BN_SHAPE[0]
    part = slice(rank * b, (rank + 1) * b)
    x = torch.from_numpy(inp["x"][part]).to(dev).contiguous(
        memory_format=torch.channels_last)
    g = torch.from_numpy(inp["g"][part]).to(dev)
    calls = []
    all_reduce = dist.all_reduce

    def counted(*a, **kw):
        calls.append(1)
        return all_reduce(*a, **kw)

    dist.all_reduce = counted
    try:
        bn = sync_bn_module(torch, inp).to(dev)
        xg = x.detach().clone().requires_grad_()
        y = bn(xg)
        fwd = len(calls)
        (y * g).sum().backward()
        out = {"y": _host(y), "dx": _host(xg.grad),
               "dscale": _host(bn.scale.grad), "dbias": _host(bn.bias.grad),
               "mean": _host(bn.mean), "var": _host(bn.var),
               "channels_last": y.is_contiguous(
                   memory_format=torch.channels_last),
               "calls": (fwd, len(calls) - fwd), "device": str(dev),
               "local_rank": hvd.local_rank()}
        n = len(calls)
        out["running"] = _host(bn(x, use_running_average=True))
        out["calls_running"] = len(calls) - n
    finally:
        dist.all_reduce = all_reduce
    lo = rank * (rank + 1) // 2
    u = torch.from_numpy(inp["u"][lo:lo + rank + 1]).to(dev) \
        .requires_grad_()
    h, w = SYNC_BN_SHAPE[2:]
    mean, var = sync_batch_stats(u, counts=(rank + 1) * h * w)
    ((mean * torch.from_numpy(inp["gm"]).to(dev)).sum()
     + (var * torch.from_numpy(inp["gv"]).to(dev)).sum()).backward()
    out["counts"] = {"mean": _host(mean), "var": _host(var),
                     "du": _host(u.grad)}
    if world == 4:
        pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        out["pair"] = sync_bn_grads(torch, sync_bn_module(
            torch, inp, group=pairs[rank // 2]).to(dev), x, g)
    return out


def run_prefetch_card(hvd):
    """A PrefetchIterator on the card (depth 1, two threads): five seeded
    host batches through ``shard_local_batch``, the delivered tensors and
    their streams, and the staging buffers."""
    import torch

    from horovod_tpu_torch.data import PrefetchIterator

    rng = np.random.RandomState(5)
    # two leaves of one shape: each has a ring of its own
    host = [{"x": rng.rand(8, 16, 16, 3).astype(np.float32),
             "x2": rng.rand(8, 16, 16, 3).astype(np.float32),
             "y": rng.randint(0, 10, (8,)).astype(np.int32)}
            for _ in range(5)]
    step = hvd.DistributedTrainStep(
        lambda m, b: m(b["x"]).mean(),
        torch.optim.SGD(torch.nn.Linear(3, 1).to(hvd.device()).parameters(),
                        lr=0.1))
    consumer = torch.cuda.current_stream()
    out = {"device": str(hvd.device()), "consumer": consumer.stream_id,
           "devices": set()}
    with PrefetchIterator(iter(host), place=step.shard_local_batch,
                          depth=1, threads=2) as feed:
        stager = feed.stager
        out["copy"] = stager.stream.stream_id
        got = []
        for i, b in enumerate(feed):
            if i == 0:
                slots = [s for ring in stager._rings.values() for s in ring]
                out["pinned"] = bool(slots) and all(s.buf.is_pinned()
                                                    for s in slots)
                out["events"] = all(getattr(v, "_hvd_copy_event", None)
                                    is not None for v in b.values())
            # consumer-stream work on the delivered batch
            got.append({k: (v * 1).cpu().numpy() for k, v in b.items()})
            out["devices"].update(str(v.device) for v in b.values())
    out["equal"] = all(np.array_equal(g[k], h[k]) for g, h in zip(got, host)
                       for k in h)
    out["batches"] = len(got)
    return out


def run_sync_bn_parity_card(hvd):
    """chip_smoke's SyncBatchNorm-against-BatchNorm check at a small
    bf16 channels-last shape on the card."""
    import torch

    import chip_smoke

    return chip_smoke.sync_bn_parity(torch, (8, 64, 14, 14))


# ---------------------------------------------------------------------------
# worlds started by the port's launcher (python -m horovod_tpu_torch.runner)
# ---------------------------------------------------------------------------

def run_launch(hvd, steps: int):
    """A rank's identity, the launcher's variables it found, and with
    ``steps`` the losses and weights of :func:`run_train` (each rank draws
    its own weights; ``init`` broadcasts rank 0's).  One intra-op thread a
    rank, in the launched worlds and in their spawned references alike."""
    import torch

    from chip_smoke import LAUNCH_VARS

    torch.set_num_threads(1)
    out = {k: getattr(hvd, k)() for k in IDENTITY_QUERIES}
    out["device"] = str(hvd.device())
    if hvd.device().type == "cuda":
        out["card"] = str(torch.cuda.get_device_properties(hvd.device())
                          .uuid)
    out["env"] = {k: os.environ.get(k) for k in LAUNCH_VARS}
    if steps:
        out["losses"], out["params"] = run_train(hvd, steps, 0, True)
    return out


def rank_identity(tag: str) -> dict:
    """``run()``'s function: the launcher's identity of this rank."""
    return {"tag": tag, "rank": int(os.environ["HOROVOD_RANK"]),
            "size": int(os.environ["HOROVOD_SIZE"]),
            "local_rank": int(os.environ["HOROVOD_LOCAL_RANK"])}


def rank_fails(code: int):
    """``run()``'s function: rank 1 raises."""
    if os.environ["HOROVOD_RANK"] == "1":
        raise RuntimeError(f"rank 1 fails with {code}")
    return 0


# ---------------------------------------------------------------------------
# Adasum and the row-sparse exchange (tests/test_torch_adasum.py,
# tests/test_torch_sparse.py)
# ---------------------------------------------------------------------------

#: the (cross, local) layouts of the Adasum worlds: recursive doubling over
#: 2 and 4 nodes, the gathered tree over 3, and JAX's GLOBAL_AXES mesh
ADASUM_LAYOUTS = ((2, 1), (4, 1), (3, 1), (2, 4))
#: the layouts whose worlds also train: the optimizer cases and the MLP
ADASUM_TRAIN_LAYOUTS = ((4, 1), (2, 4))
#: grouped_allreduce(op=Adasum)'s scale factors in the scaled case
ADASUM_SCALES = (0.5, 3.0)


def adasum_inputs(rank: int) -> list:
    """Rank ``rank``'s tensors: two fp32 of odd sizes and one that
    :func:`adasum_torch` casts to bf16; rank 1's second tensor is zero, so
    the zero-norm guard acts."""
    rng = np.random.RandomState(300 + rank)
    xs = [rng.randn(3, 7).astype(np.float32),
          rng.randn(11).astype(np.float32),
          rng.randn(6).astype(np.float32)]
    if rank == 1:
        xs[1][:] = 0.0
    return xs


def adasum_torch(rank: int, device="cpu") -> list:
    import torch

    xs = [torch.from_numpy(x).to(device) for x in adasum_inputs(rank)]
    xs[2] = xs[2].to(torch.bfloat16)
    return xs


#: the delta optimizer's parameters and per-rank gradients (the JAX
#: package's tests/test_adasum.py TestDistributedAdasumOptimizer)
DAO_W0 = np.linspace(-1.0, 1.0, 6).reshape(3, 2).astype(np.float32)
DAO_B0 = np.array([0.5, -0.5, 1.5, 2.0], np.float32)
DAO_STEPS = 3
#: name -> (torch optimizer, keyword arguments); the test builds the optax
#: twin of each
DAO_CASES = {"sgdm": ("SGD", dict(lr=0.1, momentum=0.9)),
             "adamw": ("AdamW", dict(lr=1e-2, weight_decay=1e-2))}


def dao_grads(rank: int, step: int, xp=np) -> dict:
    """Deterministic per-rank, per-step gradients, not parallel across
    ranks (numpy or jnp)."""
    gw = xp.sin(DAO_W0 * (rank + 1) + 0.3 * step) * 0.5
    gb = xp.cos(DAO_B0 * (rank + 2) - 0.1 * step) * 0.5
    return {"w": gw.astype(xp.float32), "b": gb.astype(xp.float32)}


def _dao_run(hvd, case: str, k: int = 1) -> list:
    """``DAO_STEPS * k`` micro-steps of ``DistributedAdasumOptimizer`` on
    :func:`dao_grads`; the parameters after each, as numpy."""
    import torch

    name, kw = DAO_CASES[case]
    dev = hvd.device()
    w = torch.nn.Parameter(torch.from_numpy(DAO_W0.copy()).to(dev))
    b = torch.nn.Parameter(torch.from_numpy(DAO_B0.copy()).to(dev))
    opt = hvd.DistributedAdasumOptimizer(
        getattr(torch.optim, name)([w, b], **kw), backward_passes_per_step=k)
    hist = []
    for t in range(DAO_STEPS * k):
        g = dao_grads(hvd.rank(), t)
        w.grad = torch.from_numpy(g["w"]).to(dev)
        b.grad = torch.from_numpy(g["b"]).to(dev)
        opt.step()
        opt.zero_grad()
        hist.append({"w": w.detach().cpu().numpy().copy(),
                     "b": b.detach().cpu().numpy().copy()})
    return hist


#: the MLP's rows a rank, steps and SGD learning rate in the op=Adasum cases
ADASUM_MLP = dict(rows=4, steps=2, lr=0.1)


def adasum_mlp_batch(world: int):
    return mlp_batch(n=ADASUM_MLP["rows"] * world, seed=11)


def _mlp_model(dev):
    import torch

    return torch.nn.ParameterDict({
        k: torch.nn.Parameter(torch.from_numpy(v.copy()).to(dev))
        for k, v in mlp_params().items()})


def _mlp_numpy(model) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in model.items()}


def _adasum_mlp(hvd, path: str) -> dict:
    """``ADASUM_MLP["steps"]`` SGD steps of the MLP on this rank's rows:
    ``"hook"``, ``DistributedOptimizer(op=Adasum)`` with hooks fired by
    ``backward()``; ``"step_time"``, the same with the gradients from
    ``torch.autograd.grad`` (no hook), so ``step()`` launches every
    bucket; ``"train_step"``, ``DistributedTrainStep(op=Adasum)``;
    ``"delta"``, ``DistributedTrainStep(op=None)`` over
    ``DistributedAdasumOptimizer(SGD(momentum=0.9))``."""
    import torch

    dev, rank = hvd.device(), hvd.rank()
    model = _mlp_model(dev)
    lr, steps = ADASUM_MLP["lr"], ADASUM_MLP["steps"]
    x, y = adasum_mlp_batch(hvd.size())
    if path in ("train_step", "delta"):
        if path == "delta":
            opt = hvd.DistributedAdasumOptimizer(
                torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9))
            step = hvd.DistributedTrainStep(mlp_loss, opt, op=None)
        else:
            opt = torch.optim.SGD(model.parameters(), lr=lr)
            step = hvd.DistributedTrainStep(mlp_loss, opt, op=hvd.Adasum)
        model, opt = step.init(model)
        batch = step.shard_batch({"x": x, "y": y})
        losses = [float(step(model, opt, batch)[2]) for _ in range(steps)]
        return {"params": _mlp_numpy(model), "losses": losses}
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=lr),
                                   op=hvd.Adasum)
    n = ADASUM_MLP["rows"]
    batch = {"x": torch.from_numpy(x[rank * n:(rank + 1) * n]).to(dev),
             "y": torch.from_numpy(y[rank * n:(rank + 1) * n]).to(dev)}
    sources = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = mlp_loss(model, batch)
        if path == "hook":
            loss.backward()
        else:
            params = list(model.values())
            for p, g in zip(params, torch.autograd.grad(loss, params)):
                p.grad = g
        opt.step()
        sources.append(sorted({src for _, src in opt.launches}))
    return {"params": _mlp_numpy(model), "sources": sources,
            "buckets": len(opt._buckets)}


#: the slice's LM: TransformerLM sizes, tokens and AdamW of its 3 steps
ADASUM_LM = dict(vocab_size=128, num_layers=2, num_heads=2, d_model=64,
                 d_ff=128, max_seq_len=32)
ADASUM_LM_STEPS = 3


def adasum_lm_tokens(rows: int = 8) -> np.ndarray:
    return np.random.RandomState(13).randint(0, 128, (rows, 17)).astype(
        np.int64)


def adasum_lm_train(hvd, params=None, hook: bool = False,
                    rows: int = 8) -> dict:
    """The fp32 TransformerLM from ``params`` (a state dict of numpy
    arrays; None: drawn from seed 0) trained ``ADASUM_LM_STEPS`` steps
    through ``DistributedTrainStep(op=None)`` over
    ``DistributedAdasumOptimizer(AdamW(3e-4, weight_decay=1e-4))``, or
    with ``hook`` through ``DistributedTrainStep(op=Adasum)`` (the hook
    path), on ``rows`` sequences of :func:`adasum_lm_tokens`; losses and
    state dict as numpy."""
    import torch

    from horovod_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        lm_loss,
    )

    dev = hvd.device()
    cfg = TransformerConfig(dtype=torch.float32, attention_impl="flash",
                            **ADASUM_LM)
    model = TransformerLM(cfg, generator=torch.Generator().manual_seed(0))
    if params is not None:
        model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                               for k, v in params.items()})
    model.to(dev)
    adamw = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4)
    if hook:
        step = hvd.DistributedTrainStep(lambda m, b: lm_loss(m, b), adamw,
                                        op=hvd.Adasum)
    else:
        step = hvd.DistributedTrainStep(
            lambda m, b: lm_loss(m, b),
            hvd.DistributedAdasumOptimizer(adamw), op=None)
    model, opt = step.init(model)
    batch = step.shard_batch(adasum_lm_tokens(rows))
    losses = [float(step(model, opt, batch)[2])
              for _ in range(ADASUM_LM_STEPS)]
    return {"losses": losses,
            "params": {k: v.cpu().numpy().copy()
                       for k, v in model.state_dict().items()}}


def run_adasum(hvd, train: bool = False, lm_params=None) -> dict:
    """Every Adasum check of one world: the grouped reduction, the
    ``grouped_allreduce``/``allreduce(op=Adasum)`` forms, the eager plane
    on the same tensor, the zero-norm guard's count; with ``train`` the
    delta optimizer's cases (and ``backward_passes_per_step=2``) and the
    MLP through every op=Adasum path; with ``lm_params`` the slice's LM."""
    import torch

    from horovod_tpu_torch import telemetry
    from horovod_tpu_torch.ops import adasum as A
    from horovod_tpu_torch.ops import collectives as C

    torch.set_num_threads(1)   # or the ranks oversubscribe the cores
    dev, rank = hvd.device(), hvd.rank()
    xs = adasum_torch(rank, dev)
    host = lambda ts: [t.float().cpu().numpy() for t in ts]  # noqa: E731
    telemetry.enable()
    telemetry.reset()
    out = {"grouped": host(A.adasum_grouped_allreduce(xs))}
    out["fallbacks"] = telemetry.value("hvd_adasum_zero_norm_fallbacks_total")
    pre, post = ADASUM_SCALES
    out["scaled"] = host(C.grouped_allreduce(
        xs, op=C.Adasum, prescale_factor=pre, postscale_factor=post))
    out["single"] = host([C.allreduce(xs[0], op=C.Adasum)])[0]
    out["eager"] = host([hvd.allreduce(xs[0], op=hvd.Adasum)])[0]
    out["inputs_kept"] = all(torch.equal(a, b) for a, b in
                             zip(xs, adasum_torch(rank, dev)))
    if train:
        out["dao"] = {case: _dao_run(hvd, case)[-1] for case in DAO_CASES}
        out["dao_k2"] = _dao_run(hvd, "sgdm", k=2)
        cfg = hvd._state.global_state().config
        threshold, cfg.fusion_threshold_bytes = \
            cfg.fusion_threshold_bytes, 64
        try:
            out["mlp"] = {path: _adasum_mlp(hvd, path) for path in
                          ("hook", "step_time", "train_step", "delta")}
        finally:
            cfg.fusion_threshold_bytes = threshold
    if lm_params is not None:
        out["lm"] = adasum_lm_train(hvd, lm_params)
    return out


def run_adasum_card(hvd) -> dict:
    """The grouped reduction of :func:`adasum_inputs` and the seeded LM
    trained on 12 sequences (a multiple of worlds of 2, 3 and 4) by the
    delta form and by op=Adasum on the hook path (a world on the card or
    its gloo twin)."""
    import torch

    from horovod_tpu_torch.ops import adasum as A

    torch.set_num_threads(1)   # or the ranks oversubscribe the cores
    xs = adasum_torch(hvd.rank(), hvd.device())
    return {"grouped": [t.float().cpu().numpy()
                        for t in A.adasum_grouped_allreduce(xs)],
            "delta": adasum_lm_train(hvd, rows=12),
            "hook": adasum_lm_train(hvd, hook=True, rows=12)}


#: the row-sparse cases: the dense table's rows and width, each rank's
#: max_rows slots, and the embedding model of the optimizer cases
SPARSE_ROWS, SPARSE_WIDTH, SPARSE_SLOTS = 12, 3, 5
SPARSE_V, SPARSE_D = 32, 4


def sparse_inputs(rank: int) -> dict:
    """Rank ``rank``'s ``sparse_allreduce`` operands (``SPARSE_SLOTS``
    unique rows of ``SPARSE_ROWS``, the last slot the fill index with a
    nonzero value that must be dropped) and a dense gradient with 4
    touched rows for ``_sparse_leaf_reduce``."""
    rng = np.random.RandomState(500 + rank)
    idx = rng.permutation(SPARSE_ROWS)[:SPARSE_SLOTS].astype(np.int64)
    idx[-1] = SPARSE_ROWS
    vals = rng.randn(SPARSE_SLOTS, SPARSE_WIDTH).astype(np.float32)
    g = np.zeros((SPARSE_ROWS, SPARSE_WIDTH), np.float32)
    rows = rng.permutation(SPARSE_ROWS)[:4]
    g[rows] = rng.randn(4, SPARSE_WIDTH).astype(np.float32)
    return {"values": vals, "indices": idx, "grad": g}


def sparse_model_params() -> dict:
    """The JAX package's TestSparseGradientRouting table and head."""
    rng = np.random.RandomState(3)
    return {"emb": rng.randn(SPARSE_V, SPARSE_D).astype(np.float32),
            "w": rng.randn(SPARSE_D, 2).astype(np.float32)}


def sparse_tokens(world: int) -> np.ndarray:
    """4 token ids a rank, ``(world, 4)``."""
    return np.random.RandomState(9).randint(0, SPARSE_V, (world, 4))


def _sparse_opt_run(hvd, sparse, path: str) -> dict:
    """One SGD(1.0) step of the embedding model on this rank's tokens
    (``sum((emb[t] @ w)**2)``); ``path`` ``"hook"`` (backward) or
    ``"step_time"`` (``torch.autograd.grad``, no hook).  Returns the
    parameters, i.e. the initial ones minus the reduced gradients."""
    import torch

    dev = hvd.device()
    model = torch.nn.ParameterDict({
        k: torch.nn.Parameter(torch.from_numpy(v.copy()).to(dev))
        for k, v in sparse_model_params().items()})
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=1.0),
                                   named_parameters=model.named_parameters(),
                                   sparse_params=sparse)
    tok = torch.from_numpy(sparse_tokens(hvd.size())[hvd.rank()]).to(dev)
    loss = torch.sum((model["emb"][tok] @ model["w"]) ** 2)
    if path == "hook":
        loss.backward()
    else:
        params = list(model.values())
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
    opt.step()
    return _mlp_numpy(model)


def _sparse_step_run(hvd, sparse) -> dict:
    """One SGD(0.1) step of DistributedTrainStep(sparse_params=sparse)
    on the global tokens (``mean((emb[t] @ w)**2)``)."""
    import torch

    dev = hvd.device()
    model = torch.nn.ParameterDict({
        k: torch.nn.Parameter(torch.from_numpy(v.copy()).to(dev))
        for k, v in sparse_model_params().items()})

    def loss_fn(m, batch):
        return torch.mean((m["emb"][batch] @ m["w"]) ** 2)

    step = hvd.DistributedTrainStep(
        loss_fn, torch.optim.SGD(model.parameters(), lr=0.1),
        sparse_params=sparse)
    model, opt = step.init(model)
    batch = step.shard_batch(torch.from_numpy(sparse_tokens(hvd.size())))
    loss = float(step(model, opt, batch)[2])
    return {"params": _mlp_numpy(model), "loss": loss}


def run_sparse(hvd) -> dict:
    """Every row-sparse check of one world: ``sparse_allreduce`` for Sum
    and Average, ``_sparse_leaf_reduce`` with a bound that drops rows and
    one that leaves fill slots, ``distributed_gradients`` with a mapping,
    the optimizer on both paths and the step, each with and without
    ``sparse_params``."""
    import torch

    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.optim import optimizer as O

    torch.set_num_threads(1)   # or the ranks oversubscribe the cores
    dev = hvd.device()
    inp = sparse_inputs(hvd.rank())
    vals = torch.from_numpy(inp["values"]).to(dev)
    idx = torch.from_numpy(inp["indices"]).to(dev)
    g = torch.from_numpy(inp["grad"]).to(dev)
    out = {}
    for op in ("Sum", "Average"):
        out[("allreduce", op)] = C.sparse_allreduce(
            vals, idx, SPARSE_ROWS, op=getattr(C, op)).cpu().numpy()
        for bound in (2, 8):
            out[("leaf", op, bound)] = O._sparse_leaf_reduce(
                g, bound, getattr(C, op)).cpu().numpy()
    named = {"table.emb": g.clone(), "head": vals.clone()}
    O.distributed_gradients(named, sparse_params={"emb": 8})
    out["distributed_gradients"] = {k: v.cpu().numpy()
                                    for k, v in named.items()}
    for sparse in (None, {"emb": 4}, {"emb": 16}):
        key = None if sparse is None else sparse["emb"]
        for path in ("hook", "step_time"):
            out[("opt", key, path)] = _sparse_opt_run(hvd, sparse, path)
    for sparse in (None, {"emb": 8}):
        out[("step", None if sparse is None else 8)] = _sparse_step_run(
            hvd, sparse)
    return out


# ---------------------------------------------------------------------------
# the hierarchical and tree exchange (tests/test_torch_hierarchy.py)
# ---------------------------------------------------------------------------

#: the gloo worlds of the hierarchy tests, as (cross, local) layouts; the
#: world of 8 also runs the three-level tree 2 x 2 x 2 from its own groups
HIER_LAYOUTS = ((2, 4), (3, 2))
#: the MLP trainings of :func:`hier_mlp`: name -> (steps, step options)
HIER_MLP_CASES = {
    "flat": (8, {"hierarchy": "flat"}),
    "two_level": (8, {"hierarchy": "two_level"}),
    "auto": (8, {}),
    "tree": (8, {"hierarchy": "tree"}),
    "b64": (8, {"hierarchy": "two_level", "exchange_bucket_bytes": 64}),
    "int8": (3, {"hierarchy": "two_level", "compression": "int8"}),
    "int8_ef": (3, {"hierarchy": "two_level", "compression": "int8",
                    "error_feedback": True, "exchange_bucket_bytes": 64}),
    "fp8_ef": (3, {"hierarchy": "two_level", "compression": "int8",
                   "error_feedback": True, "wire": "fp8_e4m3"}),
    "adasum": (3, {"hierarchy": "two_level", "reduction": "adasum"}),
}
#: the cases the world of 3 x 2 trains too
HIER_MLP_3X2 = ("flat", "two_level", "adasum")


def hier_leaves(world: int) -> dict:
    """Every rank's exchange inputs, stacked over ranks: three fp32 leaves
    of 10, 3 x 5 and 7 values, a 24-value codec input per rank, and the
    local codec's residuals (their first values, as many as the leaves'
    one group pads to)."""
    rng = np.random.RandomState(600 + world)
    return {"a": rng.randn(world, 10).astype(np.float32),
            "b": rng.randn(world, 3, 5).astype(np.float32),
            "c": rng.randn(world, 7).astype(np.float32),
            "codec": rng.randn(world, 24).astype(np.float32),
            "resid": (rng.randn(world, 48) * 1e-2).astype(np.float32)}


def tree3_groups(rank: int):
    """The 2 x 2 x 2 tree's (chip, slice, pod) groups of ``rank`` in a
    world of 8, rank = pod·4 + slice·2 + chip; every rank makes every
    group, in one order."""
    import torch.distributed as dist

    mine = []
    for level in range(3):          # chip, slice, pod
        stride = 1 << level
        for base in range(8):
            if base & stride:
                continue
            ranks = [base, base + stride]
            group = dist.new_group(ranks)
            if rank in ranks:
                mine.append(group)
    return mine


def _tree_case(C, xs, levels, **kw):
    """tree_reducescatter then tree_allgather: (shards, leaves), numpy."""
    out = C.tree_reducescatter(xs, levels, **kw)
    shards, spec = out[0], out[1]
    host = {k: v.float().numpy().copy() for k, v in shards.items()}
    back = [v.numpy().copy() for v in C.tree_allgather(shards, spec, levels)]
    if len(out) == 3:
        return host, back, {k: v.numpy().copy() for k, v in out[2].items()}
    return host, back


def hier_mlp(hvd, name: str) -> dict:
    """``HIER_MLP_CASES[name]`` through DistributedTrainStep with AdamW
    (lr 1e-2, weight decay 1e-4) on :func:`mlp_batch`'s global batch of 8
    rows a rank: the last loss, the parameters, the mode the step
    runs, the block this rank owns and its first-moment shards."""
    import torch

    steps, kw = HIER_MLP_CASES[name]
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
        step = hvd.DistributedTrainStep(
            mlp_loss, torch.optim.AdamW(model.parameters(), lr=1e-2,
                                        weight_decay=1e-4),
            shard_optimizer_states=True, **kw)
        model, opt = step.init(model)
        x, y = mlp_batch(8 * hvd.size())
        batch = step.shard_batch({"x": x, "y": y})
        for _ in range(steps):
            model, opt, loss = step(model, opt, batch)
    finally:
        cfg.exchange_wire_dtype = wire
    st = opt.sharded_state
    return {"loss": float(loss),
            "params": {k: v.detach().numpy().copy()
                       for k, v in model.items()},
            "mode": step.exchange_hierarchy, "index": opt.shard_index,
            "mu": {k: st.inner.state[s]["exp_avg"].numpy().copy()
                   for k, s in st.shards.items()}}


def run_hierarchy(hvd, lm=None) -> dict:
    """On a gloo world laid out as (cross, local) nodes: the two-level
    exchange's round trip, shards, ownership, Average and buckets, codecs
    (outer, inner with residuals, by level name) and Adasum on the cross
    hop; on a world of 8 also the three-level tree from its own groups;
    the MLP trainings, and with ``lm`` (state dict, sizes, tokens) the
    two-layer TransformerLM 3 steps two_level and tree."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.runtime.topology import resolve_topology

    torch.set_num_threads(1)   # or the ranks oversubscribe the cores
    world, rank = hvd.size(), hvd.rank()
    st = hvd._state.global_state()
    cfg = st.config
    inp = hier_leaves(world)

    def t(k):
        return torch.from_numpy(np.ascontiguousarray(inp[k][rank]))

    xs = [t("a"), t("b"), t("c")]
    two = C.layout_levels()
    out = {"index": C.tree_shard_index(two),
           ("two", "sum"): _tree_case(C, xs, two)}
    shards, spec = C.grouped_reducescatter(xs)
    out[("flat", "sum")] = (
        {k: v.numpy().copy() for k, v in shards.items()},
        [v.numpy().copy() for v in C.grouped_allgather(shards, spec)])
    sh, spec = C.hierarchical_reducescatter(xs, op=C.Average,
                                            bucket_bytes=64)
    out[("two", "avg_b64")] = (
        {k: v.numpy().copy() for k, v in sh.items()},
        [v.numpy().copy() for v in C.hierarchical_allgather(sh, spec)])
    # rank 0's leaves on every rank: the owned slices gather back to them
    first = [torch.from_numpy(np.ascontiguousarray(inp[k][0]))
             for k in "abc"]
    own = C.local_fusion_shards(first, spec, index=out["index"])
    out["own"] = ({k: v.numpy().copy() for k, v in own.items()},
                  [v.numpy().copy() for v in C.tree_allgather(own, spec,
                                                              two)])
    codec = [t("codec")]
    padded = C.make_fusion_spec(xs, world).groups[0].padded
    for wire in WIRES:
        wire0, cfg.exchange_wire_dtype = cfg.exchange_wire_dtype, wire
        try:
            out[("q", wire)] = _tree_case(C, codec, C.layout_levels(8),
                                          op=C.Average)
            out[("qi", wire)] = _tree_case(
                C, xs, C.layout_levels(8, True), op=C.Sum,
                residuals={"b0/float32": t("resid")[:padded].clone()})
            out[("adasum_q", wire)] = _tree_case(
                C, xs, C.layout_levels(8), reduction="adasum")
        finally:
            cfg.exchange_wire_dtype = wire0
    levels = C.exchange_levels_from_topology(resolve_topology(
        "two_level", (st.cross_size, st.local_size),
        level_codecs={"local": 8}))
    out["codecs_local"] = _tree_case(C, xs, levels, op=C.Average)
    for op in ("Sum", "Average"):
        out[("adasum", op)] = _tree_case(C, xs, two, op=getattr(C, op),
                                         reduction="adasum",
                                         prescale_factor=0.5,
                                         postscale_factor=2.0)
    # an outer hop of one rank, and a tree of one level: the plain sum
    deg = (C.ExchangeLevel.over(dist.group.WORLD), C.ExchangeLevel.over(None))
    out["degenerate"] = [_tree_case(C, xs, lv, op=C.Average,
                                    reduction=red)
                         for lv in (deg, deg[:1]) for red in C.REDUCTIONS]
    if world == 8:
        tree = [C.ExchangeLevel.over(g) for g in tree3_groups(rank)]
        q_pod = tree[:2] + [C.ExchangeLevel.over(tree[2].group, 8)]
        q_chip = [C.ExchangeLevel.over(tree[0].group, 8)] + tree[1:]
        out["tree3"] = {
            "index": C.tree_shard_index(tree),
            "sum": _tree_case(C, xs, tree),
            "pod_int8": _tree_case(C, codec, q_pod, op=C.Average),
            "chip_int8": _tree_case(C, [torch.full((8,), 500.0),
                                        torch.full((8,), 1e-3)], q_chip,
                                    op=C.Average),
            "adasum": _tree_case(C, xs, tree, op=C.Average,
                                 reduction="adasum")}
    cases = HIER_MLP_CASES if world == 8 else HIER_MLP_3X2
    out["mlp"] = {name: hier_mlp(hvd, name) for name in cases}
    if lm is not None:
        out["lm"] = {h: hier_lm(hvd, *lm, h) for h in ("two_level", "tree")}
    return out


def hier_lm(hvd, lm_sd, sizes, tokens, hierarchy: str) -> tuple:
    """The TransformerLM of ``sizes`` from ``lm_sd`` (convert.py's
    weights) through ``DistributedTrainStep(shard_optimizer_states=True,
    hierarchy=...)`` with AdamW(3e-4, weight decay 1e-4), 3 steps on the
    global batch ``tokens``; (losses, parameters)."""
    import torch

    from horovod_tpu_torch.models import transformer as TT

    model = TT.TransformerLM(TT.TransformerConfig(
        dtype=torch.float32, attention_impl="flash", **sizes))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in lm_sd.items()})
    step = hvd.DistributedTrainStep(
        lambda m, b: TT.lm_loss(m, b),
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4),
        shard_optimizer_states=True, hierarchy=hierarchy)
    model, opt = step.init(model)
    batch = step.shard_batch(torch.from_numpy(tokens).long())
    losses = []
    for _ in range(3):
        model, opt, loss = step(model, opt, batch)
        losses.append(float(loss))
    return losses, {k: v.numpy().copy() for k, v in
                    model.state_dict().items()}


def run_hier_ckpt(hvd, directory: str, save: bool) -> dict:
    """The sharded MLP of :func:`_ckpt_mlp` on the world's own layout.
    ``save``: 2 steps, every rank saves its shard at the block it owns
    (plan ``dp=<world>``) and rank 0 the parameters, then a third step;
    then fresh wrappers restore at this world, under ``"auto"`` and
    ``"flat"``.  Else a fresh wrapper restores under ``"auto"``.  Each
    restore reports its shard state, the parameters after the third step,
    the mode and the block it owns."""
    import torch

    from horovod_tpu_torch.checkpoint import Checkpointer

    torch.set_num_threads(1)
    world = hvd.size()
    ckpt = Checkpointer(os.path.join(directory, "hier"), async_save=False)
    out = {}
    if save:
        step, model, opt, batch = _ckpt_mlp(hvd)
        for _ in range(2):
            model, opt, _ = step(model, opt, batch)
        ckpt.save_sharded(2, opt.sharded_state_dict(), opt.shard_index,
                          world, plan=f"dp={world}")
        ckpt.save(2, {"model": model.state_dict()})
        out["saved"] = _np_tree(opt.sharded_state_dict())
        out["index"] = opt.shard_index
        model, opt, _ = step(model, opt, batch)
        out["params3"] = _params_np(model)
        hvd.barrier()
    for how in ("auto", "flat") if save else ("auto",):
        step, model, opt, batch = _ckpt_mlp(hvd, hierarchy=how)
        opt.load_sharded_state_dict(ckpt.restore_sharded(
            opt.sharded_state_template(), opt.shard_index, world,
            plan=f"dp={world}"))
        model.load_state_dict(ckpt.restore()["model"])
        restored = _np_tree(opt.sharded_state_dict())
        model, opt, _ = step(model, opt, batch)
        out[how] = {"restored": restored, "params": _params_np(model),
                    "mode": step.exchange_hierarchy,
                    "index": opt.shard_index}
    return out


def hier_small_lm(hvd) -> dict:
    """The fp32 TransformerLM of :data:`ADASUM_LM` (seed 0) trained
    ``ADASUM_LM_STEPS`` steps through ``DistributedTrainStep(
    shard_optimizer_states=True, hierarchy="two_level")`` with
    ``Compression.int8``, error feedback and ``reduction="adasum"`` on 8
    sequences of :func:`adasum_lm_tokens`; losses and state dict as
    numpy."""
    import torch

    from horovod_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        lm_loss,
    )

    cfg = TransformerConfig(dtype=torch.float32, attention_impl="flash",
                            **ADASUM_LM)
    model = TransformerLM(cfg, generator=torch.Generator().manual_seed(0))
    model.to(hvd.device())
    step = hvd.DistributedTrainStep(
        lambda m, b: lm_loss(m, b),
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4),
        compression=hvd.Compression.int8, shard_optimizer_states=True,
        hierarchy="two_level", error_feedback=True, reduction="adasum")
    model, opt = step.init(model)
    batch = step.shard_batch(adasum_lm_tokens(8))
    losses = [float(step(model, opt, batch)[2])
              for _ in range(ADASUM_LM_STEPS)]
    return {"losses": losses, "mode": step.exchange_hierarchy,
            "params": {k: v.cpu().numpy().copy()
                       for k, v in model.state_dict().items()}}


def _full_lm_run(hvd, hierarchy: str, steps: int = 5) -> dict:
    """chip_smoke's 870.9M TransformerLM (seed 0, bf16 compute, flash)
    through ``DistributedOptimizer(AdamW(3e-4, weight_decay=1e-4),
    gradient_predivide_factor=2.0, shard_optimizer_states=True,
    hierarchy=...)`` and DistributedTrainStep, ``steps`` steps on a global
    batch of 6 sequences a rank: losses, each step's seconds, peak memory,
    this rank's AdamW state bytes, the padded buffer's values, and whether
    every parameter equals rank 0's."""
    import torch

    from chip_smoke import FULL, SEED, full_config
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.ops import collectives as C

    dev = hvd.device()
    cfg = full_config(torch, "flash")
    model = TransformerLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4),
        gradient_predivide_factor=2.0, shard_optimizer_states=True,
        hierarchy=hierarchy)
    step = hvd.DistributedTrainStep(lambda m, b: lm_loss(m, b), opt)
    tokens = torch.randint(0, cfg.vocab_size,
                           (FULL["batch"] * hvd.size(), FULL["seq"] + 1),
                           generator=torch.Generator().manual_seed(SEED))
    torch.cuda.reset_peak_memory_stats()
    model, opt = step.init(model)
    batch = step.shard_batch(tokens)
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, loss = step(model, opt, batch)
        losses.append(float(loss))           # synchronises
        times.append(time.perf_counter() - t0)
    with torch.no_grad():
        same = all(bool(torch.equal(p, C.broadcast(p, 0)))
                   for p in model.parameters())
    out = {"losses": losses, "times": times, "mode": step.exchange_hierarchy,
           "peak": torch.cuda.max_memory_allocated(), "same": same,
           "state_bytes": state_bytes(opt.sharded_state.inner),
           "padded": sum(g.padded for g in opt.spec.groups),
           "index": opt.shard_index}
    del model, opt, step, batch
    torch.cuda.empty_cache()
    return out


def run_hier_nccl(hvd, full: bool = False) -> dict:
    """On a world laid out as nodes (cards over NCCL, or its gloo twin):
    the two-level round trip of :func:`hier_leaves`' fp32 leaves and of a
    bf16 one against the flat exchange, the small LM of
    :func:`hier_small_lm`, and with ``full`` the 870.9M LM two_level and
    flat (:func:`_full_lm_run`)."""
    import torch

    from horovod_tpu_torch.ops import collectives as C

    torch.set_num_threads(1)   # or the ranks oversubscribe the cores
    world, rank, dev = hvd.size(), hvd.rank(), hvd.device()
    inp = hier_leaves(world)
    xs = [torch.from_numpy(np.ascontiguousarray(inp[k][rank])).to(dev)
          for k in "abc"]
    xs.append(xs[1].to(torch.bfloat16))
    levels = C.layout_levels()
    shards, spec = C.tree_reducescatter(xs, levels)
    host = lambda ts: [t.float().cpu().numpy() for t in ts]  # noqa: E731
    out = {"index": C.tree_shard_index(levels),
           "tree": host(C.tree_allgather(shards, spec, levels)),
           "tree_shards": {k: v.float().cpu().numpy()
                           for k, v in shards.items()}}
    shards, spec = C.grouped_reducescatter(xs)
    out["flat"] = host(C.grouped_allgather(shards, spec))
    out["lm"] = hier_small_lm(hvd)
    if full:
        out["full"] = {h: _full_lm_run(hvd, h) for h in ("two_level", "flat")}
    return out


def launched_main(argv) -> int:
    """``python tests/torch_port_workers.py FN OUT_DIR STEPS [DEVICE]``:
    one rank of a world that the launcher started, on ``DEVICE`` (default
    ``cpu``; ``cuda`` takes ``cuda:<local_rank>``).  ``fail_fast``: rank 0
    writes its pid to ``OUT_DIR/rank.0.pid`` and enters ``hvd.init()``,
    where it waits for rank 1, which exits 3 a second after the pid
    appears.  Else ``FN(hvd, STEPS)``, its result pickled to
    ``OUT_DIR/rank.N.pkl``."""
    import pickle

    fn_name, out_dir, steps = argv[0], argv[1], int(argv[2])
    device = argv[3] if len(argv) > 3 else "cpu"
    pid_file = os.path.join(out_dir, "rank.0.pid")
    if fn_name == "fail_fast" and os.environ["HOROVOD_RANK"] == "1":
        deadline = time.monotonic() + 60
        while not os.path.exists(pid_file) and time.monotonic() < deadline:
            time.sleep(0.1)
        time.sleep(1.0)
        return 3
    import horovod_tpu_torch as hvd

    if fn_name == "fail_fast":
        with open(pid_file, "w") as f:
            f.write(str(os.getpid()))
    hvd.init(device=device)
    try:
        out = globals()[fn_name](hvd, steps)
        print(f"rank {hvd.rank()} of {hvd.size()} done", flush=True)
        import torch.distributed as dist

        dist.barrier(group=hvd._state.global_state().host_group)
        with open(os.path.join(out_dir, f"rank.{hvd.rank()}.pkl"),
                  "wb") as f:
            pickle.dump(out, f)
    finally:
        hvd.shutdown()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(launched_main(sys.argv[1:]))


# ---------------------------------------------------------------------------
# tp and fsdp in the step's plan (tests/test_torch_model_parallel.py)
# ---------------------------------------------------------------------------

#: the 2-layer LM of the model-parallel tests (d 128, 4 heads)
MP_LM = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=128,
             d_ff=256, max_seq_len=16)
MP_LR = 1e-3
MP_STEPS = 3


def mp_tokens() -> np.ndarray:
    """The global batch of the LM cases: 8 rows of 17 tokens."""
    return np.random.RandomState(11).randint(0, 64, (8, 17)).astype(np.int64)


def mp_mlp_batch() -> dict:
    """``tests/test_plan.py``'s TpMlp batch: x and y of (16, 32)."""
    rng = np.random.RandomState(0)
    return {"x": rng.randn(16, 32).astype(np.float32),
            "y": rng.randn(16, 32).astype(np.float32)}


def fsdp_setup() -> tuple:
    """``tests/test_plan.py``'s FSDP set-up: w1 (64, 256), w2 (256, 8) and
    a batch of 32 rows."""
    rng = np.random.RandomState(0)
    w = {"w1": (rng.randn(64, 256) * 0.05).astype(np.float32),
         "w2": (rng.randn(256, 8) * 0.05).astype(np.float32)}
    batch = {"x": rng.randn(32, 64).astype(np.float32),
             "y": rng.randn(32, 8).astype(np.float32)}
    return w, batch


def tp_mlp(group=None):
    """``tests/test_plan.py``'s TpMlp: ColumnParallelDense(64), gelu,
    RowParallelDense(32), both with a bias."""
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.parallel.tensor_parallel import (
        ColumnParallelDense,
        RowParallelDense,
    )

    class TpMlp(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.col = ColumnParallelDense(32, 64, group)
            self.row = RowParallelDense(64, 32, group)

        def forward(self, x):
            return self.row(F.gelu(self.col(x), approximate="tanh"))

    return TpMlp()


def tp_mlp_state(flax_params: dict) -> dict:
    """The flax TpMlp's parameters as :func:`tp_mlp`'s full state_dict."""
    import torch

    col, row = flax_params["ColumnParallelDense_0"], \
        flax_params["RowParallelDense_0"]
    return {"col.weight": torch.from_numpy(col["kernel"].T.copy()),
            "col.bias": torch.from_numpy(col["bias"].copy()),
            "row.weight": torch.from_numpy(row["kernel"].T.copy()),
            "row.bias": torch.from_numpy(row["bias"].copy())}


def _fsdp_mlp():
    import torch

    class Mlp(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w1 = torch.nn.Parameter(torch.zeros(64, 256))
            self.w2 = torch.nn.Parameter(torch.zeros(256, 8))

        def forward(self, x):
            return torch.relu(x @ self.w1) @ self.w2

    return Mlp()


def _np_state(model) -> dict:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def _mp_train(hvd, model, loss_fn, batch, plan, opt_fn, mesh=None,
              **kw) -> dict:
    """MP_STEPS steps of DistributedTrainStep under ``plan``: the losses,
    this rank's parameters (its shards), the optimizer state's shapes, the
    step's mode and the resident bytes."""
    from horovod_tpu_torch.parallel.fsdp import resident_bytes

    step = hvd.DistributedTrainStep(loss_fn, opt_fn(model.parameters()),
                                    plan=plan, mesh=mesh, **kw)
    model, opt = step.init(model)
    b = step.shard_batch(batch)
    losses = []
    for _ in range(MP_STEPS):
        model, opt, loss = step(model, opt, b)
        losses.append(float(loss))
    inner = getattr(opt, "optimizer", opt)
    state_shapes = {name: tuple(inner.state[p]["exp_avg"].shape)
                    for name, p in model.named_parameters()
                    if p in inner.state}
    return dict(losses=losses, params=_np_state(model), mode=step.mode,
                state_shapes=state_shapes, resident=resident_bytes(model),
                tp_index=step.mesh.index("tp"),
                fsdp_index=step.mesh.index("fsdp"),
                dims=None if step.fsdp_placement is None
                else dict(step.fsdp_placement.dims)), step, model


def _adamw(params):
    import torch

    return torch.optim.AdamW(params, lr=MP_LR, weight_decay=1e-4)


def _mp_lm(hvd, lm_sd, plan, tp_group_from_mesh: bool = False):
    """The LM under ``plan`` from the flax weights ``lm_sd`` (a full
    state_dict): built at full width for the step to shard, or with
    ``tp_group_from_mesh`` from ``plan.build_mesh()`` with this rank's
    converted shard.  Returns _mp_train's record plus the logits of the
    whole batch after training."""
    import torch

    from horovod_tpu_torch.models import transformer as TT
    from horovod_tpu_torch.models.convert import tp_shard
    from horovod_tpu_torch.parallel.plan import ShardingPlan

    cfg = TT.TransformerConfig(dtype=torch.float32, attention_impl="flash",
                               **MP_LM)
    mesh = None
    if tp_group_from_mesh:
        mesh = ShardingPlan.from_string(plan).resolve(hvd.size()).build_mesh()
        tp, idx = mesh.shape["tp"], mesh.index("tp")
        model = TT.TransformerLM(cfg, tp_group=mesh.group("tp"))
        model.load_state_dict({k: tp_shard(k, v, tp, idx)
                               for k, v in lm_sd.items()})
    else:
        model = TT.TransformerLM(cfg)
        model.load_state_dict(lm_sd)
    tok = mp_tokens()
    rec, step, model = _mp_train(hvd, model, lambda m, b: TT.lm_loss(m, b),
                                 tok, plan, _adamw, mesh=mesh)
    with torch.no_grad():
        rec["logits"] = model(torch.from_numpy(tok[:, :-1])).numpy()
    if step.fsdp_placement is not None:
        from horovod_tpu_torch.parallel.fsdp import gather_params

        rec["full"] = {k: v.numpy() for k, v in gather_params(model).items()}
    return rec


def _mp_fsdp_mlp(hvd, w, batch, plan, **kw):
    import torch

    model = _fsdp_mlp()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})

    def loss_fn(m, b):
        return torch.mean((m(b["x"]) - b["y"]) ** 2)

    rec, step, model = _mp_train(
        hvd, model, loss_fn, batch, plan,
        lambda p: torch.optim.Adam(p, lr=1e-2), **kw)
    if step.fsdp_placement is not None:
        from horovod_tpu_torch.parallel.fsdp import gather_params

        rec["full"] = {k: v.numpy() for k, v in gather_params(model).items()}
    return rec


def _mp_moe(hvd, plan):
    """The MoE LM of MOE_LM, seeded weights, under ``plan`` (the model's
    ep group from the plan's mesh), placed leaves from one element up."""
    import torch

    from horovod_tpu_torch.models.moe import MoEConfig, MoETransformerLM
    from horovod_tpu_torch.parallel.plan import ShardingPlan

    mesh = ShardingPlan.from_string(plan).resolve(hvd.size()).build_mesh()
    cfg = MoEConfig(dtype=torch.float32, attention_impl="dense",
                    fused_dispatch="off", **MOE_LM)
    model = MoETransformerLM(cfg, generator=torch.Generator().manual_seed(0),
                             ep_group=mesh.group("ep"))
    kw = {"fsdp_min_weight_size": 1} if mesh.shape["fsdp"] > 1 else {}
    rec, step, model = _mp_train(hvd, model, moe_lm_loss, moe_tokens(), plan,
                                 _adamw, mesh=mesh, **kw)
    if step.fsdp_placement is not None:
        from horovod_tpu_torch.parallel.fsdp import gather_params

        rec["full"] = {k: v.numpy() for k, v in gather_params(model).items()}
    return rec


def _caught_step(hvd, fn) -> str:
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return str(e)
    return ""


#: the refusals held word for word against the JAX step: (name, plan,
#: keyword arguments); ``op``/``compression`` by name
MP_REFUSALS = [
    ("tp_under_shard_map", "dp=2,tp=2", dict(mode="shard_map")),
    ("ep_sharded_states", "dp=2,ep=2", dict(shard_optimizer_states=True)),
    ("sharded_states_under_pjit", "dp=4",
     dict(mode="pjit", shard_optimizer_states=True)),
    ("data_axes_conflict", "dp=2,fsdp=2", dict(data_axes=("dp",))),
    ("fsdp_axis_under_shard_map", "dp=2,fsdp=2",
     dict(mode="shard_map", fsdp_axis="fsdp")),
    ("fsdp_axis_unknown", "dp=4", dict(fsdp_axis="zz")),
    ("fsdp_min_without_axis", "dp=4", dict(fsdp_min_weight_size=1)),
    ("sum_under_pjit", "dp=4", dict(mode="pjit", op="Sum")),
    ("compression_under_pjit", "dp=4", dict(mode="pjit",
                                            compression="fp16")),
    ("op_none_under_pjit", "dp=4", dict(mode="pjit", op=None)),
    ("sparse_under_pjit", "dp=4", dict(mode="pjit",
                                       sparse_params={"w": 4})),
    ("unknown_mode", "dp=4", dict(mode="gspmd")),
    ("pipeline", "dp=2,pp=2", {}),
]


def mp_refusal_kwargs(hvd, kw: dict) -> dict:
    """A refusal case's keyword arguments with ``op`` and ``compression``
    named resolved against ``hvd`` (either package)."""
    kw = dict(kw)
    if "op" in kw and kw["op"] is not None:
        kw["op"] = getattr(hvd, kw["op"])
    if "compression" in kw:
        kw["compression"] = getattr(hvd.Compression, kw["compression"])
    return kw


def _mp_errors(hvd) -> dict:
    import torch

    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh

    out = {}
    for name, plan, kw in MP_REFUSALS:
        kw = mp_refusal_kwargs(hvd, kw)
        out[name] = _caught_step(hvd, lambda: hvd.DistributedTrainStep(
            lambda m, b: None, torch.optim.SGD(
                [torch.zeros(2, requires_grad=True)], lr=0.1),
            plan=plan, **kw))
    other = make_parallel_mesh(tp=4)
    out["mesh_mismatch"] = _caught_step(hvd, lambda: hvd.DistributedTrainStep(
        lambda m, b: None, torch.optim.SGD(
            [torch.zeros(2, requires_grad=True)], lr=0.1),
        plan="dp=2,tp=2", mesh=other))
    # a model sharded over another extent than the plan's, and a plan's
    # tp with no tensor-parallel module
    step = hvd.DistributedTrainStep(
        lambda m, b: None, torch.optim.SGD(
            [torch.zeros(2, requires_grad=True)], lr=0.1), plan="tp=4")
    out["tp_extent"] = _caught_step(
        hvd, lambda: step.init(tp_mlp(make_parallel_mesh(tp=2).group("tp"))))
    lin = torch.nn.Linear(4, 4)
    step = hvd.DistributedTrainStep(
        lambda m, b: None, torch.optim.SGD(lin.parameters(), lr=0.1),
        plan="tp=4")
    out["tp_no_modules"] = _caught_step(hvd, lambda: step.init(lin))
    return out


def _mp_checkpoint(hvd, directory: str) -> dict:
    """The checkpoint guard: a tp-sharded and an fsdp-placed model's
    state_dict refused by save and restore_and_broadcast on every rank; a
    replicated one saved."""
    import torch

    from horovod_tpu_torch.checkpoint import Checkpointer
    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh

    ckpt = Checkpointer(directory, async_save=False)
    out = {}
    tp_model = tp_mlp(make_parallel_mesh(dp=2, tp=2).group("tp"))
    out["tp_save"] = _caught_step(
        hvd, lambda: ckpt.save(1, {"model": tp_model.state_dict()}))
    out["tp_restore"] = _caught_step(
        hvd, lambda: ckpt.restore_and_broadcast(
            {"model": tp_model.state_dict()}))
    w, _ = fsdp_setup()
    model = _fsdp_mlp()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
    step = hvd.DistributedTrainStep(
        lambda m, b: None, torch.optim.SGD(model.parameters(), lr=0.1),
        plan="fsdp=4", fsdp_min_weight_size=1)
    model, _ = step.init(model)
    out["fsdp_save"] = _caught_step(
        hvd, lambda: ckpt.save(2, {"model": model.state_dict()}))
    # the optimizer state alone: AdamW's moments of a tp and an fsdp shard
    tp_opt = torch.optim.AdamW(tp_model.parameters(), lr=1e-3)
    tp_model(torch.from_numpy(mp_mlp_batch()["x"])).sum().backward()
    tp_opt.step()
    out["tp_opt_save"] = _caught_step(
        hvd, lambda: ckpt.save(4, {"opt": tp_opt.state_dict()}))
    out["tp_opt_restore"] = _caught_step(
        hvd, lambda: ckpt.restore_and_broadcast(
            {"opt": tp_opt.state_dict()}))
    model = _fsdp_mlp()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
    step = hvd.DistributedTrainStep(
        lambda m, b: torch.mean((m(b["x"]) - b["y"]) ** 2),
        torch.optim.AdamW(model.parameters(), lr=1e-3), plan="fsdp=4",
        fsdp_min_weight_size=1)
    model, opt = step.init(model)
    model, opt, _ = step(model, opt, step.shard_batch(fsdp_setup()[1]))
    out["fsdp_opt_save"] = _caught_step(
        hvd, lambda: ckpt.save(5, {"opt": opt.state_dict()}))
    out.update(_mp_loaded_state(hvd, ckpt, tp_opt))
    out["written"] = sorted(os.listdir(directory)) if os.path.isdir(
        directory) else []
    torch.distributed.barrier()        # every rank listed before step 3
    repl = tp_mlp()
    out["replicated_save"] = ckpt.save(3, {"model": repl.state_dict()})
    return out


def _mp_loaded_state(hvd, ckpt, tp_opt) -> dict:
    """An AdamW over a tp = 2 and an fsdp = 2 shard that loads a saved
    state (a copy, as ``torch.load`` gives) and saves before any step:
    the loaded moments are that rank's shard, refused as a step's are."""
    import copy

    import torch

    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh

    out = {}
    saved = copy.deepcopy(tp_opt.state_dict())
    tp_model = tp_mlp(make_parallel_mesh(dp=2, tp=2).group("tp"))
    loaded = torch.optim.AdamW(tp_model.parameters(), lr=1e-3)
    loaded.load_state_dict(saved)
    out["tp_loaded_save"] = _caught_step(
        hvd, lambda: ckpt.save(6, {"opt": loaded.state_dict()}))
    w, batch = fsdp_setup()

    def fsdp_step():
        model = _fsdp_mlp()
        model.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
        step = hvd.DistributedTrainStep(
            lambda m, b: torch.mean((m(b["x"]) - b["y"]) ** 2),
            torch.optim.AdamW(model.parameters(), lr=1e-3),
            plan="dp=2,fsdp=2", fsdp_min_weight_size=1)
        return step, *step.init(model)

    step, model, opt = fsdp_step()
    step(model, opt, step.shard_batch(batch))
    saved = copy.deepcopy(opt.state_dict())
    _, _, opt = fsdp_step()
    opt.load_state_dict(saved)
    out["fsdp_loaded_save"] = _caught_step(
        hvd, lambda: ckpt.save(7, {"opt": opt.state_dict()}))
    return out


def mp_axis_grads(rank: int) -> np.ndarray:
    """Rank ``rank``'s gradient in the exchange-scope case."""
    return np.random.RandomState(40 + rank).randn(6).astype(np.float32)


def _mp_axis(hvd) -> dict:
    """DistributedOptimizer(axis=...) over the dp group of a ``dp=2,tp=2``
    mesh and over ALONE, on the hook path and at synchronize(), with a
    predivide factor; the forms that take the world only, refused; a step
    given an optimizer of another scope, refused."""
    import torch

    from horovod_tpu_torch.ops.collectives import ALONE
    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh

    mesh = make_parallel_mesh(dp=2, tp=2)
    out = {}
    for name, axis, kw in (("dp", mesh.scope("dp"), {}),
                           ("dp_predivide", mesh.scope("dp"),
                            {"gradient_predivide_factor": 2.0}),
                           ("alone", ALONE, {})):
        for path in ("hook", "synchronize"):
            p = torch.nn.Parameter(torch.zeros(6))
            opt = hvd.DistributedOptimizer(torch.optim.SGD([p], lr=1.0),
                                           axis=axis, **kw)
            g = torch.from_numpy(mp_axis_grads(hvd.rank()))
            if path == "hook":
                (p * g).sum().backward()
            else:
                p.grad = g.clone()
            opt.synchronize()
            out[(name, path)] = (p.grad.numpy().copy(),
                                 [src for _, src in opt.launches])
    p = [torch.nn.Parameter(torch.zeros(2))]
    refusals = {}
    for name, kw in (("sharded", dict(shard_optimizer_states=True)),
                     ("adasum", dict(op=hvd.Adasum)),
                     ("int8", dict(compression=hvd.Compression.int8)),
                     ("sparse", dict(sparse_params={"w": 2},
                                     named_parameters=[("w", p[0])]))):
        refusals[name] = _caught_step(hvd, lambda: hvd.DistributedOptimizer(
            torch.optim.SGD(p, lr=0.1), axis=mesh.scope("dp"), **kw))
    refusals["step_scope"] = _caught_step(hvd, lambda: hvd.DistributedTrainStep(
        lambda m, b: None, hvd.DistributedOptimizer(torch.optim.SGD(
            p, lr=0.1)), plan="dp=2,tp=2", mesh=mesh))
    step = hvd.DistributedTrainStep(
        lambda m, b: None, hvd.DistributedOptimizer(
            torch.optim.SGD(p, lr=0.1), axis=mesh.scope("dp")),
        plan="dp=2,tp=2", mesh=mesh)
    out["scope_accepted"] = step.exchange_scope is mesh.scope("dp")
    out["refusals"] = refusals
    out["dp_ranks"] = sorted(
        torch.distributed.get_process_group_ranks(mesh.group("dp")))
    return out


def _mp_seeded_tp(mesh) -> dict:
    """The LM of MP_LM and the ViT of VIT_CPU drawn from seed 0 with the
    tp group of ``mesh``, against the shards of the same models drawn at
    full width: per model, the names whose shard differs (by tp_shard) and
    the number of parameters compared."""
    import torch

    from horovod_tpu_torch.models import transformer as TT
    from horovod_tpu_torch.models.convert import tp_shard
    from horovod_tpu_torch.models.vit import ViTConfig, VisionTransformer

    tp, idx = mesh.shape["tp"], mesh.index("tp")
    out = {}
    for name, build in (
            ("lm", lambda **kw: TT.TransformerLM(
                TT.TransformerConfig(dtype=torch.float32, **MP_LM), **kw)),
            ("vit", lambda **kw: VisionTransformer(
                ViTConfig(dtype=torch.float32, **VIT_CPU), **kw))):
        full = build(generator=torch.Generator().manual_seed(0)).state_dict()
        shard = build(generator=torch.Generator().manual_seed(0),
                      tp_group=mesh.group("tp")).state_dict()
        out[name] = ([k for k, v in shard.items()
                      if not torch.equal(v, tp_shard(k, full[k], tp, idx))],
                     len(shard))
    return out


def _mp_tp_buckets(hvd) -> dict:
    """One step of plan ``dp=2,tp=2`` over the LM of MP_LM at full width
    (the step cuts it in init) at a 128 KiB fusion threshold: the buckets
    the step's exchange launched, and plan_buckets' counts over the
    shards' bytes and over the full parameters' bytes."""
    import torch

    from horovod_tpu_torch.models import transformer as TT
    from horovod_tpu_torch.ops.bucketing import plan_buckets
    from horovod_tpu_torch.runtime import state

    cfg = state.global_state().config
    threshold, cfg.fusion_threshold_bytes = cfg.fusion_threshold_bytes, \
        128 * 1024
    try:
        model = TT.TransformerLM(TT.TransformerConfig(
            dtype=torch.float32, **MP_LM),
            generator=torch.Generator().manual_seed(0))
        full = [p.numel() * 4 for p in model.parameters()]
        step = hvd.DistributedTrainStep(
            lambda m, b: TT.lm_loss(m, b),
            torch.optim.AdamW(model.parameters(), lr=MP_LR), plan="dp=2,tp=2")
        model, opt = step.init(model)
        step(model, opt, step.shard_batch(mp_tokens()))
        shards = [p.numel() * 4 for p in model.parameters()]
        return dict(launched=len(opt.launches),
                    shards=len(plan_buckets(shards, 128 * 1024)),
                    full=len(plan_buckets(full, 128 * 1024)))
    finally:
        cfg.fusion_threshold_bytes = threshold


def run_model_parallel(hvd, tp_mlp_params, lm_sd, directory: str) -> dict:
    """On a gloo world of 4 (or 2: ``tp=2`` only): tp, fsdp and their mixes
    through DistributedTrainStep, against the replicated plans; models
    drawn from a seed over a tp group; the refusals and the checkpoint
    guard (world 4)."""
    import torch

    from horovod_tpu_torch.parallel.plan import ShardingPlan

    torch.set_num_threads(1)
    world = hvd.size()
    out = {}
    out["seeded_tp"] = _mp_seeded_tp(ShardingPlan.from_string(
        "dp=2,tp=2" if world == 4 else "tp=2").resolve(world).build_mesh())
    mlp_b = mp_mlp_batch()
    full = tp_mlp_state(tp_mlp_params)
    tp_plans = ["dp=2,tp=2"] if world == 4 else ["tp=2"]
    for plan in tp_plans:
        model = tp_mlp()
        model.load_state_dict(full)

        def mse(m, b):
            return torch.mean((m(b["x"]) - b["y"]) ** 2)

        rec, _, model = _mp_train(hvd, model, mse, mlp_b, plan, _adamw)
        with torch.no_grad():
            rec["logits"] = model(torch.from_numpy(mlp_b["x"])).numpy()
        out[("tp_mlp", plan)] = rec
        out[("lm", plan)] = _mp_lm(hvd, lm_sd, plan,
                                   tp_group_from_mesh=world == 4)
    if world == 2:
        return out
    w, batch = fsdp_setup()
    for plan in ("dp=2,fsdp=2", "fsdp=4"):
        out[("fsdp_mlp", plan)] = _mp_fsdp_mlp(hvd, w, batch, plan,
                                               fsdp_min_weight_size=1)
    out[("fsdp_mlp", "dp=4")] = _mp_fsdp_mlp(hvd, w, batch, "dp=4")
    out[("fsdp_mlp_default_min", "fsdp=4")] = _mp_fsdp_mlp(hvd, w, batch,
                                                           "fsdp=4")
    for plan in ("dp=4", "fsdp=2,tp=2"):
        out[("lm", plan)] = _mp_lm(hvd, lm_sd, plan)
    for plan in ("dp=2,ep=2", "fsdp=2,ep=2"):
        out[("moe", plan)] = _mp_moe(hvd, plan)
    out["errors"] = _mp_errors(hvd)
    out["tp_buckets"] = _mp_tp_buckets(hvd)
    out["checkpoint"] = _mp_checkpoint(hvd, directory)
    out["axis"] = _mp_axis(hvd)
    return out


# ---------------------------------------------------------------------------
# the ViT (tests/test_torch_vit.py)
# ---------------------------------------------------------------------------

#: bench.py's CPU ViT: 32 px, patch 16, 2 layers, d 128, 4 heads
VIT_CPU = dict(image_size=32, patch_size=16, num_layers=2, num_heads=4,
               d_model=128, d_ff=512)
VIT_LR = 3e-4


def vit_batch(n: int = 4) -> dict:
    """``n`` NHWC fp32 images of VIT_CPU's size and int64 labels of 1000
    classes."""
    rng = np.random.RandomState(5)
    return {"x": rng.rand(n, 32, 32, 3).astype(np.float32),
            "y": rng.randint(0, 1000, (n,)).astype(np.int64)}


def vit_step(hvd, sd, plan=None, impl="dense", steps: int = 1) -> dict:
    """``steps`` AdamW(3e-4, weight_decay=1e-4) steps of the fp32 ViT of
    VIT_CPU from the state_dict ``sd`` through DistributedTrainStep under
    ``plan``: losses, this rank's parameters, its tp index, and the logits
    of the whole batch before and after."""
    import torch

    from horovod_tpu_torch.models.vit import ViTConfig, VisionTransformer, \
        vit_loss

    cfg = ViTConfig(dtype=torch.float32, attention_impl=impl, **VIT_CPU)
    model = VisionTransformer(cfg)
    model.load_state_dict(sd)
    batch = vit_batch()
    x = torch.from_numpy(batch["x"])
    with torch.no_grad():
        before = model(x).numpy()
    step = hvd.DistributedTrainStep(
        vit_loss, torch.optim.AdamW(model.parameters(), lr=VIT_LR,
                                    weight_decay=1e-4), plan=plan)
    model, opt = step.init(model)
    b = step.shard_batch(batch)
    losses = []
    for _ in range(steps):
        model, opt, loss = step(model, opt, b)
        losses.append(float(loss))
    with torch.no_grad():
        after = model(x).numpy()
    return dict(losses=losses, params=_np_state(model), before=before,
                after=after, mode=step.mode,
                tp_index=step.mesh.index("tp") if step.mesh else 0)


def run_vit(hvd, sd) -> dict:
    """On a gloo world of 2: the ViT one step under ``dp=2`` and ``tp=2``."""
    import torch

    torch.set_num_threads(1)
    return {plan: vit_step(hvd, sd, plan) for plan in ("dp=2", "tp=2")}


#: the plans of the four-card model-parallel test, the replicated one first
MP_NCCL_PLANS = ("dp=4", "tp=4", "dp=2,tp=2", "fsdp=4", "fsdp=2,tp=2")
#: the plans whose model is drawn with the plan's tp group (the others at
#: full width, for the step to shard)
MP_NCCL_SEEDED = ("dp=2,tp=2", "fsdp=2,tp=2")


def run_mp_nccl(hvd, small: bool = False, steps: int = 3) -> dict:
    """chip_smoke's 870.9M TransformerLM (seed 0, bf16 compute on a card,
    flash) under each of MP_NCCL_PLANS through DistributedTrainStep with
    AdamW(3e-4, weight_decay=1e-4), which the step wraps, ``steps`` steps
    on one global batch of 6 sequences a rank of a world of 4: losses,
    step seconds, peak memory, this rank's resident parameter and AdamW
    state bytes, and the bytes of the leaves the plan leaves whole.  Under
    MP_NCCL_SEEDED's plans the model is drawn from the seed with the tp
    group of the step's mesh, and ``seeded`` says whether it is, leaf for
    leaf, tp_shard of the model drawn at full width.  ``small`` runs a
    2-layer d 128 model on sequences of 16 (the gloo rehearsal)."""
    import torch

    from chip_smoke import FULL, SEED, full_config
    from horovod_tpu_torch.models.convert import tp_shard
    from horovod_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        lm_loss,
    )
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.parallel.fsdp import resident_bytes
    from horovod_tpu_torch.parallel.plan import ShardingPlan

    torch.set_num_threads(1)
    dev = hvd.device()
    if small:
        cfg = TransformerConfig(dtype=torch.float32, attention_impl="flash",
                                **MP_LM)
        seq, rows = 16, 2
    else:
        cfg = full_config(torch, "flash")
        seq, rows = FULL["seq"], FULL["batch"]
    tokens = torch.randint(0, cfg.vocab_size, (rows * hvd.size(), seq + 1),
                           generator=torch.Generator().manual_seed(SEED))
    def seeded():
        return torch.Generator(device=dev).manual_seed(SEED)

    out, numel = {}, None
    for plan in MP_NCCL_PLANS:
        mesh, kw, same = None, {}, None
        if plan in MP_NCCL_SEEDED:
            mesh = ShardingPlan.from_string(plan).resolve(hvd.size()) \
                .build_mesh()
            kw = {"tp_group": mesh.group("tp")}
        model = TransformerLM(cfg, device=dev, generator=seeded(), **kw)
        if numel is None:               # dp=4's full width
            full_bytes = resident_bytes(model)
            numel = {n: p.numel() for n, p in model.named_parameters()}
        if mesh is not None:
            full = TransformerLM(cfg, device=dev,
                                 generator=seeded()).state_dict()
            tp, idx = mesh.shape["tp"], mesh.index("tp")
            same = all(torch.equal(v, tp_shard(k, full[k], tp, idx))
                       for k, v in model.state_dict().items())
            del full
        step = hvd.DistributedTrainStep(
            lambda m, b: lm_loss(m, b),
            torch.optim.AdamW(model.parameters(), lr=3e-4,
                              weight_decay=1e-4), plan=plan, mesh=mesh)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        model, opt = step.init(model)
        batch = step.shard_batch(tokens)
        losses, times = [], []
        K.reset_launch_counts()
        for _ in range(steps):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, opt, loss = step(model, opt, batch)
            losses.append(float(loss))           # synchronises
            times.append(time.perf_counter() - t0)
        launches = {k: v for k, v in K.launch_counts().items() if v}
        inner = getattr(opt, "optimizer", opt)
        extent = step.plan.tp * step.plan.fsdp
        # the leaves the plan does not cut to 1/extent, at what they hold
        whole = sum(p.numel() * p.element_size()
                    for n, p in model.named_parameters()
                    if p.numel() * extent != numel[n])
        out[plan] = dict(
            losses=losses, times=times, mode=step.mode, extent=extent,
            resident=resident_bytes(model), full=full_bytes, whole=whole,
            seeded=same, state_bytes=state_bytes(inner), launches=launches,
            peak=torch.cuda.max_memory_allocated()
            if dev.type == "cuda" else 0)
        del model, opt, step, batch, inner
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the pipeline axis (tests/test_torch_pipeline.py)
# ---------------------------------------------------------------------------

#: (num_microbatches, virtual_stages) of the JAX package's interleaved cases
PIPE_CASES = [(4, 1), (8, 1), (4, 2), (8, 2), (8, 4)]
PIPE_D = 8
PIPE_BATCH = 16
#: the narrow LM of the pipeline test: 4 blocks, d 64
PIPE_LM = dict(vocab_size=64, num_layers=4, num_heads=4, d_model=64,
               d_ff=128, max_seq_len=16)
#: (num_microbatches, virtual_stages) of the LM at pp = 2
PIPE_LM_CASES = [(4, 1), (4, 2)]


def pipe_inputs(world: int, v: int):
    """The ``v * world`` stage kernels (d, d) and the input (16, d)."""
    rng = np.random.RandomState(100 * world + v)
    ws = (rng.randn(v * world, PIPE_D, PIPE_D) / np.sqrt(PIPE_D)).astype(
        np.float32)
    return ws, rng.randn(PIPE_BATCH, PIPE_D).astype(np.float32)


def pipe_error_cases(world: int) -> list:
    """(name, batch rows, num_microbatches, virtual_stages) the schedules
    refuse at a pp group of ``world``."""
    return [("m_not_multiple_of_s", 12, 3 * world // 2, 2),
            ("batch", 10, 4, 2), ("gpipe_batch", 10, 4, 1),
            ("virtual_stages", 12, world, 0)]


def pipe_lm_tokens() -> np.ndarray:
    return np.random.RandomState(12).randint(0, 64, (4, 17)).astype(np.int64)


def _pipe_case(group, world: int, rank: int, m: int, v: int,
               schedule: str) -> dict:
    """One schedule over tanh(h @ w) stages: the fanned-out output, this
    rank's chunk gradients and its input gradient of sum(y**2), the loss
    averaged over the group as JAX's pmean over pp."""
    import torch

    from horovod_tpu_torch.parallel import pipeline as P

    ws, x = pipe_inputs(world, v)
    mine = torch.tensor(np.stack([ws[j * world + rank] for j in range(v)]),
                        requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)

    def stage(w, h):
        return torch.tanh(h @ w)

    if schedule == "gpipe":
        y = P.gpipe(stage, mine[0], xt, m, group=group)
    else:
        y = P.interleaved_1f1b(stage, mine, xt, m, v, group=group)
    (y.pow(2).sum() / world).backward()
    return {"y": y.detach().numpy(), "g": mine.grad.numpy(),
            "gx": None if xt.grad is None else xt.grad.numpy()}


def _pipe_lm(hvd, group, lm_sd: dict, m: int, v: int) -> dict:
    """The narrow LM with its blocks through the pipeline: the loss, and
    the gradients of this rank's blocks and of the parameters outside the
    pipe (summed over the group)."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.models.stages import (
        lm_chunks,
        outside_parameters,
        pipeline_lm_loss,
    )
    from horovod_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )

    model = TransformerLM(TransformerConfig(dtype=torch.float32, **PIPE_LM))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in lm_sd.items()})
    chunks = lm_chunks(model, group, v)
    loss = pipeline_lm_loss(model, torch.from_numpy(pipe_lm_tokens()),
                            chunks, m, group=group)
    (loss / dist.get_world_size(group)).backward()
    for p in outside_parameters(model):
        dist.all_reduce(p.grad, group=group)
    mine = {id(p) for c in chunks for p in c.parameters()} | \
        {id(p) for p in outside_parameters(model)}
    return {"loss": float(loss),
            "grads": {n: p.grad.numpy() for n, p in model.named_parameters()
                      if id(p) in mine}}


def run_pipeline(hvd, lm_sd=None) -> dict:
    """Every pipeline case on this world's pp group (the world), the
    refusals, and, given the LM's weights, the narrow LM."""
    import torch

    from horovod_tpu_torch.parallel import pipeline as P
    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh

    torch.set_num_threads(1)
    world, rank = hvd.size(), hvd.rank()
    group = make_parallel_mesh(pp=world).group("pp")
    out = {"cases": {(m, v): _pipe_case(group, world, rank, m, v,
                                        "interleaved")
                     for m, v in PIPE_CASES},
           "gpipe": _pipe_case(group, world, rank, 8, 1, "gpipe")}
    _, x = pipe_inputs(world, 2)
    errors = {}
    for name, rows, m, v in pipe_error_cases(world):
        try:
            if v == 1:
                P.gpipe(lambda w, h: h, None, torch.from_numpy(x)[:rows], m,
                        group=group)
            else:
                P.interleaved_1f1b(lambda w, h: h, [None] * v,
                                   torch.from_numpy(x)[:rows], m, v,
                                   group=group)
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    if lm_sd is not None:
        out["lm"] = {(m, v): _pipe_lm(hvd, group, lm_sd, m, v)
                     for m, v in PIPE_LM_CASES}
    return out


def run_pp_nccl(hvd, small: bool = False, steps: int = 3) -> dict:
    """The 870.9M TransformerLM's 16 blocks at pp = the world (4 cards),
    batch 8 as 8 microbatches of one sequence: ``gpipe`` (4 blocks a
    stage) and ``interleaved_1f1b`` at v = 2 (8 chunks of 2 blocks), the
    embedding and the head outside the pipe, ``steps`` forward and
    backward passes each.  Against the same weights run sequentially on
    this card: the losses, and this rank's stage gradients and the
    (summed) gradients of the parameters outside the pipe, normwise; each
    rank's loss (from the fanned-out output), step seconds, peak memory,
    flash launches, and the compute-idle share of one profiled step (1 −
    its kernels' device time outside NCCL / its wall time) beside
    ``bubble_fraction``.  ``small`` runs an 8-block d 32 model on
    sequences of 16 (the gloo rehearsal)."""
    import torch
    import torch.distributed as dist

    from chip_smoke import FULL, SEED, full_config
    from horovod_tpu_torch.models.stages import (
        lm_chunks,
        outside_parameters,
        pipeline_lm_loss,
    )
    from horovod_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        lm_loss,
    )
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh
    from horovod_tpu_torch.parallel.pipeline import bubble_fraction

    torch.set_num_threads(1)
    dev = hvd.device()
    world = hvd.size()
    cuda = dev.type == "cuda"
    if small:
        cfg = TransformerConfig(vocab_size=64, num_layers=8, num_heads=2,
                                d_model=32, d_ff=64, max_seq_len=16,
                                dtype=torch.float32, attention_impl="dense")
        seq = 16
    else:
        cfg, seq = full_config(torch, "flash"), FULL["seq"]
    batch = m = 8
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                           generator=torch.Generator().manual_seed(SEED)
                           ).to(dev)
    model = TransformerLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    group = make_parallel_mesh(pp=world).group("pp")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # the one-rank sequential run of the same weights, on this card
    loss = lm_loss(model, tokens)
    loss.backward()
    out = {"ref_loss": float(loss.detach())}
    ref = {n: p.grad.float().clone() for n, p in model.named_parameters()}
    outside = {id(p) for p in outside_parameters(model)}

    def rel(ids):
        num = den = 0.0
        for n, p in model.named_parameters():
            if id(p) in ids:
                num += float((p.grad.float() - ref[n]).pow(2).sum())
                den += float(ref[n].pow(2).sum())
        return (num / den) ** 0.5

    for v in (1, 2):
        chunks = lm_chunks(model, group, v)
        stage = {id(p) for c in chunks for p in c.parameters()}

        def step():
            model.zero_grad(set_to_none=True)
            loss = pipeline_lm_loss(model, tokens, chunks, m, group=group)
            (loss / world).backward()
            for p in outside_parameters(model):
                dist.all_reduce(p.grad, group=group)
            return loss

        if cuda:
            torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        times = []
        for _ in range(steps):
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            loss = step()
            sync()
            times.append(time.perf_counter() - t0)
        counts = K.launch_counts()
        losses = [None] * world
        dist.all_gather_object(losses, float(loss.detach()))
        rec = dict(loss=float(loss.detach()), losses=losses, times=times,
                   stage_rel=rel(stage), outside_rel=rel(outside),
                   stage_blocks=sum(len(c) for c in chunks),
                   bubble=bubble_fraction(world, m, v),
                   launches={k: counts.get(k, 0) for k in
                             ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")},
                   peak=torch.cuda.max_memory_allocated() if cuda else 0)
        if cuda:
            from torch.profiler import ProfilerActivity, profile

            dist.barrier()
            sync()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step()
                sync()
                wall = time.perf_counter() - t0
            busy = comm = 0.0
            for e in prof.key_averages():
                us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
                if us <= 0 or "#" in e.key:
                    continue
                if "nccl" in e.key.lower():
                    comm += us / 1e6
                else:
                    busy += us / 1e6
            rec.update(wall_s=wall, compute_s=busy, nccl_s=comm,
                       compute_idle=1 - busy / wall)
        out[v] = rec
    return out


def run_torch_state_sync(hvd) -> dict:
    """``TorchState.sync()`` on a world where rank 0's MLP has taken an
    AdamW step and the others hold other weights and no optimizer state
    (a joiner's): every rank ends with rank 0's parameters, AdamW state
    and attributes, bit for bit."""
    import torch

    from horovod_tpu_torch.elastic.state import TorchState

    torch.manual_seed(hvd.rank())
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                                torch.nn.Linear(8, 2))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    if hvd.rank() == 0:
        model(torch.ones(3, 4)).sum().backward()
        opt.step()
    state = TorchState(model, opt, epoch=5 if hvd.rank() == 0 else 0)
    state.sync()
    return {"params": {k: v.numpy() for k, v in model.state_dict().items()},
            "opt": {f"{i}/{k}": v.numpy() for i, s in
                    opt.state_dict()["state"].items() for k, v in s.items()},
            "epoch": state.epoch, "commits": state._commit_count}


# ---------------------------------------------------------------------------
# the runtime tools: timeline, stall inspector, aggregation, group teardown
# ---------------------------------------------------------------------------

#: the stall inspector's warning time in ``run_tools``, and how long rank 1
#: keeps back the op that rank 0 has submitted
STALL_WARN_S, STALL_HOLD_S = 0.6, 2.0


def run_tools(hvd, directory: str, jax_traces=None) -> dict:
    """The runtime tools on a gloo world: (a) the eager ops under
    ``start_timeline`` (the file rank 0 holds after ``stop_timeline``, and
    whether the others wrote ``<file>.<rank>``); (b) the port's
    ``aggregate_after_close`` over the JAX package's per-rank trace files
    ``jax_traces`` (``[(path, wall_origin_us)]`` by rank); (c) the stall
    inspector's warnings on rank 0 while rank 1 holds back an op that rank
    0 has submitted."""
    import json

    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.utils import logging as hvd_logging
    from horovod_tpu_torch.utils import stall as stall_mod
    from horovod_tpu_torch.utils import timeline as tl_mod

    torch.set_num_threads(1)   # or the ranks oversubscribe the cores
    r, world = hvd.rank(), hvd.size()
    st = hvd._state.global_state()
    out = {}
    # the eager ops twice: through the native writer, then the Python one
    # (which records the NEGOTIATE instants' arguments), tensors named
    # apart so that the second pass negotiates anew
    for suffix in ("", ".py"):
        path = os.path.join(directory, f"eager{suffix}.json")
        if suffix:
            os.environ["HOROVOD_TIMELINE_PYTHON"] = "1"
        hvd.start_timeline(path)
        h1 = hvd.allreduce_async(torch.ones(4) * (r + 1),
                                 name=f"tl.ar_a{suffix}")
        h2 = hvd.allreduce_async(torch.ones(8) * (r + 1),
                                 name=f"tl.ar_b{suffix}")
        out["ar"] = [hvd.synchronize(h).numpy() for h in (h1, h2)]
        out["ag"] = hvd.allgather(torch.full((r + 1, 2), float(r)),
                                  name=f"tl.ag{suffix}").numpy()
        out["bc"] = hvd.broadcast(torch.full((3,), float(r)), root_rank=1,
                                  name=f"tl.bc{suffix}").numpy()
        out["a2a"] = hvd.alltoall(torch.arange(2.0 * world) + 10 * r,
                                  name=f"tl.a2a{suffix}").numpy()
        out[f"writer{suffix}"] = type(st.timeline).__name__
        hvd.stop_timeline()
        os.environ.pop("HOROVOD_TIMELINE_PYTHON", None)
        out[f"own_file{suffix}"] = os.path.exists(f"{path}.{r}") \
            if r else None
        if r == 0:
            out[f"merged{suffix}"] = tl_mod.load_trace(path)
    if jax_traces:
        p, origin = jax_traces[r]
        tl_mod.aggregate_after_close(p, origin)
        if r == 0:
            with open(p) as f:
                out["jax_merged"] = json.load(f)
    # (c) a short warning time; rank 1 submits the op STALL_HOLD_S late
    warnings = []
    real = hvd_logging.warning
    hvd_logging.warning = lambda msg, *a: warnings.append(msg % a)
    try:
        st.stall_inspector.stop()
        st.stall_inspector = stall_mod.StallInspector(
            warning_time_s=STALL_WARN_S, poll_interval_s=0.1)
        dist.barrier(group=st.host_group)
        if r == 0:
            h = hvd.allreduce_async(torch.ones(2), name="tl.stuck")
            time.sleep(STALL_HOLD_S)
        else:
            time.sleep(STALL_HOLD_S)
            h = hvd.allreduce_async(torch.ones(2), name="tl.stuck")
        out["stuck"] = hvd.synchronize(h).numpy()
        out["pending_after"] = st.stall_inspector.pending_ops()
    finally:
        hvd_logging.warning = real
    out["warnings"] = warnings
    return out


def run_abort_groups(hvd) -> dict:
    """The groups a world made (the world, the host group, the layout
    groups, a parallel mesh's) against what ``shutdown(abort=True)`` left,
    with the NCCL branch taken on gloo: ``dist.get_backend`` answers
    ``"nccl"`` and ``c10d._abort_process_group`` is recorded, then run."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh
    from horovod_tpu_torch.runtime import state

    st = state.global_state()
    st.layout_group("local")
    make_parallel_mesh(dp=2, tp=2)
    made = len(c10d._world.pg_map)
    dist.barrier(group=st.host_group)
    calls = []
    real_abort, real_backend = c10d._abort_process_group, dist.get_backend

    def abort(group=None):
        calls.append(group)
        real_abort(group)

    c10d._abort_process_group = abort
    state.dist.get_backend = lambda group=None: "nccl"
    try:
        state.shutdown(abort=True)
    finally:
        c10d._abort_process_group = real_abort
        state.dist.get_backend = real_backend
    return {"made": made, "left": len(c10d._world.pg_map),
            "calls": calls, "initialized": dist.is_initialized(),
            "runtime": hvd.is_initialized()}


def run_timeline_card(hvd, directory: str) -> dict:
    """On one card: eight CUDA tensors through ``allreduce_async`` under
    ``start_timeline`` (the native writer), then under ``torch.profiler``;
    the writer, the results, the dropped count and the trace's spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from horovod_tpu_torch.utils import timeline as tl_mod

    dev = hvd.device()
    xs = [torch.randn(1000 * (i + 1), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(i))
          for i in range(8)]
    path = os.path.join(directory, "card.json")
    hvd.start_timeline(path)
    st = hvd._state.global_state()
    writer = type(st.timeline).__name__
    hs = [hvd.allreduce_async(x, name=f"card.{i}", prescale_factor=0.5,
                              postscale_factor=2.0) for i, x in enumerate(xs)]
    exact = all(torch.equal(hvd.synchronize(h), x) for h, x in zip(hs, xs))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        hvd.allreduce(xs[0], name="card.prof")
        torch.cuda.synchronize()
    dropped = st.timeline.dropped_events
    hvd.stop_timeline()
    spans = {}
    for e in tl_mod.load_trace(path):
        if e["ph"] == "B":
            spans.setdefault(e["tid"], []).append(e["name"])
    return {"writer": writer, "exact": exact, "dropped": dropped,
            "spans": spans,
            "ranges": sorted({e.name for e in prof.events()
                              if e.name.startswith("hvd:")})}


# ---------------------------------------------------------------------------
# the planning and memory plane: calibration and degradation
# ---------------------------------------------------------------------------

#: the sweep of the gloo calibration: small enough for a CPU world, large
#: enough that the host clock resolves a bandwidth
CAL_SWEEP = (2 ** 16, 2 ** 18, 2 ** 20, 2 ** 22)


def run_calibrate(hvd, out_path: str, sizes=CAL_SWEEP, reps: int = 3
                  ) -> dict:
    """``calibration.measure_artifact`` over this world's layout, each
    point the best of ``reps``; rank 0 saves it to ``out_path``.  Every
    rank returns its artifact.  On the CPU a rank keeps one intra-op
    thread, as the other gloo worlds here do."""
    import torch

    from horovod_tpu_torch.analysis import calibration as CAL

    if hvd.device().type == "cpu":
        torch.set_num_threads(1)
    return CAL.measure_artifact(out_path, sizes_bytes=sizes, reps=reps)


#: the degrade scenario of ``horovod_tpu/elastic/smoke.py`` on real
#: worlds: a dp=4 world with ZeRO-style sharded momentum and error-feedback
#: residual (flat fusion-buffer slices), checkpoints every ``every`` steps,
#: half the world lost after ``kill_at``, the lost steps replayed at dp=2
#: with gradient accumulation, capacity back at the next boundary
DEGRADE = dict(plan="dp=4", world=4, shrunk=2, steps=12, every=3, kill_at=8,
               width=16, global_batch=8, per_replica_batch=2)
#: the degrade runs' losses against the never-degraded run's: float64
#: partial sums added in another order (the state itself is bit-exact)
DEGRADE_LOSS_TOL = 1e-9


def degrade_sample_grads(step: int) -> np.ndarray:
    """The global batch's per-sample gradients at ``step``, (samples,
    width): multiples of 1/16 in [-1.5, 1.5], so that any grouping of
    their sums, and the mean, is exact in fp32 (a world of any size, with
    any accumulation, computes the same bits)."""
    d = DEGRADE
    k = np.arange(d["global_batch"], dtype=np.float64)[:, None]
    i = np.arange(d["width"], dtype=np.float64)[None, :]
    base = np.round(16 * np.sin(i * (1.0 + 0.1 * step) + k)) / 16
    return (base * np.where(k % 2 == 0, 0.5, 1.5)).astype(np.float32)


def degrade_update(w, m, r, g):
    """The smoke's elementwise step over flat buffers (any equal slicing
    of them reproduces it bit for bit): quantize gradient + residual
    (error feedback), momentum, apply."""
    q = np.round(8.0 * (g + r)) / 8.0 if isinstance(g, np.ndarray) else \
        (8.0 * (g + r)).round() / 8.0
    r = g + r - q
    m = 0.9 * m + q
    return w - 0.1 * m, m, r


def degrade_reference(steps: int):
    """The never-degraded run in numpy fp32: (w, m, r) after ``steps``,
    and each step's loss (the global batch's mean of ``g_s · w`` over
    the width, in float64, at the weights before the step)."""
    d = DEGRADE
    w = np.full((d["width"],), 1.5, np.float32)
    m = np.zeros_like(w)
    r = np.zeros_like(w)
    losses = []
    for s in range(1, steps + 1):
        gs = degrade_sample_grads(s)
        losses.append(float((gs.astype(np.float64) @ w.astype(np.float64))
                            .mean() / d["width"]))
        g = gs.mean(axis=0, dtype=np.float32)
        w, m, r = (x.astype(np.float32)
                   for x in degrade_update(w, m, r, g))
    return w, m, r, losses


def degrade_train(hvd, plan, ckpt, w, m, r, steps, save_every=None):
    """Steps ``steps`` of the scenario on this world at ``plan``: each rank
    accumulates ``grad_accum`` microbatches of ``per_replica_batch`` rows
    (``preserve_global_batch``), the gradient is reduce-scattered (sum)
    and divided by the rows' count, each rank updates its slice of w, m
    and r, and w is all-gathered.  At a step that ``save_every`` divides,
    rank 0 saves w and every rank its slice of m and r, stamped with the
    plan.  Returns (w, m, r, losses, grad_accum)."""
    import torch

    from horovod_tpu_torch.elastic.degrade import preserve_global_batch

    d = DEGRADE
    n, rank = hvd.size(), hvd.rank()
    dev = hvd.device()
    accum, achieved = preserve_global_batch(d["global_batch"], plan,
                                            d["per_replica_batch"])
    assert achieved == d["global_batch"]
    p = d["per_replica_batch"]
    losses = []
    for s in steps:
        gs = torch.from_numpy(degrade_sample_grads(s)).to(dev)
        local = torch.zeros(d["width"], device=dev)
        part = torch.zeros((), dtype=torch.float64, device=dev)
        for j in range(accum):
            rows = gs[(j * n + rank) * p:(j * n + rank + 1) * p]
            local += rows.mean(dim=0)
            part += (rows.double() @ w.double()).sum()
        g = hvd.reducescatter(local, op=hvd.Sum) / (n * accum)
        # named: a joiner's eager plane counts unnamed calls from zero
        losses.append(float(hvd.allreduce(part, op=hvd.Sum,
                                          name=f"degrade.loss.{s}"))
                      / d["global_batch"] / d["width"])
        sl = slice(rank * (d["width"] // n), (rank + 1) * (d["width"] // n))
        w_shard, m, r = degrade_update(w[sl], m, r, g)
        w = hvd.allgather(w_shard, name=f"degrade.w.{s}")
        if save_every and s % save_every == 0:
            ckpt.save(s, {"w": w.cpu()})
            ckpt.save_sharded(s, {"m": m.cpu(), "r": r.cpu()}, rank, n,
                              plan=plan.to_string())
            ckpt.wait()
    return w, m, r, losses, accum


def run_degrade(hvd, directory: str, plan: str, restore_step: int,
                last_step: int) -> dict:
    """One generation of the degrade scenario: a world at ``plan``
    restores step ``restore_step`` (w from rank 0's save, its slice of m
    and r re-sliced from the sharded save by ``reshard_restore``; step 0
    starts fresh) and trains steps ``restore_step + 1 .. last_step``,
    saving every ``DEGRADE["every"]`` steps."""
    import torch

    from horovod_tpu_torch.checkpoint import Checkpointer
    from horovod_tpu_torch.elastic.degrade import reshard_restore
    from horovod_tpu_torch.parallel.plan import ShardingPlan

    d = DEGRADE
    plan = ShardingPlan.from_string(plan).resolve(hvd.size())
    shard = d["width"] // hvd.size()
    ckpt = Checkpointer(directory)
    dev = hvd.device()
    if restore_step:
        w = ckpt.restore(step=restore_step)["w"].to(dev)
        st = reshard_restore(ckpt, {"m": torch.zeros(shard),
                                    "r": torch.zeros(shard)},
                             hvd.rank(), plan, step=restore_step)
        m, r = st["m"].to(dev), st["r"].to(dev)
    else:
        w = torch.full((d["width"],), 1.5, device=dev)
        m = torch.zeros(shard, device=dev)
        r = torch.zeros(shard, device=dev)
    w, m, r, losses, accum = degrade_train(
        hvd, plan, ckpt, w, m, r, range(restore_step + 1, last_step + 1),
        d["every"])
    ckpt.close()
    return {"w": w.cpu().numpy(), "m": m.cpu().numpy(),
            "r": r.cpu().numpy(), "losses": losses, "grad_accum": accum}


def check_degrade_run(run) -> dict:
    """The launcher's degrade run: worlds of 4, 2, 4; each generation at
    the plan the controller chose, with the accumulation that keeps the
    global batch; the committed losses those of the never-degraded run.
    Returns the per-generation plans and the losses."""
    steps = [r for r in run["ranks"] if r.get("event") == "zero_step"]
    by_gen = {}
    for r in steps:
        by_gen.setdefault(r["plan"], set()).add((r["size"], r["accum"]))
    assert by_gen == {"dp=4": {(4, 1)}, "dp=2": {(2, 2)}}, by_gen
    sizes = [r["size"] for r in run["results"]]
    assert sizes[:3] == [4, 2, 4], sizes
    last = {}
    for r in steps:
        last[r["gstep"]] = r["loss"]
    n = max(last)
    _, _, _, want = degrade_reference(n)
    assert sorted(last) == list(range(1, n + 1))
    np.testing.assert_allclose([last[s] for s in range(1, n + 1)], want,
                               rtol=DEGRADE_LOSS_TOL)
    return {"plans": sorted(by_gen), "losses": [last[s] for s in sorted(last)]}


def run_remat_card(hvd, layers: int = 2, steps: int = 3) -> dict:
    """On one card: the 870.9M LM's width at ``layers`` layers (seq 1024,
    batch 2, bf16, flash) through ``DistributedTrainStep`` with AdamW,
    ``steps`` steps under each remat tier from one seed: the losses, the
    flash launches a step, the peak memory, the offload tier's host bytes,
    and the bytes one more forward keeps for backward."""
    import torch

    from horovod_tpu_torch.memory.remat import OffloadStats
    from horovod_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        lm_loss,
    )
    from horovod_tpu_torch.ops import kernels as K

    dev = hvd.device()
    tokens = torch.randint(0, 32000, (2, 1025),
                           generator=torch.Generator().manual_seed(0))
    out = {}
    for tier in ("none", "dots", "full", "offload"):
        cfg = TransformerConfig(vocab_size=32000, num_layers=layers,
                                num_heads=16, d_model=2048, d_ff=8192,
                                max_seq_len=1024, dtype=torch.bfloat16,
                                attention_impl="flash", remat_policy=tier)
        model = TransformerLM(cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(0))
        step = hvd.DistributedTrainStep(
            lm_loss, torch.optim.AdamW(model.parameters(), lr=3e-4))
        model, opt = step.init(model)
        batch = step.shard_batch(tokens)
        OffloadStats.reset()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        losses = [float(step(model, opt, batch)[2]) for _ in range(steps)]
        counts = K.launch_counts()
        host = (OffloadStats.d2h_bytes, OffloadStats.h2d_bytes)
        torch.cuda.synchronize()
        state = torch.cuda.memory_allocated()
        loss = lm_loss(model, batch)
        activations = torch.cuda.memory_allocated() - state
        del loss
        out[tier] = {"losses": losses, "activations": activations,
                     "launches": {k: counts[k] / steps for k in (
                         "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")},
                     "peak": torch.cuda.max_memory_allocated(),
                     "host_d2h": host[0], "host_h2d": host[1]}
        del model, opt, step
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the training-state guard (tests/test_torch_guarded_step.py,
# tests/test_torch_guard.py, the four-card test_guard_over_nccl)
# ---------------------------------------------------------------------------

#: the loss scale of each step of the guarded-step worlds: clean steps, a
#: non-finite loss at step 4, a spike past the limit at step 6 (the
#: guardian's warmup is 2 clean steps)
GUARD_SCALES = (1.0, 1.0, 1.0, float("nan"), 1.0, 1e3, 1.0)
GUARD_VERDICTS = ("ok", "ok", "ok", "nonfinite", "ok", "spike", "ok")
GUARD_CASES = ("hook", "sharded", "adasum", "tp", "fsdp")
GUARD_ROWS = 4


def guard_tokens(world: int, seed: int = 0) -> np.ndarray:
    """The guarded-step worlds' global batch: ``GUARD_ROWS`` sequences a
    rank of MP_LM's tokens (17 each)."""
    return np.random.RandomState(seed).randint(
        0, MP_LM["vocab_size"], (GUARD_ROWS * world, 17)).astype(np.int64)


def guard_loss(model, batch):
    """``lm_loss`` times the batch's scale (one value a row, all equal)."""
    from horovod_tpu_torch.models.transformer import lm_loss

    return lm_loss(model, batch["tokens"]) * batch["scale"][0]


def guard_model(seed: int = 0, device=None):
    """MP_LM in fp32 with flash attention, drawn from ``seed``."""
    import torch

    from horovod_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
    )

    cfg = TransformerConfig(dtype=torch.float32, attention_impl="flash",
                            **MP_LM)
    return TransformerLM(cfg, device=device,
                         generator=torch.Generator().manual_seed(seed))


def guard_state(opt) -> list:
    """What a skipped step must leave as it was: the optimizer state the
    wrapper holds (the sharded exchange's shard state and error-feedback
    residuals included)."""
    sharded = getattr(opt, "sharded_state", None)
    if sharded is not None:
        return [sharded.inner.state_dict(), sharded.residuals]
    return [opt.state_dict()]


def guard_case(hvd, case: str, world_tokens: np.ndarray) -> dict:
    """GUARD_SCALES through ``DistributedTrainStep(guard=TrainingGuard(
    policy="skip_step", warmup_steps=2))`` in one exchange form: each
    step's norm and verdict, and whether the parameters and the optimizer
    state (AdamW's step counters included) are bit for bit those from
    before each step (by their fingerprints)."""
    import torch

    from horovod_tpu_torch.guard import TrainingGuard, fingerprint

    model = guard_model()
    adamw = torch.optim.AdamW(model.parameters(), lr=MP_LR,
                              weight_decay=1e-4)
    size = hvd.size()
    opt, kw = adamw, {}
    if case == "hook":
        opt = hvd.DistributedOptimizer(adamw)
    elif case == "sharded":
        kw = dict(shard_optimizer_states=True,
                  compression=hvd.Compression.int8, error_feedback=True)
    elif case == "adasum":
        opt, kw = hvd.DistributedAdasumOptimizer(adamw), dict(op=None)
    elif case == "tp":
        kw = dict(plan=f"tp={size}")
    elif case == "fsdp":
        kw = dict(plan=f"fsdp={size}", fsdp_min_weight_size=1)
    guard = TrainingGuard(policy="skip_step", warmup_steps=2)
    step = hvd.DistributedTrainStep(guard_loss, opt, guard=guard, **kw)
    model, opt = step.init(model)
    out = {"gnorm": [], "verdict": [], "unchanged": [], "limit": []}
    for scale in GUARD_SCALES:
        tokens = torch.from_numpy(world_tokens)
        batch = step.shard_batch({
            "tokens": tokens,
            "scale": torch.full((tokens.shape[0],), scale)})
        before = fingerprint([model.state_dict(), guard_state(opt)])
        out["limit"].append(guard.current_limit())
        step(model, opt, batch)
        after = fingerprint([model.state_dict(), guard_state(opt)])
        out["gnorm"].append(guard.numerics.last_gnorm)
        out["verdict"].append(guard.numerics.last_verdict)
        out["unchanged"].append(before == after)
    if case == "hook":
        # the replica vote over gloo: equal replicas agree; a copy
        # perturbed on rank 1 is named
        from horovod_tpu_torch.guard import ReplicaChecker, dist_gather_fn

        tree = {k: v.clone() for k, v in model.state_dict().items()}
        fps = dist_gather_fn()(fingerprint(tree))
        out["fps_agree"] = len(set(fps)) == 1 and len(fps) == size
        if hvd.rank() == 1:
            first = next(iter(tree))
            tree[first].view(-1)[0] += 1.0
        report = ReplicaChecker(1, dist_gather_fn()).check(1, tree)
        out["diverged"] = None if report is None else report.diverged
    return out


def run_guard(hvd) -> dict:
    """Every GUARD_CASES exchange form on this world (gloo, one intra-op
    thread a rank)."""
    import torch

    torch.set_num_threads(1)
    tokens = guard_tokens(hvd.size())
    return {case: guard_case(hvd, case, tokens) for case in GUARD_CASES}


#: the four-card guard scenario: the 870.9M LM's width at 4 of its 16
#: layers (each checkpoint writes the parameters and AdamW state), a
#: checkpoint every 2 commits, a replica check every 2 steps, rank 2's
#: parameters corrupted at step 5
GUARD_NCCL = dict(steps=8, every=2, interval=2, corrupt_at=5, rank=2,
                  layers=4)


def _guard_world_scenario(hvd, cfg, rows: int, seq: int, root: str,
                          fault: bool) -> dict:
    """One run of the four-card scenario: phase 4's recipe (AdamW 3e-4,
    the hook path) under ``TrainingGuard(policy="rollback")`` with
    fingerprints gathered over the world, ``TorchState`` with a
    ``Checkpointer``; with ``fault``, a ``guard.params`` corrupt fault on
    rank GUARD_NCCL["rank"] at its check of step ``corrupt_at``.  The
    batch of each step is drawn from the step's number, so a replay
    trains on the same rows.  Returns this rank's final fingerprint, the
    divergence events and the pinned steps."""
    import torch

    from chip_smoke import SEED
    from horovod_tpu_torch import faults
    from horovod_tpu_torch.checkpoint import Checkpointer
    from horovod_tpu_torch.elastic import TorchState
    from horovod_tpu_torch.guard import (
        GuardRollback,
        RollbackManager,
        TrainingGuard,
        dist_gather_fn,
        fingerprint,
    )
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss

    dev = hvd.device()
    g = GUARD_NCCL
    model = TransformerLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    adamw = torch.optim.AdamW(model.parameters(), lr=3e-4,
                              weight_decay=1e-4)
    opt = hvd.DistributedOptimizer(adamw, gradient_predivide_factor=2.0)
    ckpt = Checkpointer(os.path.join(root, "fault" if fault else "clean"))
    state = TorchState(model, adamw, checkpointer=ckpt,
                       checkpoint_every=g["every"])
    guard = TrainingGuard(policy="rollback", check_interval=g["interval"],
                          gather_fn=dist_gather_fn(),
                          rollback=RollbackManager(state))
    step = hvd.DistributedTrainStep(lm_loss, opt, guard=guard)
    model, opt = step.init(model)
    if fault and hvd.rank() == g["rank"]:
        faults.set_plan(faults.FaultPlan(seed=SEED).add(
            "guard.params", "corrupt", at=g["corrupt_at"], arg=1.0))
    events, t_rollback = [], None
    try:
        while state._commit_count < g["steps"]:
            s = state._commit_count + 1
            tokens = torch.randint(
                0, cfg.vocab_size, (rows * hvd.size(), seq + 1),
                generator=torch.Generator().manual_seed(SEED + s))
            model, opt, loss = step(model, opt, step.shard_batch(tokens))
            state.commit()
            guard.note_commit()
            live = dict(model.named_parameters())
            try:
                out = guard.check_replicas(s, live)
            except GuardRollback:
                report = guard.checker.last_report
                t0 = time.perf_counter()
                state.wait()            # rank 0's writer: the target is on
                hvd.barrier()           # disk before any rank reads it
                replayed = guard.rollback(reason="divergence")
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                t_rollback = time.perf_counter() - t0
                events.append(dict(
                    step=s, diverged=report.diverged,
                    fingerprints=report.fingerprints, replayed=replayed,
                    restored=state._commit_count,
                    pinned=ckpt.pinned_steps(), seconds=t_rollback))
                continue
            with torch.no_grad():
                for name, t in out.items():
                    if t is not live[name]:     # the injected corruption
                        live[name].copy_(t)
        state.wait()
    finally:
        faults.clear_plan()
    nbytes = sum(t.numel() * t.element_size() for t in
                 list(model.state_dict().values()) +
                 [v for st in adamw.state.values() for v in st.values()
                  if torch.is_tensor(v)])
    return dict(fp=fingerprint(model.state_dict()), events=events,
                pinned=ckpt.pinned_steps(), state_bytes=nbytes,
                commits=state._commit_count)


def _guard_sharded_skip(hvd, cfg, rows: int, seq: int) -> dict:
    """The sharded exchange under ``guard=`` (skip_step): a clean step,
    then a non-finite loss; this rank's verdicts and norms."""
    import torch

    from chip_smoke import SEED
    from horovod_tpu_torch.guard import TrainingGuard
    from horovod_tpu_torch.models.transformer import TransformerLM

    dev = hvd.device()
    model = TransformerLM(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    guard = TrainingGuard(policy="skip_step", warmup_steps=2)
    step = hvd.DistributedTrainStep(
        guard_loss, torch.optim.AdamW(model.parameters(), lr=3e-4),
        shard_optimizer_states=True, guard=guard)
    model, opt = step.init(model)
    tokens = torch.randint(0, cfg.vocab_size, (rows * hvd.size(), seq + 1),
                           generator=torch.Generator().manual_seed(SEED))
    out = {"verdict": [], "gnorm": []}
    for scale in (1.0, float("nan"), 1.0):
        step(model, opt, step.shard_batch({
            "tokens": tokens,
            "scale": torch.full((tokens.shape[0],), scale)}))
        out["verdict"].append(guard.numerics.last_verdict)
        out["gnorm"].append(guard.numerics.last_gnorm)
    return out


def run_guard_nccl(hvd, small: bool = False) -> dict:
    """The four-card guard test (``test_guard_over_nccl``): the
    GUARD_NCCL scenario fault-free, then with rank 2's parameters
    corrupted; then the sharded exchange's guarded skip.  ``small`` runs
    MP_LM on sequences of 16 (the gloo rehearsal)."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from chip_smoke import FULL, full_config

    if small:
        torch.set_num_threads(1)
        from horovod_tpu_torch.models.transformer import TransformerConfig

        cfg = TransformerConfig(dtype=torch.float32, attention_impl="flash",
                                **MP_LM)
        seq, rows = 16, 2
    else:
        cfg = dataclasses.replace(full_config(torch, "flash"),
                                  num_layers=GUARD_NCCL["layers"])
        seq, rows = FULL["seq"], FULL["batch"]
    root = hvd.broadcast_object(
        tempfile.mkdtemp(prefix="hvd_guard_") if hvd.rank() == 0 else None,
        root_rank=0)
    try:
        clean = _guard_world_scenario(hvd, cfg, rows, seq, root, False)
        if hvd.device().type == "cuda":
            torch.cuda.empty_cache()
        faulty = _guard_world_scenario(hvd, cfg, rows, seq, root, True)
        if hvd.device().type == "cuda":
            torch.cuda.empty_cache()
        sharded = _guard_sharded_skip(hvd, cfg, rows, seq)
    finally:
        hvd.barrier()
        if hvd.rank() == 0:
            shutil.rmtree(root, ignore_errors=True)
    return dict(clean=clean, faulty=faulty, sharded=sharded)


def check_guard_world(outs: list) -> None:
    """What ``run_guard_nccl``'s ranks must show: the vote on every rank
    names rank GUARD_NCCL["rank"] once, at the first check after the
    corruption, and the world rolls back to the pinned last-good step;
    every rank ends on the fault-free run's parameters bit for bit; the
    sharded exchange's guarded step skips the non-finite step on every
    rank, with the same norms."""
    g = GUARD_NCCL
    detect = -(-g["corrupt_at"] // g["interval"]) * g["interval"]
    last_good = (detect - g["interval"]) // g["every"] * g["every"]
    first = outs[0]
    for rank, out in enumerate(outs):
        clean, faulty = out["clean"], out["faulty"]
        assert clean["events"] == [], rank
        assert len(faulty["events"]) == 1, (rank, faulty["events"])
        ev = faulty["events"][0]
        assert ev["step"] == detect and ev["diverged"] == [g["rank"]], \
            (rank, ev)
        assert ev["restored"] == last_good and ev["pinned"] == [last_good]
        assert ev["replayed"] == detect - last_good
        assert ev["fingerprints"] == first["faulty"]["events"][0][
            "fingerprints"]
        assert faulty["fp"] == clean["fp"] == first["clean"]["fp"], rank
        assert faulty["commits"] == clean["commits"] == g["steps"]
        sharded = out["sharded"]
        assert sharded["verdict"] == ["ok", "nonfinite", "ok"], rank
        np.testing.assert_array_equal(sharded["gnorm"],
                                      first["sharded"]["gnorm"])


# ---------------------------------------------------------------------------
# steps_per_call: the step as a captured graph
# ---------------------------------------------------------------------------

#: the cases of the graph step: the data plan's hook path and the flat
#: sharded exchange
SPC_CASES = ("hook", "sharded")


def _spc_state(opt) -> list:
    """The optimizer's state, in parameter order, as numpy: the wrapped
    torch optimizer's on the hook path, the shard optimizer's under the
    sharded exchange."""
    inner = opt.sharded_state.inner if hasattr(opt, "sharded_state") \
        else opt.optimizer
    return [{k: v.detach().cpu().float().numpy().copy()
             for k, v in inner.state[p].items()}
            for g in inner.param_groups for p in g["params"]]


def spc_train(hvd, case: str, k: int, calls: int, params0=None,
              tokens=None, sizes=None, profile: bool = False) -> dict:
    """``calls`` calls of ``DistributedTrainStep(steps_per_call=k)`` with
    AdamW(3e-4, weight_decay=1e-4) (``capturable=True`` on a card) on the
    transformer LM of ``sizes`` (default :data:`TRAIN_SIZES`; fp32 on the
    CPU, bf16 on a card), from ``params0`` (a state dict of numpy arrays)
    or seed 0, on the global batch ``tokens`` (default
    :func:`train_tokens`); ``case`` is the hook path or the flat sharded
    exchange.  Returns each call's loss, the parameters, the optimizer's
    state, the telemetry's step count and the step's counters; with
    ``profile`` (a card) one more call runs under torch.profiler after
    the results are taken, and its kernel 1-4 device launches are
    returned too."""
    import torch

    from horovod_tpu_torch import telemetry
    from horovod_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        lm_loss,
    )

    dev = hvd.device()
    cfg = TransformerConfig(
        dtype=torch.float32 if dev.type == "cpu" else torch.bfloat16,
        attention_impl="flash", **(sizes or TRAIN_SIZES))
    model = TransformerLM(cfg, generator=torch.Generator().manual_seed(0))
    if params0 is not None:
        model.load_state_dict({n: torch.from_numpy(np.asarray(v))
                               for n, v in params0.items()})
    model = model.to(dev)
    kw = {"capturable": True} if dev.type == "cuda" else {}
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4,
                          **kw),
        shard_optimizer_states=case == "sharded")
    step = hvd.DistributedTrainStep(lambda m, b: lm_loss(m, b), opt,
                                    steps_per_call=k)
    model, opt = step.init(model)
    batch = step.shard_batch(train_tokens() if tokens is None else tokens)
    was_on = telemetry.enabled()
    telemetry.enable()
    before = telemetry.value("hvd_steps_total")
    ctx = telemetry.run_context().step
    losses = []
    try:
        for _ in range(calls):
            model, opt, loss = step(model, opt, batch)
            losses.append(float(loss))
        steps_total = telemetry.value("hvd_steps_total") - before
    finally:
        if not was_on:
            telemetry.disable()
    out = dict(
        losses=losses,
        params={n: v.detach().cpu().float().numpy().copy()
                for n, v in model.state_dict().items()},
        names=[n for n, _ in model.named_parameters()],
        state=_spc_state(opt), steps_total=steps_total,
        context_steps=telemetry.run_context().step - ctx,
        cache_hit=step.compile_cache_hit, profiled=None)
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx

        from chip_smoke import profiled_launches

        torch.cuda.synchronize()
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            model, opt, loss = step(model, opt, batch)
            float(loss)
        out["profiled"] = profiled_launches(prof)
        # an eager call after the graph's (the hook path's round flags,
        # the gradients and the shards' .grad are the eager step's then),
        # and a replay after it
        eager_step = hvd.DistributedTrainStep(lambda m, b: lm_loss(m, b),
                                              opt)
        model, opt, loss = eager_step(model, opt, batch)
        out["after"] = [float(loss)]
        model, opt, loss = step(model, opt, batch)
        out["after"].append(float(loss))
    out.update(
        replays=step.replays,
        graphs=0 if step.graphs is None else len(step.graphs),
        launches={} if step.graphs is None else dict(
            step.graphs.values()[0].graph.launches))
    return out


def run_graph_rebind(hvd, k: int = 2, calls: int = 3) -> dict:
    """On a card: ``DistributedTrainStep(steps_per_call=k)`` against
    ``k`` eager steps a call, where what the graph was captured with
    changes between calls.  ``restore``: after the second call the
    parameters and AdamW's state are restored (``load_state_dict``, new
    state tensors) to a snapshot taken after the first.  ``tensor_lr``: an
    lr on the card under a ``LambdaLR`` stepped each call (``fill_`` in
    place: one capture).  ``float_lr``: a float lr under the same schedule
    (a new key each call); after each call the card's cache is emptied and
    its reserved bytes read, and the graph of the call before must be
    freed.  Returns, for each case and way, the losses (the last step's of
    each call), the parameters and the state, and for the graph the
    in-memory layer's hits and misses, the reserved bytes and whether
    every replaced graph was freed."""
    import copy
    import gc
    import weakref

    import torch

    from horovod_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        lm_loss,
    )

    dev = hvd.device()
    cfg = TransformerConfig(dtype=torch.bfloat16, attention_impl="flash",
                            **TRAIN_SIZES)

    def run(case: str, kk: int) -> dict:
        model = TransformerLM(cfg, generator=torch.Generator().manual_seed(
            0)).to(dev)
        lr = torch.tensor(3e-4, device=dev) if case == "tensor_lr" \
            else 3e-4
        inner = torch.optim.AdamW(model.parameters(), lr=lr,
                                  weight_decay=1e-4, capturable=True)
        step = hvd.DistributedTrainStep(lambda m, b: lm_loss(m, b),
                                        hvd.DistributedOptimizer(inner),
                                        steps_per_call=kk)
        model, opt = step.init(model)
        batch = step.shard_batch(train_tokens())
        scheduler = None if case == "restore" else \
            torch.optim.lr_scheduler.LambdaLR(inner, lambda c: 0.5 ** c)
        losses, reserved, freed, snap = [], [], [], None
        last = None
        for c in range(calls):
            if case == "restore" and c == 2:
                model.load_state_dict(snap[0])
                opt.load_state_dict(snap[1])
            for _ in range(k // kk):
                model, opt, loss = step(model, opt, batch)
            losses.append(float(loss))
            if case == "restore" and c == 0:
                snap = (copy.deepcopy(model.state_dict()),
                        copy.deepcopy(opt.state_dict()))
            if scheduler is not None:
                scheduler.step()
            if kk > 1 and case == "float_lr":
                gc.collect()
                torch.cuda.empty_cache()
                reserved.append(torch.cuda.memory_reserved())
                if last is not None:
                    freed.append(last() is None)
                last = weakref.ref(step.graphs.values()[0])
        out = dict(losses=losses, lr_is_tensor=isinstance(
            inner.param_groups[0]["lr"], torch.Tensor),
            params={n: v.detach().cpu().float().numpy().copy()
                    for n, v in model.state_dict().items()},
            state=_spc_state(opt))
        if kk > 1:
            out.update(hits=step.graphs.hits, misses=step.graphs.misses,
                       graphs=len(step.graphs), reserved=reserved,
                       freed=freed)
        return out

    return {case: {"graph": run(case, k), "eager": run(case, 1)}
            for case in ("restore", "tensor_lr", "float_lr")}


def run_steps_per_call(hvd, k: int = 3, calls: int = 1, params0=None,
                       tokens=None, sizes=None,
                       cases=SPC_CASES) -> dict:
    """For each case of :data:`SPC_CASES`: ``calls`` calls of
    ``steps_per_call=k`` and ``k * calls`` calls of ``steps_per_call=1``
    from the same weights (:func:`spc_train`).  On a card the first runs
    through the captured graph (and one more call under the profiler,
    after the compared ones) and the second eagerly."""
    import torch

    torch.set_num_threads(1)
    card = hvd.device().type == "cuda"
    out = {}
    for case in cases:
        out[case] = {
            "graph": spc_train(hvd, case, k, calls, params0, tokens, sizes,
                               profile=card),
            "eager": spc_train(hvd, case, 1, k * calls, params0, tokens,
                               sizes)}
    return out


def check_steps_per_call(res: dict, k: int, calls: int) -> None:
    """``steps_per_call=k`` equals ``k`` calls of 1 bit for bit: each
    call's loss is the last of its ``k`` eager steps', and the parameters
    and the optimizer's state are the same bits; the telemetry counted
    ``k`` steps a call."""
    for case, r in res.items():
        g, e = r["graph"], r["eager"]
        assert g["losses"] == e["losses"][k - 1::k], (case, g["losses"],
                                                      e["losses"])
        for n, v in e["params"].items():
            np.testing.assert_array_equal(g["params"][n], v,
                                          err_msg=f"{case} {n}")
        assert len(g["state"]) == len(e["state"])
        for i, (sg, se) in enumerate(zip(g["state"], e["state"])):
            assert sg.keys() == se.keys(), (case, i)
            for key in se:
                np.testing.assert_array_equal(sg[key], se[key],
                                              err_msg=f"{case} {i} {key}")
        assert g["steps_total"] == e["steps_total"] == k * calls, case
        assert g["context_steps"] == e["context_steps"] == k * calls, case


# ---------------------------------------------------------------------------
# the N-level tree over a named layout, the overlap probe, dead-peer drills
# ---------------------------------------------------------------------------

#: JAX TestTreeExchange's mesh: extents and names, outermost first
TREE_SHAPE, TREE_NAMES = (2, 2, 2), ("pod", "slice", "chip")
#: the sharded optimizer over the tree layout: name -> options (JAX
#: TestTreeExchange._sharded_update's cases, and error feedback)
TREE_OPT_CASES = {
    "tree": {"hierarchy": "tree"},
    "auto": {"hierarchy": "auto"},
    "flat": {"hierarchy": "flat"},
    "pod_codec": {"hierarchy": "tree", "level_codecs": {"pod": 8}},
    "chip_codec": {"hierarchy": "tree", "level_codecs": {"chip": 8}},
    "int8": {"hierarchy": "tree", "compression": "int8"},
    "int8_ef": {"hierarchy": "tree", "compression": "int8",
                "error_feedback": True},
}
TREE_OPT_STEPS = 3


def tree_opt_grads(world: int = 8) -> np.ndarray:
    """(steps, world, 12) seeded gradients: rank r's leaves ``a`` (8
    values) and ``b`` (4) at each step."""
    rng = np.random.RandomState(11)
    return rng.randn(TREE_OPT_STEPS, world, 12).astype(np.float32)


def _tree_opt(hvd, axis, name: str, steps: int = TREE_OPT_STEPS,
              start=None):
    """Adam(0.1) over ``a = ones(8)``, ``b = zeros(4)`` (or ``start``)
    through ``DistributedOptimizer(shard_optimizer_states=True,
    axis=axis, **TREE_OPT_CASES[name])``, ``steps`` steps of
    :func:`tree_opt_grads`; (params, optimizer)."""
    import torch

    kw = dict(TREE_OPT_CASES[name])
    if "compression" in kw:
        kw["compression"] = getattr(hvd.Compression, kw["compression"])
    init = start or (np.ones(8, np.float32), np.zeros(4, np.float32))
    params = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in init]
    opt = hvd.DistributedOptimizer(torch.optim.Adam(params, lr=0.1),
                                   shard_optimizer_states=True, axis=axis,
                                   **kw)
    grads = tree_opt_grads(hvd.size())
    for t in range(steps):
        g = grads[t, hvd.rank()]
        params[0].grad = torch.from_numpy(g[:8].copy())
        params[1].grad = torch.from_numpy(g[8:].copy())
        opt.step()
    return params, opt


def _tree_opt_out(params, opt) -> dict:
    return {"a": params[0].detach().numpy().copy(),
            "b": params[1].detach().numpy().copy(),
            "mode": opt.exchange_hierarchy, "index": opt.shard_index}


def run_tree_layout(hvd, directory: str) -> dict:
    """On a gloo world of 8 laid out 2 x 4: the sharded optimizer over
    ``TreeLayout((2, 2, 2), ("pod", "slice", "chip"))`` for every
    :data:`TREE_OPT_CASES` case; a sharded checkpoint saved under the
    tree at the block each rank owns and restored into a fresh wrapper;
    the world's default layout (``axis=None``) against the same axes
    named by a layout, and a ``(2, 1, 4)`` layout (its extent-1 level
    dropped) against ``(2, 4)``; a layout that does not cover the
    world."""
    import torch

    from horovod_tpu_torch.checkpoint import Checkpointer
    from horovod_tpu_torch.runtime.topology import TreeLayout

    torch.set_num_threads(1)
    world = hvd.size()
    tree = TreeLayout(TREE_SHAPE, TREE_NAMES)
    out = {"opt": {name: _tree_opt_out(*_tree_opt(hvd, tree, name))
                   for name in TREE_OPT_CASES}}
    # the checkpoint round trip under the tree (error feedback: the
    # residuals travel too)
    params, opt = _tree_opt(hvd, tree, "int8_ef", steps=2)
    start = tuple(p.detach().numpy().copy() for p in params)
    ckpt = Checkpointer(os.path.join(directory, "tree"), async_save=False)
    ckpt.save_sharded(2, opt.sharded_state_dict(), opt.shard_index, world,
                      plan=f"dp={world}")
    saved = _np_tree(opt.sharded_state_dict())
    _step_once(hvd, params, opt, 2)
    hvd.barrier()
    fresh, opt2 = _tree_opt(hvd, tree, "int8_ef", steps=0, start=start)
    opt2.load_sharded_state_dict(ckpt.restore_sharded(
        opt2.sharded_state_template(), opt2.shard_index, world,
        plan=f"dp={world}"))
    restored = _np_tree(opt2.sharded_state_dict())
    _step_once(hvd, fresh, opt2, 2)
    out["ckpt"] = {"saved": saved, "restored": restored,
                   "index": opt.shard_index,
                   "continued": [p.detach().numpy().copy() for p in params],
                   "resumed": [p.detach().numpy().copy() for p in fresh]}
    # axis=None against its own axes named by a layout, and extent 1
    named = TreeLayout((2, 4), ("cross", "local"))
    with_one = TreeLayout((2, 1, 4), ("pod", "slice", "chip"))
    out["default"] = {
        how: {name: _tree_opt_out(*_tree_opt(hvd, axis, name))
              for name in ("auto", "flat", "int8_ef")}
        for how, axis in (("none", None), ("named", named),
                          ("with_one", with_one))}
    try:
        hvd.DistributedOptimizer(
            torch.optim.SGD([torch.nn.Parameter(torch.ones(4))], lr=0.1),
            shard_optimizer_states=True, axis=TreeLayout((2, 2), ("a", "b")))
        out["uncovered"] = None
    except ValueError as e:
        out["uncovered"] = str(e)
    return out


def run_tree_groups(hvd) -> dict:
    """On a caller-made world of 4 over two hosts (laid out 2 x 2): how
    many process groups this rank holds (``c10d``'s map) after the
    world's layout levels, a layout naming the same axes, a layout of
    other names, an equal layout again, and ``hvd.shutdown()``; and
    whether the layouts that should share groups hold the same
    objects."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    from horovod_tpu_torch.runtime import state
    from horovod_tpu_torch.runtime.topology import TreeLayout

    st = state.global_state()
    held = {"start": len(c10d._world.pg_map)}
    levels = {name: st.layout_group(name) for name in ("local", "cross")}
    held["levels"] = len(c10d._world.pg_map)
    named = TreeLayout((2, 2), ("cross", "local")).groups()
    held["named"] = len(c10d._world.pg_map)
    other = TreeLayout((2, 2), ("x", "y")).groups()
    held["other"] = len(c10d._world.pg_map)
    again = TreeLayout((2, 2), ("x", "y")).groups()
    held["again"] = len(c10d._world.pg_map)
    dist.barrier(group=st.host_group)
    hvd.shutdown()
    held["shutdown"] = len(c10d._world.pg_map)
    return {"held": held,
            "named_shares_levels": all(named[k] is levels[k]
                                       for k in levels),
            "equal_layouts_share": all(again[k] is other[k] for k in other),
            "other_differs": other["x"] is not levels["cross"],
            "world_left": dist.is_initialized()}


def _step_once(hvd, params, opt, t: int) -> None:
    """One more step of :func:`_tree_opt` with step ``t``'s gradients."""
    import torch

    g = tree_opt_grads(hvd.size())[t, hvd.rank()]
    params[0].grad = torch.from_numpy(g[:8].copy())
    params[1].grad = torch.from_numpy(g[8:].copy())
    opt.step()


def _probe_mlp(hvd):
    """The test MLP as a module, and this rank's rows of
    :func:`mlp_batch`'s global batch of 8 rows a rank."""
    import torch

    model = torch.nn.ParameterDict({
        k: torch.nn.Parameter(torch.from_numpy(v.copy()))
        for k, v in mlp_params().items()})
    x, y = mlp_batch(8 * hvd.size())
    rows = slice(8 * hvd.rank(), 8 * (hvd.rank() + 1))
    return model, {"x": torch.from_numpy(x[rows]),
                   "y": torch.from_numpy(y[rows])}


def run_overlap_probe(hvd) -> dict:
    """``measure_overlap`` on a gloo world of 8 laid out 2 x 4 over the
    test MLP: ``"auto"`` (two-level) and ``"flat"`` over the world's
    layout, the ``(2, 2, 2)`` tree over a ``TreeLayout``, and the auto
    case again with telemetry on (the gauges' values by label); each
    report as a dict with its bench fields."""
    import dataclasses

    import torch

    from horovod_tpu_torch import telemetry
    from horovod_tpu_torch.runtime.topology import TreeLayout
    from horovod_tpu_torch.utils.overlap_probe import measure_overlap

    torch.set_num_threads(1)
    model, batch = _probe_mlp(hvd)

    def probe(**kw):
        rep = measure_overlap(mlp_loss, model, batch, iters=1, warmup=0,
                              **kw)
        return dict(dataclasses.asdict(rep), fields=rep.as_bench_fields())

    out = {"auto": probe(), "flat": probe(hierarchy="flat"),
           "tree": probe(axis=TreeLayout(TREE_SHAPE, TREE_NAMES),
                         hierarchy="tree")}
    telemetry.reset()
    telemetry.enable()
    try:
        out["gauged"] = probe()
        out["gauges"] = {
            (name, tuple(sorted(labels.items()))): telemetry.value(
                name, **labels)
            for name, labels in (
                ("hvd_exchange_time_seconds", {"level": "total"}),
                ("hvd_exchange_time_seconds", {"level": "local"}),
                ("hvd_exchange_time_seconds", {"level": "cross"}),
                ("hvd_overlap_fraction", {}),
                ("hvd_tail_exchange_seconds", {"fused": "off"}),
                ("hvd_exchange_measured_wire_bytes", {"level": "local"}),
                ("hvd_exchange_measured_wire_bytes", {"level": "cross"}))}
    finally:
        telemetry.disable()
        telemetry.reset()
    return out


def run_kill(hvd, path: str, victim: int) -> dict:
    """A dead peer on the gloo world (ROADMAP C 15's rehearsal): the
    world's groups take an elastic world's timeouts (``shorten_timeouts``,
    ``HOROVOD_ELASTIC_HEARTBEAT_TIMEOUT`` seconds), one step completes,
    then rank ``victim`` exits and the others enter the sharded
    optimizer's step (``path="sharded"``) or an eager allreduce's
    ``synchronize`` (``"eager"``).  A survivor returns what it raised,
    the seconds until it did, and whether its parameters stayed as they
    were."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.runtime import distributed as hvd_dist

    torch.set_num_threads(1)
    st = hvd._state.global_state()
    st.timeout, st.device_timeout = hvd_dist.shorten_timeouts(
        dist.group.WORLD, st.host_group)
    params = [torch.nn.Parameter(torch.ones(64))]
    if path == "sharded":
        opt = hvd.DistributedOptimizer(torch.optim.SGD(params, lr=0.1),
                                       shard_optimizer_states=True)

        def act():
            params[0].grad = torch.full((64,), float(hvd.rank() + 1))
            opt.step()
    else:
        def act():
            hvd.synchronize(hvd.allreduce_async(torch.ones(64),
                                                name="kill"))
    act()
    dist.barrier(group=st.host_group)
    if hvd.rank() == victim:
        os._exit(0)
    before = params[0].detach().clone()
    t0 = time.monotonic()
    err = None
    try:
        act()
    except Exception as e:  # noqa: BLE001 - reported to the test
        err = e
    seconds = time.monotonic() - t0
    hvd._state.shutdown(abort=True)
    return {"error": None if err is None else type(err).__name__,
            "message": str(err)[:500], "seconds": seconds,
            "unchanged": torch.equal(before, params[0].detach())}


#: the four-card tree cases of :func:`run_tree_nccl`: name -> (layout as
#: (shape, names) or None, hierarchy, level codecs)
TREE_NCCL_CASES = {
    "two_level": (((2, 2), ("cross", "local")), "two_level", None),
    "tree": (((2, 2), ("cross", "local")), "tree", None),
    "tree_212": (((2, 1, 2), TREE_NAMES), "tree", None),
    "pod_codec": (((2, 1, 2), TREE_NAMES), "tree", {"pod": 8}),
    "flat": (None, "flat", None),
}


def _tree_lm(hvd, case: str) -> dict:
    """The fp32 TransformerLM of :data:`ADASUM_LM` (seed 0) through
    ``DistributedTrainStep`` over ``DistributedOptimizer(AdamW(3e-4,
    weight_decay=1e-4), shard_optimizer_states=True, axis=..., hierarchy=
    ..., level_codecs=...)`` of ``TREE_NCCL_CASES[case]``,
    ``ADASUM_LM_STEPS`` steps on 8 sequences of
    :func:`adasum_lm_tokens`."""
    import torch

    from horovod_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        lm_loss,
    )
    from horovod_tpu_torch.runtime.topology import TreeLayout

    layout, hierarchy, codecs = TREE_NCCL_CASES[case]
    cfg = TransformerConfig(dtype=torch.float32, attention_impl="flash",
                            **ADASUM_LM)
    model = TransformerLM(cfg, generator=torch.Generator().manual_seed(0))
    model.to(hvd.device())
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4),
        shard_optimizer_states=True, hierarchy=hierarchy,
        level_codecs=codecs,
        axis=None if layout is None else TreeLayout(*layout))
    step = hvd.DistributedTrainStep(lambda m, b: lm_loss(m, b), opt)
    model, opt = step.init(model)
    batch = step.shard_batch(adasum_lm_tokens(8))
    losses = [float(step(model, opt, batch)[2])
              for _ in range(ADASUM_LM_STEPS)]
    return {"losses": losses, "mode": opt.exchange_hierarchy,
            "index": opt.shard_index,
            "params": {k: v.cpu().numpy().copy()
                       for k, v in model.state_dict().items()}}


def _probe_report(hvd, model, batch, axis, hierarchy: str, **kw) -> dict:
    """``measure_overlap`` as a dict with its bench fields and the
    kernels' launches over the probe's calls."""
    import dataclasses

    from horovod_tpu_torch.models.transformer import lm_loss
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.utils.overlap_probe import measure_overlap

    K.reset_launch_counts()
    rep = measure_overlap(lm_loss, model, batch, axis=axis,
                          hierarchy=hierarchy, **kw)
    return dict(dataclasses.asdict(rep), fields=rep.as_bench_fields(),
                launches=K.launch_counts())


def run_tree_nccl(hvd, full: bool = False) -> dict:
    """On a world of 4 (four cards over NCCL, or its gloo twin): the small
    LM of :func:`_tree_lm` for every :data:`TREE_NCCL_CASES` case, and the
    overlap probe over the ``(2, 2)`` layout, two-level, and over the
    world, flat: on the small LM, or with ``full`` on chip_smoke's 870.9M
    LM at 6 sequences of 1024 a rank (``PROBE``'s calls)."""
    import torch

    from horovod_tpu_torch.models.transformer import TransformerConfig, \
        TransformerLM
    from horovod_tpu_torch.runtime.topology import TreeLayout

    torch.set_num_threads(1)   # or the ranks oversubscribe the cores
    out = {"lm": {case: _tree_lm(hvd, case) for case in TREE_NCCL_CASES}}
    dev, rank = hvd.device(), hvd.rank()
    if full:
        from chip_smoke import FULL, PROBE, SEED, full_config

        cfg = full_config(torch, "flash")
        model = TransformerLM(cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(SEED))
        rows = FULL["batch"]
        tokens = torch.randint(0, cfg.vocab_size,
                               (rows * hvd.size(), FULL["seq"] + 1),
                               generator=torch.Generator().manual_seed(SEED))
        kw = dict(PROBE)
    else:
        cfg = TransformerConfig(dtype=torch.float32, attention_impl="flash",
                                **ADASUM_LM)
        model = TransformerLM(cfg, generator=torch.Generator().manual_seed(0))
        model.to(dev)
        rows = 2
        tokens = torch.from_numpy(adasum_lm_tokens(rows * hvd.size()))
        kw = dict(iters=2, warmup=1)
    batch = tokens[rank * rows:(rank + 1) * rows].to(dev)
    out["probe"] = {
        "two_level": _probe_report(hvd, model, batch,
                                   TreeLayout((2, 2), ("cross", "local")),
                                   "auto", **kw),
        "flat": _probe_report(hvd, model, batch, None, "flat", **kw)}
    out["trace"] = {
        "two_level": _traced_sharded_step(
            model, batch, TreeLayout((2, 2), ("cross", "local")),
            "two_level"),
        "flat": _traced_sharded_step(model, batch, None, "flat")}
    return out


def _traced_sharded_step(model, batch, axis, hierarchy: str) -> dict:
    """One step of the sharded optimizer (AdamW, ``axis``, ``hierarchy``)
    on ``model``'s LM loss, traced (``utils/trace.trace_call``): the
    recorded collectives as JSON, the level scopes of the reduce-scatters,
    the wire bytes by level over the ``(local, cross)`` tree of the
    ``(2, 2)`` layout (two-level) or the world's one level (flat) beside
    the cost model's for the payload the innermost reduce-scatters carried,
    the lint's rules and the serial tail."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.analysis import cost_model as CM
    from horovod_tpu_torch.analysis.trace_lint import lint_trace
    from horovod_tpu_torch.models.transformer import lm_loss
    from horovod_tpu_torch.utils import trace as T

    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=3e-4),
        shard_optimizer_states=True, axis=axis, hierarchy=hierarchy)

    def one():
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(model, batch)
        loss.backward()
        opt.step()
        return loss.detach()

    loss, tr = T.trace_call(one)
    levels = (("local", 2), ("cross", 2)) if hierarchy == "two_level" \
        else (("flat", hvd.size()),)
    inner = [o for o in tr.ops if o.kind == "reduce-scatter"
             and o.group_size == levels[0][1]
             and T.group_stride(o.ranks) == 1]
    payload = sum(o.bytes * o.group_size for o in inner)
    grad_bytes = sum(p.numel() * p.element_size()
                     for p in model.parameters())
    rules = [f.rule for f in lint_trace(tr, expect_hierarchy=hierarchy,
                                        grad_bytes=grad_bytes)]
    placed = [o for o in tr.ops if o.interval is not None]
    tail = max((o for o in placed if o.kind in ("reduce-scatter",
                                                "all-gather")),
               key=lambda o: o.interval[0], default=None)
    return dict(loss=float(loss), ops=[o.as_json() for o in tr.ops],
                kinds=T.count_by_kind(tr.ops), placed=len(placed),
                tail=None if tail is None else (tail.kind, tail.stream,
                                                tail.interval),
                rs_level_scopes=T.level_scopes_by_kind(tr.ops).get(
                    "reduce-scatter", ()),
                wire=CM.collective_wire_by_level(tr.ops, topology=levels),
                model_wire=CM.exchange_wire_by_level(payload, levels),
                payload=payload, grad_bytes=grad_bytes, rules=rules,
                serial_tail=T.serial_tail_collectives(tr),
                flops=tr.flops, peak=tr.memory_high_water_bytes,
                kernels=len(tr.kernels), seconds=tr.seconds)


# ---------------------------------------------------------------------------
# the structure guards over a step's record (tests/test_torch_trace_guards.py)
# ---------------------------------------------------------------------------

#: bucket caps of the guards: below the largest leaf (several buckets), and
#: above the whole payload (one bucket)
HLO_GUARD_BUCKET = 128 * 1024
ONE_BUCKET = 1 << 30
#: the traced steps of the exchange family: name -> step options
TRACE_EXCHANGE_CASES = {
    "dp": {},
    "sharded_flat": dict(shard_optimizer_states=True, hierarchy="flat",
                         exchange_bucket_bytes=ONE_BUCKET),
    "sharded_bucketed": dict(shard_optimizer_states=True, hierarchy="flat",
                             exchange_bucket_bytes=HLO_GUARD_BUCKET),
    "two_level": dict(shard_optimizer_states=True, hierarchy="two_level",
                      exchange_bucket_bytes=ONE_BUCKET),
    "two_level_int8": dict(shard_optimizer_states=True,
                           hierarchy="two_level",
                           exchange_bucket_bytes=ONE_BUCKET,
                           compression="int8"),
    "two_level_bucketed": dict(shard_optimizer_states=True,
                               hierarchy="two_level",
                               exchange_bucket_bytes=HLO_GUARD_BUCKET),
}


def hlo_guard_net():
    """``tests/test_hlo_guards.py``'s Net: Dense(256), relu, Dense(256),
    Dense(10) over 64 features, seeded."""
    import torch

    gen = torch.Generator().manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(64, 256), torch.nn.ReLU(),
                              torch.nn.Linear(256, 256),
                              torch.nn.Linear(256, 10))
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return net


def hlo_guard_loss(m, batch):
    import torch.nn.functional as F

    return F.cross_entropy(m(batch["x"]), batch["y"])


def hlo_guard_batch() -> dict:
    """The guards' global batch: 16 rows of 64 features and their labels."""
    import torch

    rng = np.random.RandomState(0)
    return {"x": torch.from_numpy(rng.randn(16, 64).astype(np.float32)),
            "y": torch.from_numpy(rng.randint(0, 10, 16).astype(np.int64))}


def _trace_record(tr, **lint) -> dict:
    """A trace as data the test process reads: its ops as JSON, the
    unwaited works and the lint's rules."""
    from horovod_tpu_torch.analysis.trace_lint import lint_trace

    return dict(ops=[o.as_json() for o in tr.ops], unwaited=tr.unwaited,
                rules=[f.rule for f in lint_trace(tr, **lint)])


def _traced_hlo_guard_step(hvd, expect=None, **kw) -> dict:
    """One traced DistributedTrainStep of :func:`hlo_guard_net` with ``kw``."""
    import torch

    model = hlo_guard_net()
    if kw.get("compression"):
        kw["compression"] = getattr(hvd.Compression, kw["compression"])
    step = hvd.DistributedTrainStep(
        hlo_guard_loss, torch.optim.SGD(model.parameters(), lr=0.1), **kw)
    model, opt = step.init(model)
    _, tr = step.trace(model, opt, step.shard_batch(hlo_guard_batch()))
    grad_bytes = sum(p.numel() * p.element_size()
                     for p in model.parameters())
    return dict(_trace_record(tr, expect_hierarchy=expect,
                              grad_bytes=grad_bytes), grad_bytes=grad_bytes)


def run_trace_exchange(hvd) -> dict:
    """On a gloo world of 4 laid out 2 x 2: one traced step of each
    :data:`TRACE_EXCHANGE_CASES` case."""
    import torch

    torch.set_num_threads(1)
    out = {}
    for name, kw in TRACE_EXCHANGE_CASES.items():
        expect = kw.get("hierarchy")
        out[name] = _traced_hlo_guard_step(hvd, expect=expect, **kw)
    return out


def run_trace_model_parallel(hvd) -> dict:
    """On a gloo world of 4: the recorded collectives of an fsdp step
    (``plan="fsdp=4"``), a tp block's forward (ColumnParallelDense →
    RowParallelDense over tp = 4), the sp ring attention's forward and
    backward (sp = 4), an sp step of the ring LM (``plan="sp=4"``), and the
    expert exchange fused and unfused (ep = 4)."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.models import transformer as TT
    from horovod_tpu_torch.ops.fused_collectives import expert_alltoall_ffn
    from horovod_tpu_torch.parallel.mesh import make_parallel_mesh
    from horovod_tpu_torch.parallel.ring_attention import ring_attention
    from horovod_tpu_torch.utils import trace as T

    torch.set_num_threads(1)
    out = {}
    w, batch = fsdp_setup()
    model = _fsdp_mlp()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in w.items()})
    step = hvd.DistributedTrainStep(
        lambda m, b: torch.mean((m(b["x"]) - b["y"]) ** 2),
        torch.optim.SGD(model.parameters(), lr=0.1), plan="fsdp=4",
        fsdp_min_weight_size=1)
    model, opt = step.init(model)
    _, tr = step.trace(model, opt, step.shard_batch(
        {k: torch.from_numpy(v) for k, v in batch.items()}))
    out["fsdp"] = dict(_trace_record(tr), grad_bytes=sum(
        v.nbytes for v in w.values()))

    tp = tp_mlp(make_parallel_mesh(tp=4).group("tp"))
    x = torch.from_numpy(mp_mlp_batch()["x"])
    with T.record_collectives() as rec:
        y = tp(x)
    out["tp"] = dict(ops=[o.as_json() for o in rec.ops],
                     out_bytes=y.numel() * y.element_size())

    rng = np.random.RandomState(hvd.rank())
    q, k, v = (torch.from_numpy(rng.randn(2, 16, 4, 16).astype(np.float32))
               .requires_grad_() for _ in range(3))
    with T.record_collectives() as rec:
        o = ring_attention(q, k, v, dist.group.WORLD, causal=False)
    with T.record_collectives() as bwd:
        torch.autograd.grad(o.sum(), (q, k, v))
    out["sp_ring"] = dict(ops=[o.as_json() for o in rec.ops],
                          bwd=[o.as_json() for o in bwd.ops])

    mesh = make_parallel_mesh(sp=4)
    cfg = TT.TransformerConfig(dtype=torch.float32, attention_impl="ring",
                               **SP_TRAIN_SIZES)
    lm = TT.TransformerLM(cfg, generator=torch.Generator().manual_seed(0),
                          sp_group=mesh.group("sp"))

    def sp_loss(m, b):
        t = b["inputs"].shape[1]
        logits = m(b["inputs"], mesh.index("sp") * t + torch.arange(t))
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), b["labels"].reshape(-1))

    step = hvd.DistributedTrainStep(
        sp_loss, torch.optim.SGD(lm.parameters(), lr=0.1), plan="sp=4",
        mesh=mesh)
    lm, opt = step.init(lm)
    rows = torch.from_numpy(sp_train_rows())
    _, tr = step.trace(lm, opt, step.shard_batch(
        {"inputs": rows[:, :-1], "labels": rows[:, 1:]}))
    out["sp_step"] = dict(_trace_record(tr), sp=tr.sp)

    disp, w1, w2 = (torch.from_numpy(a[hvd.rank()])
                    for a in ring_expert_inputs(hvd.size()))

    def expert_fn(t):
        return torch.einsum("ecf,efd->ecd", torch.relu(
            torch.einsum("ecd,edf->ecf", t, w1)), w2)

    for fused in (True, False):
        with torch.no_grad(), T.record_collectives() as rec:
            expert_alltoall_ffn(disp, expert_fn, dist.group.WORLD,
                                fused=fused, params=(w1, w2))
        out["ep_fused" if fused else "ep_unfused"] = dict(
            ops=[o.as_json() for o in rec.ops])
    return out


def run_trace_tree(hvd) -> dict:
    """On a gloo world of 8 laid out 2 x 4: one traced sharded step of
    :func:`hlo_guard_net` two-level (auto) and flat, and one traced step of the
    sharded optimizer over ``TreeLayout((2, 2, 2))``, fp32 and with the
    int8 wire on its outermost level, each in one bucket."""
    import torch

    from horovod_tpu_torch.runtime.topology import TreeLayout
    from horovod_tpu_torch.utils import trace as T

    torch.set_num_threads(1)
    out = {"two_level": _traced_hlo_guard_step(
               hvd, expect="two_level", shard_optimizer_states=True,
               exchange_bucket_bytes=ONE_BUCKET),
           "flat": _traced_hlo_guard_step(
               hvd, expect="flat", shard_optimizer_states=True,
               hierarchy="flat", exchange_bucket_bytes=ONE_BUCKET)}
    for name, kw in (("tree", {}), ("tree_int8",
                                     {"compression": hvd.Compression.int8})):
        model = hlo_guard_net()
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            shard_optimizer_states=True,
            axis=TreeLayout(TREE_SHAPE, TREE_NAMES), hierarchy="tree",
            exchange_bucket_bytes=ONE_BUCKET, **kw)
        batch = {k: v[hvd.rank() * 2:(hvd.rank() + 1) * 2]
                 for k, v in hlo_guard_batch().items()}

        def one():
            opt.zero_grad(set_to_none=True)
            hlo_guard_loss(model, batch).backward()
            opt.step()

        _, tr = T.trace_call(one)
        out[name] = _trace_record(tr)
    return out
