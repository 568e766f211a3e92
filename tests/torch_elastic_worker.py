"""The training script of the port's elastic end-to-end tests, launched
by ``python -m horovod_tpu_torch.runner --host-discovery-script ...``
(the JAX package's ``tests/test_elastic_e2e.py`` script, over the port).

Epochs of batches; rank 0 appends one JSON line per epoch (the line
count drives the discovery script); the state commits every batch; a
scheduled exit raises or kills itself on a chosen (epoch, batch,
start_rank).  ``--model lm`` trains a ``TransformerLM`` under
``TorchState`` on the card (the four-card tests; ``--device cpu``: a
narrow twin on gloo) instead of the one ``ObjectState`` vector, through
the hook path or, with ``--sharded``, the sharded exchange; every rank
then appends its loss, its step's seconds (the batch, forward, backward
and ``step()``, up to the card's last kernel) and its reset seconds to
``--rank-logfile``.  ``--model zero`` trains the degrade
scenario of ``torch_port_workers.DEGRADE`` (sharded momentum and
error-feedback residual, a checkpoint every step in ``--ckpt-dir``) at
the plan ``HOROVOD_PLAN`` names: each entry of ``train`` re-slices the
last committed step's shards to the world's plan (``reshard_restore``)
and accumulates as ``preserve_global_batch`` says; every rank logs each
step's loss, plan and accumulation.
"""

import argparse
import json
import os
import sys
import time

p = argparse.ArgumentParser()
p.add_argument("--logfile", required=True)
p.add_argument("--epochs", type=int, default=3)
p.add_argument("--batches-per-epoch", type=int, default=2)
p.add_argument("--discovery-schedule", default="[]")
p.add_argument("--exit-schedule", default="{}")
p.add_argument("--exit-mode", default="exception")
p.add_argument("--discovery-wait", type=int, default=30)
p.add_argument("--rank-logfile", default="")
p.add_argument("--model", default="vector", choices=("vector", "lm", "zero"))
p.add_argument("--ckpt-dir", default="",
               help="--model zero: the sharded checkpoints' directory")
p.add_argument("--device", default="",
               help="--model zero: cpu (default) or cuda; --model lm: cuda "
                    "(default) or cpu, where the LM is a narrow twin")
p.add_argument("--sharded", action="store_true",
               help="--model lm: the sharded exchange "
                    "(shard_optimizer_states=True) in place of the hook path")
p.add_argument("--hosts", default="",
               help="comma-separated host names, in the order that maps "
                    "each host's slots to its block of cards")
p.add_argument("--slots", type=int, default=1)
args = p.parse_args()

hostname = os.environ.get("HOROVOD_HOSTNAME")
start_rank = int(os.environ.get("HOROVOD_RANK", 0))
on_card = (args.model == "lm" and args.device != "cpu") or \
    args.device == "cuda"
if on_card:
    # two host names on one machine: both hosts' slots have local ranks
    # 0..slots-1, and init() takes cuda:<local_rank>; list this host's
    # block of cards first so that cuda:<local_rank> is a card no other
    # host's slot takes
    host_index = args.hosts.split(",").index(hostname)
    cards = list(range(4))
    mine = cards[host_index * args.slots:(host_index + 1) * args.slots]
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(
        str(c) for c in mine + [c for c in cards if c not in mine])

import numpy as np  # noqa: E402
import torch  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402

torch.set_num_threads(1)
device = "cuda" if on_card else "cpu"
if device == "cuda":
    # build the kernels before any collective: a rank that builds while a
    # peer waits in a collective would outlast the elastic timeout
    from horovod_tpu_torch.ops.build import load_library

    load_library()
hvd.init(device=device)
if device == "cuda":
    rank_log_env = {k: os.environ.get(k) for k in (
        "TORCH_NCCL_ASYNC_ERROR_HANDLING", "TORCH_NCCL_BLOCKING_WAIT",
        "TORCH_NCCL_HEARTBEAT_TIMEOUT_SEC", "NCCL_ASYNC_ERROR_HANDLING")}
    print(f"env {rank_log_env} torch {torch.__version__}", flush=True)

discovery_schedule = json.loads(args.discovery_schedule)
epoch_to_hosts = {e: h for e, h in discovery_schedule if e is not None}
default_hosts = discovery_schedule[-1][1] if discovery_schedule else []
exit_schedule = json.loads(args.exit_schedule)


def check_exit(epoch, batch):
    key = f"{epoch},{batch}"
    if key in exit_schedule and start_rank in exit_schedule[key]:
        print(f"planned exit epoch={epoch} batch={batch} "
              f"start_rank={start_rank} mode={args.exit_mode}", flush=True)
        rank_log({"event": "kill", "start_rank": start_rank})
        if args.exit_mode == "exception":
            raise RuntimeError("planned worker failure")
        os.kill(os.getpid(), 9)


def log_state(state, w):
    with open(args.logfile, "a") as f:
        f.write(json.dumps({
            "epoch": state.epoch,
            "hostname": hostname,
            "start_rank": start_rank,
            "rank": hvd.process_rank(),
            "size": hvd.process_count(),
            "rendezvous": state.rendezvous,
            "w": w,
        }) + os.linesep)


def rank_log(record):
    if args.rank_logfile:
        # O_APPEND line writes are atomic at this size
        with open(args.rank_logfile, "a") as f:
            f.write(json.dumps(dict(record, t=time.time())) + os.linesep)


def lm_parts():
    """The 870.9M LM's width (d 2048, 16 heads, vocab 32000) at 4 layers,
    seeded, on the card (a narrow fp32 twin on the CPU); AdamW; the
    exchange (the hook path, or with ``--sharded`` the sharded one) built
    anew each generation."""
    from horovod_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        lm_loss,
    )

    if on_card:
        cfg = TransformerConfig(vocab_size=32000, num_layers=4,
                                num_heads=16, d_model=2048, d_ff=8192,
                                max_seq_len=1024, dtype=torch.bfloat16,
                                attention_impl="flash")
    else:
        cfg = TransformerConfig(vocab_size=128, num_layers=2, num_heads=2,
                                d_model=64, d_ff=128, max_seq_len=32,
                                dtype=torch.float32, attention_impl="flash")
    dev = hvd.device()
    model = TransformerLM(cfg, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(0))
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=1e-4)
    return model, opt, lm_loss


if args.model == "lm":
    model, inner, lm_loss = lm_parts()
    box = {}

    def rebuild():
        box["opt"] = hvd.DistributedOptimizer(
            inner, named_parameters=model.named_parameters(),
            shard_optimizer_states=args.sharded)

    rebuild()
    state = hvd.elastic.TorchState(model, inner, epoch=0, batch=0,
                                   rendezvous=0)
    state.register_reset_callbacks([rebuild])
else:
    state = hvd.elastic.ObjectState(params=np.zeros(2), epoch=0, batch=0,
                                    rendezvous=0)
zero = {}


def zero_enter(state):
    """``--model zero`` at each entry of ``train``: this world's plan (the
    driver's, through ``HOROVOD_PLAN``), and w and this rank's slices of
    m and r at the last committed step, re-sliced from the checkpoint."""
    from horovod_tpu_torch.checkpoint import Checkpointer
    from horovod_tpu_torch.elastic.degrade import reshard_restore
    from horovod_tpu_torch.parallel.plan import ShardingPlan
    from torch_port_workers import DEGRADE

    n = hvd.size()
    plan = ShardingPlan.from_string(
        os.environ.get("HOROVOD_PLAN") or f"dp={n}").resolve(n)
    ckpt = Checkpointer(args.ckpt_dir)
    shard = DEGRADE["width"] // n
    gstep = state.epoch * args.batches_per_epoch + state.batch
    if gstep:
        w = ckpt.restore(step=gstep)["w"]
        st = reshard_restore(ckpt, {"m": torch.zeros(shard),
                                    "r": torch.zeros(shard)},
                             hvd.rank(), plan, step=gstep)
        m, r = st["m"], st["r"]
    else:
        w = torch.full((DEGRADE["width"],), 1.5)
        m, r = torch.zeros(shard), torch.zeros(shard)
    dev = hvd.device()
    zero.update(plan=plan, ckpt=ckpt, w=w.to(dev), m=m.to(dev), r=r.to(dev))


def zero_step(state):
    from torch_port_workers import degrade_train

    gstep = state.epoch * args.batches_per_epoch + state.batch + 1
    zero["w"], zero["m"], zero["r"], losses, accum = degrade_train(
        hvd, zero["plan"], zero["ckpt"], zero["w"], zero["m"], zero["r"],
        [gstep], save_every=1)
    rank_log({"event": "zero_step", "gstep": gstep, "loss": losses[0],
              "plan": zero["plan"].to_string(), "accum": accum,
              "rank": hvd.rank(), "size": hvd.size()})


def lm_batch(state):
    """Each rank's rows of one seeded global batch of 8 sequences of 256
    tokens (16 on the CPU), by (epoch, batch)."""
    g = torch.Generator().manual_seed(1000 * state.epoch + state.batch)
    cfg = model.cfg
    tokens = torch.randint(0, cfg.vocab_size,
                           (8, min(256, cfg.max_seq_len // 2) + 1),
                           generator=g)
    rows = tokens.shape[0] // hvd.size()
    return tokens[hvd.rank() * rows:(hvd.rank() + 1) * rows].to(
        hvd.device())


@hvd.elastic.run
def train(state):
    from horovod_tpu_torch.elastic import state as elastic_state

    state.rendezvous += 1
    rank_log({"event": "rendezvous", "start_rank": start_rank,
              "rank": hvd.process_rank(), "size": hvd.process_count(),
              "rendezvous": state.rendezvous,
              "package": os.path.dirname(hvd.__file__),
              "reset_s": elastic_state.last_reset_s,
              "failure_t": elastic_state.last_failure_t,
              "commit_s": getattr(state, "last_commit_s", None)})
    if args.model == "zero":
        zero_enter(state)
    while state.epoch < args.epochs:
        while state.batch < args.batches_per_epoch:
            check_exit(state.epoch, state.batch)
            if args.model == "lm":
                t0 = time.perf_counter()
                opt = box["opt"]
                opt.zero_grad()
                loss = lm_loss(model, lm_batch(state))
                loss.backward()
                opt.step()
                if on_card:
                    torch.cuda.synchronize()
                rank_log({"event": "step", "epoch": state.epoch,
                          "batch": state.batch, "start_rank": start_rank,
                          "rank": hvd.process_rank(),
                          "size": hvd.process_count(),
                          "loss": float(loss.detach()),
                          "step_s": time.perf_counter() - t0})
            elif args.model == "zero":
                zero_step(state)
            else:
                grad = hvd.allreduce(torch.ones(2), op=hvd.Average,
                                     name="grad")
                state.params = state.params + grad.numpy()
            state.batch += 1
            state.commit()
            if args.model == "lm":
                rank_log({"event": "commit",
                          "gstep": state.epoch * args.batches_per_epoch +
                          state.batch, "rank": hvd.process_rank(),
                          "size": hvd.process_count(),
                          "rendezvous": state.rendezvous,
                          "check": repr(sum(float(p.detach().double().sum())
                                            for p in model.parameters()))})
        rank_log({"epoch": state.epoch, "start_rank": start_rank,
                  "rank": hvd.process_rank(), "size": hvd.process_count()})
        if hvd.process_rank() == 0:
            w = round(float(state.params[0]), 4) if args.model == "vector" \
                else round(float(model.ln_f.scale.float().sum()), 4) \
                if args.model == "lm" else round(float(zero["w"].sum()), 4)
            log_state(state, w)
            cur = epoch_to_hosts.get(state.epoch, default_hosts)
            nxt = epoch_to_hosts.get(state.epoch + 1, default_hosts)
            if cur != nxt:
                # wait for the driver to observe the logfile-driven host
                # change so the interrupt lands at this epoch boundary
                t0 = time.time()
                while state._host_messages.empty():
                    if time.time() - t0 > args.discovery_wait:
                        raise TimeoutError("no host-change notification")
                    time.sleep(0.1)
        state.epoch += 1
        state.batch = 0
        state.commit()


train(state)
rank_log({"event": "done", "start_rank": start_rank})
print(f"worker done start_rank={start_rank}", flush=True)
sys.stdout.flush()
