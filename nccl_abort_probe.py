"""A dead peer over NCCL, and what aborting the dead world's groups takes
(four cards).

    python3 nccl_abort_probe.py OUT_DIR aeh0,aeh2long,aeh2

Four ranks all-reduce a 32 MiB bf16 buffer on a side stream, as the hook
path does; rank 3 SIGKILLs itself at iteration 5.  Each survivor waits for
its all-reduce with a 10 s host deadline (polling an event recorded after
it), then aborts every group (``c10d._abort_process_group()``) in a thread
(25 s allowed; else the threads' Python stacks go to
``OUT_DIR/<variant>.<rank>.stacks`` and the rank exits with code 3), makes
a new world of the three survivors on a fresh store, all-reduces once in
it, destroys it and exits.  The variants set
``TORCH_NCCL_ASYNC_ERROR_HANDLING`` and the groups' timeout: ``aeh0``
(0, 10 s), ``aeh2`` (2, 10 s: NCCL's watchdog catches the timeout as the
host's deadline passes), ``aeh2long`` (2, 60 s: the host aborts before
the watchdog catches it).  Prints one JSON line a variant: each
survivor's seconds from the kill to detection and to exit, the abort's
seconds or its hang, the new world's sum (3.0) and the exit code.
Needs four cards; imports torch only."""

import datetime
import faulthandler
import json
import os
import signal
import sys
import threading
import time

WORLD = 4


def worker(rank, port, port2, variant, out_dir):
    os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = variant["aeh"]
    import torch
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    name = variant["name"]
    log = open(os.path.join(out_dir, f"{name}.{rank}.jsonl"), "a")
    stacks = open(os.path.join(out_dir, f"{name}.{rank}.stacks"), "w")

    def rec(**kw):
        log.write(json.dumps(dict(kw, t=time.time())) + "\n")
        log.flush()

    torch.cuda.set_device(rank)
    store = dist.TCPStore("127.0.0.1", port, None, False,
                          timeout=datetime.timedelta(seconds=60))
    dist.init_process_group("nccl", store=store, world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    host = dist.new_group(backend="gloo")
    for g in (dist.group.WORLD, host):
        c10d._set_pg_timeout(datetime.timedelta(seconds=variant["pg_s"]), g)
    x = torch.randn(16 * 1024 * 1024, device="cuda", dtype=torch.bfloat16)
    side = torch.cuda.Stream()
    cur = torch.cuda.current_stream()
    rec(ev="ready")
    try:
        for i in range(40):
            if rank == 3 and i == 5:
                rec(ev="kill")
                os.kill(os.getpid(), signal.SIGKILL)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                dist.all_reduce(x)
                x.mul_(0.25)
            ev = torch.cuda.Event()
            ev.record(side)
            deadline = time.monotonic() + 10.0
            while not ev.query():
                if time.monotonic() > deadline:
                    raise TimeoutError("exchange past its deadline")
                time.sleep(0.001)
            cur.wait_stream(side)
            dist.barrier(group=host)
    except BaseException as e:  # noqa: BLE001
        rec(ev="error", err=f"{type(e).__name__}: {str(e)[:200]}")
    done = threading.Event()
    t0 = time.time()

    def abort():
        try:
            c10d._abort_process_group()
            rec(ev="aborted", s=time.time() - t0)
        except BaseException as e:  # noqa: BLE001
            rec(ev="abort_error", err=f"{type(e).__name__}: {e}",
                s=time.time() - t0)
        done.set()

    threading.Thread(target=abort, daemon=True).start()
    if not done.wait(25):
        rec(ev="abort_hang")
        faulthandler.dump_traceback(file=stacks, all_threads=True)
        stacks.flush()
        os._exit(3)
    # a new world of the three survivors on a fresh store
    try:
        store2 = dist.TCPStore("127.0.0.1", port2, None, False,
                               timeout=datetime.timedelta(seconds=60))
        dist.init_process_group("nccl", store=store2, world_size=3,
                                rank=rank,
                                timeout=datetime.timedelta(seconds=30))
        y = torch.ones(4, device="cuda")
        dist.all_reduce(y)
        rec(ev="new_world", sum=float(y[0]))
        dist.destroy_process_group()
        rec(ev="destroyed")
    except BaseException as e:  # noqa: BLE001
        rec(ev="new_world_error", err=f"{type(e).__name__}: {str(e)[:200]}")
    rec(ev="exit")


def main():
    import multiprocessing as mp

    import torch
    import torch.distributed as dist

    if torch.cuda.device_count() < WORLD:
        print(f"nccl_abort_probe needs {WORLD} CUDA cards", file=sys.stderr)
        return 1
    out_dir = sys.argv[1]
    os.makedirs(out_dir, exist_ok=True)
    variants = {"aeh0": {"name": "aeh0", "aeh": "0", "pg_s": 10},
                "aeh2long": {"name": "aeh2long", "aeh": "2", "pg_s": 60},
                "aeh2": {"name": "aeh2", "aeh": "2", "pg_s": 10}}
    ctx = mp.get_context("spawn")
    for name in sys.argv[2].split(","):
        v = variants[name]
        store = dist.TCPStore("0.0.0.0", 0, None, True,
                              timeout=datetime.timedelta(seconds=60),
                              wait_for_workers=False)
        store2 = dist.TCPStore("0.0.0.0", 0, None, True,
                               timeout=datetime.timedelta(seconds=60),
                               wait_for_workers=False)
        t_start = time.time()
        procs = [ctx.Process(target=worker,
                             args=(r, store.port, store2.port, v, out_dir))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        exits = {}
        deadline = time.time() + 75
        while time.time() < deadline and len(exits) < WORLD:
            for r, p in enumerate(procs):
                if r not in exits and p.exitcode is not None:
                    exits[r] = (time.time(), p.exitcode)
            time.sleep(0.2)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        recs = {}
        for r in range(WORLD):
            path = os.path.join(out_dir, f"{name}.{r}.jsonl")
            recs[r] = [json.loads(line) for line in open(path)] \
                if os.path.exists(path) else []
        kill_t = next((x["t"] for x in recs[3] if x["ev"] == "kill"), None)
        summary = {"variant": name}
        for r in range(3):
            evs = {x["ev"]: x for x in recs[r]}
            summary[r] = {
                "events": [x["ev"] for x in recs[r]],
                "detect_s": round(evs["error"]["t"] - kill_t, 2)
                if "error" in evs and kill_t else None,
                "abort_s": evs.get("aborted", {}).get("s"),
                "abort_hang": "abort_hang" in evs,
                "new_world": evs.get("new_world", {}).get("sum"),
                "errors": [x.get("err") for x in recs[r] if "err" in x],
                "exit_s": round(exits[r][0] - kill_t, 2)
                if r in exits and kill_t else None,
                "exitcode": exits.get(r, (None, "alive"))[1]}
        print(json.dumps(summary), flush=True)
        print(f"variant {name} took {time.time() - t_start:.1f} s",
              flush=True)
        del store, store2
    return 0


if __name__ == "__main__":
    sys.exit(main())
