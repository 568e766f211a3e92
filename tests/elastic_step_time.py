"""Step times of the elastic sharded LM with no fault, for one or more
checkouts of the port in turn.

Each run is one launch of ``python -m horovod_tpu_torch.runner`` over two
host names of two slots each (``tests/torch_elastic_worker.py --model lm
--sharded``: the 870.9M LM's width at 4 layers under ``TorchState``,
AdamW through ``DistributedOptimizer(shard_optimizer_states=True)``, a
commit after every batch), as ``test_torch_gpu.py``'s
``test_sharded_kill_over_nccl`` launches it, but with no rank killed.
Each step is timed on its rank from its batch to the card's last kernel
of ``step()`` (the commit that follows is not in it).  The launcher and
the workers import the package of the checkout a run names, and every
run uses this checkout's worker, so two checkouts compare on the same
script::

    python tests/elastic_step_time.py --roots OLD NEW NEW OLD

On four cards it needs no argument but ``--roots``; ``--device cpu``
runs the narrow twin on gloo.  Prints one JSON line a run: the root, the
card's name and power limit, each rank's step seconds, and the median
over every rank of the steps after each rank's first ``--skip``.
"""

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from test_torch_elastic_e2e import REPO, run_elastic  # noqa: E402


def card_name() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "no card"


def one_run(root: str, args) -> dict:
    with tempfile.TemporaryDirectory(prefix="hvd_step_time_") as tmp:
        run = run_elastic(
            pathlib.Path(tmp), [(None, ["localhost:2", "127.0.0.1:2"])],
            np=4, min_np=4, max_np=4, epochs=args.epochs,
            timeout=args.timeout,
            extra_env={"HOROVOD_ELASTIC_HEARTBEAT_TIMEOUT": "10",
                       "HOROVOD_ELASTIC_START_TIMEOUT": "300",
                       "HOROVOD_QUARANTINE_DISABLE": "1"},
            worker_args=("--model", "lm", "--sharded", "--hosts",
                         "localhost,127.0.0.1", "--slots", "2",
                         "--batches-per-epoch", str(args.batches),
                         *(("--device", "cpu") if args.device == "cpu"
                           else ())),
            root=root)
    if run["rc"] != 0:
        sys.stderr.write(run["stderr"][-3000:] + run["logs"][-3000:])
        raise SystemExit(f"the run of {root} ended with {run['rc']}")
    packages = {r["package"] for r in run["ranks"]
                if r.get("event") == "rendezvous"}
    if not packages or any(not p.startswith(root + os.sep)
                           for p in packages):
        raise SystemExit(f"the run of {root} imported {packages}")
    steps: dict = {}
    for r in run["ranks"]:
        if r.get("event") == "step":
            steps.setdefault(r["start_rank"], []).append(r["step_s"])
    kept = [s for times in steps.values() for s in times[args.skip:]]
    return {"root": root, "package": sorted(packages),
            "card": card_name(), "device": args.device,
            "steps_by_rank": {str(k): v for k, v in sorted(steps.items())},
            "skip": args.skip,
            "median_step_s": statistics.median(kept) if kept else None}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--roots", nargs="+", default=[REPO],
                   help="the checkouts to run, in turn")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batches", type=int, default=6,
                   help="batches an epoch")
    p.add_argument("--skip", type=int, default=2,
                   help="each rank's first steps left out of the median")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--timeout", type=float, default=400.0)
    args = p.parse_args()
    for root in args.roots:
        print(json.dumps(one_run(os.path.abspath(root), args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
