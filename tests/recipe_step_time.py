"""Phase 4's step time for one or more checkouts of the port in turn.

Each run is a fresh process in the checkout's root (its ``chip_smoke.py``
and its ``horovod_tpu_torch``) that takes ``chip_smoke.recipe``: the
seeded 870.9M TransformerLM at full width, batch 6 x 1024, bf16, flash,
``DistributedOptimizer(AdamW)`` on the hook path at a world of one, on one
card.  Every run loads the kernels from one store
(``HOROVOD_COMPILE_CACHE_DIR``, a temporary directory: checkouts with the
same sources share one library, built once).  Two checkouts compare on the
same card in turns::

    python tests/recipe_step_time.py --roots OLD NEW NEW OLD

Prints one JSON line a run: the root, the card's name and power limit,
each step's seconds (to the loss on the host) and host seconds (to the
call's return), the median of the steps after the first ``--skip``, and
the kernels' launches a step.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

RUN = """
import json, sys, torch
import chip_smoke
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import build

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.load_library()
hvd.init()
r = chip_smoke.recipe(torch, hvd, steps={steps})
print(json.dumps({{"times": r["times"], "host": r["host"],
                  "counts": r["counts"], "package": hvd.__file__}}))
hvd.shutdown()
"""


def card_name() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "no card"


def one_run(root: str, store: str, args) -> dict:
    root = os.path.abspath(root)
    env = dict(os.environ, PYTHONPATH=root, HOROVOD_COMPILE_CACHE_DIR=store)
    proc = subprocess.run([sys.executable, "-c", RUN.format(
        steps=args.steps)], cwd=root, env=env, capture_output=True,
        text=True, timeout=args.timeout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-3000:] + proc.stderr[-3000:])
        raise SystemExit(f"the run of {root} ended with {proc.returncode}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    if not out["package"].startswith(root + os.sep):
        raise SystemExit(f"the run of {root} imported {out['package']}")
    kept = out["times"][args.skip:]
    return {"root": root, "card": card_name(), "step_s": out["times"],
            "host_s": out["host"], "skip": args.skip,
            "median_step_ms": 1e3 * statistics.median(kept),
            "launches_a_step": {k: v / len(out["times"])
                                for k, v in out["counts"].items() if v}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--skip", type=int, default=1)
    ap.add_argument("--timeout", type=float, default=600)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory(prefix="hvd_recipe_store_") as store:
        for root in args.roots:
            print(json.dumps(one_run(root, store, args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
