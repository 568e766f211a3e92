"""``python -m horovod_tpu_torch.runner.probe_task <driver_addrs> <index>
[key]`` — the per-host NIC probe task (``horovod_tpu/runner/probe_task.py``;
reference ``python -m horovod.runner.task_fn``).  The HMAC key arrives as
an argument because ssh does not forward environment variables (the
reference ships its settings, key included, base64-encoded in the remote
command); the env var is the fallback for local spawns."""

import os
import sys

from horovod_tpu_torch.runner.driver_service import run_probe_task


def main() -> None:
    driver_addrs, index = sys.argv[1], int(sys.argv[2])
    key = sys.argv[3] if len(sys.argv) > 3 else \
        os.environ.get("HOROVOD_SECRET_KEY")
    run_probe_task(driver_addrs, index, key)


if __name__ == "__main__":
    main()
