"""Worker-side bootstrap for :func:`horovod_tpu_torch.runner.run`
(``horovod_tpu/runner/run_task.py``; reference
``horovod/runner/task_fn.py`` role)."""

from horovod_tpu_torch.runner.api import _task_main

if __name__ == "__main__":
    _task_main()
