"""``python -m horovod_tpu_torch.runner`` == ``hvdrun`` for the port."""

from horovod_tpu_torch.runner.launch import main

if __name__ == "__main__":
    main()
