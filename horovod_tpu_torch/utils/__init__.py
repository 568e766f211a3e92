"""Measurement utilities of the PyTorch port (``horovod_tpu/utils``)."""
