"""Gradient compression for collectives (``horovod_tpu/ops/compression.py``).

A ``Compressor`` has ``compress(tensor) -> (tensor, ctx)`` and
``decompress(tensor, ctx)``, as in the reference's
``horovod/torch/compression.py``.  The casting compressors go through the
:func:`~horovod_tpu_torch.ops.kernels.fused_scale` kernel, and carry their
``wire_dtype`` so that the exchange folds the cast into its prescale pass
over each bucket instead of casting every gradient first.
"""

from __future__ import annotations

from typing import Optional

import torch

from horovod_tpu_torch.ops.kernels import fused_scale


class Compressor:
    #: the dtype floating tensors travel in, or None for no cast
    wire_dtype: Optional[torch.dtype] = None

    @classmethod
    def compress(cls, tensor):
        if cls.wire_dtype is None or not tensor.is_floating_point():
            return tensor, None
        return fused_scale(tensor, 1.0, cls.wire_dtype), tensor.dtype

    @staticmethod
    def decompress(tensor, ctx):
        if ctx is None or tensor.dtype == ctx:
            return tensor
        return fused_scale(tensor, 1.0, ctx)


class NoneCompressor(Compressor):
    """Identity (reference ``NoneCompressor``)."""


class FP16Compressor(Compressor):
    """Cast float tensors to fp16 for the wire, back to their dtype after
    (reference ``FP16Compressor``)."""

    wire_dtype = torch.float16


class BF16Compressor(Compressor):
    """bfloat16 on the wire: fp32's exponent range at half the bytes."""

    wire_dtype = torch.bfloat16


class Compression:
    """Namespace matching the reference's ``Compression`` selector."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
