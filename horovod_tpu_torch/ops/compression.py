"""Gradient compression for collectives (``horovod_tpu/ops/compression.py``).

A ``Compressor`` has ``compress(tensor) -> (tensor, ctx)`` and
``decompress(tensor, ctx)``, as in the reference's
``horovod/torch/compression.py``.  The casting compressors go through the
:func:`~horovod_tpu_torch.ops.kernels.fused_scale` kernel, and carry their
``wire_dtype`` so that the exchange folds the cast into its prescale pass
over each bucket instead of casting every gradient first.
``Compression.int8`` is no compressor but a marker that the reduction
layers route through the shared-scale quantized codec
(:func:`~horovod_tpu_torch.ops.collectives.quantized_allreduce`).
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


class Int8WireReduction:
    """Marker selecting the quantized *wire reduction*
    (``horovod_tpu/ops/compression.py`` ``Int8WireReduction``), not a
    ``Compressor``: the reduction runs between quantizing and
    dequantizing, after the ranks agree on a shared scale, because int8
    payloads with per-rank scales would overflow and mis-scale when
    summed.  ``grouped_allreduce``, ``distributed_gradients`` and the
    sharded exchange route float groups through
    :func:`~horovod_tpu_torch.ops.collectives.quantized_allreduce` /
    ``quantized_reducescatter`` (int8, or fp8 e4m3 under
    ``HOROVOD_EXCHANGE_WIRE_DTYPE``).  As in the JAX package, the sum
    runs in int32 (int8) or fp32 (fp8), so the wire carries 4 bytes an
    element: the codec rounds, it does not shrink the wire."""

    wire_reduce_bits = 8


class Compression:
    """Namespace matching the reference's ``Compression`` selector."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8WireReduction
