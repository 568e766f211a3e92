"""ResNet v1.5 (``horovod_tpu/models/resnet.py``).

The same network as the flax model: bottleneck blocks with the stride in
the 3x3 conv, XLA's ``SAME`` padding, flax's BatchNorm (momentum 0.9, eps
1e-5, fp32 statistics, the result in ``dtype``), optional bf16 compute
with fp32 parameters, and the TPU stem's 2x2 space-to-depth variant.

The model takes NHWC images, as the JAX package does, and runs its convs on
``torch.channels_last`` tensors, so that the NHWC view the fused segment's
kernel takes (:func:`~horovod_tpu_torch.ops.kernels.fused_conv_bn_relu`)
costs no transpose.  Module and parameter names follow the flax tree
(``BottleneckBlock_3/Conv_1/kernel`` is ``BottleneckBlock_3.Conv_1.weight``,
OIHW; ``batch_stats/bn_init/mean`` is ``bn_init.mean``), so
:func:`horovod_tpu_torch.models.convert.variables_from_flax` maps one onto
the other.

BatchNorm's running ``mean`` and ``var`` are parameters, not buffers: the
JAX bench hands the whole variable tree to its training step, which
differentiates them in inference mode (``train=False``) and lets SGD move
them.  The fused segments give them zero gradients, as in the JAX package.
``train=True`` normalises with batch statistics and updates the running
statistics in place (flax's ``mutable=["batch_stats"]``).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.ops.kernels import fused_conv_bn_relu


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial dim: (low, high), the extra
    pixel on the high side (PyTorch's symmetric ``padding`` differs for a
    3x3 stride-2 conv on an even input)."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Bias-free conv as flax ``nn.Conv(use_bias=False, dtype=dtype)``:
    input and fp32 weight cast to ``dtype``.  ``padding`` is ``"SAME"`` or
    explicit ``((top, bottom), (left, right))``."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding="SAME", dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel,
                                               device=device))

    def forward(self, x):
        k = self.weight.shape[-1]
        if self.padding == "SAME":
            (t, b), (l, r) = (same_padding(x.shape[2], k, self.stride),
                              same_padding(x.shape[3], k, self.stride))
        else:
            (t, b), (l, r) = self.padding
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype)
        if t == b and l == r:
            return F.conv2d(x, w, stride=self.stride, padding=(t, l))
        x = F.pad(x, (l, r, t, b)).contiguous(memory_format=torch.channels_last)
        return F.conv2d(x, w, stride=self.stride)


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=dtype)`` over
    NCHW: statistics in fp32 (``E[x²] − E[x]²``, clipped at 0), normalised
    in fp32, the result in ``dtype``.  The running update uses the biased
    batch variance, as flax does."""

    def __init__(self, c: int, dtype: torch.dtype = torch.float32,
                 scale_init: float = 1.0, momentum: float = 0.9,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.dtype, self.momentum, self.eps = dtype, momentum, eps
        self.scale_init = scale_init
        self.scale = nn.Parameter(torch.empty(c, device=device))
        self.bias = nn.Parameter(torch.empty(c, device=device))
        self.mean = nn.Parameter(torch.empty(c, device=device))
        self.var = nn.Parameter(torch.empty(c, device=device))

    def forward(self, x, train: bool):
        x32 = x.float()
        if train:
            mu = x32.mean((0, 2, 3))
            var = (x32.square().mean((0, 2, 3)) - mu.square()).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mu)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mu, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (x32 - _channel(mu)) * _channel(mul) + _channel(self.bias)
        return y.to(self.dtype)


class FusedConvBnRelu3x3(nn.Module):
    """The block's stride-1 3x3 segment, ``relu(bn_inference(conv3x3))``,
    whose backward is the fused kernel.  Inference-mode BN only; its
    parameters and statistics nest under this module, as in flax."""

    def __init__(self, cin: int, c: int, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-5, device=None):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.weight = nn.Parameter(torch.empty(c, cin, 3, 3, device=device))
        self.scale = nn.Parameter(torch.empty(c, device=device))
        self.bias = nn.Parameter(torch.empty(c, device=device))
        self.mean = nn.Parameter(torch.empty(c, device=device))
        self.var = nn.Parameter(torch.empty(c, device=device))

    def forward(self, x):
        a = x.to(self.dtype).permute(0, 2, 3, 1)      # NHWC view
        out = fused_conv_bn_relu(a, self.weight.permute(2, 3, 1, 0),
                                 self.scale, self.bias, self.mean, self.var,
                                 self.eps)
        return out.permute(0, 3, 1, 2)


class BottleneckBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int,
                 dtype: torch.dtype, fused_bwd: bool = False, device=None):
        super().__init__()
        conv = partial(Conv, dtype=dtype, device=device)
        norm = partial(BatchNorm, dtype=dtype, device=device)
        self.Conv_0 = conv(cin, filters, 1)
        self.BatchNorm_0 = norm(filters)
        self.fused = fused_bwd and stride == 1
        if self.fused:
            self.FusedConvBnRelu3x3_0 = FusedConvBnRelu3x3(
                filters, filters, dtype, device=device)
            self.Conv_1 = conv(filters, 4 * filters, 1)
            self.BatchNorm_1 = norm(4 * filters, scale_init=0.0)
        else:
            self.Conv_1 = conv(filters, filters, 3, stride)
            self.BatchNorm_1 = norm(filters)
            self.Conv_2 = conv(filters, 4 * filters, 1)
            self.BatchNorm_2 = norm(4 * filters, scale_init=0.0)
        self.project = cin != 4 * filters or stride != 1
        if self.project:
            self.conv_proj = conv(cin, 4 * filters, 1, stride)
            self.norm_proj = norm(4 * filters)

    def forward(self, x, train: bool):
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x), train))
        if self.fused:
            y = self.FusedConvBnRelu3x3_0(y)
            y = self.BatchNorm_1(self.Conv_1(y), train)
        else:
            y = torch.relu(self.BatchNorm_1(self.Conv_1(y), train))
            y = self.BatchNorm_2(self.Conv_2(y), train)
        residual = x
        if self.project:
            residual = self.norm_proj(self.conv_proj(x), train)
        return torch.relu(residual + y)


def space_to_depth_2x2(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) → (N, H/2, W/2, 4C) pixel shuffle of the TPU stem."""
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"space_to_depth stem requires even spatial dims, "
                         f"got ({h}, {w})")
    return x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(n, h // 2, w // 2, 4 * c)


class ResNet(nn.Module):
    """``model(images, train=True) -> logits`` (fp32), images NHWC.

    ``fused_bwd`` builds every stride-1 block's 3x3 segment as a
    :class:`FusedConvBnRelu3x3`; like the JAX package, it is meant for
    inference-mode BN (``train=False``, the bench's configuration), and a
    ``train=True`` call raises.  Weights are drawn from ``generator``:
    conv and dense kernels N(0, 1/fan_in) (flax's lecun normal,
    untruncated), BN scale 1 (0 for each block's last BN), bias and mean 0,
    var 1."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.float32,
                 space_to_depth: bool = False, fused_bwd: bool = False,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype, self.space_to_depth = dtype, space_to_depth
        self.fused_bwd = fused_bwd
        if space_to_depth:
            self.conv_init = Conv(12, num_filters, 4, 1, "SAME", dtype,
                                  device)
        else:
            self.conv_init = Conv(3, num_filters, 7, 2, ((3, 3), (3, 3)),
                                  dtype, device)
        self.bn_init = BatchNorm(num_filters, dtype, device=device)
        self.blocks = []
        cin = num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                filters = num_filters * 2 ** i
                block = BottleneckBlock(cin, filters,
                                        2 if i > 0 and j == 0 else 1,
                                        dtype, fused_bwd, device)
                self.add_module(f"BottleneckBlock_{len(self.blocks)}", block)
                self.blocks.append(block)
                cin = 4 * filters
        self.Dense_0 = nn.Linear(cin, num_classes, device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in self.modules():
            if isinstance(m, (BatchNorm, FusedConvBnRelu3x3)):
                m.scale.fill_(getattr(m, "scale_init", 1.0))
                m.bias.zero_()
                m.mean.zero_()
                m.var.fill_(1.0)
            if isinstance(m, (Conv, FusedConvBnRelu3x3, nn.Linear)):
                w = m.weight
                fan_in = w[0].numel()
                w.copy_(torch.randn(w.shape, generator=generator,
                                    device=w.device) * fan_in ** -0.5)
            if isinstance(m, nn.Linear):
                m.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if train and self.fused_bwd:
            raise ValueError("fused_bwd segments run inference-mode BN: "
                             "call with train=False")
        x = x.to(self.dtype)
        if self.space_to_depth:
            x = space_to_depth_2x2(x)
        x = x.permute(0, 3, 1, 2)                 # channels_last NCHW view
        x = torch.relu(self.bn_init(self.conv_init(x), train))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for block in self.blocks:
            x = block(x, train)
        x = x.mean((2, 3))
        return F.linear(x.float(), self.Dense_0.weight, self.Dense_0.bias)


def unfused_state_dict(state: dict) -> dict:
    """A ``fused_bwd=True`` ResNet's ``state_dict`` (or any dict keyed by
    its parameter names) under the names of the ``fused_bwd=False`` model
    with the same weights: in a fused block the segment's conv and BN are
    ``Conv_1``/``BatchNorm_1``, and the last conv and BN move from ``_1``
    to ``_2``."""
    fused = {n.partition(".")[0] for n in state
             if ".FusedConvBnRelu3x3_0." in n}
    out = {}
    for name, value in state.items():
        block, _, rest = name.partition(".")
        if block in fused:
            rest = rest.replace("Conv_1.", "Conv_2.") \
                .replace("BatchNorm_1.", "BatchNorm_2.") \
                .replace("FusedConvBnRelu3x3_0.weight", "Conv_1.weight") \
                .replace("FusedConvBnRelu3x3_0.", "BatchNorm_1.")
            name = f"{block}.{rest}"
        out[name] = value
    return out


ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3])
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3])
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3])


def resnet_loss(model: ResNet, batch: dict, train: bool = False
                ) -> torch.Tensor:
    """Mean softmax cross-entropy of the fp32 logits on integer labels
    (``optax.softmax_cross_entropy_with_integer_labels(...).mean()``);
    ``batch`` holds ``x`` (NHWC images) and ``y``.  ``train=False`` is the
    bench's inference-mode BN."""
    logits = model(batch["x"], train=train)
    return F.cross_entropy(logits.float(), batch["y"].long())
