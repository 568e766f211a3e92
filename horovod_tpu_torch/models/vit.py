"""Vision Transformer (``horovod_tpu/models/vit.py``).

The JAX model on the port's blocks: a patch embedding that is one strided
product with a bias (each ``p × p × C`` patch times a ``(p·p·C, d)``
kernel), the transformer's :class:`~horovod_tpu_torch.models.transformer.
Block` stack with bidirectional attention (``causal=False``) and rotary
embeddings over the flattened patch sequence, a final RMSNorm, mean
pooling over the patches and an fp32 ``head`` with a bias.  Images come
in JAX's ``(B, H, W, C)`` layout.  ``attention_impl="flash"`` runs the
port's flash kernels without the causal mask; the blocks take a
``tp_group`` as the LM's do.

Parameter names follow the flax tree: ``patch_embed/kernel`` (HWIO) is
``patch_embed.weight`` (OIHW), ``head/kernel`` ``(d, classes)`` is
``head.weight`` ``(classes, d)``, so
:func:`~horovod_tpu_torch.models.convert.params_from_flax` carries a
flax ``VisionTransformer``'s variables across.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.transformer import (
    Block,
    RMSNorm,
    TransformerConfig,
    dense_kernels,
    draw_dense_,
)


@dataclasses.dataclass
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    channels: int = 3
    dtype: torch.dtype = torch.bfloat16
    attention_impl: str = "dense"       # dense | flash

    @property
    def num_patches(self) -> int:
        if self.image_size % self.patch_size:
            raise ValueError(
                f"image_size {self.image_size} is not a multiple of "
                f"patch_size {self.patch_size}")
        return (self.image_size // self.patch_size) ** 2

    def transformer(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=1,               # unused: inputs are patches
            num_layers=self.num_layers, num_heads=self.num_heads,
            d_model=self.d_model, d_ff=self.d_ff,
            max_seq_len=self.num_patches, dtype=self.dtype,
            attention_impl=self.attention_impl, causal=False)


class PatchEmbed(nn.Module):
    """``(B, H, W, C) -> (B, (H/p)·(W/p), d)``: one ``(p·p·C, d)`` product
    with a bias over the image's patches, row-major, both operands in
    ``dtype`` (flax ``nn.Conv`` with a ``p`` stride and ``VALID``
    padding).  ``weight`` is ``(d, C, p, p)``."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.patch = cfg.patch_size
        self.dtype = cfg.dtype
        self.weight = nn.Parameter(torch.empty(
            cfg.d_model, cfg.channels, cfg.patch_size, cfg.patch_size,
            device=device))
        self.bias = nn.Parameter(torch.zeros(cfg.d_model, device=device))

    def forward(self, x):
        b, h, w, c = x.shape
        p = self.patch
        patches = x.to(self.dtype).reshape(b, h // p, p, w // p, p, c) \
            .permute(0, 1, 3, 2, 4, 5).reshape(b, (h // p) * (w // p),
                                               p * p * c)
        # (d, C, p, p) -> (d, p·p·C): the patches' (kh, kw, c) order
        kernel = self.weight.permute(0, 2, 3, 1).reshape(
            self.weight.shape[0], -1)
        return F.linear(patches, kernel.to(self.dtype),
                        self.bias.to(self.dtype))


class VisionTransformer(nn.Module):
    """``model(images) -> logits`` (fp32) over ``(B, H, W, C)`` images.
    Weights are drawn from ``generator``: dense and patch kernels
    N(0, 1/fan_in), biases 0, norm scales 1."""

    def __init__(self, cfg: ViTConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 tp_group=None):
        super().__init__()
        self.cfg = cfg
        tcfg = cfg.transformer()
        self.patch_embed = PatchEmbed(cfg, device)
        self.layers = nn.ModuleList(Block(tcfg, device, tp_group=tp_group)
                                    for _ in range(cfg.num_layers))
        self.ln_f = RMSNorm(cfg.d_model, device=device)
        self.head = nn.Linear(cfg.d_model, cfg.num_classes, device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        cfg = self.cfg
        dense = dense_kernels(self)
        fan_in = {"patch_embed.weight": cfg.patch_size ** 2 * cfg.channels,
                  "head.weight": cfg.d_model}
        for name, p in self.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
            elif name.endswith(".bias"):
                p.zero_()
            elif name in dense:
                draw_dense_(dense[name], generator)
            else:
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=p.device) * fan_in[name] ** -0.5)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(images)
        positions = torch.arange(x.shape[1], device=x.device)
        for block in self.layers:
            x = block(x, positions)
        x = self.ln_f(x).mean(dim=1)
        return F.linear(x.float(), self.head.weight, self.head.bias)


def ViT_S16(**kw) -> VisionTransformer:
    """ViT-S/16: 12 layers, 6 heads, d_model 384, d_ff 1536 (``device``,
    ``generator`` and ``tp_group`` go to the model, the rest to
    :class:`ViTConfig`)."""
    model_kw = {k: kw.pop(k) for k in ("device", "generator", "tp_group")
                if k in kw}
    return VisionTransformer(ViTConfig(num_layers=12, num_heads=6,
                                       d_model=384, d_ff=1536, **kw),
                             **model_kw)


def ViT_B16(**kw) -> VisionTransformer:
    """ViT-B/16: :class:`ViTConfig`'s defaults (12 layers, 12 heads,
    d_model 768, d_ff 3072), as :func:`ViT_S16` takes its arguments."""
    model_kw = {k: kw.pop(k) for k in ("device", "generator", "tp_group")
                if k in kw}
    return VisionTransformer(ViTConfig(**kw), **model_kw)


def vit_loss(model: VisionTransformer, batch) -> torch.Tensor:
    """Softmax cross-entropy of ``batch["x"]``'s logits against the integer
    labels ``batch["y"]``, mean over the batch (``bench.py``'s ViT loss)."""
    return F.cross_entropy(model(batch["x"]), batch["y"])
