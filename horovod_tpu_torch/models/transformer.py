"""Decoder-only transformer LM (``horovod_tpu/models/transformer.py``).

The same network as the flax model at tensor-parallel degree 1: RMSNorm,
interleaved rotary embeddings with fp32 angles, a fused bias-free QKV
projection, tanh-approximated GELU, a tied output head, fp32 parameters
and ``cfg.dtype`` compute.  Parameter names follow the flax tree
(``layer_{i}/attn/qkv/kernel`` is ``layers.{i}.attn.qkv.weight``, stored
``(out, in)``); :func:`horovod_tpu_torch.models.convert.params_from_flax`
maps one onto the other.  ``attention_impl`` is ``dense`` (plain
attention) or ``flash`` (the port's flash kernels); ring, ulysses,
tensor parallelism and remat wait for later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.ops.kernels import flash_attention
from horovod_tpu_torch.parallel.ring_attention import reference_attention


@dataclasses.dataclass
class TransformerConfig:
    vocab_size: int = 32_000
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    attention_impl: str = "dense"       # dense | flash
    flash_block: int = 512              # only gates fit_flash_block
    causal: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def rotary_embedding(x: torch.Tensor, positions: torch.Tensor,
                     base: float = 10_000.0) -> torch.Tensor:
    """Rotate interleaved pairs ``(x[..., 0::2], x[..., 1::2])`` of head
    dims by fp32 position angles.  ``x``: (b, t, h, d); ``positions``:
    (t,)."""
    d = x.shape[-1]
    inv_freq = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32,
                                            device=x.device) / d))
    angles = positions[:, None].float() * inv_freq[None, :]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


class RMSNorm(nn.Module):
    """fp32 statistics and scale, result in the input's dtype."""

    def __init__(self, dim: int, epsilon: float = 1e-6, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        x32 = x.float()
        y = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True)
                              + self.epsilon)
        return (y * self.scale).to(x.dtype)


class Dense(nn.Linear):
    """Bias-free linear computed in ``dtype`` (flax ``Dense(dtype=...)``
    with fp32 parameters: both operands cast, product in ``dtype``)."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype,
                 device=None):
        super().__init__(d_in, d_out, bias=False, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.linear(x.to(self.compute_dtype),
                        self.weight.to(self.compute_dtype))


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.qkv = Dense(cfg.d_model, 3 * cfg.d_model, cfg.dtype, device)
        self.proj = Dense(cfg.d_model, cfg.d_model, cfg.dtype, device)

    def forward(self, x, positions):
        cfg = self.cfg
        b, t, _ = x.shape
        q, k, v = self.qkv(x).split(cfg.d_model, dim=-1)
        shape = (b, t, cfg.num_heads, cfg.head_dim)
        q, k, v = (a.reshape(shape) for a in (q, k, v))
        q = rotary_embedding(q, positions)
        k = rotary_embedding(k, positions)
        if cfg.attention_impl == "dense":
            o = reference_attention(q, k, v, causal=cfg.causal)
        elif cfg.attention_impl == "flash":
            o = flash_attention(q, k, v, causal=cfg.causal,
                                block_q=cfg.flash_block,
                                block_k=cfg.flash_block)
        else:
            raise ValueError(
                f"attention_impl {cfg.attention_impl!r} is not ported; "
                f"dense and flash are")
        return self.proj(o.reshape(b, t, cfg.d_model))


class MlpBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.wi = Dense(cfg.d_model, cfg.d_ff, cfg.dtype, device)
        self.wo = Dense(cfg.d_ff, cfg.d_model, cfg.dtype, device)

    def forward(self, x):
        # flax nn.gelu defaults to the tanh approximation
        return self.wo(F.gelu(self.wi(x), approximate="tanh"))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        self.attn = Attention(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, device=device)
        self.mlp = MlpBlock(cfg, device)

    def forward(self, x, positions):
        x = x + self.attn(self.ln1(x), positions)
        return x + self.mlp(self.ln2(x))


class Embed(nn.Module):
    def __init__(self, vocab: int, dim: int, device=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(vocab, dim, device=device))


class TransformerLM(nn.Module):
    """``model(tokens, positions=None) -> logits`` in ``cfg.dtype``.

    ``tokens``: (batch, seq) int64.  Weights are drawn from ``generator``
    (a ``torch.Generator`` on ``device``): embeddings N(0, 0.02), dense
    kernels N(0, 1/fan_in) (flax's lecun normal, untruncated), norm
    scales 1.
    """

    def __init__(self, cfg: TransformerConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.d_model, device)
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.num_layers))
        self.ln_f = RMSNorm(cfg.d_model, device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for name, p in self.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
                continue
            std = 0.02 if name == "embed.embedding" else p.shape[1] ** -0.5
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device) * std)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        emb = self.embed.embedding
        x = F.embedding(tokens, emb).to(cfg.dtype)
        for block in self.layers:
            x = block(x, positions)
        x = self.ln_f(x)
        # tied head as flax Embed.attend: both operands in cfg.dtype
        return x.to(cfg.dtype) @ emb.to(cfg.dtype).t()


def lm_loss(model: TransformerLM, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross-entropy, mean over the local batch.  The softmax
    runs in fp32 whatever the logits' dtype."""
    logits = model(tokens[:, :-1],
                   positions[:-1] if positions is not None else None)
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))
