"""Plain attention (``horovod_tpu/parallel/ring_attention.py``
``reference_attention``).  The ring and its helpers wait for a later slice."""

from __future__ import annotations

from typing import Optional

import torch

from horovod_tpu_torch.ops.kernels import NEG_INF


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Single-device softmax attention over ``(b, t, h, d)`` inputs, in
    fp32, cast back to q's dtype: the numerics oracle and the dense
    ``attention_impl``."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        allowed = torch.arange(tq, device=q.device)[:, None] >= \
            torch.arange(tk, device=q.device)[None, :]
        scores = scores.masked_fill(~allowed, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
