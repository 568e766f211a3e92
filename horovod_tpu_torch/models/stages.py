"""Cut a model's blocks into pipeline stage chunks, and the
:class:`~horovod_tpu_torch.models.transformer.TransformerLM`'s loss with
its blocks run through :mod:`~horovod_tpu_torch.parallel.pipeline`.

The JAX package's pipeline takes each rank's chunks stacked on a leading
dimension (its tests stack them by hand); here a rank's chunks are lists
of the model's own blocks.  Of ``v*s`` global stages of ``n/(v*s)``
consecutive blocks each, rank ``r`` of ``s`` holds chunk ``j`` = global
stage ``j*s + r``.  The embedding, the final norm and the tied head stay
outside the pipe, replicated on every rank, as JAX's replicated input and
output are.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.ops import fused_collectives as FC
from horovod_tpu_torch.parallel.pipeline import gpipe, interleaved_1f1b


def stage_chunks(blocks: Sequence[nn.Module], stages: int, rank: int,
                 virtual_stages: int = 1) -> List[nn.ModuleList]:
    """Rank ``rank``'s ``virtual_stages`` chunks of ``blocks``: chunk ``j``
    is global stage ``j*stages + rank`` of ``virtual_stages*stages``
    stages of consecutive blocks."""
    n, cut = len(blocks), virtual_stages * stages
    if n % cut != 0:
        raise ValueError(f"{n} blocks do not cut into {cut} stages "
                         f"({virtual_stages} chunks on each of {stages} "
                         f"ranks)")
    per = n // cut
    return [nn.ModuleList(blocks[(j * stages + rank) * per:
                                 (j * stages + rank + 1) * per])
            for j in range(virtual_stages)]


def lm_chunks(model, group=None, virtual_stages: int = 1
              ) -> List[nn.ModuleList]:
    """This rank's chunks of a ``TransformerLM``'s blocks over the pp
    ``group`` (``None``: a group of one)."""
    return stage_chunks(list(model.layers), FC.group_size(group),
                        FC.group_rank(group), virtual_stages)


def pipeline_lm_loss(model, tokens: torch.Tensor, chunks, num_microbatches:
                     int, group=None,
                     positions: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """:func:`~horovod_tpu_torch.models.transformer.lm_loss` with the
    blocks run as ``chunks`` (:func:`lm_chunks`) through
    :func:`~horovod_tpu_torch.parallel.pipeline.gpipe` (one chunk) or
    :func:`~horovod_tpu_torch.parallel.pipeline.interleaved_1f1b` (more);
    the same loss on every rank of ``group``.  Before its backward, divide
    it by the group's size, and after, sum the gradients of the embedding
    and the final norm over the group (the pipeline module's docstring):
    then every rank holds the gradients of the sequential model."""
    cfg = model.cfg
    inp = tokens[:, :-1]
    pos = positions[:-1] if positions is not None else \
        torch.arange(inp.shape[1], device=tokens.device)
    emb = model.embed.embedding
    x = F.embedding(inp, emb).to(cfg.dtype)

    def stage_fn(chunk, h):
        for block in chunk:
            h = block(h, pos)
        return h

    if len(chunks) == 1:
        x = gpipe(stage_fn, chunks[0], x, num_microbatches, group=group)
    else:
        x = interleaved_1f1b(stage_fn, chunks, x, num_microbatches,
                             len(chunks), group=group)
    logits = model.ln_f(x).to(cfg.dtype) @ emb.to(cfg.dtype).t()
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))


def outside_parameters(model) -> List[nn.Parameter]:
    """The parameters of a ``TransformerLM`` that stay outside the pipe
    (the embedding, tied to the head, and the final norm): every rank of
    the pp group holds them and sums their gradients over it."""
    return [model.embed.embedding, model.ln_f.scale]
