"""Ulysses-style sequence parallelism: an all-to-all exchange of sequence
for heads (``horovod_tpu/parallel/ulysses.py``).

Ranks holding sequence slices all-to-all their Q/K/V so that each holds the
whole sequence for a subset of heads, run dense attention locally, then
all-to-all back to sequence shards.  Two exchanges per attention, through
``torch.distributed.nn.functional.all_to_all_single``, which carries its
own gradient.  It runs no kernel, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.distributed.nn.functional as dist_fn

from horovod_tpu_torch.ops.fused_collectives import group_size
from horovod_tpu_torch.parallel.ring_attention import reference_attention


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """Send block j of ``x``'s leading dim to group rank j and receive the
    same-shaped block from each rank, stacked in rank order."""
    x = x.contiguous()
    return dist_fn.all_to_all_single(torch.empty_like(x), x, group=group)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group=None, causal: bool = False) -> torch.Tensor:
    """Attention over the global sequence via head-sharded local attention.

    ``q``, ``k``, ``v`` are this rank's ``(batch, seq_local, heads,
    head_dim)`` blocks, the global sequence their concatenation in
    group-rank order; ``heads`` must divide by the group's size.  Each rank
    runs dense softmax attention over the whole sequence for its heads; the
    causal mask is exact because the positions are global after the
    exchange.  ``group=None`` is a group of one."""
    world = group_size(group)
    b, t, heads, d = q.shape
    if heads % world:
        raise ValueError(
            f"ulysses_attention needs heads ({heads}) divisible by the sp "
            f"group's size ({world}); use ring_attention for arbitrary "
            f"head counts")
    if world == 1:
        return reference_attention(q, k, v, causal=causal)
    hl = heads // world

    def to_heads(x):
        # (b, t, h, d) -> (b, world·t, h/world, d): scatter heads, gather
        # the sequence in rank order
        x = x.reshape(b, t, world, hl, d).permute(2, 0, 1, 3, 4)
        y = _exchange(x, group)                 # (world, b, t, hl, d)
        return y.permute(1, 0, 2, 3, 4).reshape(b, world * t, hl, d)

    out = reference_attention(to_heads(q), to_heads(k), to_heads(v),
                              causal=causal)
    # inverse exchange: back to sequence shards holding every head
    y = out.reshape(b, world, t, hl, d).permute(1, 0, 2, 3, 4)
    y = _exchange(y, group)                     # (world, b, t, hl, d)
    return y.permute(1, 2, 0, 3, 4).reshape(b, t, heads, d)
