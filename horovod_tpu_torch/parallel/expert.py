"""Expert parallelism: top-1-routed MoE over an expert-parallel process
group (``horovod_tpu/parallel/expert.py``).

Static capacity buckets, as in the JAX package: each rank scatters its
tokens into an ``(experts, capacity, d)`` dispatch buffer, the buffer's
expert slots move to the ranks that own them (two ``all_to_all`` calls, or
the fused ring of :func:`~horovod_tpu_torch.ops.fused_collectives.expert_alltoall_ffn`),
each rank runs its experts as one batched product, and the results come
home for the gate-weighted combine.  Tokens beyond an expert's capacity
are dropped (contribute zero), the Switch-Transformer policy.  ``group``
is any process group of the step's mesh (``mesh.group("ep")``), or
``None`` for a group of this rank alone.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from horovod_tpu_torch.ops.fused_collectives import group_size


def router_scores(x: torch.Tensor, gate_kernel: torch.Tensor) -> torch.Tensor:
    """``x @ gate_kernel`` in fp32 with TF32 off on a card: near-tie tokens
    must route as the fp32 reference routes them."""
    a, w = x.float(), gate_kernel.float()
    if not a.is_cuda:
        return a @ w
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ w
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep


def top1_routing(scores: torch.Tensor, capacity: int):
    """Greedy top-1 assignment with per-expert capacity.

    ``scores``: (tokens, num_experts) gate logits.  Returns ``(expert_idx,
    slot, keep, gate)``: each token's expert (the first maximum of its fp32
    softmax, as ``jnp.argmax`` takes it), its position inside that
    expert's bucket in token order, whether it fit, and its softmax gate
    weight."""
    probs = torch.softmax(scores.float(), dim=-1)
    expert_idx = torch.argmax(probs, dim=-1)
    gate = probs.gather(1, expert_idx[:, None])[:, 0]
    # the running count along the tokens, scanned as the innermost dim: a
    # scan over the outer dim of (tokens, experts) runs one thread an
    # expert (2.8 ms a layer at 16,384 tokens on an H100)
    one_hot = F.one_hot(expert_idx, scores.shape[-1]).t()
    slot = (torch.cumsum(one_hot, dim=1) - 1).gather(0, expert_idx[None])[0]
    keep = slot < capacity
    return expert_idx, slot, keep, gate


def moe_capacity(tokens: int, num_experts: int,
                 capacity_factor: float) -> int:
    """Per-expert capacity ``ceil(capacity_factor · tokens / num_experts)``,
    at least 1, in Python floats exactly as the JAX package writes it."""
    return int(max(1, -(-capacity_factor * tokens // num_experts)))


def _token_rows(expert_idx: torch.Tensor, slot: torch.Tensor,
                keep: torch.Tensor, capacity: int,
                num_experts: int) -> torch.Tensor:
    """Each token's row of the flat ``(num_experts·capacity + tokens, d)``
    buffer: a kept token's ``expert·capacity + slot``, a dropped token a
    row of its own past the experts' rows.  Every row is distinct."""
    trash = num_experts * capacity + torch.arange(
        expert_idx.shape[0], device=expert_idx.device)
    return torch.where(keep, expert_idx * capacity + slot, trash)


def dispatch_tokens(x: torch.Tensor, expert_idx: torch.Tensor,
                    slot: torch.Tensor, keep: torch.Tensor,
                    num_experts: int, capacity: int) -> torch.Tensor:
    """The ``(num_experts, capacity, d)`` dispatch buffer: each kept token
    at its (expert, slot), zeros elsewhere.  JAX adds a dropped token's
    zeros at slot 0 of its expert; here it lands in a row of its own that
    is cut off, the same buffer, so that no two tokens share a row: an
    accumulating scatter of the thousands of dropped tokens onto one slot
    ran one warp a slot (1.3 ms a layer on an H100)."""
    rows = _token_rows(expert_idx, slot, keep, capacity, num_experts)
    buf = x.new_zeros((num_experts * capacity + x.shape[0], x.shape[-1]))
    buf = buf.index_put((rows,), x)
    return buf[:num_experts * capacity].view(num_experts, capacity,
                                             x.shape[-1])


def combine_tokens(combined: torch.Tensor, expert_idx: torch.Tensor,
                   slot: torch.Tensor, keep: torch.Tensor,
                   gate: torch.Tensor) -> torch.Tensor:
    """Each token's result from its (expert, slot), weighted by its gate;
    dropped tokens read a zero row of their own (distinct rows keep the
    gradient's scatter free of duplicates) and get zeros."""
    e, c, d = combined.shape
    rows = _token_rows(expert_idx, slot, keep, c, e)
    flat = torch.cat([combined.reshape(e * c, d),
                      combined.new_zeros((expert_idx.shape[0], d))])
    y = flat[rows]
    return torch.where(keep[:, None], y * gate[:, None].to(y.dtype),
                       torch.zeros_like(y))


def expert_parallel_ffn(x: torch.Tensor, gate_kernel: torch.Tensor,
                        expert_fn: Callable, num_experts_total: int,
                        capacity_factor: float = 1.25, group=None,
                        scores: Optional[torch.Tensor] = None,
                        fused: bool = False,
                        params: Optional[Sequence[torch.Tensor]] = None):
    """Mixture-of-experts FFN with experts sharded over ``group``.

    Every rank of ``group`` calls this with its ``(tokens_local, d)``
    tokens ``x`` and the replicated ``(d, num_experts_total)`` router
    ``gate_kernel``.  ``expert_fn(buffers)`` applies this rank's
    ``num_experts_total / world`` experts to an ``(e_local, slots, d)``
    buffer, batched over dim 0 and token-wise (each slot independent), so
    that the fused and unfused schedules agree.  ``scores`` hands in fp32
    router logits already computed (the aux loss's), so that the dispatched
    routing is the accounted one.  ``fused`` takes the ring of
    :func:`~horovod_tpu_torch.ops.fused_collectives.expert_alltoall_ffn`,
    whose ``params`` are the tensors ``expert_fn`` reads that need
    gradients.

    Returns ``(tokens_local, d)`` gate-weighted expert outputs (zeros for
    dropped tokens) and the fraction of tokens dropped (a 0-d tensor)."""
    from horovod_tpu_torch.ops.fused_collectives import expert_alltoall_ffn

    world = group_size(group)
    if num_experts_total % world != 0:
        raise ValueError(
            f"num_experts_total={num_experts_total} not divisible by "
            f"'ep' size {world}")
    e_local = num_experts_total // world
    t, d = x.shape
    capacity = moe_capacity(t, num_experts_total, capacity_factor)
    if scores is None:
        scores = router_scores(x, gate_kernel)
    expert_idx, slot, keep, gate = top1_routing(scores, capacity)
    dispatch = dispatch_tokens(x, expert_idx, slot, keep, num_experts_total,
                               capacity)
    # (E, C, d) -> (world, E_local, C, d); dim 0 is the destination rank
    combined = expert_alltoall_ffn(
        dispatch.reshape(world, e_local, capacity, d), expert_fn, group,
        fused=fused, params=params)
    y = combine_tokens(combined.reshape(num_experts_total, capacity, d),
                       expert_idx, slot, keep, gate)
    return y, 1.0 - keep.float().mean()
