"""Ring attention: exact attention over a sequence-parallel group
(``horovod_tpu/parallel/ring_attention.py``).

Q stays put; K/V blocks travel one hop a step around the sp process group
while each rank folds the visiting block into an online-softmax
accumulator.  After ``world`` steps every query has attended to the whole
global sequence.  Two formulations share this contract:

* the **fused** ring,
  :func:`~horovod_tpu_torch.ops.fused_collectives.ring_flash_attention`,
  which consumes each visiting block with the flash kernels;
* the **plain** ring below, the JAX package's jnp ring in fp32, kept for
  shards off the flash tiling contract.

The choice between them is made by shape alone, as :func:`flash_attention`
makes it: there is no knob.  The plain ring is not a cheaper collective, as
the unfused pair is for the tensor-parallel boundary ops: it materializes
``(b, h, t, t)`` fp32 scores every step, so wherever the shards fit, the
fused ring runs, on the card (the kernels) and on the CPU (their plain
versions).  Both understand the ``contiguous`` and ``zigzag`` sequence
layouts (``HOROVOD_SP_LAYOUT``).  ``group`` is a ``torch.distributed``
process group, or ``None`` for a group of this rank alone.
"""

from __future__ import annotations

from typing import Optional

import torch

from horovod_tpu_torch.ops import fused_collectives as FC
from horovod_tpu_torch.ops.kernels import (
    NEG_INF,
    fit_flash_block,
    flash_kernels_take,
)
from horovod_tpu_torch.runtime import config


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group=None, causal: bool = False,
                   scale: Optional[float] = None,
                   layout: Optional[str] = None, block_q: int = 512,
                   block_k: int = 512) -> torch.Tensor:
    """Exact attention with K/V ring-rotated over ``group``.

    ``q``, ``k``, ``v`` are this rank's ``(batch, seq_local, heads,
    head_dim)`` blocks; the global sequence is the shards' concatenation in
    group-rank order (chunk order under ``layout="zigzag"``, see
    :func:`~horovod_tpu_torch.ops.fused_collectives.ring_layout_positions`).
    ``causal`` masks by global positions.  The fused ring runs where the
    shards fit its contract (equal shapes, a ``seq_local`` that
    ``fit_flash_block`` takes, an even one under zigzag, and on a card the
    flash kernels' bfloat16 and head_dims, ``flash_kernels_take``);
    otherwise the plain ring runs, with the same numerics and the same
    hops.
    ``layout=None`` reads ``HOROVOD_SP_LAYOUT``.  Returns this rank's output
    block."""
    layout = config.sp_layout() if layout is None else layout
    FC._check_layout(layout)
    tq, d = q.shape[1], q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    fits = (k.shape == q.shape and v.shape == q.shape
            and fit_flash_block(tq, block_q) is not None
            and fit_flash_block(tq, block_k) is not None
            and not (layout == "zigzag" and tq % 2)
            and flash_kernels_take(q, k, v))
    if fits:
        return FC.ring_flash_attention(q, k, v, group, causal=causal,
                                       scale=scale, layout=layout,
                                       block_q=block_q, block_k=block_k)
    return _PlainRing.apply(q, k, v, group, causal, scale, layout)


def _step_parts(qf, k_cur, qpos, kpos, scale, causal):
    """fp32 scores of this step and its mask (None without ``causal``)."""
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k_cur.float()) * scale
    if not causal:
        return s, None
    allowed = qpos[:, None] >= kpos[None, :]
    return s.masked_fill(~allowed, NEG_INF), allowed


class _PlainRing(torch.autograd.Function):
    """The JAX jnp ring's math: fp32 scores and PV, the online softmax per
    step, probabilities multiplied by the mask so that a fully masked block
    adds exactly 0.  Autograd cannot flow through the hops, so the backward
    is the travelling-accumulator ring with the per-block FA2 backward in
    fp32 from the global lse."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale, layout):
        world, me = FC.group_size(group), FC.group_rank(group)
        tq, tk = q.shape[1], k.shape[1]
        qpos = FC.ring_layout_positions(me, world, tq, layout, q.device)
        kpos = [FC.ring_layout_positions(r, world, tk, layout, q.device)
                for r in range(world)]
        qf = q.float()
        b, _, h, d = q.shape
        o = torch.zeros((b, tq, h, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, h, tq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        kv = [k.contiguous(), v.contiguous()]
        for s in range(world):
            if s < world - 1:
                nxt, requests = FC._hop(kv, group, (me + 1) % world,
                                        (me - 1) % world)
            scores, allowed = _step_parts(qf, kv[0], qpos,
                                          kpos[(me - s) % world], scale,
                                          causal)
            m_new = torch.maximum(m, scores.amax(-1))
            p = torch.exp(scores - m_new[..., None])
            if allowed is not None:
                p = p * allowed
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            o = o * corr.transpose(1, 2)[..., None] + \
                torch.einsum("bhqk,bkhd->bqhd", p, kv[1].float())
            m = m_new
            if s < world - 1:
                FC._wait(requests)
                kv = nxt
        l_safe = l.clamp_min(1e-30)
        out = (o / l_safe.transpose(1, 2)[..., None]).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, m + torch.log(l_safe))
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        ctx.qpos, ctx.kpos = qpos, kpos
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        world, me = FC.group_size(group), FC.group_rank(group)
        to, frm = (me + 1) % world, (me - 1) % world
        qf, gf = q.float(), g.float()
        delta = (gf * out.float()).sum(-1).transpose(1, 2)    # (b, h, tq)
        dq = torch.zeros_like(qf)
        acc = [torch.zeros(k.shape, dtype=torch.float32, device=k.device),
               torch.zeros(v.shape, dtype=torch.float32, device=v.device)]
        kv = [k.contiguous(), v.contiguous()]
        for s in range(world):
            if s < world - 1:
                nxt, requests = FC._hop(kv, group, to, frm)
            scores, allowed = _step_parts(qf, kv[0], ctx.qpos,
                                          ctx.kpos[(me - s) % world], scale,
                                          causal)
            p = torch.exp(scores - lse[..., None])
            if allowed is not None:
                p = p * allowed
            dp = torch.einsum("bqhd,bkhd->bhqk", gf, kv[1].float())
            ds = p * (dp - delta[..., None])
            kf = kv[0].float()
            dq += torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
            acc[0] += torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
            acc[1] += torch.einsum("bhqk,bqhd->bkhd", p, gf)
            if world > 1:
                # the accumulators travel with their block and are home
                # after the world-th hop
                acc_in, acc_requests = FC._hop(acc, group, to, frm)
                FC._wait(acc_requests)
                acc = acc_in
            if s < world - 1:
                FC._wait(requests)
                kv = nxt
        return (dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype),
                None, None, None, None)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Single-device softmax attention over ``(b, t, h, d)`` inputs, in
    fp32, cast back to q's dtype: the numerics oracle, the dense
    ``attention_impl`` and the local attention inside Ulysses."""
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
