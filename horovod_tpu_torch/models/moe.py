"""Switch-style Mixture-of-Experts transformer LM
(``horovod_tpu/models/moe.py``).

:class:`SwitchFFN` replaces every ``moe_every``-th block's MLP with top-1
routed gelu experts; :class:`MoETransformerLM` stacks them on the same
attention, RMSNorm and rotary machinery as
:class:`~horovod_tpu_torch.models.transformer.TransformerLM`, with a tied
head.  Two execution modes share the router and the parameters:

* *local* (``ep_group=None``): every rank holds and runs all experts, one
  batched product over the ``(E, capacity, d)`` dispatch buffer;
* *expert-parallel* (``ep_group`` a process group of the mesh): the experts'
  weights stay replicated, each rank applies its ``E/ep`` slice of them
  (other ranks' experts get zero gradients, so every gradient hook still
  fires), and tokens move by
  :func:`~horovod_tpu_torch.parallel.expert.expert_parallel_ffn` (two
  ``all_to_all`` calls, or the fused ring when ``fused_dispatch`` /
  ``HOROVOD_MOE_FUSED_DISPATCH`` resolves on; ``"auto"`` takes the two
  calls, since the ring, the JAX package's schedule kept for parity, is
  the slower one on H100s, ``ep_bench.py``).

Parameters follow the flax tree: ``layer_{i}/moe/gate`` (d, E),
``layer_{i}/moe/w1`` (E, d, f) and ``layer_{i}/moe/w2`` (E, f, d) are
``layers.{i}.moe.gate`` / ``.w1`` / ``.w2`` in flax's layout, so
:func:`~horovod_tpu_torch.models.convert.params_from_flax` carries them
unchanged.  After each forward a :class:`SwitchFFN` keeps its Switch aux
loss, its per-expert routing share and its drop fraction
(``moe_aux_loss``, ``moe_expert_fraction``, ``moe_drop_fraction``, the JAX
model's sowed ``intermediates``); :func:`moe_aux_loss` averages the aux
losses of a model's last forward.  ``remat``/``remat_policy`` wrap each
block in its remat tier, dense and MoE blocks alike, as the JAX model
does; a recomputed MoE block sets those attributes again to the same
values.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.memory.remat import remat_block, resolve_remat_policy
from horovod_tpu_torch.models.transformer import (
    Attention,
    Block,
    Embed,
    RMSNorm,
    TransformerConfig,
)
from horovod_tpu_torch.parallel.expert import (
    combine_tokens,
    dispatch_tokens,
    expert_parallel_ffn,
    moe_capacity,
    router_scores,
    top1_routing,
)


@dataclasses.dataclass
class MoEConfig:
    vocab_size: int = 32_000
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    attention_impl: str = "dense"
    flash_block: int = 512
    causal: bool = True
    num_experts: int = 8
    capacity_factor: float = 1.25
    moe_every: int = 2              # every Nth block is MoE (Switch: 2)
    fused_dispatch: Optional[str] = None  # auto|on|off; None -> env knob
    remat: bool = False
    remat_policy: Optional[str] = None  # none|dots|full|offload

    def resolved_fused_dispatch(self) -> str:
        """``fused_dispatch`` with the ``HOROVOD_MOE_FUSED_DISPATCH``
        fallback (default ``"auto"``)."""
        return (self.fused_dispatch
                or os.environ.get("HOROVOD_MOE_FUSED_DISPATCH")
                or "auto").lower()

    def transformer(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=self.vocab_size, num_layers=self.num_layers,
            num_heads=self.num_heads, d_model=self.d_model,
            d_ff=self.d_ff, max_seq_len=self.max_seq_len,
            dtype=self.dtype, attention_impl=self.attention_impl,
            flash_block=self.flash_block, causal=self.causal)


def _expert_mlp(buffers: torch.Tensor, w1: torch.Tensor,
                w2: torch.Tensor) -> torch.Tensor:
    """``(E?, S, d) -> (E?, S, d)``: the one batched expert body both modes
    share (``moe.py:129-135``)."""
    h = torch.einsum("esd,edf->esf", buffers, w1)
    return torch.einsum("esf,efd->esd", F.gelu(h, approximate="tanh"), w2)


class SwitchFFN(nn.Module):
    """Top-1 routed expert FFN: ``(B, T, D) -> (B, T, D)`` in ``cfg.dtype``.
    The router runs in fp32 (TF32 off on a card); the routing the aux loss
    accounts is the one dispatched."""

    def __init__(self, cfg: MoEConfig, device=None, ep_group=None):
        super().__init__()
        self.cfg = cfg
        self.ep_group = ep_group
        d, e, f = cfg.d_model, cfg.num_experts, cfg.d_ff
        self.gate = nn.Parameter(torch.empty(d, e, device=device))
        self.w1 = nn.Parameter(torch.empty(e, d, f, device=device))
        self.w2 = nn.Parameter(torch.empty(e, f, d, device=device))
        self.moe_aux_loss: Optional[torch.Tensor] = None
        self.moe_expert_fraction: Optional[torch.Tensor] = None
        self.moe_drop_fraction: Optional[torch.Tensor] = None

    def forward(self, x):
        from horovod_tpu_torch.ops.fused_collectives import (
            group_rank,
            group_size,
            resolve_fused_collectives,
        )

        cfg = self.cfg
        b, t, d = x.shape
        e = cfg.num_experts
        tokens = x.reshape(b * t, d)
        scores = router_scores(tokens, self.gate)
        probs = torch.softmax(scores, dim=-1)
        chosen = F.one_hot(torch.argmax(probs, dim=-1), e).float()
        fraction = chosen.mean(0)
        self.moe_aux_loss = e * torch.sum(fraction * probs.mean(0))
        self.moe_expert_fraction = fraction.detach()
        dt = cfg.dtype
        xt = tokens.to(dt)
        if self.ep_group is not None:
            e_local = e // group_size(self.ep_group)
            lo = group_rank(self.ep_group) * e_local
            w1, w2 = self.w1, self.w2

            def expert_fn(buffers):
                return _expert_mlp(buffers, w1[lo:lo + e_local].to(dt),
                                   w2[lo:lo + e_local].to(dt))

            y, dropped = expert_parallel_ffn(
                xt, self.gate, expert_fn, e,
                capacity_factor=cfg.capacity_factor, group=self.ep_group,
                scores=scores,
                fused=resolve_fused_collectives(
                    cfg.resolved_fused_dispatch()),
                params=(w1, w2))
        else:
            capacity = moe_capacity(tokens.shape[0], e, cfg.capacity_factor)
            expert_idx, slot, keep, gate = top1_routing(scores, capacity)
            dispatch = dispatch_tokens(xt, expert_idx, slot, keep, e,
                                       capacity)
            out = _expert_mlp(dispatch, self.w1.to(dt), self.w2.to(dt))
            y = combine_tokens(out, expert_idx, slot, keep, gate)
            dropped = 1.0 - keep.float().mean()
        self.moe_drop_fraction = dropped.detach()
        return y.reshape(b, t, d).to(dt)


class MoEBlock(nn.Module):
    def __init__(self, cfg: MoEConfig, device=None, ep_group=None,
                 tcfg: Optional[TransformerConfig] = None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        self.attn = Attention(tcfg or cfg.transformer(), device)
        self.ln2 = RMSNorm(cfg.d_model, device=device)
        self.moe = SwitchFFN(cfg, device, ep_group)

    def forward(self, x, positions):
        x = x + self.attn(self.ln1(x), positions)
        return x + self.moe(self.ln2(x))


class MoETransformerLM(nn.Module):
    """``model(tokens, positions=None) -> logits`` in ``cfg.dtype``; every
    ``cfg.moe_every``-th block routes through experts, the rest are the
    dense :class:`~horovod_tpu_torch.models.transformer.Block`.  Add
    ``aux_weight * moe_aux_loss(model)`` to the task loss.

    ``ep_group`` is the expert-parallel process group (``None``: local
    experts); every rank of it holds the same parameters and calls the
    model on its own tokens.  Weights are drawn from ``generator`` as in
    ``TransformerLM``: embeddings and the router N(0, 0.02), dense kernels
    and the experts' ``w1``/``w2`` N(0, 1/fan_in) (flax's lecun normal,
    untruncated; flax counts a 3-D kernel's leading expert axis into its
    fan-in, E·d for ``w1`` and E·f for ``w2``), norm scales 1."""

    def __init__(self, cfg: MoEConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 ep_group=None):
        super().__init__()
        self.cfg = cfg
        # one attention config for every block: model.tcfg.attention_impl
        # switches all of them
        self.tcfg = tcfg = cfg.transformer()
        self.embed = Embed(cfg.vocab_size, cfg.d_model, device)
        self.layers = nn.ModuleList(
            MoEBlock(cfg, device, ep_group, tcfg) if self.is_moe(i)
            else Block(tcfg, device) for i in range(cfg.num_layers))
        self.ln_f = RMSNorm(cfg.d_model, device=device)
        self.reset_parameters(generator)

    def is_moe(self, i: int) -> bool:
        return bool(self.cfg.moe_every) and (i + 1) % self.cfg.moe_every == 0

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for name, p in self.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
                continue
            if name == "embed.embedding" or name.endswith(".moe.gate"):
                std = 0.02
            elif p.dim() == 3:      # (E, in, out): flax's fan-in is E·in
                std = (p.shape[0] * p.shape[1]) ** -0.5
            else:                   # (out, in) dense weights
                std = p.shape[1] ** -0.5
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device) * std)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        emb = self.embed.embedding
        x = F.embedding(tokens, emb).to(cfg.dtype)
        policy = resolve_remat_policy(cfg.remat_policy, cfg.remat)
        for block in self.layers:
            x = remat_block(block, policy)(x, positions)
        x = self.ln_f(x)
        # tied head as flax Embed.attend: both operands in cfg.dtype
        return x.to(cfg.dtype) @ emb.to(cfg.dtype).t()


def moe_layers(model: nn.Module) -> list:
    return [m for m in model.modules() if isinstance(m, SwitchFFN)]


def moe_aux_loss(model: nn.Module) -> torch.Tensor:
    """Mean of the Switch aux losses of ``model``'s last forward (0 when it
    has no MoE layer), differentiable."""
    losses = [m.moe_aux_loss for m in moe_layers(model)
              if m.moe_aux_loss is not None]
    if not losses:
        return torch.zeros(())
    return torch.stack([a.float() for a in losses]).mean()
