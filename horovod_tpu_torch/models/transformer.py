"""Decoder-only transformer LM (``horovod_tpu/models/transformer.py``).

The same network as the flax model at tensor-parallel degree 1: RMSNorm,
interleaved rotary embeddings with fp32 angles, a fused bias-free QKV
projection, tanh-approximated GELU, a tied output head, fp32 parameters
and ``cfg.dtype`` compute.  Parameter names follow the flax tree
(``layer_{i}/attn/qkv/kernel`` is ``layers.{i}.attn.qkv.weight``, stored
``(out, in)``); :func:`horovod_tpu_torch.models.convert.params_from_flax`
maps one onto the other.  ``attention_impl`` is ``dense`` (plain
attention), ``flash`` (the port's flash kernels), or one of the sequence-
parallel formulations over the ``sp_group`` the model is built with:
``ring`` (:func:`~horovod_tpu_torch.parallel.ring_attention.ring_attention`)
or ``ulysses``.

Tensor parallelism, two ways.  Built with a ``tp_group`` (or sharded by
``DistributedTrainStep(plan="...,tp=n")``), the model holds this rank's
shard of every block's kernels, as the JAX model's
``ColumnParallelDense``/``RowParallelDense`` annotations place them:
``qkv`` and ``wi`` column-parallel, ``proj`` and ``wo`` row-parallel
(:mod:`~horovod_tpu_torch.parallel.tensor_parallel`), and attention runs
on the rank's ``num_heads/tp`` heads, its q, k and v slices of each head
(:func:`~horovod_tpu_torch.parallel.tensor_parallel.column_rows` with
three parts).  The embedding and the norm scales stay whole, as JAX's
``nn.Embed`` and ``RMSNorm`` carry no partitioning.  With ``tp_group=None``
the blocks are the plain products.  :func:`fused_tp_apply` is the other
way: the sequence-parallel boundary products over a model's full
replicated weights.

``remat``/``remat_policy`` wrap each block in its remat tier
(:func:`~horovod_tpu_torch.memory.remat.remat_block`), as the JAX model
wraps ``Block`` in ``remat_block``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.memory.remat import remat_block, resolve_remat_policy
from horovod_tpu_torch.ops.kernels import flash_attention
from horovod_tpu_torch.parallel.tensor_parallel import (
    ColumnParallelDense,
    RowParallelDense,
)
from horovod_tpu_torch.parallel.ring_attention import (
    reference_attention,
    ring_attention,
)
from horovod_tpu_torch.parallel.ulysses import ulysses_attention


@dataclasses.dataclass
class TransformerConfig:
    vocab_size: int = 32_000
    num_layers: int = 12
    num_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    attention_impl: str = "dense"       # dense | flash | ring | ulysses
    flash_block: int = 512              # gates fit_flash_block on the CPU
    causal: bool = True
    # the ring's sequence layout; None reads HOROVOD_SP_LAYOUT (default
    # "contiguous"), "zigzag" balances the causal work across ranks
    sp_layout: Optional[str] = None
    remat: bool = False
    # per-block remat tier (none|dots|full|offload), over the boolean when
    # set; resolved at each forward with HOROVOD_REMAT_POLICY
    # (memory/remat.resolve_remat_policy)
    remat_policy: Optional[str] = None

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


class Attention(nn.Module):
    """Fused bias-free QKV, column-parallel over ``tp_group`` (each rank its
    heads' q, k and v), attention over the rank's ``num_heads/tp`` heads,
    and a row-parallel bias-free output projection."""

    def __init__(self, cfg: TransformerConfig, device=None, sp_group=None,
                 tp_group=None):
        super().__init__()
        self.cfg = cfg
        self.sp_group = sp_group
        self.qkv = ColumnParallelDense(cfg.d_model, 3 * cfg.d_model, tp_group,
                                       use_bias=False, dtype=cfg.dtype,
                                       parts=3, device=device)
        self.proj = RowParallelDense(cfg.d_model, cfg.d_model, tp_group,
                                     use_bias=False, dtype=cfg.dtype,
                                     device=device)

    def forward(self, x, positions):
        cfg = self.cfg
        b, t, _ = x.shape
        tp = self.qkv.tp
        if cfg.num_heads % tp:
            raise ValueError(f"{cfg.num_heads} heads do not split over "
                             f"tp={tp}")
        heads = cfg.num_heads // tp
        d_loc = heads * cfg.head_dim
        q, k, v = self.qkv(x).split(d_loc, dim=-1)
        shape = (b, t, heads, cfg.head_dim)
        q, k, v = (a.reshape(shape) for a in (q, k, v))
        q = rotary_embedding(q, positions)
        k = rotary_embedding(k, positions)
        if cfg.attention_impl == "dense":
            o = reference_attention(q, k, v, causal=cfg.causal)
        elif cfg.attention_impl == "flash":
            o = flash_attention(q, k, v, causal=cfg.causal,
                                block_q=cfg.flash_block,
                                block_k=cfg.flash_block)
        elif cfg.attention_impl == "ring":
            o = ring_attention(q, k, v, self.sp_group, causal=cfg.causal,
                               layout=cfg.sp_layout, block_q=cfg.flash_block,
                               block_k=cfg.flash_block)
        elif cfg.attention_impl == "ulysses":
            o = ulysses_attention(q, k, v, self.sp_group, causal=cfg.causal)
        else:
            raise ValueError(
                f"unknown attention_impl {cfg.attention_impl!r}")
        return self.proj(o.reshape(b, t, d_loc))


class MlpBlock(nn.Module):
    """``wi`` column-parallel and ``wo`` row-parallel over ``tp_group``,
    both bias-free, tanh GELU between them."""

    def __init__(self, cfg: TransformerConfig, device=None, tp_group=None):
        super().__init__()
        self.wi = ColumnParallelDense(cfg.d_model, cfg.d_ff, tp_group,
                                      use_bias=False, dtype=cfg.dtype,
                                      device=device)
        self.wo = RowParallelDense(cfg.d_ff, cfg.d_model, tp_group,
                                   use_bias=False, dtype=cfg.dtype,
                                   device=device)

    def forward(self, x):
        # flax nn.gelu defaults to the tanh approximation
        return self.wo(F.gelu(self.wi(x), approximate="tanh"))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None, sp_group=None,
                 tp_group=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        self.attn = Attention(cfg, device, sp_group, tp_group)
        self.ln2 = RMSNorm(cfg.d_model, device=device)
        self.mlp = MlpBlock(cfg, device, tp_group)

    def forward(self, x, positions):
        x = x + self.attn(self.ln1(x), positions)
        return x + self.mlp(self.ln2(x))


class Embed(nn.Module):
    def __init__(self, vocab: int, dim: int, device=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(vocab, dim, device=device))


class TransformerLM(nn.Module):
    """``model(tokens, positions=None) -> logits`` in ``cfg.dtype``.

    ``tokens``: (batch, seq_local) int64.  ``positions``: (seq_local,)
    global positions for the rotary embedding; the default ``arange`` is
    right without sequence parallelism, and under it each rank passes its
    shard's global positions (for ``zigzag``, ``ring_layout_positions``,
    with the tokens permuted by ``zigzag_sequence_indices``).  ``sp_group``
    is the sequence-parallel process group that ``attention_impl`` ``ring``
    and ``ulysses`` run over (``None``: a group of one), and ``tp_group``
    the tensor-parallel one the blocks' kernels are sharded over (module
    docstring).  Weights are drawn from ``generator`` (a
    ``torch.Generator`` on ``device``): embeddings N(0, 0.02), dense
    kernels N(0, 1/fan_in) (flax's lecun normal, untruncated, fan_in the
    kernel's full input width), each drawn at its full shape and cut to
    this rank's block (:func:`draw_dense_`), so that a model built with a
    ``tp_group`` holds the shards of the model built without one from the
    same seed; norm scales 1.
    """

    def __init__(self, cfg: TransformerConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 sp_group=None, tp_group=None):
        super().__init__()
        self.cfg = cfg
        self.embed = Embed(cfg.vocab_size, cfg.d_model, device)
        self.layers = nn.ModuleList(Block(cfg, device, sp_group, tp_group)
                                    for _ in range(cfg.num_layers))
        self.ln_f = RMSNorm(cfg.d_model, device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        dense = dense_kernels(self)
        for name, p in self.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
            elif name == "embed.embedding":
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=p.device) * 0.02)
            else:
                draw_dense_(dense[name], generator)

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


def dense_kernels(model: nn.Module) -> dict:
    """``{"<module>.weight": module}`` over ``model``'s
    :class:`ColumnParallelDense` and :class:`RowParallelDense` modules."""
    return {f"{m}.weight": mod for m, mod in model.named_modules()
            if isinstance(mod, (ColumnParallelDense, RowParallelDense))}


def draw_dense_(module: nn.Module,
                generator: Optional[torch.Generator]) -> None:
    """Draw ``module``'s kernel N(0, 1/in_features) at its full
    ``(features, in_features)`` shape and keep this rank's block of it, so
    that every tp extent takes the same values from ``generator``."""
    w = module.weight
    full = torch.randn((module.features, module.in_features),
                       generator=generator, device=w.device)
    w.copy_(module.local(full * module.in_features ** -0.5))


def lm_loss(model: TransformerLM, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross-entropy, mean over the local batch.  The softmax
    runs in fp32 whatever the logits' dtype."""
    logits = model(tokens[:, :-1],
                   positions[:-1] if positions is not None else None)
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))


# ---------------------------------------------------------------------------
# tensor-parallel execution mode
# ---------------------------------------------------------------------------

def fused_tp_apply(model: TransformerLM, cfg: TransformerConfig,
                   tokens: torch.Tensor,
                   positions: Optional[torch.Tensor] = None,
                   fused: Optional[bool] = None, mesh=None) -> torch.Tensor:
    """``model``'s forward with tile-fused collectives at every
    tensor-parallel boundary (``transformer.fused_tp_apply``): the same
    logits as ``model(tokens)``.

    Every rank of ``mesh``'s ``tp`` group calls this with the same
    (replicated) parameters and tokens; ``mesh=None`` is a tp extent of 1.
    The layout is Megatron's sequence parallelism: the residual stream
    stays token-sharded between blocks (RMSNorm and the residual adds are
    per token), each column boundary gathers tokens inside its product
    (:func:`~horovod_tpu_torch.parallel.tensor_parallel.column_parallel_dense_ag`)
    and each row boundary reduce-scatters them back
    (:func:`~horovod_tpu_torch.parallel.tensor_parallel.row_parallel_dense_rs`),
    so all four projections of a layer run the matmul kernel.  One
    all-gather after ``ln_f`` reassembles the tokens for the tied head,
    a plain ``torch.matmul`` as the JAX package leaves it to XLA.

    Shape contract: ``seq % tp``, ``num_heads % tp`` and ``d_ff % tp`` must
    be 0.  ``fused=None`` reads the ``HOROVOD_FUSED_COLLECTIVES`` knob
    (:func:`~horovod_tpu_torch.ops.fused_collectives.resolve_fused_collectives`);
    ``fused=False`` keeps the same layout with unfused boundary
    collectives.  Gradients flow to ``model``'s parameters; at tp > 1 each
    rank's are its partials (as under the JAX package's ``shard_map``),
    which nothing here sums.
    """
    from horovod_tpu_torch.ops.fused_collectives import (
        group_rank,
        group_size,
        resolve_fused_collectives,
    )
    from horovod_tpu_torch.parallel.mesh import AXIS_TP
    from horovod_tpu_torch.parallel.tensor_parallel import (
        column_parallel_dense_ag,
        row_parallel_dense_rs,
    )

    if cfg.attention_impl not in ("dense", "flash"):
        raise ValueError(
            f"fused_tp_apply supports attention_impl dense|flash, got "
            f"{cfg.attention_impl!r} (ring/ulysses already own their "
            f"sequence axis)")
    if fused is None:
        fused = resolve_fused_collectives()
    group = mesh.group(AXIS_TP) if mesh is not None else None
    w, me = group_size(group), group_rank(group)
    b, t = tokens.shape
    d, heads, dt = cfg.d_model, cfg.num_heads, cfg.dtype
    if t % w or heads % w or cfg.d_ff % w:
        raise ValueError(
            f"fused_tp_apply needs seq ({t}), num_heads ({heads}) and "
            f"d_ff ({cfg.d_ff}) divisible by the tp extent {w}")
    t_loc, d_loc, f_loc = t // w, d // w, cfg.d_ff // w
    h_loc, hd = heads // w, cfg.head_dim
    if positions is None:
        positions = torch.arange(t, device=tokens.device)

    def rows(x_shard):
        """(b, t_loc, f) token shard -> (b·t_loc, f) rows in ``dt``."""
        return x_shard.reshape(b * t_loc, x_shard.shape[-1]).to(dt)

    def to_rank_major(full):
        """(b, t, f) natural tokens -> (w·b·t_loc, f) rank-major rows, the
        layout the reduce-scatter hands out."""
        f = full.shape[-1]
        return full.reshape(b, w, t_loc, f).transpose(0, 1) \
            .reshape(w * b * t_loc, f)

    def from_gathered(rows_, f):
        """(w·b·t_loc, f) rank-major gather output -> (b, t, f) natural."""
        return rows_.reshape(w, b, t_loc, f).transpose(0, 1).reshape(b, t, f)

    def cols(weight, width):
        """This rank's block of output features of an (out, in) weight, in
        ``dt``, as the (in, out_local) kernel view."""
        return weight[me * width:(me + 1) * width].to(dt).t()

    def in_rows(weight, width):
        """This rank's block of input features of an (out, in) weight, in
        ``dt``, as the (in_local, out) kernel view."""
        return weight[:, me * width:(me + 1) * width].to(dt).t()

    emb = model.embed.embedding
    x = F.embedding(tokens, emb).to(dt)                    # (b, t, d)
    # token-shard the residual stream: rank r owns tokens
    # [r·t_loc, (r+1)·t_loc) of every batch row
    x_shard = x[:, me * t_loc:(me + 1) * t_loc]
    for layer in model.layers:
        # -- attention: AG⊗qkv-matmul -> core -> proj-matmul⊗RS
        qkv_w = layer.attn.qkv.weight                        # (3d, d)
        if w == 1:
            wqkv = qkv_w.to(dt).t()
        else:
            # per-matrix column shards: a contiguous block of the fused
            # (3d, d) weight would span only one of q/k/v at tp > 3
            wqkv = torch.cat([qkv_w[j * d + me * d_loc:
                                    j * d + (me + 1) * d_loc]
                              for j in range(3)]).to(dt).t()
        qkv = column_parallel_dense_ag(rows(layer.ln1(x_shard)), wqkv,
                                       group=group, fused=fused)
        q, k, v = from_gathered(qkv, 3 * d_loc).split(d_loc, dim=-1)
        shape = (b, t, h_loc, hd)
        q, k, v = (a.reshape(shape) for a in (q, k, v))
        q = rotary_embedding(q, positions)
        k = rotary_embedding(k, positions)
        if cfg.attention_impl == "flash":
            o = flash_attention(q, k, v, causal=cfg.causal,
                                block_q=cfg.flash_block,
                                block_k=cfg.flash_block)
        else:
            o = reference_attention(q, k, v, causal=cfg.causal)
        y = row_parallel_dense_rs(
            to_rank_major(o.reshape(b, t, h_loc * hd)).to(dt),
            in_rows(layer.attn.proj.weight, d_loc), group=group, fused=fused)
        x_shard = x_shard + y.reshape(b, t_loc, d)

        # -- MLP: AG⊗wi-matmul -> gelu -> wo-matmul⊗RS.  The activation
        # stays rank-major between the two boundaries: gelu is elementwise
        hh = column_parallel_dense_ag(rows(layer.ln2(x_shard)),
                                      cols(layer.mlp.wi.weight, f_loc),
                                      group=group, fused=fused)
        hh = F.gelu(hh, approximate="tanh")
        y = row_parallel_dense_rs(hh.to(dt), in_rows(layer.mlp.wo.weight,
                                                     f_loc),
                                  group=group, fused=fused)
        x_shard = x_shard + y.reshape(b, t_loc, d)

    x_shard = model.ln_f(x_shard)
    if w == 1:
        x = x_shard
    else:
        # the one boundary-wide gather left: reassemble tokens for the tied
        # head (rank-major chunks -> natural order)
        import torch.distributed.nn.functional as dist_fn

        chunks = dist_fn.all_gather(x_shard.contiguous(), group=group)
        x = torch.stack(chunks).transpose(0, 1).reshape(b, t, d)
    # tied head as flax Embed.attend: both operands in cfg.dtype
    return x.to(dt) @ emb.to(dt).t()
