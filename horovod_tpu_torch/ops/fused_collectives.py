"""Tile-fused matmul⊗collective ops, the sp ring and the expert-parallel
dispatch over ``torch.distributed`` (``horovod_tpu/ops/pallas_kernels.py``:
``matmul_reducescatter``, ``allgather_matmul``,
``resolve_fused_collectives``, ``ring_flash_attention`` and its index math,
``expert_chunk_mlp`` and ``expert_alltoall_ffn``).

The tensor-parallel boundary ops of the Megatron sequence-parallel layout.
Where the JAX package streams tiles around a ``ppermute`` ring inside one
program, the port posts one ``dist.batch_isend_irecv`` send/receive pair per
hop on the tensor-parallel process group, and computes the next tile's
product with :func:`~horovod_tpu_torch.ops.kernels.pallas_matmul`'s kernel
while the hop is in flight.  Every rank posts the same pairs in the same
order, so the ring cannot deadlock.

``group`` is a ``torch.distributed`` process group, or ``None`` for a group
of this rank alone (a tensor-parallel extent of 1, where both ops are the
bare kernel, as in the JAX package).  Rows are rank-major: the gather
concatenates the ranks' row blocks in group-rank order and the scatter
hands group rank ``r`` the rows ``[r·m/world, (r+1)·m/world)``.

Gradients: the transpose of one ring is the other.  The dX of
``matmul_reducescatter`` is ``allgather_matmul(dy, wᵀ)`` and the dX of
``allgather_matmul`` is ``matmul_reducescatter(dy, wᵀ)``; dW is the local
product against the gathered operand, which the ring collects as it passes.

:func:`ring_flash_attention` passes K/V blocks around the sequence-parallel
group the same way, one hop a step, and consumes each visiting block with
the global-positions flash kernels.

:func:`expert_alltoall_ffn` moves MoE dispatch tiles around the ep group:
two ``all_to_all`` calls, or a ring whose hop ``s`` carries one tile to expert
rank ``me+s`` and its outputs home; :func:`expert_chunk_mlp` is the
per-tile expert MLP on kernel 6.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops import kernels as K
from horovod_tpu_torch.runtime.config import Config


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


#: valid values of the ``HOROVOD_FUSED_COLLECTIVES`` knob
FUSED_COLLECTIVES_MODES = ("auto", "on", "off")


def resolve_fused_collectives(mode: Optional[str] = None) -> bool:
    """Whether the boundary ops take the tile-fused rings
    (``pallas_kernels.resolve_fused_collectives``): ``"on"``/``"off"``
    force, and ``None`` reads the ``HOROVOD_FUSED_COLLECTIVES`` knob.

    ``"auto"``, the knob's default, is off.  The JAX package's ``"auto"``
    takes the rings on a TPU; on four NVLink H100s at the 870.9M model's
    shapes the rings (one NCCL send/receive pair a hop) took about twice
    the unfused collectives' time through ``fused_tp_apply``
    (``tp_bench.py``)."""
    if mode is None:
        mode = Config.from_env().fused_collectives
    if mode not in FUSED_COLLECTIVES_MODES:
        raise ValueError(f"fused_collectives must be one of "
                         f"{FUSED_COLLECTIVES_MODES}, got {mode!r}")
    return mode == "on"


def _hop(ts: Sequence[torch.Tensor], group, to: int, frm: int
         ) -> Tuple[List[torch.Tensor], List]:
    """Post one ring hop: send each of ``ts`` to group rank ``to`` and
    receive tensors like them from group rank ``frm``.  Returns the receive
    buffers and the requests to wait on before reading them."""
    bufs = [torch.empty_like(t) for t in ts]
    dst, src = dist.get_global_rank(group, to), dist.get_global_rank(group,
                                                                     frm)
    ops = [dist.P2POp(dist.isend, t, dst, group) for t in ts] + \
        [dist.P2POp(dist.irecv, buf, src, group) for buf in bufs]
    return bufs, dist.batch_isend_irecv(ops)


def _wait(requests) -> None:
    for req in requests:
        req.wait()


def _matmul_rs(x: torch.Tensor, w: torch.Tensor, group,
               fused: bool) -> torch.Tensor:
    """Forward of :func:`matmul_reducescatter` at a world above 1."""
    world, m = group_size(group), x.shape[0]
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    if not fused:
        y = K._mm(x, w, out_dtype)
        out = y.new_empty((m // world, y.shape[1]))
        dist.reduce_scatter_tensor(out, y, group=group)
        return out
    me = group_rank(group)
    tiles = x.reshape(world, m // world, x.shape[1])
    # start at tile (me-1) so that after world-1 send-right hops each rank
    # holds its OWN fully reduced tile; the partials are summed in fp32
    acc = K._mm(tiles[(me - 1) % world], w, torch.float32)
    for s in range(1, world):
        (got,), requests = _hop([acc], group, (me + 1) % world,
                                (me - 1) % world)
        part = K._mm(tiles[(me - 1 - s) % world], w, torch.float32)
        _wait(requests)
        acc = got.add_(part)
    return acc.to(out_dtype)


def _allgather_mm(x: torch.Tensor, w: torch.Tensor, group, fused: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward of :func:`allgather_matmul` at a world above 1; returns the
    product and the gathered ``x``."""
    world, m_local = group_size(group), x.shape[0]
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    x = x.contiguous()
    if not fused:
        full = x.new_empty((world * m_local, x.shape[1]))
        dist.all_gather_into_tensor(full, x, group=group)
        return K._mm(full, w, out_dtype), full
    me = group_rank(group)
    out = x.new_empty((world * m_local, w.shape[1]), dtype=out_dtype)
    full = x.new_empty((world * m_local, x.shape[1]))
    cur = x
    # send left = receive from the right neighbour: at hop s this rank
    # holds shard (me + s) % world
    for s in range(world):
        src = (me + s) % world
        rows = slice(src * m_local, (src + 1) * m_local)
        if s < world - 1:
            (nxt,), requests = _hop([cur], group, (me - 1) % world,
                                    (me + 1) % world)
        K._mm(cur, w, out_dtype, out=out[rows])
        full[rows].copy_(cur)
        if s < world - 1:
            _wait(requests)
            cur = nxt
    return out, full


class _MatmulReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group, fused):
        ctx.save_for_backward(x, w)
        ctx.group, ctx.fused = group, fused
        return _matmul_rs(x, w, group, fused)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(torch.promote_types(x.dtype, w.dtype))
        dx, dy_full = _allgather_mm(dy, w.t(), ctx.group, ctx.fused)
        dw = K.matmul_grad_w(x, dy_full, w) if ctx.needs_input_grad[1] \
            else None
        return dx.to(x.dtype), dw, None, None


class _AllgatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group, fused):
        out, full = _allgather_mm(x, w, group, fused)
        ctx.save_for_backward(full, w)
        ctx.group, ctx.fused, ctx.x_dtype = group, fused, x.dtype
        return out

    @staticmethod
    def backward(ctx, dy):
        full, w = ctx.saved_tensors
        dy = dy.to(torch.promote_types(full.dtype, w.dtype))
        dx = _matmul_rs(dy, w.t(), ctx.group, ctx.fused)
        dw = K.matmul_grad_w(full, dy, w) if ctx.needs_input_grad[1] \
            else None
        return dx.to(ctx.x_dtype), dw, None, None


def _check_2d(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{name} takes 2-D operands, got {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} (flatten leading dims first)")


def matmul_reducescatter(x: torch.Tensor, w: torch.Tensor, group=None,
                         fused: bool = True) -> torch.Tensor:
    """Fused ``reduce_scatter(x @ w)`` over ``group``: the row-parallel
    boundary op.  ``x`` is ``(m, k)`` with ``m`` divisible by the group's
    size, ``w`` this rank's ``(k, n)`` contraction shard; returns the
    reduced ``(m/world, n)`` row block this rank owns.

    Fused, each hop sends the fp32 partial of one output tile to the right
    neighbour while this rank computes its partial of the next tile;
    ``fused=False`` is the kernel followed by ``reduce_scatter_tensor``.  A
    group of one is the bare :func:`~horovod_tpu_torch.ops.kernels.pallas_matmul`."""
    _check_2d("matmul_reducescatter", x, w)
    world = group_size(group)
    if x.shape[0] % world:
        raise ValueError(f"matmul_reducescatter rows {x.shape[0]} not "
                         f"divisible by the group's size {world}")
    if world == 1:
        return K.pallas_matmul(x, w)
    if fused:
        matmul_reducescatter.launches += 1
    return _MatmulReduceScatter.apply(x, w, group, fused)


def allgather_matmul(x: torch.Tensor, w: torch.Tensor, group=None,
                     fused: bool = True) -> torch.Tensor:
    """Fused ``all_gather(x) @ w`` over ``group``: the column-parallel
    boundary op.  ``x`` is this rank's ``(m_local, k)`` row shard, ``w`` the
    ``(k, n)`` kernel; returns the full ``(world·m_local, n)`` product.

    Fused, each hop passes the row shard this rank holds to the left
    neighbour while this rank multiplies it; ``fused=False`` is
    ``all_gather_into_tensor`` followed by the kernel.  A group of one is
    the bare :func:`~horovod_tpu_torch.ops.kernels.pallas_matmul`."""
    _check_2d("allgather_matmul", x, w)
    world = group_size(group)
    if world == 1:
        return K.pallas_matmul(x, w)
    if fused:
        allgather_matmul.launches += 1
    return _AllgatherMatmul.apply(x, w, group, fused)


#: constructions of the fused rings, per op: the counterpart of the JAX
#: package's ``hvd_pallas_fused_launches_total{kernel}``
matmul_reducescatter.launches = 0
allgather_matmul.launches = 0


# ---------------------------------------------------------------------------
# the sp ring: index math (pallas_kernels.py:1039-1127) and ring-flash
# attention (:1130-1305)
# ---------------------------------------------------------------------------

#: sequence layouts the sp ring understands (``HOROVOD_SP_LAYOUT``)
RING_LAYOUTS = ("contiguous", "zigzag")


def _check_layout(layout: str) -> None:
    if layout not in RING_LAYOUTS:
        raise ValueError(
            f"sp layout must be one of {RING_LAYOUTS}, got {layout!r}")


def ring_layout_positions(rank: int, world: int, seq_local: int,
                          layout: str, device=None) -> torch.Tensor:
    """Global sequence positions (int32) that shard ``rank`` holds.

    ``contiguous``: shard r is global chunk r of ``world`` chunks.
    ``zigzag``: shard r holds chunks ``(r, 2·world−1−r)`` of ``2·world``
    equal chunks, pairing an early (causally light) chunk with a late one
    so that the causal work balances across ranks and no causal ring step
    is wholly masked."""
    _check_layout(layout)
    if layout == "contiguous":
        return rank * seq_local + torch.arange(seq_local, dtype=torch.int32,
                                               device=device)
    if seq_local % 2:
        raise ValueError(
            f"zigzag layout needs an even per-shard seq, got {seq_local}")
    half = seq_local // 2
    ar = torch.arange(half, dtype=torch.int32, device=device)
    return torch.cat([rank * half + ar, (2 * world - 1 - rank) * half + ar])


def zigzag_sequence_indices(world: int, seq_global: int) -> torch.Tensor:
    """Permutation σ with ``x_zigzag = x[:, σ]``: contiguous sharding of the
    permuted sequence hands shard r its zigzag chunks ``(r, 2·world−1−r)``
    (undo with ``argsort(σ)``)."""
    if seq_global % (2 * world):
        raise ValueError(
            f"zigzag needs seq divisible by 2·world={2 * world}, "
            f"got {seq_global}")
    half = seq_global // (2 * world)
    idx = []
    for r in range(world):
        idx.extend(range(r * half, (r + 1) * half))
        idx.extend(range((2 * world - 1 - r) * half,
                         (2 * world - r) * half))
    return torch.tensor(idx, dtype=torch.int64)


def _chunks(rank: int, world: int, layout: str) -> Tuple[int, ...]:
    return (rank,) if layout == "contiguous" else (rank, 2 * world - 1 - rank)


def ring_step_skipped(rank: int, step: int, world: int, layout: str) -> bool:
    """Whether causal ring step ``step`` of ``rank`` visits a block wholly
    in its future (so it launches no kernel): the exact chunk-level test
    ``max(q chunks) < min(k/v chunks)``, decided on the host."""
    return max(_chunks(rank, world, layout)) < \
        min(_chunks((rank - step) % world, world, layout))


def ring_step_schedule(world: int, causal: bool = False,
                       layout: str = "contiguous") -> dict:
    """Static kernel-launch schedule of the sp ring.  Under ``contiguous``
    a causal ring skips ``world·(world−1)/2`` of the ``world²`` launches,
    all on the low ranks; ``zigzag`` skips none."""
    _check_layout(layout)
    skipped = tuple(
        sum(ring_step_skipped(r, s, world, layout) for s in range(world))
        if causal else 0 for r in range(world))
    total = sum(skipped)
    return {
        "world": world, "causal": causal, "layout": layout,
        "steps_per_rank": world,
        "launches": world * world - total,
        "skipped": total,
        "skipped_by_rank": skipped,
    }


def _to_o(w_row: torch.Tensor, b: int, h: int, t: int) -> torch.Tensor:
    """A ``(b·h, t)`` row weight, broadcastable over ``(b, t, h, d)``."""
    return w_row.reshape(b, h, t).transpose(1, 2)[..., None]


class _RingFlash(torch.autograd.Function):
    """Forward: K/V travel one hop a step, the next hop posted before this
    step's kernel; the normalized partials ``(out_s, lse_s)`` merge in log
    space from the finite sentinel.  Backward: delta and lse are the global
    ones (the first step's dQ kernel computes delta from the merged O), dQ
    accumulates in fp32 here, and each block's dK/dV accumulator travels
    with the block, home after ``world`` hops."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale, layout):
        world, me = group_size(group), group_rank(group)
        b, t, h, _ = q.shape
        pos = [ring_layout_positions(r, world, t, layout, q.device)
               for r in range(world)] if causal else None
        out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full((b * h, t), K.NEG_INF, dtype=torch.float32,
                         device=q.device)
        kv = [k.contiguous(), v.contiguous()]
        for s in range(world):
            src = (me - s) % world
            if s < world - 1:
                nxt, requests = _hop(kv, group, (me + 1) % world,
                                     (me - 1) % world)
            if not (causal and ring_step_skipped(me, s, world, layout)):
                kw = dict(qpos=pos[me], kpos=pos[src]) if causal else {}
                out_s, lse_s = K.flash_fwd(q, *kv, causal, scale, **kw)
                # all finite: exp(NEG_INF - anything) is exactly 0
                lse_new = torch.logaddexp(lse, lse_s)
                out = out * _to_o(torch.exp(lse - lse_new), b, h, t) + \
                    out_s.float() * _to_o(torch.exp(lse_s - lse_new), b, h, t)
                lse = lse_new
            if s < world - 1:
                _wait(requests)
                kv = nxt
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale, ctx.layout = group, causal, scale, \
            layout
        ctx.pos = pos
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale, pos = ctx.group, ctx.causal, ctx.scale, ctx.pos
        world, me = group_size(group), group_rank(group)
        g = g.to(q.dtype).contiguous()
        delta = None         # the first step's dQ kernel computes it from out
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        acc = [torch.zeros(k.shape, dtype=torch.float32, device=k.device),
               torch.zeros(v.shape, dtype=torch.float32, device=v.device)]
        kv = [k.contiguous(), v.contiguous()]
        to, frm = (me + 1) % world, (me - 1) % world
        acc_requests = None
        for s in range(world):
            src = (me - s) % world
            if s < world - 1:
                nxt, requests = _hop(kv, group, to, frm)
            live = not (causal and ring_step_skipped(me, s, world, ctx.layout))
            if live:
                kw = dict(qpos=pos[me], kpos=pos[src]) if causal else {}
                # step 0 visits this rank's own block, which is always live
                dq_s, delta = K.flash_bwd_dq(
                    q, *kv, g, lse, delta, causal, scale,
                    out=out if delta is None else None, **kw)
                dk_s, dv_s = K.flash_bwd_dkv(q, *kv, g, lse, delta, causal,
                                             scale, **kw)
            if acc_requests is not None:
                _wait(acc_requests)
                acc = acc_in
            if live:
                dq += dq_s.float()
                acc[0] += dk_s.float()
                acc[1] += dv_s.float()
            if world > 1:
                # the accumulators hop with their block every step; the
                # world-th hop is the homecoming
                acc_in, acc_requests = _hop(acc, group, to, frm)
            if s < world - 1:
                _wait(requests)
                kv = nxt
        if acc_requests is not None:
            _wait(acc_requests)
            acc = acc_in
        return (dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype),
                None, None, None, None)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group=None, causal: bool = False,
                         scale: Optional[float] = None,
                         layout: str = "contiguous", block_q: int = 512,
                         block_k: int = 512) -> torch.Tensor:
    """Fused sp-ring ⊗ flash attention over ``group``
    (``pallas_kernels.ring_flash_attention``): the exact softmax attention
    of this rank's ``(batch, seq_local, heads, head_dim)`` queries over the
    whole group's sequence, differentiable.

    Every rank of ``group`` calls this with its shard; ``group=None`` is a
    group of this rank alone.  Each visiting K/V block runs the flash
    kernels, under ``causal`` their global-positions variant
    (:func:`~horovod_tpu_torch.ops.kernels.flash_fwd` with ``qpos`` and
    ``kpos``), with positions
    computed on the host from ``layout`` per (rank, step) rather than sent;
    a causal step whose block lies wholly in the future is skipped on the
    host (:func:`ring_step_skipped`).  Partials merge in log space::

        lse = logaddexp(lse, lse_s)
        out = out·exp(lse_prev − lse) + out_s·exp(lse_s − lse)

    from the finite sentinel, so a fully masked partial adds exactly 0.

    Raises for shards off the flash tiling contract (unequal q/k/v shapes,
    a ``seq_local`` that :func:`~horovod_tpu_torch.ops.kernels.fit_flash_block`
    rejects, an odd ``seq_local`` under zigzag); the dispatch in
    ``parallel/ring_attention.py`` checks first and takes the plain ring."""
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"ring_flash_attention needs equal q/k/v shard shapes, got "
            f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    t, d = q.shape[1], q.shape[-1]
    if K.fit_flash_block(t, block_q) is None or \
            K.fit_flash_block(t, block_k) is None:
        raise ValueError(
            f"seq_local {t} does not fit the flash tiling contract; use the "
            f"plain ring (parallel.ring_attention) instead")
    _check_layout(layout)
    if layout == "zigzag" and t % 2:
        raise ValueError(f"zigzag layout needs an even per-shard seq, got {t}")
    scale = d ** -0.5 if scale is None else scale
    ring_flash_attention.launches += 1
    return _RingFlash.apply(q, k, v, group, causal, scale, layout)


#: constructions of the fused sp ring (JAX ``hvd_pallas_fused_launches_total``)
ring_flash_attention.launches = 0


# ---------------------------------------------------------------------------
# the expert-parallel dispatch: expert_chunk_mlp (pallas_kernels.py:880) and
# the a2a ⊗ expert-matmul ring (:897)
# ---------------------------------------------------------------------------

def expert_chunk_mlp(chunk: torch.Tensor, w1: torch.Tensor,
                     w2: torch.Tensor) -> torch.Tensor:
    """Per-expert gelu MLP over one ``(e_local, slots, d)`` token chunk
    (``pallas_kernels.expert_chunk_mlp``): each expert's two products run
    :func:`~horovod_tpu_torch.ops.kernels.pallas_matmul` (kernel 6 on a
    card for bf16 operands on its tiling contract, the plain product
    otherwise), batched by a loop over the local experts.  ``w1`` is
    ``(e_local, d, f)``, ``w2`` ``(e_local, f, d)``; the hidden activation
    is rounded to the operands' dtype, the result to ``chunk``'s."""
    outs = []
    for e in range(chunk.shape[0]):
        h = K.pallas_matmul(chunk[e], w1[e])
        outs.append(K.pallas_matmul(
            torch.nn.functional.gelu(h, approximate="tanh"), w2[e],
            out_dtype=chunk.dtype))
    return torch.stack(outs)


def _expert_vjp_graph(expert_fn, tile: torch.Tensor, track: bool):
    """``expert_fn(tile)``; with ``track``, also the graph from a leaf copy
    of ``tile`` that the ring's backward differentiates."""
    if not track:
        return expert_fn(tile), None
    leaf = tile.detach().requires_grad_()
    with torch.enable_grad():
        out = expert_fn(leaf)
    return out.detach(), (leaf, out)


class _ExpertRing(torch.autograd.Function):
    """The fused ring, forward and backward.  Forward, hop ``s``: send the
    tile for rank ``me+s`` and receive rank ``me−s``'s tile for my experts
    (hop ``s+1`` is posted before hop ``s``'s tile enters ``expert_fn``),
    then send its outputs home to ``me−s`` and receive mine from
    ``me+s``.  Backward runs the same ring on the gradients: each output
    tile's gradient goes back to the rank that computed it, the expert
    body's vector-Jacobian product runs there (from the graph the forward
    kept), and the dispatch gradient rides home.  ``params`` (the tensors
    ``expert_fn`` reads) receive their summed gradients."""

    @staticmethod
    def forward(ctx, dispatch, expert_fn, group, n_params, *params):
        world, me = group_size(group), group_rank(group)
        track = any(ctx.needs_input_grad[i] for i in (0, *range(
            4, 4 + n_params)))
        tiles = [dispatch[(me + s) % world].contiguous()
                 for s in range(world)]
        graphs = []
        pending = _hop([tiles[1]], group, (me + 1) % world,
                       (me - 1) % world)
        out0, g0 = _expert_vjp_graph(expert_fn, tiles[0], track)
        chunks, homes = [out0], []
        graphs.append(g0)
        for s in range(1, world):
            (got,), requests = pending
            _wait(requests)
            if s + 1 < world:
                pending = _hop([tiles[s + 1]], group, (me + s + 1) % world,
                               (me - s - 1) % world)
            y, g = _expert_vjp_graph(expert_fn, got, track)
            graphs.append(g)
            (back,), requests = _hop([y.contiguous()], group,
                                     (me - s) % world, (me + s) % world)
            homes.append(requests)
            chunks.append(back)
        for requests in homes:
            _wait(requests)
        ctx.graphs, ctx.group, ctx.params = graphs, group, params
        # chunks[s] holds my tokens' outputs from expert rank me+s: roll to
        # the unfused all_to_all's source-rank order
        return torch.roll(torch.stack(chunks), me, 0)

    @staticmethod
    def backward(ctx, grad):
        group, graphs, params = ctx.group, ctx.graphs, ctx.params
        world, me = group_size(group), group_rank(group)
        needs = [p.requires_grad for p in params]
        g_params = [None] * len(params)

        def vjp(s, g_out):
            leaf, out = graphs[s]
            inputs = [leaf] + [p for p, n in zip(params, needs) if n]
            got = torch.autograd.grad(out, inputs, g_out, allow_unused=True)
            it = iter(got[1:])
            for i, n in enumerate(needs):
                if n:
                    gp = next(it)
                    if gp is not None:
                        g_params[i] = gp if g_params[i] is None else \
                            g_params[i] + gp
            return got[0]

        g_tiles = [grad[(me + s) % world].contiguous() for s in range(world)]
        g_disp = grad.new_empty((world,) + grad.shape[1:])
        pending = _hop([g_tiles[1]], group, (me + 1) % world,
                       (me - 1) % world)
        g_disp[me] = vjp(0, g_tiles[0])
        homes = []
        for s in range(1, world):
            (g_out,), requests = pending
            _wait(requests)
            if s + 1 < world:
                pending = _hop([g_tiles[s + 1]], group, (me + s + 1) % world,
                               (me - s - 1) % world)
            g_in = vjp(s, g_out)
            (back,), requests = _hop([g_in.contiguous()], group,
                                     (me - s) % world, (me + s) % world)
            homes.append((requests, back, (me + s) % world))
        for requests, back, src in homes:
            _wait(requests)
            g_disp[src] = back
        ctx.graphs = None
        return (g_disp, None, None, None, *g_params)


def expert_alltoall_ffn(dispatch: torch.Tensor, expert_fn, group=None,
                        fused: bool = True,
                        params: Optional[Sequence[torch.Tensor]] = None
                        ) -> torch.Tensor:
    """The MoE dispatch → expert → combine exchange over ``group``
    (``pallas_kernels.expert_alltoall_ffn``), differentiable.

    ``dispatch`` is this rank's ``(world, e_local, capacity, d)`` routed
    token buffer, dim 0 the destination expert rank; ``expert_fn`` applies
    this rank's local experts to an ``(e_local, slots, d)`` buffer and must
    be token-wise.  Returns the ``(world, e_local, capacity, d)`` expert
    outputs back at this rank, dim 0 the expert rank that computed them.

    ``fused=False``: two ``all_to_all_single`` calls around one
    ``expert_fn`` call over the whole ``world·capacity`` buffer (their
    gradient is the inverse exchange).  ``fused=True``: the ring of
    :class:`_ExpertRing`, one tile per hop in each direction, one
    ``dist.batch_isend_irecv`` pair per hop posted in the same order on
    every rank, with the next hop in flight while ``expert_fn`` computes;
    ``params`` are the tensors ``expert_fn`` reads that need gradients
    (the ring's ``autograd.Function`` returns theirs).  The ring is the JAX
    package's schedule, kept for parity: eager NCCL hops hide little
    under the expert body, and at one MoE layer's shapes on four H100s
    it is the slower schedule (``ep_bench.py``).  A group of one is
    ``expert_fn(dispatch[0])[None]``."""
    import torch.distributed.nn.functional as dist_fn

    if dispatch.dim() != 4:
        raise ValueError(
            f"expert_alltoall_ffn takes a (world, e_local, capacity, d) "
            f"dispatch buffer, got shape {tuple(dispatch.shape)}")
    world = group_size(group)
    if dispatch.shape[0] != world:
        raise ValueError(
            f"dispatch dim 0 is {dispatch.shape[0]} but the ep group has "
            f"size {world}")
    _, e_local, capacity, d = dispatch.shape
    if world == 1:
        return expert_fn(dispatch[0])[None]
    if not fused:
        received = dist_fn.all_to_all_single(
            torch.empty_like(dispatch), dispatch.contiguous(), group=group)
        buffers = received.transpose(0, 1).reshape(e_local, world * capacity,
                                                   d)
        outputs = expert_fn(buffers).reshape(e_local, world, capacity, d) \
            .transpose(0, 1).contiguous()
        return dist_fn.all_to_all_single(torch.empty_like(outputs), outputs,
                                         group=group)
    expert_alltoall_ffn.launches += 1
    params = tuple(params or ())
    if not torch.is_grad_enabled():
        # apply() reports the inputs' requires_grad even under no_grad:
        # hand it nothing to differentiate, so no tile keeps a graph
        dispatch, params = dispatch.detach(), ()
    return _ExpertRing.apply(dispatch, expert_fn, group, len(params),
                             *params)


#: constructions of the fused expert ring (JAX
#: ``hvd_pallas_fused_launches_total{kernel="a2a_matmul"}``)
expert_alltoall_ffn.launches = 0
