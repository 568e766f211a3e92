"""The port's hand-written Hopper kernels, their wrappers and plain versions.

Counterpart of ``horovod_tpu/ops/pallas_kernels.py``.  Each kernel is an
operator of the dispatcher, ``torch.ops.hvd_torch.<op>``
(``torch.library.custom_op``): its CPU kernel is the plain PyTorch version
with the Pallas kernel's exact semantics, its CUDA kernel the launch of
``csrc/*.cu`` (built on first use by :mod:`.build`, called through
ctypes), and its fake kernel gives tracing the output's shapes and dtypes.
So ``torch.export`` and AOTInductor keep each op as one opaque call
(``runtime/compile_cache.aot_compile``), and dispatch modes (the remat
tiers, ``memory/remat.py``) see it.  A real meta tensor, like any tensor
that is neither on the CPU nor on a card, raises; nothing falls back.

Each kernel also has a wrapper, the entry point the rest of the port
calls, which keeps the dispatch rule (what the op computes and what takes
the plain path on a card) and glues the ops into ``torch.autograd.Function``
s.  A launch counts in a plain integer attribute of the wrapper,
``<wrapper>.launches`` (the flash wrappers count their global-positions
variant apart, in ``<wrapper>.pos_launches``), bumped in the op's CUDA
kernel, so a launch from an AOT package counts too.

Kernels (TPU source → op → CUDA source):

* :func:`fused_scale` (``pallas_kernels.fused_scale``) →
  ``hvd_torch::fused_scale`` (writes its ``out``; ``x`` None scales ``out``
  in place) → ``csrc/fused_scale.cu``: the exchange's pre/postscale and
  wire cast.
* :func:`flash_fwd`, :func:`flash_bwd_dq`, :func:`flash_bwd_dkv`
  (``pallas_kernels._flash_fwd`` / ``_flash_bwd``) →
  ``hvd_torch::flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv`` →
  ``csrc/flash_attention.cu``, glued by :func:`flash_attention`'s
  ``torch.autograd.Function``.  With ``qpos``/``kpos`` the same ops
  launch the kernels' global-positions variant (the Pallas kernels'
  ``positions=True``), which the sp ring
  (:func:`~horovod_tpu_torch.ops.fused_collectives.ring_flash_attention`)
  launches per visiting block.
* :func:`fused_conv_bn_relu_bwd` (``pallas_kernels.fused_conv_bn_relu_bwd``)
  → ``hvd_torch::cbr_bwd`` → ``csrc/conv_bn_relu_bwd.cu``, the backward of
  ResNet's stride-1 3x3 segment, glued by :func:`fused_conv_bn_relu`'s
  ``torch.autograd.Function``.
* :func:`pallas_matmul` (``pallas_kernels.pallas_matmul``) →
  ``hvd_torch::pallas_matmul`` (and ``pallas_matmul_out``, which writes a
  row block of the tp ring's output in place) → ``csrc/matmul.cu``: the
  blocked product with fp32 accumulation that the tensor-parallel ring ops
  (:mod:`.fused_collectives`) compute per tile; its own
  ``torch.autograd.Function`` runs dX and dW through it too.

Each op but ``fused_scale`` has a flop formula
(``torch.utils.flop_counter``, read by :mod:`~horovod_tpu_torch.utils.trace`)
that counts the dense work it replaces, whatever its launch computes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

#: the Pallas kernels' finite masking sentinel (pallas_kernels.py _NEG_INF)
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

#: head_dims the CUDA flash kernels are instantiated for
FLASH_HEAD_DIMS = (64, 128)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _cuda_library(x: torch.Tensor):
    """(library, stream handle) for a launch on ``x``'s device."""
    if not x.is_cuda:
        raise ValueError(
            f"the CUDA kernels take CUDA tensors, got one on {x.device}")
    from horovod_tpu_torch.ops.build import load_library

    return load_library(), torch.cuda.current_stream(x.device).cuda_stream


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _no_meta_launch(x: torch.Tensor) -> None:
    """The ops' fake kernels serve tracing (fake tensors: ``torch.export``,
    ``opcheck``); a real tensor on the meta device would reach a launch
    there, which the kernels refuse as they refuse any non-CUDA tensor."""
    from torch._subclasses.fake_tensor import is_fake

    if not is_fake(x):
        raise ValueError(
            f"the CUDA kernels take CUDA tensors, got one on {x.device}")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return x


# ---------------------------------------------------------------------------
# fused scale (+ cast)
# ---------------------------------------------------------------------------

def fused_scale_plain(x: torch.Tensor, factor: float,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """``(x.f32 * factor).astype(out_dtype)`` — ``_scale_kernel``."""
    return (x.float() * factor).to(out_dtype)


def fused_scale_kernel_takes(x: torch.Tensor,
                             out_dtype: torch.dtype) -> bool:
    """Whether ``csrc/fused_scale.cu`` computes this pass: a CUDA tensor
    and both dtypes among float32, bfloat16 and float16.  :func:`fused_scale`
    reads this by dtype before any launch; anything else (float64 on a
    card) computes :func:`fused_scale_plain`, through fp32 as the JAX
    package's ``fused_scale`` does."""
    return (x.device.type != "cpu" and x.dtype in _DTYPE_CODES
            and out_dtype in _DTYPE_CODES)


def fused_scale(x: torch.Tensor, factor: float,
                out_dtype: Optional[torch.dtype] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x * factor`` in fp32, cast to ``out_dtype``, in one pass over any
    shape (no padding).  ``out`` (contiguous, ``x``'s shape, ``out_dtype``)
    receives the result; it may be ``x`` itself when the dtype is
    unchanged, which the exchange uses to scale a bucket in place.  A CPU
    tensor, or a card's tensor the kernel takes
    (:func:`fused_scale_kernel_takes`), runs ``hvd_torch::fused_scale``
    into ``out`` (allocated when not given): its CPU kernel is
    :func:`fused_scale_plain`, its CUDA kernel the launch.  A card's
    tensor the kernel does not take computes :func:`fused_scale_plain`."""
    out_dtype = out_dtype or x.dtype
    if out is not None and (out.dtype != out_dtype or out.shape != x.shape
                            or not out.is_contiguous()):
        raise ValueError("out must be contiguous with x's shape and "
                         "out_dtype")
    if x.device.type != "cpu" and not fused_scale_kernel_takes(x, out_dtype):
        y = fused_scale_plain(x, factor, out_dtype)
        return y if out is None else out.copy_(y)
    if out is None:
        out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    torch.ops.hvd_torch.fused_scale(out, None if x is out else x,
                                    float(factor))
    return out


def _launch_fused_scale(x: torch.Tensor, factor: float,
                        out_dtype: torch.dtype,
                        out: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch ``csrc/fused_scale.cu`` on ``x`` (``out`` already checked,
    and may be ``x``); raises on a dtype the kernel does not take."""
    if x.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise TypeError(f"the fused_scale kernel takes {list(_DTYPE_CODES)}"
                        f", got {x.dtype} -> {out_dtype}")
    lib, stream = _cuda_library(x)
    # the kernel takes 16-byte aligned pointers; a misaligned out is
    # written through an aligned temporary
    dst = out if out is not None and out.data_ptr() % 16 == 0 else \
        torch.empty(x.shape, dtype=out_dtype, device=x.device)
    src = x if x is dst else _aligned(x)
    if src.numel():
        _check(lib.hvd_fused_scale(src.data_ptr(), dst.data_ptr(),
                                   src.numel(), float(factor),
                                   _DTYPE_CODES[src.dtype],
                                   _DTYPE_CODES[out_dtype], stream),
               "fused_scale")
        fused_scale.launches += 1
    if out is None or out is dst:
        return dst
    return out.copy_(dst)


@torch.library.custom_op(
    "hvd_torch::fused_scale", mutates_args=("out",), device_types="cpu",
    schema="(Tensor(a!) out, Tensor? x, float factor) -> ()")
def _fused_scale_op(out: torch.Tensor, x: Optional[torch.Tensor],
                    factor: float) -> None:
    """``out = (x.f32 * factor).astype(out.dtype)``, ``x`` None for in
    place; the CPU kernel is the plain version."""
    out.copy_(fused_scale_plain(out if x is None else x, factor, out.dtype))


@_fused_scale_op.register_kernel("cuda")
def _fused_scale_cuda(out, x, factor):
    _launch_fused_scale(out if x is None else x, factor, out.dtype, out)


@_fused_scale_op.register_fake
def _fused_scale_fake(out, x, factor):
    _no_meta_launch(out)


fused_scale.launches = 0


# ---------------------------------------------------------------------------
# flash attention: plain versions
# ---------------------------------------------------------------------------

def _visible(t: int, causal: bool, device, qpos=None,
             kpos=None) -> Optional[torch.Tensor]:
    """The causal mask over local indices, or with ``qpos``/``kpos`` over
    global positions (``qpos[i] >= kpos[j]``); None without ``causal``."""
    if not causal:
        return None
    if qpos is not None:
        return qpos[:, None] >= kpos[None, :]
    pos = torch.arange(t, device=device)
    return pos[:, None] >= pos[None, :]


def _scores(q, k, scale, mask):
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return s if mask is None else s.masked_fill(~mask, NEG_INF)


def flash_fwd_plain(q, k, v, causal: bool, scale: float, qpos=None,
                    kpos=None):
    """Forward of ``_flash_fwd_kernel``: O in q's dtype and the per-row
    fp32 logsumexp as ``(b*h, t)``.  Probabilities are rounded to v's
    dtype for the PV product, as the kernel does for the MXU.  With
    ``qpos``/``kpos`` ((t,) global positions) the causal mask compares
    those; a row that sees no key gets O = 0 and lse = NEG_INF."""
    b, t, h, d = q.shape
    mask = _visible(t, causal, q.device, qpos, kpos)
    s = _scores(q, k, scale, mask)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    l_safe = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = o / l_safe.permute(0, 2, 1, 3)
    lse = (m + torch.log(l_safe)).reshape(b * h, t)
    return o.to(q.dtype), lse


def _bwd_parts(q, k, v, do, lse, delta, causal, scale, qpos, kpos):
    b, t, h, d = q.shape
    mask = _visible(t, causal, q.device, qpos, kpos)
    p = torch.exp(_scores(q, k, scale, mask) - lse.reshape(b, h, t, 1))
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta.reshape(b, h, t, 1))).to(k.dtype)
    return p, ds


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool, scale: float,
                       qpos=None, kpos=None):
    """dQ of ``_flash_bwd_dq_kernel``: dS = P∘(dP − delta) in k's dtype,
    dQ = dS·K·scale.  ``lse`` and ``delta`` may be global (the sp ring's)."""
    _, ds = _bwd_parts(q, k, v, do, lse, delta, causal, scale, qpos, kpos)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.float(), k.float()) * scale
    return dq.to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool,
                        scale: float, qpos=None, kpos=None):
    """dK/dV of ``_flash_bwd_dkv_kernel``: dV = Pᵀ·dO, dK = dSᵀ·Q·scale."""
    p, ds = _bwd_parts(q, k, v, do, lse, delta, causal, scale, qpos, kpos)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.float(), q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO ∘ O) as ``(b*h, t)`` fp32 — a plain elementwise
    pass in the JAX package (``_flash_bwd``), not a Pallas call; on a card
    the dQ kernel computes it in its prologue (:func:`flash_bwd_dq` with
    ``out``)."""
    b, t, h, _ = out.shape
    delta = (do.float() * out.float()).sum(-1)          # (b, t, h)
    return delta.transpose(1, 2).reshape(b * h, t).contiguous()


# ---------------------------------------------------------------------------
# flash attention: kernel wrappers
# ---------------------------------------------------------------------------

def flash_kernels_take(*xs: torch.Tensor) -> bool:
    """Whether the flash wrappers compute these inputs: on the CPU their
    plain versions take any float dtype and head_dim; on a card the CUDA
    kernels take bfloat16 with a head_dim in :data:`FLASH_HEAD_DIMS`.  The
    dispatch (:func:`flash_attention`, ``ring_attention``) reads this by
    dtype and shape before any launch and sends what the kernels refuse to
    the plain path, as it sends a t that :func:`fit_flash_block` refuses;
    the JAX package computes both cases."""
    return xs[0].device.type == "cpu" or (
        xs[0].shape[-1] in FLASH_HEAD_DIMS
        and all(x.dtype == torch.bfloat16 for x in xs))


def _flash_inputs(*xs: torch.Tensor):
    """Validate bf16 (b, t, h, d) inputs of one shape for the CUDA kernels
    and return them contiguous and 16-byte aligned."""
    shape = xs[0].shape
    for x in xs:
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the flash kernels take bfloat16, got {x.dtype}")
        if x.dim() != 4 or x.shape != shape or x.device != xs[0].device:
            raise ValueError("flash inputs must share one (b, t, h, d) shape "
                             "and device")
    if shape[-1] not in FLASH_HEAD_DIMS:
        raise ValueError(f"the flash kernels support head_dim "
                         f"{FLASH_HEAD_DIMS}, got {shape[-1]}")
    return [_aligned(x) for x in xs]


def _rows(x: torch.Tensor, b: int, h: int, t: int) -> torch.Tensor:
    if x.shape != (b * h, t) or x.dtype != torch.float32:
        raise ValueError(f"expected fp32 ({b * h}, {t}), got {x.dtype} "
                         f"{tuple(x.shape)}")
    return _aligned(x)


def _positions(qpos, kpos, t: int, device) -> Tuple:
    """(qpos, kpos, data pointers) for a launch: both None (local indices)
    or both (t,) integer vectors on ``device``, as contiguous int32."""
    if qpos is None and kpos is None:
        return None, None, (None, None)
    if qpos is None or kpos is None:
        raise ValueError("pass both qpos and kpos, or neither")
    out = []
    for pos in (qpos, kpos):
        if pos.shape != (t,) or pos.is_floating_point() or \
                pos.device != device:
            raise ValueError(f"positions must be ({t},) integers on "
                             f"{device}, got {pos.dtype} {tuple(pos.shape)} "
                             f"on {pos.device}")
        out.append(_aligned(pos.to(torch.int32)))
    return out[0], out[1], (out[0].data_ptr(), out[1].data_ptr())


def flash_fwd(q, k, v, causal: bool, scale: float, qpos=None, kpos=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """O and lse ``(b*h, t)`` of causal or full attention over
    ``(b, t, h, d)`` inputs (``_flash_fwd``) through
    ``hvd_torch::flash_fwd``; with ``qpos``/``kpos`` ((t,) integer global
    positions) the global-positions variant, which masks by ``qpos[i] >=
    kpos[j]``, skips only the tiles those hide and counts in
    ``flash_fwd.pos_launches``."""
    return torch.ops.hvd_torch.flash_fwd(q, k, v, bool(causal), float(scale),
                                         qpos, kpos)


def _launch_flash_fwd(q, k, v, causal, scale, qpos=None, kpos=None):
    """``hvd_torch::flash_fwd``'s CUDA kernel: ``_flash_fwd`` on a card."""
    q, k, v = _flash_inputs(q, k, v)
    b, t, h, d = q.shape
    qpos, kpos, ptrs = _positions(qpos, kpos, t, q.device)
    lib, stream = _cuda_library(q)
    o = torch.empty_like(q)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    _check(lib.hvd_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             o.data_ptr(), lse.data_ptr(), *ptrs, b, t, h, d,
                             float(scale), int(causal), stream), "flash_fwd")
    if qpos is None:
        flash_fwd.launches += 1
    else:
        flash_fwd.pos_launches += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float,
                 qpos=None, kpos=None, out=None):
    """dQ from the forward's lse and delta (``_flash_bwd_dq_kernel``)
    through ``hvd_torch::flash_bwd_dq``; with ``qpos``/``kpos`` the
    global-positions variant.  Returns ``(dq, delta)``.  Pass
    ``delta=None`` and the forward's O as ``out`` to have delta =
    rowsum(dO∘O) computed here (on a card in the kernel's prologue, which
    writes it out for the dK/dV kernel), or a ``(b*h, t)`` fp32 ``delta``
    (the sp ring's later steps), not both; a given delta comes back as it
    is (the op returns a new one only when it computed it)."""
    if (delta is None) == (out is None):
        raise ValueError("pass delta, or out to compute it from, not both")
    dq, computed = torch.ops.hvd_torch.flash_bwd_dq(
        q, k, v, do, lse, delta, bool(causal), float(scale), qpos, kpos, out)
    return dq, computed if delta is None else delta


def _launch_flash_bwd_dq(q, k, v, do, lse, delta, causal, scale, qpos=None,
                         kpos=None, out=None):
    """``hvd_torch::flash_bwd_dq``'s CUDA kernel; the delta it returns is
    the one it computed, or an empty tensor when ``delta`` was given."""
    q, k, v, do, *o = _flash_inputs(q, k, v, do, *([] if out is None
                                                    else [out]))
    b, t, h, d = q.shape
    lse = _rows(lse, b, h, t)
    if delta is None:
        delta = computed = torch.empty((b * h, t), dtype=torch.float32,
                                       device=q.device)
        o_ptr = o[0].data_ptr()
    else:
        delta, o_ptr = _rows(delta, b, h, t), None
        computed = q.new_empty((0,), dtype=torch.float32)
    qpos, kpos, ptrs = _positions(qpos, kpos, t, q.device)
    lib, stream = _cuda_library(q)
    dq = torch.empty_like(q)
    _check(lib.hvd_flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                do.data_ptr(), lse.data_ptr(),
                                delta.data_ptr(), dq.data_ptr(), *ptrs, o_ptr,
                                b, t, h, d, float(scale), int(causal),
                                stream), "flash_bwd_dq")
    if qpos is None:
        flash_bwd_dq.launches += 1
    else:
        flash_bwd_dq.pos_launches += 1
    return dq, computed


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float,
                  qpos=None, kpos=None):
    """dK and dV from the forward's lse and delta
    (``_flash_bwd_dkv_kernel``) through ``hvd_torch::flash_bwd_dkv``,
    delta as :func:`flash_bwd_dq` returns it; with ``qpos``/``kpos`` the
    global-positions variant."""
    return torch.ops.hvd_torch.flash_bwd_dkv(
        q, k, v, do, lse, delta, bool(causal), float(scale), qpos, kpos)


def _launch_flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale, qpos=None,
                          kpos=None):
    """``hvd_torch::flash_bwd_dkv``'s CUDA kernel."""
    q, k, v, do = _flash_inputs(q, k, v, do)
    b, t, h, d = q.shape
    lse, delta = _rows(lse, b, h, t), _rows(delta, b, h, t)
    qpos, kpos, ptrs = _positions(qpos, kpos, t, q.device)
    lib, stream = _cuda_library(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _check(lib.hvd_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 do.data_ptr(), lse.data_ptr(),
                                 delta.data_ptr(), dk.data_ptr(),
                                 dv.data_ptr(), *ptrs, b, t, h, d,
                                 float(scale), int(causal), stream),
           "flash_bwd_dkv")
    if qpos is None:
        flash_bwd_dkv.launches += 1
    else:
        flash_bwd_dkv.pos_launches += 1
    return dk, dv


flash_fwd.launches = flash_fwd.pos_launches = 0
flash_bwd_dq.launches = flash_bwd_dq.pos_launches = 0
flash_bwd_dkv.launches = flash_bwd_dkv.pos_launches = 0


def _contiguous(*xs):
    return tuple(x.contiguous() for x in xs)


@torch.library.custom_op(
    "hvd_torch::flash_fwd", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, bool causal, float scale, "
           "Tensor? qpos=None, Tensor? kpos=None) -> (Tensor, Tensor)")
def _flash_fwd_op(q, k, v, causal, scale, qpos=None, kpos=None):
    """The CPU kernel: :func:`flash_fwd_plain`."""
    return _contiguous(*flash_fwd_plain(q, k, v, causal, scale, qpos, kpos))


_flash_fwd_op.register_kernel("cuda")(_launch_flash_fwd)


@_flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, causal, scale, qpos=None, kpos=None):
    _no_meta_launch(q)
    b, t, h, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((b * h, t), dtype=torch.float32)


@torch.library.custom_op(
    "hvd_torch::flash_bwd_dq", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, Tensor dout, Tensor lse, "
           "Tensor? delta, bool causal, float scale, Tensor? qpos=None, "
           "Tensor? kpos=None, Tensor? out=None) -> (Tensor, Tensor)")
def _flash_bwd_dq_op(q, k, v, dout, lse, delta, causal, scale, qpos=None,
                     kpos=None, out=None):
    """The CPU kernel: :func:`flash_bwd_dq_plain`, delta from
    :func:`flash_delta` when not given (else an empty second result)."""
    computed = flash_delta(out, dout) if delta is None else \
        lse.new_empty((0,))
    dq = flash_bwd_dq_plain(q, k, v, dout, lse,
                            computed if delta is None else delta, causal,
                            scale, qpos, kpos)
    return dq.contiguous(), computed


_flash_bwd_dq_op.register_kernel("cuda")(_launch_flash_bwd_dq)


@_flash_bwd_dq_op.register_fake
def _flash_bwd_dq_fake(q, k, v, dout, lse, delta, causal, scale, qpos=None,
                       kpos=None, out=None):
    _no_meta_launch(q)
    b, t, h, _ = q.shape
    rows = (b * h, t) if delta is None else (0,)
    return q.new_empty(q.shape), q.new_empty(rows, dtype=torch.float32)


@torch.library.custom_op(
    "hvd_torch::flash_bwd_dkv", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, Tensor dout, Tensor lse, "
           "Tensor delta, bool causal, float scale, Tensor? qpos=None, "
           "Tensor? kpos=None) -> (Tensor, Tensor)")
def _flash_bwd_dkv_op(q, k, v, dout, lse, delta, causal, scale, qpos=None,
                      kpos=None):
    """The CPU kernel: :func:`flash_bwd_dkv_plain`."""
    return _contiguous(*flash_bwd_dkv_plain(q, k, v, dout, lse, delta,
                                            causal, scale, qpos, kpos))


_flash_bwd_dkv_op.register_kernel("cuda")(_launch_flash_bwd_dkv)


@_flash_bwd_dkv_op.register_fake
def _flash_bwd_dkv_fake(q, k, v, dout, lse, delta, causal, scale, qpos=None,
                        kpos=None):
    _no_meta_launch(q)
    return k.new_empty(k.shape), v.new_empty(v.shape)


# ---------------------------------------------------------------------------
# fused conv3x3 + inference-BN + relu backward
# ---------------------------------------------------------------------------

#: the JAX dispatch rule's cap on the fp32 dW (a TPU VMEM figure, kept so
#: that both packages fuse the same segments)
CBR_DW_CAP_BYTES = 2_400_000
#: rows (pixels) of one wgrad split-K slice are a multiple of this
CBR_ROWS_PER_STEP = 64
#: the prologue's blocks to aim for: three waves of a 132-SM H100, a
#: figure of the shape alone, as CBR_TARGET_BLOCKS
CBR_PROLOGUE_BLOCKS = 396
#: wgrad blocks to aim for: two per SM of a 132-SM H100.  A figure of the
#: shape alone, so that the scratch sizes do not depend on the device
CBR_TARGET_BLOCKS = 264


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


def _cbr_bwd(db, b, a, w, gamma, beta, scale_eff, conv_dtype):
    """The relu mask and the BN gradients by hand in fp32, ``dy =
    dz·scale_eff`` rounded to ``a``'s dtype, and the conv gradients of
    that dy, ``a`` and ``w`` rounded to ``a``'s dtype, computed in
    ``conv_dtype``."""
    dz = torch.where(b > 0, db.float(), 0.0)
    dbeta = dz.sum((0, 1, 2))
    gamma = gamma.float()
    gamma_safe = torch.where(gamma.abs() < 1e-12, 1.0, gamma)
    dgamma = (dz * ((b.float() - beta.float()) / gamma_safe)).sum((0, 1, 2))
    dy = (dz * scale_eff.float()).to(a.dtype)
    w_round = _oihw(w.to(a.dtype).to(conv_dtype))
    da, dw, _ = torch.ops.aten.convolution_backward(
        _nchw(dy.to(conv_dtype)), _nchw(a.to(conv_dtype)), w_round, None,
        [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [True, True, False])
    return (da.permute(0, 2, 3, 1).to(a.dtype),
            dw.permute(2, 3, 1, 0).float(), dgamma, dbeta)


def fused_conv_bn_relu_bwd_plain(db, b, a, w, gamma, beta, scale_eff):
    """The backward of ``relu(bn_inference(conv3x3_same(a, w)))`` as the
    port's kernel defines it, in plain PyTorch: the conv gradients in fp32
    from bf16-valued operands, so ``da`` is rounded once to ``a``'s dtype
    and ``dw`` (HWIO), ``dgamma`` and ``dbeta`` come back in fp32,
    unrounded.

    Layouts are the JAX package's: ``db``, ``b`` (the relu output) and
    ``a`` NHWC, ``w`` HWIO, the rest ``(c,)``."""
    return _cbr_bwd(db, b, a, w, gamma, beta, scale_eff, torch.float32)


def cbr_bwd_unfused(db, b, a, w, gamma, beta, scale_eff):
    """``_cbr_bwd_reference``: the same backward with the conv gradients
    as autograd of the conv in ``a``'s dtype gives them (dW rounded to
    it).  The JAX package computes this for a shape outside its rule; in
    fp32 it equals :func:`fused_conv_bn_relu_bwd_plain`."""
    return _cbr_bwd(db, b, a, w, gamma, beta, scale_eff, a.dtype)


def cbr_fusable(db, b, a, w) -> bool:
    """The JAX dispatch rule (``pallas_kernels.py:603-615``) by shape
    alone: a 3x3 kernel, both channel counts multiples of 128, ``db`` and
    ``b`` of the conv output's shape, and the fp32 dW within
    :data:`CBR_DW_CAP_BYTES`."""
    n, hh, ww, cin = a.shape
    c = w.shape[-1]
    return (tuple(w.shape[:2]) == (3, 3) and w.shape[2] == cin and
            c % 128 == 0 and cin % 128 == 0 and db.shape == b.shape and
            tuple(db.shape) == (n, hh, ww, c) and
            9 * cin * c * 4 <= CBR_DW_CAP_BYTES)


def cbr_splits(rows: int, cin: int, c: int) -> int:
    """Split-K slices of the wgrad GEMM over the rows: as many as keep the
    9·(cin/128)·(c/128) output tiles within :data:`CBR_TARGET_BLOCKS`
    blocks (one wave: a few blocks past it would run as a second wave
    alone), with at least 32 row steps of 64 in a slice."""
    tiles = 9 * (cin // 128) * (c // 128)
    steps = -(-rows // CBR_ROWS_PER_STEP)
    return max(1, min(CBR_TARGET_BLOCKS // tiles, steps // 32))


def cbr_kernel_takes(db, b, a) -> bool:
    """Whether ``csrc/conv_bn_relu_bwd.cu`` computes this segment: CUDA
    activations in bfloat16.  :func:`fused_conv_bn_relu_bwd` reads this by
    dtype before any launch; a fusable segment in another dtype (fp32,
    fp16) computes :func:`fused_conv_bn_relu_bwd_plain`, as the JAX
    package's Pallas kernel computes every dtype."""
    return a.device.type != "cpu" and all(
        x.dtype == torch.bfloat16 for x in (db, b, a))


def cbr_prologue_rows(rows: int) -> int:
    """Rows of one prologue block: a multiple of 64 that gives about
    :data:`CBR_PROLOGUE_BLOCKS` blocks (256 at 28x28x128 and batch 128, 64
    at 14x14x256)."""
    return 64 * -(-rows // (64 * CBR_PROLOGUE_BLOCKS))


def fused_conv_bn_relu_bwd(db, b, a, w, gamma, beta, scale_eff):
    """``(da, dw, dgamma, dbeta)`` of ``relu(bn_inference(conv3x3_same(a,
    w)))`` (``pallas_kernels.fused_conv_bn_relu_bwd``), as
    :func:`fused_conv_bn_relu_bwd_plain` defines them.

    A shape outside :func:`cbr_fusable` computes :func:`cbr_bwd_unfused`
    on any device, as the JAX package does.  Inside it, a CPU tensor, and
    bf16 activations on a card, run ``hvd_torch::cbr_bwd``: its CPU kernel
    is the plain version, its CUDA kernel launches
    ``csrc/conv_bn_relu_bwd.cu`` (fp32 ``w`` and channel vectors).
    Activations on a card that the kernel does not take
    (:func:`cbr_kernel_takes`: not bf16) compute the plain version.
    The plain version's fp32 convolution gradients on a card run through
    cuDNN under the process's ``torch.backends.cudnn.allow_tf32``, as any
    PyTorch convolution does (TF32 by default)."""
    if not cbr_fusable(db, b, a, w):
        return cbr_bwd_unfused(db, b, a, w, gamma, beta, scale_eff)
    if a.device.type != "cpu" and not cbr_kernel_takes(db, b, a):
        return fused_conv_bn_relu_bwd_plain(db, b, a, w, gamma, beta,
                                            scale_eff)
    return torch.ops.hvd_torch.cbr_bwd(db, b, a, w, gamma, beta, scale_eff)


def _launch_cbr_bwd(db, b, a, w, gamma, beta, scale_eff):
    """Launch ``csrc/conv_bn_relu_bwd.cu`` on a fusable segment; raises on
    activations the kernel does not take (not bf16)."""
    for x in (db, b, a):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"the conv_bn_relu_bwd kernel takes bfloat16 "
                            f"activations, got {x.dtype}")
    n, hh, ww, cin = a.shape
    c = w.shape[-1]
    db, b, a = (_aligned(x) for x in (db, b, a))
    vecs = [_aligned(v.float()) for v in (gamma, beta, scale_eff)]
    # (cin, 9, c) bf16: dgrad's B operand, one row of K = (tap, c) per cin
    wt = _aligned(w.to(torch.bfloat16).reshape(9, cin, c).permute(1, 0, 2))
    lib, stream = _cuda_library(a)
    rows = n * hh * ww
    splits = cbr_splits(rows, cin, c)
    prologue_rows = cbr_prologue_rows(rows)
    blocks = -(-rows // prologue_rows)
    dev = a.device
    dy = torch.empty((rows, c), dtype=torch.bfloat16, device=dev)
    part_bn = torch.empty((2, blocks, c), dtype=torch.float32, device=dev)
    part_w = torch.empty((splits, 9 * cin * c), dtype=torch.float32,
                         device=dev)
    da = torch.empty_like(a)
    dw = torch.empty((3, 3, cin, c), dtype=torch.float32, device=dev)
    dgamma = torch.empty((c,), dtype=torch.float32, device=dev)
    dbeta = torch.empty((c,), dtype=torch.float32, device=dev)
    _check(lib.hvd_cbr_bwd(db.data_ptr(), b.data_ptr(), a.data_ptr(),
                           wt.data_ptr(), vecs[0].data_ptr(),
                           vecs[1].data_ptr(), vecs[2].data_ptr(),
                           dy.data_ptr(), part_bn.data_ptr(),
                           part_w.data_ptr(), da.data_ptr(), dw.data_ptr(),
                           dgamma.data_ptr(), dbeta.data_ptr(), n, hh, ww,
                           cin, c, splits, prologue_rows, stream),
           "conv_bn_relu_bwd")
    fused_conv_bn_relu_bwd.launches += 1
    return da, dw, dgamma, dbeta


fused_conv_bn_relu_bwd.launches = 0


@torch.library.custom_op(
    "hvd_torch::cbr_bwd", mutates_args=(), device_types="cpu",
    schema="(Tensor db, Tensor b, Tensor a, Tensor w, Tensor gamma, "
           "Tensor beta, Tensor scale_eff) -> (Tensor, Tensor, Tensor, "
           "Tensor)")
def _cbr_bwd_op(db, b, a, w, gamma, beta, scale_eff):
    """The CPU kernel: :func:`fused_conv_bn_relu_bwd_plain`."""
    return _contiguous(*fused_conv_bn_relu_bwd_plain(db, b, a, w, gamma,
                                                     beta, scale_eff))


_cbr_bwd_op.register_kernel("cuda")(_launch_cbr_bwd)


@_cbr_bwd_op.register_fake
def _cbr_bwd_fake(db, b, a, w, gamma, beta, scale_eff):
    _no_meta_launch(a)
    cin, c = a.shape[-1], w.shape[-1]
    f32 = torch.float32
    return (a.new_empty(a.shape), a.new_empty((3, 3, cin, c), dtype=f32),
            a.new_empty((c,), dtype=f32), a.new_empty((c,), dtype=f32))


class _FusedConvBnRelu(torch.autograd.Function):
    """Plain forward that saves the relu output; the backward is
    :func:`fused_conv_bn_relu_bwd` (``fused_conv_bn_relu``'s
    ``custom_vjp``).  ``mean`` and ``var`` get zero gradients."""

    @staticmethod
    def forward(ctx, a, w, gamma, beta, mean, var, eps: float):
        y = F.conv2d(_nchw(a), _oihw(w.to(a.dtype)), padding=1)
        scale_eff = (gamma / torch.sqrt(var + eps)).float()
        z = y.float() * scale_eff[:, None, None] + \
            (beta - mean * scale_eff)[:, None, None]
        out = torch.relu(z).to(a.dtype).permute(0, 2, 3, 1)
        ctx.save_for_backward(a, w, out, gamma, beta, scale_eff)
        return out

    @staticmethod
    def backward(ctx, db):
        a, w, out, gamma, beta, scale_eff = ctx.saved_tensors
        da, dw, dgamma, dbeta = fused_conv_bn_relu_bwd(
            db, out, a, w, gamma.float(), beta.float(), scale_eff)
        zeros = torch.zeros_like(gamma)
        return (da, dw.to(w.dtype), dgamma.to(gamma.dtype),
                dbeta.to(beta.dtype), zeros, zeros.clone(), None)


def fused_conv_bn_relu(a: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, mean: torch.Tensor,
                       var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``relu(bn_inference(conv3x3_same(a, w)))`` over NHWC ``a`` and an
    HWIO ``w`` (``pallas_kernels.fused_conv_bn_relu``): the conv runs in
    ``a``'s dtype, the affine in fp32, and the result comes back in ``a``'s
    dtype.  Only the relu output is saved, so dgamma is rebuilt from it and
    a channel whose ``gamma`` is exactly 0 gets dgamma 0."""
    return _FusedConvBnRelu.apply(a, w, gamma, beta, mean, var, eps)


# ---------------------------------------------------------------------------
# blocked matmul, fp32 accumulation
# ---------------------------------------------------------------------------

def _fit_mm_block(dim: int, candidates) -> Optional[int]:
    for c in candidates:
        if c <= dim and dim % c == 0:
            return c
    return None


def mm_fits(m: int, k: int, n: int) -> bool:
    """The JAX dispatch rule of ``pallas_matmul`` by shape alone
    (``pallas_kernels.py:801-804``): a row block of 512 down to 8 divides
    ``m``, a column block of 512, 256 or 128 divides ``n``, and ``k`` is a
    multiple of 128."""
    return (_fit_mm_block(m, (512, 256, 128, 64, 32, 16, 8)) is not None and
            _fit_mm_block(n, (512, 256, 128)) is not None and k % 128 == 0)


def mm_kernel_takes(x: torch.Tensor, w: torch.Tensor,
                    out_dtype: torch.dtype) -> bool:
    """Whether ``csrc/matmul.cu`` computes this product: CUDA operands in
    bfloat16 and a bfloat16 or float32 result.  The dispatch reads this
    before any launch; anything else computes :func:`pallas_matmul_plain`
    (on the CPU always), as the JAX package computes every dtype."""
    return (x.device.type != "cpu" and x.dtype == w.dtype == torch.bfloat16
            and out_dtype in (torch.bfloat16, torch.float32))


def pallas_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                        out_dtype: torch.dtype) -> torch.Tensor:
    """``jnp.dot(x, w, preferred_element_type=f32).astype(out_dtype)``:
    the product in fp32, rounded once."""
    return (x.float() @ w.float()).to(out_dtype)


def _mm_operand(t: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """(row-major storage, transposed) of a 2-D operand: a row-major tensor
    as it is, the transposed view of a row-major tensor as that tensor with
    the flag set, anything else as a row-major copy."""
    if t.is_contiguous():
        return _aligned(t), False
    if t.t().is_contiguous():
        return _aligned(t.t()), True
    return _aligned(t), False


def _mm(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype,
        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w`` by the dispatch rule, without autograd, through
    ``hvd_torch::pallas_matmul`` (or ``pallas_matmul_out``, which writes
    ``out``: row-major, ``(m, n)``, ``out_dtype``, when given) on the CPU
    and for operands the kernel takes on a card; the plain product
    otherwise."""
    (m, k), n = x.shape, w.shape[1]
    if out is not None and (out.shape != (m, n) or out.dtype != out_dtype
                            or not out.is_contiguous()):
        raise ValueError("out must be row-major (m, n) of out_dtype")
    if not mm_fits(m, k, n) or (x.device.type != "cpu" and
                                not mm_kernel_takes(x, w, out_dtype)):
        y = pallas_matmul_plain(x, w, out_dtype)
        return y if out is None else out.copy_(y)
    if out is None:
        return torch.ops.hvd_torch.pallas_matmul(x, w, out_dtype)
    torch.ops.hvd_torch.pallas_matmul_out(x, w, out)
    return out


def _launch_mm(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``csrc/matmul.cu`` for ``x @ w`` (the CUDA kernel of both
    matmul ops), into ``out`` when given."""
    (m, k), n = x.shape, w.shape[1]
    a, a_t = _mm_operand(x)
    b, b_t = _mm_operand(w)
    dst = out if out is not None and out.data_ptr() % 16 == 0 else \
        torch.empty((m, n), dtype=out_dtype, device=x.device)
    lib, stream = _cuda_library(x)
    _check(lib.hvd_matmul(a.data_ptr(), b.data_ptr(), dst.data_ptr(), m, n, k,
                          int(a_t), int(b_t), int(out_dtype == torch.float32),
                          stream), "matmul")
    pallas_matmul.launches += 1
    return dst if out is None or out is dst else out.copy_(dst)


def matmul_grad_w(x: torch.Tensor, dy: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """``xᵀ·dy``, the gradient of ``w`` in ``y = x @ w``, in ``w``'s dtype.
    When ``w`` is the transposed view of a row-major ``(n, k)`` weight, the
    product is taken as ``dyᵀ·x`` in the weight's own layout and returned
    transposed, so the weight's gradient comes out row-major."""
    if not w.is_contiguous() and w.t().is_contiguous():
        return _mm(dy.t(), x, w.dtype).t()
    return _mm(x.t(), dy, w.dtype)


class _PallasMatmul(torch.autograd.Function):
    """dX = dy·wᵀ and dW = xᵀ·dy through the same kernel.  dy is taken in
    the operands' dtype (the kernel's bf16 on the card), and each gradient
    comes back in its operand's dtype, as autograd of a ``cfg.dtype``
    product gives it."""

    @staticmethod
    def forward(ctx, x, w, out_dtype):
        ctx.save_for_backward(x, w)
        return _mm(x, w, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(torch.promote_types(x.dtype, w.dtype))
        dx = _mm(dy, w.t(), x.dtype) if ctx.needs_input_grad[0] else None
        dw = matmul_grad_w(x, dy, w) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def pallas_matmul(x: torch.Tensor, w: torch.Tensor,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ w`` with fp32 accumulation, rounded to ``out_dtype`` (default:
    the operands' promoted dtype), differentiable
    (``pallas_kernels.pallas_matmul``).

    ``x`` is ``(m, k)``, ``w`` ``(k, n)``; either may be the transposed view
    of a row-major tensor, which the kernel reads in place.  A shape outside
    :func:`mm_fits` computes :func:`pallas_matmul_plain` on any device, as
    the JAX package does, and so do operands the kernel does not take
    (:func:`mm_kernel_takes`: a dtype other than bfloat16, or a result
    other than bfloat16 or float32).  Otherwise a CUDA tensor launches
    ``csrc/matmul.cu``."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"pallas_matmul takes (m, k) @ (k, n), got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    out_dtype = out_dtype or torch.promote_types(x.dtype, w.dtype)
    return _PallasMatmul.apply(x, w, out_dtype)


pallas_matmul.launches = 0


@torch.library.custom_op(
    "hvd_torch::pallas_matmul", mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor w, ScalarType out_dtype) -> Tensor")
def _pallas_matmul_op(x, w, out_dtype):
    """The CPU kernel: :func:`pallas_matmul_plain`."""
    return pallas_matmul_plain(x, w, out_dtype).contiguous()


@_pallas_matmul_op.register_kernel("cuda")
def _pallas_matmul_cuda(x, w, out_dtype):
    return _launch_mm(x, w, out_dtype)


@_pallas_matmul_op.register_fake
def _pallas_matmul_fake(x, w, out_dtype):
    _no_meta_launch(x)
    return x.new_empty((x.shape[0], w.shape[1]), dtype=out_dtype)


@torch.library.custom_op(
    "hvd_torch::pallas_matmul_out", mutates_args=("out",),
    device_types="cpu", schema="(Tensor x, Tensor w, Tensor(a!) out) -> ()")
def _pallas_matmul_out_op(x, w, out):
    """``out = x @ w`` (a row block of the tp ring's gathered output);
    the CPU kernel: :func:`pallas_matmul_plain`."""
    out.copy_(pallas_matmul_plain(x, w, out.dtype))


@_pallas_matmul_out_op.register_kernel("cuda")
def _pallas_matmul_out_cuda(x, w, out):
    _launch_mm(x, w, out.dtype, out)


@_pallas_matmul_out_op.register_fake
def _pallas_matmul_out_fake(x, w, out):
    _no_meta_launch(x)


#: each op's CUDA kernel (the launch) by the op's name in ``hvd_torch``
CUDA_KERNELS = {"fused_scale": _fused_scale_cuda,
                "flash_fwd": _launch_flash_fwd,
                "flash_bwd_dq": _launch_flash_bwd_dq,
                "flash_bwd_dkv": _launch_flash_bwd_dkv,
                "cbr_bwd": _launch_cbr_bwd,
                "pallas_matmul": _pallas_matmul_cuda,
                "pallas_matmul_out": _pallas_matmul_out_cuda}


# ---------------------------------------------------------------------------
# FLOP formulas (torch.utils.flop_counter, read by utils/trace.py)
# ---------------------------------------------------------------------------
#
# Each op counts what the dense computation it replaces counts, whatever
# its launch computes: a step then counts the same FLOPs on the dense
# path, the flash path and the card.  Attention follows torch's SDPA
# convention (causal masking does not halve the count; the positions
# variant counts alike); fused_scale has no formula: elementwise work
# counts 0, as in JAX's op_flops.

def _attention_product(q, k) -> int:
    """2·B·h·t_q·t_k·d: one of attention's dense products, from the
    ``(batch, seq, heads, head_dim)`` shapes of q and k."""
    b, tq, h, d = q
    return 2 * b * h * tq * k[1] * d


@register_flop_formula([torch.ops.hvd_torch.flash_fwd,
                        torch.ops.hvd_torch.flash_bwd_dq,
                        torch.ops.hvd_torch.flash_bwd_dkv])
def _flash_flops(q, k, *args, out_shape=None, **kwargs) -> int:
    """Two products each: the forward's QKᵀ and PV; the backward's four
    split as dP = dO·Vᵀ and dQ = dS·K (dQ kernel), dV = Pᵀ·dO and dK =
    dSᵀ·Q (dK/dV kernel)."""
    return 2 * _attention_product(q, k)


@register_flop_formula(torch.ops.hvd_torch.cbr_bwd)
def _cbr_bwd_flops(db, b, a, w, *args, out_shape=None, **kwargs) -> int:
    """dgrad and wgrad of the 3x3 stride-1 conv, 2·N·H·W·Cin·C·9 each
    (``a`` NHWC, ``w`` HWIO)."""
    n, h, wd, cin = a
    kh, kw, _, c = w
    return 2 * (2 * n * h * wd * cin * c * kh * kw)


@register_flop_formula([torch.ops.hvd_torch.pallas_matmul,
                        torch.ops.hvd_torch.pallas_matmul_out])
def _pallas_matmul_flops(x, w, *args, out_shape=None, **kwargs) -> int:
    """2·M·N·K."""
    return 2 * x[0] * x[1] * w[1]


#: every kernel's launch counter, by the name chip_smoke.py and PERF.md
#: use: the wrapper that launches it and the attribute it counts in
WRAPPERS = {"fused_scale": (fused_scale, "launches"),
            "flash_fwd": (flash_fwd, "launches"),
            "flash_bwd_dq": (flash_bwd_dq, "launches"),
            "flash_bwd_dkv": (flash_bwd_dkv, "launches"),
            "fused_conv_bn_relu_bwd": (fused_conv_bn_relu_bwd, "launches"),
            "pallas_matmul": (pallas_matmul, "launches"),
            "flash_fwd_pos": (flash_fwd, "pos_launches"),
            "flash_bwd_dq_pos": (flash_bwd_dq, "pos_launches"),
            "flash_bwd_dkv_pos": (flash_bwd_dkv, "pos_launches")}


def reset_launch_counts() -> None:
    for fn, attr in WRAPPERS.values():
        setattr(fn, attr, 0)


def launch_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in WRAPPERS.items()}


def add_launch_counts(delta: dict) -> None:
    """Add ``delta`` ({name: n}) to the counts: a CUDA graph's replay runs
    the kernels its capture recorded, with no Python, and a capture
    launches none (``runtime/compile_cache.capture``)."""
    for name, n in delta.items():
        fn, attr = WRAPPERS[name]
        setattr(fn, attr, getattr(fn, attr) + n)


# ---------------------------------------------------------------------------
# flash attention: dispatch and autograd
# ---------------------------------------------------------------------------

def fit_flash_block(t: int, requested: int) -> Optional[int]:
    """Largest flash block ≤ ``requested`` that divides ``t``; sequences
    shorter than one tile run as one block; other non-128-multiples return
    ``None`` (the caller computes reference attention).  A copy of
    ``pallas_kernels.fit_flash_block``: the port keeps its dispatch rule,
    while the CUDA kernels tile by 128 (forward) or 64 rows (backward)
    and mask the ragged edge."""
    if t <= 128:
        b = min(requested, t)
        if t % b == 0:
            return b
        return t if t % 8 == 0 else None
    for cand in (requested, 512, 256, 128):
        if cand <= t and t % cand == 0:
            return cand
    return None


class _FlashAttention(torch.autograd.Function):
    """Forward saves O and lse; backward runs the dQ kernel, which also
    computes delta from O, then the dK/dV kernel (``flash_attention``'s
    ``custom_vjp`` in the JAX package)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, delta = flash_bwd_dq(q, k, v, do, lse, None, ctx.causal,
                                 ctx.scale, out=out)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal,
                               ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """Blocked attention over ``(batch, seq, heads, head_dim)`` inputs,
    differentiable through the FlashAttention-2 backward kernels.  Inputs
    the kernels do not take (:func:`flash_kernels_take`: on a card, a dtype
    other than bfloat16 or a head_dim outside :data:`FLASH_HEAD_DIMS`)
    compute :func:`~horovod_tpu_torch.parallel.ring_attention.reference_attention`.
    On a card the kernels take any sequence length, masking the ragged
    tile (ViT-B/16's 196 patches launch them; the JAX package's Pallas
    kernels need :func:`fit_flash_block`'s tiling and compute dense
    attention there); on the CPU a sequence that :func:`fit_flash_block`
    cannot tile computes reference attention, as the JAX package does, and
    ``block_q``/``block_k`` only decide that."""
    t, d = q.shape[1], q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    untiled = q.device.type == "cpu" and (
        fit_flash_block(t, block_q) is None or
        fit_flash_block(t, block_k) is None)
    if untiled or not flash_kernels_take(q, k, v):
        from horovod_tpu_torch.parallel.ring_attention import \
            reference_attention

        return reference_attention(q, k, v, causal=causal, scale=scale)
    return _FlashAttention.apply(q, k, v, causal, scale)
