"""The eager plane's two data planes and their priority chain
(``horovod_tpu/ops/op_manager.py``).

The reference dispatches each collective through an ``OperationManager``
whose per-type op lists are tried in priority order, the first
``Enabled()`` one winning (``ops/operation_manager.cc:40-98``).  The port
has two planes, each with the same five primitives, so ``ops.eager``
dispatches by a method call:

* :class:`DeviceOps` (default; ``HOROVOD_TPU_OPERATIONS=XLA``, the JAX
  package's name for its device plane): the world's process group, NCCL
  on a card and gloo in a CPU world.  Sum, Average, Min, Max and Product
  are one ``all_reduce`` of the flat buffer, its pre- and postscale
  ``fused_scale`` passes; Adasum gathers the rows and runs the tree on the
  device.
* :class:`HostOps` (``HOROVOD_TPU_OPERATIONS=HOST``): the host gloo group
  (``GlobalState.host_group``).  Tensors travel as bytes, so any dtype
  goes, and reductions run on the host through
  :func:`~horovod_tpu_torch.ops.eager._reduce_stacked`; results go back to
  the tensor's device.

The requested plane goes first in the chain and the other stays as the
fallback; a call takes the first plane enabled for its tensor.  A CPU
tensor cannot go through NCCL, so on an NCCL world the device plane is
not enabled for it and the host plane takes it, as the reference sends
CPU tensors through its CPU operations.  A CUDA tensor takes the host
plane only when ``HOST`` was asked for.

Primitives (collective: every rank calls them in the same order):

* ``metadata_allgather(arr) -> (world, *arr.shape) ndarray``, over the
  host group on both planes, so that negotiation never waits on the card;
* ``reduce_rows(flat, op, pre, post, segments) -> flat`` (``flat`` is the
  caller's own buffer, which a plane may overwrite);
* ``allgather_padded(padded) -> (world, *padded.shape)``;
* ``bcast(tensor, root) -> tensor``;
* ``alltoall_slots(slots) -> (world, ...)``: ``slots[d]`` holds the rows
  this rank sends to rank ``d``; row ``s`` of the result is what rank
  ``s`` sent here.

``backend()`` names the backend that moves a plane's data (``"nccl"`` or
``"gloo"``), which names the timeline's collective spans.
"""

from __future__ import annotations

import logging
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch.runtime import state

_log = logging.getLogger(__name__)


def _gather_into(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """``out`` (world × ``inp``) := every rank's ``inp``, over ``group``
    (``all_gather_single`` from torch 2.13, where the old name is
    deprecated)."""
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, inp, group=group)


def _host_allgather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` stacked, ``(world, *x.shape)`` on the CPU,
    gathered as bytes over the host group."""
    st = state.global_state()
    x = x.detach().cpu().contiguous()
    if st.size == 1:
        return x[None].clone()
    out = torch.empty((st.size,) + tuple(x.shape), dtype=x.dtype)
    if x.numel():
        _gather_into(out.reshape(-1).view(torch.uint8),
                     x.reshape(-1).view(torch.uint8), st.host_group)
    return out


def _host_metadata_allgather(arr: np.ndarray) -> np.ndarray:
    arr = np.ascontiguousarray(arr)
    return _host_allgather(torch.from_numpy(arr)).numpy()


class DeviceOps:
    """The device plane: the world's process group."""

    name = "XLA"

    def enabled(self, tensor=None) -> bool:
        return tensor is None or tensor.device.type != "cpu" or \
            dist.get_backend() == "gloo"

    def backend(self) -> str:
        """The backend that moves this plane's data: the world's."""
        return dist.get_backend()

    def metadata_allgather(self, arr: np.ndarray) -> np.ndarray:
        return _host_metadata_allgather(arr)

    def reduce_rows(self, flat, op, prescale, postscale, segments):
        from horovod_tpu_torch.ops import eager

        if op == eager.ReduceOp.ADASUM:
            rows = self.allgather_padded(flat)
            return eager._reduce_stacked(rows, op, prescale, postscale,
                                         segments)
        return eager._reduce_flat(flat, op, prescale, postscale)

    def allgather_padded(self, padded: torch.Tensor) -> torch.Tensor:
        world = state.global_state().size
        padded = padded.contiguous()
        out = padded.new_empty((world,) + tuple(padded.shape))
        if padded.numel():
            _gather_into(out.reshape(-1), padded.reshape(-1), None)
        return out

    def bcast(self, tensor: torch.Tensor, root_rank: int) -> torch.Tensor:
        out = tensor.detach().clone(memory_format=torch.contiguous_format)
        dist.broadcast(out, src=root_rank)
        return out

    def alltoall_slots(self, slots: torch.Tensor) -> torch.Tensor:
        slots = slots.contiguous()
        out = torch.empty_like(slots)
        if slots.numel():
            dist.all_to_all_single(out, slots)
        return out


class HostOps:
    """The host plane: bytes over the host gloo group, reductions on the
    host."""

    name = "HOST"

    def enabled(self, tensor=None) -> bool:
        return True

    def backend(self) -> str:
        return "gloo"

    def metadata_allgather(self, arr: np.ndarray) -> np.ndarray:
        return _host_metadata_allgather(arr)

    def reduce_rows(self, flat, op, prescale, postscale, segments):
        from horovod_tpu_torch.ops import eager

        rows = _host_allgather(flat)
        return eager._reduce_stacked(rows, op, prescale, postscale,
                                     segments).to(flat.device)

    def allgather_padded(self, padded: torch.Tensor) -> torch.Tensor:
        return _host_allgather(padded).to(padded.device)

    def bcast(self, tensor: torch.Tensor, root_rank: int) -> torch.Tensor:
        st = state.global_state()
        out = tensor.detach().cpu().clone(
            memory_format=torch.contiguous_format)
        if out.numel():
            dist.broadcast(out.reshape(-1).view(torch.uint8), src=root_rank,
                           group=st.host_group)
        return out.to(tensor.device)

    def alltoall_slots(self, slots: torch.Tensor) -> torch.Tensor:
        st = state.global_state()
        src = slots.detach().cpu().contiguous()
        out = torch.empty_like(src)
        if src.numel():
            dist.all_to_all_single(out.reshape(-1).view(torch.uint8),
                                   src.reshape(-1).view(torch.uint8),
                                   group=st.host_group)
        return out.to(slots.device)


_DEVICE = DeviceOps()
_HOST = HostOps()
PLANES = {_DEVICE.name: _DEVICE, _HOST.name: _HOST}


def _requested() -> str:
    if state.is_initialized():
        return state.global_state().config.tpu_operations
    from horovod_tpu_torch.runtime.config import Config

    return Config.from_env().tpu_operations


def chain() -> List:
    """Priority-ordered planes (reference ``CreateOperationManager``)."""
    req = _requested()
    if req == "HOST":
        return [_HOST, _DEVICE]
    if req not in ("XLA", ""):
        _log.warning("HOROVOD_TPU_OPERATIONS=%s is not a known data plane "
                     "(XLA, HOST); defaulting to XLA", req)
    return [_DEVICE, _HOST]


def active_op(tensor=None):
    """The first plane of the chain enabled for ``tensor`` (reference
    ``ExecuteOperation``, ``operation_manager.cc:100``)."""
    return next(op for op in chain() if op.enabled(tensor))


def current_operations(tensor=None) -> str:
    """Name of the plane an eager collective of ``tensor`` uses."""
    return active_op(tensor).name
