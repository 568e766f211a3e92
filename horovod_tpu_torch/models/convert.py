"""Carry the JAX package's variables across to the port.

``params_from_flax`` takes a flax variable tree of numpy arrays (unboxed:
``flax.core.meta.unbox``, then ``numpy.asarray`` on each leaf) and returns
a ``state_dict`` for the port's module of the same architecture built from
its ``params`` collection; ``variables_from_flax`` also carries the
``batch_stats`` collection (BatchNorm ``mean``/``var``), which the port
keeps beside the parameters under the same module path: as parameters in
the ResNet's ``BatchNorm``, as buffers in
:class:`~horovod_tpu_torch.optim.SyncBatchNorm`, whose ``scale``/``bias``
and ``mean``/``var`` a flax ``SyncBatchNorm``'s tree maps onto.

Names: path components join with dots, ``layer_{i}`` becomes
``layers.{i}``, and ``kernel`` becomes ``weight``.  A dense kernel
``(in, out)`` becomes ``(out, in)``; a convolution kernel, HWIO in flax,
becomes OIHW (``permute(3, 2, 0, 1)``: a plain transpose would also swap
its H and W).

``params_from_flax(tree, tp=n, tp_index=r)`` gives rank ``r`` of a tp
group of ``n`` its shard of the transformer blocks' kernels, as a model
built with that ``tp_group`` holds them
(:mod:`~horovod_tpu_torch.parallel.tensor_parallel`): its per-head q, k
and v output features of ``attn.qkv``, its output features of ``mlp.wi``
(column-parallel), and its input features of ``attn.proj`` and
``mlp.wo`` (row-parallel).  Every other leaf stays whole.  FSDP needs no
converter: the step places full weights.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from horovod_tpu_torch.parallel.tensor_parallel import column_rows

COLLECTIONS = ("params", "batch_stats")


def _name(path) -> str:
    parts = []
    for p in path:
        m = re.fullmatch(r"layer_(\d+)", p)
        parts.append(f"layers.{m.group(1)}" if m else
                     "weight" if p == "kernel" else p)
    return ".".join(parts)


def _weight(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    raise ValueError(f"no torch layout for a {arr.ndim}-D kernel")


def _flatten(tree: Mapping, out: Dict[str, torch.Tensor]) -> None:
    def walk(node, path):
        if isinstance(node, Mapping):
            for key, child in node.items():
                walk(child, path + (str(key),))
            return
        arr = np.array(node, dtype=np.float32)
        if path[-1] == "kernel":
            arr = _weight(arr)
        out[_name(path)] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(tree, ())


#: the tensor-parallel layout of the transformer blocks' kernels: the
#: name's ending -> ("column", parts) or ("row", 1)
TP_LAYOUT = {"attn.qkv.weight": ("column", 3), "mlp.wi.weight": ("column", 1),
             "attn.proj.weight": ("row", 1), "mlp.wo.weight": ("row", 1)}


def tp_shard(name: str, weight: torch.Tensor, tp: int,
             index: int) -> torch.Tensor:
    """Rank ``index``'s shard of the full ``(out, in)`` ``weight`` named
    ``name`` at a tp extent of ``tp`` (:data:`TP_LAYOUT`; any other leaf
    whole)."""
    layout = next((v for k, v in TP_LAYOUT.items()
                   if name == k or name.endswith("." + k)), None)
    if tp == 1 or layout is None:
        return weight
    kind, parts = layout
    if kind == "column":
        return weight[column_rows(weight.shape[0], tp, index, parts)]
    width = weight.shape[1] // tp
    return weight[:, index * width:(index + 1) * width].contiguous()


def params_from_flax(tree: Mapping, tp: int = 1,
                     tp_index: int = 0) -> Dict[str, torch.Tensor]:
    """The ``params`` collection (or a bare parameter tree) as a
    ``state_dict``; with ``tp > 1``, rank ``tp_index``'s shard of it
    (:func:`tp_shard`)."""
    out: Dict[str, torch.Tensor] = {}
    _flatten(tree.get("params", tree), out)
    return {k: tp_shard(k, v, tp, tp_index) for k, v in out.items()}


def variables_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """``params`` and ``batch_stats`` of a flax variable tree as one
    ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    for collection in COLLECTIONS:
        _flatten(tree.get(collection, {}), out)
    return out
