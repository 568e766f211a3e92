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
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

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


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The ``params`` collection (or a bare parameter tree) as a
    ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    _flatten(tree.get("params", tree), out)
    return out


def variables_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """``params`` and ``batch_stats`` of a flax variable tree as one
    ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}
    for collection in COLLECTIONS:
        _flatten(tree.get(collection, {}), out)
    return out
