"""Carry the JAX package's parameters across to the port.

``params_from_flax`` takes a flax parameter tree of numpy arrays (unboxed:
``flax.core.meta.unbox``, then ``numpy.asarray`` on each leaf) and returns
a ``state_dict`` for the port's module of the same architecture: path
components join with dots, ``layer_{i}`` becomes ``layers.{i}``, and a
dense ``kernel`` ``(in, out)`` becomes ``weight`` ``(out, in)``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _name(path) -> str:
    parts = []
    for p in path:
        m = re.fullmatch(r"layer_(\d+)", p)
        parts.append(f"layers.{m.group(1)}" if m else
                     "weight" if p == "kernel" else p)
    return ".".join(parts)


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    tree = tree.get("params", tree)
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for key, child in node.items():
                walk(child, path + (str(key),))
            return
        arr = np.array(node, dtype=np.float32)
        if path[-1] == "kernel":
            arr = arr.T.copy()
        out[_name(path)] = torch.from_numpy(arr)

    walk(tree, ())
    return out
