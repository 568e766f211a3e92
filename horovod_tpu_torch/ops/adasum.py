"""Adasum's pairwise combine (``horovod_tpu/ops/adasum.py`` ``_combine``),
for the eager plane's reduction tree (``ops/eager.py``).

Given two gradients ``a``, ``b`` (one layer each),

    a' = (1 - a.b / (2|a|^2)) * a  +  (1 - a.b / (2|b|^2)) * b

which is ``a+b`` for orthogonal gradients and the average for parallel
ones.  Dots and norms are taken in fp32 whatever the input dtype, as the
reference's fp16 path widens its accumulation (``adasum.h:107``).  The
in-step Adasum (``grouped_allreduce(op=Adasum)``, the recursive-doubling
exchange, ``DistributedAdasumOptimizer``) is not ported yet.
"""

from __future__ import annotations

from typing import List

import torch


def _combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One pairwise Adasum combine of two 1-D tensors of one dtype."""
    af, bf = a.float(), b.float()
    dot = torch.dot(af, bf)
    anormsq = torch.dot(af, af)
    bnormsq = torch.dot(bf, bf)
    one = torch.ones((), dtype=torch.float32, device=a.device)
    acoeff = torch.where(anormsq >= 1e-30,
                         1.0 - dot / (2.0 * anormsq + 1e-30), one)
    bcoeff = torch.where(bnormsq >= 1e-30,
                         1.0 - dot / (2.0 * bnormsq + 1e-30), one)
    return (acoeff * af + bcoeff * bf).to(a.dtype)


def adasum_tree(rows: List[torch.Tensor]) -> torch.Tensor:
    """The pairwise Adasum reduction tree over per-rank rows (JAX
    ``eager._adasum_tree``): neighbours combine, an odd last row passes
    up unchanged, until one row is left."""
    vals = list(rows)
    while len(vals) > 1:
        nxt = [_combine(vals[i], vals[i + 1])
               for i in range(0, len(vals) - 1, 2)]
        if len(vals) % 2:
            nxt.append(vals[-1])
        vals = nxt
    return vals[0]
