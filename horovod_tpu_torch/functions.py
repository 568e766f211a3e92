"""State synchronisation over tensors, modules and Python objects.

Counterpart of ``horovod_tpu/functions.py`` and of the reference's
``horovod/torch/functions.py``: broadcasts from ``root_rank`` so that every
rank starts from the same parameters and optimizer state.  Tensors are
overwritten in place, the PyTorch idiom, and returned.
:func:`allgather_object` gathers one object a rank through the eager
``allgather``.
"""

from __future__ import annotations

import pickle
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch.runtime import state


def _tensors(variables):
    if isinstance(variables, torch.nn.Module):
        yield from variables.parameters()
        yield from variables.buffers()
    elif isinstance(variables, torch.Tensor):
        yield variables
    elif isinstance(variables, dict):
        for v in variables.values():
            yield from _tensors(v)
    elif isinstance(variables, (list, tuple)):
        for v in variables:
            if isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], str):
                yield from _tensors(v[1])      # named_parameters() pairs
            else:
                yield from _tensors(v)


def broadcast_variables(variables, root_rank: int = 0,
                        name: Optional[str] = None):
    """Broadcast every tensor of ``variables`` (a module, a tensor, or a
    dict/list of them) from ``root_rank`` in place, and return
    ``variables`` (reference ``broadcast_variables``, the post-restore
    sync of the five-line recipe).  ``name`` is accepted for the JAX
    package's signature."""
    del name
    if state.global_state().size == 1:
        return variables
    with torch.no_grad():
        for t in _tensors(variables):
            dist.broadcast(t.data, src=root_rank)
    return variables


def broadcast_parameters(params, root_rank: int = 0):
    """Reference ``torch/functions.py:30``: a ``state_dict()``,
    ``named_parameters()`` or module, broadcast in place."""
    return broadcast_variables(params, root_rank=root_rank)


def broadcast_object(obj: Any = None, root_rank: int = 0,
                     name: Optional[str] = None) -> Any:
    """Pickle ``obj`` on ``root_rank`` and return it on every rank."""
    del name
    if state.global_state().size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=root_rank)
    return box[0]


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0):
    """Make every rank's optimizer state ``root_rank``'s (reference
    ``torch/functions.py:62``); returns the optimizer."""
    if state.global_state().size == 1:
        return optimizer
    sd = broadcast_object(optimizer.state_dict()
                          if dist.get_rank() == root_rank else None,
                          root_rank)
    optimizer.load_state_dict(sd)
    return optimizer


def allgather_object(obj: Any, name: Optional[str] = None) -> List[Any]:
    """One Python object from each rank, in rank order (reference
    ``tensorflow/functions.py:136``): pickled into a CPU byte tensor and
    gathered by the eager ``allgather``, whose negotiated sizes split the
    result."""
    from horovod_tpu_torch.ops import eager

    name = name or "allgather_object"
    if state.global_state().size == 1:
        return [obj]
    payload = torch.frombuffer(bytearray(pickle.dumps(obj)),
                               dtype=torch.uint8)
    gathered, sizes = eager.allgather_with_sizes(payload, name=name)
    out, off = [], 0
    for n in sizes.tolist():
        # bytes this program's ranks pickled
        out.append(pickle.loads(gathered[off:off + n].numpy().tobytes()))
        off += n
    return out
