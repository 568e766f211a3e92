"""Pytree leaves in the JAX package's order.

``jax.tree_util`` visits a dict's (and a ``defaultdict``'s) values in
sorted-key order, an ``OrderedDict``'s in insertion order, lists, tuples
and namedtuples in order, and treats ``None`` as an empty subtree; torch's
pytree visits every dict in insertion order and keeps ``None`` as a leaf.
Where a value must agree across the two packages (a checksum over a tree,
the leaf a seeded fault picks), the port walks trees with these helpers.
As in JAX, a container is one of those exact types (a namedtuple being
any tuple with ``_fields``); every other object, a subclass of one
included, is a leaf.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, List


_DICTS = (dict, collections.defaultdict, collections.OrderedDict)


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _is_sequence(node: Any) -> bool:
    return type(node) in (list, tuple) or _is_namedtuple(node)


def _keys(node: dict) -> list:
    """A dict's keys in the order JAX visits them."""
    if type(node) is collections.OrderedDict:
        return list(node)
    return sorted(node)


def leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree_util.tree_leaves`` order."""
    out: List[Any] = []

    def walk(node):
        if node is None:
            return
        if type(node) in _DICTS:
            for k in _keys(node):
                walk(node[k])
        elif _is_sequence(node):
            for v in node:
                walk(v)
        else:
            out.append(node)

    walk(tree)
    return out


def map_leaves(tree: Any, fn: Callable[[int, Any], Any]) -> Any:
    """A copy of ``tree``'s containers with each leaf replaced by
    ``fn(index, leaf)``, the index counted in :func:`leaves` order.  A
    dict keeps its own key order."""
    count = [0]

    def walk(node):
        if node is None:
            return None
        if type(node) in _DICTS:
            new = {k: walk(node[k]) for k in _keys(node)}
            if type(node) is collections.defaultdict:
                out = collections.defaultdict(node.default_factory)
            else:
                out = type(node)()
            for k in node:
                out[k] = new[k]
            return out
        if _is_namedtuple(node):
            return type(node)(*[walk(v) for v in node])
        if _is_sequence(node):
            return type(node)(walk(v) for v in node)
        i = count[0]
        count[0] += 1
        return fn(i, node)

    return walk(tree)
