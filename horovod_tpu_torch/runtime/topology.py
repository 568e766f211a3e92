"""Exchange topology resolution (``horovod_tpu/runtime/topology.py``,
the part the flat sharded exchange needs).

The world is laid out as the JAX package's runtime mesh, ``(cross,
local)`` = ``(dcn, ici)`` in mesh order: ``HOROVOD_CROSS_SIZE`` nodes of
``HOROVOD_LOCAL_SIZE`` cards, with a process group per level
(``GlobalState.layout_group("local"/"cross")``, ``runtime/state.py``),
which Adasum's reduction runs over.  :func:`resolve_topology` applies the
JAX package's decision rule to those extents.  Only the one-level (flat)
exchange is ported: a two-level or tree exchange, asked for or picked by
``"auto"``, raises :class:`NotImplementedError` rather than run flat.
"""

from __future__ import annotations

from typing import Sequence

#: Valid values of the exchange ``hierarchy`` knob (JAX
#: ``HIERARCHY_MODES``).
HIERARCHY_MODES = ("auto", "flat", "two_level")

#: The ``hierarchy`` vocabulary plus ``"tree"``, the explicit N-level form
#: (JAX ``TOPOLOGY_MODES``).
TOPOLOGY_MODES = HIERARCHY_MODES + ("tree",)

_NOT_PORTED = ("the {} exchange is not ported to horovod_tpu_torch yet "
               "(ROADMAP Queue A 7); only the flat exchange runs")


def resolve_topology(hierarchy: str, axis_sizes: Sequence[int]) -> str:
    """The exchange mode for ``hierarchy`` over mesh extents
    ``axis_sizes`` (outermost first): JAX ``resolve_topology(...).mode``.

    ``"flat"`` is one collective scope over the whole world.  ``"auto"``
    picks ``"two_level"`` (two axes) or ``"tree"`` (more) exactly when at
    least two axes have extent > 1, else ``"flat"``.  ``"two_level"``
    needs exactly two axes (``ValueError`` otherwise, as in JAX).  Every
    mode other than flat raises :class:`NotImplementedError`."""
    if hierarchy not in TOPOLOGY_MODES:
        raise ValueError(f"hierarchy must be one of {TOPOLOGY_MODES}, got "
                         f"{hierarchy!r}")
    sizes = [int(s) for s in axis_sizes]
    if not sizes:
        raise ValueError("axis_sizes must name >= 1 mesh axis")
    if hierarchy == "two_level" and len(sizes) != 2:
        raise ValueError(
            "hierarchy='two_level' needs a 2-axis (dp_outer, dp_inner) "
            f"data-parallel spec, got {len(sizes)} axis/es")
    if hierarchy == "auto":
        effective = [s for s in sizes if s > 1]
        hierarchy = "flat" if len(effective) < 2 else \
            ("two_level" if len(sizes) == 2 else "tree")
    if hierarchy != "flat":
        raise NotImplementedError(_NOT_PORTED.format(hierarchy))
    return "flat"
