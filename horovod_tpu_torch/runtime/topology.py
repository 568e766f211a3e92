"""Exchange topology resolution (``horovod_tpu/runtime/topology.py``,
the part the sharded exchange needs).

The world is laid out as the JAX package's runtime mesh, ``(cross,
local)`` = ``(dcn, ici)`` in mesh order: ``HOROVOD_CROSS_SIZE`` nodes of
``HOROVOD_LOCAL_SIZE`` cards, with a process group per level
(``GlobalState.layout_group("local"/"cross")``, ``runtime/state.py``).
:func:`resolve_topology` applies the JAX package's decision rule to those
extents and returns the :class:`TopologyTree` the exchange runs: one level
(flat), two (``local`` inside ``cross``: the two-level exchange) or more
(the tree).  The port names its two layout levels as its process groups
are named, where the JAX package says ``ici`` and ``dcn``.

A tree of three or more levels comes, as in JAX, from a layout the caller
names: JAX passes an N-axis ``Mesh(devs.reshape(2, 2, 2), ("pod",
"slice", "chip"))`` as the sharded exchange's ``axis``, the port a
:class:`TreeLayout` over the ``hvd.init()`` world, with one process group
for each line of ranks along each axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

#: Valid values of the exchange ``hierarchy`` knob (JAX
#: ``HIERARCHY_MODES``).
HIERARCHY_MODES = ("auto", "flat", "two_level")

#: The ``hierarchy`` vocabulary plus ``"tree"``, the explicit N-level form
#: (JAX ``TOPOLOGY_MODES``).
TOPOLOGY_MODES = HIERARCHY_MODES + ("tree",)

#: The layout's level names in mesh order, outermost first: the names of
#: the process groups (``runtime/state.py``)
LAYOUT_AXES = ("cross", "local")

#: Level names of an N-level tree of three or more axes, INNERMOST first
#: (JAX ``DEFAULT_LEVEL_NAMES``)
DEFAULT_LEVEL_NAMES = ("chip", "slice", "pod", "cluster")

#: Per-level wire codec vocabulary (``HOROVOD_EXCHANGE_LEVEL_CODECS``):
#: dtype name -> wire bits (None = full precision)
LEVEL_CODEC_BITS = {"fp32": None, "int8": 8, "fp8_e4m3": 8}


def parse_level_codecs(spec: Optional[str]) -> Dict[str, Optional[int]]:
    """Parse the per-level codec grammar, ``"level=dtype,level=dtype"``
    (e.g. ``"cross=int8,local=fp32"``), into ``{level name: wire bits}``
    (JAX ``parse_level_codecs``).  Unknown dtypes and repeated levels
    raise; an empty or None spec is ``{}`` (the codec on the outermost hop
    only)."""
    out: Dict[str, Optional[int]] = {}
    if not spec:
        return out
    for item in str(spec).split(","):
        item = item.strip()
        if not item:
            continue
        name, sep, dtype = item.partition("=")
        name, dtype = name.strip(), dtype.strip().lower()
        if not sep or not name or dtype not in LEVEL_CODEC_BITS:
            raise ValueError(
                f"bad level codec term {item!r}: expected level=dtype with "
                f"dtype in {sorted(LEVEL_CODEC_BITS)}")
        if name in out:
            raise ValueError(f"duplicate level {name!r} in {spec!r}")
        out[name] = LEVEL_CODEC_BITS[dtype]
    return out


@dataclasses.dataclass(frozen=True)
class TopologyLevel:
    """One level of the resolved tree: its name (the layout level it runs
    over; ``axes`` widens it for the flat tree's one level, which spans
    every axis), its extent, and the codec width on its hop (None = full
    precision)."""

    name: str
    extent: int
    wire_bits: Optional[int] = None
    axes: Optional[Tuple[str, ...]] = None

    @property
    def axis_spec(self):
        """The axis, or axes, this level's collectives run over."""
        return self.axes if self.axes is not None else self.name


@dataclasses.dataclass(frozen=True)
class TopologyTree:
    """The resolved N-level topology, levels INNERMOST first, so
    ``levels[0]`` rides the fastest fabric and ``levels[-1]`` the slowest.
    One level is ``"flat"``, two ``"two_level"``, more ``"tree"``
    (:attr:`mode`)."""

    levels: Tuple[TopologyLevel, ...]

    def __post_init__(self):
        if not self.levels:
            raise ValueError("a topology tree needs >= 1 level")

    @property
    def world(self) -> int:
        n = 1
        for lv in self.levels:
            n *= lv.extent
        return n

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(lv.name for lv in self.levels)

    @property
    def mode(self) -> str:
        """1 level = ``"flat"``, 2 = ``"two_level"``, more = ``"tree"``."""
        return {1: "flat", 2: "two_level"}.get(len(self.levels), "tree")

    def effective(self) -> "TopologyTree":
        """The tree with its extent-1 levels dropped (they move no bytes);
        at least one level is kept, so a world of one stays a tree."""
        keep = tuple(lv for lv in self.levels if lv.extent > 1)
        return TopologyTree(levels=keep or self.levels[:1])


def resolve_topology(hierarchy: str, axis_sizes: Sequence[int],
                     axis_names: Optional[Sequence[str]] = None,
                     wire_bits: Optional[int] = None,
                     level_codecs: Optional[Dict[str, Optional[int]]] = None
                     ) -> TopologyTree:
    """The :class:`TopologyTree` of ``hierarchy`` over the extents
    ``axis_sizes`` (mesh order, outermost first), with JAX
    ``resolve_topology``'s rule and errors.

    Default names: ``("local",)`` for one axis, :data:`LAYOUT_AXES` for
    two, the outermost-first reversal of :data:`DEFAULT_LEVEL_NAMES`
    beyond that.

    * ``"flat"``: one level over every axis; ``wire_bits`` compresses its
      whole wire.
    * ``"two_level"``: exactly two axes (``ValueError`` otherwise: an
      explicit request must not flatten), ``wire_bits`` on the outer hop
      only.
    * ``"tree"``: every axis a level, ``wire_bits`` on the outermost hop.
    * ``"auto"``: ``two_level`` (two axes) or ``tree`` (more) exactly when
      at least two axes have extent > 1, else ``flat``.

    ``level_codecs`` (:func:`parse_level_codecs`) sets the codec width by
    level name; a name the tree does not have raises."""
    if hierarchy not in TOPOLOGY_MODES:
        raise ValueError(f"hierarchy must be one of {TOPOLOGY_MODES}, got "
                         f"{hierarchy!r}")
    sizes = [int(s) for s in axis_sizes]
    if not sizes:
        raise ValueError("axis_sizes must name >= 1 mesh axis")
    if axis_names is None:
        if len(sizes) == 1:
            axis_names = LAYOUT_AXES[1:]
        elif len(sizes) == 2:
            axis_names = LAYOUT_AXES
        elif len(sizes) <= len(DEFAULT_LEVEL_NAMES):
            axis_names = tuple(reversed(DEFAULT_LEVEL_NAMES[:len(sizes)]))
        else:
            raise ValueError(
                f"{len(sizes)} axes exceed the default level names "
                f"{DEFAULT_LEVEL_NAMES}; pass axis_names explicitly")
    names = tuple(str(n) for n in axis_names)
    if len(names) != len(sizes):
        raise ValueError(f"axis_names {names} does not match {len(sizes)} "
                         f"axis size(s)")
    codecs = dict(level_codecs or {})
    unknown = set(codecs) - set(names)
    if unknown:
        raise ValueError(
            f"level codec(s) for unknown level(s) {sorted(unknown)}: tree "
            f"levels are {list(reversed(names))}")
    if hierarchy == "two_level" and len(sizes) != 2:
        raise ValueError(
            "hierarchy='two_level' needs a 2-axis (dp_outer, dp_inner) "
            f"data-parallel spec, got {len(sizes)} axis/es")
    if hierarchy == "auto":
        effective = [s for s in sizes if s > 1]
        hierarchy = "flat" if len(effective) < 2 else \
            ("two_level" if len(sizes) == 2 else "tree")
    if hierarchy == "flat":
        world = 1
        for s in sizes:
            world *= s
        name = names[-1] if len(names) == 1 else "flat"
        return TopologyTree(levels=(TopologyLevel(
            name=name, extent=world, wire_bits=codecs.get(name, wire_bits),
            axes=names if len(names) > 1 else None),))
    inner_first = list(zip(reversed(names), reversed(sizes)))
    return TopologyTree(levels=tuple(
        TopologyLevel(name=name, extent=extent, wire_bits=codecs.get(
            name, wire_bits if i == len(inner_first) - 1 else None))
        for i, (name, extent) in enumerate(inner_first)))


def resolve_hierarchy(hierarchy: str, axis_sizes: Sequence[int]) -> str:
    """The ``"auto"|"flat"|"two_level"`` knob resolved against the
    extents (JAX ``resolve_hierarchy``): ``"flat"`` or ``"two_level"``; an
    auto'd spec of more than two axes answers ``"flat"``, as it did before
    trees existed."""
    if hierarchy not in HIERARCHY_MODES:
        raise ValueError(f"hierarchy must be one of {HIERARCHY_MODES}, got "
                         f"{hierarchy!r}")
    mode = resolve_topology(hierarchy, axis_sizes).mode
    return "flat" if mode == "tree" else mode


@dataclasses.dataclass
class TreeLayout:
    """The ``hvd.init()`` world laid out over named axes, the port's
    counterpart of the N-axis JAX ``Mesh`` that ``sharded_distributed_update``
    takes as its ``axis``: extents and names outermost first, and rank
    ``r`` at the C-order coordinates of ``r`` over ``shape``, as JAX's mesh
    orders ``devices.reshape(shape)``::

        layout = TreeLayout(shape=(2, 2, 2), names=("pod", "slice", "chip"))
        opt = hvd.DistributedOptimizer(inner, shard_optimizer_states=True,
                                       axis=layout, hierarchy="tree")

    Each axis is a level of the exchange tree, named as the layout names
    it (``level_codecs`` are placed by those names).  :meth:`groups` makes
    the process groups at its first call in a world."""

    shape: Tuple[int, ...]
    names: Tuple[str, ...]

    def __post_init__(self):
        self.shape = tuple(int(n) for n in self.shape)
        self.names = tuple(str(n) for n in self.names)
        if not self.shape or len(self.shape) != len(self.names):
            raise ValueError(f"a TreeLayout needs one name for each of its "
                             f">= 1 extents, got shape {self.shape} and "
                             f"names {self.names}")
        if len(set(self.names)) != len(self.names):
            raise ValueError(f"TreeLayout axis names must differ, got "
                             f"{self.names}")
        if any(n < 1 for n in self.shape):
            raise ValueError(f"TreeLayout extents must be >= 1, got "
                             f"{self.shape}")

    @property
    def size(self) -> int:
        n = 1
        for e in self.shape:
            n *= e
        return n

    def check_world(self, world: int) -> None:
        """Raise unless the layout covers a world of ``world`` ranks."""
        if self.size != world:
            raise ValueError(
                f"the layout {dict(zip(self.names, self.shape))} covers "
                f"{self.size} ranks, and the world has {world}: the "
                f"product of the extents must be the world's size")

    def groups(self) -> Dict[str, Optional[Any]]:
        """This rank's process group along each axis: ``None`` at extent
        1, the world's group when the axis spans the world.  The first
        call in a world makes every group of every axis
        (``GlobalState.tree_groups``), so every rank must make it
        together, at the same point of its program; later calls in that
        world, and equal layouts, return the same groups, and
        ``hvd.shutdown()`` releases them."""
        from horovod_tpu_torch.runtime import state

        st = state.global_state()
        self.check_world(st.size)
        return st.tree_groups(self.shape, self.names)
