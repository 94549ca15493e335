"""ICI mesh/torus topology math, copied whole from the JAX package.

The allocator's topology-aware placement reads it for pools that publish a
mesh (subslices with shape and origin); GPU slices publish none, so for
them it decides by counters alone. Kept whole so that the port's allocator
decides exactly as the JAX package's on the same objects.

This is the TPU-native replacement for the reference's MIG profile/placement
model (``cmd/gpu-kubelet-plugin/nvlib.go:1247-1328`` enumerates valid GPU
memory-slice placements; ``mig.go:111-116`` defines canonical names). On TPU
the partitionable resource is not a linear run of memory slices but a 2D/3D
ICI mesh of chips; a valid "placement" is an axis-aligned, alignment-respecting
box of chips (a *subslice*). The same math also powers ComputeDomain slice
validation (multi-host boxes) and the fabric partitioner
(``pkg/icislice`` — the analogue of the reference's ``pkg/fabricmanager``).

Coordinates are row-major tuples; axis 0 is the slowest-varying.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Iterable, Iterator, Sequence


Coord = tuple[int, ...]


@dataclass(frozen=True)
class Box:
    """An axis-aligned box of chips: origin + shape (both length-ndims)."""

    origin: Coord
    shape: Coord

    def __post_init__(self) -> None:
        if len(self.origin) != len(self.shape):
            raise ValueError(f"origin {self.origin} and shape {self.shape} rank mismatch")
        if any(s <= 0 for s in self.shape):
            raise ValueError(f"non-positive shape {self.shape}")

    @property
    def ndims(self) -> int:
        return len(self.shape)

    @property
    def num_chips(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def coords(self) -> Iterator[Coord]:
        """All chip coordinates inside the box (no wraparound)."""
        ranges = [range(o, o + s) for o, s in zip(self.origin, self.shape)]
        return (tuple(c) for c in itertools.product(*ranges))

    def contains(self, coord: Coord) -> bool:
        return all(o <= c < o + s for c, o, s in zip(coord, self.origin, self.shape))

    def overlaps(self, other: "Box") -> bool:
        return all(
            o1 < o2 + s2 and o2 < o1 + s1
            for o1, s1, o2, s2 in zip(self.origin, self.shape, other.origin, other.shape)
        )

    def contains_box(self, other: "Box") -> bool:
        """Whether ``other`` lies entirely inside this box."""
        return all(
            o1 <= o2 and o2 + s2 <= o1 + s1
            for o1, s1, o2, s2 in zip(self.origin, self.shape,
                                      other.origin, other.shape)
        )

    @property
    def shape_str(self) -> str:
        return "x".join(str(s) for s in self.shape)

    @property
    def origin_str(self) -> str:
        return "-".join(str(o) for o in self.origin)

    def canonical_name(self, prefix: str = "sub") -> str:
        """Canonical subslice name — the analogue of the reference's MIG name
        ``gpu-<minor>-mig-<profile>-<placementStart>-<size>`` (mig.go:111-116):
        ``<prefix>-<shape>-at-<origin>``, e.g. ``sub-2x2-at-0-4``.
        """
        return f"{prefix}-{self.shape_str}-at-{self.origin_str}"

    @staticmethod
    def parse_shape(s: str) -> Coord:
        """Parse '4x4' / '2x2x4' → (4, 4) / (2, 2, 4)."""
        try:
            dims = tuple(int(p) for p in s.lower().split("x"))
        except ValueError as e:
            raise ValueError(f"invalid topology shape {s!r}") from e
        if not dims or any(d <= 0 for d in dims):
            raise ValueError(f"invalid topology shape {s!r}")
        return dims


@dataclass(frozen=True)
class Topology:
    """A mesh (or per-axis torus) of TPU chips.

    ``dims``: chips per axis, e.g. (4, 4) for v5e-16, (2, 2, 4) for v5p-16.
    ``wrap``: whether each axis has wraparound ICI links (torus). TPU slices
    get wraparound on an axis only when the slice spans the full physical
    axis; for subslice math we treat wrap as a property of the allocated box.
    """

    dims: Coord
    wrap: tuple[bool, ...] = ()

    def __post_init__(self) -> None:
        if not self.dims or any(d <= 0 for d in self.dims):
            raise ValueError(f"invalid dims {self.dims}")
        if self.wrap and len(self.wrap) != len(self.dims):
            raise ValueError("wrap rank mismatch")
        if not self.wrap:
            object.__setattr__(self, "wrap", tuple(False for _ in self.dims))

    @property
    def ndims(self) -> int:
        return len(self.dims)

    @property
    def num_chips(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    @property
    def shape_str(self) -> str:
        return "x".join(str(d) for d in self.dims)

    # -- index <-> coordinate -------------------------------------------------

    def coords_of(self, index: int) -> Coord:
        """Row-major chip index → coordinates."""
        if not 0 <= index < self.num_chips:
            raise IndexError(f"chip index {index} out of range for {self.dims}")
        coords = []
        for d in reversed(self.dims):
            coords.append(index % d)
            index //= d
        return tuple(reversed(coords))

    def index_of(self, coord: Coord) -> int:
        if len(coord) != self.ndims:
            raise ValueError(f"coord {coord} rank mismatch with {self.dims}")
        idx = 0
        for c, d in zip(coord, self.dims):
            if not 0 <= c < d:
                raise IndexError(f"coord {coord} out of range for {self.dims}")
            idx = idx * d + c
        return idx

    def all_coords(self) -> Iterator[Coord]:
        return (tuple(c) for c in itertools.product(*(range(d) for d in self.dims)))

    # -- neighbors / links ----------------------------------------------------

    def neighbors(self, coord: Coord) -> list[Coord]:
        """ICI neighbors of a chip (mesh edges plus torus wraparound links)."""
        out = []
        for axis in range(self.ndims):
            for delta in (-1, 1):
                n = list(coord)
                n[axis] += delta
                if 0 <= n[axis] < self.dims[axis]:
                    out.append(tuple(n))
                elif self.wrap[axis] and self.dims[axis] > 2:
                    n[axis] %= self.dims[axis]
                    out.append(tuple(n))
        return out

    def num_ici_links(self) -> int:
        """Total number of (undirected) ICI links in the topology."""
        total = 0
        for axis in range(self.ndims):
            per_line = self.dims[axis] - 1
            if self.wrap[axis] and self.dims[axis] > 2:
                per_line += 1
            lines = self.num_chips // self.dims[axis]
            total += per_line * lines
        return total

    def bisection_links(self) -> int:
        """ICI links crossing a bisection of the longest axis — determines
        all-reduce bandwidth ceiling for collectives laid out on this mesh."""
        axis = max(range(self.ndims), key=lambda a: self.dims[a])
        if self.dims[axis] < 2:
            return 0
        cross_section = self.num_chips // self.dims[axis]
        return cross_section * (2 if self.wrap[axis] and self.dims[axis] > 2 else 1)

    # -- subslice validity (the MIG-placement analogue) -----------------------

    def is_valid_subslice(self, box: Box) -> bool:
        """A subslice is valid iff it fits, every dim divides the parent dim,
        and its origin is aligned to its shape (``origin[i] % shape[i] == 0``).

        Alignment guarantees that the set of same-shaped subslices tiles the
        mesh exactly — the property the reference gets from fixed MIG
        placement tables (nvlib.go:1247-1328) and that KEP-4815 shared
        counters rely on to make overlap impossible by construction.
        """
        if box.ndims != self.ndims:
            return False
        for o, s, d in zip(box.origin, box.shape, self.dims):
            if s > d or d % s != 0 or o % s != 0 or o + s > d:
                return False
        return True

    def aligned_origins(self, shape: Coord) -> Iterator[Coord]:
        """All valid (aligned) origins for a subslice of the given shape."""
        if len(shape) != self.ndims:
            raise ValueError(f"shape {shape} rank mismatch with {self.dims}")
        for o, d in zip(shape, self.dims):
            if d % o != 0:
                return
        ranges = [range(0, d, s) for s, d in zip(shape, self.dims)]
        yield from (tuple(c) for c in itertools.product(*ranges))

    def enumerate_subslices(self, shapes: Iterable[Coord]) -> list[Box]:
        """All valid placements for each of the requested shapes — the
        analogue of ``inspectMigProfilesAndPlacements`` (nvlib.go:1247)."""
        out: list[Box] = []
        for shape in shapes:
            if len(shape) != self.ndims:
                continue
            if any(d % s != 0 for s, d in zip(shape, self.dims)):
                continue
            for origin in self.aligned_origins(shape):
                out.append(Box(origin=origin, shape=shape))
        return out

    def enclosing_subslices(self, box: Box,
                            shapes: Iterable[Coord]) -> list[Box]:
        """Valid aligned placements of the given shapes that STRICTLY
        contain ``box`` (more chips, fully covering it), smallest first
        — the geometric form of the containment chains the free-box
        allocator precomputes from counter-key subsets
        (``kubeletplugin/allocator._PoolGeometry.link``; the property
        tests pin the two formulations equal over published menus).

        Alignment makes this cheap and unique: for a given containing
        shape, at most ONE aligned placement can cover an aligned box
        (the one whose origin is ``box.origin`` rounded down to the
        shape's alignment grid).
        """
        out: list[Box] = []
        for shape in shapes:
            if len(shape) != self.ndims:
                continue
            if any(d % s != 0 for s, d in zip(shape, self.dims)):
                continue
            origin = tuple(o - o % s for o, s in zip(box.origin, shape))
            cand = Box(origin=origin, shape=tuple(shape))
            if (cand.num_chips > box.num_chips
                    and self.is_valid_subslice(cand)
                    and cand.contains_box(box)):
                out.append(cand)
        out.sort(key=lambda b: (b.num_chips, b.shape, b.origin))
        return out

    def standard_subslice_shapes(self) -> list[Coord]:
        """The default partition menu: all boxes whose dims are powers of two
        dividing the parent dims, except the full topology itself (published
        separately as whole chips / the whole slice)."""
        per_axis: list[list[int]] = []
        for d in self.dims:
            opts = [s for s in _pow2_divisors(d)]
            per_axis.append(opts)
        shapes = [
            tuple(c) for c in itertools.product(*per_axis)
            if tuple(c) != self.dims
        ]
        # Sort: biggest first, then lexicographic, for stable publication order.
        shapes.sort(key=lambda s: (-_prod(s), s))
        return shapes

    def subslice_wrap(self, box: Box) -> tuple[bool, ...]:
        """A subslice inherits wraparound on an axis only if it spans it."""
        return tuple(
            w and s == d for w, s, d in zip(self.wrap, box.shape, self.dims)
        )


def _pow2_divisors(d: int) -> list[int]:
    out = []
    s = 1
    while s <= d:
        if d % s == 0:
            out.append(s)
        s *= 2
    return out


def _prod(xs: Sequence[int]) -> int:
    n = 1
    for x in xs:
        n *= x
    return n
