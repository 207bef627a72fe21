"""Dim3 — an integer 3-vector for grid geometry.

The port's own copy of ``stencil_tpu.geometry.dim3`` (reference:
include/stencil/dim3.hpp), kept so this package imports nothing of the
JAX package. Used for extents, origins, partition indices and direction
vectors. Pure host-side math; kernels receive plain ints.

Note the reference's ``operator!=`` and ``max()`` carry known bugs
(SURVEY.md §2.5); this implementation is correct rather than bug-compatible.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator


@dataclass(frozen=True, order=False)
class Dim3:
    x: int = 0
    y: int = 0
    z: int = 0

    # -- constructors -------------------------------------------------------
    @staticmethod
    def of(v) -> "Dim3":
        if isinstance(v, Dim3):
            return v
        if isinstance(v, int):
            return Dim3(v, v, v)
        x, y, z = v
        return Dim3(int(x), int(y), int(z))

    # -- arithmetic ---------------------------------------------------------
    def _coerce(self, other) -> "Dim3":
        return Dim3.of(other)

    def __add__(self, other) -> "Dim3":
        o = self._coerce(other)
        return Dim3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, other) -> "Dim3":
        o = self._coerce(other)
        return Dim3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, other) -> "Dim3":
        o = self._coerce(other)
        return Dim3(self.x * o.x, self.y * o.y, self.z * o.z)

    def __floordiv__(self, other) -> "Dim3":
        o = self._coerce(other)
        return Dim3(self.x // o.x, self.y // o.y, self.z // o.z)

    def __mod__(self, other) -> "Dim3":
        o = self._coerce(other)
        return Dim3(self.x % o.x, self.y % o.y, self.z % o.z)

    def __neg__(self) -> "Dim3":
        return Dim3(-self.x, -self.y, -self.z)

    # -- queries ------------------------------------------------------------
    def flatten(self) -> int:
        """Number of points in the box (reference: dim3.hpp `flatten`)."""
        return self.x * self.y * self.z

    def all_ge(self, v: int) -> bool:
        return self.x >= v and self.y >= v and self.z >= v

    def all_lt(self, v: int) -> bool:
        return self.x < v and self.y < v and self.z < v

    def any_eq(self, v: int) -> bool:
        return self.x == v or self.y == v or self.z == v

    def min_elem(self) -> int:
        return min(self.x, self.y, self.z)

    def max_elem(self) -> int:
        return max(self.x, self.y, self.z)

    def wrap(self, lims: "Dim3") -> "Dim3":
        """Periodic wrap of each component into ``[0, lims)``
        (reference: dim3.hpp:208-230). Python's ``%`` already returns a
        non-negative result for positive moduli."""
        o = self._coerce(lims)
        return Dim3(self.x % o.x, self.y % o.y, self.z % o.z)

    # -- conversion / iteration --------------------------------------------
    def as_tuple(self) -> tuple[int, int, int]:
        return (self.x, self.y, self.z)

    def __iter__(self) -> Iterator[int]:
        yield self.x
        yield self.y
        yield self.z

    def __getitem__(self, i: int) -> int:
        return (self.x, self.y, self.z)[i]

    def __repr__(self) -> str:
        return f"Dim3({self.x},{self.y},{self.z})"


# The 26 non-zero directions of the 3x3x3 neighborhood, in the reference's
# planning order: z outer, y middle, x inner (reference: src/stencil.cu:331-333).
DIRECTIONS_26: tuple[Dim3, ...] = tuple(
    Dim3(x, y, z)
    for z in (-1, 0, 1)
    for y in (-1, 0, 1)
    for x in (-1, 0, 1)
    if (x, y, z) != (0, 0, 0)
)

FACE_DIRS: tuple[Dim3, ...] = tuple(d for d in DIRECTIONS_26 if abs(d.x) + abs(d.y) + abs(d.z) == 1)
EDGE_DIRS: tuple[Dim3, ...] = tuple(d for d in DIRECTIONS_26 if abs(d.x) + abs(d.y) + abs(d.z) == 2)
CORNER_DIRS: tuple[Dim3, ...] = tuple(d for d in DIRECTIONS_26 if abs(d.x) + abs(d.y) + abs(d.z) == 3)
