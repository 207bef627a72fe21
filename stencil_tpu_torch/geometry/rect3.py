"""Rect3 — an axis-aligned half-open box [lo, hi) in grid coordinates.

The port's own copy of ``stencil_tpu.geometry.rect3`` (reference:
include/stencil/rect3.hpp:13-27). Used for compute regions and the
interior/exterior overlap decomposition.
"""

from __future__ import annotations

from dataclasses import dataclass

from .dim3 import Dim3


@dataclass(frozen=True)
class Rect3:
    lo: Dim3
    hi: Dim3

    @staticmethod
    def of(lo, hi) -> "Rect3":
        return Rect3(Dim3.of(lo), Dim3.of(hi))

    def extent(self) -> Dim3:
        """Size of the box (reference: rect3.hpp `extent`)."""
        return self.hi - self.lo

    def num_points(self) -> int:
        e = self.extent()
        return max(e.x, 0) * max(e.y, 0) * max(e.z, 0)

    def empty(self) -> bool:
        return self.num_points() == 0

    def contains(self, p: Dim3) -> bool:
        return (
            self.lo.x <= p.x < self.hi.x
            and self.lo.y <= p.y < self.hi.y
            and self.lo.z <= p.z < self.hi.z
        )

    def shifted(self, d: Dim3) -> "Rect3":
        return Rect3(self.lo + d, self.hi + d)

    def slices(self, origin: Dim3 = Dim3(0, 0, 0)) -> tuple[slice, slice, slice]:
        """Convert to numpy/torch basic-index slices relative to ``origin``."""
        lo = self.lo - origin
        hi = self.hi - origin
        return (slice(lo.x, hi.x), slice(lo.y, hi.y), slice(lo.z, hi.z))

    def __repr__(self) -> str:
        return f"Rect3({self.lo.as_tuple()}..{self.hi.as_tuple()})"
