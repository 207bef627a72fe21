"""Per-direction stencil radius over the 27-cell neighborhood.

The port's own copy of ``stencil_tpu.geometry.radius`` (reference:
include/stencil/radius.hpp:14-104, include/stencil/direction_map.hpp:11-58).

Semantics pinned from the reference:
- ``dir(d)`` for a *face* direction is the halo width on that side; for edge
  and corner directions the stored value acts as an on/off gate for whether
  that diagonal exchange happens at all, and as a weight in the partitioner's
  interface cost — halo *extents* always use the face radii
  (reference: local_domain.cuh:212-222 uses ``radius.x(dir.x)`` etc.).
"""

from __future__ import annotations

from .dim3 import Dim3


class Radius:
    __slots__ = ("_r",)

    def __init__(self):
        # dict keyed by direction tuple (-1..1)^3
        self._r: dict[tuple[int, int, int], int] = {
            (x, y, z): 0 for x in (-1, 0, 1) for y in (-1, 0, 1) for z in (-1, 0, 1)
        }

    # -- accessors ----------------------------------------------------------
    def dir(self, x, y=None, z=None) -> int:
        if y is None:  # Dim3 or tuple
            d = Dim3.of(x)
            x, y, z = d.x, d.y, d.z
        return self._r[(x, y, z)]

    def set_dir(self, d, r: int) -> None:
        d = Dim3.of(d)
        self._r[(d.x, d.y, d.z)] = int(r)

    def x(self, d: int) -> int:
        """Face radius on the ±x side (reference: radius.hpp:25-30)."""
        return self._r[(d, 0, 0)]

    def y(self, d: int) -> int:
        return self._r[(0, d, 0)]

    def z(self, d: int) -> int:
        return self._r[(0, 0, d)]

    def __eq__(self, other) -> bool:
        return isinstance(other, Radius) and self._r == other._r

    def __hash__(self):
        return hash(tuple(sorted(self._r.items())))

    def without_x(self) -> "Radius":
        """Copy with every x-involving direction zeroed — the tight-x
        layout: no x halo columns are allocated or exchanged, the compute
        kernels form the periodic x neighborhood by index arithmetic.
        Valid only for single-block x axes."""
        ret = Radius()
        for d, v in self._r.items():
            ret._r[d] = 0 if d[0] != 0 else v
        return ret

    # -- bulk setters (reference: radius.hpp:46-79) -------------------------
    def set_face(self, r: int) -> None:
        for d in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)):
            self._r[d] = int(r)

    def set_edge(self, r: int) -> None:
        for d in self._r:
            if sum(1 for c in d if c != 0) == 2:
                self._r[d] = int(r)

    def set_corner(self, r: int) -> None:
        for d in self._r:
            if sum(1 for c in d if c != 0) == 3:
                self._r[d] = int(r)

    # -- factories ----------------------------------------------------------
    @staticmethod
    def constant(r: int) -> "Radius":
        """All 26 directions get radius ``r`` (reference: radius.hpp:81-91).
        The center entry is also set to ``r`` to match the reference."""
        ret = Radius()
        for d in ret._r:
            ret._r[d] = int(r)
        return ret

    @staticmethod
    def face_edge_corner(face: int, edge: int, corner: int) -> "Radius":
        """Reference: radius.hpp:95-103 (center forced to 0)."""
        ret = Radius()
        ret.set_face(face)
        ret.set_edge(edge)
        ret.set_corner(corner)
        ret._r[(0, 0, 0)] = 0
        return ret

    # -- derived ------------------------------------------------------------
    def face_tuple(self, sign: int) -> tuple[int, int, int]:
        """(x, y, z) face radii on the ``sign`` side."""
        return (self.x(sign), self.y(sign), self.z(sign))

    def max_radius(self) -> int:
        return max(r for d, r in self._r.items() if d != (0, 0, 0))

    def __repr__(self) -> str:
        return (
            f"Radius(x={self.x(-1)}/{self.x(1)}, y={self.y(-1)}/{self.y(1)}, "
            f"z={self.z(-1)}/{self.z(1)})"
        )
