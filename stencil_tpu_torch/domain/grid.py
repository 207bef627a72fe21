"""GridSpec — the static layout of a partitioned, halo-padded 3D grid.

The port's own copy of ``stencil_tpu.domain.grid``. Bundles what the reference scatters across ``DistributedDomain``/
``Placement``/``LocalDomain`` geometry state (reference:
include/stencil/stencil.hpp:33-122, include/stencil/partition.hpp:264-289):
the global extent, the partition grid, per-block logical sizes/origins
(uneven splits follow the reference's remainder rule, partition.hpp:55-86),
the per-direction radius, and the padded block shape.

Because the partition is a tensor product (each axis is split
independently), per-block sizes factor into three per-axis size lists —
this is what makes uneven blocks exchangeable with axis-aligned collective
permutes: blocks in the same ring share the orthogonal-axis sizes.

Array layout convention: tensors are indexed ``[z, y, x]``; all blocks
are padded to the *base* (largest) logical size plus both face radii, and
smaller blocks keep their data at the same compute offset with a dead tail
(the pad-and-mask strategy, SURVEY.md §7 step 4).

``aligned=True`` (the default) keeps the JAX package's padding exactly, so
the port's arrays have the JAX package's layout and state moves between the
two packages without re-layout (``stencil_tpu_torch.convert``). The CUDA
kernels take offsets and strides and do not depend on that padding.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

from ..geometry import Dim3, Radius, Rect3, halo_rect


def _axis_sizes(total: int, n: int, base: int) -> Tuple[int, ...]:
    """Per-index sizes along one axis under the reference remainder rule
    (partition.hpp:55-70): trailing indices lose one point."""
    rem = total % n
    # base = ceil(total / n) when rem != 0, else total / n
    return tuple(base - (1 if (rem != 0 and i >= rem) else 0) for i in range(n))


# The JAX package's alignment of the block's minor dims (its TPU tiles):
# y to 8 rows, x to 128 columns. Kept for layout parity; the pad tail beyond
# raw_size is dead cells, exactly like the uneven-partition tail.
ALIGN_Y = 8
ALIGN_X = 128


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclass(frozen=True)
class GridSpec:
    global_size: Dim3
    dim: Dim3  # number of blocks along x, y, z
    radius: Radius
    aligned: bool = True  # pad block planes to (ALIGN_Y, ALIGN_X) multiples
    base: Dim3 = field(init=False)  # largest block size
    sizes_x: Tuple[int, ...] = field(init=False)
    sizes_y: Tuple[int, ...] = field(init=False)
    sizes_z: Tuple[int, ...] = field(init=False)

    def __post_init__(self):
        g, d = self.global_size, self.dim
        if not (d.x >= 1 and d.y >= 1 and d.z >= 1):
            raise ValueError(f"partition {d} needs >= 1 block per axis")
        if not (g.x >= d.x and g.y >= d.y and g.z >= d.z):
            raise ValueError(f"global {g} too small for partition {d}")
        base = Dim3(-(-g.x // d.x), -(-g.y // d.y), -(-g.z // d.z))
        object.__setattr__(self, "base", base)
        object.__setattr__(self, "sizes_x", _axis_sizes(g.x, d.x, base.x))
        object.__setattr__(self, "sizes_y", _axis_sizes(g.y, d.y, base.y))
        object.__setattr__(self, "sizes_z", _axis_sizes(g.z, d.z, base.z))

    # -- factories ----------------------------------------------------------
    @classmethod
    def from_partition(cls, global_size, part, radius: Radius) -> "GridSpec":
        """From a RankPartition/NodePartition (same remainder semantics)."""
        return cls(Dim3.of(global_size), part.dim(), radius)

    # -- per-block queries ---------------------------------------------------
    def block_size(self, idx) -> Dim3:
        i = Dim3.of(idx)
        return Dim3(self.sizes_x[i.x], self.sizes_y[i.y], self.sizes_z[i.z])

    def block_origin(self, idx) -> Dim3:
        i = Dim3.of(idx)
        return Dim3(
            sum(self.sizes_x[: i.x]),
            sum(self.sizes_y[: i.y]),
            sum(self.sizes_z[: i.z]),
        )

    def is_uniform(self) -> bool:
        return self.base * self.dim == self.global_size

    def block_spec(self) -> "GridSpec":
        """One block of this partition as a one-block spec: the same padded
        shape and compute offset (the per-position view of a mesh)."""
        return GridSpec(self.base, Dim3(1, 1, 1), self.radius, self.aligned)

    # -- shapes --------------------------------------------------------------
    def padded(self) -> Dim3:
        """Per-block allocation extent (x, y, z); when ``aligned``, the y/x
        plane dims are rounded up to (ALIGN_Y, ALIGN_X) multiples (dead tail)
        and the compute region starts at an 8-aligned y row (see
        compute_offset)."""
        off = self.compute_offset()
        r = self.radius
        p = Dim3(off.x + self.base.x + r.x(1), off.y + self.base.y + r.y(1),
                 off.z + self.base.z + r.z(1))
        if not self.aligned:
            return p
        return Dim3(_round_up(p.x, ALIGN_X), _round_up(p.y, ALIGN_Y), p.z)

    def block_shape_zyx(self) -> Tuple[int, int, int]:
        p = self.padded()
        return (p.z, p.y, p.x)

    def stacked_shape_zyx(self) -> Tuple[int, int, int, int, int, int]:
        """Shape of the stacked-blocks array: (bz, by, bx, pz, py, px)."""
        p = self.padded()
        return (self.dim.z, self.dim.y, self.dim.x, p.z, p.y, p.x)

    def num_blocks(self) -> int:
        return self.dim.flatten()

    def compute_offset(self) -> Dim3:
        """Allocation-local origin of the compute region.

        In ``aligned`` layouts the y offset is rounded up to a multiple of
        ALIGN_Y, as in the JAX package. The rows between the y halo and the
        compute region are dead pad."""
        r = self.radius
        yo = r.y(-1)
        if self.aligned and yo > 0:
            yo = _round_up(yo, ALIGN_Y)
        return Dim3(r.x(-1), yo, r.z(-1))

    def halo_rect(self, direction, size=None, halo: bool = True) -> Rect3:
        """Allocation-local halo (or owned boundary) rect in *this* layout:
        the radius-origin geometry rect (geometry.halo_rect) translated by
        the aligned layout's extra compute offset."""
        r = self.radius
        sz = self.base if size is None else Dim3.of(size)
        shift = self.compute_offset() - Dim3(r.x(-1), r.y(-1), r.z(-1))
        rect = halo_rect(direction, sz, r, halo)
        return Rect3(rect.lo + shift, rect.hi + shift)
