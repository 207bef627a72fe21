"""Halo geometry: where halo/exterior regions live inside a padded block.

The port's own copy of ``stencil_tpu.geometry.region``: the reference's
LocalDomain halo math
(reference: src/local_domain.cu:86-129 ``halo_pos``,
include/stencil/local_domain.cuh:212-239 ``halo_extent``/``raw_size``)
and the DistributedDomain interior/exterior overlap decomposition
(reference: src/stencil.cu:878-977).

Coordinates are *allocation-local*: a padded block has shape
``raw_size = size + radius- + radius+`` per axis, with the compute region
offset by the negative-side face radii.
"""

from __future__ import annotations

from .dim3 import DIRECTIONS_26, Dim3
from .radius import Radius
from .rect3 import Rect3


def halo_extent(direction, size, radius: Radius) -> Dim3:
    """Point-extent of the halo region on side ``direction``.

    A zero component of ``direction`` spans the full compute size on that
    axis; a nonzero component spans that side's *face* radius
    (reference: local_domain.cuh:212-222).
    """
    d = Dim3.of(direction)
    sz = Dim3.of(size)
    return Dim3(
        sz.x if d.x == 0 else radius.x(d.x),
        sz.y if d.y == 0 else radius.y(d.y),
        sz.z if d.z == 0 else radius.z(d.z),
    )


def halo_pos(direction, size, radius: Radius, halo: bool) -> Dim3:
    """Allocation-local position of the halo (``halo=True``) or the matching
    boundary interior / "exterior" region (``halo=False``) on side
    ``direction``. Reference: src/local_domain.cu:86-129.
    """
    d = Dim3.of(direction)
    sz = Dim3.of(size)

    def axis(dc: int, s: int, rm: int) -> int:
        # rm is the negative-side face radius on this axis
        if dc == 1:
            return s + (rm if halo else 0)
        if dc == -1:
            return 0 if halo else rm
        return rm

    return Dim3(
        axis(d.x, sz.x, radius.x(-1)),
        axis(d.y, sz.y, radius.y(-1)),
        axis(d.z, sz.z, radius.z(-1)),
    )


def raw_size(size, radius: Radius) -> Dim3:
    """Padded allocation size: compute size plus both face radii per axis
    (reference: local_domain.cuh:236-239)."""
    sz = Dim3.of(size)
    return Dim3(
        sz.x + radius.x(-1) + radius.x(1),
        sz.y + radius.y(-1) + radius.y(1),
        sz.z + radius.z(-1) + radius.z(1),
    )


def compute_offset(radius: Radius) -> Dim3:
    """Allocation-local origin of the compute region."""
    return Dim3(radius.x(-1), radius.y(-1), radius.z(-1))


def halo_rect(direction, size, radius: Radius, halo: bool) -> Rect3:
    """Allocation-local Rect3 of the halo (``halo=True``) or the matching
    owned boundary region (``halo=False``) on side ``direction``.

    The owned region adjacent to side ``d`` is what gets *sent* toward
    ``d``, so it is sized by the receiver's opposite-side halo:
    ``halo_extent(-d)`` (the reference pairs ``halo_pos(d, false)`` with
    ``halo_extent(-d)``, src/packer.cu:80-81, test_cuda_local_domain.cu
    "case1"). With asymmetric per-axis radii the two extents differ.
    """
    d = Dim3.of(direction)
    pos = halo_pos(d, size, radius, halo)
    ext = halo_extent(d if halo else -d, size, radius)
    return Rect3(pos, pos + ext)


def interior_region(compute: Rect3, radius: Radius) -> Rect3:
    """Shrink the compute region so that a stencil read in any direction with
    nonzero radius stays inside owned data (reference: src/stencil.cu:878-921).

    Walks all 26 directions; a negative direction component with nonzero
    radius pulls the low face in, a positive one pulls the high face in.
    """
    lo = list(compute.lo.as_tuple())
    hi = list(compute.hi.as_tuple())
    clo = compute.lo.as_tuple()
    chi = compute.hi.as_tuple()
    for d in DIRECTIONS_26:
        r = radius.dir(d)
        if r == 0:
            continue
        for ax, dc in enumerate((d.x, d.y, d.z)):
            if dc < 0:
                lo[ax] = max(clo[ax] + r, lo[ax])
            elif dc > 0:
                hi[ax] = min(chi[ax] - r, hi[ax])
    return Rect3(Dim3(*lo), Dim3(*hi))


def exterior_regions(compute: Rect3, interior: Rect3) -> list[Rect3]:
    """Decompose (compute minus interior) into at most 6 non-overlapping
    slabs by sliding faces inward: +x, +y, +z, -x, -y, -z order
    (reference: src/stencil.cu:927-977)."""
    ret: list[Rect3] = []
    lo = list(compute.lo.as_tuple())
    hi = list(compute.hi.as_tuple())

    # positive faces: peel [interior.hi, hi) slab then slide hi in
    for ax, int_hi in enumerate(interior.hi.as_tuple()):
        if int_hi != hi[ax]:
            slab_lo = list(lo)
            slab_hi = list(hi)
            slab_lo[ax] = int_hi
            ret.append(Rect3(Dim3(*slab_lo), Dim3(*slab_hi)))
            hi[ax] = int_hi
    # negative faces: peel [lo, interior.lo) slab then slide lo in
    for ax, int_lo in enumerate(interior.lo.as_tuple()):
        if int_lo != lo[ax]:
            slab_lo = list(lo)
            slab_hi = list(hi)
            slab_hi[ax] = int_lo
            ret.append(Rect3(Dim3(*slab_lo), Dim3(*slab_hi)))
            lo[ax] = int_lo
    return ret
