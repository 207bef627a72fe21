"""Per-block boundary shells of an uneven partition.

The port's copy of ``stencil_tpu.ops.shells``. On an uneven partition the
remainder rule makes trailing blocks one cell smaller along an axis
(``domain/grid.py``), so a block's hi-side boundary sits at its own size,
not at the base extent. The JAX package traces one program for every block
and reads each block's sizes with ``axis_index`` lookups; the port knows
each block index on the host, so the sizes are Python ints:

- :func:`dyn_block_sizes` is block ``idx``'s logical (z, y, x) sizes;
- :func:`shell_regions` lists the boundary shells (one per side of each
  included axis) as :class:`~..geometry.Rect3` in the padded block, each
  that side's radius thick, spanning the base extents of the other axes,
  and starting at the block's own size on the hi side;
- :func:`interior_mask` is True over the base compute extents where a
  face-radius stencil reads no halo of an included axis.

Shells overlap at edges and corners; every re-sweep reads the same
exchanged source, so a cell written twice gets one value and the order is
immaterial. A cross-section that spans the base extent of a smaller block
reaches into its dead pad tail, never into another block's data. The shells
are the rects that ``stencil_kernels.sweep_region`` (B1 on one rect)
re-sweeps in the uneven fused schedule (``ops/jacobi.py``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..domain.grid import GridSpec
from ..geometry import Dim3, Rect3


def dyn_block_sizes(spec: GridSpec, idx) -> Tuple[int, int, int]:
    """Block ``idx``'s (x, y, z index) logical sizes, in (z, y, x) order."""
    s = spec.block_size(idx)
    return s.z, s.y, s.x


def include_axes(spec: GridSpec, multi_block_only: bool) -> Tuple[bool, bool, bool]:
    """The (z, y, x) axes whose sides :func:`shell_regions` and
    :func:`interior_mask` take: every axis, or only the multi-block ones."""
    if not multi_block_only:
        return (True, True, True)
    return (spec.dim.z > 1, spec.dim.y > 1, spec.dim.x > 1)


def shell_regions(spec: GridSpec, sizes, include: Sequence[bool]) -> List[Rect3]:
    """The boundary shells of a block with (z, y, x) ``sizes``
    (:func:`dyn_block_sizes`) on the ``include``d axes, lo side then hi
    side per axis in (z, y, x) order, as allocation-local rects."""
    off = spec.compute_offset()
    o = (off.z, off.y, off.x)
    base = (spec.base.z, spec.base.y, spec.base.x)
    r = spec.radius
    rad = (r.z, r.y, r.x)
    regs = []
    for ax in range(3):
        if not include[ax]:
            continue
        for side, width in ((-1, rad[ax](-1)), (1, rad[ax](1))):
            if width <= 0:
                continue
            lo, size = list(o), list(base)
            if side > 0:
                lo[ax] = o[ax] + sizes[ax] - width
            size[ax] = width
            regs.append(Rect3(Dim3(lo[2], lo[1], lo[0]),
                              Dim3(lo[2] + size[2], lo[1] + size[1], lo[0] + size[0])))
    return regs


def interior_mask(spec: GridSpec, sizes, include: Sequence[bool], device=None) -> torch.Tensor:
    """Bool over the (base.z, base.y, base.x) compute extents: True where a
    face-radius stencil reads no halo of an ``include``d axis."""
    shape = (spec.base.z, spec.base.y, spec.base.x)
    r = spec.radius
    rad = (r.z, r.y, r.x)
    m = torch.ones(shape, dtype=torch.bool, device=device)
    for ax in range(3):
        if not include[ax]:
            continue
        view = [1, 1, 1]
        view[ax] = shape[ax]
        rel = torch.arange(shape[ax], device=device).view(view)
        m = m & (rel >= rad[ax](-1)) & (rel < sizes[ax] - rad[ax](1))
    return m
