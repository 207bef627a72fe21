"""In-place periodic halo fills for self-wrap axes, and quantity grouping.

The port's counterpart of ``stencil_tpu.ops.halo_fill``. On an axis whose
partition has a single block, the periodic halo source is the block itself,
so that axis's exchange phase is a copy inside device memory:
:func:`self_fill` launches the hand-written CUDA kernel
(``csrc/self_fill.cu``, replacing the TPU's ``make_self_fill``) and
:func:`self_fill_plain` is the same copy in plain PyTorch. Both update the
tensors in place (the JAX version returns new arrays).

Fill order across axes is the composed x -> y -> z order (:data:`AXIS_ORDER`);
each axis copies the full padded extent of the other two, halos included, so
calling the axes in that order composes edges and corners exactly as the JAX
package's single-block ``HaloExchange`` does.

``z_stack > 1`` is the fill of a stack of resident blocks, each a
contiguous ``(pz, py, px)`` block: the x and y fills act within each z
plane, so one launch over the stack viewed as one
``(z_stack * pz, py, px)`` array fills every resident's halos, as the TPU
kernel's ``z_stack`` form does for a ``(cz, 1, 1)`` residency. The port's
exchange stacks the residents of any residency this way.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from ..domain.grid import GridSpec
from . import _native

AXIS_ORDER = ("x", "y", "z")
_AXIS_DIM = {"z": 0, "y": 1, "x": 2}

# quantities one fill launch can carry (the kernel's pointer table)
MAX_FILL_GROUP = 16


def dtype_groups(state) -> List[Tuple[torch.dtype, list]]:
    """``[(dtype, [keys])]`` of a quantity dict, grouped by dtype in
    first-appearance order: quantities of one group share one fill launch
    (and, later, one packed carrier); distinct dtypes are moved separately
    and never bitcast."""
    groups: dict = {}
    for k, v in state.items():
        groups.setdefault(v.dtype, []).append(k)
    return list(groups.items())


def pack_slabs(slabs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stack a same-dtype group's boundary slabs into one ``(Q, ...slab)``
    carrier; a single slab is its own carrier (no leading unit axis)."""
    return slabs[0] if len(slabs) == 1 else torch.stack(list(slabs))


def unpack_slabs(carrier: torch.Tensor, nq: int) -> List[torch.Tensor]:
    """Inverse of :func:`pack_slabs`, including the Q=1 degeneration."""
    return [carrier] if nq == 1 else [carrier[q] for q in range(nq)]


def axis_geom(spec: GridSpec, axis: str) -> Tuple[int, int, int, int]:
    """``(offset, size, rm, rp)`` of one axis: compute-region origin and
    extent in the padded block, and the lo / hi halo widths."""
    off = spec.compute_offset()
    r = spec.radius
    if axis == "x":
        return off.x, spec.base.x, r.x(-1), r.x(1)
    if axis == "y":
        return off.y, spec.base.y, r.y(-1), r.y(1)
    if axis == "z":
        return off.z, spec.base.z, r.z(-1), r.z(1)
    raise ValueError(f"unknown axis {axis!r}")


def _axis_slice(t: torch.Tensor, axis: str, lo: int, hi: int):
    idx = [slice(None)] * t.dim()
    idx[t.dim() - 3 + _AXIS_DIM[axis]] = slice(lo, hi)
    return tuple(idx)


def self_fill_plain(blocks: Sequence[torch.Tensor], spec: GridSpec, axis: str):
    """Plain PyTorch version of the fill: for each ``(..., pz, py, px)``
    block, halo ``[o - rm, o)`` <- ``[o + n - rm, o + n)`` and
    ``[o + n, o + n + rp)`` <- ``[o, o + rp)`` along ``axis``, over the full
    extent of the other axes. In place; returns the blocks."""
    o, n, rm, rp = axis_geom(spec, axis)
    for b in blocks:
        if rm:
            b[_axis_slice(b, axis, o - rm, o)] = b[_axis_slice(b, axis, o + n - rm, o + n)]
        if rp:
            b[_axis_slice(b, axis, o + n, o + n + rp)] = b[_axis_slice(b, axis, o, o + rp)]
    return list(blocks)


def fill_bytes(spec: GridSpec, axis: str, itemsize: int) -> int:
    """Bytes one quantity's fill of ``axis`` must move: each halo cell's
    source read once and the cell written once."""
    _, _, rm, rp = axis_geom(spec, axis)
    p = spec.padded()
    cells = {"z": p.y * p.x, "y": p.z * p.x, "x": p.z * p.y}[axis] * (rm + rp)
    return 2 * cells * itemsize


def _check_blocks(blocks: Sequence[torch.Tensor], spec: GridSpec, axis: str,
                  z_stack: int = 1) -> None:
    p = spec.padded()
    o, n, rm, rp = axis_geom(spec, axis)
    if not 1 <= len(blocks) <= MAX_FILL_GROUP:
        raise ValueError(f"fill group of {len(blocks)} outside [1, {MAX_FILL_GROUP}]")
    if n < max(rm, rp):
        raise ValueError(f"{axis}-axis block size {n} < radius {max(rm, rp)}")
    if z_stack < 1 or (z_stack > 1 and axis == "z"):
        raise ValueError(f"z_stack={z_stack}: a z-stack fills the x and y axes only")
    b0 = blocks[0]
    for b in blocks:
        if b.dtype != b0.dtype or b.device != b0.device:
            raise ValueError("a fill group shares one dtype and one device")
        if (tuple(b.shape[-3:]) != (p.z, p.y, p.x)
                or b.numel() != z_stack * p.z * p.y * p.x):
            raise ValueError(f"block shape {tuple(b.shape)} is not {z_stack} padded "
                             f"({p.z}, {p.y}, {p.x}) block(s)")
        if not b.is_contiguous():
            raise ValueError("fill blocks must be contiguous")
    if b0.element_size() not in (4, 8):
        raise ValueError(f"fill copies 4- or 8-byte elements, not {b0.dtype}")


def self_fill(blocks: Sequence[torch.Tensor], spec: GridSpec, axis: str, z_stack: int = 1):
    """Fill both periodic halos of ``axis`` in place for every block of a
    same-dtype group (at most :data:`MAX_FILL_GROUP`); with ``z_stack > 1``
    each tensor is a contiguous stack of that many resident blocks and
    ``axis`` is x or y. CPU tensors take :func:`self_fill_plain`; CUDA
    tensors launch ``csrc/self_fill.cu`` (one launch for the group) or
    raise."""
    _check_blocks(blocks, spec, axis, z_stack)
    dev = blocks[0].device
    if dev.type == "cpu":
        return self_fill_plain(blocks, spec, axis)
    if dev.type != "cuda":
        raise ValueError(f"self_fill runs on cuda or cpu tensors, not {dev}")
    o, n, rm, rp = axis_geom(spec, axis)
    if rm == 0 and rp == 0:
        return list(blocks)
    p = spec.padded()
    ptrs = (ctypes.c_void_p * len(blocks))(*[b.data_ptr() for b in blocks])
    rc = _native.lib("self_fill").self_fill_launch(
        ptrs, len(blocks), blocks[0].element_size(), z_stack * p.z, p.y, p.x,
        _AXIS_DIM[axis], o, n, rm, rp, dev.index, _native.stream_ptr(dev))
    _native.check(rc, f"self_fill[{axis}]")
    self_fill.launches += 1
    return list(blocks)


self_fill.launches = 0


def wrap_fill_batched(spec: GridSpec, a: torch.Tensor) -> torch.Tensor:
    """Periodic self-wrap fill of every leading-dim block of ``a``
    (``(..., pz, py, px)``, e.g. a stack of independent single-block tenant
    states), in the composed x -> y -> z order; nothing crosses the leading
    axes. In place; returns ``a``. Plain PyTorch, the counterpart of the JAX
    package's ``wrap_fill_batched``."""
    for axis in AXIS_ORDER:
        self_fill_plain([a], spec, axis)
    return a
