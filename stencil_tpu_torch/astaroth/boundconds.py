"""Symmetric / antisymmetric / periodic boundary conditions.

The port's copy of ``stencil_tpu.astaroth.boundconds`` (reference:
astaroth/boundconds.cuh), in plain tensor slicing: the JAX package computes
it on XLA with no Pallas kernel, and the app never calls it. Semantics as
the reference's index math intends (``src = 2*bound - dst``, mirroring
about the first/last interior cell, sign +1 symmetric / -1 antisymmetric):

    ghost[b0 - g] = sign * field[b0 + g]      (low side,  g = 1..r)
    ghost[b1 + g] = sign * field[b1 - g]      (high side)

Two reference caveats, kept as the JAX package keeps them: (a) the kernels
are vestigial — ``astaroth.cu`` never calls them, the reference program is
periodic only through the library's exchange; (b) the reference's write line is
``vtxbuf[dst] = sign*vtxbuf[src] * 0.0 + 1.0`` (boundconds.cuh:127), a
disabled state; the real mirror is implemented.

These work on a padded [.., z, y, x] block (leading dims allowed, e.g. the
stacked ``(bz, by, bx, pz, py, px)`` state) along axes whose partition has
a single block: a domain boundary is a block boundary only there. Like the
JAX functions they return a new tensor and leave their argument as it was.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..domain.grid import GridSpec
from ..ops.halo_fill import axis_geom

SYMMETRIC = "symmetric"
ANTISYMMETRIC = "antisymmetric"
PERIODIC = "periodic"

_AXIS_DIM = {"z": -3, "y": -2, "x": -1}


def _index(arr: torch.Tensor, dim: int, idx: int):
    sl = [slice(None)] * arr.ndim
    sl[dim] = idx
    return tuple(sl)


def apply_mirror(arr: torch.Tensor, spec: GridSpec, axis: str, sign: int) -> torch.Tensor:
    """Fill both ghost zones of ``axis`` by mirroring about the boundary
    cells (reference: boundconds.cuh:44-111 index math). The axis must
    have a single block in the partition."""
    n_blocks = {"x": spec.dim.x, "y": spec.dim.y, "z": spec.dim.z}[axis]
    if n_blocks != 1:
        raise ValueError(f"non-periodic {axis} boundary needs a single block on that axis")
    o, sz, rm, rp = axis_geom(spec, axis)
    dim = arr.ndim + _AXIS_DIM[axis]
    out = arr.clone()
    b0 = o  # first interior cell (boundloc0, boundconds.cuh:31)
    b1 = o + sz - 1  # last interior cell (boundloc1)
    for g in range(1, rm + 1):
        out[_index(out, dim, b0 - g)] = sign * out[_index(out, dim, b0 + g)]
    for g in range(1, rp + 1):
        out[_index(out, dim, b1 + g)] = sign * out[_index(out, dim, b1 - g)]
    return out


def symmetric(arr: torch.Tensor, spec: GridSpec, axis: str) -> torch.Tensor:
    """sign=+1 (reference: acKernelSymmetricBoundconds)."""
    return apply_mirror(arr, spec, axis, +1)


def antisymmetric(arr: torch.Tensor, spec: GridSpec, axis: str) -> torch.Tensor:
    """sign=-1 (reference: acKernelAntisymmetricBoundconds)."""
    return apply_mirror(arr, spec, axis, -1)


def apply_boundconds(arr: torch.Tensor, spec: GridSpec, kinds: Dict[str, str]) -> torch.Tensor:
    """Apply per-axis boundary conditions to a padded block.

    ``kinds`` maps axis name ('x'/'y'/'z') to SYMMETRIC/ANTISYMMETRIC/
    PERIODIC; PERIODIC axes are left to the halo exchange (the reference
    program's only mode, astaroth.conf bcs)."""
    for axis, kind in kinds.items():
        if kind == PERIODIC:
            continue
        if kind == SYMMETRIC:
            arr = symmetric(arr, spec, axis)
        elif kind == ANTISYMMETRIC:
            arr = antisymmetric(arr, spec, axis)
        else:
            raise ValueError(f"unknown boundary condition {kind!r}")
    return arr
