"""Reductions over the owned compute cells of a domain.

The port's counterpart of ``stencil_tpu.astaroth.reductions`` (reference:
astaroth/reductions.cuh:1-60 — max/min/rms/sum over scalar fields and
vector magnitudes). The blocks are one, or every resident block of a
partition (uniform or uneven), stacked on the device, or a mesh's
per-position stacks: a reduction is a masked torch reduction over each
stack, combined over the positions as the JAX package combines its
devices' local reductions with ``pmax``/``psum``. The mask keeps halo, pad
and (on an uneven partition) each smaller block's dead tail out; it is
built once (on a mesh, split the way the mesh splits the state) and kept on
each device it is used on.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..domain.grid import GridSpec
from ..parallel.exchange import split_positions


def compute_mask(spec: GridSpec) -> np.ndarray:
    """Stacked bool array marking owned compute cells of every block."""
    mask = np.zeros(spec.stacked_shape_zyx(), dtype=bool)
    off = spec.compute_offset()
    for iz in range(spec.dim.z):
        for iy in range(spec.dim.y):
            for ix in range(spec.dim.x):
                s = spec.block_size((ix, iy, iz))
                mask[iz, iy, ix, off.z:off.z + s.z, off.y:off.y + s.y,
                     off.x:off.x + s.x] = True
    return mask


class Reductions:
    """Scalar and vector-magnitude reductions over a domain's stacked
    tensors, or a mesh's lists of per-position stacks (``ex`` is the
    domain's ``HaloExchange``)."""

    def __init__(self, ex):
        self.spec = ex.spec
        mask = torch.from_numpy(compute_mask(ex.spec))
        self._count = int(mask.sum())
        self._masks = split_positions(mask, ex.spec, ex.mesh) if ex.on_mesh else [mask]
        self._on = {}

    def _mask_on(self, i: int, device) -> torch.Tensor:
        if (i, device) not in self._on:
            self._on[i, device] = self._masks[i].to(device)
        return self._on[i, device]

    def _stats(self, arrs) -> Dict[str, float]:
        if isinstance(arrs, torch.Tensor):
            arrs = [arrs]
        if len(arrs) != len(self._masks):
            raise ValueError(f"{len(arrs)} stacks for {len(self._masks)} positions")
        parts = []
        for i, arr in enumerate(arrs):
            m = self._mask_on(i, arr.device)
            parts.append(torch.stack([torch.where(m, arr, -torch.inf).max(),
                                      torch.where(m, arr, torch.inf).min(),
                                      torch.where(m, arr, 0.0).sum(),
                                      torch.where(m, arr * arr, 0.0).sum()]).cpu())
        mx, mn, sm, sq = torch.stack(parts).unbind(1)
        return {"max": float(mx.max()), "min": float(mn.min()), "sum": float(sm.sum()),
                "rms": float(torch.sqrt(sq.sum() / self._count))}

    # reference: RTYPE_MAX / RTYPE_MIN / RTYPE_SUM / RTYPE_RMS
    def scal(self, arr) -> Dict[str, float]:
        return self._stats(arr)

    def vec(self, x, y, z) -> Dict[str, float]:
        if isinstance(x, torch.Tensor):
            return self._stats(torch.sqrt(x * x + y * y + z * z))
        return self._stats([torch.sqrt(a * a + b * b + c * c) for a, b, c in zip(x, y, z)])
