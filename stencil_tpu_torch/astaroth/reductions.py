"""Reductions over the owned compute cells of a domain on one device.

The port's counterpart of ``stencil_tpu.astaroth.reductions`` (reference:
astaroth/reductions.cuh:1-60 — max/min/rms/sum over scalar fields and
vector magnitudes). The blocks are one, or every resident block of a
partition (uniform or uneven), stacked on the device: a reduction is a
masked torch reduction over the stack, where the JAX package reduces each
device's blocks and combines them with ``pmax``/``psum`` over its mesh. The
mask keeps halo, pad and (on an uneven partition) each smaller block's dead
tail out; it is built once and kept on each device it is used on.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..domain.grid import GridSpec


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
    tensors (``ex`` is the domain's ``HaloExchange``)."""

    def __init__(self, ex):
        self.spec = ex.spec
        self._mask = torch.from_numpy(compute_mask(ex.spec))
        self._count = int(self._mask.sum())
        self._on = {}

    def _mask_on(self, device) -> torch.Tensor:
        if device not in self._on:
            self._on[device] = self._mask.to(device)
        return self._on[device]

    def _stats(self, arr: torch.Tensor) -> Dict[str, float]:
        m = self._mask_on(arr.device)
        return {
            "max": float(torch.where(m, arr, -torch.inf).max()),
            "min": float(torch.where(m, arr, torch.inf).min()),
            "sum": float(torch.where(m, arr, 0.0).sum()),
            "rms": float(torch.sqrt(torch.where(m, arr * arr, 0.0).sum() / self._count)),
        }

    # reference: RTYPE_MAX / RTYPE_MIN / RTYPE_SUM / RTYPE_RMS
    def scal(self, arr: torch.Tensor) -> Dict[str, float]:
        return self._stats(arr)

    def vec(self, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> Dict[str, float]:
        return self._stats(torch.sqrt(x * x + y * y + z * z))
