"""LocalBlock — one subdomain's quantities as halo-padded torch tensors.

The port's counterpart of ``stencil_tpu.domain.block`` (reference:
include/stencil/local_domain.cuh:34-276, src/local_domain.cu). Each
quantity is a dense tensor of shape ``raw_size = size + radius- + radius+``,
indexed ``[z, y, x]`` (x fastest, the reference's pitched memory order),
double-buffered as curr and next; ``swap()`` exchanges the two dicts. The
tensors live on an explicit device: ``device=None`` is the current CUDA
device (raising when none is visible), ``device="cpu"`` the CPU.

Unlike the JAX block, whose arrays are immutable, the tensors are mutable:
``get_curr`` returns the block's own tensor, and ``set_curr`` replaces it.
:func:`stencil_tpu_torch.convert.block_from_jax` carries a JAX block's
arrays across.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..geometry import Dim3, Radius, Rect3, compute_offset, halo_rect, raw_size
from .handle import DataHandle


def block_rect_slices(rect: Rect3) -> Tuple[slice, slice, slice]:
    """Slices selecting an allocation-local ``Rect3`` from a [z,y,x] tensor."""
    return (
        slice(rect.lo.z, rect.hi.z),
        slice(rect.lo.y, rect.hi.y),
        slice(rect.lo.x, rect.hi.x),
    )


def block_compute_slices(size, radius: Radius) -> Tuple[slice, slice, slice]:
    """Slices selecting the compute (interior, non-halo) region: every
    coordinate offset by the negative-side radius (the reference's
    accessor origin, local_domain.cuh:153-173)."""
    sz = Dim3.of(size)
    off = compute_offset(radius)
    return (
        slice(off.z, off.z + sz.z),
        slice(off.y, off.y + sz.y),
        slice(off.x, off.x + sz.x),
    )


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = getattr(torch, str(np.dtype(dtype)), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return dt


class LocalBlock:
    """All quantities of one subdomain, halo-padded, double-buffered, on
    one device: ``add_data`` -> ``realize`` -> ``get_curr``/``get_next`` ->
    ``swap``, and the geometry queries (``raw_size``, ``halo_region``...)."""

    def __init__(self, size, origin, radius: Optional[Radius] = None, device=None):
        from ..api import resolve_device

        self.size = Dim3.of(size)
        self.origin = Dim3.of(origin)
        self.radius = radius if radius is not None else Radius.constant(0)
        self.device = resolve_device(device)
        self._handles: List[DataHandle] = []
        self._curr: Dict[int, torch.Tensor] = {}
        self._next: Dict[int, torch.Tensor] = {}
        self._realized = False

    # -- setup (reference: local_domain.cuh:85-107) -------------------------
    def set_radius(self, radius: Radius) -> None:
        if self._realized:
            raise RuntimeError("set_radius after realize")
        self.radius = radius

    def add_data(self, name: str = "", dtype="float32") -> DataHandle:
        if self._realized:
            raise RuntimeError("add_data after realize")
        dt = _torch_dtype(dtype)
        h = DataHandle(len(self._handles), name or f"q{len(self._handles)}",
                       str(dt).replace("torch.", ""))
        self._handles.append(h)
        return h

    def realize(self) -> None:
        """Allocate zero curr and next tensors per quantity
        (reference: src/local_domain.cu:159-220)."""
        shape = self._shape()
        for h in self._handles:
            dt = getattr(torch, h.dtype)
            self._curr[h.idx] = torch.zeros(shape, dtype=dt, device=self.device)
            self._next[h.idx] = torch.zeros(shape, dtype=dt, device=self.device)
        self._realized = True

    # -- geometry -----------------------------------------------------------
    def raw_size(self) -> Dim3:
        return raw_size(self.size, self.radius)

    def _shape(self) -> Tuple[int, int, int]:
        return self.raw_size().as_tuple()[::-1]  # [z, y, x]

    def num_data(self) -> int:
        return len(self._handles)

    def handles(self) -> Tuple[DataHandle, ...]:
        return tuple(self._handles)

    def compute_slices(self) -> Tuple[slice, slice, slice]:
        return block_compute_slices(self.size, self.radius)

    def halo_region(self, direction, halo: bool) -> Rect3:
        """Allocation-local halo (``halo=True``) or matching interior-edge
        region (reference: src/local_domain.cu:86-129)."""
        return halo_rect(direction, self.size, self.radius, halo)

    # -- data access --------------------------------------------------------
    def get_curr(self, h: DataHandle) -> torch.Tensor:
        return self._curr[h.idx]

    def get_next(self, h: DataHandle) -> torch.Tensor:
        return self._next[h.idx]

    def _checked(self, arr) -> torch.Tensor:
        t = torch.as_tensor(arr)
        if tuple(t.shape) != self._shape():
            raise ValueError(f"shape {tuple(t.shape)} != padded {self._shape()}")
        return t.to(self.device)

    def set_curr(self, h: DataHandle, arr) -> None:
        self._curr[h.idx] = self._checked(arr)

    def set_next(self, h: DataHandle, arr) -> None:
        self._next[h.idx] = self._checked(arr)

    def curr_tree(self) -> Dict[int, torch.Tensor]:
        return dict(self._curr)

    def next_tree(self) -> Dict[int, torch.Tensor]:
        return dict(self._next)

    def swap(self) -> None:
        """Exchange curr and next (reference: src/local_domain.cu:67-84): a
        host-side swap of the two dicts, no device work."""
        self._curr, self._next = self._next, self._curr

    # -- host transfer (reference: local_domain.cuh:264-273, region_to_host)
    def quantity_to_host(self, h: DataHandle, curr: bool = True) -> np.ndarray:
        """The full padded region including halos, as numpy [z,y,x]."""
        src = self._curr if curr else self._next
        return src[h.idx].detach().cpu().numpy()

    def region_to_host(self, h: DataHandle, rect: Rect3, curr: bool = True) -> np.ndarray:
        src = self._curr if curr else self._next
        return src[h.idx][block_rect_slices(rect)].detach().cpu().numpy()

    def interior_to_host(self, h: DataHandle, curr: bool = True) -> np.ndarray:
        src = self._curr if curr else self._next
        return src[h.idx][self.compute_slices()].detach().cpu().numpy()
