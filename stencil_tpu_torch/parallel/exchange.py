"""Periodic halo exchange of a single-block domain on one device.

The port's counterpart of ``stencil_tpu.parallel.exchange`` for one device
and a (1,1,1) partition. With a single block on every axis, each axis phase
of the axis-composed exchange is the block wrapping onto itself, so the
exchange is three in-place fills, x then y then z, through the fill kernel
(``ops/halo_fill.self_fill``). Each phase spans the full padded extent of
the other axes, so edges and corners compose exactly as in the JAX package.

``Method.REMOTE_DMA`` moves the same composed slabs by copies a kernel
issues; on one block every phase wraps onto the block itself, so its
exchange is the same three fills (the JAX package takes its composed body
there too). Its ``fused`` and ``persistent`` kernel variants change the step
loops (``ops/jacobi.py``), which then exchange inside their own kernels.

State layout, as in the JAX package: each quantity is one tensor of shape
``(bz, by, bx, pz, py, px)`` = ``(1, 1, 1, pz, py, px)``. Unlike the JAX
version, the exchange updates the tensors in place (it still returns the
state dict).

Multi-block partitions (NCCL point-to-point between GPUs) are slice 2 of
ROADMAP.md.
"""

from __future__ import annotations

import enum
from typing import Sequence

import numpy as np
import torch

from ..domain.grid import GridSpec
from ..geometry import DIRECTIONS_26, Dim3, halo_extent
from ..ops.fused_stencil import kernel_supported
from ..ops.halo_fill import AXIS_ORDER, MAX_FILL_GROUP, axis_geom, dtype_groups, self_fill
from ..plan.ir import build_plan


class Method(enum.Enum):
    """Exchange strategy, named as in the JAX package; the port has the
    axis-composed and remote-dma exchanges so far."""

    AXIS_COMPOSED = "axis-composed"
    REMOTE_DMA = "remote-dma"


def direction_bytes(spec: GridSpec, direction, itemsize: int) -> int:
    """Logical bytes received across all blocks for one direction's halos
    (reference: src/stencil.cu:139-161,620-627)."""
    d = Dim3.of(direction)
    if spec.radius.dir(d) == 0:
        return 0
    total = 0
    for iz in range(spec.dim.z):
        for iy in range(spec.dim.y):
            for ix in range(spec.dim.x):
                ext = halo_extent(d, spec.block_size((ix, iy, iz)), spec.radius)
                total += ext.flatten() * itemsize
    return total


class HaloExchange:
    """The single-device, single-block exchange: axis-composed, or
    remote-dma with its ``fused`` or ``persistent`` kernel variant."""

    def __init__(self, spec: GridSpec, method: Method = Method.AXIS_COMPOSED,
                 fused: bool = False, persistent: bool = False):
        if method not in (Method.AXIS_COMPOSED, Method.REMOTE_DMA):
            raise NotImplementedError(
                f"{method}: the port has the axis-composed and remote-dma exchanges only")
        # one device holds every block
        self.resident = spec.dim
        self.fused = bool(fused)
        if self.fused and method != Method.REMOTE_DMA:
            raise ValueError(
                "fused=True is the REMOTE_DMA fused compute+exchange "
                f"variant; got method {method}")
        self.persistent = bool(persistent)
        if self.persistent:
            if method != Method.REMOTE_DMA:
                raise ValueError(
                    "persistent=True is the REMOTE_DMA whole-chunk "
                    f"kernel variant; got method {method}")
            if self.fused:
                raise ValueError(
                    "fused and persistent are mutually exclusive kernel "
                    "variants (the persistent chunk at k == 1 IS the "
                    "fused substep)")
        if (self.fused or self.persistent) and not kernel_supported(spec, self.resident):
            variant = "fused compute+exchange" if self.fused else "persistent whole-chunk"
            raise ValueError(
                f"the {variant} variant supports single-resident partitions "
                f"only (got resident {self.resident}); use plain REMOTE_DMA "
                "or AXIS_COMPOSED for oversubscription")
        if spec.dim != Dim3(1, 1, 1):
            raise NotImplementedError(
                f"partition {spec.dim}: multi-block exchange (NCCL between "
                "GPUs) is slice 2 of ROADMAP.md; this slice runs (1,1,1)")
        for axis in AXIS_ORDER:
            _o, n, rm, rp = axis_geom(spec, axis)
            if n < max(rm, rp):
                raise ValueError(
                    f"{axis}-axis block size {n} < radius {max(rm, rp)}: "
                    "halo would span multiple blocks")
        self.spec = spec
        self.method = method
        self.plan = build_plan(spec, Dim3(1, 1, 1), method, resident=self.resident,
                               fused=self.fused, persistent=self.persistent)
        # device-program launches per k-step chunk of the last persistent
        # loop call, counted as the JAX package counts them (ops/jacobi.py)
        self.last_launches_per_chunk = 0
        self._loops = {}

    def __call__(self, state):
        """Fill every halo of every quantity in ``state``, a quantity dict
        or one tensor (in place; returns it)."""
        if isinstance(state, torch.Tensor):
            self({0: state})
            return state
        groups = dtype_groups(state)
        for axis in AXIS_ORDER:
            _o, _n, rm, rp = axis_geom(self.spec, axis)
            if rm == 0 and rp == 0:
                continue
            for _dt, keys in groups:
                for i in range(0, len(keys), MAX_FILL_GROUP):
                    self_fill([state[k] for k in keys[i:i + MAX_FILL_GROUP]],
                              self.spec, axis)
        return state

    def make_loop(self, iters: int):
        """``loop(state) -> state`` running ``iters`` back-to-back exchanges
        (reference: bin/exchange_weak.cu:168-177)."""
        if iters not in self._loops:
            def loop(state):
                for _ in range(iters):
                    state = self(state)
                return state

            self._loops[iters] = loop
        return self._loops[iters]

    def bytes_logical(self, itemsizes: Sequence[int]) -> int:
        """Total halo bytes delivered per exchange (reference-parity count)."""
        per_item = sum(direction_bytes(self.spec, d, 1) for d in DIRECTIONS_26)
        return per_item * sum(itemsizes)

    def bytes_moved(self, itemsizes: Sequence[int]) -> int:
        """Bytes relocated by the composed phases, whose slabs span full
        padded extents (>= bytes_logical)."""
        p = self.spec.padded()
        r = self.spec.radius
        per_item = (r.x(-1) + r.x(1)) * p.y * p.z
        per_item += (r.y(-1) + r.y(1)) * p.x * p.z
        per_item += (r.z(-1) + r.z(1)) * p.x * p.y
        return per_item * sum(itemsizes) * self.spec.num_blocks()


def shard_blocks(global_zyx: np.ndarray, spec: GridSpec, device, dtype=None) -> torch.Tensor:
    """Scatter a global [z,y,x] host array into the stacked padded layout
    ``(bz, by, bx, pz, py, px)`` on ``device``; halo and pad cells are 0."""
    g = spec.global_size
    if global_zyx.shape != (g.z, g.y, g.x):
        raise ValueError(
            f"global array shape {global_zyx.shape} != grid ({g.z}, {g.y}, {g.x})")
    stacked = np.zeros(spec.stacked_shape_zyx(), dtype=dtype or global_zyx.dtype)
    off = spec.compute_offset()
    for iz in range(spec.dim.z):
        for iy in range(spec.dim.y):
            for ix in range(spec.dim.x):
                o = spec.block_origin((ix, iy, iz))
                s = spec.block_size((ix, iy, iz))
                stacked[iz, iy, ix, off.z:off.z + s.z, off.y:off.y + s.y,
                        off.x:off.x + s.x] = global_zyx[
                    o.z:o.z + s.z, o.y:o.y + s.y, o.x:o.x + s.x]
    return torch.from_numpy(stacked).to(device)


def unshard_blocks(stacked: torch.Tensor, spec: GridSpec) -> np.ndarray:
    """Gather the compute regions of a stacked tensor into a global [z,y,x]
    host array (halos dropped)."""
    g = spec.global_size
    arr = stacked.detach().cpu().numpy()
    out = np.empty((g.z, g.y, g.x), dtype=arr.dtype)
    off = spec.compute_offset()
    for iz in range(spec.dim.z):
        for iy in range(spec.dim.y):
            for ix in range(spec.dim.x):
                o = spec.block_origin((ix, iy, iz))
                s = spec.block_size((ix, iy, iz))
                out[o.z:o.z + s.z, o.y:o.y + s.y, o.x:o.x + s.x] = arr[
                    iz, iy, ix, off.z:off.z + s.z, off.y:off.y + s.y,
                    off.x:off.x + s.x]
    return out
