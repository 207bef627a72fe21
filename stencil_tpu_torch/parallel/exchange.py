"""Periodic halo exchange of a domain whose blocks all sit on one device.

The port's counterpart of ``stencil_tpu.parallel.exchange`` for one device:
a (1,1,1) partition, or any partition, uniform or uneven (the reference's
remainder rule, ``domain/grid.py``), with every block resident on the
device (the JAX package's oversubscribed layout, reference
``dd.set_gpus({0,0})``, stencil.hpp:154). The axis-composed exchange runs
the phases x then y then z; each spans the full padded extent of the other
axes, so edges and corners compose exactly as in the JAX package.

- An axis with one block wraps onto itself: its phase is an in-place fill
  through the fill kernel (``ops/halo_fill.self_fill``) on every resident.
  An x or y fill acts within each z plane, so it runs over each quantity's
  residents stacked as one ``(residents * pz, py, px)`` array (the TPU's
  ``z_stack`` form, which the JAX package uses on a ``(cz, 1, 1)``
  residency and the port under any residency); a z fill beside x or y
  residents takes each resident as a block of its own.
- An axis with several blocks is a resident phase
  (``_axis_phase_resident_batched`` in the JAX package): each resident's lo
  halo takes its lo neighbour's hi boundary slab and its hi halo its hi
  neighbour's lo slab, cyclically (the ring is this one device). Per phase
  side and quantity, one rolled copy of the boundary slabs of every
  resident moves them all (``torch.roll`` along the block dim). On an
  uneven axis each block's hi slab and hi halo sit at its own size
  (``o + n_i``), as in the JAX package's per-block offsets
  (``_resident_sizes``): one indexed copy per block and side.

``Method.REMOTE_DMA`` moves the same composed slabs by copies a kernel
issues; on one block every phase wraps onto the block itself, so its
exchange is the same three fills (the JAX package takes its composed body
there too). Its ``fused`` and ``persistent`` kernel variants change the step
loops (``ops/jacobi.py``), which then exchange inside their own kernels.
REMOTE_DMA on resident blocks is not ported yet (ROADMAP.md).

State layout, as in the JAX package: each quantity is one tensor of shape
``(bz, by, bx, pz, py, px)``. Unlike the JAX version, the exchange updates
the tensors in place (it still returns the state dict).

Over a mesh of several block positions (``mesh=``, a
``parallel.mesh.DeviceMesh`` with one block per position) each quantity is
a list of ``(1, 1, 1, pz, py, px)`` blocks, one per position in the mesh's
flat order, each its own allocation, and the exchange is REMOTE_DMA: the
axis carrier (``ops/remote_dma.RemoteDmaExchange``; also with
``persistent``, at the deep radius) or, with ``fused``, the fused exchange
carrier (``ops/fused_stencil.FusedRemoteDmaExchange``). The fused and
persistent jacobi loops then step through their kernels' wire-crossing
forms, one launch over every position (``ops/jacobi.py``). On an uneven
partition the axis carrier takes the uneven ring (B6's size table); the
fused exchange carrier, the fused step and the persistent chunk take
uniform partitions only, as on the TPU, so ``fused`` exchanges through the
axis carrier and steps by the JAX package's host-orchestrated schedule,
and ``persistent`` raises.
The mesh's positions must share one device (the reference's
``set_gpus({0,0})``); positions on distinct GPUs (peer access and event
waits between phases) and NCCL across hosts are ROADMAP.md queue A item 5.

``wire_dtype`` (the JAX package's bf16-on-the-wire compression and its fp8
tier) narrows what crosses between positions of a mesh: the carriers and
the fused step round each crossing floating word through the wire
(``ops/halo_fill.wire_narrow_dtype`` is the policy). On one device nothing
crosses, so a single block or a resident partition takes it as a no-op, as
the JAX package does on a one-device mesh.
"""

from __future__ import annotations

import enum
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..domain.grid import GridSpec
from ..geometry import DIRECTIONS_26, Dim3, halo_extent
from ..ops.fused_stencil import FusedRemoteDmaExchange, kernel_supported
from ..ops.halo_fill import (AXIS_ORDER, MAX_FILL_GROUP, _axis_slice, axis_geom, axis_sizes,
                             dtype_groups, self_fill, wire_name)
from ..ops.remote_dma import RemoteDmaExchange
from ..plan.ir import build_plan
from .mesh import DeviceMesh


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
    """The exchange of a domain whose blocks all sit on one device:
    axis-composed over any partition, uniform or uneven, or remote-dma
    (with its ``fused`` or ``persistent`` kernel variant) on one block; or,
    with ``mesh`` of several positions, remote-dma over the mesh (the axis
    carrier, or the fused exchange carrier with ``fused`` on a uniform
    partition), again with either kernel variant (``persistent`` on a
    uniform partition only). ``wire_dtype`` narrows the carriers crossing
    between positions (a no-op on one device); the persistent variant
    over a mesh refuses it."""

    def __init__(self, spec: GridSpec, method: Method = Method.AXIS_COMPOSED,
                 fused: bool = False, persistent: bool = False,
                 mesh: Optional[DeviceMesh] = None, wire_dtype=None):
        if method not in (Method.AXIS_COMPOSED, Method.REMOTE_DMA):
            raise NotImplementedError(
                f"{method}: the port has the axis-composed and remote-dma exchanges only")
        self.wire_dtype = wire_name(wire_dtype)
        self.mesh = mesh if mesh is not None and len(mesh) > 1 else None
        if self.mesh is None:
            # one device holds every block: the mesh is (1,1,1)
            mesh_dim = Dim3(1, 1, 1)
            self.resident = spec.dim
        else:
            mesh_dim = self._check_mesh(spec, method, self.mesh)
            self.resident = Dim3(1, 1, 1)
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
            if self.wire_dtype and self.mesh is not None:
                raise NotImplementedError(
                    f"wire_dtype={self.wire_dtype} with the persistent variant over a mesh: "
                    "the JAX package diverges here (on the TPU its chunk kernel has no wire "
                    "form and narrows nothing; on the CPU its once-a-chunk deep exchange "
                    "narrows), so the port matches neither (ROADMAP.md queue C, \"Design "
                    "divergences\")")
        if (self.fused or self.persistent) and self.oversubscribed:
            variant = "fused compute+exchange" if self.fused else "persistent whole-chunk"
            raise ValueError(
                f"the {variant} variant supports single-resident partitions "
                f"only (got resident {self.resident}); use plain REMOTE_DMA "
                "or AXIS_COMPOSED for oversubscription")
        if self.persistent and not spec.is_uniform():
            raise NotImplementedError(
                f"uneven partition {spec.dim} of {spec.global_size}: the persistent chunk "
                "kernel is uniform-only, as on the TPU; the JAX package's XLA chunk body is "
                "ROADMAP.md queue A item 2.6")
        if method == Method.REMOTE_DMA and self.oversubscribed:
            raise NotImplementedError(
                f"REMOTE_DMA on resident blocks (partition {spec.dim} on one device) is "
                "item 3 of ROADMAP.md's list of what the resident path still lacks; "
                "use AXIS_COMPOSED")
        for axis in AXIS_ORDER:
            _o, _n, rm, rp = axis_geom(spec, axis)
            n = min(axis_sizes(spec, axis))
            if n < max(rm, rp):
                raise ValueError(
                    f"{axis}-axis block size {n} < radius {max(rm, rp)}: "
                    "halo would span multiple blocks")
        self.spec = spec
        self.method = method
        self.plan = build_plan(spec, mesh_dim, method, resident=self.resident,
                               wire_dtype=self.wire_dtype, fused=self.fused,
                               persistent=self.persistent)
        # device-program launches per k-step chunk of the last persistent
        # loop call, counted as the JAX package counts them (ops/jacobi.py)
        self.last_launches_per_chunk = 0
        self._loops = {}
        self._remote = None
        if self.mesh is not None:
            # the fused exchange carrier (B7) is uniform-only, as on the TPU
            fused_carrier = self.fused and kernel_supported(spec, self.resident)
            self._remote = (FusedRemoteDmaExchange if fused_carrier else RemoteDmaExchange)(self)

    @staticmethod
    def _check_mesh(spec: GridSpec, method: Method, mesh: DeviceMesh) -> Dim3:
        """A mesh of several positions: REMOTE_DMA, one block per position,
        every position on one device. Returns the mesh shape."""
        if method != Method.REMOTE_DMA:
            raise NotImplementedError(
                f"{method} on a mesh of {len(mesh)} positions: the port exchanges a mesh by "
                "REMOTE_DMA only (collectives between GPUs are ROADMAP.md queue A item 5)")
        if spec.num_blocks() > len(mesh):
            raise NotImplementedError(
                f"partition {spec.dim} ({spec.num_blocks()} blocks) on {len(mesh)} positions: "
                "REMOTE_DMA takes one block per position, as the JAX carrier does; "
                "oversubscribed REMOTE_DMA is ROADMAP.md queue A item 2")
        if spec.dim != mesh.dim:
            raise ValueError(f"mesh {mesh.dim} does not match partition {spec.dim}")
        mesh.device  # raises for positions on distinct devices
        return mesh.dim

    @property
    def on_mesh(self) -> bool:
        """Blocks on a mesh of several positions (per-position state)."""
        return self.mesh is not None

    @property
    def last_transfer_count(self) -> int:
        """Slabs or messages sent to another position by the last mesh
        exchange (0 on one position)."""
        return self._remote.last_transfer_count if self._remote is not None else 0

    @property
    def oversubscribed(self) -> bool:
        """More than one block of the partition on the device."""
        return self.resident != Dim3(1, 1, 1)

    def __call__(self, state):
        """Fill every halo of every quantity in ``state``, a quantity dict
        or one tensor (in place; returns it)."""
        return self.exchange(state)

    def exchange(self, state, axes=None):
        """The composed phases x -> y -> z, or the subset ``axes`` of axis
        names (the deep-halo jacobi loop exchanges only its multi-block
        axes; the kernels wrap the others), over ``state``, a quantity dict
        or one tensor. In place; returns ``state``."""
        if isinstance(state, (torch.Tensor, list, tuple)):
            self.exchange({0: state}, axes)
            return state
        if self.mesh is not None:
            if isinstance(self._remote, FusedRemoteDmaExchange):
                if axes is not None:
                    raise ValueError("the fused exchange moves every direction at once")
                return self._remote(state)
            return self._remote(state, axes)
        groups = dtype_groups(state)
        for phase in self.plan.axis_phases:
            if not phase.active or (axes is not None and phase.axis not in axes):
                continue
            for _dt, keys in groups:
                if phase.resident > 1:
                    for k in keys:
                        self._resident_phase(state[k], phase)
                else:
                    self._self_wrap_phase([state[k] for k in keys], phase.axis)
        return state

    def _self_wrap_phase(self, ts, axis: str) -> None:
        """One self-wrap axis over every resident of the same-dtype
        quantities ``ts``, through the fill kernel: x and y over each
        quantity's residents as one z-stack, z over each resident as a
        block of its own; at most MAX_FILL_GROUP tensors per launch."""
        nres = self.spec.num_blocks()
        blocks, z_stack = ts, nres
        if axis == "z" and nres > 1:
            p = self.spec.padded()
            blocks = [b for t in ts for b in t.view(-1, p.z, p.y, p.x).unbind(0)]
            z_stack = 1
        for i in range(0, len(blocks), MAX_FILL_GROUP):
            self_fill(blocks[i:i + MAX_FILL_GROUP], self.spec, axis, z_stack=z_stack)

    def _resident_phase(self, t: torch.Tensor, phase) -> None:
        """One axis phase over the resident blocks of one quantity: the lo
        halos take the hi boundary slabs rolled one block up the block dim,
        the hi halos the lo slabs rolled one block down (cyclic). On an
        uneven axis, block by block at each block's own size."""
        o, n, rm, rp = axis_geom(self.spec, phase.axis)
        if not phase.uniform:
            self._uneven_resident_phase(t, phase)
            return
        if rm:
            t[_axis_slice(t, phase.axis, o - rm, o)] = torch.roll(
                t[_axis_slice(t, phase.axis, o + n - rm, o + n)], 1, phase.bdim)
        if rp:
            t[_axis_slice(t, phase.axis, o + n, o + n + rp)] = torch.roll(
                t[_axis_slice(t, phase.axis, o, o + rp)], -1, phase.bdim)

    def _uneven_resident_phase(self, t: torch.Tensor, phase) -> None:
        """:meth:`_resident_phase` on an uneven axis (the JAX package's
        ``_axis_phase_resident_batched`` at ``_resident_sizes``): block
        ``j``'s hi slab ``[o + n_j - rm, o + n_j)`` -> block ``j + 1``'s lo
        halo ``[o - rm, o)``; block ``j``'s lo slab ``[o, o + rp)`` -> block
        ``j - 1``'s hi halo ``[o + n_{j-1}, o + n_{j-1} + rp)``, cyclically.
        Every read is of compute cells and every write of halo cells, so
        the copies need no staging."""
        o, _n, rm, rp = axis_geom(self.spec, phase.axis)
        sizes = phase.sizes
        c = len(sizes)
        blocks = t.unbind(phase.bdim)
        for j, src in enumerate(blocks):
            n = sizes[j]
            if rm:
                dst = blocks[(j + 1) % c]
                dst[_axis_slice(dst, phase.axis, o - rm, o)] = \
                    src[_axis_slice(src, phase.axis, o + n - rm, o + n)]
            if rp:
                dst, nb = blocks[(j - 1) % c], sizes[(j - 1) % c]
                dst[_axis_slice(dst, phase.axis, o + nb, o + nb + rp)] = \
                    src[_axis_slice(src, phase.axis, o, o + rp)]

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


def shard_blocks(global_zyx, spec: GridSpec, device) -> Union[torch.Tensor, List[torch.Tensor]]:
    """Scatter a global [z,y,x] array (numpy, or a tensor) into the stacked
    padded layout ``(bz, by, bx, pz, py, px)`` on ``device``, keeping its
    dtype; halo and pad cells are 0. With a ``DeviceMesh`` for ``device``,
    the blocks of a mesh: one ``(1, 1, 1, pz, py, px)`` block per position,
    on that position's device (the JAX package's
    ``shard_blocks(global, spec, mesh)``)."""
    g = spec.global_size
    mesh = device if isinstance(device, DeviceMesh) else None
    src = torch.as_tensor(global_zyx, device=None if mesh else device)
    if tuple(src.shape) != (g.z, g.y, g.x):
        raise ValueError(
            f"global array shape {tuple(src.shape)} != grid ({g.z}, {g.y}, {g.x})")
    if mesh is not None:
        _check_positions(spec, mesh)
        p = spec.padded()
        blocks = []
        for pos, dev in zip(mesh.positions(), mesh.devices):
            b = torch.zeros((1, 1, 1, p.z, p.y, p.x), dtype=src.dtype, device=dev)
            b[0, 0, 0][_compute(spec, pos)] = src[_global(spec, pos)].to(dev)
            blocks.append(b)
        return blocks
    stacked = torch.zeros(spec.stacked_shape_zyx(), dtype=src.dtype, device=device)
    for iz in range(spec.dim.z):
        for iy in range(spec.dim.y):
            for ix in range(spec.dim.x):
                stacked[iz, iy, ix][_compute(spec, (ix, iy, iz))] = \
                    src[_global(spec, (ix, iy, iz))]
    return stacked


def unshard_blocks(stacked, spec: GridSpec) -> np.ndarray:
    """Gather the compute regions of a stacked tensor, or of a mesh's list
    of per-position blocks, into a global [z,y,x] host array (halos
    dropped)."""
    g = spec.global_size
    arr = join_positions(stacked, spec) if isinstance(stacked, (list, tuple)) else stacked
    arr = arr.detach().cpu().numpy()
    out = np.empty((g.z, g.y, g.x), dtype=arr.dtype)
    for iz in range(spec.dim.z):
        for iy in range(spec.dim.y):
            for ix in range(spec.dim.x):
                out[_global(spec, (ix, iy, iz))] = arr[iz, iy, ix][_compute(spec, (ix, iy, iz))]
    return out


def _compute(spec: GridSpec, pos):
    """Block-local (z, y, x) slices of block ``pos``'s compute region."""
    off, s = spec.compute_offset(), spec.block_size(pos)
    return (slice(off.z, off.z + s.z), slice(off.y, off.y + s.y), slice(off.x, off.x + s.x))


def _global(spec: GridSpec, pos):
    """Global (z, y, x) slices of block ``pos``."""
    o, s = spec.block_origin(pos), spec.block_size(pos)
    return (slice(o.z, o.z + s.z), slice(o.y, o.y + s.y), slice(o.x, o.x + s.x))


def _check_positions(spec: GridSpec, mesh: DeviceMesh) -> None:
    if spec.dim != mesh.dim:
        raise ValueError(f"mesh {mesh.dim} does not match partition {spec.dim}")


def split_positions(stacked: torch.Tensor, spec: GridSpec, mesh: DeviceMesh) -> List[torch.Tensor]:
    """A stacked ``(bz, by, bx, pz, py, px)`` tensor as a mesh's blocks: a
    copy of each block, on its position's device, in flat order."""
    _check_positions(spec, mesh)
    if tuple(stacked.shape) != spec.stacked_shape_zyx():
        raise ValueError(f"shape {tuple(stacked.shape)} != {spec.stacked_shape_zyx()}")
    p = spec.padded()
    flat = stacked.reshape(-1, 1, 1, 1, p.z, p.y, p.x)
    return [flat[i].to(dev, copy=True) for i, dev in enumerate(mesh.devices)]


def join_positions(blocks: Sequence[torch.Tensor], spec: GridSpec) -> torch.Tensor:
    """A mesh's per-position blocks as one stacked ``(bz, by, bx, pz, py,
    px)`` tensor (a copy, on the first block's device)."""
    dev = blocks[0].device
    return torch.cat([b.reshape(1, *b.shape[-3:]).to(dev) for b in blocks]).view(
        spec.stacked_shape_zyx())
