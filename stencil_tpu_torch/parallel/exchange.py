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

``Method.DIRECT26`` is the reference's literal 26 messages (the JAX
package's ``_direct26_batched`` and ``_direct26_batched_uneven``): per
active direction of the plan's ``direct_phases``, every resident's
exact-extent box of compute cells goes to the resident one block further
along that direction (cyclically; ``torch.roll`` of the gathered boxes over
the block dims, the JAX package's ``_roll_blocks`` on one device). On an
uneven partition the boxes keep the base block size on the direction's
zero axes (each block's box starts at its own hi side on a nonzero axis),
the messages run face -> edge -> corner, and a padded write that spills
into a band of a later direction is overwritten there, as in the JAX
package, dead pad included. Copies and rolls are the port's counterpart of
the XLA data movement the JAX package compiles this method to; it has no
Pallas kernel.

``Method.REMOTE_DMA`` moves the same composed slabs by copies a kernel
issues; on one block every phase wraps onto the block itself, so its
exchange is the same three fills (the JAX package takes its composed body
there too). On resident blocks every block is an endpoint of the axis
carrier (``ops/remote_dma.RemoteDmaExchange``: a view into its stack), so
a ring phase over the blocks is one launch of B6 per dtype group, and an
axis with one block a self-wrap fill; the plan keeps the REMOTE_DMA
accounting of the (1,1,1) mesh. Its ``fused`` and ``persistent`` kernel
variants change the step loops (``ops/jacobi.py``), which then exchange
inside their own kernels; they take one block per position, as in the JAX
package.

``batch_quantities`` (``DistributedDomain.set_quantity_batching``) picks the
carrier of a same-dtype group: on (the default), the direct26 messages and
the resident phases move the group's boxes as one packed carrier per
message or side, and the fills take up to ``MAX_FILL_GROUP`` blocks a
launch; off, every quantity moves on its own. The cells are the same either
way.

State layout, as in the JAX package: each quantity is one tensor of shape
``(bz, by, bx, pz, py, px)``. Unlike the JAX version, the exchange updates
the tensors in place (it still returns the state dict).

Over a mesh of several block positions (``mesh=``, a
``parallel.mesh.DeviceMesh``) each quantity is a list of ``(cz, cy, cx, pz,
py, px)`` stacks, one per position in the mesh's flat order, each its own
allocation: one block a position (``(1, 1, 1, ...)``), or the resident
blocks of an oversubscribed mesh (partition / mesh shape, position
``(ix, iy, iz)`` holding blocks ``ix * cx ...``), every block then an
endpoint of the axis carrier. The exchange is REMOTE_DMA: the
axis carrier (``ops/remote_dma.RemoteDmaExchange``; also with
``persistent``, at the deep radius) or, with ``fused``, the fused exchange
carrier (``ops/fused_stencil.FusedRemoteDmaExchange``). The fused and
persistent jacobi loops then step through their kernels' wire-crossing
forms, one launch over every position (``ops/jacobi.py``). On an uneven
partition the axis carrier takes the uneven ring (B6's size table); the
fused exchange carrier and the fused step take uniform partitions only, as
on the TPU, so ``fused`` exchanges through the axis carrier and steps by
the JAX package's host-orchestrated schedule, and ``persistent`` runs the
deep exchange through the axis carrier once a chunk, then the chunk
kernel's uneven form (messages off, each position at its own extent).
The mesh's positions must share one device (the reference's
``set_gpus({0,0})``); positions on distinct GPUs (peer access and event
waits between phases) and NCCL across hosts are ROADMAP.md queue A item 5.

``wire_dtype`` (the JAX package's bf16-on-the-wire compression, its fp8
tier and every other floating format it narrows through,
``ops/halo_fill.WIRE_FORMATS``) narrows what crosses between positions of
a mesh: the carriers and the fused step round each crossing floating word
through the wire (``ops/halo_fill.wire_format`` is the policy). On an
oversubscribed mesh only the slabs between positions round; the shifts
between the residents of one position stay lossless, as in the JAX
package. On one device nothing crosses, so a single block or a resident
partition takes it as a no-op, as the JAX package does on a one-device
mesh.
"""

from __future__ import annotations

import enum
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..domain.grid import GridSpec
from ..geometry import DIRECTIONS_26, Dim3, halo_extent
from ..ops.fused_stencil import FusedRemoteDmaExchange, box_slices, kernel_supported
from ..ops.halo_fill import (AXIS_ORDER, MAX_FILL_GROUP, _axis_slice, axis_geom, axis_sizes,
                             dtype_groups, pack_slabs, self_fill, unpack_slabs, wire_name)
from ..ops.remote_dma import RemoteDmaExchange
from ..plan.ir import build_plan
from .mesh import DeviceMesh


class Method(enum.Enum):
    """Exchange strategy, named as in the JAX package; the port has the
    axis-composed, direct26 and remote-dma exchanges (auto-spmd, the SPMD
    partitioner's, is ROADMAP.md queue A item 5)."""

    AXIS_COMPOSED = "axis-composed"
    DIRECT26 = "direct26"
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
    axis-composed or direct26 over any partition, uniform or uneven, or
    remote-dma (with its ``fused`` or ``persistent`` kernel variant on one
    block, plain on resident blocks); or, with ``mesh`` of several
    positions, remote-dma over the mesh (the axis carrier, or the fused
    exchange carrier with ``fused`` on a uniform partition), with either
    kernel variant on one block a position, and plain on more blocks than
    positions. ``wire_dtype`` narrows the carriers crossing between
    positions (a no-op on one device); the persistent variant over a mesh
    refuses it. ``batch_quantities`` picks one
    carrier per same-dtype group (default) or one per quantity."""

    def __init__(self, spec: GridSpec, method: Method = Method.AXIS_COMPOSED,
                 fused: bool = False, persistent: bool = False,
                 mesh: Optional[DeviceMesh] = None, wire_dtype=None,
                 batch_quantities: bool = True):
        if not isinstance(method, Method):
            raise NotImplementedError(
                f"{method}: the port has the axis-composed, direct26 and remote-dma exchanges")
        self.wire_dtype = wire_name(wire_dtype)
        self.batch_quantities = bool(batch_quantities)
        self.mesh = mesh if mesh is not None and len(mesh) > 1 else None
        if self.mesh is None:
            # one device holds every block: the mesh is (1,1,1)
            mesh_dim = Dim3(1, 1, 1)
            self.resident = spec.dim
        else:
            mesh_dim = self._check_mesh(spec, method, self.mesh)
            self.resident = position_resident(spec, self.mesh)
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
        for axis in AXIS_ORDER:
            _o, _n, rm, rp = axis_geom(spec, axis)
            n = min(axis_sizes(spec, axis))
            if n < max(rm, rp):
                raise ValueError(
                    f"{axis}-axis block size {n} < radius {max(rm, rp)}: "
                    "halo would span multiple blocks")
        self.spec = spec
        self.method = method
        self.plan = build_plan(spec, mesh_dim, method, batch_quantities=self.batch_quantities,
                               resident=self.resident, wire_dtype=self.wire_dtype,
                               fused=self.fused, persistent=self.persistent)
        # device-program launches per k-step chunk of the last persistent
        # loop call, counted as the JAX package counts them (ops/jacobi.py)
        self.last_launches_per_chunk = 0
        self._loops = {}
        self._remote = None
        if self.mesh is not None:
            # the fused exchange carrier (B7) is uniform-only, as on the TPU
            fused_carrier = self.fused and kernel_supported(spec, self.resident)
            self._remote = (FusedRemoteDmaExchange if fused_carrier else RemoteDmaExchange)(self)
        elif method == Method.REMOTE_DMA and self.oversubscribed:
            # every resident block an endpoint of the axis carrier (B6)
            self._remote = RemoteDmaExchange(self)

    @staticmethod
    def _check_mesh(spec: GridSpec, method: Method, mesh: DeviceMesh) -> Dim3:
        """A mesh of several positions: REMOTE_DMA, the partition a multiple
        of the mesh on every axis, every position on one device. Returns the
        mesh shape."""
        if method != Method.REMOTE_DMA:
            raise NotImplementedError(
                f"{method} on a mesh of {len(mesh)} positions: the port exchanges a mesh by "
                "REMOTE_DMA only (collectives between GPUs are ROADMAP.md queue A item 5)")
        position_resident(spec, mesh)
        mesh.device  # raises for positions on distinct devices
        return mesh.dim

    @property
    def on_mesh(self) -> bool:
        """Blocks on a mesh of several positions (per-position state)."""
        return self.mesh is not None

    @property
    def last_transfer_count(self) -> int:
        """Slabs or messages sent to another position by the last mesh
        exchange (0 on one device)."""
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
        if self._remote is not None:
            if isinstance(self._remote, FusedRemoteDmaExchange):
                if axes is not None:
                    raise ValueError("the fused exchange moves every direction at once")
                return self._remote(state)
            return self._remote(state, axes)
        if self.method == Method.DIRECT26:
            if axes is not None:
                raise ValueError("axis subsetting requires AXIS_COMPOSED")
            for ts in self._carriers(state):
                self._direct26(ts)
            return state
        for phase in self.plan.axis_phases:
            if not phase.active or (axes is not None and phase.axis not in axes):
                continue
            for ts in self._carriers(state):
                if phase.resident > 1:
                    self._resident_phase(ts, phase)
                else:
                    self._self_wrap_phase(ts, phase.axis)
        return state

    def _carriers(self, state) -> List[List[torch.Tensor]]:
        """The tensors that move as one carrier: each same-dtype group of
        ``state``, or each quantity alone when quantity batching is off."""
        groups = [[state[k] for k in keys] for _dt, keys in dtype_groups(state)]
        return groups if self.batch_quantities else [[t] for g in groups for t in g]

    def _direct26(self, ts: List[torch.Tensor]) -> None:
        """The 26 messages over the resident stacks ``ts`` (one same-dtype
        carrier): per direction of the plan, each block's box gathered into
        one carrier, rolled one block along the direction over the block
        dims (cyclic), and written into the receivers' halo boxes. On a
        uniform partition every box is the same rect, so a message is one
        slice per quantity; on an uneven one each block's box starts at its
        own hi side along the direction's nonzero axes."""
        uniform = self.spec.is_uniform()
        for ph in self.plan.direct_phases:
            d = ph.direction
            dims = [i for i, c in enumerate((d[2], d[1], d[0])) if c]
            shifts = [(d[2], d[1], d[0])[i] for i in dims]
            if uniform:
                src, dst = box_slices(ph.src, ph.dst, ph.shape)
                carrier = pack_slabs([t[src] for t in ts])
            else:
                boxes = self._uneven_boxes(ph)
                carrier = pack_slabs([torch.stack([
                    t[j][s] for j, (s, _d) in zip(np.ndindex(*t.shape[:3]), boxes)
                ]).view(*t.shape[:3], *ph.shape) for t in ts])
            boff = 1 if len(ts) > 1 else 0
            carrier = torch.roll(carrier, shifts, [boff + i for i in dims])
            for t, piece in zip(ts, unpack_slabs(carrier, len(ts))):
                if uniform:
                    t[dst] = piece
                else:
                    for j, (_s, dbox) in zip(np.ndindex(*t.shape[:3]), boxes):
                        t[j][dbox] = piece[j]

    def _uneven_boxes(self, ph):
        """``[(src, dst)]`` slices of each block's box of direct26 message
        ``ph`` on an uneven partition, in stacked (z, y, x) block order:
        ``ph.shape`` from the block's hi side (``o + n - rm`` / ``o + n``)
        along a +/- component, from the compute origin elsewhere."""
        spec, r, off = self.spec, self.spec.radius, self.spec.compute_offset()
        d = Dim3.of(ph.direction)
        out = []
        for iz, iy, ix in np.ndindex(spec.dim.z, spec.dim.y, spec.dim.x):
            size = spec.block_size((ix, iy, iz))
            src, dst = [], []
            for dc, o, n, rm in zip((d.z, d.y, d.x), (off.z, off.y, off.x),
                                    (size.z, size.y, size.x), (r.z(-1), r.y(-1), r.x(-1))):
                src.append(o + n - rm if dc == 1 else o)
                dst.append(o - rm if dc == 1 else o + n if dc == -1 else o)
            out.append(box_slices(src, dst, ph.shape))
        return out

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

    def _resident_phase(self, ts: List[torch.Tensor], phase) -> None:
        """One axis phase over the resident blocks of the carrier ``ts``:
        the lo halos take the hi boundary slabs rolled one block up the
        block dim, the hi halos the lo slabs rolled one block down (cyclic),
        the group's slabs packed into one carrier a side. On an uneven axis,
        block by block at each block's own size."""
        o, n, rm, rp = axis_geom(self.spec, phase.axis)
        if not phase.uniform:
            for t in ts:
                self._uneven_resident_phase(t, phase)
            return
        boff = 1 if len(ts) > 1 else 0
        for width, lo, hi, shift in ((rm, o + n - rm, o - rm, 1), (rp, o, o + n, -1)):
            if not width:
                continue
            carrier = torch.roll(pack_slabs([t[_axis_slice(t, phase.axis, lo, lo + width)]
                                             for t in ts]), shift, boff + phase.bdim)
            for t, piece in zip(ts, unpack_slabs(carrier, len(ts))):
                t[_axis_slice(t, phase.axis, hi, hi + width)] = piece

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
        padded extents (>= bytes_logical); for direct26 the logical bytes on
        a uniform partition, and on an uneven one the messages' extents
        padded to the base block size on their zero axes."""
        p = self.spec.padded()
        r = self.spec.radius
        if self.method == Method.DIRECT26:
            if self.spec.is_uniform():
                return self.bytes_logical(itemsizes)
            b = self.spec.base
            total = 0
            for d in DIRECTIONS_26:
                if r.dir(-d) == 0:
                    continue
                ext = 1
                for dc, rm, rp, n in ((d.z, r.z(-1), r.z(1), b.z), (d.y, r.y(-1), r.y(1), b.y),
                                      (d.x, r.x(-1), r.x(1), b.x)):
                    ext *= rm if dc == 1 else rp if dc == -1 else n
                total += ext
            return total * sum(itemsizes) * self.spec.num_blocks()
        per_item = (r.x(-1) + r.x(1)) * p.y * p.z
        per_item += (r.y(-1) + r.y(1)) * p.x * p.z
        per_item += (r.z(-1) + r.z(1)) * p.x * p.y
        return per_item * sum(itemsizes) * self.spec.num_blocks()


def position_resident(spec: GridSpec, mesh: DeviceMesh) -> Dim3:
    """Blocks a position of ``mesh`` holds along x, y and z (the partition
    over the mesh shape, which must divide it)."""
    d, m = spec.dim, mesh.dim
    if d.x % m.x or d.y % m.y or d.z % m.z:
        raise ValueError(f"mesh {m} does not divide partition {d}")
    return Dim3(d.x // m.x, d.y // m.y, d.z // m.z)


def position_blocks(spec: GridSpec, mesh: DeviceMesh):
    """``[(position index, (jz, jy, jx))]`` of every block of the partition
    in the stacked (z, y, x) block order: the position that holds it and its
    place in that position's stack."""
    c = position_resident(spec, mesh)
    return [(mesh.index((ix // c.x, iy // c.y, iz // c.z)), (iz % c.z, iy % c.y, ix % c.x))
            for iz, iy, ix in np.ndindex(spec.dim.z, spec.dim.y, spec.dim.x)]


def shard_blocks(global_zyx, spec: GridSpec, device) -> Union[torch.Tensor, List[torch.Tensor]]:
    """Scatter a global [z,y,x] array (numpy, or a tensor) into the stacked
    padded layout ``(bz, by, bx, pz, py, px)`` on ``device``, keeping its
    dtype; halo and pad cells are 0. With a ``DeviceMesh`` for ``device``,
    the stacks of a mesh: one ``(cz, cy, cx, pz, py, px)`` stack of its
    resident blocks per position (one block when the mesh matches the
    partition), on that position's device (the JAX package's
    ``shard_blocks(global, spec, mesh)``)."""
    g = spec.global_size
    mesh = device if isinstance(device, DeviceMesh) else None
    src = torch.as_tensor(global_zyx, device=None if mesh else device)
    if tuple(src.shape) != (g.z, g.y, g.x):
        raise ValueError(
            f"global array shape {tuple(src.shape)} != grid ({g.z}, {g.y}, {g.x})")
    if mesh is not None and position_resident(spec, mesh) == Dim3(1, 1, 1):
        p = spec.padded()
        blocks = []
        for pos, dev in zip(mesh.positions(), mesh.devices):
            b = torch.zeros((1, 1, 1, p.z, p.y, p.x), dtype=src.dtype, device=dev)
            b[0, 0, 0][_compute(spec, pos)] = src[_global(spec, pos)].to(dev)
            blocks.append(b)
        return blocks
    stacked = torch.zeros(spec.stacked_shape_zyx(), dtype=src.dtype,
                          device=src.device if mesh else device)
    for iz in range(spec.dim.z):
        for iy in range(spec.dim.y):
            for ix in range(spec.dim.x):
                stacked[iz, iy, ix][_compute(spec, (ix, iy, iz))] = \
                    src[_global(spec, (ix, iy, iz))]
    return split_positions(stacked, spec, mesh) if mesh is not None else stacked


def unshard_blocks(stacked, spec: GridSpec) -> np.ndarray:
    """Gather the compute regions of a stacked tensor, or of a mesh's list
    of per-position stacks, into a global [z,y,x] host array (halos
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


def _stack_slices(spec: GridSpec, mesh: DeviceMesh, pos):
    """Slices of the stacked block dims (z, y, x) that position ``pos``
    holds."""
    c = position_resident(spec, mesh)
    return tuple(slice(i * n, (i + 1) * n) for i, n in zip(pos[::-1], (c.z, c.y, c.x)))


def split_positions(stacked: torch.Tensor, spec: GridSpec, mesh: DeviceMesh) -> List[torch.Tensor]:
    """A stacked ``(bz, by, bx, pz, py, px)`` tensor as a mesh's stacks: a
    copy of each position's ``(cz, cy, cx, pz, py, px)`` resident blocks, on
    its position's device, in flat order."""
    if tuple(stacked.shape) != spec.stacked_shape_zyx():
        raise ValueError(f"shape {tuple(stacked.shape)} != {spec.stacked_shape_zyx()}")
    return [stacked[_stack_slices(spec, mesh, pos)].to(dev, copy=True).contiguous()
            for pos, dev in zip(mesh.positions(), mesh.devices)]


def join_positions(blocks: Sequence[torch.Tensor], spec: GridSpec) -> torch.Tensor:
    """A mesh's per-position stacks as one stacked ``(bz, by, bx, pz, py,
    px)`` tensor (a copy, on the first stack's device); the mesh shape is
    the partition over each stack's block dims."""
    dev = blocks[0].device
    c = Dim3(blocks[0].shape[2], blocks[0].shape[1], blocks[0].shape[0])
    d = spec.dim
    mesh = DeviceMesh(Dim3(d.x // c.x, d.y // c.y, d.z // c.z), ["cpu"] * len(blocks))
    out = torch.empty(spec.stacked_shape_zyx(), dtype=blocks[0].dtype, device=dev)
    for pos, b in zip(mesh.positions(), blocks):
        out[_stack_slices(spec, mesh, pos)] = b.to(dev)
    return out
