"""ExchangePlan IR — the declarative geometry of a halo exchange.

The port's own copy of the part of ``stencil_tpu.plan.ir`` that the
axis-composed, direct26 and remote-dma exchanges lower from: the composed
axis phases (:class:`AxisPhaseIR`), the direct26 per-direction messages
(:class:`DirectPhaseIR`: exact extents on a uniform partition; on an uneven
one the orthogonal extents padded to the base block size and the messages
in face -> edge -> corner order), the axis phases' kernel-initiated twins
(:class:`RemoteDmaPhaseIR`), the fused variant's exact-extent per-direction
messages (:class:`FusedPhaseIR`) and :func:`build_plan`. It is pure
geometry — no torch, no devices — and builds plans for any partition, so
tests hold it field by field against the JAX package's.

On one block every direction wraps onto the block itself: the fused and
persistent kernels (``ops/fused_stencil.py``, ``ops/persistent_stencil.py``)
turn the fused phases into in-place hand-offs from compute cells to halo
cells.

The wire model is carried over: a plan's ``wire_dtype`` (the narrowed wire
of the remote-dma carriers, ``ops/halo_fill.wire_format``) prices
wire-crossing cells at the narrowed itemsize in :meth:`ExchangePlan.wire_bytes`.

The planner's vocabulary is ported too: :class:`PlanConfig` (the problem
key the plan DB and the campaign's compile cache key with) and
:class:`PlanChoice` (one point of the search space: partition, method,
batching, temporal depth, kernel variant), whose JSON form is the JAX
package's, so a plan DB or checkpoint manifest of either package loads in
the other. Not carried over yet: the auto-spmd geometry and the hierarchical
(DCN) level (ROADMAP.md queue A item 5), which raise
``NotImplementedError``; a choice that carries a hierarchy or a
non-identity placement parses and round-trips, and raises where a domain
would realize it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

from ..geometry import DIRECTIONS_26, Dim3, Radius

# Method value strings (mirrors parallel.exchange.Method).
AXIS_COMPOSED = "axis-composed"
DIRECT26 = "direct26"
AUTO_SPMD = "auto-spmd"
REMOTE_DMA = "remote-dma"
METHODS = (AXIS_COMPOSED, DIRECT26, AUTO_SPMD, REMOTE_DMA)

# Kernel variants of REMOTE_DMA: one kernel per step that hands off every
# direction's exact-extent message and sweeps ("fused"), and one kernel per
# k-step chunk over radius*k halos ("persistent"; at k == 1 it is the fused
# kernel, so it needs k >= 2).
FUSED_VARIANT = "fused"
PERSISTENT_VARIANT = "persistent"

# (axis name, stacked-array data dim, block dim) in exchange-phase order.
AXIS_ORDER = (("x", 5, 2), ("y", 4, 1), ("z", 3, 0))

# blocks one launch of the fill kernel takes (ops/halo_fill.MAX_FILL_GROUP)
FILL_GROUP = 16

# where the geometries still to port stand in ROADMAP.md
_LATER = {AUTO_SPMD: "ROADMAP.md queue A item 5", "hierarchy": "ROADMAP.md queue A item 5"}

def wire_itemsize(wire_dtype: Optional[str]) -> Optional[int]:
    """Bytes per cell a wire-compressed carrier pays (None = native): a
    wire format's own (``ops/halo_fill.WIRE_FORMATS``; each fp8 and fp4
    format one byte, as numpy says with ``ml_dtypes``), else numpy's
    itemsize of the name. The fp8 tier quarters fp32's wire bytes as
    bfloat16 halves them."""
    from ..ops.halo_fill import WIRE_FORMATS

    if wire_dtype is None:
        return None
    if wire_dtype in WIRE_FORMATS:
        return WIRE_FORMATS[wire_dtype].itemsize
    import numpy as np

    return np.dtype(wire_dtype).itemsize


@dataclass(frozen=True)
class AxisPhaseIR:
    """One composed axis phase: ``sizes`` is the per-axis block-size table
    (length ``ring * resident``), ``ring`` the devices along the mesh axis,
    ``resident`` the blocks stacked per device; ``fwd``/``bwd`` the
    neighbour pairs toward +axis/-axis."""

    axis: str
    adim: int
    bdim: int
    ring: int
    resident: int
    rm: int
    rp: int
    offset: int
    sizes: Tuple[int, ...]
    fwd: Tuple[Tuple[int, int], ...]
    bwd: Tuple[Tuple[int, int], ...]
    wire_cells: int         # cells sent between devices per exchange per quantity
    local_cells: int        # cells moved inside a device (self-wrap / resident shifts)

    @property
    def blocks(self) -> int:
        return self.ring * self.resident

    @property
    def uniform(self) -> bool:
        return len(set(self.sizes)) == 1

    @property
    def active(self) -> bool:
        return self.rm > 0 or self.rp > 0

    def collectives(self) -> int:
        if self.ring <= 1 or not self.active:
            return 0
        return (1 if self.rm > 0 else 0) + (1 if self.rp > 0 else 0)


@dataclass(frozen=True)
class DirectPhaseIR:
    """One DIRECT26 direction message: ``shape`` (z, y, x) is the radius
    along the direction's nonzero axes and the base block size on the
    others; ``src``/``dst`` are block-local starts on a uniform partition
    (None on an uneven one, where they depend on each block's size).
    ``pairs`` is the flattened 26-neighbour permutation when every block
    has its own position; with residents the move composes per-axis block
    shifts, one collective per nonzero component whose axis has several
    positions (``collective_count``)."""

    direction: Tuple[int, int, int]       # (dx, dy, dz)
    shape: Tuple[int, int, int]           # carrier extent (z, y, x)
    src: Optional[Tuple[int, int, int]]
    dst: Optional[Tuple[int, int, int]]
    pairs: Tuple[Tuple[int, int], ...]
    collective_count: int
    wire_cells: int
    local_cells: int

    def collectives(self) -> int:
        return self.collective_count


@dataclass(frozen=True)
class RemoteDmaPhaseIR:
    """One kernel-initiated axis phase of a REMOTE_DMA plan: the composed
    phase's slab geometry, moved by copies a kernel issues rather than by
    collectives (so :meth:`collectives` is 0; :meth:`dmas` counts the
    copies toward other devices)."""

    axis: str
    adim: int
    bdim: int
    ring: int
    resident: int
    rm: int
    rp: int
    offset: int
    sizes: Tuple[int, ...]
    fwd: Tuple[Tuple[int, int], ...]
    bwd: Tuple[Tuple[int, int], ...]
    wire_cells: int
    local_cells: int

    @property
    def blocks(self) -> int:
        return self.ring * self.resident

    @property
    def uniform(self) -> bool:
        return len(set(self.sizes)) == 1

    @property
    def active(self) -> bool:
        return self.rm > 0 or self.rp > 0

    def collectives(self) -> int:
        return 0

    def dmas(self) -> int:
        if self.ring <= 1 or not self.active:
            return 0
        return (1 if self.rm > 0 else 0) + (1 if self.rp > 0 else 0)


@dataclass(frozen=True)
class FusedPhaseIR:
    """One exact-extent per-direction message of a fused substep: it reads
    only the sender's compute cells, so no message depends on another.
    ``shape`` (z, y, x) is the radius along the direction's nonzero axes and
    the block size on the others; ``src``/``dst`` are block-local starts
    (uniform partitions only). A message ``crossing`` to another device
    costs one copy; a self-wrap one is a local hand-off."""

    direction: Tuple[int, int, int]       # (dx, dy, dz)
    shape: Tuple[int, int, int]           # (z, y, x)
    src: Optional[Tuple[int, int, int]]
    dst: Optional[Tuple[int, int, int]]
    crossing: bool
    wire_cells: int
    local_cells: int

    def collectives(self) -> int:
        return 0

    def dmas(self) -> int:
        return 1 if self.crossing else 0


@dataclass(frozen=True)
class ExchangePlan:
    """The exchange program of one (spec, mesh, method): phases, the carrier
    policy (``pack_groups`` "dtype" packs every same-dtype quantity into one
    carrier, "quantity" sends one per quantity) and the kernel variant."""

    method: str
    pack_groups: str
    partition: Tuple[int, int, int]
    mesh_dim: Tuple[int, int, int]
    resident: Tuple[int, int, int]
    axis_phases: Tuple[AxisPhaseIR, ...]
    direct_phases: Tuple[DirectPhaseIR, ...] = ()
    remote_phases: Tuple[RemoteDmaPhaseIR, ...] = ()
    fused_phases: Tuple[FusedPhaseIR, ...] = ()
    fused: bool = False
    persistent: bool = False
    # the narrowed wire of crossing carriers (None: native)
    wire_dtype: Optional[str] = None

    @property
    def batch_quantities(self) -> bool:
        return self.pack_groups == "dtype"

    @property
    def phases(self) -> Tuple:
        if self.method == DIRECT26:
            return self.direct_phases
        if self.method == REMOTE_DMA:
            return self.fused_phases if self.fused else self.remote_phases
        return self.axis_phases

    def collectives_per_exchange(self, quantities: int = 1, dtype_groups: int = 1) -> int:
        """Collectives one exchange issues (0 for REMOTE_DMA)."""
        carriers = dtype_groups if self.batch_quantities else quantities
        return sum(p.collectives() for p in self.phases) * carriers

    def dmas_per_exchange(self, quantities: int = 1, dtype_groups: int = 1) -> int:
        """Kernel-issued copies toward other devices per REMOTE_DMA exchange
        (0 for the other methods, and on one device)."""
        if self.method != REMOTE_DMA:
            return 0
        carriers = dtype_groups if self.batch_quantities else quantities
        phases = self.fused_phases if self.fused else self.remote_phases
        return sum(p.dmas() for p in phases) * carriers

    def carrier_launches(self, carriers: Sequence[int], dtype_groups: int) -> int:
        """Kernel launches of one REMOTE_DMA exchange on the card, the copy
        count the "cuda" cost model prices (0 for the other methods).
        ``carriers`` holds each carrier's quantity count (a same-dtype group
        when batching, else 1 each). A fused plan over several positions of a
        uniform partition is one fused-exchange launch (B7) per dtype group;
        otherwise each active axis phase takes, per carrier, one axis-carrier
        launch (B6) where the partition has several blocks along the axis, or
        self-wrap fills (B4) of every block, ``FILL_GROUP`` blocks a launch."""
        if self.method != REMOTE_DMA:
            return 0
        px, py, pz = self.partition
        mx, my, mz = self.mesh_dim
        uniform = all(p.uniform for p in self.axis_phases)
        if self.fused and mx * my * mz > 1 and uniform:
            return dtype_groups
        nblocks = px * py * pz
        n = 0
        for ph in self.remote_phases:
            if not ph.active:
                continue
            for q in carriers:
                n += 1 if ph.blocks > 1 else -(-q * nblocks // FILL_GROUP)
        return n

    def launches_per_chunk(self, k: int = 1) -> int:
        """Device-program dispatches one k-step chunk pays, in the JAX
        package's unit: persistent 2 (deep exchange + chunk program; the
        whole-chunk kernel is 1, which the step loop records instead),
        plain and fused REMOTE_DMA 2 per step, the other methods 1."""
        if int(k) < 1:
            raise ValueError(f"launches_per_chunk needs k >= 1, got {k}")
        if self.method != REMOTE_DMA:
            return 1
        if self.persistent:
            return 2
        return 2 * int(k)

    def wire_bytes(self, itemsizes: Sequence[int],
                   floating: Optional[Sequence[bool]] = None) -> int:
        """Bytes sent between positions per exchange, all quantities
        (``itemsizes``): with ``wire_dtype`` set, a crossing cell of a
        floating quantity pays the narrowed itemsize, an integer one
        (``floating`` False; omitted, every quantity is floating) its
        native one, as the lowering narrows only floating carriers."""
        w = wire_itemsize(self.wire_dtype)
        if w is None:
            per_cell = sum(itemsizes)
        else:
            fl = [True] * len(itemsizes) if floating is None else list(floating)
            per_cell = sum(min(i, w) if f else i for i, f in zip(itemsizes, fl))
        return sum(p.wire_cells for p in self.phases) * per_cell

    def local_bytes(self, itemsizes: Sequence[int]) -> int:
        """Bytes moved without crossing between positions (self-wrap
        fills, resident-neighbour shifts), all quantities."""
        return sum(p.local_cells for p in self.phases) * sum(itemsizes)

    def describe(self) -> str:
        """Human-readable plan dump."""
        lines = [
            f"method={self.method} pack_groups={self.pack_groups} "
            f"partition={self.partition} mesh={self.mesh_dim} "
            f"resident={self.resident}"
            + (" (fused compute+exchange kernel)" if self.fused else "")
            + (" (persistent whole-chunk kernel)" if self.persistent else "")
            + (f" wire_dtype={self.wire_dtype}" if self.wire_dtype else ""),
        ]
        for p in self.phases:
            if isinstance(p, FusedPhaseIR):
                lines.append(
                    f"  dir {p.direction}: shape(zyx)={p.shape} permutes=0 "
                    f"dmas={p.dmas()} wire_cells={p.wire_cells} "
                    f"local_cells={p.local_cells}")
            elif isinstance(p, RemoteDmaPhaseIR):
                lines.append(
                    f"  axis {p.axis}: ring={p.ring} resident={p.resident} "
                    f"rm={p.rm} rp={p.rp} permutes=0 dmas={p.dmas()} "
                    f"wire_cells={p.wire_cells} local_cells={p.local_cells}")
            elif isinstance(p, AxisPhaseIR):
                lines.append(
                    f"  axis {p.axis}: ring={p.ring} resident={p.resident} "
                    f"rm={p.rm} rp={p.rp} permutes={p.collectives()} "
                    f"wire_cells={p.wire_cells} local_cells={p.local_cells}")
            else:
                lines.append(
                    f"  dir {p.direction}: shape(zyx)={p.shape} "
                    f"permutes={p.collectives()} wire_cells={p.wire_cells}")
        lines.append(f"  total permutes/exchange (1 group): {self.collectives_per_exchange()}")
        if self.method == REMOTE_DMA:
            lines.append(
                f"  total async remote copies/exchange (1 group): "
                f"{self.dmas_per_exchange()} (kernel-initiated — the "
                "census sees 0 ppermutes)")
        if self.wire_dtype:
            native = dataclasses.replace(self, wire_dtype=None)
            lines.append(
                f"  wire bytes (1 fp32 quantity): {self.wire_bytes([4])} "
                f"({self.wire_dtype} on the wire; {native.wire_bytes([4])} native)")
        return "\n".join(lines)


def spec_axis(spec, name: str):
    """(per-index sizes, low radius, high radius, compute offset) along one
    axis; the halo sits at ``[offset - rm, offset)``."""
    off = spec.compute_offset()
    if name == "x":
        return spec.sizes_x, spec.radius.x(-1), spec.radius.x(1), off.x
    if name == "y":
        return spec.sizes_y, spec.radius.y(-1), spec.radius.y(1), off.y
    return spec.sizes_z, spec.radius.z(-1), spec.radius.z(1), off.z


def _ring_pairs(n: int):
    fwd = tuple((i, (i + 1) % n) for i in range(n))
    bwd = tuple((i, (i - 1) % n) for i in range(n))
    return fwd, bwd


def _axis_phases(spec, mesh_dim: Dim3, resident: Dim3) -> Tuple[AxisPhaseIR, ...]:
    p = spec.padded()
    orth = {"x": p.y * p.z, "y": p.x * p.z, "z": p.x * p.y}
    res = {"x": resident.x, "y": resident.y, "z": resident.z}
    md = {"x": mesh_dim.x, "y": mesh_dim.y, "z": mesh_dim.z}
    nblocks = spec.num_blocks()
    phases = []
    for name, adim, bdim in AXIS_ORDER:
        sizes, rm, rp, off = spec_axis(spec, name)
        c, ring = res[name], md[name]
        fwd, bwd = _ring_pairs(ring) if ring > 1 else ((), ())
        slab_cells = (rm + rp) * orth[name] * nblocks
        if ring > 1:
            # with residents only each device's two boundary slabs leave it
            wire = (rm + rp) * orth[name] * (nblocks // c) if c > 1 else slab_cells
        else:
            wire = 0
        phases.append(AxisPhaseIR(
            axis=name, adim=adim, bdim=bdim, ring=ring, resident=c, rm=rm, rp=rp,
            offset=off, sizes=tuple(sizes), fwd=fwd, bwd=bwd,
            wire_cells=wire, local_cells=slab_cells - wire))
    return tuple(phases)


def _perm26(dim: Dim3, d: Dim3) -> Tuple[Tuple[int, int], ...]:
    """Flattened (z, y, x)-major permutation sending toward ``d`` (one
    block per position)."""
    pairs = []
    for iz in range(dim.z):
        for iy in range(dim.y):
            for ix in range(dim.x):
                src = (iz * dim.y + iy) * dim.x + ix
                jz, jy, jx = (iz + d.z) % dim.z, (iy + d.y) % dim.y, (ix + d.x) % dim.x
                pairs.append((src, (jz * dim.y + jy) * dim.x + jx))
    return tuple(pairs)


def _direct_phases(spec, mesh_dim: Dim3, resident: Dim3) -> Tuple[DirectPhaseIR, ...]:
    """The active directions (``radius.dir(-d) != 0``), each a message of
    the base-size extent on its zero axes; on an uneven partition in face ->
    edge -> corner order (a padded write may spill only into a band of a
    direction with more nonzero components, written later). Directions of
    zero extent are dropped."""
    uniform = spec.is_uniform()
    oversub = resident != Dim3(1, 1, 1)
    nblocks = spec.num_blocks()
    md = {"z": mesh_dim.z, "y": mesh_dim.y, "x": mesh_dim.x}
    dirs = [d for d in DIRECTIONS_26 if spec.radius.dir(-d) != 0]
    if not uniform:
        dirs.sort(key=lambda d: abs(d.x) + abs(d.y) + abs(d.z))
    phases = []
    for d, src, dst, shape in direction_boxes(spec, dirs):
        if any(e == 0 for e in shape):
            continue
        if oversub:
            comp = {"z": d.z, "y": d.y, "x": d.x}
            count = sum(1 for a in ("z", "y", "x") if comp[a] != 0 and md[a] > 1)
            pairs: Tuple[Tuple[int, int], ...] = ()
        else:
            count, pairs = 1, _perm26(spec.dim, d)
        cells = shape[0] * shape[1] * shape[2] * nblocks
        phases.append(DirectPhaseIR(
            direction=(d.x, d.y, d.z), shape=shape,
            src=src if uniform else None, dst=dst if uniform else None,
            pairs=pairs, collective_count=count,
            wire_cells=cells if count else 0, local_cells=0 if count else cells))
    return tuple(phases)


def _remote_phases(axis_phases) -> Tuple[RemoteDmaPhaseIR, ...]:
    return tuple(
        RemoteDmaPhaseIR(
            axis=p.axis, adim=p.adim, bdim=p.bdim, ring=p.ring, resident=p.resident,
            rm=p.rm, rp=p.rp, offset=p.offset, sizes=p.sizes, fwd=p.fwd, bwd=p.bwd,
            wire_cells=p.wire_cells, local_cells=p.local_cells)
        for p in axis_phases)


def direction_boxes(spec, directions):
    """``[(direction, src, dst, shape)]`` in (z, y, x) block-local
    coordinates for each of ``directions`` on a uniform partition: the
    message toward ``d`` reads the sender's compute cells on its ``d`` side
    and fills the receiver's ``-d`` halo, radius deep along ``d``'s nonzero
    axes and the block's extent on the others. On an uneven partition these
    are the base-size block's boxes (the direct26 carrier extents)."""
    r, base, off = spec.radius, spec.base, spec.compute_offset()
    out = []
    for d in directions:
        shape, src, dst = [], [], []
        for dc, s, rmin, rplus, o in zip(
                (d.z, d.y, d.x), (base.z, base.y, base.x),
                (r.z(-1), r.y(-1), r.x(-1)), (r.z(1), r.y(1), r.x(1)),
                (off.z, off.y, off.x)):
            if dc == 1:
                shape.append(rmin)
                src.append(o + s - rmin)
                dst.append(o - rmin)
            elif dc == -1:
                shape.append(rplus)
                src.append(o)
                dst.append(o + s)
            else:
                shape.append(s)
                src.append(o)
                dst.append(o)
        out.append((d, tuple(src), tuple(dst), tuple(shape)))
    return out


def _fused_phases(spec, mesh_dim: Dim3) -> Tuple[FusedPhaseIR, ...]:
    """The active directions (``radius.dir(-d) != 0``) in face -> edge ->
    corner order, each an exact-extent message; a direction crosses iff one
    of its nonzero axes has more than one device."""
    uniform = spec.is_uniform()
    nblocks = spec.num_blocks()
    md = {"z": mesh_dim.z, "y": mesh_dim.y, "x": mesh_dim.x}
    dirs = [d for d in DIRECTIONS_26 if spec.radius.dir(-d) != 0]
    dirs.sort(key=lambda d: abs(d.x) + abs(d.y) + abs(d.z))
    phases = []
    for d, src, dst, shape in direction_boxes(spec, dirs):
        if any(e == 0 for e in shape):
            continue
        comp = {"z": d.z, "y": d.y, "x": d.x}
        crossing = any(comp[a] != 0 and md[a] > 1 for a in ("z", "y", "x"))
        cells = shape[0] * shape[1] * shape[2] * nblocks
        phases.append(FusedPhaseIR(
            direction=(d.x, d.y, d.z), shape=shape,
            src=src if uniform else None, dst=dst if uniform else None,
            crossing=crossing,
            wire_cells=cells if crossing else 0,
            local_cells=0 if crossing else cells))
    return tuple(phases)


def build_plan(spec, mesh_dim, method, batch_quantities: bool = True,
               resident: Optional[Dim3] = None, wire_dtype: Optional[str] = None,
               fused: bool = False, persistent: bool = False, hierarchy=None) -> ExchangePlan:
    """The ExchangePlan of one (GridSpec, mesh shape (x, y, z), method) for
    the axis-composed, direct26 and remote-dma methods, the last with its
    fused or persistent variant. ``method`` may be the enum or its value string;
    ``resident`` defaults to ``spec.dim / mesh_dim``; ``wire_dtype``
    narrows wire-crossing carriers in the byte model."""
    mval = getattr(method, "value", method)
    if mval not in METHODS:
        raise ValueError(f"unknown exchange method {method!r}")
    if hierarchy is not None:
        raise NotImplementedError(f"hierarchical exchange plans: {_LATER['hierarchy']}")
    if fused and mval != REMOTE_DMA:
        raise ValueError(
            "the fused compute+exchange variant is a REMOTE_DMA lowering "
            f"(kernel-initiated copies); got method {mval!r}")
    if persistent and mval != REMOTE_DMA:
        raise ValueError(
            "the persistent whole-chunk variant is a REMOTE_DMA lowering "
            f"(kernel-initiated copies); got method {mval!r}")
    if persistent and fused:
        raise ValueError(
            "fused and persistent are distinct kernel variants of one "
            "plan — choose one (persistent at k == 1 IS the fused kernel)")
    if mval == AUTO_SPMD:
        raise NotImplementedError(f"{mval} exchange plans: {_LATER[mval]}")
    md = Dim3.of(mesh_dim)
    if spec.dim.x % md.x or spec.dim.y % md.y or spec.dim.z % md.z:
        raise ValueError(f"mesh {md} does not divide partition {spec.dim}")
    if resident is None:
        resident = Dim3(spec.dim.x // md.x, spec.dim.y // md.y, spec.dim.z // md.z)
    for flag, name in ((fused, "fused compute+exchange"), (persistent, "persistent whole-chunk")):
        if flag and resident != Dim3(1, 1, 1):
            raise ValueError(
                f"the {name} kernel supports single-resident "
                f"partitions only (got resident {resident}); use the plain "
                "REMOTE_DMA carrier or AXIS_COMPOSED for oversubscription")
    axis_phases = _axis_phases(spec, md, resident)
    return ExchangePlan(
        method=mval,
        pack_groups="dtype" if batch_quantities else "quantity",
        partition=(spec.dim.x, spec.dim.y, spec.dim.z),
        mesh_dim=(md.x, md.y, md.z),
        resident=(resident.x, resident.y, resident.z),
        axis_phases=axis_phases,
        direct_phases=_direct_phases(spec, md, resident) if mval == DIRECT26 else (),
        remote_phases=_remote_phases(axis_phases) if mval == REMOTE_DMA else (),
        fused_phases=_fused_phases(spec, md) if fused else (),
        fused=fused,
        persistent=persistent,
        wire_dtype=wire_dtype,
    )


def radius_dirs(radius) -> Tuple[Tuple[int, int, int, int], ...]:
    """Canonical nonzero-direction serialization of a Radius,
    ``((dx, dy, dz, r), ...)`` sorted by direction: the convention of the
    checkpoint manifests and of :class:`PlanConfig`."""
    return tuple((d[0], d[1], d[2], r) for d, r in sorted(radius._r.items())
                 if r and d != (0, 0, 0))


@dataclass(frozen=True)
class PlanConfig:
    """Canonical problem key: what a tuned plan, or a compiled program of
    the campaign's compile cache, is valid for. ``quantities`` is a dtype
    multiset, ``(("float32", 4),)``, sorted by dtype name, so the order in
    which a domain declares its quantities never changes the key.
    ``platform`` is the device type: ``"cuda"`` on the card, ``"cpu"``
    otherwise. :meth:`key` is the JAX package's string for the same
    fields."""

    grid: Tuple[int, int, int]                       # (x, y, z)
    radius: Tuple[Tuple[int, int, int, int], ...]    # radius_dirs()
    quantities: Tuple[Tuple[str, int], ...]          # sorted (dtype, count)
    ndev: int
    platform: str = "cpu"

    @classmethod
    def make(cls, size, radius, dtypes: Sequence[str], ndev: int,
             platform: str = "cpu") -> "PlanConfig":
        size = Dim3.of(size)
        counts: Dict[str, int] = {}
        for dt in dtypes:
            counts[str(dt)] = counts.get(str(dt), 0) + 1
        return cls(grid=(size.x, size.y, size.z), radius=radius_dirs(radius),
                   quantities=tuple(sorted(counts.items())), ndev=int(ndev),
                   platform=str(platform))

    @property
    def num_quantities(self) -> int:
        return sum(n for _dt, n in self.quantities)

    @property
    def dtype_group_count(self) -> int:
        return max(1, len(self.quantities))

    def itemsizes(self) -> Tuple[int, ...]:
        """Bytes per cell of each quantity, in key order."""
        import numpy as np

        out = []
        for dt, n in self.quantities:
            out.extend([np.dtype(dt).itemsize] * n)
        return tuple(out)

    def floating_flags(self) -> Tuple[bool, ...]:
        """Per-quantity floatness, aligned with :meth:`itemsizes`: only
        floating carriers narrow on the wire (``ExchangePlan.wire_bytes``)."""
        import numpy as np

        out = []
        for dt, n in self.quantities:
            out.extend([bool(np.issubdtype(np.dtype(dt), np.floating))] * n)
        return tuple(out)

    def radius_obj(self) -> Radius:
        return radius_from_dirs(self.radius)

    def key(self) -> str:
        """Stable string key: sorted-key compact JSON."""
        return json.dumps({
            "grid": list(self.grid),
            "radius": [list(t) for t in self.radius],
            "quantities": [list(t) for t in self.quantities],
            "ndev": self.ndev,
            "platform": self.platform,
        }, sort_keys=True, separators=(",", ":"))

    def to_json(self) -> dict:
        return json.loads(self.key())

    @classmethod
    def from_json(cls, obj: dict) -> "PlanConfig":
        return cls(grid=tuple(obj["grid"]),
                   radius=tuple(tuple(t) for t in obj["radius"]),
                   quantities=tuple((str(d), int(n)) for d, n in obj["quantities"]),
                   ndev=int(obj["ndev"]), platform=str(obj.get("platform", "cpu")))


def radius_from_dirs(dirs) -> Radius:
    """The Radius of a :func:`radius_dirs` serialization."""
    r = Radius.constant(0)
    for dx, dy, dz, v in dirs:
        r.set_dir((dx, dy, dz), v)
    return r


def validate_placement(placement, ndev: int) -> Optional[str]:
    """``None`` (identity) or a permutation of ``range(ndev)`` mapping mesh
    position i (row-major z, y, x) to the index of the device hosting it:
    the JAX package's one placement-shape check. Returns an error string,
    or None when valid."""
    if placement is None:
        return None
    try:
        f = [int(v) for v in placement]
    except (TypeError, ValueError):
        return f"placement must be a sequence of ints, got {placement!r}"
    if len(f) != ndev:
        return f"placement has {len(f)} entries for {ndev} mesh positions"
    if sorted(f) != list(range(ndev)):
        return f"placement {f} is not a permutation of range({ndev})"
    return None


def validate_hierarchy(hierarchy, mesh_dim) -> Optional[str]:
    """``None`` (flat) or an ``(axis, hosts)`` outer split whose host count
    divides the mesh extent along ``axis``: the JAX package's check, which
    the plan DB applies to a stored choice. Returns an error string, or
    None when valid."""
    if hierarchy is None:
        return None
    try:
        axis, hosts = hierarchy
        axis = str(axis)
        hosts = int(hosts)
    except (TypeError, ValueError):
        return f"hierarchy must be an (axis, hosts) pair, got {hierarchy!r}"
    if axis not in ("x", "y", "z"):
        return f"hierarchy axis must be 'x'|'y'|'z', got {axis!r}"
    if hosts < 1:
        return f"hierarchy needs hosts >= 1, got {hosts}"
    md = Dim3.of(mesh_dim)
    n = {"x": md.x, "y": md.y, "z": md.z}[axis]
    if n % hosts:
        return f"{hosts} hosts do not divide the {axis} mesh extent {n}"
    return None


@dataclass(frozen=True)
class PlanChoice:
    """One point of the planner's search space, what the autotuner picks
    and the plan DB stores: partition (blocks x, y, z) x exchange method x
    quantity batching x temporal depth ``multistep_k`` x kernel variant
    (``"fused"`` or ``"persistent"`` on REMOTE_DMA).

    ``placement`` (mesh position -> device index), ``hierarchy`` (the
    outer ``(axis, hosts)`` split) and ``host_placement`` are the JAX
    package's fields, kept so its DB entries and manifests load here; an
    absent field is identity / flat, the JAX migration default. A domain
    realizes only the identity placement and no hierarchy (positions on
    distinct GPUs and several hosts are ROADMAP.md queue A item 5)."""

    partition: Tuple[int, int, int]
    method: str
    batch_quantities: bool = True
    multistep_k: int = 1
    kernel_variant: Optional[str] = None
    placement: Optional[Tuple[int, ...]] = None
    hierarchy: Optional[Tuple[str, int]] = None
    host_placement: Optional[Tuple[int, ...]] = None

    def to_json(self) -> dict:
        return {
            "partition": list(self.partition),
            "method": self.method,
            "batch_quantities": self.batch_quantities,
            "multistep_k": self.multistep_k,
            "kernel_variant": self.kernel_variant,
            "placement": None if self.placement is None else list(self.placement),
            "hierarchy": (None if self.hierarchy is None
                          else [self.hierarchy[0], self.hierarchy[1]]),
            "host_placement": (None if self.host_placement is None
                               else list(self.host_placement)),
        }

    @classmethod
    def from_json(cls, obj: dict) -> "PlanChoice":
        placement = obj.get("placement")
        hierarchy = obj.get("hierarchy")
        host_placement = obj.get("host_placement")
        return cls(
            partition=tuple(obj["partition"]),
            method=str(obj["method"]),
            batch_quantities=bool(obj.get("batch_quantities", True)),
            multistep_k=int(obj.get("multistep_k", 1)),
            kernel_variant=obj.get("kernel_variant"),
            placement=None if placement is None else tuple(int(v) for v in placement),
            hierarchy=(None if hierarchy is None
                       else (str(hierarchy[0]), int(hierarchy[1]))),
            host_placement=(None if host_placement is None
                            else tuple(int(v) for v in host_placement)),
        )

    @property
    def is_fused(self) -> bool:
        """The fused compute+exchange variant of REMOTE_DMA."""
        return self.kernel_variant == FUSED_VARIANT

    @property
    def is_persistent(self) -> bool:
        """The persistent whole-chunk variant of REMOTE_DMA (``multistep_k``
        is the chunk depth)."""
        return self.kernel_variant == PERSISTENT_VARIANT

    @property
    def is_placed(self) -> bool:
        """A non-identity block placement."""
        return (self.placement is not None
                and list(self.placement) != list(range(len(self.placement))))

    @property
    def is_hierarchical(self) -> bool:
        """A real (multi-host) outer split."""
        return self.hierarchy is not None and self.hierarchy[1] > 1

    def fingerprint(self) -> str:
        """12 hex characters of the sha256 of the canonical JSON: the key
        that joins a metrics file, the plan DB and a fitted calibration."""
        blob = json.dumps(self.to_json(), sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:12]

    def label(self) -> str:
        px, py, pz = self.partition
        s = f"{px}x{py}x{pz}/{self.method}"
        s += "/batched" if self.batch_quantities else "/per-quantity"
        if self.multistep_k > 1:
            s += f"/k={self.multistep_k}"
        if self.kernel_variant:
            s += f"/{self.kernel_variant}"
        if self.hierarchy is not None:
            s += f"/h={self.hierarchy[0]}{self.hierarchy[1]}"
        if (self.host_placement is not None
                and list(self.host_placement) != list(range(len(self.host_placement)))):
            s += "/hp=" + "-".join(str(v) for v in self.host_placement)
        if self.is_placed:
            s += "/p=" + "-".join(str(v) for v in self.placement)
        return s

    def realizable(self) -> None:
        """Raise for what a domain cannot realize: a hierarchy or a
        non-identity placement (ROADMAP.md queue A item 5)."""
        if self.hierarchy is not None or self.host_placement is not None:
            raise NotImplementedError(
                f"plan {self.label()}: hierarchical (multi-host) plans are ROADMAP.md "
                "queue A item 5")
        if self.is_placed:
            raise NotImplementedError(
                f"plan {self.label()}: a non-identity block placement needs positions on "
                "distinct devices (ROADMAP.md queue A item 5)")
