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

``tenants=True`` marks the stack's blocks as independent tenants (the
campaign's ``(B, pz, py, px)`` slot state): x and y fill as for a z-stack,
and z wraps each tenant onto itself, the z fill's two runs repeated over
the B tenants a block apart. :func:`wrap_fill_tenants` fills a tenant stack
x -> y -> z, three launches for a same-dtype group of up to
:data:`MAX_FILL_GROUP` quantities; :func:`wrap_fill_batched` is its plain
version.

:func:`fill_layout` is what the kernel is told: the fill of one axis as two
copies (runs) repeated over instances, and the vector width that divides
them. It is pure Python, so the CPU tests hold it to the plain fill.

The narrowed wire (``wire_dtype``, the JAX package's bf16-on-the-wire
compression, its fp8 tier and every other floating format it narrows
through) is owned here too. A wire is a format of the port's own table,
:data:`WIRE_FORMATS` (name, bytes a cell, the kernels' code, and its
rounding parameters; torch lacks several of these dtypes and no narrow
tensor is ever made). :func:`wire_format` is the policy (only a floating
carrier narrows, only to a strictly narrower floating wire; never an
integer quantity, never a bitcast), :func:`wire_round` the plain version
of a crossing word's narrow-then-widen, and a format's ``code`` and
:func:`wire_params` what the exchange kernels take (``csrc/wire_round.cuh``).
The self-wrap fill never narrows: it copies inside one position.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

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


# The kernels' wire codes (csrc/wire_round.cuh): 0 is no narrowing; bf16,
# fp16, e4m3fn, e5m2 and fp32 (fp64 data only) are rounded by the card's
# conversions, each its own instantiation; every other format shares one
# instantiation, SOFT_WIRE, which rounds by the format's parameters
# (:func:`wire_params`) passed with the launch.
SOFT_WIRE = 6


@dataclass(frozen=True)
class WireFormat:
    """A floating wire format: its name (the JAX package's dtype name), the
    bytes a cell of it pays, the kernels' code, and how a value rounds into
    it: to nearest even at the quantum of ``mant`` stored mantissa bits in
    its binade, or below the least normal ``2 ** emin`` at the subnormal
    quantum ``2 ** (emin - mant)``; a result past ``top`` (the largest
    finite value), and an infinity, becomes +-inf, NaN or +-``top`` by
    ``overflow``. Without ``signed_zero`` a zero result is +0; with
    ``nan_to_zero`` (a format without NaN) a NaN becomes -0. An
    ``exp_only`` format holds powers of two alone: no sign and no zero, so
    a value that is not positive is NaN, and a result that rounds to zero
    is the least value ``2 ** (emin - 1)`` (fp32 data; fp64 data below it
    is NaN), as XLA converts."""

    name: str
    itemsize: int
    code: int
    mant: int
    emin: int
    top: float
    overflow: str  # "inf", "nan" or "saturate"
    signed_zero: bool = True
    nan_to_zero: bool = False
    exp_only: bool = False

    @property
    def over(self) -> float:
        """What a value past ``top`` becomes, before its sign."""
        return {"inf": math.inf, "nan": math.nan, "saturate": self.top}[self.overflow]

    @property
    def least(self) -> float:
        """An exponent-only format's least value (half its least normal)."""
        return 2.0 ** (self.emin - 1)


def _fmt(name, code, mant, emin, top, overflow, itemsize=1, **kw) -> WireFormat:
    return WireFormat(name, itemsize, code, mant, emin, float(top), overflow, **kw)


# every floating wire the port narrows through, by the JAX package's name;
# bf16 and fp32 round through torch's conversion in the plain version
WIRE_FORMATS = {f.name: f for f in (
    _fmt("bfloat16", 1, 7, -126, (2 - 2.0 ** -7) * 2.0 ** 127, "inf", 2),
    _fmt("float16", 2, 10, -14, 65504, "inf", 2),
    _fmt("float8_e4m3fn", 3, 3, -6, 448, "nan"),
    _fmt("float32", 4, 23, -126, (2 - 2.0 ** -23) * 2.0 ** 127, "inf", 4),
    _fmt("float8_e5m2", 5, 2, -14, 57344, "inf"),
    _fmt("float8_e4m3fnuz", SOFT_WIRE, 3, -7, 240, "nan", signed_zero=False),
    _fmt("float8_e5m2fnuz", SOFT_WIRE, 2, -15, 57344, "nan", signed_zero=False),
    _fmt("float8_e4m3b11fnuz", SOFT_WIRE, 3, -10, 30, "nan", signed_zero=False),
    _fmt("float8_e3m4", SOFT_WIRE, 4, -2, 15.5, "inf"),
    _fmt("float8_e4m3", SOFT_WIRE, 3, -6, 240, "inf"),
    _fmt("float8_e8m0fnu", SOFT_WIRE, 0, -126, 2.0 ** 127, "nan", exp_only=True),
    _fmt("float4_e2m1fn", SOFT_WIRE, 1, 0, 6, "saturate", nan_to_zero=True),
)}

# doubles of a launch's format parameters (csrc/wire_round.cuh Format::from)
WIRE_PARAMS = 8


def _torch_dtype(dt) -> torch.dtype:
    if isinstance(dt, torch.dtype):
        return dt
    t = getattr(torch, str(dt), None)
    if not isinstance(t, torch.dtype):
        raise ValueError(f"unknown dtype {dt!r}")
    return t


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def wire_name(wire) -> Optional[str]:
    """The canonical name of a wire dtype (a torch dtype or a name), or
    None for no wire (``None`` or ""): a format of :data:`WIRE_FORMATS`, or
    a dtype nothing narrows to (``float64``, an integer), which is a no-op
    as in the JAX package."""
    if wire is None or wire == "":
        return None
    name = _dtype_name(wire) if isinstance(wire, torch.dtype) else str(wire)
    if name in WIRE_FORMATS:
        return name
    dt = _torch_dtype(name)
    if dt.is_floating_point and dt != torch.float64:
        raise ValueError(f"wire_dtype {name}: a floating dtype the port has no wire format for")
    return _dtype_name(dt)


def wire_format(native, wire) -> Optional[WireFormat]:
    """The format a wire-crossing carrier of ``native`` data travels in, or
    None when it stays native (the JAX package's ``wire_narrow_dtype``):
    both floating, and the wire strictly narrower than the data."""
    name = wire_name(wire)
    native = _torch_dtype(native)
    if name not in WIRE_FORMATS or not native.is_floating_point:
        return None
    fmt = WIRE_FORMATS[name]
    return fmt if fmt.itemsize < native.itemsize else None


@functools.lru_cache(maxsize=None)
def wire_params(fmt: Optional[WireFormat]):
    """The :data:`WIRE_PARAMS` doubles a launch passes for ``fmt`` (zeros
    for no wire), as a ctypes array made once per format: mantissa bits,
    least normal exponent, largest finite value, what a value past it
    becomes, what a NaN becomes, the least value of an exponent-only
    format, signed zero, exponent only."""
    vals = (0.0,) * WIRE_PARAMS if fmt is None else (
        float(fmt.mant), float(fmt.emin), fmt.top, fmt.over,
        -0.0 if fmt.nan_to_zero else math.nan, fmt.least, float(fmt.signed_zero),
        float(fmt.exp_only))
    return (ctypes.c_double * WIRE_PARAMS)(*vals)


def _round_format(t: torch.Tensor, fmt: WireFormat) -> torch.Tensor:
    """``t`` rounded into ``fmt`` and widened back, in one rounding from the
    data's own value (computed in fp64, exact for fp32 and fp64 data): to
    nearest even at the quantum of ``|x|``'s binade, or the subnormal
    quantum below the least normal; then ``fmt``'s rules for overflow,
    zero, NaN and an exponent-only format, as the JAX package's ``astype``
    under ``jax.jit``."""
    x = t.to(torch.float64)
    a = x.abs()
    _m, e = torch.frexp(a)  # a = m 2^e, m in [0.5, 1)
    q = torch.ldexp(torch.ones_like(a), ((e - 1).clamp(min=fmt.emin) - fmt.mant))
    r = torch.round(torch.where(torch.isfinite(a), a, 0.0) / q) * q  # half to even
    r = torch.where((r > fmt.top) | torch.isinf(a), fmt.over, r)
    if fmt.exp_only:
        r = torch.where(r == 0, fmt.least, r)
        if t.dtype == torch.float64:
            r = torch.where(a < fmt.least, math.nan, r)
        return torch.where(x > 0, r, math.nan).to(t.dtype)
    r = torch.copysign(r, x) if fmt.signed_zero else torch.where(r == 0, 0.0, torch.copysign(r, x))
    return torch.where(torch.isnan(x), -0.0 if fmt.nan_to_zero else math.nan, r).to(t.dtype)


def wire_round(t: torch.Tensor, wire) -> torch.Tensor:
    """Plain version of a crossing word's trip over the wire: ``t`` narrowed
    to ``wire`` and widened back (``t`` itself when it does not narrow),
    equal to the JAX package's ``jax.jit(lambda x:
    x.astype(wire).astype(x.dtype))`` except that IEEE subnormals are kept.
    fp32 wires (fp64 data) and bf16 wires round through torch's ``.to``,
    bf16 from fp64 through fp32 (twice, as the JAX package does); every
    other format rounds once from the data's value by its parameters
    (:func:`_round_format`), since torch rounds fp64 through fp32,
    saturates fp8 and lacks most of these formats."""
    fmt = wire_format(t.dtype, wire)
    if fmt is None:
        return t
    if fmt.name == "bfloat16":
        return t.to(torch.float32).to(torch.bfloat16).to(t.dtype)
    if fmt.name == "float32":
        return t.to(torch.float32).to(t.dtype)
    return _round_format(t, fmt)


def axis_geom(spec: GridSpec, axis: str) -> Tuple[int, int, int, int]:
    """``(offset, size, rm, rp)`` of one axis: compute-region origin and
    base (largest) extent in the padded block, and the lo / hi halo widths.
    On a multi-block axis of an uneven partition a block's own size is
    :func:`axis_sizes`'s."""
    off = spec.compute_offset()
    r = spec.radius
    if axis == "x":
        return off.x, spec.base.x, r.x(-1), r.x(1)
    if axis == "y":
        return off.y, spec.base.y, r.y(-1), r.y(1)
    if axis == "z":
        return off.z, spec.base.z, r.z(-1), r.z(1)
    raise ValueError(f"unknown axis {axis!r}")


def axis_sizes(spec: GridSpec, axis: str) -> Tuple[int, ...]:
    """The block sizes along one axis, one per block index. ``axis_geom``'s
    size is the base (largest) one; on an uneven partition a block's hi
    side starts at its own size (a self-wrap axis has one block, whose size
    is the base)."""
    return {"x": spec.sizes_x, "y": spec.sizes_y, "z": spec.sizes_z}[axis]


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


@dataclass(frozen=True)
class FillLayout:
    """One axis's fill as the kernel performs it, in words of the padded
    block (or z-stack) viewed flat: for each of ``count`` instances at
    ``i * stride``, each run ``(dst, src, length)`` copies ``length`` words
    from ``base + src`` to ``base + dst``. ``body`` is ``"runs"`` (y and z:
    long contiguous runs, copied in chunks) or ``"rows"`` (x: one row per
    instance, a few words at each end). ``vec`` is the words per access."""

    body: str
    runs: Tuple[Tuple[int, int, int], ...]
    count: int
    stride: int
    vec: int


# bytes of one access the kernel can make: a 16-byte vector, 8, or one word
VECTOR_BYTES = (16, 8)
SECTOR_BYTES = 32


def fill_layout(spec: GridSpec, axis: str, elem_size: int, z_stack: int = 1,
                ptr_align: int = 16, tenants: bool = False) -> FillLayout:
    """The runs of ``axis``'s fill for ``elem_size``-byte words and the
    widest access (16 bytes, 8, or one word) that divides every run's
    start and length, the stride and ``ptr_align`` (the largest power of
    two that divides every block's address). Empty runs (a zero radius on
    one side) are left out. With ``tenants`` the ``z_stack`` blocks are
    independent tenants, and z wraps each onto itself: its runs repeat
    over the tenants, one padded block apart."""
    _check_stack(axis, z_stack, tenants)
    o, n, rm, rp = axis_geom(spec, axis)
    p = spec.padded()
    unit = {"z": p.y * p.x, "y": p.x, "x": 1}[axis]
    runs = tuple((d * unit, s * unit, w * unit)
                 for d, s, w in ((o - rm, o + n - rm, rm), (o + n, o, rp)) if w)
    if axis == "z":
        body, count, stride = "runs", z_stack, p.z * p.y * p.x if z_stack > 1 else 0
    elif axis == "y":
        body, count, stride = "runs", z_stack * p.z, p.y * p.x
    else:
        body, count, stride = "rows", z_stack * p.z * p.y, p.x
    words = [stride] + [v for run in runs for v in run]
    vec = next(w // elem_size for w in VECTOR_BYTES + (elem_size,)
               if w >= elem_size and ptr_align % w == 0
               and all(v * elem_size % w == 0 for v in words))
    return FillLayout(body, runs, count, stride, vec)


def _sectors(lo: int, hi: int) -> Tuple[int, int]:
    return lo // SECTOR_BYTES, (hi - 1) // SECTOR_BYTES + 1


def _merged_len(spans) -> int:
    total, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total


def fill_sector_bytes(layout: FillLayout, elem_size: int) -> int:
    """Bytes of the 32-byte sectors one quantity's fill must touch, on a
    block whose address is sector-aligned: in each instance, the sectors
    that hold its source words, read once, and those that hold its halo
    words, written once. For the x fill this is the floor: a row end of a
    few words still costs its whole sectors."""
    e = elem_size
    period = SECTOR_BYTES // math.gcd(layout.stride * e, SECTOR_BYTES) if layout.count > 1 else 1
    total = 0
    for i in range(min(period, layout.count)):
        base = i * layout.stride * e
        reads = [_sectors(base + s * e, base + (s + w) * e) for _d, s, w in layout.runs]
        writes = [_sectors(base + d * e, base + (d + w) * e) for d, _s, w in layout.runs]
        reps = (layout.count - i + period - 1) // period
        total += reps * (_merged_len(reads) + _merged_len(writes))
    return total * SECTOR_BYTES


def _check_stack(axis: str, z_stack: int, tenants: bool) -> None:
    if z_stack < 1 or (z_stack > 1 and axis == "z" and not tenants):
        raise ValueError(f"z_stack={z_stack}: a z-stack of resident blocks fills the x and y "
                         "axes only (tenants=True wraps each block's z onto itself)")


def _check_blocks(blocks: Sequence[torch.Tensor], spec: GridSpec, axis: str,
                  z_stack: int = 1, tenants: bool = False) -> None:
    p = spec.padded()
    o, n, rm, rp = axis_geom(spec, axis)
    if not 1 <= len(blocks) <= MAX_FILL_GROUP:
        raise ValueError(f"fill group of {len(blocks)} outside [1, {MAX_FILL_GROUP}]")
    if n < max(rm, rp):
        raise ValueError(f"{axis}-axis block size {n} < radius {max(rm, rp)}")
    _check_stack(axis, z_stack, tenants)
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


def self_fill(blocks: Sequence[torch.Tensor], spec: GridSpec, axis: str, z_stack: int = 1,
              tenants: bool = False):
    """Fill both periodic halos of ``axis`` in place for every block of a
    same-dtype group (at most :data:`MAX_FILL_GROUP`); with ``z_stack > 1``
    each tensor is a contiguous stack of that many resident blocks and
    ``axis`` is x or y, or (``tenants``) of that many independent tenants
    and ``axis`` any of the three. CPU tensors take
    :func:`self_fill_plain`; CUDA tensors launch ``csrc/self_fill.cu`` (one
    launch for the group) or raise."""
    _check_blocks(blocks, spec, axis, z_stack, tenants)
    dev = blocks[0].device
    if dev.type == "cpu":
        return self_fill_plain(blocks, spec, axis)
    if dev.type != "cuda":
        raise ValueError(f"self_fill runs on cuda or cpu tensors, not {dev}")
    addrs = [b.data_ptr() for b in blocks]
    align = min(min(a & -a for a in addrs), VECTOR_BYTES[0])
    lay = fill_layout(spec, axis, blocks[0].element_size(), z_stack, align, tenants)
    if not lay.runs:
        return list(blocks)
    runs = [v for run in lay.runs for v in run] + [0] * (3 * (2 - len(lay.runs)))
    rc = _native.lib("self_fill").self_fill_launch(
        (ctypes.c_void_p * len(blocks))(*addrs), len(blocks), blocks[0].element_size(),
        {"runs": 0, "rows": 1}[lay.body], (ctypes.c_longlong * 6)(*runs), lay.count,
        lay.stride, lay.vec, _native.stream_ptr(dev))
    _native.check(rc, f"self_fill[{axis}]")
    self_fill.launches += 1
    return list(blocks)


self_fill.launches = 0


def wrap_fill_tenants(spec: GridSpec, fields: Sequence[torch.Tensor]):
    """Periodic self-wrap fill of every tenant of same-dtype ``(B, pz, py,
    px)`` stacks, in place, in the composed x -> y -> z order: per axis one
    :func:`self_fill` launch (``tenants=True``) for each group of up to
    :data:`MAX_FILL_GROUP` stacks, so 8 Astaroth fields take 3 launches.
    The counterpart of the JAX package's ``wrap_fill_batched`` on a tenant
    stack; CPU stacks take the plain fill. Returns the stacks."""
    fields = list(fields)
    if not fields or fields[0].dim() != 4:
        raise ValueError("wrap_fill_tenants takes (B, pz, py, px) tenant stacks")
    b = fields[0].shape[0]
    for axis in AXIS_ORDER:
        for i in range(0, len(fields), MAX_FILL_GROUP):
            self_fill(fields[i:i + MAX_FILL_GROUP], spec, axis, z_stack=b, tenants=True)
    return fields


def wrap_fill_batched(spec: GridSpec, a: torch.Tensor) -> torch.Tensor:
    """Periodic self-wrap fill of every leading-dim block of ``a``
    (``(..., pz, py, px)``, e.g. a stack of independent single-block tenant
    states), in the composed x -> y -> z order; nothing crosses the leading
    axes. In place; returns ``a``. Plain PyTorch, the counterpart of the JAX
    package's ``wrap_fill_batched``."""
    for axis in AXIS_ORDER:
        self_fill_plain([a], spec, axis)
    return a
