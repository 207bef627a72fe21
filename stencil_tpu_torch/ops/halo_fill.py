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
compression and its fp8 tier) is owned here too: :func:`wire_narrow_dtype`
is the policy (only a floating carrier narrows, only to a strictly narrower
floating wire; never an integer quantity, never a bitcast), :func:`wire_round`
the plain version of a crossing word's narrow-then-widen, and
:data:`WIRE_CODES` the codes the exchange kernels take
(``csrc/wire_round.cuh``). The self-wrap fill never narrows: it copies inside
one position.
"""

from __future__ import annotations

import ctypes
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


# the wire dtypes the kernels narrow through, by their code in
# csrc/wire_round.cuh (0 is no narrowing); float32 narrows fp64 data only
WIRE_CODES = {"bfloat16": 1, "float16": 2, "float8_e4m3fn": 3, "float32": 4}

# (mantissa bits, least normal exponent, largest finite value, overflow to
# +-inf or else to NaN) of the wires rounded by hand: once, from fp64
_ROUNDED = {"float16": (10, -14, 65504.0, True), "float8_e4m3fn": (3, -6, 448.0, False)}


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
    """The canonical name of a wire dtype (a torch dtype or its name), or
    None for no wire (``None`` or ""). A floating wire the kernels cannot
    round through raises ``NotImplementedError``; a non-floating one is a
    no-op, as in the JAX package (nothing narrows to it)."""
    if wire is None or wire == "":
        return None
    dt = _torch_dtype(wire)
    name = _dtype_name(dt)
    if dt.is_floating_point and name not in WIRE_CODES and dt != torch.float64:
        raise NotImplementedError(
            f"wire_dtype {name}: the port narrows through {', '.join(WIRE_CODES)} only "
            "(other wire dtypes are ROADMAP.md queue B)")
    return name


def wire_narrow_dtype(native, wire) -> Optional[torch.dtype]:
    """The dtype a wire-crossing carrier of ``native`` data travels as, or
    None when it stays native (the JAX package's ``wire_narrow_dtype``):
    both floating, and the wire strictly narrower than the data."""
    name = wire_name(wire)
    if name is None:
        return None
    native, w = _torch_dtype(native), _torch_dtype(name)
    if not (native.is_floating_point and w.is_floating_point):
        return None
    if w.itemsize >= native.itemsize:
        return None
    return w


def wire_code(native, wire) -> int:
    """The kernels' code of ``wire`` for ``native`` data (0: no narrowing)."""
    w = wire_narrow_dtype(native, wire)
    return 0 if w is None else WIRE_CODES[_dtype_name(w)]


def _round_once(t: torch.Tensor, fmt) -> torch.Tensor:
    """``t`` rounded to nearest even into a format of ``fmt``
    (:data:`_ROUNDED`) and widened back, in one rounding from fp64 (exact
    for fp32 and fp64 data): the quantum of ``|x|``'s binade, or the
    subnormal quantum below the least normal; overflow past the largest
    finite value to +-inf or to NaN, as the JAX package's ``astype``."""
    mant, emin, top, to_inf = fmt
    x = t.to(torch.float64)
    _m, e = torch.frexp(x)  # |x| = m 2^e, m in [0.5, 1)
    q = torch.ldexp(torch.ones_like(x), (e - 1 - mant).clamp(min=emin - mant))
    r = torch.round(x / q) * q  # half to even
    bad = torch.full_like(r, math.nan)
    over = torch.copysign(torch.full_like(r, math.inf), r) if to_inf else bad
    r = torch.where(r.abs() > top, over, r)
    r = torch.where(torch.isfinite(x), r, x if to_inf else bad)
    return r.to(t.dtype)


def wire_round(t: torch.Tensor, wire) -> torch.Tensor:
    """Plain version of a crossing word's trip over the wire: ``t`` narrowed
    to ``wire`` and widened back (``t`` itself when it does not narrow),
    equal to the JAX package's ``x.astype(wire).astype(x.dtype)`` except
    that IEEE subnormals are kept. fp32 wires (fp64 data) and bf16 wires
    round through torch's ``.to``, bf16 from fp64 through fp32 (twice, as
    the JAX package does); fp16 and fp8 (e4m3fn: overflow is NaN, not
    saturation) round once from fp64 by hand, since torch rounds fp64
    through fp32 and saturates fp8."""
    w = wire_narrow_dtype(t.dtype, wire)
    if w is None:
        return t
    name = _dtype_name(w)
    if name in _ROUNDED:
        return _round_once(t, _ROUNDED[name])
    if w == torch.bfloat16:
        return t.to(torch.float32).to(w).to(t.dtype)
    return t.to(w).to(t.dtype)


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
