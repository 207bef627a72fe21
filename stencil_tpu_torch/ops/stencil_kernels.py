"""The Jacobi sweep and multistep kernels, and their plain PyTorch versions.

The port's counterpart of ``stencil_tpu.ops.pallas_stencil``:

- :func:`sweep` launches ``csrc/jacobi_sweep.cu`` (replacing the TPU's
  ``make_pallas_jacobi_sweep``); :func:`sweep_plain` is the same step in
  plain PyTorch. :func:`sweep_region` launches the same kernel on one rect
  with every wrap flag off (the overlap shells of a multi-block partition);
  its plain version is ``ops.jacobi.jacobi_sweep``.
- :func:`multistep` launches ``csrc/jacobi_multistep.cu`` (replacing the
  TPU's ``make_pallas_jacobi_multistep`` and ``_make_multistep_row_tiled``,
  single-block and deep-halo forms): k steps in one launch, the
  intermediate stages kept in shared memory; :func:`multistep_plain` is k
  plain steps.
- :func:`sweep_tenants` launches the same sweep kernel over a campaign
  slot's ``(B, pz, py, px)`` stack of independent tenants, every axis
  wrapping onto each tenant (the TPU kernel's ``batch=`` form).
- :func:`plan_multistep_depth` is the port's own depth planner, bounded by
  the 227 KB of shared memory a Hopper block may use.

Tensors are stacks of padded blocks, ``(bz, by, bx, pz, py, px)`` with
every block of the partition resident on one device (a single-block domain
is the stack of one). Each kernel covers the whole stack in one launch.

A wrapper takes its plain version only for tensors on the CPU; on a CUDA
tensor it launches its kernel or raises. Each wrapper counts its launches
in ``<wrapper>.launches``.

Arithmetic, identical in kernels and plain versions: the six face
neighbours are summed left to right as ``x_lo + x_hi + y_lo + y_hi + z_lo +
z_hi`` and multiplied by 1/6 rounded to the field's type (:func:`sixth`:
:data:`SIXTH` for float32). That is what the JAX package computes bit for
bit: XLA folds its ``sum / 6`` into that multiply, in float32 and float64
alike (a true divide differs in about a third of all cells). PyTorch keeps
each op as written, on the CPU and on CUDA.

Fields are float32 or float64. The plain versions take both; the CUDA
kernels are float32, as the TPU kernels are, and a float64 field on the
card raises ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..domain.grid import GridSpec
from ..geometry import Dim3, Rect3
from . import _native

HOT_TEMP = 1.0
COLD_TEMP = 0.0
SIXTH = float(np.float32(1.0) / np.float32(6.0))
FIELD_DTYPES = (torch.float32, torch.float64)

# Mirrors csrc/jacobi_multistep.cu: output tile (x, and y at k <= KLO),
# the tile height at deeper k, the deepest k the kernel takes, stage-0
# planes copied ahead of use, and the shared memory one block may use on an
# H100 (232,448 bytes).
MULTISTEP_TILE = (64, 32)  # (x, y)
MULTISTEP_TILE_Y_HI = 16
MULTISTEP_KLO = 3
MULTISTEP_KMAX = 6
MULTISTEP_LOOK = 4
SMEM_LIMIT = 232448
# The deepest depth the planner picks: the fastest per step at 512^3, in
# both forms, whose instantiations do not spill. ptxas: k=3 takes 80
# registers (the cap of its 736-thread block) and k=4 96-109, without spill;
# at their 96-register cap k=5 spills up to 8 bytes and k=6 up to 56. Per
# step on an H100 80GB HBM3 at 700 W (apps/bench_kernels, PERF.md section 6)
# k=3 beats k=2, 4, 5 and 6, single-block and deep-halo.
MULTISTEP_KPLAN = 3
# the JAX package's depth cap (the k its multistep defaults to)
TEMPORAL_K_CAP = 12


def _region(spec: GridSpec):
    off = spec.compute_offset()
    b = spec.base
    return (..., slice(off.z, off.z + b.z), slice(off.y, off.y + b.y),
            slice(off.x, off.x + b.x))


def _neighbours(curr: torch.Tensor, spec: GridSpec, wrap):
    """``[x_lo, x_hi, y_lo, y_hi, z_lo, z_hi]`` of every compute cell: the
    periodic image within the compute region on a wrapping axis, the
    shifted read (halo included) on the others."""
    cs = _region(spec)
    c = curr[cs]
    out = []
    for dim, w in ((-1, wrap[2]), (-2, wrap[1]), (-3, wrap[0])):
        if w:
            out += [torch.roll(c, 1, dim), torch.roll(c, -1, dim)]
            continue
        for d in (-1, 1):
            sl = list(cs)
            s = sl[dim]
            sl[dim] = slice(s.start + d, s.stop + d)
            out.append(curr[tuple(sl)])
    return out


def sixth(dtype) -> float:
    """1/6 rounded to ``dtype`` (float32 or float64): the constant XLA
    multiplies by in place of the JAX package's ``sum / 6``."""
    return SIXTH if dtype == torch.float32 else 1.0 / 6.0


def _average(nb) -> torch.Tensor:
    s = nb[0] + nb[1]
    for t in nb[2:]:
        s = s + t
    return s * sixth(s.dtype)


def sweep_plain(curr, nxt, sel, spec: GridSpec, wrap=(True, True, True)):
    """One Jacobi step in plain PyTorch: writes the compute region of
    ``nxt`` (in place; returns it). ``sel`` is the int32 sphere code
    (0 stencil, 1 hot, 2 cold) in the same padded layout. ``wrap`` =
    ``(wz, wy, wx)`` marks the single-block axes whose periodic neighbour
    is taken from the opposite face instead of the halo."""
    cs = _region(spec)
    avg = _average(_neighbours(curr, spec, wrap))
    s = sel[cs]
    nxt[cs] = torch.where(s == 1, HOT_TEMP, torch.where(s == 2, COLD_TEMP, avg))
    return nxt


def sphere_masks_from_coords(spec: GridSpec, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hot, cold)`` bool masks over a single block's compute region from
    integer coordinates, as the multistep kernel derives them: hot centre
    ``(gx/3, gy/2, gz/2)``, cold ``(2gx/3, gy/2, gz/2)``, ``d2 < (gx/10+1)^2``,
    hot wins. Equal to the JAX package's ``sphere_masks``."""
    g = spec.global_size
    return _sphere_masks(g, torch.arange(g.z, device=device), torch.arange(g.y, device=device),
                         torch.arange(g.x, device=device))


def _sphere_masks(g: Dim3, z, y, x):
    """``(hot, cold)`` over the grid of global coordinates ``z x y x x`` (1-d
    int tensors, already wrapped into the global box)."""
    thresh = (g.x // 10 + 1) ** 2
    z, y, x = z.view(-1, 1, 1), y.view(1, -1, 1), x.view(1, 1, -1)
    yz = (y - g.y // 2) ** 2 + (z - g.z // 2) ** 2
    hot = (x - g.x // 3) ** 2 + yz < thresh
    cold = ~hot & ((x - g.x * 2 // 3) ** 2 + yz < thresh)
    return hot, cold


def multi_block_axes(spec: GridSpec) -> Tuple[bool, bool, bool]:
    """``(z, y, x)``: which axes the partition splits into several blocks
    (the deep-halo axes of the multistep; the others wrap onto themselves)."""
    return spec.dim.z > 1, spec.dim.y > 1, spec.dim.x > 1


def require_deep_halo(spec: GridSpec, k: int) -> None:
    """The deep-halo multistep's conditions, as the TPU's
    ``make_pallas_jacobi_multistep`` raises them:
    a uniform partition, radius >= k on both sides of every multi-block
    axis, and at least 2k + 1 planes per block."""
    if not spec.is_uniform():
        raise ValueError("deep-halo multistep requires a uniform partition")
    r = spec.radius
    for m, rl, rh in zip(multi_block_axes(spec), (r.z(-1), r.y(-1), r.x(-1)),
                         (r.z(1), r.y(1), r.x(1))):
        if m and (rl < k or rh < k):
            raise ValueError("deep-halo multistep needs radius >= k on multi-block axes")
    if spec.base.z < 2 * k + 1:
        raise ValueError("domain too shallow for this temporal depth")


def _multistep_block(c, spec: GridSpec, k: int, origin: Dim3):
    """k steps of one block's grown input ``c`` (z, y, x): grown by k cells
    on the multi-block axes, the compute region on the others, which wrap.
    Stage s covers extents grown by k - s; the spheres sit at the wrapped
    global coordinates. Returns the compute region after k steps."""
    g, b = spec.global_size, spec.base
    multi = multi_block_axes(spec)
    crop = tuple(slice(1, -1) if m else slice(None) for m in multi)
    for s in range(1, k + 1):
        e = k - s
        nb = []
        for ax in (2, 1, 0):  # x, y, z: the neighbours' summation order
            if not multi[ax]:
                inner = c[crop]
                nb += [torch.roll(inner, 1, ax), torch.roll(inner, -1, ax)]
                continue
            for lo in (0, 2):
                sl = list(crop)
                sl[ax] = slice(lo, c.shape[ax] - 2 + lo)
                nb.append(c[tuple(sl)])
        coords = [torch.remainder(torch.arange(-e * m, n + e * m, device=c.device) + o, gg)
                  for m, n, o, gg in zip(multi, (b.z, b.y, b.x), (origin.z, origin.y, origin.x),
                                         (g.z, g.y, g.x))]
        hot, cold = _sphere_masks(g, *coords)
        c = torch.where(hot, HOT_TEMP, torch.where(cold, COLD_TEMP, _average(nb)))
    return c


def multistep_plain(curr, nxt, spec: GridSpec, k: int):
    """``k`` Jacobi steps in plain PyTorch, spheres from coordinates; writes
    the compute region of every block of ``nxt`` (in place; returns it).
    Single-block axes wrap. On a multi-block partition (the deep-halo form)
    ``curr``'s halos hold the neighbours' cells at radius >= k, and each
    block runs k sweeps over shrinking grown extents at its own global
    origin (block index x block size)."""
    multi = multi_block_axes(spec)
    if any(multi):
        require_deep_halo(spec, k)
    off, b, d = spec.compute_offset(), spec.base, spec.dim
    grown = tuple(slice(o - k * m, o + n + k * m)
                  for m, o, n in zip(multi, (off.z, off.y, off.x), (b.z, b.y, b.x)))
    cs = _region(spec)[1:]
    c6, n6 = curr.view(spec.stacked_shape_zyx()), nxt.view(spec.stacked_shape_zyx())
    for iz in range(d.z):
        for iy in range(d.y):
            for ix in range(d.x):
                n6[(iz, iy, ix, *cs)] = _multistep_block(
                    c6[(iz, iy, ix, *grown)], spec, k, Dim3(ix * b.x, iy * b.y, iz * b.z))
    return nxt


def multistep_shape(k: int) -> dict:
    """The multistep kernel's launch shape at depth ``k`` (``Shape<K>`` in
    ``csrc/jacobi_multistep.cu``): the output tile (``tile``: x, y); a
    thread owns a 4-cell x run of a row of the tile grown by k (``rows``);
    a row holds ``runs`` runs, enough for the widest tile (the first of a
    row is up to 3 columns wider) at any 16-byte phase of its first cell;
    shared memory holds a guard row, a stage-0 ring of ``LOOK + 2`` planes,
    two planes for each of stages 1..k-1 and a guard row."""
    tx = MULTISTEP_TILE[0]
    ty = MULTISTEP_TILE[1] if k <= MULTISTEP_KLO else MULTISTEP_TILE_Y_HI
    rows = ty + 2 * k
    runs = -(-(3 + tx + 3 + 2 * k) // 4)
    pitch = 4 * runs
    planes = MULTISTEP_LOOK + 2 + 2 * (k - 1)
    return {"tile": (tx, ty), "rows": rows, "runs": runs, "pitch": pitch, "planes": planes,
            "threads": -(-(rows * runs) // 32) * 32,
            "smem_bytes": 4 * (planes * rows * pitch + 2 * pitch)}


def multistep_stage_updates(spec: GridSpec, k: int) -> int:
    """Cell updates one depth-``k`` launch makes over ``spec``'s blocks
    with the kernel's tiles, ghost zones included: stage s covers each tile
    grown by k - s cells in x and y, over the block's planes grown by k - s
    in z. Each update is 7 fp32 operations (6 adds and a multiply,
    unfused)."""
    tx, ty = multistep_shape(k)["tile"]
    b = spec.base
    tiles = -(-b.x // tx) * -(-b.y // ty) * spec.num_blocks()
    return tiles * sum((tx + 2 * g) * (ty + 2 * g) * (b.z + 2 * g) for g in range(k))


def multistep_smem_bytes(k: int) -> int:
    """Shared memory of one multistep block at depth ``k`` (the kernel
    exports the same formula as ``jacobi_multistep_smem_bytes``)."""
    return multistep_shape(k)["smem_bytes"]


def plan_multistep_depth(k_want: int) -> int:
    """The deepest k <= ``k_want`` up to ``MULTISTEP_KPLAN``. Every depth
    the kernel takes fits one block's shared memory (``SMEM_LIMIT``); speed
    per step is what binds. Unlike the TPU planner it does not depend on the
    plane size: the kernel tiles x and y, so 512^3 and 768^3 get the same
    depth."""
    return max(0, min(k_want, MULTISTEP_KPLAN))


def _check_block(t: torch.Tensor, spec: GridSpec, dtype, what: str,
                 stack: Optional[int] = None) -> None:
    """``t`` holds every block of ``spec``'s partition, contiguous; with
    ``stack``, it is a ``(stack, pz, py, px)`` stack of one-block tenants."""
    p = spec.padded()
    nb = spec.num_blocks() if stack is None else stack
    if t.dtype != dtype:
        raise ValueError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if (tuple(t.shape[-3:]) != (p.z, p.y, p.x) or t.numel() != nb * p.z * p.y * p.x
            or (stack is not None and t.dim() != 4)):
        raise ValueError(f"{what}: shape {tuple(t.shape)} is not {nb} padded "
                         f"({p.z}, {p.y}, {p.x}) block(s)")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


def _check_fields(spec: GridSpec, curr, nxt, sel=None, stack: Optional[int] = None) -> None:
    """curr and nxt: blocks (or a ``stack`` of tenants) of ``spec`` in one
    float type, float32 or float64; sel, where given: the same in int32."""
    if curr.dtype not in FIELD_DTYPES:
        raise ValueError(f"curr: dtype {curr.dtype}, expected float32 or float64")
    _check_block(curr, spec, curr.dtype, "curr", stack)
    _check_block(nxt, spec, curr.dtype, "nxt", stack)
    if sel is not None:
        _check_block(sel, spec, torch.int32, "sel", stack)


def _device_of(*ts) -> torch.device:
    """The operands' one device; ``ts[0]`` and ``ts[1]`` are curr and nxt.
    A float64 field on the card raises: the kernels are float32."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("operands on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"kernels run on cuda or cpu tensors, not {dev}")
    if ts[0].data_ptr() == ts[1].data_ptr():
        raise ValueError("curr and nxt must be distinct buffers")
    if dev.type == "cuda" and ts[0].dtype != torch.float32:
        raise NotImplementedError(
            f"{ts[0].dtype} fields on CUDA: the Jacobi kernels are float32, as the TPU "
            "kernels are (a float64 instantiation is queued in ROADMAP.md); pass "
            "device='cpu' for the plain versions")
    return dev


def _launch_sweep(curr, nxt, sel, spec: GridSpec, dev, lo: Dim3, n: Dim3, wrap,
                  nblocks: int) -> None:
    p = spec.padded()
    rc = _native.lib("jacobi_sweep").jacobi_sweep_launch(
        curr.data_ptr(), nxt.data_ptr(), sel.data_ptr(), p.y * p.x, p.x,
        p.z * p.y * p.x, nblocks, lo.z, lo.y, lo.x, n.z, n.y, n.x,
        int(wrap[0]), int(wrap[1]), int(wrap[2]), dev.index, _native.stream_ptr(dev))
    _native.check(rc, "jacobi_sweep")


def sweep(curr, nxt, sel, spec: GridSpec, wrap=(True, True, True)):
    """One Jacobi step of every block: ``nxt``'s compute regions <- the
    6-neighbour average of ``curr`` with the ``sel`` spheres imposed (in
    place; returns ``nxt``). See :func:`sweep_plain` for the arguments."""
    _check_fields(spec, curr, nxt, sel)
    dev = _device_of(curr, nxt, sel)
    if dev.type == "cpu":
        return sweep_plain(curr, nxt, sel, spec, wrap)
    _launch_sweep(curr, nxt, sel, spec, dev, spec.compute_offset(), spec.base, wrap,
                  spec.num_blocks())
    sweep.launches += 1
    return nxt


sweep.launches = 0


def sweep_tenants(curr, nxt, sel, spec: GridSpec):
    """One Jacobi step of every tenant of a campaign slot: ``curr``, ``nxt``
    and ``sel`` are ``(B, pz, py, px)`` stacks of B independent tenants, each
    a single block of the one-block ``spec``; every axis of every tenant
    wraps onto the tenant itself and nothing crosses the tenant axis.
    ``nxt``'s compute regions <- the step (in place; returns ``nxt``). CPU
    tensors take :func:`sweep_plain` over the stack; CUDA tensors launch
    ``csrc/jacobi_sweep.cu`` once for all B tenants, or raise."""
    if spec.dim != Dim3(1, 1, 1):
        raise ValueError(f"tenants are single-block domains; got partition {spec.dim}")
    nb = curr.shape[0] if curr.dim() == 4 else 0
    if nb < 1:
        raise ValueError(f"curr: shape {tuple(curr.shape)} is not a stack of tenants")
    _check_fields(spec, curr, nxt, sel, nb)
    dev = _device_of(curr, nxt, sel)
    if dev.type == "cpu":
        return sweep_plain(curr, nxt, sel, spec)
    _launch_sweep(curr, nxt, sel, spec, dev, spec.compute_offset(), spec.base, (True,) * 3, nb)
    sweep_tenants.launches += 1
    return nxt


sweep_tenants.launches = 0


def sweep_region(curr, nxt, sel, spec: GridSpec, rect: Rect3):
    """One Jacobi step over ``rect`` (allocation-local, inside the compute
    region) of every block, reading every neighbour in place, halos
    included (in place; returns ``nxt``). CPU tensors take the plain
    region sweep ``ops.jacobi.jacobi_sweep`` with masks ``(sel == 1,
    sel == 2)``; CUDA tensors launch ``csrc/jacobi_sweep.cu`` on the rect
    with its wrap flags off, or raise."""
    _check_fields(spec, curr, nxt, sel)
    off = spec.compute_offset()
    hi = off + spec.base
    if not (off.x <= rect.lo.x < rect.hi.x <= hi.x and off.y <= rect.lo.y < rect.hi.y <= hi.y
            and off.z <= rect.lo.z < rect.hi.z <= hi.z):
        raise ValueError(f"sweep_region: {rect} is empty or outside the compute region")
    dev = _device_of(curr, nxt, sel)
    if dev.type == "cpu":
        # imported here: ops.jacobi imports this module
        from .jacobi import jacobi_sweep

        return jacobi_sweep(curr, nxt, rect, (sel == 1, sel == 2))
    _launch_sweep(curr, nxt, sel, spec, dev, rect.lo, rect.hi - rect.lo, (False,) * 3,
                  spec.num_blocks())
    sweep_region.launches += 1
    return nxt


sweep_region.launches = 0


def multistep_zchunks(spec: GridSpec, k: int, blocks_in_flight: int) -> int:
    """z chunks per tile column: the count whose launch the device
    finishes soonest, in plane steps (a chunk of c planes takes c + 2k
    steps, its 2k warm-up included), with ``blocks_in_flight`` (the SMs
    times the multistep blocks an SM holds) running at once: every block's
    steps shared evenly over them, plus one block's steps for the last to
    finish; the fewest chunks on a tie. No chunk is shorter than 4k
    planes."""
    tx, ty = multistep_shape(k)["tile"]
    b = spec.base
    tiles = -(-b.x // tx) * -(-b.y // ty) * spec.num_blocks()
    slots = max(1, blocks_in_flight)

    def steps(n):
        per_block = -(-b.z // n) + 2 * k
        return tiles * n * per_block / slots + per_block

    return min(range(1, max(1, b.z // max(4 * k, 1)) + 1), key=lambda n: (steps(n), n))


def multistep_blocks_in_flight(dev: torch.device, k: int) -> int:
    """SMs x resident multistep blocks per SM at depth ``k`` on ``dev``."""
    return _blocks_in_flight(dev.index, k)


def multistep_info(index: int, k: int, multi_block: bool = False) -> dict:
    """What the depth-``k`` instantiation (``multi_block``: the deep-halo
    one) reports on CUDA device ``index``: resident blocks per SM,
    registers and local (spill) bytes per thread, threads and dynamic
    shared memory per block."""
    r = (ctypes.c_int * 5)()
    _native.check(_native.lib("jacobi_multistep").jacobi_multistep_info(
        k, int(multi_block), index, r), "jacobi_multistep_info")
    return dict(zip(("blocks_per_sm", "regs", "local_bytes", "threads", "smem_bytes"), r))


@functools.lru_cache(maxsize=None)
def _blocks_in_flight(index: int, k: int) -> int:
    per_sm = multistep_info(index, k, multi_block=True)["blocks_per_sm"]
    return torch.cuda.get_device_properties(index).multi_processor_count * max(1, per_sm)


def multistep(curr, nxt, spec: GridSpec, k: int):
    """``k`` Jacobi steps of every block in one launch: ``nxt``'s compute
    regions <- the field after k steps (in place; returns ``nxt``). The
    spheres are the standard jacobi3d spheres, derived from coordinates.
    On a multi-block partition this is the deep-halo form: ``curr``'s
    halos must hold the neighbours' cells at radius >= k (see
    :func:`require_deep_halo`)."""
    _check_fields(spec, curr, nxt)
    if not 1 <= k <= min(MULTISTEP_KMAX, spec.base.z):
        raise ValueError(f"multistep depth {k} outside [1, {MULTISTEP_KMAX}] "
                         f"or deeper than the {spec.base.z} planes")
    if spec.dim.flatten() > 1:
        require_deep_halo(spec, k)
    dev = _device_of(curr, nxt)
    if dev.type == "cpu":
        return multistep_plain(curr, nxt, spec, k)
    p, off, b, g, d = (spec.padded(), spec.compute_offset(), spec.base, spec.global_size,
                       spec.dim)
    rc = _native.lib("jacobi_multistep").jacobi_multistep_launch(
        curr.data_ptr(), nxt.data_ptr(), p.y * p.x, p.x, p.z * p.y * p.x,
        off.z, off.y, off.x, b.z, b.y, b.x, d.z, d.y, d.x, k, g.x, g.y, g.z,
        multistep_zchunks(spec, k, multistep_blocks_in_flight(dev, k)), dev.index,
        _native.stream_ptr(dev))
    _native.check(rc, "jacobi_multistep")
    multistep.launches += 1
    return nxt


multistep.launches = 0
