"""The Jacobi sweep and multistep kernels, and their plain PyTorch versions.

The port's counterpart of ``stencil_tpu.ops.pallas_stencil``:

- :func:`sweep` launches ``csrc/jacobi_sweep.cu`` (replacing the TPU's
  ``make_pallas_jacobi_sweep``); :func:`sweep_plain` is the same step in
  plain PyTorch. The kernel takes a table of sweep tasks (a rect of a
  block or a stack of blocks, its wrap flags and its sel planes,
  :func:`sweep_table`), so one launch serves every form:
  :func:`sweep_region` (one rect of every block, wrap off: an overlap
  shell; plain version :func:`region_plain`), :func:`sweep_tenants` (a
  campaign slot's ``(B, pz, py, px)`` stack of independent tenants, every
  axis wrapping onto each tenant: the TPU kernel's ``batch=`` form),
  :func:`sweep_positions` (every position of a mesh) and
  :func:`sweep_regions` (every shell of every block or position of a
  step). ``sel`` may be read on a range of planes only
  (:func:`sel_z_range`, :func:`block_sel_range`: the TPU kernel's
  ``sel_z_range``); the plain versions take the same range.
- :func:`multistep` launches ``csrc/jacobi_multistep.cu`` (replacing the
  TPU's ``make_pallas_jacobi_multistep`` and ``_make_multistep_row_tiled``,
  single-block and deep-halo forms): k steps in one launch, the
  intermediate stages kept in shared memory; :func:`multistep_plain` is k
  plain steps. :func:`multistep_positions` is the deep-halo form over the
  separate blocks of a mesh's positions, each at its own global origin, in
  one launch (a table of entries); its plain version
  :func:`multistep_positions_plain`.
- :func:`plan_multistep_depth` is the port's own depth planner, bounded by
  the 227 KB of shared memory a Hopper block may use.

Tensors are stacks of padded blocks, ``(bz, by, bx, pz, py, px)`` with
every block of the partition resident on one device (a single-block domain
is the stack of one), or lists of one padded block a mesh position. Each
kernel covers the whole stack, or every listed position, in one launch.

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

Fields are float32 or float64, and so are the kernels: each CUDA kernel is
instantiated for both element types (the TPU kernels are float32 only; the
JAX package steps float64 on XLA). A thread's run is 16 bytes in either
type, 4 float32 or 2 float64 cells, so the launch shapes below take the
element size (``item``, 4 or 8 bytes) and an fp64 tile is as many bytes as
the fp32 one, half as many cells. ``sel`` stays int32 in both.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..domain.grid import GridSpec
from ..geometry import Dim3, Rect3
from . import _native

HOT_TEMP = 1.0
COLD_TEMP = 0.0
SIXTH = float(np.float32(1.0) / np.float32(6.0))
FIELD_DTYPES = (torch.float32, torch.float64)

# Mirrors csrc/jacobi_multistep.cu: output tile (x in fp32 cells, 256
# bytes; and y at k <= KLO), the tile height at deeper k, the deepest k the
# kernel takes, stage-0 planes copied ahead of use, and the shared memory
# one block may use on an H100 (232,448 bytes).
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


def sweep_plain(curr, nxt, sel, spec: GridSpec, wrap=(True, True, True), sel_range=None):
    """One Jacobi step in plain PyTorch: writes the compute region of
    ``nxt`` (in place; returns it). ``sel`` is the int32 sphere code
    (0 stencil, 1 hot, 2 cold) in the same padded layout. ``wrap`` =
    ``(wz, wy, wx)`` marks the single-block axes whose periodic neighbour
    is taken from the opposite face instead of the halo. ``sel_range``:
    the allocation-local planes ``[lo, hi)`` on which ``sel`` is imposed
    (the TPU kernel's ``sel_z_range``; :func:`sel_z_range`), one pair for
    every block or one pair a block; None imposes it on every plane."""
    cs = _region(spec)
    avg = _average(_neighbours(curr, spec, wrap))
    s = _ranged_sel(sel, spec, sel_range)[cs]
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


def block_origin(spec: GridSpec, pos) -> Dim3:
    """The global origin of block ``pos`` (ix, iy, iz) of a uniform
    partition: block index x block size, as ``lax.axis_index`` gives the
    TPU kernel on a device of the mesh."""
    b = spec.base
    return Dim3(pos[0] * b.x, pos[1] * b.y, pos[2] * b.z)


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


def run_cells(item: int) -> int:
    """Cells of a 16-byte run of ``item``-byte cells: 4 in float32, 2 in
    float64."""
    if item not in (4, 8):
        raise ValueError(f"cells of {item} bytes: the kernels take float32 or float64")
    return 16 // item


def multistep_shape(k: int, item: int = 4) -> dict:
    """The multistep kernel's launch shape at depth ``k`` for ``item``-byte
    cells (``Shape<K, T>`` in ``csrc/jacobi_multistep.cu``): the output tile
    (``tile``: x, y; x 256 bytes of cells); a thread owns a C-cell x run
    (16 bytes, :func:`run_cells`) of a row of the tile grown by k
    (``rows``); a row holds ``runs`` runs, enough for the widest tile (the
    first of a row is up to C - 1 columns wider) at any 16-byte phase of its
    first cell; shared memory holds a guard row, a stage-0 ring of ``LOOK +
    2`` planes, two planes for each of stages 1..k-1 and a guard row. Deeper
    than ``MULTISTEP_KLO`` an fp64 tile is half as high (its windows take
    twice the registers a cell)."""
    c = run_cells(item)
    tx = MULTISTEP_TILE[0] * 4 // item
    ty = MULTISTEP_TILE[1] if k <= MULTISTEP_KLO else MULTISTEP_TILE_Y_HI * 4 // item
    rows = ty + 2 * k
    runs = -(-(2 * (c - 1) + tx + 2 * k) // c)
    pitch = c * runs
    planes = MULTISTEP_LOOK + 2 + 2 * (k - 1)
    return {"tile": (tx, ty), "rows": rows, "runs": runs, "pitch": pitch, "planes": planes,
            "threads": -(-(rows * runs) // 32) * 32,
            "smem_bytes": item * (planes * rows * pitch + 2 * pitch)}


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


def multistep_smem_bytes(k: int, item: int = 4) -> int:
    """Shared memory of one multistep block at depth ``k`` for ``item``-byte
    cells (the kernel exports the same formula as
    ``jacobi_multistep_smem_bytes``)."""
    return multistep_shape(k, item)["smem_bytes"]


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
    The kernels take the fields' element type (float32 or float64, checked
    by :func:`_check_fields`) from ``ts[0]``."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("operands on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"kernels run on cuda or cpu tensors, not {dev}")
    if ts[0].data_ptr() == ts[1].data_ptr():
        raise ValueError("curr and nxt must be distinct buffers")
    return dev


# The sweep kernel's launch (csrc/sweep_runs.cuh: TX, TY, LOOK, PLANE, NT,
# B1_SMEM; csrc/jacobi_sweep.cu: MIN_BLOCKS, TASK_COLS and the task row's
# fields), in fp32 cells; an fp64 launch keeps the bytes (:func:`sweep_plane`).
SWEEP_TILE = (128, 8)
SWEEP_LOOK = 4
SWEEP_MIN_BLOCKS = 2
SWEEP_PLANE = 1360  # floats of one ring plane: a tile's (ty + 2) rows of 4 * runs
SWEEP_THREADS = 352
# a guard row, the ring of LOOK + 2 planes, a guard row, two patch cells per
# row (at most PLANE / 12) and ring slot
SWEEP_SMEM = 4 * ((SWEEP_LOOK + 2) * (SWEEP_PLANE + 2 * (SWEEP_PLANE // 12))
                  + 2 * 4 * ((SWEEP_TILE[0] + 11) // 4))
SWEEP_TASK_FIELDS = ("curr", "out", "sel", "stride", "count", "start", "zo", "yo", "xo", "nz",
                     "ny", "nx", "wrap", "slo", "shi", "tx", "ty", "gx", "gy", "zchunk", "nzc")
SWEEP_TASK_COLS = len(SWEEP_TASK_FIELDS)


def sel_z_range(spec: GridSpec) -> Tuple[int, int]:
    """The allocation-local ``[lo, hi)`` planes that may hold sphere cells
    in any block of ``spec`` (the union over the z blocks), ``(0, 0)`` when
    none does: the spheres span global z in ``[zc - R, zc + R]``,
    ``zc = gz // 2``, ``R = gx // 10``. The port's copy of the JAX package's
    ``pallas_stencil.sel_z_range``, which its Pallas sweep skips ``sel``
    outside of."""
    lo, hi = spec.padded().z, 0
    for iz in range(spec.dim.z):
        blo, bhi = block_sel_range(spec, iz)
        if blo < bhi:
            lo, hi = min(lo, blo), max(hi, bhi)
    return (lo, hi) if lo < hi else (0, 0)


def block_sel_range(spec: GridSpec, iz: int) -> Tuple[int, int]:
    """The allocation-local ``[lo, hi)`` planes of z block ``iz`` that may
    hold sphere cells, ``(0, 0)`` for none: the tightest range, within
    :func:`sel_z_range`."""
    g = spec.global_size
    zc, r = g.z // 2, g.x // 10
    o, s = sum(spec.sizes_z[:iz]), spec.sizes_z[iz]
    blo, bhi = max(zc - r - o, 0), min(zc + r + 1 - o, s)
    if blo >= bhi:
        return (0, 0)
    zo = spec.compute_offset().z
    return (zo + blo, zo + bhi)


def block_sel_ranges(spec: GridSpec) -> list:
    """:func:`block_sel_range` of every block of ``spec``, in the stacked
    order (z slowest)."""
    d = spec.dim
    return [block_sel_range(spec, iz) for iz in range(d.z) for _ in range(d.y * d.x)]


def _block_ranges(sel_range, nblocks: int) -> Optional[list]:
    """``sel_range`` as one ``(lo, hi)`` a block, or None for every plane:
    None, one pair for every block, or one pair a block."""
    if sel_range is None:
        return None
    if len(sel_range) == 2 and all(isinstance(v, (int, np.integer)) for v in sel_range):
        return [tuple(int(v) for v in sel_range)] * nblocks
    if len(sel_range) != nblocks:
        raise ValueError(f"{len(sel_range)} sel ranges for {nblocks} blocks")
    return [tuple(int(v) for v in r) for r in sel_range]


def _ranged_sel(sel: torch.Tensor, spec: GridSpec, sel_range) -> torch.Tensor:
    """``sel`` with the planes outside each block's sel range zeroed (a
    copy), or ``sel`` itself for every plane: what the kernel imposes."""
    p = spec.padded()
    nb = sel.numel() // (p.z * p.y * p.x)
    ranges = _block_ranges(sel_range, nb)
    if ranges is None:
        return sel
    s = sel.clone()
    v = s.view(nb, p.z, p.y, p.x)
    for b, (lo, hi) in enumerate(ranges):
        v[b, :max(0, lo)] = 0
        v[b, max(lo, hi, 0):] = 0
    return s


def sweep_plane(item: int = 4) -> int:
    """Elements of one ring plane for ``item``-byte cells: the bytes of
    ``SWEEP_PLANE`` floats (``Elem<T>::PLANE_T`` in csrc/sweep_runs.cuh)."""
    return SWEEP_PLANE * 4 // item


def sweep_runs(tx: int, item: int = 4) -> int:
    """16-byte runs of a ring row for a ``tx``-wide tile of ``item``-byte
    cells: ``(tx + 3C - 1) // C``, C cells a run (:func:`run_cells`)."""
    c = run_cells(item)
    return (tx + 3 * c - 1) // c


def sweep_tile(nx: int, ny: int, xo: int, item: int = 4) -> Tuple[int, int]:
    """The tile ``(tx, ty)`` B1 sweeps an ``nx`` x ``ny`` rect at padded x
    ``xo`` with, for ``item``-byte cells: of the widths ``tx`` (a multiple
    of C, the cells of a 16-byte run) whose grown tile, ``ty + 2`` rows of
    :func:`sweep_runs` runs, fills at most a ring plane (:func:`sweep_plane`
    elements) with ``ty >= 1``, one with the fewest tiles a plane
    (``sweep_tiles_x`` x ``ceil(ny / ty)``); on a tie the widest up to
    ``SWEEP_TILE``'s 128 fp32 cells (B8's measured tile; 64 fp64 cells, the
    same bytes), else the narrowest. In fp32 128 x 8 on a wide rect; a
    171-wide block takes 56 x 19, a 1-cell x shell 4 x 111, a 1-row y shell
    256 x 3, a 32^3 tenant 32 x 32. In fp64 64 x 8 on a wide rect."""
    c = run_cells(item)
    plane, cap = sweep_plane(item), SWEEP_TILE[0] * 4 // item
    best = None
    tx = c
    while True:
        ty = plane // (c * sweep_runs(tx, item)) - 2
        if ty < 1:
            break
        wide = tx > cap
        key = (sweep_tiles_x(nx, xo, tx, item) * -(-ny // ty), wide, tx if wide else -tx)
        if best is None or key < best[0]:
            best = (key, (tx, ty))
        tx += c
    return best[1]


def sweep_tiles_x(nx: int, xo: int, tx: int, item: int = 4) -> int:
    """Tiles along x of an ``nx``-wide rect at padded x ``xo``, ``tx``
    wide (``tiles_x`` in ``csrc/sweep_runs.cuh``): tile 0 spans
    ``[0, tx + a)``, tile t ``[t tx + a, (t + 1) tx + a)``, ``a = -xo mod
    C`` (C cells of ``item`` bytes a 16-byte run)."""
    return max(1, (nx - (-xo % run_cells(item)) + tx - 1) // tx)


# The most planes a z chunk of a sweep task takes: at 512^3, one-wave
# launches of 512-plane chunks ran slower than two-chunk ones (one block,
# the 6 uneven positions; timed by forcing the chunk on an H100, PERF.md)
SWEEP_CHUNK_MAX = 256


def sweep_chunk(work, blocks: int) -> int:
    """Output planes per z chunk of a launch over ``work``, one ``(cols,
    nz)`` a task (its tile columns over all its blocks, its planes), walked
    by ``blocks`` resident blocks: of the chunks ``c = ceil(max nz / n)``
    from ``SWEEP_CHUNK_MAX`` planes down to 4 (or the deepest task's planes
    when fewer), the one whose walk ends soonest (B8's rule,
    ``fused_jacobi.cu``'s ``zchunks_for``): ``ceil(tiles / blocks)`` rounds
    of ``c + 2`` plane steps (a chunk and its warm-up), a task's tiles
    counted with chunks of ``min(c, nz)``; the fewest chunks on a tie."""
    top = max(nz for _, nz in work)
    slots = max(1, blocks)

    def cost(n):
        c = -(-top // n)
        tiles = sum(cols * -(-nz // min(c, nz)) for cols, nz in work)
        return -(-tiles // slots) * (c + 2)

    lo = -(-top // SWEEP_CHUNK_MAX)
    n = min(range(lo, max(lo, top // 4) + 1), key=lambda n: (cost(n), n))
    return -(-top // n)


class SweepTask(NamedTuple):
    """One task of B1's table before its tiles are laid out: ``count``
    blocks ``stride`` elements apart from the pointers ``curr``, ``out``
    and ``sel`` (``data_ptr`` values); the rect ``lo`` (z, y, x, in the
    padded block) of ``n`` (z, y, x) cells; ``wrap`` (z, y, x); ``sel``
    imposed on the allocation-local planes ``[slo, shi)``."""

    curr: int
    out: int
    sel: int
    stride: int
    count: int
    lo: Tuple[int, int, int]
    n: Tuple[int, int, int]
    wrap: Tuple[bool, bool, bool]
    slo: int
    shi: int


def sweep_table(tasks, blocks: int, item: int = 4) -> Tuple[tuple, int]:
    """``(rows, tiles)``: the kernel's task table for ``item``-byte cells,
    one row of ``SWEEP_TASK_FIELDS`` a task (its tile shape by
    :func:`sweep_tile`, its z chunks by :func:`sweep_chunk` over every task,
    its sel planes rect-relative and clipped, none when empty, the tiles of
    the rows before it), and the tiles in all."""
    shapes = [sweep_tile(t.n[2], t.n[1], t.lo[2], item) for t in tasks]
    cols = [sweep_tiles_x(t.n[2], t.lo[2], tx, item) * -(-t.n[1] // ty)
            for t, (tx, ty) in zip(tasks, shapes)]
    chunk = sweep_chunk([(c * t.count, t.n[0]) for t, c in zip(tasks, cols)], blocks)
    rows, start = [], 0
    for t, (tx, ty), c in zip(tasks, shapes, cols):
        nz, gy = t.n[0], -(-t.n[1] // ty)
        zchunk = min(chunk, nz)
        nzc = -(-nz // zchunk)
        slo = min(max(t.slo - t.lo[0], 0), nz)
        shi = min(max(t.shi - t.lo[0], 0), nz)
        if slo >= shi:
            slo = shi = 0
        wrap = int(t.wrap[2]) | int(t.wrap[1]) << 1 | int(t.wrap[0]) << 2
        rows.append((t.curr, t.out, t.sel, t.stride, t.count, start, *t.lo, *t.n, wrap, slo, shi,
                     tx, ty, c // gy, gy, zchunk, nzc))
        start += t.count * c * nzc
    return tuple(rows), start


def sweep_bytes(spec: GridSpec, rects, sel_range=None, blocks: Optional[int] = None,
                item: int = 4) -> Tuple[int, int]:
    """``(every plane, sel planes)``: the least bytes one sweep of ``rects``
    (allocation-local) of each of ``blocks`` blocks of ``spec`` (default
    all of its partition's) moves for ``item``-byte cells: curr read and out
    written once a cell, and the int32 sel read once a cell on every plane
    (12 bytes a cell in fp32, 20 in fp64), or only on its sel planes
    (``sel_range`` as for :func:`sweep_plain`)."""
    nb = spec.num_blocks() if blocks is None else blocks
    ranges = _block_ranges(sel_range, nb) or [(0, spec.padded().z)] * nb
    full = ranged = 0
    for rect in rects:
        n = rect.hi - rect.lo
        plane = n.y * n.x
        for lo, hi in ranges:
            full += (2 * item + 4) * plane * n.z
            ranged += (2 * item * plane * n.z
                       + 4 * plane * max(0, min(hi, rect.hi.z) - max(lo, rect.lo.z)))
    return full, ranged


def sweep_info(index: int, item: int = 4) -> dict:
    """What the sweep kernel's instantiation for ``item``-byte cells
    reports on CUDA device ``index``: resident blocks per SM, registers and
    local (spill) bytes per thread, threads and dynamic shared memory per
    block."""
    r = (ctypes.c_int * 5)()
    _native.check(_native.lib("jacobi_sweep").jacobi_sweep_info(index, item, r),
                  "jacobi_sweep_info")
    return dict(zip(("blocks_per_sm", "regs", "local_bytes", "threads", "smem_bytes"), r))


@functools.lru_cache(maxsize=None)
def sweep_blocks_in_flight(index: int, item: int = 4) -> int:
    """SMs x resident sweep blocks per SM on CUDA device ``index`` for
    ``item``-byte cells."""
    per_sm = sweep_info(index, item)["blocks_per_sm"]
    return torch.cuda.get_device_properties(index).multi_processor_count * max(1, per_sm)


def _alignment(ts, sz: int, cells: int = 4) -> int:
    """The cells (``cells``, the cells of a 16-byte run, then halved down
    to 1) that every tensor's address, counted in its own elements, and the
    plane stride ``sz`` are a multiple of."""
    low = min((t.data_ptr() & -t.data_ptr()) // t.element_size() for t in ts)
    w = cells
    while w > 1:
        if low % w == 0 and sz % w == 0:
            return w
        w //= 2
    return 1


def _launch_tasks(tasks, tensors, spec: GridSpec, dev) -> None:
    """One launch of ``csrc/jacobi_sweep.cu`` over ``tasks``, whose
    pointers lie in ``tensors`` (``tensors[0]``'s type, float32 or float64,
    picks the instantiation); every block is a padded block of ``spec``. The
    table is made once per task list (``_native.kept``)."""
    p = spec.padded()
    sz = p.y * p.x
    item = tensors[0].element_size()
    blocks = sweep_blocks_in_flight(dev.index, item)
    tasks = tuple(tasks)
    rows, tiles = _native.kept(("sweep_rows", tasks, blocks, item),
                               lambda: sweep_table(tasks, blocks, item))
    table = _native.device_table(("sweep_tasks", rows), lambda: [v for r in rows for v in r], dev)
    rc = _native.lib("jacobi_sweep").jacobi_sweep_launch(
        table.data_ptr(), len(rows), SWEEP_TASK_COLS, tiles, sz, p.x, p.y,
        _alignment(tensors, sz, run_cells(item)), item, min(tiles, blocks), dev.index,
        _native.stream_ptr(dev))
    _native.check(rc, "jacobi_sweep")


def _stack_tasks(curr, out, sel, spec: GridSpec, rect: Rect3, wrap, sel_range) -> list:
    """The tasks of one rect of every block of the stacks ``curr``, ``out``
    and ``sel``: one task for every block when ``sel_range`` is None or one
    pair, else one a block with its own range."""
    p = spec.padded()
    bsize = p.z * p.y * p.x
    nb = curr.numel() // bsize
    lo, n = rect.lo, rect.hi - rect.lo
    geo = ((lo.z, lo.y, lo.x), (n.z, n.y, n.x), tuple(bool(w) for w in wrap))
    ranges = _block_ranges(sel_range, nb)
    if ranges is None or len(set(ranges)) == 1:
        slo, shi = ranges[0] if ranges else (0, p.z)
        return [SweepTask(curr.data_ptr(), out.data_ptr(), sel.data_ptr(), bsize, nb, *geo,
                          slo, shi)]
    fb, sb = curr.element_size() * bsize, sel.element_size() * bsize
    return [SweepTask(curr.data_ptr() + b * fb, out.data_ptr() + b * fb, sel.data_ptr() + b * sb,
                      bsize, 1, *geo, slo, shi)
            for b, (slo, shi) in enumerate(ranges)]


def _compute_rect(spec: GridSpec) -> Rect3:
    off = spec.compute_offset()
    return Rect3(off, off + spec.base)


def sweep(curr, nxt, sel, spec: GridSpec, wrap=(True, True, True), sel_range=None):
    """One Jacobi step of every block: ``nxt``'s compute regions <- the
    6-neighbour average of ``curr`` with the ``sel`` spheres imposed (in
    place; returns ``nxt``). See :func:`sweep_plain` for the arguments. On
    the card one launch of ``csrc/jacobi_sweep.cu`` covers every block."""
    _check_fields(spec, curr, nxt, sel)
    dev = _device_of(curr, nxt, sel)
    if dev.type == "cpu":
        return sweep_plain(curr, nxt, sel, spec, wrap, sel_range)
    _launch_tasks(_stack_tasks(curr, nxt, sel, spec, _compute_rect(spec), wrap, sel_range),
                  (curr, nxt, sel), spec, dev)
    sweep.launches += 1
    return nxt


sweep.launches = 0


def sweep_tenants(curr, nxt, sel, spec: GridSpec, sel_range=None):
    """One Jacobi step of every tenant of a campaign slot: ``curr``, ``nxt``
    and ``sel`` are ``(B, pz, py, px)`` stacks of B independent tenants, each
    a single block of the one-block ``spec``; every axis of every tenant
    wraps onto the tenant itself and nothing crosses the tenant axis;
    ``sel_range`` as for :func:`sweep_plain` (one pair for every tenant).
    ``nxt``'s compute regions <- the step (in place; returns ``nxt``). CPU
    tensors take :func:`sweep_plain` over the stack; CUDA tensors launch
    ``csrc/jacobi_sweep.cu`` once for all B tenants (one task of B blocks),
    or raise."""
    if spec.dim != Dim3(1, 1, 1):
        raise ValueError(f"tenants are single-block domains; got partition {spec.dim}")
    nb = curr.shape[0] if curr.dim() == 4 else 0
    if nb < 1:
        raise ValueError(f"curr: shape {tuple(curr.shape)} is not a stack of tenants")
    _check_fields(spec, curr, nxt, sel, nb)
    dev = _device_of(curr, nxt, sel)
    if sel_range is not None:
        sel_range = tuple(sel_range)
    if dev.type == "cpu":
        return sweep_plain(curr, nxt, sel, spec, sel_range=sel_range)
    _launch_tasks(_stack_tasks(curr, nxt, sel, spec, _compute_rect(spec), (True,) * 3,
                               sel_range), (curr, nxt, sel), spec, dev)
    sweep_tenants.launches += 1
    return nxt


sweep_tenants.launches = 0


def _check_rect(spec: GridSpec, rect: Rect3) -> None:
    off = spec.compute_offset()
    hi = off + spec.base
    if not (off.x <= rect.lo.x < rect.hi.x <= hi.x and off.y <= rect.lo.y < rect.hi.y <= hi.y
            and off.z <= rect.lo.z < rect.hi.z <= hi.z):
        raise ValueError(f"sweep_region: {rect} is empty or outside the compute region")


def region_plain(curr, nxt, sel, spec: GridSpec, rect: Rect3, sel_range=None):
    """One Jacobi step over ``rect`` of every block in plain PyTorch: the
    region sweep ``ops.jacobi.jacobi_sweep`` with masks ``(sel == 1, sel ==
    2)`` on the sel planes (``sel_range`` as for :func:`sweep_plain`)."""
    # imported here: ops.jacobi imports this module
    from .jacobi import jacobi_sweep

    s = _ranged_sel(sel, spec, sel_range)
    return jacobi_sweep(curr, nxt, rect, (s == 1, s == 2))


def sweep_region(curr, nxt, sel, spec: GridSpec, rect: Rect3, sel_range=None):
    """One Jacobi step over ``rect`` (allocation-local, inside the compute
    region) of every block, reading every neighbour in place, halos
    included (in place; returns ``nxt``). CPU tensors take
    :func:`region_plain`; CUDA tensors launch ``csrc/jacobi_sweep.cu`` on
    the rect with its wrap flags off, or raise."""
    _check_fields(spec, curr, nxt, sel)
    _check_rect(spec, rect)
    dev = _device_of(curr, nxt, sel)
    if dev.type == "cpu":
        return region_plain(curr, nxt, sel, spec, rect, sel_range)
    _launch_tasks(_stack_tasks(curr, nxt, sel, spec, rect, (False,) * 3, sel_range),
                  (curr, nxt, sel), spec, dev)
    sweep_region.launches += 1
    return nxt


sweep_region.launches = 0


def _check_lists(currs, outs, sels, spec: GridSpec) -> torch.device:
    """One entry per block stack in each list, each a stack of ``spec``'s
    blocks, all on one device, every ``curr`` and ``out`` its own buffer."""
    if not len(currs) == len(outs) == len(sels) >= 1:
        raise ValueError(f"{len(currs)} curr, {len(outs)} out and {len(sels)} sel entries")
    for c, o, s in zip(currs, outs, sels):
        _check_fields(spec, c, o, s)
    dev = _device_of(*currs, *outs, *sels)
    if len({t.data_ptr() for t in (*currs, *outs)}) != 2 * len(currs):
        raise ValueError("every curr and out must be its own buffer")
    return dev


def _entry_ranges(sel_ranges, n: int) -> list:
    if sel_ranges is None:
        return [None] * n
    if len(sel_ranges) != n:
        raise ValueError(f"{len(sel_ranges)} sel ranges for {n} entries")
    return list(sel_ranges)


def sweep_positions(currs, nxts, sels, bspec: GridSpec, sel_ranges=None, wrap=(False,) * 3):
    """One Jacobi step of every position of a mesh: lists of one padded
    block of ``bspec`` (the block spec) per position; each ``nxt``'s compute
    region <- the sweep of its ``curr``, reading the filled halos,
    ``sels[i]`` imposed on ``sel_ranges[i]``'s planes (None: every plane;
    see :func:`sweep_plain`). ``wrap`` = ``(wz, wy, wx)`` wraps the axes
    with one position onto the block itself (the TPU kernel's wrap of the
    single-block axes; default none: every halo read as filled). In place;
    returns ``nxts``. CPU tensors take :func:`sweep_plain` per position;
    CUDA tensors launch ``csrc/jacobi_sweep.cu`` once for every position,
    or raise."""
    dev = _check_lists(currs, nxts, sels, bspec)
    ranges = _entry_ranges(sel_ranges, len(currs))
    wrap = tuple(bool(w) for w in wrap)
    if dev.type == "cpu":
        for c, n, s, r in zip(currs, nxts, sels, ranges):
            sweep_plain(c, n, s, bspec, wrap, r)
        return nxts
    rect = _compute_rect(bspec)
    tasks = [t for c, n, s, r in zip(currs, nxts, sels, ranges)
             for t in _stack_tasks(c, n, s, bspec, rect, wrap, r)]
    _launch_tasks(tasks, (*currs, *nxts, *sels), bspec, dev)
    sweep_positions.launches += 1
    return nxts


sweep_positions.launches = 0


def sweep_regions(currs, outs, sels, spec: GridSpec, rects, sel_ranges=None):
    """One Jacobi step over every rect of every block stack: ``currs``,
    ``outs`` and ``sels`` are lists of stacks of ``spec``'s blocks (a
    resident stack, or one block a mesh position), ``rects[i]`` the rects
    (allocation-local, inside the compute region) swept in every block of
    entry ``i``, reading every neighbour in place, ``sel_ranges[i]`` its
    sel planes (None, one pair, or one pair a block; see
    :func:`sweep_plain`). The rects of an entry may overlap (every one reads
    only ``curr``, so a cell written twice gets one value). In place;
    returns ``outs``. CPU tensors take :func:`region_plain` rect by rect;
    CUDA tensors launch ``csrc/jacobi_sweep.cu`` once for every rect of
    every entry, or raise."""
    dev = _check_lists(currs, outs, sels, spec)
    if len(rects) != len(currs):
        raise ValueError(f"{len(rects)} rect lists for {len(currs)} entries")
    for rs in rects:
        for rect in rs:
            _check_rect(spec, rect)
    ranges = _entry_ranges(sel_ranges, len(currs))
    if dev.type == "cpu":
        for c, o, s, rs, r in zip(currs, outs, sels, rects, ranges):
            for rect in rs:
                region_plain(c, o, s, spec, rect, r)
        return outs
    tasks = [t for c, o, s, rs, r in zip(currs, outs, sels, rects, ranges) for rect in rs
             for t in _stack_tasks(c, o, s, spec, rect, (False,) * 3, r)]
    if tasks:
        _launch_tasks(tasks, (*currs, *outs, *sels), spec, dev)
        sweep_regions.launches += 1
    return outs


sweep_regions.launches = 0


def multistep_zchunks(spec: GridSpec, k: int, blocks_in_flight: int, item: int = 4,
                      blocks: Optional[int] = None) -> int:
    """z chunks per tile column: the count whose launch the device
    finishes soonest, in plane steps (a chunk of c planes takes c + 2k
    steps, its 2k warm-up included), with ``blocks_in_flight`` (the SMs
    times the multistep blocks an SM holds) running at once: every block's
    steps shared evenly over them, plus one block's steps for the last to
    finish; the fewest chunks on a tie. No chunk is shorter than 4k
    planes. The tiles are those of ``item``-byte cells, over the ``blocks``
    the launch covers (default every block of the partition; a positions
    launch covers the positions it is given)."""
    tx, ty = multistep_shape(k, item)["tile"]
    b = spec.base
    nb = spec.num_blocks() if blocks is None else blocks
    tiles = -(-b.x // tx) * -(-b.y // ty) * nb
    slots = max(1, blocks_in_flight)

    def steps(n):
        per_block = -(-b.z // n) + 2 * k
        return tiles * n * per_block / slots + per_block

    return min(range(1, max(1, b.z // max(4 * k, 1)) + 1), key=lambda n: (steps(n), n))


def multistep_blocks_in_flight(dev: torch.device, k: int, item: int = 4) -> int:
    """SMs x resident multistep blocks per SM at depth ``k`` on ``dev`` for
    ``item``-byte cells."""
    return _blocks_in_flight(dev.index, k, item)


def multistep_info(index: int, k: int, multi_block: bool = False, item: int = 4) -> dict:
    """What the depth-``k`` instantiation for ``item``-byte cells
    (``multi_block``: the deep-halo one) reports on CUDA device ``index``:
    resident blocks per SM, registers and local (spill) bytes per thread,
    threads and dynamic shared memory per block."""
    r = (ctypes.c_int * 5)()
    _native.check(_native.lib("jacobi_multistep").jacobi_multistep_info(
        k, int(multi_block), item, index, r), "jacobi_multistep_info")
    return dict(zip(("blocks_per_sm", "regs", "local_bytes", "threads", "smem_bytes"), r))


@functools.lru_cache(maxsize=None)
def _blocks_in_flight(index: int, k: int, item: int) -> int:
    per_sm = multistep_info(index, k, multi_block=True, item=item)["blocks_per_sm"]
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
    item = curr.element_size()
    rc = _native.lib("jacobi_multistep").jacobi_multistep_launch(
        curr.data_ptr(), nxt.data_ptr(), p.y * p.x, p.x, p.z * p.y * p.x,
        off.z, off.y, off.x, b.z, b.y, b.x, d.z, d.y, d.x, k, g.x, g.y, g.z,
        multistep_zchunks(spec, k, multistep_blocks_in_flight(dev, k, item), item), item,
        dev.index, _native.stream_ptr(dev))
    _native.check(rc, "jacobi_multistep")
    multistep.launches += 1
    return nxt


multistep.launches = 0


# the columns of a positions entry (csrc/jacobi_multistep.cu TAB_COLS)
MULTISTEP_TAB_FIELDS = ("curr", "out", "ox", "oy", "oz")


def _check_positions(currs, nxts, spec: GridSpec, k: int, origins) -> torch.device:
    """``currs`` and ``nxts``: lists of one padded block of ``spec``'s
    partition per position, one float type, one device, every buffer its
    own; ``origins`` one Dim3 each; the deep-halo conditions at depth
    ``k`` on a partition of several blocks."""
    if not len(currs) == len(nxts) == len(origins) >= 1:
        raise ValueError(f"{len(currs)} curr, {len(nxts)} nxt and {len(origins)} origin entries")
    if spec.num_blocks() < 2:
        raise ValueError("the positions form is the deep-halo form: a partition of several "
                         "blocks (one block takes multistep)")
    bspec = spec.block_spec()
    for c, n in zip(currs, nxts):
        _check_fields(bspec, c, n)
        if c.dtype != currs[0].dtype:
            raise ValueError("every position's block has one float type")
    dev = _device_of(*currs, *nxts)
    if len({t.data_ptr() for t in (*currs, *nxts)}) != 2 * len(currs):
        raise ValueError("every curr and nxt must be its own buffer")
    if not 1 <= k <= min(MULTISTEP_KMAX, spec.base.z):
        raise ValueError(f"multistep depth {k} outside [1, {MULTISTEP_KMAX}] "
                         f"or deeper than the {spec.base.z} planes")
    require_deep_halo(spec, k)
    g = spec.global_size
    for o in origins:
        if not (0 <= o.x < g.x and 0 <= o.y < g.y and 0 <= o.z < g.z):
            raise ValueError(f"origin {o} outside the global box {g}")
    return dev


def multistep_positions_plain(currs, nxts, spec: GridSpec, k: int, origins):
    """The plain version of :func:`multistep_positions`: each position's
    block through :func:`multistep_plain`'s per-block body at its own
    global origin. In place; returns ``nxts``."""
    multi = multi_block_axes(spec)
    off, b = spec.compute_offset(), spec.base
    grown = tuple(slice(o - k * m, o + n + k * m)
                  for m, o, n in zip(multi, (off.z, off.y, off.x), (b.z, b.y, b.x)))
    cs = _region(spec)[1:]
    for c, n, o in zip(currs, nxts, origins):
        n[(0, 0, 0, *cs)] = _multistep_block(c[(0, 0, 0, *grown)], spec, k, o)
    return nxts


def multistep_positions(currs, nxts, spec: GridSpec, k: int, origins):
    """``k`` Jacobi steps of every given position of a mesh in one launch:
    ``currs`` and ``nxts`` are lists of one padded block of ``spec``'s
    partition per position (``(1, 1, 1, pz, py, px)``, each its own
    allocation), ``origins`` each block's global origin (the JAX package's
    deep-halo multistep on a device of the mesh, whose origin comes from
    ``lax.axis_index``; :func:`block_origin`). Each ``nxt``'s compute region
    <- its block after k steps, the standard spheres from coordinates; the
    partition's single-block axes wrap onto the block, the others read the
    halos, which must hold the neighbours' cells at radius >= k. In place;
    returns ``nxts``. CPU tensors take :func:`multistep_positions_plain`;
    CUDA tensors launch ``csrc/jacobi_multistep.cu``'s positions entry once
    over a table of (curr, out, origin) entries in device memory (made once
    per operand list, ``_native.device_table``; its z chunks counted over
    the positions launched), or raise."""
    origins = [Dim3.of(o) for o in origins]
    dev = _check_positions(currs, nxts, spec, k, origins)
    if dev.type == "cpu":
        return multistep_positions_plain(currs, nxts, spec, k, origins)
    p, off, b, g, d = (spec.padded(), spec.compute_offset(), spec.base, spec.global_size,
                       spec.dim)
    item = currs[0].element_size()
    # one row of MULTISTEP_TAB_FIELDS a position
    rows = tuple(v for c, n, o in zip(currs, nxts, origins)
                 for v in (c.data_ptr(), n.data_ptr(), o.x, o.y, o.z))
    table = _native.device_table(("multistep_positions", rows), lambda: list(rows), dev)
    aligned = all(t.data_ptr() % 16 == 0 for t in (*currs, *nxts))  # the 16-byte runs' test
    zchunks = multistep_zchunks(spec, k, multistep_blocks_in_flight(dev, k, item), item,
                                blocks=len(currs))
    rc = _native.lib("jacobi_multistep").jacobi_multistep_positions_launch(
        table.data_ptr(), len(currs), int(aligned), p.y * p.x, p.x, off.z, off.y, off.x, b.z,
        b.y, b.x, d.z, d.y, d.x, k, g.x, g.y, g.z, zchunks, item, dev.index,
        _native.stream_ptr(dev))
    _native.check(rc, "jacobi_multistep positions")
    multistep_positions.launches += 1
    return nxts


multistep_positions.launches = 0
