"""The Astaroth RK3 substep kernel and its plain PyTorch version.

The port's counterpart of ``stencil_tpu.ops.pallas_astaroth``:

- :func:`substep` launches ``csrc/astaroth_substep.cu`` (replacing the TPU's
  ``make_pallas_substep``, both window variants) over one block: one
  Williamson RK3 stage for all 8 MHD fields over the compute region, in
  fp64 or fp32, every derivative, pencil and rate kept on chip: a block
  marches a tile's z window through a ring in shared memory, and each
  cell's work is split over three warp groups (:data:`GROUPS`), which hand
  :data:`HANDOVER` values of each cell over through shared memory;
- :func:`substep_tasks` is the same kernel over a table of tasks, one
  launch: a task is one block of stacks of padded blocks (every resident
  block of a partition) and a rect in it, each block's compute region at
  its own extent (:func:`compute_tasks`, the JAX package's per-resident
  loop) or its exterior shells (:func:`shell_tasks`, the overlap
  iteration's re-integration after the exchange), or one task per tenant
  of a campaign slot's ``(B, pz, py, px)`` stacks (:func:`tenant_tasks`,
  each tenant's whole compute region; the halos are filled first, per
  tenant, by ``halo_fill.wrap_fill_tenants``). :func:`substep_table` lays
  the table out; :func:`substep` is its one-task case;
- :func:`substep_plain` and :func:`substep_tasks_plain` are the same stage
  through ``astaroth.fd`` and ``astaroth.equations`` in PyTorch, over z
  slabs so that the ~74 derivative tensors and the equations' temporaries
  stay small at 256^3.

The wrappers take their plain versions only for tensors on the CPU; on a
CUDA tensor they launch the kernel or raise. They count their launches in
``substep.launches`` and ``substep_tasks.launches`` (and, of the latter,
the launches that hold shell tasks in ``substep_tasks.shells``).

Layout: 8 + 8 padded ``(pz, py, px)`` blocks of one dtype (views of the
stacked ``(1, 1, 1, pz, py, px)`` state are fine), or for
:func:`substep_tasks` 8 + 8 contiguous stacks of them (the stacked
``(bz, by, bx, pz, py, px)`` state), ordered like :data:`FIELDS`, with a
radius of at least 3 on all six faces (inline x halos; the TPU's tight-x
layout is a lane-roll device and not taken). Only the tasks' cells of
``out`` are written; the rest keeps its contents.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from ..domain.grid import GridSpec
from ..geometry import Dim3, Rect3, exterior_regions, interior_region
from . import _native

FIELDS = ("lnrho", "uux", "uuy", "uuz", "ax", "ay", "az", "entropy")
NF = len(FIELDS)

# Williamson (1980) low-storage coefficients (reference: integration.cuh:19-21)
RK3_ALPHA = (0.0, -5.0 / 9.0, -153.0 / 128.0)
RK3_BETA = (1.0 / 3.0, 15.0 / 16.0, 8.0 / 15.0)

HALO = 3  # 6th-order stencils (reference: astaroth.h STENCIL_ORDER 6)

# Operations per compute cell and stage, counted from csrc/astaroth_substep.cu
# (each exp as one): 669 in the derivatives, 256 in the right-hand sides,
# 3 (stage 0) or 6 (stages 1-2) per field in the update.
FLOPS_PER_CELL = (949, 973, 973)

# z planes per slab of the plain version: about 2^20 cells per temporary
_SLAB_CELLS = 1 << 20

# The kernel's launch shape (csrc/astaroth_substep.cu exports the same):
# a block is a TILE[0] x TILE[1]-cell tile marching a z chunk, with one
# thread per cell in each of GROUPS warp groups (magnetic, momentum,
# scalars). Its shared memory holds, per field, a ring of RING_SLOTS planes
# of the tile's footprint (the tile grown by HALO on each side), and the
# HANDOVER values per cell the groups hand each other in a z plane.
TILE = (32, 4)
GROUPS = 3
RING_SLOTS = 8
# values per ring slot: the 38 x 10 footprint padded to a multiple of 128
# bytes in fp32 and fp64
RING_STRIDE = 384
HANDOVER = 16
# blocks wanted per z column of tiles: the blocks the device holds at once
# x WAVES
WAVES = 2


def substep_supported(spec: GridSpec, dtype) -> bool:
    """Whether the kernel takes this layout and dtype: fp32 or fp64 fields
    with a radius of at least 3 on every face."""
    if dtype not in (torch.float32, torch.float64):
        return False
    r = spec.radius
    return min(r.x(-1), r.x(1), r.y(-1), r.y(1), r.z(-1), r.z(1)) >= HALO


def require_supported(spec: GridSpec, dtype) -> None:
    """Raise ValueError unless :func:`substep_supported`."""
    if not substep_supported(spec, dtype):
        r = spec.radius
        raise ValueError(
            f"substep takes fp32 or fp64 fields with radius >= {HALO} on all six "
            f"faces (inline x halos); got {dtype} with radius x({r.x(-1)},{r.x(1)}) "
            f"y({r.y(-1)},{r.y(1)}) z({r.z(-1)},{r.z(1)})")


def stage_bytes(spec: GridSpec, itemsize: int, stage: int) -> int:
    """Bytes a stage must move over one block's compute cells: 8 fields read
    and 8 written, plus 8 out fields read at stages 1-2."""
    return tasks_bytes(_whole(spec), itemsize, stage)


def substep_threads() -> int:
    """Threads of one kernel block."""
    return GROUPS * TILE[0] * TILE[1]


def substep_smem_bytes(itemsize: int) -> int:
    """Dynamic shared memory of one kernel block: every field's ring of
    footprint planes (each padded to RING_STRIDE values), the hand-over,
    and the 16 bytes of the ring's mbarrier."""
    cells = TILE[0] * TILE[1]
    return (NF * RING_SLOTS * RING_STRIDE + HANDOVER * cells) * itemsize + 16


def _zchunk(tiles: int, nz: int, blocks_in_flight: int) -> int:
    """The z planes a block marches when ``tiles`` tile columns share the
    card and the tallest task has ``nz`` planes: ``nz`` cut into enough
    chunks that the columns, times the chunks, give ``blocks_in_flight`` x
    :data:`WAVES` blocks (at most one plane each)."""
    chunks = max(1, min(nz, -(-blocks_in_flight * WAVES // tiles)))
    return -(-nz // chunks)


def tile_grid(n) -> Tuple[int, int]:
    """``(gx, gy)``: the tiles across an extent ``n`` (x, y, z)."""
    return -(-n.x // TILE[0]), -(-n.y // TILE[1])


def substep_zchunk(spec: GridSpec, blocks_in_flight: int) -> int:
    """z planes a block marches on one block: the compute region's z extent
    cut into enough chunks that the tiles of the x-y plane, times the
    chunks, give ``blocks_in_flight`` x :data:`WAVES` blocks (at most one
    plane each)."""
    gx, gy = tile_grid(spec.base)
    return _zchunk(gx * gy, spec.base.z, blocks_in_flight)


class SubstepTask(NamedTuple):
    """One task of the table: block ``block`` of the stacks (their flat
    index, x fastest) and the rect of it to update, allocation-local."""

    block: int
    rect: Rect3


def block_index(spec: GridSpec, j: int) -> Tuple[int, int, int]:
    """The (x, y, z) partition index of the stacks' flat block ``j``."""
    d = spec.dim
    return (j % d.x, (j // d.x) % d.y, j // (d.x * d.y))


def block_compute(spec: GridSpec, j: int) -> Rect3:
    """Block ``j``'s compute region at its own extent, allocation-local."""
    off = spec.compute_offset()
    return Rect3(off, off + spec.block_size(block_index(spec, j)))


def compute_tasks(spec: GridSpec) -> Tuple[SubstepTask, ...]:
    """Every block's compute region: the tasks of one stage over a
    partition (uneven blocks at their own extents)."""
    return tuple(SubstepTask(j, block_compute(spec, j)) for j in range(spec.num_blocks()))


def tenant_tasks(spec: GridSpec, tenants: int) -> Tuple[SubstepTask, ...]:
    """One task per tenant of a ``(tenants, pz, py, px)`` stack of a
    one-block ``spec``: tenant ``j``'s whole compute region at the base
    extent, the batched campaign's stage (all tenants in one launch up to
    :data:`MAX_TASKS`)."""
    if spec.num_blocks() != 1:
        raise ValueError(f"tenant stacks are single-block domains; got partition {spec.dim}")
    if tenants < 1:
        raise ValueError(f"a tenant stack holds at least one tenant, not {tenants}")
    rect = _whole(spec)[0].rect
    return tuple(SubstepTask(j, rect) for j in range(tenants))


def _all_whole(spec: GridSpec, tasks) -> bool:
    """Whether every task is its block's whole compute region: its own
    extent in a partition's stacks, the base extent in a tenant stack (a
    one-block ``spec``, every tenant's region the same rect)."""
    if spec.num_blocks() == 1:
        rect = _whole(spec)[0].rect
        return all(t.rect == rect for t in tasks)
    return all(t.rect == block_compute(spec, t.block) for t in tasks)


def shell_tasks(spec: GridSpec) -> Tuple[SubstepTask, ...]:
    """Every block's exterior shells (``exterior_regions`` of its compute
    region less its interior at the spec's radius; 6 a block at radius 3),
    the overlap iteration's stage-0 re-integration after the exchange."""
    out = []
    for j in range(spec.num_blocks()):
        c = block_compute(spec, j)
        out.extend(SubstepTask(j, r) for r in exterior_regions(c, interior_region(c, spec.radius)))
    return tuple(out)


def task_tma(spec: GridSpec, rect: Rect3, item: int, aligned: bool = True) -> bool:
    """Whether tensor copies fill a task's ring: fp64 only (an fp32
    footprint row of 152 bytes is no multiple of 16), rows 16-byte aligned
    (an even x pitch) and fields at 16-byte aligned addresses (``aligned``),
    and the task's boxes starting on a 16-byte boundary (``lo.x - 3`` even:
    the high x shell of an even extent starts at an odd column)."""
    return item == 8 and aligned and spec.padded().x % 2 == 0 and (rect.lo.x - HALO) % 2 == 0


TASK_COLS = 12  # int32 columns of a task row (csrc/astaroth_substep.cu SubstepTask)
MAX_TASKS = 256  # rows one launch's table holds (csrc/astaroth_substep.cu Table)


def substep_table(tasks, spec: GridSpec, blocks_in_flight: int, item: int,
                  aligned: bool = True) -> Tuple[tuple, int]:
    """``(rows, tiles)``: the kernel's task table, one row of
    :data:`TASK_COLS` a task (its first tile in the launch's walk, its
    block, its rect's origin (z, y, x) and extent, its tile columns and
    rows, the z planes a block of it marches and its :func:`task_tma`), and
    the blocks to launch. The z chunk is the one-block rule
    (:func:`substep_zchunk`) over the tile columns of every task and the
    tallest task, each task marching at most its own extent."""
    tasks = [SubstepTask(*t) for t in tasks]
    cols = [tile_grid(t.rect.hi - t.rect.lo) for t in tasks]
    top = max(t.rect.hi.z - t.rect.lo.z for t in tasks)
    chunk = _zchunk(sum(gx * gy for gx, gy in cols), top, blocks_in_flight)
    rows, start = [], 0
    for t, (gx, gy) in zip(tasks, cols):
        lo, n = t.rect.lo, t.rect.hi - t.rect.lo
        zc = min(chunk, n.z)
        rows.append((start, t.block, lo.z, lo.y, lo.x, n.z, n.y, n.x, gx, gy, zc,
                     int(task_tma(spec, t.rect, item, aligned))))
        start += gx * gy * -(-n.z // zc)
    return tuple(rows), start


def table_launches(rows, tiles: int):
    """``[(rows, tiles), ...]``: the table cut into launches of at most
    :data:`MAX_TASKS` rows, each group's first tiles counted from 0."""
    out = []
    for i in range(0, len(rows), MAX_TASKS):
        group = rows[i:i + MAX_TASKS]
        first = group[0][0]
        end = rows[i + MAX_TASKS][0] if i + MAX_TASKS < len(rows) else tiles
        out.append((tuple((r[0] - first,) + tuple(r[1:]) for r in group), end - first))
    return out


def tasks_bytes(tasks, itemsize: int, stage: int) -> int:
    """Bytes a stage over ``tasks`` must move: each task's cells read from 8
    fields and written to 8, plus 8 out fields read at stages 1-2."""
    return (2 if stage == 0 else 3) * NF * itemsize * sum(
        (t.rect.hi - t.rect.lo).flatten() for t in tasks)


@functools.lru_cache(maxsize=None)
def substep_info(index: int, itemsize: int, stage: int) -> dict:
    """What the kernel instantiation of ``itemsize`` and ``stage`` (stage 0
    or the others) reports on CUDA device ``index``: resident blocks per SM,
    registers and local (spill) bytes per thread, threads and dynamic shared
    memory per block."""
    r = (ctypes.c_int * 5)()
    _native.check(_native.lib("astaroth_substep").astaroth_substep_info(
        itemsize, int(stage == 0), index, r), "astaroth_substep_info")
    return dict(zip(("blocks_per_sm", "regs", "local_bytes", "threads", "smem_bytes"), r))


def substep_blocks_in_flight(dev: torch.device, itemsize: int, stage: int) -> int:
    """SMs x resident blocks per SM of the instantiation a launch runs."""
    per_sm = substep_info(dev.index, itemsize, stage)["blocks_per_sm"]
    return torch.cuda.get_device_properties(dev.index).multi_processor_count * max(1, per_sm)


def _whole(spec: GridSpec) -> Tuple[SubstepTask]:
    """One block's compute region at the base extent: :func:`substep`'s task."""
    off = spec.compute_offset()
    return (SubstepTask(0, Rect3(off, off + spec.base)),)


def substep_tasks_plain(curr8: Sequence[torch.Tensor], out8: Sequence[torch.Tensor],
                        spec: GridSpec, tasks, c, inv_ds, stage: int, dt: float):
    """One RK3 stage of all 8 fields over ``tasks`` in plain PyTorch: each
    task's cells of ``out8`` (stacks of padded blocks) updated in place from
    ``curr8``, task by task and z slab by z slab through
    ``astaroth.integrate.integrate_region`` (returns ``out8``)."""
    # imported here: astaroth.integrate imports this module
    from ..astaroth.integrate import integrate_region

    p = spec.padded()
    cb = [t.view(-1, p.z, p.y, p.x) for t in curr8]
    ob = [t.view(-1, p.z, p.y, p.x) for t in out8]
    for j, rect in tasks:
        curr = {k: t[j] for k, t in zip(FIELDS, cb)}
        out = {k: t[j] for k, t in zip(FIELDS, ob)}
        lo, hi = rect.lo, rect.hi
        planes = max(1, _SLAB_CELLS // ((hi.y - lo.y) * (hi.x - lo.x)))
        for z0 in range(lo.z, hi.z, planes):
            slab = Rect3(Dim3(lo.x, lo.y, z0), Dim3(hi.x, hi.y, min(hi.z, z0 + planes)))
            integrate_region(stage, slab, inv_ds, c, dt, curr, out)
    return tuple(out8)


def substep_plain(curr8: Sequence[torch.Tensor], out8: Sequence[torch.Tensor],
                  spec: GridSpec, c, inv_ds, stage: int, dt: float):
    """One RK3 stage of all 8 fields in plain PyTorch: ``out8``'s compute
    cells updated in place from ``curr8`` (returns ``out8``), z slab by z
    slab through ``astaroth.integrate.integrate_region``."""
    return substep_tasks_plain(curr8, out8, spec, _whole(spec), c, inv_ds, stage, dt)


def _check(curr8, out8, spec: GridSpec, stage: int, stacks: bool = False) -> torch.device:
    """The 16 blocks (``stacks``: stacks of blocks) as the kernel takes them;
    returns their device."""
    if len(curr8) != NF or len(out8) != NF:
        raise ValueError(f"substep takes {NF} curr and {NF} out blocks "
                         f"({', '.join(FIELDS)})")
    if stage not in (0, 1, 2):
        raise ValueError(f"RK3 stage {stage} outside 0..2")
    dtype, dev = curr8[0].dtype, curr8[0].device
    require_supported(spec, dtype)
    p = spec.padded()
    block = p.z * p.y * p.x
    for t in (*curr8, *out8):
        if t.dtype != dtype or t.device != dev:
            raise ValueError("substep blocks share one dtype and one device")
        if stacks:
            if tuple(t.shape[-3:]) != (p.z, p.y, p.x) or t.numel() != curr8[0].numel():
                raise ValueError(f"stack shape {tuple(t.shape)} is not a stack of padded "
                                 f"({p.z}, {p.y}, {p.x}) blocks like the first's "
                                 f"{tuple(curr8[0].shape)}")
        elif tuple(t.shape[-3:]) != (p.z, p.y, p.x) or t.numel() != block:
            raise ValueError(f"block shape {tuple(t.shape)} is not one padded "
                             f"({p.z}, {p.y}, {p.x}) block")
        if not t.is_contiguous():
            raise ValueError("substep blocks must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"substep runs on cuda or cpu tensors, not {dev}")
    ptrs = {t.data_ptr() for t in curr8}
    if len(ptrs) != NF or ptrs & {t.data_ptr() for t in out8}:
        raise ValueError("the 16 curr and out blocks must be distinct buffers")
    return dev


def _check_tasks(tasks, spec: GridSpec, nblocks: int, stage: int) -> None:
    """Each task a block of the stacks and a non-empty rect with 3 halo cells
    on every side; at stages 1-2, whole compute regions of distinct blocks
    (stages 1-2 read ``out``: a shell would apply its stage twice): of a
    partition's stacks, or of a tenant stack (a one-block ``spec`` over
    ``nblocks`` tenants)."""
    if not tasks:
        raise ValueError("substep_tasks needs at least one task")
    p = spec.padded()
    for j, rect in tasks:
        if not 0 <= j < nblocks:
            raise ValueError(f"task block {j} outside the stacks' {nblocks} blocks")
        lo, hi = rect.lo, rect.hi
        for a, b, n in ((lo.x, hi.x, p.x), (lo.y, hi.y, p.y), (lo.z, hi.z, p.z)):
            if not HALO <= a < b <= n - HALO:
                raise ValueError(f"task rect {rect} is empty or leaves fewer than {HALO} halo "
                                 f"cells in the padded ({p.z}, {p.y}, {p.x}) block")
    if stage:
        if (len({j for j, _ in tasks}) != len(tasks) or spec.num_blocks() not in (1, nblocks)
                or not _all_whole(spec, tasks)):
            raise ValueError(f"a shell task at stage {stage}: stages 1-2 read out and take "
                             "whole compute regions of distinct blocks only")


def _launch(curr8, out8, spec: GridSpec, tasks, c, inv_ds, stage: int, dt: float,
            dev: torch.device, nblocks: int) -> int:
    """Launch ``csrc/astaroth_substep.cu`` over ``tasks`` of the stacks
    ``curr8`` / ``out8``: one launch, or one per :data:`MAX_TASKS` tasks;
    returns the launches. The tables are made once per task list, dtype and
    alignment (``_native.kept``)."""
    alpha_over_pb = RK3_ALPHA[stage] / RK3_BETA[stage - 1] if stage else 0.0
    prm = (ctypes.c_double * 16)(
        *inv_ds, c.cs2_sound, c.gamma, c.cp_sound, c.lnrho0, c.lnT0, c.mu0, c.eta,
        c.nu_visc, c.zeta, c.chi, dt, RK3_BETA[stage], alpha_over_pb)
    cp = (ctypes.c_void_p * NF)(*[t.data_ptr() for t in curr8])
    op = (ctypes.c_void_p * NF)(*[t.data_ptr() for t in out8])
    p = spec.padded()
    item = curr8[0].element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in curr8)
    bif = substep_blocks_in_flight(dev, item, stage)
    tasks = tuple(tasks)

    def make():
        groups = table_launches(*substep_table(tasks, spec, bif, item, aligned))
        return [((ctypes.c_int * (len(rows) * TASK_COLS))(*[v for r in rows for v in r]),
                 len(rows), tiles) for rows, tiles in groups]

    lib = _native.lib("astaroth_substep")
    launches = _native.kept(("substep_launches", p.x, tasks, bif, item, aligned), make)
    for rows, ntask, tiles in launches:
        rc = lib.astaroth_substep_launch(cp, op, item, prm, 16, int(stage == 0), rows, ntask,
                                         TASK_COLS, tiles, p.y * p.x, p.x, p.z, nblocks,
                                         dev.index, _native.stream_ptr(dev))
        _native.check(rc, f"astaroth_substep[{stage}]")
    return len(launches)


def substep(curr8: Sequence[torch.Tensor], out8: Sequence[torch.Tensor],
            spec: GridSpec, c, inv_ds, stage: int, dt: float):
    """One RK3 stage (``stage`` 0, 1 or 2) of all 8 fields of one block:
    ``out8``'s compute cells updated in place from ``curr8`` (returns
    ``out8``). ``c`` is ``astaroth.equations.Constants``, ``inv_ds`` the
    ``(inv_dsx, inv_dsy, inv_dsz)`` triple. CPU tensors take
    :func:`substep_plain`; CUDA tensors launch ``csrc/astaroth_substep.cu``
    (the one-task table) or raise."""
    dev = _check(curr8, out8, spec, stage)
    if dev.type == "cpu":
        return substep_plain(curr8, out8, spec, c, inv_ds, stage, dt)
    substep.launches += _launch(curr8, out8, spec, _whole(spec), c, inv_ds, stage, dt, dev, 1)
    return tuple(out8)


substep.launches = 0


def substep_tasks(curr8: Sequence[torch.Tensor], out8: Sequence[torch.Tensor],
                  spec: GridSpec, tasks, c, inv_ds, stage: int, dt: float):
    """One RK3 stage of all 8 fields over ``tasks`` (:class:`SubstepTask`
    pairs of a block of the stacks and a rect, e.g. :func:`compute_tasks` or
    :func:`shell_tasks`) in one launch (one per :data:`MAX_TASKS` tasks, the
    rows a launch's table holds): each task's cells of ``out8`` (8
    contiguous stacks of padded blocks, the stacked state) updated in place
    from ``curr8`` (returns ``out8``). A shell task runs at stage 0 only.
    CPU tensors take :func:`substep_tasks_plain`; CUDA tensors launch
    ``csrc/astaroth_substep.cu`` or raise."""
    dev = _check(curr8, out8, spec, stage, stacks=True)
    p = spec.padded()
    nblocks = curr8[0].numel() // (p.z * p.y * p.x)
    tasks = tuple(SubstepTask(*t) for t in tasks)
    _check_tasks(tasks, spec, nblocks, stage)
    if dev.type == "cpu":
        return substep_tasks_plain(curr8, out8, spec, tasks, c, inv_ds, stage, dt)
    n = _launch(curr8, out8, spec, tasks, c, inv_ds, stage, dt, dev, nblocks)
    substep_tasks.launches += n
    if not _all_whole(spec, tasks):
        substep_tasks.shells += n
    return tuple(out8)


substep_tasks.launches = 0
substep_tasks.shells = 0
