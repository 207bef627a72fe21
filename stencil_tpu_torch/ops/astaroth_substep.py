"""The Astaroth RK3 substep kernel and its plain PyTorch version.

The port's counterpart of ``stencil_tpu.ops.pallas_astaroth``:

- :func:`substep` launches ``csrc/astaroth_substep.cu`` (replacing the TPU's
  ``make_pallas_substep``, both window variants): one Williamson RK3 stage
  for all 8 MHD fields over the compute region, in fp64 or fp32, every
  derivative, pencil and rate kept on chip: a block marches a tile's z
  window through a ring in shared memory, and each cell's work is split
  over three warp groups (:data:`GROUPS`), which hand :data:`HANDOVER`
  values of each cell over through shared memory;
- :func:`substep_plain` is the same stage through ``astaroth.fd`` and
  ``astaroth.equations`` in PyTorch, over z slabs so that the ~74 derivative
  tensors and the equations' temporaries stay small at 256^3.

The wrapper takes its plain version only for tensors on the CPU; on a CUDA
tensor it launches the kernel or raises. It counts its launches in
``substep.launches``.

Layout: 8 + 8 padded ``(pz, py, px)`` blocks of one dtype (views of the
stacked ``(1, 1, 1, pz, py, px)`` state are fine), ordered like
:data:`FIELDS`, with a radius of at least 3 on all six faces (inline x
halos; the TPU's tight-x layout is a lane-roll device and not taken). Only
compute cells of ``out`` are written; its halos keep their contents.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from ..domain.grid import GridSpec
from ..geometry import Dim3, Rect3
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
    """Bytes a stage must move over the compute cells: 8 fields read and 8
    written, plus 8 out fields read at stages 1-2."""
    return (2 if stage == 0 else 3) * NF * itemsize * spec.base.flatten()


def substep_threads() -> int:
    """Threads of one kernel block."""
    return GROUPS * TILE[0] * TILE[1]


def substep_smem_bytes(itemsize: int) -> int:
    """Dynamic shared memory of one kernel block: every field's ring of
    footprint planes (each padded to RING_STRIDE values), the hand-over,
    and the 16 bytes of the ring's mbarrier."""
    cells = TILE[0] * TILE[1]
    return (NF * RING_SLOTS * RING_STRIDE + HANDOVER * cells) * itemsize + 16


def substep_zchunk(spec: GridSpec, blocks_in_flight: int) -> int:
    """z planes a block marches: the compute region's z extent cut into
    enough chunks that the tiles of the x-y plane, times the chunks, give
    ``blocks_in_flight`` x :data:`WAVES` blocks (at most one plane each)."""
    b = spec.base
    tiles = -(-b.x // TILE[0]) * -(-b.y // TILE[1])
    chunks = max(1, min(b.z, -(-blocks_in_flight * WAVES // tiles)))
    return -(-b.z // chunks)


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


def substep_plain(curr8: Sequence[torch.Tensor], out8: Sequence[torch.Tensor],
                  spec: GridSpec, c, inv_ds, stage: int, dt: float):
    """One RK3 stage of all 8 fields in plain PyTorch: ``out8``'s compute
    cells updated in place from ``curr8`` (returns ``out8``), z slab by z
    slab through ``astaroth.integrate.integrate_region``."""
    # imported here: astaroth.integrate imports this module
    from ..astaroth.integrate import integrate_region

    off, b = spec.compute_offset(), spec.base
    curr = dict(zip(FIELDS, curr8))
    out = dict(zip(FIELDS, out8))
    planes = max(1, _SLAB_CELLS // (b.y * b.x))
    for z0 in range(0, b.z, planes):
        z1 = min(b.z, z0 + planes)
        rect = Rect3(Dim3(off.x, off.y, off.z + z0), Dim3(off.x + b.x, off.y + b.y, off.z + z1))
        integrate_region(stage, rect, inv_ds, c, dt, curr, out)
    return tuple(out8)


def _check(curr8, out8, spec: GridSpec, stage: int) -> torch.device:
    if len(curr8) != NF or len(out8) != NF:
        raise ValueError(f"substep takes {NF} curr and {NF} out blocks "
                         f"({', '.join(FIELDS)})")
    if stage not in (0, 1, 2):
        raise ValueError(f"RK3 stage {stage} outside 0..2")
    dtype, dev = curr8[0].dtype, curr8[0].device
    require_supported(spec, dtype)
    p = spec.padded()
    for t in (*curr8, *out8):
        if t.dtype != dtype or t.device != dev:
            raise ValueError("substep blocks share one dtype and one device")
        if tuple(t.shape[-3:]) != (p.z, p.y, p.x) or t.numel() != p.z * p.y * p.x:
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


def substep(curr8: Sequence[torch.Tensor], out8: Sequence[torch.Tensor],
            spec: GridSpec, c, inv_ds, stage: int, dt: float):
    """One RK3 stage (``stage`` 0, 1 or 2) of all 8 fields: ``out8``'s
    compute cells updated in place from ``curr8`` (returns ``out8``).
    ``c`` is ``astaroth.equations.Constants``, ``inv_ds`` the
    ``(inv_dsx, inv_dsy, inv_dsz)`` triple. CPU tensors take
    :func:`substep_plain`; CUDA tensors launch ``csrc/astaroth_substep.cu``
    or raise."""
    dev = _check(curr8, out8, spec, stage)
    if dev.type == "cpu":
        return substep_plain(curr8, out8, spec, c, inv_ds, stage, dt)
    alpha_over_pb = RK3_ALPHA[stage] / RK3_BETA[stage - 1] if stage else 0.0
    prm = (ctypes.c_double * 16)(
        *inv_ds, c.cs2_sound, c.gamma, c.cp_sound, c.lnrho0, c.lnT0, c.mu0, c.eta,
        c.nu_visc, c.zeta, c.chi, dt, RK3_BETA[stage], alpha_over_pb)
    cp = (ctypes.c_void_p * NF)(*[t.data_ptr() for t in curr8])
    op = (ctypes.c_void_p * NF)(*[t.data_ptr() for t in out8])
    p, off, b = spec.padded(), spec.compute_offset(), spec.base
    item = curr8[0].element_size()
    zchunk = substep_zchunk(spec, substep_blocks_in_flight(dev, item, stage))
    rc = _native.lib("astaroth_substep").astaroth_substep_launch(
        cp, op, item, prm, 16, int(stage == 0), p.y * p.x, p.x, off.z, off.y, off.x,
        b.z, b.y, b.x, zchunk, dev.index, _native.stream_ptr(dev))
    _native.check(rc, f"astaroth_substep[{stage}]")
    substep.launches += 1
    return tuple(out8)


substep.launches = 0
