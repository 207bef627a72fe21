"""The Jacobi sweep and multistep kernels, and their plain PyTorch versions.

The port's counterpart of ``stencil_tpu.ops.pallas_stencil``:

- :func:`sweep` launches ``csrc/jacobi_sweep.cu`` (replacing the TPU's
  ``make_pallas_jacobi_sweep``); :func:`sweep_plain` is the same step in
  plain PyTorch.
- :func:`multistep` launches ``csrc/jacobi_multistep.cu`` (replacing the
  TPU's ``make_pallas_jacobi_multistep`` and ``_make_multistep_row_tiled``
  in their single-block forms): k steps in one launch, the intermediate
  stages kept in shared memory; :func:`multistep_plain` is k plain steps.
- :func:`plan_multistep_depth` is the port's own depth planner, bounded by
  the 227 KB of shared memory a Hopper block may use.

A wrapper takes its plain version only for tensors on the CPU; on a CUDA
tensor it launches its kernel or raises. Each wrapper counts its launches
in ``<wrapper>.launches``.

Arithmetic, identical in kernels and plain versions: the six face
neighbours are summed left to right as ``x_lo + x_hi + y_lo + y_hi + z_lo +
z_hi`` and multiplied by :data:`SIXTH`, 1/6 rounded to float32. That is what
the JAX package computes bit for bit: XLA folds its ``sum / 6`` into that
multiply (a true divide differs in about a third of all cells). PyTorch
keeps each op as written, on the CPU and on CUDA.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..domain.grid import GridSpec
from . import _native

HOT_TEMP = 1.0
COLD_TEMP = 0.0
SIXTH = float(np.float32(1.0) / np.float32(6.0))

# Mirrors csrc/jacobi_multistep.cu: output tile, deepest k the kernel takes,
# and the shared memory one block may use on an H100 (232,448 bytes).
MULTISTEP_TILE = (32, 32)  # (x, y)
MULTISTEP_KMAX = 6
SMEM_LIMIT = 232448
# The deepest depth the planner picks: the deepest whose register windows
# do not spill (ptxas: k=3 fits 64 registers, k=4..6 spill 48-156 bytes),
# which is also the fastest per step at 512^3 on an H100 (PERF.md).
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


def _average(nb) -> torch.Tensor:
    s = nb[0] + nb[1]
    for t in nb[2:]:
        s = s + t
    return s * SIXTH


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
    thresh = (g.x // 10 + 1) ** 2
    z = torch.arange(g.z, device=device).view(-1, 1, 1)
    y = torch.arange(g.y, device=device).view(1, -1, 1)
    x = torch.arange(g.x, device=device).view(1, 1, -1)
    yz = (y - g.y // 2) ** 2 + (z - g.z // 2) ** 2
    hot = (x - g.x // 3) ** 2 + yz < thresh
    cold = ~hot & ((x - g.x * 2 // 3) ** 2 + yz < thresh)
    return hot, cold


def multistep_plain(curr, nxt, spec: GridSpec, k: int):
    """``k`` Jacobi steps of a single-block periodic domain in plain
    PyTorch, spheres from coordinates; writes the compute region of
    ``nxt`` (in place; returns it)."""
    _require_single_block(spec)
    hot, cold = sphere_masks_from_coords(spec, curr.device)
    cs = _region(spec)
    c = curr[cs]
    for _ in range(k):
        avg = _average([torch.roll(c, sh, dim) for dim in (-1, -2, -3) for sh in (1, -1)])
        c = torch.where(hot, HOT_TEMP, torch.where(cold, COLD_TEMP, avg))
    nxt[cs] = c
    return nxt


def multistep_smem_bytes(k: int) -> int:
    """Shared memory of one multistep block at depth ``k``: two planes of
    the tile grown by k cells for each of stages 0..k-1 (the kernel exports
    the same formula as ``jacobi_multistep_smem_bytes``)."""
    tx, ty = MULTISTEP_TILE
    return 4 * 2 * k * (ty + 2 * k) * (tx + 2 * k)


def plan_multistep_depth(k_want: int) -> int:
    """The deepest k <= ``k_want`` up to ``MULTISTEP_KPLAN``. Every depth
    the kernel takes fits one block's shared memory (``SMEM_LIMIT``); its
    register windows are what bind. Unlike the TPU planner it does not
    depend on the plane size: the kernel tiles x and y, so 512^3 and 768^3
    get the same depth."""
    return max(0, min(k_want, MULTISTEP_KPLAN))


def _require_single_block(spec: GridSpec) -> None:
    if spec.dim.flatten() != 1:
        raise NotImplementedError(
            "the multistep kernel runs single-block domains; the deep-halo "
            "form for multi-block partitions is slice 2 of ROADMAP.md")


def _check_block(t: torch.Tensor, spec: GridSpec, dtype, what: str) -> None:
    p = spec.padded()
    if t.dtype != dtype:
        raise ValueError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape[-3:]) != (p.z, p.y, p.x) or t.numel() != p.z * p.y * p.x:
        raise ValueError(f"{what}: shape {tuple(t.shape)} is not one padded "
                         f"({p.z}, {p.y}, {p.x}) block")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


def _device_of(*ts) -> torch.device:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("operands on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"kernels run on cuda or cpu tensors, not {dev}")
    if ts[0].data_ptr() == ts[1].data_ptr():
        raise ValueError("curr and nxt must be distinct buffers")
    return dev


def sweep(curr, nxt, sel, spec: GridSpec, wrap=(True, True, True)):
    """One Jacobi step: ``nxt``'s compute region <- the 6-neighbour average
    of ``curr`` with the ``sel`` spheres imposed (in place; returns
    ``nxt``). See :func:`sweep_plain` for the arguments."""
    _check_block(curr, spec, torch.float32, "curr")
    _check_block(nxt, spec, torch.float32, "nxt")
    _check_block(sel, spec, torch.int32, "sel")
    dev = _device_of(curr, nxt, sel)
    if dev.type == "cpu":
        return sweep_plain(curr, nxt, sel, spec, wrap)
    p, off, b = spec.padded(), spec.compute_offset(), spec.base
    rc = _native.lib("jacobi_sweep").jacobi_sweep_launch(
        curr.data_ptr(), nxt.data_ptr(), sel.data_ptr(), p.y * p.x, p.x,
        off.z, off.y, off.x, b.z, b.y, b.x,
        int(wrap[0]), int(wrap[1]), int(wrap[2]), dev.index, _native.stream_ptr(dev))
    _native.check(rc, "jacobi_sweep")
    sweep.launches += 1
    return nxt


sweep.launches = 0


def multistep_zchunks(spec: GridSpec, k: int) -> int:
    """z chunks per tile column: enough blocks to give each of the 132 SMs
    one, without a chunk shorter than 4k planes (each chunk re-runs a 2k
    warm-up)."""
    tx, ty = MULTISTEP_TILE
    b = spec.base
    tiles = -(-b.x // tx) * -(-b.y // ty)
    return max(1, min(-(-132 // tiles), b.z // max(4 * k, 1)))


def multistep(curr, nxt, spec: GridSpec, k: int):
    """``k`` Jacobi steps of a single-block periodic domain in one launch:
    ``nxt``'s compute region <- the field after k steps (in place; returns
    ``nxt``). The spheres are the standard jacobi3d spheres, derived from
    coordinates."""
    _require_single_block(spec)
    _check_block(curr, spec, torch.float32, "curr")
    _check_block(nxt, spec, torch.float32, "nxt")
    if not 1 <= k <= min(MULTISTEP_KMAX, spec.base.z):
        raise ValueError(f"multistep depth {k} outside [1, {MULTISTEP_KMAX}] "
                         f"or deeper than the {spec.base.z} planes")
    dev = _device_of(curr, nxt)
    if dev.type == "cpu":
        return multistep_plain(curr, nxt, spec, k)
    p, off, b, g = spec.padded(), spec.compute_offset(), spec.base, spec.global_size
    rc = _native.lib("jacobi_multistep").jacobi_multistep_launch(
        curr.data_ptr(), nxt.data_ptr(), p.y * p.x, p.x,
        off.z, off.y, off.x, b.z, b.y, b.x, k, g.x, g.y, g.z,
        multistep_zchunks(spec, k), _native.stream_ptr(dev))
    _native.check(rc, "jacobi_multistep")
    multistep.launches += 1
    return nxt


multistep.launches = 0
