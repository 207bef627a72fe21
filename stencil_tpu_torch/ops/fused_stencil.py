"""The fused compute+exchange Jacobi step: one launch per step.

The port's counterpart of ``stencil_tpu.ops.fused_stencil`` for one block on
one device, where every direction of the remote-dma fused plan
(``plan.ir.FusedPhaseIR``) wraps onto the block itself:

- :func:`fused_jacobi` launches ``csrc/fused_jacobi.cu`` (replacing the
  TPU's ``make_fused_jacobi_kernel`` in its all-self-wrap form): the exact-
  extent hand-offs of every direction into ``curr``'s halos, in place, and
  the sweep of the compute region into ``nxt``, in one launch;
- :func:`fused_jacobi_plain` is the same step in plain PyTorch: the
  hand-offs in plan order, then the sweep reading the filled halos.

A wrapper takes its plain version only for tensors on the CPU; on a CUDA
tensor it launches its kernel or raises. Launches are counted in
``fused_jacobi.launches``. The wire-crossing form (several devices) is
ROADMAP.md queue B item 8.
"""

from __future__ import annotations

import ctypes

import torch

from ..domain.grid import GridSpec
from ..geometry import Dim3
from . import _native
from .stencil_kernels import _check_block, _device_of, sweep_plain

NO_WRAP = (False, False, False)


def kernel_supported(spec: GridSpec, resident) -> bool:
    """What the fused and the persistent kernels take: uniform partitions,
    one resident block per device (the JAX package's
    ``fused_kernel_supported`` and ``persistent_kernel_supported``).
    ``HaloExchange`` refuses either variant without it."""
    return spec.is_uniform() and Dim3.of(resident) == Dim3(1, 1, 1)


def box_slices(src, dst, shape):
    """Index tuples ``(..., z, y, x)`` of one hand-off's source and
    destination boxes."""
    return ((..., *(slice(a, a + w) for a, w in zip(src, shape))),
            (..., *(slice(a, a + w) for a, w in zip(dst, shape))))


def box_rows(boxes) -> ctypes.Array:
    """The ``(src, dst, shape)`` boxes as the kernels' table: 9 ints a row."""
    flat = [v for src, dst, shape in boxes for v in (*src, *dst, *shape)]
    return (ctypes.c_int * max(1, len(flat)))(*flat)


def require_face_radius(spec: GridSpec) -> None:
    r = spec.radius
    if min(r.x(-1), r.x(1), r.y(-1), r.y(1), r.z(-1), r.z(1)) < 1:
        raise ValueError("jacobi needs face radius >= 1")


def _plan_boxes(spec: GridSpec, plan):
    if spec.dim != Dim3(1, 1, 1):
        raise NotImplementedError(
            f"partition {spec.dim}: the fused kernel runs one block; the "
            "wire-crossing form is ROADMAP.md queue B item 8")
    if any(ph.crossing for ph in plan.fused_phases):
        raise ValueError("the fused kernel on one block runs self-wrap hand-offs only")
    return [(ph.src, ph.dst, ph.shape) for ph in plan.fused_phases]


def fused_jacobi_plain(curr, nxt, sel, spec: GridSpec, plan):
    """One fused step in plain PyTorch: ``curr``'s halos <- the plan's
    hand-offs (in place), then ``nxt``'s compute region <- the sweep of
    ``curr`` reading those halos. Returns ``(curr, nxt)``."""
    for src, dst, shape in _plan_boxes(spec, plan):
        s, d = box_slices(src, dst, shape)
        curr[d] = curr[s]
    sweep_plain(curr, nxt, sel, spec, NO_WRAP)
    return curr, nxt


def fused_jacobi(curr, nxt, sel, spec: GridSpec, plan):
    """One fused step (see :func:`fused_jacobi_plain`), in place; returns
    ``(curr', out)`` = ``(curr, nxt)``. ``plan`` is the remote-dma fused
    plan of ``spec`` on one device (``HaloExchange(..., fused=True).plan``)."""
    _check_block(curr, spec, torch.float32, "curr")
    _check_block(nxt, spec, torch.float32, "nxt")
    _check_block(sel, spec, torch.int32, "sel")
    require_face_radius(spec)
    boxes = _plan_boxes(spec, plan)
    dev = _device_of(curr, nxt, sel)
    if dev.type == "cpu":
        return fused_jacobi_plain(curr, nxt, sel, spec, plan)
    p, off, b = spec.padded(), spec.compute_offset(), spec.base
    rc = _native.lib("fused_jacobi").fused_jacobi_launch(
        curr.data_ptr(), nxt.data_ptr(), sel.data_ptr(), p.y * p.x, p.x,
        off.z, off.y, off.x, b.z, b.y, b.x, box_rows(boxes), len(boxes), dev.index,
        _native.stream_ptr(dev))
    _native.check(rc, "fused_jacobi")
    fused_jacobi.launches += 1
    return curr, nxt


fused_jacobi.launches = 0
