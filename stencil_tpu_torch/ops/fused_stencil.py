"""The fused remote-dma exchange over a mesh, and the fused compute+exchange
Jacobi step on one block and over a mesh.

The port's counterpart of ``stencil_tpu.ops.fused_stencil``. The fused plan
(``plan.ir.FusedPhaseIR``) moves one exact-extent message per active
direction; every message reads only sender compute cells and writes only
receiver halo cells, so all of them may run at once:

- :func:`fused_exchange` launches ``csrc/fused_exchange.cu`` (replacing the
  TPU's ``make_fused_exchange_kernel``): one launch per (device, dtype
  group) stores every position's messages, crossing and self-wrap alike,
  straight into the destination position's halo boxes (the reference's
  ``ColoDomainKernel``, SURVEY.md section 2.3);
  :func:`fused_exchange_plain` is the same copies by tensor slicing,
  position by position; :class:`FusedRemoteDmaExchange` is the transport
  of a ``HaloExchange(fused=True)`` over a mesh, with
  ``last_transfer_count`` (messages sent to another position per dtype
  group) as the JAX transport counts its remote copies. Positions on
  distinct GPUs will need each launch to wait on its neighbours' previous
  reads (an event per neighbour); ROADMAP.md queue A item 5.

The fused step (the TPU's ``make_fused_jacobi_kernel``) has two forms:

- on one block every direction wraps onto the block itself:
  :func:`fused_jacobi` launches ``csrc/fused_jacobi.cu``'s barrier-free
  kernel, the exact-extent hand-offs of every direction into ``curr``'s
  halos, in place, and the sweep of the compute region into ``nxt``, in one
  launch; :func:`fused_jacobi_plain` is the same step in plain PyTorch, the
  hand-offs in plan order, then the sweep reading the filled halos;
- over a mesh of block positions on one device (the wire-crossing form):
  :func:`fused_jacobi_mesh` launches the same file's cooperative kernel
  (``csrc/mesh_chunk.cuh`` at one substep), once per step for every
  position: every message into the destination position's halos, a
  grid-wide barrier, every position's sweep with no wrap;
  :func:`fused_jacobi_mesh_plain` is :func:`fused_exchange_plain` and then
  one :func:`sweep_plain` per position. The kernel reads its positions'
  pointers and its messages from two tables in device memory
  (:func:`launch_mesh_chunk`), kept per pointer order, so a loop that
  swaps ``curr`` and ``nxt`` uploads nothing after its first two steps.

A wrapper takes its plain version only for tensors on the CPU; on a CUDA
tensor it launches its kernel or raises. Launches are counted in
``fused_jacobi.launches``, ``fused_jacobi_mesh.launches`` and
``fused_exchange.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ..domain.grid import GridSpec
from ..geometry import Dim3
from . import _native
from .halo_fill import dtype_groups
from .remote_dma import _check_mesh_blocks
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
            f"partition {spec.dim}: fused_jacobi runs one block; a mesh of block "
            "positions takes fused_jacobi_mesh")
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


def _messages(plan, mesh):
    """``[(phase, [destination index per position])]`` of the fused plan's
    messages on ``mesh``: the message toward ``d`` goes to position + d."""
    if Dim3.of(plan.mesh_dim) != mesh.dim:
        raise ValueError(f"plan for mesh {plan.mesh_dim}, got mesh {mesh.dim}")
    if not plan.fused_phases or any(ph.src is None for ph in plan.fused_phases):
        raise ValueError("fused_exchange needs the fused plan of a uniform partition")
    return [(ph, mesh.destinations(ph.direction)) for ph in plan.fused_phases]


def fused_exchange_plain(blocks_by_position, spec: GridSpec, plan, mesh):
    """Every message of the fused plan in plain PyTorch, direction by
    direction and position by position: each block's compute box on the
    ``d`` side -> the ``-d`` side halo box of the block at position + d,
    for every quantity of the group. In place; returns
    ``blocks_by_position``."""
    for ph, dests in _messages(plan, mesh):
        s, d = box_slices(ph.src, ph.dst, ph.shape)
        for i, j in enumerate(dests):
            for src, dst in zip(blocks_by_position[i], blocks_by_position[j]):
                dst[d] = src[s]
    return blocks_by_position


def fused_exchange(blocks_by_position, spec: GridSpec, plan, mesh):
    """The fused exchange (see :func:`fused_exchange_plain`) of a same-dtype
    group: ``blocks_by_position[i]`` is the group's list of padded blocks at
    position ``i`` of ``mesh``, every position on the mesh's one device;
    ``plan`` is the remote-dma fused plan of ``spec`` on ``mesh``. CPU
    tensors take :func:`fused_exchange_plain`; CUDA tensors launch
    ``csrc/fused_exchange.cu`` once for every message, or raise. In place;
    returns ``blocks_by_position``."""
    dev = _check_mesh_blocks(blocks_by_position, spec, mesh)
    messages = _messages(plan, mesh)
    if dev.type == "cpu":
        return fused_exchange_plain(blocks_by_position, spec, plan, mesh)
    ptrs = [[b.data_ptr() for b in group] for group in blocks_by_position]

    def rows():
        return [p for _ph, dests in messages for i, j in enumerate(dests)
                for pair in zip(ptrs[i], ptrs[j]) for p in pair]

    key = ("fused_exchange", plan.mesh_dim, tuple(ph.direction for ph, _ in messages),
           tuple(p for group in ptrs for p in group))
    table = _native.device_table(key, rows, dev)
    p = spec.padded()
    boxes = [(ph.src, ph.dst, ph.shape) for ph, _ in messages]
    rc = _native.lib("fused_exchange").fused_exchange_launch(
        table.data_ptr(), len(mesh) * len(ptrs[0]), box_rows(boxes), len(boxes),
        blocks_by_position[0][0].element_size(), p.y * p.x, p.x, dev.index,
        _native.stream_ptr(dev))
    _native.check(rc, "fused_exchange")
    fused_exchange.launches += 1
    return blocks_by_position


fused_exchange.launches = 0


def check_mesh_fields(currs, nxts, sels, spec: GridSpec, mesh) -> torch.device:
    """``currs``, ``nxts`` (float32) and ``sels`` (int32): one contiguous
    padded block of ``spec`` per position of ``mesh``, all on the mesh's one
    device, every ``curr`` and ``nxt`` its own buffer; returns the device."""
    if not len(currs) == len(nxts) == len(sels) == len(mesh):
        raise ValueError(f"{len(currs)} curr, {len(nxts)} nxt and {len(sels)} sel blocks "
                         f"for {len(mesh)} positions")
    dev = _check_mesh_blocks([[c, n] for c, n in zip(currs, nxts)], spec, mesh)
    _check_mesh_blocks([[s] for s in sels], spec, mesh)
    if currs[0].dtype != torch.float32 or sels[0].dtype != torch.int32:
        raise ValueError(f"fields are float32 and sel int32, not {currs[0].dtype} and "
                         f"{sels[0].dtype}")
    if len({t.data_ptr() for t in (*currs, *nxts)}) != 2 * len(mesh):
        raise ValueError("every position's curr and nxt must be distinct buffers")
    return dev


def launch_mesh_chunk(entry, currs, nxts, sels, spec: GridSpec, boxes, dests_by_box, dev,
                      *depth) -> int:
    """Call a mesh chunk entry of ``csrc/mesh_chunk.cuh``
    (``fused_jacobi_mesh_launch``, or ``persistent_jacobi_launch`` with its
    ``depth``) over every position; returns its CUDA error code. Its two
    device tables: positions, one row of (curr, nxt, sel) pointers per
    position, kept per pointer order (a loop's swap alternates two); and
    messages, one row of (source position, destination position, box
    index) per position and box, box by box (``dests_by_box[b][i]`` is
    where position ``i`` sends box ``b``)."""
    ptrs = tuple(t.data_ptr() for row in zip(currs, nxts, sels) for t in row)
    pos = _native.device_table(("mesh_positions", ptrs), lambda: list(ptrs), dev)
    dests_by_box = tuple(tuple(d) for d in dests_by_box)
    msg = _native.device_table(
        ("mesh_messages", dests_by_box),
        lambda: [v for b, dests in enumerate(dests_by_box) for i, j in enumerate(dests)
                 for v in (i, j, b)], dev)
    p, off, b = spec.padded(), spec.compute_offset(), spec.base
    return entry(pos.data_ptr(), len(currs), msg.data_ptr(), len(currs), box_rows(boxes),
                 len(boxes), p.y * p.x, p.x, off.z, off.y, off.x, b.z, b.y, b.x, *depth,
                 dev.index, _native.stream_ptr(dev))


def fused_jacobi_mesh_plain(currs, nxts, sels, spec: GridSpec, plan, mesh):
    """One fused step over a mesh in plain PyTorch: every position's
    ``curr`` halos <- the fused plan's messages (:func:`fused_exchange_plain`,
    in place), then each position's ``nxt`` compute region <- the sweep of
    its ``curr`` reading those halos. Returns ``(currs, nxts)``."""
    fused_exchange_plain([[c] for c in currs], spec, plan, mesh)
    bspec = spec.block_spec()
    for c, n, s in zip(currs, nxts, sels):
        sweep_plain(c, n, s, bspec, NO_WRAP)
    return currs, nxts


def fused_jacobi_mesh(currs, nxts, sels, spec: GridSpec, plan, mesh):
    """One fused step of every position of ``mesh`` (see
    :func:`fused_jacobi_mesh_plain`), in place: lists of one padded block of
    ``spec`` per position, every position on the mesh's one device; ``plan``
    is the remote-dma fused plan of ``spec`` on ``mesh``. CPU tensors take
    the plain version; CUDA tensors launch ``csrc/fused_jacobi.cu``'s
    cooperative kernel once for every position, or raise. Returns
    ``(currs, nxts)``."""
    dev = check_mesh_fields(currs, nxts, sels, spec, mesh)
    require_face_radius(spec)
    messages = _messages(plan, mesh)
    if dev.type == "cpu":
        return fused_jacobi_mesh_plain(currs, nxts, sels, spec, plan, mesh)
    rc = launch_mesh_chunk(_native.lib("fused_jacobi").fused_jacobi_mesh_launch, currs, nxts,
                           sels, spec, [(ph.src, ph.dst, ph.shape) for ph, _ in messages],
                           [dests for _ph, dests in messages], dev)
    _native.check(rc, "fused_jacobi_mesh")
    fused_jacobi_mesh.launches += 1
    return currs, nxts


fused_jacobi_mesh.launches = 0


def fused_jacobi_mesh_bytes(plan, positions: int, spec: GridSpec) -> int:
    """The least bytes a fused mesh step moves: curr and sel read and nxt
    written once per compute cell (12 bytes), each message cell read and
    written once (8 bytes)."""
    return 12 * spec.base.flatten() * positions + fused_exchange_bytes(plan, 1, positions, 4)


def fused_exchange_bytes(plan, nq: int, positions: int, itemsize: int) -> int:
    """Bytes the fused exchange must move for ``nq`` quantities over
    ``positions`` blocks: each message cell read once and written once."""
    cells = sum(ph.shape[0] * ph.shape[1] * ph.shape[2] for ph in plan.fused_phases)
    return 2 * cells * itemsize * nq * positions


class FusedRemoteDmaExchange:
    """The fused remote-dma transport of a ``HaloExchange(fused=True)`` over
    a mesh: one :func:`fused_exchange` call per dtype group. ``state`` is
    ``{key: [block per position]}``; in place."""

    def __init__(self, ex):
        self.spec = ex.spec
        self.plan = ex.plan
        self.mesh = ex.mesh
        # messages whose destination is another position, per dtype group
        self._crossing = sum(j != i for _ph, dests in _messages(self.plan, self.mesh)
                             for i, j in enumerate(dests))
        self.last_transfer_count = 0

    def __call__(self, state):
        self.last_transfer_count = 0
        for _dt, keys in dtype_groups({k: blocks[0] for k, blocks in state.items()}):
            blocks = [[state[k][i] for k in keys] for i in range(len(self.mesh))]
            fused_exchange(blocks, self.spec, self.plan, self.mesh)
            self.last_transfer_count += self._crossing
        return state
