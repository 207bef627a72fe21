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
  ``ColoDomainKernel``, SURVEY.md section 2.3), moving the plan's direction
  boxes by rows (``csrc/row_moves.cuh``, shared with ``remote_axis``) from a
  work list laid out here (:func:`fused_exchange_work`: the rows of
  :func:`message_rows`, the +x and -x faces as one paired segment);
  :func:`fused_exchange_plain` is the same copies by tensor slicing,
  position by position; :class:`FusedRemoteDmaExchange` is the transport
  of a ``HaloExchange(fused=True)`` over a mesh, with
  ``last_transfer_count`` (messages sent to another position per dtype
  group) as the JAX transport counts its remote copies. Positions on
  distinct GPUs will need each launch to wait on its neighbours' previous
  reads (an event per neighbour); ROADMAP.md queue A item 5.

A narrowed wire (``wire=``, the JAX package's ``wire_dtype``) rounds each
floating word of a crossing direction's message (the plan's ``crossing``)
through the wire between its load and its store
(``csrc/wire_round.cuh``; plain: ``halo_fill.wire_round``); a self-wrap
message stays a bit copy. Rounding is idempotent, so this direct form
equals the composed exchange (B6) with the same wire bit for bit, as in the
JAX package. The fused step takes the same wire over a mesh (its fields
are fp32); on one block nothing crosses.

The fused step (the TPU's ``make_fused_jacobi_kernel``) has two forms, and
one kernel body, ``csrc/fused_jacobi.cu``, runs both: one cooperative launch
per step moves every message into the destination position's halos
(phase A), waits at a grid-wide barrier, then sweeps every position's
compute region with no wrap, reading those halos (phase B,
``csrc/sweep_runs.cuh``):

- on one block every direction wraps onto the block itself:
  :func:`fused_jacobi` launches the kernel over a one-position table whose
  messages all wrap onto the block; :func:`fused_jacobi_plain` is the same
  step in plain PyTorch, the hand-offs in plan order, then the sweep
  reading the filled halos;
- over a mesh of block positions on one device (the wire-crossing form):
  :func:`fused_jacobi_mesh` launches it once per step for every position;
  :func:`fused_jacobi_mesh_plain` is :func:`fused_exchange_plain` and then
  one :func:`sweep_plain` per position.

The kernel reads its positions' pointers, its messages and its phase-A
work list from three tables in device memory (:func:`mesh_tables`,
:func:`message_rows`, kept in ``ops/row_moves`` with the carriers' work
lists), the first kept per pointer order, so a loop that
swaps ``curr`` and ``nxt`` uploads nothing after its first two steps. The
work list and the launch shape are pure Python (:func:`message_rows`,
:func:`fused_shape`, :func:`fused_zchunks`), mirrored from the kernel's
source, so the CPU tests hold them to the plain version.

A wrapper takes its plain version only for tensors on the CPU; on a CUDA
tensor it launches its kernel or raises. Launches are counted in
``fused_jacobi.launches``, ``fused_jacobi_mesh.launches`` and
``fused_exchange.launches``, those through a narrowed wire also in
``fused_jacobi_mesh.narrowed`` and ``fused_exchange.narrowed``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..domain.grid import GridSpec
from ..geometry import Dim3
from . import _native, row_moves
from .halo_fill import dtype_groups, wire_format, wire_params, wire_round
from .remote_dma import _check_mesh_blocks
from .row_moves import message_rows
from .stencil_kernels import _check_block, _device_of, sweep_plain

NO_WRAP = (False, False, False)


def kernel_supported(spec: GridSpec, resident) -> bool:
    """What the fused and the persistent kernels take: uniform partitions,
    one resident block per device (the JAX package's
    ``fused_kernel_supported`` and ``persistent_kernel_supported``).
    ``HaloExchange`` refuses either variant on resident blocks; on an uneven
    mesh the fused variant exchanges through the axis carrier and steps by
    the host-orchestrated schedule (``ops/jacobi.py``), and the persistent
    variant raises."""
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


def require_float32_fields(t: torch.Tensor, what: str) -> None:
    """Raise ``NotImplementedError`` for a float64 field: the fused step
    (B8) and the persistent chunk (B9) are float32 kernels, as the JAX
    package builds them (``make_fused_jacobi_kernel`` and
    ``make_persistent_jacobi_kernel`` take no dtype), on the CPU as on the
    card. The JAX package runs a float64 domain through these variants on
    XLA (its kernels are TPU-only); the port runs float64 Jacobi on its
    other paths (ROADMAP.md queue C, Design divergences)."""
    if t.dtype == torch.float64:
        raise NotImplementedError(
            f"{what}: float64 fields with the fused or persistent kernel variant diverge from "
            "the JAX package, which runs them on XLA: these kernels are float32, as the JAX "
            "package builds them; float64 Jacobi runs on the default and plain remote-dma "
            "paths (ROADMAP.md queue C, Design divergences)")


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
    plan of ``spec`` on one device (``HaloExchange(..., fused=True).plan``).
    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/fused_jacobi.cu`` over one position whose messages all wrap onto
    the block, or raise."""
    require_float32_fields(curr, "fused_jacobi")
    _check_block(curr, spec, torch.float32, "curr")
    _check_block(nxt, spec, torch.float32, "nxt")
    _check_block(sel, spec, torch.int32, "sel")
    require_face_radius(spec)
    boxes = _plan_boxes(spec, plan)
    dev = _device_of(curr, nxt, sel)
    if dev.type == "cpu":
        return fused_jacobi_plain(curr, nxt, sel, spec, plan)
    _native.check(_launch_fused([curr], [nxt], [sel], spec, boxes, [(0,)] * len(boxes), dev),
                  "fused_jacobi")
    fused_jacobi.launches += 1
    return curr, nxt


fused_jacobi.launches = 0


def _check_plan(plan, mesh) -> None:
    """Raise unless ``plan`` is the fused plan of a uniform partition on
    ``mesh``."""
    if Dim3.of(plan.mesh_dim) != mesh.dim:
        raise ValueError(f"plan for mesh {plan.mesh_dim}, got mesh {mesh.dim}")
    if not plan.fused_phases or any(ph.src is None for ph in plan.fused_phases):
        raise ValueError("fused_exchange needs the fused plan of a uniform partition")


def _messages(plan, mesh):
    """``[(phase, [destination index per position])]`` of the fused plan's
    messages on ``mesh``: the message toward ``d`` goes to position + d."""
    _check_plan(plan, mesh)
    return [(ph, mesh.destinations(ph.direction)) for ph in plan.fused_phases]


def fused_exchange_plain(blocks_by_position, spec: GridSpec, plan, mesh, wire=None):
    """Every message of the fused plan in plain PyTorch, direction by
    direction and position by position: each block's compute box on the
    ``d`` side -> the ``-d`` side halo box of the block at position + d,
    for every quantity of the group, a crossing message through the
    narrowed ``wire`` when one is given (``halo_fill.wire_round``). In
    place; returns ``blocks_by_position``."""
    for ph, dests in _messages(plan, mesh):
        s, d = box_slices(ph.src, ph.dst, ph.shape)
        for i, j in enumerate(dests):
            for src, dst in zip(blocks_by_position[i], blocks_by_position[j]):
                dst[d] = wire_round(src[s], wire) if ph.crossing else src[s]
    return blocks_by_position


def _x_face_pairs(steps):
    """``((+x box, -x box),)`` when both x faces send a message, else ``()``:
    their row ends share sectors, so they move as one paired segment."""
    if (1, 0, 0) in steps and (-1, 0, 0) in steps:
        return ((steps.index((1, 0, 0)), steps.index((-1, 0, 0))),)
    return ()


def fused_exchange_work(plan, spec: GridSpec, vec: bool, word: int, m: int,
                        narrow: bool = False) -> row_moves.MoveWork:
    """The fused exchange's work list for ``m`` instances (positions x
    quantities) of ``word``-byte words: the plan's direction boxes by rows
    (:func:`message_rows`, the rows B8's phase A moves), the +x and -x
    faces as one paired segment, each box sent by a position to the
    position + its direction; with ``narrow`` the crossing boxes' segments
    round through the wire."""
    p = spec.padded()
    boxes = tuple((ph.src, ph.dst, ph.shape) for ph in plan.fused_phases)
    steps = tuple(ph.direction for ph in plan.fused_phases)
    return row_moves.move_work(boxes, steps, p.y * p.x, p.x, vec, word,
                               _x_face_pairs(steps), m,
                               tuple(narrow and ph.crossing for ph in plan.fused_phases))


def fused_exchange(blocks_by_position, spec: GridSpec, plan, mesh, wire=None):
    """The fused exchange (see :func:`fused_exchange_plain`) of a same-dtype
    group: ``blocks_by_position[i]`` is the group's list of padded blocks at
    position ``i`` of ``mesh``, every position on the mesh's one device;
    ``plan`` is the remote-dma fused plan of ``spec`` on ``mesh``; ``wire``
    the narrowed wire dtype or None. CPU tensors take
    :func:`fused_exchange_plain`; CUDA tensors launch
    ``csrc/fused_exchange.cu`` once for every message (the work list of
    :func:`fused_exchange_work`, with the wire's format for the group's
    dtype), or raise. In place; returns ``blocks_by_position``."""
    dev = _check_mesh_blocks(blocks_by_position, spec, mesh)
    _check_plan(plan, mesh)
    if dev.type == "cpu":
        return fused_exchange_plain(blocks_by_position, spec, plan, mesh, wire)
    p = spec.padded()
    fmt = wire_format(blocks_by_position[0][0].dtype, wire)
    rc = row_moves.launch_moves(
        _native.lib("fused_exchange").fused_exchange_launch, "fused_exchange",
        (plan.fused_phases, p.y * p.x, p.x),
        lambda vec, word, m: fused_exchange_work(plan, spec, vec, word, m, fmt is not None),
        blocks_by_position, mesh, p.y * p.x, p.x, dev, fmt)
    _native.check(rc, "fused_exchange")
    fused_exchange.launches += 1
    fused_exchange.narrowed += fmt is not None
    return blocks_by_position


fused_exchange.launches = 0
fused_exchange.narrowed = 0  # the launches through a narrowed wire


def check_mesh_fields(currs, nxts, sels, spec: GridSpec, mesh, what: str) -> torch.device:
    """``currs``, ``nxts`` (float32; float64 raises
    :func:`require_float32_fields`) and ``sels`` (int32): one contiguous
    padded block of ``spec`` per position of ``mesh``, all on the mesh's one
    device, every ``curr`` and ``nxt`` its own buffer; returns the device."""
    if not len(currs) == len(nxts) == len(sels) == len(mesh):
        raise ValueError(f"{len(currs)} curr, {len(nxts)} nxt and {len(sels)} sel blocks "
                         f"for {len(mesh)} positions")
    require_float32_fields(currs[0], what)
    dev = _check_mesh_blocks([[c, n] for c, n in zip(currs, nxts)], spec, mesh)
    _check_mesh_blocks([[s] for s in sels], spec, mesh)
    if currs[0].dtype != torch.float32 or sels[0].dtype != torch.int32:
        raise ValueError(f"fields are float32 and sel int32, not {currs[0].dtype} and "
                         f"{sels[0].dtype}")
    if len({t.data_ptr() for t in (*currs, *nxts)}) != 2 * len(mesh):
        raise ValueError("every position's curr and nxt must be distinct buffers")
    return dev


def mesh_tables(currs, nxts, sels, dests_by_box, dev):
    """The two device tables of a mesh kernel (``csrc/mesh_chunk.cuh``):
    positions, one row of (curr, nxt, sel) pointers per position, kept per
    pointer order (a loop's swap alternates two); and messages, one row of
    (source position, destination position, box index) per position and
    box, box by box (``dests_by_box[b][i]`` is where position ``i`` sends
    box ``b``)."""
    ptrs = tuple(t.data_ptr() for row in zip(currs, nxts, sels) for t in row)
    pos = _native.device_table(("mesh_positions", ptrs), lambda: list(ptrs), dev)
    dests_by_box = tuple(tuple(d) for d in dests_by_box)
    msg = _native.device_table(
        ("mesh_messages", dests_by_box),
        lambda: [v for b, dests in enumerate(dests_by_box) for i, j in enumerate(dests)
                 for v in (i, j, b)], dev)
    return pos, msg


def launch_mesh_chunk(entry, currs, nxts, sels, spec: GridSpec, boxes, dests_by_box, dev,
                      *depth) -> int:
    """Call the persistent chunk's entry (``persistent_jacobi_launch``, with
    its ``depth``) over every position, with :func:`mesh_tables`; returns
    its CUDA error code."""
    pos, msg = mesh_tables(currs, nxts, sels, dests_by_box, dev)
    p, off, b = spec.padded(), spec.compute_offset(), spec.base
    return entry(pos.data_ptr(), len(currs), msg.data_ptr(), len(currs), box_rows(boxes),
                 len(boxes), p.y * p.x, p.x, off.z, off.y, off.x, b.z, b.y, b.x, *depth,
                 dev.index, _native.stream_ptr(dev))


# The fused step kernel's launch shape (csrc/sweep_runs.cuh: TX, TY, LOOK,
# MIN_BLOCKS; csrc/fused_jacobi.cu: UNROLL, SEG_COLS, MAX_SEGS)
FUSED_TILE = (128, 8)
FUSED_LOOK = 4
FUSED_MIN_BLOCKS = 3
ROW_UNROLL = 4
SEG_COLS = 10
MAX_SEGS = 26 * 3


def fused_shape() -> dict:
    """The fused step kernel's launch shape (``csrc/sweep_runs.cuh``): the
    output tile (``tile``: x, y; the first tile of a row is up to 3 columns
    wider); a thread owns a 4-cell x run of a row of the tile grown by one
    cell (``rows``), a row holding ``runs`` runs, enough for the widest tile
    at any 16-byte phase of its first cell; shared memory holds a guard row,
    a ring of ``LOOK + 2`` planes and a guard row. Phase A's task is
    ``ROW_UNROLL`` units for each thread (``task_units``)."""
    tx, ty = FUSED_TILE
    rows = ty + 2
    runs = (3 + tx + 3 + 2 + 3) // 4
    pitch = 4 * runs
    ring = FUSED_LOOK + 2
    threads = -(-(rows * runs) // 32) * 32
    return {"tile": (tx, ty), "rows": rows, "runs": runs, "pitch": pitch, "ring": ring,
            "threads": threads, "smem_bytes": 4 * (ring * rows * pitch + 2 * pitch),
            "task_units": threads * ROW_UNROLL}


def fused_tiles(spec: GridSpec) -> Tuple[int, int]:
    """Output tiles of one block along x and y: tile 0 of a row spans
    ``[0, TX + a)``, tile t ``[t TX + a, (t + 1) TX + a)`` with
    ``a = -xo mod 4``, so every later tile starts its output on the 16-byte
    grid of the padded row."""
    tx, ty = FUSED_TILE
    b, xo = spec.base, spec.compute_offset().x
    return max(1, -(-(b.x - (-xo % 4)) // tx)), -(-b.y // ty)


def fused_zchunks(spec: GridSpec, positions: int, blocks: int) -> int:
    """z chunks per tile column when ``blocks`` resident blocks walk the
    tiles of ``positions`` blocks of ``spec`` in turn (the kernel's
    ``zchunks_for``): the count whose walk ends soonest, a block taking
    ``ceil(tiles / blocks)`` tiles (the last, partial round included) of
    its chunk's planes plus a 2-step warm-up each; the fewest chunks on a
    tie, no chunk under 4 planes."""
    gx, gy = fused_tiles(spec)
    cols, nz = gx * gy * positions, spec.base.z

    def steps(n):
        c = -(-nz // n)
        return -(-(cols * -(-nz // c)) // blocks) * (c + 2)

    return min(range(1, max(1, nz // 4) + 1), key=lambda n: (steps(n), n))


def fused_info(index: int, wire: int = 0) -> dict:
    """What the fused step kernel's instantiation for the wire code ``wire``
    (a ``halo_fill.WireFormat``'s code: 0 copies bits, ``SOFT_WIRE`` is
    every format the card does not convert) reports on CUDA
    device ``index``: resident blocks per SM, registers and local (spill)
    bytes per thread, threads and dynamic shared memory per block."""
    r = (ctypes.c_int * 5)()
    _native.check(_native.lib("fused_jacobi").fused_jacobi_info(index, wire, r),
                  "fused_jacobi_info")
    return dict(zip(("blocks_per_sm", "regs", "local_bytes", "threads", "smem_bytes"), r))


@functools.lru_cache(maxsize=64)
def row_table(boxes, sz: int, sy: int, vec: bool, messages: int, narrow=()):
    """``(rows, tasks)``: :func:`message_rows` as the kernel's table, one
    row of ``SEG_COLS`` ints a segment (box, src, dst, units, width, ey,
    rows, tasks per message, tasks before it over all ``messages`` messages
    of a box, narrow: 1 where the box's words round through the wire, from
    ``narrow``, one bool a box, empty for none), and the tasks in all."""
    task = fused_shape()["task_units"]
    flags = row_moves.narrow_flags(narrow, len(boxes))
    rows, start = [], 0
    for s in message_rows(boxes, sz, sy, vec):
        chunks = -(-(s.rows * s.units) // task)
        rows.append((s.box, s.src, s.dst, s.units, s.width, s.ey, s.rows, chunks, start,
                     int(flags[s.box])))
        start += messages * chunks
    if not 1 <= len(rows) <= MAX_SEGS:
        raise ValueError(f"{len(rows)} work-list segments outside [1, {MAX_SEGS}]")
    return tuple(rows), start


def _launch_fused(currs, nxts, sels, spec: GridSpec, boxes, dests_by_box, dev, narrow=(),
                  wire=None) -> int:
    """One launch of ``csrc/fused_jacobi.cu`` over every position (one per
    ``currs`` entry), every message box ``b`` sent by position ``i`` to
    ``dests_by_box[b][i]``, the boxes flagged in ``narrow`` through the wire
    format ``wire`` (None: bit copies); returns the CUDA error code."""
    pos, msg = mesh_tables(currs, nxts, sels, dests_by_box, dev)
    p, off, b = spec.padded(), spec.compute_offset(), spec.base
    sz, sy = p.y * p.x, p.x
    align = min(t.data_ptr() & -t.data_ptr() for t in (*currs, *nxts, *sels))
    vec = align % 16 == 0 and sz % 4 == 0 and sy % 4 == 0
    boxes = tuple((tuple(s), tuple(d), tuple(e)) for s, d, e in boxes)
    rows, tasks = row_table(boxes, sz, sy, vec, len(currs), tuple(narrow))
    segs = _native.device_table(("fused_rows", rows), lambda: [v for row in rows for v in row],
                                dev)
    return _native.lib("fused_jacobi").fused_jacobi_launch(
        pos.data_ptr(), len(currs), msg.data_ptr(), len(currs), segs.data_ptr(), len(rows),
        SEG_COLS, tasks, sz, sy, off.z, off.y, off.x, b.z, b.y, b.x, int(vec),
        0 if wire is None else wire.code, wire_params(wire), dev.index,
        _native.stream_ptr(dev))


def fused_jacobi_mesh_plain(currs, nxts, sels, spec: GridSpec, plan, mesh, wire=None):
    """One fused step over a mesh in plain PyTorch: every position's
    ``curr`` halos <- the fused plan's messages (:func:`fused_exchange_plain`,
    in place, the crossing ones through ``wire``), then each position's
    ``nxt`` compute region <- the sweep of its ``curr`` reading those halos.
    Returns ``(currs, nxts)``."""
    fused_exchange_plain([[c] for c in currs], spec, plan, mesh, wire)
    bspec = spec.block_spec()
    for c, n, s in zip(currs, nxts, sels):
        sweep_plain(c, n, s, bspec, NO_WRAP)
    return currs, nxts


def fused_jacobi_mesh(currs, nxts, sels, spec: GridSpec, plan, mesh, wire=None):
    """One fused step of every position of ``mesh`` (see
    :func:`fused_jacobi_mesh_plain`), in place: lists of one padded block of
    ``spec`` per position, every position on the mesh's one device; ``plan``
    is the remote-dma fused plan of ``spec`` on ``mesh``; ``wire`` the
    narrowed wire dtype or None. CPU tensors take the plain version; CUDA
    tensors launch ``csrc/fused_jacobi.cu`` once for every position (phase
    A rounding the crossing boxes' words through the wire), or raise.
    Returns ``(currs, nxts)``."""
    dev = check_mesh_fields(currs, nxts, sels, spec, mesh, "fused_jacobi_mesh")
    require_face_radius(spec)
    messages = _messages(plan, mesh)
    if dev.type == "cpu":
        return fused_jacobi_mesh_plain(currs, nxts, sels, spec, plan, mesh, wire)
    fmt = wire_format(torch.float32, wire)
    rc = _launch_fused(currs, nxts, sels, spec, [(ph.src, ph.dst, ph.shape) for ph, _ in messages],
                       [dests for _ph, dests in messages], dev,
                       [fmt is not None and ph.crossing for ph, _ in messages], fmt)
    _native.check(rc, "fused_jacobi_mesh")
    fused_jacobi_mesh.launches += 1
    fused_jacobi_mesh.narrowed += fmt is not None
    return currs, nxts


fused_jacobi_mesh.launches = 0
fused_jacobi_mesh.narrowed = 0  # the launches through a narrowed wire


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


def fused_exchange_sector_bytes(plan, spec: GridSpec, nq: int, positions: int,
                                itemsize: int) -> int:
    """The 32-byte sectors the fused exchange must touch for ``nq``
    quantities over ``positions`` blocks: a block's message sources read
    once and its halo boxes written once (``row_moves.sector_bytes``); the
    x faces' row ends cost whole sectors, so this is the floor of a copy."""
    p = spec.padded()
    boxes = [(ph.src, ph.dst, ph.shape) for ph in plan.fused_phases]
    return row_moves.sector_bytes(boxes, p.y * p.x, p.x, itemsize) * nq * positions


class FusedRemoteDmaExchange:
    """The fused remote-dma transport of a ``HaloExchange(fused=True)`` over
    a mesh: one :func:`fused_exchange` call per dtype group, through the
    exchange's wire. ``state`` is ``{key: [block per position]}``; in
    place."""

    def __init__(self, ex):
        self.spec = ex.spec
        self.plan = ex.plan
        self.mesh = ex.mesh
        self.wire = ex.wire_dtype
        # messages whose destination is another position, per dtype group
        self._crossing = sum(j != i for _ph, dests in _messages(self.plan, self.mesh)
                             for i, j in enumerate(dests))
        self.last_transfer_count = 0

    def __call__(self, state):
        self.last_transfer_count = 0
        for _dt, keys in dtype_groups({k: blocks[0] for k, blocks in state.items()}):
            blocks = [[state[k][i] for k in keys] for i in range(len(self.mesh))]
            fused_exchange(blocks, self.spec, self.plan, self.mesh, self.wire)
            self.last_transfer_count += self._crossing
        return state
