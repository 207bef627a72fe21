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
  receiver by receiver; :class:`FusedRemoteDmaExchange` is the transport
  of a ``HaloExchange(fused=True)`` over a mesh, with
  ``last_transfer_count`` (messages sent to another position per dtype
  group) as the JAX transport counts its remote copies.

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

Positions spread over several processes (``DeviceMesh.multi_process``,
the TPU kernels' form between hosts behind a neighbour barrier,
``stencil_tpu/ops/fused_stencil.py:153-162``, ``:328-335``): each rank
pulls the messages into its own positions, so a launch writes only its own
memory (as B6's cross-process form does, ``ops/remote_dma``):

- :func:`fused_exchange_across` is one launch of ``csrc/fused_exchange.cu``
  per dtype group over this rank's receivers: each pointer row (the source
  block at position - d, this rank's or another's mapped through CUDA IPC;
  this rank's block), the +x and -x faces unpaired (a paired row would
  write the sender's memory), the crossing boxes through the wire. Its
  plain version is :func:`fused_exchange_plain`, which fills the
  receivers of this process; on the CPU the same boxes travel over gloo
  (:func:`fused_exchange_gloo`).
- :func:`fused_jacobi_across` is one cooperative launch of
  ``csrc/fused_jacobi.cu`` a step over this rank's positions: its position
  table holds this rank's rows first, swept in phase B, then the mapped
  rows of the positions its messages come from, only read; phase A pulls
  into the local halos, ``grid.sync()``, phase B sweeps. Its plain version
  is :func:`fused_jacobi_mesh_plain`; :func:`fused_step_across` is
  the loop's step (the handshake and this launch on the card, B7's gloo
  form and the local sweeps on the CPU).

Before each launch the rank holds one handshake with every rank its
messages cross to (``parallel/ipc.PhaseOrder.before_all``).

A wrapper takes its plain version only for tensors on the CPU; on a CUDA
tensor it launches its kernel or raises. Launches are counted in
``fused_jacobi.launches``, ``fused_jacobi_mesh.launches``,
``fused_exchange.launches``, ``fused_exchange_across.launches`` and
``fused_jacobi_across.launches``, those through a narrowed wire also in
their ``narrowed``.
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
from .remote_dma import _check_mesh_blocks, receiver_rows
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


def _sources(mesh, r: int, step) -> int:
    """The flat index of position ``r - step``: where the message along
    ``step`` into ``r`` comes from."""
    return mesh.index(mesh.shifted(mesh.position(r), [-c for c in step]))


def fused_exchange_plain(blocks_by_position, spec: GridSpec, plan, mesh, wire=None):
    """Every message of the fused plan into this process's positions (on
    one process every position) in plain PyTorch, direction by direction
    and receiver by receiver: each receiver's halo box on the ``-d`` side
    <- the compute box on the ``d`` side of the block at position - d, for
    every quantity of the group, a crossing message through the narrowed
    ``wire`` when one is given (``halo_fill.wire_round``). The messages
    read compute cells and write halo cells only, so this order gives what
    the kernels' orders give. ``blocks_by_position[i]`` is the group's list
    of blocks at position ``i`` (another process's reached through a mapped
    view), or None where no local position needs it. The plain version of
    :func:`fused_exchange` and :func:`fused_exchange_across`. In place;
    returns ``blocks_by_position``."""
    _check_plan(plan, mesh)
    for ph in plan.fused_phases:
        s, d = box_slices(ph.src, ph.dst, ph.shape)
        for r in mesh.local_positions():
            for src, dst in zip(blocks_by_position[_sources(mesh, r, ph.direction)],
                                blocks_by_position[r]):
                dst[d] = wire_round(src[s], wire) if ph.crossing else src[s]
    return blocks_by_position


def messages_gloo(blocks_by_position, boxes, steps, mesh, narrow=(), wire=None):
    """Direction messages over a mesh spread over processes, on the CPU:
    box ``b`` of every local block's list (``(src, dst, shape)``, from its
    compute cells into halo cells) goes to the block at its position +
    ``steps[b]``, through ``wire`` where ``narrow[b]`` is set
    (``halo_fill.wire_round``): copied into a local receiver, or packed as
    one message to the receiver's rank by gloo ``isend``; the boxes into
    local halos from other ranks arrive by ``irecv`` (the tag names the
    receiver position and the box). ``blocks_by_position[i]`` is None at
    another rank's position. In place; returns ``blocks_by_position``."""
    dist = torch.distributed
    narrow = tuple(narrow) or (False,) * len(boxes)
    reqs, keep, landing = [], [], []
    for b, (box, step) in enumerate(zip(boxes, steps)):
        s, d = box_slices(*box)
        for i in mesh.local_positions():
            j = mesh.index(mesh.shifted(mesh.position(i), step))
            pieces = [wire_round(t[s], wire if narrow[b] else None)
                      for t in blocks_by_position[i]]
            if mesh.is_local(j):
                for t, piece in zip(blocks_by_position[j], pieces):
                    t[d] = piece
            else:
                keep.append(torch.cat([piece.reshape(-1) for piece in pieces]))
                reqs.append(dist.isend(keep[-1], mesh.owner(j), tag=j * len(boxes) + b))
        for r in mesh.local_positions():
            i = _sources(mesh, r, step)
            if mesh.is_local(i):
                continue
            views = [t[d] for t in blocks_by_position[r]]
            buf = torch.empty(sum(v.numel() for v in views), dtype=views[0].dtype)
            reqs.append(dist.irecv(buf, mesh.owner(i), tag=r * len(boxes) + b))
            landing.append((buf, views))
    for req in reqs:
        req.wait()
    for buf, views in landing:
        at = 0
        for v in views:
            v.copy_(buf[at:at + v.numel()].view(v.shape))
            at += v.numel()
    return blocks_by_position


def fused_exchange_gloo(blocks_by_position, spec: GridSpec, plan, mesh, wire=None):
    """:func:`fused_exchange_plain` over a mesh spread over processes, on
    the CPU: the fused plan's messages by :func:`messages_gloo`, a crossing
    one through ``wire``. ``blocks_by_position[i]`` is the group's list of
    blocks at position ``i`` of this process, None at another rank's. In
    place; returns ``blocks_by_position``."""
    _check_plan(plan, mesh)
    phases = plan.fused_phases
    return messages_gloo(blocks_by_position, [(ph.src, ph.dst, ph.shape) for ph in phases],
                         [ph.direction for ph in phases], mesh, [ph.crossing for ph in phases],
                         wire)


def fused_exchange_across(ptrs_of, nq: int, dtype, spec: GridSpec, plan, mesh, dev, wire=None):
    """B7's cross-process form: one launch of ``csrc/fused_exchange.cu``
    that fills every halo box of this process's positions for a same-dtype
    group of ``nq`` quantities, pulling each direction's message from the
    compute cells of the source block at position - d through
    ``ptrs_of(i)`` (its ``nq`` block addresses: this process's, or
    another's mapped through CUDA IPC). The work list is
    :func:`fused_exchange_work`'s boxes with the x faces unpaired (a paired
    row would write the sender's memory too), over ``m`` = local positions
    x quantities, each row's (source, receiver) pair from
    ``remote_dma.receiver_rows``; the crossing boxes round through
    ``wire``. The caller orders the launch after the other processes'
    (``parallel/ipc.PhaseOrder.before_all``). Its plain version is
    :func:`fused_exchange_plain`; on the CPU a mesh spread over
    processes exchanges through :func:`fused_exchange_gloo`."""
    _check_plan(plan, mesh)
    p = spec.padded()
    sz, sy = p.y * p.x, p.x
    word = torch.empty((), dtype=dtype).element_size()
    if word not in (4, 8):
        raise ValueError(f"the exchange copies 4- or 8-byte elements, not {dtype}")
    fmt = wire_format(dtype, wire)
    locs = mesh.local_positions()
    phases = plan.fused_phases
    steps = tuple(ph.direction for ph in phases)
    ends = sorted(across_layout(mesh, steps)[0])
    ptrs = tuple(a for i in ends for a in ptrs_of(i))
    m = len(locs) * nq

    def make():
        boxes = tuple((ph.src, ph.dst, ph.shape) for ph in phases)
        rows = receiver_rows(ptrs_of, nq, mesh, steps, word)
        vec = all(a % row_moves.VECTOR_BYTES == 0 for a in rows) and \
            (sz * word) % row_moves.VECTOR_BYTES == 0 and (sy * word) % row_moves.VECTOR_BYTES == 0
        work = row_moves.move_work(boxes, steps, sz, sy, vec, word, (), m,
                                   tuple(fmt is not None and ph.crossing for ph in phases))
        table = _native.upload(rows + [v for row in work.rows for v in row], dev)
        return (table, m, table.data_ptr() + 8 * len(rows), len(work.rows), work.tasks, word,
                0 if fmt is None else fmt.code, wire_params(fmt), sz, sy)

    table, *rest = _native.kept(
        (str(dev), "row_moves", "fused_exchange_across", phases, (p.z, p.y, p.x),
         tuple(mesh.dim), locs, nq, word, None if fmt is None else fmt.name, tuple(ends), ptrs),
        make)
    rc = _native.lib("fused_exchange").fused_exchange_launch(table.data_ptr(), *rest,
                                                             _native.stream_ptr(dev))
    _native.check(rc, "fused_exchange across processes")
    fused_exchange_across.launches += 1
    fused_exchange_across.narrowed += fmt is not None


fused_exchange_across.launches = 0
fused_exchange_across.narrowed = 0  # the launches through a narrowed wire


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


def position_table(ptrs, dev):
    """A mesh kernel's position table (``csrc/mesh_chunk.cuh``) on ``dev``:
    ``ptrs``, three addresses (curr, nxt, sel) a row, kept per content."""
    return _native.device_table(("mesh_positions", ptrs), lambda: list(ptrs), dev)


def mesh_tables(currs, nxts, sels, dests_by_box, dev):
    """The two device tables of a mesh kernel (``csrc/mesh_chunk.cuh``):
    positions, one row of (curr, nxt, sel) pointers per position, kept per
    pointer order (a loop's swap alternates two); and messages, one row of
    (source position, destination position, box index) per position and
    box, box by box (``dests_by_box[b][i]`` is where position ``i`` sends
    box ``b``)."""
    ptrs = tuple(t.data_ptr() for row in zip(currs, nxts, sels) for t in row)
    pos = position_table(ptrs, dev)
    dests_by_box = tuple(tuple(d) for d in dests_by_box)
    msg = _native.device_table(
        ("mesh_messages", dests_by_box),
        lambda: [v for b, dests in enumerate(dests_by_box) for i, j in enumerate(dests)
                 for v in (i, j, b)], dev)
    return pos, msg


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
        pos.data_ptr(), len(currs), len(currs), msg.data_ptr(), len(currs), segs.data_ptr(),
        len(rows), SEG_COLS, tasks, sz, sy, off.z, off.y, off.x, b.z, b.y, b.x, int(vec),
        0 if wire is None else wire.code, wire_params(wire), dev.index,
        _native.stream_ptr(dev))


def fused_jacobi_mesh_plain(currs, nxts, sels, spec: GridSpec, plan, mesh, wire=None):
    """One fused step of this process's positions of a mesh (on one
    process every position) in plain PyTorch: their ``curr`` halos <- the
    fused plan's messages (:func:`fused_exchange_plain`, in place, the
    crossing ones through ``wire``), then each one's ``nxt`` compute region
    <- the sweep of its ``curr`` reading those halos. ``currs[i]`` is
    position ``i``'s curr block (another process's a mapped view, or None
    where no message comes from it). The plain version of
    :func:`fused_jacobi_mesh` and :func:`fused_jacobi_across`. Returns
    ``(currs, nxts)``."""
    fused_exchange_plain([None if c is None else [c] for c in currs], spec, plan, mesh, wire)
    bspec = spec.block_spec()
    for i in mesh.local_positions():
        sweep_plain(currs[i], nxts[i], sels[i], bspec, NO_WRAP)
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


# (mesh dim, local positions, steps) -> across_layout's result
_layouts: dict = {}


def across_layout(mesh, steps):
    """``(order, rows)`` of a cross-process launch over this process's
    positions, messages along ``steps``: ``order`` the positions of the
    position table's rows, the local ones first, then each other process's
    position a message comes from; ``rows`` the message table, one (source
    row, destination row, box) for each box ``b`` and each local receiver,
    box by box. Kept per layout: it is host work of every launch."""
    locs = mesh.local_positions()
    key = (tuple(mesh.dim), locs, tuple(tuple(st) for st in steps))
    if key not in _layouts:
        srcs = sorted({_sources(mesh, r, st) for st in steps for r in locs} - set(locs))
        order = (*locs, *srcs)
        row = {i: n for n, i in enumerate(order)}
        _layouts[key] = (order, tuple(v for b, st in enumerate(steps) for n, r in enumerate(locs)
                                      for v in (row[_sources(mesh, r, st)], n, b)))
    return _layouts[key]


def across_tables(ptrs_of, mesh, steps, dev):
    """The position and message tables of a mesh kernel's cross-process
    launch (``csrc/mesh_chunk.cuh``) in :func:`across_layout`'s order:
    positions, one row of ``ptrs_of(i)`` (curr, nxt, sel) a local position,
    then one of the curr (mapped; the rest 0) of each other process's
    position a message comes from, kept per pointer order; messages kept
    per content. Returns ``(positions, messages, pointers)``: ``pointers``
    the position table's values, three a row."""
    order, rows = across_layout(mesh, steps)
    ptrs = tuple(v for i in order for v in (ptrs_of(i) if mesh.is_local(i)
                                            else (ptrs_of(i)[0], 0, 0)))
    pos = position_table(ptrs, dev)
    msg = _native.device_table(("mesh_messages_across", rows), lambda: list(rows), dev)
    return pos, msg, ptrs


def fused_jacobi_across(ptrs_of, spec: GridSpec, plan, mesh, dev, wire=None) -> None:
    """B8's cross-process form: one cooperative launch of
    ``csrc/fused_jacobi.cu`` of one fused
    step of this process's positions, ``ptrs_of(i)`` the (curr, nxt, sel)
    addresses of a local position and, at another process's position a
    message comes from, its curr mapped through CUDA IPC first: phase A
    pulls every message into the local halos (the crossing boxes through
    ``wire``), ``grid.sync()``, phase B sweeps the local positions, which
    :func:`across_tables` puts first. The caller orders the launch after the
    other processes' (``parallel/ipc.PhaseOrder.before_all``). Its plain
    version is :func:`fused_jacobi_mesh_plain`."""
    _check_plan(plan, mesh)
    require_face_radius(spec)
    phases = plan.fused_phases
    locs = mesh.local_positions()
    pos, msg, ptrs = across_tables(ptrs_of, mesh, [ph.direction for ph in phases], dev)
    fmt = wire_format(torch.float32, wire)
    p, off, b = spec.padded(), spec.compute_offset(), spec.base
    sz, sy = p.y * p.x, p.x
    vec = all(a % row_moves.VECTOR_BYTES == 0 for a in ptrs if a) and sz % 4 == 0 and \
        sy % 4 == 0
    boxes = tuple((tuple(ph.src), tuple(ph.dst), tuple(ph.shape)) for ph in phases)
    rows, tasks = row_table(boxes, sz, sy, vec, len(locs),
                            tuple(fmt is not None and ph.crossing for ph in phases))
    segs = _native.device_table(("fused_rows", rows), lambda: [v for row in rows for v in row],
                                dev)
    rc = _native.lib("fused_jacobi").fused_jacobi_launch(
        pos.data_ptr(), len(ptrs) // 3, len(locs), msg.data_ptr(), len(locs), segs.data_ptr(),
        len(rows), SEG_COLS, tasks, sz, sy, off.z, off.y, off.x, b.z, b.y, b.x, int(vec),
        0 if fmt is None else fmt.code, wire_params(fmt), dev.index, _native.stream_ptr(dev))
    _native.check(rc, "fused_jacobi across processes")
    fused_jacobi_across.launches += 1
    fused_jacobi_across.narrowed += fmt is not None


fused_jacobi_across.launches = 0
fused_jacobi_across.narrowed = 0  # the launches through a narrowed wire


def peer_pointers(stacks, peers, mesh):
    """``ptr(i)``: the address of position ``i``'s stack of ``stacks`` (a
    quantity's list of per-position stacks, exported by ``peers``,
    ``parallel/ipc.PeerBuffers``): this process's own, or another's mapped
    through CUDA IPC."""
    where = peers.buffer_of(stacks)
    return lambda i: stacks[i].data_ptr() if mesh.is_local(i) else peers.pointer(i, *where)


def fused_step_across(currs, nxts, sels, spec: GridSpec, plan, mesh, wire=None, peers=None):
    """One fused step of this process's positions of a mesh spread over
    processes (lists of one block a position, None at another process's):
    on the card the handshake with every rank the messages cross to
    (``peers.order.before_all``) and one :func:`fused_jacobi_across`
    launch; on the CPU the messages over gloo (:func:`fused_exchange_gloo`,
    the crossing ones through ``wire``), then each local position's sweep.
    Returns ``(currs, nxts)``."""
    locs = mesh.local_positions()
    require_float32_fields(currs[locs[0]], "fused_jacobi across processes")
    dev = currs[locs[0]].device
    if dev.type == "cpu":
        fused_exchange_gloo([None if c is None else [c] for c in currs], spec, plan, mesh, wire)
        bspec = spec.block_spec()
        for i in locs:
            sweep_plain(currs[i], nxts[i], sels[i], bspec, NO_WRAP)
        return currs, nxts
    if peers is None:
        raise RuntimeError("a mesh spread over processes steps on the card through the buffers "
                           "DistributedDomain.realize exports (parallel/ipc.PeerBuffers)")
    curr_of = peer_pointers(currs, peers, mesh)
    peers.order.before_all()
    fused_jacobi_across(lambda i: (curr_of(i), nxts[i].data_ptr(), sels[i].data_ptr())
                        if mesh.is_local(i) else (curr_of(i), 0, 0), spec, plan, mesh, dev, wire)
    return currs, nxts


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
    place. Over positions of several processes (another rank's position
    None in each list): on the card one handshake with every rank the
    messages cross to (``parallel/ipc.PhaseOrder.before_all``), then one
    :func:`fused_exchange_across` launch per dtype group over this rank's
    receivers; on the CPU :func:`fused_exchange_gloo`.
    ``last_transfer_count`` counts the messages sent to another position
    per dtype group (over processes, by this rank's positions)."""

    def __init__(self, ex):
        self.spec = ex.spec
        self.plan = ex.plan
        self.mesh = ex.mesh
        self.wire = ex.wire_dtype
        # positions of other processes: the CUDA IPC buffers and phase order
        # (parallel/ipc.PeerBuffers), attached at realize on the card
        self.across = self.mesh.multi_process
        self.peers = None
        senders = self.mesh.local_positions() if self.across else range(len(self.mesh))
        # messages whose destination is another position, per dtype group
        self._crossing = sum(dests[i] != i for _ph, dests in _messages(self.plan, self.mesh)
                             for i in senders)
        self.last_transfer_count = 0

    def __call__(self, state):
        self.last_transfer_count = 0
        if self.across:
            return self._across(state)
        for _dt, keys in dtype_groups({k: blocks[0] for k, blocks in state.items()}):
            blocks = [[state[k][i] for k in keys] for i in range(len(self.mesh))]
            fused_exchange(blocks, self.spec, self.plan, self.mesh, self.wire)
            self.last_transfer_count += self._crossing
        return state

    def _across(self, state):
        mesh = self.mesh
        locs = mesh.local_positions()
        groups = [keys for _dt, keys in dtype_groups({k: v[locs[0]] for k, v in state.items()})]
        dev = mesh.device  # this process's positions' one device
        if dev.type == "cuda":
            if self.peers is None:
                raise RuntimeError("a mesh spread over processes exchanges on the card through "
                                   "the buffers DistributedDomain.realize exports "
                                   "(parallel/ipc.PeerBuffers)")
            where = {k: peer_pointers(v, self.peers, mesh) for k, v in state.items()}
            self.peers.order.before_all()
        for keys in groups:
            if dev.type == "cpu":
                fused_exchange_gloo([[state[k][i] for k in keys] if mesh.is_local(i) else None
                                     for i in range(len(mesh))], self.spec, self.plan, mesh,
                                    self.wire)
            else:
                fused_exchange_across(lambda i, keys=keys: tuple(where[k](i) for k in keys),
                                      len(keys), state[keys[0]][locs[0]].dtype, self.spec,
                                      self.plan, mesh, dev, self.wire)
            self.last_transfer_count += self._crossing
        return state