"""The remote-dma halo exchange over a mesh of block positions.

The port's counterpart of ``stencil_tpu.ops.remote_dma``. A mesh
(``parallel.mesh.DeviceMesh``) holds one block per position, each its own
allocation (on more blocks than positions, or on the resident blocks of
one device, every block is an endpoint: :class:`RemoteDmaExchange`); each
axis phase of the composed x -> y -> z geometry (the
plan's ``RemoteDmaPhaseIR``) moves every position's two boundary slabs
straight into its ring neighbours' halos:

- :func:`remote_axis` launches ``csrc/remote_axis.cu`` (replacing the TPU's
  ``make_remote_axis_kernel``): one launch per (device, axis phase, dtype
  group) for every position on the device, each a sender, storing through
  the neighbour block's pointer (the reference's same-GPU
  ``PeerAccessSender``, tx_cuda.cuh:41-113, and colocated
  ``ColoQuantityKernel`` writes). On one card a (2,2,2) exchange is 3
  launches per dtype group, not 24. The kernel moves the phase's two slab
  boxes by rows (``csrc/row_moves.cuh``, shared with the fused exchange)
  from a work list laid out here (:func:`remote_axis_work`): the x phase's
  two slabs as one paired segment, each boundary row's two row ends on
  adjacent lanes; the y and z phases' whole padded rows as 16-byte vectors;
- :func:`remote_axis_plain` is the same copies by tensor slicing, position
  by position;
- with a narrowed wire (``wire=``, the JAX package's ``wire_dtype``) each
  floating word of a slab that leaves its position is rounded through the
  wire between its load and its store (``csrc/wire_round.cuh``; the plain
  version ``halo_fill.wire_round``): the TPU kernel's narrow VMEM staging
  and widening unpack, bit for bit, in the same one launch. With one block
  a position every slab of a ring phase leaves; over the blocks of an
  oversubscribed mesh only the slabs between positions do, and the shifts
  between the residents of one position stay bit copies
  (:func:`remote_axis_local` marks them, per sender block and direction).
  An integer group copies bits; an axis with one position is a self-wrap
  fill and never narrows;
- :class:`RemoteDmaExchange` is the transport of a ``HaloExchange`` over a
  mesh: ring phases through :func:`remote_axis`, an axis with one position
  through the fill kernel (``ops/halo_fill.self_fill``) on every position;
  ``last_transfer_count`` counts the slabs sent to another position in the
  last exchange, as the JAX transport counts its remote copies (one per
  side, position and dtype group: independent of the quantity count).

Uneven (remainder) partitions, as the TPU kernel takes them: along a ring
the slab extents are the same for every block, and only where a block's
hi side starts depends on its own size ``n_i`` (the TPU kernel reads it
from the plan's size table as ``sz_my``). Each block's hi slab is
``[o + n_i - rm, o + n_i)`` and its hi halo ``[o + n_i, o + n_i + rp)``.
The kernel keeps the uniform work list and takes the uneven ring through
its pointer table (:func:`remote_axis_shifts`): the box that sends the hi
slab forward moves its sender's pointer by ``(n_i - base)`` planes, rows or
words, and the box that sends the lo slab back moves its receiver's; in
the x phase's paired segment both hi sides are the sender's. One launch
per phase and dtype group, as on a uniform ring.

Ordering. Within a phase every read is of a compute row along the axis and
every write of a halo row along it, which are disjoint (the block is at
least the radius wide), so positions may run in any order inside a launch.
Between phases a position's halo rows along x are read by phase y (the y
slabs span the full padded x extent), so phase y must follow every phase-x
launch: in one process every launch is on the current stream, in order.

Positions spread over several processes (``DeviceMesh.multi_process``):
each rank's launch of a phase covers the messages into its own positions,
one launch per (axis phase, dtype group) with the rows of the uniform work
list unpaired (:func:`remote_axis_across`): each row pairs a sender block,
local or mapped through CUDA IPC (``parallel/ipc.PeerBuffers``, in the
buffer order of the current step), with the rank's own receiver block, so
a rank writes only its own memory. Before each phase the ranks run the TPU
kernel's neighbour barrier (``stencil_tpu/ops/remote_dma.py:153-160``) as
an event per neighbouring rank (``parallel/ipc.PhaseOrder``). On the CPU
the same slabs travel over gloo (:func:`remote_axis_gloo`). Positions on
another card or host (NCCL between GPUs) are ROADMAP.md queue A item 5.

A wrapper takes its plain version only for tensors on the CPU; on a CUDA
tensor it launches its kernel or raises. Launches are counted in
``remote_axis.launches``, those through a narrowed wire also in
``remote_axis.narrowed``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..domain.grid import GridSpec
from ..geometry import Dim3
from . import _native, row_moves
from .halo_fill import (MAX_FILL_GROUP, _AXIS_DIM, _axis_slice, axis_geom, axis_sizes,
                        dtype_groups, self_fill, wire_format, wire_params, wire_round)


def _check_mesh_blocks(blocks_by_position: Sequence[Sequence[torch.Tensor]], spec: GridSpec,
                       mesh) -> torch.device:
    """Every position holds the same number of same-dtype, contiguous padded
    blocks of ``spec`` on the mesh's one device; returns that device."""
    if len(blocks_by_position) != len(mesh):
        raise ValueError(f"{len(blocks_by_position)} block groups for {len(mesh)} positions")
    dev = mesh.device
    p = spec.padded()
    nq = len(blocks_by_position[0])
    if nq < 1:
        raise ValueError("empty quantity group")
    b0 = blocks_by_position[0][0]
    for group in blocks_by_position:
        if len(group) != nq:
            raise ValueError("every position carries the same quantities")
        for b in group:
            if b.dtype != b0.dtype or b.device != dev:
                raise ValueError(f"a group shares one dtype and sits on the mesh's device {dev}")
            if tuple(b.shape[-3:]) != (p.z, p.y, p.x) or b.numel() != p.z * p.y * p.x:
                raise ValueError(f"block shape {tuple(b.shape)} is not one padded "
                                 f"({p.z}, {p.y}, {p.x}) block")
            if not b.is_contiguous():
                raise ValueError("blocks must be contiguous")
    if b0.element_size() not in (4, 8):
        raise ValueError(f"the exchange copies 4- or 8-byte elements, not {b0.dtype}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the mesh kernels run on cuda or cpu tensors, not {dev}")
    return dev


def _check_phase(spec: GridSpec, phase, mesh) -> None:
    if not (phase.ring > 1 and phase.active):
        raise ValueError("remote_axis needs an active phase over a ring of several positions "
                         "(an axis with one position is a self-wrap fill)")
    if mesh.ring(phase.axis) != phase.ring:
        raise ValueError(f"phase ring {phase.ring} != the mesh's {mesh.ring(phase.axis)} "
                         f"positions along {phase.axis}")
    _o, _n, rm, rp = axis_geom(spec, phase.axis)
    n = min(axis_sizes(spec, phase.axis))
    if n < max(rm, rp):
        raise ValueError(f"{phase.axis}-axis block size {n} < radius {max(rm, rp)}")


def ring_sizes(spec: GridSpec, axis: str, mesh):
    """Each position's block size along ``axis``, in the mesh's flat order."""
    sizes, k = axis_sizes(spec, axis), "xyz".index(axis)
    return tuple(sizes[pos[k]] for pos in mesh.positions())


def remote_axis_plain(blocks_by_position, spec: GridSpec, phase, mesh, wire=None, local=None):
    """One axis phase in plain PyTorch, position by position: each block's
    hi slab ``[o + n_i - rm, o + n_i)`` along ``phase.axis`` (``n_i`` its own
    size, :func:`ring_sizes`) -> its forward ring neighbour's lo halo
    ``[o - rm, o)``, its lo slab ``[o, o + rp)`` -> its backward neighbour
    ``b``'s hi halo ``[o + n_b, o + n_b + rp)``, over the full padded extent
    of the other axes, for every quantity of the group, each slab through
    the narrowed ``wire`` when one is given (``halo_fill.wire_round``),
    except a slab ``local`` (:func:`remote_axis_local`) marks as staying on
    its position. In place; returns ``blocks_by_position``."""
    o, _base, rm, rp = axis_geom(spec, phase.axis)
    sizes = ring_sizes(spec, phase.axis, mesh)
    k = "xyz".index(phase.axis)
    marks = dict(local or ())
    fwd_local, bwd_local = (marks.get(tuple(sign if a == k else 0 for a in range(3)))
                            for sign in (1, -1))
    for i, pos in enumerate(mesh.positions()):
        bwd, fwd = (mesh.index(q) for q in mesh.ring_neighbors(pos, phase.axis))
        n, nb = sizes[i], sizes[bwd]
        fwd_wire = None if fwd_local and fwd_local[i] else wire
        bwd_wire = None if bwd_local and bwd_local[i] else wire
        for q, src in enumerate(blocks_by_position[i]):
            if rm:
                dst = blocks_by_position[fwd][q]
                dst[_axis_slice(dst, phase.axis, o - rm, o)] = wire_round(
                    src[_axis_slice(src, phase.axis, o + n - rm, o + n)], fwd_wire)
            if rp:
                dst = blocks_by_position[bwd][q]
                dst[_axis_slice(dst, phase.axis, o + nb, o + nb + rp)] = wire_round(
                    src[_axis_slice(src, phase.axis, o, o + rp)], bwd_wire)
    return blocks_by_position


def remote_axis_local(axis: str, partition, resident):
    """Which slabs of an axis phase over every block of ``partition``
    (blocks a position holds: ``resident``, each a Dim3) stay on their
    position: ``((step, flags), ...)`` for the forward and backward steps,
    one bool a sender block in the block mesh's flat order, set where the
    block and its ring neighbour share a position (a shift between
    residents). With one block a position nothing stays; on an axis whose
    positions' ring is 1 everything does (``remote_emu``'s ``m > 1``)."""
    k = "xyz".index(axis)
    dims = (partition.x, partition.y, partition.z)
    nb, c = dims[k], (resident.x, resident.y, resident.z)[k]
    out = []
    for sign in (1, -1):
        flags = []
        for i in range(partition.flatten()):
            j = (i % dims[0], (i // dims[0]) % dims[1], i // (dims[0] * dims[1]))[k]
            flags.append(j // c == (j + sign) % nb // c)
        out.append((tuple(sign if a == k else 0 for a in range(3)), tuple(flags)))
    return tuple(out)


def remote_axis_boxes(axis: str, geom, ext, paired: bool = True):
    """``(boxes, steps, pairs)`` of one axis phase, for the axis's
    ``geom`` = ``(o, n, rm, rp)`` (``halo_fill.axis_geom``) and the padded
    block's ``ext`` (z, y, x): the hi slab ``[o + n - rm, o + n)`` -> lo halo
    ``[o - rm, o)`` sent forward and the lo slab ``[o, o + rp)`` -> hi halo
    ``[o + n, o + n + rp)`` sent back, each a ``(src, dst, shape)`` box in
    (z, y, x) over the full padded extent of the other two axes, with its
    (dx, dy, dz) step; an empty slab is left out. In the x phase the two are
    a pair: their row ends share sectors (``row_moves``)."""
    o, n, rm, rp = geom
    a, k = _AXIS_DIM[axis], "xyz".index(axis)
    boxes, steps = [], []
    for src, dst, width, sign in ((o + n - rm, o - rm, rm, 1), (o, o + n, rp, -1)):
        if width:
            boxes.append((tuple(src if i == a else 0 for i in range(3)),
                          tuple(dst if i == a else 0 for i in range(3)),
                          tuple(width if i == a else e for i, e in enumerate(ext))))
            steps.append(tuple(sign if i == k else 0 for i in range(3)))
    pairs = ((0, 1),) if paired and axis == "x" and len(boxes) == 2 else ()
    return tuple(boxes), tuple(steps), pairs


def remote_axis_work(spec: GridSpec, axis: str, vec: bool, word: int, m: int,
                     narrow: bool = False) -> row_moves.MoveWork:
    """The phase's work list for ``m`` instances (positions x quantities)
    of ``word``-byte words: the slab boxes of :func:`remote_axis_boxes` by
    rows, the x phase's two slabs as one paired segment, the y and z
    phases' whole padded rows as 16-byte vectors where ``vec``; with
    ``narrow`` every segment rounds through the wire (a ring phase's slabs
    all cross)."""
    p = spec.padded()
    boxes, steps, pairs = remote_axis_boxes(axis, axis_geom(spec, axis), (p.z, p.y, p.x))
    return row_moves.move_work(boxes, steps, p.y * p.x, p.x, vec, word, pairs, m,
                               (narrow,) * len(boxes))


def remote_axis_shifts(spec: GridSpec, axis: str, mesh, paired: bool = True) -> dict:
    """The uneven ring's pointer moves (``row_moves.pointer_rows``): for
    each pointer group's step of the phase's work list, the word offset
    ``(n_i - base) * stride`` of each position's hi side, on the block
    whose hi side the group's box touches: the sender's for the hi slab
    sent forward (and both halves of the x phase's paired segment), the
    receiver's for the lo slab sent back into its hi halo. Empty on a
    uniform ring."""
    o, base, rm, rp = axis_geom(spec, axis)
    sizes = ring_sizes(spec, axis, mesh)
    if all(n == base for n in sizes):
        return {}
    p = spec.padded()
    stride = {"x": 1, "y": p.x, "z": p.y * p.x}[axis]
    hi = tuple((n - base) * stride for n in sizes)
    _boxes, steps, pairs = remote_axis_boxes(axis, (o, base, rm, rp), (p.z, p.y, p.x), paired)
    partners = {c for _b, c in pairs}
    return {step: ((hi, None) if sum(step) > 0 else (None, hi))
            for b, step in enumerate(steps) if b not in partners}


def remote_axis(blocks_by_position, spec: GridSpec, phase, mesh, wire=None, local=None):
    """One axis phase of the remote-dma exchange (see
    :func:`remote_axis_plain`) for a same-dtype group: ``blocks_by_position[i]``
    is the group's list of padded blocks at position ``i`` of ``mesh``
    (flat order), every position on the mesh's one device; ``wire`` the
    narrowed wire dtype or None; ``local`` the slabs that stay on their
    position (:func:`remote_axis_local`; None: every slab leaves). CPU
    tensors take :func:`remote_axis_plain`; CUDA tensors launch
    ``csrc/remote_axis.cu`` once for every position and quantity (the work
    list of :func:`remote_axis_work`, with the wire's format for the group's
    dtype and the local senders marked in the pointer rows; on an uneven
    ring the pointers moved by :func:`remote_axis_shifts`), or raise. In
    place; returns ``blocks_by_position``."""
    _check_phase(spec, phase, mesh)
    dev = _check_mesh_blocks(blocks_by_position, spec, mesh)
    if dev.type == "cpu":
        return remote_axis_plain(blocks_by_position, spec, phase, mesh, wire, local)
    p = spec.padded()
    fmt = wire_format(blocks_by_position[0][0].dtype, wire)
    if local and all(all(flags) for _step, flags in local):
        fmt = None  # every slab stays on its position: bit copies
    geometry = (phase.axis, axis_geom(spec, phase.axis), (p.z, p.y, p.x),
                axis_sizes(spec, phase.axis))
    rc = row_moves.launch_moves(
        _native.lib("remote_axis").remote_axis_launch, "remote_axis", geometry,
        lambda vec, word, m: remote_axis_work(spec, phase.axis, vec, word, m, fmt is not None),
        blocks_by_position, mesh, p.y * p.x, p.x, dev, fmt,
        lambda: remote_axis_shifts(spec, phase.axis, mesh), local)
    _native.check(rc, f"remote_axis[{phase.axis}]")
    remote_axis.launches += 1
    remote_axis.narrowed += fmt is not None
    return blocks_by_position


remote_axis.launches = 0
remote_axis.narrowed = 0  # the launches that round anything through a narrowed wire


def remote_axis_gloo(blocks_by_position, spec: GridSpec, phase, mesh, wire=None):
    """:func:`remote_axis_plain` over a mesh spread over processes, on the
    CPU: ``blocks_by_position[i]`` is the group's list of blocks at
    position ``i`` of this process, None at another rank's. Each local
    sender's two slabs (the slices of :func:`remote_axis_plain`, each
    rounded through ``wire``) are copied into a local receiver, or go out
    packed as one message a side to the receiver's rank by gloo
    ``isend``; the slabs into local halos from other ranks arrive by
    ``irecv`` (the tag names the receiver position and side). In place;
    returns ``blocks_by_position``."""
    dist = torch.distributed
    axis = phase.axis
    o, _base, rm, rp = axis_geom(spec, axis)
    sizes = ring_sizes(spec, axis, mesh)
    reqs, keep, landing = [], [], []
    for i in mesh.local_positions():
        bwd, fwd = (mesh.index(q) for q in mesh.ring_neighbors(mesh.position(i), axis))
        src = blocks_by_position[i]
        # side 0: a hi slab into the forward neighbour's lo halo; side 1: a
        # lo slab into the backward neighbour's hi halo
        for width, dest, lo, side in ((rm, fwd, o + sizes[i] - rm, 0), (rp, bwd, o, 1)):
            if not width:
                continue
            slabs = [wire_round(b[_axis_slice(b, axis, lo, lo + width)], wire) for b in src]
            if mesh.is_local(dest):
                at = o - rm if side == 0 else o + sizes[dest]
                for b, piece in zip(blocks_by_position[dest], slabs):
                    b[_axis_slice(b, axis, at, at + width)] = piece
            else:
                keep.append(torch.cat([piece.reshape(-1) for piece in slabs]))
                reqs.append(dist.isend(keep[-1], mesh.owner(dest), tag=2 * dest + side))
        for width, sender, at, side in ((rm, bwd, o - rm, 0), (rp, fwd, o + sizes[i], 1)):
            if not width or mesh.is_local(sender):
                continue
            views = [b[_axis_slice(b, axis, at, at + width)] for b in src]
            buf = torch.empty(sum(v.numel() for v in views), dtype=src[0].dtype)
            reqs.append(dist.irecv(buf, mesh.owner(sender), tag=2 * i + side))
            landing.append((buf, views))
    for req in reqs:
        req.wait()
    for buf, views in landing:
        at = 0
        for v in views:
            v.copy_(buf[at:at + v.numel()].view(v.shape))
            at += v.numel()
    return blocks_by_position


def remote_axis_receivers_plain(blocks_by_position, spec: GridSpec, phase, mesh, wire=None):
    """The plain version of :func:`remote_axis_across`: the slabs of
    :func:`remote_axis_plain` that land in this process's positions, each
    receiver's lo halo from its backward neighbour's hi slab and its hi halo
    from its forward neighbour's lo slab, through ``wire``.
    ``blocks_by_position[i]`` is the group's list of blocks at position
    ``i`` (another process's reached through a mapped view), or None where
    no local position needs it. In place; returns ``blocks_by_position``."""
    o, _base, rm, rp = axis_geom(spec, phase.axis)
    sizes = ring_sizes(spec, phase.axis, mesh)
    for r in mesh.local_positions():
        bwd, fwd = (mesh.index(q) for q in mesh.ring_neighbors(mesh.position(r), phase.axis))
        for q, dst in enumerate(blocks_by_position[r]):
            if rm:
                src, n = blocks_by_position[bwd][q], sizes[bwd]
                dst[_axis_slice(dst, phase.axis, o - rm, o)] = wire_round(
                    src[_axis_slice(src, phase.axis, o + n - rm, o + n)], wire)
            if rp:
                src = blocks_by_position[fwd][q]
                at = o + sizes[r]
                dst[_axis_slice(dst, phase.axis, at, at + rp)] = wire_round(
                    src[_axis_slice(src, phase.axis, o, o + rp)], wire)
    return blocks_by_position


def receiver_rows(ptrs_of, nq: int, mesh, steps, word: int, shifts=None):
    """The pointer table of a launch over this process's receivers: for
    each group's step and each local position ``r`` and quantity, (block of
    the sender ``r - step``, block of ``r``), from ``ptrs_of(i)`` (the
    group's ``nq`` addresses at position ``i``, local or mapped);
    ``shifts`` as for ``row_moves.pointer_rows``, by the sender's and the
    receiver's position."""
    rows = []
    for step in steps:
        back = tuple(-c for c in step)
        s_off, r_off = (shifts or {}).get(step, (None, None))
        for r in mesh.local_positions():
            i = mesh.index(mesh.shifted(mesh.position(r), back))
            src, dst = ptrs_of(i), ptrs_of(r)
            for q in range(nq):
                rows += [src[q] + (word * s_off[i] if s_off else 0),
                         dst[q] + (word * r_off[r] if r_off else 0)]
    return rows


def remote_axis_across(ptrs_of, nq: int, dtype, spec: GridSpec, phase, mesh, dev, wire=None):
    """B6's cross-process form: one launch of ``csrc/remote_axis.cu`` that
    fills every halo of this process's positions along ``phase.axis`` for a
    same-dtype group of ``nq`` quantities, reading each sender's boundary
    slab through ``ptrs_of(i)`` (its ``nq`` block addresses: this process's,
    or another's mapped through CUDA IPC). The work list is the uniform
    one of :func:`remote_axis_work`, unpaired (a paired x row would write
    the sender's memory too), over ``m`` = local positions x quantities;
    each row's (sender, receiver) pair comes from :func:`receiver_rows`,
    moved on an uneven ring (:func:`remote_axis_shifts`); every slab
    crosses positions, so a narrowed ``wire`` rounds them all. The caller
    orders the launch after its neighbours' (``parallel/ipc.PhaseOrder``).
    Its plain version is :func:`remote_axis_receivers_plain`; on the CPU a
    mesh spread over processes exchanges through :func:`remote_axis_gloo`."""
    _check_phase(spec, phase, mesh)
    p = spec.padded()
    sz, sy = p.y * p.x, p.x
    word = torch.empty((), dtype=dtype).element_size()
    if word not in (4, 8):
        raise ValueError(f"the exchange copies 4- or 8-byte elements, not {dtype}")
    fmt = wire_format(dtype, wire)
    locs = mesh.local_positions()
    # the blocks the rows name: the receivers and their ring neighbours
    ends = sorted({j for r in locs for j in
                   (r, *(mesh.index(q) for q in mesh.ring_neighbors(mesh.position(r),
                                                                   phase.axis)))})
    ptrs = tuple(a for i in ends for a in ptrs_of(i))
    geom = axis_geom(spec, phase.axis)
    m = len(locs) * nq

    def make():
        shifts = remote_axis_shifts(spec, phase.axis, mesh, paired=False)
        boxes, steps, _pairs = remote_axis_boxes(phase.axis, geom, (p.z, p.y, p.x), False)
        rows = receiver_rows(ptrs_of, nq, mesh, steps, word, shifts)
        vec = all(a % row_moves.VECTOR_BYTES == 0 for a in rows) and \
            (sz * word) % row_moves.VECTOR_BYTES == 0 and (sy * word) % row_moves.VECTOR_BYTES == 0
        # unpaired, every box has its pointer group, in the boxes' order
        work = row_moves.move_work(boxes, steps, sz, sy, vec, word, (), m,
                                   (fmt is not None,) * len(boxes))
        table = _native.upload(rows + [v for row in work.rows for v in row], dev)
        return (table, m, table.data_ptr() + 8 * len(rows), len(work.rows), work.tasks, word,
                0 if fmt is None else fmt.code, wire_params(fmt), sz, sy)

    table, *rest = _native.kept(
        (str(dev), "row_moves", "remote_axis_across", phase.axis, geom, (p.z, p.y, p.x),
         axis_sizes(spec, phase.axis), tuple(mesh.dim), locs, nq, word,
         None if fmt is None else fmt.name, tuple(ends), ptrs), make)
    rc = _native.lib("remote_axis").remote_axis_launch(table.data_ptr(), *rest,
                                                       _native.stream_ptr(dev))
    _native.check(rc, f"remote_axis across processes [{phase.axis}]")
    remote_axis.launches += 1
    remote_axis.narrowed += fmt is not None


def remote_axis_bytes(spec: GridSpec, phase, nq: int, positions: int, itemsize: int) -> int:
    """Bytes one phase must move for ``nq`` quantities over ``positions``
    blocks: each slab cell read once and written once."""
    _o, _n, rm, rp = axis_geom(spec, phase.axis)
    p = spec.padded()
    cells = {"z": p.y * p.x, "y": p.z * p.x, "x": p.z * p.y}[phase.axis] * (rm + rp)
    return 2 * cells * itemsize * nq * positions


def remote_axis_sector_bytes(spec: GridSpec, phase, nq: int, positions: int,
                             itemsize: int) -> int:
    """The 32-byte sectors one phase must touch for ``nq`` quantities over
    ``positions`` blocks: a block's two slabs' sectors read once and its two
    halos' sectors written once (``row_moves.sector_bytes``), at the block's
    own size along the ring (each index of the ring's size table holds
    ``positions / ring`` blocks). In the x phase a row end of a few words
    costs its whole sector, so this is that phase's floor."""
    p = spec.padded()
    o, _base, rm, rp = axis_geom(spec, phase.axis)
    sizes = axis_sizes(spec, phase.axis)
    per = sum(row_moves.sector_bytes(
        remote_axis_boxes(phase.axis, (o, n, rm, rp), (p.z, p.y, p.x))[0], p.y * p.x, p.x,
        itemsize) for n in sizes)
    return per * nq * positions // len(sizes)


def self_wrap_positions(state, keys, spec: GridSpec, axis: str) -> None:
    """An axis with one position: every position's blocks of ``keys`` fill
    their own periodic halos through the fill kernel, at most
    :data:`MAX_FILL_GROUP` blocks per launch."""
    blocks = [b for k in keys for b in state[k]]
    for i in range(0, len(blocks), MAX_FILL_GROUP):
        self_fill(blocks[i:i + MAX_FILL_GROUP], spec, axis)


class RemoteDmaExchange:
    """The remote-dma transport of a ``HaloExchange`` over a mesh, or over
    the resident blocks of one device: the composed phases x -> y -> z over
    the partition's blocks, each block an endpoint (a view into its
    position's stack, or into the device's resident stack), a ring phase
    as one :func:`remote_axis` call per same-dtype group (through the
    exchange's wire) or per quantity (quantity batching off), an axis with
    one block as self-wrap fills. ``state`` is ``{key: [stack per
    position]}`` on a mesh, ``{key: stacked tensor}`` on one device; in
    place. ``last_transfer_count`` counts the slabs that left a position
    (resident shifts stay on it, and a wire leaves them bit copies)."""

    def __init__(self, ex):
        from ..plan.ir import REMOTE_DMA, build_plan

        self.spec = ex.spec
        self.plan = ex.plan
        self.mesh = ex.mesh
        self.wire = ex.wire_dtype if ex.mesh is not None else None
        self.batch = ex.batch_quantities
        self.blocks_of_positions = ex.mesh is None or ex.resident != Dim3(1, 1, 1)
        # the carriers' phases: a ring over every block of the partition
        self.block_plan = (build_plan(self.spec, self.spec.dim, REMOTE_DMA)
                           if self.blocks_of_positions else self.plan)
        self._block_meshes = {}
        # the resident shifts of an oversubscribed mesh, per axis
        self.local = ({axis: remote_axis_local(axis, self.spec.dim, ex.resident) for axis in "xyz"}
                      if self.blocks_of_positions and self.wire else {})
        self.last_transfer_count = 0
        # positions of other processes: the CUDA IPC buffers and phase order
        # (parallel/ipc.PeerBuffers), attached at realize on the card
        self.across = ex.mesh is not None and ex.mesh.multi_process
        self.peers = None

    def _block_mesh(self, dev):
        """The mesh of every block of the partition on ``dev`` (flat order,
        x fastest), which the carriers' work lists and pointer tables take."""
        from ..parallel.mesh import DeviceMesh

        if dev not in self._block_meshes:
            self._block_meshes[dev] = DeviceMesh(self.spec.dim, [dev] * self.spec.num_blocks())
        return self._block_meshes[dev]

    def _endpoints(self, stacks):
        """One quantity's blocks as ``(1, 1, 1, pz, py, px)`` views in the
        partition's flat order, from its stacked tensor (one device) or its
        list of per-position stacks (a mesh)."""
        if not self.blocks_of_positions:
            return list(stacks)
        p = self.spec.padded()
        if self.mesh is None:
            return list(stacks.view(-1, 1, 1, 1, p.z, p.y, p.x).unbind(0))
        from ..parallel.exchange import position_blocks

        return [stacks[i][j].view(1, 1, 1, p.z, p.y, p.x)
                for i, j in position_blocks(self.spec, self.mesh)]

    def __call__(self, state, axes=None):
        self.last_transfer_count = 0
        if self.across:
            return self._across(state, axes)
        first = next(iter(state.values()))
        dev = (first[0] if isinstance(first, (list, tuple)) else first).device
        mesh = self._block_mesh(dev) if self.blocks_of_positions else self.mesh
        ends = {k: self._endpoints(v) for k, v in state.items()}
        groups = [keys for _dt, keys in dtype_groups({k: b[0] for k, b in ends.items()})]
        if not self.batch:
            groups = [[k] for keys in groups for k in keys]
        for phase, block_phase in zip(self.plan.remote_phases, self.block_plan.remote_phases):
            if not phase.active or (axes is not None and phase.axis not in axes):
                continue
            for keys in groups:
                if block_phase.ring > 1:
                    blocks = [[ends[k][i] for k in keys] for i in range(len(mesh))]
                    remote_axis(blocks, self.spec, block_phase, mesh, self.wire,
                                self.local.get(phase.axis))
                else:
                    self_wrap_positions(ends, keys, self.spec, phase.axis)
                if phase.ring > 1:
                    self.last_transfer_count += len(self.mesh) * ((phase.rm > 0) + (phase.rp > 0))
        return state

    def _across(self, state, axes=None):
        """The exchange of a mesh spread over processes (one block a
        position; another rank's position None in each list): per phase,
        on the card the neighbour barrier (``parallel/ipc.PhaseOrder``) and
        one :func:`remote_axis_across` launch per group over this rank's
        receivers; on the CPU :func:`remote_axis_gloo`. An axis with one
        position is a self-wrap fill of the local positions.
        ``last_transfer_count`` counts the slabs this rank's positions
        sent."""
        from ..parallel.ipc import ordered_phases

        mesh, spec = self.mesh, self.spec
        locs = mesh.local_positions()
        dev = mesh.device  # this process's positions' one device
        groups = [keys for _dt, keys in dtype_groups({k: v[locs[0]] for k, v in state.items()})]
        if not self.batch:
            groups = [[k] for keys in groups for k in keys]
        phases = {ph.axis: ph for ph in self.plan.remote_phases
                  if ph.active and (axes is None or ph.axis in axes)}
        local_ends = {k: [v[i] for i in locs] for k, v in state.items()}
        if dev.type == "cuda":
            if self.peers is None:
                raise RuntimeError("a mesh spread over processes exchanges on the card through "
                                   "the buffers DistributedDomain.realize exports "
                                   "(parallel/ipc.PeerBuffers)")
            where = {k: self.peers.buffer_of(v) for k, v in state.items()}

        def launch(axis):
            phase = phases[axis]
            for keys in groups:
                if phase.ring == 1:
                    self_wrap_positions(local_ends, keys, spec, axis)
                    continue
                if dev.type == "cpu":
                    remote_axis_gloo([[state[k][i] for k in keys] if mesh.is_local(i) else None
                                      for i in range(len(mesh))], spec, phase, mesh, self.wire)
                else:
                    def ptrs_of(i, keys=keys):
                        return tuple(self.peers.pointer(i, *where[k]) for k in keys)

                    remote_axis_across(ptrs_of, len(keys), state[keys[0]][locs[0]].dtype, spec,
                                       phase, mesh, dev, self.wire)
                self.last_transfer_count += len(locs) * ((phase.rm > 0) + (phase.rp > 0))

        if dev.type == "cpu":
            for axis in phases:
                launch(axis)
        else:
            ordered_phases(self.peers.order, list(phases), launch)
        return state
