"""The persistent whole-chunk Jacobi kernel: one launch per k-step chunk.

The port's counterpart of ``stencil_tpu.ops.persistent_stencil``. A chunk
fills radius-k halos once and runs k substeps with no further exchange:
substep ``s`` computes the region grown ``k - 1 - s`` cells past the
compute region, recomputing neighbour cells redundantly with the sweep's
operand order, so the chunk equals k plain steps bit for bit.

- :func:`persistent_jacobi` launches ``csrc/persistent_jacobi.cu``
  (replacing the TPU's ``make_persistent_jacobi_kernel`` in its
  all-self-wrap form) on one block: the deep hand-offs
  (:func:`deep_dir_phases`) and the k substeps in one cooperative launch;
  :func:`persistent_jacobi_plain` is the same chunk in plain PyTorch: the
  hand-offs, then :func:`make_persistent_chunk_body`.
- :func:`persistent_jacobi_mesh` launches the same kernel over a mesh of
  block positions on one device (the wire-crossing form): one launch per
  chunk pulls every position's deep messages into its halos from the
  position each comes from (crossing and self-wrap alike), then runs the k
  substeps of every position; :func:`persistent_jacobi_mesh_plain` is the
  deep messages receiver by receiver, then the chunk body per position.
  One block is the kernel's one-position case.
- On an uneven partition (remainder splits, where the TPU kernel refuses and
  the JAX package runs one deep exchange and its XLA chunk body,
  ``stencil_tpu/ops/jacobi.py:560-616``) :func:`persistent_jacobi_mesh`
  takes the kernel's uneven form: no messages, since the caller's deep
  exchange (B6's uneven ring at the chunk's radius) has filled the halos,
  then the passes of every position, each over its own grown regions at its
  own extent (a table of the positions' extents); its plain version is
  :func:`make_persistent_chunk_body` at each position's own size. Its
  launches are also counted in ``persistent_jacobi_mesh.uneven``.
- Over positions spread over several processes (the TPU kernel's form
  between hosts behind its neighbour barrier,
  ``stencil_tpu/ops/persistent_stencil.py:279-289``),
  :func:`persistent_jacobi_across` is one cooperative launch of the same
  kernel over this process's positions:
  its position table holds this process's rows, swept, then the mapped
  rows of the positions its deep messages come from, only read; it pulls
  the messages into the local halos (uniform) and runs a range of the
  chunk's passes. :func:`persistent_chunk_across` is the loop's chunk: on
  the card one handshake with every rank the messages cross to
  (``parallel/ipc.PhaseOrder.before_all``) and one launch for a chunk of
  one pass; a chunk of several passes is two launches with a second
  handshake before pass 1, since pass 1 writes the compute cells of
  ``curr`` that other processes pull in their first launch. The uneven
  form follows the caller's deep exchange (B6 across processes), with the
  same second handshake before pass 1. On the CPU the deep messages travel
  over gloo (``fused_stencil.messages_gloo``), then the chunk body runs on
  each local position. Its plain version is
  :func:`persistent_jacobi_mesh_plain` (over this process's positions);
  one process's mesh is the form's every-position-local case, which
  :func:`persistent_jacobi_mesh` launches. Launches are counted in
  ``persistent_jacobi_across.launches`` (the uneven form's also in
  ``persistent_jacobi_across.uneven``).

The result contract. The kernel keeps every substep of a tile on chip, in
on-chip passes of at most :data:`ONCHIP_KMAX` substeps
(:func:`chunk_passes`). A pass reads one buffer over the region grown by
the depth still to run and writes only the other buffer, over the region
grown by what the next pass needs: the compute region for the last pass.
So a chunk writes ``curr``'s halos (the messages) and the result buffer's
compute region (plus, beyond one pass, the intermediate passes' grown
regions), and nothing else; :func:`result_in_nxt` says which buffer holds
the result. The TPU kernel instead ping-pongs every substep through the
two buffers (its result is in ``nxt`` for odd k); the field it computes is
the same.

Both read ``sel`` at grown cells, so ``sel`` must arrive with its halos
filled (the step loop exchanges it once per loop call). A wrapper takes its
plain version only for tensors on the CPU; on a CUDA tensor it launches its
kernel or raises. Launches are counted in ``persistent_jacobi.launches``
and ``persistent_jacobi_mesh.launches``.
"""

from __future__ import annotations

from typing import List

import torch

from ..domain.grid import GridSpec
from ..geometry import DIRECTIONS_26, Dim3, Rect3
from ..plan.ir import direction_boxes
from . import _native
from .fused_stencil import (across_tables, box_rows, box_slices, check_mesh_fields,
                            mesh_tables, messages_gloo, peer_pointers, position_table,
                            require_float32_fields)
from .stencil_kernels import _check_block, _device_of


def chunk_schedule(iters: int, k: int) -> List[int]:
    """The chunk depths an ``iters``-step persistent loop runs: full
    depth-``k`` chunks plus one shallower tail chunk for the remainder."""
    if k < 1:
        raise ValueError(f"persistent chunk depth must be >= 1, got {k}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    n, rem = divmod(iters, k)
    return [k] * n + ([rem] if rem else [])


def check_chunk_depth(spec: GridSpec, depth: int) -> None:
    """Refuse a depth the realized halo cannot feed: substep 0 reads
    ``depth`` cells into the halo on every side."""
    r = spec.radius
    rmin = min(r.x(-1), r.x(1), r.y(-1), r.y(1), r.z(-1), r.z(1))
    if rmin < depth:
        raise ValueError(
            f"persistent chunk depth {depth} needs radius >= {depth} on "
            f"every side (realized min face radius is {rmin}): realize "
            "the spec at radius*k before building the chunk")
    if min(spec.base.x, spec.base.y, spec.base.z) < depth:
        raise ValueError(
            f"persistent chunk depth {depth} exceeds a {spec.base} block "
            "interior: the shrinking valid strip would go negative "
            "(plan/cost.py prices this infeasible)")


# the deepest on-chip pass the kernel instantiates (csrc/mesh_chunk.cuh
# ONCHIP_KMAX): its register windows grow with the depth
ONCHIP_KMAX = 6
# csrc/mesh_chunk.cuh: a pass's output tile edge (x and y), and the tiles
# wanted per resident block when choosing the z chunk
ONCHIP_TILE = 32
TILES_PER_BLOCK = 4


def zchunk_for(want: int, cols: int, nz: int) -> int:
    """Planes of a z chunk (csrc/jacobi_column.cuh ``zchunk_for``): ``nz``
    split into ``ceil(want / cols)`` chunks, at least one, at most ``nz``."""
    nzc = min(max(1, -(-want // cols)), nz)
    return -(-nz // nzc)


def onchip_walk(extents, g: int, blocks: int) -> list:
    """The tiles one on-chip pass walks (``onchip_pass`` in
    ``csrc/mesh_chunk.cuh``) over positions of compute ``extents`` (``(nz,
    ny, nx)`` each; every position the first's on a uniform mesh, where the
    kernel takes no extent table), writing each position's region grown by
    ``g``, with ``blocks`` resident blocks: ``[(position, X0, Y0, Z0, Z1, ex,
    ey)]`` in the walk's order, each a ``ONCHIP_TILE``-square column of
    planes ``[Z0, Z1)`` of the position's ``ex`` x ``ey`` region (tile offsets
    from the region's first cell). The z chunk is chosen once a pass, from
    every position's columns and the largest extent."""
    grown = [(z + 2 * g, y + 2 * g, x + 2 * g) for z, y, x in extents]
    t = ONCHIP_TILE
    cols = [-(-ex // t) * -(-ey // t) for _ez, ey, ex in grown]
    zchunk = zchunk_for(TILES_PER_BLOCK * blocks, sum(cols), max(e[0] for e in grown))
    out = []
    for i, (ez, ey, ex) in enumerate(grown):
        gx, gy = -(-ex // t), -(-ey // t)
        for u in range(gx * gy * -(-ez // zchunk)):
            z0 = (u // (gx * gy)) * zchunk
            out.append((i, (u % gx) * t, ((u // gx) % gy) * t, z0, min(ez, z0 + zchunk), ex, ey))
    return out


def chunk_passes(k: int) -> List[int]:
    """The on-chip passes of a depth-``k`` chunk: ``ceil(k / ONCHIP_KMAX)``
    passes of balanced depths, the deeper ones first (the kernel's
    ``chunk_passes`` / ``pass_depth``)."""
    if k < 1:
        raise ValueError(f"persistent chunk depth must be >= 1, got {k}")
    n = -(-k // ONCHIP_KMAX)
    q, r = divmod(k, n)
    return [q + 1] * r + [q] * (n - r)


def result_in_nxt(k: int) -> bool:
    """Whether a depth-``k`` chunk leaves its result in ``nxt`` (else in
    ``curr``): the passes alternate the two buffers, the first reading
    ``curr``, so always for a chunk of one pass, by pass parity beyond."""
    return len(chunk_passes(k)) % 2 == 1


def make_persistent_chunk_body(spec: GridSpec, depth: int, size=None, passes=None):
    """``chunk(curr, nxt, sel) -> (result, other)`` over one halo-filled
    block, in place, as the kernel writes it: for each on-chip pass of
    :func:`chunk_passes`, its substeps on temporaries (substep ``s`` of a
    chunk computing the region grown ``depth - 1 - s`` cells per side) and
    only the pass's last substep stored, into the other buffer (pass ``p``
    reads ``curr`` when ``p`` is even). The result is in ``nxt`` when
    :func:`result_in_nxt`, else in ``curr``. ``size`` (x, y, z; default the
    base block) is the block's own compute extent, as a smaller block of an
    uneven partition has it; ``passes`` (a ``range`` of pass indices;
    default all) the passes to run, as a launch of the cross-process form
    runs them."""
    from .jacobi import jacobi_sweep

    check_chunk_depth(spec, depth)
    off = spec.compute_offset()
    base = spec.base if size is None else Dim3.of(size)

    def rect(g):
        return Rect3(Dim3(off.x - g, off.y - g, off.z - g),
                     Dim3(off.x + base.x + g, off.y + base.y + g, off.z + base.z + g))

    run = range(len(chunk_passes(depth))) if passes is None else passes

    def chunk(curr, nxt, sel):
        masks = (sel == 1, sel == 2)
        src, dst, left = curr, nxt, depth
        for p, d in enumerate(chunk_passes(depth)):
            if p not in run:
                left -= d
                src, dst = dst, src
                continue
            tmp = [torch.empty_like(src) for _ in range(min(d - 1, 2))]
            c = src
            for s in range(d):
                n = dst if s == d - 1 else tmp[s % 2]
                c = jacobi_sweep(c, n, rect(left - 1 - s), masks)
            left -= d
            src, dst = dst, src
        return src, dst

    return chunk


def deep_dir_phases(spec: GridSpec, mesh_dim):
    """``[(direction, src, dst, shape, crossing)]`` at the spec's full
    (deep) radius on a uniform partition, in (z, y, x) block-local
    coordinates: every active direction's exact-extent message (faces,
    edges and corners; grown substeps read corner halos)."""
    md = Dim3.of(mesh_dim)
    multi = {"z": md.z > 1, "y": md.y > 1, "x": md.x > 1}
    dirs = [d for d in DIRECTIONS_26 if spec.radius.dir(-d) != 0]
    return [(d, src, dst, shape,
             any(comp != 0 and multi[a] for a, comp in (("z", d.z), ("y", d.y), ("x", d.x))))
            for d, src, dst, shape in direction_boxes(spec, dirs)]


def _require_kernel_form(spec: GridSpec, k: int, mesh=None) -> None:
    """One block, or a mesh of one block a position (uniform or uneven), at
    a depth ``k >= 2`` the realized halo feeds."""
    if mesh is None and spec.dim != Dim3(1, 1, 1):
        raise NotImplementedError(
            f"partition {spec.dim}: persistent_jacobi runs one block; a mesh of block "
            "positions takes persistent_jacobi_mesh")
    if mesh is not None and spec.dim != mesh.dim:
        raise ValueError(f"mesh {mesh.dim} does not match partition {spec.dim}")
    if k < 2:
        raise ValueError(
            "persistent chunks need k >= 2 (a depth-1 chunk IS the "
            "fused substep kernel — use kernel_variant='fused')")
    check_chunk_depth(spec, k)


def _deep_boxes(spec: GridSpec):
    """The deep messages' ``(src, dst, shape)`` boxes on one block, each
    wrapping onto the block itself."""
    return [(src, dst, shape) for _d, src, dst, shape, _c in deep_dir_phases(spec, (1, 1, 1))]


def persistent_jacobi_plain(curr, nxt, sel, spec: GridSpec, k: int):
    """One k-step chunk in plain PyTorch: ``curr``'s halos <- the deep
    hand-offs (in place), then the chunk body. Returns ``(curr, nxt,
    sel)``; the chunk's result is in ``nxt`` when :func:`result_in_nxt`,
    else in ``curr``."""
    _require_kernel_form(spec, k)
    for src, dst, shape in _deep_boxes(spec):
        s, d = box_slices(src, dst, shape)
        curr[d] = curr[s]
    make_persistent_chunk_body(spec, k)(curr, nxt, sel)
    return curr, nxt, sel


def persistent_jacobi(curr, nxt, sel, spec: GridSpec, k: int):
    """One k-step chunk (see :func:`persistent_jacobi_plain`), in place, in
    one launch; returns ``(curr', out', sel)`` = ``(curr, nxt, sel)``."""
    require_float32_fields(curr, "persistent_jacobi")
    _check_block(curr, spec, torch.float32, "curr")
    _check_block(nxt, spec, torch.float32, "nxt")
    _check_block(sel, spec, torch.int32, "sel")
    _require_kernel_form(spec, k)
    dev = _device_of(curr, nxt, sel)
    if dev.type == "cpu":
        return persistent_jacobi_plain(curr, nxt, sel, spec, k)
    boxes = _deep_boxes(spec)
    pos, msg = mesh_tables([curr], [nxt], [sel], [(0,)] * len(boxes), dev)
    rc = launch_chunk(pos, 1, 1, msg, boxes, None, spec, k, dev)
    _native.check(rc, "persistent_jacobi")
    persistent_jacobi.launches += 1
    return curr, nxt, sel


persistent_jacobi.launches = 0


def position_extents(spec: GridSpec, mesh) -> tuple:
    """Each position's compute extent ``(nz, ny, nx)``, in the mesh's flat
    order: the uneven form's extent table."""
    return tuple((b.z, b.y, b.x) for b in (spec.block_size(pos) for pos in mesh.positions()))


def persistent_jacobi_mesh_plain(currs, nxts, sels, spec: GridSpec, k: int, mesh, passes=None):
    """One k-step chunk of this process's positions of a mesh (on one
    process every position) in plain PyTorch, the plain version of
    :func:`persistent_jacobi_mesh` and :func:`persistent_jacobi_across`
    (``passes`` as there): on a uniform partition, with pass 0, each local
    position's ``curr`` halos <- the deep messages (:func:`deep_dir_phases`
    on the mesh) from the positions at position - d (``currs[i]``: another
    process's a mapped view, or None where no message comes from it); then
    the chunk body's passes on each local position at its own size (on an
    uneven partition the caller's deep exchange has filled the halos).
    Returns ``(currs, nxts, sels)``; the result is in ``nxts`` when
    :func:`result_in_nxt`, else in ``currs``."""
    _require_kernel_form(spec, k, mesh)
    passes = range(len(chunk_passes(k))) if passes is None else passes
    locs = mesh.local_positions()
    if spec.is_uniform() and 0 in passes:
        for d, src, dst, shape, _c in deep_dir_phases(spec, mesh.dim):
            s, t = box_slices(src, dst, shape)
            for r in locs:
                i = mesh.index(mesh.shifted(mesh.position(r), (-d.x, -d.y, -d.z)))
                currs[r][t] = currs[i][s]
    ext = position_extents(spec, mesh)
    for i in locs:
        z, y, x = ext[i]
        make_persistent_chunk_body(spec.block_spec(), k, (x, y, z), passes)(currs[i], nxts[i],
                                                                          sels[i])
    return currs, nxts, sels


def persistent_jacobi_mesh(currs, nxts, sels, spec: GridSpec, k: int, mesh):
    """One k-step chunk of every position of ``mesh`` (see
    :func:`persistent_jacobi_mesh_plain`), in place: lists of one padded
    block of ``spec`` per position, on the mesh's one device, ``sels``
    halo-filled (and on an uneven partition ``currs`` too, at radius k).
    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/persistent_jacobi.cu`` once for every position (its uneven form
    on an uneven partition): the cross-process form's launch
    (:func:`launch_positions`) with every position local. Returns
    ``(currs, nxts, sels)``."""
    dev = check_mesh_fields(currs, nxts, sels, spec, mesh, "persistent_jacobi_mesh")
    _require_kernel_form(spec, k, mesh)
    if dev.type == "cpu":
        return persistent_jacobi_mesh_plain(currs, nxts, sels, spec, k, mesh)
    rc = launch_positions(lambda i: (currs[i].data_ptr(), nxts[i].data_ptr(), sels[i].data_ptr()),
                          spec, k, mesh, dev)
    _native.check(rc, "persistent_jacobi_mesh")
    persistent_jacobi_mesh.uneven += not spec.is_uniform()
    persistent_jacobi_mesh.launches += 1
    return currs, nxts, sels


persistent_jacobi_mesh.launches = 0
persistent_jacobi_mesh.uneven = 0  # the launches of the uneven form


def extent_table(ext, dev):
    """The uneven form's extent table on ``dev``: a ``(nz, ny, nx)`` row a
    position (:func:`position_extents`), kept per content."""
    return _native.device_table(("mesh_extents", ext), lambda: [v for e in ext for v in e], dev)


def launch_chunk(pos, npos: int, nsweep: int, msg, boxes, ext, spec: GridSpec, k: int, dev,
                 passes=None) -> int:
    """Call ``persistent_jacobi_launch`` (``csrc/persistent_jacobi.cu``):
    the position table ``pos`` of ``npos`` rows, the first ``nsweep``
    swept; the message table ``msg`` of the ``(src, dst, shape)``
    ``boxes`` (None and ``()`` in the uneven form, whose extent table is
    ``ext``, else None); the chunk's passes ``passes`` (a ``range``;
    default all). Returns the CUDA error code."""
    p, off, b = spec.padded(), spec.compute_offset(), spec.base
    passes = range(len(chunk_passes(k))) if passes is None else passes
    return _native.lib("persistent_jacobi").persistent_jacobi_launch(
        pos.data_ptr(), npos, nsweep, None if msg is None else msg.data_ptr(),
        0 if msg is None else nsweep, box_rows(boxes), len(boxes),
        None if ext is None else ext.data_ptr(), p.y * p.x, p.x, off.z, off.y, off.x, b.z, b.y,
        b.x, k, passes.start, passes.stop, dev.index, _native.stream_ptr(dev))


def launch_positions(ptrs_of, spec: GridSpec, k: int, mesh, dev, passes=None) -> int:
    """One launch of ``csrc/persistent_jacobi.cu`` over this process's
    positions of ``mesh`` (on one process every position), ``ptrs_of`` and
    ``passes`` as for :func:`persistent_jacobi_across`: on a uniform
    partition the tables of ``fused_stencil.across_tables`` and the deep
    messages' boxes, else the uneven form's extent table of the local
    positions. Returns the CUDA error code."""
    locs = mesh.local_positions()
    if spec.is_uniform():
        phases = deep_dir_phases(spec, mesh.dim)
        pos, msg, ptrs = across_tables(ptrs_of, mesh, [(d.x, d.y, d.z) for d, *_ in phases], dev)
        return launch_chunk(pos, len(ptrs) // 3, len(locs), msg,
                            [(src, dst, shape) for _d, src, dst, shape, _c in phases], None,
                            spec, k, dev, passes)
    pos = position_table(tuple(v for i in locs for v in ptrs_of(i)), dev)
    every = position_extents(spec, mesh)
    return launch_chunk(pos, len(locs), len(locs), None, (),
                        extent_table(tuple(every[i] for i in locs), dev), spec, k, dev, passes)


def persistent_jacobi_across(ptrs_of, spec: GridSpec, k: int, mesh, dev, passes=None) -> None:
    """B9's cross-process form: one cooperative launch of
    ``csrc/persistent_jacobi.cu`` over this process's positions, ``ptrs_of(i)`` the (curr, nxt, sel)
    addresses of a local position and, at another process's position a
    deep message comes from, its curr mapped through CUDA IPC first
    (``fused_stencil.across_tables``). It runs the chunk's passes
    ``passes`` (a ``range`` of :func:`chunk_passes`' indices; default all),
    the deep messages into the local halos with pass 0; on an uneven
    partition no messages (the caller's deep exchange) and each local
    position at its own extent. The caller orders the launch after the
    other processes' (``parallel/ipc.PhaseOrder.before_all``). Its plain
    version is :func:`persistent_jacobi_mesh_plain`."""
    _require_kernel_form(spec, k, mesh)
    _native.check(launch_positions(ptrs_of, spec, k, mesh, dev, passes),
                  "persistent_jacobi across processes")
    persistent_jacobi_across.launches += 1
    persistent_jacobi_across.uneven += not spec.is_uniform()


persistent_jacobi_across.launches = 0
persistent_jacobi_across.uneven = 0  # the launches of the uneven form


def persistent_chunk_across(currs, nxts, sels, spec: GridSpec, k: int, mesh, peers=None) -> int:
    """One k-step chunk of this process's positions of a mesh spread over
    processes (lists of one block a position, None at another process's;
    ``sels`` halo-filled, and on an uneven partition ``currs`` too, at
    radius k). On the card: on a uniform partition the handshake with
    every rank the messages cross to (``peers.order.before_all``) and one
    :func:`persistent_jacobi_across` launch of the messages and pass 0;
    then, for a chunk of several passes, a second handshake and a launch of
    the passes after pass 0 (on an uneven partition the same, without the
    first handshake: the caller's deep exchange held its own). On the CPU
    the deep messages over gloo (uniform), then the chunk body on each
    local position at its own size. Returns the launches it issued (the
    chunk programs on the CPU)."""
    locs = mesh.local_positions()
    require_float32_fields(currs[locs[0]], "persistent_jacobi across processes")
    _require_kernel_form(spec, k, mesh)
    dev = currs[locs[0]].device
    uniform = spec.is_uniform()
    if dev.type == "cpu":
        if uniform:
            phases = deep_dir_phases(spec, mesh.dim)
            messages_gloo([None if c is None else [c] for c in currs],
                          [(src, dst, shape) for _d, src, dst, shape, _c in phases],
                          [(d.x, d.y, d.z) for d, *_ in phases], mesh)
        bspec, ext = spec.block_spec(), position_extents(spec, mesh)
        for i in locs:
            z, y, x = ext[i]
            make_persistent_chunk_body(bspec, k, (x, y, z))(currs[i], nxts[i], sels[i])
        return 1
    if peers is None:
        raise RuntimeError("a mesh spread over processes steps on the card through the buffers "
                           "DistributedDomain.realize exports (parallel/ipc.PeerBuffers)")
    curr_of = peer_pointers(currs, peers, mesh)

    def ptrs_of(i):
        if mesh.is_local(i):
            return curr_of(i), nxts[i].data_ptr(), sels[i].data_ptr()
        return curr_of(i), 0, 0

    n = len(chunk_passes(k))
    if uniform:
        peers.order.before_all()
    persistent_jacobi_across(ptrs_of, spec, k, mesh, dev, range(0, 1))
    if n > 1:
        peers.order.before_all()  # pass 1 overwrites curr's cells the others pulled
        persistent_jacobi_across(ptrs_of, spec, k, mesh, dev, range(1, n))
    return 1 + (n > 1)


def chunk_bytes(spec: GridSpec, k: int, size=None) -> int:
    """The least bytes a chunk must move: one read of ``curr`` and ``sel``
    and one write of the result over the block grown by its radius-k halo
    (4 bytes each); ``size`` (x, y, z) a block's own extent (default the
    base block)."""
    b = spec.base if size is None else Dim3.of(size)
    return 12 * (b.x + 2 * k) * (b.y + 2 * k) * (b.z + 2 * k)


def chunk_design_bytes(spec: GridSpec, k: int) -> int:
    """What the kernel's design moves per chunk: per on-chip pass one read
    of its source and of ``sel`` over the region grown by the depth still
    to run and one write of the region grown by what follows (the compute
    region for the last pass), plus the messages' read and write of each
    halo cell. Tiles re-read their neighbours' ghost zones; that is not
    counted."""
    b = spec.base

    def cells(g):
        return (b.x + 2 * g) * (b.y + 2 * g) * (b.z + 2 * g)

    total, left = 0, k
    for d in chunk_passes(k):
        total += 8 * cells(left) + 4 * cells(left - d)
        left -= d
    halo = sum(shape[0] * shape[1] * shape[2] for _s, _d, shape in _deep_boxes(spec))
    return total + 8 * halo
