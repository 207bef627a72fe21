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
  chunk stores every position's deep messages into the destination
  position's halos (crossing and self-wrap alike), then runs the k
  substeps of every position; :func:`persistent_jacobi_mesh_plain` is the
  deep messages position by position, then the chunk body per position.
  One block is the kernel's one-position case.
- On an uneven partition (remainder splits, where the TPU kernel refuses and
  the JAX package runs one deep exchange and its XLA chunk body,
  ``stencil_tpu/ops/jacobi.py:560-616``) :func:`persistent_jacobi_mesh`
  takes the kernel's uneven form: no messages, since the caller's deep
  exchange (B6's uneven ring at the chunk's radius) has filled the halos,
  then the passes of every position, each over its own grown regions at its
  own extent (a table of the positions' extents,
  ``persistent_jacobi_uneven_launch``); its plain version is
  :func:`make_persistent_chunk_body` at each position's own size. Its
  launches are also counted in ``persistent_jacobi_mesh.uneven``.

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
from .fused_stencil import (box_slices, check_mesh_fields, launch_mesh_chunk,
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


def make_persistent_chunk_body(spec: GridSpec, depth: int, size=None):
    """``chunk(curr, nxt, sel) -> (result, other)`` over one halo-filled
    block, in place, as the kernel writes it: for each on-chip pass of
    :func:`chunk_passes`, its substeps on temporaries (substep ``s`` of a
    chunk computing the region grown ``depth - 1 - s`` cells per side) and
    only the pass's last substep stored, into the other buffer. The result
    is in ``nxt`` when :func:`result_in_nxt`, else in ``curr``. ``size``
    (x, y, z; default the base block) is the block's own compute extent, as
    a smaller block of an uneven partition has it."""
    from .jacobi import jacobi_sweep

    check_chunk_depth(spec, depth)
    off = spec.compute_offset()
    base = spec.base if size is None else Dim3.of(size)

    def rect(g):
        return Rect3(Dim3(off.x - g, off.y - g, off.z - g),
                     Dim3(off.x + base.x + g, off.y + base.y + g, off.z + base.z + g))

    def chunk(curr, nxt, sel):
        masks = (sel == 1, sel == 2)
        src, dst, left = curr, nxt, depth
        for d in chunk_passes(depth):
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


def _deep_messages(spec: GridSpec, mesh=None):
    """``(boxes, dests_by_box)`` of the deep messages: each direction's
    ``(src, dst, shape)`` box and, per position, the position it sends the
    box to (position + d on ``mesh``; the block itself on one block)."""
    phases = deep_dir_phases(spec, mesh.dim if mesh is not None else (1, 1, 1))
    boxes = [(src, dst, shape) for _d, src, dst, shape, _c in phases]
    dests = [mesh.destinations((d.x, d.y, d.z)) if mesh is not None else (0,)
             for d, *_ in phases]
    return boxes, dests


def persistent_jacobi_plain(curr, nxt, sel, spec: GridSpec, k: int):
    """One k-step chunk in plain PyTorch: ``curr``'s halos <- the deep
    hand-offs (in place), then the chunk body. Returns ``(curr, nxt,
    sel)``; the chunk's result is in ``nxt`` when :func:`result_in_nxt`,
    else in ``curr``."""
    _require_kernel_form(spec, k)
    for src, dst, shape in _deep_messages(spec)[0]:
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
    boxes, dests = _deep_messages(spec)
    rc = launch_mesh_chunk(_native.lib("persistent_jacobi").persistent_jacobi_launch, [curr],
                           [nxt], [sel], spec, boxes, dests, dev, k)
    _native.check(rc, "persistent_jacobi")
    persistent_jacobi.launches += 1
    return curr, nxt, sel


persistent_jacobi.launches = 0


def position_extents(spec: GridSpec, mesh) -> tuple:
    """Each position's compute extent ``(nz, ny, nx)``, in the mesh's flat
    order: the uneven form's extent table."""
    return tuple((b.z, b.y, b.x) for b in (spec.block_size(pos) for pos in mesh.positions()))


def persistent_jacobi_mesh_plain(currs, nxts, sels, spec: GridSpec, k: int, mesh):
    """One k-step chunk over a mesh in plain PyTorch: every position's
    ``curr`` halos <- the deep messages (:func:`deep_dir_phases` on the
    mesh, the message toward ``d`` to position + d; in place), then the
    chunk body on each position. On an uneven partition no messages (the
    caller's deep exchange has filled the halos) and each position's body
    at its own size. Returns ``(currs, nxts, sels)``; the result is in
    ``nxts`` when :func:`result_in_nxt`, else in ``currs``."""
    _require_kernel_form(spec, k, mesh)
    if not spec.is_uniform():
        bspec = spec.block_spec()
        for c, n, s, (z, y, x) in zip(currs, nxts, sels, position_extents(spec, mesh)):
            make_persistent_chunk_body(bspec, k, (x, y, z))(c, n, s)
        return currs, nxts, sels
    boxes, dests_by_box = _deep_messages(spec, mesh)
    for (src, dst, shape), dests in zip(boxes, dests_by_box):
        s, d = box_slices(src, dst, shape)
        for i, j in enumerate(dests):
            currs[j][d] = currs[i][s]
    body = make_persistent_chunk_body(spec.block_spec(), k)
    for c, n, s in zip(currs, nxts, sels):
        body(c, n, s)
    return currs, nxts, sels


def persistent_jacobi_mesh(currs, nxts, sels, spec: GridSpec, k: int, mesh):
    """One k-step chunk of every position of ``mesh`` (see
    :func:`persistent_jacobi_mesh_plain`), in place: lists of one padded
    block of ``spec`` per position, on the mesh's one device, ``sels``
    halo-filled (and on an uneven partition ``currs`` too, at radius k).
    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/persistent_jacobi.cu`` once for every position (its uneven form
    on an uneven partition), or raise. Returns ``(currs, nxts, sels)``."""
    dev = check_mesh_fields(currs, nxts, sels, spec, mesh, "persistent_jacobi_mesh")
    _require_kernel_form(spec, k, mesh)
    if dev.type == "cpu":
        return persistent_jacobi_mesh_plain(currs, nxts, sels, spec, k, mesh)
    lib = _native.lib("persistent_jacobi")
    if spec.is_uniform():
        boxes, dests = _deep_messages(spec, mesh)
        rc = launch_mesh_chunk(lib.persistent_jacobi_launch, currs, nxts, sels, spec, boxes,
                               dests, dev, k)
    else:
        rc = launch_uneven_chunk(lib.persistent_jacobi_uneven_launch, currs, nxts, sels, spec,
                                 mesh, dev, k)
        persistent_jacobi_mesh.uneven += 1
    _native.check(rc, "persistent_jacobi_mesh")
    persistent_jacobi_mesh.launches += 1
    return currs, nxts, sels


persistent_jacobi_mesh.launches = 0
persistent_jacobi_mesh.uneven = 0  # the launches of the uneven form


def launch_uneven_chunk(entry, currs, nxts, sels, spec: GridSpec, mesh, dev, k: int) -> int:
    """Call the uneven form's entry (``persistent_jacobi_uneven_launch``)
    over every position: the position table of :func:`mesh_tables`' rows and
    the extent table (:func:`position_extents`), each kept per key; returns
    its CUDA error code."""
    ptrs = tuple(t.data_ptr() for row in zip(currs, nxts, sels) for t in row)
    pos = _native.device_table(("mesh_positions", ptrs), lambda: list(ptrs), dev)
    ext = position_extents(spec, mesh)
    table = _native.device_table(("mesh_extents", ext), lambda: [v for e in ext for v in e], dev)
    p, off, b = spec.padded(), spec.compute_offset(), spec.base
    return entry(pos.data_ptr(), len(currs), table.data_ptr(), p.y * p.x, p.x, off.z, off.y,
                 off.x, b.z, b.y, b.x, k, dev.index, _native.stream_ptr(dev))


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
    halo = sum(shape[0] * shape[1] * shape[2] for _s, _d, shape in _deep_messages(spec)[0])
    return total + 8 * halo
