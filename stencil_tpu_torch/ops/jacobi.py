"""7-point Jacobi heat diffusion: the region sweep, the spheres, and the
single-block step and loop.

The port's counterpart of ``stencil_tpu.ops.jacobi`` (reference:
bin/jacobi3d.cu:30-85 kernel, :296-377 loop): each compute cell becomes the
average of its six face neighbours; a hot sphere (1.0) at x = 1/3 and a cold
sphere (0.0) at x = 2/3 of the global domain, radius X/10, are re-imposed
every step; the field starts at 0.5.

On a single-block domain every axis wraps onto itself, so a step needs no
exchange at all: :func:`make_jacobi_loop` runs the multistep kernel for
``iters // k`` passes and the one-step sweep for the ``iters % k`` tail,
exactly the schedule of the JAX package's single-chip fast path.

On a uniform multi-block partition, every block resident on the device,
the loops follow the JAX package's Pallas branch of ``_compile_jacobi``:
the kernels wrap the single-block axes and read halos on the multi-block
ones. A step with overlap sweeps pre-exchange data, runs the full exchange,
then re-sweeps the multi-block axes' shells from the exchanged halos
(every shell of every block in one launch,
:func:`stencil_kernels.sweep_regions`); without overlap it exchanges the
multi-block axes and sweeps. With overlap and a depth k >= 2 (the deep
halo, radius >= k), one exchange of the multi-block axes feeds each k-step
multistep pass over every resident at its own global origin, and the
``iters % k`` tail runs the overlap step. On an uneven resident partition
the JAX package keeps its XLA path (no Pallas, no overlap shells, no
multistep), and so does the schedule here: each step is the full exchange,
then one sweep of every block's full base extent reading the filled halos
(cells past a smaller block's own size are dead pad).

The direct26 method takes the full 26-message exchange every step, with no
axis subsetting, no overlap shells and no multistep (the JAX package's
Pallas branch has no axis phases to subset there), then one sweep of every
resident that reads the exchanged halos (no in-kernel wrap: after a full
exchange the wrap would read the same values, and the JAX package's kernel
takes the halos too); on the card that sweep is one launch of B1's task
table over the resident stack.

Over a mesh of one block a position, AXIS_COMPOSED and DIRECT26 take the
same Pallas-branch schedules on each position (:func:`_positions_loop`),
the messages copies between positions (``parallel/mesh_exchange``) and
every position's work one launch: the overlap step (one sweep of every
position wrapping its single-position axes, the exchange, one launch of
every position's shells), the axis-subset step without overlap, the
dynamic-shell step on an uneven mesh (:func:`_dyn_shell_step`), the
deep-halo multistep as one launch of its positions form over every
position at its own global origin (:func:`stencil_kernels.
multistep_positions`), and DIRECT26's exchange and no-wrap sweep. Across
processes each rank's launches cover its own positions, and on the card a
step that sweeps before it exchanges (the overlap and dynamic-shell steps)
first takes a handshake with every rank it exchanges with.

The remote-dma method dispatches first, as the JAX package's
``_compile_jacobi`` does: the plain exchange + sweep step, the fused step
kernel (one launch per step) or the persistent chunk kernel (one launch per
k-step chunk), by the exchange's kernel variant. Over a mesh of several
block positions (``HaloExchange(mesh=...)``, operands are lists of blocks)
each variant keeps its shape: the plain step is the exchange (axis-carrier
phases, self-wrap fills) and one sweep launch over every position with no
in-kernel wrap (the JAX package's ``_compile_jacobi_remote``); the fused
step is one launch of the fused kernel's wire-crossing form over every
position (:func:`fused_stencil.fused_jacobi_mesh`); the persistent chunk
one launch of the chunk kernel's wire-crossing form
(:func:`persistent_stencil.persistent_jacobi_mesh`), after the axis
carrier has filled ``sel``'s deep halos once per loop call. On an uneven
mesh the plain step keeps its shape (the axis carrier takes the uneven
ring); the fused step kernel is uniform-only, as on the TPU, so the fused
variant runs the JAX package's host-orchestrated schedule
(:func:`_uneven_fused_loop`), and the persistent chunk takes its uneven
form: per chunk the deep exchange (B6's uneven ring) and one launch of the
chunk body over every position at its own size
(:func:`persistent_stencil.persistent_jacobi_mesh`), 2 launches a chunk as
the JAX package counts them. On resident blocks the plain remote-dma step
is the exchange (the axis carrier over every block) and one sweep launch
over every block: the stack of one device, or each position's stack of an
oversubscribed mesh (the blocks as views into their stacks); the fused and
persistent variants take one block a position, as in the JAX package.

Over a mesh spread over several processes each loop steps this rank's own
positions, as the plain step does: the fused step is one launch of the
fused kernel's cross-process form a step
(:func:`fused_stencil.fused_step_across`), the persistent chunk one launch
of the chunk kernel's (two, with a second handshake, for a chunk of
several on-chip passes; :func:`persistent_stencil.persistent_chunk_across`),
each after one handshake with every rank the messages cross to; the uneven
fused schedule sweeps, exchanges and re-sweeps the local positions, its
sweep after a handshake of its own (it overwrites the buffer the other
ranks' previous exchange read). On the CPU the messages travel over gloo.

:func:`make_batched_jacobi_loop` steps a campaign slot, a ``(B, pz, py,
px)`` stack of independent single-block tenants: one tenant-form sweep
launch per step on the card, the JAX package's XLA branch (fill, then
sweep) on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..api import resolve_device
from ..geometry import Dim3, Rect3, exterior_regions
from ..parallel.exchange import Method, shard_blocks, split_positions
from ..parallel.mesh import DeviceMesh
from ..utils import logging as log
from ..utils import timer
from . import _native
from .fused_stencil import (NO_WRAP, fused_jacobi, fused_jacobi_mesh, fused_step_across,
                            kernel_supported, require_face_radius)
from .halo_fill import wrap_fill_batched
from .persistent_stencil import (check_chunk_depth, chunk_schedule, persistent_chunk_across,
                                 persistent_jacobi, persistent_jacobi_mesh, result_in_nxt)
from .shells import dyn_block_sizes, include_axes, shell_regions
from .stencil_kernels import (
    COLD_TEMP,
    HOT_TEMP,
    MULTISTEP_KMAX,
    TEMPORAL_K_CAP,
    _sphere_masks,
    block_sel_range,
    block_sel_ranges,
    block_origin,
    multi_block_axes,
    multistep,
    multistep_positions,
    multistep_shape,
    plan_multistep_depth,
    sel_z_range,
    sixth,
    sphere_masks_from_coords,
    sweep,
    sweep_positions,
    sweep_regions,
    sweep_tenants,
)

INIT_TEMP = (HOT_TEMP + COLD_TEMP) / 2


def _rect_slices(rect: Rect3, dz=0, dy=0, dx=0):
    return (
        slice(rect.lo.z + dz, rect.hi.z + dz),
        slice(rect.lo.y + dy, rect.hi.y + dy),
        slice(rect.lo.x + dx, rect.hi.x + dx),
    )


def jacobi_sweep(src: torch.Tensor, out: torch.Tensor, rect: Rect3, masks=None):
    """Write the 6-neighbour average of ``src`` into region ``rect`` of
    ``out`` (allocation-local coordinates, leading dims allowed; the reads
    reach one cell past ``rect``, into the halos). ``masks`` is an optional
    ``(hot, cold)`` pair of bool tensors shaped like ``src``. In place;
    returns ``out``."""
    avg = (
        src[(..., *_rect_slices(rect, dx=-1))]
        + src[(..., *_rect_slices(rect, dx=1))]
        + src[(..., *_rect_slices(rect, dy=-1))]
        + src[(..., *_rect_slices(rect, dy=1))]
        + src[(..., *_rect_slices(rect, dz=-1))]
        + src[(..., *_rect_slices(rect, dz=1))]
    ) * sixth(src.dtype)
    if masks is not None:
        hot, cold = masks
        sl = (..., *_rect_slices(rect))
        avg = torch.where(hot[sl], HOT_TEMP, torch.where(cold[sl], COLD_TEMP, avg))
    out[(..., *_rect_slices(rect))] = avg.to(out.dtype)
    return out


def sphere_masks(global_size) -> Tuple[np.ndarray, np.ndarray]:
    """Hot/cold sphere masks over the global [z,y,x] grid.

    Bit-parity with the reference's integer-truncated distance
    (bin/jacobi3d.cu:30-32,49): dist = int64(sqrtf(dx^2+dy^2+dz^2)),
    hot iff dist(hotCenter) <= X/10."""
    g = Dim3.of(global_size)
    hot_c = (g.x // 3, g.y // 2, g.z // 2)
    cold_c = (g.x * 2 // 3, g.y // 2, g.z // 2)
    rad = g.x // 10
    z, y, x = np.meshgrid(
        np.arange(g.z), np.arange(g.y), np.arange(g.x), indexing="ij", sparse=True
    )

    def dist(c):
        d2 = (x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2
        return np.sqrt(d2.astype(np.float32)).astype(np.int64)

    hot = dist(hot_c) <= rad
    cold = (~hot) & (dist(cold_c) <= rad)
    return hot, cold


def sphere_sel(global_size) -> np.ndarray:
    """Hot/cold spheres packed into one int32 array: 0 stencil, 1 hot,
    2 cold — the layout the sweep consumes."""
    hot, cold = sphere_masks(global_size)
    sel = np.zeros(hot.shape, np.int32)
    sel[hot] = 1
    sel[cold] = 2
    return sel


def sphere_sel_blocks(spec, device):
    """``sphere_sel(spec.global_size)`` in the stacked padded layout on
    ``device`` (halos and pad 0), built there from integer coordinates:
    the coordinate spheres equal the sqrt-truncating ones
    (:func:`stencil_kernels.sphere_masks_from_coords`), and a 512^3 grid
    takes seconds of host time the other way. With a ``DeviceMesh`` for
    ``device``, a mesh's blocks, each built on its position's device from
    its block's global coordinates (None at another process's position)."""
    if not isinstance(device, DeviceMesh):
        hot, cold = sphere_masks_from_coords(spec, device)
        return shard_blocks(hot.to(torch.int32) + 2 * cold.to(torch.int32), spec, device)
    if device.dim != spec.dim:  # each position's resident stack
        return split_positions(sphere_sel_blocks(spec, device.device), spec, device)
    g, p, off = spec.global_size, spec.padded(), spec.compute_offset()
    blocks = []
    for i, (pos, dev) in enumerate(zip(device.positions(), device.devices)):
        if not device.is_local(i):
            blocks.append(None)  # another process's position
            continue
        o, b = spec.block_origin(pos), spec.block_size(pos)
        hot, cold = _sphere_masks(g, *(torch.arange(a, a + n, device=dev)
                                       for a, n in ((o.z, b.z), (o.y, b.y), (o.x, b.x))))
        sel = torch.zeros((1, 1, 1, p.z, p.y, p.x), dtype=torch.int32, device=dev)
        sel[0, 0, 0, off.z:off.z + b.z, off.y:off.y + b.y, off.x:off.x + b.x] = (
            hot.to(torch.int32) + 2 * cold.to(torch.int32))
        blocks.append(sel)
    return blocks


def jacobi_reference(field: np.ndarray, masks, iters: int) -> np.ndarray:
    """Slow float64 numpy reference with periodic wrap, for correctness
    checks."""
    hot, cold = masks
    f = field.astype(np.float64)
    for _ in range(iters):
        avg = (
            np.roll(f, 1, 2) + np.roll(f, -1, 2)
            + np.roll(f, 1, 1) + np.roll(f, -1, 1)
            + np.roll(f, 1, 0) + np.roll(f, -1, 0)
        ) / 6
        f = np.where(hot, HOT_TEMP, np.where(cold, COLD_TEMP, avg))
    return f


def multi_block_layout(spec) -> Tuple[Tuple[bool, bool, bool], Tuple[str, ...], list]:
    """``(wrap, axes, shells)`` of a partition: the sweep's ``(wz, wy, wx)``
    wrap flags (single-block axes), the names of the multi-block axes (the
    exchange subset the kernels need), and the overlap shells, the
    radius-thick rects of the compute region along the multi-block axes."""
    multi = multi_block_axes(spec)
    wrap = tuple(not m for m in multi)
    axes = tuple(name for name, m in zip("zyx", multi) if m)
    r = spec.radius
    off = spec.compute_offset()
    compute = Rect3(off, off + spec.base)
    lo = Dim3(r.x(-1) if multi[2] else 0, r.y(-1) if multi[1] else 0, r.z(-1) if multi[0] else 0)
    hi = Dim3(r.x(1) if multi[2] else 0, r.y(1) if multi[1] else 0, r.z(1) if multi[0] else 0)
    shells = exterior_regions(compute, Rect3(compute.lo + lo, compute.hi - hi)) if axes else []
    return wrap, axes, shells


def _sel_ranges(ex, standard_spheres: bool):
    """The planes each block's ``sel`` is imposed on, as the TPU kernel's
    ``sel_z_range`` skips the others: each block's (or mesh position's)
    own sphere planes when ``sel`` holds the standard jacobi3d spheres,
    else None (every plane)."""
    if not standard_spheres:
        return None
    spec = ex.spec
    if ex.on_mesh and not ex.oversubscribed:
        return [block_sel_range(spec, Dim3.of(pos).z) for pos in ex.mesh.positions()]
    return block_sel_ranges(spec)


def _step_body(ex, overlap: bool, ranges=None):
    """``body(curr, nxt, sel) -> (out, curr)``: one step of the domain of
    ``ex`` (the JAX package's Pallas ``body``), ``sel`` imposed on each
    block's ``ranges`` (:func:`_sel_ranges`). ``curr``'s halos are updated
    in place by the exchange."""
    spec = ex.spec
    if ex.method == Method.DIRECT26:
        require_face_radius(spec)

        def body(curr, nxt, sel):
            ex(curr)
            return sweep(curr, nxt, sel, spec, NO_WRAP, ranges), curr
        return body
    wrap, axes, shells = multi_block_layout(spec)
    if not axes:  # every axis wraps inside the kernel: no exchange at all
        return lambda curr, nxt, sel: (sweep(curr, nxt, sel, spec, wrap, ranges), curr)
    require_face_radius(spec)
    if not spec.is_uniform():
        # the JAX package's XLA path for an uneven resident partition:
        # serialized, the full exchange, then the full base extent
        def body(curr, nxt, sel):
            ex(curr)
            return sweep(curr, nxt, sel, spec, NO_WRAP, ranges), curr
    elif overlap:
        def body(curr, nxt, sel):
            # the sweep reads pre-exchange data; the shells' stencils also
            # read the single-block axes' halos, so the FULL exchange runs;
            # every shell of every block in one launch
            out = sweep(curr, nxt, sel, spec, wrap, ranges)
            ex(curr)
            sweep_regions([curr], [out], [sel], spec, [shells], [ranges])
            return out, curr
    else:
        def body(curr, nxt, sel):
            ex.exchange(curr, axes=axes)
            return sweep(curr, nxt, sel, spec, wrap, ranges), curr
    return body


def _ignored(temporal_k, why: str) -> None:
    if temporal_k is not None:
        log.warn(f"temporal_k={temporal_k} ignored: the temporal multistep composes "
                 f"with in-step exchanges; {why}")


def _sweep_step(ex, ranges=None):
    """``step(curr, nxt, sel) -> out``: one no-wrap sweep reading the filled
    halos, ``sel`` imposed on each block's ``ranges``; over a mesh (whose
    operands are lists of per-position stacks) one launch for every block
    of every position, each a view into its stack (the exchange's
    endpoints); over positions of several processes, for this process's."""
    spec = ex.spec
    if ex.on_mesh and ex.oversubscribed:
        bspec, ends = spec.block_spec(), ex._remote._endpoints

        def step(curr, nxt, sel):
            sweep_positions(ends(curr), ends(nxt), ends(sel), bspec, ranges)
            return nxt
    elif ex.on_mesh:
        bspec, locs = spec.block_spec(), ex.mesh.local_positions()
        lranges = [ranges[i] for i in locs] if ranges is not None else None

        def step(curr, nxt, sel):
            sweep_positions([curr[i] for i in locs], [nxt[i] for i in locs],
                            [sel[i] for i in locs], bspec, lranges)
            return nxt
    else:
        def step(curr, nxt, sel):
            return sweep(curr, nxt, sel, spec, NO_WRAP, ranges)
    return step


def _remote_loop(ex, iters: int, temporal_k, ranges=None):
    """Plain remote-dma: per step the exchange (three fills on one block;
    the mesh exchange over a mesh), then the sweep reading the filled
    halos, then the swap."""
    require_face_radius(ex.spec)
    _ignored(temporal_k, "the REMOTE_DMA path runs per-step exchange + sweep dispatches")
    step = _sweep_step(ex, ranges)

    def loop(curr, nxt, sel):
        for _ in range(iters):
            ex(curr)
            curr, nxt = step(curr, nxt, sel), curr
        return curr, nxt

    return loop


def _dyn_shell_step(ex, ranges=None):
    """``step(curr, nxt, sel) -> (out, curr)``: the JAX package's
    dynamic-shell step over an uneven mesh of one block a position (its
    ``use_dyn_overlap`` body): one full-base no-wrap sweep of every position
    on the pre-exchange state; the mesh exchange; then every side's
    boundary shell of every position (``ops/shells``, at the block's own
    size on the hi side) re-swept from the exchanged state. The sweeps are
    one launch (``sweep_positions``), and so are the shells
    (``sweep_regions``), ``sel`` imposed on each position's ``ranges``.
    Over positions of several processes, this rank's positions; on the card
    its sweep follows a handshake with every rank it exchanges with
    (``parallel/ipc.PhaseOrder.before_all``), since it overwrites the
    buffer their previous exchange read."""
    spec, mesh = ex.spec, ex.mesh
    bspec = spec.block_spec()
    include = include_axes(spec, multi_block_only=False)
    idx = mesh.local_positions()
    shells = [shell_regions(spec, dyn_block_sizes(spec, mesh.position(i)), include)
              for i in idx]
    lranges = [ranges[i] for i in idx] if ranges is not None else None

    def step(curr, nxt, sel):
        c, n, s = ([t[i] for i in idx] for t in (curr, nxt, sel))
        if mesh.multi_process and ex.peers is not None:
            ex.peers.order.before_all()
        sweep_positions(c, n, s, bspec, lranges)
        ex(curr)
        sweep_regions(c, n, s, bspec, shells, lranges)
        return nxt, curr

    return step


def _uneven_fused_loop(ex, iters: int, ranges=None):
    """Fused remote-dma over an uneven mesh: the JAX package's
    host-orchestrated schedule (``stencil_tpu/ops/jacobi.py``
    ``_compile_jacobi_fused``), since the fused step kernel (B8) and the
    fused exchange carrier (B7) take uniform partitions only, as on the
    TPU: per step :func:`_dyn_shell_step` (the mesh exchange is B6's uneven
    ring, B4 on the single-position axes), then the swap."""
    step = _dyn_shell_step(ex, ranges)

    def loop(curr, nxt, sel):
        for _ in range(iters):
            curr, nxt = step(curr, nxt, sel)
        return curr, nxt

    return loop


def _positions_loop(ex, iters: int, overlap: bool, k: int, ranges=None):
    """AXIS_COMPOSED or DIRECT26 over a mesh of one block a position: the
    JAX package's Pallas-branch schedule of ``_compile_jacobi`` on each
    device, every position's work in one launch. The exchange moves copies
    between positions (``parallel/mesh_exchange``). Per step:

    - DIRECT26: the full exchange, then one no-wrap sweep of every position.
    - AXIS_COMPOSED, uniform, with overlap: one sweep of every position on
      the pre-exchange state, wrapping its single-position axes (across
      processes on the card after a handshake with every rank it exchanges
      with: the sweep overwrites the buffer their previous exchange read);
      the full exchange; then every position's overlap shells along the
      multi-position axes (:func:`multi_block_layout`) in one launch.
    - without overlap: the exchange of the multi-position axes, then the
      wrapping sweep.
    - uneven, with overlap: the dynamic-shell step (:func:`_dyn_shell_step`).

    With a depth ``k >= 2`` (the deep halo; uniform, overlap, standard
    spheres), each pass of ``iters // k`` is the exchange of the
    multi-position axes and one launch of the multistep's positions form
    over every position at its own global origin; the ``iters % k`` tail
    runs the overlap step. Over positions of several processes every
    launch covers this rank's positions."""
    spec, mesh = ex.spec, ex.mesh
    require_face_radius(spec)
    bspec = spec.block_spec()
    idx = mesh.local_positions()
    lranges = [ranges[i] for i in idx] if ranges is not None else None
    wrap, axes, shells = multi_block_layout(spec)
    origins = [block_origin(spec, mesh.position(i)) for i in idx]
    handshake = mesh.multi_process and ex.peers is not None

    def local(*ts):
        return ([t[i] for i in idx] for t in ts)

    if ex.method == Method.DIRECT26:
        def step(curr, nxt, sel):
            ex(curr)
            sweep_positions(*local(curr, nxt, sel), bspec, lranges)
            return nxt, curr
    elif not overlap:
        def step(curr, nxt, sel):
            ex.exchange(curr, axes=axes)
            sweep_positions(*local(curr, nxt, sel), bspec, lranges, wrap)
            return nxt, curr
    elif not spec.is_uniform():
        step = _dyn_shell_step(ex, ranges)
    else:
        def step(curr, nxt, sel):
            c, n, s = local(curr, nxt, sel)
            if handshake:
                ex.peers.order.before_all()
            sweep_positions(c, n, s, bspec, lranges, wrap)
            ex(curr)
            sweep_regions(c, n, s, bspec, [shells] * len(c), lranges)
            return nxt, curr

    def loop(curr, nxt, sel):
        n_multi, n_single = divmod(iters, k) if k else (0, iters)
        for _ in range(n_multi):
            ex.exchange(curr, axes=axes)
            multistep_positions(*local(curr, nxt), spec, k, origins)
            curr, nxt = nxt, curr
        for _ in range(n_single):
            curr, nxt = step(curr, nxt, sel)
        return curr, nxt

    loop.temporal_k = k
    return loop


def _fused_loop(ex, iters: int, temporal_k, ranges=None):
    """Fused remote-dma: one fused step kernel per step (halo hand-offs into
    ``curr`` and the sweep into ``nxt``; over a mesh, every position's
    messages and sweeps in one launch, the crossing ones through the
    exchange's wire), then the swap. An uneven mesh runs
    :func:`_uneven_fused_loop` instead."""
    require_face_radius(ex.spec)
    _ignored(temporal_k, "the FUSED path runs one fused exchange+sweep substep per step")
    spec, plan, mesh = ex.spec, ex.plan, ex.mesh
    if not kernel_supported(spec, ex.resident):
        return _uneven_fused_loop(ex, iters, ranges)
    if ex.on_mesh and mesh.multi_process:
        def step(curr, nxt, sel):
            return fused_step_across(curr, nxt, sel, spec, plan, mesh, ex.wire_dtype, ex.peers)
    elif ex.on_mesh:
        def step(curr, nxt, sel):
            return fused_jacobi_mesh(curr, nxt, sel, spec, plan, mesh, ex.wire_dtype)
    else:
        def step(curr, nxt, sel):
            return fused_jacobi(curr, nxt, sel, spec, plan)

    def loop(curr, nxt, sel):
        for _ in range(iters):
            c2, out = step(curr, nxt, sel)
            curr, nxt = out, c2
        return curr, nxt

    return loop


def _persistent_loop(ex, iters: int, temporal_k, ranges=None):
    """Persistent remote-dma: ``sel``'s halos filled once per loop call (in
    place; sel is step-invariant; over a mesh by the axis carrier at the
    deep radius), then per chunk of ``chunk_schedule(iters, k)`` one
    whole-chunk kernel (depth >= 2; over a mesh, one launch for every
    position), or the exchange and one sweep (a depth-1 tail). ``k`` is
    ``temporal_k``, else the realized min face radius. A chunk's result is
    where ``result_in_nxt`` says; the other buffer becomes the scratch.
    ``ex.last_launches_per_chunk`` counts as the JAX package does: 1 per
    kernel chunk on the card, 2 per chunk that runs as exchange + chunk
    program (the CPU's plain versions, a depth-1 tail, and every chunk of an
    uneven mesh: its deep exchange, then the chunk kernel's uneven form).
    Over positions of several processes a chunk steps this rank's
    positions (:func:`persistent_stencil.persistent_chunk_across`); on the
    card ``sel``'s blocks are exported to the other ranks first
    (``parallel/ipc.PeerBuffers.add``), and a chunk's launches count as they
    are issued: 1 a chunk of one
    on-chip pass, 2 of several (the second after its own handshake), and
    the deep exchange of an uneven mesh besides."""
    spec = ex.spec
    require_face_radius(spec)
    uneven = not spec.is_uniform()
    r = spec.radius
    k = (int(temporal_k) if temporal_k is not None
         else min(r.x(-1), r.x(1), r.y(-1), r.y(1), r.z(-1), r.z(1)))
    sched = chunk_schedule(iters, k)
    if sched:
        check_chunk_depth(spec, max(sched))
    tail = _sweep_step(ex, ranges)
    across = ex.on_mesh and ex.mesh.multi_process
    if across:
        def chunk(curr, nxt, sel, d):
            return persistent_chunk_across(curr, nxt, sel, spec, d, ex.mesh, ex.peers)
    elif ex.on_mesh:
        def chunk(curr, nxt, sel, d):
            persistent_jacobi_mesh(curr, nxt, sel, spec, d, ex.mesh)
            return 1
    else:
        def chunk(curr, nxt, sel, d):
            persistent_jacobi(curr, nxt, sel, spec, d)
            return 1

    def loop(curr, nxt, sel):
        if across and ex.peers is not None:
            # on the card the other ranks pull sel's deep halos from its
            # blocks: export them (a collective, once a list)
            ex.peers.add(sel)
        ex(sel)
        first = curr[ex.mesh.local_positions()[0]] if ex.on_mesh else curr
        launches = 0
        for d in sched:
            if d >= 2:
                if uneven:
                    ex(curr)  # the deep halo, once a chunk
                issued = chunk(curr, nxt, sel, d)
                out, scratch = (nxt, curr) if result_in_nxt(d) else (curr, nxt)
                launches += issued + uneven if first.is_cuda else 2
            else:
                ex(curr)
                out, scratch = tail(curr, nxt, sel), curr
                launches += 2
            curr, nxt = out, scratch
        ex.last_launches_per_chunk = launches // max(1, len(sched))
        return curr, nxt

    loop.temporal_k = k
    return loop


def multistep_heights() -> dict:
    """The tile heights the multistep kernel is built for: ``{(k, dtype
    name): rows}`` for every depth and both cell types."""
    return {(k, name): multistep_shape(k, item)["tile"][1]
            for k in range(1, MULTISTEP_KMAX + 1)
            for name, item in (("float32", 4), ("float64", 8))}


def check_multistep_rows(rows: int, k: int) -> None:
    """Refuse a ``multistep_rows`` the depth-``k`` multistep kernel is not
    built for (the JAX package's ``valid_strip_rows`` assertion): on the
    card the rows are the kernel's tile height, which its instantiation
    fixes, so a legal value selects nothing new; the error names the
    heights each depth is built for."""
    legal = {multistep_heights()[(k, name)] for name in ("float32", "float64")}
    if rows not in legal:
        built = ", ".join(f"k={kk} {name}: {h}" for (kk, name), h in
                          sorted(multistep_heights().items()))
        raise ValueError(f"multistep_rows={rows} illegal for k={k}: the multistep kernel "
                         f"is built for tile heights {sorted(legal)} at this depth "
                         f"({built})")


def make_jacobi_step(ex, overlap: bool = True, standard_spheres: bool = True):
    """``step(curr, nxt, sel) -> (new_curr, new_next)`` for the domain of
    HaloExchange ``ex``: one sweep into ``nxt``, then the swap. On a single
    block every axis wraps inside the kernel, so no exchange runs and the
    result is ``(sweep(curr, nxt), curr)``; a multi-block partition
    exchanges (see the module docstring; ``overlap`` picks the structure).
    A remote-dma exchange takes its one-step loop. ``standard_spheres`` as
    for :func:`make_jacobi_loop`."""
    if ex.method == Method.REMOTE_DMA or ex.on_mesh:
        return make_jacobi_loop(ex, 1, overlap=overlap, standard_spheres=standard_spheres)
    _native.note_first_use("loop")
    return _step_body(ex, overlap, _sel_ranges(ex, standard_spheres))


def make_jacobi_loop(ex, iters: int, overlap: bool = True, standard_spheres: bool = True,
                     temporal_k: Optional[int] = None, multistep_rows: Optional[int] = None):
    """``loop(curr, nxt, sel) -> (new_curr, new_next)`` advancing ``iters``
    steps: ``iters // k`` multistep passes of depth ``k`` (each
    ``(multistep(c, x), c)``, after an exchange of the multi-block axes on
    a multi-block partition), then ``iters % k`` single steps.

    ``k`` is the deepest of ``min(12, (nz - 1) // 2, iters)`` (further
    capped by ``temporal_k`` and, on a multi-block partition, by the
    multi-block axes' radii) that :func:`plan_multistep_depth` takes. On a
    multi-block partition the multistep engages only with ``overlap``, and
    on an uneven partition never (``k`` = 0), as in the JAX package.
    ``standard_spheres`` declares that ``sel`` holds
    the standard jacobi3d spheres (``sphere_sel(global_size)``): only then
    may the multistep run, since it derives the spheres from coordinates
    instead of reading ``sel``, and only then do the sweeps read ``sel``
    on each block's sphere planes alone (:func:`stencil_kernels.
    block_sel_range`, as the TPU kernel's ``sel_z_range``); otherwise on
    every plane. The chosen depth is ``loop.temporal_k`` (0 when only
    sweeps run).

    ``multistep_rows`` is the JAX package's strip height of the multistep
    (its row-tiled staging); on the card it is the multistep kernel's tile
    height, which each depth's instantiation fixes, so a value the kernel is
    not built for raises (:func:`check_multistep_rows`) and a legal one
    changes nothing; when the multistep does not engage it is ignored with
    a warning, as in the JAX package.

    A remote-dma exchange runs its own loop instead (see the module
    docstring); ``temporal_k`` is then the persistent chunk depth, and the
    plain and fused loops ignore it with a warning, as in the JAX package.
    A direct26 exchange runs the full exchange and a sweep every step.
    Each call is first-use work (``ops/_native.first_use``), which a
    warmed-up loop never repeats."""
    _native.note_first_use("loop")
    ranges = _sel_ranges(ex, standard_spheres)
    if ex.method == Method.REMOTE_DMA:
        if multistep_rows is not None:
            log.warn(f"multistep_rows={multistep_rows} ignored: row-strip staging is the "
                     "composed multistep's knob")
        if ex.persistent:
            return _persistent_loop(ex, iters, temporal_k, ranges)
        loop = (_fused_loop if ex.fused else _remote_loop)(ex, iters, temporal_k, ranges)
        loop.temporal_k = 0
        return loop
    with timer.timed("jacobi.build"), timer.trace_range("jacobi.build"):
        spec = ex.spec
        r = spec.radius
        _wrap, axes, _shells = multi_block_layout(spec)
        k_want = max(0, min(TEMPORAL_K_CAP, (spec.base.z - 1) // 2, iters))
        if temporal_k is not None:
            k_want = min(k_want, temporal_k)
        # the deep halo: k <= the radius on both sides of each multi-block axis
        for m, rl, rh in zip(multi_block_axes(spec), (r.z(-1), r.y(-1), r.x(-1)),
                             (r.z(1), r.y(1), r.x(1))):
            if m:
                k_want = min(k_want, rl, rh)
        k = (plan_multistep_depth(k_want)
             if standard_spheres and (overlap or not axes) and spec.is_uniform()
             and ex.method == Method.AXIS_COMPOSED else 0)
        if k < 2:
            k = 0
        if multistep_rows is not None:
            if k:
                check_multistep_rows(int(multistep_rows), k)
            else:
                # a probe must never attribute per-step numbers to row tiling
                log.warn(f"multistep_rows={multistep_rows} ignored: the temporal multistep "
                         "did not engage (overlap off, non-uniform partition, direct26, "
                         "iters/radius too small, or non-standard spheres) - timings reflect "
                         "the per-step kernels")
        if ex.on_mesh:
            return _positions_loop(ex, iters, overlap, k, ranges)
        step = _step_body(ex, overlap, ranges)

    def loop(curr, nxt, sel):
        n_multi, n_single = divmod(iters, k) if k else (0, iters)
        for _ in range(n_multi):
            if axes:
                ex.exchange(curr, axes=axes)
            curr, nxt = multistep(curr, nxt, spec, k), curr
        for _ in range(n_single):
            curr, nxt = step(curr, nxt, sel)
        return curr, nxt

    loop.temporal_k = k
    return loop


def warm_jacobi_loops(get_loop, sizes, curr, nxt, sel) -> None:
    """The warm-up of a chunk loop: ``get_loop(k)(a, b, sel)`` for every
    chunk size ``k`` of ``sizes`` from both orders of the two buffers, then
    ``curr`` put back as it was (``nxt`` is scratch). The kernels keep their
    tables by the addresses a launch reads and writes (``_native.kept``),
    and a chunk may start from either order (a multistep pass or an odd
    chunk swaps them), so a warm-up from one order leaves table uploads,
    each with its host sync, in the first chunks of the other. What the
    warm-up leaves in ``nxt`` never reaches a result: a chunk writes every
    compute cell of its output and fills the halos it reads."""
    keep = ([None if b is None else b.clone() for b in curr] if isinstance(curr, list)
            else curr.clone())
    for k in sizes:
        for a, b in ((curr, nxt), (nxt, curr)):
            get_loop(k)(a, b, sel)
    for b, kept in (zip(curr, keep) if isinstance(curr, list) else ((curr, keep),)):
        if b is not None:  # None: another process's position
            b.copy_(kept)


def make_batched_jacobi_loop(spec, iters: int, *, device=None):
    """The multi-tenant batched iteration: ``loop(curr, nxt, sel) ->
    (new_curr, new_next)`` over ``(B, pz, py, px)`` stacks of tenant states,
    advancing every tenant ``iters`` steps. The counterpart of the JAX
    package's ``make_batched_jacobi_loop``.

    ``spec`` describes ONE tenant as a single-block domain
    (``GridSpec(size, Dim3(1, 1, 1), radius)``); each tenant is its own
    periodic box and nothing crosses the tenant axis. ``sel`` is the int32
    sphere code, per tenant ``(B, pz, py, px)`` (on the CPU a shared
    ``(pz, py, px)`` also broadcasts), nonzero only on the spheres' planes
    (:func:`stencil_kernels.sel_z_range`), as the campaign's is.

    The loop runs on ``device`` (default: the current CUDA device) and
    refuses tensors elsewhere. On the card each step is one launch of the
    tenant-form sweep (:func:`stencil_kernels.sweep_tenants`), which wraps
    every axis in-kernel, never fills a halo and reads ``sel`` on the
    spheres' planes only, as the JAX package's Pallas branch: a step returns
    ``(out, curr)``. On the CPU each step is the JAX package's XLA branch:
    the composed self-wrap fill of ``curr`` (:func:`halo_fill.wrap_fill_batched`,
    in place) and the region sweep, reading ``sel`` on every plane,
    returning ``(out, filled curr)``. For a ``sel`` of that form the compute
    regions agree bit for bit (off those planes the card ignores ``sel``;
    the TPU kernel skips it on the tiles outside them); the halos differ. Updates in place, like every loop of
    the port: the caller keeps its own copy of a state it may roll back to."""
    if spec.dim != Dim3(1, 1, 1):
        raise ValueError(
            "batched tenants are single-block domains; got partition "
            f"{spec.dim} (spatial decomposition and tenant batching do not compose yet)")
    r = spec.radius
    if min(r.x(-1), r.x(1), r.y(-1), r.y(1), r.z(-1), r.z(1)) < 1:
        raise ValueError("jacobi needs face radius >= 1 on every side")
    dev = resolve_device(device)
    if dev.type == "cpu":
        off = spec.compute_offset()
        compute = Rect3(off, off + spec.base)

        def run(curr, nxt, sel):
            masks = (sel == 1, sel == 2)
            for _ in range(iters):
                cur2 = wrap_fill_batched(spec, curr)
                curr, nxt = jacobi_sweep(cur2, nxt, compute, masks), cur2
            return curr, nxt
    else:
        _native.lib("jacobi_sweep")  # the first-use kernel build belongs to the program
        srange = sel_z_range(spec)

        def run(curr, nxt, sel):
            for _ in range(iters):
                curr, nxt = sweep_tenants(curr, nxt, sel, spec, srange), curr
            return curr, nxt

    def loop(curr, nxt, sel):
        if any(t.device != dev for t in (curr, nxt, sel)):
            raise ValueError(f"batched loop built for {dev}; operands on "
                             f"{[str(t.device) for t in (curr, nxt, sel)]}")
        return run(curr, nxt, sel)

    return loop
