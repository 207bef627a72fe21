"""Uneven (remainder) partitions in the port against the JAX package: the
dynamic boundary shells, B6's uneven ring (its plain version, and its work
list and pointer table replayed as the kernel reads them), the resident
uneven exchange, the jacobi loops over uneven specs (resident
AXIS_COMPOSED, plain and fused remote-dma over a mesh), the domain round
trip, an uneven checkpoint restored elastically, the health check on an
uneven state and jacobi3d at --no-weak over 6 and 3 positions. The JAX
side runs on its virtual CPU devices (a mesh of n devices for the port's
``["cpu"] * n`` positions, one device for a resident spec). Inputs are
random numpy arrays from a seed, noise in every halo and pad cell.
Tolerance: bit-exact on every compared cell."""

import bisect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import stencil_tpu.apps.jacobi3d as japp
import stencil_tpu.ckpt as jckpt
import stencil_tpu.domain.grid as jgrid
import stencil_tpu.fault.health as jhealth
import stencil_tpu.geometry as jgeo
import stencil_tpu.ops.jacobi as jjac
import stencil_tpu.ops.shells as jshells
import stencil_tpu.parallel as jpar
import stencil_tpu_torch.apps.jacobi3d as tapp
import stencil_tpu_torch.ckpt as tckpt
import stencil_tpu_torch.domain.grid as tgrid
import stencil_tpu_torch.geometry as tgeo
import stencil_tpu_torch.ops.jacobi as tjac
import stencil_tpu_torch.parallel as tpar
from stencil_tpu.api import DistributedDomain as JDomain
from stencil_tpu.parallel.mesh import BLOCK_PSPEC
from stencil_tpu_torch import DistributedDomain
from stencil_tpu_torch.convert import (mesh_state_from_jax, mesh_state_to_numpy, state_from_jax,
                                       state_to_numpy)
from stencil_tpu_torch.ops import halo_fill, remote_dma, row_moves, shells
from test_torch_exchange_launch import launch_wire
from stencil_tpu_torch.ops import stencil_kernels as tk
from stencil_tpu_torch.ops.health_reduce import health_reduce

torch.set_num_threads(2)

F32, F64 = np.float32, np.float64
RDMA_T, RDMA_J = tpar.Method.REMOTE_DMA, jpar.Method.REMOTE_DMA


def radius(geo, r):
    """``r``: an int (every direction), or face radii (x-, x+, y-, y+, z-,
    z+) with every edge and corner at 1."""
    if isinstance(r, int):
        return geo.Radius.constant(r)
    out = geo.Radius.constant(0)
    for d, v in zip(((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1)), r):
        out.set_dir(d, v)
    out.set_edge(1)
    out.set_corner(1)
    return out


def specs(size, dim, r, aligned=True):
    return (tgrid.GridSpec(tgeo.Dim3(*size), tgeo.Dim3(*dim), radius(tgeo, r), aligned=aligned),
            jgrid.GridSpec(jgeo.Dim3(*size), jgeo.Dim3(*dim), radius(jgeo, r), aligned=aligned))


def meshes(dim):
    """(port mesh of CPU positions, JAX mesh of as many virtual devices)."""
    n = int(np.prod(dim))
    return tpar.DeviceMesh(dim, ["cpu"] * n), jpar.grid_mesh(jgeo.Dim3(*dim), jax.devices()[:n])


def one_device():
    return jpar.grid_mesh(jgeo.Dim3(1, 1, 1), jax.devices()[:1])


def noisy(jspec, dtypes, seed):
    rng = np.random.RandomState(seed)
    return {i: rng.rand(*jspec.stacked_shape_zyx()).astype(dt) for i, dt in enumerate(dtypes)}


def block_indices(spec):
    d = spec.dim
    return [(ix, iy, iz) for iz in range(d.z) for iy in range(d.y) for ix in range(d.x)]


def own_box(arr, spec, grow):
    """Each block's compute region at its own size grown by ``grow`` cells
    (radius-wide halos: the cells every exchange fills), stacked as a list."""
    off = spec.compute_offset()
    out = []
    for ix, iy, iz in block_indices(spec):
        s = spec.block_size((ix, iy, iz))
        out.append(arr[iz, iy, ix, off.z - grow:off.z + s.z + grow,
                       off.y - grow:off.y + s.y + grow, off.x - grow:off.x + s.x + grow])
    return out


# -- the dynamic shells ---------------------------------------------------------------

SHELL_CASES = [((17, 19, 16), (2, 2, 2), 2), ((13, 11, 9), (3, 2, 1), (2, 1, 1, 2, 1, 1)),
               ((103, 12, 8), (5, 1, 1), 1)]


@pytest.mark.parametrize("size,dim,r", SHELL_CASES, ids=["222-r2", "321-asym", "511-r1"])
def test_shells_match_jax(size, dim, r):
    """Per block index: the JAX package's ``dyn_block_sizes`` (its traced
    table lookups, run under ``shard_map``) equal the port's ints; the
    shells (both include sets) equal JAX's ``(lo, size)`` pairs; the
    interior mask equals JAX's."""
    tspec, jspec = specs(size, dim, r)
    _tmesh, jmesh = meshes(dim)
    d, P4 = jspec.dim, PartitionSpec(*BLOCK_PSPEC[:4])
    fn = jax.jit(jax.shard_map(
        lambda x: x + jnp.stack([jnp.asarray(v, jnp.int32)
                                 for v in jshells.dyn_block_sizes(jspec)]).reshape(1, 1, 1, 3),
        mesh=jmesh, in_specs=P4, out_specs=P4))
    dyn = np.asarray(fn(jax.device_put(np.zeros((d.z, d.y, d.x, 3), np.int32),
                                       NamedSharding(jmesh, P4))))
    for ix, iy, iz in block_indices(tspec):
        sizes = shells.dyn_block_sizes(tspec, (ix, iy, iz))
        assert sizes == tuple(int(v) for v in dyn[iz, iy, ix])
        for only in (False, True):
            inc = shells.include_axes(tspec, only)
            assert inc == jshells.include_axes(jspec, only)
            got = shells.shell_regions(tspec, sizes, inc)
            want = jshells.shell_regions(jspec, sizes, inc)
            assert len(got) == len(want)
            for rect, (lo, sz) in zip(got, want):
                lo = tuple(int(v) for v in lo)
                assert (rect.lo.z, rect.lo.y, rect.lo.x) == lo
                assert (rect.hi.z, rect.hi.y, rect.hi.x) == tuple(a + b for a, b in zip(lo, sz))
            np.testing.assert_array_equal(shells.interior_mask(tspec, sizes, inc).numpy(),
                                          np.asarray(jshells.interior_mask(jspec, sizes, inc)))


# -- B6's uneven ring ------------------------------------------------------------------

# (id, size, mesh, radius, dtypes, wire): JAX's REMOTE_DMA exchange on as
# many virtual devices (its CPU emulation, which the JAX tests pin equal to
# AXIS_COMPOSED) against the port's mesh exchange through remote_axis
RING_CASES = [
    ("222-r2-f32", (17, 19, 16), (2, 2, 2), 2, [F32], None),
    ("321-r1-mixed", (13, 11, 9), (3, 2, 1), 1, [F32, F64, F32], None),
    ("511-r1-f64", (23, 7, 6), (5, 1, 1), 1, [F64], None),
    ("231-asym-f32", (20, 14, 12), (2, 3, 1), (2, 1, 1, 2, 1, 1), [F32, F32], None),
    ("222-bf16-wire", (17, 19, 16), (2, 2, 2), 2, [F32, F64], "bfloat16"),
    ("321-bf16-wire", (13, 11, 9), (3, 2, 1), 1, [F32], "bfloat16"),
]


def jax_mesh_exchange(jspec, jmesh, arrs, **kw):
    jex = jpar.HaloExchange(jspec, jmesh, RDMA_J, **kw)
    out = jex({k: jax.device_put(v, NamedSharding(jmesh, BLOCK_PSPEC)) for k, v in arrs.items()})
    return {k: np.asarray(v) for k, v in out.items()}, jex


@pytest.mark.parametrize("name,size,dim,r,dtypes,wire", RING_CASES, ids=[c[0] for c in RING_CASES])
def test_uneven_ring_matches_jax(name, size, dim, r, dtypes, wire):
    """Every cell of every quantity after one exchange (halos, pad and the
    dead tail of the smaller blocks), the transfer count and the plan's
    size tables."""
    tspec, jspec = specs(size, dim, r)
    tmesh, jmesh = meshes(dim)
    assert not tspec.is_uniform()
    arrs = noisy(jspec, dtypes, 7)
    want, jex = jax_mesh_exchange(jspec, jmesh, arrs, wire_dtype=wire)
    tex = tpar.HaloExchange(tspec, RDMA_T, mesh=tmesh, wire_dtype=wire)
    st = mesh_state_from_jax(arrs, tspec, tmesh)
    tex(st)
    got = mesh_state_to_numpy(st, tspec)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} q{k}")
        if wire:
            assert not np.array_equal(got[k], arrs[k])
    assert tex.last_transfer_count == jex._remote.last_transfer_count
    assert [p.sizes for p in tex.plan.remote_phases] == [p.sizes for p in jex.plan.remote_phases]


def test_uneven_ring_plain_at_own_sizes():
    """remote_axis_plain on a (5,1,1) ring of 103/103/102/102/102: each
    block's hi slab is read at its own size and each hi halo written
    there, from a coordinate field."""
    tspec, _j = specs((512, 8, 8), (5, 1, 1), 2)
    assert tspec.sizes_x == (103, 103, 102, 102, 102)
    tmesh, _jm = meshes((5, 1, 1))
    plan = tpar.HaloExchange(tspec, RDMA_T, mesh=tmesh).plan
    (ph,) = [p for p in plan.remote_phases if p.ring > 1]
    g = np.arange(512, dtype=np.float64)[None, None, :].repeat(8, 1).repeat(8, 0)
    blocks = [[b] for b in tpar.shard_blocks(g, tspec, tmesh)]
    remote_dma.remote_axis_plain(blocks, tspec, ph, tmesh)
    o = tspec.compute_offset()
    for i, (b,) in enumerate(blocks):
        n, x0 = tspec.sizes_x[i], sum(tspec.sizes_x[:i])
        row = b[0, 0, 0, o.z, o.y].numpy()
        np.testing.assert_array_equal(row[o.x - 2:o.x], [(x0 - 2) % 512, (x0 - 1) % 512])
        np.testing.assert_array_equal(row[o.x + n:o.x + n + 2], [(x0 + n) % 512,
                                                                 (x0 + n + 1) % 512])


class ArenaCard:
    """Stands in for the card in remote_axis's CUDA branch: the blocks are
    views into one flat CPU arena (a block's gap after it), so a pointer
    moved off a block's start still names arena words, and a Python copy of
    csrc/row_moves.cuh replays each uploaded table on the arena, task by
    task, as the kernel reads it. ``calls`` keeps (axis, m, word, widths)
    per launch."""

    type, index = "cuda", 0

    def __init__(self, monkeypatch, spec, groups, shift=0):
        p = spec.padded()
        self.blk = p.z * p.y * p.x
        words = sum(len(g) for g in groups) * 2 * self.blk + 16
        self.arenas, self.calls, self.tables = {}, [], {}
        nxt, out = {}, []
        for g in groups:
            views = []
            for b in g:
                a = self.arenas.setdefault(b.dtype, torch.zeros(words, dtype=b.dtype))
                k = nxt.get(b.dtype, shift)
                views.append(a[k:k + self.blk].view(b.shape).copy_(b))
                nxt[b.dtype] = k + 2 * self.blk
            out.append(views)
        self.groups = out
        monkeypatch.setattr(remote_dma, "_check_mesh_blocks", lambda *a: self)
        monkeypatch.setattr(remote_dma._native, "kept", lambda key, make: make())
        monkeypatch.setattr(remote_dma._native, "upload", self.upload)
        monkeypatch.setattr(remote_dma._native, "stream_ptr", lambda dev: 0)
        monkeypatch.setattr(remote_dma._native, "lib", lambda name: self)

    def upload(self, values, device):
        t = torch.tensor(values, dtype=torch.int64)
        self.tables[t.data_ptr()] = t.tolist()
        return t

    def remote_axis_launch(self, ptrs, m, segs, nseg, tasks, word, code, fmt, sz, sy, _stream):
        table = self.tables[ptrs]
        head = (segs - ptrs) // 8
        rows = [table[i:i + row_moves.MOVE_COLS] for i in range(head, len(table),
                                                                row_moves.MOVE_COLS)]
        assert len(rows) == nseg
        arena = next(a for a in self.arenas.values() if a.element_size() == word)
        self.calls.append((m, word, sorted({r[8] for r in rows})))
        replay_arena(arena, table[:head], m, rows, tasks, sz, sy, launch_wire(code, fmt))
        return 0


def replay_arena(arena, ptr_rows, m, seg_rows, tasks, sz, sy, wire=None):
    """csrc/row_moves.cuh over a flat arena: pointers are arena addresses
    (possibly moved off a block's start), units as the kernel computes
    them; a narrow segment rounds through ``wire`` unless its sender row
    is marked local. In place."""
    task = row_moves.move_shape()["task_units"]
    word, a0 = arena.element_size(), arena.data_ptr()
    flat = arena.view(-1)
    starts = [row[12] for row in seg_rows]
    for t in range(tasks):
        row = seg_rows[bisect.bisect_right(starts, t) - 1]
        g, src, dst, split, src2, dst2, end, units, width, ey, rows, chunks, start, narrow = row
        c, j = divmod(t - start, m)
        sender = ptr_rows[2 * (g * m + j)]
        narrow = narrow and not sender & 1  # the local mark (row_moves.cuh)
        p = ((sender & ~1) - a0) // word
        q = (ptr_rows[2 * (g * m + j) + 1] - a0) // word
        i = np.arange(c * task, min((c + 1) * task, rows * units), dtype=np.int64)
        r, k = np.divmod(i, units)
        base = (r // ey) * sz + (r % ey) * sy
        for keep, x, s0, d0, a, b in ((k < split, k * width, src, dst, p, q),
                                      ((k >= split) & (k < end), (k - split) * width, src2, dst2,
                                       q, p)):
            if keep.any():
                off = (base[keep] + x[keep])[:, None] + np.arange(width)
                words = flat[torch.from_numpy((a + s0 + off).ravel())]
                flat[torch.from_numpy((b + d0 + off).ravel())] = \
                    halo_fill.wire_round(words, wire) if narrow else words


TABLE_CASES = [("321-r1", (67, 45, 29), (3, 2, 1), 1, True, [F32, F32]),
               ("321-r1-unaligned", (67, 45, 29), (3, 2, 1), 1, False, [F32]),
               ("231-asym-f64", (100, 70, 61), (2, 3, 1), (2, 1, 1, 2, 1, 1), True, [F64]),
               ("511-r1", (103, 9, 7), (5, 1, 1), 1, True, [F32]),
               ("222-r2-mixed-bf16", (17, 19, 16), (2, 2, 2), 2, True, [F32, F64])]


@pytest.mark.parametrize("name,size,dim,r,aligned,dtypes", TABLE_CASES,
                         ids=[c[0] for c in TABLE_CASES])
def test_uneven_tables_replay_to_the_plain_version(monkeypatch, name, size, dim, r, aligned,
                                                   dtypes):
    """The mesh exchange's CUDA branch on an uneven ring: the table it
    uploads (pointers moved by remote_axis_shifts, the uniform work list),
    replayed as the kernel reads it, equals remote_axis_plain on every cell
    (bf16 on the wire in the last case); one launch per (ring phase, dtype
    group), as on a uniform ring; 16-byte units are chosen on the moved
    addresses (none in an uneven x phase, as an x pointer moves by single
    words); the shifts are each block's (n_i - base) planes, rows or words."""
    tspec, jspec = specs(size, dim, r, aligned)
    tmesh, _jm = meshes(dim)
    wire = "bfloat16" if "bf16" in name else None
    arrs = noisy(jspec, dtypes, 3)
    tex = tpar.HaloExchange(tspec, RDMA_T, mesh=tmesh, wire_dtype=wire)
    want = mesh_state_from_jax(arrs, tspec, tmesh)
    tex(want)
    st = mesh_state_from_jax(arrs, tspec, tmesh)
    keys = list(st)
    card = ArenaCard(monkeypatch, tspec, [[st[k][i] for k in keys] for i in range(len(tmesh))])
    cst = {k: [card.groups[i][q] for i in range(len(tmesh))] for q, k in enumerate(keys)}
    before = remote_dma.remote_axis.launches
    tex(cst)
    groups = len(halo_fill.dtype_groups({k: v[0] for k, v in cst.items()}))
    rings = [p for p in tex.plan.remote_phases if p.ring > 1 and p.active]
    assert remote_dma.remote_axis.launches - before == len(rings) * groups == len(card.calls)
    for k in keys:
        for a, b in zip(cst[k], want[k]):
            assert torch.equal(a, b), (name, k)
    p = tspec.padded()
    for ph in rings:
        shifts = remote_dma.remote_axis_shifts(tspec, ph.axis, tmesh)
        sizes = remote_dma.ring_sizes(tspec, ph.axis, tmesh)
        base = max(sizes)
        if ph.uniform:
            assert shifts == {}
            continue
        stride = {"x": 1, "y": p.x, "z": p.y * p.x}[ph.axis]
        for step, (s_off, r_off) in shifts.items():
            assert (s_off if sum(step) > 0 else r_off) == tuple((n - base) * stride
                                                               for n in sizes)
            assert (r_off if sum(step) > 0 else s_off) is None
    x_calls = [c for ph, c in zip([p for p in rings for _ in range(groups)], card.calls)
               if ph.axis == "x"]
    if tspec.sizes_x[0] != tspec.sizes_x[-1]:
        assert all(widths == [1] for _m, _w, widths in x_calls)


class _StackSlots:
    """Sizes ArenaCard's slots for whole stacks: ``padded()`` is one stack
    of ``blocks`` padded blocks of ``spec``."""

    def __init__(self, spec, blocks):
        p = spec.padded()
        self.p = tgeo.Dim3(p.x, p.y, p.z * blocks)

    def padded(self):
        return self.p


@pytest.mark.parametrize("mesh_dim", [None, (2, 1, 2)], ids=["one-device", "oversub-212"])
def test_uneven_resident_endpoints_replay_to_the_plain_version(monkeypatch, mesh_dim):
    """REMOTE_DMA over the resident blocks of an uneven (2,2,2) split of
    17 x 16 x 16 in fp64, on one device and on a (2,1,2) mesh of stacks:
    the table the card gets (every block an endpoint, a view into its
    stack; pointers moved by the uneven ring's shifts) replayed on an arena
    equals the plain exchange on every cell, and that the JAX package's
    (tests/test_remote_dma.py's uneven-oversub-f64 case)."""
    tspec, jspec = specs((17, 16, 16), (2, 2, 2), 1)
    arrs = noisy(jspec, [F64, F64], 19)
    if mesh_dim is None:
        jmesh, tmesh = one_device(), None
        state = lambda: state_from_jax(arrs, tspec, "cpu")  # noqa: E731
    else:
        tmesh = tpar.DeviceMesh(mesh_dim, ["cpu"] * 4)
        jmesh = jpar.grid_mesh(jgeo.Dim3(*mesh_dim), jax.devices()[:4])
        state = lambda: mesh_state_from_jax(arrs, tspec, tmesh)  # noqa: E731
    jex = jpar.HaloExchange(jspec, jmesh, RDMA_J)
    jwant = jex({k: jax.device_put(v, NamedSharding(jmesh, BLOCK_PSPEC)) for k, v in arrs.items()})
    tex = tpar.HaloExchange(tspec, RDMA_T, mesh=tmesh)
    want = state()
    tex(want)
    st = state()
    keys = list(st)
    per = st[keys[0]] if tmesh is not None else [st[keys[0]]]
    card = ArenaCard(monkeypatch, _StackSlots(tspec, per[0].shape[:3].numel()),
                     [[st[k][i] if tmesh is not None else st[k] for k in keys]
                      for i in range(len(per))])
    cst = ({k: [card.groups[i][q] for i in range(len(per))] for q, k in enumerate(keys)}
           if tmesh is not None else {k: card.groups[0][q] for q, k in enumerate(keys)})
    tex(cst)
    assert len(card.calls) == 3  # x, y and z: a ring over the blocks, one dtype group
    to_np = ((lambda s: mesh_state_to_numpy(s, tspec)) if tmesh is not None
             else state_to_numpy)
    got, ref = to_np(cst), to_np(want)
    for k in keys:
        np.testing.assert_array_equal(got[k], ref[k])
        np.testing.assert_array_equal(got[k], np.asarray(jwant[k]))


def test_uneven_sector_floor_counts_each_blocks_own_size():
    """remote_axis_sector_bytes on an uneven ring is the sum over ring
    indices of a block's sectors at its own size (a row end at o + n_i
    may straddle a sector the base size does not), and equals a count of
    the sectors word by word; remote_axis_bytes is the same as a uniform
    ring's of the same padded pitch."""
    tspec, _j = specs((512, 512, 512), (3, 2, 1), 3)
    uspec, _j = specs((513, 512, 512), (3, 2, 1), 3)
    assert tspec.padded() == uspec.padded()
    plan = tpar.HaloExchange(tspec, RDMA_T, mesh=meshes((3, 2, 1))[0]).plan
    uplan = tpar.HaloExchange(uspec, RDMA_T, mesh=meshes((3, 2, 1))[0]).plan
    p = tspec.padded()
    for ph, uph in zip(plan.remote_phases, uplan.remote_phases):
        if ph.ring < 2:
            continue
        assert remote_dma.remote_axis_bytes(tspec, ph, 4, 6, 4) == \
            remote_dma.remote_axis_bytes(uspec, uph, 4, 6, 4)
        o, _b, rm, rp = halo_fill.axis_geom(tspec, ph.axis)
        want = 0
        for n in ph.sizes:
            words = []
            for side in (0, 1):
                boxes = remote_dma.remote_axis_boxes(ph.axis, (o, n, rm, rp), (p.z, p.y, p.x))[0]
                w = []
                for box in boxes:
                    corner, shape = box[side], box[2]
                    z, y, x = np.meshgrid(*(np.arange(e, dtype=np.int64) for e in shape),
                                          indexing="ij")
                    w.append(((corner[0] + z) * p.y * p.x + (corner[1] + y) * p.x
                              + corner[2] + x).ravel())
                words.append(np.concatenate(w))
            want += sum(len(np.unique(w * 4 // row_moves.SECTOR_BYTES)) for w in words)
        got = remote_dma.remote_axis_sector_bytes(tspec, ph, 1, len(ph.sizes), 4)
        assert got == want * row_moves.SECTOR_BYTES, ph.axis
        assert got >= remote_dma.remote_axis_bytes(tspec, ph, 1, len(ph.sizes), 4)


# -- the resident uneven exchange ------------------------------------------------------

RESIDENT_CASES = [((11, 9, 13), (2, 2, 2), 2, [F32]), ((13, 7, 5), (2, 2, 2), 1, [F32]),
                  ((12, 12, 13), (2, 2, 2), 2, [F64]),
                  ((13, 11, 9), (3, 2, 1), (2, 1, 1, 2, 1, 1), [F32, F64, F32, F32]),
                  ((19, 18, 16), (2, 2, 2), 3, [F32, F32])]


@pytest.mark.parametrize("size,dim,r,dtypes", RESIDENT_CASES,
                         ids=["222-r2", "222-r1-three-way", "z-13-f64", "321-asym-mixed",
                              "x-only-r3"])
def test_resident_uneven_exchange_matches_jax(size, dim, r, dtypes):
    """Every cell of every quantity after one exchange on one device
    (tests/test_exchange.py:120, :126, :272), after a second one, the byte
    accounting, and the same state through the mesh exchange (B6's plain
    version) over as many positions."""
    tspec, jspec = specs(size, dim, r)
    jex = jpar.HaloExchange(jspec, one_device())
    tex = tpar.HaloExchange(tspec)
    assert tuple(tex.resident) == tuple(jex.resident) == dim
    arrs = noisy(jspec, dtypes, 11)
    want = jex({i: jax.device_put(a, jex.sharding()) for i, a in arrs.items()})
    st = state_from_jax(arrs, tspec, "cpu")
    tex(st)
    for i, v in state_to_numpy(st).items():
        np.testing.assert_array_equal(v, np.asarray(want[i]))
    tex.make_loop(2)(st)
    for i, v in state_to_numpy(st).items():
        np.testing.assert_array_equal(v, np.asarray(want[i]))
    items = [a.dtype.itemsize for a in arrs.values()]
    assert tex.bytes_logical(items) == jex.bytes_logical(items)
    assert tex.bytes_moved(items) == jex.bytes_moved(items)
    tmesh, _jm = meshes(dim)
    mst = mesh_state_from_jax(arrs, tspec, tmesh)
    tpar.HaloExchange(tspec, RDMA_T, mesh=tmesh)(mst)
    for i, v in mesh_state_to_numpy(mst, tspec).items():
        for a, b in zip(own_box(v, tspec, 1), own_box(np.asarray(want[i]), tspec, 1)):
            np.testing.assert_array_equal(a, b)


def test_resident_uneven_across_the_resident_axis():
    """z = 4+4+3+3 on one device (tests/test_exchange.py:297's partition):
    equal to the JAX package on every cell."""
    tspec, jspec = specs((8, 8, 14), (1, 1, 4), 2)
    assert tspec.sizes_z == (4, 4, 3, 3)
    jex = jpar.HaloExchange(jspec, one_device())
    arrs = noisy(jspec, [F32], 4)
    want = jex({0: jax.device_put(arrs[0], jex.sharding())})[0]
    st = state_from_jax(arrs, tspec, "cpu")
    tpar.HaloExchange(tspec)(st)
    np.testing.assert_array_equal(st[0].numpy(), np.asarray(want))


# -- the jacobi loops -------------------------------------------------------------------

def start_fields(jspec, size, jmesh, seed, dtype=F32):
    rng = np.random.RandomState(seed)
    shape = jspec.stacked_shape_zyx()
    sel = np.asarray(jpar.exchange.shard_blocks(jjac.sphere_sel(jgeo.Dim3(*size)), jspec, jmesh))
    return {"c": rng.rand(*shape).astype(dtype), "n": rng.rand(*shape).astype(dtype), "s": sel}


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("size,dim,r,iters", [((19, 15, 10), (2, 2, 2), 1, 3),
                                              ((19, 18, 16), (2, 2, 2), 2, 4),
                                              ((13, 11, 9), (3, 2, 1), 1, 3)],
                         ids=["222-r1", "x-uneven-r2", "321-r1"])
def test_resident_uneven_jacobi_matches_jax(size, dim, r, iters, overlap, dtype):
    """Resident AXIS_COMPOSED over an uneven partition
    (tests/test_jacobi.py:55, :736): no multistep (``temporal_k`` 0), the
    serialized exchange-then-sweep step; both buffers, every cell, against
    the JAX package's XLA loop on one device, in float32 and float64."""
    tspec, jspec = specs(size, dim, r)
    mesh = one_device()
    jex = jpar.HaloExchange(jspec, mesh)
    arrs = start_fields(jspec, size, mesh, iters, dtype)
    js = {k: jax.device_put(v, jex.sharding()) for k, v in arrs.items()}
    jc, jn = jjac.make_jacobi_loop(jex, iters, overlap=overlap)(js["c"], js["n"], js["s"])
    tloop = tjac.make_jacobi_loop(tpar.HaloExchange(tspec), iters, overlap=overlap)
    assert tloop.temporal_k == 0 and not tspec.is_uniform()
    st = state_from_jax(arrs, tspec, "cpu")
    tc, tn = tloop(st["c"], st["n"], st["s"])
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    step = tjac.make_jacobi_step(tpar.HaloExchange(tspec), overlap=overlap)
    st = state_from_jax(arrs, tspec, "cpu")
    out, cur = step(st["c"], st["n"], st["s"])
    jstep = jjac.make_jacobi_step(jex, overlap=overlap)
    jo, jcur = jstep(*(jax.device_put(arrs[k], jex.sharding()) for k in "cns"))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(cur.numpy(), np.asarray(jcur))


def mesh_loops(size, dim, r, iters, seed, dtype=F32, **kw):
    tspec, jspec = specs(size, dim, r)
    tmesh, jmesh = meshes(dim)
    arrs = start_fields(jspec, size, jmesh, seed, dtype)
    jex = jpar.HaloExchange(jspec, jmesh, RDMA_J, **kw)
    js = {k: jax.device_put(v, NamedSharding(jmesh, BLOCK_PSPEC)) for k, v in arrs.items()}
    jc, jn = jjac.make_jacobi_loop(jex, iters)(js["c"], js["n"], js["s"])
    tex = tpar.HaloExchange(tspec, RDMA_T, mesh=tmesh, **kw)
    ts = mesh_state_from_jax(arrs, tspec, tmesh)
    tloop = tjac.make_jacobi_loop(tex, iters)
    assert tloop.temporal_k == 0
    tc, tn = tloop(ts["c"], ts["n"], ts["s"])
    return (mesh_state_to_numpy({"c": tc, "n": tn}, tspec),
            {"c": np.asarray(jc), "n": np.asarray(jn)}, tspec, jspec, tex)


MESH_JACOBI = [((19, 15, 10), (2, 2, 2), 1), ((13, 11, 9), (3, 2, 1), 1),
               ((23, 7, 6), (5, 1, 1), 1), ((17, 19, 16), (2, 2, 2), 2)]
MESH_IDS = ["222-r1", "321-r1", "511-r1", "222-r2"]


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("size,dim,r", MESH_JACOBI, ids=MESH_IDS)
def test_mesh_plain_uneven_jacobi_matches_jax(size, dim, r, dtype):
    """Plain remote-dma over an uneven mesh: 3 steps of the exchange (B6's
    uneven ring, B4) and one sweep per position; both buffers, every cell,
    in float32 and float64."""
    got, want, tspec, _js, _tex = mesh_loops(size, dim, r, 3, 21, dtype)
    assert not tspec.is_uniform()
    for key in ("c", "n"):
        assert got[key].dtype == dtype
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("dtype,wire", [(F32, None), (F32, "bfloat16"), (F64, None),
                                        (F64, "float32")])
@pytest.mark.parametrize("size,dim,r", MESH_JACOBI, ids=MESH_IDS)
def test_mesh_fused_uneven_jacobi_matches_jax(size, dim, r, dtype, wire):
    """Fused remote-dma over an uneven mesh (tests/test_fused_stencil.py:176,
    :182): the host-orchestrated schedule (pre-exchange sweeps, the mesh
    exchange, every side's shell); 3 steps, bf16 on the wire too. The
    gathered compute regions of both buffers; the last exchanged state on
    each block's own compute region grown by the radius (every halo cell
    the JAX package's fused messages fill); the swept buffer on that box's
    compute and face cells. Its edge and corner halo cells, which no
    7-point stencil reads, hold the full-base sweep's dead cells: the axis
    carrier fills pad cells the fused messages leave, and a smaller block's
    dead cells sit where its edge halos are."""
    got, want, tspec, jspec, tex = mesh_loops(size, dim, r, 3, 23, dtype, fused=True,
                                              wire_dtype=wire)
    assert isinstance(tex._remote, remote_dma.RemoteDmaExchange)
    for key in ("c", "n"):
        np.testing.assert_array_equal(jpar.exchange.unshard_blocks(jnp.asarray(got[key]), jspec),
                                      jpar.exchange.unshard_blocks(jnp.asarray(want[key]), jspec))
    for a, b in zip(own_box(got["n"], tspec, r), own_box(want["n"], tspec, r)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(own_box(got["c"], tspec, r), own_box(want["c"], tspec, r)):
        faces = face_cells(a.shape, r)
        np.testing.assert_array_equal(a[faces], b[faces])


def face_cells(shape, r):
    """Bool over a block's compute box grown by ``r``: the compute cells and
    the face halos (at most one axis outside the compute range)."""
    out = sum(np.logical_or(np.arange(n) < r, np.arange(n) >= n - r).reshape(
        [-1 if i == ax else 1 for i in range(3)]).astype(int) for ax, n in enumerate(shape))
    return out <= 1


def test_mesh_fused_uneven_launch_schedule(monkeypatch):
    """The uneven fused step's calls per step on (3,2,1): one full-base
    sweep of every position (one launch), the exchange, then every
    position's six shells, each at the block's own size on its hi side
    (one launch), each position's sel on its own sphere planes."""
    tspec, _j = specs((13, 11, 9), (3, 2, 1), 1)
    tmesh, _jm = meshes((3, 2, 1))
    tex = tpar.HaloExchange(tspec, RDMA_T, mesh=tmesh, fused=True)
    calls = []
    monkeypatch.setattr(tjac, "sweep_positions",
                        lambda c, n, s, spec, ranges: calls.append(("sweep", len(c), ranges))
                        or n)
    monkeypatch.setattr(tjac, "sweep_regions",
                        lambda c, o, s, spec, rects, ranges: calls.append(("shells", rects))
                        or o)
    real = tex._remote
    monkeypatch.setattr(tex, "_remote", lambda st, axes=None: calls.append(("ex",)) or real(st))
    st = tpar.shard_blocks(np.zeros((9, 11, 13), F32), tspec, tmesh)
    sel = tjac.sphere_sel_blocks(tspec, tmesh)
    tjac.make_jacobi_loop(tex, 2)(st, [b.clone() for b in st], sel)
    ranges = [tk.block_sel_range(tspec, pos[2]) for pos in tmesh.positions()]
    per_step = [("sweep", 6, ranges), ("ex",)]
    off = tspec.compute_offset()
    rects = []
    for pos in tmesh.positions():
        s = tspec.block_size(pos)
        rects.append(shells.shell_regions(tspec, (s.z, s.y, s.x), (True, True, True)))
        assert rects[-1][-1].lo.x == off.x + s.x - 1  # the x hi shell
    per_step.append(("shells", rects))
    assert calls == per_step * 2


def test_persistent_on_uneven_mesh_raises(monkeypatch):
    """The persistent variant on an uneven mesh now runs the chunk kernel's
    uneven form: 5 steps at k = 2 are sel's deep exchange once, then per
    chunk the deep exchange (B6's uneven ring) and one chunk launch over
    every position (2 dispatches a chunk, the depth-1 tail the exchange and
    a sweep)."""
    tspec, _j = specs((17, 16, 16), (2, 2, 2), 2)
    tmesh = meshes((2, 2, 2))[0]
    tex = tpar.HaloExchange(tspec, RDMA_T, mesh=tmesh, persistent=True)
    assert tex.plan.persistent and tex.plan.launches_per_chunk(2) == 2
    calls = []
    real = tex._remote
    monkeypatch.setattr(tex, "_remote", lambda st, axes=None: calls.append("ex") or real(st))
    chunk = tjac.persistent_jacobi_mesh
    monkeypatch.setattr(tjac, "persistent_jacobi_mesh",
                        lambda c, n, s, spec, d, mesh: calls.append(f"chunk{d}")
                        or chunk(c, n, s, spec, d, mesh))
    st = tpar.shard_blocks(np.full((16, 16, 17), 0.5, F32), tspec, tmesh)
    sel = tjac.sphere_sel_blocks(tspec, tmesh)
    tjac.make_jacobi_loop(tex, 5, temporal_k=2)(st, [b.clone() for b in st], sel)
    assert calls == ["ex"] + ["ex", "chunk2"] * 2 + ["ex"]
    assert tex.last_launches_per_chunk == 2


# -- the domain, checkpoints and the health check -----------------------------------------

def port_domain(size, r, part=None, devices=None, dtype="float32"):
    dd = DistributedDomain(*size, device="cpu")
    if devices:
        dd.set_devices(devices)
        dd.set_methods(RDMA_T)
    dd.set_radius(r)
    if part:
        dd.set_partition(part)
    h = dd.add_data("q", dtype)
    dd.realize()
    return dd, h


def jax_domain(size, r, ndev, part=None, dtype="float32"):
    dd = JDomain(*size)
    dd.set_devices(jax.devices()[:ndev])
    dd.set_radius(r)
    if part:
        dd.set_partition(part)
    h = dd.add_data("q", dtype)
    dd.realize()
    return dd, h


@pytest.mark.parametrize("where", ["resident", "mesh"])
def test_domain_round_trip_matches_jax(where):
    """tests/test_distributed_domain.py:198 on the port: an (11, 9, 13)
    radius-2 domain over (2,2,2) resident blocks or 8 positions; the
    global round trip, the exchanged state against the JAX domain's on
    every cell each block owns or fills, and set_partition((3, 1, 1)) on
    16^3 realizing."""
    size = (11, 9, 13)
    if where == "resident":
        dd, h = port_domain(size, 2, part=(2, 2, 2))
        jd, jh = jax_domain(size, 2, 1, part=(2, 2, 2))
    else:
        dd, h = port_domain(size, 2, devices=["cpu"] * 8)
        jd, jh = jax_domain(size, 2, 8)
    assert tuple(dd.spec.dim) == tuple(jd.spec.dim) == (2, 2, 2) and not dd.spec.is_uniform()
    g = np.random.RandomState(2).rand(13, 9, 11).astype(F32)
    dd.set_curr_global(h, g)
    jd.set_curr_global(jh, g)
    np.testing.assert_array_equal(dd.get_curr_global(h), g)
    dd.exchange()
    jd.exchange()
    np.testing.assert_array_equal(dd.get_curr_global(h), g)
    got = dd.get_curr(h)
    got = (tpar.join_positions(got, dd.spec) if isinstance(got, list) else got).numpy()
    for a, b in zip(own_box(got, dd.spec, 2), own_box(np.asarray(jd.get_curr(jh)), jd.spec, 2)):
        np.testing.assert_array_equal(a, b)
    assert dd.exchange_bytes_for_method(dd.halo_exchange.method) == \
        jd.exchange_bytes_for_method(jd.halo_exchange.method)
    small, _h = port_domain((16, 16, 16), 1, part=(3, 1, 1))
    assert small.spec.sizes_x == (6, 5, 5)


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "jax"), ("jax", "port")])
def test_uneven_checkpoint_restores_elastically(tmp_path, writer, reader):
    """tests/test_ckpt.py:84's fp64-uneven case across packages: a (13, 11,
    9) fp64 state saved on an uneven (2,2,2) partition (the port's over 8
    positions) restores onto a uniform one-block domain and onto (2,1,1)
    residents, bit for bit; a port snapshot of a (1,1,1) state restores
    onto the uneven partition."""
    size, d = (13, 11, 9), str(tmp_path / "ck")
    g = np.random.RandomState(9).rand(9, 11, 13)
    if writer == "port":
        wd, wh = port_domain(size, 1, devices=["cpu"] * 8, dtype="float64")
    else:
        wd, wh = jax_domain(size, 1, 8, dtype="float64")
    assert not wd.spec.is_uniform()
    wd.set_curr_global(wh, g)
    wd.save_checkpoint(d, 3, keep=2)
    wd.finish_checkpoints()
    snap = os.path.join(d, tckpt.snapshot_name(3))
    assert tckpt.validate_snapshot(snap) == jckpt.validate_snapshot(snap) == []
    for part in ((1, 1, 1), (2, 1, 1)):
        if reader == "port":
            rd, rh = port_domain(size, 1, part=part, dtype="float64")
        else:
            rd, rh = jax_domain(size, 1, 1, part=part, dtype="float64")
        assert rd.restore_checkpoint(d) == 3
        assert rd.get_curr_global(rh).tobytes() == g.tobytes()
    if writer == reader == "port":
        d2 = str(tmp_path / "ck2")
        one, oh = port_domain(size, 1, dtype="float64")
        one.set_curr_global(oh, g)
        one.save_checkpoint(d2, 5, asynchronous=False)
        back, bh = port_domain(size, 1, part=(2, 2, 2), dtype="float64")
        assert back.restore_checkpoint(d2) == 5
        assert back.get_curr_global(bh).tobytes() == g.tobytes()


@pytest.mark.parametrize("where", ["resident", "mesh"])
def test_health_on_uneven_state_matches_jax(where):
    """The health reduction over an uneven (13, 11, 9) (3,2,1) state agrees
    with the JAX guard's on the same stacked arrays: clean, with an inf in
    a dead pad cell past a smaller block's own size, and with a NaN in a
    compute cell (dead pad cells count, as in the JAX package)."""
    tspec, _j = specs((13, 11, 9), (3, 2, 1), 1)
    rng = np.random.RandomState(4)
    base = rng.rand(*tspec.stacked_shape_zyx()).astype(F32) - 0.5
    off = tspec.compute_offset()
    dead = base.copy()
    dead[0, 0, 2, off.z, off.y, off.x + tspec.sizes_x[2]] = np.inf  # block x=2 holds 4 of 5
    bad = base.copy()
    bad[0, 1, 1, off.z + 1, off.y + 2, off.x + 3] = np.nan
    tmesh, _jm = meshes((3, 2, 1))
    for arr in (base, dead, bad):
        jfin, jmax = jhealth.HealthGuard._build({"q": jnp.asarray(arr)})
        if where == "mesh":
            groups = [tpar.split_positions(torch.from_numpy(arr), tspec, tmesh)]
        else:
            groups = [[torch.from_numpy(arr)]]
        got = health_reduce(groups).numpy()
        assert bool(got[0, 0]) == bool(np.asarray(jfin)[0])
        if bool(got[0, 0]):
            assert got[1, 0] == np.asarray(jmax)[0]


# -- jacobi3d --------------------------------------------------------------------------

@pytest.mark.parametrize("n,variant", [(6, None), (6, "fused"), (3, None)])
def test_jacobi3d_no_weak_over_uneven_positions(n, variant):
    """jacobi3d at --no-weak over 6 and 3 CPU positions: 16^3 splits (3,2,1)
    and (3,1,1); the result equals jacobi_reference and the JAX app's run
    over as many virtual devices, bit for bit."""
    kw = dict(iters=4, weak=False, chunk=2, method=RDMA_T, kernel_variant=variant)
    got = tapp.run(16, 16, 16, devices=["cpu"] * n, **kw)
    dd = got["domain"]
    assert not dd.spec.is_uniform() and got["temporal_k"] == 0
    assert tuple(dd.spec.dim) == ((3, 2, 1) if n == 6 else (3, 1, 1))
    a = dd.get_curr_global(got["handle"])
    want = japp.run(16, 16, 16, devices=jax.devices()[:n],
                    **{**kw, "method": RDMA_J, "kernel_variant": variant})
    np.testing.assert_array_equal(a, want["domain"].get_curr_global(want["handle"]))
    ref = tjac.jacobi_reference(np.full((16, 16, 16), tjac.INIT_TEMP, F32),
                                tjac.sphere_masks((16, 16, 16)), 4 + 2)
    np.testing.assert_allclose(a, ref, rtol=1e-5, atol=1e-6)


def test_jacobi3d_cli_over_six_positions(capsys):
    assert tapp.main(["--x", "16", "--y", "16", "--z", "16", "--iters", "3", "--no-weak",
                      "--method", "remote-dma", "--devices", ",".join(["cpu"] * 6)]) == 0
    row = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert row[:7] == ["jacobi3d", "remote-dma", "1", "6", "16", "16", "16"]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("size,dim,r", [((17, 19, 16), (2, 2, 2), 2),
                                        ((13, 11, 9), (3, 2, 1), (2, 1, 1, 2, 1, 1))],
                         ids=["222-r2", "321-asym"])
def test_uneven_plans_match_jax(size, dim, r, fused):
    """build_plan on an uneven spec over its mesh, REMOTE_DMA plain and
    fused, field by field against the JAX IR (the size tables, the fused
    messages without static starts), and the plan the exchange builds."""
    import dataclasses

    import stencil_tpu.plan.ir as jir
    import stencil_tpu_torch.plan.ir as tir

    tspec, jspec = specs(size, dim, r)

    def plain(v):
        if isinstance(v, tuple):
            return tuple(plain(e) for e in v)
        return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v

    got = tir.build_plan(tspec, dim, tir.REMOTE_DMA, fused=fused)
    want = jir.build_plan(jspec, dim, jir.REMOTE_DMA, fused=fused)
    for f in ("method", "partition", "mesh_dim", "resident", "axis_phases", "remote_phases",
              "fused_phases", "fused"):
        assert plain(getattr(got, f)) == plain(getattr(want, f)), f
    assert all(p.src is None and p.dst is None for p in got.fused_phases)
    assert got.dmas_per_exchange(3, 2) == want.dmas_per_exchange(3, 2)
    assert plain(tpar.HaloExchange(tspec, RDMA_T, mesh=meshes(dim)[0], fused=fused).plan
                 .remote_phases) == plain(want.remote_phases)
