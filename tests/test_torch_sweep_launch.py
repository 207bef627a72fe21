"""The sweep kernel's (B1) launch: its constants, task table, tile and z-chunk
rules, mirrored in Python (ops/stencil_kernels.py) and held to the kernel
source (csrc/sweep_runs.cuh, csrc/jacobi_sweep.cu); the tiles of every task
cover each output cell of its rect once; and the table, replayed in Python
as the kernel walks it (tiles, index wrap, sel planes), gives the plain
versions' cells bit for bit in every form (one block, a resident stack and
its shells, mesh positions uniform and uneven, tenants), in float32 and
in float64 (16-byte runs of 2 cells, the fp64 instantiation's layout). CPU
only: the kernel itself is held to its plain version by chip_smoke.py.
Inputs are random numpy fields from a seed; tolerance: bit-exact."""

import pathlib
import re

import numpy as np
import pytest
import torch

from stencil_tpu_torch.domain import GridSpec
from stencil_tpu_torch.geometry import Dim3, Radius
from stencil_tpu_torch.ops import jacobi as tjac
from stencil_tpu_torch.ops import stencil_kernels as sk
from stencil_tpu_torch.ops.shells import dyn_block_sizes, shell_regions
from stencil_tpu_torch.parallel import DeviceMesh

torch.set_num_threads(2)

CSRC = pathlib.Path(sk.__file__).resolve().parent.parent / "csrc"
RUNS_SRC = (CSRC / "sweep_runs.cuh").read_text()
SWEEP_SRC = (CSRC / "jacobi_sweep.cu").read_text()
NO_WRAP = (False, False, False)
# an H100's resident sweep blocks (132 SMs x 2), for the z-chunk rule
BLOCKS = 264
# the fields' types the kernel is instantiated for, and their cell bytes
DTYPES = {np.float32: 4, np.float64: 8}


def _const(src, name):
    expr = re.search(rf"constexpr (?:int|long long) {name} = ([^;]+);", src).group(1)
    env = {}
    for dep in ("TX", "TY", "LOOK", "RING", "ROWS", "RUNS", "PITCH", "PLANE", "SMEM",
                "PATCH_ROWS"):
        if dep != name and re.search(rf"\b{dep}\b", expr):
            env[dep] = _const(src, dep)
    return eval(re.sub(r"//.*", "", expr).replace("/", "//").replace("LL", ""), {}, env)


def test_constants_mirror_the_kernel_source():
    assert sk.SWEEP_TILE == (_const(RUNS_SRC, "TX"), _const(RUNS_SRC, "TY"))
    assert sk.SWEEP_LOOK == _const(RUNS_SRC, "LOOK")
    assert sk.SWEEP_MIN_BLOCKS == _const(SWEEP_SRC, "MIN_BLOCKS")
    assert "__launch_bounds__(runs::NT, MIN_BLOCKS)" in SWEEP_SRC
    assert sk.SWEEP_PLANE == _const(RUNS_SRC, "PLANE")
    assert sk.SWEEP_THREADS == _const(RUNS_SRC, "NT")
    assert sk.SWEEP_SMEM == _const(RUNS_SRC, "B1_SMEM")
    assert sk.SWEEP_TASK_COLS == _const(SWEEP_SRC, "TASK_COLS")
    fields = re.search(r"struct SweepTask \{\s*long long ([^;]+);", SWEEP_SRC).group(1)
    assert tuple(f.strip() for f in fields.split(",")) == sk.SWEEP_TASK_FIELDS
    # B1's instantiation of the body, one launch over the table, no fallback
    assert "runs::flex_tile(" in SWEEP_SRC and "march<true>" in RUNS_SRC
    assert "march<false>(g, b, c);" in RUNS_SRC  # B8's, unchanged
    assert SWEEP_SRC.count("<<<") == 1


@pytest.mark.parametrize("item", [4, 8])
def test_launch_shape(item):
    """Every tile the rule may pick fits a ring plane and has a thread per
    run; MIN_BLOCKS blocks fit an SM's shared memory and threads, and the
    registers they leave a thread hold the body without spilling (72 on
    an H100 in fp32). The fp64 instantiation keeps the bytes: a ring plane
    of half as many cells, 16-byte runs of 2 cells, the same threads and
    shared memory (``Elem<T>`` in the source)."""
    tx, ty = sk.SWEEP_TILE
    runs = (tx + 11) // 4
    assert sk.SWEEP_PLANE == (ty + 2) * 4 * runs
    assert sk.SWEEP_THREADS == -(-((ty + 2) * runs) // 32) * 32
    assert sk.SWEEP_PLANE // 4 <= sk.SWEEP_THREADS
    assert sk.SWEEP_MIN_BLOCKS * (sk.SWEEP_SMEM + 1024) <= 233_472
    assert sk.SWEEP_MIN_BLOCKS * sk.SWEEP_THREADS <= 2048
    assert 65_536 // (sk.SWEEP_MIN_BLOCKS * sk.SWEEP_THREADS) // 8 * 8 >= 72
    c = sk.run_cells(item)
    assert c * item == 16 and sk.sweep_plane(item) * item == sk.SWEEP_PLANE * 4
    assert "PLANE_T = PLANE * 4 / (int)sizeof(T)" in RUNS_SRC
    assert "C = 16 / (int)sizeof(T)" in RUNS_SRC
    # the widest grown tile's runs have a thread each, in either type
    tx = c
    while sk.sweep_plane(item) // (c * sk.sweep_runs(tx, item)) - 2 >= 1:
        rows = sk.sweep_plane(item) // (c * sk.sweep_runs(tx, item))
        assert rows * sk.sweep_runs(tx, item) <= sk.SWEEP_THREADS
        tx += c
    # the kernel's pitch for a task's tile is the wrapper's runs of C cells
    assert "f.pitch = E::C * (((int)k.tx + 3 * E::C - 1) >> E::SHIFT);" in SWEEP_SRC
    assert sk.sweep_runs(128, 4) == (128 + 11) // 4 and sk.sweep_runs(64, 8) == 34


def _tiles_of(nx, ny, xo, item=4):
    """Every candidate (count, tx, ty) of the tile rule: widths of whole
    16-byte runs (C cells) whose grown tile's runs of C cells fill at most
    a ring plane of the fp32 plane's bytes."""
    c = 16 // item
    plane = sk.SWEEP_PLANE * 4 // item
    out, tx = [], c
    while True:
        runs = (tx + 3 * c - 1) // c
        ty = plane // (c * runs) - 2
        if ty < 1:
            return out
        out.append((sk.sweep_tiles_x(nx, xo, tx, item) * -(-ny // ty), tx, ty))
        tx += c


@pytest.mark.parametrize("nx,ny,xo,item,want", [
    (512, 512, 0, 4, (128, 8)), (512, 512, 1, 4, (128, 8)), (256, 256, 1, 4, (128, 8)),
    (171, 256, 1, 4, (56, 19)), (170, 256, 1, 4, (56, 19)), (32, 32, 1, 4, (32, 32)),
    (128, 128, 1, 4, (128, 8)), (1, 256, 1, 4, (4, 111)), (256, 1, 1, 4, (256, 3)),
    (4, 256, 4, 4, (4, 111)), (67, 45, 1, 4, (72, 15)),
    (512, 512, 0, 8, (64, 8)), (512, 512, 1, 8, (64, 8)), (256, 256, 1, 8, (64, 8)),
    (171, 256, 1, 8, (44, 12)), (32, 32, 1, 8, (32, 16)), (128, 128, 1, 8, (64, 8)),
    (1, 256, 1, 8, (2, 111)), (256, 1, 1, 8, (128, 3)), (67, 45, 1, 8, (36, 15))])
def test_tile_rule(nx, ny, xo, item, want):
    """The fewest tiles a plane; on a tie the widest up to 128 fp32 cells
    (64 fp64 cells: the same bytes), else the narrowest; the grown tile fits
    a ring plane."""
    c = 16 // item
    tx, ty = sk.sweep_tile(nx, ny, xo, item)
    assert (tx, ty) == want
    runs = (tx + 3 * c - 1) // c
    assert tx % c == 0 and ty >= 1 and (ty + 2) * c * runs <= sk.SWEEP_PLANE * 4 // item
    cands = _tiles_of(nx, ny, xo, item)
    least = min(n for n, _, _ in cands)
    assert sk.sweep_tiles_x(nx, xo, tx, item) * -(-ny // ty) == least
    ties = [t for n, t, _ in cands if n == least]
    small = [t for t in ties if t <= 512 // item]
    assert tx == (max(small) if small else min(ties))


@pytest.mark.parametrize("work,want", [
    ([(256, 512)], 256), ([(512, 256)], 256), ([(252, 512)], 256), ([(1024, 128)], 128),
    ([(64, 32)], 8), ([(6, 4)], 4), ([(64, 1), (128, 256), (3, 256)], 20), ([(70000, 4)], 4),
    ([(128, 1024)], 256)])
def test_chunk_rule(work, want):
    """The chunk whose walk ends soonest (rounds of resident blocks times a
    chunk's plane steps, recomputed here by walking the tiles), at most
    SWEEP_CHUNK_MAX planes and at least 4 of the deepest task; at 264
    resident blocks (an H100 at two a SM): 512^3 one block and the 8 mesh
    positions 256 planes, the 64 tenants of 128^3 128, of 32^3 8."""
    blocks = 264
    c = sk.sweep_chunk(work, blocks)
    assert c == want
    top = max(nz for _, nz in work)
    assert min(4, top) <= c <= sk.SWEEP_CHUNK_MAX

    def walk(c):
        # each block takes tiles in turn; a tile of a chunk of h planes takes h + 2 steps
        tiles = [min(c, nz) + 2 for cols, nz in work for _ in range(cols)
                 for z0 in range(0, nz, min(c, nz))]
        return -(-len(tiles) // blocks) * (max(min(c, nz) for _, nz in work) + 2)

    cands = sorted({-(-top // n) for n in range(-(-top // sk.SWEEP_CHUNK_MAX),
                                                max(1, top // 4) + 1)})
    assert walk(c) == min(walk(x) for x in cands)


def _row(rows, i):
    return dict(zip(sk.SWEEP_TASK_FIELDS, rows[i]))


def _tile_cells(t, i, j, k, item=4):
    """The (x, y, z) ranges, rect-relative, of tile (i, j, k) of task row t,
    as sweep_runs.cuh's flex_tile lays them out for ``item``-byte cells."""
    a = -t["xo"] % (16 // item)
    x0 = 0 if i == 0 else i * t["tx"] + a
    x1 = min(t["nx"], (i + 1) * t["tx"] + a)
    y0 = j * t["ty"]
    y1 = min(t["ny"], y0 + t["ty"])
    z0 = k * t["zchunk"]
    z1 = min(t["nz"], z0 + t["zchunk"])
    return (x0, x1), (y0, y1), (z0, z1)


def _task(lo, n, wrap=(True, True, True), count=1):
    return sk.SweepTask(0, 0, 0, 0, count, lo, n, wrap, 0, 1 << 20)


@pytest.mark.parametrize("item", [4, 8])
@pytest.mark.parametrize("label,lo,n", [
    ("512 tight-x wrap", (1, 8, 0), (512, 512, 512)),
    ("512 r1", (1, 8, 1), (512, 512, 512)),
    ("171 wide", (1, 8, 1), (512, 256, 171)),
    ("170 wide", (1, 8, 1), (512, 256, 170)),
    ("1-cell x shell", (1, 8, 171), (512, 256, 1)),
    ("1-cell y shell", (1, 263, 1), (512, 1, 171)),
    ("1-cell z shell", (512, 8, 1), (1, 256, 171)),
    ("tenant pitch 34", (1, 1, 1), (32, 32, 32)),
    ("tenant pitch 130", (1, 1, 1), (128, 128, 128))])
def test_tiles_cover_each_output_cell_once(label, lo, n, item):
    """Per axis the tiles partition the rect (so the product covers each
    cell once); every tile after the first of a row starts on the padded
    row's 16-byte grid; the grown tile fits its row of runs and the last
    run holds no output; the walk's tile count is the table's. In either
    cell type (C cells a 16-byte run)."""
    c = 16 // item
    rows, tiles = sk.sweep_table([_task(lo, n)], BLOCKS, item)
    t = _row(rows, 0)
    assert t["start"] == 0 and tiles == t["gx"] * t["gy"] * t["nzc"] * t["count"]
    runs = (t["tx"] + 3 * c - 1) // c
    xs, ys, zs = [], [], []
    for i in range(t["gx"]):
        (x0, x1), _, _ = _tile_cells(t, i, 0, 0, item)
        assert x1 > x0
        if i:
            assert (t["xo"] + x0) % c == 0
        e = (t["xo"] + x0 - 1) % c
        assert e + (x1 - x0) + 2 <= c * runs and e + (x1 - x0) < c * (runs - 1)
        xs += range(x0, x1)
    for j in range(t["gy"]):
        _, (y0, y1), _ = _tile_cells(t, 0, j, 0, item)
        ys += range(y0, y1)
    for k in range(t["nzc"]):
        _, _, (z0, z1) = _tile_cells(t, 0, 0, k, item)
        zs += range(z0, z1)
    assert xs == list(range(n[2])) and ys == list(range(n[1])) and zs == list(range(n[0]))


class FakeSweepCard:
    """Stands in for the card in the sweep wrappers' CUDA branch: the table
    the wrapper uploads is kept, and a Python copy of csrc/jacobi_sweep.cu's
    walk (a task found by binary search over the rows' first tiles, its
    block, its tile) and of sweep_runs.cuh's flex_tile (index wrap, halos
    read in place, sel on the task's planes) applies it to the CPU blocks
    its pointers name, counting each output cell's writes."""

    type, index = "cuda", 0

    def __init__(self, monkeypatch, tensors):
        self.tensors = list(tensors)
        self.tables, self.launches, self.writes = {}, [], {}
        monkeypatch.setattr(sk, "_device_of", lambda *a: self)
        monkeypatch.setattr(sk, "sweep_blocks_in_flight", lambda index, item=4: BLOCKS)
        monkeypatch.setattr(sk._native, "device_table", self.device_table)
        monkeypatch.setattr(sk._native, "stream_ptr", lambda dev: 0)
        monkeypatch.setattr(sk._native, "lib", lambda name: self)

    def device_table(self, key, rows, device):
        if key not in self.tables:
            t = torch.tensor(rows(), dtype=torch.int64)
            self.tables[key] = t
            self.tables[t.data_ptr()] = t.tolist()
        return self.tables[key]

    def block(self, ptr, pz, py, px, item=4):
        for t in self.tensors:
            base = t.data_ptr()
            if t.element_size() == item and base <= ptr < base + t.numel() * item:
                off = (ptr - base) // item
                return t.view(-1)[off:off + pz * py * px].view(pz, py, px)
        raise AssertionError(f"pointer {ptr} in no tensor")

    def jacobi_sweep_launch(self, table, ntask, cols, tiles, sz, sy, py, align, item, grid, dev,
                            stream):
        assert cols == sk.SWEEP_TASK_COLS and 1 <= grid <= min(tiles, BLOCKS)
        assert item in (4, 8) and align in (1, 2, 4) and align <= 16 // item
        self.item = item
        flat = self.tables[table]
        rows = [flat[i * cols:(i + 1) * cols] for i in range(ntask)]
        assert len(flat) == ntask * cols
        starts = [r[5] for r in rows]
        for w in range(tiles):
            lo, hi = 0, ntask - 1
            while lo < hi:
                mid = (lo + hi + 1) >> 1
                lo, hi = (mid, hi) if starts[mid] <= w else (lo, mid - 1)
            t = dict(zip(sk.SWEEP_TASK_FIELDS, rows[lo]))
            per = t["gx"] * t["gy"] * t["nzc"]
            r, u = divmod(w - t["start"], per)
            assert r < t["count"]
            self.tile(t, r * t["stride"], sz, sy, py, u % t["gx"], u // t["gx"] % t["gy"],
                      u // (t["gx"] * t["gy"]))
        self.launches.append((ntask, tiles, align))
        return 0

    def tile(self, t, off, sz, sy, py, i, j, k):
        pz, item = self.pz, self.item
        curr = self.block(t["curr"] + off * item, pz, py, sy, item)
        out = self.block(t["out"] + off * item, pz, py, sy, item)
        sel = self.block(t["sel"] + off * 4, pz, py, sy, 4)
        assert curr.element_size() == item and sel.dtype == torch.int32
        (x0, x1), (y0, y1), (z0, z1) = _tile_cells(t, i, j, k, item)
        if x1 <= x0 or y1 <= y0 or z1 <= z0:
            return
        wx, wy, wz = t["wrap"] & 1, t["wrap"] & 2, t["wrap"] & 4

        def idx(a0, a1, d, n, o, w):
            v = torch.arange(a0, a1) + d
            return o + (torch.remainder(v, n) if w else v)

        def at(dz, dy, dx):
            zi = idx(z0, z1, dz, t["nz"], t["zo"], wz)
            yi = idx(y0, y1, dy, t["ny"], t["yo"], wy)
            xi = idx(x0, x1, dx, t["nx"], t["xo"], wx)
            return curr.index_select(0, zi).index_select(1, yi).index_select(2, xi)

        s = at(0, 0, -1) + at(0, 0, 1)
        for d in ((0, -1, 0), (0, 1, 0), (-1, 0, 0), (1, 0, 0)):
            s = s + at(*d)
        avg = s * sk.sixth(curr.dtype)
        zs = slice(t["zo"] + z0, t["zo"] + z1)
        ys = slice(t["yo"] + y0, t["yo"] + y1)
        xs = slice(t["xo"] + x0, t["xo"] + x1)
        code = sel[zs, ys, xs].clone()
        planes = torch.arange(z0, z1)
        code[(planes < t["slo"]) | (planes >= t["shi"])] = 0
        out[zs, ys, xs] = torch.where(code == 1, sk.HOT_TEMP,
                                      torch.where(code == 2, sk.COLD_TEMP, avg))
        key = out.data_ptr()
        cnt = self.writes.setdefault(key, torch.zeros(out.shape, dtype=torch.int32))
        cnt[zs, ys, xs] += 1


def _card(monkeypatch, tensors, pz):
    card = FakeSweepCard(monkeypatch, tensors)
    card.pz = pz
    return card


def _rand(rng, shape, dtype=np.float32):
    return torch.from_numpy(rng.rand(*shape).astype(dtype))


def _rsel(rng, shape):
    return torch.from_numpy(rng.randint(-1, 4, shape).astype(np.int32))


ONE = Dim3(1, 1, 1)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("size,radius,wrap", [
    ((36, 20, 12), Radius.constant(1).without_x(), (True, True, True)),
    ((33, 21, 13), Radius.constant(2), (False, True, False)),
    ((67, 45, 29), Radius.constant(1), (True, True, True)),
    ((20, 9, 7), Radius.constant(1), (True, False, True))])
@pytest.mark.parametrize("ranged", [False, True])
def test_replay_one_block(monkeypatch, size, radius, wrap, ranged, dtype):
    """One block, random fields and halos, random sel codes in [-1, 4):
    the replayed table equals sweep_plain (with the same sel planes), and
    writes each compute cell once."""
    spec = GridSpec(Dim3(*size), ONE, radius)
    p = spec.padded()
    rng = np.random.RandomState(sum(size))
    c, s = _rand(rng, (1, 1, 1, p.z, p.y, p.x), dtype), _rsel(rng, (1, 1, 1, p.z, p.y, p.x))
    rg = (spec.compute_offset().z + 2, spec.compute_offset().z + 5) if ranged else None
    want = sk.sweep_plain(c, torch.zeros_like(c), s, spec, wrap, rg)
    got = torch.zeros_like(c)
    card = _card(monkeypatch, [c, got, s], p.z)
    sk.sweep(c, got, s, spec, wrap, rg)
    assert torch.equal(got, want)
    off, b = spec.compute_offset(), spec.base
    cnt = card.writes[got.data_ptr()]
    assert cnt[off.z:off.z + b.z, off.y:off.y + b.y, off.x:off.x + b.x].eq(1).all()
    assert int(cnt.sum()) == b.z * b.y * b.x
    assert len(card.launches) == 1


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,B", [(32, 2), (12, 3), (4, 5)])
def test_replay_tenants(monkeypatch, n, B, dtype):
    """A campaign slot of unaligned tenants (pitch n + 2): one task of B
    blocks, every axis wrapping onto the tenant; with random sel read on
    every plane, and with the spheres read on their planes."""
    spec = GridSpec(Dim3(n, n, n), ONE, Radius.constant(1), aligned=False)
    p = spec.padded()
    assert p.x == n + 2
    rng = np.random.RandomState(n)
    c, s = _rand(rng, (B, p.z, p.y, p.x), dtype), _rsel(rng, (B, p.z, p.y, p.x))
    sph = tjac.sphere_sel_blocks(spec, "cpu").view(1, p.z, p.y, p.x).expand(B, -1, -1, -1)
    sph = sph.contiguous()
    for sel, rg in ((s, None), (sph, sk.sel_z_range(spec))):
        want = sk.sweep_plain(c, torch.zeros_like(c), sel, spec)
        got = torch.zeros_like(c)
        card = _card(monkeypatch, [c, got, sel], p.z)
        sk.sweep_tenants(c, got, sel, spec, rg)
        assert torch.equal(got, want)
        assert card.launches[0][0] == 1  # one task row for every tenant


def _stack_case(global_size, part, r, seed, dtype=np.float32):
    spec = GridSpec(Dim3(*global_size), Dim3(*part), Radius.constant(r))
    rng = np.random.RandomState(seed)
    shape = spec.stacked_shape_zyx()
    return spec, _rand(rng, shape, dtype), tjac.sphere_sel_blocks(spec, "cpu"), _rsel(rng, shape)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("global_size,part", [((32, 24, 20), (2, 2, 2)),
                                              ((24, 20, 32), (1, 1, 2))])
def test_replay_stack_and_shells(monkeypatch, global_size, part, dtype):
    """A resident stack at radius 4: the stacked sweep (wrap on the
    single-block axes) and every overlap shell of every block in one
    launch, each block's sel on its own sphere planes, equal the plain
    sweep and region sweeps (ops.jacobi.jacobi_sweep) bit for bit; with
    random sel on every plane too."""
    spec, c, sph, rs = _stack_case(global_size, part, 4, seed=sum(global_size), dtype=dtype)
    wrap, _axes, shells = tjac.multi_block_layout(spec)
    off = spec.compute_offset()
    for sel, ranges in ((sph, sk.block_sel_ranges(spec)), (rs, None)):
        want = sk.sweep_plain(c, torch.zeros_like(c), sel, spec, wrap)
        for rect in shells:
            tjac.jacobi_sweep(c, want, rect, (sel == 1, sel == 2))
        got = torch.zeros_like(c)
        card = _card(monkeypatch, [c, got, sel], spec.padded().z)
        sk.sweep(c, got, sel, spec, wrap, ranges)
        sk.sweep_regions([c], [got], [sel], spec, [shells], [ranges])
        assert torch.equal(got, want)
        assert len(card.launches) == 2
        # the sphere case: one task a block (its own planes) and a shell
        assert card.launches[1][0] == (spec.num_blocks() if ranges else 1) * len(shells)
    assert off.z == 4


def _mesh_case(global_size, part, seed, dtype=np.float32):
    spec = GridSpec(Dim3(*global_size), Dim3(*part), Radius.constant(1))
    mesh = DeviceMesh(part, ["cpu"] * (part[0] * part[1] * part[2]))
    bspec = spec.block_spec()
    p = bspec.padded()
    rng = np.random.RandomState(seed)
    currs = [_rand(rng, (1, 1, 1, p.z, p.y, p.x), dtype) for _ in range(len(mesh))]
    sels = tjac.sphere_sel_blocks(spec, mesh)
    ranges = [sk.block_sel_range(spec, Dim3.of(pos).z) for pos in mesh.positions()]
    shells = [shell_regions(spec, dyn_block_sizes(spec, pos), (True, True, True))
              for pos in mesh.positions()]
    return spec, bspec, mesh, currs, sels, ranges, shells


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("global_size,part", [((32, 32, 32), (2, 2, 2)),
                                              ((20, 16, 12), (3, 2, 1)),
                                              ((22, 18, 10), (3, 2, 1))])
def test_replay_positions_and_shells(monkeypatch, global_size, part, dtype):
    """Every position of a mesh, uniform (8 positions) and uneven (6,
    (3,2,1)): one sweep_positions launch equals sweep_plain per position,
    and one sweep_regions launch of every position's six shells (at its
    own size on the hi side) equals the region sweeps, bit for bit."""
    spec, bspec, mesh, currs, sels, ranges, shells = _mesh_case(global_size, part,
                                                                sum(global_size), dtype)
    pz = bspec.padded().z
    nxts = [torch.zeros_like(c) for c in currs]
    card = _card(monkeypatch, [*currs, *nxts, *sels], pz)
    sk.sweep_positions(currs, nxts, sels, bspec, ranges)
    for c, n, s in zip(currs, nxts, sels):
        assert torch.equal(n, sk.sweep_plain(c, torch.zeros_like(c), s, bspec, NO_WRAP))
    outs = [torch.zeros_like(c) for c in currs]
    card.tensors += outs
    sk.sweep_regions(currs, outs, sels, bspec, shells, ranges)
    for c, o, s, rects in zip(currs, outs, sels, shells):
        want = torch.zeros_like(c)
        for rect in rects:
            tjac.jacobi_sweep(c, want, rect, (s == 1, s == 2))
        assert torch.equal(o, want)
    assert len(card.launches) == 2
    assert card.launches[0][0] == len(mesh)
    assert card.launches[1][0] == sum(len(r) for r in shells)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("part,fused", [((2, 2, 2), False), ((3, 2, 1), False),
                                        ((3, 2, 1), True)])
def test_the_loops_launch_once_a_step(monkeypatch, part, fused, dtype):
    """The plain mesh step is one sweep_positions launch a step, uniform or
    uneven; the uneven fused step one sweep_positions and one sweep_regions
    launch a step; the replayed loop gives the CPU loop's cells."""
    from stencil_tpu_torch.parallel import HaloExchange, Method

    spec, bspec, mesh, currs, sels, _r, _s = _mesh_case((16, 16, 16), part, 5, dtype)
    ex = HaloExchange(spec, Method.REMOTE_DMA, mesh=mesh, fused=fused)
    nxts = [torch.zeros_like(c) for c in currs]
    want, _ = tjac.make_jacobi_loop(ex, 3)([c.clone() for c in currs],
                                           [n.clone() for n in nxts], sels)
    card = _card(monkeypatch, [*currs, *nxts, *sels], bspec.padded().z)
    before = (sk.sweep_positions.launches, sk.sweep_regions.launches)
    got, _ = tjac.make_jacobi_loop(ex, 3)(currs, nxts, sels)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert sk.sweep_positions.launches - before[0] == 3
    assert sk.sweep_regions.launches - before[1] == (3 if fused else 0)
    assert len(card.launches) == (6 if fused else 3)


@pytest.mark.parametrize("global_size,part,r", [
    ((16, 16, 16), (1, 1, 1), 1), ((512, 512, 512), (1, 1, 1), 1), ((64, 64, 64), (2, 2, 2), 4),
    ((20, 16, 12), (3, 2, 1), 1), ((40, 40, 33), (1, 1, 3), 1), ((128, 128, 128), (1, 1, 4), 2)])
def test_sel_ranges_cover_the_spheres(global_size, part, r):
    """Each block's range lies within the union (sel_z_range) and holds
    every plane where the spheres' sel is nonzero."""
    spec = GridSpec(Dim3(*global_size), Dim3(*part), Radius.constant(r))
    lo, hi = sk.sel_z_range(spec)
    if global_size[0] > 64:
        return _cover_by_formula(spec, lo, hi)
    sel = tjac.sphere_sel_blocks(spec, "cpu")
    p = spec.padded()
    blocks = sel.view(-1, p.z, p.y, p.x)
    for b, (blo, bhi) in zip(blocks, sk.block_sel_ranges(spec)):
        planes = torch.nonzero(b.flatten(1).ne(0).any(1)).flatten().tolist()
        if planes:
            assert blo <= min(planes) and max(planes) < bhi
            assert lo <= blo and bhi <= hi
        else:
            assert blo >= bhi or (lo <= blo and bhi <= hi)


def _cover_by_formula(spec, lo, hi):
    g = spec.global_size
    zc, rad = g.z // 2, g.x // 10
    for iz in range(spec.dim.z):
        blo, bhi = sk.block_sel_range(spec, iz)
        o = sum(spec.sizes_z[:iz])
        want = [z - o + spec.compute_offset().z for z in range(zc - rad, zc + rad + 1)
                if 0 <= z - o < spec.sizes_z[iz]]
        if want:
            assert (blo, bhi) == (min(want), max(want) + 1) and lo <= blo and bhi <= hi


def _run_layout(t, sy, yoff, align, i, rn, item=4):
    """A Python copy of flex_tile's per-run choice (csrc/sweep_runs.cuh) for
    run rn of a row at plane offset yoff in x tile i of task row t: the
    padded x each of its C ring cells is copied from, and how (16, 8 or 4
    bytes a copy, and a patched cell; an fp64 run copies 16 bytes or a
    cell at a time, and patches nothing)."""
    c = 16 // item
    a = -t["xo"] % c
    x0 = 0 if i == 0 else i * t["tx"] + a
    w = min(t["nx"], (i + 1) * t["tx"] + a) - x0
    e = (t["xo"] + x0 - 1) % c
    if not (c * rn + c - 1 >= e and c * rn <= e + w + 1):
        return None  # no cell of the grown tile: copies nothing
    lx0 = x0 - 1 - e + c * rn
    wx = t["wrap"] & 1
    xq = [t["xo"] + ((lx0 + q) % t["nx"]) if wx else min(max(t["xo"] + lx0 + q, 0), sy - 1)
          for q in range(c)]
    run4 = xq == [xq[0] + q for q in range(c)]
    ph = (yoff + xq[0]) % c
    vcp = run4 and align == c and ph == 0
    v8 = c == 4 and run4 and not vcp and align >= 2 and ph % 2 == 0
    patch = None
    if c == 4 and wx and t["gx"] > 1 and not vcp and not v8:
        u0 = t["xo"] + lx0
        cells = [(q, t["xo"] + t["nx"] - 1 if lx0 + q == -1 else t["xo"])
                 for q in range(4) if lx0 + q in (-1, t["nx"])]
        uph = (yoff + u0) % 4
        if len(cells) == 1 and u0 >= 0 and u0 + 3 < sy and align >= 2 and uph % 2 == 0:
            patch = cells[0]
            xq = [u0 + q for q in range(4)]
            vcp, v8 = align == 4 and uph == 0, not (align == 4 and uph == 0)
    src = list(xq)
    if patch:
        src[patch[0]] = patch[1]
    return lx0, src, ("16" if vcp else "8" if v8 else str(item)), patch, xq


@pytest.mark.parametrize("nx,xo,sy,align,item", [
    (512, 1, 640, 4, 4), (512, 0, 512, 4, 4), (512, 2, 640, 4, 4), (512, 3, 640, 4, 4),
    (512, 4, 640, 4, 4), (128, 1, 130, 4, 4), (32, 1, 34, 4, 4), (128, 1, 130, 2, 4),
    (67, 1, 128, 4, 4), (171, 1, 514, 4, 4), (170, 1, 514, 2, 4), (33, 2, 37, 1, 4),
    (2, 1, 4, 4, 4), (4, 1, 6, 4, 4), (5, 3, 11, 1, 4),
    (512, 1, 640, 2, 8), (512, 0, 512, 2, 8), (512, 2, 640, 2, 8), (128, 1, 130, 2, 8),
    (32, 1, 34, 2, 8), (67, 1, 128, 2, 8), (171, 1, 514, 2, 8), (33, 2, 37, 1, 8),
    (2, 1, 4, 2, 8), (5, 3, 11, 1, 8)])
def test_runs_copy_the_cells_the_sweep_reads(nx, xo, sy, align, item):
    """Every run of every x tile of an x-wrapping rect, on rows of both
    parities of the padded pitch: the cells it leaves in the ring, for x
    in [-1, nx] (what any output reads), are the periodic images; a vector
    copy lies on its grid and inside the padded row; a patched run has one
    wrapped cell and copies the rest from its own padded cells; a run
    falls back to copies of a cell only where the layout or a tiny row
    leaves no vector. In fp32 and fp64 (runs of 2 cells, no patch)."""
    c = 16 // item
    tx, ty = sk.sweep_tile(nx, 8, xo, item)
    rows, _ = sk.sweep_table([sk.SweepTask(0, 0, 0, 0, 1, (1, 1, xo), (8, 8, nx), (True,) * 3,
                                           0, 0)], BLOCKS, item)
    t = _row(rows, 0)
    kinds = set()
    for yoff in (sy, 2 * sy):
        for i in range(t["gx"]):
            sides = []  # a row's patched cells: at most one at each end (its patch cells)
            for rn in range(sk.sweep_runs(tx, item)):
                run = _run_layout(t, sy, yoff, align, i, rn, item)
                if run is None:
                    continue
                lx0, src, kind, patch, xq = run
                kinds.add(kind)
                for q in range(c):
                    x = lx0 + q
                    if -1 <= x <= nx:
                        assert src[q] == xo + x % nx, (i, rn, q)
                if kind != str(item):
                    w = int(kind) // item
                    assert (yoff + xq[0]) % w == 0 and 0 <= xq[0] and xq[c - 1] < sy
                if patch:
                    assert sum(1 for q in range(c) if lx0 + q in (-1, nx)) == 1
                    sides.append(lx0 + patch[0] == nx)
            assert sorted(sides) == sorted(set(sides))
    if item == 4 and align == 4 and sy % 4 == 0 and nx > 2 and t["gx"] > 1:
        assert kinds <= {"16"}
    if nx <= 2:
        assert str(item) in kinds
