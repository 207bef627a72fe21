"""The fused step kernel's launch shape, tiling, z-chunk rule and phase-A
work list, mirrored in Python (ops/fused_stencil.py) and held to the kernel
source (csrc/sweep_runs.cuh, csrc/fused_jacobi.cu): the work list covers
every halo cell of every message box once, moves 16 bytes only where source
and destination agree in phase, and, replayed with plain torch indexing,
moves the plain versions' cells bit for bit; the one-block wrapper is the
one-position case of the kernel's tables. CPU only: the kernel itself is
held to its plain version by chip_smoke.py phases 6 and 10. Inputs are
random numpy fields from a seed; tolerance: bit-exact."""

import math
import pathlib
import re

import numpy as np
import pytest
import torch

from stencil_tpu_torch.domain import GridSpec
from stencil_tpu_torch.geometry import Dim3, Radius
from stencil_tpu_torch.ops import fused_stencil as fst
from stencil_tpu_torch.ops.halo_fill import WIRE_FORMATS, wire_round
from stencil_tpu_torch.parallel import DeviceMesh, Method
from stencil_tpu_torch.plan.ir import build_plan

torch.set_num_threads(2)

CSRC = pathlib.Path(fst.__file__).resolve().parent.parent / "csrc"
SWEEP_SRC = (CSRC / "sweep_runs.cuh").read_text()
STEP_SRC = (CSRC / "fused_jacobi.cu").read_text()
# H100: an SM's shared memory, of which each resident block takes 1 KB for
# itself; its registers and threads
SMEM_PER_SM = 233_472
REGS_PER_SM = 65_536
THREADS_PER_SM = 2048


def _const(src, name):
    expr = re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
    # C integer division on positive operands
    return eval(re.sub(r"//.*", "", expr).replace("/", "//"), {}, {"TX": fst.FUSED_TILE[0]})


def test_constants_mirror_the_kernel_source():
    assert fst.FUSED_TILE == (_const(SWEEP_SRC, "TX"), _const(SWEEP_SRC, "TY"))
    assert fst.FUSED_LOOK == _const(SWEEP_SRC, "LOOK")
    assert fst.FUSED_MIN_BLOCKS == _const(SWEEP_SRC, "MIN_BLOCKS")
    assert fst.fused_shape()["runs"] == _const(SWEEP_SRC, "RUNS")
    assert fst.ROW_UNROLL == _const(STEP_SRC, "UNROLL")
    assert fst.SEG_COLS == _const(STEP_SRC, "SEG_COLS")
    assert fst.MAX_SEGS == _const(STEP_SRC, "MAX_SEGS")
    # the table row's fields, in the order message_rows / row_table write them
    fields = re.search(r"struct RowSeg \{\s*long long ([^;]+);", STEP_SRC).group(1)
    assert [f.strip() for f in fields.split(",")] == [
        "box", "src", "dst", "units", "width", "ey", "rows", "chunks", "start", "narrow"]
    assert len(fields.split(",")) == fst.SEG_COLS
    # the wire: fp32 fields through bf16, fp16, e4m3, e5m2 and the SOFT
    # formats (by the launch's format), rounded in phase A between load and
    # store on the flagged segments only
    assert STEP_SRC.count("(const void*)fused_step_kernel<wire::") == 6
    assert "if (s.narrow) v[u] = wire::narrow<WIRE>(v[u], f);" in STEP_SRC
    assert "s.fmt = wire::Format::from(fmt);" in STEP_SRC


def test_launch_shape():
    """One 4-cell run per thread over the tile grown by one cell, a row wide
    enough for the widest tile at any 16-byte phase, threads in whole warps;
    MIN_BLOCKS blocks fit an SM's shared memory, threads and registers at
    a register cap of at least 48."""
    sh = fst.fused_shape()
    tx, ty = sh["tile"]
    assert sh["rows"] == ty + 2
    assert 4 * sh["runs"] >= 3 + tx + 3 + 2 > 4 * (sh["runs"] - 1)
    assert sh["pitch"] == 4 * sh["runs"] and sh["pitch"] * 4 % 16 == 0
    t = sh["threads"]
    assert t % 32 == 0 and sh["rows"] * sh["runs"] <= t < sh["rows"] * sh["runs"] + 32
    assert sh["ring"] == fst.FUSED_LOOK + 2 and sh["ring"] % 6 == 0
    assert sh["smem_bytes"] == 4 * (sh["ring"] * sh["rows"] * sh["pitch"] + 2 * sh["pitch"])
    blocks = fst.FUSED_MIN_BLOCKS
    assert blocks >= 2
    assert blocks * (sh["smem_bytes"] + 1024) <= SMEM_PER_SM
    assert blocks * t <= THREADS_PER_SM
    assert REGS_PER_SM // (blocks * t) // 8 * 8 >= 48
    assert sh["task_units"] == t * fst.ROW_UNROLL


@pytest.mark.parametrize("nx,xo", [(512, 1), (256, 1), (33, 2), (200, 3), (513, 1), (67, 1),
                                   (68, 1), (2, 1), (40, 4), (64, 4), (129, 5)])
def test_tiles_cover_every_column(nx, xo):
    """Tiles partition the row; every tile after the first starts its
    output on the padded row's 16-byte grid; every grown tile fits a row of
    runs that starts on the grid, and its last run holds no output."""
    spec = GridSpec(Dim3(nx, 8, 8), Dim3(1, 1, 1), Radius.constant(xo), aligned=False)
    assert spec.compute_offset().x == xo
    gx, gy = fst.fused_tiles(spec)
    tx, ty = fst.FUSED_TILE
    assert gy == math.ceil(8 / ty)
    runs = fst.fused_shape()["runs"]
    a = -xo % 4
    cols = []
    for t in range(gx):
        x0 = 0 if t == 0 else t * tx + a
        x1 = min(nx, (t + 1) * tx + a)
        assert x1 > x0
        if t:
            assert (xo + x0) % 4 == 0
        e = (xo + x0 - 1) % 4
        assert e + (x1 - x0) + 2 <= 4 * runs  # ghost columns included
        assert e + (x1 - x0) < 4 * (runs - 1)  # the last run holds only a ghost
        cols += range(x0, x1)
    assert cols == list(range(nx))


def _walk_steps(cols, npos, nz, n, blocks):
    """Plane steps of the slowest block when `blocks` blocks take in turn
    the tiles of `npos` positions of `cols` columns each, cut into n z
    chunks, in the kernel's order (x, y, z chunk, position): a simulated
    walk."""
    c = -(-nz // n)
    per_pos = cols * -(-nz // c)
    per_block = [0] * blocks
    for t in range(npos * per_pos):
        z0 = (t % per_pos) // cols * c
        per_block[t % blocks] += min(nz, z0 + c) - z0 + 2
    return max(per_block)


@pytest.mark.parametrize("size,dim,blocks", [((512,) * 3, (1, 1, 1), 396),
                                             ((512,) * 3, (1, 1, 1), 264),
                                             ((512,) * 3, (2, 2, 2), 396),
                                             ((200, 100, 61), (1, 1, 1), 396),
                                             ((33, 21, 13), (1, 1, 1), 132)])
def test_zchunks_end_the_walk_soonest(size, dim, blocks):
    """The rule's count is the one whose simulated walk ends soonest among
    chunks of at least 4 planes (the walk's slowest block, the chunks'
    ragged last one and the warm-up included)."""
    spec = GridSpec(Dim3(*size), Dim3(*dim), Radius.constant(1)).block_spec()
    npos = int(np.prod(dim))
    gx, gy = fst.fused_tiles(spec)
    nz = spec.base.z
    n = fst.fused_zchunks(spec, npos, blocks)
    assert 1 <= n <= max(1, nz // 4)
    walks = [_walk_steps(gx * gy, npos, nz, k, blocks) for k in range(1, max(1, nz // 4) + 1)]
    assert walks[n - 1] == min(walks)


def _mesh_boxes(plan):
    return [(ph.src, ph.dst, ph.shape) for ph in plan.fused_phases]


WORK_CASES = [((512,) * 3, (1, 1, 1), 1, True), ((33, 21, 13), (1, 1, 1), 2, True),
              ((200, 100, 61), (1, 1, 1), 3, True), ((200, 100, 61), (1, 1, 1), 3, False),
              ((16, 16, 16), (2, 2, 2), 1, True), ((24, 20, 16), (2, 2, 2), 1, True),
              ((24, 20, 16), (2, 2, 2), 1, False)]
WORK_IDS = ["512-r1", "33x21x13-r2", "200x100x61-r3", "200x100x61-r3-unaligned",
            "16-222-r1", "24x20x16-222-r1", "24x20x16-222-r1-unaligned"]


def _work(size, dim, r, aligned):
    spec = GridSpec(Dim3(*size), Dim3(*dim), Radius.constant(r), aligned=aligned)
    plan = build_plan(spec, dim, Method.REMOTE_DMA, fused=True)
    p = spec.padded()
    sz, sy = p.y * p.x, p.x
    vec = sz % 4 == 0 and sy % 4 == 0
    return spec, plan, _mesh_boxes(plan), sz, sy, vec


def _unit_offsets(seg, sz, sy):
    """Word offsets (from the segment's first unit) of every unit's first
    word, row by row; and the words within a unit."""
    r = np.arange(seg.rows, dtype=np.int64)
    base = (r // seg.ey) * sz + (r % seg.ey) * sy
    return (base[:, None] + np.arange(seg.units, dtype=np.int64) * seg.width).ravel(), \
        np.arange(seg.width, dtype=np.int64)


@pytest.mark.parametrize("size,dim,r,aligned", WORK_CASES, ids=WORK_IDS)
def test_work_list_covers_every_halo_cell_once(size, dim, r, aligned):
    """Per box, the segments write every cell of its destination box once
    and read each from the source cell the box pairs it with; 16-byte
    units only where vectors are allowed, source and destination agreeing
    in phase, both on the 16-byte grid; the tasks are the units in chunks
    of the kernel's task, over every message of a box."""
    spec, plan, boxes, sz, sy, vec = _work(size, dim, r, aligned)
    assert vec == aligned
    segs = fst.message_rows(boxes, sz, sy, vec)
    wide = 0
    for b, (src, dst, shape) in enumerate(boxes):
        s0 = src[0] * sz + src[1] * sy + src[2]
        d0 = dst[0] * sz + dst[1] * sy + dst[2]
        z, y, x = np.meshgrid(*(np.arange(n, dtype=np.int64) for n in shape), indexing="ij")
        want = np.sort((d0 + z * sz + y * sy + x).ravel())
        got = []
        for seg in (s for s in segs if s.box == b):
            assert seg.rows == shape[0] * shape[1] and seg.ey == shape[1]
            units, words = _unit_offsets(seg, sz, sy)
            assert seg.src - s0 == seg.dst - d0  # one pairing for the whole box
            if seg.width == 4:
                wide += 1
                assert vec and (s0 - d0) % 4 == 0
                assert ((seg.src + units) % 4 == 0).all() and ((seg.dst + units) % 4 == 0).all()
            else:
                assert seg.width == 1
            got.append((seg.dst + units[:, None] + words[None, :]).ravel())
        got = np.sort(np.concatenate(got))
        np.testing.assert_array_equal(got, want)  # every halo cell once
    # the compute-extent rows of the y and z faces go as vectors when allowed
    assert (wide > 0) == vec
    rows, tasks = fst.row_table(tuple((tuple(s), tuple(d), tuple(e)) for s, d, e in boxes),
                                sz, sy, vec, spec.num_blocks())
    task, start = fst.fused_shape()["task_units"], 0
    assert len(rows) == len(segs) <= fst.MAX_SEGS
    for row, seg in zip(rows, segs):
        assert row[:7] == (seg.box, seg.src, seg.dst, seg.units, seg.width, seg.ey, seg.rows)
        assert row[7] == -(-seg.rows * seg.units // task) and row[8] == start
        start += spec.num_blocks() * row[7]
    assert tasks == start


def replay_rows(blocks, rows, msgs, m, sz, sy, wire=None):
    """Phase A as the kernel performs it, in plain torch indexing: for each
    work-list row (box, src, dst, units, width, ey, rows, ..., narrow) and
    each of the box's m messages (source, destination, box), the segment's
    words from the source position's block into the destination's, through
    ``wire`` where the row is flagged narrow. In place."""
    for row in rows:
        box, src, dst, units, width, ey, nrows = (int(v) for v in row[:7])
        narrow = int(row[9])
        r = np.arange(nrows, dtype=np.int64)
        base = (r // ey) * sz + (r % ey) * sy
        words = (np.arange(units)[:, None] * width + np.arange(width)).ravel()
        off = torch.from_numpy((base[:, None] + words[None, :]).ravel())
        for j in range(m):
            s, d, b = (int(v) for v in msgs[box * m + j])
            assert b == box and s == j
            words = blocks[s].view(-1)[src + off]
            blocks[d].view(-1)[dst + off] = wire_round(words, wire) if narrow else words
    return blocks


def _rand_blocks(spec, n, seed):
    rng = np.random.RandomState(seed)
    p = spec.padded()
    return [torch.from_numpy(rng.rand(1, 1, 1, p.z, p.y, p.x).astype(np.float32))
            for _ in range(n)]


@pytest.mark.parametrize("size,dim,r,aligned", WORK_CASES, ids=WORK_IDS)
def test_replay_equals_the_plain_hand_offs(size, dim, r, aligned):
    """The work list replayed over random blocks (noise in every halo)
    equals the plain versions' copies bit for bit, every cell: the one-block
    hand-offs of `_plan_boxes` on one block, `fused_exchange_plain` on the
    mesh."""
    spec, plan, boxes, sz, sy, vec = _work(size, dim, r, aligned)
    npos = spec.num_blocks()
    rows, _ = fst.row_table(tuple((tuple(s), tuple(d), tuple(e)) for s, d, e in boxes),
                            sz, sy, vec, npos)
    got = _rand_blocks(spec, npos, 40 + r)
    want = [b.clone() for b in got]
    if npos == 1:
        dests = [(0,)] * len(boxes)
        for src, dst, shape in fst._plan_boxes(spec, plan):
            s, d = fst.box_slices(src, dst, shape)
            want[0][d] = want[0][s]
    else:
        mesh = DeviceMesh(dim, ["cpu"] * npos)
        dests = [mesh.destinations(ph.direction) for ph in plan.fused_phases]
        fst.fused_exchange_plain([[b] for b in want], spec, plan, mesh)
    msgs = [(i, j, b) for b, ds in enumerate(dests) for i, j in enumerate(ds)]
    replay_rows(got, rows, msgs, npos, sz, sy)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


class FakeFusedCard:
    """Stands in for the card in the fused wrappers' CUDA branch: keeps the
    tables the wrapper uploads, and applies them to the CPU blocks the
    position table names (phase A by `replay_rows`, then the plain sweep of
    every position)."""

    type, index = "cuda", 0

    def __init__(self, monkeypatch, blocks, spec):
        self.blocks = {b.data_ptr(): b for b in blocks}
        self.spec, self.tables, self.made = spec, {}, []
        monkeypatch.setattr(fst, "_device_of", lambda *a: self)
        monkeypatch.setattr(fst._native, "device_table", self.device_table)
        monkeypatch.setattr(fst._native, "stream_ptr", lambda dev: 0)
        monkeypatch.setattr(fst._native, "lib", lambda name: self)

    def device_table(self, key, rows, device):
        if key not in self.tables:
            t = torch.tensor(rows(), dtype=torch.int64)
            self.tables[key] = t
            self.tables[t.data_ptr()] = t.tolist()
            self.made.append(key)
        return self.tables[key]

    def fused_jacobi_launch(self, pos, npos, nsweep, msg, m, segs, nseg, ncols, tasks, sz, sy,
                            zo, yo, xo, nz, ny, nx, vec, wire, fmt, dev, stream):
        assert wire == 0 and nsweep == npos  # one block: nothing crosses, every row swept
        p = [[self.blocks[v] for v in self.tables[pos][3 * i:3 * i + 3]] for i in range(npos)]
        flat, msgs = self.tables[segs], self.tables[msg]
        assert ncols == fst.SEG_COLS and len(flat) == nseg * ncols
        rows = [flat[i * ncols:(i + 1) * ncols] for i in range(nseg)]
        assert tasks == rows[-1][8] + m * rows[-1][7]
        replay_rows([a for a, _b, _s in p], rows,
                    [msgs[3 * i:3 * i + 3] for i in range(len(msgs) // 3)], m, sz, sy)
        off, b = self.spec.compute_offset(), self.spec.base
        assert (zo, yo, xo, nz, ny, nx) == (off.z, off.y, off.x, b.z, b.y, b.x)
        for a, nxt, sel in p:
            fst.sweep_plain(a, nxt, sel, self.spec, fst.NO_WRAP)
        return 0


@pytest.mark.parametrize("size,r", [((16, 16, 14), 1), ((33, 21, 13), 2)], ids=["16-r1", "33-r2"])
def test_one_block_is_the_one_position_case(monkeypatch, size, r):
    """The one-block wrapper builds a one-position table whose messages all
    wrap onto the block, and its cells (curr with its halos, and nxt) equal
    `fused_jacobi_plain`'s."""
    spec = GridSpec(Dim3(*size), Dim3(1, 1, 1), Radius.constant(r))
    plan = build_plan(spec, (1, 1, 1), Method.REMOTE_DMA, fused=True)
    c, n = _rand_blocks(spec, 2, 33)
    rng = np.random.RandomState(34)
    p = spec.padded()
    s = torch.from_numpy(rng.randint(-1, 4, (1, 1, 1, p.z, p.y, p.x)).astype(np.int32))
    wc, wn = c.clone(), n.clone()
    fst.fused_jacobi_plain(wc, wn, s, spec, plan)
    card = FakeFusedCard(monkeypatch, [c, n, s], spec)
    before = fst.fused_jacobi.launches
    fst.fused_jacobi(c, n, s, spec, plan)
    assert fst.fused_jacobi.launches == before + 1
    assert torch.equal(c, wc) and torch.equal(n, wn)
    assert [k[0] for k in card.made] == ["mesh_positions", "mesh_messages", "fused_rows"]
    msgs = card.tables[("mesh_messages", ((0,),) * len(plan.fused_phases))]
    assert msgs.view(-1, 3)[:, :2].eq(0).all()
    assert card.tables[card.made[0]].tolist() == [c.data_ptr(), n.data_ptr(), s.data_ptr()]


@pytest.mark.parametrize("size,dim", [((16, 16, 16), (2, 2, 2)), ((16, 16, 20), (1, 1, 2)),
                                      ((24, 20, 16), (2, 1, 1))], ids=["222", "112", "211"])
def test_narrow_flags_mark_the_crossing_boxes(size, dim):
    """B8's table flags exactly the rows of crossing boxes (a direction with
    a nonzero component on an axis of several positions), and replayed with
    a wire gives fused_exchange_plain with that wire on every cell (NaN equal
    to NaN); the rows are otherwise the unflagged table's."""
    spec, plan, boxes, sz, sy, vec = _work(size, dim, 1, True)
    npos = spec.num_blocks()
    key = tuple((tuple(s), tuple(d), tuple(e)) for s, d, e in boxes)
    crossing = [ph.crossing for ph in plan.fused_phases]
    assert crossing == [any(c and n > 1 for c, n in zip(ph.direction, dim))
                        for ph in plan.fused_phases]
    plain_rows, tasks = fst.row_table(key, sz, sy, vec, npos)
    rows, wtasks = fst.row_table(key, sz, sy, vec, npos, tuple(crossing))
    assert tasks == wtasks and [r[:9] for r in rows] == [r[:9] for r in plain_rows]
    assert [r[9] for r in rows] == [int(crossing[r[0]]) for r in rows]
    assert not any(r[9] for r in plain_rows) and any(r[9] for r in rows)
    assert all(crossing) == (1 not in dim)
    mesh = DeviceMesh(dim, ["cpu"] * npos)
    dests = [mesh.destinations(ph.direction) for ph in plan.fused_phases]
    msgs = [(i, j, b) for b, ds in enumerate(dests) for i, j in enumerate(ds)]
    p = spec.padded()
    for wire in WIRE_FORMATS:
        rng = np.random.RandomState(45)
        got = [torch.from_numpy((rng.standard_normal((1, 1, 1, p.z, p.y, p.x))
                                 * 2.0 ** rng.uniform(-12, 9, (1, 1, 1, p.z, p.y, p.x)))
                                .astype(np.float32)) for _ in range(npos)]
        want = [b.clone() for b in got]
        fst.fused_exchange_plain([[b] for b in want], spec, plan, mesh, wire)
        replay_rows(got, rows, msgs, npos, sz, sy, wire)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.numpy())


# -- B9's pass walk, uniform and uneven -------------------------------------------------

CHUNK_SRC = (CSRC / "mesh_chunk.cuh").read_text()


def test_chunk_walk_constants_mirror_the_kernel_source():
    from stencil_tpu_torch.ops import persistent_stencil as pst

    assert pst.ONCHIP_TILE == _const(CHUNK_SRC, "ONCHIP_TILE")
    assert pst.TILES_PER_BLOCK == _const(CHUNK_SRC, "TILES_PER_BLOCK")
    assert pst.ONCHIP_KMAX == _const(CHUNK_SRC, "ONCHIP_KMAX")
    # the uneven form: the extent table's rows, read per position, the tile
    # walk's z chunk chosen once from every position's columns
    assert "const long long* ext;" in CHUNK_SRC
    assert "*ex = (int)c.ext[3 * i + 2] + 2 * g;" in CHUNK_SRC
    assert "zchunk_for((long long)TILES_PER_BLOCK * gridDim.x, all_cols, ez0)" in CHUNK_SRC


@pytest.mark.parametrize("size,dim,k", [((512, 512, 512), (3, 2, 1), 4), ((67, 45, 29), (3, 2, 1), 3),
                                        ((17, 19, 16), (2, 2, 2), 2), ((64, 64, 64), (2, 2, 2), 4)],
                         ids=["512-321-k4", "67x45x29-321-k3", "17x19x16-222-k2", "64-222-k4"])
@pytest.mark.parametrize("blocks", [132, 7])
def test_chunk_walk_covers_each_positions_region_once(size, dim, k, blocks):
    """Every pass of a depth-k chunk: the tiles cover each position's
    region grown by the depth left, at its own extent, every cell once; on a
    uniform mesh the walk is the uniform kernel's (every position the same
    tiles, ``per_pos`` each)."""
    from stencil_tpu_torch.ops import persistent_stencil as pst

    spec = GridSpec(Dim3(*size), Dim3(*dim), Radius.constant(k))
    mesh = DeviceMesh(dim, ["cpu"] * spec.num_blocks())
    ext = pst.position_extents(spec, mesh)
    assert len(set(ext)) == (1 if spec.is_uniform() else len(set(ext)))
    left = k
    for d in pst.chunk_passes(k):
        left -= d
        tiles = pst.onchip_walk(ext, left, blocks)
        for i, (nz, ny, nx) in enumerate(ext):
            ez, ey, ex = nz + 2 * left, ny + 2 * left, nx + 2 * left
            seen = np.zeros((ez, ey, ex), np.int32)
            for pos, x0, y0, z0, z1, tx, ty in tiles:
                if pos == i:
                    assert (tx, ty) == (ex, ey)
                    seen[z0:z1, y0:y0 + pst.ONCHIP_TILE, x0:x0 + pst.ONCHIP_TILE] += 1
            assert (seen == 1).all(), (i, left)
        if spec.is_uniform():
            per = len(tiles) // len(ext)
            assert [t[0] for t in tiles] == [i for i in range(len(ext)) for _ in range(per)]
