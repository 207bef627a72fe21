"""The Astaroth substep kernel's launch shape, shared-memory budget, ring
schedule and task table, mirrored in Python (ops/astaroth_substep.py) and
held to the kernel source (the table's rows, its z chunks, the kernel's
walk over it replayed, the tensor-copy choice per task); and the unfused
issue floor of utils/roofline.py. CPU only: the kernel itself is held to
its plain version by chip_smoke.py phases 5 and 14."""

import collections
import pathlib
import re

import numpy as np
import pytest
import torch

from stencil_tpu_torch.domain import GridSpec
from stencil_tpu_torch.geometry import Dim3, Radius, Rect3, interior_region
from stencil_tpu_torch.ops import astaroth_substep as asub
from stencil_tpu_torch.utils import roofline

SRC = (pathlib.Path(asub.__file__).resolve().parent.parent / "csrc" /
       "astaroth_substep.cu").read_text()
# H100: shared memory one block may use, and an SM's, of which each
# resident block takes 1 KB for itself
SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472
CELLS_256 = 256 ** 3


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _enum(name):
    body = re.sub(r"//.*", "", re.search(rf"enum {name} \{{(.*?)\}};", SRC, re.S).group(1))
    return [w for w in re.findall(r"\b([A-Z][A-Z0-9_]*)\b", body) if w != "NH"]


def test_issue_floor_of_the_fp64_stage():
    """949 unfused fp64 operations per cell at 256^3: 0.952 ms."""
    assert roofline.issue_ms(949 * CELLS_256, torch.float64) == pytest.approx(0.952, abs=5e-4)


@pytest.mark.parametrize("dtype,ms", [(torch.float64, 0.968), (torch.float32, 0.484)])
def test_issue_floor_of_the_main_path_mix(dtype, ms):
    ops = sum(asub.FLOPS_PER_CELL) / 3 * CELLS_256
    assert roofline.issue_ms(ops, dtype) == pytest.approx(ms, abs=5e-4)


def test_issue_floor_is_half_the_data_sheet_rate():
    """The data sheet counts a fused multiply-add as two operations; an
    unfused kernel issues one per lane and clock, so its floor is about
    twice bound_ms's operations floor (1.98 GHz against the boost clock)."""
    for dtype in (torch.float64, torch.float32):
        ratio = roofline.issue_ms(1e12, dtype) / roofline.bound_ms(0, 1e12, dtype)[0]
        assert 1.9 < ratio < 2.1
    assert roofline.bound_ms(0, 1e12, torch.float64)[0] > 0  # bound_ms unchanged


def test_launch_shape_mirrors_the_kernel_source():
    assert asub.TILE == (_const("BX"), _const("BY"))
    assert asub.GROUPS == len(_enum("Group"))
    assert asub.HANDOVER == len(_enum("Hand"))
    assert asub.RING_SLOTS == _const("SLOTS")
    assert asub.RING_STRIDE == _const("PSTRIDE")
    assert asub.RING_STRIDE >= (asub.TILE[0] + 2 * asub.HALO) * (asub.TILE[1] + 2 * asub.HALO)
    assert asub.RING_STRIDE * 4 % 128 == 0
    assert asub.HALO == _const("H")
    assert asub.substep_threads() == asub.GROUPS * asub.TILE[0] * asub.TILE[1]
    # one footprint cell per thread fills the ring
    footprint = (asub.TILE[0] + 2 * asub.HALO) * (asub.TILE[1] + 2 * asub.HALO)
    assert footprint <= asub.substep_threads()


@pytest.mark.parametrize("dtype,blocks", [(torch.float64, 1), (torch.float32, 2)])
def test_shared_memory_budget(dtype, blocks):
    """fp64's ring and hand-over fit one block per SM, fp32's two; the
    kernel asks ptxas for as many (min_blocks)."""
    item = torch.empty((), dtype=dtype).element_size()
    b = asub.substep_smem_bytes(item)
    assert b == (8 * asub.RING_SLOTS * asub.RING_STRIDE + asub.HANDOVER * 128) * item + 16
    assert b <= SMEM_PER_BLOCK
    assert blocks * (b + 1024) <= SMEM_PER_SM < (blocks + 1) * (b + 1024)


@pytest.mark.parametrize("size", [(256, 256, 256), (64, 64, 64), (40, 24, 20), (33, 13, 7),
                                  (200, 100, 61), (48, 40, 36), (1, 1, 1)])
@pytest.mark.parametrize("blocks_in_flight", [1, 132, 264])
def test_zchunk_covers_every_plane_once(size, blocks_in_flight):
    spec = GridSpec(Dim3(*size), Dim3(1, 1, 1), Radius.constant(3))
    zc = asub.substep_zchunk(spec, blocks_in_flight)
    # the kernel's grid: one block per tile and z chunk
    gx, gy, gz = (-(-size[0] // asub.TILE[0]), -(-size[1] // asub.TILE[1]), -(-size[2] // zc))
    assert 1 <= zc <= size[2]
    assert (gz - 1) * zc < size[2] <= gz * zc  # no empty chunk
    assert (gx - 1) * asub.TILE[0] < size[0] <= gx * asub.TILE[0]
    assert (gy - 1) * asub.TILE[1] < size[1] <= gy * asub.TILE[1]
    want = -(-blocks_in_flight * asub.WAVES // (gx * gy))
    assert gz <= max(1, min(size[2], want))


def test_zchunk_at_the_main_path_shape():
    """256^3 on 132 SMs of one fp64 block each: 512 tiles, one chunk."""
    spec = GridSpec(Dim3(256, 256, 256), Dim3(1, 1, 1), Radius.constant(3))
    assert asub.substep_zchunk(spec, 132) == 256


@pytest.mark.parametrize("z0,z1", [(0, 1), (0, 2), (3, 10), (0, 86), (86, 172)])
def test_ring_schedule(z0, z1):
    """The kernel's slots: plane zp of a chunk starting at z0 lives in slot
    (zp - z0 + H) mod SLOTS; plane z reads z-3 .. z+3 through
    slot[j] = (z - z0 + j) mod SLOTS, while plane z+4 is copied into the
    one slot that window does not use."""
    h, slots = asub.HALO, asub.RING_SLOTS

    def slot(zp):
        return (zp - z0 + h) % slots

    held = {slot(zp): zp for zp in range(z0 - h, z0 + h + 1)}
    for z in range(z0, z1):
        window = range(z - h, z + h + 1)
        assert [held[(z - z0 + j) % slots] for j in range(2 * h + 1)] == list(window)
        if z + 1 < z1:
            assert slot(z + h + 1) not in {slot(p) for p in window}
            held[slot(z + h + 1)] = z + h + 1


# -- the task table (substep_tasks): rows, z chunks, the walk, the TMA choice ------

def test_task_row_mirrors_the_kernel_source():
    body = re.search(r"struct SubstepTask \{(.*?)\};", SRC, re.S).group(1)
    cols = re.findall(r"\b(\w+)\s*[,;]", body)
    assert cols == ["start", "block", "zo", "yo", "xo", "nz", "ny", "nx", "gx", "gy", "zchunk",
                    "tma"]
    assert asub.TASK_COLS == _const("TASK_COLS") == len(cols)


def _spec(size, part, aligned=True):
    return GridSpec(Dim3(*size), Dim3(*part), Radius.constant(3), aligned=aligned)


def _walk(rows, tiles):
    """The kernel's walk: for each block of the grid, its task row (thread
    0's binary search over the rows' first tiles) and its tile's first
    column, row and plane in the rect and its planes."""
    starts = [r[0] for r in rows]
    for w in range(tiles):
        lo, hi = 0, len(rows) - 1
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            if starts[mid] <= w:
                lo = mid
            else:
                hi = mid - 1
        t = rows[lo]
        gx, gy, zc = t[8], t[9], t[10]
        u = w - t[0]
        tz, r = divmod(u, gx * gy)
        z0 = tz * zc
        yield lo, (r % gx) * asub.TILE[0], (r // gx) * asub.TILE[1], z0, min(t[5] - z0, zc)


TABLES = {
    "40x24x20 (2,2,2)": ((40, 24, 20), (2, 2, 2), "compute"),
    "33x13x14 (1,1,2)": ((33, 13, 14), (1, 1, 2), "compute"),
    "67x45x29 (2,2,2) uneven": ((67, 45, 29), (2, 2, 2), "compute"),
    "64^3 (2,2,2) shells": ((64, 64, 64), (2, 2, 2), "shells"),
    "67x45x29 (2,2,2) uneven shells": ((67, 45, 29), (2, 2, 2), "shells"),
}


@pytest.mark.parametrize("blocks_in_flight", [1, 132, 264])
@pytest.mark.parametrize("case", sorted(TABLES))
def test_table_walk_covers_every_cell_of_every_task_once(case, blocks_in_flight):
    """Every cell of every task is some block's (live) cell exactly once, no
    block of the grid is empty, and each task's z chunks cover its planes
    with no empty chunk."""
    size, part, kind = TABLES[case]
    spec = _spec(size, part)
    tasks = asub.compute_tasks(spec) if kind == "compute" else asub.shell_tasks(spec)
    rows, tiles = asub.substep_table(tasks, spec, blocks_in_flight, 8)
    assert len(rows[0]) == asub.TASK_COLS and rows[0][0] == 0
    cover = []
    for t, row in zip(tasks, rows):
        n = t.rect.hi - t.rect.lo
        assert row[1:8] == (t.block, t.rect.lo.z, t.rect.lo.y, t.rect.lo.x, n.z, n.y, n.x)
        assert 1 <= row[10] <= n.z and row[8:10] == asub.tile_grid(n)
        cover.append(np.zeros((n.z, n.y, n.x), dtype=np.int32))
    for i, x0, y0, z0, n in _walk(rows, tiles):
        assert n >= 1 and x0 < rows[i][7] and y0 < rows[i][6]
        cover[i][z0:z0 + n, y0:y0 + asub.TILE[1], x0:x0 + asub.TILE[0]] += 1
    assert all((c == 1).all() for c in cover)


@pytest.mark.parametrize("size", [(256, 256, 256), (64, 64, 64), (40, 24, 20), (33, 13, 7),
                                  (200, 100, 61), (1, 1, 1)])
@pytest.mark.parametrize("blocks_in_flight", [1, 132, 264])
def test_one_task_table_is_the_one_block_launch(size, blocks_in_flight):
    """substep's table: one row, the one-block z chunk, its grid's blocks."""
    spec = _spec(size, (1, 1, 1))
    off = spec.compute_offset()
    rows, tiles = asub.substep_table(((0, Rect3(off, off + spec.base)),), spec,
                                     blocks_in_flight, 8)
    zc = asub.substep_zchunk(spec, blocks_in_flight)
    gx, gy = asub.tile_grid(spec.base)
    assert len(rows) == 1 and rows[0][10] == zc and tiles == gx * gy * -(-size[2] // zc)


def test_shells_and_interior_tile_every_compute_region_once():
    """6 shells a block (48 on (2,2,2)), each block's at its own extent on an
    uneven partition; with the interior they cover the compute region once."""
    for size, part in (((64, 64, 64), (2, 2, 2)), ((67, 45, 29), (2, 2, 2)),
                       ((33, 13, 14), (1, 1, 2))):
        spec = _spec(size, part)
        shells = asub.shell_tasks(spec)
        assert len(shells) == 6 * spec.num_blocks()
        for j, c in asub.compute_tasks(spec):
            n = c.hi - c.lo
            cover = np.zeros((n.z, n.y, n.x), dtype=np.int32)
            rects = [r for b, r in shells if b == j] + [interior_region(c, spec.radius)]
            for r in rects:
                lo, hi = r.lo - c.lo, r.hi - c.lo
                cover[lo.z:hi.z, lo.y:hi.y, lo.x:hi.x] += 1
            assert (cover == 1).all() and n == spec.block_size(asub.block_index(spec, j))


def test_tma_choice_per_task():
    """fp64 tasks whose boxes start 16-byte aligned take tensor copies: every
    compute region (x from 3) and the +y, +z, -x shells; the +x shell (x
    from 3 + 253) and the -y, -z shells (x from 6) do not. fp32, unaligned
    fields and an odd x pitch never do."""
    spec = _spec((512, 512, 512), (2, 2, 2))
    rows, _ = asub.substep_table(asub.compute_tasks(spec), spec, 132, 8)
    assert [r[-1] for r in rows] == [1] * 8
    shells = asub.shell_tasks(spec)
    rows, _ = asub.substep_table(shells, spec, 132, 8)
    assert [r[4] for r in rows[:6]] == [256, 3, 3, 3, 6, 6]
    assert [r[-1] for r in rows] == [0, 1, 1, 1, 0, 0] * 8
    assert all(r[-1] == 0 for r in asub.substep_table(shells, spec, 132, 4)[0])
    assert all(r[-1] == 0 for r in asub.substep_table(shells, spec, 132, 8, aligned=False)[0])
    odd = _spec((33, 13, 14), (1, 1, 2), aligned=False)
    assert odd.padded().x % 2 == 1
    assert all(r[-1] == 0 for r in asub.substep_table(asub.compute_tasks(odd), odd, 132, 8)[0])


def test_task_bytes():
    spec = _spec((512, 512, 512), (2, 2, 2))
    cells = sum((r.hi - r.lo).flatten() for _, r in asub.shell_tasks(spec))
    assert cells == 512 ** 3 - 8 * 250 ** 3
    assert asub.tasks_bytes(asub.shell_tasks(spec), 8, 0) == 16 * 8 * cells
    assert asub.tasks_bytes(asub.compute_tasks(spec), 4, 1) == 24 * 4 * 512 ** 3


def test_long_tables_are_cut_into_launches():
    """A table longer than MAX_TASKS rows (the kernel's parameter table) goes
    out in several launches, each group's first tiles counted from 0, the
    groups' tiles summing to the table's; the kernel's walk over each group
    covers its tasks' cells once."""
    assert asub.MAX_TASKS == _const("MAX_TASKS")
    spec = _spec((100, 72, 54), (5, 6, 3))  # 90 blocks of 20x12x18: 540 shells
    shells = asub.shell_tasks(spec)
    rows, tiles = asub.substep_table(shells, spec, 132, 8)
    groups = asub.table_launches(rows, tiles)
    assert [len(g) for g, _ in groups] == [256, 256, 28]
    assert sum(t for _, t in groups) == tiles
    done = 0
    for g, t in groups:
        assert g[0][0] == 0 and all(a[0] < b[0] for a, b in zip(g, g[1:]))
        assert [r[1:] for r in g] == [r[1:] for r in rows[done:done + len(g)]]
        seen = collections.Counter(i for i, *_ in _walk(g, t))
        assert sorted(seen) == list(range(len(g)))
        done += len(g)
    assert asub.table_launches(rows[:3], rows[3][0]) == [(rows[:3], rows[3][0])]


# -- the positions form (substep_positions): its rows, its position column, the split --

def test_position_row_mirrors_the_kernel_source():
    """A positions row is a task row and its position; one launch takes up
    to MAX_POSITIONS positions' pointers and tensor maps, and its
    parameters (the table, the positions' 8 + 8 pointers and 8 maps of 128
    bytes each, the coefficients) fit the 32,764 bytes a launch may pass."""
    body = re.search(r"struct PositionTask \{(.*?)\};", SRC, re.S).group(1)
    assert re.findall(r"\b(\w+)\s*;", body) == ["task", "pos"]
    assert asub.POSITION_COLS == _const("POSITION_COLS") == asub.TASK_COLS + 1
    assert asub.MAX_POSITIONS == _const("MAX_POSITIONS")
    table = 4 + asub.MAX_TASKS * 4 * asub.POSITION_COLS
    positions = asub.MAX_POSITIONS * (2 * asub.NF * 8 + asub.NF * 128)
    coefs, scalars = 24 * 8, 4 * 4
    assert table + positions + coefs + scalars + 64 <= 32_764


MESHES = {
    "(2,2,2) on 8": ((40, 24, 20), (2, 2, 2), (1, 1, 1)),
    "(1,1,2) on 2": ((33, 13, 14), (1, 1, 2), (1, 1, 1)),
    "(2,2,2) on 4": ((40, 24, 20), (2, 2, 2), (1, 1, 2)),
    "(2,2,2) on 2": ((40, 24, 20), (2, 2, 2), (1, 2, 2)),
    "uneven 19x16x14 on 8": ((19, 16, 14), (2, 2, 2), (1, 1, 1)),
    "(3,2,2) on 12": ((60, 40, 28), (3, 2, 2), (1, 1, 1)),
}


@pytest.mark.parametrize("case", sorted(MESHES))
def test_position_tasks_are_the_partition_blocks(case):
    """Each position's tasks are its stack's blocks, in the stack's order,
    each the compute region (and the 6 shells) of the partition block that
    split_positions puts there, at its own extent."""
    from stencil_tpu_torch.parallel import DeviceMesh, split_positions

    size, part, res = MESHES[case]
    spec = _spec(size, part)
    r = Dim3(*res)
    mesh_dim = asub.position_mesh(spec, r)
    full = asub.position_compute_tasks(spec, r)
    assert len(full) == spec.num_blocks()
    assert [(t.position, t.block) for t in full] == [
        (p, j) for p in range(mesh_dim.flatten()) for j in range(r.flatten())]
    # a stacked tensor of block indices, split as a mesh's state
    ids = torch.arange(spec.num_blocks(), dtype=torch.int64).view(
        spec.dim.z, spec.dim.y, spec.dim.x, 1, 1, 1)
    p = spec.padded()
    stacked = ids.expand(*ids.shape[:3], p.z, p.y, p.x).contiguous()
    mesh = DeviceMesh(mesh_dim, ["cpu"] * mesh_dim.flatten())
    pos = split_positions(stacked, spec, mesh)
    for t in full:
        j = int(pos[t.position].reshape(-1, p.z, p.y, p.x)[t.block, 0, 0, 0])
        assert asub.position_block(spec, r, t.position, t.block) == j
        assert t.rect == asub.block_compute(spec, j)
    shells = asub.position_shell_tasks(spec, r)
    assert len(shells) == 6 * len(full)
    assert {(t.position, t.block) for t in shells} == {(t.position, t.block) for t in full}


@pytest.mark.parametrize("case", sorted(MESHES))
def test_position_table_walk_covers_every_task_once(case):
    """The positions table's rows are substep_table's rows of the same
    blocks and rects, each followed by its position; the kernel's walk over
    each launch covers every cell of every task once."""
    size, part, res = MESHES[case]
    spec = _spec(size, part)
    r = Dim3(*res)
    npos = asub.position_mesh(spec, r).flatten()
    for tasks in (asub.position_compute_tasks(spec, r), asub.position_shell_tasks(spec, r)):
        rows, tiles = asub.position_table(tasks, spec, 132, 8, [True] * npos)
        plain, ptiles = asub.substep_table([(t.block, t.rect) for t in tasks], spec, 132, 8)
        assert ptiles == tiles and [row[:-1] for row in rows] == list(plain)
        assert [row[-1] for row in rows] == [t.position for t in tasks]
        assert all(len(row) == asub.POSITION_COLS for row in rows)
        seen = collections.Counter()
        for g, t, positions in asub.position_launches(rows, tiles):
            assert len(positions) <= asub.MAX_POSITIONS and len(g) <= asub.MAX_TASKS
            for i, x0, y0, z0, n in _walk(g, t):
                seen[positions[g[i][-1]], g[i][1], g[i][2:5]] += n
        want = collections.Counter()
        for t in tasks:
            gx, gy = asub.tile_grid(t.rect.hi - t.rect.lo)
            n = t.rect.hi - t.rect.lo
            want[t.position, t.block, (t.rect.lo.z, t.rect.lo.y, t.rect.lo.x)] += gx * gy * n.z
        assert seen == want


def test_meshes_beyond_the_launch_limit_are_split():
    """More positions than one launch takes: the 12 positions of (3,2,2) go
    out in two launches, 8 then 4, each group's first tiles counted from
    0, its positions column local to the group; a long shell table is cut
    by MAX_TASKS as well as by MAX_POSITIONS."""
    spec = _spec((60, 40, 28), (3, 2, 2))
    one = Dim3(1, 1, 1)
    tasks = asub.position_compute_tasks(spec, one)
    rows, tiles = asub.position_table(tasks, spec, 132, 8, [True] * 12)
    groups = asub.position_launches(rows, tiles)
    assert [(len(g), p) for g, _, p in groups] == [(8, tuple(range(8))), (4, (8, 9, 10, 11))]
    assert sum(t for _, t, _ in groups) == tiles
    for g, t, positions in groups:
        assert g[0][0] == 0 and [r[-1] for r in g] == list(range(len(positions)))
    # 90 blocks of 20x12x18 on 45 positions of 2: 540 shells
    spec = _spec((100, 72, 54), (5, 6, 3))
    res = Dim3(1, 2, 1)
    shells = asub.position_shell_tasks(spec, res)
    rows, tiles = asub.position_table(shells, spec, 132, 8, [True] * 45)
    groups = asub.position_launches(rows, tiles)
    # 8 positions of 2 blocks of 6 shells: 96 rows a launch
    assert [len(g) for g, _, _ in groups] == [96] * 5 + [60]
    assert [len(p) for _, _, p in groups] == [8] * 5 + [5]
    assert sum(t for _, t, _ in groups) == tiles
    # one position of many blocks: cut by MAX_TASKS only
    spec = _spec((100, 72, 54), (5, 6, 3))
    shells = asub.position_shell_tasks(spec, spec.dim)
    rows, tiles = asub.position_table(shells, spec, 132, 8, [True])
    assert [len(g) for g, _, _ in asub.position_launches(rows, tiles)] == [256, 256, 28]


def test_position_tma_choice_per_position():
    """A position whose fields are off 16-byte alignment takes cp.async for
    every task; the others keep the table's choice."""
    spec = _spec((512, 512, 512), (2, 2, 2))
    one = Dim3(1, 1, 1)
    aligned = [True] * 8
    aligned[3] = False
    rows, _ = asub.position_table(asub.position_compute_tasks(spec, one), spec, 132, 8, aligned)
    assert [r[-2] for r in rows] == [1, 1, 1, 0, 1, 1, 1, 1]
    rows, _ = asub.position_table(asub.position_shell_tasks(spec, one), spec, 132, 8, aligned)
    assert [r[-2] for r in rows] == [0, 1, 1, 1, 0, 0] * 3 + [0] * 6 + [0, 1, 1, 1, 0, 0] * 4
    rows, _ = asub.position_table(asub.position_compute_tasks(spec, one), spec, 132, 4,
                                  [True] * 8)
    assert all(r[-2] == 0 for r in rows)
