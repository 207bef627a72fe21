"""The exchange carriers' work lists and launch shape (ops/row_moves.py,
mirrored from csrc/row_moves.cuh, csrc/remote_axis.cu and
csrc/fused_exchange.cu), held on the CPU: B6's work list covers every slab
cell of each phase once and B7's every cell of every direction box once;
16-byte units only where source and destination agree in phase on the
16-byte grid; in a paired segment a boundary row's two hand-offs sit on
adjacent units of one warp instruction; replayed task by task as the kernel
reads the tables, the work lists move exactly the cells of
remote_axis_plain and fused_exchange_plain; B8's work list is unchanged.
The kernels themselves are held to their plain versions by chip_smoke.py
phase 9. Inputs are random numpy fields from a seed; tolerance: bit-exact."""

import bisect
import pathlib
import re

import numpy as np
import pytest
import torch

from stencil_tpu_torch.domain import GridSpec
from stencil_tpu_torch.geometry import Dim3, Radius
from stencil_tpu_torch.ops import fused_stencil as fst
from stencil_tpu_torch.ops import halo_fill
from stencil_tpu_torch.ops import remote_dma as rdma
from stencil_tpu_torch.ops import row_moves as rmv
from stencil_tpu_torch.parallel import DeviceMesh, HaloExchange, Method
from stencil_tpu_torch.plan.ir import build_plan

torch.set_num_threads(2)

CSRC = pathlib.Path(rmv.__file__).resolve().parent.parent / "csrc"
HEADER = (CSRC / "row_moves.cuh").read_text()
F32, F64 = np.float32, np.float64


def asym_radius(faces):
    """Face radii ``faces`` = (x-, x+, y-, y+, z-, z+); every edge and corner
    direction on (a gate: halo extents use the face radii)."""
    r = Radius()
    for d, v in zip(((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1)), faces):
        r.set_dir(d, v)
    r.set_edge(1)
    r.set_corner(1)
    return r


# (id, global size, mesh, radius, aligned, dtype): the (2,2,2), (1,1,2) and
# (2,1,1) meshes, fp32 and fp64, aligned and off the 16-byte grid, symmetric
# and asymmetric radii (rm == 0 on x, y or z), ragged sizes
CASES = [
    ("222-r1-f32", (16, 16, 16), (2, 2, 2), Radius.constant(1), True, F32),
    ("222-r2-f64-unaligned", (24, 20, 18), (2, 2, 2), Radius.constant(2), False, F64),
    ("112-r1-f64", (16, 16, 20), (1, 1, 2), Radius.constant(1), True, F64),
    ("112-r3-f32-ragged-unaligned", (13, 11, 18), (1, 1, 2), Radius.constant(3), False, F32),
    ("211-r2-f32-ragged", (26, 14, 10), (2, 1, 1), Radius.constant(2), True, F32),
    ("211-r1-f64-ragged-unaligned", (30, 7, 9), (2, 1, 1), Radius.constant(1), False, F64),
    ("222-asym-x0-f32", (16, 12, 10), (2, 2, 2), asym_radius((0, 2, 1, 2, 2, 1)), True, F32),
    ("222-asym-y0-f64-unaligned", (18, 14, 12), (2, 2, 2), asym_radius((1, 3, 0, 1, 1, 2)),
     False, F64),
    ("211-asym-z0-f32-unaligned", (22, 9, 8), (2, 1, 1), asym_radius((2, 1, 1, 2, 0, 1)), False,
     F32),
    ("112-asym-x0-f64", (12, 10, 16), (1, 1, 2), asym_radius((0, 1, 2, 1, 1, 3)), True, F64),
]
IDS = [c[0] for c in CASES]


def _case(size, dim, radius, aligned, dtype):
    spec = GridSpec(Dim3(*size), Dim3(*dim), radius, aligned=aligned)
    p = spec.padded()
    word = np.dtype(dtype).itemsize
    vw = rmv.VECTOR_BYTES // word
    vec = (p.y * p.x) % vw == 0 and p.x % vw == 0
    return spec, p.y * p.x, p.x, word, vec


def _phases(spec):
    plan = build_plan(spec, spec.dim, Method.REMOTE_DMA)
    return [ph for ph in plan.remote_phases if ph.ring > 1 and ph.active]


def _slab_boxes(spec, axis):
    p = spec.padded()
    return rdma.remote_axis_boxes(axis, halo_fill.axis_geom(spec, axis), (p.z, p.y, p.x))


def _fused(spec):
    plan = build_plan(spec, spec.dim, Method.REMOTE_DMA, fused=True)
    boxes = tuple((ph.src, ph.dst, ph.shape) for ph in plan.fused_phases)
    return plan, boxes, tuple(ph.direction for ph in plan.fused_phases)


def _works(spec, word, vec, m=1):
    """``[(label, work, boxes, steps)]``: B6's work list of every ring phase,
    then B7's."""
    out = []
    for ph in _phases(spec):
        boxes, steps, _pairs = _slab_boxes(spec, ph.axis)
        out.append((f"remote_axis {ph.axis}", rdma.remote_axis_work(spec, ph.axis, vec, word, m),
                    boxes, steps))
    plan, boxes, steps = _fused(spec)
    out.append(("fused_exchange", fst.fused_exchange_work(plan, spec, vec, word, m), boxes, steps))
    return out


def _box_of(work, steps):
    """The box each (group, side) of ``work`` moves: a group's first side is
    the box of its step; a paired segment's second side the box whose step
    is the opposite one."""
    return lambda g, side: steps.index(tuple(-v for v in work.steps[g]) if side
                                       else work.steps[g])


def _unit_words(row, sz, sy):
    """``(side, k, src words, dst words)`` of each side of a work-list row
    that moves units: ``k`` the units' indices in a row, the words as
    offsets in the blocks (flat, one entry per word)."""
    _g, src, dst, split, src2, dst2, end, units, width, ey, rows, _c, _s, _n = row
    r = np.arange(rows, dtype=np.int64)
    base = (r // ey) * sz + (r % ey) * sy
    k = np.arange(units, dtype=np.int64)
    out = []
    for side, ks, x, s0, d0 in ((0, k[k < split], k[k < split] * width, src, dst),
                                (1, k[(k >= split) & (k < end)],
                                 (k[(k >= split) & (k < end)] - split) * width, src2, dst2)):
        if len(ks):
            words = (x[:, None] + np.arange(width)).ravel()
            off = (base[:, None] + words[None, :]).ravel()
            out.append((side, ks, s0 + off, d0 + off))
    return out


def _box_words(box, sz, sy):
    src, dst, shape = box
    z, y, x = np.meshgrid(*(np.arange(n, dtype=np.int64) for n in shape), indexing="ij")
    rel = (z * sz + y * sy + x).ravel()
    return src[0] * sz + src[1] * sy + src[2] + rel, dst[0] * sz + dst[1] * sy + dst[2] + rel


@pytest.mark.parametrize("name,size,dim,radius,aligned,dtype", CASES, ids=IDS)
def test_work_lists_cover_every_cell_once(name, size, dim, radius, aligned, dtype):
    """B6's work list writes every cell of each phase's two halo slabs once
    (over the full padded extent of the other axes) and B7's every cell of
    every direction box once, each read from the source cell its box pairs
    it with; the tasks are the units in chunks of a task, over every
    instance of a group."""
    spec, sz, sy, word, vec = _case(size, dim, radius, aligned, dtype)
    m, task = 3, rmv.move_shape()["task_units"]
    for label, work, boxes, steps in _works(spec, word, vec, m):
        box_of = _box_of(work, steps)
        got = {b: ([], []) for b in range(len(boxes))}
        start = 0
        for row in work.rows:
            assert len(row) == rmv.MOVE_COLS
            assert row[11] == -(-row[10] * row[7] // task) and row[12] == start, label
            start += m * row[11]
            for side, _k, s, d in _unit_words(row, sz, sy):
                got[box_of(row[0], side)][0].append(s)
                got[box_of(row[0], side)][1].append(d)
        assert work.tasks == start
        for b, box in enumerate(boxes):
            want_s, want_d = _box_words(box, sz, sy)
            s, d = np.concatenate(got[b][0]), np.concatenate(got[b][1])
            order, want = np.argsort(d), np.argsort(want_d)
            np.testing.assert_array_equal(d[order], want_d[want], err_msg=f"{label} box {b}")
            np.testing.assert_array_equal(s[order], want_s[want], err_msg=f"{label} box {b}")


@pytest.mark.parametrize("name,size,dim,radius,aligned,dtype", CASES, ids=IDS)
def test_vectors_only_where_source_and_destination_agree_in_phase(name, size, dim, radius,
                                                                  aligned, dtype):
    """A unit wider than a word is one 16-byte vector, in a run segment,
    only where vectors are allowed (the strides on the 16-byte grid), with
    source and destination on the grid at every unit of every row; B6's y
    and z phases and B7's y and z faces move vectors wherever they may."""
    spec, sz, sy, word, vec = _case(size, dim, radius, aligned, dtype)
    vw = rmv.VECTOR_BYTES // word
    for label, work, _boxes, _steps in _works(spec, word, vec):
        wide = 0
        for row in work.rows:
            _g, src, dst, split, _s2, _d2, end, units, width, _ey, _rows, _c, _st, _n = row
            if width == 1:
                continue
            wide += 1
            assert vec and width == vw and split == end == units, label
            for _side, k, s, d in _unit_words(row, sz, sy):
                assert (s[::width] % vw == 0).all() and (d[::width] % vw == 0).all(), label
        if label[-1] in "yz" or (label == "fused_exchange" and vec):
            runs_long = spec.padded().x >= 2 * vw if label[-1] in "yz" else spec.base.x >= 2 * vw
            assert (wide > 0) == (vec and runs_long), label
        if label.endswith("x"):
            assert wide == 0, label


@pytest.mark.parametrize("name,size,dim,radius,aligned,dtype", CASES, ids=IDS)
def test_paired_row_ends_share_one_warp_instruction(name, size, dim, radius, aligned, dtype):
    """B6's x phase and B7's x faces are one paired segment when both sides
    have a radius: each row's first-message units (b's hi row end, read
    from b and written into its forward neighbour) and then the partner's
    (the forward neighbour's lo row end, read there and written into b) on
    adjacent units that lie in one warp instruction (one 32-unit window of
    the task's index space: a task is whole warps); with one side's radius
    0 the lone x message is a run segment of one-word units."""
    spec, sz, sy, word, vec = _case(size, dim, radius, aligned, dtype)
    rm, rp = spec.radius.x(-1), spec.radius.x(1)
    assert rmv.move_shape()["task_units"] % rmv.WARP == 0
    assert rmv.MOVE_THREADS % rmv.WARP == 0
    for label, work, _boxes, steps in _works(spec, word, vec):
        if label not in ("remote_axis x", "fused_exchange"):
            continue
        paired = [row for row in work.rows if row[3] < row[6]]
        assert len(paired) == (1 if rm and rp else 0), label
        for row in paired:
            g, src, dst, split, src2, dst2, end, units, width = row[:9]
            assert (split, end, width) == (rm, rm + rp, 1)
            assert work.steps[g] == (1, 0, 0)
            assert units == rmv.row_lanes(end) and rmv.WARP % units == 0
            rows = np.arange(row[10], dtype=np.int64)
            first, last = rows * units, rows * units + end - 1
            assert (first // rmv.WARP == last // rmv.WARP).all(), label
            # b's hi row end is read and then b's hi halo beside it written;
            # the neighbour's lo halo written and its lo row end read beside it
            o, n = spec.compute_offset().x, spec.base.x
            assert (src % sy, dst2 % sy) == (o + n - rm, o + n), label
            assert (dst % sy, src2 % sy) == (o - rm, o), label
        if not (rm and rp):
            lone = [row for row in work.rows if work.steps[row[0]][0] != 0
                    and all(v == 0 for v in work.steps[row[0]][1:])]
            assert len(lone) == 1 and lone[0][8] == 1, label


def launch_wire(code, fmt):
    """The wire format name a launch's code and parameters (``fmt``, the
    ``halo_fill.wire_params`` doubles) select, None for code 0."""
    if code == 0:
        return None
    for f in halo_fill.WIRE_FORMATS.values():
        if f.code == code and (code != halo_fill.SOFT_WIRE or np.array_equal(
                np.array(list(fmt)), np.array(list(halo_fill.wire_params(f))), equal_nan=True)):
            return f.name
    raise AssertionError(f"no wire format of code {code} and parameters {list(fmt)}")


def replay_tables(blocks, ptr_rows, m, seg_rows, tasks, sz, sy, wire=None):
    """csrc/row_moves.cuh's kernel in plain torch indexing, one block a task,
    as it reads its tables: the segment by the starts, the chunk and the
    instance (chunk-major), each unit's row, side and words, a segment
    flagged narrow through ``wire`` (``halo_fill.wire_round``, the plain
    version of csrc/wire_round.cuh) unless bit 0 of the instance's sender
    pointer marks it local; ``blocks`` maps a pointer to its CPU block. In
    place."""
    task = rmv.move_shape()["task_units"]
    starts = [row[12] for row in seg_rows]
    assert starts == sorted(starts) and starts[0] == 0
    assert tasks == starts[-1] + m * seg_rows[-1][11]
    for t in range(tasks):
        row = seg_rows[bisect.bisect_right(starts, t) - 1]
        g, src, dst, split, src2, dst2, end, units, width, ey, rows, chunks, start, narrow = row
        c, j = divmod(t - start, m)
        assert c < chunks
        sender = ptr_rows[2 * (g * m + j)]
        narrow = narrow and not sender & 1
        p, q = blocks[sender & ~1], blocks[ptr_rows[2 * (g * m + j) + 1]]
        i = np.arange(c * task, min((c + 1) * task, rows * units), dtype=np.int64)
        r, k = np.divmod(i, units)
        base = (r // ey) * sz + (r % ey) * sy
        for side, keep, x, s0, d0, a, b in (
                (0, k < split, k * width, src, dst, p, q),
                (1, (k >= split) & (k < end), (k - split) * width, src2, dst2, q, p)):
            if keep.any():
                off = (base[keep] + x[keep])[:, None] + np.arange(width)
                words = a.view(-1)[torch.from_numpy((s0 + off).ravel())]
                b.view(-1)[torch.from_numpy((d0 + off).ravel())] = \
                    halo_fill.wire_round(words, wire) if narrow else words


def _pointer_rows(blocks, mesh, steps):
    """The pointer table as row_moves.launch_moves lays it out."""
    out = []
    for step in steps:
        dests = mesh.destinations(step)
        for i, group in enumerate(blocks):
            for q, b in enumerate(group):
                out += [b.data_ptr(), blocks[dests[i]][q].data_ptr()]
    return out


def _rand_groups(spec, nq, dtype, seed):
    rng = np.random.RandomState(seed)
    p = spec.padded()
    return [[torch.from_numpy(rng.rand(1, 1, 1, p.z, p.y, p.x).astype(dtype)) for _ in range(nq)]
            for _ in range(spec.num_blocks())]


@pytest.mark.parametrize("nq", [1, 3], ids=["1q", "3q"])
@pytest.mark.parametrize("name,size,dim,radius,aligned,dtype", CASES, ids=IDS)
def test_replay_equals_the_plain_versions(name, size, dim, radius, aligned, dtype, nq):
    """Every phase's work list (B6) and the fused one (B7), replayed as the
    kernel reads its tables over random blocks (noise in every halo and
    pad), equal remote_axis_plain and fused_exchange_plain on every cell,
    bit for bit; with one quantity and with three (the instances of a
    group: position-major, then quantity)."""
    spec, sz, sy, word, vec = _case(size, dim, radius, aligned, dtype)
    mesh = DeviceMesh(dim, ["cpu"] * spec.num_blocks())
    m = len(mesh) * nq
    plan, _boxes, _steps = _fused(spec)
    jobs = [(f"remote_axis {ph.axis}", rdma.remote_axis_work(spec, ph.axis, vec, word, m),
             lambda st, ph=ph: rdma.remote_axis_plain(st, spec, ph, mesh)) for ph in _phases(spec)]
    jobs.append(("fused_exchange", fst.fused_exchange_work(plan, spec, vec, word, m),
                 lambda st: fst.fused_exchange_plain(st, spec, plan, mesh)))
    for n, (label, work, plain) in enumerate(jobs):
        got = _rand_groups(spec, nq, dtype, 50 + n)
        want = plain([[b.clone() for b in g] for g in got])
        replay_tables({b.data_ptr(): b for g in got for b in g},
                      _pointer_rows(got, mesh, work.steps), m, work.rows, work.tasks, sz, sy)
        for ga, gb in zip(got, want):
            for a, b in zip(ga, gb):
                assert torch.equal(a, b), label


def _message_rows_before(boxes, sz, sy, vec):
    """B8's phase-A work list as message_rows laid it out before the carriers
    shared it (fp32, no pairs): the reference its output must keep."""
    segs = []
    for b, (src, dst, (ez, ey, ex)) in enumerate(boxes):
        s0 = src[0] * sz + src[1] * sy + src[2]
        d0 = dst[0] * sz + dst[1] * sy + dst[2]
        parts = [(0, ex, 1)]
        head = -s0 % 4
        if vec and (s0 - d0) % 4 == 0 and ex - head >= 4:
            nv = (ex - head) // 4
            parts = [(0, head, 1), (head, nv, 4), (head + 4 * nv, ex - head - 4 * nv, 1)]
        segs += [(b, s0 + x, d0 + x, units, width, ey, ez * ey)
                 for x, units, width in parts if units]
    return segs


@pytest.mark.parametrize("size,dim,r,aligned", [
    ((512,) * 3, (1, 1, 1), 1, True), ((33, 21, 13), (1, 1, 1), 2, True),
    ((200, 100, 61), (1, 1, 1), 3, False), ((24, 20, 16), (2, 2, 2), 1, True),
    ((24, 20, 16), (2, 2, 2), 1, False)], ids=["512-r1", "33x21x13-r2", "200x100x61-r3-un",
                                               "24x20x16-222", "24x20x16-222-un"])
def test_message_rows_for_the_fused_step_is_unchanged(size, dim, r, aligned):
    """The fused step's call (fp32, no pairs) lays out the same segments as
    before, with no partner, and row_table the same rows."""
    spec = GridSpec(Dim3(*size), Dim3(*dim), Radius.constant(r), aligned=aligned)
    plan = build_plan(spec, dim, Method.REMOTE_DMA, fused=True)
    boxes = tuple((ph.src, ph.dst, ph.shape) for ph in plan.fused_phases)
    p = spec.padded()
    sz, sy = p.y * p.x, p.x
    vec = sz % 4 == 0 and sy % 4 == 0
    segs = fst.message_rows(boxes, sz, sy, vec)
    assert [(s.box, s.src, s.dst, s.units, s.width, s.ey, s.rows) for s in segs] == \
        _message_rows_before(boxes, sz, sy, vec)
    assert all(s.partner == -1 for s in segs)
    rows, _tasks = fst.row_table(boxes, sz, sy, vec, spec.num_blocks())
    assert [row[:7] for row in rows] == _message_rows_before(boxes, sz, sy, vec)


@pytest.mark.parametrize("name,size,dim,radius,aligned,dtype", CASES, ids=IDS)
def test_sector_floors(name, size, dim, radius, aligned, dtype):
    """The sector floors count the 32-byte sectors of a block's sources once
    and of its destinations once: B6's phase equals B4's fill of the same
    axis on aligned rows (the same slabs on each block), and both carriers'
    equal a count of the sectors word by word."""
    spec, sz, sy, word, _vec = _case(size, dim, radius, aligned, dtype)
    npos = spec.num_blocks()
    for ph in _phases(spec):
        got = rdma.remote_axis_sector_bytes(spec, ph, 2, npos, word)
        fill = 2 * npos * halo_fill.fill_sector_bytes(halo_fill.fill_layout(spec, ph.axis, word),
                                                      word)
        # the fill counts each row's sectors alone; rows of a few sectors
        # share their end sectors with the next row's start
        assert got == fill if aligned else got <= fill, ph.axis
        assert got >= rdma.remote_axis_bytes(spec, ph, 2, npos, word)
    plan, boxes, _steps = _fused(spec)
    for bx in (boxes, [b for ph in _phases(spec) for b in _slab_boxes(spec, ph.axis)[0]]):
        words = [np.concatenate(w) for w in zip(*(_box_words(b, sz, sy) for b in bx))]
        want = sum(len(np.unique(w * word // rmv.SECTOR_BYTES)) for w in words)
        assert rmv.sector_bytes(bx, sz, sy, word) == want * rmv.SECTOR_BYTES
    assert fst.fused_exchange_sector_bytes(plan, spec, 1, 1, word) == \
        rmv.sector_bytes(boxes, sz, sy, word)


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_constants_mirror_the_kernel_source():
    """THREADS, UNROLL and COLS, the table row's fields in the order
    move_work writes them, the grid of one block a task with the tasks
    chunk-major, and both carriers launching the shared body."""
    assert rmv.MOVE_THREADS == _const(HEADER, "THREADS")
    assert rmv.MOVE_UNROLL == _const(HEADER, "UNROLL")
    assert rmv.MOVE_COLS == _const(HEADER, "COLS")
    assert re.search(r"constexpr int TASK = THREADS \* UNROLL;", HEADER)
    fields = re.search(r"struct Seg \{\s*long long ([^;]+);", HEADER).group(1)
    assert [f.strip() for f in fields.split(",")] == [
        "group", "src", "dst", "split", "src2", "dst2", "end", "units", "width", "ey", "rows",
        "chunks", "start", "narrow"]
    assert "const long long t = blockIdx.x;" in HEADER
    assert "const long long c = k / m, j = k - c * m;" in HEADER
    # one launch site for every instantiation: fp32 words through each wire
    # but fp32, fp64 words through each
    assert HEADER.count("cudaLaunchKernel(kernel, dim3((unsigned)tasks), dim3(THREADS)") == 1
    assert HEADER.count("move_rows_kernel<T, wire::") == 6
    assert HEADER.count("move_rows_kernel<U, wire::") == 7
    assert "move_rows_kernel<T, wire::F32>" not in HEADER
    assert "if (narrow) v[u] = wire::narrow_unit<T, WIRE>(v[u], f);" in HEADER
    # the local mark: bit 0 of the sender pointer, read and cleared only
    # where a wire is compiled in
    assert "narrow = s.narrow && !(p & 1ull);" in HEADER and "p &= ~1ull;" in HEADER
    for name in ("remote_axis", "fused_exchange"):
        src = (CSRC / f"{name}.cu").read_text()
        assert '#include "row_moves.cuh"' in src
        assert "return row_moves::launch(ptrs, m, segs, nseg, tasks, elem_size, wire, fmt, sz, " \
            "sy, stream);" in src
    wire_src = (CSRC / "wire_round.cuh").read_text()
    tag = {"bfloat16": "BF16", "float16": "F16", "float8_e4m3fn": "E4M3", "float32": "F32",
           "float8_e5m2": "E5M2"}
    for fmt in halo_fill.WIRE_FORMATS.values():
        assert f"constexpr int {tag.get(fmt.name, 'SOFT')} = {fmt.code};" in wire_src
    # the launch's format parameters, in wire_params' order
    order = re.search(r"static Format from\(const double\* p\) \{(.*?)\n  \}", wire_src,
                      re.S).group(1)
    fields = re.findall(r"f\.(\w+) = [^;]*p\[(\d)\]", order)
    assert [int(i) for _f, i in fields] == list(range(halo_fill.WIRE_PARAMS))
    assert [f for f, _i in fields] == ["mant", "emin", "top", "over", "nan_out", "least",
                                       "signed_zero", "exp_only"]


@pytest.mark.parametrize("units,lanes", [(1, 1), (2, 2), (3, 4), (5, 8), (6, 8), (8, 8),
                                         (12, 16), (17, 32), (32, 32), (40, 40)])
def test_row_lanes(units, lanes):
    assert rmv.row_lanes(units) == lanes


# -- the narrowed wire ------------------------------------------------------------------

WIRE_CASES = [c for c in CASES if c[0] in ("222-r1-f32", "112-r1-f64", "211-r2-f32-ragged",
                                           "211-r1-f64-ragged-unaligned", "222-asym-x0-f32")]
WIRE_IDS = [c[0] for c in WIRE_CASES]


@pytest.mark.parametrize("name,size,dim,radius,aligned,dtype", WIRE_CASES, ids=WIRE_IDS)
def test_narrow_flags_mark_the_crossing_segments(name, size, dim, radius, aligned, dtype):
    """With a wire, B6's work list flags every segment (a ring phase's slabs
    all cross) and B7's the segments of exactly the crossing direction
    boxes, the paired x faces' one flag both halves'; without one, none;
    the rows are otherwise those of the unnarrowed list."""
    spec, sz, sy, word, vec = _case(size, dim, radius, aligned, dtype)
    for ph in _phases(spec):
        plain = rdma.remote_axis_work(spec, ph.axis, vec, word, 3)
        wired = rdma.remote_axis_work(spec, ph.axis, vec, word, 3, narrow=True)
        assert [r[13] for r in plain.rows] == [0] * len(plain.rows)
        assert [r[13] for r in wired.rows] == [1] * len(wired.rows)
        assert [r[:13] for r in wired.rows] == [r[:13] for r in plain.rows]
    plan, _boxes, steps = _fused(spec)
    wired = fst.fused_exchange_work(plan, spec, vec, word, 3, narrow=True)
    plain = fst.fused_exchange_work(plan, spec, vec, word, 3)
    assert [r[:13] for r in wired.rows] == [r[:13] for r in plain.rows]
    assert not any(r[13] for r in plain.rows)
    box_of = _box_of(wired, steps)
    for row in wired.rows:
        for side, *_rest in _unit_words(row, sz, sy):
            assert row[13] == plan.fused_phases[box_of(row[0], side)].crossing, name
    crossing = {ph.direction for ph in plan.fused_phases if ph.crossing}
    assert crossing == {ph.direction for ph in plan.fused_phases
                        if any(c and n > 1 for c, n in zip(ph.direction, dim))}
    assert any(r[13] for r in wired.rows)
    if dim.count(1) > 0:  # a self-wrap axis: some boxes stay bit copies
        assert not all(r[13] for r in wired.rows)


def test_paired_boxes_share_their_narrow_flag():
    spec, sz, sy, word, vec = _case(*CASES[0][1:])
    boxes, steps, pairs = _slab_boxes(spec, "x")
    with pytest.raises(ValueError, match="share their narrow flag"):
        rmv.move_work(boxes, steps, sz, sy, vec, word, pairs, 1, (True, False))
    with pytest.raises(ValueError, match="narrow flags"):
        rmv.move_work(boxes, steps, sz, sy, vec, word, pairs, 1, (True,))


@pytest.mark.parametrize("wire", ["bfloat16", "float8_e4m3fn", "float16", "float32",
                                  "float8_e5m2", "float8_e3m4", "float8_e8m0fnu"])
@pytest.mark.parametrize("name,size,dim,radius,aligned,dtype", WIRE_CASES[:3], ids=WIRE_IDS[:3])
def test_replay_with_a_wire_equals_the_plain_versions(name, size, dim, radius, aligned, dtype,
                                                      wire):
    """Every phase's work list and the fused one with the wire's flags,
    replayed with each flagged word through the wire, equal
    remote_axis_plain and fused_exchange_plain with that wire on every cell
    (NaN equal to NaN: fp8 overflows to NaN); an fp32 wire on fp32 data
    flags nothing and copies bits."""
    spec, sz, sy, word, vec = _case(size, dim, radius, aligned, dtype)
    mesh = DeviceMesh(dim, ["cpu"] * spec.num_blocks())
    m = len(mesh) * 2
    narrow = halo_fill.wire_format(torch.from_numpy(np.zeros(1, dtype)).dtype, wire) is not None
    plan, _boxes, _steps = _fused(spec)
    jobs = [(rdma.remote_axis_work(spec, ph.axis, vec, word, m, narrow),
             lambda st, ph=ph: rdma.remote_axis_plain(st, spec, ph, mesh, wire))
            for ph in _phases(spec)]
    jobs.append((fst.fused_exchange_work(plan, spec, vec, word, m, narrow),
                 lambda st: fst.fused_exchange_plain(st, spec, plan, mesh, wire)))
    rng = np.random.RandomState(70)
    p = spec.padded()
    for work, plain in jobs:
        got = [[torch.from_numpy((rng.standard_normal((1, 1, 1, p.z, p.y, p.x))
                                  * 2.0 ** rng.uniform(-12, 9, (1, 1, 1, p.z, p.y, p.x)))
                                 .astype(dtype)) for _ in range(2)]
               for _ in range(spec.num_blocks())]
        want = plain([[b.clone() for b in g] for g in got])
        replay_tables({b.data_ptr(): b for g in got for b in g},
                      _pointer_rows(got, mesh, work.steps), m, work.rows, work.tasks, sz, sy,
                      wire)
        for ga, gb in zip(got, want):
            for a, b in zip(ga, gb):
                np.testing.assert_array_equal(a.numpy(), b.numpy())


# -- B6 over resident blocks: every block an endpoint ---------------------------------------

class EndpointCard:
    """Stands in for the card in remote_axis's CUDA branch: the tables it
    uploads are kept, and each launch is replayed (``replay_tables``) on the
    CPU views its pointer rows name, so a resident block, a view into its
    stack, is an endpoint like a position's block. ``calls`` keeps each
    launch's instance count, ``marks`` its sender rows' local marks and
    ``wires`` its wire format's name."""

    type, index = "cuda", 0

    def __init__(self, monkeypatch, stacks, spec):
        p = spec.padded()
        self.blocks = {v.data_ptr(): v for t in stacks
                       for v in t.reshape(-1, p.z, p.y, p.x).unbind(0)}
        self.tables, self.calls, self.marks, self.wires = {}, [], [], []
        monkeypatch.setattr(rdma, "_check_mesh_blocks", lambda *a: self)
        monkeypatch.setattr(rdma._native, "kept", lambda key, make: make())
        monkeypatch.setattr(rdma._native, "upload", self.upload)
        monkeypatch.setattr(rdma._native, "stream_ptr", lambda dev: 0)
        monkeypatch.setattr(rdma._native, "lib", lambda name: self)

    def upload(self, values, device):
        t = torch.tensor(values, dtype=torch.int64)
        self.tables[t.data_ptr()] = t.tolist()
        return t

    def remote_axis_launch(self, ptrs, m, segs, nseg, tasks, word, code, fmt, sz, sy,
                           _stream):
        table = self.tables[ptrs]
        head = (segs - ptrs) // 8
        rows = [table[i:i + rmv.MOVE_COLS] for i in range(head, len(table), rmv.MOVE_COLS)]
        assert len(rows) == nseg
        # every pointer a block's start, a sender's with its local mark
        assert {p & ~1 for p in table[:head]} <= set(self.blocks)
        self.calls.append(m)
        self.marks.append([p & 1 for p in table[:head:2]])
        self.wires.append(launch_wire(code, fmt))
        replay_tables(self.blocks, table[:head], m, rows, tasks, sz, sy, self.wires[-1])
        return 0


@pytest.mark.parametrize("dim,nq", [((2, 2, 2), 1), ((2, 1, 2), 3), ((1, 3, 1), 2)],
                         ids=["222-1q", "212-3q", "131-2q"])
def test_resident_endpoint_tables_replay_to_the_plain_version(monkeypatch, dim, nq):
    """REMOTE_DMA over the resident blocks of one device on the card: one
    launch a ring phase (the partition's axes with several blocks), its
    pointer rows the blocks' own starts inside the stack (B6's table over
    the block mesh), replayed as the kernel reads it, equal to the CPU's
    exchange on every cell; an axis with one block is a fill."""
    spec = GridSpec(Dim3(12, 18, 16), Dim3(*dim), Radius.constant(2))
    rng = np.random.RandomState(60 + nq)
    want = {q: torch.from_numpy(rng.rand(*spec.stacked_shape_zyx()).astype(np.float32))
            for q in range(nq)}
    got = {q: t.clone() for q, t in want.items()}
    HaloExchange(spec, Method.REMOTE_DMA)(want)
    card = EndpointCard(monkeypatch, list(got.values()), spec)
    before = rdma.remote_axis.launches
    HaloExchange(spec, Method.REMOTE_DMA)(got)
    rings = sum(1 for n in dim if n > 1)
    assert rdma.remote_axis.launches - before == rings == len(card.calls)
    assert card.calls == [spec.num_blocks() * nq] * rings
    for q in want:
        assert torch.equal(got[q], want[q])


# -- the wire on an oversubscribed mesh: narrowing per block and direction ---------------

# (partition, mesh): every axis crossing; x with a ring of one position but
# two residents; an uneven-free mix of 1, 2 and 3 residents a position
OVERSUB = [((4, 2, 2), (2, 2, 2)), ((2, 2, 2), (1, 2, 2)), ((3, 2, 4), (1, 2, 2)),
           ((2, 4, 1), (2, 2, 1))]
OVERSUB_IDS = ["422-on-222", "222-on-122", "324-on-122", "241-on-221"]


@pytest.mark.parametrize("part,mesh_dim", OVERSUB, ids=OVERSUB_IDS)
def test_local_marks_follow_the_partition(part, mesh_dim):
    """remote_axis_local marks a sender block's message along each step
    local exactly where the block and its ring neighbour sit on one
    position (``parallel.exchange.position_blocks``): never with one block
    a position, always on an axis whose positions' ring is 1."""
    from stencil_tpu_torch.parallel.exchange import position_blocks, position_resident

    spec = GridSpec(Dim3(*(4 * n for n in part)), Dim3(*part), Radius.constant(1))
    mesh = DeviceMesh(mesh_dim, ["cpu"] * Dim3(*mesh_dim).flatten())
    res = position_resident(spec, mesh)
    where = [i for i, _j in position_blocks(spec, mesh)]
    blocks = DeviceMesh(part, ["cpu"] * spec.num_blocks())
    for k, axis in enumerate("xyz"):
        marks = dict(rdma.remote_axis_local(axis, spec.dim, res))
        for sign in (1, -1):
            step = tuple(sign if a == k else 0 for a in range(3))
            dests = blocks.destinations(step)
            assert marks[step] == tuple(where[i] == where[d] for i, d in enumerate(dests))
        if mesh.ring(axis) == 1:
            assert all(all(f) for f in marks.values())
        elif (res.x, res.y, res.z)[k] == 1:
            assert not any(any(f) for f in marks.values())
    one = dict(rdma.remote_axis_local("x", Dim3(2, 2, 2), Dim3(1, 1, 1)))
    assert not any(any(f) for f in one.values())


@pytest.mark.parametrize("wire", ["bfloat16", "float8_e5m2", "float4_e2m1fn"])
@pytest.mark.parametrize("part,mesh_dim", OVERSUB[:3], ids=OVERSUB_IDS[:3])
def test_oversubscribed_wire_tables_replay_to_the_plain_version(monkeypatch, part, mesh_dim,
                                                                wire):
    """An oversubscribed mesh with a wire on the card: one launch a ring
    phase over every block, each sender row marked local where its message
    stays on its position (remote_axis_local), a phase whose messages all
    stay launched unnarrowed (and not counted in ``narrowed``); replayed as
    the kernel reads it, equal to the CPU's exchange with the wire on every
    cell, fp32 and fp64 quantities, which rounds only the slabs between
    positions."""
    from stencil_tpu_torch.parallel.exchange import position_resident, split_positions

    spec = GridSpec(Dim3(*(4 * n for n in part)), Dim3(*part), Radius.constant(2))
    mesh = DeviceMesh(mesh_dim, ["cpu"] * Dim3(*mesh_dim).flatten())
    rng = np.random.RandomState(90)
    shape = spec.stacked_shape_zyx()
    g = {q: torch.from_numpy((rng.standard_normal(shape) * 2.0 ** rng.uniform(-12, 9, shape))
                             .astype(dt)) for q, dt in enumerate((F32, F64))}
    want, got, native = ({q: split_positions(t, spec, mesh) for q, t in g.items()}
                         for _ in range(3))
    HaloExchange(spec, Method.REMOTE_DMA, mesh=mesh, wire_dtype=wire)(want)
    HaloExchange(spec, Method.REMOTE_DMA, mesh=mesh)(native)
    card = EndpointCard(monkeypatch, [b for bl in got.values() for b in bl], spec)
    launches, narrowed = rdma.remote_axis.launches, rdma.remote_axis.narrowed
    HaloExchange(spec, Method.REMOTE_DMA, mesh=mesh, wire_dtype=wire)(got)
    res = position_resident(spec, mesh)
    rings = [a for a, n in zip("xyz", part) if n > 1]
    crossing = [a for a in rings if mesh.ring(a) > 1]
    assert rdma.remote_axis.launches - launches == 2 * len(rings) == len(card.calls)
    assert rdma.remote_axis.narrowed - narrowed == 2 * len(crossing)
    for i, axis in enumerate(a for a in rings for _dt in (F32, F64)):
        local = dict(rdma.remote_axis_local(axis, spec.dim, res))
        steps = [s for s in local if axis != "x" or sum(s) > 0]  # x: one paired group
        if axis in crossing:
            assert card.wires[i] == wire
            assert card.marks[i] == [int(f) for st in steps for f in local[st]]
        else:
            assert card.wires[i] is None and not any(card.marks[i])
    for q in want:
        for a, b in zip(got[q], want[q]):
            assert torch.equal(a, b), q
    # and the wire did round what crossed
    assert not all(torch.equal(a, b) for q in want for a, b in zip(want[q], native[q]))
