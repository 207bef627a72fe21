"""The fused and persistent variants over several processes (B7, B8 and B9
in their cross-process forms): jacobi3d's fused and persistent loops under
``apps/launch_multiprocess`` (2 processes x 4 CPU positions over gloo, and
the uneven (3,2,1) over 2 x 3) against the JAX package on its 8 virtual
CPU devices, bit for bit; and, with no spawn, the tables each rank's launch
builds on the card, replayed on the CPU as the kernels read them, against
the kernels' plain versions in four layouts of ranks (2 x 4,
8 x 1, 2 x 3 and a scattered (3,2,2)); the ranks each rank's handshake
holds; the order of handshakes and launches in a step and a chunk (a
recording stand-in for the events); and ``sel``'s export through
``parallel/ipc.PeerBuffers.add``. One spawn, torch at one thread, under a
time limit. Inputs are random numpy fields from a seed. Tolerance:
bit-exact."""

import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

import stencil_tpu.apps.jacobi3d as japp
import stencil_tpu.parallel as jpar
from stencil_tpu_torch.domain import GridSpec
from stencil_tpu_torch.geometry import DIRECTIONS_26, Dim3, Radius
from stencil_tpu_torch.ops import fused_stencil as tfused
from stencil_tpu_torch.ops import persistent_stencil as tpers
from stencil_tpu_torch.ops import remote_dma as rdma
from stencil_tpu_torch.ops.jacobi import sphere_sel_blocks
from stencil_tpu_torch.ops.stencil_kernels import sweep_plain
from stencil_tpu_torch.parallel import HaloExchange, Method, distributed, ipc
from stencil_tpu_torch.parallel.mesh import DeviceMesh
from stencil_tpu_torch.plan.ir import build_plan

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SPAWN_TIMEOUT = 300
RDMA_J = jpar.Method.REMOTE_DMA

# jacobi3d under the launcher: (run keyword arguments, JAX devices)
RUNS = {
    "fused": (dict(x=32, y=32, z=32, iters=4, chunk=2, kernel_variant="fused"), 8),
    "persistent": (dict(x=32, y=32, z=32, iters=5, chunk=2, kernel_variant="persistent",
                        deep_halo=2), 8),
    "uneven-fused": (dict(x=25, y=25, z=25, iters=4, chunk=2, kernel_variant="fused",
                          partition=(3, 2, 1)), 6),
    "uneven-persistent": (dict(x=25, y=25, z=25, iters=5, chunk=2, kernel_variant="persistent",
                               deep_halo=2, partition=(3, 2, 1)), 6),
}

# layouts of ranks: (partition, owner of each position, wire)
LAYOUTS = [((2, 2, 2), (0, 0, 0, 0, 1, 1, 1, 1), None),
           ((2, 2, 2), (0, 1, 2, 3, 4, 5, 6, 7), "bfloat16"),
           ((3, 2, 1), (0, 0, 0, 1, 1, 1), None),
           ((3, 2, 2), (0, 1, 0, 1, 0, 1, 1, 0, 1, 0, 1, 0), "bfloat16")]
LAYOUT_IDS = ["2x4", "8x1-bf16", "2x3", "scattered-bf16"]
STEPS = [(d.x, d.y, d.z) for d in DIRECTIONS_26]


# -- the worker (run by the launcher) ---------------------------------------------------

def worker_variants(out: str) -> None:
    import stencil_tpu_torch.apps.jacobi3d as tapp

    distributed.maybe_init_from_env()
    rank = distributed.process_index()
    fields, report = {}, {}
    for name, (kw, ndev) in RUNS.items():
        kw = dict(kw)
        devices = ["cpu"] * (ndev // 2) if ndev != 8 else None
        r = tapp.run(kw.pop("x"), kw.pop("y"), kw.pop("z"), method=Method.REMOTE_DMA,
                     weak=False, devices=devices, **kw)
        dd = r["domain"]
        field = dd.get_curr_global(r["handle"])
        report[name] = {"row": tapp.csv_row(r), "dim": list(dd.spec.dim),
                        "local": list(dd.mesh.local_positions()),
                        "launches_per_chunk": dd.halo_exchange.last_launches_per_chunk}
        if rank == 0:
            fields[name] = field
    if rank == 0:
        np.savez(os.path.join(out, "variants.npz"), **fields)
    with open(os.path.join(out, f"report_{rank}.json"), "w") as f:
        json.dump(report, f)


def _spawn(mode: str, out, timeout: float = SPAWN_TIMEOUT):
    """The launcher over 2 processes x 4 CPU positions running ``mode``;
    returns (rc, seconds, output)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    t0 = time.monotonic()
    p = subprocess.run([sys.executable, "-m", "stencil_tpu_torch.apps.launch_multiprocess",
                        "--cpu", "--timeout", str(timeout), "2", "4",
                        "test_torch_multiprocess_variants", mode, str(out)], cwd=HERE, env=env,
                       capture_output=True, text=True, timeout=timeout + 60)
    return p.returncode, time.monotonic() - t0, p.stdout + p.stderr


@pytest.fixture(scope="module")
def variants_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mp_variants")
    rc, _s, log = _spawn("variants", out)
    assert rc == 0, log[-4000:]
    reports = [json.load(open(out / f"report_{r}.json")) for r in range(2)]
    return reports, dict(np.load(out / "variants.npz"))


@pytest.mark.parametrize("name", list(RUNS))
def test_variants_under_the_launcher_match_jax(variants_run, name):
    """jacobi3d's fused and persistent loops over 2 ranks (x 4 positions,
    and the uneven (3,2,1) over 2 x 3: compared on compute regions, the
    gathered field), bit-equal to the JAX app's one-process run over as many
    virtual devices; the row and the launches a chunk as the JAX package
    counts them on the CPU."""
    reports, fields = variants_run
    kw, ndev = RUNS[name]
    kw = dict(kw)
    want = japp.run(kw.pop("x"), kw.pop("y"), kw.pop("z"), devices=jax.devices()[:ndev],
                    method=RDMA_J, weak=False, **kw)
    jdd = want["domain"]
    np.testing.assert_array_equal(fields[name], jdd.get_curr_global(want["handle"]))
    row = japp.csv_row(want).split(",")
    for rank, rep in enumerate(reports):
        got = rep[name]
        assert got["row"].split(",")[:8] == ["jacobi3d", "remote-dma", "2"] + row[3:8]
        assert got["dim"] == [jdd.spec.dim.x, jdd.spec.dim.y, jdd.spec.dim.z]
        assert got["local"] == list(range(rank * ndev // 2, (rank + 1) * ndev // 2))
        assert got["launches_per_chunk"] == jdd.halo_exchange.last_launches_per_chunk


# -- the card's tables, replayed -----------------------------------------------------------

class ReplayCard:
    """The card of the cross-process launches, replayed on the CPU: the
    tables each wrapper uploads read as the kernels read them, every
    pointer a CPU block's address (what a rank's own block or a neighbour's
    mapped one is on the card)."""

    def __init__(self, monkeypatch, blocks, spec=None):
        self.blocks = {b.data_ptr(): b for b in blocks}
        self.spec = spec
        self.tables, self.calls = {}, []
        native = tfused._native
        monkeypatch.setattr(native, "kept", lambda key, make: make())
        monkeypatch.setattr(native, "upload", self.upload)
        monkeypatch.setattr(native, "device_table", lambda key, rows, dev: self.upload(rows(), dev))
        monkeypatch.setattr(native, "stream_ptr", lambda dev: 0)
        monkeypatch.setattr(native, "lib", lambda name: self)

    def upload(self, values, device):
        t = torch.tensor(values, dtype=torch.int64)
        self.tables[t.data_ptr()] = t.tolist()
        return t

    def rows(self, pos, npos, nsweep):
        """The position table's rows as (a, b, sel) blocks; the rows after
        the swept ones name only a source's a."""
        vals = self.tables[pos]
        assert len(vals) == 3 * npos and 1 <= nsweep <= npos
        out = []
        for i in range(npos):
            a, b, s = vals[3 * i:3 * i + 3]
            if i >= nsweep:
                assert b == s == 0
                out.append((self.blocks[a], None, None))
            else:
                out.append((self.blocks[a], self.blocks[b], self.blocks[s]))
        return out

    def fused_exchange_launch(self, ptrs, m, segs, nseg, tasks, word, code, fmt, sz, sy, _st):
        from stencil_tpu_torch.ops import row_moves as rmv
        from test_torch_exchange_launch import launch_wire, replay_tables

        table = self.tables[ptrs]
        head = (segs - ptrs) // 8
        rows = [table[i:i + rmv.MOVE_COLS] for i in range(head, len(table), rmv.MOVE_COLS)]
        assert len(rows) == nseg
        self.calls.append(("b7", m, head // 2))
        replay_tables(self.blocks, table[:head], m, rows, tasks, sz, sy, launch_wire(code, fmt))
        return 0

    remote_axis_launch = fused_exchange_launch  # B6 reads the same tables

    def fused_jacobi_launch(self, pos, npos, nsweep, msg, m, segs, nseg, ncols, tasks, sz, sy, zo,
                            yo, xo, nz, ny, nx, vec, code, fmt, _dev, _stream):
        """Phase A's work list over the messages into the swept rows (their
        sources anywhere in the table), through the launch's wire; then
        one sweep of each swept row."""
        from test_torch_exchange_launch import launch_wire
        from stencil_tpu_torch.ops.halo_fill import wire_round

        p = self.rows(pos, npos, nsweep)
        flat, msgs = self.tables[segs], self.tables[msg]
        assert ncols == tfused.SEG_COLS and m == nsweep and len(msgs) == 3 * m * (len(msgs) // (3 * m))
        self.calls.append(("b8", npos, nsweep))
        wire = launch_wire(code, fmt)
        for i in range(nseg):
            box, src, dst, units, width, ey, nrows = flat[i * ncols:i * ncols + 7]
            narrow = flat[i * ncols + 9]
            r = np.arange(nrows, dtype=np.int64)
            base = (r // ey) * sz + (r % ey) * sy
            words = (np.arange(units)[:, None] * width + np.arange(width)).ravel()
            off = torch.from_numpy((base[:, None] + words[None, :]).ravel())
            for j in range(m):
                s, d, b = msgs[3 * (box * m + j):3 * (box * m + j) + 3]
                assert b == box and d == j
                got = p[s][0].view(-1)[src + off]
                p[d][0].view(-1)[dst + off] = wire_round(got, wire) if narrow else got
        bspec = self.spec.block_spec()
        assert (nz, ny, nx) == (bspec.base.z, bspec.base.y, bspec.base.x)
        for a, b, sel in p[:nsweep]:
            sweep_plain(a, b, sel, bspec, tfused.NO_WRAP)
        return 0

    def persistent_jacobi_launch(self, pos, npos, nsweep, msg, m, boxes, nboxes, ext, sz, sy, zo,
                                 yo, xo, nz, ny, nx, k, pass0, pass1, _dev, _stream):
        """The deep messages into the swept rows with pass 0 (uniform), then
        passes [pass0, pass1) of each swept row at its extent."""
        p = self.rows(pos, npos, nsweep)
        self.calls.append(("b9", npos, nsweep, pass0, pass1))
        if ext is None and pass0 == 0:
            rows = self.tables[msg]
            assert m == nsweep and len(rows) == 3 * m * nboxes
            for r in range(m * nboxes):
                src, dst, b = rows[3 * r:3 * r + 3]
                assert b == r // m and dst == r % m
                box = list(boxes[9 * b:9 * b + 9])
                s, d = tfused.box_slices(box[0:3], box[3:6], box[6:9])
                p[dst][0][d] = p[src][0][s]
        elif ext is not None:
            assert m == 0 and nsweep == npos
        extents = (self.tables[ext] if ext is not None else [nz, ny, nx] * nsweep)
        for i, (a, b, sel) in enumerate(p[:nsweep]):
            ez, ey, ex = extents[3 * i:3 * i + 3]
            tpers.make_persistent_chunk_body(self.spec.block_spec(), k, (ex, ey, ez),
                                             range(pass0, pass1))(a, b, sel)
        return 0


def _rank_meshes(monkeypatch, part, owners):
    """Each rank and its mesh of the layout (``process_index`` patched)."""
    positions = [distributed.Position(i, o, "h", "cpu") for i, o in enumerate(owners)]
    for rank in sorted(set(owners)):
        monkeypatch.setattr(distributed, "process_index", lambda rank=rank: rank)
        yield rank, DeviceMesh(part, positions)


def _blocks(spec, n, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    p = spec.padded()
    return [torch.from_numpy(rng.rand(1, 1, 1, p.z, p.y, p.x).astype(dtype)) for _ in range(n)]


def _sels(spec, n, seed):
    rng = np.random.RandomState(seed)
    p = spec.padded()
    return [torch.from_numpy(rng.randint(0, 3, (1, 1, 1, p.z, p.y, p.x)).astype(np.int32))
            for _ in range(n)]


def _cloned(blocks):
    return [None if b is None else ([t.clone() for t in b] if isinstance(b, list) else b.clone())
            for b in blocks]


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("part,owners,wire", LAYOUTS, ids=LAYOUT_IDS)
def test_fused_exchange_tables_replay_to_the_plain_version(monkeypatch, part, owners, wire):
    """B7's cross-process form as each rank launches it (its receivers'
    rows, the sources local or mapped, the x faces unpaired: one pointer
    group a box), replayed: all ranks' launches together equal
    fused_exchange_plain over every position, through the wire; each
    rank's launch equals fused_exchange_plain of its own
    receivers."""
    spec = GridSpec(Dim3(24, 20, 16), Dim3(*part), Radius.constant(1))
    plan = build_plan(spec, part, Method.REMOTE_DMA, fused=True)
    nq, n = 2, spec.num_blocks()
    flat = _blocks(spec, n * nq, 61)
    got = [flat[i * nq:(i + 1) * nq] for i in range(n)]
    want, each = _cloned(got), _cloned(got)
    tfused.fused_exchange_plain(want, spec, plan, DeviceMesh(part, ["cpu"] * n), wire)
    card = ReplayCard(monkeypatch, flat)
    for _rank, mesh in _rank_meshes(monkeypatch, part, owners):
        before = _cloned(got)
        tfused.fused_exchange_across(lambda i: tuple(b.data_ptr() for b in got[i]), nq,
                                     torch.float32, spec, plan, mesh, torch.device("cpu"), wire)
        m = len(mesh.local_positions()) * nq
        assert card.calls[-1] == ("b7", m, len(plan.fused_phases) * m)
        tfused.fused_exchange_plain(before, spec, plan, mesh, wire)
        for i in mesh.local_positions():
            each[i] = before[i]
    for g, w, e in zip(got, want, each):
        assert _same(g, w) and _same(g, e)


@pytest.mark.parametrize("part,owners,wire", LAYOUTS, ids=LAYOUT_IDS)
def test_fused_step_tables_replay_to_the_plain_version(monkeypatch, part, owners, wire):
    """B8's cross-process form: each rank's position table holds its own
    rows first (the swept count) and then the mapped rows of the positions
    its messages come from (read only); replayed over two steps through the
    swap, all ranks' launches equal fused_jacobi_mesh_plain over every
    position, and each rank's fused_jacobi_mesh_plain."""
    spec = GridSpec(Dim3(24, 20, 16), Dim3(*part), Radius.constant(1))
    plan = build_plan(spec, part, Method.REMOTE_DMA, fused=True)
    n = spec.num_blocks()
    c, nx, sel = _blocks(spec, n, 62), _blocks(spec, n, 63), _sels(spec, n, 64)
    wc, wn = _cloned(c), _cloned(nx)
    card = ReplayCard(monkeypatch, c + nx + sel, spec)
    one = DeviceMesh(part, ["cpu"] * n)
    for _step in range(2):
        tfused.fused_jacobi_mesh_plain(wc, wn, sel, spec, plan, one, wire)
        ec, en = _cloned(c), _cloned(nx)
        before = _cloned(c)
        for _rank, mesh in _rank_meshes(monkeypatch, part, owners):
            locs = mesh.local_positions()
            tfused.fused_jacobi_across(
                lambda i: ((c[i].data_ptr(), nx[i].data_ptr(), sel[i].data_ptr())
                           if mesh.is_local(i) else (c[i].data_ptr(), 0, 0)),
                spec, plan, mesh, torch.device("cpu"), wire)
            _tag, npos, nsweep = card.calls[-1]
            sources = {tfused._sources(mesh, r, ph.direction) for ph in plan.fused_phases
                       for r in locs}
            assert nsweep == len(locs) and npos == len(set(locs) | sources)
            mine_c, mine_n = _cloned(before), _cloned(nx)
            tfused.fused_jacobi_mesh_plain(mine_c, mine_n, sel, spec, plan, mesh, wire)
            for i in locs:
                ec[i], en[i] = mine_c[i], mine_n[i]
        assert _same(c, wc) and _same(nx, wn) and _same(c, ec) and _same(nx, en)
        c, nx, wc, wn = nx, c, wn, wc


@pytest.mark.parametrize("uneven", [False, True], ids=["uniform", "uneven"])
@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("part,owners,_wire", LAYOUTS, ids=LAYOUT_IDS)
def test_chunk_tables_replay_to_the_plain_version(monkeypatch, part, owners, _wire, k, uneven):
    """B9's cross-process form: a chunk of one pass (k = 2) is one launch a
    rank; of two (k = 8), every rank's launch of the messages and pass 0,
    then every rank's launch of pass 1 (the second handshake between).
    Replayed, all ranks' launches equal persistent_jacobi_mesh_plain over
    every position (on an uneven partition after the deep exchange, each
    position at its own extent), and each launch
    persistent_jacobi_mesh_plain of its passes."""
    size = (25, 21, 17) if uneven else (24, 20, 16)
    spec = GridSpec(Dim3(*size), Dim3(*part), Radius.constant(k))
    assert spec.is_uniform() != uneven
    n = spec.num_blocks()
    c, nx = _blocks(spec, n, 70 + k), _blocks(spec, n, 71 + k)
    sel = _sels(spec, n, 72 + k)
    one = DeviceMesh(part, ["cpu"] * n)
    if uneven:  # the caller's deep exchange (B6 across processes) fills curr's halos
        HaloExchange(spec, Method.REMOTE_DMA, mesh=one)(c)
    wc, wn = _cloned(c), _cloned(nx)
    tpers.persistent_jacobi_mesh_plain(wc, wn, sel, spec, k, one)
    card = ReplayCard(monkeypatch, c + nx + sel, spec)
    npass = len(tpers.chunk_passes(k))
    assert npass == (2 if k == 8 else 1)
    for passes in ([range(0, 1)] if npass == 1 else [range(0, 1), range(1, 2)]):
        ec, en = _cloned(c), _cloned(nx)
        before_c, before_n = _cloned(c), _cloned(nx)
        for _rank, mesh in _rank_meshes(monkeypatch, part, owners):
            locs = mesh.local_positions()
            tpers.persistent_jacobi_across(
                lambda i: ((c[i].data_ptr(), nx[i].data_ptr(), sel[i].data_ptr())
                           if mesh.is_local(i) else (c[i].data_ptr(), 0, 0)),
                spec, k, mesh, torch.device("cpu"), passes)
            assert card.calls[-1][2:] == (len(locs), passes.start, passes.stop)
            mine_c, mine_n = _cloned(before_c), _cloned(before_n)
            tpers.persistent_jacobi_mesh_plain(mine_c, mine_n, sel, spec, k, mesh, passes)
            for i in locs:
                ec[i], en[i] = mine_c[i], mine_n[i]
        assert _same(c, ec) and _same(nx, en)
    assert _same(c, wc) and _same(nx, wn)


# -- the handshake: with whom, and in what order ----------------------------------------

@pytest.mark.parametrize("part,owners,_wire", LAYOUTS, ids=LAYOUT_IDS)
def test_handshake_set_is_every_message_sources_owner(monkeypatch, part, owners, _wire):
    """A rank's set (``DeviceMesh.message_ranks`` of the 26 directions, what
    ``PeerBuffers`` gives ``PhaseOrder.everyone``) is the owners of every
    message's source and every message's receiver, other than itself:
    symmetric, and a superset of its ring neighbours on each axis. At 2 x 4
    on (2,2,2) the one other rank; at 8 x 1 all seven, where B6's axis
    phases meet three."""
    sets = {}
    for rank, mesh in _rank_meshes(monkeypatch, part, owners):
        got = mesh.message_ranks(STEPS)
        sources = {mesh.owner(tfused._sources(mesh, r, st)) for r in mesh.local_positions()
                   for st in STEPS} - {rank}
        assert set(got) == sources
        axes = {r for a in "xyz" for r in mesh.neighbour_ranks(a)}
        assert axes <= sources
        sets[rank] = set(got)
    for rank, got in sets.items():
        assert all(rank in sets[r] for r in got)
    if owners == LAYOUTS[0][1]:
        assert sets == {0: {1}, 1: {0}}
    if owners == LAYOUTS[1][1]:
        assert all(got == set(range(8)) - {r} for r, got in sets.items())


class _Recorder:
    def __init__(self, log):
        self.log = log

    def record(self):
        self.log.append(("record",))

    def wait(self, rank):
        self.log.append(("wait", rank))

    def exchange(self, ranks):
        self.log.append(("notify", tuple(ranks)))


class _Block:
    """A block as the cross-process steps see it on the card: its device,
    dtype and address."""

    device, dtype, is_cuda = torch.device("cuda", 0), torch.float32, True

    def __init__(self, addr):
        self.addr = addr

    def data_ptr(self):
        return self.addr


class _Peers:
    def __init__(self, order):
        self.order = order

    def buffer_of(self, stacks):
        return (0, 0)

    def pointer(self, i, q, b):
        return 1 << 20


def test_order_of_calls_in_a_step_and_a_chunk(monkeypatch):
    """On the card, with a recording stand-in for the events and notices:
    a fused step is record -> notify -> wait -> one launch; a chunk of one
    pass (k = 4) the same; a chunk of two passes (k = 8) the handshake and
    the launch of the messages and pass 0, then a second handshake and the
    launch of pass 1; the uneven form's chunk (after its deep exchange's own
    handshakes) a launch of pass 0, the second handshake, pass 1; and the
    uneven fused schedule's step a handshake before its sweep."""
    from stencil_tpu_torch.ops import jacobi as tjac

    log = []
    rec = _Recorder(log)
    peers = _Peers(ipc.PhaseOrder({"x": (), "y": (), "z": (1,)}, rec, rec, everyone=(1,)))
    positions = [distributed.Position(i, i // 4, "h", "cpu") for i in range(8)]
    monkeypatch.setattr(distributed, "process_index", lambda: 0)
    mesh = DeviceMesh((2, 2, 2), positions)
    blocks = [[_Block(4096 * (3 * i + j + 1)) if i < 4 else None for i in range(8)]
              for j in range(3)]
    monkeypatch.setattr(tfused, "fused_jacobi_across",
                        lambda *a, **kw: log.append(("launch", "step")))
    monkeypatch.setattr(tpers, "persistent_jacobi_across",
                        lambda ptrs_of, spec, k, mesh, dev, passes: log.append(
                            ("launch", tuple(passes))))
    handshake = [("record",), ("notify", (1,)), ("wait", 1)]
    spec = GridSpec(Dim3(16, 16, 16), Dim3(2, 2, 2), Radius.constant(1))
    plan = build_plan(spec, (2, 2, 2), Method.REMOTE_DMA, fused=True)
    tfused.fused_step_across(*blocks, spec, plan, mesh, None, peers)
    assert log == handshake + [("launch", "step")]
    for k, size in ((4, 16), (8, 32)):
        log.clear()
        spec = GridSpec(Dim3(size, size, size), Dim3(2, 2, 2), Radius.constant(k))
        issued = tpers.persistent_chunk_across(*blocks, spec, k, mesh, peers)
        want = handshake + [("launch", (0,))]
        if k == 8:
            want += handshake + [("launch", (1,))]
        assert log == want and issued == len(tpers.chunk_passes(k))
    log.clear()
    spec = GridSpec(Dim3(33, 32, 32), Dim3(2, 2, 2), Radius.constant(8))
    assert tpers.persistent_chunk_across(*blocks, spec, 8, mesh, peers) == 2
    assert log == [("launch", (0,))] + handshake + [("launch", (1,))]
    # the uneven fused schedule: its sweep overwrites what the others' last
    # exchange read, so a handshake comes first
    log.clear()
    spec = GridSpec(Dim3(17, 16, 16), Dim3(2, 2, 2), Radius.constant(1))

    class _Ex:
        def __init__(self):
            self.spec, self.mesh, self.peers = spec, mesh, peers

        def __call__(self, state):
            log.append(("exchange",))

    monkeypatch.setattr(tjac, "sweep_positions", lambda c, n, s, bspec, r: log.append(
        ("sweep", len(c))))
    monkeypatch.setattr(tjac, "sweep_regions", lambda c, o, s, bspec, shells, r: log.append(
        ("shells", len(c))))
    tjac._uneven_fused_loop(_Ex(), 2, None)(*blocks)
    assert log == 2 * (handshake + [("sweep", 4), ("exchange",), ("shells", 4)])


class _FakeIpc:
    """``parallel/ipc``'s CUDA and gloo calls for a PeerBuffers of one rank
    of 2 on the CPU: a handle is a block's address, mapping it gives the
    address back, and the all-gather fills the other rank's exports from
    ``registry`` (``{(q, b): every position's stack}``)."""

    def __init__(self, monkeypatch, mesh, registry):
        self.mesh, self.registry = mesh, registry
        monkeypatch.setattr(ipc, "mem_handle", lambda t: (t.data_ptr().to_bytes(64, "little"), 0))
        monkeypatch.setattr(ipc, "event_create", lambda: 1)
        monkeypatch.setattr(ipc, "event_handle", lambda ev: b"e")
        monkeypatch.setattr(ipc, "open_event", lambda h: 2)
        monkeypatch.setattr(ipc, "open_mem", lambda h: int.from_bytes(h, "little"))
        monkeypatch.setattr(ipc, "close_mem", lambda h: None)
        monkeypatch.setattr(ipc, "event_destroy", lambda ev: None)
        monkeypatch.setattr(ipc, "notice_group", lambda: None)
        monkeypatch.setattr(ipc.torch.cuda, "synchronize", lambda device=None: None)
        monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
        monkeypatch.setattr(torch.distributed, "all_gather_object", self.all_gather)

    def all_gather(self, out, mine):
        exports = mine[0] if isinstance(mine, tuple) else mine
        keys = {key[:2] for key in exports}
        for r in range(2):
            ex = {(*key, i): (self.registry[key][i].data_ptr().to_bytes(64, "little"), 0)
                  for key in keys for i in range(len(self.mesh)) if self.mesh.owner(i) == r}
            out[r] = (ex, b"e") if isinstance(mine, tuple) else ex


def test_sel_exported_and_exchanged_as_one_process(monkeypatch):
    """``sel`` is no buffer of the domain: ``PeerBuffers.add`` exports it as
    realize exports curr and next (a collective; a list already exported
    keeps its key with none), ``buffer_of`` finds it, and the persistent
    loop's ``ex(sel)`` across processes, B6's launches of both ranks
    through the mapped pointers (replayed), fills sel's deep halos as the
    one-process mesh's exchange does; on the card the persistent loop
    exports sel before that exchange, and ``sphere_sel_blocks`` makes no
    collective."""
    spec = GridSpec(Dim3(16, 16, 16), Dim3(2, 2, 2), Radius.constant(2))
    one = DeviceMesh((2, 2, 2), ["cpu"] * 8)
    sel = sphere_sel_blocks(spec, one)
    want = [b.clone() for b in sel]
    HaloExchange(spec, Method.REMOTE_DMA, mesh=one)(want)
    curr, nxt = _blocks(spec, 8, 80), _blocks(spec, 8, 81)
    registry = {(0, 0): curr, (0, 1): nxt, ("added", 0): sel}
    card = ReplayCard(monkeypatch, sel)
    owners = (0, 0, 0, 0, 1, 1, 1, 1)
    peers = {}
    for rank, mesh in _rank_meshes(monkeypatch, (2, 2, 2), owners):
        _FakeIpc(monkeypatch, mesh, registry)
        own = lambda lst: [b if mesh.is_local(i) else None for i, b in enumerate(lst)]  # noqa: E731
        pb = ipc.PeerBuffers(mesh, {(0, 0): own(curr), (0, 1): own(nxt)}, STEPS)
        assert pb.order.everyone == (1 - rank,)
        assert pb.add(own(sel)) == ("added", 0) and pb.buffer_of(own(sel)) == ("added", 0)
        monkeypatch.setattr(torch.distributed, "all_gather_object",
                            lambda *a: pytest.fail("a second export of sel"))
        assert pb.add(own(sel)) == ("added", 0) and pb.added == 1
        peers[rank] = (mesh, pb)
    phases = [ph for ph in build_plan(spec, (2, 2, 2), Method.REMOTE_DMA).remote_phases
              if ph.active]
    for ph in phases:
        for rank, (mesh, pb) in peers.items():
            monkeypatch.setattr(distributed, "process_index", lambda rank=rank: rank)
            rdma.remote_axis_across(lambda i, pb=pb: (pb.pointer(i, "added", 0),), 1,
                                    torch.int32, spec, ph, mesh, torch.device("cpu"))
    assert len(card.calls) == 2 * len(phases) and _same(sel, want)
    for _mesh, pb in peers.values():
        pb.close()
    from stencil_tpu_torch.ops import jacobi as tjac

    log = []
    mesh = peers[0][0]
    monkeypatch.setattr(distributed, "process_index", lambda: 0)
    monkeypatch.setattr(torch.distributed, "all_gather_object",
                        lambda *a: pytest.fail("a collective in sphere_sel_blocks"))
    blocks = sphere_sel_blocks(spec, mesh)
    assert [b is None for b in blocks] == [False] * 4 + [True] * 4

    class _Adds:
        def add(self, stacks):
            log.append(("add", stacks))

    class _Ex:
        on_mesh, oversubscribed, last_launches_per_chunk = True, False, 0

        def __init__(self):
            self.spec, self.mesh, self.peers = spec, mesh, _Adds()

        def __call__(self, state):
            log.append(("exchange", state))

    monkeypatch.setattr(tjac, "persistent_chunk_across", lambda *a: log.append(("chunk",)) or 1)
    card = [[_Block(4096 * (3 * i + j + 1)) if i < 4 else None for i in range(8)]
            for j in range(3)]
    tjac._persistent_loop(_Ex(), 2, 2)(*card)
    assert log == [("add", card[2]), ("exchange", card[2]), ("chunk",)]


def test_an_unordered_launch_raises(monkeypatch):
    """``PeerBuffers`` takes the directions of B7-B9's messages, at least
    one, and a phase order made without the ranks they cross to refuses
    ``before_all`` (a launch across processes would read the other ranks'
    buffers unordered); ``before`` needs no such set."""
    spec = GridSpec(Dim3(16, 16, 16), Dim3(2, 2, 2), Radius.constant(1))
    curr = _blocks(spec, 8, 82)
    _rank, mesh = next(_rank_meshes(monkeypatch, (2, 2, 2), (0, 0, 0, 0, 1, 1, 1, 1)))
    _FakeIpc(monkeypatch, mesh, {(0, 0): curr})
    with pytest.raises(ValueError, match="directions"):
        ipc.PeerBuffers(mesh, {(0, 0): [b if mesh.is_local(i) else None
                                        for i, b in enumerate(curr)]}, ())
    log = []
    rec = _Recorder(log)
    order = ipc.PhaseOrder({"x": (), "y": (), "z": (1,)}, rec, rec)
    order.before("z")
    assert log == [("record",), ("notify", (1,)), ("wait", 1)]
    with pytest.raises(RuntimeError, match="no handshake set"):
        order.before_all()


if __name__ == "__main__":
    torch.set_num_threads(1)
    {"variants": worker_variants}[sys.argv[1]](sys.argv[2])
