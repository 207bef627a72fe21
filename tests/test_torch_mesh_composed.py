"""AXIS_COMPOSED and DIRECT26 over a mesh of block positions
(``parallel/mesh_exchange``), the jacobi loops over positions
(``ops/jacobi._positions_loop``) and B2/B3's positions form
(``ops/stencil_kernels.multistep_positions``), against the JAX package on
its virtual CPU devices.

- The exchange on ``["cpu"] * n`` positions against the JAX package's
  ``HaloExchange`` on ``grid_mesh(dim, jax.devices()[:n])``, every cell,
  halos included: ``tests/test_exchange.py``'s ``test_constant_radius``
  mesh configs, an uneven partition, an fp32 + fp64 dict with quantity
  batching on and off, AXIS_COMPOSED through a bf16 wire; the messages and
  their bytes against the JAX IR's.
- jacobi3d over 8 CPU positions by AXIS_COMPOSED (``deep_halo`` 1, 2, and
  overlap off) and DIRECT26, and over the uneven (3,2,1) of 6 positions,
  against the JAX app on as many virtual devices (compute regions).
- The positions form of the multistep against the JAX package's deep-halo
  ``make_pallas_jacobi_multistep`` in interpret mode at each position's
  origin; its launch table with a recording stand-in for the card.
- The order of the card's handshakes across processes with a recording
  stand-in: an axis handshake before each composed phase, one with every
  rank before DIRECT26, and one before the overlap step's first sweep.

Tolerance: bit-exact."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import stencil_tpu.apps.jacobi3d as japp
import stencil_tpu.domain.grid as jgrid
import stencil_tpu.geometry as jgeo
import stencil_tpu.ops.pallas_stencil as jps
import stencil_tpu.parallel as jpar
import stencil_tpu_torch.apps.jacobi3d as tapp
import stencil_tpu_torch.domain.grid as tgrid
import stencil_tpu_torch.geometry as tgeo
import stencil_tpu_torch.parallel as tpar
from stencil_tpu.parallel.mesh import BLOCK_PSPEC
from stencil_tpu_torch.convert import mesh_state_from_jax, mesh_state_to_numpy
from stencil_tpu_torch.ops import jacobi as tjac
from stencil_tpu_torch.ops import stencil_kernels as sk
from stencil_tpu_torch.parallel import distributed, ipc

torch.set_num_threads(2)

F32, F64 = np.float32, np.float64
AC_T, D26_T = tpar.Method.AXIS_COMPOSED, tpar.Method.DIRECT26
METHODS = {"axis-composed": (AC_T, jpar.Method.AXIS_COMPOSED),
           "direct26": (D26_T, jpar.Method.DIRECT26)}
SRC = (pathlib.Path(sk.__file__).resolve().parent.parent / "csrc" /
       "jacobi_multistep.cu").read_text()


def pair(size, dim, r):
    """(port spec, JAX spec, port mesh of CPU positions, JAX mesh)."""
    n = int(np.prod(dim))
    return (tgrid.GridSpec(tgeo.Dim3(*size), tgeo.Dim3(*dim), tgeo.Radius.constant(r)),
            jgrid.GridSpec(jgeo.Dim3(*size), jgeo.Dim3(*dim), jgeo.Radius.constant(r)),
            tpar.DeviceMesh(dim, ["cpu"] * n),
            jpar.grid_mesh(jgeo.Dim3(*dim), jax.devices()[:n]))


def exchange_both(size, dim, r, dtypes, method, batch=True, wire=None, seed=0):
    """One exchange in each package from the same noisy state (every cell,
    halos included); returns (port arrays, JAX arrays, port exchange, JAX
    exchange)."""
    tspec, jspec, tmesh, jmesh = pair(size, dim, r)
    rng = np.random.RandomState(seed)
    arrs = {i: rng.rand(*jspec.stacked_shape_zyx()).astype(dt) for i, dt in enumerate(dtypes)}
    tm, jm = METHODS[method]
    jex = jpar.HaloExchange(jspec, jmesh, jm, batch_quantities=batch, wire_dtype=wire)
    jout = jex({k: jax.device_put(v, NamedSharding(jmesh, BLOCK_PSPEC)) for k, v in arrs.items()})
    tex = tpar.HaloExchange(tspec, tm, mesh=tmesh, batch_quantities=batch, wire_dtype=wire)
    tstate = mesh_state_from_jax(arrs, tspec, tmesh)
    tex(tstate)
    return (mesh_state_to_numpy(tstate, tspec), {k: np.asarray(v) for k, v in jout.items()},
            tex, jex)


def assert_counts(tex, jex, dtypes):
    """The port's counted messages and bytes equal the JAX IR's."""
    plan = jex.plan
    want = plan.collectives_per_exchange(len(dtypes), len(set(dtypes)))
    assert tex.last_message_count == want == tex.plan.collectives_per_exchange(
        len(dtypes), len(set(dtypes)))
    sizes = [np.dtype(d).itemsize for d in dtypes]
    assert tex.last_message_bytes == plan.wire_bytes(sizes)
    assert tex.last_transfer_count == 0


# tests/test_exchange.py's test_constant_radius configs of several devices
CONSTANT = [((8, 8, 8), (2, 2, 2), 1), ((12, 8, 10), (2, 2, 2), 3), ((8, 8, 8), (4, 2, 1), 2),
            ((16, 8, 8), (8, 1, 1), 2)]


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("size,dim,r", CONSTANT)
def test_constant_radius_matches_jax(size, dim, r, method):
    got, want, tex, jex = exchange_both(size, dim, r, [F32], method)
    np.testing.assert_array_equal(got[0], want[0])
    assert_counts(tex, jex, [F32])


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("batch", [True, False], ids=["batched", "per-quantity"])
def test_mixed_dict_uneven_matches_jax(method, batch):
    """An fp32 + fp64 dict on an uneven partition (x 9/8, y 7/6/6): each
    hi slab and hi halo at its position's own size, DIRECT26's boxes from
    each position's own hi side, face -> edge -> corner."""
    dtypes = [F32, F64, F32]
    got, want, tex, jex = exchange_both((17, 19, 12), (2, 3, 1), 2, dtypes, method, batch,
                                        seed=3)
    assert not tex.spec.is_uniform()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert_counts(tex, jex, dtypes)


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("wire", ["bfloat16", "float8_e4m3fn"])
def test_wire_matches_jax(method, wire):
    """A narrowed wire: every carrier between positions rounds (a ring
    phase's slabs, every direction message), a self-wrap fill stays
    lossless; the bytes at the wire's itemsize."""
    dtypes = [F32, F64]
    got, want, tex, jex = exchange_both((16, 12, 10), (2, 1, 2), 1, dtypes, method, wire=wire,
                                        seed=5)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert_counts(tex, jex, dtypes)


def test_axis_subset_and_loop():
    """``exchange(axes=...)`` runs the named phases only, and ``make_loop``
    repeats the exchange, as the JAX package's."""
    tspec, jspec, tmesh, jmesh = pair((16, 16, 12), (2, 2, 2), 1)
    rng = np.random.RandomState(2)
    arr = rng.rand(*jspec.stacked_shape_zyx()).astype(F32)
    jex = jpar.HaloExchange(jspec, jmesh, jpar.Method.AXIS_COMPOSED)
    jst = jax.device_put(arr, NamedSharding(jmesh, BLOCK_PSPEC))
    want = np.asarray(jax.jit(jax.shard_map(
        lambda b: jex.exchange_block(b, axes=("x", "z")), mesh=jmesh, in_specs=BLOCK_PSPEC,
        out_specs=BLOCK_PSPEC))(jst))
    tex = tpar.HaloExchange(tspec, AC_T, mesh=tmesh)
    st = mesh_state_from_jax({0: arr}, tspec, tmesh)
    tex.exchange(st, axes=("x", "z"))
    np.testing.assert_array_equal(mesh_state_to_numpy(st, tspec)[0], want)
    assert tex.last_message_count == 4
    st = mesh_state_from_jax({0: arr}, tspec, tmesh)
    tex.make_loop(2)(st)
    np.testing.assert_array_equal(mesh_state_to_numpy(st, tspec)[0],
                                  np.asarray(jex.make_loop(2)(jst)))


# -- jacobi3d over positions ---------------------------------------------------------

JACOBI_RUNS = [("axis-composed", 1, True), ("axis-composed", 2, True),
               ("axis-composed", 1, False), ("direct26", 1, True)]


@pytest.mark.parametrize("method,deep,overlap", JACOBI_RUNS,
                         ids=["composed", "composed-deep2", "composed-no-overlap", "direct26"])
def test_jacobi3d_over_8_positions_matches_jax(method, deep, overlap):
    """jacobi3d 24^3 over 8 CPU positions, 5 steps after the warm-up chunk:
    the overlap step (sweep with the single-position axes wrapped, the
    exchange, every position's shells), the deep-halo multistep's positions
    form at k = 2 with an overlap-step tail, the axis-subset step, and
    DIRECT26's exchange and sweep, bit-equal to the JAX app on 8 virtual
    devices."""
    kw = dict(iters=5, weak=False, deep_halo=deep, overlap=overlap)
    got = tapp.run(24, 24, 24, devices=["cpu"] * 8, method=METHODS[method][0], **kw)
    want = japp.run(24, 24, 24, devices=jax.devices()[:8], method=METHODS[method][1], **kw)
    np.testing.assert_array_equal(got["domain"].get_curr_global(got["handle"]),
                                  want["domain"].get_curr_global(want["handle"]))
    assert got["temporal_k"] == (2 if deep == 2 else 0)
    assert tapp.csv_row(got).split(",")[:4] == ["jacobi3d", method, "1", "8"]


def test_jacobi3d_uneven_over_6_positions_matches_jax():
    """The uneven (3,2,1) of 16^3 over 6 positions by AXIS_COMPOSED (the
    app's default): the dynamic-shell step, compared on compute regions."""
    got = tapp.run(16, 16, 16, devices=["cpu"] * 6, iters=4, weak=False)
    want = japp.run(16, 16, 16, devices=jax.devices()[:6], iters=4, weak=False)
    assert tuple(got["domain"].spec.dim) == (3, 2, 1) and not got["domain"].spec.is_uniform()
    np.testing.assert_array_equal(got["domain"].get_curr_global(got["handle"]),
                                  want["domain"].get_curr_global(want["handle"]))


def test_jacobi3d_cli_devices_by_each_method(capsys):
    for flags, method in (([], "axis-composed"), (["--direct26"], "direct26"),
                          (["--deep-halo", "2"], "axis-composed")):
        assert tapp.main(["--x", "16", "--y", "16", "--z", "16", "--iters", "2", "--no-weak",
                          "--devices", ",".join(["cpu"] * 8), *flags]) == 0
        row = capsys.readouterr().out.strip().splitlines()[-1].split(",")
        assert row[:7] == ["jacobi3d", method, "1", "8", "16", "16", "16"]


# -- B2/B3's positions form ----------------------------------------------------------

def _positions(stacked, spec):
    """A stacked (bz, by, bx, pz, py, px) array as one (1, 1, 1, ...) tensor a
    position, and each position's global origin, in flat order."""
    d = spec.dim
    out, origins = [], []
    for iz in range(d.z):
        for iy in range(d.y):
            for ix in range(d.x):
                out.append(torch.from_numpy(stacked[iz, iy, ix][None, None, None].copy()))
                origins.append(sk.block_origin(spec, (ix, iy, iz)))
    return out, origins


@pytest.mark.parametrize("size,part,r,k", [((16, 16, 24), (2, 2, 2), 2, 2),
                                           ((24, 16, 20), (1, 1, 2), 3, 3)])
def test_multistep_positions_matches_pallas(size, part, r, k):
    """The positions form's plain version, each position at its own origin,
    against the JAX package's deep-halo multistep in interpret mode given
    the same origin, from random fields with noise in every halo."""
    tspec, jspec, _tm, _jm = pair(size, part, r)
    rng = np.random.RandomState(k)
    curr = rng.rand(*jspec.stacked_shape_zyx()).astype(F32)
    currs, origins = _positions(curr, tspec)
    nxts = [torch.zeros_like(c) for c in currs]
    sk.multistep_positions(currs, nxts, tspec, k, origins)
    fn = jps.make_pallas_jacobi_multistep(jspec, k, interpret=True)
    off, b = tspec.compute_offset(), tspec.base
    cs = (slice(off.z, off.z + b.z), slice(off.y, off.y + b.y), slice(off.x, off.x + b.x))
    for n, o, idx in zip(nxts, origins, np.ndindex(*curr.shape[:3])):
        want = np.asarray(fn(jnp.asarray((o.z, o.y, o.x), jnp.int32), jnp.asarray(curr[idx]),
                             jnp.zeros(curr.shape[3:], jnp.float32)))
        np.testing.assert_array_equal(n[0, 0, 0].numpy()[cs], want[cs])


@pytest.mark.parametrize("dtype", [F32, F64])
def test_multistep_positions_equals_the_stack_form(dtype):
    """fp32 and fp64: every position's block equals the stack form's
    (multistep over the resident stack), a subset of positions too."""
    tspec, jspec, _tm, _jm = pair((20, 16, 28), (2, 1, 2), 2)
    curr = np.random.RandomState(1).rand(*jspec.stacked_shape_zyx()).astype(dtype)
    want = sk.multistep(torch.from_numpy(curr.copy()), torch.zeros(curr.shape,
                        dtype=torch.from_numpy(curr).dtype), tspec, 2).numpy()
    currs, origins = _positions(curr, tspec)
    nxts = [torch.zeros_like(c) for c in currs]
    sk.multistep_positions(currs[1:3], nxts[1:3], tspec, 2, origins[1:3])
    assert not nxts[0].any()
    sk.multistep_positions(currs, nxts, tspec, 2, origins)
    for n, idx in zip(nxts, np.ndindex(*curr.shape[:3])):
        np.testing.assert_array_equal(n[0, 0, 0].numpy(), want[idx])


def test_multistep_positions_refusals():
    tspec, _js, _tm, _jm = pair((16, 16, 24), (2, 2, 2), 1)
    c = [torch.zeros((1, 1, 1, *tspec.block_shape_zyx())) for _ in range(2)]
    n = [torch.zeros_like(t) for t in c]
    o = [tgeo.Dim3(0, 0, 0), tgeo.Dim3(8, 0, 0)]
    with pytest.raises(ValueError, match="radius >= k"):
        sk.multistep_positions(c, n, tspec, 2, o)
    with pytest.raises(ValueError, match="own buffer"):
        sk.multistep_positions(c, [n[0], c[0]], tspec, 1, o)
    with pytest.raises(ValueError, match="origin"):
        sk.multistep_positions(c, n, tspec, 1, [o[0], tgeo.Dim3(16, 0, 0)])
    one = tgrid.GridSpec(tgeo.Dim3(16, 16, 24), tgeo.Dim3(1, 1, 1), tgeo.Radius.constant(1))
    with pytest.raises(ValueError, match="several"):
        sk.multistep_positions(c[:1], n[:1], one, 1, o[:1])
    assert sk.multistep_positions.launches == 0


class _Dev:
    type, index = "cuda", 0


class FakeMultistepCard:
    """Stands in for the card in multistep_positions' CUDA branch: the
    device table is kept and the launch's arguments recorded."""

    def __init__(self, monkeypatch):
        self.tables, self.launches = {}, []
        monkeypatch.setattr(sk, "_device_of", lambda *a: _Dev())
        monkeypatch.setattr(sk, "multistep_blocks_in_flight", lambda dev, k, item=4: 132)
        monkeypatch.setattr(sk._native, "device_table", self.device_table)
        monkeypatch.setattr(sk._native, "stream_ptr", lambda dev: 0)
        monkeypatch.setattr(sk._native, "lib", lambda name: self)

    def device_table(self, key, rows, device):
        if key not in self.tables:
            self.tables[key] = torch.tensor(rows(), dtype=torch.int64)
        return self.tables[key]

    def jacobi_multistep_positions_launch(self, dev_tab, entries, aligned, sz, sy, zo, yo, xo,
                                          nz, ny, nx, bz, by, bx, k, gx, gy, gz, zchunks, item,
                                          dev, stream):
        self.launches.append(dict(dev=dev_tab, entries=entries, aligned=aligned, k=k,
                                  zchunks=zchunks, item=item, dims=(bz, by, bx), n=(nz, ny, nx),
                                  g=(gx, gy, gz), strides=(sz, sy), off=(zo, yo, xo)))
        return 0


@pytest.mark.parametrize("npos", [8, 3])
def test_multistep_positions_launch_table(monkeypatch, npos):
    """One launch over the given positions: its entries (curr, out, origin)
    in the device table, the pointers' 16-byte test, the partition's dims,
    and the z chunks counted over the positions launched (each chunk count
    times the entries is grid.z, which the launch holds to 65535)."""
    card = FakeMultistepCard(monkeypatch)
    spec = tgrid.GridSpec(tgeo.Dim3(128, 128, 256), tgeo.Dim3(2, 2, 2), tgeo.Radius.constant(4))
    p = spec.padded()
    currs = [torch.empty((1, 1, 1, p.z, p.y, p.x)) for _ in range(npos)]
    nxts = [torch.empty_like(c) for c in currs]
    origins = [sk.block_origin(spec, (i % 2, i // 2 % 2, i // 4)) for i in range(npos)]
    sk.multistep_positions.launches = 0
    sk.multistep_positions(currs, nxts, spec, 4, origins)
    (got,) = card.launches
    rows = [v for c, n, o in zip(currs, nxts, origins)
            for v in (c.data_ptr(), n.data_ptr(), o.x, o.y, o.z)]
    table = card.tables[("multistep_positions", tuple(rows))]
    assert table.tolist() == rows and got["dev"] == table.data_ptr()
    assert got["aligned"] == int(all(v % 16 == 0 for i, v in enumerate(rows) if i % 5 < 2))
    assert got["entries"] == npos and got["dims"] == (2, 2, 2) and got["k"] == 4
    assert got["n"] == (128, 64, 64) and got["g"] == (128, 128, 256) and got["item"] == 4
    assert got["strides"] == (p.y * p.x, p.x)
    want = sk.multistep_zchunks(spec, 4, 132, 4, blocks=npos)
    assert got["zchunks"] == want and npos * want <= 65535
    if npos < 8:
        assert want >= sk.multistep_zchunks(spec, 4, 132, 4)
    assert sk.multistep_positions.launches == 1
    assert sk.MULTISTEP_TAB_FIELDS == ("curr", "out", "ox", "oy", "oz")
    for text in ("constexpr int TAB_COLS = 5;", "(long long)entries * zchunks > 65535",
                 "launch_k<T>(p, k, entries, true, st)",
                 "p.vec = aligned && sz % C == 0 && sy % C == 0;"):
        assert text in SRC, text


# -- the order of the card's handshakes across processes -----------------------------

class _Recorder:
    def __init__(self, log):
        self.log = log

    def record(self):
        self.log.append(("record",))

    def wait(self, rank):
        self.log.append(("wait", rank))

    def exchange(self, ranks):
        self.log.append(("notify", tuple(ranks)))


class _FakePeers:
    def __init__(self, mesh, log):
        neighbours = {a: mesh.neighbour_ranks(a) for a in "xyz" if mesh.ring(a) > 1}
        steps = [(d.x, d.y, d.z) for d in tgeo.DIRECTIONS_26]
        rec = _Recorder(log)
        self.order = ipc.PhaseOrder(neighbours, rec, rec, mesh.message_ranks(steps))


def _card_mesh_of_ranks(monkeypatch, method):
    """A (2,2,2) mesh of 4 ranks of 2 positions each on one card's UUID, as
    rank 0 sees it, its exchange's pulls recorded in place of the copies."""
    P = distributed.Position
    mesh = tpar.DeviceMesh((2, 2, 2), [P(i, i // 2, "h", "cuda:0", "GPU-a") for i in range(8)])
    spec = tgrid.GridSpec(tgeo.Dim3(16, 16, 16), tgeo.Dim3(2, 2, 2), tgeo.Radius.constant(1))
    ex = tpar.HaloExchange(spec, method, mesh=mesh)
    log = []
    ex.attach_peers(_FakePeers(mesh, log))
    monkeypatch.setattr(type(ex._remote), "_pull_round",
                        lambda self, state, keys, rnd: log.append(("pull", rnd.step)))
    return ex, mesh, log


def _local(mesh, shape, dtype=torch.float32):
    return [torch.zeros((1, 1, 1, *shape), dtype=dtype) if mesh.is_local(i) else None
            for i in range(len(mesh))]


def test_card_handshakes_before_each_composed_phase(monkeypatch):
    """AXIS_COMPOSED across processes on the card: per axis phase the
    handshake with that axis's ring neighbours (record, notify, wait on
    each), then the phase's two pulls; x has neighbours only on this rank,
    so its phase needs none."""
    ex, mesh, log = _card_mesh_of_ranks(monkeypatch, AC_T)
    state = {0: _local(mesh, ex.spec.block_shape_zyx())}
    ex(state)
    assert mesh.neighbour_ranks("x") == () and mesh.neighbour_ranks("y") == (1,)
    assert log == [("pull", (1, 0, 0)), ("pull", (-1, 0, 0)),
                   ("record",), ("notify", (1,)), ("wait", 1),
                   ("pull", (0, 1, 0)), ("pull", (0, -1, 0)),
                   ("record",), ("notify", (2,)), ("wait", 2),
                   ("pull", (0, 0, 1)), ("pull", (0, 0, -1))]
    assert ex.peers.order.handshakes == 2


def test_card_handshake_before_direct26(monkeypatch):
    """DIRECT26 across processes on the card: one handshake with every rank
    the 26 directions cross to, then the 26 pulls."""
    ex, mesh, log = _card_mesh_of_ranks(monkeypatch, D26_T)
    state = {0: _local(mesh, ex.spec.block_shape_zyx())}
    ex(state)
    everyone = mesh.message_ranks([(d.x, d.y, d.z) for d in tgeo.DIRECTIONS_26])
    assert everyone == (1, 2, 3)
    assert log[:5] == [("record",), ("notify", everyone), ("wait", 1), ("wait", 2), ("wait", 3)]
    assert [e[0] for e in log[5:]] == ["pull"] * 26 and ex.peers.order.handshakes == 1


def test_card_handshake_before_the_overlap_sweep(monkeypatch):
    """The overlap step across processes on the card: a handshake with
    every rank before its first sweep (the sweep overwrites the buffer the
    neighbours read in the previous exchange), then the exchange's phase
    handshakes and pulls, then the shells."""
    ex, mesh, log = _card_mesh_of_ranks(monkeypatch, AC_T)
    monkeypatch.setattr(tjac, "sweep_positions", lambda *a, **k: log.append(("sweep",)))
    monkeypatch.setattr(tjac, "sweep_regions", lambda *a, **k: log.append(("shells",)))
    shape = ex.spec.block_shape_zyx()
    blocks = [_local(mesh, shape) for _ in range(2)]
    sel = _local(mesh, shape, torch.int32)
    loop = tjac.make_jacobi_loop(ex, 1)
    assert loop.temporal_k == 0
    loop(blocks[0], blocks[1], sel)
    assert log[:6] == [("record",), ("notify", (1, 2, 3)), ("wait", 1), ("wait", 2), ("wait", 3),
                       ("sweep",)]
    assert log[-1] == ("shells",) and log.count(("sweep",)) == 1
    assert [e for e in log[6:-1] if e[0] == "pull"] == [
        ("pull", s) for s in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
                              (0, 0, -1))]
