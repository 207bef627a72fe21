"""jacobi3d's fused and persistent remote-dma variants over a mesh of block
positions (the wire-crossing forms of the fused step and the persistent
chunk), in the port on CPU positions against the JAX package on its
virtual CPU devices (the host-orchestrated schedules of
``stencil_tpu/ops/jacobi.py``): the fused and persistent loops on (2,2,2),
(1,1,2) and (2,1,1) meshes, with tail chunks; the kernels' plain versions
against the JAX step and chunk, halos included; the app and its CLI; the
tables the CUDA wrappers build, interpreted in Python; and the refusals
that remain. Inputs are random numpy fields from a seed with noise in
every halo and pad cell, and the spheres' sel. Tolerance: bit-exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import stencil_tpu.apps.jacobi3d as japp
import stencil_tpu.domain.grid as jgrid
import stencil_tpu.geometry as jgeo
import stencil_tpu.ops.jacobi as jjac
import stencil_tpu.parallel as jpar
import stencil_tpu_torch.apps.jacobi3d as tapp
import stencil_tpu_torch.domain.grid as tgrid
import stencil_tpu_torch.geometry as tgeo
import stencil_tpu_torch.ops.jacobi as tjac
import stencil_tpu_torch.parallel as tpar
import stencil_tpu_torch.plan.ir as tir
from stencil_tpu.parallel.mesh import BLOCK_PSPEC
from stencil_tpu_torch import DistributedDomain
from stencil_tpu_torch.convert import mesh_state_from_jax, mesh_state_to_numpy
from stencil_tpu_torch.ops import fused_stencil as tfused
from stencil_tpu_torch.ops import persistent_stencil as tpers
from stencil_tpu_torch.ops.stencil_kernels import sweep_plain

torch.set_num_threads(2)

RDMA_T, RDMA_J = tpar.Method.REMOTE_DMA, jpar.Method.REMOTE_DMA


def pair(size, dim, r):
    """(port spec, JAX spec, port mesh of CPU positions, JAX mesh)."""
    n = int(np.prod(dim))
    return (tgrid.GridSpec(tgeo.Dim3(*size), tgeo.Dim3(*dim), tgeo.Radius.constant(r)),
            jgrid.GridSpec(jgeo.Dim3(*size), jgeo.Dim3(*dim), jgeo.Radius.constant(r)),
            tpar.DeviceMesh(dim, ["cpu"] * n),
            jpar.grid_mesh(jgeo.Dim3(*dim), jax.devices()[:n]))


def start_state(jspec, size, seed):
    """Stacked numpy arrays: a random field and a random next buffer, noise
    in every halo and pad cell, and the spheres' sel (halos 0)."""
    rng = np.random.RandomState(seed)
    shape = jspec.stacked_shape_zyx()
    sel = np.asarray(jpar.exchange.shard_blocks(
        jjac.sphere_sel(size), jspec, jpar.grid_mesh(jspec.dim, jax.devices()[:jspec.num_blocks()])))
    return {"c": rng.rand(*shape).astype(np.float32), "n": rng.rand(*shape).astype(np.float32),
            "s": sel}


def both_loops(size, dim, r, iters, seed, **kw):
    """``make_jacobi_loop(ex, iters)`` in each package from one start state
    (``kw``: the kernel variant and ``temporal_k``); returns (port stacked
    arrays, JAX arrays, port exchange, JAX exchange)."""
    tk = kw.pop("temporal_k", None)
    tspec, jspec, tmesh, jmesh = pair(size, dim, r)
    arrs = start_state(jspec, size, seed)
    jex = jpar.HaloExchange(jspec, jmesh, RDMA_J, **kw)
    js = {k: jax.device_put(v, NamedSharding(jmesh, BLOCK_PSPEC)) for k, v in arrs.items()}
    jc, jn = jjac.make_jacobi_loop(jex, iters, temporal_k=tk)(js["c"], js["n"], js["s"])
    tex = tpar.HaloExchange(tspec, RDMA_T, mesh=tmesh, **kw)
    ts = mesh_state_from_jax(arrs, tspec, tmesh)
    tc, tn = tjac.make_jacobi_loop(tex, iters, temporal_k=tk)(ts["c"], ts["n"], ts["s"])
    return (mesh_state_to_numpy({"c": tc, "n": tn}, tspec),
            {"c": np.asarray(jc), "n": np.asarray(jn)}, tex, jex, tspec, jspec)


def compute(arr, jspec):
    return jpar.exchange.unshard_blocks(jnp.asarray(arr), jspec)


def halo_box(arr, spec, r):
    """Every block's compute region grown by ``r`` cells: the cells both
    packages' exchanges fill (the JAX axis carrier also fills pad cells)."""
    off, b = spec.compute_offset(), spec.base
    return arr[..., off.z - r:off.z + b.z + r, off.y - r:off.y + b.y + r,
               off.x - r:off.x + b.x + r]


def contract_loop(jex, spec, c, n, s, iters, k):
    """Stacked numpy ``(curr, nxt)`` after a persistent loop of ``iters``
    steps at depth ``k`` under the port's chunk contract, from the JAX
    package's exchange and its one-chunk loop: per chunk, ``curr`` <- the
    deep exchange, the result buffer's compute region <- JAX's chunk
    result, every other cell kept; then the swap of ``result_in_nxt``.
    Compare it over the halo box: JAX's exchange also fills pad cells."""
    off, b = spec.compute_offset(), spec.base
    cr = (..., slice(off.z, off.z + b.z), slice(off.y, off.y + b.y), slice(off.x, off.x + b.x))
    loops = {}
    for d in tpers.chunk_schedule(iters, k):
        assert tpers.result_in_nxt(d)  # one on-chip pass at these depths
        if d not in loops:
            loops[d] = jjac.make_jacobi_loop(jex, d, temporal_k=d)
        res, _ = loops[d](c, n, s)
        out = np.array(n)
        out[cr] = np.asarray(res)[cr]
        c, n = jax.device_put(jnp.asarray(out), c.sharding), jex(c)
    return np.asarray(c), np.asarray(n)


# -- the loops ----------------------------------------------------------------------

FUSED_CASES = [((16, 16, 16), (2, 2, 2)), ((18, 20, 22), (2, 2, 2)),
               ((16, 16, 20), (1, 1, 2)), ((24, 20, 16), (2, 1, 1))]


@pytest.mark.parametrize("size,dim", FUSED_CASES, ids=lambda v: "x".join(map(str, v)))
def test_fused_mesh_loop_matches_jax(size, dim):
    """3 fused steps: the gathered compute region and both buffers, halos
    and pad included (the fused messages fill the same cells)."""
    got, want, tex, _jex, _tspec, jspec = both_loops(size, dim, 1, 3, 5, fused=True)
    np.testing.assert_array_equal(compute(got["c"], jspec), compute(want["c"], jspec))
    for key in ("c", "n"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert tex.fused and tex.on_mesh and tex.last_launches_per_chunk == 0


PERSISTENT_CASES = [((16, 16, 16), (2, 2, 2), 2, 5), ((16, 16, 16), (2, 2, 2), 3, 5),
                    ((16, 16, 20), (1, 1, 2), 3, 7), ((24, 20, 16), (2, 1, 1), 2, 3)]


@pytest.mark.parametrize("size,dim,k,iters", PERSISTENT_CASES,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_persistent_mesh_loop_matches_jax(size, dim, k, iters):
    """Radius-k halos, chunk depth k: 5 steps at k=2 end in a depth-1 tail,
    at k=3 in a depth-2 chunk; 7 at k=3 in a depth-1 tail. The gathered
    compute region, each buffer's grown box, and the launch census."""
    got, want, tex, jex, tspec, jspec = both_loops(size, dim, k, iters, 6 + k, persistent=True,
                                                   temporal_k=k)
    np.testing.assert_array_equal(compute(got["c"], jspec), compute(want["c"], jspec))
    # each buffer's grown box is what the chunk contract leaves, built from
    # JAX's exchange and chunks
    js = {key: jax.device_put(v, NamedSharding(jex.mesh, BLOCK_PSPEC))
          for key, v in start_state(jspec, size, 6 + k).items()}
    want = dict(zip("cn", contract_loop(jex, tspec, js["c"], js["n"], js["s"], iters, k)))
    for key in ("c", "n"):
        np.testing.assert_array_equal(halo_box(got[key], tspec, k), halo_box(want[key], tspec, k),
                                      err_msg=key)
    assert tex.last_launches_per_chunk == jex.last_launches_per_chunk == 2
    assert tpers.chunk_schedule(iters, k)[-1] < k


# -- the kernels' plain versions against the JAX step and chunk ------------------------

@pytest.mark.parametrize("size,dim", [FUSED_CASES[0], FUSED_CASES[3]],
                         ids=lambda v: "x".join(map(str, v)))
def test_fused_mesh_plain_matches_jax_step(size, dim):
    """One fused step: JAX's exchanged curr (every cell) and its swept out
    against ``fused_jacobi_mesh_plain``'s curr and nxt."""
    tspec, jspec, tmesh, jmesh = pair(size, dim, 1)
    arrs = start_state(jspec, size, 9)
    jex = jpar.HaloExchange(jspec, jmesh, RDMA_J, fused=True)
    js = {k: jax.device_put(v, NamedSharding(jmesh, BLOCK_PSPEC)) for k, v in arrs.items()}
    jout, jcur = jjac.make_jacobi_loop(jex, 1)(js["c"], js["n"], js["s"])
    ts = mesh_state_from_jax(arrs, tspec, tmesh)
    plan = tir.build_plan(tspec, dim, tir.REMOTE_DMA, fused=True)
    currs, nxts = tfused.fused_jacobi_mesh_plain(ts["c"], ts["n"], ts["s"], tspec, plan, tmesh)
    got = mesh_state_to_numpy({"c": currs, "n": nxts}, tspec)
    np.testing.assert_array_equal(got["c"], np.asarray(jcur))
    np.testing.assert_array_equal(got["n"], np.asarray(jout))


@pytest.mark.parametrize("k", [2, 3])
def test_persistent_mesh_plain_matches_jax_chunk(k):
    """One depth-k chunk on (2,2,2) at 16^3 radius k, sel's deep halos
    filled by each package's exchange: ``persistent_jacobi_mesh_plain``'s
    ``curr`` holds JAX's deep exchange over the halo box and is unchanged
    elsewhere; its result buffer (``nxt``: one on-chip pass) holds in the
    compute region JAX's result, read from the buffer JAX's own rule names
    (``nxt`` for odd k), and is unchanged elsewhere, pads included; sel is
    equal after the fill and unchanged by the chunk."""
    tspec, jspec, tmesh, jmesh = pair((16, 16, 16), (2, 2, 2), k)
    arrs = start_state(jspec, (16, 16, 16), 20 + k)
    jex = jpar.HaloExchange(jspec, jmesh, RDMA_J, persistent=True)
    js = {key: jax.device_put(v, NamedSharding(jmesh, BLOCK_PSPEC)) for key, v in arrs.items()}
    jout, _ = jjac.make_jacobi_loop(jex, k, temporal_k=k)(js["c"], js["n"], js["s"])
    jres = np.asarray(jout)  # JAX's loop resolves its kernel's parity (nxt for odd k)
    tex = tpar.HaloExchange(tspec, RDMA_T, mesh=tmesh, persistent=True)
    ts = mesh_state_from_jax(arrs, tspec, tmesh)
    tex(ts["s"])
    sel = mesh_state_to_numpy({"s": ts["s"]}, tspec)["s"]
    np.testing.assert_array_equal(sel, np.asarray(jex(js["s"])))
    currs, nxts, sels = tpers.persistent_jacobi_mesh_plain(ts["c"], ts["n"], ts["s"], tspec, k,
                                                           tmesh)
    assert tpers.result_in_nxt(k)
    got = mesh_state_to_numpy({"c": currs, "n": nxts, "s": sels}, tspec)
    off, b = tspec.compute_offset(), tspec.base
    cr = (..., slice(off.z, off.z + b.z), slice(off.y, off.y + b.y), slice(off.x, off.x + b.x))
    hb = (..., slice(off.z - k, off.z + b.z + k), slice(off.y - k, off.y + b.y + k),
          slice(off.x - k, off.x + b.x + k))

    def outside(arr, box):
        mask = np.ones(arr.shape, bool)
        mask[box] = False
        return arr[mask]

    np.testing.assert_array_equal(got["c"][hb], np.asarray(jex(js["c"]))[hb])
    np.testing.assert_array_equal(got["c"][cr], arrs["c"][cr])
    np.testing.assert_array_equal(outside(got["c"], hb), outside(arrs["c"], hb))
    np.testing.assert_array_equal(got["n"][cr], jres[cr])
    np.testing.assert_array_equal(outside(got["n"], cr), outside(arrs["n"], cr))
    np.testing.assert_array_equal(got["s"], sel)


# -- the app and its CLI --------------------------------------------------------------

VARIANTS = {"fused": dict(kernel_variant="fused"),
            "persistent": dict(kernel_variant="persistent", deep_halo=2)}


@functools.lru_cache(maxsize=None)
def jax_app(variant, weak):
    size = (8, 8, 8) if weak else (16, 16, 16)
    return japp.run(*size, devices=jax.devices()[:8], method=RDMA_J, iters=5, chunk=2,
                    weak=weak, **VARIANTS[variant])


@pytest.mark.parametrize("weak", [False, True])
@pytest.mark.parametrize("variant", ["fused", "persistent"])
def test_jacobi3d_mesh_variants_match_jax_app(variant, weak):
    """5 iterations in chunks of 2 after a warm-up chunk (the persistent
    loop's depth-1 tail included), 8 positions."""
    want = jax_app(variant, weak)
    size = (8, 8, 8) if weak else (16, 16, 16)
    got = tapp.run(*size, devices=["cpu"] * 8, method=RDMA_T, iters=5, chunk=2, weak=weak,
                   **VARIANTS[variant])
    assert (got["x"], got["y"], got["z"]) == (want["x"], want["y"], want["z"]) == (16, 16, 16)
    np.testing.assert_array_equal(got["domain"].get_curr_global(got["handle"]),
                                  want["domain"].get_curr_global(want["handle"]))
    assert tapp.csv_row(got).split(",")[:8] == japp.csv_row(want).split(",")[:8]
    assert got["kernel_variant"] == variant and got["devices"] == 8
    assert got["temporal_k"] == (2 if variant == "persistent" else 0)


@pytest.mark.parametrize("variant", ["fused", "persistent"])
def test_jacobi3d_cli_mesh_variants(variant, capsys):
    argv = ["--x", "16", "--y", "16", "--z", "16", "--iters", "5", "--no-weak", "--method",
            "remote-dma", "--devices", ",".join(["cpu"] * 8), "--kernel-variant", variant]
    if variant == "persistent":
        argv += ["--deep-halo", "2"]
    assert tapp.main(argv) == 0
    row = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert row[:8] == japp.csv_row(jax_app(variant, False)).split(",")[:8]


# -- the CUDA wrappers' tables, interpreted ----------------------------------------------

class FakeChunkCard:
    """Stands in for the card in the mesh chunk wrappers' CUDA branch: the
    tables the wrapper uploads are kept (counting each one made), and a
    Python copy of csrc/mesh_chunk.cuh (and of csrc/fused_jacobi.cu's
    phase-A work list) applies them to the CPU blocks the position table
    names."""

    type, index = "cuda", 0

    def __init__(self, monkeypatch, blocks):
        self.blocks = {b.data_ptr(): b for b in blocks}
        self.tables, self.made = {}, []
        for mod in (tfused, tpers):
            monkeypatch.setattr(mod, "check_mesh_fields", lambda *a: self)
        monkeypatch.setattr(tfused._native, "device_table", self.device_table)
        monkeypatch.setattr(tfused._native, "stream_ptr", lambda dev: 0)
        monkeypatch.setattr(tfused._native, "lib", lambda name: self)

    def device_table(self, key, rows, device):
        if key not in self.tables:
            t = torch.tensor(rows(), dtype=torch.int64)
            self.tables[key] = t
            self.tables[t.data_ptr()] = t.tolist()
            self.made.append(key[0])
        return self.tables[key]

    def positions(self, pos, npos):
        return [[self.blocks[v] for v in self.tables[pos][3 * i:3 * i + 3]] for i in range(npos)]

    def run(self, pos, npos, msg, m, boxes, nboxes, sz, sy, zo, yo, xo, nz, ny, nx, k):
        p = self.positions(pos, npos)
        rows = self.tables[msg]
        assert len(rows) == 3 * m * nboxes and m == npos
        for r in range(m * nboxes):
            src, dst, b = rows[3 * r:3 * r + 3]
            assert b == r // m and dst == r % m  # box by box, receiver by receiver
            box = list(boxes[9 * b:9 * b + 9])
            s, d = tfused.box_slices(box[0:3], box[3:6], box[6:9])
            p[dst][0][d] = p[src][0][s]
        return self.substeps(p, sz, sy, zo, yo, xo, nz, ny, nx, k)

    def substeps(self, p, sz, sy, zo, yo, xo, nz, ny, nx, k):
        spec = tgrid.GridSpec(tgeo.Dim3(nx, ny, nz), tgeo.Dim3(1, 1, 1), self.radius)
        assert (sy, sz) == (spec.padded().x, spec.padded().x * spec.padded().y)
        off = spec.compute_offset()
        assert (zo, yo, xo) == (off.z, off.y, off.x)
        for a, b, sel in p:
            if k == 1:
                sweep_plain(a, b, sel, spec, tfused.NO_WRAP)
            else:
                tpers.make_persistent_chunk_body(spec, k)(a, b, sel)
        return 0

    def fused_jacobi_launch(self, pos, npos, nsweep, msg, m, segs, nseg, ncols, tasks, sz, sy,
                            zo, yo, xo, nz, ny, nx, vec, code, fmt, dev, stream):
        """The fused step: its phase-A work list replayed as
        tests/test_torch_fused_launch.py does (the flagged rows through the
        wire of the launch's code and format), then one sweep per position."""
        from test_torch_exchange_launch import launch_wire
        from test_torch_fused_launch import replay_rows

        p = self.positions(pos, npos)
        flat, msgs = self.tables[segs], self.tables[msg]
        assert ncols == tfused.SEG_COLS and len(flat) == nseg * ncols and m == nsweep == npos
        wire = launch_wire(code, fmt)
        replay_rows([a for a, _b, _s in p], [flat[i * ncols:(i + 1) * ncols] for i in range(nseg)],
                    [msgs[3 * i:3 * i + 3] for i in range(len(msgs) // 3)], m, sz, sy, wire)
        return self.substeps(p, sz, sy, zo, yo, xo, nz, ny, nx, 1)

    def persistent_jacobi_launch(self, pos, npos, nsweep, msg, m, boxes, nboxes, ext, sz, sy,
                                 zo, yo, xo, nz, ny, nx, k, pass0, pass1, _dev, _stream):
        """One process's chunk: every row swept, every pass run; with an
        extent table the uneven form: no messages; each position's passes at
        the extent its row of the extent table gives, inside the base
        block."""
        assert nsweep == npos and (pass0, pass1) == (0, len(tpers.chunk_passes(k)))
        if ext is None:
            return self.run(pos, npos, msg, m, boxes, nboxes, sz, sy, zo, yo, xo, nz, ny, nx, k)
        assert msg is None and m == nboxes == 0
        rows = self.tables[ext]
        assert len(rows) == 3 * npos
        spec = tgrid.GridSpec(tgeo.Dim3(nx, ny, nz), tgeo.Dim3(1, 1, 1), self.radius)
        assert (sy, sz) == (spec.padded().x, spec.padded().x * spec.padded().y)
        assert (zo, yo, xo) == tuple(getattr(spec.compute_offset(), a) for a in "zyx")
        for (a, b, sel), i in zip(self.positions(pos, npos), range(npos)):
            ez, ey, ex = rows[3 * i:3 * i + 3]
            assert ez <= nz and ey <= ny and ex <= nx
            tpers.make_persistent_chunk_body(spec, k, (ex, ey, ez))(a, b, sel)
        return 0


def _mesh_fields(size, dim, r, seed):
    tspec, jspec, tmesh, _jmesh = pair(size, dim, r)
    arrs = start_state(jspec, size, seed)
    if r > 1:  # the persistent chunk reads sel's deep halos
        tex = tpar.HaloExchange(tspec, RDMA_T, mesh=tmesh)
        st = mesh_state_from_jax({"s": arrs["s"]}, tspec, tmesh)
        tex(st)
        arrs["s"] = mesh_state_to_numpy(st, tspec)["s"]
    return tspec, tmesh, arrs


@pytest.mark.parametrize("size,dim", [FUSED_CASES[0], FUSED_CASES[2]],
                         ids=lambda v: "x".join(map(str, v)))
def test_fused_mesh_tables_move_the_plain_versions_cells(monkeypatch, size, dim):
    """Four steps through the swap (both pointer orders): every cell of
    every buffer equals the plain version's, and the wrapper makes two
    position tables, one message table and one phase-A work list."""
    tspec, tmesh, arrs = _mesh_fields(size, dim, 1, 31)
    plan = tir.build_plan(tspec, dim, tir.REMOTE_DMA, fused=True)
    want = mesh_state_from_jax(arrs, tspec, tmesh)
    got = mesh_state_from_jax(arrs, tspec, tmesh)
    card = FakeChunkCard(monkeypatch, [b for bl in got.values() for b in bl])
    card.radius = tspec.radius
    before = tfused.fused_jacobi_mesh.launches
    wc, wn, gc, gn = want["c"], want["n"], got["c"], got["n"]
    for _ in range(4):
        tfused.fused_jacobi_mesh_plain(wc, wn, want["s"], tspec, plan, tmesh)
        tfused.fused_jacobi_mesh(gc, gn, got["s"], tspec, plan, tmesh)
        wc, wn, gc, gn = wn, wc, gn, gc
    assert tfused.fused_jacobi_mesh.launches == before + 4
    assert sorted(card.made) == ["fused_rows", "mesh_messages", "mesh_positions",
                                 "mesh_positions"]
    for key in ("c", "n"):
        assert all(torch.equal(a, b) for a, b in zip(got[key], want[key])), key


@pytest.mark.parametrize("wire", ["bfloat16", "float8_e4m3fn"])
@pytest.mark.parametrize("size,dim", [FUSED_CASES[0], FUSED_CASES[3]],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_fused_mesh_tables_with_a_wire(monkeypatch, size, dim, wire):
    """Two fused steps with a wire: the wrapper flags the crossing boxes'
    rows and passes the wire's code; replayed through that wire, every cell
    of every buffer equals the plain version's with the wire."""
    tspec, tmesh, arrs = _mesh_fields(size, dim, 1, 36)
    plan = tir.build_plan(tspec, dim, tir.REMOTE_DMA, fused=True)
    want = mesh_state_from_jax(arrs, tspec, tmesh)
    got = mesh_state_from_jax(arrs, tspec, tmesh)
    card = FakeChunkCard(monkeypatch, [b for bl in got.values() for b in bl])
    card.radius = tspec.radius
    wc, wn, gc, gn = want["c"], want["n"], got["c"], got["n"]
    for _ in range(2):
        tfused.fused_jacobi_mesh_plain(wc, wn, want["s"], tspec, plan, tmesh, wire)
        tfused.fused_jacobi_mesh(gc, gn, got["s"], tspec, plan, tmesh, wire)
        wc, wn, gc, gn = wn, wc, gn, gc
    rows = [k for k in card.tables if isinstance(k, tuple) and k[0] == "fused_rows"]
    assert len(rows) == 1 and any(r[9] for r in rows[0][1])
    for key in ("c", "n"):
        for a, b in zip(got[key], want[key]):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=key)


@pytest.mark.parametrize("size,dim,k", [((16, 16, 16), (2, 2, 2), 3), ((24, 20, 16), (2, 1, 1), 2)],
                         ids=["222-k3", "211-k2"])
def test_persistent_mesh_tables_move_the_plain_versions_cells(monkeypatch, size, dim, k):
    tspec, tmesh, arrs = _mesh_fields(size, dim, k, 32)
    want = mesh_state_from_jax(arrs, tspec, tmesh)
    got = mesh_state_from_jax(arrs, tspec, tmesh)
    card = FakeChunkCard(monkeypatch, [b for bl in got.values() for b in bl])
    card.radius = tspec.radius
    before = tpers.persistent_jacobi_mesh.launches
    wc, wn, gc, gn = want["c"], want["n"], got["c"], got["n"]
    for _ in range(2):
        tpers.persistent_jacobi_mesh_plain(wc, wn, want["s"], tspec, k, tmesh)
        tpers.persistent_jacobi_mesh(gc, gn, got["s"], tspec, k, tmesh)
        if tpers.result_in_nxt(k):
            wc, wn, gc, gn = wn, wc, gn, gc
    assert tpers.persistent_jacobi_mesh.launches == before + 2
    # the cross-process form's tables, every position local
    assert sorted(card.made) == ["mesh_messages_across"] + ["mesh_positions"] * (
        1 + tpers.result_in_nxt(k))
    for key in ("c", "n"):
        assert all(torch.equal(a, b) for a, b in zip(got[key], want[key])), key


@pytest.mark.parametrize("size,dim,k", [((17, 19, 16), (2, 2, 2), 2), ((18, 20, 22), (1, 2, 4), 3)],
                         ids=["17x19x16-222-k2", "18x20x22-124-k3"])
def test_persistent_uneven_mesh_tables(monkeypatch, size, dim, k):
    """The uneven form's CUDA branch: one position table and one extent
    table (each position's own extent, flat order), no message table, and
    the plain version's cells in every buffer over two chunks through the
    swap; the launches counted as uneven."""
    tspec, tmesh, arrs = _mesh_fields(size, dim, k, 37)
    tex = tpar.HaloExchange(tspec, RDMA_T, mesh=tmesh)
    want = mesh_state_from_jax(arrs, tspec, tmesh)
    got = mesh_state_from_jax(arrs, tspec, tmesh)
    tex(want["c"])
    tex(got["c"])
    card = FakeChunkCard(monkeypatch, [b for bl in got.values() for b in bl])
    card.radius = tspec.radius
    before = (tpers.persistent_jacobi_mesh.launches, tpers.persistent_jacobi_mesh.uneven)
    wc, wn, gc, gn = want["c"], want["n"], got["c"], got["n"]
    for _ in range(2):
        tpers.persistent_jacobi_mesh_plain(wc, wn, want["s"], tspec, k, tmesh)
        tpers.persistent_jacobi_mesh(gc, gn, got["s"], tspec, k, tmesh)
        wc, wn, gc, gn = wn, wc, gn, gc
    assert (tpers.persistent_jacobi_mesh.launches, tpers.persistent_jacobi_mesh.uneven) == (
        before[0] + 2, before[1] + 2)
    assert sorted(card.made) == ["mesh_extents", "mesh_positions", "mesh_positions"]
    ext = [k_ for k_ in card.tables if isinstance(k_, tuple) and k_[0] == "mesh_extents"][0][1]
    assert ext == tpers.position_extents(tspec, tmesh) and len(set(ext)) > 1
    for key in ("c", "n"):
        assert all(torch.equal(a, b) for a, b in zip(got[key], want[key])), key


def test_one_block_persistent_is_the_one_position_case(monkeypatch):
    """The one-block wrapper builds a one-position table whose messages all
    wrap onto the block, and gives the plain version's cells."""
    spec = tgrid.GridSpec(tgeo.Dim3(16, 16, 14), tgeo.Dim3(1, 1, 1), tgeo.Radius.constant(2))
    p = spec.padded()
    rng = np.random.RandomState(33)
    c, n = (torch.from_numpy(rng.rand(1, 1, 1, p.z, p.y, p.x).astype(np.float32))
            for _ in range(2))
    s = torch.from_numpy(rng.randint(0, 3, (1, 1, 1, p.z, p.y, p.x)).astype(np.int32))
    wc, wn = c.clone(), n.clone()
    tpers.persistent_jacobi_plain(wc, wn, s, spec, 2)
    card = FakeChunkCard(monkeypatch, [c, n, s])
    card.radius = spec.radius
    monkeypatch.setattr(tpers, "_device_of", lambda *a: card)
    tpers.persistent_jacobi(c, n, s, spec, 2)
    assert torch.equal(c, wc) and torch.equal(n, wn)
    msgs = card.tables[("mesh_messages", ((0,),) * 26)]
    assert msgs.view(-1, 3)[:, :2].eq(0).all()


# -- what is still refused ------------------------------------------------------------------

def _domain(devices, variant, size=(16, 16, 16)):
    dd = DistributedDomain(*size, device="cpu")
    dd.set_devices(devices)
    dd.set_radius(2)
    dd.set_methods(RDMA_T)
    dd.set_fused_exchange(variant == "fused")
    dd.set_persistent_exchange(variant == "persistent")
    dd.add_data("t", "float32")
    return dd


@pytest.mark.parametrize("variant", ["fused", "persistent"])
def test_mesh_variants_on_distinct_devices_raise(monkeypatch, variant):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        _domain(["cuda:0"] * 4 + ["cuda:1"] * 4, variant).realize()


@pytest.mark.parametrize("variant", ["fused", "persistent"])
def test_mesh_variants_on_uneven_partitions_raise(variant):
    """Both variants run on an uneven partition. The persistent one takes
    the chunk kernel's uneven form (per chunk B6's deep exchange, then one
    chunk over every position at its own extent): 5 steps at k = 2 over 8
    positions of a 17 x 16 x 16 domain equal the JAX loop's on the gathered
    compute region, 2 dispatches a chunk. The fused one runs the JAX
    package's host-orchestrated schedule: 3 steps equal the JAX loop's on
    the gathered compute region and on the exchanged buffer's halo box at
    each block's own size."""
    if variant == "persistent":
        got, want, tex, jex, tspec, jspec = both_loops((17, 16, 16), (2, 2, 2), 2, 5, 41,
                                                       persistent=True, temporal_k=2)
        assert not tspec.is_uniform() and tex.persistent
        np.testing.assert_array_equal(compute(got["c"], jspec), compute(want["c"], jspec))
        assert tex.last_launches_per_chunk == jex.last_launches_per_chunk == 2
        return
    got, want, tex, _jex, tspec, jspec = both_loops((17, 16, 16), (2, 2, 2), 1, 3, 41,
                                                    fused=True)
    assert not tspec.is_uniform() and tex.fused
    for key in ("c", "n"):
        np.testing.assert_array_equal(compute(got[key], jspec), compute(want[key], jspec))
    off = tspec.compute_offset()
    for iz, iy, ix in np.ndindex(*tspec.stacked_shape_zyx()[:3]):
        s = tspec.block_size((ix, iy, iz))
        box = (iz, iy, ix, slice(off.z - 1, off.z + s.z + 1), slice(off.y - 1, off.y + s.y + 1),
               slice(off.x - 1, off.x + s.x + 1))
        np.testing.assert_array_equal(got["n"][box], want["n"][box])


# tests/test_persistent_stencil.py's uneven cases (against AXIS_COMPOSED
# there; here against the JAX persistent loop and its AXIS_COMPOSED loop)
UNEVEN_PERSISTENT = [("uneven-k2", (18, 20, 22), (1, 2, 4), 2, 6),
                     ("uneven-k3-tail1", (18, 20, 22), (1, 2, 4), 3, 7)]


@pytest.mark.parametrize("name,size,dim,k,iters", UNEVEN_PERSISTENT,
                         ids=[c[0] for c in UNEVEN_PERSISTENT])
def test_persistent_uneven_mesh_loop_matches_jax(name, size, dim, k, iters):
    """The uneven form over 8 positions of an 18 x 20 x 22 domain split
    (1,2,4) (z blocks 6/6/5/5): the gathered compute region equals the JAX
    persistent loop's and its composed loop's, 2 dispatches a chunk, tail
    chunks included; the result buffer's compute region at each position's
    own size is where ``result_in_nxt`` puts it."""
    got, want, tex, jex, tspec, jspec = both_loops(size, dim, k, iters, 50 + k, persistent=True,
                                                   temporal_k=k)
    assert not tspec.is_uniform()
    np.testing.assert_array_equal(compute(got["c"], jspec), compute(want["c"], jspec))
    assert tex.last_launches_per_chunk == jex.last_launches_per_chunk == 2
    jspec_mesh = jpar.grid_mesh(jgeo.Dim3(*dim), jax.devices()[:8])
    cex = jpar.HaloExchange(jspec, jspec_mesh, jpar.Method.AXIS_COMPOSED)
    arrs = start_state(jspec, size, 50 + k)
    js = {key: jax.device_put(v, NamedSharding(jspec_mesh, BLOCK_PSPEC)) for key, v in arrs.items()}
    cc, _ = jjac.make_jacobi_loop(cex, iters)(js["c"], js["n"], js["s"])
    np.testing.assert_array_equal(compute(got["c"], jspec), compute(np.asarray(cc), jspec))


@pytest.mark.parametrize("variant", ["fused", "persistent"])
def test_mesh_variants_with_wire_dtype_raise(variant):
    """The fused variant takes a wire over a mesh: 3 fused steps with bf16 on
    the wire equal the JAX loop's with it (both buffers, halos included).
    The persistent variant refuses it: the JAX package's two platforms
    diverge there (ROADMAP.md queue C)."""
    if variant == "fused":
        got, want, tex, jex, _ts, _js = both_loops((16, 16, 16), (2, 2, 2), 1, 3, 35, fused=True,
                                                   wire_dtype="bfloat16")
        assert tex.wire_dtype == jex.wire_dtype == "bfloat16"
        for key in ("c", "n"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        return
    spec = tgrid.GridSpec(tgeo.Dim3(16, 16, 16), tgeo.Dim3(2, 2, 2), tgeo.Radius.constant(2))
    with pytest.raises(NotImplementedError, match="wire_dtype=bfloat16 with the persistent "
                                                  "variant over a mesh: the JAX package diverges"):
        tpar.HaloExchange(spec, RDMA_T, mesh=tpar.DeviceMesh((2, 2, 2), ["cpu"] * 8),
                          wire_dtype="bfloat16", **{variant: True})


def test_mesh_wrappers_check_operands():
    tspec, tmesh, arrs = _mesh_fields((16, 16, 16), (2, 2, 2), 2, 34)
    st = mesh_state_from_jax(arrs, tspec, tmesh)
    plan = tir.build_plan(tspec, (2, 2, 2), tir.REMOTE_DMA, fused=True)
    c, n, s = st["c"], st["n"], st["s"]
    with pytest.raises(ValueError, match="for 8 positions"):
        tfused.fused_jacobi_mesh(c[:7], n, s, tspec, plan, tmesh)
    with pytest.raises(ValueError, match="distinct"):
        tpers.persistent_jacobi_mesh(c, c, s, tspec, 2, tmesh)
    # float64 fields: the kernels are float32, as the JAX package builds them
    with pytest.raises(NotImplementedError, match="float64.*float32.*Design divergences"):
        tpers.persistent_jacobi_mesh([b.double() for b in c], [b.double() for b in n], s, tspec,
                                     2, tmesh)
    with pytest.raises(NotImplementedError, match="fused_jacobi_mesh: float64"):
        tfused.fused_jacobi_mesh([b.double() for b in c], [b.double() for b in n], s, tspec,
                                 plan, tmesh)
    with pytest.raises(ValueError, match="float32"):
        tpers.persistent_jacobi_mesh([b.int() for b in c], [b.int() for b in n], s, tspec,
                                     2, tmesh)
    with pytest.raises(ValueError, match="k >= 2"):
        tpers.persistent_jacobi_mesh(c, n, s, tspec, 1, tmesh)
    with pytest.raises(ValueError, match="radius >= 3"):
        tpers.persistent_jacobi_mesh(c, n, s, tspec, 3, tmesh)
    spec2 = tgrid.GridSpec(tgeo.Dim3(16, 16, 16), tgeo.Dim3(2, 1, 1), tgeo.Radius.constant(2))
    with pytest.raises(ValueError, match="plan for mesh"):
        tfused.fused_jacobi_mesh(c, n, s, tspec,
                                 tir.build_plan(spec2, (2, 1, 1), tir.REMOTE_DMA, fused=True),
                                 tmesh)
    with pytest.raises(NotImplementedError, match="fused_jacobi_mesh"):
        tfused.fused_jacobi_plain(c[0], n[0], s[0], tspec, plan)
