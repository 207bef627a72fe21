"""The port's remote-dma exchange over a mesh of block positions (the axis
carrier, B6) against the JAX package's REMOTE_DMA exchange on its 8-device
CPU mesh (``parallel/remote_emu.py`` off the TPU, pinned bit-identical to
AXIS_COMPOSED by the JAX package's own tests): the plan, every cell of
every quantity after one exchange and after ``make_loop(3)``, the transfer
count, the mesh exchange against the port's resident exchange, and the
loud refusals. Inputs are random numpy arrays from a seed, noise in every
halo and pad cell. Tolerance: exact (data movement)."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import stencil_tpu.domain.grid as jgrid
import stencil_tpu.geometry as jgeo
import stencil_tpu.parallel as jpar
import stencil_tpu.plan.ir as jir
import stencil_tpu_torch.domain.grid as tgrid
import stencil_tpu_torch.geometry as tgeo
import stencil_tpu_torch.parallel as tpar
import stencil_tpu_torch.plan.ir as tir
from stencil_tpu.parallel.mesh import BLOCK_PSPEC
from stencil_tpu_torch import DistributedDomain
from stencil_tpu_torch.domain import DataHandle
from stencil_tpu_torch.convert import mesh_state_from_jax, mesh_state_to_numpy
from stencil_tpu_torch.ops import remote_dma

torch.set_num_threads(2)

F32, F64 = np.float32, np.float64

# the uniform cases of tests/test_remote_dma.py's parity table, with the
# ring and self-wrap geometries of this slice
CASES = [
    ("222-r1-f32", (16, 16, 16), (2, 2, 2), 1, [F32]),
    ("222-r2-3xf32", (16, 16, 16), (2, 2, 2), 2, [F32, F32, F32]),
    ("211-r2-f64-pair", (24, 20, 16), (2, 1, 1), 2, [F64, F64]),
    ("112-r1-mixed", (16, 16, 20), (1, 1, 2), 1, [F32, F64, F32]),
]


def pair(size, dim, r):
    """(port spec, JAX spec, port mesh of CPU positions, JAX mesh)."""
    n = int(np.prod(dim))
    return (tgrid.GridSpec(tgeo.Dim3(*size), tgeo.Dim3(*dim), tgeo.Radius.constant(r)),
            jgrid.GridSpec(jgeo.Dim3(*size), jgeo.Dim3(*dim), jgeo.Radius.constant(r)),
            tpar.DeviceMesh(dim, ["cpu"] * n),
            jpar.grid_mesh(jgeo.Dim3(*dim), jax.devices()[:n]))


def noisy(jspec, dtypes, seed):
    rng = np.random.RandomState(seed)
    return {i: rng.rand(*jspec.stacked_shape_zyx()).astype(dt) for i, dt in enumerate(dtypes)}


def run_both(size, dim, r, dtypes, fused=False, loop=0, seed=0):
    """One exchange (or ``make_loop(loop)``) in each package from the same
    state; returns (port arrays, JAX arrays, port exchange, JAX exchange)."""
    tspec, jspec, tmesh, jmesh = pair(size, dim, r)
    arrs = noisy(jspec, dtypes, seed)
    jex = jpar.HaloExchange(jspec, jmesh, jpar.Method.REMOTE_DMA, fused=fused)
    jstate = {k: jax.device_put(v, NamedSharding(jmesh, BLOCK_PSPEC)) for k, v in arrs.items()}
    jout = (jex.make_loop(loop) if loop else jex)(jstate)
    tex = tpar.HaloExchange(tspec, tpar.Method.REMOTE_DMA, mesh=tmesh, fused=fused)
    tstate = mesh_state_from_jax(arrs, tspec, tmesh)
    (tex.make_loop(loop) if loop else tex)(tstate)
    return (mesh_state_to_numpy(tstate, tspec), {k: np.asarray(v) for k, v in jout.items()},
            tex, jex)


@pytest.mark.parametrize("name,size,dim,r,dtypes", CASES, ids=[c[0] for c in CASES])
def test_exchange_matches_jax(name, size, dim, r, dtypes):
    got, want, tex, jex = run_both(size, dim, r, dtypes)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} q{k}")
    assert tex.last_transfer_count == jex._remote.last_transfer_count


def test_make_loop_matches_jax():
    got, want, _tex, _jex = run_both((16, 16, 16), (2, 2, 2), 2, [F32, F32], loop=3, seed=3)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("nq", [1, 4])
def test_transfer_count_is_q_independent(nq):
    """8 positions x 2 slabs per active ring phase, per dtype group
    (tests/test_remote_dma.py:155-168)."""
    tspec, _jspec, tmesh, _jmesh = pair((16, 16, 16), (2, 2, 2), 1)
    ex = tpar.HaloExchange(tspec, tpar.Method.REMOTE_DMA, mesh=tmesh)
    state = {q: tpar.shard_blocks(np.zeros((16, 16, 16), F32), tspec, tmesh) for q in range(nq)}
    ex(state)
    assert ex.last_transfer_count == 48 == 8 * 6


@pytest.mark.parametrize("mesh", [(2, 2, 2), (2, 1, 1), (1, 1, 2)])
@pytest.mark.parametrize("r", [1, 2])
def test_remote_plan_matches_jax(mesh, r):
    size = (24, 20, 16)
    tspec = tgrid.GridSpec(tgeo.Dim3(*size), tgeo.Dim3(*mesh), tgeo.Radius.constant(r))
    jspec = jgrid.GridSpec(jgeo.Dim3(*size), jgeo.Dim3(*mesh), jgeo.Radius.constant(r))
    got = tir.build_plan(tspec, mesh, tir.REMOTE_DMA)
    want = jir.build_plan(jspec, mesh, jir.REMOTE_DMA)
    assert [(p.axis, p.ring, p.resident, p.dmas(), p.wire_cells, p.local_cells)
            for p in got.remote_phases] == \
        [(p.axis, p.ring, p.resident, p.dmas(), p.wire_cells, p.local_cells)
         for p in want.remote_phases]
    for q, g in ((1, 1), (4, 1), (4, 2)):
        assert got.dmas_per_exchange(q, g) == want.dmas_per_exchange(q, g)


def test_self_wrap_axes_go_through_the_fill_kernel_wrapper(monkeypatch):
    """(1,1,2): x and y have one position each, so those phases are fills
    of every position's blocks; z is the one ring phase."""
    from stencil_tpu_torch.ops import halo_fill

    fills, rings = [], []
    real_fill, real_ring = remote_dma.self_fill, remote_dma.remote_axis
    monkeypatch.setattr(remote_dma, "self_fill",
                        lambda b, s, a, **k: (fills.append((a, len(b))), real_fill(b, s, a, **k)))
    monkeypatch.setattr(remote_dma, "remote_axis",
                        lambda b, s, ph, m, wire, local=None: (
                            rings.append(ph.axis), real_ring(b, s, ph, m, wire, local)))
    tspec, _jspec, tmesh, _jmesh = pair((16, 16, 20), (1, 1, 2), 1)
    ex = tpar.HaloExchange(tspec, tpar.Method.REMOTE_DMA, mesh=tmesh)
    ex({q: tpar.shard_blocks(np.zeros((20, 16, 16), F32), tspec, tmesh) for q in range(9)})
    # 9 quantities x 2 positions = 18 blocks: launches of 16 and 2
    assert fills == [("x", 16), ("x", 2), ("y", 16), ("y", 2)]
    assert rings == ["z"]
    assert halo_fill.MAX_FILL_GROUP == 16


def test_mesh_exchange_equals_resident_exchange():
    """The mesh exchange gathered into the stacked (2,2,2) layout equals the
    port's resident AXIS_COMPOSED exchange of the same partition on every
    cell (16^3, r2, two quantities)."""
    tspec, jspec, tmesh, _jmesh = pair((16, 16, 16), (2, 2, 2), 2)
    arrs = noisy(jspec, [F32, F64], 7)
    mesh_state = mesh_state_from_jax(arrs, tspec, tmesh)
    tpar.HaloExchange(tspec, tpar.Method.REMOTE_DMA, mesh=tmesh)(mesh_state)
    stacked = {k: torch.from_numpy(v.copy()) for k, v in arrs.items()}
    tpar.HaloExchange(tspec)(stacked)
    for k in arrs:
        assert torch.equal(tpar.join_positions(mesh_state[k], tspec), stacked[k])


def test_plain_version_is_the_kernel_wrappers_cpu_branch(monkeypatch):
    tspec, _jspec, tmesh, _jmesh = pair((16, 16, 16), (2, 2, 2), 1)
    calls = []
    monkeypatch.setattr(remote_dma, "remote_axis_plain", lambda *a: calls.append(a[2].axis))
    before = remote_dma.remote_axis.launches
    ex = tpar.HaloExchange(tspec, tpar.Method.REMOTE_DMA, mesh=tmesh)
    ex({0: tpar.shard_blocks(np.zeros((16, 16, 16), F32), tspec, tmesh)})
    assert calls == ["x", "y", "z"] and remote_dma.remote_axis.launches == before


def test_remote_axis_checks_operands():
    tspec, _jspec, tmesh, _jmesh = pair((16, 16, 16), (2, 2, 2), 1)
    phase = tir.build_plan(tspec, (2, 2, 2), tir.REMOTE_DMA).remote_phases[0]
    blocks = [[b] for b in tpar.shard_blocks(np.zeros((16, 16, 16), F32), tspec, tmesh)]
    with pytest.raises(ValueError, match="positions"):
        remote_dma.remote_axis(blocks[:4], tspec, phase, tmesh)
    with pytest.raises(ValueError, match="dtype"):
        remote_dma.remote_axis(blocks[:7] + [[blocks[7][0].double()]], tspec, phase, tmesh)
    with pytest.raises(ValueError, match="4- or 8-byte"):
        remote_dma.remote_axis([[b[0].half()] for b in blocks], tspec, phase, tmesh)
    spec1 = tgrid.GridSpec(tgeo.Dim3(16, 16, 16), tgeo.Dim3(1, 2, 2), tgeo.Radius.constant(1))
    self_wrap = tir.build_plan(spec1, (1, 2, 2), tir.REMOTE_DMA).remote_phases[0]
    with pytest.raises(ValueError, match="self-wrap"):
        remote_dma.remote_axis(blocks[:4], spec1, self_wrap, tpar.DeviceMesh((1, 2, 2), ["cpu"] * 4))
    meta = [[torch.zeros(b[0].shape, device="meta")] for b in blocks]
    with pytest.raises(ValueError):
        remote_dma.remote_axis(meta, tspec, phase, tpar.DeviceMesh((2, 2, 2), ["meta"] * 8))


# -- loud refusals --------------------------------------------------------------------

def _domain(devices, method=tpar.Method.REMOTE_DMA, partition=None, size=(16, 16, 16)):
    dd = DistributedDomain(*size, device="cpu")
    dd.set_radius(1)
    dd.set_methods(method)
    dd.set_devices(devices)
    if partition is not None:
        dd.set_partition(partition)
    dd.add_data("t", "float32")
    return dd


def test_positions_on_distinct_cuda_devices_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    dd = _domain(["cuda:0"] * 4 + ["cuda:1"] * 4)
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        dd.realize()
    mesh = tpar.DeviceMesh((2, 2, 2), ["cuda:0"] * 7 + ["cuda:1"])
    assert not mesh.one_device
    spec = tgrid.GridSpec(tgeo.Dim3(16, 16, 16), tgeo.Dim3(2, 2, 2), tgeo.Radius.constant(1))
    with pytest.raises(NotImplementedError, match="distinct devices"):
        tpar.HaloExchange(spec, tpar.Method.REMOTE_DMA, mesh=mesh)


def test_more_blocks_than_positions_raise():
    """More blocks than positions now run: a domain of (2,2,2) blocks on 4
    positions stacks two z residents on each ((2,2,1) mesh, the JAX
    package's ``stack_residents``), and its exchange, every block an
    endpoint of the axis carrier, equals the JAX REMOTE_DMA exchange of the
    same domain on 4 devices on every cell."""
    dd = _domain(["cpu"] * 4, partition=(2, 2, 2))
    dd.realize()
    assert tuple(dd.mesh.dim) == (2, 2, 1) and tuple(dd.halo_exchange.resident) == (1, 1, 2)
    assert all(tuple(b.shape[:3]) == (2, 1, 1) for b in dd.get_curr(DataHandle(0)))
    rng = np.random.RandomState(12)
    field = rng.rand(16, 16, 16).astype(F32)
    dd.set_curr_global(DataHandle(0), field)
    dd.exchange()
    _tspec, jspec, _tm, _jm = pair((16, 16, 16), (2, 2, 2), 1)
    jmesh = jpar.grid_mesh(jgeo.Dim3(2, 2, 1), jax.devices()[:4])
    jex = jpar.HaloExchange(jspec, jmesh, jpar.Method.REMOTE_DMA)
    want = jex({0: jpar.exchange.shard_blocks(field, jspec, jmesh)})[0]
    got = mesh_state_to_numpy({0: dd.get_curr(DataHandle(0))}, dd.spec)[0]
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(dd.get_curr_global(DataHandle(0)), field)
    assert dd.halo_exchange.last_transfer_count == jex._remote.last_transfer_count


# tests/test_remote_dma.py's oversubscribed cases: (2,2,2) blocks on a
# (2,2,1) mesh, and an uneven split on a (2,1,2) mesh in fp64
OVERSUB = [("oversubscribed", (16, 16, 16), (2, 2, 2), (2, 2, 1), [F32, F32]),
           ("uneven-oversub-f64", (17, 16, 16), (2, 2, 2), (2, 1, 2), [F64, F64])]


@pytest.mark.parametrize("batch", [True, False], ids=["batched", "per-quantity"])
@pytest.mark.parametrize("name,size,dim,mesh_dim,dtypes", OVERSUB, ids=[c[0] for c in OVERSUB])
def test_oversubscribed_exchange_matches_jax(name, size, dim, mesh_dim, dtypes, batch):
    """Every cell of every quantity, and the copies that left a position,
    against the JAX package's emulation on 4 virtual devices; the mesh's
    stacks are views' owners (each block a view into its position's
    stack)."""
    tspec, jspec, _tm, _jm = pair(size, dim, 1)
    n = int(np.prod(mesh_dim))
    jmesh = jpar.grid_mesh(jgeo.Dim3(*mesh_dim), jax.devices()[:n])
    tmesh = tpar.DeviceMesh(mesh_dim, ["cpu"] * n)
    arrs = noisy(jspec, dtypes, 13)
    jex = jpar.HaloExchange(jspec, jmesh, jpar.Method.REMOTE_DMA, batch_quantities=batch)
    want = jex({k: jax.device_put(v, NamedSharding(jmesh, BLOCK_PSPEC)) for k, v in arrs.items()})
    tex = tpar.HaloExchange(tspec, tpar.Method.REMOTE_DMA, mesh=tmesh, batch_quantities=batch)
    st = mesh_state_from_jax(arrs, tspec, tmesh)
    assert [tuple(b.shape[:3]) for b in st[0]] == [tuple(tex.resident)[::-1]] * n
    tex(st)
    got = mesh_state_to_numpy(st, tspec)
    for k in arrs:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=name)
    assert tex.last_transfer_count == jex._remote.last_transfer_count > 0


def test_axis_composed_on_a_mesh_raises():
    with pytest.raises(NotImplementedError, match="REMOTE_DMA only"):
        _domain(["cpu"] * 8, method=tpar.Method.AXIS_COMPOSED).realize()


def test_uneven_partition_and_wire_dtype_raise():
    """Both now run. An uneven partition (x = 9 + 8) over 8 positions: the
    domain's exchange through B6's uneven ring equals the JAX REMOTE_DMA
    exchange on every cell. A wire over the mesh: the domain's exchange
    with bf16 on the wire equals the JAX REMOTE_DMA exchange with it on
    every cell."""
    tspec, jspec, tmesh, jmesh = pair((17, 16, 16), (2, 2, 2), 1)
    arrs = noisy(jspec, [F32], 17)
    want = jpar.HaloExchange(jspec, jmesh, jpar.Method.REMOTE_DMA)(
        {0: jax.device_put(arrs[0], NamedSharding(jmesh, BLOCK_PSPEC))})
    dd = _domain(["cpu"] * 8, size=(17, 16, 16))
    dd.realize()
    assert dd.spec.sizes_x == (9, 8)
    dd.set_curr(DataHandle(0, "t", "float32"), mesh_state_from_jax(arrs, tspec, tmesh)[0])
    dd.exchange()
    np.testing.assert_array_equal(mesh_state_to_numpy(dd.curr_state(), tspec)[0],
                                  np.asarray(want[0]))
    tspec, jspec, tmesh, jmesh = pair((16, 16, 16), (2, 2, 2), 1)
    arrs = noisy(jspec, [F32, F64], 13)
    jex = jpar.HaloExchange(jspec, jmesh, jpar.Method.REMOTE_DMA, wire_dtype="bfloat16")
    want = jex({k: jax.device_put(v, NamedSharding(jmesh, BLOCK_PSPEC)) for k, v in arrs.items()})
    dd = _domain(["cpu"] * 8)
    handles = [DataHandle(0, "t", "float32"), dd.add_data("b", "float64")]
    dd.set_wire_dtype("bfloat16")
    dd.realize()
    assert dd.halo_exchange.wire_dtype == "bfloat16" == dd.halo_exchange.plan.wire_dtype
    st = mesh_state_from_jax(arrs, tspec, tmesh)
    for i, h in enumerate(handles):
        dd.set_curr(h, st[i])
    dd.exchange()
    got = mesh_state_to_numpy(dd.curr_state(), tspec)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        assert not np.array_equal(got[k], arrs[k])


def test_mesh_shape_and_neighbours():
    mesh = tpar.DeviceMesh((2, 3, 4), ["cpu"] * 24)
    assert [mesh.index(mesh.position(i)) for i in range(24)] == list(range(24))
    assert mesh.position(7) == (1, 0, 1)
    assert mesh.ring_neighbors((0, 0, 3), "z") == ((0, 0, 2), (0, 0, 0))
    assert mesh.ring_neighbors((1, 2, 0), "y") == ((1, 1, 0), (1, 0, 0))
    assert mesh.ring_neighbors((0, 1, 1), "x") == ((1, 1, 1), (1, 1, 1))
    assert mesh.one_device and mesh.dim == tgeo.Dim3(2, 3, 4)
    assert mesh.destinations((0, 0, 1))[:3] == (6, 7, 8)
    assert mesh.destinations((-1, 0, 0)) == tuple(mesh.index(mesh.shifted(p, (-1, 0, 0)))
                                                  for p in mesh.positions())
    # the JAX mesh's device array has the same flat order
    jmesh = jpar.grid_mesh(jgeo.Dim3(2, 2, 2), jax.devices()[:8])
    tmesh = tpar.DeviceMesh((2, 2, 2), ["cpu"] * 8)
    for i, pos in enumerate(tmesh.positions()):
        ix, iy, iz = pos
        assert jmesh.devices[iz, iy, ix] == jax.devices()[i]
    with pytest.raises(ValueError, match="needs 8 devices"):
        tpar.DeviceMesh((2, 2, 2), ["cpu"] * 4)


# -- the kernel's pointer table, checked on the CPU --------------------------------

class FakeCard:
    """Stands in for the card in the CUDA branch of the mesh wrappers: the
    table the wrapper uploads is kept (none is kept from another test's
    blocks: the fake card keeps no launch), and a Python copy of the kernel
    applies it to the CPU blocks the pointers name, as the CUDA kernel
    would."""

    type, index = "cuda", 0

    def __init__(self, monkeypatch, module, blocks):
        self.tables = {}
        self.blocks = {b.data_ptr(): b for g in blocks for b in g}
        monkeypatch.setattr(module, "_check_mesh_blocks", lambda *a: self)
        monkeypatch.setattr(module._native, "kept", lambda key, make: make())
        monkeypatch.setattr(module._native, "upload", self.upload)
        monkeypatch.setattr(module._native, "stream_ptr", lambda dev: 0)

    def upload(self, values, device):
        t = torch.tensor(values, dtype=torch.int64)
        self.tables[t.data_ptr()] = (t, t.tolist())
        return t


def test_remote_axis_table_moves_the_plain_versions_slabs(monkeypatch):
    """The table the CUDA branch uploads (the pointer rows, per group's
    step, position and quantity, then the phase's work list), replayed task
    by task as csrc/row_moves.cuh reads it, gives the plain version's
    result on every cell."""
    from test_torch_exchange_launch import replay_tables

    for size, dim, r in (((16, 16, 16), (2, 2, 2), 2), ((24, 20, 16), (2, 1, 1), 1)):
        tspec, jspec, tmesh, _jmesh = pair(size, dim, r)
        arrs = noisy(jspec, [F32, F32, F32], 11)
        plan = tir.build_plan(tspec, dim, tir.REMOTE_DMA)
        for ph in (p for p in plan.remote_phases if p.ring > 1):
            st = mesh_state_from_jax(arrs, tspec, tmesh)
            want = [[st[k][i].clone() for k in st] for i in range(len(tmesh))]
            remote_dma.remote_axis_plain(want, tspec, ph, tmesh)
            got = [[st[k][i] for k in st] for i in range(len(tmesh))]
            card = FakeCard(monkeypatch, remote_dma, got)

            def launch(ptrs, m, segs, nseg, tasks, item, code, _fmt, sz, sy, _st):
                assert code == 0
                table, cols = card.tables[ptrs][1], remote_dma.row_moves.MOVE_COLS
                head = (segs - ptrs) // 8  # the pointer rows: one group in x, two in y and z
                assert head == 2 * m * (1 if ph.axis == "x" else 2) and item == 4
                assert len(table) == head + nseg * cols and m == len(tmesh) * 3
                rows = [table[i:i + cols] for i in range(head, len(table), cols)]
                replay_tables(card.blocks, table[:head], m, rows, tasks, sz, sy)
                return 0

            monkeypatch.setattr(remote_dma._native, "lib", lambda name: type(
                "Lib", (), {"remote_axis_launch": staticmethod(launch)}))
            before = remote_dma.remote_axis.launches
            remote_dma.remote_axis(got, tspec, ph, tmesh)
            assert remote_dma.remote_axis.launches == before + 1
            for ga, gb in zip(got, want):
                for a, b in zip(ga, gb):
                    assert torch.equal(a, b), (size, ph.axis)


@pytest.mark.parametrize("name,size,dim,mesh_dim,dtypes", OVERSUB, ids=[c[0] for c in OVERSUB])
def test_oversubscribed_jacobi_loop_matches_jax(name, size, dim, mesh_dim, dtypes):
    """3 plain remote-dma steps over more blocks than positions: per step
    the exchange (every block an endpoint) and one sweep of every block,
    each a view into its position's stack; the gathered compute region
    equals the JAX loop's on 4 devices (fp32, and fp64 uneven)."""
    import stencil_tpu.ops.jacobi as jjac
    import stencil_tpu_torch.ops.jacobi as tjac

    tspec, jspec, _tm, _jm = pair(size, dim, 1)
    n = int(np.prod(mesh_dim))
    jmesh = jpar.grid_mesh(jgeo.Dim3(*mesh_dim), jax.devices()[:n])
    tmesh = tpar.DeviceMesh(mesh_dim, ["cpu"] * n)
    rng = np.random.RandomState(14)
    shape = jspec.stacked_shape_zyx()
    arrs = {"c": rng.rand(*shape).astype(dtypes[0]), "n": rng.rand(*shape).astype(dtypes[0]),
            "s": np.asarray(jpar.exchange.shard_blocks(jjac.sphere_sel(size), jspec, jmesh))}
    jex = jpar.HaloExchange(jspec, jmesh, jpar.Method.REMOTE_DMA)
    js = {k: jax.device_put(v, NamedSharding(jmesh, BLOCK_PSPEC)) for k, v in arrs.items()}
    jc, _ = jjac.make_jacobi_loop(jex, 3)(js["c"], js["n"], js["s"])
    tex = tpar.HaloExchange(tspec, tpar.Method.REMOTE_DMA, mesh=tmesh)
    ts = mesh_state_from_jax(arrs, tspec, tmesh)
    tc, _ = tjac.make_jacobi_loop(tex, 3)(ts["c"], ts["n"], ts["s"])
    np.testing.assert_array_equal(tpar.unshard_blocks(tc, tspec),
                                  jpar.exchange.unshard_blocks(jc, jspec), err_msg=name)
