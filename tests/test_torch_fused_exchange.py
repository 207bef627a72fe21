"""The port's fused remote-dma exchange over a mesh of block positions (the
fused exchange carrier, B7) against the JAX package's
``HaloExchange(..., Method.REMOTE_DMA, fused=True)`` on its 8-device CPU
mesh (``FusedRemoteEmulation`` off the TPU, pinned bit-identical to
AXIS_COMPOSED on every declared halo cell by the JAX package's own tests):
every cell of every quantity after one exchange and after ``make_loop(3)``,
the transfer count, and the wrapper's CPU branch and operand checks. Inputs
are random numpy arrays from a seed, noise in every halo and pad cell.
Tolerance: exact (data movement)."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import stencil_tpu.domain.grid as jgrid
import stencil_tpu.geometry as jgeo
import stencil_tpu.parallel as jpar
import stencil_tpu_torch.domain.grid as tgrid
import stencil_tpu_torch.geometry as tgeo
import stencil_tpu_torch.parallel as tpar
import stencil_tpu_torch.plan.ir as tir
from stencil_tpu.parallel.mesh import BLOCK_PSPEC
from stencil_tpu_torch.convert import mesh_state_from_jax, mesh_state_to_numpy
from stencil_tpu_torch.ops import fused_stencil

torch.set_num_threads(2)

F32, F64 = np.float32, np.float64

# the B6 cases (tests/test_torch_remote_dma.py), through the fused carrier
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


def run_both(size, dim, r, dtypes, loop=0, seed=0):
    """One fused exchange (or ``make_loop(loop)``) in each package from the
    same state; returns (port arrays, JAX arrays, port exchange, JAX
    exchange)."""
    tspec, jspec, tmesh, jmesh = pair(size, dim, r)
    arrs = noisy(jspec, dtypes, seed)
    jex = jpar.HaloExchange(jspec, jmesh, jpar.Method.REMOTE_DMA, fused=True)
    jstate = {k: jax.device_put(v, NamedSharding(jmesh, BLOCK_PSPEC)) for k, v in arrs.items()}
    jout = (jex.make_loop(loop) if loop else jex)(jstate)
    tex = tpar.HaloExchange(tspec, tpar.Method.REMOTE_DMA, mesh=tmesh, fused=True)
    tstate = mesh_state_from_jax(arrs, tspec, tmesh)
    (tex.make_loop(loop) if loop else tex)(tstate)
    return (mesh_state_to_numpy(tstate, tspec), {k: np.asarray(v) for k, v in jout.items()},
            tex, jex)


@pytest.mark.parametrize("name,size,dim,r,dtypes", CASES, ids=[c[0] for c in CASES])
def test_fused_exchange_matches_jax(name, size, dim, r, dtypes):
    got, want, tex, jex = run_both(size, dim, r, dtypes)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} q{k}")
    assert tex.last_transfer_count == jex._remote.last_transfer_count


def test_fused_make_loop_matches_jax():
    got, want, _tex, _jex = run_both((16, 16, 16), (2, 2, 2), 2, [F32, F32], loop=3, seed=3)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("nq", [1, 4])
def test_fused_transfer_count_is_q_independent_and_predicted(nq):
    """8 positions x 26 messages per dtype group, as the plan predicts
    (tests/test_fused_stencil.py's count)."""
    tspec, _jspec, tmesh, _jmesh = pair((16, 16, 16), (2, 2, 2), 1)
    ex = tpar.HaloExchange(tspec, tpar.Method.REMOTE_DMA, mesh=tmesh, fused=True)
    ex({q: tpar.shard_blocks(np.zeros((16, 16, 16), F32), tspec, tmesh) for q in range(nq)})
    assert ex.last_transfer_count == 8 * 26 == ex.plan.dmas_per_exchange(nq, 1) * 8


def test_fused_and_axis_carriers_agree_on_declared_halos():
    """Every compute and declared halo cell (the 26 exact-extent boxes) is
    the same after the fused exchange and after the axis carrier."""
    tspec, jspec, tmesh, _jmesh = pair((16, 16, 16), (2, 2, 2), 2)
    arrs = noisy(jspec, [F32], 5)
    out = {}
    for fused in (False, True):
        st = mesh_state_from_jax(arrs, tspec, tmesh)
        tpar.HaloExchange(tspec, tpar.Method.REMOTE_DMA, mesh=tmesh, fused=fused)(st)
        out[fused] = mesh_state_to_numpy(st, tspec)[0]
    plan = tir.build_plan(tspec, (2, 2, 2), tir.REMOTE_DMA, fused=True)
    boxes = [fused_stencil.box_slices(ph.src, ph.dst, ph.shape)[1] for ph in plan.fused_phases]
    off, b = tspec.compute_offset(), tspec.base
    boxes.append((..., slice(off.z, off.z + b.z), slice(off.y, off.y + b.y),
                  slice(off.x, off.x + b.x)))
    for box in boxes:
        np.testing.assert_array_equal(out[True][box], out[False][box])


def test_plain_version_is_the_kernel_wrappers_cpu_branch(monkeypatch):
    tspec, _jspec, tmesh, _jmesh = pair((16, 16, 16), (2, 2, 2), 1)
    calls = []
    monkeypatch.setattr(fused_stencil, "fused_exchange_plain", lambda *a: calls.append(len(a[0])))
    before = fused_stencil.fused_exchange.launches
    ex = tpar.HaloExchange(tspec, tpar.Method.REMOTE_DMA, mesh=tmesh, fused=True)
    ex({0: tpar.shard_blocks(np.zeros((16, 16, 16), F32), tspec, tmesh),
        1: tpar.shard_blocks(np.zeros((16, 16, 16), F64), tspec, tmesh)})
    assert calls == [8, 8] and fused_stencil.fused_exchange.launches == before


def test_fused_exchange_checks_operands():
    tspec, _jspec, tmesh, _jmesh = pair((16, 16, 16), (2, 2, 2), 1)
    plan = tir.build_plan(tspec, (2, 2, 2), tir.REMOTE_DMA, fused=True)
    blocks = [[b] for b in tpar.shard_blocks(np.zeros((16, 16, 16), F32), tspec, tmesh)]
    with pytest.raises(ValueError, match="positions"):
        fused_stencil.fused_exchange(blocks[:4], tspec, plan, tmesh)
    with pytest.raises(ValueError, match="plan for mesh"):
        fused_stencil.fused_exchange(blocks, tspec, tir.build_plan(
            tspec, (1, 1, 1), tir.REMOTE_DMA, fused=True, resident=tgeo.Dim3(1, 1, 1)), tmesh)
    with pytest.raises(ValueError, match="fused plan"):
        fused_stencil.fused_exchange(blocks, tspec, tir.build_plan(tspec, (2, 2, 2),
                                                                   tir.REMOTE_DMA), tmesh)
    with pytest.raises(ValueError, match="4- or 8-byte"):
        fused_stencil.fused_exchange([[b[0].half()] for b in blocks], tspec, plan, tmesh)
    meta = [[torch.zeros(b[0].shape, device="meta")] for b in blocks]
    with pytest.raises(ValueError):
        fused_stencil.fused_exchange(meta, tspec, plan, tpar.DeviceMesh((2, 2, 2), ["meta"] * 8))


def test_fused_exchange_table_moves_the_plain_versions_boxes(monkeypatch):
    """The table the CUDA branch uploads (the pointer rows, per direction
    group, position and quantity, then the work list of the plan's boxes,
    the x faces paired), replayed task by task as csrc/row_moves.cuh reads
    it, gives the plain version's result on every cell."""
    from test_torch_exchange_launch import replay_tables

    from stencil_tpu_torch.ops import remote_dma, row_moves

    for size, dim, r in (((16, 16, 16), (2, 2, 2), 2), ((16, 16, 20), (1, 1, 2), 1)):
        tspec, jspec, tmesh, _jmesh = pair(size, dim, r)
        arrs = noisy(jspec, [F64, F64], 12)
        plan = tir.build_plan(tspec, dim, tir.REMOTE_DMA, fused=True)
        st = mesh_state_from_jax(arrs, tspec, tmesh)
        want = [[st[k][i].clone() for k in st] for i in range(len(tmesh))]
        fused_stencil.fused_exchange_plain(want, tspec, plan, tmesh)
        got = [[st[k][i] for k in st] for i in range(len(tmesh))]
        blocks = {b.data_ptr(): b for g in got for b in g}
        tables = {}

        def upload(values, device):
            t = torch.tensor(values, dtype=torch.int64)
            tables[t.data_ptr()] = (t, t.tolist())
            return t

        def launch(ptrs, m, segs, nseg, tasks, item, code, _fmt, sz, sy, _st):
            assert code == 0
            table, cols = tables[ptrs][1], row_moves.MOVE_COLS
            head = (segs - ptrs) // 8
            # one pointer group per direction box, the -x face riding with +x
            assert head == 2 * m * (len(plan.fused_phases) - 1)
            assert len(table) == head + nseg * cols and item == 8 and m == 2 * len(tmesh)
            replay_tables(blocks, table[:head], m,
                          [table[i:i + cols] for i in range(head, len(table), cols)], tasks,
                          sz, sy)
            return 0

        monkeypatch.setattr(fused_stencil, "_check_mesh_blocks",
                            lambda *a: type("Card", (), {"type": "cuda", "index": 0})())
        # every call uploads its table: none is kept from another test's blocks
        monkeypatch.setattr(remote_dma._native, "kept", lambda key, make: make())
        monkeypatch.setattr(remote_dma._native, "upload", upload)
        monkeypatch.setattr(remote_dma._native, "stream_ptr", lambda dev: 0)
        monkeypatch.setattr(remote_dma._native, "lib", lambda name: type(
            "Lib", (), {"fused_exchange_launch": staticmethod(launch)}))
        before = fused_stencil.fused_exchange.launches
        fused_stencil.fused_exchange(got, tspec, plan, tmesh)
        assert fused_stencil.fused_exchange.launches == before + 1
        for ga, gb in zip(got, want):
            for a, b in zip(ga, gb):
                assert torch.equal(a, b), size
