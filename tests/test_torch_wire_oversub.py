"""The narrowed wire on an oversubscribed mesh (more blocks than
positions), in the port on ``["cpu"] * n`` positions against the JAX
package on as many of its virtual CPU devices: only the slabs that leave a
position round through the wire, the shifts between the residents of one
position stay bit copies (``ops/remote_dma.remote_axis_local``). Each case
equals both JAX methods, REMOTE_DMA (its emulation: ``m > 1``) and
AXIS_COMPOSED (``_permute_wire``), on every cell, with JAX REMOTE_DMA's
``last_transfer_count``: (4,2,2) blocks on (2,2,2) positions, and (2,2,2)
blocks on (1,2,2) positions, whose x ring is one position holding two
residents (nothing crosses on x). jacobi3d over (4,2,2) blocks on 8
positions with an e5m2 wire equals the JAX app's. Inputs are seeded numpy
fields (fp32, fp64 and int32 quantities, noise in every halo and pad
cell). Tolerance: bit-exact, NaN equal to NaN."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import stencil_tpu.apps.jacobi3d as japp
import stencil_tpu.domain.grid as jgrid
import stencil_tpu.geometry as jgeo
import stencil_tpu.parallel as jpar
import stencil_tpu_torch.apps.jacobi3d as tapp
import stencil_tpu_torch.domain.grid as tgrid
import stencil_tpu_torch.geometry as tgeo
import stencil_tpu_torch.parallel as tpar
from stencil_tpu.parallel.mesh import BLOCK_PSPEC
from stencil_tpu_torch.convert import mesh_state_from_jax, mesh_state_to_numpy

torch.set_num_threads(2)

F32, F64, I32 = np.float32, np.float64, np.int32
RDMA_T = tpar.Method.REMOTE_DMA

# (id, global size, partition, mesh)
CASES = [("422-on-222", (16, 16, 16), (4, 2, 2), (2, 2, 2)),
         ("222-on-122", (16, 16, 16), (2, 2, 2), (1, 2, 2))]


def _fields(jspec, seed):
    rng = np.random.RandomState(seed)
    shape = jspec.stacked_shape_zyx()
    wide = rng.standard_normal(shape) * 2.0 ** rng.uniform(-12, 9, shape)
    return {0: wide.astype(F32), 1: (wide * (1 + 2.0 ** -30)).astype(F64),
            2: rng.randint(-2 ** 30, 2 ** 30, shape).astype(I32)}


@functools.lru_cache(maxsize=None)
def jax_exchange(case, wire, method):
    """The JAX exchange of :func:`_fields` with ``wire`` by ``method`` (a
    Method's value): (arrays, REMOTE_DMA's last_transfer_count or None)."""
    _id, size, part, mesh_dim = next(c for c in CASES if c[0] == case)
    jspec = jgrid.GridSpec(jgeo.Dim3(*size), jgeo.Dim3(*part), jgeo.Radius.constant(2))
    n = int(np.prod(mesh_dim))
    jmesh = jpar.grid_mesh(jgeo.Dim3(*mesh_dim), jax.devices()[:n])
    jex = jpar.HaloExchange(jspec, jmesh, jpar.Method(method), wire_dtype=wire)
    out = jex({k: jax.device_put(v, NamedSharding(jmesh, BLOCK_PSPEC))
               for k, v in _fields(jspec, 50).items()})
    count = jex._remote.last_transfer_count if method == "remote-dma" else None
    return {k: np.asarray(v) for k, v in out.items()}, count


def port_exchange(case, wire):
    _id, size, part, mesh_dim = next(c for c in CASES if c[0] == case)
    tspec = tgrid.GridSpec(tgeo.Dim3(*size), tgeo.Dim3(*part), tgeo.Radius.constant(2))
    jspec = jgrid.GridSpec(jgeo.Dim3(*size), jgeo.Dim3(*part), jgeo.Radius.constant(2))
    tmesh = tpar.DeviceMesh(mesh_dim, ["cpu"] * int(np.prod(mesh_dim)))
    tex = tpar.HaloExchange(tspec, RDMA_T, mesh=tmesh, wire_dtype=wire)
    assert tex.oversubscribed and tex.wire_dtype == wire
    st = mesh_state_from_jax(_fields(jspec, 50), tspec, tmesh)
    tex(st)
    return mesh_state_to_numpy(st, tspec), tex.last_transfer_count


@pytest.mark.parametrize("wire", ["bfloat16", "float8_e5m2", "float4_e2m1fn"])
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_oversubscribed_wire_matches_both_jax_methods(case, wire):
    """Every cell of every quantity equals JAX REMOTE_DMA's and
    AXIS_COMPOSED's exchange with the same wire; the int32 quantity is
    moved bit for bit; the wire rounded something; the transfer count is
    JAX REMOTE_DMA's."""
    got, count = port_exchange(case, wire)
    rdma, jcount = jax_exchange(case, wire, "remote-dma")
    composed, _ = jax_exchange(case, wire, "axis-composed")
    native, native_count = port_exchange(case, None)
    for k in got:
        np.testing.assert_array_equal(got[k], rdma[k], err_msg=f"{case} {wire} q{k}")
        np.testing.assert_array_equal(got[k], composed[k], err_msg=f"{case} {wire} q{k}")
        if k == 2:
            np.testing.assert_array_equal(got[k], native[k])
        else:
            assert not np.array_equal(got[k], native[k], equal_nan=True)
    assert count == jcount == native_count > 0


def test_resident_shifts_stay_lossless():
    """(2,2,2) blocks on (1,2,2) positions: x's two residents of a position
    hand their slabs to each other, so the x halos of the compute rows
    equal the unnarrowed exchange's (y and z's then carry them across
    rounded, so only the compute rows are compared); y's halos, which
    cross, did round."""
    got, _ = port_exchange("222-on-122", "float8_e5m2")
    native, _ = port_exchange("222-on-122", None)
    spec = tgrid.GridSpec(tgeo.Dim3(16, 16, 16), tgeo.Dim3(2, 2, 2), tgeo.Radius.constant(2))
    off, b = spec.compute_offset(), spec.base
    zs, ys = slice(off.z, off.z + b.z), slice(off.y, off.y + b.y)
    for k in (0, 1):
        for xs in (slice(off.x - 2, off.x), slice(off.x + b.x, off.x + b.x + 2)):
            np.testing.assert_array_equal(got[k][..., zs, ys, xs], native[k][..., zs, ys, xs])
        halo = (..., zs, slice(off.y - 2, off.y), slice(off.x, off.x + b.x))
        assert not np.array_equal(got[k][halo], native[k][halo])


def field(r):
    return r["domain"].get_curr_global(r["handle"])


def test_jacobi3d_oversubscribed_wire_matches_jax_app():
    """16^3 as (4,2,2) blocks on 8 positions, 5 steps in chunks of 2 with an
    e5m2 wire: the gathered field equals the JAX app's, and differs from
    the unnarrowed run."""
    kw = dict(iters=5, chunk=2, weak=False, partition=(4, 2, 2))
    got = tapp.run(16, 16, 16, devices=["cpu"] * 8, method=RDMA_T, wire_dtype="float8_e5m2",
                   **kw)
    want = japp.run(16, 16, 16, devices=jax.devices()[:8], method=jpar.Method.REMOTE_DMA,
                    wire_dtype="float8_e5m2", **kw)
    assert got["domain"].halo_exchange.oversubscribed
    np.testing.assert_array_equal(field(got), field(want))
    assert not np.array_equal(field(got), field(tapp.run(16, 16, 16, devices=["cpu"] * 8,
                                                         method=RDMA_T, **kw)))
