"""DistributedDomain and jacobi3d over a mesh of 8 block positions (one block
each, every position on the CPU) against the JAX package's domain and app
on its 8 virtual CPU devices: the realized partition and regions, the
global scatter / exchange / gather round trip with every halo cell, state
conversion, 4 REMOTE_DMA jacobi steps (tests/test_remote_dma.py:205-228),
the app with and without weak scaling and its CLI, and the app's loud
refusals (the fused and persistent variants on a mesh:
tests/test_torch_mesh_variants.py). Inputs come from numpy seeds. Tolerance: bit-exact."""

import jax
import numpy as np
import pytest
import torch

import stencil_tpu.apps.jacobi3d as japp
import stencil_tpu.parallel as jpar
import stencil_tpu_torch.apps.jacobi3d as tapp
import stencil_tpu_torch.ops.jacobi as tjac
import stencil_tpu_torch.parallel as tpar
from stencil_tpu.api import DistributedDomain as JDomain
from stencil_tpu.ops.jacobi import INIT_TEMP, make_jacobi_loop, sphere_sel
from stencil_tpu_torch import DistributedDomain
from stencil_tpu_torch.convert import mesh_state_from_jax, mesh_state_to_numpy

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8
RDMA_T, RDMA_J = tpar.Method.REMOTE_DMA, jpar.Method.REMOTE_DMA


def domains(size=(16, 16, 16), radius=1, dtype="float32"):
    """(port domain, handle), (JAX domain, handle), both realized on 8."""
    tdd = DistributedDomain(*size, device="cpu")
    jdd = JDomain(*size)
    out = []
    for dd, devs, method in ((tdd, CPU8, RDMA_T), (jdd, jax.devices()[:8], RDMA_J)):
        dd.set_radius(radius)
        dd.set_methods(method)
        dd.set_devices(devs)
        h = dd.add_data("t", dtype)
        dd.realize()
        out.append((dd, h))
    return out


def test_domain_realizes_the_jax_partition_and_regions():
    for size in ((16, 16, 16), (32, 16, 24)):
        (tdd, _th), (jdd, _jh) = domains(size)
        assert tuple(tdd.spec.dim) == tuple(jdd.spec.dim)
        assert tdd.mesh.dim == tdd.spec.dim and len(tdd.mesh) == 8
        assert tdd.spec.stacked_shape_zyx() == jdd.spec.stacked_shape_zyx()
        assert [str(r) for r in tdd.get_interior()] == [str(r) for r in jdd.get_interior()]
        assert tdd.exchange_bytes_for_method(RDMA_T) == jdd.exchange_bytes_for_method(RDMA_J)
        assert tdd.exchange_bytes_moved() == jdd.exchange_bytes_moved()


def test_domain_scatter_exchange_gather_matches_jax():
    (tdd, th), (jdd, jh) = domains(radius=2, dtype="float64")
    g = np.random.RandomState(4).rand(16, 16, 16)
    tdd.set_curr_global(th, g)
    jdd.set_curr_global(jh, g)
    blocks = tdd.get_curr(th)
    assert len(blocks) == 8 and all(tuple(b.shape[:3]) == (1, 1, 1) for b in blocks)
    # the JAX state moves across as the port's own scatter of the same array
    moved = mesh_state_from_jax({"t": np.asarray(jdd.get_curr(jh))}, tdd.spec, tdd.mesh)["t"]
    assert all(torch.equal(a, b) for a, b in zip(moved, blocks))
    tdd.exchange()
    jdd.exchange()
    np.testing.assert_array_equal(tdd.get_curr_global(th), g)
    np.testing.assert_array_equal(mesh_state_to_numpy({"t": tdd.get_curr(th)}, tdd.spec)["t"],
                                  np.asarray(jdd.get_curr(jh)))
    loop = tdd.exchange_loop(2)
    loop(tdd.curr_state())
    np.testing.assert_array_equal(tdd.get_curr_global(th), g)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_jacobi_four_steps_match_jax(dtype):
    """16^3 over 8 positions, 4 REMOTE_DMA steps (the exchange and one sweep
    of every position a step) from the uniform start in float32, from a
    random field in float64; the JAX domain's mesh is ``grid_mesh`` over its
    8 CPU devices."""
    (tdd, th), (jdd, jh) = domains(dtype=dtype)
    start = (np.full((16, 16, 16), INIT_TEMP, np.float32) if dtype == "float32"
             else np.random.RandomState(16).rand(16, 16, 16))
    jdd.set_curr_global(jh, start)
    jsel = jpar.exchange.shard_blocks(sphere_sel((16, 16, 16)), jdd.spec, jdd.mesh)
    c = jdd.get_curr(jh)
    n = jax.device_put(jax.numpy.zeros_like(c), jdd.sharding())
    c, _n = make_jacobi_loop(jdd.halo_exchange, 4)(c, n, jsel)
    tdd.set_curr_global(th, start)
    sel = tjac.sphere_sel_blocks(tdd.spec, tdd.mesh)
    np.testing.assert_array_equal(mesh_state_to_numpy({"s": sel}, tdd.spec)["s"], np.asarray(jsel))
    loop = tjac.make_jacobi_loop(tdd.halo_exchange, 4)
    tc, _tn = loop(tdd.get_curr(th), tdd.get_next(th), sel)
    got = tpar.unshard_blocks(tc, tdd.spec)
    assert got.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, jpar.exchange.unshard_blocks(c, jdd.spec))


@pytest.fixture(scope="module")
def jax_app_run():
    """The JAX app on 8 devices, weak-scaled from 8^3 to 16^3, 3 steps."""
    return japp.run(8, 8, 8, devices=jax.devices()[:8], method=RDMA_J, iters=3)


@pytest.mark.parametrize("weak", [False, True])
def test_jacobi3d_on_8_positions_matches_jax_app(jax_app_run, weak):
    want = jax_app_run
    size = (8, 8, 8) if weak else (16, 16, 16)
    got = tapp.run(*size, devices=CPU8, method=RDMA_T, iters=3, weak=weak)
    assert (got["x"], got["y"], got["z"]) == (want["x"], want["y"], want["z"]) == (16, 16, 16)
    np.testing.assert_array_equal(got["domain"].get_curr_global(got["handle"]),
                                  want["domain"].get_curr_global(want["handle"]))
    assert tapp.csv_row(got).split(",")[:8] == japp.csv_row(want).split(",")[:8]
    assert got["devices"] == 8 and got["device_list"] == CPU8


def test_jacobi3d_cli_devices(capsys):
    assert tapp.main(["--x", "16", "--y", "16", "--z", "16", "--iters", "2", "--no-weak",
                      "--method", "remote-dma", "--devices", ",".join(CPU8)]) == 0
    row = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert row[:7] == ["jacobi3d", "remote-dma", "1", "8", "16", "16", "16"]
    with pytest.raises(SystemExit):
        tapp.main(["--devices", "cpu,cpu", "--device", "cpu"])


def test_mesh_app_refusals():
    """AXIS_COMPOSED over more blocks than positions and ``device`` with
    ``devices`` raise; AXIS_COMPOSED over one block a position (the app's
    default method) now runs, equal to the JAX app on 8 devices. More
    blocks than positions run by REMOTE_DMA: (2,2,2) blocks on 4 positions
    (two z residents a position, the JAX package's ``stack_residents``), 4
    steps in chunks of 2, equal to the JAX app on 4 devices (per step the
    exchange with every block an endpoint, then one sweep of every
    block)."""
    with pytest.raises(NotImplementedError, match="oversubscribed.*queue A item 5"):
        tapp.run(16, 16, 16, devices=["cpu"] * 4, iters=1, weak=False, partition=(2, 2, 2))
    comp = tapp.run(16, 16, 16, devices=CPU8, iters=2, weak=False)
    jcomp = japp.run(16, 16, 16, devices=jax.devices()[:8], iters=2, weak=False)
    assert tapp.csv_row(comp).split(",")[:2] == ["jacobi3d", "axis-composed"]
    np.testing.assert_array_equal(comp["domain"].get_curr_global(comp["handle"]),
                                  jcomp["domain"].get_curr_global(jcomp["handle"]))
    got = tapp.run(16, 16, 16, devices=["cpu"] * 4, method=RDMA_T, iters=4, chunk=2, weak=False,
                   partition=(2, 2, 2))
    want = japp.run(16, 16, 16, devices=jax.devices()[:4], method=RDMA_J, iters=4, chunk=2,
                    weak=False, partition=(2, 2, 2))
    assert tuple(got["domain"].mesh.dim) == (2, 2, 1)
    np.testing.assert_array_equal(got["domain"].get_curr_global(got["handle"]),
                                  want["domain"].get_curr_global(want["handle"]))
    assert tapp.csv_row(got).split(",")[:8] == japp.csv_row(want).split(",")[:8]
    with pytest.raises(ValueError, match="not both"):
        tapp.run(16, 16, 16, device="cpu", devices=CPU8, method=RDMA_T, iters=1)
