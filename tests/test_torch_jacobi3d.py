"""The port's slice end to end against the JAX package on the CPU: the
jacobi3d app (multistep passes plus a sweep tail) and the single-device
halo exchange. Tolerance: bit-exact."""

import jax
import numpy as np
import pytest
import torch

import stencil_tpu.apps.jacobi3d as japp
import stencil_tpu_torch.apps.jacobi3d as tapp
from stencil_tpu.domain.grid import GridSpec as JGridSpec
from stencil_tpu.geometry import Dim3 as JDim3
from stencil_tpu.geometry import Radius as JRadius
from stencil_tpu.parallel import HaloExchange as JHaloExchange
from stencil_tpu.parallel import grid_mesh
from stencil_tpu.parallel.exchange import shard_blocks as jshard
from stencil_tpu.parallel.exchange import unshard_blocks as junshard
from stencil_tpu_torch import DistributedDomain
from stencil_tpu_torch.convert import state_from_jax, state_to_numpy

torch.set_num_threads(2)


@pytest.mark.parametrize("size,iters,chunk", [((32, 24, 20), 19, 10), ((20, 16, 12), 7, None)])
def test_jacobi3d_matches_jax(size, iters, chunk):
    """Chunks of 10 at nz=20 run one multistep pass of k=9 and a 1-step
    tail; chunks of 7 at nz=12 run one pass of k=5 and a 2-step tail."""
    got = tapp.run(*size, iters=iters, weak=False, device="cpu", chunk=chunk)
    want = japp.run(*size, iters=iters, weak=False, devices=jax.devices()[:1], chunk=chunk)
    assert got["temporal_k"] >= 2 and (chunk or iters) % got["temporal_k"] != 0
    a = got["domain"].get_curr_global(got["handle"])
    b = want["domain"].get_curr_global(want["handle"])
    assert a.dtype == np.float32 and a.shape == size[::-1]
    np.testing.assert_array_equal(a, b)
    assert tapp.csv_row(got).split(",")[:8] == japp.csv_row(want).split(",")[:8]
    assert got["exchange_bytes"] == want["exchange_bytes"]


def test_exchange_matches_jax():
    """Radius 3, four fp32 quantities and one fp64, full padded arrays
    (halos, edges, corners and dead pad), state carried through convert."""
    size = (20, 12, 10)
    r = 3
    p_spec = JGridSpec(JDim3(*size), JDim3(1, 1, 1), JRadius.constant(r))
    mesh = grid_mesh(p_spec.dim, jax.devices()[:1])
    jex = JHaloExchange(p_spec, mesh)
    rng = np.random.RandomState(0)
    globs = {i: rng.rand(*size[::-1]).astype(np.float32) for i in range(4)}
    globs[4] = rng.rand(*size[::-1]).astype(np.float64)
    jstate = {i: jshard(g, p_spec, mesh) for i, g in globs.items()}
    # halos carry noise before the exchange, so every filled cell is checked
    noise = {i: rng.rand(*p_spec.stacked_shape_zyx()).astype(g.dtype) for i, g in globs.items()}
    off = p_spec.compute_offset()
    region = (0, 0, 0, slice(off.z, off.z + size[2]), slice(off.y, off.y + size[1]),
              slice(off.x, off.x + size[0]))
    for i in globs:
        noise[i][region] = np.asarray(jstate[i])[region]
        jstate[i] = jax.device_put(noise[i], jstate[i].sharding)

    dd = DistributedDomain(*size, device="cpu")
    dd.set_radius(r)
    handles = [dd.add_data(f"q{i}", "float32") for i in range(4)]
    handles.append(dd.add_data("q4", "float64"))
    dd.realize()
    assert dd.spec.stacked_shape_zyx() == p_spec.stacked_shape_zyx()
    for h, t in zip(handles, state_from_jax(noise, dd.spec, "cpu").values()):
        dd.set_curr(h, t)

    want = {i: np.asarray(a) for i, a in jex(jstate).items()}
    dd.exchange()
    got = state_to_numpy({h.idx: dd.get_curr(h) for h in handles})
    for i in globs:
        assert got[i].dtype == want[i].dtype
        np.testing.assert_array_equal(got[i], want[i])
    assert dd.exchange_bytes_for_method(dd.halo_exchange.method) == \
        jex.bytes_logical([4, 4, 4, 4, 8])
    assert dd.exchange_bytes_moved() == jex.bytes_moved([4, 4, 4, 4, 8])
    # idempotent on exchanged data; the loop runs the same fills
    dd.exchange_loop(2)(dd.curr_state())
    again = state_to_numpy({h.idx: dd.get_curr(h) for h in handles})
    for i in globs:
        np.testing.assert_array_equal(again[i], want[i])


def test_domain_global_roundtrip_and_regions():
    dd = DistributedDomain(12, 10, 8, device="cpu")
    dd.set_radius(2)
    h = dd.add_data("t", "float64")
    dd.realize()
    g = np.random.RandomState(1).rand(8, 10, 12)
    dd.set_curr_global(h, g)
    np.testing.assert_array_equal(dd.get_curr_global(h), g)
    dd.swap()
    assert not dd.get_curr_global(h).any()
    (interior,) = dd.get_interior()
    (exteriors,) = dd.get_exterior()
    assert interior.num_points() + sum(e.num_points() for e in exteriors) == 12 * 10 * 8


def test_multi_block_raises():
    """Several devices under the axis-composed method realize a mesh of
    one block a position (copies between positions); more blocks than
    positions by it raise (ROADMAP.md queue A item 5); an uneven partition
    (every block on the one device, x blocks of 6/5/5) and a uniform one
    realize."""
    three = DistributedDomain(16, 16, 16, device="cpu")
    three.set_partition((3, 1, 1))
    three.add_data("t", "float32")
    three.realize()
    assert three.spec.sizes_x == (6, 5, 5) and three.halo_exchange.oversubscribed
    assert [r.extent().x for r in three.get_interior()] == [6, 5, 5]
    dd = DistributedDomain(16, 16, 16, device="cpu")
    two = DistributedDomain(16, 16, 16, device="cpu")
    two.set_devices(["cpu", "cpu"])
    two.add_data("t", "float32")
    two.realize()
    assert two.mesh is not None and len(two.mesh) == 2 and not two.halo_exchange.oversubscribed
    over = DistributedDomain(16, 16, 16, device="cpu")
    over.set_devices(["cpu", "cpu"])
    over.set_partition((4, 1, 1))
    over.add_data("t", "float32")
    with pytest.raises(NotImplementedError, match="oversubscribed.*ROADMAP.md queue A item 5"):
        over.realize()
    dd.set_partition((2, 1, 1))
    dd.add_data("t", "float32")
    dd.realize()
    assert dd.halo_exchange.oversubscribed and len(dd.get_interior()) == 2


@pytest.mark.parametrize("iters", [4, 7])
def test_float64_loop_matches_jax(iters):
    """make_jacobi_loop on a float64 one-block domain on the CPU (multistep
    passes of k=3 plus a sweep tail) against the JAX package's XLA loop."""
    import stencil_tpu.ops.jacobi as jjac
    import stencil_tpu_torch.ops.jacobi as tjac

    size = (18, 14, 12)
    jspec = JGridSpec(JDim3(*size), JDim3(1, 1, 1), JRadius.constant(1))
    mesh = grid_mesh(jspec.dim, jax.devices()[:1])
    field = np.random.RandomState(iters).rand(*size[::-1])
    jsel = jshard(jjac.sphere_sel(size), jspec, mesh)
    jc, _ = jjac.make_jacobi_loop(JHaloExchange(jspec, mesh), iters, use_pallas=False)(
        jshard(field, jspec, mesh), jshard(np.zeros_like(field), jspec, mesh), jsel)
    dd = DistributedDomain(*size, device="cpu")
    dd.set_radius(1)
    h = dd.add_data("t", "float64")
    dd.realize()
    dd.set_curr_global(h, field)
    loop = tjac.make_jacobi_loop(dd.halo_exchange, iters)
    assert loop.temporal_k == 3
    tc, _ = loop(dd.get_curr(h), dd.get_next(h), state_from_jax({"s": np.asarray(jsel)}, dd.spec,
                                                                "cpu")["s"])
    dd.set_curr(h, tc)
    got = dd.get_curr_global(h)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, junshard(jc, jspec))
