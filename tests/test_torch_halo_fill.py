"""The port's self-wrap halo fill against the JAX package's: the fill
(through its wrapper's CPU branch, i.e. the plain PyTorch version) against
``make_self_fill(..., interpret=True)``, and the composed x -> y -> z fill
against ``wrap_fill_batched``. Tolerance: bit-exact (pure data movement)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stencil_tpu.domain.grid as jgrid
import stencil_tpu.geometry as jgeo
import stencil_tpu.ops.halo_fill as jfill
import stencil_tpu_torch.domain.grid as tgrid
import stencil_tpu_torch.geometry as tgeo
import stencil_tpu_torch.ops.halo_fill as tfill

torch.set_num_threads(2)


def specs(size, radius_fn):
    return (
        tgrid.GridSpec(tgeo.Dim3(*size), tgeo.Dim3(1, 1, 1), radius_fn(tgeo)),
        jgrid.GridSpec(jgeo.Dim3(*size), jgeo.Dim3(1, 1, 1), radius_fn(jgeo)),
    )


def asym(geo, axis):
    r = geo.Radius.constant(0)
    lo = {"x": (-1, 0, 0), "y": (0, -1, 0), "z": (0, 0, -1)}[axis]
    r.set_dir(lo, 1)
    r.set_dir(tuple(-c for c in lo), 3)
    return r


def random_blocks(spec, n, seed, dtype=np.float32):
    p = spec.padded()
    rng = np.random.RandomState(seed)
    return [rng.rand(p.z, p.y, p.x).astype(dtype) for _ in range(n)]


CASES = [((256, 136, 24), 1), ((140, 160, 40), 2), ((256, 144, 30), 3)]


@pytest.mark.parametrize("axis", ["x", "y", "z"])
@pytest.mark.parametrize("size,r", CASES)
def test_fill_matches_pallas(size, r, axis):
    ts, js = specs(size, lambda g: g.Radius.constant(r))
    (base,) = random_blocks(ts, 1, seed=r)
    want = np.asarray(jfill.make_self_fill(js, axis, interpret=True)(jnp.asarray(base)))
    (got,) = tfill.self_fill([torch.from_numpy(base.copy())], ts, axis)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_fill_asymmetric_matches_pallas(axis):
    ts, js = specs((140, 160, 40), lambda g: asym(g, axis))
    (base,) = random_blocks(ts, 1, seed=3)
    want = np.asarray(jfill.make_self_fill(js, axis, interpret=True)(jnp.asarray(base)))
    (got,) = tfill.self_fill([torch.from_numpy(base.copy())], ts, axis)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_fill_three_quantities_matches_pallas(axis):
    ts, js = specs((140, 160, 40), lambda g: g.Radius.constant(2))
    bases = random_blocks(ts, 3, seed=5)
    want = jfill.make_self_fill(js, axis, interpret=True, nq=3)(*[jnp.asarray(b) for b in bases])
    got = tfill.self_fill([torch.from_numpy(b.copy()) for b in bases], ts, axis)
    for q in range(3):
        np.testing.assert_array_equal(got[q].numpy(), np.asarray(want[q]))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("radius", ["r1", "r3", "asym"])
def test_composed_fill_matches_wrap_fill_batched(radius, dtype):
    def rad(g):
        if radius == "asym":
            r = g.Radius.constant(0)
            for d, v in (((-1, 0, 0), 1), ((1, 0, 0), 3), ((0, -1, 0), 2),
                         ((0, 1, 0), 1), ((0, 0, -1), 3), ((0, 0, 1), 2)):
                r.set_dir(d, v)
            return r
        return g.Radius.constant(int(radius[1:]))

    ts, js = specs((20, 12, 10), rad)
    p = ts.padded()
    base = np.random.RandomState(11).rand(2, p.z, p.y, p.x).astype(dtype)
    want = np.asarray(jfill.wrap_fill_batched(js, jnp.asarray(base)))
    got = torch.from_numpy(base.copy())
    for axis in tfill.AXIS_ORDER:
        tfill.self_fill([got[i] for i in range(2)], ts, axis)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tfill.wrap_fill_batched(ts, torch.from_numpy(base.copy())).numpy(), want)


def test_dtype_groups_and_carriers():
    state = {"a": torch.zeros(2, dtype=torch.float32), "b": torch.zeros(2, dtype=torch.float64),
             "c": torch.ones(2, dtype=torch.float32)}
    assert tfill.dtype_groups(state) == [(torch.float32, ["a", "c"]), (torch.float64, ["b"])]
    slabs = [torch.arange(3.0), torch.arange(3.0) + 10]
    carrier = tfill.pack_slabs(slabs)
    assert carrier.shape == (2, 3)
    assert all(torch.equal(a, b) for a, b in zip(tfill.unpack_slabs(carrier, 2), slabs))
    assert tfill.pack_slabs(slabs[:1]) is slabs[0]
    assert tfill.unpack_slabs(slabs[0], 1)[0] is slabs[0]
