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
@pytest.mark.parametrize("radius,aligned", [
    pytest.param(r, a, id=r if a else f"{r}-unaligned")
    for a in (True, False) for r in ("r1", "r3", "asym")])
def test_composed_fill_matches_wrap_fill_batched(radius, aligned, dtype):
    def rad(g):
        if radius == "asym":
            r = g.Radius.constant(0)
            for d, v in (((-1, 0, 0), 1), ((1, 0, 0), 3), ((0, -1, 0), 2),
                         ((0, 1, 0), 1), ((0, 0, -1), 3), ((0, 0, 1), 2)):
                r.set_dir(d, v)
            return r
        return g.Radius.constant(int(radius[1:]))

    ts = tgrid.GridSpec(tgeo.Dim3(20, 12, 10), tgeo.Dim3(1, 1, 1), rad(tgeo), aligned=aligned)
    js = jgrid.GridSpec(jgeo.Dim3(20, 12, 10), jgeo.Dim3(1, 1, 1), rad(jgeo), aligned=aligned)
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


def _layout_radius(geo, name):
    if name == "asym":
        r = geo.Radius.constant(0)
        for d, v in (((-1, 0, 0), 1), ((1, 0, 0), 3), ((0, -1, 0), 2), ((0, 1, 0), 1),
                     ((0, 0, -1), 3), ((0, 0, 1), 2)):
            r.set_dir(d, v)
        return r
    return geo.Radius.constant(int(name[1:]))


def _layout_cells(lay):
    """(destination, source) flat word indices of every copy in ``lay``."""
    dst, src = [], []
    for i in range(lay.count):
        base = i * lay.stride
        for d, s, w in lay.runs:
            dst.append(np.arange(base + d, base + d + w))
            src.append(np.arange(base + s, base + s + w))
    return np.concatenate(dst), np.concatenate(src)


@pytest.mark.parametrize("z_stack", [1, 3])
@pytest.mark.parametrize("elem", [4, 8])
@pytest.mark.parametrize("radius", ["r1", "r3", "r5", "asym"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_fill_layout_covers_the_plain_fill(axis, aligned, radius, elem, z_stack):
    """The runs of ``fill_layout`` write exactly the cells the plain fill
    changes, each from the cell the plain fill reads, and its vector width
    divides every start, length and stride and is the widest that does."""
    spec = tgrid.GridSpec(tgeo.Dim3(13, 11, 9), tgeo.Dim3(1, 1, 1),
                          _layout_radius(tgeo, radius), aligned=aligned)
    if axis == "z" and z_stack > 1:
        with pytest.raises(ValueError, match="z-stack"):
            tfill.fill_layout(spec, axis, elem, z_stack)
        return
    lay = tfill.fill_layout(spec, axis, elem, z_stack)
    p = spec.padded()
    dtype = torch.float32 if elem == 4 else torch.float64
    before = torch.arange(z_stack * p.z * p.y * p.x, dtype=dtype).reshape(z_stack, p.z, p.y, p.x)
    after = tfill.self_fill_plain([before.clone()], spec, axis)[0].reshape(-1)
    changed = np.flatnonzero((after != before.reshape(-1)).numpy())
    dst, src = _layout_cells(lay)
    assert len(np.unique(dst)) == len(dst)
    np.testing.assert_array_equal(np.sort(dst), changed)
    np.testing.assert_array_equal(after.numpy()[dst], src.astype(after.numpy().dtype))
    assert lay.body == ("rows" if axis == "x" else "runs")
    words = [lay.stride] + [v for run in lay.runs for v in run]
    width = lay.vec * elem
    assert width in (elem, 8, 16) and width >= elem
    assert all(v % lay.vec == 0 for v in words)
    if width < 16:
        assert any(v * elem % (2 * width) for v in words)
    # the pointers' alignment caps the width
    assert tfill.fill_layout(spec, axis, elem, z_stack, ptr_align=elem).vec == 1


def test_fill_layout_vector_widths():
    """The main paths' layouts: 16-byte runs for y and z at 512^3 r3 fp32,
    single words at the x row ends, 16-byte row ends at r4 fp32; and the
    x sector floor of 4 sectors a row at 512^3 r3."""
    spec = tgrid.GridSpec(tgeo.Dim3(512, 512, 512), tgeo.Dim3(1, 1, 1), tgeo.Radius.constant(3))
    assert [tfill.fill_layout(spec, a, 4).vec for a in "xyz"] == [1, 4, 4]
    assert [tfill.fill_layout(spec, a, 8).vec for a in "xyz"] == [1, 2, 2]
    x = tfill.fill_layout(spec, "x", 4)
    assert x.count == 518 * 528 and x.stride == 640
    assert tfill.fill_sector_bytes(x, 4) == 4 * 32 * x.count
    for a in "yz":
        lay = tfill.fill_layout(spec, a, 4)
        assert tfill.fill_sector_bytes(lay, 4) == tfill.fill_bytes(spec, a, 4)
    spec4 = tgrid.GridSpec(tgeo.Dim3(64, 64, 64), tgeo.Dim3(1, 1, 1), tgeo.Radius.constant(4))
    assert tfill.fill_layout(spec4, "x", 4).vec == 4
