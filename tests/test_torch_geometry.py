"""The port's geometry and grid layout against the JAX package's: partitions,
padded shapes, offsets, block sizes and origins, halo and region rects must
be identical over a sweep of sizes, partitions and radii."""

import itertools

import pytest
import torch

import stencil_tpu.domain.grid as jgrid
import stencil_tpu.geometry as jgeo
import stencil_tpu_torch.domain.grid as tgrid
import stencil_tpu_torch.geometry as tgeo

torch.set_num_threads(2)

SIZES = [(512, 512, 512), (32, 24, 20), (140, 160, 40), (17, 9, 31), (128, 16, 12)]
DIMS = [(1, 1, 1), (2, 1, 1), (1, 2, 2), (2, 2, 2), (3, 1, 2)]
RADII = ["r1", "r3", "asym", "tight_x", "fec"]


def make_radius(geo, kind: str):
    if kind == "r1":
        return geo.Radius.constant(1)
    if kind == "r3":
        return geo.Radius.constant(3)
    if kind == "asym":
        r = geo.Radius.constant(0)
        for d, v in (((-1, 0, 0), 1), ((1, 0, 0), 3), ((0, -1, 0), 2),
                     ((0, 1, 0), 1), ((0, 0, -1), 3), ((0, 0, 1), 2)):
            r.set_dir(d, v)
        return r
    if kind == "tight_x":
        return geo.Radius.constant(2).without_x()
    return geo.Radius.face_edge_corner(2, 1, 0)


def rect_t(r):
    return (r.lo.as_tuple(), r.hi.as_tuple())


@pytest.mark.parametrize("radius", RADII)
def test_radius_matches(radius):
    tr, jr = make_radius(tgeo, radius), make_radius(jgeo, radius)
    for d in itertools.product((-1, 0, 1), repeat=3):
        assert tr.dir(d) == jr.dir(d)
    assert tr.max_radius() == jr.max_radius()
    assert [d.as_tuple() for d in tgeo.DIRECTIONS_26] == [d.as_tuple() for d in jgeo.DIRECTIONS_26]


@pytest.mark.parametrize("n", [1, 2, 6, 8, 12, 30, 97])
def test_partitions_match(n):
    assert tgeo.prime_factors(n) == jgeo.prime_factors(n)
    assert tgeo.decompose_zy(n).as_tuple() == jgeo.decompose_zy(n).as_tuple()
    for size in SIZES:
        tp, jp = tgeo.RankPartition(size, n), jgeo.RankPartition(size, n)
        assert tp.dim().as_tuple() == jp.dim().as_tuple()
        for i in range(tp.dim().flatten()):
            idx = tp.dimensionize(i)
            assert idx.as_tuple() == jp.dimensionize(i).as_tuple()
            assert tp.subdomain_size(idx).as_tuple() == jp.subdomain_size(idx.as_tuple()).as_tuple()
            assert tp.subdomain_origin(idx).as_tuple() == jp.subdomain_origin(idx.as_tuple()).as_tuple()
        for kind in RADII:
            for nodes in (1, 2):
                tn = tgeo.NodePartition(size, make_radius(tgeo, kind), nodes, n)
                jn = jgeo.NodePartition(size, make_radius(jgeo, kind), nodes, n)
                assert tn.dim().as_tuple() == jn.dim().as_tuple()
                assert tn.sys_dim().as_tuple() == jn.sys_dim().as_tuple()
                d = tn.dim()
                for idx in itertools.product(range(d.x), range(d.y), range(d.z)):
                    assert tn.subdomain_size(idx).as_tuple() == jn.subdomain_size(idx).as_tuple()
                    assert tn.subdomain_origin(idx).as_tuple() == jn.subdomain_origin(idx).as_tuple()


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("radius", RADII)
@pytest.mark.parametrize("size", SIZES)
def test_gridspec_matches(size, radius, aligned):
    for dim in DIMS:
        if any(s < d for s, d in zip(size, dim)):
            continue
        ts = tgrid.GridSpec(tgeo.Dim3(*size), tgeo.Dim3(*dim), make_radius(tgeo, radius), aligned)
        js = jgrid.GridSpec(jgeo.Dim3(*size), jgeo.Dim3(*dim), make_radius(jgeo, radius), aligned)
        assert ts.padded().as_tuple() == js.padded().as_tuple()
        assert ts.compute_offset().as_tuple() == js.compute_offset().as_tuple()
        assert ts.stacked_shape_zyx() == js.stacked_shape_zyx()
        assert ts.is_uniform() == js.is_uniform()
        assert ts.base.as_tuple() == js.base.as_tuple()
        for idx in itertools.product(range(dim[0]), range(dim[1]), range(dim[2])):
            assert ts.block_size(idx).as_tuple() == js.block_size(idx).as_tuple()
            assert ts.block_origin(idx).as_tuple() == js.block_origin(idx).as_tuple()
        for d in tgeo.DIRECTIONS_26:
            for halo in (True, False):
                assert rect_t(ts.halo_rect(d, halo=halo)) == rect_t(js.halo_rect(d.as_tuple(), halo=halo))
        off_t, off_j = ts.compute_offset(), js.compute_offset()
        comp_t = tgeo.Rect3(off_t, off_t + ts.base)
        comp_j = jgeo.Rect3(off_j, off_j + js.base)
        it = tgeo.interior_region(comp_t, ts.radius)
        ij = jgeo.interior_region(comp_j, js.radius)
        assert rect_t(it) == rect_t(ij)
        assert [rect_t(r) for r in tgeo.exterior_regions(comp_t, it)] == \
            [rect_t(r) for r in jgeo.exterior_regions(comp_j, ij)]
