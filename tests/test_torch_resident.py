"""Multi-block domains with every block resident on one device, in the port
against the JAX package on one CPU device (``grid_mesh(Dim3(1, 1, 1))`` with
a multi-block spec, the JAX package's oversubscribed layout): the exchange
on every halo cell, the plan IR, the deep-halo multistep's plain version
against the interpreted Pallas kernels (full-plane and row-tiled forms), the
z-stack fill, the jacobi step and loop, the app, and state conversion.
Inputs come from numpy seeds. Tolerance: bit-exact on every compared cell."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stencil_tpu.apps.jacobi3d as japp
import stencil_tpu.domain.grid as jgrid
import stencil_tpu.geometry as jgeo
import stencil_tpu.ops.halo_fill as jfill
import stencil_tpu.ops.jacobi as jjac
import stencil_tpu.ops.pallas_stencil as jps
import stencil_tpu.parallel as jpar
import stencil_tpu.plan.ir as jir
import stencil_tpu_torch.apps.jacobi3d as tapp
import stencil_tpu_torch.domain.grid as tgrid
import stencil_tpu_torch.geometry as tgeo
import stencil_tpu_torch.ops.halo_fill as tfill
import stencil_tpu_torch.ops.jacobi as tjac
import stencil_tpu_torch.ops.stencil_kernels as tk
import stencil_tpu_torch.parallel as tpar
import stencil_tpu_torch.plan.ir as tir
from stencil_tpu_torch import DistributedDomain
from stencil_tpu_torch.convert import state_from_jax, state_to_numpy

torch.set_num_threads(2)

PARTS = [(2, 2, 2), (1, 1, 2), (2, 1, 1), (1, 2, 2)]


def radius(geo, kind):
    if isinstance(kind, int):
        return geo.Radius.constant(kind)
    r = geo.Radius.constant(0)
    for d, v in (((-1, 0, 0), 1), ((1, 0, 0), 2), ((0, -1, 0), 3), ((0, 1, 0), 1),
                 ((0, 0, -1), 2), ((0, 0, 1), 3)):
        r.set_dir(d, v)
    r.set_edge(1)
    r.set_corner(1)
    return r


def specs(size, part, rad):
    return (tgrid.GridSpec(tgeo.Dim3(*size), tgeo.Dim3(*part), radius(tgeo, rad)),
            jgrid.GridSpec(jgeo.Dim3(*size), jgeo.Dim3(*part), radius(jgeo, rad)))


def one_device(jspec):
    """The JAX resident mesh: every block of ``jspec`` on one CPU device."""
    return jpar.grid_mesh(jgeo.Dim3(1, 1, 1), jax.devices()[:1])


def noisy_state(jspec, dtypes, seed):
    """{i: stacked numpy array}: random everywhere, halos and pad included,
    so every filled cell is checked."""
    rng = np.random.RandomState(seed)
    return {i: rng.rand(*jspec.stacked_shape_zyx()).astype(dt) for i, dt in enumerate(dtypes)}


# -- the exchange --------------------------------------------------------------------

# one fp32 quantity; four quantities of which one fp64 (a group of one fp64
# quantity beside a group of three fp32 ones)
STATES = {"f32": [np.float32], "mixed4": [np.float32, np.float64, np.float32, np.float32]}


@pytest.mark.parametrize("state", sorted(STATES))
@pytest.mark.parametrize("rad", [1, 2, 3, "asym"])
@pytest.mark.parametrize("part", PARTS)
def test_exchange_matches_jax(part, rad, state):
    """Every cell of every quantity after one exchange, and after a second
    (idempotent) one; the byte accounting."""
    tspec, jspec = specs((12, 16, 20), part, rad)
    mesh = one_device(jspec)
    jex = jpar.HaloExchange(jspec, mesh)
    tex = tpar.HaloExchange(tspec)
    assert tuple(tex.resident) == tuple(jex.resident) == part
    arrays = noisy_state(jspec, STATES[state], seed=len(state) + 7 * part[0] + part[2])
    tstate = state_from_jax(arrays, tspec, "cpu")
    want = jex({i: jax.device_put(a, jex.sharding()) for i, a in arrays.items()})
    tex(tstate)
    got = state_to_numpy(tstate)
    for i in arrays:
        assert got[i].dtype == arrays[i].dtype
        np.testing.assert_array_equal(got[i], np.asarray(want[i]))
    tex.make_loop(2)(tstate)
    for i, v in state_to_numpy(tstate).items():
        np.testing.assert_array_equal(v, np.asarray(want[i]))
    items = [a.dtype.itemsize for a in arrays.values()]
    assert tex.bytes_logical(items) == jex.bytes_logical(items)
    assert tex.bytes_moved(items) == jex.bytes_moved(items)


@pytest.mark.parametrize("part", [(2, 2, 2), (1, 1, 2)])
def test_exchange_axis_subset_matches_jax(part):
    """``exchange(state, axes=...)``: the multi-block phases only, as the
    deep-halo loop runs them (JAX: ``exchange_blocks(axes=...)``)."""
    tspec, jspec = specs((12, 16, 20), part, 2)
    mesh = one_device(jspec)
    jex = jpar.HaloExchange(jspec, mesh)
    names = tuple(n for n, d in zip("zyx", part[::-1]) if d > 1)
    (arr,) = noisy_state(jspec, [np.float32], seed=5).values()
    fn = jax.jit(jax.shard_map(lambda b: jex.exchange_blocks({0: b}, axes=names)[0],
                               mesh=mesh, in_specs=jpar.mesh.BLOCK_PSPEC,
                               out_specs=jpar.mesh.BLOCK_PSPEC))
    want = np.asarray(fn(jax.device_put(arr, jex.sharding())))
    t = torch.from_numpy(arr.copy())
    tpar.HaloExchange(tspec).exchange(t, axes=names)
    np.testing.assert_array_equal(t.numpy(), want)


TORCH_DTYPE = {np.float32: torch.float32, np.float64: torch.float64}


@pytest.mark.parametrize("part,dtypes", [((2, 2, 1), [np.float32] * 5),
                                         ((2, 1, 1), STATES["mixed4"]),
                                         ((1, 1, 2), STATES["mixed4"]),
                                         ((1, 1, 1), [np.float32] * 17)])
def test_self_wrap_axes_go_through_the_fill_wrapper(monkeypatch, part, dtypes):
    """Under any residency every self-wrap axis is filled by ``self_fill``
    (the kernel's wrapper; never the plain version directly), at most 16
    tensors per launch: x and y over each quantity's residents as one
    z-stack, z over each resident as a block of its own. Every cell equals
    the JAX exchange."""
    tspec, jspec = specs((12, 16, 20), part, 2)
    calls = []
    orig = tpar.exchange.self_fill

    def recording(blocks, spec, axis, z_stack=1):
        calls.append((axis, len(blocks), z_stack, blocks[0].dtype))
        return orig(blocks, spec, axis, z_stack=z_stack)

    monkeypatch.setattr(tpar.exchange, "self_fill", recording)
    jex = jpar.HaloExchange(jspec, one_device(jspec))
    arrays = noisy_state(jspec, dtypes, seed=11)
    tstate = state_from_jax(arrays, tspec, "cpu")
    want = jex({i: jax.device_put(a, jex.sharding()) for i, a in arrays.items()})
    tpar.HaloExchange(tspec)(tstate)
    for i, v in state_to_numpy(tstate).items():
        np.testing.assert_array_equal(v, np.asarray(want[i]))
    nres = int(np.prod(part))
    for axis, d in zip("xyz", part):
        mine = [c for c in calls if c[0] == axis]
        if d > 1:
            assert not mine
            continue
        assert all(1 <= n <= tfill.MAX_FILL_GROUP for _a, n, _z, _d in mine)
        for dt in set(dtypes):
            nq = dtypes.count(dt)
            per = [(n, z) for _a, n, z, cdt in mine if cdt == TORCH_DTYPE[dt]]
            if axis == "z" and nres > 1:
                assert sum(n for n, _z in per) == nq * nres and {z for _n, z in per} == {1}
            else:
                assert sum(n for n, _z in per) == nq and {z for _n, z in per} == {nres}


def test_exchange_refusals():
    """REMOTE_DMA on resident blocks now runs: the axis carrier over every
    block equals the axis-composed exchange on every cell, under the
    REMOTE_DMA plan's accounting (no copy leaves the device). The uneven
    (1,1,2) split of z = 21 (11 + 10) builds, as an exchange equal to the
    JAX package's on every cell and as a domain."""
    tspec, jspec = specs((12, 16, 20), (2, 2, 2), 1)
    (arr,) = noisy_state(jspec, [np.float32], seed=20).values()
    rdma, comp = torch.from_numpy(arr.copy()), torch.from_numpy(arr.copy())
    ex = tpar.HaloExchange(tspec, tpar.Method.REMOTE_DMA)
    ex(rdma)
    tpar.HaloExchange(tspec)(comp)
    assert torch.equal(rdma, comp)
    assert [p.axis for p in ex.plan.remote_phases] == ["x", "y", "z"]
    assert ex.plan.dmas_per_exchange() == ex.last_transfer_count == 0
    tspec, jspec = specs((12, 16, 21), (1, 1, 2), 1)
    tex, jex = tpar.HaloExchange(tspec), jpar.HaloExchange(jspec, one_device(jspec))
    (arr,) = noisy_state(jspec, [np.float32], seed=21).values()
    want = jex({0: jax.device_put(arr, jex.sharding())})[0]
    t = torch.from_numpy(arr.copy())
    tex(t)
    np.testing.assert_array_equal(t.numpy(), np.asarray(want))
    dd = DistributedDomain(12, 16, 21, device="cpu")
    dd.set_partition((1, 1, 2))
    dd.add_data("t", "float32")
    dd.realize()
    assert dd.spec.sizes_z == (11, 10)


# -- the plan IR ---------------------------------------------------------------------

def plain(v):
    if isinstance(v, tuple):
        return tuple(plain(e) for e in v)
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


@pytest.mark.parametrize("rad", [1, 3, "asym"])
@pytest.mark.parametrize("part", PARTS + [(2, 2, 1)])
def test_resident_plan_matches_jax(part, rad):
    """``build_plan(spec, (1,1,1), AXIS_COMPOSED, resident=spec.dim)``, field
    by field, and the plan the port's exchange builds."""
    tspec, jspec = specs((12, 16, 20), part, rad)
    got = tir.build_plan(tspec, tgeo.Dim3(1, 1, 1), tir.AXIS_COMPOSED, resident=tspec.dim)
    want = jir.build_plan(jspec, jgeo.Dim3(1, 1, 1), jir.AXIS_COMPOSED, resident=jspec.dim)
    for f in dataclasses.fields(got):
        assert plain(getattr(got, f.name)) == plain(getattr(want, f.name)), f.name
    assert plain(tpar.HaloExchange(tspec).plan.axis_phases) == plain(want.axis_phases)
    assert got.describe() == want.describe()
    assert got.collectives_per_exchange(4, 2) == want.collectives_per_exchange(4, 2) == 0


def test_stack_residents_matches_jax():
    from stencil_tpu.geometry.partition import stack_residents as jstack

    for part in PARTS + [(2, 2, 1), (4, 1, 2), (3, 2, 1)]:
        n = part[0] * part[1] * part[2]
        for c in (c for c in range(1, n + 1) if n % c == 0):
            try:
                want = jstack(jgeo.Dim3(*part), c)
            except ValueError as e:
                with pytest.raises(ValueError, match="cannot stack"):
                    tgeo.stack_residents(tgeo.Dim3(*part), c)
                assert "cannot stack" in str(e)
                continue
            got = tgeo.stack_residents(tgeo.Dim3(*part), c)
            assert (got.x, got.y, got.z) == (want.x, want.y, want.z)


# -- the deep-halo multistep ----------------------------------------------------------

def _origins(spec):
    d, b = spec.dim, spec.base
    for iz in range(d.z):
        for iy in range(d.y):
            for ix in range(d.x):
                yield (iz, iy, ix), (iz * b.z, iy * b.y, ix * b.x)


MULTI_CASES = [
    ((16, 16, 24), (2, 2, 2), 2, 2, None),
    ((24, 16, 20), (1, 1, 2), 3, 3, None),
    ((24, 16, 20), (1, 1, 2), 3, 3, 16),
    ((32, 24, 14), (2, 1, 1), 2, 2, 8),
    ((16, 24, 22), (1, 2, 2), 2, 2, None),
    # the spheres (radius 12) cross the periodic z boundary of the z split
    ((128, 16, 20), (1, 1, 2), 2, 2, None),
    ((128, 16, 20), (1, 1, 2), 2, 2, 8),
]


@pytest.mark.parametrize("size,part,r,k,rows", MULTI_CASES)
def test_deep_halo_multistep_matches_pallas(size, part, r, k, rows):
    """The plain deep-halo multistep over the whole stack against the
    interpreted Pallas kernel run per block at its global origin
    (``rows=None``: the full-plane form, pallas_stencil.py:709; else the
    row-tiled form, :993), from random fields with noise in every halo."""
    tspec, jspec = specs(size, part, r)
    (curr,) = noisy_state(jspec, [np.float32], seed=k + len(size)).values()
    fn = jps.make_pallas_jacobi_multistep(jspec, k, interpret=True, rows=rows)
    got = tk.multistep(torch.from_numpy(curr.copy()), torch.zeros(curr.shape), tspec, k).numpy()
    off, b = tspec.compute_offset(), tspec.base
    cs = (slice(off.z, off.z + b.z), slice(off.y, off.y + b.y), slice(off.x, off.x + b.x))
    for idx, org in _origins(tspec):
        want = np.asarray(fn(jnp.asarray(org, jnp.int32), jnp.asarray(curr[idx]),
                             jnp.zeros(curr.shape[3:], jnp.float32)))
        np.testing.assert_array_equal(got[idx][cs], want[cs])


def test_deep_halo_multistep_refusals():
    tspec, _ = specs((16, 16, 24), (2, 2, 2), 1)
    c = torch.zeros(tspec.stacked_shape_zyx())
    with pytest.raises(ValueError, match="radius >= k"):
        tk.multistep(c, torch.zeros_like(c), tspec, 2)
    tspec, _ = specs((16, 16, 8), (1, 1, 2), 2)
    c = torch.zeros(tspec.stacked_shape_zyx())
    with pytest.raises(ValueError, match="too shallow"):
        tk.multistep(c, torch.zeros_like(c), tspec, 2)
    with pytest.raises(ValueError, match="shape"):
        tk.multistep(c[:, :, :, :1], torch.zeros_like(c), tspec, 1)


def test_sweep_region_matches_jax_region_sweep():
    """A shell rect of every block, halos read in place, sel spheres
    imposed: the JAX package's region sweep."""
    tspec, jspec = specs((16, 16, 24), (2, 2, 2), 2)
    (curr,) = noisy_state(jspec, [np.float32], seed=3).values()
    sel = np.random.RandomState(4).randint(0, 3, size=curr.shape).astype(np.int32)
    off = tspec.compute_offset()
    for lo, hi in (((0, 0, 0), (8, 8, 2)), ((0, 6, 0), (8, 8, 12)), ((1, 2, 3), (5, 7, 11))):
        rect = tgeo.Rect3(off + tgeo.Dim3(*lo), off + tgeo.Dim3(*hi))
        jrect = jgeo.Rect3(jspec.compute_offset() + jgeo.Dim3(*lo),
                           jspec.compute_offset() + jgeo.Dim3(*hi))
        masks = (jnp.asarray(sel == 1), jnp.asarray(sel == 2))
        want = np.asarray(jax.jit(lambda s, o: jjac.jacobi_sweep(s, o, jrect, masks))(
            jnp.asarray(curr), jnp.zeros_like(curr)))
        got = tk.sweep_region(torch.from_numpy(curr.copy()), torch.zeros(curr.shape),
                              torch.from_numpy(sel), tspec, rect).numpy()
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="outside"):
        tk.sweep_region(torch.from_numpy(curr), torch.zeros(curr.shape), torch.from_numpy(sel),
                        tspec, tgeo.Rect3(off, off + tgeo.Dim3(9, 1, 1)))


# -- the z-stack fill ------------------------------------------------------------------

@pytest.mark.parametrize("axis", ["x", "y"])
def test_z_stack_fill_matches_pallas(axis):
    """``make_self_fill(z_stack=2)`` on the (2 * pz, py, px) view of a
    (1, 1, 2) stack, and the port's fill over the stack."""
    tspec, jspec = specs((140, 160, 40), (1, 1, 2), 2)
    (arr,) = noisy_state(jspec, [np.float32], seed=11).values()
    p = jspec.padded()
    fill = jfill.make_self_fill(jspec, axis, interpret=True, z_stack=2)
    want = np.asarray(fill(jnp.asarray(arr.reshape(2 * p.z, p.y, p.x)))).reshape(arr.shape)
    (got,) = tfill.self_fill([torch.from_numpy(arr.copy())], tspec, axis, z_stack=2)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="z_stack"):
        tfill.self_fill([torch.from_numpy(arr.copy())], tspec, "z", z_stack=2)


# -- the jacobi step and loop -----------------------------------------------------------

def _jacobi_pair(size, part, r, seed, dtype=np.float32):
    tspec, jspec = specs(size, part, r)
    mesh = one_device(jspec)
    jex = jpar.HaloExchange(jspec, mesh)
    rng = np.random.RandomState(seed)
    field = rng.rand(*size[::-1]).astype(dtype)
    jsel = jpar.exchange.shard_blocks(jjac.sphere_sel(jgeo.Dim3(*size)), jspec, mesh)
    return tspec, jspec, mesh, jex, field, jsel


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("size,part,r,iters,dtype", [
    ((16, 16, 24), (2, 2, 2), 2, 5, np.float32),
    ((20, 16, 24), (1, 1, 2), 3, 7, np.float32),
    ((24, 24, 24), (2, 2, 2), 4, 7, np.float64),   # deep_halo 4: k = 3 passes, a tail step
    ((16, 16, 24), (2, 2, 2), 1, 4, np.float64),   # deep_halo 1: sweeps and shells
    ((20, 16, 24), (1, 1, 2), 3, 7, np.float64)])
def test_jacobi_loop_matches_jax(size, part, r, iters, dtype, overlap):
    """Multistep passes plus a tail with overlap (k = 2 then 1 tail step;
    k = 3 then 1), sweeps only without (and at radius 1); against the JAX
    XLA path and, in float32, its interpreted Pallas path (deep-halo
    multistep included; the Pallas kernels are float32 only). Float64 runs
    the same schedule through the kernels' plain versions."""
    tspec, jspec, mesh, jex, field, jsel = _jacobi_pair(size, part, r, seed=iters, dtype=dtype)
    tex = tpar.HaloExchange(tspec)
    c0 = jpar.exchange.shard_blocks(field, jspec, mesh)
    tstate = state_from_jax({"c": np.asarray(c0), "s": np.asarray(jsel)}, tspec, "cpu")
    assert tstate["c"].dtype == (torch.float64 if dtype == np.float64 else torch.float32)
    tloop = tjac.make_jacobi_loop(tex, iters, overlap=overlap)
    k = min(3, r, iters, (tspec.base.z - 1) // 2) if overlap else 0
    assert tloop.temporal_k == (k if k >= 2 else 0)
    tc, _ = tloop(tstate["c"], torch.zeros_like(tstate["c"]), tstate["s"])
    got = tpar.unshard_blocks(tc, tspec)
    assert got.dtype == dtype
    kws = [dict(use_pallas=False)] + ([dict(use_pallas=True, interpret=True)]
                                      if dtype == np.float32 else [])
    for kw in kws:
        loop = jjac.make_jacobi_loop(jex, iters, overlap=overlap, **kw)
        jc, _ = loop(jpar.exchange.shard_blocks(field, jspec, mesh),
                     jpar.exchange.shard_blocks(np.zeros_like(field), jspec, mesh), jsel)
        np.testing.assert_array_equal(got, jpar.exchange.unshard_blocks(jc, jspec), err_msg=str(kw))


@pytest.mark.parametrize("overlap", [True, False])
def test_jacobi_step_matches_jax(overlap):
    """One step on (2, 1, 1) (x split: y and z wrap in the kernels and the
    exchange copies their slabs), against the XLA and interpreted Pallas
    steps; the exchanged curr's halos too (overlap runs the full exchange)."""
    size, part = (24, 16, 14), (2, 1, 1)
    tspec, jspec, mesh, jex, field, jsel = _jacobi_pair(size, part, 1, seed=2)
    c0 = jpar.exchange.shard_blocks(field, jspec, mesh)
    tstate = state_from_jax({"c": np.asarray(c0), "s": np.asarray(jsel)}, tspec, "cpu")
    tout, tcur = tjac.make_jacobi_step(tpar.HaloExchange(tspec), overlap=overlap)(
        tstate["c"], torch.zeros_like(tstate["c"]), tstate["s"])
    for kw in (dict(use_pallas=False), dict(use_pallas=True, interpret=True)):
        step = jjac.make_jacobi_step(jex, overlap=overlap, **kw)
        jout, jcur = step(jpar.exchange.shard_blocks(field, jspec, mesh),
                          jpar.exchange.shard_blocks(np.zeros_like(field), jspec, mesh), jsel)
        np.testing.assert_array_equal(tpar.unshard_blocks(tout, tspec),
                                      jpar.exchange.unshard_blocks(jout, jspec))
    if overlap:
        np.testing.assert_array_equal(tcur.numpy(), np.asarray(jcur))


# -- the app, the domain and state conversion ------------------------------------------

def test_jacobi3d_resident_matches_jax_app_and_reference():
    kw = dict(iters=7, weak=False, chunk=3, partition=(2, 2, 2), deep_halo=2)
    got = tapp.run(16, 16, 16, device="cpu", **kw)
    want = japp.run(16, 16, 16, devices=jax.devices()[:1], **kw)
    a = got["domain"].get_curr_global(got["handle"])
    np.testing.assert_array_equal(a, want["domain"].get_curr_global(want["handle"]))
    assert got["temporal_k"] == 2
    assert tapp.csv_row(got).split(",")[:8] == japp.csv_row(want).split(",")[:8]
    size = jgeo.Dim3(16, 16, 16)
    ref = jjac.jacobi_reference(np.full((16, 16, 16), jjac.INIT_TEMP, np.float32),
                                jjac.sphere_masks(size), 7 + 3)
    np.testing.assert_allclose(a, ref, rtol=1e-5, atol=1e-6)


def test_domain_regions_and_state_roundtrip():
    """Per-block interiors/exteriors in the JAX block order, and a
    multi-block state carried JAX -> port -> JAX unchanged."""
    from stencil_tpu.api import DistributedDomain as JDomain

    dds = []
    for dd in (DistributedDomain(12, 16, 20, device="cpu"), JDomain(12, 16, 20)):
        dd.set_radius(2)
        dd.set_partition((2, 1, 2))
        if not isinstance(dd, DistributedDomain):
            dd.set_devices(jax.devices()[:1])
        h = dd.add_data("t", "float64")
        dd.realize()
        dds.append((dd, h))
    (tdd, th), (jdd, jh) = dds
    assert [str(r) for r in tdd.get_interior()] == [str(r) for r in jdd.get_interior()]
    assert [[str(r) for r in rs] for rs in tdd.get_exterior()] == \
        [[str(r) for r in rs] for rs in jdd.get_exterior()]
    g = np.random.RandomState(8).rand(20, 16, 12)
    jdd.set_curr_global(jh, g)
    jdd.exchange()
    arr = np.asarray(jdd.get_curr(jh))
    t = state_from_jax({"t": arr}, tdd.spec, "cpu")["t"]
    tdd.set_curr(th, t)
    np.testing.assert_array_equal(tdd.get_curr_global(th), g)
    tdd.exchange()
    back = state_to_numpy({"t": tdd.get_curr(th)})["t"]
    np.testing.assert_array_equal(back, arr)
    assert tdd.exchange_bytes_moved() == jdd.exchange_bytes_moved()


@pytest.mark.parametrize("size,part", [((20, 16, 12), (1, 1, 1)), ((33, 21, 13), (1, 1, 1)),
                                       ((128, 16, 20), (1, 1, 2)), ((16, 16, 24), (2, 2, 2))])
def test_sphere_sel_blocks_match_jax_layout(size, part):
    """The app's sel, built from integer coordinates on the device, is the
    JAX package's sqrt-truncating sel in its stacked layout, halos 0."""
    tspec, jspec = specs(size, part, 2)
    want = np.asarray(jpar.exchange.shard_blocks(jjac.sphere_sel(jgeo.Dim3(*size)), jspec,
                                                 one_device(jspec)))
    got = tjac.sphere_sel_blocks(tspec, "cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # a tensor scatters as its numpy array does
    g = np.random.RandomState(1).rand(*size[::-1])
    np.testing.assert_array_equal(tpar.shard_blocks(torch.from_numpy(g), tspec, "cpu").numpy(),
                                  tpar.shard_blocks(g, tspec, "cpu").numpy())
