"""The port's Jacobi sweep and multistep (through their wrappers' CPU
branches, i.e. the plain PyTorch versions) against the JAX package's Pallas
kernels in interpret mode and its XLA sweep. Tolerance: bit-exact over the
compute region."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stencil_tpu.domain.grid as jgrid
import stencil_tpu.geometry as jgeo
import stencil_tpu.ops.halo_fill as jfill
import stencil_tpu.ops.jacobi as jjac
import stencil_tpu.ops.pallas_stencil as jps
import stencil_tpu_torch.domain.grid as tgrid
import stencil_tpu_torch.geometry as tgeo
import stencil_tpu_torch.ops.jacobi as tjac
import stencil_tpu_torch.ops.stencil_kernels as tk

torch.set_num_threads(2)


def specs(size, radius=1, tight_x=False):
    def rad(g):
        r = g.Radius.constant(radius)
        return r.without_x() if tight_x else r

    return (tgrid.GridSpec(tgeo.Dim3(*size), tgeo.Dim3(1, 1, 1), rad(tgeo)),
            jgrid.GridSpec(jgeo.Dim3(*size), jgeo.Dim3(1, 1, 1), rad(jgeo)))


def region(spec):
    off, b = spec.compute_offset(), spec.base
    return (slice(off.z, off.z + b.z), slice(off.y, off.y + b.y), slice(off.x, off.x + b.x))


def padded_state(spec, seed, fill_halo=False):
    """Random field in the compute region (zeros elsewhere, or random
    everywhere with ``fill_halo``), and the padded int32 sphere sel."""
    p = spec.padded()
    rng = np.random.RandomState(seed)
    if fill_halo:
        curr = rng.rand(p.z, p.y, p.x).astype(np.float32)
    else:
        curr = np.zeros((p.z, p.y, p.x), np.float32)
        b = spec.base
        curr[region(spec)] = rng.rand(b.z, b.y, b.x).astype(np.float32)
    sel = np.zeros((p.z, p.y, p.x), np.int32)
    sel[region(spec)] = tjac.sphere_sel(spec.global_size)
    return curr, sel


def t(a):
    return torch.from_numpy(a.copy())


SWEEP_SIZES = [(40, 16, 8), (20, 16, 12), (33, 21, 13)]


@pytest.mark.parametrize("size", SWEEP_SIZES)
def test_sweep_matches_pallas(size):
    ts, js = specs(size)
    curr, sel = padded_state(ts, seed=1)
    fn = jps.make_pallas_jacobi_sweep(js, jps.sel_z_range(js), interpret=True,
                                      wrap=(True, True, True))
    want = np.asarray(fn(jnp.asarray(curr), jnp.zeros_like(curr), jnp.asarray(sel)))
    got = tk.sweep(t(curr), torch.zeros(curr.shape), t(sel), ts)
    np.testing.assert_array_equal(got.numpy()[region(ts)], want[region(ts)])


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("size", SWEEP_SIZES)
def test_sweep_matches_xla(size, wrap):
    """Without wrap the plain sweep reads the (random) halos, as the XLA
    region sweep does; with wrap it equals the XLA sweep of the
    self-wrap-filled block."""
    ts, js = specs(size)
    curr, sel = padded_state(ts, seed=2, fill_halo=True)
    src = curr
    if wrap:
        src = np.asarray(jfill.wrap_fill_batched(js, jnp.asarray(curr)))
    off = js.compute_offset()
    rect = jgeo.Rect3(off, off + js.base)
    masks = (jnp.asarray(sel == 1), jnp.asarray(sel == 2))
    want = np.asarray(jax.jit(lambda s, o: jjac.jacobi_sweep(s, o, rect, masks))(
        jnp.asarray(src), jnp.zeros_like(src)))
    got = tk.sweep(t(curr), torch.zeros(curr.shape), t(sel), ts, wrap=(wrap,) * 3)
    np.testing.assert_array_equal(got.numpy()[region(ts)], want[region(ts)])
    # the port's region sweep is the XLA sweep too
    trect = tgeo.Rect3(ts.compute_offset(), ts.compute_offset() + ts.base)
    got2 = tjac.jacobi_sweep(t(src), torch.zeros(curr.shape), trect,
                             (t(sel) == 1, t(sel) == 2))
    np.testing.assert_array_equal(got2.numpy()[region(ts)], want[region(ts)])


@pytest.mark.parametrize("k", [2, 3, 5])
def test_multistep_matches_pallas(k):
    ts, js = specs((20, 16, 12))
    curr, _ = padded_state(ts, seed=k)
    fn = jps.make_pallas_jacobi_multistep(js, k, interpret=True)
    want = np.asarray(fn(jnp.asarray(curr), jnp.zeros_like(curr)))
    got = tk.multistep(t(curr), torch.zeros(curr.shape), ts, k)
    np.testing.assert_array_equal(got.numpy()[region(ts)], want[region(ts)])


def test_multistep_matches_pallas_row_tiled():
    """ny=40 with 16-row strips: the TPU kernel's last strip re-anchors."""
    k = 3
    ts, js = specs((20, 40, 12))
    curr, _ = padded_state(ts, seed=7)
    fn = jps.make_pallas_jacobi_multistep(js, k, interpret=True, rows=16)
    want = np.asarray(fn(jnp.asarray(curr), jnp.zeros_like(curr)))
    got = tk.multistep(t(curr), torch.zeros(curr.shape), ts, k)
    np.testing.assert_array_equal(got.numpy()[region(ts)], want[region(ts)])


def test_multistep_and_sweep_tight_x_match_pallas():
    """Radius.constant(1).without_x(), nx=128: no x halo columns exist."""
    k = 3
    ts, js = specs((128, 16, 12), tight_x=True)
    assert ts.padded().x == 128 and ts.compute_offset().x == 0
    curr, sel = padded_state(ts, seed=9)
    fn = jps.make_pallas_jacobi_multistep(js, k, interpret=True)
    want = np.asarray(fn(jnp.asarray(curr), jnp.zeros_like(curr)))
    got = tk.multistep(t(curr), torch.zeros(curr.shape), ts, k)
    np.testing.assert_array_equal(got.numpy()[region(ts)], want[region(ts)])
    sw = jps.make_pallas_jacobi_sweep(js, jps.sel_z_range(js), interpret=True,
                                      wrap=(True, True, True))
    want1 = np.asarray(sw(jnp.asarray(curr), jnp.zeros_like(curr), jnp.asarray(sel)))
    got1 = tk.sweep(t(curr), torch.zeros(curr.shape), t(sel), ts)
    np.testing.assert_array_equal(got1.numpy()[region(ts)], want1[region(ts)])


@pytest.mark.parametrize("size,steps,ks", [((20, 16, 12), 6, (2, 3, 6)),
                                            ((33, 21, 13), 12, (3, 4, 6))])
def test_multistep_depth_independent(size, steps, ks):
    """Every step has the same operand order, so k-step passes give the same
    bits for every k, and equal ``steps`` single sweeps with ``sel``."""
    ts, _ = specs(size)
    curr, sel = padded_state(ts, seed=4)
    outs = []
    for k in ks:
        c, n = t(curr), torch.zeros(curr.shape)
        for _ in range(steps // k):
            c, n = tk.multistep(c, n, ts, k), c
        outs.append(c.numpy()[region(ts)])
    c, n = t(curr), torch.zeros(curr.shape)
    for _ in range(steps):
        c, n = tk.sweep(c, n, t(sel), ts), c
    outs.append(c.numpy()[region(ts)])
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])


@pytest.mark.parametrize("size", [(20, 16, 12), (33, 21, 13), (64, 48, 40), (100, 30, 50)])
def test_coordinate_spheres_equal_sphere_sel(size):
    ts, _ = specs(size)
    hot, cold = tk.sphere_masks_from_coords(ts, "cpu")
    jhot, jcold = jjac.sphere_masks(jgeo.Dim3(*size))
    np.testing.assert_array_equal(hot.numpy(), jhot)
    np.testing.assert_array_equal(cold.numpy(), jcold)
    assert (tjac.sphere_sel(size) == jjac.sphere_sel(jgeo.Dim3(*size))).all()


def test_multistep_depth_planner():
    # at k=4: guard rows and 4 + 2 + 2 * 3 planes of the 64x16 tile grown by
    # 4, at a pitch of 20 runs of 4; speed per step, not shared memory, bounds
    # the depth
    assert tk.multistep_smem_bytes(4) == 4 * ((4 + 2 + 2 * 3) * (16 + 8) * 80 + 2 * 80)
    assert tk.plan_multistep_depth(12) == tk.MULTISTEP_KPLAN == 3
    assert tk.plan_multistep_depth(2) == 2
    assert tk.plan_multistep_depth(1) == 1
    assert tk.multistep_smem_bytes(tk.MULTISTEP_KMAX) <= tk.SMEM_LIMIT


def test_reference_divide_is_a_reciprocal_multiply():
    """Why SIXTH: XLA compiles the JAX package's ``sum / 6`` into
    ``sum * float32(1/6)``, which differs from a true divide in about a
    third of all cells; the port multiplies, on the CPU and on the GPU."""
    rng = np.random.RandomState(0)
    s = (rng.rand(4096) * 6).astype(np.float32)
    xla = np.asarray(jax.jit(lambda a: a / 6)(jnp.asarray(s)))
    port = (torch.from_numpy(s) * tk.SIXTH).numpy()
    np.testing.assert_array_equal(port, xla)
    assert (s / np.float32(6) != xla).any()


def test_reference_divide_is_a_float64_reciprocal_multiply():
    """The same fold in float64: XLA multiplies by float64(1/6), so the
    port's float64 plain versions multiply by ``sixth(torch.float64)``."""
    rng = np.random.RandomState(1)
    s = rng.rand(4096) * 6
    xla = np.asarray(jax.jit(lambda a: a / 6)(jnp.asarray(s, jnp.float64)))
    assert tk.sixth(torch.float64) == 1.0 / 6.0 and tk.sixth(torch.float32) == tk.SIXTH
    port = (torch.from_numpy(s) * tk.sixth(torch.float64)).numpy()
    np.testing.assert_array_equal(port, xla)
    assert (s / 6 != xla).any()


@pytest.mark.parametrize("radius", [1, 2])
def test_float64_sweep_and_multistep_match_jax(radius):
    """float64 fields through the wrappers' CPU branches: one sweep against
    the JAX XLA sweep, and a k=3 multistep against three of them."""
    tspec, jspec = specs((20, 14, 12), radius)
    off = jspec.compute_offset()
    rng = np.random.RandomState(radius)
    p = jspec.padded()
    curr = np.zeros((1, 1, 1, p.z, p.y, p.x), np.float64)
    curr[(0, 0, 0) + region(jspec)] = rng.rand(12, 14, 20)
    sel = np.zeros(curr.shape, np.int32)
    sel[(0, 0, 0) + region(jspec)] = jjac.sphere_sel((20, 14, 12))
    compute = jgeo.Rect3(off, off + jspec.base)

    @jax.jit
    def xla_step(c):  # jitted, as the JAX package's loops are (eager JAX divides)
        c = jfill.wrap_fill_batched(jspec, c)
        s = jnp.asarray(sel)
        return jjac.jacobi_sweep(c, jnp.zeros_like(c), compute, (s == 1, s == 2))

    one = tk.sweep(torch.from_numpy(curr), torch.zeros(curr.shape, dtype=torch.float64),
                   torch.from_numpy(sel), tspec)
    want = xla_step(jnp.asarray(curr))
    assert one.dtype == torch.float64
    np.testing.assert_array_equal(one.numpy()[(0, 0, 0) + region(jspec)],
                                  np.asarray(want)[(0, 0, 0) + region(jspec)])
    three = tk.multistep(torch.from_numpy(curr), torch.zeros(curr.shape, dtype=torch.float64),
                         tspec, 3)
    want = np.asarray(xla_step(xla_step(want)))
    np.testing.assert_array_equal(three.numpy()[(0, 0, 0) + region(jspec)],
                                  want[(0, 0, 0) + region(jspec)])


# -- the sel plane range (the TPU kernel's sel_z_range) ---------------------------


def pair(size, part, radius):
    return (tgrid.GridSpec(tgeo.Dim3(*size), tgeo.Dim3(*part), tgeo.Radius.constant(radius)),
            jgrid.GridSpec(jgeo.Dim3(*size), jgeo.Dim3(*part), jgeo.Radius.constant(radius)))


@pytest.mark.parametrize("size,part,radius", [
    ((16, 16, 16), (1, 1, 1), 1), ((40, 16, 8), (1, 1, 1), 2), ((512, 512, 512), (1, 1, 1), 1),
    ((32, 24, 20), (2, 2, 2), 4), ((512, 512, 512), (2, 2, 2), 1), ((20, 16, 12), (3, 2, 1), 1),
    ((40, 40, 33), (1, 1, 3), 1), ((64, 64, 61), (2, 1, 4), 2), ((100, 64, 40), (1, 1, 5), 3)])
def test_sel_z_range_matches_jax(size, part, radius):
    """The port's copy of sel_z_range equals the JAX package's on uniform,
    stacked and uneven specs; each block's own range lies within it."""
    ts, js = pair(size, part, radius)
    lo, hi = tk.sel_z_range(ts)
    assert (lo, hi) == tuple(jps.sel_z_range(js))
    for blo, bhi in tk.block_sel_ranges(ts):
        assert blo >= bhi or lo <= blo < bhi <= hi


@pytest.mark.parametrize("size", SWEEP_SIZES + [(64, 24, 21)])
@pytest.mark.parametrize("ranged", [False, True])
def test_sweep_sel_range_matches_pallas(size, ranged):
    """Seeded numpy fields through the interpreted Pallas sweep and the
    port's plain sweep: with the spheres' sel and both kernels reading it
    on sel_z_range's planes only, and with random sel codes read on every
    plane (the Pallas range the whole block). Bit-exact."""
    ts, js = specs(size)
    curr, sel = padded_state(ts, seed=sum(size))
    if not ranged:
        sel = np.random.RandomState(3).randint(-1, 4, size=sel.shape).astype(np.int32)
    jrange = jps.sel_z_range(js) if ranged else (0, js.padded().z)
    fn = jps.make_pallas_jacobi_sweep(js, jrange, interpret=True, wrap=(True, True, True))
    want = np.asarray(fn(jnp.asarray(curr), jnp.zeros_like(curr), jnp.asarray(sel)))
    got = tk.sweep_plain(t(curr), torch.zeros(curr.shape), t(sel), ts, (True,) * 3,
                         tk.sel_z_range(ts) if ranged else None)
    np.testing.assert_array_equal(got.numpy()[region(ts)], want[region(ts)])


def _xla_region(src, rect, sel):
    masks = (jnp.asarray(sel == 1), jnp.asarray(sel == 2))
    return np.asarray(jax.jit(lambda s, o: jjac.jacobi_sweep(s, o, rect, masks))(
        jnp.asarray(src), jnp.zeros_like(src)))


def _jrect(r):
    return jgeo.Rect3(jgeo.Dim3(r.lo.x, r.lo.y, r.lo.z), jgeo.Dim3(r.hi.x, r.hi.y, r.hi.z))


def test_stack_and_shells_with_sel_ranges_match_xla():
    """A (2,2,2) r4 resident stack, random fields and halos, the spheres'
    sel: the stacked sweep (no axis wraps) and every overlap shell, each
    block's sel on its own planes, against the JAX XLA region sweep of the
    same blocks with sel on every plane. Bit-exact."""
    ts, js = pair((32, 24, 20), (2, 2, 2), 4)
    shape = ts.stacked_shape_zyx()
    curr = np.random.RandomState(8).rand(*shape).astype(np.float32)
    sel = tjac.sphere_sel_blocks(ts, "cpu").numpy()
    wrap, _axes, shells = tjac.multi_block_layout(ts)
    rg = tk.block_sel_ranges(ts)
    got = tk.sweep_plain(t(curr), torch.zeros(shape), t(sel), ts, wrap, rg)
    for rect in shells:
        tk.region_plain(t(curr), got, t(sel), ts, rect, rg)
    off = ts.compute_offset()
    want = _xla_region(curr, _jrect(tgeo.Rect3(off, off + ts.base)), sel)
    np.testing.assert_array_equal(got.numpy(), want)
    shell_got = torch.zeros(shape)
    for rect in shells:
        tk.region_plain(t(curr), shell_got, t(sel), ts, rect, rg)
        w = _xla_region(curr, _jrect(rect), sel)
        sl = (..., slice(rect.lo.z, rect.hi.z), slice(rect.lo.y, rect.hi.y),
              slice(rect.lo.x, rect.hi.x))
        np.testing.assert_array_equal(shell_got.numpy()[sl], w[sl])


@pytest.mark.parametrize("size,part", [((32, 32, 32), (2, 2, 2)), ((20, 16, 12), (3, 2, 1))])
def test_positions_and_shells_with_sel_ranges_match_xla(size, part):
    """Eight mesh positions and six uneven ones: sweep_positions' and
    sweep_regions' plain versions, each position's sel on its own planes,
    against the JAX XLA region sweep of each position's block (halos read
    in place) with sel on every plane. Bit-exact."""
    from stencil_tpu_torch.ops.shells import dyn_block_sizes, shell_regions
    from stencil_tpu_torch.parallel import DeviceMesh

    ts, _js = pair(size, part, 1)
    mesh = DeviceMesh(part, ["cpu"] * (part[0] * part[1] * part[2]))
    bspec = ts.block_spec()
    p = bspec.padded()
    rng = np.random.RandomState(sum(size))
    currs = [rng.rand(1, 1, 1, p.z, p.y, p.x).astype(np.float32) for _ in range(len(mesh))]
    sels = [s.numpy() for s in tjac.sphere_sel_blocks(ts, mesh)]
    rg = [tk.block_sel_range(ts, pos[2]) for pos in mesh.positions()]
    outs = tk.sweep_positions([t(c) for c in currs], [torch.zeros(c.shape) for c in currs],
                              [t(s) for s in sels], bspec, rg)
    off = bspec.compute_offset()
    whole = _jrect(tgeo.Rect3(off, off + bspec.base))
    for c, s, o in zip(currs, sels, outs):
        np.testing.assert_array_equal(o.numpy(), _xla_region(c, whole, s))
    rects = [shell_regions(ts, dyn_block_sizes(ts, pos), (True,) * 3) for pos in mesh.positions()]
    outs = tk.sweep_regions([t(c) for c in currs], [torch.zeros(c.shape) for c in currs],
                            [t(s) for s in sels], bspec, rects, rg)
    for c, s, o, rs in zip(currs, sels, outs, rects):
        want = np.zeros(c.shape, np.float32)
        for rect in rs:
            w = _xla_region(c, _jrect(rect), s)
            sl = (..., slice(rect.lo.z, rect.hi.z), slice(rect.lo.y, rect.hi.y),
                  slice(rect.lo.x, rect.hi.x))
            want[sl] = w[sl]
        np.testing.assert_array_equal(o.numpy(), want)
