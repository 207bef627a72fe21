"""jacobi3d's remote-dma method and its fused and persistent kernel variants
in the port, against the JAX package on the CPU: the plan IR field by
field, the fused and persistent kernels' plain versions against the Pallas
kernels in interpret mode, the step loops, the app, and the chunk helpers
with their errors. Inputs come from a numpy seed. Tolerance: bit-exact on
every cell of every compared array."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stencil_tpu.apps.jacobi3d as japp
import stencil_tpu.domain.grid as jgrid
import stencil_tpu.geometry as jgeo
import stencil_tpu.ops.jacobi as jjac
import stencil_tpu.ops.persistent_stencil as jpers
import stencil_tpu.parallel as jpar
import stencil_tpu.plan.ir as jir
import stencil_tpu_torch.apps.jacobi3d as tapp
import stencil_tpu_torch.domain.grid as tgrid
import stencil_tpu_torch.geometry as tgeo
import stencil_tpu_torch.ops.jacobi as tjac
import stencil_tpu_torch.ops.persistent_stencil as tpers
import stencil_tpu_torch.parallel as tpar
import stencil_tpu_torch.plan.ir as tir
from stencil_tpu.ops.fused_stencil import fused_kernel_supported, make_fused_jacobi_kernel
from stencil_tpu_torch.convert import state_from_jax, state_to_numpy
from stencil_tpu_torch.ops.fused_stencil import fused_jacobi_plain, kernel_supported

torch.set_num_threads(2)


def radius(geo, kind):
    if isinstance(kind, int):
        return geo.Radius.constant(kind)
    r = geo.Radius.constant(0)
    for d, v in (((-1, 0, 0), 1), ((1, 0, 0), 2), ((0, -1, 0), 2), ((0, 1, 0), 1),
                 ((0, 0, -1), 1), ((0, 0, 1), 3)):
        r.set_dir(d, v)
    if kind == "asym":  # diagonals on too; "asym-faces" leaves them off
        r.set_edge(1)
        r.set_corner(1)
    return r


def specs(size, part, rad):
    return (tgrid.GridSpec(tgeo.Dim3(*size), tgeo.Dim3(*part), radius(tgeo, rad)),
            jgrid.GridSpec(jgeo.Dim3(*size), jgeo.Dim3(*part), radius(jgeo, rad)))


def plain(v):
    """A plan field as plain data (phase records as dicts)."""
    if isinstance(v, tuple):
        return tuple(plain(e) for e in v)
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


# -- the plan IR -----------------------------------------------------------------

PLAN_VARIANTS = [("axis-composed", {}), ("remote-dma", {}),
                 ("remote-dma", {"fused": True}), ("remote-dma", {"persistent": True})]


@pytest.mark.parametrize("size,part", [((16, 16, 16), (1, 1, 1)), ((16, 16, 16), (2, 2, 2)),
                                       ((16, 16, 16), (1, 2, 4)), ((18, 20, 22), (1, 2, 4))])
@pytest.mark.parametrize("rad", [1, 2, "asym", "asym-faces"])
def test_build_plan_matches_jax(size, part, rad):
    tspec, jspec = specs(size, part, rad)
    for method, kw in PLAN_VARIANTS:
        for batch in (True, False):
            got = tir.build_plan(tspec, part, method, batch_quantities=batch, **kw)
            want = jir.build_plan(jspec, part, method, batch_quantities=batch, **kw)
            for f in dataclasses.fields(got):
                assert plain(getattr(got, f.name)) == plain(getattr(want, f.name)), \
                    (method, kw, f.name)
            assert want.direct_phases == () and want.dcn_phases == ()
            assert plain(got.phases) == plain(want.phases)
            for k in (1, 2, 4):
                assert got.launches_per_chunk(k) == want.launches_per_chunk(k)
            for q, g in ((1, 1), (4, 1), (4, 2)):
                assert got.collectives_per_exchange(q, g) == want.collectives_per_exchange(q, g)
                assert got.dmas_per_exchange(q, g) == want.dmas_per_exchange(q, g)
            assert got.describe() == want.describe()


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("mesh,method,kw", [
    ((2, 2, 2), "axis-composed", {"fused": True}),
    ((2, 2, 2), "axis-composed", {"persistent": True}),
    ((2, 2, 2), "remote-dma", {"fused": True, "persistent": True}),
    ((2, 2, 1), "remote-dma", {"fused": True}),
    ((2, 2, 1), "remote-dma", {"persistent": True}),
    ((3, 2, 2), "remote-dma", {}),
    ((2, 2, 2), "ring-dma", {}),
])
def test_build_plan_errors_match_jax(mesh, method, kw):
    tspec, jspec = specs((16, 16, 16), (2, 2, 2), 1)
    assert _error(lambda: tir.build_plan(tspec, mesh, method, **kw)) == \
        _error(lambda: jir.build_plan(jspec, mesh, method, **kw))


def test_launches_per_chunk_error_and_what_is_left():
    tspec, jspec = specs((16, 16, 16), (1, 1, 1), 1)
    assert _error(lambda: tir.build_plan(tspec, (1, 1, 1), "remote-dma").launches_per_chunk(0)) \
        == _error(lambda: jir.build_plan(jspec, (1, 1, 1), "remote-dma").launches_per_chunk(0))
    # the direct26 plan now builds, the JAX package's message for message
    got = tir.build_plan(tspec, (1, 1, 1), "direct26")
    assert got.describe() == jir.build_plan(jspec, (1, 1, 1), "direct26").describe()
    assert len(got.direct_phases) == 26
    # PlanChoice is ported; what a domain cannot realize still refuses
    for call in (lambda: tir.build_plan(tspec, (1, 1, 1), "auto-spmd"),
                 lambda: tir.build_plan(tspec, (1, 1, 1), "axis-composed", hierarchy=("z", 1)),
                 tir.PlanChoice((2, 2, 2), "remote-dma", hierarchy=("z", 2)).realizable,
                 tir.PlanChoice((2, 1, 1), "remote-dma", placement=(1, 0)).realizable):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()


# -- the kernels' plain versions against the interpreted Pallas kernels ----------

def random_block(spec, rng):
    p = spec.padded()
    return (rng.rand(p.z, p.y, p.x).astype(np.float32),
            rng.randint(0, 3, size=(p.z, p.y, p.x)).astype(np.int32))


@pytest.mark.parametrize("size,r", [((16, 16, 16), 1), ((17, 19, 16), 2)])
def test_fused_plain_matches_interpreted_kernel(size, r):
    """Two substeps through the double buffer, from random fields with noise
    in every halo and a random sel: both outputs, every cell."""
    tspec, jspec = specs(size, (1, 1, 1), r)
    kern = make_fused_jacobi_kernel(
        jspec, jir.build_plan(jspec, (1, 1, 1), "remote-dma", fused=True), interpret=True)
    plan = tir.build_plan(tspec, (1, 1, 1), "remote-dma", fused=True)
    rng = np.random.RandomState(3)
    curr, sel = random_block(tspec, rng)
    nxt = rng.rand(*curr.shape).astype(np.float32)
    jc, jn = jnp.asarray(curr), jnp.asarray(nxt)
    tc, tn = torch.from_numpy(curr.copy()), torch.from_numpy(nxt.copy())
    ts = torch.from_numpy(sel)
    for _ in range(2):
        jc2, jout = kern(jc, jn, jnp.asarray(sel))
        tc2, tout = fused_jacobi_plain(tc, tn, ts, tspec, plan)
        np.testing.assert_array_equal(tc2.numpy(), np.asarray(jc2))
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        jc, jn, tc, tn = jout, jc2, tout, tc2


def _self_wrap(spec, arr):
    """Deep hand-offs on a numpy block (the JAX test's replica)."""
    out = arr.copy()
    for _d, src, dst, shape, _c in tpers.deep_dir_phases(spec, (1, 1, 1)):
        out[tuple(slice(a, a + w) for a, w in zip(dst, shape))] = \
            arr[tuple(slice(a, a + w) for a, w in zip(src, shape))]
    return out


def _compute(spec, g=0):
    """The index of a block's compute region grown ``g`` cells per side
    (leading dims allowed)."""
    off, b = spec.compute_offset(), spec.base
    return (..., *(slice(o - g, o + n + g) for o, n in ((off.z, b.z), (off.y, b.y), (off.x, b.x))))


def _outside(arr, box):
    """``arr``'s cells outside ``box`` (an index of the block)."""
    mask = np.ones(arr.shape, bool)
    mask[box] = False
    return arr[mask]


@pytest.mark.parametrize("size,k", [((16, 16, 14), 2), ((16, 16, 16), 3), ((16, 16, 13), 4)])
def test_persistent_plain_matches_interpreted_kernel(size, k):
    """One chunk from random fields with noise in every halo, with sel codes
    in {0, 1, 2} and in [-1, 4): ``curr``'s halos are the JAX package's
    deep exchange and its compute region is unchanged; the result buffer
    (``nxt``: one on-chip pass) holds in its compute region the interpreted
    kernel's result, read from the buffer JAX's own rule names (``nxt``
    for odd k), and every other cell of it is unchanged; ``sel`` is
    unchanged. Then the chunk body alone, on halo-filled inputs, against
    JAX's chunk body the same way."""
    tspec, jspec = specs(size, (1, 1, 1), k)
    jmesh = jpar.grid_mesh(jspec.dim, jax.devices()[:1])
    jex = jpar.HaloExchange(jspec, jmesh, jpar.Method.REMOTE_DMA, persistent=True)
    kern = jpers.make_persistent_jacobi_kernel(
        jspec, jir.build_plan(jspec, (1, 1, 1), "remote-dma", persistent=True), k,
        interpret=True)
    cr = _compute(tspec)
    assert tpers.result_in_nxt(k)
    for lo, hi in ((0, 3), (-1, 4)):
        rng = np.random.RandomState(k)
        curr = random_block(tspec, rng)[0]
        p = tspec.padded()
        sel = _self_wrap(tspec, rng.randint(lo, hi, size=(p.z, p.y, p.x)).astype(np.int32))
        nxt = rng.rand(*curr.shape).astype(np.float32)
        jc, jo, js = kern(jnp.asarray(curr), jnp.asarray(nxt), jnp.asarray(sel))
        jres = np.asarray(jo if k % 2 else jc)
        exchanged = np.asarray(jex(jax.device_put(jnp.asarray(curr[None, None, None]),
                                                  jex.sharding())))[0, 0, 0]
        tc, to, ts = tpers.persistent_jacobi_plain(
            torch.from_numpy(curr.copy()), torch.from_numpy(nxt.copy()),
            torch.from_numpy(sel.copy()), tspec, k)
        # the messages fill the halo box; JAX's exchange also fills pad cells
        hb = _compute(tspec, k)
        np.testing.assert_array_equal(tc.numpy()[hb], exchanged[hb])
        np.testing.assert_array_equal(tc.numpy()[cr], curr[cr])
        np.testing.assert_array_equal(_outside(tc.numpy(), hb), _outside(curr, hb))
        np.testing.assert_array_equal(to.numpy()[cr], jres[cr])
        np.testing.assert_array_equal(_outside(to.numpy(), cr), _outside(nxt, cr))
        np.testing.assert_array_equal(ts.numpy(), sel)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

        # the chunk body alone, on halo-filled inputs
        filled = _self_wrap(tspec, curr)
        jf, _jscr = jax.jit(jpers.make_persistent_chunk_body(jspec, k))(
            jnp.asarray(filled), jnp.asarray(nxt), jnp.asarray(sel))
        tf, tother = tpers.make_persistent_chunk_body(tspec, k)(
            torch.from_numpy(filled.copy()), torch.from_numpy(nxt.copy()), torch.from_numpy(sel))
        np.testing.assert_array_equal(tf.numpy()[cr], np.asarray(jf)[cr])
        np.testing.assert_array_equal(_outside(tf.numpy(), cr), _outside(nxt, cr))
        np.testing.assert_array_equal(tother.numpy(), filled)
    assert [(d.x, d.y, d.z, s, t, sh, c) for d, s, t, sh, c in tpers.deep_dir_phases(tspec, (1, 1, 1))] \
        == [(d.x, d.y, d.z, s, t, sh, c) for d, s, t, sh, c in jpers._deep_dir_phases(jspec, jgeo.Dim3(1, 1, 1))]


def test_result_in_nxt_and_chunk_passes():
    """k = 1..12: the passes sum to k, are balanced, and number
    ceil(k / ONCHIP_KMAX); the result rule is their parity; and the plain
    chunk body leaves its result where the rule says and, for a chunk of one
    pass, the other buffer (``curr``) alone."""
    assert tpers.ONCHIP_KMAX == 6
    for k in range(1, 13):
        passes = tpers.chunk_passes(k)
        assert sum(passes) == k and max(passes) - min(passes) <= 1
        assert passes == sorted(passes, reverse=True) and max(passes) <= tpers.ONCHIP_KMAX
        assert len(passes) == -(-k // tpers.ONCHIP_KMAX)
        assert tpers.result_in_nxt(k) == (k <= 6)
    tspec, _ = specs((12, 12, 12), (1, 1, 1), 12)
    rng = np.random.RandomState(12)
    curr, sel = random_block(tspec, rng)
    nxt = rng.rand(*curr.shape).astype(np.float32)
    for k in range(1, 13):
        c, n = torch.from_numpy(curr.copy()), torch.from_numpy(nxt.copy())
        res, other = tpers.make_persistent_chunk_body(tspec, k)(c, n, torch.from_numpy(sel))
        assert (res is n and other is c) == tpers.result_in_nxt(k)
        assert (res is c and other is n) == (not tpers.result_in_nxt(k))
        if len(tpers.chunk_passes(k)) == 1:
            np.testing.assert_array_equal(other.numpy(), curr)
    with pytest.raises(ValueError, match=">= 1"):
        tpers.chunk_passes(0)


def test_persistent_plain_deeper_than_one_pass_matches_jax_chunk():
    """k = 8 at 20^3, radius 8: two on-chip passes of 4, so the result lands
    in ``curr``. Its compute region equals the JAX package's depth-8 chunk
    body on the same halo-filled input; ``curr``'s halos are the deep
    hand-offs; ``nxt`` holds the first pass over the block grown 4 cells and
    is unchanged outside it; ``sel`` (codes in [-1, 4)) is unchanged."""
    k = 8
    tspec, jspec = specs((20, 20, 20), (1, 1, 1), k)
    assert tpers.chunk_passes(k) == [4, 4] and not tpers.result_in_nxt(k)
    rng = np.random.RandomState(8)
    curr = random_block(tspec, rng)[0]
    p = tspec.padded()
    sel = _self_wrap(tspec, rng.randint(-1, 4, size=(p.z, p.y, p.x)).astype(np.int32))
    nxt = rng.rand(*curr.shape).astype(np.float32)
    filled = _self_wrap(tspec, curr)
    jf, _ = jax.jit(jpers.make_persistent_chunk_body(jspec, k))(
        jnp.asarray(filled), jnp.asarray(nxt), jnp.asarray(sel))
    tc, tn, ts = tpers.persistent_jacobi_plain(
        torch.from_numpy(curr.copy()), torch.from_numpy(nxt.copy()), torch.from_numpy(sel.copy()),
        tspec, k)
    cr = _compute(tspec)
    np.testing.assert_array_equal(tc.numpy()[cr], np.asarray(jf)[cr])
    np.testing.assert_array_equal(_outside(tc.numpy(), cr), _outside(filled, cr))
    g4 = _compute(tspec, 4)
    np.testing.assert_array_equal(_outside(tn.numpy(), g4), _outside(nxt, g4))
    # the first pass over the grown block: JAX's depth-4 chunk body on a
    # 28^3 block of radius 4 cut from the same halo-filled input
    j28 = jgrid.GridSpec(jgeo.Dim3(28, 28, 28), jgeo.Dim3(1, 1, 1), jgeo.Radius.constant(4),
                         aligned=False)
    g8 = _compute(tspec, 8)
    j4, _ = jax.jit(jpers.make_persistent_chunk_body(j28, 4))(
        jnp.asarray(filled[g8]), jnp.asarray(nxt[g8]), jnp.asarray(sel[g8]))
    np.testing.assert_array_equal(tn.numpy()[g4], np.asarray(j4)[..., 4:32, 4:32, 4:32])
    np.testing.assert_array_equal(ts.numpy(), sel)


# -- the step loops ---------------------------------------------------------------

def contract_loop(jex, spec, c, n, s, iters, k):
    """numpy ``(curr, nxt)`` after a persistent loop of ``iters`` steps at
    depth ``k`` under the port's chunk contract, from the JAX package's
    exchange and its one-chunk loop: per chunk, ``curr``'s halo box <- the
    deep exchange (a depth-1 tail exchanges every cell, pads included, as
    the loop's exchange does), the result buffer's compute region <- JAX's
    chunk result, every other cell kept; then the swap of
    ``result_in_nxt``."""
    cr, hb = _compute(spec), _compute(spec, k)
    loops = {}
    for d in tpers.chunk_schedule(iters, k):
        assert tpers.result_in_nxt(d)  # one on-chip pass at these depths
        if d not in loops:
            loops[d] = jjac.make_jacobi_loop(jex, d, temporal_k=d)
        res, _ = loops[d](c, n, s)
        out = np.array(n)
        out[cr] = np.asarray(res)[cr]
        filled, ex = np.array(c), np.asarray(jex(c))
        if d == 1:
            filled = ex
        else:
            filled[hb] = ex[hb]
        c, n = (jax.device_put(jnp.asarray(a), c.sharding) for a in (out, filled))
    return np.asarray(c), np.asarray(n)


@pytest.mark.parametrize("variant", ["plain", "fused", "persistent"])
@pytest.mark.parametrize("size,k,iters", [((24, 24, 24), 2, 8), ((24, 24, 24), 4, 10),
                                          ((18, 20, 22), 3, 7)])
def test_remote_dma_loops_match_jax(variant, size, k, iters):
    """One device, radius k; the persistent loop at depth k (24^3 k=4 iters
    10 ends in a depth-2 chunk, 18x20x22 k=3 iters 7 in a depth-1 tail)."""
    tspec, jspec = specs(size, (1, 1, 1), k)
    kw = {"fused": variant == "fused", "persistent": variant == "persistent"}
    tk = k if variant == "persistent" else None
    mesh = jpar.grid_mesh(jspec.dim, jax.devices()[:1])
    jex = jpar.HaloExchange(jspec, mesh, jpar.Method.REMOTE_DMA, **kw)
    tex = tpar.HaloExchange(tspec, tpar.Method.REMOTE_DMA, **kw)
    rng = np.random.RandomState(iters)
    field = rng.rand(*size[::-1]).astype(np.float32)
    sel = jjac.sphere_sel(size)
    jstate = {"c": jpar.exchange.shard_blocks(field, jspec, mesh),
              "s": jpar.exchange.shard_blocks(sel, jspec, mesh)}
    tstate = state_from_jax({key: np.asarray(a) for key, a in jstate.items()}, tspec, "cpu")
    jnxt = jax.device_put(jnp.zeros_like(jstate["c"]), jex.sharding())
    jc, jn = jjac.make_jacobi_loop(jex, iters, temporal_k=tk)(jstate["c"], jnxt, jstate["s"])
    tc, tn = tjac.make_jacobi_loop(tex, iters, temporal_k=tk)(
        tstate["c"], torch.zeros_like(tstate["c"]), tstate["s"])
    got = state_to_numpy({"c": tc, "n": tn})
    if variant == "persistent":
        # the field is JAX's; both buffers, every cell, are what the chunk
        # contract leaves, built from JAX's exchange and chunks
        cr = _compute(tspec)
        np.testing.assert_array_equal(got["c"][cr], np.asarray(jc)[cr])
        want_c, want_n = contract_loop(jex, tspec, jstate["c"], jnxt, jstate["s"], iters, k)
        np.testing.assert_array_equal(got["c"], want_c)
        np.testing.assert_array_equal(got["n"], want_n)
    else:
        np.testing.assert_array_equal(got["c"], np.asarray(jc))
        np.testing.assert_array_equal(got["n"], np.asarray(jn))
    assert tex.last_launches_per_chunk == getattr(jex, "last_launches_per_chunk", 0)
    if variant == "persistent":
        assert tex.last_launches_per_chunk == tex.plan.launches_per_chunk(k) == 2


def test_exchange_variant_errors_match_jax():
    tspec, jspec = specs((16, 16, 16), (1, 1, 1), 1)
    mesh = jpar.grid_mesh(jspec.dim, jax.devices()[:1])
    for method, kw in (("AXIS_COMPOSED", {"fused": True}), ("AXIS_COMPOSED", {"persistent": True}),
                       ("REMOTE_DMA", {"fused": True, "persistent": True})):
        assert _error(lambda: tpar.HaloExchange(tspec, tpar.Method[method], **kw)) == \
            _error(lambda: jpar.HaloExchange(jspec, mesh, jpar.Method[method], **kw))
    # a stacked multi-block partition on one device is oversubscribed
    tspec2, jspec2 = specs((16, 16, 16), (1, 1, 2), 1)
    mesh2 = jpar.grid_mesh(jgeo.Dim3(1, 1, 1), jax.devices()[:1])
    for kw in ({"fused": True}, {"persistent": True}):
        assert _error(lambda: tpar.HaloExchange(tspec2, tpar.Method.REMOTE_DMA, **kw)) == \
            _error(lambda: jpar.HaloExchange(jspec2, mesh2, jpar.Method.REMOTE_DMA, **kw))


# -- the app ------------------------------------------------------------------------

@pytest.mark.parametrize("variant,deep_halo", [("fused", 1), ("persistent", 2), ("persistent", 4)])
def test_jacobi3d_variants_match_jax_app(variant, deep_halo):
    """32^3, 7 iterations in chunks of 3: the warm-up chunk, 3 + 3, a
    1-step chunk (the persistent loop's depth-1 tail)."""
    kw = dict(iters=7, chunk=3, weak=False, deep_halo=deep_halo, kernel_variant=variant)
    got = tapp.run(32, 32, 32, method=tpar.Method.REMOTE_DMA, device="cpu", **kw)
    want = japp.run(32, 32, 32, method=jpar.Method.REMOTE_DMA, devices=jax.devices()[:1], **kw)
    np.testing.assert_array_equal(got["domain"].get_curr_global(got["handle"]),
                                  want["domain"].get_curr_global(want["handle"]))
    assert tapp.csv_row(got).split(",")[:8] == japp.csv_row(want).split(",")[:8]
    assert got["kernel_variant"] == variant and got["method"] == "remote-dma"
    assert got["temporal_k"] == (deep_halo if variant == "persistent" else 0)


@pytest.mark.parametrize("kw", [dict(kernel_variant="bogus"), dict(kernel_variant="persistent"),
                                dict(kernel_variant="fused"), dict(fused=True)])
def test_jacobi3d_argument_errors_match_jax_app(kw):
    """Unknown variant, persistent without --deep-halo >= 2, and a variant
    without the remote-dma method all fail alike."""
    assert _error(lambda: tapp.run(8, 8, 8, iters=1, device="cpu", **kw)) == \
        _error(lambda: japp.run(8, 8, 8, iters=1, devices=jax.devices()[:1], **kw))


def test_jacobi3d_cli_variants(capsys):
    with pytest.raises(SystemExit):
        tapp.main(["--fused", "--kernel-variant", "persistent", "--device", "cpu"])
    assert tapp.main(["--x", "16", "--y", "16", "--z", "16", "--iters", "3", "--method",
                      "remote-dma", "--kernel-variant", "persistent", "--deep-halo", "2",
                      "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("jacobi3d,remote-dma,1,1,16,16,16,")


# -- the chunk helpers ----------------------------------------------------------------

@pytest.mark.parametrize("iters,k", [(8, 2), (10, 4), (7, 3), (0, 4), (1, 4), (8, 0), (-1, 2)])
def test_chunk_schedule_matches_jax(iters, k):
    if k < 1 or iters < 0:
        assert _error(lambda: tpers.chunk_schedule(iters, k)) == \
            _error(lambda: jpers.chunk_schedule(iters, k))
    else:
        assert tpers.chunk_schedule(iters, k) == jpers.chunk_schedule(iters, k)


@pytest.mark.parametrize("size,part,r,depth", [((16, 16, 16), (2, 2, 2), 2, 2),
                                               ((16, 16, 16), (2, 2, 2), 2, 3),
                                               ((16, 16, 16), (1, 1, 4), 8, 8),
                                               ((16, 16, 13), (1, 1, 1), 4, 4)])
def test_check_chunk_depth_matches_jax(size, part, r, depth):
    tspec, jspec = specs(size, part, r)
    try:
        jpers.check_chunk_depth(jspec, depth)
    except ValueError as e:
        assert _error(lambda: tpers.check_chunk_depth(tspec, depth)) == str(e)
    else:
        tpers.check_chunk_depth(tspec, depth)
    resident = tgeo.Dim3(1, 1, 1)
    assert kernel_supported(tspec, resident) == \
        jpers.persistent_kernel_supported(jspec, jgeo.Dim3(1, 1, 1)) == \
        fused_kernel_supported(jspec, jgeo.Dim3(1, 1, 1))


# -- float64 with the fused and persistent variants ---------------------------------------

@pytest.mark.parametrize("devices", [None, ["cpu"] * 8], ids=["one block", "8 positions"])
@pytest.mark.parametrize("variant", ["fused", "persistent"])
def test_float64_fused_and_persistent_variants_raise(variant, devices):
    """The fused step (B8) and the persistent chunk (B9) are float32 kernels,
    as the JAX package builds them: a float64 field raises
    NotImplementedError naming the divergence (the JAX package runs such a
    domain on XLA), through the app and through each kernel wrapper, on the
    CPU as on the card. The plain remote-dma path takes float64."""
    kw = dict(iters=4, weak=False, method=tpar.Method.REMOTE_DMA, kernel_variant=variant,
              dtype="float64", deep_halo=2 if variant == "persistent" else 1)
    kw.update(dict(devices=devices) if devices else dict(device="cpu"))
    with pytest.raises(NotImplementedError, match="float64.*diverge.*Design divergences"):
        tapp.run(16, 16, 16, **kw)
    kw.pop("kernel_variant")
    got = tapp.run(16, 16, 16, **kw)
    assert got["domain"].get_curr_global(got["handle"]).dtype == np.float64
    tspec, _ = specs((16, 16, 14), (1, 1, 1), 2)
    f64 = torch.zeros(tspec.stacked_shape_zyx(), dtype=torch.float64)
    sel = torch.zeros(tspec.stacked_shape_zyx(), dtype=torch.int32)
    from stencil_tpu_torch.ops import fused_stencil as tfused

    plan = tir.build_plan(tspec, (1, 1, 1), tpar.Method.REMOTE_DMA, fused=True)
    with pytest.raises(NotImplementedError, match="fused_jacobi: float64"):
        tfused.fused_jacobi(f64, f64.clone(), sel, tspec, plan)
    with pytest.raises(NotImplementedError, match="persistent_jacobi: float64"):
        tpers.persistent_jacobi(f64, f64.clone(), sel, tspec, 2)
