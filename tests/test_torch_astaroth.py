"""The port's Astaroth slice against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages; every
array carries its dtype (``jax_enable_x64`` is on). Tolerances:

- config and init: exact (the same Python and numpy code in both).
- fp64 region math and steps: relative 1e-10, the reference's own
  XLA-vs-numpy bound for Astaroth; the two frameworks evaluate the same
  operations in the same order, but XLA fuses and may fold a divide by a
  constant into a multiply, so a few ulps differ.
- fp32: rtol 1e-4, atol 1e-5, the JAX package's own XLA-vs-Pallas bound
  (tests/test_pallas_astaroth.py): few-ulp reassociation on fields of
  magnitude up to ~20.

On the CPU the kernel wrapper runs its plain version; the CUDA kernel is
held to that plain version on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stencil_tpu.apps.astaroth as japp
import stencil_tpu.astaroth.config as jconfig
import stencil_tpu.astaroth.init as jinit
import stencil_tpu_torch.apps.astaroth as tapp
import stencil_tpu_torch.astaroth.config as tconfig
import stencil_tpu_torch.astaroth.init as tinit
from stencil_tpu.astaroth.equations import Constants as JConstants
from stencil_tpu.astaroth.integrate import _integrate_region
from stencil_tpu.astaroth.integrate import make_astaroth_step as jmake_step
from stencil_tpu.astaroth.reductions import Reductions as JReductions
from stencil_tpu.domain.grid import GridSpec as JGridSpec
from stencil_tpu.geometry import Dim3 as JDim3
from stencil_tpu.geometry import Radius as JRadius
from stencil_tpu.geometry import Rect3 as JRect3
from stencil_tpu.ops.pallas_astaroth import make_pallas_substep
from stencil_tpu.parallel import HaloExchange as JHaloExchange
from stencil_tpu.parallel import grid_mesh
from stencil_tpu.parallel.exchange import shard_blocks as jshard
from stencil_tpu.parallel.exchange import unshard_blocks as junshard
from stencil_tpu_torch import HaloExchange
from stencil_tpu_torch.astaroth.equations import Constants
from stencil_tpu_torch.astaroth.integrate import (FIELDS, inv_ds_of, integrate_region,
                                                  make_astaroth_step)
from stencil_tpu_torch.convert import state_from_jax, state_to_numpy
from stencil_tpu_torch.domain import GridSpec
from stencil_tpu_torch.geometry import Dim3, Radius, Rect3
from stencil_tpu_torch.ops import astaroth_substep as tsub
from stencil_tpu_torch.parallel import unshard_blocks

torch.set_num_threads(2)

TOL = {np.float64: dict(rtol=1e-10, atol=1e-12), np.float32: dict(rtol=1e-4, atol=1e-5)}
DT = 0.1  # large enough that the update is visible in fp32


def configs(nx=None):
    t, _ = tconfig.load_config(tapp.DEFAULT_CONF)
    j, _ = jconfig.load_config(japp.DEFAULT_CONF)
    for info in (t, j):
        if nx is not None:
            info.int_params["AC_nx"] = nx[0]
            info.int_params["AC_ny"] = nx[1]
            info.int_params["AC_nz"] = nx[2]
            info.update_builtin_params()
    return t, j


def specs(size):
    return (GridSpec(Dim3(*size), Dim3(1, 1, 1), Radius.constant(3)),
            JGridSpec(JDim3(*size), JDim3(1, 1, 1), JRadius.constant(3)))


def padded_fields(spec, dtype, seed):
    """Random curr and out blocks over the whole padded block (halos
    included), values in [0, 0.1)."""
    p = spec.padded()
    rng = np.random.RandomState(seed)
    curr = {k: (rng.rand(p.z, p.y, p.x) * 0.1).astype(dtype) for k in FIELDS}
    out = {k: (rng.rand(p.z, p.y, p.x) * 0.1).astype(dtype) for k in FIELDS}
    return curr, out


def compute_region(spec):
    off, b = spec.compute_offset(), spec.base
    return (..., slice(off.z, off.z + b.z), slice(off.y, off.y + b.y),
            slice(off.x, off.x + b.x))


# -- (a) config and init -------------------------------------------------------

@pytest.mark.parametrize("nx", [None, (24, 20, 16)])
def test_config_matches_jax(nx):
    t, j = configs(nx)
    assert t.int_params == j.int_params
    assert t.real_params == j.real_params
    assert t.uninitialized() == j.uninitialized() == ["AC_dt"]
    assert Constants.from_info(t) == tuple(JConstants.from_info(j))
    assert inv_ds_of(t) == (j.real_params["AC_inv_dsx"], j.real_params["AC_inv_dsy"],
                            j.real_params["AC_inv_dsz"])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_init_matches_jax(dtype):
    size = (24, 20, 16)
    np.testing.assert_array_equal(tinit.hash_init(size, dtype=dtype),
                                  jinit.hash_init(size, dtype=dtype))
    np.testing.assert_array_equal(tinit.const_init(size, 0.5, dtype=dtype),
                                  jinit.const_init(size, 0.5, dtype=dtype))
    for a, b in zip(tinit.radial_explosion_init(size, dtype=dtype),
                    jinit.radial_explosion_init(size, dtype=dtype)):
        assert a.dtype == dtype
        np.testing.assert_array_equal(a, b)
    assert tapp.decompose_zyx(8) == Dim3(2, 2, 2) and tapp.decompose_zyx(1) == Dim3(1, 1, 1)


# -- (b) the region math against _integrate_region -------------------------------

@pytest.mark.parametrize("substep", [0, 1, 2])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_integrate_region_matches_jax(dtype, substep):
    tinfo, jinfo = configs()
    ts, js = specs((24, 20, 16))
    curr, out = padded_fields(ts, dtype, seed=substep)
    off = ts.compute_offset()
    rect = Rect3(off, off + ts.base)
    got = integrate_region(substep, rect, inv_ds_of(tinfo), Constants.from_info(tinfo), DT,
                           {k: torch.from_numpy(v.copy()) for k, v in curr.items()},
                           {k: torch.from_numpy(v.copy()) for k, v in out.items()})
    joff = js.compute_offset()
    want = _integrate_region(substep, JRect3(joff, joff + js.base), inv_ds_of(jinfo),
                             JConstants.from_info(jinfo), DT,
                             {k: jnp.asarray(v) for k, v in curr.items()},
                             {k: jnp.asarray(v) for k, v in out.items()})
    sl = compute_region(ts)
    for k in FIELDS:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype == dtype
        np.testing.assert_allclose(g[sl], w[sl], err_msg=k, **TOL[dtype])
        # halos keep their contents; the update is visible
        np.testing.assert_array_equal(g[0], out[k][0])
        assert not np.array_equal(g[sl], curr[k][sl])


@pytest.mark.parametrize("substep", [0, 1, 2])
def test_substep_plain_slabs_equal_whole_region(monkeypatch, substep):
    """substep_plain's z slabs change nothing: bit-equal to one
    integrate_region over the whole compute region."""
    tinfo, _ = configs()
    ts, _ = specs((20, 12, 10))
    curr, out = padded_fields(ts, np.float64, seed=10 + substep)
    monkeypatch.setattr(tsub, "_SLAB_CELLS", 3 * 20 * 12)  # slabs of 3 planes
    c, ids = Constants.from_info(tinfo), inv_ds_of(tinfo)
    got = tsub.substep_plain(tuple(torch.from_numpy(curr[k]) for k in FIELDS),
                             tuple(torch.from_numpy(out[k].copy()) for k in FIELDS),
                             ts, c, ids, substep, DT)
    off = ts.compute_offset()
    want = integrate_region(substep, Rect3(off, off + ts.base), ids, c, DT,
                            {k: torch.from_numpy(v) for k, v in curr.items()},
                            {k: torch.from_numpy(v.copy()) for k, v in out.items()})
    for k, g in zip(FIELDS, got):
        assert torch.equal(g, want[k]), k


# -- (c) the plain substep against the interpreted Pallas kernel -------------------

@pytest.mark.parametrize("substep", [0, 1, 2])
def test_substep_plain_matches_pallas_interpret(substep):
    tinfo, jinfo = configs()
    ts, js = specs((16, 16, 16))
    curr, out = padded_fields(ts, np.float32, seed=20 + substep)
    fn = make_pallas_substep(js, JConstants.from_info(jinfo), inv_ds_of(jinfo), substep, DT,
                             interpret=True)
    want = fn(tuple(jnp.asarray(curr[k]) for k in FIELDS),
              tuple(jnp.asarray(out[k]) for k in FIELDS))
    got = tsub.substep(tuple(torch.from_numpy(curr[k]) for k in FIELDS),
                       tuple(torch.from_numpy(out[k].copy()) for k in FIELDS),
                       ts, Constants.from_info(tinfo), inv_ds_of(tinfo), substep, DT)
    sl = compute_region(ts)
    for k, g, w in zip(FIELDS, got, want):
        np.testing.assert_allclose(g.numpy()[sl], np.asarray(w)[sl], err_msg=k,
                                   **TOL[np.float32])
        assert not np.array_equal(g.numpy()[sl], curr[k][sl])


# -- (d) the slice: make_astaroth_step against the JAX step -----------------------

@pytest.mark.parametrize("swap_per_substep", [False, True], ids=["reference", "swap"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_step_matches_jax(dtype, swap_per_substep):
    """Two iterations at dt = 1e-3 on one block (one CPU device), from
    random fields with zero halos, the state carried across by convert."""
    size = (24, 20, 16)
    tinfo, jinfo = configs(size)
    ts, js = specs(size)
    mesh = grid_mesh(js.dim, jax.devices()[:1])
    rng = np.random.RandomState(5)
    fields = {k: rng.randn(*size[::-1]) * 0.05 for k in FIELDS}
    fields["lnrho"] = fields["lnrho"] + 0.5
    jcurr = {k: jshard(v.astype(dtype), js, mesh) for k, v in fields.items()}
    jnxt = {k: jshard(np.zeros(size[::-1], dtype), js, mesh) for k in FIELDS}
    curr = state_from_jax({k: np.asarray(v) for k, v in jcurr.items()}, ts, "cpu")
    nxt = state_from_jax({k: np.asarray(v) for k, v in jnxt.items()}, ts, "cpu")
    assert all(t.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype for t in curr.values())

    name = np.dtype(dtype).name
    jstep = jmake_step(JHaloExchange(js, mesh), jinfo, dt=1e-3,
                       swap_per_substep=swap_per_substep, iters=2, dtype=name)
    jcurr, jnxt = jstep(jcurr, jnxt)
    step = make_astaroth_step(HaloExchange(ts), tinfo, dt=1e-3,
                              swap_per_substep=swap_per_substep, iters=2, dtype=name)
    launches = tsub.substep.launches
    curr, nxt = step(curr, nxt)
    assert tsub.substep.launches == launches  # CPU tensors run the plain version
    back = state_to_numpy(curr)
    for k in FIELDS:
        got = unshard_blocks(torch.from_numpy(back[k]), ts)
        want = junshard(jcurr[k], js)
        assert got.dtype == want.dtype == dtype
        np.testing.assert_allclose(got, want, err_msg=k, **TOL[dtype])
        assert not np.array_equal(got, fields[k].astype(dtype))


# -- (e) the app on the CPU ------------------------------------------------------

def test_app_run_cpu_reductions_match_jax():
    r = tapp.run(device="cpu", nx=16, iters=2, reductions=True)
    row = tapp.csv_row(r).split(",")
    assert row[:4] == ["1", "16", "16", "16"] and all(float(v) > 0 for v in row[4:])
    assert r["iters_run"] == 2 and r["dtype"] == "float64"
    dd, h = r["domain"], r["handles"]
    for name in FIELDS:
        assert dd.get_curr(h[name]).dtype == torch.float64
        assert np.isfinite(dd.get_curr_global(h[name])).all()
    js = JGridSpec(JDim3(16, 16, 16), JDim3(1, 1, 1), JRadius.constant(3))
    red = JReductions(JHaloExchange(js, grid_mesh(js.dim, jax.devices()[:1])))
    state = state_to_numpy({k: dd.get_curr(h[k]) for k in FIELDS})
    want = {"lnrho": red.scal(jnp.asarray(state["lnrho"])),
            "uu": red.vec(*(jnp.asarray(state[k]) for k in ("uux", "uuy", "uuz")))}
    for q in ("lnrho", "uu"):
        for stat, v in want[q].items():
            assert r["reductions"][q][stat] == pytest.approx(v, rel=1e-10, abs=1e-300), (q, stat)


def test_app_matches_jax_app_state():
    """The app's init and its iterations: the port's fp64 run on the CPU
    against the JAX app's on one CPU device, both at 12^3 for 2 iterations
    (plus the warm-up) at dt 1e-5. The hash-random init is rough at the
    conf's grid spacing, so its rates are large sums that cancel: at dt
    1e-3 one cell of 1728 lands 3e-10 apart; at 1e-5 the update is still
    far above the tolerance and the cancellation is not."""
    got = tapp.run(device="cpu", nx=12, iters=2, dt=1e-5)
    want = japp.run(iters=2, nx=12, devices=jax.devices()[:1], dt=1e-5)
    init = {}
    dd0, h0 = tapp.make_domain(tapp.load(nx=12), "float64", "cpu")
    for k in FIELDS:
        a = got["domain"].get_curr_global(got["handles"][k])
        b = want["domain"].get_curr_global(want["handles"][k])
        np.testing.assert_allclose(a, b, err_msg=k, **TOL[np.float64])
        init[k] = dd0.get_curr_global(h0[k])
        assert np.abs(a - init[k]).max() > 1e-6, k


def test_app_no_compute_and_f32_cli(capsys):
    assert tapp.main(["2", "--device", "cpu", "--nx", "12", "--f32", "--no-compute"]) == 0
    row = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert row[:4] == ["1", "12", "12", "12"]
    r = tapp.run(device="cpu", nx=12, iters=2, dtype="float32", chunk=2)
    assert r["iters_run"] == 2 and r["dtype"] == "float32"


# -- (f) what the kernel wrapper refuses -----------------------------------------

def _blocks(spec, dtype=torch.float64, device="cpu", n=8):
    p = spec.padded()
    return tuple(torch.zeros((p.z, p.y, p.x), dtype=dtype, device=device) for _ in range(n))


def _refusal(case):
    ts, _ = specs((16, 12, 10))
    if case == "meta device":
        return _blocks(ts, device="meta"), _blocks(ts, device="meta"), ts, 0, "cuda or cpu"
    if case == "radius 2":
        s2 = GridSpec(Dim3(16, 12, 10), Dim3(1, 1, 1), Radius.constant(2))
        return _blocks(s2), _blocks(s2), s2, 0, "radius >= 3"
    if case == "tight x":
        s0 = GridSpec(Dim3(128, 12, 10), Dim3(1, 1, 1), Radius.constant(3).without_x())
        return _blocks(s0), _blocks(s0), s0, 0, "radius >= 3"
    if case == "float16":
        return _blocks(ts, torch.float16), _blocks(ts, torch.float16), ts, 0, "fp32 or fp64"
    if case == "mixed dtypes":
        return _blocks(ts), _blocks(ts, torch.float32), ts, 0, "one dtype"
    if case == "wrong shape":
        other, _ = specs((16, 12, 12))
        return _blocks(ts), _blocks(other), ts, 0, "padded"
    if case == "seven fields":
        return _blocks(ts, n=7), _blocks(ts), ts, 0, "8 curr"
    if case == "aliased":
        c = _blocks(ts)
        return c, c, ts, 1, "distinct"
    if case == "non-contiguous":
        p = ts.padded()
        t = tuple(torch.zeros((p.z, p.y, p.x), dtype=torch.float64).transpose(0, 1)
                  .contiguous().transpose(0, 1) for _ in range(8))
        return t, _blocks(ts), ts, 0, "contiguous"
    if case == "stage 3":
        return _blocks(ts), _blocks(ts), ts, 3, "stage"
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["meta device", "radius 2", "tight x", "float16",
                                  "mixed dtypes", "wrong shape", "seven fields", "aliased",
                                  "non-contiguous", "stage 3"])
def test_substep_refuses(case):
    curr, out, spec, stage, msg = _refusal(case)
    tinfo, _ = configs()
    launches = tsub.substep.launches
    with pytest.raises(ValueError, match=msg):
        tsub.substep(curr, out, spec, Constants.from_info(tinfo), inv_ds_of(tinfo), stage, DT)
    assert tsub.substep.launches == launches


def test_step_refuses_unsupported_layouts():
    tinfo, _ = configs()
    s2 = GridSpec(Dim3(16, 12, 10), Dim3(1, 1, 1), Radius.constant(2))
    with pytest.raises(ValueError, match="radius >= 3"):
        make_astaroth_step(HaloExchange(s2), tinfo)
    ts, _ = specs((16, 12, 10))
    with pytest.raises(ValueError, match="fp32 or fp64"):
        make_astaroth_step(HaloExchange(ts), tinfo, dtype="float16")
    assert tsub.substep_supported(ts, torch.float32) and tsub.substep_supported(ts, torch.float64)
    assert tsub.stage_bytes(ts, 8, 0) == 16 * 8 * 16 * 12 * 10
    assert tsub.stage_bytes(ts, 4, 1) == 24 * 4 * 16 * 12 * 10
