"""Astaroth on resident blocks, the rest of the slice against the JAX package
on the CPU (helpers and tolerances: ``test_torch_astaroth_resident.py``):

- the substep's table form (``substep_tasks``) in its plain version against
  the per-block plain substep, and its shell tasks against the JAX
  package's ``_integrate_region`` on the same rects;
- ``apps.astaroth.run(partition=(2, 2, 2))`` against the JAX app's 8-device
  run: state, reductions and the CSV row;
- the reductions over resident stacks, uniform and uneven;
- ``astaroth.boundconds`` bit-exact against the JAX module;
- a guarded resident run whose rollback matches the clean run, and the
  app's ``no_compute`` on residents;
- the refusals: radius < 3, mixed dtypes, a shell task at stage 1 or 2, a
  task outside its block, a mesh of positions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stencil_tpu.apps.astaroth as japp
import stencil_tpu.astaroth.boundconds as jbc
import stencil_tpu_torch.apps.astaroth as tapp
import stencil_tpu_torch.astaroth.boundconds as tbc
from stencil_tpu.astaroth.equations import Constants as JConstants
from stencil_tpu.astaroth.integrate import _integrate_region
from stencil_tpu.astaroth.reductions import Reductions as JReductions
from stencil_tpu.geometry import Rect3 as JRect3
from stencil_tpu.geometry import exterior_regions as jexterior
from stencil_tpu.geometry import interior_region as jinterior
from stencil_tpu.parallel import HaloExchange as JHaloExchange
from stencil_tpu_torch import DistributedDomain, HaloExchange
from stencil_tpu_torch.astaroth.equations import Constants
from stencil_tpu_torch.astaroth.integrate import FIELDS, inv_ds_of, make_astaroth_step
from stencil_tpu_torch.astaroth.reductions import Reductions, compute_mask
from stencil_tpu_torch.geometry import Dim3, Rect3
from stencil_tpu_torch.ops import astaroth_substep as tsub
from stencil_tpu_torch.parallel import Method
from test_torch_astaroth_resident import TOL, configs, resident_mesh, specs

torch.set_num_threads(2)

DT = 0.1  # large enough that the update is visible


def stacked_fields(spec, dtype, seed):
    """Random curr and out stacks over every padded block (halos
    included), values in [0, 0.1)."""
    rng = np.random.RandomState(seed)
    shape = spec.stacked_shape_zyx()
    curr = {k: (rng.rand(*shape) * 0.1).astype(dtype) for k in FIELDS}
    out = {k: (rng.rand(*shape) * 0.1).astype(dtype) for k in FIELDS}
    return curr, out


def torch8(d):
    return tuple(torch.from_numpy(d[k].copy()) for k in FIELDS)


# -- the table form's plain version ------------------------------------------------

@pytest.mark.parametrize("stage", [0, 1, 2])
@pytest.mark.parametrize("size", [(16, 16, 16), (19, 18, 16)], ids=["uniform", "uneven"])
def test_tasks_plain_matches_per_block(size, stage):
    """One stage over every block's compute region in one call against the
    plain substep block by block (uniform: ``substep_plain``; uneven: the
    region math over each block's own extent), bit-equal; cells outside
    the compute regions keep their contents."""
    tinfo, _ = configs(size)
    c, ids = Constants.from_info(tinfo), inv_ds_of(tinfo)
    ts, _ = specs(size, (2, 2, 2))
    curr, out = stacked_fields(ts, np.float64, seed=30 + stage)
    got = tsub.substep_tasks(torch8(curr), torch8(out), ts, tsub.compute_tasks(ts), c, ids,
                             stage, DT)
    p = ts.padded()
    cb = [t.view(-1, p.z, p.y, p.x) for t in torch8(curr)]
    want = [t.view(-1, p.z, p.y, p.x) for t in torch8(out)]
    for j in range(8):
        cj, wj = [t[j] for t in cb], [t[j] for t in want]
        if ts.is_uniform():
            tsub.substep_plain(cj, wj, ts, c, ids, stage, DT)
        else:
            tsub.substep_tasks_plain(cj, wj, ts, ((0, tsub.block_compute(ts, j)),), c, ids,
                                     stage, DT)
    for k, g, w, o in zip(FIELDS, got, want, torch8(out)):
        assert torch.equal(g.view_as(w), w), k
        mask = torch.from_numpy(~compute_mask(ts))
        assert torch.equal(g[mask], o[mask]), k


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_shell_tasks_match_jax_integrate_region(dtype):
    """Stage 0 over every block's 6 exterior shells (one call, 48 tasks) from
    random stacks against the JAX package's ``_integrate_region`` over the
    overlap iteration's ``exteriors`` rects on the stacked arrays, every
    cell compared (the rest of ``out`` untouched in both)."""
    size = (16, 16, 16)
    tinfo, jinfo = configs(size)
    ts, js = specs(size, (2, 2, 2))
    curr, out = stacked_fields(ts, dtype, seed=41)
    tasks = tsub.shell_tasks(ts)
    assert len(tasks) == 48
    got = tsub.substep_tasks(torch8(curr), torch8(out), ts, tasks, Constants.from_info(tinfo),
                             inv_ds_of(tinfo), 0, DT)
    joff = js.compute_offset()
    compute = JRect3(joff, joff + js.base)
    jc = {k: jnp.asarray(v) for k, v in curr.items()}
    jo = {k: jnp.asarray(v) for k, v in out.items()}
    rects = jexterior(compute, jinterior(compute, js.radius))
    assert [tuple(r.lo) + tuple(r.hi) for r in rects] == [
        tuple(t.rect.lo) + tuple(t.rect.hi) for t in tasks[:6]]
    for rect in rects:
        jo = _integrate_region(0, rect, inv_ds_of(jinfo), JConstants.from_info(jinfo), DT, jc, jo)
    for k, g in zip(FIELDS, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(jo[k]), err_msg=k, **TOL[dtype])
        assert not np.array_equal(g.numpy(), out[k])


# -- the app ---------------------------------------------------------------------

def test_app_matches_jax_app_8_devices():
    """``run(partition=(2,2,2), nx=8)`` (8 resident blocks of 8^3, 16^3
    global) against the JAX app's ``run(devices=jax.devices()[:8], nx=8)``:
    every cell within 1e-10 after 2 iterations and the warm-up at dt 1e-5
    (the hash init's cancellation, ``test_torch_astaroth.py``), the
    reductions, and the CSV row's processes column (the block count)."""
    got = tapp.run(device="cpu", nx=8, iters=2, dt=1e-5, reductions=True, partition=(2, 2, 2))
    want = japp.run(iters=2, nx=8, devices=jax.devices()[:8], dt=1e-5, reductions=True)
    assert got["global"] == Dim3(16, 16, 16) and tuple(want["global"]) == (16, 16, 16)
    assert tapp.csv_row(got).split(",")[:4] == ["8", "8", "8", "8"] == \
        japp.csv_row(want).split(",")[:4]
    assert got["domain"].spec.dim == Dim3(2, 2, 2) and got["iters_run"] == 2
    for k in FIELDS:
        a = got["domain"].get_curr_global(got["handles"][k])
        b = want["domain"].get_curr_global(want["handles"][k])
        np.testing.assert_allclose(a, b, err_msg=k, **TOL[np.float64])
    for q in ("lnrho", "uu"):
        for stat, v in want["reductions"][q].items():
            assert got["reductions"][q][stat] == pytest.approx(v, rel=1e-10, abs=1e-300), (q, stat)


@pytest.mark.parametrize("size", [(16, 16, 16), (19, 18, 16)], ids=["uniform", "uneven"])
def test_reductions_on_residents_match_jax(size):
    """Scalar and vector reductions over (2,2,2) stacks with garbage in the
    halos, pad and (uneven) dead tails, against the JAX reductions on its
    resident mesh."""
    ts, js = specs(size, (2, 2, 2))
    rng = np.random.RandomState(7)
    arrs = [rng.randn(*ts.stacked_shape_zyx()) * 10 for _ in range(3)]
    red, jred = Reductions(HaloExchange(ts)), JReductions(JHaloExchange(js, resident_mesh()))
    got = {"s": red.scal(torch.from_numpy(arrs[0])),
           "v": red.vec(*(torch.from_numpy(a) for a in arrs))}
    want = {"s": jred.scal(jnp.asarray(arrs[0])), "v": jred.vec(*(jnp.asarray(a) for a in arrs))}
    for q in ("s", "v"):
        for stat, v in want[q].items():
            assert got[q][stat] == pytest.approx(v, rel=1e-12), (q, stat)


# -- boundary conditions ---------------------------------------------------------------

@pytest.mark.parametrize("part", [(1, 1, 1), (1, 1, 2)])
def test_boundconds_match_jax(part):
    """Every single-block axis, both signs, and ``apply_boundconds`` over a
    kinds dict, bit-exact on every cell; a multi-block axis and an unknown
    kind raise in both."""
    ts, js = specs((12, 10, 8), part)
    rng = np.random.RandomState(3)
    a = rng.randn(*ts.stacked_shape_zyx())
    single = [ax for ax, n in zip("xyz", part) if n == 1]
    for axis in single:
        for tf, jf in ((tbc.symmetric, jbc.symmetric), (tbc.antisymmetric, jbc.antisymmetric)):
            got = tf(torch.from_numpy(a), ts, axis)
            np.testing.assert_array_equal(got.numpy(), np.asarray(jf(jnp.asarray(a), js, axis)))
    kinds = {"x": tbc.SYMMETRIC, "y": tbc.ANTISYMMETRIC, "z": tbc.PERIODIC}
    arg = torch.from_numpy(a.copy())
    got = tbc.apply_boundconds(arg, ts, kinds)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jbc.apply_boundconds(jnp.asarray(a), js, kinds)))
    assert not np.array_equal(got.numpy(), a) and np.array_equal(arg.numpy(), a)
    for axis in "xyz":
        if axis not in single:
            with pytest.raises(ValueError, match="single block"):
                tbc.symmetric(torch.from_numpy(a), ts, axis)
            with pytest.raises(ValueError, match="single block"):
                jbc.symmetric(jnp.asarray(a), js, axis)
    with pytest.raises(ValueError, match="unknown boundary"):
        tbc.apply_boundconds(torch.from_numpy(a), ts, {"x": "open"})


# -- the guarded loop and the exchange alone on residents ----------------------------------

def test_guarded_resident_rollback_matches_clean_run(tmp_path, capsys):
    """A NaN injected at step 2 of a (2,2,2) run rolls back to the step-1
    snapshot and the run ends bit-equal to the clean one."""
    kw = dict(device="cpu", nx=8, iters=3, chunk=1, dt=1e-5, partition=(2, 2, 2))
    got = tapp.run(ckpt_dir=str(tmp_path / "g"), ckpt_every=1, health_every=1,
                   inject="nan@2:q=lnrho", rollback_backoff=0.01, **kw)
    assert "rolled back from step 2 to checkpointed step 1" in capsys.readouterr().err
    clean = tapp.run(ckpt_dir=str(tmp_path / "c"), **kw)
    assert got["iters_run"] == 3 and got["processes"] == 8
    for k in FIELDS:
        a = got["domain"].get_curr_global(got["handles"][k])
        assert np.isfinite(a).all(), k
        np.testing.assert_array_equal(a, clean["domain"].get_curr_global(clean["handles"][k]))


def test_no_compute_on_residents():
    r = tapp.run(device="cpu", nx=8, iters=2, no_compute=True, partition=(1, 1, 2))
    assert tapp.csv_row(r).split(",")[:4] == ["2", "8", "8", "8"]
    assert r["iter_trimean_s"] > 0 and r["exch_trimean_s"] > 0


# -- refusals ------------------------------------------------------------------------

def _stacks(spec, dtype=torch.float64, n=8):
    return tuple(torch.zeros(spec.stacked_shape_zyx(), dtype=dtype) for _ in range(n))


def test_table_form_refuses():
    tinfo, _ = configs((16, 16, 16))
    c, ids = Constants.from_info(tinfo), inv_ds_of(tinfo)
    ts, _ = specs((16, 16, 16), (2, 2, 2))
    launches = tsub.substep_tasks.launches
    shells, full = tsub.shell_tasks(ts), tsub.compute_tasks(ts)
    for stage in (1, 2):
        with pytest.raises(ValueError, match=f"shell task at stage {stage}"):
            tsub.substep_tasks(_stacks(ts), _stacks(ts), ts, shells, c, ids, stage, DT)
        with pytest.raises(ValueError, match="shell task"):
            tsub.substep_tasks(_stacks(ts), _stacks(ts), ts, full[:4] + full[:1], c, ids,
                               stage, DT)
    with pytest.raises(ValueError, match="one dtype"):
        tsub.substep_tasks(_stacks(ts), _stacks(ts, torch.float32), ts, full, c, ids, 0, DT)
    with pytest.raises(ValueError, match="outside the stacks"):
        tsub.substep_tasks(_stacks(ts), _stacks(ts), ts, [(8, full[0].rect)], c, ids, 0, DT)
    off = ts.compute_offset()
    with pytest.raises(ValueError, match="halo"):
        tsub.substep_tasks(_stacks(ts), _stacks(ts), ts,
                           [(0, Rect3(off - Dim3(1, 0, 0), off + ts.base))], c, ids, 0, DT)
    with pytest.raises(ValueError, match="stack"):
        tsub.substep_tasks(_stacks(ts), tuple(t[:1] for t in _stacks(ts)), ts, full, c, ids, 0,
                           DT)
    s2, _ = specs((16, 16, 16), (2, 2, 2), r=2)
    with pytest.raises(ValueError, match="radius >= 3"):
        tsub.substep_tasks(_stacks(s2), _stacks(s2), s2, tsub.compute_tasks(s2), c, ids, 0, DT)
    with pytest.raises(ValueError, match="radius >= 3"):
        make_astaroth_step(HaloExchange(s2), tinfo, dtype="float64")
    assert tsub.substep_tasks.launches == launches


def test_step_refuses_a_mesh_of_positions():
    """A mesh of positions takes only REMOTE_DMA, as every mesh of the port
    (AXIS_COMPOSED over positions raises at realize, ROADMAP.md queue A item
    5); over REMOTE_DMA the step runs on the mesh and gives the resident
    step's cells."""
    tinfo, _ = configs((16, 16, 16))

    def domain(method, devices):
        dd = DistributedDomain(16, 16, 16, device="cpu")
        dd.set_radius(3)
        dd.set_partition((2, 2, 2))
        if devices:
            dd.set_devices(devices)
        dd.set_methods(method)
        hs = [dd.add_data(k, "float64") for k in FIELDS]
        return dd, hs

    dd, _ = domain(Method.AXIS_COMPOSED, ["cpu"] * 8)
    with pytest.raises(NotImplementedError, match="mesh"):
        dd.realize()
    rng = np.random.RandomState(4)
    g = {k: rng.randn(16, 16, 16) * 0.05 + 0.5 * (k == "lnrho") for k in FIELDS}
    cells = []
    for method, devices in ((Method.REMOTE_DMA, ["cpu"] * 8), (Method.AXIS_COMPOSED, None)):
        dd, hs = domain(method, devices)
        dd.realize()
        for h, k in zip(hs, FIELDS):
            dd.set_curr_global(h, g[k])
        curr, nxt = dd.curr_state(), dd.next_state()
        step = make_astaroth_step(dd.halo_exchange, tinfo, dt=1e-3, iters=2, dtype="float64")
        curr, _ = step({k: curr[h.idx] for h, k in zip(hs, FIELDS)},
                       {k: nxt[h.idx] for h, k in zip(hs, FIELDS)})
        for h, k in zip(hs, FIELDS):
            dd.set_curr(h, curr[k])
        cells.append([dd.get_curr_global(h) for h in hs])
    for k, a, b in zip(FIELDS, *cells):
        np.testing.assert_array_equal(a, b, err_msg=k)
