"""Astaroth tenants in the port's campaign against the JAX package on the
CPU: the batched step (``make_batched_astaroth_step``, the XLA step in the
JAX package), the driver on a mixed Jacobi + Astaroth job list with the same
injected eviction, a revival from the other package's snapshot, the CLI's
``--workload``, the tenant forms of B5's task table and B4's fill (their
tables and layouts pinned to the kernel sources and replayed against the
plain versions), and the refusals.

Tolerances: Jacobi bit-exact (byte-equal); Astaroth fp64 within 1e-10 of
the field's largest magnitude, fp32 rtol 1e-4 / atol 1e-5; the fills and
the tables exact. Inputs come from numpy seeds (conftest enables x64)."""

import pathlib
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stencil_tpu.astaroth.integrate as jinteg
import stencil_tpu.campaign as jcamp
import stencil_tpu.domain.grid as jgrid
import stencil_tpu.geometry as jgeo
import stencil_tpu.ops.halo_fill as jfill
import stencil_tpu_torch.astaroth.integrate as tinteg
import stencil_tpu_torch.campaign as tcamp
import stencil_tpu_torch.domain.grid as tgrid
import stencil_tpu_torch.geometry as tgeo
from stencil_tpu_torch.apps import campaign as tapp
from stencil_tpu_torch.astaroth.equations import Constants
from stencil_tpu_torch.ops import astaroth_substep as asub
from stencil_tpu_torch.ops import halo_fill as tfill

torch.set_num_threads(2)

DEV1 = jax.devices()[:1]
FIELDS = tinteg.FIELDS
CSRC = pathlib.Path(asub.__file__).resolve().parent.parent / "csrc"
SIZE = (10, 8, 6)


def specs(size, radius=3, part=(1, 1, 1)):
    return (tgrid.GridSpec(tgeo.Dim3(*size), tgeo.Dim3(*part), tgeo.Radius.constant(radius),
                           aligned=False),
            jgrid.GridSpec(jgeo.Dim3(*size), jgeo.Dim3(*part), jgeo.Radius.constant(radius),
                           aligned=False))


def rough(spec, b, dtype, seed):
    """8 random (b, pz, py, px) fields in [0, 0.1), halos included."""
    p = spec.padded()
    rng = np.random.RandomState(seed)
    return {k: (rng.rand(b, p.z, p.y, p.x) * 0.1).astype(dtype) for k in FIELDS}


def assert_close(got, want, dtype):
    if np.dtype(dtype) == np.float64:
        scale = max(float(np.abs(want).max()), 1e-300)
        assert float(np.abs(got - want).max()) <= 1e-10 * scale
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# -- the batched step ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_batched_step_matches_jax(dtype):
    """3 tenants of 10x8x6, 2 iterations from rough fields at dt 1e-3: both
    returned stacks on the full padded arrays; the port's are its own input
    tensors, swapped (it updates in place)."""
    tspec, jspec = specs(SIZE)
    info_t = tcamp.WORKLOADS["astaroth"]._info(tspec)
    info_j = jcamp.WORKLOADS["astaroth"]._info(jspec)
    c, o = rough(tspec, 3, dtype, 1), rough(tspec, 3, dtype, 2)
    jc, jo = jinteg.make_batched_astaroth_step(jspec, info_j, dt=1e-3, iters=2)(
        {k: jnp.asarray(v) for k, v in c.items()}, {k: jnp.asarray(v) for k, v in o.items()})
    tc = {k: torch.from_numpy(v.copy()) for k, v in c.items()}
    to = {k: torch.from_numpy(v.copy()) for k, v in o.items()}
    step = tinteg.make_batched_astaroth_step(tspec, info_t, dt=1e-3, iters=2, device="cpu")
    gc, go = step(tc, to)
    assert all(gc[k] is tc[k] and go[k] is to[k] for k in FIELDS)  # two swaps
    for k in FIELDS:
        assert_close(gc[k].numpy(), np.asarray(jc[k]), dtype)
        assert_close(go[k].numpy(), np.asarray(jo[k]), dtype)
    # one iteration returns the pair swapped
    gc1, go1 = tinteg.make_batched_astaroth_step(tspec, info_t, dt=1e-3, device="cpu")(tc, to)
    assert all(gc1[k] is to[k] and go1[k] is tc[k] for k in FIELDS)


def test_batched_step_refusals():
    tspec, jspec = specs(SIZE)
    info = tcamp.WORKLOADS["astaroth"]._info(tspec)
    part_t, part_j = specs((20, 8, 6), part=(2, 1, 1))
    with pytest.raises(ValueError, match="single-block domains"):
        tinteg.make_batched_astaroth_step(part_t, info, device="cpu")
    with pytest.raises(ValueError, match="single-block domains"):
        jinteg.make_batched_astaroth_step(part_j, jcamp.WORKLOADS["astaroth"]._info(jspec))
    r2_t, r2_j = specs(SIZE, radius=2)
    with pytest.raises(ValueError, match=r"face radius >= 3 \(6th-order stencils\)"):
        tinteg.make_batched_astaroth_step(r2_t, info, device="cpu")
    with pytest.raises(ValueError, match=r"face radius >= 3 \(6th-order stencils\)"):
        jinteg.make_batched_astaroth_step(r2_j, jcamp.WORKLOADS["astaroth"]._info(jspec))
    step = tinteg.make_batched_astaroth_step(tspec, info, device="cpu")
    meta = {k: torch.zeros((1, 12, 14, 16), device="meta") for k in FIELDS}
    with pytest.raises(ValueError, match="built for cpu"):
        step(meta, {k: torch.zeros_like(t) for k, t in meta.items()})


# -- the driver ---------------------------------------------------------------------


def mixed_jobs(mod, steps=4):
    """Two jacobi fp32 tenants and three astaroth fp64 tenants, queued
    interleaved (two buckets, never one slot)."""
    return [mod.TenantJob("j0", (8, 8, 8), steps, "float32", seed=3),
            mod.TenantJob("a0", SIZE, steps, "float64", seed=4, workload="astaroth"),
            mod.TenantJob("a1", SIZE, steps, "float64", seed=5, workload="astaroth"),
            mod.TenantJob("j1", (8, 8, 8), steps, "float32", seed=6),
            mod.TenantJob("a2", SIZE, steps, "float64", seed=7, workload="astaroth")]


INJECT = dict(inject="nan@3:tenant=a1:repeat=always", max_rollbacks=1, rollback_backoff=0.0)


@pytest.fixture(scope="module")
def driver_runs(tmp_path_factory):
    """One JAX and one port run of the mixed list with a1 faulted from step
    3 (evicted), slot 2, chunks of 2; then each package revives a1 (no
    fault) from the OTHER package's campaign directory."""
    base = tmp_path_factory.mktemp("astaroth-campaign")
    t = tcamp.CampaignDriver(mixed_jobs(tcamp), 2, str(base / "t"), chunk=2, device="cpu",
                             **INJECT).run()
    j = jcamp.CampaignDriver(mixed_jobs(jcamp), 2, str(base / "j"), chunk=2, devices=DEV1,
                             **INJECT).run()
    for src, dst in (("t", "t-revived-by-j"), ("j", "j-revived-by-t")):
        shutil.copytree(base / src, base / dst)
    rj = jcamp.CampaignDriver([mixed_jobs(jcamp)[2]], 1, str(base / "t-revived-by-j"),
                              chunk=2, devices=DEV1, resume=True).run()
    rt = tcamp.CampaignDriver([mixed_jobs(tcamp)[2]], 1, str(base / "j-revived-by-t"),
                              chunk=2, device="cpu", resume=True).run()
    return t, j, rt, rj


def test_driver_matches_jax_with_the_same_eviction(driver_runs):
    t, j, _, _ = driver_runs
    assert t["evicted"] == j["evicted"] == ["a1"]
    assert t["slots"] == j["slots"]
    assert set(t["results"]) == set(j["results"]) == {"j0", "j1", "a0", "a1", "a2"}
    for tid, want in j["results"].items():
        got = t["results"][tid]
        assert (got.outcome, got.steps) == (want.outcome, want.steps), tid
        if want.outcome != "done":
            assert got.evidence and got.evidence.endswith("fault-evidence.json")
            continue
        assert sorted(got.finals) == sorted(want.finals)
        for k, w in want.finals.items():
            if tid.startswith("j"):
                assert got.finals[k].tobytes() == w.tobytes(), (tid, k)
            else:
                assert got.finals[k].dtype == np.float64
                assert_close(got.finals[k], w, np.float64)
    assert t["cell_steps"] == j["cell_steps"]


def test_each_package_revives_the_others_astaroth_snapshot(driver_runs):
    """The evicted tenant's last healthy snapshot carries all 8 fields; the
    JAX driver revives the port's and the port the JAX package's, each
    finishing a1 within the fp64 tolerance of the other."""
    _, _, rt, rj = driver_runs
    assert rt["results"]["a1"].outcome == rj["results"]["a1"].outcome == "done"
    for k in FIELDS:
        assert_close(rt["results"]["a1"].finals[k], rj["results"]["a1"].finals[k], np.float64)


def test_app_serves_astaroth_batched_only(tmp_path):
    """``--workload astaroth`` (batched): every tenant's fields equal the
    driver's on the same jobs, byte for byte; the A/B and the sequential
    mode refuse it, as in the JAX app, and so does run_sequential."""
    argv = ["--workload", "astaroth", "--tenants", "3", "--slot", "2", "--size", "8",
            "--steps", "2", "--dtype", "float64", "--device", "cpu"]
    out = tapp.run_modes(tapp.parse_args(argv), str(tmp_path / "app"))
    assert out["workload"] == "astaroth" and out["evicted"] == []
    jobs = [tcamp.TenantJob(f"t{i}", (8, 8, 8), 2, "float64", seed=i, workload="astaroth")
            for i in range(3)]
    ref = tcamp.CampaignDriver(jobs, 2, str(tmp_path / "drv"), device="cpu").run()
    for tid, r in ref["results"].items():
        got = out["_batched"]["results"][tid]
        assert all(got.finals[k].tobytes() == r.finals[k].tobytes() for k in FIELDS)
    for mode in ("ab", "sequential"):
        with pytest.raises(SystemExit):
            tapp.parse_args(argv + ["--mode", mode])
    with pytest.raises(NotImplementedError, match="B=1 slot"):
        tcamp.run_sequential(jobs, device="cpu")


def test_driver_serving_attributes():
    """slo_min_samples is a setting again; sentinel, status and replan stay
    None until their modules are ported."""
    d = tcamp.CampaignDriver([], 1, "unused", device="cpu", slo_min_samples=5)
    assert d.slo_min_samples == 5
    assert (d.sentinel, d.status, d.replan) == (None, None, None)
    assert tcamp.CampaignDriver([], 1, "unused", device="cpu",
                                slo_min_samples=0).slo_min_samples == 1


# -- B5's tenant table, pinned to the kernel source ----------------------------------


SUBSTEP_SRC = (CSRC / "astaroth_substep.cu").read_text()


def _walk(rows, tiles):
    """The kernel's walk: each grid block's task row (the last whose first
    tile is <= the block's) and its tile's columns, rows and planes."""
    starts = [r[0] for r in rows]
    for w in range(tiles):
        i = max(k for k, s in enumerate(starts) if s <= w)
        t = rows[i]
        gx, gy, zc = t[8], t[9], t[10]
        tz, r = divmod(w - t[0], gx * gy)
        yield i, (r % gx) * asub.TILE[0], (r // gx) * asub.TILE[1], tz * zc, min(t[5] - tz * zc,
                                                                                zc)


@pytest.mark.parametrize("size,b", [((32, 32, 32), 64), ((33, 13, 7), 5), ((6, 5, 4), 300)])
def test_tenant_table_covers_every_cell_of_every_tenant_once(size, b):
    """One task a tenant (its block the lane, its rect the base compute
    region), cut into launches of MAX_TASKS rows (the source's), each
    group's walk covering its tenants' cells once; tensor copies only on an
    even x pitch in fp64."""
    assert asub.MAX_TASKS == int(re.search(r"constexpr int MAX_TASKS = (\d+);",
                                           SUBSTEP_SRC).group(1))
    spec = specs(size)[0]
    tasks = asub.tenant_tasks(spec, b)
    off = spec.compute_offset()
    assert [tuple(t) for t in tasks] == [(j, tgeo.Rect3(off, off + spec.base))
                                         for j in range(b)]
    rows, tiles = asub.substep_table(tasks, spec, 132, 8)
    assert [r[1] for r in rows] == list(range(b))
    assert all(r[-1] == (spec.padded().x % 2 == 0) for r in rows)
    groups = asub.table_launches(rows, tiles)
    assert [len(g) for g, _ in groups] == [min(asub.MAX_TASKS, b - i)
                                           for i in range(0, b, asub.MAX_TASKS)]
    n = spec.base
    done = 0
    for g, t in groups:
        cover = np.zeros((len(g), n.z, n.y, n.x), dtype=np.int32)
        for i, x0, y0, z0, nz in _walk(g, t):
            cover[i, z0:z0 + nz, y0:y0 + asub.TILE[1], x0:x0 + asub.TILE[0]] += 1
        assert (cover == 1).all()
        done += len(g)
    assert done == b


def test_tenant_tasks_pass_the_stage_checks():
    """Stages 1-2 take whole compute regions of distinct tenants; a shell of
    a tenant, a repeated tenant or a tenant past the stack is refused."""
    spec = specs(SIZE)[0]
    p = spec.padded()
    fields = [torch.zeros((3, p.z, p.y, p.x), dtype=torch.float64) for _ in range(16)]
    consts = Constants(1.0, 0.5, 1.0, 1.3, 1.2, 1.4, 5e-3, 5e-3, 0.01)
    tasks = asub.tenant_tasks(spec, 3)
    for s in (0, 1, 2):
        asub.substep_tasks(fields[:8], fields[8:], spec, tasks, consts, (1.0,) * 3, s, 1e-3)
    shell = asub.shell_tasks(spec)[0]
    for bad in ((tasks[0], tasks[0]), (asub.SubstepTask(2, shell.rect),)):
        with pytest.raises(ValueError, match="stages 1-2"):
            asub.substep_tasks(fields[:8], fields[8:], spec, bad, consts, (1.0,) * 3, 1, 1e-3)
    asub.substep_tasks(fields[:8], fields[8:], spec, (asub.SubstepTask(2, shell.rect),), consts,
                       (1.0,) * 3, 0, 1e-3)
    with pytest.raises(ValueError, match="outside the stacks"):
        asub.substep_tasks(fields[:8], fields[8:], spec, asub.tenant_tasks(spec, 4), consts,
                           (1.0,) * 3, 0, 1e-3)
    with pytest.raises(ValueError, match="single-block"):
        asub.tenant_tasks(specs((20, 8, 6), part=(2, 1, 1))[0], 2)


def test_tenant_stage_equals_one_block_stages():
    """The plain tenant stage of each lane equals the one-block stage of
    that tenant alone (what chip_smoke.py holds the kernel to)."""
    spec = specs(SIZE)[0]
    consts = Constants.from_info(tcamp.WORKLOADS["astaroth"]._info(spec))
    c = {k: torch.from_numpy(v) for k, v in rough(spec, 3, np.float64, 9).items()}
    o = {k: torch.from_numpy(v) for k, v in rough(spec, 3, np.float64, 10).items()}
    alone = {k: t.clone() for k, t in o.items()}
    for s in (0, 1, 2):
        asub.substep_tasks(tuple(c.values()), tuple(o.values()), spec,
                           asub.tenant_tasks(spec, 3), consts, (2.0, 3.0, 4.0), s, 0.1)
        for j in range(3):
            asub.substep([c[k][j] for k in FIELDS], [alone[k][j] for k in FIELDS], spec, consts,
                         (2.0, 3.0, 4.0), s, 0.1)
    assert all(torch.equal(o[k], alone[k]) for k in FIELDS)


# -- B4's tenant fill, pinned to the kernel source -----------------------------------


FILL_SRC = (CSRC / "self_fill.cu").read_text()


@pytest.mark.parametrize("elem", [4, 8])
@pytest.mark.parametrize("size", [(32, 32, 32), (33, 13, 7), SIZE])
def test_tenant_z_fill_layout_covers_the_plain_fill(size, elem):
    """The z layout of a tenant stack: the one-tenant runs repeated over the
    B tenants one padded block apart (the kernel's runs body steps each
    instance by the stride), writing exactly the cells the plain fill of
    every tenant changes, each from the cell it reads; x and y are the
    z-stack form's."""
    assert "a = (V*)ptrs.p[blockIdx.y] + (long long)(inst >> 1) * stride" in FILL_SRC
    spec, b = specs(size)[0], 4
    p = spec.padded()
    lay = tfill.fill_layout(spec, "z", elem, z_stack=b, tenants=True)
    one = tfill.fill_layout(spec, "z", elem)
    assert (lay.body, lay.count, lay.stride, lay.runs) == ("runs", b, p.z * p.y * p.x, one.runs)
    assert lay.vec * elem in (elem, 8, 16) and lay.stride % lay.vec == 0
    for axis in "xy":
        assert tfill.fill_layout(spec, axis, elem, b, tenants=True) == tfill.fill_layout(
            spec, axis, elem, b)
    dtype = torch.float32 if elem == 4 else torch.float64
    before = torch.arange(b * p.z * p.y * p.x, dtype=dtype).reshape(b, p.z, p.y, p.x)
    after = tfill.self_fill_plain([before.clone()], spec, "z")[0].reshape(-1)
    changed = np.flatnonzero((after != before.reshape(-1)).numpy())
    dst = np.concatenate([np.arange(i * lay.stride + d, i * lay.stride + d + w)
                          for i in range(b) for d, _s, w in lay.runs])
    src = np.concatenate([np.arange(i * lay.stride + s, i * lay.stride + s + w)
                          for i in range(b) for _d, s, w in lay.runs])
    np.testing.assert_array_equal(np.sort(dst), changed)
    np.testing.assert_array_equal(after.numpy()[dst], src.astype(after.numpy().dtype))
    with pytest.raises(ValueError, match="z-stack"):
        tfill.fill_layout(spec, "z", elem, z_stack=b)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_wrap_fill_tenants_matches_jax(dtype):
    """The composed tenant fill of 8 stacks equals the JAX package's
    wrap_fill_batched of each, bit for bit."""
    tspec, jspec = specs((11, 7, 6))
    fields = rough(tspec, 3, dtype, 11)
    got = tfill.wrap_fill_tenants(tspec, [torch.from_numpy(v.copy()) for v in fields.values()])
    for g, v in zip(got, fields.values()):
        assert g.numpy().tobytes() == np.asarray(
            jfill.wrap_fill_batched(jspec, jnp.asarray(v))).tobytes()
    with pytest.raises(ValueError, match="tenant stacks"):
        tfill.wrap_fill_tenants(tspec, [torch.zeros((4, 5, 6))])


def test_tenant_forms_take_plain_versions_only_on_cpu(monkeypatch):
    """On CPU stacks the tenant fill and the tenant stage run their plain
    versions (no launch counted); on any other device they are refused."""
    spec = specs(SIZE)[0]
    p = spec.padded()
    calls = []
    monkeypatch.setattr(tfill, "self_fill_plain", lambda *a, **k: calls.append("fill"))
    monkeypatch.setattr(asub, "substep_tasks_plain", lambda *a, **k: calls.append("stage"))
    before = (tfill.self_fill.launches, asub.substep_tasks.launches)
    fields = [torch.zeros((2, p.z, p.y, p.x), dtype=torch.float64) for _ in range(16)]
    consts = Constants(1.0, 0.5, 1.0, 1.3, 1.2, 1.4, 5e-3, 5e-3, 0.01)
    tfill.wrap_fill_tenants(spec, fields[:8])
    asub.substep_tasks(fields[:8], fields[8:], spec, asub.tenant_tasks(spec, 2), consts,
                       (1.0,) * 3, 0, 1e-3)
    assert calls == ["fill"] * 3 + ["stage"]
    assert before == (tfill.self_fill.launches, asub.substep_tasks.launches)
    meta = [torch.zeros((2, p.z, p.y, p.x), dtype=torch.float64, device="meta")
            for _ in range(16)]
    with pytest.raises(ValueError):
        tfill.wrap_fill_tenants(spec, meta[:8])
    with pytest.raises(ValueError):
        asub.substep_tasks(meta[:8], meta[8:], spec, asub.tenant_tasks(spec, 2), consts,
                           (1.0,) * 3, 0, 1e-3)
    assert len(calls) == 4
