"""The port's multi-tenant campaign path against the JAX package on the CPU:
the batched loop (against the XLA branch on the full padded arrays, and the
interpreted Pallas ``batch=`` kernel on compute regions), slot packing, the
driver and the sequential baseline (every tenant's final field, across
packages and modes), the backfill order, the injected eviction with its
rc-43 evidence and revival, the compile cache and its keys. Tolerance:
bit-exact (byte-equal) throughout. Inputs come from numpy seeds with
explicit dtypes (conftest enables x64)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stencil_tpu.campaign as jcamp
import stencil_tpu.domain.grid as jgrid
import stencil_tpu.geometry as jgeo
import stencil_tpu.obs.telemetry as jtel
import stencil_tpu.ops.jacobi as jjac
import stencil_tpu.plan.ir as jir
import stencil_tpu_torch.campaign as tcamp
import stencil_tpu_torch.domain.grid as tgrid
import stencil_tpu_torch.geometry as tgeo
import stencil_tpu_torch.obs.telemetry as ttel
import stencil_tpu_torch.ops.jacobi as tjac
import stencil_tpu_torch.ops.stencil_kernels as tsk
import stencil_tpu_torch.plan.ir as tir
from stencil_tpu_torch.apps import campaign as tapp
from stencil_tpu_torch.campaign.driver import pick_slot
from stencil_tpu_torch.convert import state_from_jax, state_to_numpy
from stencil_tpu_torch.obs import FAULT_RC

torch.set_num_threads(2)

DEV1 = jax.devices()[:1]


def specs(size, radius, aligned=False):
    return (tgrid.GridSpec(tgeo.Dim3(*size), tgeo.Dim3(1, 1, 1), tgeo.Radius.constant(radius),
                           aligned=aligned),
            jgrid.GridSpec(jgeo.Dim3(*size), jgeo.Dim3(1, 1, 1), jgeo.Radius.constant(radius),
                           aligned=aligned))


def region(spec):
    off, b = spec.compute_offset(), spec.base
    return (slice(None), slice(off.z, off.z + b.z), slice(off.y, off.y + b.y),
            slice(off.x, off.x + b.x))


def slot_inputs(spec, B, dtype, seed):
    """Random curr and nxt (halos included) and a random per-tenant sel."""
    p = spec.padded()
    rng = np.random.RandomState(seed)
    shape = (B, p.z, p.y, p.x)
    return (rng.rand(*shape).astype(dtype), rng.rand(*shape).astype(dtype),
            rng.randint(0, 3, size=shape).astype(np.int32))


# -- the batched loop -------------------------------------------------------------


@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("size", [(12, 12, 12), (33, 21, 13)])
@pytest.mark.parametrize("B", [1, 4])
def test_batched_loop_matches_jax_xla(B, size, radius, dtype, iters):
    """Both halves of the returned pair on the full padded arrays: the CPU
    branch is the JAX XLA branch (composed fill of curr, then the sweep)."""
    tspec, jspec = specs(size, radius)
    c, n, s = slot_inputs(tspec, B, dtype, seed=B + radius + iters)
    want = jjac.make_batched_jacobi_loop(jspec, iters)(jnp.asarray(c), jnp.asarray(n),
                                                       jnp.asarray(s))
    got = tjac.make_batched_jacobi_loop(tspec, iters, device="cpu")(
        *state_from_jax({"c": c, "n": n, "s": s}, tspec, "cpu").values())
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_batched_loop_matches_interpreted_pallas_batch_kernel():
    """The TPU kernel's batch= form (all axes wrap in-kernel), interpreted,
    against the port's CPU branch on the compute regions (the Pallas branch
    fills no halo)."""
    B, size = 2, (128, 8, 8)
    tspec, jspec = specs(size, 1, aligned=True)
    c, n, _ = slot_inputs(tspec, B, np.float32, seed=5)
    s = np.zeros_like(c, dtype=np.int32)
    s[region(tspec)] = jjac.sphere_sel(size)
    cj, _ = jjac.make_batched_jacobi_loop(jspec, 1, use_pallas=True, batch=B, interpret=True)(
        jnp.asarray(c), jnp.asarray(n), jnp.asarray(s))
    ct, _ = tjac.make_batched_jacobi_loop(tspec, 1, device="cpu")(
        *state_from_jax({"c": c, "n": n, "s": s}, tspec, "cpu").values())
    np.testing.assert_array_equal(ct.numpy()[region(tspec)], np.asarray(cj)[region(tspec)])


@pytest.mark.parametrize("size", [(20, 16, 12), (33, 21, 13)])
def test_tenant_sweep_sel_range_matches_interpreted_pallas_batch_kernel(size):
    """Random sel codes on sel_z_range's planes (a strict subset at these
    sizes) and none elsewhere, the sel the card's batched loop takes: the
    TPU kernel's batch= form and the port's plain tenant sweep given that
    range (what the card's kernel computes) agree on the compute regions.
    Bit-exact."""
    B = 2
    tspec, jspec = specs(size, 1, aligned=True)
    c, n, s = slot_inputs(tspec, B, np.float32, seed=11)
    lo, hi = tsk.sel_z_range(tspec)
    assert 0 < lo < hi < tspec.padded().z
    s[:, :lo] = 0
    s[:, hi:] = 0
    cj, _ = jjac.make_batched_jacobi_loop(jspec, 1, use_pallas=True, batch=B, interpret=True)(
        jnp.asarray(c), jnp.asarray(n), jnp.asarray(s))
    ct = tsk.sweep_tenants(torch.from_numpy(c), torch.zeros(c.shape), torch.from_numpy(s), tspec,
                           (lo, hi))
    np.testing.assert_array_equal(ct.numpy()[region(tspec)], np.asarray(cj)[region(tspec)])


def test_batched_loop_checks_and_carries_tenant_stacks():
    tspec, _ = specs((12, 10, 8), 1)
    with pytest.raises(ValueError, match="single-block"):
        tjac.make_batched_jacobi_loop(
            tgrid.GridSpec(tgeo.Dim3(12, 10, 8), tgeo.Dim3(2, 1, 1), tgeo.Radius.constant(1)),
            1, device="cpu")
    loop = tjac.make_batched_jacobi_loop(tspec, 2, device="cpu")
    c, n, s = (torch.from_numpy(a) for a in slot_inputs(tspec, 3, np.float32, 1))
    with pytest.raises(ValueError, match="built for cpu"):
        loop(c.to("meta"), n, s)
    out, _ = loop(c.clone(), n.clone(), s)
    back = state_to_numpy({"c": out})["c"]
    assert back.shape == (3,) + tuple(tspec.block_shape_zyx())
    with pytest.raises(ValueError, match="shape"):
        state_from_jax({"c": back[:, :-1]}, tspec, "cpu")


# -- packing -----------------------------------------------------------------------


def mixed_jobs(mod):
    return [mod.TenantJob(t, s, 4) for t, s in (
        ("a0", (12, 12, 12)), ("b0", (10, 10, 10)), ("a1", (12, 12, 12)),
        ("a2", (12, 12, 12)), ("b1", (10, 10, 10)), ("a3", (12, 12, 12)))]


@pytest.mark.parametrize("slot", [1, 2, 3, 8])
def test_plan_slots_and_pick_slot_match_jax(slot):
    from collections import deque

    assert tcamp.plan_slots(mixed_jobs(tcamp), slot) == jcamp.plan_slots(mixed_jobs(jcamp), slot)
    tb, tp, tq = pick_slot(deque(mixed_jobs(tcamp)), slot)
    jb, jp, jq = jcamp.driver.pick_slot(deque(mixed_jobs(jcamp)), slot)
    assert (tb, [j.tid for j in tp], [j.tid for j in tq]) == (jb, [j.tid for j in jp],
                                                               [j.tid for j in jq])


# -- the driver and the sequential baseline -----------------------------------------


def jobs_for(mod, n, dtype="float32", size=12, steps=4, seed0=10):
    return [mod.TenantJob(f"t{i}", (size, size, size), steps, dtype, seed=seed0 + i)
            for i in range(n)]


def finals(summary):
    return {t: r.final for t, r in summary["results"].items() if r.outcome == "done"}


def test_tenant_init_matches_jax():
    for tj, jj in zip(jobs_for(tcamp, 2, "float64"), jobs_for(jcamp, 2, "float64")):
        assert tcamp.tenant_init_field(tj).tobytes() == jcamp.tenant_init_field(jj).tobytes()
        ta, ja = tcamp.astaroth_init_state(tj), jcamp.astaroth_init_state(jj)
        assert list(ta) == list(ja)
        assert all(ta[k].tobytes() == ja[k].tobytes() for k in ta)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("slot", [1, 4])
def test_driver_and_sequential_match_jax(tmp_path, dtype, slot):
    """3 jobs (B=4 has a dead lane); the program keys equal the JAX
    package's too."""
    tcache, jcache = tcamp.CompileCache(), jcamp.CompileCache()
    tb = tcamp.CampaignDriver(jobs_for(tcamp, 3, dtype), slot, str(tmp_path / "t"), chunk=2,
                              device="cpu", cache=tcache).run()
    ts = tcamp.run_sequential(jobs_for(tcamp, 3, dtype), device="cpu", chunk=2, cache=tcache)
    jb = jcamp.CampaignDriver(jobs_for(jcamp, 3, dtype), slot, str(tmp_path / "j"), chunk=2,
                              devices=DEV1, cache=jcache).run()
    js = jcamp.run_sequential(jobs_for(jcamp, 3, dtype), devices=DEV1, chunk=2, cache=jcache)
    assert tb["evicted"] == jb["evicted"] == []
    want = finals(jb)
    assert set(want) == {"t0", "t1", "t2"}
    for got in (finals(tb), finals(ts), finals(js)):
        assert set(got) == set(want)
        for tid in want:
            assert got[tid].dtype == np.dtype(dtype)
            assert got[tid].tobytes() == want[tid].tobytes(), tid
    assert tb["cell_steps"] == ts["cell_steps"] == 3 * 4 * 12 ** 3
    assert tb["slots"] == jb["slots"] and tb["cache"] == jb["cache"]
    assert tcache.built_keys == jcache.built_keys
    assert tb["p99_step_s"] >= tb["p50_step_s"] > 0


def read_records(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def slot_sequence(path):
    return [(r["name"], r.get("tenant") or ",".join(r.get("tenants", [])))
            for r in read_records(path)
            if r["name"] in ("campaign.slot", "campaign.backfill", "campaign.retire")]


def test_backfill_order_matches_jax(tmp_path):
    """6 jobs through B=2 slots: the slot/backfill/retire record sequence is
    the JAX package's."""
    seqs = []
    for name, mod, tel, kw in (("t", tcamp, ttel, {"device": "cpu"}),
                               ("j", jcamp, jtel, {"devices": DEV1})):
        m = tmp_path / f"{name}.jsonl"
        tel.configure(metrics_out=str(m), app="t")
        try:
            mod.CampaignDriver(jobs_for(mod, 6), 2, str(tmp_path / name), chunk=2, **kw).run()
        finally:
            tel.get().close()
        seqs.append(slot_sequence(m))
    assert seqs[0] == seqs[1]
    assert [t for (n, t) in seqs[0] if n == "campaign.backfill"] == ["t2", "t3", "t4", "t5"]


def run_eviction(mod, tel, tmp_path, name, kw):
    """The clean campaign, the injected one (with its metrics file), and
    the revival of t1 from the injected campaign's snapshots."""
    jobs = jobs_for(mod, 5, steps=6)
    common = dict(chunk=2, ckpt_every=2, max_rollbacks=1, **kw)
    clean = mod.CampaignDriver(jobs, 4, str(tmp_path / f"{name}-clean"), **common).run()
    m = tmp_path / f"{name}.jsonl"
    tel.configure(metrics_out=str(m), app="t")
    try:
        inj = mod.CampaignDriver(jobs, 4, str(tmp_path / f"{name}-inj"), rollback_backoff=0.01,
                                 inject="nan@3:tenant=t1:repeat=always", **common).run()
    finally:
        tel.get().close()
    rev = mod.CampaignDriver([jobs[1]], 2, str(tmp_path / f"{name}-inj"), chunk=2, resume=True,
                             **kw).run()
    return clean, inj, rev, read_records(m)


def test_injected_eviction_matches_jax(tmp_path):
    tclean, tinj, trev, trecs = run_eviction(tcamp, ttel, tmp_path, "t", {"device": "cpu"})
    jclean, jinj, jrev, jrecs = run_eviction(jcamp, jtel, tmp_path, "j", {"devices": DEV1})
    assert tclean["evicted"] == [] and tinj["evicted"] == jinj["evicted"] == ["t1"]
    r1 = tinj["results"]["t1"]
    assert r1.outcome == "fault" and r1.steps == jinj["results"]["t1"].steps
    ev = json.load(open(r1.evidence))
    assert ev["rc"] == FAULT_RC == 43 and "max rollbacks" in ev["reason"]
    assert ev["injections"] == json.load(open(jinj["results"]["t1"].evidence))["injections"]
    # survivors byte-equal to the clean run and to the JAX package's
    cf, jf = finals(tclean), finals(jclean)
    assert set(finals(tinj)) == {"t0", "t2", "t3", "t4"}
    for tid, f in finals(tinj).items():
        assert f.tobytes() == cf[tid].tobytes() == jf[tid].tobytes() == \
            finals(jinj)[tid].tobytes(), tid
    # the revival finishes t1 byte-equal to the clean runs
    rr = trev["results"]["t1"]
    assert rr.outcome == "done" and rr.steps == 6
    assert rr.final.tobytes() == cf["t1"].tobytes() == jrev["results"]["t1"].final.tobytes()
    names = {r["name"] for r in trecs}
    assert {"fault.injected", "health.fault", "recover.rollback", "campaign.evict",
            "campaign.backfill"} <= names
    assert all(not ttel.validate_record(r) and not jtel.validate_record(r) for r in trecs)
    evict = [r for r in trecs if r["name"] == "campaign.evict"]
    assert evict[0]["tenant"] == "t1" and evict[0]["rc"] == FAULT_RC
    # the same records, in the same order, as the JAX package's
    keep = ("fault.injected", "health.fault", "recover.fault", "recover.rollback",
            "recover.aborted", "campaign.evict", "campaign.backfill", "campaign.retire")

    def story(recs):
        return [(r["name"], r.get("tenant"), r.get("step"), r.get("lane"), r.get("origin"))
                for r in recs if r["name"] in keep]

    assert story(trecs) == story(jrecs)


def test_second_same_shape_campaign_is_a_pure_cache_hit(tmp_path):
    cache = tcamp.CompileCache()
    m = tmp_path / "m.jsonl"
    ttel.configure(metrics_out=str(m), app="t")
    try:
        tcamp.CampaignDriver(jobs_for(tcamp, 2, seed0=0), 2, str(tmp_path / "c1"), chunk=2,
                             cache=cache, device="cpu").run()
        misses, n_first = cache.misses, len(read_records(m))
        tcamp.CampaignDriver(jobs_for(tcamp, 2, seed0=9), 2, str(tmp_path / "c2"), chunk=2,
                             cache=cache, device="cpu").run()
    finally:
        ttel.get().close()
    recs = read_records(m)
    assert cache.misses == misses and cache.hits >= 1
    assert [r for r in recs[n_first:] if r["name"] == "compile.build"] == []
    second = [r["value"] for r in recs[n_first:] if r["name"] == "compile.cache_hit"]
    assert second and all(v == 1 for v in second)
    assert all(not ttel.validate_record(r) and not jtel.validate_record(r) for r in recs)


@pytest.mark.parametrize("size,radius,dtypes,platform", [
    ((12, 12, 12), 1, ["float32"], "cpu"),
    ((128, 128, 128), 1, ["float32"], "cuda"),
    ((33, 21, 13), 2, ["float64", "float32", "float64"], "cpu"),
])
def test_cache_key_matches_jax(size, radius, dtypes, platform):
    extras = dict(workload="jacobi-batched", batch=64, iters=3, pallas=True, devices=[0])
    t = tir.PlanConfig.make(tgeo.Dim3(*size), tgeo.Radius.constant(radius), dtypes, 1, platform)
    j = jir.PlanConfig.make(jgeo.Dim3(*size), jgeo.Radius.constant(radius), dtypes, 1, platform)
    assert t.key() == j.key() and t.to_json() == j.to_json()
    assert tcamp.cache_key(t, **extras) == jcamp.cache_key(j, **extras)


def test_unported_workloads_raise(tmp_path):
    """The batched driver takes astaroth tenants (their parity is
    tests/test_torch_campaign_astaroth.py); the sequential baseline refuses
    them, as the JAX package's does, and every driver an unknown workload."""
    job = tcamp.TenantJob("a", (8, 8, 8), 2, workload="astaroth")
    assert tcamp.CampaignDriver([job], 1, str(tmp_path), device="cpu").jobs == [job]
    with pytest.raises(NotImplementedError, match="jacobi tenants only"):
        tcamp.run_sequential([job], device="cpu")
    with pytest.raises(ValueError, match="unknown workload"):
        tcamp.CampaignDriver([tcamp.TenantJob("a", (8, 8, 8), 2, workload="x")], 1,
                             str(tmp_path), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_app_ab_builds_first_and_matches_jax(tmp_path, monkeypatch, dtype):
    """The CLI's A/B with --check-parity (float64 too): the kernel build
    runs once, before the first timed chunk of either mode, and its seconds
    are their own field; every tenant's final field, batched and
    sequential, equals the JAX package's driver on the same jobs."""
    from stencil_tpu_torch.campaign import driver as tdrv

    events = []
    monkeypatch.setattr(tapp, "build_kernels", lambda device: events.append("build") or 0.25)
    real_sync = tdrv.hard_sync
    monkeypatch.setattr(tdrv, "hard_sync", lambda dev: events.append("chunk") or real_sync(dev))
    args = tapp.parse_args(["--tenants", "3", "--slot", "2", "--size", "12", "--steps", "4",
                            "--chunk", "2", "--mode", "ab", "--check-parity", "--dtype", dtype,
                            "--init-seed", "10", "--device", "cpu"])
    out = tapp.run_modes(args, str(tmp_path / "t"))
    assert events[0] == "build" and events.count("build") == 1 and "chunk" in events
    assert out["build_s"] == 0.25 and out["parity"] == "ok" and out["dtype"] == dtype
    jb = jcamp.CampaignDriver(jobs_for(jcamp, 3, dtype), 2, str(tmp_path / "j"), chunk=2,
                              devices=DEV1).run()
    want = finals(jb)
    for got in (finals(out["_batched"]), finals(out["_sequential"])):
        assert set(got) == set(want) == {"t0", "t1", "t2"}
        for tid in want:
            assert got[tid].dtype == np.dtype(dtype)
            assert got[tid].tobytes() == want[tid].tobytes(), tid
    # on the CPU the real hook builds nothing
    monkeypatch.undo()
    assert tapp.build_kernels("cpu") == 0.0


def test_app_ab_and_fault_run(tmp_path, capsys):
    """The CLI end to end: the A/B with --check-parity, the fault run that
    evicts t1, and --resume on the same campaign dir."""
    base = ["--tenants", "4", "--slot", "2", "--size", "10", "--steps", "6", "--device", "cpu"]
    assert tapp.main(base + ["--chunk", "3", "--mode", "ab", "--check-parity",
                             "--campaign-dir", str(tmp_path / "ab")]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["parity"] == "ok" and out["evicted"] == [] and out["slots"] == 1
    assert out["batched_mcells_per_s"] > 0 and out["sequential_mcells_per_s"] > 0
    fault = base + ["--chunk", "2", "--campaign-dir", str(tmp_path / "f")]
    assert tapp.main(fault + ["--ckpt-every", "2", "--max-rollbacks", "1",
                              "--inject", "nan@3:tenant=t1:repeat=always"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["evicted"] == ["t1"]
    assert os.path.isfile(tmp_path / "f" / "tenants" / "t1" / "fault-evidence.json")
    assert tapp.main(fault + ["--resume"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["evicted"] == [] and out["cache"]["misses"] == 1
