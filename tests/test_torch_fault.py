"""The port's fault layer (stencil_tpu_torch/fault/) against the JAX
package's: chunk plans, the injection grammar and its describe() records,
the health guards (one domain and per lane), seeded injection placement,
and the guarded loop's rollback and exhaustion scenarios of
tests/test_fault_recover.py with torch state. Bit-exact / equal
throughout."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stencil_tpu.campaign as jcamp
import stencil_tpu.domain.grid as jgrid
import stencil_tpu.fault as jfault
import stencil_tpu.geometry as jgeo
import stencil_tpu_torch.campaign as tcamp
import stencil_tpu_torch.domain.grid as tgrid
import stencil_tpu_torch.fault as tfault
import stencil_tpu_torch.geometry as tgeo
from stencil_tpu_torch.fault import (FAULT_RC, FaultPlan, HealthGuard, NumericalFault,
                                     RecoveryPolicy, chunk_plan, parse_spec, run_guarded)

CASES = [(s, i, c, e, a) for s in (0, 3) for i in (0, 7, 10) for c in (1, 3, 4, 10)
         for e in ((), (2,), (0, 3), (2, 4)) for a in ((), (5,), (3, 9))]


def test_chunk_plan_matches_jax():
    for start, iters, chunk, every, at in CASES:
        assert chunk_plan(start, iters, chunk, every, at) == \
            jfault.chunk_plan(start, iters, chunk, every, at), (start, iters, chunk, every, at)


SPECS = ["nan@3", "nan@3:q=uux:cells=4, crash@5:rc=9; slow@2:seconds=0.5", "nan@1:repeat=3",
         "nan@1:repeat=always", "nan@3,crash@7,nan@3:repeat=2", "nan@3:repeat=always",
         "inf@1:q=b", "nan@1:cells=3", "halo@1", "nan@1:cells=5", "slow@1:seconds=0.01",
         "nan@4", "nan@3:tenant=t2:repeat=always", "ckpt-truncate@2,stall@9"]
BAD = ["nan", "nan@x", "bogus@3", "nan@3:wat=1", "nan@0", "nan@3:cells"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_describe_matches_jax(spec):
    t, j = FaultPlan.from_spec(spec, seed=7), jfault.FaultPlan.from_spec(spec, seed=7)
    assert t.describe() == j.describe() and t.steps() == j.steps() and t.seed == j.seed


def test_parse_errors_match_jax():
    for bad in BAD:
        with pytest.raises(ValueError) as te:
            parse_spec(bad)
        with pytest.raises(ValueError) as je:
            jfault.parse_spec(bad)
        assert str(te.value) == str(je.value)
    # with no spec and no STENCIL_FAULT_INJECT nothing is scheduled
    assert FaultPlan.from_spec(None) is None and FaultPlan.from_spec(" , ") is None
    plan = FaultPlan.from_spec("nan@4")
    assert plan.steps() == [4] and plan.seed == 0


def test_process_kinds_are_not_fired():
    """A process kind is not fired before its step; at its step crash exits
    the process with its rc (a child here), as the JAX package's does."""
    plan = FaultPlan(parse_spec("crash@2:rc=9,stall@3"))
    state = {"q": torch.zeros(4)}
    assert plan.fire_due(state, 0, 1) is state
    assert [i.fired for i in plan.injections] == [0, 0]
    code = ("import torch; from stencil_tpu_torch.fault import FaultPlan, parse_spec; "
            "FaultPlan(parse_spec('crash@2:rc=9')).fire_due({'q': torch.zeros(4)}, 1, 2); "
            "raise SystemExit(0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rc = subprocess.run([sys.executable, "-c", code], cwd=root, timeout=120,
                        capture_output=True).returncode
    assert rc == 9


# -- health guards and seeded placement ---------------------------------------------


def poisoned(seed, dtype):
    rng = np.random.RandomState(seed)
    a = rng.rand(4, 5, 6, 7).astype(dtype)
    b = rng.rand(4, 5, 6, 7).astype(dtype)
    a[2, 1, 1, 1] = np.nan
    b[1, 0, 0, 0] = 50.0
    b[3, 0, 0, 0] = np.inf
    return {"b": b, "a": a, "n": np.zeros((4, 3), np.int32)}


def caught(guard, state, step):
    try:
        guard.check(state, step)
    except (NumericalFault, jfault.NumericalFault) as f:
        return (type(f).__name__, f.kind, f.quantity, f.step, f.value,
                getattr(f, "lane", None), getattr(f, "tenant", None),
                getattr(f, "tenant_step", None))
    return None


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("max_abs", [None, 10.0, 1e6])
def test_health_guards_match_jax(dtype, max_abs):
    state = poisoned(1, dtype)
    t = {k: torch.from_numpy(v) for k, v in state.items()}
    j = {k: jnp.asarray(v) for k, v in state.items()}
    assert caught(HealthGuard(max_abs=max_abs), t, 4) == \
        caught(jfault.HealthGuard(max_abs=max_abs), j, 4)
    clean = {k: v[:1] for k, v in state.items()}
    assert caught(HealthGuard(max_abs=max_abs), {k: torch.from_numpy(v) for k, v in clean.items()},
                  4) is None
    # per lane: dead lanes are skipped, the lowest live faulty lane wins
    for live in ((0, 1, 2, 3), (0, 2, 3), (0, 3)):
        guards = []
        for guard in (tcamp.SlotHealthGuard(max_abs=max_abs),
                      jcamp.SlotHealthGuard(max_abs=max_abs)):
            guard.bind(lambda lane: f"t{lane}" if lane in live else None,
                       lambda lane, step: step - lane)
            guards.append(guard)
        assert caught(guards[0], t, 5) == caught(guards[1], j, 5)


def test_injection_placement_matches_jax():
    """FaultPlan's block burst and halo-slab corruption (in a stacked state
    and in a mesh's per-position blocks) and SlotInjector's lane burst hit
    the JAX package's cells (the port writes them in place)."""
    tspec = tgrid.GridSpec(tgeo.Dim3(12, 10, 8), tgeo.Dim3(2, 1, 1), tgeo.Radius.constant(1))
    jspec = jgrid.GridSpec(jgeo.Dim3(12, 10, 8), jgeo.Dim3(2, 1, 1), jgeo.Radius.constant(1))
    zeros = np.zeros(tspec.stacked_shape_zyx(), np.float32)
    p = tspec.padded()
    for spec_str in ("nan@2:cells=3", "inf@2:q=b", "halo@2", "halo@2:q=a:cells=3"):
        t = {"a": torch.from_numpy(zeros.copy()), "b": torch.from_numpy(zeros.copy())}
        j = {"a": jnp.asarray(zeros), "b": jnp.asarray(zeros)}
        # the same quantities as a mesh's per-position blocks (flat order)
        m = {k: [torch.zeros((1, 1, 1, p.z, p.y, p.x)) for _ in range(2)] for k in t}
        FaultPlan(parse_spec(spec_str), seed=3).fire_due(t, 1, 2, spec=tspec)
        FaultPlan(parse_spec(spec_str), seed=3).fire_due(m, 1, 2, spec=tspec)
        j = jfault.FaultPlan(jfault.parse_spec(spec_str), seed=3).fire_due(j, 1, 2, spec=jspec)
        for k in t:
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
            np.testing.assert_array_equal(
                torch.cat([b.reshape(1, p.z, p.y, p.x) for b in m[k]]).numpy(),
                np.asarray(j[k]).reshape(2, p.z, p.y, p.x))
    # a campaign slot of 3 one-block tenants, t1 in lane 2 (entered at step 1)
    tspec = tgrid.GridSpec(tgeo.Dim3(9, 7, 6), tgeo.Dim3(1, 1, 1), tgeo.Radius.constant(1),
                           aligned=False)
    jspec = jgrid.GridSpec(jgeo.Dim3(9, 7, 6), jgeo.Dim3(1, 1, 1), jgeo.Radius.constant(1),
                           aligned=False)
    p = tspec.padded()
    slot = np.zeros((3, p.z, p.y, p.x), np.float64)
    for mod, spec, state in ((tcamp, tspec, {"q": torch.from_numpy(slot.copy())}),
                             (jcamp, jspec, {"q": jnp.asarray(slot)})):
        lanes = [mod.Lane(0, mod.TenantJob("t0", (9, 7, 6), 6)), mod.Lane(1),
                 mod.Lane(2, mod.TenantJob("t1", (9, 7, 6), 6), 1, 0)]
        plan = (FaultPlan if mod is tcamp else jfault.FaultPlan)(
            (parse_spec if mod is tcamp else jfault.parse_spec)("nan@3:tenant=t1:cells=2"), seed=4)
        inj = mod.SlotInjector(plan, spec, lambda lanes=lanes: lanes)
        assert inj.steps() == [4]
        out = inj.fire_due(state, 3, 4)
        if mod is tcamp:
            got = out["q"].numpy()
        else:
            want = np.asarray(out["q"])
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[2]).sum() == 8 and not np.isnan(got[:2]).any()


# -- the guarded loop (tests/test_fault_recover.py with torch state) -----------------


def _mk(start=0.0):
    return {"q": torch.full((4,), float(start))}


def _step(st, k):
    return {"q": st["q"] + k}


class MemCkpt:
    """In-memory snapshot store; restore hands back a fresh copy."""

    def __init__(self):
        self.snaps = {}
        self.quarantined = []

    def save(self, step, st):
        self.snaps[step] = st["q"].clone()

    def restore(self):
        if not self.snaps:
            return None
        step = max(self.snaps)
        return step, {"q": self.snaps[step].clone()}

    def quarantine(self, step):
        self.quarantined.append(step)
        del self.snaps[step]


def test_plain_loop_degeneration():
    ck = MemCkpt()
    seen = []
    state, done = run_guarded(
        _mk(), start=0, iters=10, plan_fn=lambda s: chunk_plan(s, 10, 4, every=(2,)),
        step_fn=_step, save_fn=ck.save, ckpt_every=2,
        on_chunk=lambda st, k, per, done: seen.append((k, done)))
    assert done == 10 and bool((state["q"] == 10).all())
    assert seen == [(2, 2), (2, 4), (2, 6), (2, 8), (2, 10)]
    assert sorted(ck.snaps) == [2, 4, 6, 8]


@pytest.mark.parametrize("health_every", [2, 4])
def test_rollback_restores_and_recomputes_bit_identically(health_every):
    """The injection at step 5 is rolled back; every snapshot stays finite
    (the check precedes every save, even off the health cadence)."""
    clean, _ = run_guarded(_mk(), start=0, iters=8,
                           plan_fn=lambda s: chunk_plan(s, 8, 3, every=(2,)), step_fn=_step)
    ck = MemCkpt()
    plan = FaultPlan(parse_spec("nan@5"))
    state, done = run_guarded(
        _mk(), start=0, iters=8,
        plan_fn=lambda s: chunk_plan(s, 8, 3, every=(2, health_every), at=plan.steps()),
        step_fn=_step, guard=HealthGuard(every=health_every), injector=plan,
        policy=RecoveryPolicy(backoff_s=0.001), save_fn=ck.save, ckpt_every=2,
        restore_fn=ck.restore, quarantine_fn=ck.quarantine)
    assert done == 8 and torch.equal(state["q"], clean["q"])
    assert all(bool(torch.isfinite(s).all()) for s in ck.snaps.values())
    assert ck.quarantined == [] and plan.injections[0].fired == 1


def test_poisoned_restore_is_quarantined():
    ck = MemCkpt()
    ck.snaps[2] = torch.full((4,), 2.0)
    ck.snaps[4] = torch.full((4,), float("nan"))
    plan = FaultPlan(parse_spec("inf@5"))
    state, done = run_guarded(
        _mk(4.0), start=4, iters=6, plan_fn=lambda s: chunk_plan(s, 6, 2, at=plan.steps()),
        step_fn=_step, guard=HealthGuard(every=1), injector=plan,
        policy=RecoveryPolicy(backoff_s=0.001), restore_fn=ck.restore,
        quarantine_fn=ck.quarantine)
    assert ck.quarantined == [4] and done == 6 and bool((state["q"] == 6).all())


@pytest.mark.parametrize("mode", ["no-restore", "max-rollbacks"])
def test_exhaustion_raises_with_evidence(tmp_path, mode):
    """The abort bundle carries rc 43 and the JAX package's fault, rollback
    and injection records for the same scenario."""
    evidence = {}
    for name, fmod, state in (("port", tfault, _mk()), ("jax", jfault,
                                                        {"q": jnp.zeros((4,), jnp.float32)})):
        plan = fmod.FaultPlan(fmod.parse_spec("inf@2:repeat=always"))
        ck = MemCkpt() if name == "port" else None
        kw = {}
        if mode == "max-rollbacks":
            if name == "port":
                kw = dict(save_fn=ck.save, ckpt_every=1, restore_fn=ck.restore)
            else:
                snaps = {}
                kw = dict(save_fn=lambda s, st: snaps.__setitem__(s, st), ckpt_every=1,
                          restore_fn=lambda: (max(snaps), snaps[max(snaps)]) if snaps else None)
        with pytest.raises(fmod.RecoveryExhausted) as ei:
            fmod.run_guarded(
                state, start=0, iters=4,
                plan_fn=lambda s: fmod.chunk_plan(s, 4, 4, every=(1,), at=plan.steps()),
                step_fn=(lambda st, k: {"q": st["q"] + k}), guard=fmod.HealthGuard(every=1),
                injector=plan, policy=fmod.RecoveryPolicy(max_rollbacks=1, backoff_s=0.001),
                evidence_dir=str(tmp_path / name), app="unit", **kw)
        e = ei.value
        assert e.evidence_path and os.path.isfile(e.evidence_path)
        evidence[name] = (e.reason, e.rollbacks, json.load(open(e.evidence_path)))
    (treason, trb, tev), (jreason, jrb, jev) = evidence["port"], evidence["jax"]
    assert (treason, trb) == (jreason, jrb)
    assert ("cannot roll back" in treason) == (mode == "no-restore")
    assert tev["rc"] == FAULT_RC == 43 and tev["app"] == "unit"
    for key in ("reason", "policy", "rollbacks", "injections"):
        assert tev[key] == jev[key], key
    strip = [{k: v for k, v in f.items() if k != "t"} for f in tev["faults"]]
    assert strip == [{k: v for k, v in f.items() if k != "t"} for f in jev["faults"]]
