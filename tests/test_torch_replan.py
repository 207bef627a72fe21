"""The port's mid-run plan hot-swap (stencil_tpu_torch/plan/replan.py,
DistributedDomain.replan, fault.run_guarded's ``replan``, jacobi3d
``--replan``) against the JAX package's (tests/test_replan.py): the
controller's cases (a throwing re-tune rejected and the run finishing on the
old plan, an applied swap transforming the state and resetting the
sentinel, a re-tune confirming the current choice, the swap budget) give the
same records as the JAX controller; the engine runs on a stand-in clock (no
wall clock); a domain's replan keeps the state bit for bit, and a choice that
cannot realize puts the old plan back; jacobi3d over ``["cpu"] * 8`` swapped
mid-run (a stand-in sentinel requests it at step 6) is bit-identical to the
unswapped run and to the JAX app's run on its 8 virtual devices. Inputs
from numpy seeds; the JAX reference compiles once per module. Tolerance:
exact equality."""

import io
import json

import jax
import numpy as np
import pytest
import torch

import stencil_tpu.apps.jacobi3d as japp
import stencil_tpu.obs.telemetry as jtel
import stencil_tpu.parallel as jpar
import stencil_tpu.plan.ir as jir
import stencil_tpu.plan.replan as jrep
import stencil_tpu_torch.apps.jacobi3d as tapp
import stencil_tpu_torch.obs.telemetry as ttel
import stencil_tpu_torch.plan.ir as tir
import stencil_tpu_torch.plan.replan as trep
from stencil_tpu.geometry import Radius as JRadius
from stencil_tpu_torch import DistributedDomain
from stencil_tpu_torch.fault import chunk_plan, run_guarded
from stencil_tpu_torch.geometry import Radius
from stencil_tpu_torch.obs.live import LiveSentinel
from stencil_tpu_torch.parallel import Method
from stencil_tpu_torch.plan.ir import PlanChoice
from stencil_tpu_torch.plan.replan import ReplanController

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8
TRIP = {"*": {"min_history": 2, "window": 8, "rel_tol": 0.5, "clear_after": 1}}


def records(buf, name=None):
    out = [json.loads(line) for line in buf.getvalue().splitlines() if line.strip()]
    return [r for r in out if name is None or r["name"] == name]


def strip(recs):
    return [{k: v for k, v in r.items() if k not in ("run", "t", "swap_wall_s")} for r in recs]


class Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def guarded(sentinel, controller, iters=10, chunk=2, trip_at=6):
    """The engine on a stand-in clock: every chunk takes 10 ms, the one
    ending at ``trip_at`` 250 ms."""
    clock = Clock()

    def step_fn(st, k):
        done = st["i"] + k
        clock.now += 0.25 if done == trip_at else 0.01
        return dict(st, i=done)

    return run_guarded({"i": 0}, start=0, iters=iters,
                       plan_fn=lambda s: chunk_plan(s, iters, chunk), step_fn=step_fn,
                       sentinel=sentinel, replan=controller, clock=clock)


def recorder():
    buf = io.StringIO()
    return ttel.Recorder(sink=buf, app="test"), buf


def test_throwing_retune_rejected_and_run_continues():
    rec, buf = recorder()
    sent = LiveSentinel(TRIP, rec=rec)

    def retune():
        raise RuntimeError("tuner exploded")

    ctrl = ReplanController(retune, lambda c, st: st, sentinel=sent, rec=rec,
                            current_choice=PlanChoice((2, 2, 2), "direct26"))
    sent.on_replan = ctrl.request
    state, done = guarded(sent, ctrl)
    assert done == 10 and state["i"] == 10
    rej = records(buf, "replan.rejected")
    assert len(rej) == 1 and "tuner exploded" in rej[0]["reason"] and rej[0]["step"] == 6
    assert not records(buf, "replan.applied") and (ctrl.rejected, ctrl.swaps) == (1, 0)
    assert not [e for r in records(buf) for e in ttel.validate_record(r)]


def test_applied_swap_transforms_state_and_resets_sentinel():
    rec, buf = recorder()
    sent = LiveSentinel(TRIP, rec=rec)
    new = PlanChoice((8, 1, 1), "remote-dma")
    ctrl = ReplanController(lambda: new, lambda c, st: dict(st, swapped=True), sentinel=sent,
                            rec=rec, current_choice=PlanChoice((2, 2, 2), "remote-dma"))
    sent.on_replan = ctrl.request
    state, done = guarded(sent, ctrl)
    assert done == 10 and state.get("swapped") is True
    app = records(buf, "replan.applied")
    assert len(app) == 1 and (app[0]["old"], app[0]["new"]) == \
        ("2x2x2/remote-dma/batched", "8x1x1/remote-dma/batched")
    assert app[0]["step"] - records(buf, "replan.requested")[0]["step"] <= 4
    assert ctrl.current_choice == new and sent.detected_total == 1
    assert all(len(w.samples) <= 2 for w in sent.windows.values())
    assert not [e for r in records(buf) for e in jtel.validate_record(r)]


def test_retune_confirming_current_choice_is_a_rejected_noop():
    rec, buf = recorder()
    sent = LiveSentinel(TRIP, rec=rec)
    current = PlanChoice((2, 2, 2), "axis-composed")
    applied = []
    ctrl = ReplanController(lambda: current, lambda c, st: applied.append(c) or st,
                            sentinel=sent, rec=rec, current_choice=current)
    sent.on_replan = ctrl.request
    _state, done = guarded(sent, ctrl)
    assert done == 10 and not applied and ctrl.swaps == 0
    assert "confirmed" in records(buf, "replan.rejected")[0]["reason"]


@pytest.mark.parametrize("case", ["applied", "confirmed", "budget", "throwing", "none"])
def test_controller_records_match_jax(case):
    """The same request and re-tune through both controllers give the same
    records, counters and returned state."""
    outs = []
    for tel, rep, ir, radius in ((ttel, trep, tir, Radius), (jtel, jrep, jir, JRadius)):
        buf = io.StringIO()
        rec = tel.Recorder(sink=buf, app="test")
        cur = ir.PlanChoice((2, 2, 2), "remote-dma")
        new = {"applied": ir.PlanChoice((1, 2, 4), "remote-dma", kernel_variant="fused"),
               "confirmed": cur, "budget": ir.PlanChoice((8, 1, 1), "remote-dma"),
               "none": None}.get(case)

        def retune(new=new):
            if case == "throwing":
                raise ValueError("no plan")
            return new

        cfg = ir.PlanConfig.make((16, 16, 16), radius.constant(1), ["float32"], 8, "cpu")
        ctrl = rep.ReplanController(retune, lambda c, st: {"i": st["i"] + 100},
                                    current_choice=cur, config=cfg, rec=rec,
                                    max_swaps=0 if case == "budget" else 3)
        assert ctrl.maybe_swap({"i": 1}, 4) is None  # nothing latched
        ctrl.request({"metric": "step.latency_s", "step": 4})
        got = ctrl.maybe_swap({"i": 1}, 4)
        outs.append((got, ctrl.swaps, ctrl.rejected, ctrl.pending,
                     ctrl.current_choice.label(), strip(records(buf))))
    assert outs[0] == outs[1]


# -- DistributedDomain.replan -------------------------------------------------------


def state_of(dd, h):
    return dd.get_curr_global(h)


@pytest.mark.parametrize("old,new,devices", [
    (PlanChoice((2, 2, 2), "remote-dma"), PlanChoice((1, 2, 4), "remote-dma",
                                                     kernel_variant="fused"), CPU8),
    (PlanChoice((1, 1, 1), "axis-composed"), PlanChoice((2, 2, 1), "direct26",
                                                        batch_quantities=False), ["cpu"]),
])
def test_domain_replan_keeps_the_state_bit_for_bit(old, new, devices):
    dd = DistributedDomain(16, 12, 20, device="cpu", plan=old)
    dd.set_devices(devices)
    dd.set_radius(2)
    hs = [dd.add_data(n, dt) for n, dt in (("a", "float32"), ("b", "float64"))]
    dd.realize()
    rng = np.random.RandomState(7)
    fields = [rng.rand(20, 12, 16).astype(dt) for dt in (np.float32, np.float64)]
    for h, f in zip(hs, fields):
        dd.set_curr_global(h, f)
    dd.exchange()
    dd.replan(new.to_json())
    assert dd.plan_choice == new and tuple(dd.spec.dim) == tuple(new.partition)
    assert dd.halo_exchange.fused == new.is_fused and dd._method == Method(new.method)
    for h, f in zip(hs, fields):
        np.testing.assert_array_equal(state_of(dd, h), f)
    # the halos were rebuilt by the exchange: another one changes nothing
    before = {i: (t.clone() if isinstance(t, torch.Tensor) else [b.clone() for b in t])
              for i, t in dd.curr_state().items()}
    dd.exchange()
    for i, t in dd.curr_state().items():
        pairs = [(t, before[i])] if isinstance(t, torch.Tensor) else zip(t, before[i])
        assert all(torch.equal(a, b) for a, b in pairs)


def test_domain_replan_failure_restores_the_old_plan():
    dd = DistributedDomain(16, 16, 16, device="cpu", plan=PlanChoice((2, 2, 2), "remote-dma"))
    dd.set_devices(CPU8)
    dd.set_radius(1)
    h = dd.add_data("t", "float32")
    dd.realize()
    f = np.random.RandomState(3).rand(16, 16, 16).astype(np.float32)
    dd.set_curr_global(h, f)
    with pytest.raises(ValueError, match="multiple of 8"):
        dd.replan(PlanChoice((3, 1, 1), "remote-dma"))
    assert dd.plan_choice == PlanChoice((2, 2, 2), "remote-dma")
    assert tuple(dd.spec.dim) == (2, 2, 2) and not dd.halo_exchange.fused
    np.testing.assert_array_equal(dd.get_curr_global(h), f)
    with pytest.raises(RuntimeError, match="realized"):
        DistributedDomain(8, 8, 8, device="cpu").replan(PlanChoice((1, 1, 1), "direct26"))


# -- jacobi3d --replan over 8 CPU positions -----------------------------------------


class TripAt:
    """A stand-in sentinel: requests a replan when it sees ``step``, with no
    clock involved (what a LiveSentinel would do on a slow chunk)."""

    def __init__(self, step):
        self.step, self.on_replan, self.resets, self.detected_total = step, None, 0, 0

    def observe(self, key, value, *, step, unit=None):
        if step == self.step and self.on_replan is not None:
            self.detected_total += 1
            self.on_replan({"metric": key, "step": step, "value": value})

    def summary(self):
        return {"active": [], "detected": self.detected_total, "cleared": 0}

    def reset(self):
        self.resets += 1


def run_port(sentinel=None, replan=False, **kw):
    return tapp.run(24, 24, 24, iters=10, method=Method.REMOTE_DMA, devices=CPU8, weak=False,
                    chunk=2, sentinel=sentinel, replan=replan, **kw)


@pytest.fixture(scope="module")
def jax_field():
    r = japp.run(24, 24, 24, iters=10, method=jpar.Method.REMOTE_DMA,
                 devices=jax.devices()[:8], weak=False, chunk=2)
    return r["domain"].get_curr_global(r["handle"])


def test_jacobi_hot_swap_bit_identical_to_unswapped_and_jax(jax_field, tmp_path):
    rec, buf = recorder()
    prev = ttel._recorder
    ttel._recorder = rec
    try:
        trip = TripAt(6)
        r1 = run_port(sentinel=trip, replan=True, plan_db=str(tmp_path / "plans.json"))
    finally:
        ttel._recorder = prev
    req_step = 6
    app = records(buf, "replan.applied")
    assert len(app) == 1 and app[0]["step"] == req_step and app[0]["old"] != app[0]["new"]
    assert trip.resets == 1
    assert r1["domain"].plan_choice.label() == app[0]["new"]
    f1 = r1["domain"].get_curr_global(r1["handle"])
    r2 = run_port()
    f2 = r2["domain"].get_curr_global(r2["handle"])
    assert r2["domain"].plan_choice is None and r2["domain"].spec.dim != r1["domain"].spec.dim
    assert f1.tobytes() == f2.tobytes() == np.asarray(jax_field, dtype=np.float32).tobytes()


def test_jacobi_replan_without_sentinel_warns_and_runs(capfd):
    r = run_port(replan=True)
    assert r["method"] == Method.REMOTE_DMA.value and r["domain"].plan_choice is None
    assert "--replan needs --live-sentinel" in capfd.readouterr().err


def test_jacobi_cli_replan_and_status(tmp_path):
    """The CLI's live flags: a sentinel that never trips at this size keeps
    the plan; the status file ends with outcome done."""
    status = tmp_path / "status.json"
    assert tapp.main(["--x", "16", "--y", "16", "--z", "16", "--iters", "6", "--no-weak",
                      "--devices", ",".join(CPU8), "--method", "remote-dma", "--replan",
                      "--live-sentinel", "--live-config", '{"*": {"rel_tol": 1000.0}}',
                      "--status-file", str(status)]) == 0
    doc = json.loads(status.read_text())
    assert doc["outcome"] == "done" and doc["step"] == 6 and doc["anomalies"]["detected"] == 0


# -- the campaign and the serving daemon: the swap between slots ----------------------


def test_campaign_swaps_between_slots(tmp_path):
    from stencil_tpu_torch.campaign import CampaignDriver, TenantJob

    rec, buf = recorder()
    prev = ttel._recorder
    ttel._recorder = rec
    try:
        new = PlanChoice((1, 1, 1), "remote-dma", kernel_variant="fused")
        ctrl = ReplanController(lambda: new, lambda c, st: None, rec=rec)
        # latched during slot 0, consumed at the first slot boundary; two
        # shape buckets, so that there is a boundary
        ctrl.request({"metric": "step.latency_s[16x16x16,float32,jacobi]", "step": 2})
        jobs = [TenantJob("t0", (16, 16, 16), 4), TenantJob("t1", (8, 8, 8), 4)]
        summary = CampaignDriver(jobs, 1, str(tmp_path / "camp"), device="cpu", chunk=2,
                                 replan=ctrl).run()
    finally:
        ttel._recorder = prev
    assert summary["tenants"] == 2 and summary["slots"] == 2
    assert all(r.outcome == "done" for r in summary["results"].values())
    app = records(buf, "replan.applied")
    assert len(app) == 1 and app[0]["new"] == new.label() and app[0]["step"] == 1
    assert ctrl.swaps == 1


def test_campaign_cli_live_flags_and_replan(tmp_path):
    from stencil_tpu_torch.apps import campaign as tcamp

    st, db = tmp_path / "st.json", tmp_path / "plans.json"
    argv = ["--tenants", "3", "--slot", "2", "--size", "8", "--steps", "4", "--chunk", "2",
            "--device", "cpu", "--live-sentinel", "--status-file", str(st), "--replan",
            "--plan-db", str(db), "--deadline-ms", "t0=1000"]
    assert tcamp.main(argv) == 0
    doc = json.loads(st.read_text())
    assert doc["outcome"] == "done" and doc["slo"] == {"violations": []}
    assert {ln["lane"] for ln in doc["lanes"]} == {0, 1}
    for bad in (["--mode", "sequential", "--live-sentinel"], ["--replan", "--live-sentinel"]):
        with pytest.raises(SystemExit):
            tcamp.parse_args(["--device", "cpu"] + bad)


def test_serve_slo_pressure_swaps_between_slots(tmp_path):
    """The serving daemon with the live flags, in process: SLO pressure on
    a job's deadline latches the controller, the next slot boundary re-tunes
    the bucket into the plan DB (replan.applied), the status file carries
    the queue section, and every result equals the JAX daemon's."""
    from stencil_tpu_torch.apps import serve as tserve_app
    from tests.test_torch_serve import drop, job_doc, serve

    docs = [job_doc("pressed", deadline_ms=0.001, steps=8), job_doc("other", size=8, steps=4)]
    for d in docs:
        drop(str(tmp_path / "t"), d)
        drop(str(tmp_path / "j"), d)
    db, st = tmp_path / "plans.json", tmp_path / "status.json"
    out_j, _ = serve("j", tmp_path / "j", tmp_path / "j.jsonl", slot=1)
    argv = ["--serve-dir", str(tmp_path / "t"), "--slot", "1", "--device", "cpu",
            "--max-idle-s", "0.3", "--poll-s", "0.02", "--chunk", "2", "--replan",
            "--plan-db", str(db), "--status-file", str(st), "--live-sentinel",
            "--metrics-out", str(tmp_path / "t.jsonl")]
    try:
        assert tserve_app.main(argv) == 0
    finally:
        ttel.configure(None)
    recs = [json.loads(ln) for ln in open(tmp_path / "t.jsonl")]
    assert [r["reason"] for r in recs if r["name"] == "replan.requested"] == ["slo-pressure"]
    app = [r for r in recs if r["name"] == "replan.applied"]
    assert len(app) == 1 and app[0]["old"] == "untuned"
    from stencil_tpu_torch.plan import db as plandb

    assert len(plandb.load_db(str(db))["entries"]) == 1
    doc = json.loads(st.read_text())
    assert doc["queue"]["retired"] == 2 and doc["outcome"] == "idle"
    res_t = {d["job"]: json.load(open(tmp_path / "t" / "results" / f"{d['job']}.json"))
             for d in docs}
    res_j = {d["job"]: json.load(open(tmp_path / "j" / "results" / f"{d['job']}.json"))
             for d in docs}
    for jid in res_t:
        assert res_t[jid]["outcome"] == res_j[jid]["outcome"] == "done"
    assert out_j["retired"] == 2
