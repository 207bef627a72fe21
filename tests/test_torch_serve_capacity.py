"""The port's serving capacity engine against the JAX package's on the CPU,
scenario by scenario as ``tests/test_serve_capacity.py`` pins them: the
width ladder, weighted fairness (monotone shares, the aging bound, aged
queue order, stride re-entry), cross-bucket packing and its deadline-slack
veto, per-width pricing and its ledger writeback, and, end to end on both
daemons, the elastic grow mid-slot, a priced preemption with bit-identical
restores, a vetoed one, and a sustained high stream that does not starve a
low job; the per-priority p99 gauges the report folds; and the load
generator's seeded mix.

Each decision must equal the JAX package's on the same inputs: widths,
served shares, queue orders, packing plans with their candidate tables,
pricer rows, and the resize / preempt / veto records with their priced
figures. Served results: Jacobi bit-exact (byte-equal). The aging clock is
injected (advanced by the hooks, never read from the wall), so no decision
and no assertion depends on elapsed time."""

import json
import os
import runpy

import jax
import pytest
import torch

import stencil_tpu.obs.ledger as jled
import stencil_tpu.obs.telemetry as jtel
import stencil_tpu.serve as jserve
import stencil_tpu_torch.obs.ledger as tled
import stencil_tpu_torch.obs.telemetry as ttel
import stencil_tpu_torch.serve as tserve
from stencil_tpu_torch.apps import serve_loadgen as tlg
from stencil_tpu_torch.serve.admission import LEDGER_METRIC, bucket_label

torch.set_num_threads(2)

DEV1 = jax.devices()[:1]
N = 10
STEPS = 4
PKGS = {"t": (tserve, ttel, tled), "j": (jserve, jtel, jled)}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def job_doc(jid, *, size=N, steps=STEPS, tenant=None, priority="normal", deadline_ms=None,
            seed=None):
    doc = {"job": jid, "size": size, "steps": steps, "workload": "jacobi",
           "priority": priority, "dtype": "float32",
           "seed": seed if seed is not None else sum(map(ord, jid)) % 1000}
    if tenant:
        doc["tenant"] = tenant
    if deadline_ms is not None:
        doc["deadline_ms"] = deadline_ms
    return doc


def drop(serve_dir, doc):
    inc = os.path.join(serve_dir, "jobs", "incoming")
    os.makedirs(inc, exist_ok=True)
    name = f"{doc['job']}.json"
    tmp = os.path.join(inc, f".tmp-{name}")
    with open(tmp, "w") as f:
        f.write(json.dumps(doc))
    os.replace(tmp, os.path.join(inc, name))


def mk_job(mod, tid, *, size=N, steps=STEPS, pri="normal", dl=None, seq=0, admit_t=None):
    return mod.ServeJob(tid, (size, size, size), steps, "float32", seed=0, deadline_ms=dl,
                        owner=tid, priority=pri, seq=seq, admit_t=admit_t)


def seeded_ledger(led, path, prices):
    entries = []
    for key, ms in prices.items():
        label, width = key if isinstance(key, tuple) else (key, None)
        det, cfg = {"bucket": label, "samples": 8}, {"bucket": label}
        if width is not None:
            det["width"] = cfg["width"] = width
        entries.append(led.make_entry(LEDGER_METRIC, ms, label="seed", unit="ms",
                                      platform="cpu", source="serve", config=cfg, detail=det))
    led.append_entries(path, entries)


def plan_view(plan):
    return (plan.bucket, plan.width, [j.tid for j in plan.picked], plan.reason, plan.lead,
            plan.candidates)


# -- WidthPolicy (pure) ------------------------------------------------------------


def test_width_ladder_and_choose_match_jax():
    for lo, hi in ((2, 12), (4, 4), (1, 64), (3, 5)):
        t, j = tserve.WidthPolicy(lo, hi), jserve.WidthPolicy(lo, hi)
        assert (t.widths, t.fixed) == (j.widths, j.fixed)
        assert [t.choose(d) for d in range(0, 70)] == [j.choose(d) for d in range(0, 70)]
    assert tserve.WidthPolicy(2, 12).widths == (2, 4, 8, 12)
    for bad in ((0, 4), (8, 4)):
        with pytest.raises(ValueError):
            tserve.WidthPolicy(*bad)


# -- FairnessPolicy (pure, fake clock) ----------------------------------------------


def run_shares(mod, w_low, slots=60, width=2):
    """Sustained two-class backlog in disjoint buckets; the served counts
    and every slot's plan."""
    t = [0.0]
    fp = mod.FairnessPolicy({"low": w_low}, aging_s=0.0, clock=lambda: t[0])
    wp = mod.WidthPolicy(width, width)
    q = mod.ServeQueue(policy=fp)
    seq = [0]
    plans = []
    for _ in range(slots):
        by_pri = {"high": 0, "low": 0}
        for j in q.jobs(t[0]):
            by_pri[j.priority] += 1
        for pri, size in (("high", 10), ("low", 12)):
            while by_pri[pri] < width:
                q.admit(mk_job(mod, f"{pri}-{seq[0]}", size=size, pri=pri, seq=seq[0],
                               admit_t=t[0]))
                seq[0] += 1
                by_pri[pri] += 1
        plans.append(plan_view(mod.pack_serve_slot(q, wp, fairness=fp, now=t[0])))
        t[0] += 1.0
    return dict(fp.served), plans, fp.snapshot()


def test_fairness_shares_match_jax_and_are_monotone():
    base, base_plans, base_snap = run_shares(tserve, 1.0)
    assert (base, base_plans, base_snap) == run_shares(jserve, 1.0)
    doubled = run_shares(tserve, 2.0)[0]
    assert doubled == run_shares(jserve, 2.0)[0]
    assert doubled["low"] / sum(doubled.values()) >= base["low"] / sum(base.values())
    assert doubled["low"] > base["low"] and base["high"] > base["low"] * 4


def aging_bound(mod):
    t = [0.0]
    fp = mod.FairnessPolicy({"high": 10000.0, "low": 1.0}, aging_s=1.0, clock=lambda: t[0])
    fp.charge("low", 50)  # pass debt: low never wins the stride pick
    wp = mod.WidthPolicy(2, 2)
    q = mod.ServeQueue(policy=fp)
    q.admit(mk_job(mod, "low-0", size=12, pri="low", seq=0, admit_t=0.0))
    seq = [1]
    for _ in range(30):
        while sum(1 for j in q.jobs(t[0]) if j.priority == "high") < 2:
            q.admit(mk_job(mod, f"h{seq[0]}", size=10, pri="high", seq=seq[0], admit_t=t[0]))
            seq[0] += 1
        plan = mod.pack_serve_slot(q, wp, fairness=fp, now=t[0])
        if any(j.tid == "low-0" for j in plan.picked):
            return t[0], plan.reason
        t[0] += 1.0
    return None, None


def test_low_served_within_aging_bound_like_jax():
    served_at, reason = aging_bound(tserve)
    assert (served_at, reason) == aging_bound(jserve)
    assert reason == "aging-override" and served_at <= 4.0


def test_aging_promotes_queue_order_like_jax():
    orders = []
    for mod in (tserve, jserve):
        t = [0.0]
        fp = mod.FairnessPolicy(aging_s=1.0, clock=lambda: t[0])
        q = mod.ServeQueue(policy=fp)
        q.admit(mk_job(mod, "old-low", pri="low", seq=0, admit_t=0.0))
        t[0] = 1.5
        q.admit(mk_job(mod, "new-normal", pri="normal", seq=1, admit_t=1.5))
        orders.append(([j.tid for j in q.jobs(t[0])],
                       [fp.queue_key(j, t[0]) for j in q.jobs(t[0])],
                       [fp.urgent(j, 4.0) for j in q.jobs(t[0])]))
    assert orders[0] == orders[1]
    assert orders[0][0] == ["old-low", "new-normal"]


def test_stride_reentry_cannot_bank_credit_like_jax():
    passes = []
    for mod in (tserve, jserve):
        fp = mod.FairnessPolicy(clock=lambda: 0.0)
        fp.note_backlog(["high"])
        for _ in range(40):
            fp.charge("high")
        fp.note_backlog(["high", "low"])
        passes.append(fp.snapshot())
        assert fp._pass["low"] >= fp._pass["high"]
    assert passes[0] == passes[1]
    with pytest.raises(ValueError):
        tserve.FairnessPolicy({"urgent": 1.0})
    with pytest.raises(ValueError):
        tserve.FairnessPolicy({"low": 0.0})


# -- cross-bucket packing (pure) ----------------------------------------------------


def priced(mod, prices):
    p = mod.BucketPricer()
    for bucket, per_s in prices.items():
        for _ in range(3):
            p.observe(bucket, per_s)
    return p


B_SMALL = ((10, 10, 10), "float32", "jacobi")
B_BIG = ((12, 12, 12), "float32", "jacobi")


def test_packing_prefers_fuller_priced_bucket_like_jax():
    plans = []
    for mod in (tserve, jserve, tserve):
        q = mod.ServeQueue()
        q.admit(mk_job(mod, "lone", size=10, seq=0))
        for i in range(4):
            q.admit(mk_job(mod, f"b{i}", size=12, seq=1 + i))
        plans.append(plan_view(mod.pack_serve_slot(
            q, mod.WidthPolicy(4, 4), pricer=priced(mod, {B_SMALL: 0.001, B_BIG: 0.001}))))
        assert [j.tid for j in q] == ["lone"]
    assert plans[0] == plans[1] == plans[2]
    assert plans[0][:4] == (B_BIG, 4, ["b0", "b1", "b2", "b3"], "throughput")
    assert len(plans[0][5]) == 2


@pytest.mark.parametrize("deadline", [1.1, None])
def test_packing_deadline_slack_veto_like_jax(deadline):
    plans = []
    for mod in (tserve, jserve):
        q = mod.ServeQueue()
        for i in range(4):
            q.admit(mk_job(mod, f"bulk{i}", size=12, steps=10, seq=i))
        q.admit(mk_job(mod, "tight", size=10, steps=4, dl=deadline, seq=4))
        plans.append(plan_view(mod.pack_serve_slot(
            q, mod.WidthPolicy(4, 4), pricer=priced(mod, {B_BIG: 0.001, B_SMALL: 0.001}))))
    assert plans[0] == plans[1]
    if deadline is None:
        assert plans[0][0] == B_BIG
    else:
        assert plans[0][0] == B_SMALL and plans[0][3] == "deadline-slack"
    assert tserve.pack_serve_slot(tserve.ServeQueue(), tserve.WidthPolicy(1, 1)) is None


# -- per-width pricing (pure) -------------------------------------------------------


def test_pricer_per_width_rows_match_jax_and_cross_load(tmp_path):
    b = ((N, N, N), "float32", "jacobi")
    rows = {}
    for pkg, (mod, _, led) in PKGS.items():
        p = mod.BucketPricer()
        for _ in range(3):
            p.observe(b, 0.002, width=4)
        for _ in range(3):
            p.observe(b, 0.016, width=16)
        prices = [p.price(b, width=w) for w in (4, 16, 8, None)]
        entries = p.ledger_entries(platform="cpu", label="t")
        for e in entries:
            e.pop("t")
            e.get("detail", {}).pop("device", None)
        rows[pkg] = (prices, entries)
        path = str(tmp_path / f"{pkg}.jsonl")
        led.append_entries(path, p.ledger_entries(platform="cpu", label="t"))
        for reader, _, _ in PKGS.values():  # each package prices from the other's rows
            again = reader.BucketPricer(path)
            assert again.price(b, width=4)[0] == pytest.approx(prices[0][0])
            assert again.price(b, width=16)[0] == pytest.approx(prices[1][0])
            assert again.price(b)[0] > 0
    assert rows["t"] == rows["j"]
    prices, entries = rows["t"]
    assert prices[0][0] == pytest.approx(2.0) and "B=4" in prices[0][1]
    assert prices[1][0] == pytest.approx(16.0) and "B=16" in prices[1][1]
    assert prices[2][0] > 0 and "B=" not in prices[2][1]
    assert sorted((e["detail"].get("width") or 0) for e in entries) == [0, 4, 16]
    assert tserve.BucketPricer().price(b) is None
    ctrl = tserve.AdmissionController(quota=1, pricer=None)
    job = mk_job(tserve, "x")
    assert ctrl.decide(job, {}) == jserve.AdmissionController(quota=1).decide(
        mk_job(jserve, "x"), {}) == ("admit", "")
    assert ctrl.decide(job, {"x": 1})[0] == "defer"
    with pytest.raises(ValueError):
        tserve.AdmissionController(quota=-1)


# -- integration: the capacity engine end to end ------------------------------------


def engine_kw(pkg, **over):
    kw = dict(chunk=2, max_idle_s=0.3, poll_s=0.02, packing=True, fairness=True,
              preempt=True, aging_s=5.0)
    kw.update({"device": "cpu"} if pkg == "t" else {"devices": DEV1})
    kw.update(over)
    return kw


def scheduler(pkg, *, late=(), stream=False, clock=None):
    """A scheduler class of ``pkg`` dropping ``late`` at its first chunk
    boundary (``stream``: one job a boundary), ahead of its observation;
    with ``clock`` (a one-item list) it advances the aging clock one second
    a chunk, so aging is a count of chunks, not of wall time."""
    base = PKGS[pkg][0].ServeScheduler

    class Hooked(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._late = list(late)
            if clock is not None and self.fairness is not None:
                self.fairness.clock = lambda: clock[0]

        def _observe_chunk(self, bucket, per, done_now):
            if clock is not None:
                clock[0] += 1.0
            # in name order: an intake orders equal mtimes by name
            if stream and self._late:
                drop(self.serve_dir, self._late.pop(0))
            while self._late and not stream:
                drop(self.serve_dir, self._late.pop(0))
            super()._observe_chunk(bucket, per, done_now)

    return Hooked


def serve_both(tmp_path, docs, slot=2, *, ledger=None, clock=False, **kw):
    """The same drops and hooks through each package's daemon; returns
    ``{pkg: (summary, records, scheduler)}``, every record valid under both
    schemas."""
    runs = {}
    for pkg, (_, tel, led) in PKGS.items():
        sdir = str(tmp_path / pkg)
        for d in docs:
            drop(sdir, d)
        lpath = None
        if ledger:
            lpath = str(tmp_path / f"ledger-{pkg}.jsonl")
            seeded_ledger(led, lpath, ledger)
        mpath = tmp_path / f"{pkg}.jsonl"
        tel.configure(metrics_out=str(mpath), app="t")
        try:
            s = scheduler(pkg, clock=[0.0] if clock else None,
                          **{k: v for k, v in kw.items() if k in ("late", "stream")})(
                sdir, slot, admission_ledger=lpath,
                **engine_kw(pkg, **{k: v for k, v in kw.items()
                                    if k not in ("late", "stream")}))
            out = s.serve()
        finally:
            tel.get().close()
        recs = [json.loads(ln) for ln in open(mpath) if ln.strip()]
        bad = [e for r in recs for e in ttel.validate_record(r) + jtel.validate_record(r)]
        assert not bad, bad[:3]
        runs[pkg] = (out, recs, s)
    return runs


DECIDED = {"serve.resized": ("bucket", "from_width", "to_width", "reason", "depth",
                             "remaining_ms", "cost_ms"),
           "serve.preempted": ("job", "bucket", "victim_bucket", "victims", "gain_ms",
                               "resume_cost_ms", "remaining_ms"),
           "serve.preempt_veto": ("job", "bucket", "victim_bucket", "gain_ms",
                                  "resume_cost_ms", "remaining_ms"),
           "serve.packed": ("bucket", "width", "jobs", "lead", "reason"),
           "serve.parked": ("job", "step", "reason"),
           "serve.retired": ("job", "outcome", "steps"),
           "serve.admitted": ("job", "promoted")}


def decisions(recs):
    return [(r["name"],) + tuple(r.get(k) for k in DECIDED[r["name"]])
            for r in recs if r["name"] in DECIDED]


def assert_twins(runs):
    (t, trec, _), (j, jrec, _) = runs["t"], runs["j"]
    assert decisions(trec) == decisions(jrec)
    for k in ("retired", "slots", "preemptions", "resizes", "backfills", "outcome", "fairness"):
        assert t[k] == j[k], k
    assert set(t["results"]) == set(j["results"])
    for tid, want in j["results"].items():
        assert t["results"][tid].outcome == want.outcome
        assert t["results"][tid].final.tobytes() == want.final.tobytes(), tid


def test_elastic_grow_mid_slot_and_zero_recompile(tmp_path):
    runs = serve_both(tmp_path, [job_doc(f"e{i}", steps=8) for i in range(2)],
                      ledger={bucket_label(((N, N, N), "float32", "jacobi")): 50.0},
                      late=[job_doc(f"late{i}", steps=8) for i in range(4)],
                      slot_min=2, slot_max=8, preempt=False)
    assert_twins(runs)
    out, recs, s = runs["t"]
    assert out["retired"] == 6 and out["resizes"] >= 1 and out["outcome"] == "idle"
    grew = [r for r in recs if r["name"] == "serve.resized" and r["reason"] == "grow"]
    assert grew and grew[0]["from_width"] == 2 and grew[0]["to_width"] > 2
    assert [r for r in recs if r["name"] == "serve.parked" and r.get("reason") == "resize"]
    built = s.cache.built_keys
    assert len(built) == len(set(built))
    assert len({json.loads(k).get("batch") for k in built} - {None}) >= 2


PREEMPT_LEDGER = {bucket_label(((14, 14, 14), "float32", "jacobi")): 100.0,
                  bucket_label(((N, N, N), "float32", "jacobi")): 1.0}


def preempt_jobs(seed0):
    return [job_doc(f"low{i}", size=14, steps=10, priority="low", seed=seed0 + i)
            for i in range(2)]


def test_preemption_prices_gain_and_restores_bit_identical(tmp_path):
    hi = job_doc("rush", size=N, steps=2, priority="high", deadline_ms=9.0, seed=99)
    ref = serve_both(tmp_path / "ref", preempt_jobs(60) + [hi], preempt=False)
    runs = serve_both(tmp_path / "run", preempt_jobs(60), ledger=PREEMPT_LEDGER, late=[hi],
                      preempt_cost_chunks=0.05)
    assert_twins(runs)
    out, recs, _ = runs["t"]
    assert out["retired"] == 3 and out["preemptions"] == 1
    pre = [r for r in recs if r["name"] == "serve.preempted"]
    assert len(pre) == 1 and pre[0]["job"] == "rush"
    assert pre[0]["gain_ms"] > pre[0]["resume_cost_ms"]
    assert sorted(pre[0]["victims"]) == ["low0", "low1"]
    parked = [r for r in recs if r["name"] == "serve.parked" and r.get("reason") == "preempt"]
    assert len(parked) == 2 and all(0 < r["step"] < 10 for r in parked)
    for jid in ("low0", "low1", "rush"):
        a, b = out["results"][jid], ref["j"][0]["results"][jid]
        assert a.outcome == b.outcome == "done"
        assert a.final.tobytes() == b.final.tobytes(), jid


def test_preemption_vetoed_when_gain_below_resume_cost(tmp_path):
    hi = job_doc("rush", size=N, steps=2, priority="high", deadline_ms=9.0)
    runs = serve_both(tmp_path, preempt_jobs(70), ledger=PREEMPT_LEDGER, late=[hi],
                      preempt_cost_chunks=1e6)
    assert_twins(runs)
    out, recs, _ = runs["t"]
    assert out["preemptions"] == 0 and out["retired"] == 3
    veto = [r for r in recs if r["name"] == "serve.preempt_veto"]
    assert veto and veto[0]["job"] == "rush"
    assert veto[0]["gain_ms"] <= veto[0]["resume_cost_ms"]
    assert not any(r["name"] == "serve.preempted" for r in recs)


def test_sustained_high_load_does_not_starve_low(tmp_path):
    """A stream of high jobs in another bucket, one a chunk boundary; the
    aging clock advances one second a chunk against aging_s 1."""
    docs = [job_doc("a-patient", size=12, steps=2, priority="low")] + [
        job_doc(f"h-pre{i}", size=N, steps=2, priority="high", seed=90 + i) for i in range(2)]
    late = [job_doc(f"h{i}", size=N, steps=2, priority="high", seed=i) for i in range(4)]
    runs = serve_both(tmp_path, docs, late=late, stream=True, clock=True, aging_s=1.0,
                      preempt=False)
    assert_twins(runs)
    out, recs, _ = runs["t"]
    assert out["retired"] == 7 and out["results"]["a-patient"].outcome == "done"
    order = [r["job"] for r in recs if r["name"] == "serve.retired"]
    assert order.index("a-patient") < len(order) - 1
    assert out["fairness"]["served"]["low"] >= 1


def test_priority_split_gauges_like_jax(tmp_path):
    """serve.p99_ms comes once folded and once per priority tag (what the
    report splits on), the same tags as the JAX daemon's."""
    docs = [job_doc("hi", priority="high"), job_doc("lo", priority="low", size=12)]
    runs = serve_both(tmp_path, docs, preempt=False)
    tags = {pkg: sorted(r.get("priority", "") for r in recs if r["name"] == "serve.p99_ms")
            for pkg, (_, recs, _) in runs.items()}
    assert tags["t"] == tags["j"] == ["", "high", "low"]
    assert sorted(runs["t"][0]["p99_ms_by_priority"]) == ["high", "low"]


# -- the load generator: the same seeded mix as the JAX script ----------------------


def test_loadgen_helpers_match_the_jax_script():
    lg = runpy.run_path(os.path.join(ROOT, "scripts", "serve_loadgen.py"))
    spec = "12,16x8x8/float64,10/float32/jacobi,8/float64/astaroth"
    assert tlg.parse_mix(spec) == lg["parse_mix"](spec)
    assert tlg.parse_mix("12")[0] == ([12, 12, 12], "float32", "jacobi")
    for bad in ("12/float16", "", "1x2", "3/float32/brew"):
        with pytest.raises(ValueError):
            tlg.parse_mix(bad)
    gaps = [0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 1.7, 0.01]
    shaped = tlg.burst_gaps(gaps, 0.5, 1.0)
    assert shaped == lg["burst_gaps"](gaps, 0.5, 1.0)
    t = 0.0
    for g in shaped:
        t += g
        assert g >= 0 and t % 1.5 < 0.5 + 1e-9


@pytest.mark.parametrize("argv", [
    ["--jobs", "6", "--rate", "0", "--seed", "7", "--tenants", "3", "--mixed-priority",
     "--mix", "12,16/float64,8/float64/astaroth"],
    ["--jobs", "3", "--rate", "0", "--seed", "1", "--deadline-ms", "5", "--prefix", "p",
     "--workload", "astaroth", "--dtype", "float64", "--size", "9", "--steps", "2"],
])
def test_loadgen_drops_the_same_jobs_for_the_same_seed(tmp_path, argv, capsys):
    lg = runpy.run_path(os.path.join(ROOT, "scripts", "serve_loadgen.py"))
    docs = {}
    for name, main in (("t", tlg.main), ("j", lg["main"])):
        sdir = str(tmp_path / name)
        assert main(["--serve-dir", sdir] + argv) == 0
        inc = os.path.join(sdir, "jobs", "incoming")
        docs[name] = {n: json.load(open(os.path.join(inc, n))) for n in sorted(os.listdir(inc))}
    assert docs["t"] == docs["j"] and docs["t"]
    assert all(tserve.validate_job(d) == [] for d in docs["t"].values())
    capsys.readouterr()
