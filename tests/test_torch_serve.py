"""The port's serving daemon (``stencil_tpu_torch/serve/``) against the
JAX package's on the CPU, scenario by scenario as ``tests/test_serve.py``
pins them: the queue order, the state file (each package reads and
validates the other's), mid-slot admission and backfill, quarantine of
malformed and duplicate jobs, quota deferral and promotion, priority that
reorders only queued jobs, priced rejection at admission, SLO pressure, the
drain and a revival (also by the other package, from the same directory),
the status queue section and the job schema. Each scenario runs both
daemons on the same drops; their decisions (the records' sequence, the
summary's counters, the state file's verdicts) must be equal, every record
must pass both packages' validators, and every served result must equal
the JAX daemon's: Jacobi bit-exact (byte-equal), the only workload here.
Arrivals come from hooks, never sleeps; no assertion reads a clock."""

import json
import os
import shutil

import jax
import pytest
import torch

import stencil_tpu.obs.ledger as jled
import stencil_tpu.obs.telemetry as jtel
import stencil_tpu.serve as jserve
import stencil_tpu.serve.admission as jadm
import stencil_tpu_torch.obs.ledger as tled
import stencil_tpu_torch.obs.telemetry as ttel
import stencil_tpu_torch.serve as tserve
import stencil_tpu_torch.serve.admission as tadm

torch.set_num_threads(2)

DEV1 = jax.devices()[:1]
N = 10
STEPS = 4
PKGS = {"t": (tserve, ttel), "j": (jserve, jtel)}


def job_doc(jid, *, size=N, steps=STEPS, tenant=None, priority="normal", deadline_ms=None,
            workload="jacobi", seed=None, dtype="float32"):
    doc = {"job": jid, "size": size, "steps": steps, "workload": workload,
           "priority": priority, "dtype": dtype,
           "seed": seed if seed is not None else sum(map(ord, jid)) % 1000}
    if tenant:
        doc["tenant"] = tenant
    if deadline_ms is not None:
        doc["deadline_ms"] = deadline_ms
    return doc


def drop(serve_dir, doc=None, *, name=None, text=None):
    """The loadgen write contract: tmp + rename into jobs/incoming/."""
    inc = os.path.join(serve_dir, "jobs", "incoming")
    os.makedirs(inc, exist_ok=True)
    name = name or f"{doc['job']}.json"
    tmp = os.path.join(inc, f".tmp-{name}")
    with open(tmp, "w") as f:
        f.write(text if text is not None else json.dumps(doc))
    os.replace(tmp, os.path.join(inc, name))


def kwargs(pkg, **kw):
    kw.setdefault("chunk", 2)
    kw.setdefault("max_idle_s", 0.3)
    kw.setdefault("poll_s", 0.02)
    if pkg == "t":
        kw["device"] = "cpu"
    else:
        kw["devices"] = DEV1
    return kw


def late_drop(pkg, *, late=(), drain=False, before=False):
    """A scheduler class of ``pkg`` that drops ``late`` job files at its
    first chunk boundary (after or ``before`` its own observation) and,
    with ``drain``, requests a drain there: a producer writing, or SIGTERM
    arriving, while the slot is mid-flight."""
    base = PKGS[pkg][0].ServeScheduler

    class Hooked(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._late = list(late)

        def _observe_chunk(self, bucket, per, done_now):
            if not before:
                super()._observe_chunk(bucket, per, done_now)
            while self._late:  # in name order: an intake orders equal mtimes by name
                drop(self.serve_dir, self._late.pop(0))
            if before:
                super()._observe_chunk(bucket, per, done_now)
            if drain:
                self.request_drain("test-sigterm")

    return Hooked


def serve(pkg, sdir, mpath, slot=2, cls=None, **kw):
    """Serve ``sdir`` with ``pkg``'s daemon, its telemetry into ``mpath``;
    returns the summary and the records, each valid under both schemas."""
    _, tel = PKGS[pkg]
    tel.configure(metrics_out=str(mpath), app="t")
    try:
        cls = cls or PKGS[pkg][0].ServeScheduler
        out = cls(str(sdir), slot, **kwargs(pkg, **kw)).serve()
    finally:
        tel.get().close()
    recs = [json.loads(ln) for ln in open(mpath) if ln.strip()]
    bad = [e for r in recs for e in ttel.validate_record(r) + jtel.validate_record(r)]
    assert not bad, bad[:3]
    return out, recs


def trace(recs, *names):
    """The decision records' sequence: name and job (or tenant) per record."""
    return [(r["name"], r.get("job", r.get("tenant"))) for r in recs if r["name"] in names]


DECISIONS = ("serve.admitted", "serve.rejected", "serve.deferred", "serve.retired",
             "serve.parked", "serve.drain", "serve.revived", "campaign.backfill",
             "replan.requested")


def both(tmp_path, docs, *, late=(), drain=False, slot=2, **kw):
    """The same drops served by each package's daemon (``late`` dropped at
    the first chunk boundary); returns ``{pkg: (summary, records, dir)}``
    after checking their decisions, counters and results agree."""
    runs = {}
    for pkg in PKGS:
        sdir = tmp_path / pkg
        for d in docs:
            drop(str(sdir), d)
        cls = late_drop(pkg, late=late, drain=drain) if late or drain else None
        out, recs = serve(pkg, sdir, tmp_path / f"{pkg}.jsonl", slot=slot, cls=cls, **kw)
        runs[pkg] = (out, recs, str(sdir))
    (t, trec, _), (j, jrec, _) = runs["t"], runs["j"]
    assert trace(trec, *DECISIONS) == trace(jrec, *DECISIONS)
    for k in ("outcome", "revived", "slots", "retired", "admitted", "rejected", "deferred",
              "backfills", "queued_remaining", "evicted", "preemptions", "resizes"):
        assert t[k] == j[k], k
    assert_same_results(t, j)
    return runs


def assert_same_results(t, j):
    assert set(t["results"]) == set(j["results"])
    for tid, want in j["results"].items():
        got = t["results"][tid]
        assert (got.outcome, got.steps) == (want.outcome, want.steps), tid
        if want.outcome == "done":
            assert got.final.tobytes() == want.final.tobytes(), tid


# -- queue policy and the state file (pure units) ------------------------------------


def test_queue_orders_priority_deadline_arrival():
    def jobs(mod):
        return [mod.ServeJob(tid, (N, N, N), STEPS, "float32", seed=0, deadline_ms=dl,
                             owner=tid, priority=pri, seq=seq)
                for tid, pri, dl, seq in (("low-first", "low", None, 0),
                                          ("norm-late", "normal", None, 3),
                                          ("norm-tight", "normal", 1.0, 2),
                                          ("high", "high", None, 1))]

    picks = {}
    for pkg, (mod, _) in PKGS.items():
        q = mod.ServeQueue()
        for job in jobs(mod):
            q.admit(job)
        order = [x.tid for x in q]
        bucket, picked = mod.pick_serve_slot(q, 3)
        picks[pkg] = (order, bucket, [x.tid for x in picked], [x.tid for x in q],
                      [j.order_key() for j in jobs(mod)])
    assert picks["t"] == picks["j"]
    assert picks["t"][0] == ["high", "norm-tight", "norm-late", "low-first"]
    assert picks["t"][2:4] == (["high", "norm-tight", "norm-late"], ["low-first"])


@pytest.mark.parametrize("writer,reader", [("t", "j"), ("j", "t")])
def test_state_files_cross_read_and_validate(tmp_path, writer, reader):
    w, r = PKGS[writer][0], PKGS[reader][0]
    doc = w.make_state()
    assert doc == r.make_state()
    doc["jobs"]["j1"] = {"state": "queued", "steps_done": 0, "owner": "a",
                         "priority": "normal", "seq": 0, "spec": job_doc("j1")}
    path = str(tmp_path / "serve-state.json")
    w.write_state(path, doc)
    back = r.read_state(path)
    assert back is not None and r.validate_state(back) == [] == w.validate_state(back)
    assert back["jobs"]["j1"]["state"] == "queued"
    assert r.read_state(str(tmp_path / "missing.json")) is None
    assert w.JOB_STATES == r.JOB_STATES and w.LIVE_STATES == r.LIVE_STATES
    bad = w.make_state()
    bad["counters"]["admitted"] = True
    bad["jobs"]["x"] = {"state": "sleeping", "steps_done": 0, "owner": "a",
                        "priority": "normal", "seq": 0, "spec": {}}
    assert w.validate_state(bad) == r.validate_state(bad)
    assert any("counters.admitted" in e for e in w.validate_state(bad))
    assert w.validate_state([]) == r.validate_state([]) == ["not an object: list"]


# -- continuous batching: mid-slot admission, no slot-wide barrier -------------------


def test_mid_slot_admission_backfills_without_barrier(tmp_path):
    runs = both(tmp_path, [job_doc(f"early{i}") for i in range(2)],
                late=[job_doc("late0"), job_doc("late1")])
    out, recs, sdir = runs["t"]
    assert out["retired"] == 4 and out["slots"] == 1 and out["backfills"] >= 2
    names = [r["name"] for r in recs]
    slot0 = names.index("campaign.slot")
    late_admits = [i for i, r in enumerate(recs)
                   if r["name"] == "serve.admitted" and r["job"].startswith("late")]
    assert late_admits and all(i > slot0 for i in late_admits)
    assert {"late0", "late1"} <= {r["tenant"] for r in recs if r["name"] == "campaign.backfill"}
    for jid in ("early0", "early1", "late0", "late1"):
        docs = [json.load(open(os.path.join(d, "results", f"{jid}.json")))
                for _, _, d in runs.values()]
        assert all(d["outcome"] == "done" and d["steps"] == STEPS for d in docs)
        assert {k: v for k, v in docs[0].items() if k not in ("t", "snapshot_dir")} == {
            k: v for k, v in docs[1].items() if k not in ("t", "snapshot_dir")}


# -- quarantine: malformed and duplicate jobs never kill the daemon ------------------


def test_malformed_and_duplicate_jobs_quarantined(tmp_path):
    reasons = {}
    for pkg in PKGS:
        sdir = str(tmp_path / pkg)
        drop(sdir, job_doc("good"))
        drop(sdir, None, name="torn.json", text='{"job": "torn", "size": 8')
        drop(sdir, job_doc("weird") | {"workload": "brew"}, name="weird.json")
        out, recs = serve(pkg, sdir, tmp_path / f"{pkg}1.jsonl")
        assert out["retired"] == 1 and out["rejected"] == 2
        drop(sdir, job_doc("good"))  # a replayed, retired job id
        out2, recs2 = serve(pkg, sdir, tmp_path / f"{pkg}2.jsonl")
        assert out2["retired"] == 0 and out2["rejected"] == 1 and out2["revived"] == 0
        bad_dir = os.path.join(sdir, "jobs", "bad")
        reasons[pkg] = ({n: open(os.path.join(bad_dir, n)).read()
                         for n in sorted(os.listdir(bad_dir)) if n.endswith(".reason.txt")},
                        [(r["job"], r["reason"]) for r in recs + recs2
                         if r["name"] == "serve.rejected"])
    assert reasons["t"] == reasons["j"]
    texts, rejected = reasons["t"]
    assert any("not valid JSON" in v for v in texts.values())
    assert any("unknown workload 'brew'" in v for v in texts.values())
    assert any("duplicate job id 'good'" in v for v in texts.values())
    assert [j for j, _ in rejected] == ["torn", "weird", "good"]


# -- admission edge cases ------------------------------------------------------------


def test_quota_exhaustion_defers_then_promotes(tmp_path):
    runs = both(tmp_path, [job_doc(f"q{i}", tenant="alice", steps=3) for i in range(3)],
                slot=1, quota=1)
    out, recs, _ = runs["t"]
    assert (out["rejected"], out["retired"], out["deferred"]) == (0, 3, 2)
    deferred = [r for r in recs if r["name"] == "serve.deferred"]
    assert {r["job"] for r in deferred} == {"q1", "q2"}
    assert all("quota" in r["reason"] for r in deferred)
    names = [r["name"] for r in recs]
    promoted = [i for i, r in enumerate(recs) if r["name"] == "serve.admitted" and r.get("promoted")]
    assert len(promoted) == 2 and all(i > names.index("serve.retired") for i in promoted)


def test_priority_reorders_queued_never_running(tmp_path):
    runs = both(tmp_path, [job_doc("slowpoke", priority="low", steps=6)], slot=1,
                late=[job_doc("urgent", priority="high", steps=2)])
    out, recs, _ = runs["t"]
    assert out["retired"] == 2
    assert [r["job"] for r in recs if r["name"] == "serve.retired"] == ["slowpoke", "urgent"]
    assert [r["steps"] for r in recs if r["name"] == "serve.retired"] == [6, 2]
    assert not any(r["name"] == "serve.parked" for r in recs)


def seeded_ledger(mod, path, ms=250.0):
    label = mod.bucket_label(((N, N, N), "float32", "jacobi"))
    led = tled if mod is tadm else jled
    led.append_entries(path, [led.make_entry(
        mod.LEDGER_METRIC, ms, label="seed", unit="ms", platform="cpu", source="serve",
        config={"bucket": label}, detail={"bucket": label, "samples": 64})])


def test_infeasible_deadline_rejected_with_pricing_named(tmp_path):
    """The ledger seeded by one package prices the other's admission too; the
    port's drain-time writeback loads in the JAX package."""
    for writer in (tadm, jadm):
        path = str(tmp_path / f"seed-{writer.__name__}.jsonl")
        seeded_ledger(writer, path)
        for reader in (tadm, jadm):
            p99, source = reader.BucketPricer(path).price(((N, N, N), "float32", "jacobi"))
            assert p99 == 250.0 and "ledger" in source and "[seed]" in source
    docs = [job_doc("doomed", deadline_ms=1.0), job_doc("fine", deadline_ms=5000.0, steps=6),
            job_doc("nosla", steps=6)]
    runs = {}
    for pkg, mod in (("t", tadm), ("j", jadm)):
        lpath = str(tmp_path / f"ledger-{pkg}.jsonl")
        seeded_ledger(mod, lpath)
        sdir = tmp_path / pkg
        for d in docs:
            drop(str(sdir), d)
        runs[pkg] = serve(pkg, sdir, tmp_path / f"{pkg}.jsonl", admission_ledger=lpath) + (
            lpath, str(sdir))
    assert_same_results(runs["t"][0], runs["j"][0])
    reasons = {}
    for pkg, (out, recs, lpath, sdir) in runs.items():
        assert out["rejected"] == 1 and out["retired"] == 2
        rej = [r for r in recs if r["name"] == "serve.rejected"]
        assert len(rej) == 1 and rej[0]["job"] == "doomed"
        reasons[pkg] = rej[0]["reason"].replace(lpath, "LEDGER")
        assert "deadline 1 ms infeasible" in rej[0]["reason"] and "p99 is 250 ms" in reasons[pkg]
        st = tserve.read_state(os.path.join(sdir, "serve-state.json"))
        assert st["jobs"]["doomed"]["state"] == "rejected"
        assert not os.path.exists(os.path.join(sdir, "results", "doomed.json"))
        for reader in (tled, jled):
            written = [e for e in reader.load_ledger(lpath)
                       if e["metric"] == tadm.LEDGER_METRIC and e["label"] != "seed"]
            assert written and all(e["source"] == "serve" for e in written)
    assert reasons["t"] == reasons["j"]
    port_rows = [e for e in tled.load_ledger(runs["t"][2]) if e["label"] != "seed"]
    assert all(e["platform"] == "cpu" and e["detail"]["device"] == "cpu" for e in port_rows)


# -- SLO pressure -> replan.requested ------------------------------------------------


def test_slo_pressure_emits_replan_requested(tmp_path):
    runs = both(tmp_path, [job_doc("pressed", deadline_ms=0.001, steps=8)])
    for out, recs, _ in runs.values():
        assert out["retired"] == 1
        req = [r for r in recs if r["name"] == "replan.requested"]
        assert req and req[0]["reason"] == "slo-pressure"
        assert req[0]["bucket"] == tadm.bucket_label(((N, N, N), "float32", "jacobi"))
        assert req[0]["p99_ms"] > 0.001 and req[0]["jobs"] == ["pressed"]


# -- graceful drain + revival --------------------------------------------------------


def drain_docs():
    return [job_doc(f"d{i}", steps=6, seed=40 + i) for i in range(3)]


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """The JAX daemon's uninterrupted serve of the drain scenario's jobs."""
    base = tmp_path_factory.mktemp("serve-ref")
    for d in drain_docs():
        drop(str(base / "s"), d)
    out, _ = serve("j", base / "s", base / "m.jsonl", ckpt_every=2)
    assert out["retired"] == 3
    return out


@pytest.mark.parametrize("first,second", [("t", "t"), ("t", "j"), ("j", "t")],
                         ids=["port-revives-port", "jax-revives-port", "port-revives-jax"])
def test_drain_parks_and_revival_finishes_bit_identical(tmp_path, uninterrupted, first, second):
    """A daemon drained at its first chunk boundary parks every lane; a
    second daemon (of either package) revives from the same directory and
    finishes each job bit-identical to an uninterrupted serve."""
    sdir = tmp_path / "s"
    for d in drain_docs():
        drop(str(sdir), d)
    out1, recs1 = serve(first, sdir, tmp_path / "m1.jsonl", ckpt_every=2,
                        cls=late_drop(first, drain=True))
    assert out1["outcome"] == "drained" and out1["retired"] == 0
    assert out1["queued_remaining"] == 3
    parked = [r for r in recs1 if r["name"] == "serve.parked"]
    assert parked and all(0 < r["step"] < 6 for r in parked)
    assert any(r["name"] == "serve.drain" and r["reason"] == "test-sigterm" for r in recs1)
    st = tserve.read_state(str(sdir / "serve-state.json"))
    assert tserve.validate_state(st) == [] == jserve.validate_state(st) and st["draining"]
    out2, recs2 = serve(second, sdir, tmp_path / "m2.jsonl", ckpt_every=2)
    assert out2["revived"] == 3 and out2["retired"] == 3
    assert any(r["name"] == "serve.revived" and r["jobs"] == 3 for r in recs2)
    assert_same_results(out2, uninterrupted)
    st = jserve.read_state(str(sdir / "serve-state.json"))
    assert tserve.validate_state(st) == [] == jserve.validate_state(st)
    assert all(j["state"] == "done" for j in st["jobs"].values())


# -- the status queue section --------------------------------------------------------


def test_queue_stat_matches_jax(tmp_path):
    """The status file's queue section (``queue_stat``) after the same serve;
    the JAX status schema accepts it."""
    from stencil_tpu.obs.status import validate_status

    stats = {}
    for pkg, (mod, _) in PKGS.items():
        sdir = str(tmp_path / pkg)
        drop(sdir, job_doc("one"))
        s = mod.ServeScheduler(sdir, 2, **kwargs(pkg))
        out = s.serve()
        assert out["retired"] == 1
        stats[pkg] = s.queue_stat()
    assert stats["t"] == stats["j"]
    assert stats["t"]["depth"] == 0 and stats["t"]["admitted"] == 1
    doc = {"v": 1, "kind": "status", "app": "serve", "run": "r1", "t": 0.0, "queue": stats["t"]}
    assert not [e for e in validate_status(doc) if "queue" in e]


@pytest.mark.parametrize("bad,msg", [
    ({"job": "a/b", "size": 8, "steps": 1}, "path-safe"),
    ({"job": "a", "size": 0, "steps": 1}, "size"),
    ({"job": "a", "size": 8, "steps": 1, "deadline_ms": -2}, "deadline_ms"),
    ({"job": "a", "size": 8, "steps": 1, "priority": "urgent"}, "priority"),
    ({"job": "a", "size": 8, "steps": 1, "shape": 3}, "unknown fields"),
    ({"job": "a", "size": [8, 8], "steps": 1, "dtype": "float16"}, "dtype"),
    ({"job": "a", "size": 8, "steps": 1, "workload": "astaroth", "seed": 2}, None),
    (["not", "a", "dict"], "not an object"),
])
def test_job_schema_matches_jax(bad, msg):
    errs = tserve.validate_job(bad)
    assert errs == jserve.validate_job(bad)
    assert (not errs) if msg is None else any(msg in e for e in errs), errs
    if msg is None:
        t, j = tserve.job_from_doc(bad, 7), jserve.job_from_doc(bad, 7)
        assert t.spec_doc() == j.spec_doc() and t.order_key() == j.order_key()
        assert t.bucket() == j.bucket()


def test_serve_app_refuses_unported_flags(tmp_path):
    from stencil_tpu_torch.apps import serve as tapp

    for flag in (["--replan"], ["--plan-db", "x"], ["--status-file", "s"], ["--live-sentinel"],
                 ["--live-config", "{}"]):
        with pytest.raises(NotImplementedError, match="queue A item 4"):
            tapp.main(["--serve-dir", str(tmp_path), "--device", "cpu"] + flag)


def test_serve_app_kill_hook_and_revival(tmp_path):
    """The CLI on the CPU: killed with rc 17 after its first retirement
    (``STENCIL_SERVE_KILL_AFTER_RETIRE``), the same command revives the rest
    and never re-runs the retired job."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sdir = str(tmp_path / "s")
    for i in range(3):
        drop(sdir, job_doc(f"k{i}", steps=2, seed=i))
    cmd = [sys.executable, "-m", "stencil_tpu_torch.apps.serve", "--serve-dir", sdir,
           "--device", "cpu", "--slot", "1", "--max-idle-s", "0.2", "--poll-s", "0.02"]
    env = dict(os.environ, STENCIL_SERVE_KILL_AFTER_RETIRE="1", OMP_NUM_THREADS="2")
    r1 = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert r1.returncode == 17, r1.stderr[-2000:]
    env.pop("STENCIL_SERVE_KILL_AFTER_RETIRE")
    r2 = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert r2.returncode == 0, r2.stderr[-2000:]
    line = json.loads(r2.stdout.strip().splitlines()[-1])
    assert line["retired"] == 2 and line["revived"] == 2 and line["device"] == "cpu"
    st = tserve.read_state(os.path.join(sdir, "serve-state.json"))
    assert sorted(st["jobs"]) == ["k0", "k1", "k2"]
    assert all(j["state"] == "done" for j in st["jobs"].values())
    shutil.rmtree(sdir)
