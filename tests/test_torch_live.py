"""The port's live layer (stencil_tpu_torch/obs/live.py, obs/status.py and
run_guarded's sentinel / status wiring) against the JAX package's
(tests/test_obs_live.py, tests/test_obs_status.py): the same sample
sequences fed to both sentinels give the same detections, clears and
replan.requested events (warm-up, non-finite samples, window eviction,
direction, clear and re-arm, the hook that raises, the config cascade,
reset keeping totals); the status document round-trips, is written
atomically and both packages' validators agree on a catalogue of
documents; run_guarded feeds the sentinel each chunk's cycle time, driven
by a stand-in clock that injects the slowdown (no wall clock), and the
status writer's health counts accumulate across segments. Samples come from
numpy seeds. Tolerance: exact equality."""

import io
import json

import numpy as np
import pytest
import torch

import stencil_tpu.obs.live as jlive
import stencil_tpu.obs.status as jstatus
import stencil_tpu.obs.telemetry as jtel
import stencil_tpu_torch.obs.live as tlive
import stencil_tpu_torch.obs.status as tstatus
import stencil_tpu_torch.obs.telemetry as ttel
from stencil_tpu_torch.fault import HealthGuard, chunk_plan, run_guarded


def records(sink):
    return [json.loads(line) for line in sink.getvalue().splitlines()]


def strip(recs):
    """The records without the fields each run stamps (run, time)."""
    return [{k: v for k, v in r.items() if k not in ("run", "t")} for r in recs]


def feed(live, tel, config, keys_values, **kw):
    sink = io.StringIO()
    s = live.LiveSentinel(config, rec=tel.Recorder(sink=sink), **kw)
    events = [s.observe(k, v, step=i, unit=u) for i, (k, v, u) in enumerate(keys_values)]
    return events, strip(records(sink)), s.summary()


def sequences():
    rng = np.random.RandomState(24)
    base = list(1.0 + 0.05 * rng.randn(12))
    yield "spike and clear", base[:6] + [9.0, 1.0, 1.02] + base[6:], {"*": {"min_history": 3}}
    yield "sustained", base[:5] + [8.0] * 6 + [1.0, 1.0, 1.0], {"*": {"min_history": 4,
                                                                     "clear_after": 3}}
    yield "re-arm", base[:4] + [7.0, 1.0, 1.0, 7.5, 1.0, 1.0], {"*": {"min_history": 3,
                                                                     "rel_tol": 1.0}}
    yield "warm-up only", [50.0, 0.1, 30.0], {}
    yield "non-finite", base[:4] + [float("nan"), float("inf"), 6.0, 1.0, 1.0], \
        {"*": {"min_history": 3, "rel_tol": 0.5}}
    yield "eviction", list(1.0 + 0.01 * rng.randn(8)) + list(5.0 + 0.01 * rng.randn(8)) + [20.0], \
        {"*": {"window": 4, "min_history": 3, "rel_tol": 0.5}}
    yield "tight band", list(1.0 + 0.001 * rng.randn(10)) + [1.2], \
        {"*": {"min_history": 5, "rel_tol": 0.05, "mad_k": 3.0}}


@pytest.mark.parametrize("name,values,config", list(sequences()),
                         ids=[s[0] for s in sequences()])
@pytest.mark.parametrize("key,unit", [("step.latency_s", "s"), ("jacobi.mcells_per_s", None),
                                      ("step.latency_s[16x16x16,float32]", "s")])
def test_sentinel_events_match_jax(name, values, config, key, unit):
    kv = [(key, v, unit) for v in values]
    t = feed(tlive, ttel, config, kv)
    j = feed(jlive, jtel, config, kv)
    assert t == j
    if key == "jacobi.mcells_per_s":
        # the same sequence scaled down trips a throughput key on its low side
        low = [(key, 10.0 / v if v == v and abs(v) != float("inf") else v, unit)
               for v in values]
        assert feed(tlive, ttel, config, low) == feed(jlive, jtel, config, low)


def test_replan_hook_events_and_disabled_match_jax():
    seen = {"t": [], "j": []}

    def hook(tag):
        def h(ev):
            seen[tag].append(ev)
            raise RuntimeError("a broken hook must not kill the run")
        return h

    kv = [("k_s", v, "s") for v in (1.0, 1.0, 1.0, 10.0, 1.0, 12.0)]
    cfg = {"*": {"min_history": 2, "rel_tol": 0.5, "clear_after": 1}}
    assert feed(tlive, ttel, cfg, kv, on_replan=hook("t")) == \
        feed(jlive, jtel, cfg, kv, on_replan=hook("j"))
    assert seen["t"] == seen["j"] and len(seen["t"]) == 2
    t = feed(tlive, ttel, cfg, kv, replan=False)
    assert t == feed(jlive, jtel, cfg, kv, replan=False)
    assert "replan.requested" not in [r["name"] for r in t[1]]


def test_reset_keeps_totals_and_config_cascade_match_jax():
    cfg = {"*": {"min_history": 9}, "step.latency_s": {"min_history": 2, "rel_tol": 0.25},
           "step.latency_s[a]": {"rel_tol": 0.75}}
    for mod, tel in ((tlive, ttel), (jlive, jtel)):
        s = mod.LiveSentinel(cfg, rec=tel.Recorder(sink=None))
        assert s._window("step.latency_s[16x16x16]", "s").min_history == 2
        assert s._window("step.latency_s[a]", "s").rel_tol == 0.75
    out = []
    for mod, tel in ((tlive, ttel), (jlive, jtel)):
        s = mod.LiveSentinel({"*": {"min_history": 2, "rel_tol": 0.5, "clear_after": 1}},
                             rec=tel.Recorder(sink=None))
        for i, v in enumerate((1.0, 1.0, 9.0, 1.0)):
            s.observe("k_s", v, step=i, unit="s")
        s.reset()
        s.observe("k_s", 9.0, step=5, unit="s")  # warm-up again: judged by nothing
        out.append((s.summary(), s.detected_total, s.cleared_total, sorted(s.windows)))
    assert out[0] == out[1] and out[0][1] == 1


@pytest.mark.parametrize("config", [
    {}, {"*": {"rel_tol": 1.0, "window": 8, "min_history": 4}}, "x", {"k": 3},
    {"k": {"rel_tolerance": 1.0}}, {"k": {"min_history": 0}}, {"k": {"rel_tol": float("nan")}},
    {"k": {"direction": "sideways"}}, {"k": {"window": 2, "min_history": 8}},
    {"*": {"min_history": 8}, "k": {"window": 2}},
    {"*": {"min_history": 8, "window": 16}, "k": {"window": 16}},
    {"k": {"mad_k": True}}, {"k": {"clear_after": 1.5}},
])
def test_validate_config_matches_jax(config):
    assert tlive.validate_config(config) == jlive.validate_config(config)


def test_online_window_edges_match_jax():
    for mod in (tlive, jlive):
        with pytest.raises(ValueError, match="cannot hold"):
            mod.OnlineWindow("k", window=2, min_history=4)
    for key, unit in (("a_s", None), ("x_per_s", "s"), ("y", "ms"), ("z.rc", None),
                      ("w[m,b]", None), ("q_per_dev", None)):
        assert tlive.default_direction(key, unit) == jlive.default_direction(key, unit)
        assert tlive.base_metric(key) == jlive.base_metric(key)


# -- the status file -----------------------------------------------------------------


def full_doc():
    return {"v": 1, "kind": "run-status", "run": "r", "app": "jacobi3d", "t": 1.0e9,
            "step": 10, "iters": 40, "outcome": None, "per_step_s": 0.01, "steps_per_s": 100.0,
            "health": {"checks": 3, "faults": 1, "rollbacks": 1},
            "anomalies": {"active": [{"metric": "step.latency_s", "step": 6, "value": 0.5,
                                      "lo": 0.0, "hi": 0.1, "direction": "lower"}],
                          "detected": 1, "cleared": 0},
            "lanes": [{"lane": 0, "tenant": "t0", "step": 3, "steps": 6, "p50_ms": 1.0,
                       "p99_ms": 2.0, "deadline_ms": 5.0, "slo": "ok"},
                      {"lane": 1, "tenant": None}],
            "slo": {"violations": ["t1"]},
            "queue": {"depth": 2, "admitted": 5, "rejected": 1, "backfills": 3, "deferred": 1,
                      "retired": 4, "width": 2, "preempted": 1, "resized": 1}}


def test_status_round_trip_atomic_and_renders_like_jax(tmp_path):
    path = str(tmp_path / "s" / "status.json")
    doc = full_doc()
    tstatus.write_status(path, doc)
    assert not [e for e in (tmp_path / "s").iterdir() if e.name.startswith(".tmp-")]
    assert tstatus.read_status(path) == doc == jstatus.read_status(path)
    assert tstatus.validate_status(doc) == [] == jstatus.validate_status(doc)
    assert tstatus.render_status(doc).split(" · updated")[0] == \
        jstatus.render_status(doc).split(" · updated")[0]
    assert tstatus.render_status(doc).splitlines()[1:] == \
        jstatus.render_status(doc).splitlines()[1:]
    (tmp_path / "g.json").write_text("{ torn")
    (tmp_path / "l.json").write_text("[1, 2]")
    for p in ("g.json", "l.json", "missing.json"):
        assert tstatus.read_status(str(tmp_path / p)) is None


def mutations():
    yield "not a dict", lambda d: [1]
    yield "version", lambda d: {**d, "v": 2}
    yield "kind", lambda d: {**d, "kind": "other"}
    yield "t", lambda d: {**d, "t": "now"}
    yield "run", lambda d: {**d, "run": 3}
    yield "step bool", lambda d: {**d, "step": True}
    yield "per_step_s", lambda d: {**d, "per_step_s": "fast"}
    yield "health", lambda d: {**d, "health": {"checks": 1}}
    yield "health list", lambda d: {**d, "health": []}
    yield "anomalies", lambda d: {**d, "anomalies": {"active": [{}], "detected": 1,
                                                     "cleared": "x"}}
    yield "lanes", lambda d: {**d, "lanes": [{"lane": "a"}, {"lane": 1, "slo": "meh"}]}
    yield "slo", lambda d: {**d, "slo": {"violations": "t1"}}
    yield "queue", lambda d: {**d, "queue": {"depth": 1, "admitted": True, "rejected": 0,
                                             "backfills": 0, "width": 1.5}}
    yield "minimal", lambda d: {"v": 1, "kind": "run-status", "t": 0}


@pytest.mark.parametrize("name,mutate", list(mutations()), ids=[m[0] for m in mutations()])
def test_validate_status_catalogue_matches_jax(name, mutate):
    doc = mutate(full_doc())
    assert tstatus.validate_status(doc) == jstatus.validate_status(doc)
    assert (tstatus.validate_status(doc) == []) == (name == "minimal")


def test_status_writer_set_and_update(tmp_path):
    path = str(tmp_path / "status.json")
    clock = iter([10.0, 11.0, 12.0])
    w = tstatus.StatusWriter(path, app="a", run="r", clock=lambda: next(clock))
    w.set(lanes=[{"lane": 0, "tenant": None}])
    assert tstatus.read_status(path) is None  # staged, not flushed
    w.update(step=3, iters=9, outcome=None)
    doc = tstatus.read_status(path)
    assert doc["step"] == 3 and doc["lanes"] == [{"lane": 0, "tenant": None}]
    assert doc["t"] == 11.0 and "outcome" not in doc and tstatus.validate_status(doc) == []


# -- run_guarded's live wiring, without the wall clock --------------------------------


class StandInClock:
    """A clock that advances only when the stand-in step says so."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def test_run_guarded_feeds_sentinel_and_detects_midrun(tmp_path):
    """Steps 1..5 take 2 ms of stand-in time, step 6's chunk 80 ms: the
    sentinel detects it at step 6 during the run, clears at 8, and the
    status file shows it; no real time is measured."""
    sink = io.StringIO()
    old = ttel._recorder
    ttel._recorder = rec = ttel.Recorder(sink=sink)
    clock = StandInClock()
    path = str(tmp_path / "status.json")
    try:
        sent = tlive.LiveSentinel({"*": {"min_history": 3, "rel_tol": 1.0, "clear_after": 2}},
                                  rec=rec)
        status = tstatus.StatusWriter(path, app="t", run=rec.run_id)
        snapshots = []

        def step_fn(st, k):
            clock.now += 0.08 if int(st["q"][0]) + k == 6 else 0.002
            return {"q": st["q"] + k}

        def on_chunk(st, k, per, done):
            snapshots.append(tstatus.read_status(path))

        state, done = run_guarded({"q": torch.zeros(2)}, start=0, iters=10,
                                  plan_fn=lambda s: chunk_plan(s, 10, 1), step_fn=step_fn,
                                  on_chunk=on_chunk, sentinel=sent, status=status, clock=clock)
        assert done == 10 and float(state["q"][0]) == 10
        recs = records(sink)
        det = [r for r in recs if r["name"] == "anomaly.detected"]
        clr = [r for r in recs if r["name"] == "anomaly.cleared"]
        rep = [r for r in recs if r["name"] == "replan.requested"]
        assert len(det) == 1 and det[0]["step"] == 6 and det[0]["value"] == pytest.approx(0.08)
        assert len(rep) == 1 and len(clr) == 1 and clr[0]["step"] == 8
        assert sent.summary() == {"active": [], "detected": 1, "cleared": 1}
        # the snapshot written after chunk 6 (read during chunk 7) shows it live
        assert snapshots[6]["anomalies"]["detected"] == 1 and snapshots[6]["step"] == 6
        doc = tstatus.read_status(path)
        assert doc["step"] == 10 and doc["per_step_s"] == pytest.approx(0.002)
        assert tstatus.validate_status(doc) == [] == jstatus.validate_status(doc)
        for r in recs:
            assert ttel.validate_record(r) == [] == jtel.validate_record(r)
    finally:
        ttel._recorder = old


def test_status_health_accumulates_across_guarded_segments(tmp_path):
    path = str(tmp_path / "status.json")
    status = tstatus.StatusWriter(path, app="t", run="r")
    guard = HealthGuard(every=1)
    for _seg in range(2):
        run_guarded({"q": torch.zeros(2)}, start=0, iters=3,
                    plan_fn=lambda s: chunk_plan(s, 3, 1),
                    step_fn=lambda st, k: {"q": st["q"] + k}, guard=guard, status=status)
    doc = tstatus.read_status(path)
    assert doc["health"] == {"checks": 6, "faults": 0, "rollbacks": 0}


def test_live_flags_and_epilogue(tmp_path):
    """The apps' live flags: --live-config validated and canonicalized at
    parse time, the pair built, the anomaly-count gauge and the outcome."""
    import argparse

    from stencil_tpu_torch.apps import _bench_common as bc

    p = argparse.ArgumentParser()
    bc.add_live_flags(p)
    cfg = tmp_path / "live.json"
    cfg.write_text(json.dumps({"*": {"min_history": 2}}))
    args = p.parse_args(["--live-sentinel", "--live-config", str(cfg),
                         "--status-file", str(tmp_path / "st.json")])
    assert bc.canonicalize_live_config(args) == {"*": {"min_history": 2}}
    assert args.live_config == json.dumps({"*": {"min_history": 2}})
    for bad in ('{"k": {"window": 1, "min_history": 3}}', "[1]", str(tmp_path / "nope.json")):
        with pytest.raises((OSError, ValueError)):
            bc.load_live_config(bad)
    sink = io.StringIO()
    rec = ttel.Recorder(sink=sink)
    sent, status = bc.make_live(args, rec, "jacobi3d")
    assert sent.windows == {} and sent._window("k_s", "s").min_history == 2
    bc.finish_live(rec, sent, status, outcome="done")
    assert [r["name"] for r in records(sink)] == ["live.anomaly_count"]
    doc = tstatus.read_status(str(tmp_path / "st.json"))
    assert doc["outcome"] == "done" and doc["app"] == "jacobi3d"


def test_jacobi3d_cli_live_flags_refuse_bad_config(tmp_path, capsys):
    from stencil_tpu_torch.apps import jacobi3d

    with pytest.raises(SystemExit):
        jacobi3d.main(["--device", "cpu", "--live-config", '{"k": {"min_history": 0}}'])
    assert "bad --live-config" in capsys.readouterr().err
