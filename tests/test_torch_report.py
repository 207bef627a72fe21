"""apps/report against the JAX tool: the same stdout, stderr and exit code
on the same metrics files for every mode (tables, --markdown, --p99,
--baseline, --validate with and without --ledger, --trace-out, --out,
--status, --follow, the ignored-flag warnings), over a synthesized story,
the port's jacobi3d metrics file and the JAX app's; the serve gauges'
priority split; and the port's jacobi3d recording the JAX app's records."""

import json
import os
import time

import jax
import pytest
import torch

from stencil_tpu.apps import jacobi3d as jax_jacobi3d
from stencil_tpu.apps import report as jax_report
from stencil_tpu.obs import telemetry as jax_telemetry
from stencil_tpu_torch.apps import jacobi3d, report
from stencil_tpu_torch.obs import ledger, status, telemetry

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rec(kind, name, t, run="R1", proc=0, **fields):
    r = {"v": 1, "run": run, "proc": proc, "kind": kind, "name": name, "t": t}
    r.update(fields)
    return r


STORY = [
    _rec("meta", "config", 100.0, app="jacobi3d", config={"x": 24}),
    _rec("span", "jacobi.iter", 101.0, seconds=0.25, phase="step", app="jacobi3d", iters=5),
    _rec("span", "jacobi.iter", 101.5, seconds=0.5, phase="step", proc=1, iters=5),
    _rec("span", "jacobi.iter", 102.5, seconds=0.125, phase="step", iters=5),
    _rec("span", "exchange.iter", 103.0, seconds=1e-3, phase="exchange", method="direct26"),
    _rec("span", "exchange.iter", 103.1, seconds=2e-3, phase="exchange",
         method="axis-composed", batched=True),
    _rec("counter", "fault.injected", 101.6, value=1, step=3, fault_kind="nan"),
    _rec("counter", "exchange.bytes_logical", 101.7, bytes=4096),
    _rec("counter", "exchange.bytes_logical", 101.8, bytes=8192),
    _rec("counter", "census.collective-permute", 101.9, value=6, bytes=1024),
    _rec("gauge", "jacobi.mcells_per_s", 103.0, value=42.0),
    _rec("gauge", "jacobi.mcells_per_s", 103.2, value=44.5),
    _rec("gauge", "serve.p99_ms", 103.3, value=9.5, priority="high"),
    _rec("gauge", "serve.p99_ms", 103.4, value=31.0, priority="low"),
    _rec("gauge", "serve.p99_ms", 103.5, value=20.0),
    _rec("gauge", "campaign.step_latency_s", 103.6, value=0.01, mode="batched"),
    _rec("gauge", "wire_ab.bytes_ratio", 103.7, value=2.0, wire="bfloat16"),
    _rec("gauge", "fused.overlap_fraction", 103.8, value=0.4, variant="fused"),
    _rec("heartbeat", "hb", 103.5, seq=7),
    _rec("span", "jacobi.iter", 104.0, seconds=0.8, run="R2"),
]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The story, the port's jacobi3d metrics (CPU, guarded: nan injected
    and rolled back), the JAX app's, a file with schema errors, ledgers,
    a baseline map and a status snapshot."""
    d = tmp_path_factory.mktemp("report")
    story = d / "story.jsonl"
    story.write_text("\n".join(json.dumps(r) for r in STORY) + "\n")
    port = str(d / "port.jsonl")
    try:
        assert jacobi3d.main(["--x", "12", "--y", "12", "--z", "12", "--iters", "6",
                              "--no-weak", "--device", "cpu", "--health-every", "2",
                              "--inject", "nan@3", "--rollback-backoff", "0",
                              "--ckpt-dir", str(d / "ck"), "--ckpt-every", "2",
                              "--metrics-out", port]) == 0
    finally:
        telemetry.configure()
    jx = str(d / "jax.jsonl")
    jax_telemetry.configure(metrics_out=jx, app="jacobi3d")
    try:
        jax_jacobi3d.run(12, 12, 12, iters=6, weak=False, devices=jax.devices()[:1])
    finally:
        jax_telemetry.configure(metrics_out=None)
    bad = d / "bad.jsonl"
    bad.write_text(story.read_text() + '{"v": 1}\nnot json\n\n'
                   + json.dumps(_rec("gauge", "g", 1.0)) + "\n")
    led = str(d / "L.jsonl")
    ledger.append_entries(led, [ledger.make_entry("leg", 1.0, label="r01", platform="cpu",
                                                  config={"c": 1}, t=5.0)])
    torn = d / "torn.jsonl"
    torn.write_text(open(led).read() + "{torn\n")
    flat = d / "flat.json"
    flat.write_text(json.dumps({"a": {"mcells_per_s": 40.0}, "b": {"mcells_per_s": 50.0},
                                "jacobi.mcells_per_s_per_dev": 2.0,
                                "exchange": {"gb_per_s": 10.0}, "zero": {"trimean_s": 0}}))
    st = str(d / "status.json")
    w = status.StatusWriter(st, app="jacobi3d", run="RUN", clock=lambda: 1000.0)
    w.update(step=30, iters=100, per_step_s=0.0125,
             health={"checks": 3, "faults": 1, "rollbacks": 1},
             anomalies={"active": [{"metric": "jacobi.iter", "step": 20, "value": 0.5,
                                     "lo": 0.1, "hi": 0.2, "direction": "lower"}],
                        "detected": 2, "cleared": 1},
             lanes=[{"lane": 0, "tenant": "t1", "step": 3, "steps": 10, "p50_ms": 1.5,
                     "p99_ms": 3.0, "deadline_ms": 9.0, "slo": "ok"}],
             queue={"depth": 2, "admitted": 5, "rejected": 1, "backfills": 0})
    hb = d / "hb"
    hb.write_text("1")
    os.utime(hb, (990.0, 990.0))
    return {"story": str(story), "port": port, "jax": jx, "bad": str(bad), "ledger": led,
            "torn": str(torn), "missing": str(d / "TYPO.jsonl"), "flat": str(flat),
            "baseline": os.path.join(REPO, "BASELINE.json"), "status": st, "hb": str(hb),
            "dir": str(d)}


def _both(argv, capsys, monkeypatch, artefact=None):
    """Run both tools on ``argv`` with the clock pinned; return the port's
    (rc, out, err) after holding it equal to the JAX tool's, and the
    artefact each wrote (if named) equal too."""
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    monkeypatch.setattr(time, "strftime", lambda *a: "12:00:00")
    got = []
    for main in (jax_report.main, report.main):
        if artefact and os.path.exists(artefact):
            os.remove(artefact)
        rc = main(list(argv))
        cap = capsys.readouterr()
        got.append((rc, cap.out, cap.err,
                    open(artefact, "rb").read() if artefact and os.path.exists(artefact)
                    else None))
    assert got[1] == got[0]
    return got[1]


SOURCES = {"story": ["story"], "port": ["port"], "jax": ["jax"],
           "all": ["story", "port", "jax"]}
MODES = {"tables": [], "markdown": ["--markdown"], "p99": ["--p99"],
         "markdown_p99": ["--markdown", "--p99"], "validate": ["--validate"]}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("source", sorted(SOURCES))
def test_report_equals_the_jax_tool(files, capsys, monkeypatch, source, mode):
    rc, out, _err, _a = _both([files[k] for k in SOURCES[source]] + MODES[mode], capsys,
                              monkeypatch)
    assert rc == 0
    if source in ("port", "all") and mode in ("tables", "p99"):
        assert "jacobi.iter,step," in out  # the chunk spans
        assert "jacobi.mcells_per_s," in out


@pytest.mark.parametrize("baseline", ["baseline", "flat"])
@pytest.mark.parametrize("markdown", [False, True])
def test_report_baseline(files, capsys, monkeypatch, baseline, markdown):
    argv = [files["story"], files["port"], "--baseline", files[baseline]]
    _both(argv + (["--markdown"] if markdown else []), capsys, monkeypatch)


@pytest.mark.parametrize("ledger_case,want_rc", [("ledger", 0), ("torn", 1), ("missing", 1)])
def test_report_validate_ledger(files, capsys, monkeypatch, ledger_case, want_rc):
    rc, out, _e, _a = _both([files["port"], "--validate", "--ledger", files[ledger_case]],
                            capsys, monkeypatch)
    assert rc == want_rc
    assert ("LEDGER" in out) if want_rc else ("1 valid entries" in out)


def test_report_schema_errors(files, capsys, monkeypatch):
    rc, out, _e, _a = _both([files["bad"]], capsys, monkeypatch)
    assert rc == 1 and "SCHEMA:" in out
    rc, out, _e, _a = _both([files["bad"], "--validate"], capsys, monkeypatch)
    assert rc == 1


@pytest.mark.parametrize("source", ["story", "port"])
def test_report_trace_out_and_out(files, capsys, monkeypatch, source):
    t = os.path.join(files["dir"], "trace.json")
    rc, out, _e, data = _both([files[source], "--trace-out", t], capsys, monkeypatch,
                              artefact=t)
    assert rc == 0 and "# trace:" in out and data
    o = os.path.join(files["dir"], "out.txt")
    _both([files[source], "--markdown", "--out", o], capsys, monkeypatch, artefact=o)


@pytest.mark.parametrize("argv", [
    ["{story}", "--validate", "--trace-out", "{dir}/t.json", "--baseline", "{flat}",
     "--out", "{dir}/o.txt"],
    ["{story}", "--ledger", "{ledger}"],
    ["{story}", "--follow", "--follow-count", "1", "--trace-out", "{dir}/t.json",
     "--validate", "--ledger", "{ledger}", "--baseline", "{flat}", "--out", "{dir}/o"],
    ["--status", "{status}", "--validate", "--ledger", "{ledger}", "--trace-out",
     "{dir}/t.json", "--baseline", "{flat}", "--out", "{dir}/o", "{story}"],
], ids=["validate", "report_ledger", "follow", "status"])
def test_report_ignored_flag_warnings(files, capsys, monkeypatch, argv):
    _rc, _out, err, _a = _both([a.format(**files) for a in argv], capsys, monkeypatch)
    assert "ignores" in err


@pytest.mark.parametrize("extra", [[], ["--markdown", "--p99"], ["--heartbeat", "{hb}"],
                                   ["--heartbeat", "{missing}"]],
                         ids=["plain", "markdown_p99", "heartbeat", "heartbeat_missing"])
def test_report_follow_once(files, capsys, monkeypatch, extra):
    argv = [files["story"], files["port"], files["missing"], "--follow", "--follow-count",
            "1"] + [a.format(**files) for a in extra]
    rc, out, _e, _a = _both(argv, capsys, monkeypatch)
    assert rc == 0 and out.startswith("-- follow #1 @ 12:00:00 · 2/3 file(s)")


def test_report_follow_heartbeat_env(files, capsys, monkeypatch):
    monkeypatch.setenv(report.HEARTBEAT_FILE_ENV, files["hb"])
    rc, out, _e, _a = _both([files["missing"], "--follow", "--follow-count", "1"], capsys,
                            monkeypatch)
    assert "heartbeat: 10.0s ago" in out and "waiting for records" in out


@pytest.mark.parametrize("follow", [False, True])
@pytest.mark.parametrize("which", ["status", "missing"])
def test_report_status(files, capsys, monkeypatch, follow, which):
    argv = ["--status", files[which]] + (["--follow", "--follow-count", "1"] if follow else [])
    rc, out, _e, _a = _both(argv, capsys, monkeypatch)
    if which == "status":
        assert rc == 0 and "run RUN (jacobi3d) · step 30/100" in out
    else:
        assert rc == (0 if follow else 1) and "waiting for a status snapshot" in out


def test_report_usage_error(capsys):
    for main in (jax_report.main, report.main):
        with pytest.raises(SystemExit) as e:
            main([])
        assert e.value.code == 2
    capsys.readouterr()


@pytest.mark.parametrize("rec", [
    {"name": "serve.p99_ms", "priority": "high"},
    {"name": "serve.p99_ms", "priority": "low"},
    {"name": "serve.p99_ms"},
    {"name": "exchange.iter", "method": "direct26", "batched": False, "wire": "bfloat16",
     "variant": "fused", "mode": "ab"},
], ids=["high", "low", "plain", "every_tag"])
def test_agg_key_priority_split(rec):
    assert report._agg_key(rec) == jax_report._agg_key(rec)


def test_port_jacobi3d_records_the_jax_apps_records(files):
    """The port's jacobi3d metrics carry every jacobi.* record name the JAX
    app writes (the chunk spans and the closing gauges among them)."""
    def names(path):
        with open(path) as f:
            return {(r["kind"], r["name"]) for r in map(json.loads, f) if
                    r["name"].startswith("jacobi.")}
    assert names(files["jax"]) <= names(files["port"])
    assert ("span", "jacobi.iter") in names(files["port"])
