"""apps/perf_tool against the JAX tool: the cases of the JAX package's
tests/test_perf_tool.py, each run through both CLIs on the same ledger,
with equal stdout, stderr and exit code (and, for ingest, equal ledger
entries but their time stamps), plus the drift subcommand on a port run's
metrics file and the committed LEDGER.jsonl rendered read-only."""

import io
import json
import os
import shutil

import pytest
import torch

from stencil_tpu.apps import perf_tool as jax_perf_tool
from stencil_tpu.obs import ledger as jax_ledger
from stencil_tpu_torch.apps import jacobi3d, perf_tool
from stencil_tpu_torch.obs import ledger, telemetry

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seed(path, metric, values, labels=None, unit=None):
    es = []
    for i, v in enumerate(values):
        lbl = labels[i] if labels else f"h{i:02d}"
        es.append(ledger.make_entry(metric, v, label=lbl, unit=unit, platform="cpu",
                                    config={"c": 1}))
    ledger.append_entries(path, es)


def _entries(path):
    if not os.path.exists(path):
        return None
    return [{k: v for k, v in e.items() if k != "t"} for e in ledger.load_ledger(path)]


class Both:
    """Runs one argv through the JAX CLI and the port's and holds their
    stdout, stderr, exit code and ledger (if ``led`` is given: restored to
    its state before the JAX run for the port's) equal."""

    def __init__(self, capsys):
        self.capsys = capsys

    def __call__(self, argv, led=None):
        before = open(led, "rb").read() if led and os.path.exists(led) else None
        got = []
        for main in (jax_perf_tool.main, perf_tool.main):
            if led:
                if before is None:
                    if os.path.exists(led):
                        os.remove(led)
                else:
                    with open(led, "wb") as f:
                        f.write(before)
            try:
                rc = main(list(argv))
            except SystemExit as e:
                rc = ("exit", e.code)
            cap = self.capsys.readouterr()
            got.append((rc, cap.out, cap.err, _entries(led) if led else None))
        assert got[1] == got[0]
        return got[1][:3]


@pytest.fixture
def both(capsys):
    return Both(capsys)


def _gate_low(led, both):
    _seed(led, "leg_gb_per_s", [10.0, 10.4, 9.8])
    _seed(led, "leg_gb_per_s", [5.0], labels=["new"])
    rc, out, _e = both(["gate", "--ledger", led, "--metric", "leg_gb_per_s", "--label", "new",
                        "--rel-tol", "0.2"])
    assert rc == 1 and "GATE FAIL leg_gb_per_s" in out and "below" in out
    _seed(led, "leg_gb_per_s", [20.0], labels=["fast"])
    assert both(["gate", "--ledger", led, "--metric", "leg_gb_per_s", "--label", "fast",
                 "--rel-tol", "0.2"])[0] == 0


def _gate_high(led, both):
    _seed(led, "loop_wall_s", [1.0, 1.05, 0.97], unit="s")
    _seed(led, "loop_wall_s", [4.0], labels=["new"], unit="s")
    rc, out, _e = both(["gate", "--ledger", led, "--metric", "loop_wall_s", "--label", "new",
                        "--rel-tol", "0.2"])
    assert rc == 1 and "above" in out
    _seed(led, "loop_wall_s", [0.5], labels=["fast"], unit="s")
    assert both(["gate", "--ledger", led, "--metric", "loop_wall_s", "--label", "fast",
                 "--rel-tol", "0.2"])[0] == 0


def _gate_pass_and_skip(led, both):
    _seed(led, "leg_gb_per_s", [10.0, 10.4, 9.8])
    _seed(led, "leg_gb_per_s", [10.1], labels=["new"])
    rc, out, _e = both(["gate", "--ledger", led, "--metric", "leg_gb_per_s", "--label", "new",
                        "--rel-tol", "0.2"])
    assert rc == 0 and "GATE PASS leg_gb_per_s" in out
    led2 = led + ".2"
    _seed(led2, "lonely", [1.0], labels=["only"])
    rc, out, _e = both(["gate", "--ledger", led2, "--metric", "lonely", "--label", "only"])
    assert rc == 2 and "SKIP" in out


def _leg_config(led, both):
    _seed(led, "leg_gb_per_s", [10.0, 10.2])
    _seed(led, "leg_gb_per_s", [5.0], labels=["new"])
    cfg = led + ".legs.json"
    with open(cfg, "w") as f:
        json.dump({"leg_gb_per_s": {"rel_tol": 0.9}}, f)
    assert both(["gate", "--ledger", led, "--metric", "leg_gb_per_s", "--label", "new",
                 "--rel-tol", "0.1", "--leg-config", cfg])[0] == 0
    with open(cfg, "w") as f:
        json.dump({"*": {"direction": "both", "rel_tol": 0.05}}, f)
    _seed(led, "leg_gb_per_s", [17.0], labels=["hot"])
    assert both(["gate", "--ledger", led, "--metric", "leg_gb_per_s", "--label", "hot",
                 "--leg-config", cfg])[0] == 1


def _trend_diff(led, both):
    _seed(led, "leg", [10.0, 20.0], labels=["r01", "r02"], unit="GB/s")
    rc, out, _e = both(["trend", "--ledger", led])
    assert rc == 0 and "2.000x" in out
    for extra in (["--markdown"], ["--json"], ["--json", "--markdown"], ["--out", led + ".o"],
                  ["--json", "--out", led + ".json"], ["--metric", "leg", "--platform", "cpu"]):
        assert both(["trend", "--ledger", led] + extra)[0] == 0
    rc, out, _e = both(["diff", "--ledger", led, "--a", "r01", "--b", "r02"])
    assert rc == 0 and "2.000" in out
    both(["diff", "--ledger", led, "--a", "r01", "--b", "nope", "--markdown"])


def _render(led, both):
    _seed(led, "leg_gb_per_s", [10.0, 10.3], labels=["r01", "r02"])
    _seed(led, "loop_s", [1.0, 3.0], labels=["r01", "r02"], unit="s")
    rc, out, _e = both(["render", "--ledger", led, "--out", led + ".md"])
    assert rc == 0 and "## Regression sentinel" in out and "## Trends" in out


def _ingest_legacy(led, both):
    argv = ["ingest", "--ledger", led, "--legacy",
            os.path.join(REPO, "BENCH_r05.json"), os.path.join(REPO, "MULTICHIP_r05.json")]
    assert both(argv, led=led)[0] == 0
    jax_perf_tool.main(argv)  # the ledger both start from next
    both.capsys.readouterr()
    rc, out, _e = both(argv, led=led)  # re-ingest: nothing new
    assert rc == 0 and "appended 0 new entries" in out


def _ingest_all_rounds(led, both):
    paths = [os.path.join(REPO, f"{k}_r0{n}.json") for k in ("BENCH", "MULTICHIP")
             for n in range(1, 6)]
    assert both(["ingest", "--ledger", led, "--legacy"] + paths, led=led)[0] == 0


def _recorder_file(path, run, values, name="leg.wall_s", config=True):
    buf = io.StringIO()
    rec = telemetry.Recorder(sink=buf, app="t", run_id=run)
    if config:
        rec.meta("config", config={"x": 24})
    for v in values:
        rec.gauge(name, v, unit="s")
    with open(path, "w") as f:
        f.write(buf.getvalue())
    return buf.getvalue()


def _ingest_metrics(led, both):
    m = led + ".m.jsonl"
    text = _recorder_file(m, "RUN", (1.0, 1.1, 0.9))
    assert both(["ingest", "--ledger", led, "--label", "run1", "--platform", "cpu", m],
                led=led)[0] == 0
    with open(m, "w") as f:
        f.write(text + '{"v": 1}\n')
    with pytest.raises(ValueError) as a:
        jax_perf_tool.ingest_file(m, label="run2")
    with pytest.raises(ValueError) as b:
        perf_tool.ingest_file(m, label="run2")
    assert str(a.value) == str(b.value) and "missing required key" in str(b.value)


def _ingest_shapes(led, both):
    odd = led + ".odd.json"
    with open(odd, "w") as f:
        json.dump({"what": "is this"}, f)
    for fn in (jax_perf_tool.ingest_file, perf_tool.ingest_file):
        with pytest.raises(ValueError, match="unrecognized payload shape"):
            fn(odd)
    one = led + ".one.jsonl"
    with open(one, "w") as f:
        f.write(json.dumps({"v": 1, "run": "R", "proc": 0, "kind": "gauge", "name": "leg.s",
                            "t": 0.0, "value": 2.5, "unit": "s"}) + "\n")
    es = perf_tool.ingest_file(one, label="run1", platform="cpu")
    assert es == jax_perf_tool.ingest_file(one, label="run1", platform="cpu")
    payload = led + ".payload_r07.json"
    with open(payload, "w") as f:
        json.dump({"metric": "leg_mcells_per_s", "value": 5.0, "vs_baseline": 0.5,
                   "detail": {"platform": "cuda", "size": 64, "x_ms": 1.0}}, f)
    assert both(["ingest", "--ledger", led, "--rev", "abc", payload, one], led=led)[0] == 0
    mc = led + ".multichip.json"
    with open(mc, "w") as f:
        json.dump({"n_devices": 8, "ok": True, "rc": 0}, f)
    for fn in (jax_perf_tool.ingest_file, perf_tool.ingest_file):
        with pytest.raises(ValueError, match="carries no round number"):
            fn(mc)


def _backfill_order(led, both):
    _seed(led, "leg", [10.0, 30.0], labels=["r01", "r05"])
    _seed(led, "leg", [20.0], labels=["r03"])
    es = ledger.load_ledger(led)
    got = perf_tool.groups(es)
    assert got == jax_perf_tool.groups(es)
    assert [e["label"] for e in next(iter(got.values()))] == ["r01", "r03", "r05"]
    assert perf_tool.evaluate_gate(es, metrics=["leg"], rel_tol=9.0) == \
        jax_perf_tool.evaluate_gate(es, metrics=["leg"], rel_tol=9.0)
    rc, out, _e = both(["trend", "--ledger", led])
    assert out.index("r03") < out.index("r05")


def _one_label_many_files(led, both):
    paths = []
    for i, v in enumerate((1.0, 9.0)):
        p = f"{led}.m{i}.jsonl"
        _recorder_file(p, f"R{i}", (v,), name="leg.s", config=False)
        paths.append(p)
    rc, _out, err = both(["ingest", "--ledger", led, "--label", "day1", "--platform", "cpu"]
                         + paths, led=led)
    assert rc == 0 and "WARNING" in err


def _live_label_order(led, both):
    _seed(led, "leg", [100.0, 110.0, 105.0], labels=["r01", "r02", "r05"])
    _seed(led, "leg", [50.0], labels=["bench-20260803T120000"])
    rc, out, _e = both(["gate", "--ledger", led, "--metric", "leg", "--rel-tol", "0.2"])
    assert rc == 1 and "bench-20260803T120000" in out
    rc, out, _e = both(["trend", "--ledger", led])
    assert out.index("r05") < out.index("bench-20260803T120000")


def _missing_ledger(led, both):
    typo = led + ".TYPO"
    for argv in (["trend", "--ledger", typo], ["diff", "--ledger", typo, "--a", "x", "--b", "y"],
                 ["gate", "--ledger", typo], ["render", "--ledger", typo]):
        rc, _out, err = both(argv)
        assert rc == 2 and "no such ledger" in err


def _outage_round(led, both):
    healthy = {"metric": "leg_mcells_per_s", "value": 100.0,
               "detail": {"platform": "tpu", "size": 512}}
    outage = {"metric": "leg_mcells_per_s", "value": 0.0, "vs_baseline": 0.0,
              "detail": {"error": "all bench children failed"}}
    es = []
    for i in range(3):
        es += ledger.entries_from_bench_payload(healthy, label=f"r{i + 1:02d}")
    es += ledger.entries_from_bench_payload(outage, label="r04")
    ledger.append_entries(led, es)
    rc, out, _e = both(["trend", "--ledger", led, "--metric", "leg_mcells_per_s"])
    assert rc == 0 and "r04,0," in out
    assert both(["gate", "--ledger", led, "--metric", "leg_mcells_per_s"])[0] == 1
    assert both(["render", "--ledger", led])[0] == 0


def _platform_filter(led, both):
    ledger.append_entries(led, [
        ledger.make_entry("multichip_dryrun_ok", 1.0, label=f"r{i + 1:02d}",
                          platform="unknown", config={"n_devices": 8}) for i in range(3)])
    rc, out, _e = both(["trend", "--ledger", led, "--platform", "tpu"])
    assert rc == 0 and "multichip_dryrun_ok" in out
    both(["gate", "--ledger", led, "--platform", "tpu"])


def _markdown_flags(led, both):
    _seed(led, "leg", [1.0, 1.0], labels=["r01", "r02"])
    for argv in (["gate", "--ledger", led, "--markdown"],
                 ["render", "--ledger", led, "--markdown"]):
        assert both(argv)[0] == ("exit", 2)
    assert both(["trend", "--ledger", led, "--markdown"])[0] == 0
    assert both(["diff", "--ledger", led, "--a", "r01", "--b", "r02", "--markdown"])[0] == 0
    assert both(["nope"])[0] == ("exit", 2)


def _bad_leg_config(led, both):
    _seed(led, "leg", [1.0, 1.0, 1.0])
    bad = led + ".bad.json"
    for text in (None, "{not json", "[1, 2]"):
        if text is not None:
            with open(bad, "w") as f:
                f.write(text)
        rc, _out, err = both(["gate", "--ledger", led, "--leg-config",
                              bad if text is not None else led + ".TYPO.json"])
        assert rc == 2 and "bad --leg-config" in err


CASES = {f.__name__.lstrip("_"): f for f in (
    _gate_low, _gate_high, _gate_pass_and_skip, _leg_config, _trend_diff, _render,
    _ingest_legacy, _ingest_all_rounds, _ingest_metrics, _ingest_shapes, _backfill_order,
    _one_label_many_files, _live_label_order, _missing_ledger, _outage_round,
    _platform_filter, _markdown_flags, _bad_leg_config)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_perf_tool_equals_the_jax_tool(tmp_path, both, case):
    CASES[case](str(tmp_path / "L.jsonl"), both)


def test_gate_mad_band_and_directions():
    es = [ledger.make_entry("m", v, label=f"h{i}", platform="cpu", config={"c": 1})
          for i, v in enumerate([10.0, 10.1, 9.9, 10.05])]
    es.append(ledger.make_entry("m", 9.0, label="new", platform="cpu", config={"c": 1}))
    kw = dict(metrics=["m"], label="new", rel_tol=0.0, mad_k=3.0)
    got = perf_tool.evaluate_gate(es, **kw)
    assert got == jax_perf_tool.evaluate_gate(es, **kw)
    assert got[0]["status"] == "fail"
    assert perf_tool.gate_report(got) == jax_perf_tool.gate_report(got)
    for metric, unit in (("exchange.gb_per_s", None), ("jacobi.loop_wall_s", "s"),
                         ("jacobi.iter_trimean_s", None), ("astaroth_512_iter_ms", None),
                         ("bench.rc", "rc"), ("exchange.trimean_s[direct26]", None)):
        assert perf_tool.default_direction(metric, unit) == \
            jax_perf_tool.default_direction(metric, unit)


@pytest.mark.parametrize("name", ["BENCH_r03.json", "MULTICHIP_r05.json", "bench_128.json",
                                  "payload.json", "x_r12.jsonl"])
def test_label_from_filename(name):
    assert perf_tool._label_from_filename(name) == jax_perf_tool._label_from_filename(name)


@pytest.mark.parametrize("metric", [None, "jacobi3d_512_mcells_per_s_per_chip", "bench.rc",
                                    "multichip_dryrun_ok"])
def test_committed_ledger_read_only(tmp_path, both, metric):
    """The committed LEDGER.jsonl, copied: trend (tables and JSON), gate and
    render equal, the file itself never written."""
    led = str(tmp_path / "LEDGER.jsonl")
    shutil.copy(os.path.join(REPO, "LEDGER.jsonl"), led)
    before = open(led, "rb").read()
    sel = ["--metric", metric] if metric else []
    rc, out, _e = both(["trend", "--ledger", led] + sel)
    assert rc == 0
    if metric == "jacobi3d_512_mcells_per_s_per_chip":
        assert "r05" in out and "83059.7" in out
    both(["trend", "--ledger", led, "--json"] + sel)
    both(["gate", "--ledger", led] + sel)
    both(["render", "--ledger", led])
    assert open(led, "rb").read() == before
    assert ledger.load_ledger(led) == jax_ledger.load_ledger(led)


@pytest.fixture(scope="module")
def port_metrics(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("drift") / "m.jsonl")
    try:
        assert jacobi3d.main(["--x", "12", "--y", "12", "--z", "12", "--iters", "6",
                              "--no-weak", "--device", "cpu", "--metrics-out", path]) == 0
    finally:
        telemetry.configure()
    return path


@pytest.mark.parametrize("extra", [[], ["--rel-tol", "0.99", "--mad-k", "50"],
                                   ["--phase", "jacobi.exchange"], ["--phase", "nope"]],
                         ids=["default", "wide", "phase", "no_phase"])
def test_drift_on_a_port_run(both, port_metrics, extra):
    rc, out, err = both(["drift", "--metrics", port_metrics] + extra)
    if extra[-1:] == ["nope"]:
        assert rc == 2 and "judged nothing" in err
    else:
        assert rc in (0, 1) and "DRIFT" in out


def test_drift_usage_errors(tmp_path, both):
    assert both(["drift", "--metrics", str(tmp_path / "TYPO")])[0] == 2
    bad = tmp_path / "bad.jsonl"
    bad.write_text("not json\n")
    assert both(["drift", "--metrics", str(bad)])[0] == 2
    bad.write_text('{"v": 1}\n')
    assert both(["drift", "--metrics", str(bad)])[0] == 2
