"""The port's refit and measure steps (stencil_tpu_torch/plan/calibrate.py,
obs/attribution.py) against the JAX package's on the CPU platform: fit on
the same samples gives the same row apart from ``written_t`` (overheads and
bandwidth recovered, the pinned-bandwidth case, the refusals); the same
metrics records give the same samples; predict_exchange, judge_drift,
phases_from_records and ledger_detail agree; attribution records validate
under both packages' schemas; plan_tool calibrate writes the row the fit
gives, for "cpu" and for "cuda" (whose per-copy constant lands in
``dma_overhead_s``). No device. Tolerance: exact equality, except the
recovered constants of synthetic data (rel 1e-6)."""

import json

import pytest

import stencil_tpu.obs.attribution as jattr
import stencil_tpu.obs.telemetry as jtel
import stencil_tpu.plan.calibrate as jcal
import stencil_tpu.plan.ir as jir
import stencil_tpu_torch.obs.attribution as tattr
import stencil_tpu_torch.obs.telemetry as ttel
import stencil_tpu_torch.plan.calibrate as tcal
import stencil_tpu_torch.plan.ir as tir
from stencil_tpu.geometry import Dim3 as JDim3, Radius as JRadius
from stencil_tpu_torch.apps import plan_tool
from stencil_tpu_torch.geometry import Dim3, Radius
from stencil_tpu_torch.plan import db as tdb
from stencil_tpu_torch.plan.cost import PLATFORM_CALIBRATION


def samples(mod, truth, bw, points):
    return [mod.Sample(method=m, collectives=c, wire_bytes=b, measured_s=oh * c + b / bw)
            for m, oh in truth.items() for c, b in points]


def untimed(row):
    return {k: v for k, v in row.items() if k != "written_t"}


POINTS = ((2, 100_000), (4, 400_000), (6, 1_200_000), (26, 2_400_000))


@pytest.mark.parametrize("truth", [
    {"axis-composed": 5e-4, "direct26": 2e-3},
    {"remote-dma": 3e-5},
    {"axis-composed": 7e-4, "remote-dma": 4e-3, "direct26": 1.5e-3},
])
def test_fit_matches_jax(truth):
    t = tcal.fit(samples(tcal, truth, 5e8, POINTS), platform="cpu")
    j = jcal.fit(samples(jcal, truth, 5e8, POINTS), platform="cpu")
    assert untimed(t) == untimed(j)
    assert t["bandwidth_fit"] and t["r2"] == pytest.approx(1.0, abs=1e-9)
    assert t["calibration"]["wire_bytes_per_s"] == pytest.approx(5e8, rel=1e-6)
    assert tcal.diff_rows(t) == jcal.diff_rows(j)


def test_fit_pinned_bandwidth_matches_jax():
    pts = ((2, 200_000),) * 3
    t = tcal.fit(samples(tcal, {"axis-composed": 6.6e-4}, 3.9e8, pts))
    j = jcal.fit(samples(jcal, {"axis-composed": 6.6e-4}, 3.9e8, pts))
    assert untimed(t) == untimed(j) and not t["bandwidth_fit"]


@pytest.mark.parametrize("bad", [
    [("axis-composed", 2, 1000, 1e-3)],
    [("axis-composed", 0, 1000, 1e-3), ("axis-composed", 2, 1000, 2e-3)],
    [("axis-composed", 2, 1000, 1e-9), ("axis-composed", 4, 10_000_000, 1e-9)],
    [("axis-composed", 2, 1000, float("nan")), ("axis-composed", 4, 1000, 1e-3)],
])
def test_fit_refusals_match_jax(bad):
    for mod in (tcal, jcal):
        with pytest.raises(mod.CalibrationError):
            mod.fit([mod.Sample(*s) for s in bad])


def test_cuda_fit_lands_in_dma_overhead():
    row = tcal.fit(samples(tcal, {"remote-dma": 3e-5}, 2e11, POINTS), platform="cuda")
    rd = row["calibration"]["remote_dma"]
    assert rd["dma_overhead_s"] == pytest.approx(3e-5, rel=1e-6)
    assert "cpu_emulation_overhead_s" not in rd and row["platform"] == "cuda"
    assert rd["wire_bytes_per_s"] == row["calibration"]["wire_bytes_per_s"]
    names = [n for n, _f, _b in tcal.diff_rows(row)]
    assert names == ["remote_dma.dma_overhead_s", "wire_bytes_per_s"]


def configs(platform="cpu"):
    return (tir.PlanConfig.make(Dim3(24, 24, 24), Radius.constant(2), ["float32"] * 4, 8,
                                platform),
            jir.PlanConfig.make(JDim3(24, 24, 24), JRadius.constant(2), ["float32"] * 4, 8,
                                platform))


CHOICES = [dict(partition=(2, 2, 2), method="axis-composed"),
           dict(partition=(2, 2, 2), method="direct26", batch_quantities=False),
           dict(partition=(1, 2, 4), method="remote-dma"),
           dict(partition=(2, 2, 2), method="remote-dma", kernel_variant="fused"),
           dict(partition=(8, 1, 1), method="axis-composed")]


@pytest.mark.parametrize("kw", CHOICES)
@pytest.mark.parametrize("cal", [None, {"wire_bytes_per_s": 1e9, "provenance": "fitted(x)"}])
def test_predict_exchange_and_ledger_detail_match_jax(kw, cal):
    tc, jc = configs()
    t = tattr.predict_exchange(tc, tir.PlanChoice(**kw), cal)
    j = jattr.predict_exchange(jc, jir.PlanChoice(**kw), cal)
    assert (t is None) == (j is None)
    if t is not None:
        assert (t.method, t.predicted_s, t.collectives, t.wire_bytes, t.provenance) == \
            (j.method, j.predicted_s, j.collectives, j.wire_bytes, j.provenance)
        assert tattr.ledger_detail(t, phase="p", samples=3) == \
            jattr.ledger_detail(j, phase="p", samples=3)


@pytest.mark.parametrize("predicted,samples_s,rel", [
    (2.9e-3, [1.0e-3, 1.3e-3, 0.9e-3, 1.1e-3, 1.2e-3], 0.75),
    (0.0112, [0.015, 0.016, 0.017], 0.75),
    (0.0112, [0.15, 0.16, 0.17], 0.75),
    (1.0, [1.0, 1.01, 0.99], 0.05),
])
def test_judge_drift_matches_jax(predicted, samples_s, rel):
    t = tattr.judge_drift("p", predicted, samples_s, rel_tol=rel)
    j = jattr.judge_drift("p", predicted, samples_s, rel_tol=rel)
    assert (t.ok, t.center, t.lo, t.hi, t.n, t.describe()) == \
        (j.ok, j.center, j.lo, j.hi, j.n, j.describe())


def test_attribution_records_validate_and_round_trip(tmp_path):
    path = str(tmp_path / "m.jsonl")
    rec = ttel.Recorder(path, app="t", run_id="r1")
    tc, jc = configs()
    for kw in CHOICES:
        tattr.attribute_and_judge(rec, tc, tir.PlanChoice(**kw), [2e-3, 2.1e-3, 1.9e-3],
                                  phase="exchange.iter", fabric={"platform": "cpu"})
    rec.meta("plan.fingerprint", fingerprint="abc", choice="x", calibration="modeled(default)")
    rec.close()
    lines = open(path).readlines()
    assert ttel.validate_jsonl(lines)[1] == [] and jtel.validate_jsonl(lines)[1] == []
    records = [json.loads(ln) for ln in lines]
    ts, js = tcal.samples_from_records(records), jcal.samples_from_records(records)
    assert [vars(s) for s in ts] == [vars(s) for s in js] and len(ts) == 15
    assert tattr.phases_from_records(records) == jattr.phases_from_records(records)
    names = {r["name"] for r in records}
    assert {"plan.attrib.phase", "calibration.drift", "plan.fingerprint"} <= names
    assert names <= ttel.KNOWN_NAMES


def test_disabled_recorder_attributes_nothing():
    tc, _ = configs()
    assert tattr.attribute_and_judge(ttel.Recorder(None), tc, tir.PlanChoice((2, 2, 2),
                                     "axis-composed"), [1e-3], phase="p") is None


def _metrics(path, platform, method, points, per_copy, bw):
    rec = ttel.Recorder(path, app="t", run_id="r1")
    for c, b in points:
        pred = tattr.PhasePrediction(method=method, predicted_s=1e-3, collectives=c,
                                     wire_bytes=b)
        tattr.emit_phase(rec, pred, per_copy * c + b / bw, phase="exchange.iter")
    rec.close()


@pytest.mark.parametrize("platform", ["cpu", "cuda"])
def test_plan_tool_calibrate_installs_the_fit(tmp_path, platform, capsys):
    metrics, db = str(tmp_path / "m.jsonl"), str(tmp_path / "plans.json")
    pts = ((2, 1 << 20), (6, 3 << 20), (26, 1 << 22), (4, 1 << 24))
    _metrics(metrics, platform, "remote-dma", pts, 4e-5, 1e11)
    assert plan_tool.main(["calibrate", "--db", db, "--platform", platform,
                           "--from-metrics", metrics]) == 0
    row = tdb.lookup_calibration(tdb.load_db(db), platform)
    records = [json.loads(ln) for ln in open(metrics)]
    want = tcal.fit(tcal.samples_from_records(records), platform=platform)
    assert untimed(row) == untimed(want)
    key = "dma_overhead_s" if platform == "cuda" else "cpu_emulation_overhead_s"
    assert row["calibration"]["remote_dma"][key] == pytest.approx(4e-5, rel=1e-6)
    assert plan_tool.main(["calibration", "diff", "--db", db]) == 0
    out = capsys.readouterr().out
    assert f"remote_dma.{key}" in out and "fitted(n=4" in out
    # the JAX tool reads the port's DB
    from stencil_tpu.apps import plan_tool as jtool

    assert jtool.main(["calibration", "show", "--db", db]) == 0


def test_card_row_is_a_valid_fitted_row():
    """The port's "cuda" constants are a calibration row of the plan DB's
    shape, fitted on the card (their provenance names it)."""
    row = PLATFORM_CALIBRATION["cuda"]
    assert tdb.validate_calibration_row("cuda", {k: row[k] for k in (
        "calibration", "provenance", "n", "r2")}) == []
    assert row["provenance"].startswith("fitted(n=") and "H100" in row["provenance"]
