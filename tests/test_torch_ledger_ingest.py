"""The ledger's ingest half against the JAX module: the four
``entries_from_*`` give equal entries (``t`` passed) on the committed
BENCH_r0*.json and MULTICHIP_r0*.json, on bench payloads (the port's
bench_headline line among them), and on metrics records: a port run's
metrics file, and records with attribution samples, NaN samples and
method/batched tags made from a seed."""

import json
import os

import numpy as np
import pytest
import torch

from stencil_tpu.obs import ledger as jax_ledger
from stencil_tpu_torch.apps import bench_headline, jacobi3d, report
from stencil_tpu_torch.obs import ledger, telemetry

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 1_700_000_000.0


def _doc(name):
    with open(os.path.join(REPO, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("rev", [None, "abc1234"])
def test_legacy_bench_equal(n, rev):
    doc = _doc(f"BENCH_r{n:02d}.json")
    got = ledger.entries_from_legacy_bench(doc, rev=rev, t=T)
    assert got == jax_ledger.entries_from_legacy_bench(doc, rev=rev, t=T)
    assert any(e["metric"] == "bench.rc" for e in got)
    assert all(e["label"] == f"r{n:02d}" for e in got)
    assert all(ledger.validate_entry(e) == [] for e in got)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_legacy_multichip_equal(n):
    doc = _doc(f"MULTICHIP_r{n:02d}.json")
    got = ledger.entries_from_legacy_multichip(doc, label=f"r{n:02d}", t=T)
    assert got == jax_ledger.entries_from_legacy_multichip(doc, label=f"r{n:02d}", t=T)
    assert got[0]["metric"] == "multichip_dryrun_ok"


def _headline_payload(capsys):
    assert bench_headline.main(["--device", "cpu", "--size", "10", "--chunk", "2"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


PAYLOADS = {
    "healthy": {"metric": "leg_mcells_per_s", "value": 100.0, "unit": "Mcells/s",
                "vs_baseline": 1.25, "detail": {"platform": "cuda", "size": 512,
                                                "jacobi_ms": 0.2, "astaroth_ms": None,
                                                "note": "text", "flag": True,
                                                "leg_errors": 1, "nan_leg": float("nan")}},
    "outage": {"metric": "leg_mcells_per_s", "value": 0.0, "vs_baseline": 0.0,
               "detail": {"error": "all bench children failed"}},
    "nameless": {"value": 3.0},
}


@pytest.mark.parametrize("case", sorted(PAYLOADS) + ["bench_headline"])
def test_bench_payload_equal(case, capsys):
    payload = _headline_payload(capsys) if case == "bench_headline" else PAYLOADS[case]
    for source in ("bench", "manual"):
        got = ledger.entries_from_bench_payload(payload, label="r07", rev="r", source=source,
                                                t=T)
        assert got == jax_ledger.entries_from_bench_payload(payload, label="r07", rev="r",
                                                            source=source, t=T)
    if case == "bench_headline":
        assert got[0]["metric"] == "jacobi3d_10_mcells_per_s_per_gpu" and got[0]["value"] > 0


@pytest.fixture(scope="module")
def port_records(tmp_path_factory):
    """A port jacobi3d run's metrics records (CPU, 6 steps in chunks of 2,
    with the exchange's attribution epilogue)."""
    path = str(tmp_path_factory.mktemp("m") / "m.jsonl")
    try:
        assert jacobi3d.main(["--x", "12", "--y", "12", "--z", "12", "--iters", "6",
                              "--no-weak", "--device", "cpu", "--metrics-out", path]) == 0
    finally:
        telemetry.configure()
    records, errors = report.load([path])
    assert errors == []
    return records


def _seeded_records(seed: int):
    rng = np.random.default_rng(seed)
    recs = [{"v": 1, "run": "RUN", "proc": 0, "kind": "meta", "name": "config", "t": 1.0,
             "config": {"x": 24, "method": "remote-dma"}}]
    for i in range(50):
        t = 2.0 + i
        pick = int(rng.integers(4))
        if pick == 0:
            v = float(rng.normal(1.0, 0.1)) if rng.random() < 0.9 else float("nan")
            r = {"kind": "gauge", "name": "leg.wall_s", "value": v, "unit": "s"}
            if rng.random() < 0.5:
                r["method"] = ["axis-composed", "direct26"][int(rng.integers(2))]
            if rng.random() < 0.3:
                r["batched"] = bool(rng.random() < 0.5)
        elif pick == 1:
            r = {"kind": "span", "name": "jacobi.chunk", "seconds": float(rng.uniform(0.1, 1))}
        elif pick == 2:
            r = {"kind": "meta", "name": "plan.attrib.phase",
                 "phase": ["exchange.iter", "jacobi.exchange"][int(rng.integers(2))],
                 "method": ["remote-dma", "axis-composed"][int(rng.integers(2))],
                 "predicted_s": 1e-4, "measured_s": float(rng.uniform(1e-4, 2e-4)),
                 "residual": 0.1, "collectives": 6, "wire_bytes": 4096,
                 "provenance": "modeled(default)"}
        else:
            r = {"kind": "counter", "name": "exchange.bytes_logical", "value": 3}
        r.update({"v": 1, "run": "RUN", "proc": 0, "t": t})
        recs.append(r)
    return recs


@pytest.mark.parametrize("spans", [False, True])
@pytest.mark.parametrize("source", ["port_run", "seeded"])
@pytest.mark.parametrize("t", [None, T])
def test_metrics_records_equal(port_records, spans, source, t):
    recs = port_records if source == "port_run" else _seeded_records(3)
    kw = dict(label=None, platform="cpu", rev="r1", spans=spans, t=t)
    got = ledger.entries_from_metrics_records(recs, **kw)
    assert got == jax_ledger.entries_from_metrics_records(recs, **kw)
    assert got, "nothing ingested"
    metrics = {e["metric"] for e in got}
    if source == "port_run":
        assert "plan.attrib.jacobi.exchange" in metrics
        assert "jacobi.mcells_per_s" in metrics
        assert ("jacobi.iter.trimean_s" in metrics) == spans
    else:
        assert any(m.startswith("leg.wall_s[") for m in metrics)


def test_metrics_records_label_and_platform(port_records):
    got = ledger.entries_from_metrics_records(port_records, label="day1", platform="cuda",
                                              t=T)
    assert got == jax_ledger.entries_from_metrics_records(port_records, label="day1",
                                                          platform="cuda", t=T)
    assert {e["platform"] for e in got} == {"cuda"}
    assert all(e["label"].startswith("day1") for e in got)
