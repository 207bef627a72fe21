"""obs/trace_export against the JAX module: ``to_trace``, ``validate_trace``
and ``write_trace`` give the same trace objects, errors and bytes on the
same records: a synthesized fault story, random records made from a seed,
and the metrics file of a small guarded jacobi3d run of the port on the CPU
(a fault injected, rolled back and checkpointed)."""

import json

import numpy as np
import pytest
import torch

from stencil_tpu.obs import trace_export as jax_te
from stencil_tpu_torch.apps import jacobi3d
from stencil_tpu_torch.apps import report
from stencil_tpu_torch.obs import telemetry
from stencil_tpu_torch.obs import trace_export

torch.set_num_threads(2)


def _rec(kind, name, t, run="R1", proc=0, **fields):
    r = {"v": 1, "run": run, "proc": proc, "kind": kind, "name": name, "t": t}
    r.update(fields)
    return r


def _fault_story():
    return [
        _rec("meta", "config", 100.0, app="jacobi3d", config={"x": 24}),
        _rec("span", "jacobi.step", 101.0, seconds=1.0, phase="step", app="jacobi3d"),
        _rec("span", "jacobi.step", 101.5, seconds=0.5, phase="step", proc=1),
        _rec("counter", "fault.injected", 101.6, value=1, step=3, fault_kind="nan"),
        _rec("span", "health.check", 101.7, seconds=0.05, phase="health", step=4),
        _rec("counter", "recover.rollback", 102.0, value=1, from_step=4, to_step=2,
             fault_step=3),
        _rec("span", "ckpt.save", 102.5, seconds=0.3, phase="ckpt", step=4),
        _rec("gauge", "jacobi.mcells_per_s", 103.0, value=42.0),
        _rec("heartbeat", "hb", 103.5, seq=7),
        _rec("meta", "plan.attrib.phase", 103.6, phase="exchange.iter", method="remote-dma",
             predicted_s=1e-4, measured_s=1.2e-4, residual=0.2, collectives=6,
             wire_bytes=4096),
        _rec("counter", "exchange.bytes_logical", 103.7, bytes=1024),
        _rec("span", "jacobi.step", 104.0, seconds=0.8, run="R2"),
    ]


def _random_records(seed: int):
    rng = np.random.default_rng(seed)
    names = ["jacobi.chunk", "exchange.iter", "ckpt.save", "anomaly.detected", "g.x"]
    out = []
    for i in range(60):
        kind = ["span", "gauge", "counter", "heartbeat", "meta"][int(rng.integers(5))]
        t = float(1000.0 + rng.uniform(0, 50))
        fields = {"run": f"R{int(rng.integers(3))}", "proc": int(rng.integers(4))}
        if rng.random() < 0.5:
            fields["app"] = "jacobi3d" if rng.random() < 0.5 else "astaroth"
        if kind == "span":
            fields["seconds"] = float(rng.uniform(1e-5, 0.5))
            fields["phase"] = "step"
        elif kind == "gauge":
            fields["value"] = float(rng.normal())
        elif kind == "counter":
            if rng.random() < 0.7:
                fields["value"] = int(rng.integers(100))
            if rng.random() < 0.5:
                fields["bytes"] = int(rng.integers(1 << 20))
        elif kind == "heartbeat":
            fields["seq"] = i
        if rng.random() < 0.3:
            fields["step"] = int(rng.integers(10))
        out.append(_rec(kind, names[int(rng.integers(len(names)))], t, **fields))
    return out


@pytest.fixture(scope="module")
def port_metrics(tmp_path_factory):
    """The metrics file of a port jacobi3d run on the CPU: guarded, nan
    injected at step 3 and rolled back, checkpointed every 2 steps."""
    d = tmp_path_factory.mktemp("metrics")
    path = str(d / "m.jsonl")
    try:
        rc = jacobi3d.main(["--x", "10", "--y", "10", "--z", "10", "--iters", "6",
                            "--no-weak", "--device", "cpu", "--health-every", "2",
                            "--inject", "nan@3", "--ckpt-dir", str(d / "ck"),
                            "--ckpt-every", "2", "--rollback-backoff", "0",
                            "--metrics-out", path])
    finally:
        telemetry.configure()  # back to a disabled default recorder
    assert rc == 0
    records, errors = report.load([path])
    assert errors == [] and len(records) > 10
    return path, records


def _cases(port_metrics):
    return {"story": _fault_story(), "random": _random_records(7),
            "port_metrics": port_metrics[1], "empty": []}


@pytest.mark.parametrize("case", ["story", "random", "port_metrics", "empty"])
def test_to_trace_equals_the_jax_module(port_metrics, case):
    recs = _cases(port_metrics)[case]
    got = trace_export.to_trace(recs)
    assert got == jax_te.to_trace(recs)
    assert trace_export.validate_trace(got) == []


def test_port_metrics_trace_has_the_fault_story(port_metrics):
    names = {r["name"] for r in port_metrics[1]}
    assert {"fault.injected", "recover.rollback", "ckpt.save"} <= names
    ev = trace_export.to_trace(port_metrics[1])["traceEvents"]
    assert {"fault.injected", "recover.rollback", "ckpt.save"} <= {
        e["name"] for e in ev if e["ph"] == "i"}


_BASE = {"pid": 1, "tid": 0, "name": "e"}
BAD_TRACES = {
    "not_a_dict": [],
    "events_not_a_list": {"traceEvents": "nope"},
    "unsorted": {"traceEvents": [dict(_BASE, ph="i", s="p", ts=5.0),
                                 dict(_BASE, ph="i", s="p", ts=1.0)]},
    "x_no_dur": {"traceEvents": [dict(_BASE, ph="X", ts=0.0)]},
    "x_negative_dur": {"traceEvents": [dict(_BASE, ph="X", ts=0.0, dur=-1.0)]},
    "e_without_b": {"traceEvents": [dict(_BASE, ph="E", ts=0.0)]},
    "unclosed_b": {"traceEvents": [dict(_BASE, ph="B", ts=0.0)]},
    "balanced": {"traceEvents": [dict(_BASE, ph="B", ts=0.0), dict(_BASE, ph="E", ts=1.0),
                                 {"pid": 2, "tid": 0, "name": "x", "ph": "X", "ts": 2.0,
                                  "dur": 1.0}]},
    "bad_phase": {"traceEvents": [dict(_BASE, ph="Z", ts=0.0)]},
    "no_name": {"traceEvents": [{"pid": 1, "tid": 0, "ph": "i", "ts": 0.0}]},
    "negative_ts": {"traceEvents": [dict(_BASE, ph="i", ts=-3.0)]},
    "no_lane": {"traceEvents": [{"name": "e", "ph": "i", "ts": 0.0}]},
    "not_an_event": {"traceEvents": [3]},
}


@pytest.mark.parametrize("case", sorted(BAD_TRACES))
def test_validate_trace_equals_the_jax_module(case):
    obj = BAD_TRACES[case]
    assert trace_export.validate_trace(obj) == jax_te.validate_trace(obj)


@pytest.mark.parametrize("case", ["story", "port_metrics"])
def test_write_trace_bytes_equal(tmp_path, port_metrics, case):
    recs = _cases(port_metrics)[case]
    a, b = tmp_path / "port.json", tmp_path / "jax.json"
    n = trace_export.write_trace(str(a), recs)
    assert n == jax_te.write_trace(str(b), recs)
    assert a.read_bytes() == b.read_bytes()
    assert len(json.loads(a.read_text())["traceEvents"]) == n


@pytest.mark.parametrize("bad", [
    [_rec("span", "s", 10.0, seconds=-1.0)],
    [_rec("gauge", "g", 1.0, value=float("nan"))],
], ids=["negative_span", "nan_gauge"])
def test_write_trace_refuses_as_the_jax_module(tmp_path, bad):
    with pytest.raises(ValueError) as port_err:
        trace_export.write_trace(str(tmp_path / "p.json"), bad)
    with pytest.raises(ValueError) as jax_err:
        jax_te.write_trace(str(tmp_path / "j.json"), bad)
    assert str(port_err.value) == str(jax_err.value)
    assert not (tmp_path / "p.json").exists()
