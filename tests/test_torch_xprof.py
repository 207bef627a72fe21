"""obs/xprof: device seconds per named range from a profiler capture.

A dump with no event categories (the JAX/TPU shape) is read as the JAX
module reads it, every complete event; a torch.profiler trace counts only
its device categories (kernels, copies, sets, and a range's device span),
by correlation where a range has no device span; a real CPU capture has no
device seconds; and ``capture`` yields False and writes nothing without a
CUDA device."""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from stencil_tpu.obs import xprof as jax_xprof
from stencil_tpu_torch.obs import xprof

torch.set_num_threads(2)


def _jax_style_events(seed: int):
    """A TPU-dump-like event list: no ``cat``, float and int durations,
    ``#...#`` argument suffixes, events that must not count (non-X, zero
    or negative or missing dur, no name)."""
    rng = np.random.default_rng(seed)
    names = ["jacobi.chunk", "stencil.exchange", "fusion.12", "copy-start"]
    evs = []
    t = 0.0
    for i in range(40):
        name = names[int(rng.integers(len(names)))]
        if rng.random() < 0.3:
            name += f"#fused={int(rng.integers(3))},k={i}#"
        dur = float(rng.uniform(0.5, 900.0)) if rng.random() < 0.7 else int(rng.integers(1, 50))
        evs.append({"ph": "X", "name": name, "ts": t, "dur": dur, "pid": 1, "tid": 2})
        t += dur
    evs += [
        {"ph": "X", "name": "jacobi.chunk", "ts": t, "dur": 0, "pid": 1, "tid": 2},
        {"ph": "X", "name": "jacobi.chunk", "ts": t, "dur": -4.0, "pid": 1, "tid": 2},
        {"ph": "X", "name": "stencil.exchange", "ts": t, "pid": 1, "tid": 2},
        {"ph": "X", "name": "", "ts": t, "dur": 3.0, "pid": 1, "tid": 2},
        {"ph": "i", "name": "jacobi.chunk", "ts": t, "pid": 1, "tid": 2},
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "/device:TPU:0"}},
        {"ph": "X", "name": "#odd", "ts": t, "dur": 7.0, "pid": 1, "tid": 2},
    ]
    return evs


def _write(path, events, gz=False):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    doc = json.dumps({"traceEvents": events, "displayTimeUnit": "ns"})
    if gz:
        with gzip.open(path, "wt", encoding="utf-8") as f:
            f.write(doc)
    else:
        with open(path, "w") as f:
            f.write(doc)


@pytest.fixture
def jax_dump(tmp_path):
    """Two runs' dumps in the profiler layout, one gzipped, one plain, and
    a bare dump beside them, plus a truncated file that attributes nothing."""
    root = tmp_path / "logdir"
    _write(str(root / "plugins" / "profile" / "run1" / "host.trace.json.gz"),
           _jax_style_events(1), gz=True)
    _write(str(root / "plugins" / "profile" / "run2" / "host.trace.json"), _jax_style_events(2))
    _write(str(root / "bare.trace.json"), _jax_style_events(3))
    (root / "plugins" / "profile" / "run2" / "torn.trace.json").write_text('{"traceEvents": [')
    return str(root)


@pytest.mark.parametrize("names", [None, ["jacobi.chunk"], ["stencil.exchange", "copy-start"],
                                   ["absent"]], ids=["all", "chunk", "two", "absent"])
def test_jax_style_dump_equals_the_jax_module(jax_dump, names):
    got = xprof.range_seconds(jax_dump, names)
    want = jax_xprof.range_seconds(jax_dump, names)
    assert got == want
    if names is None:
        assert set(got) == {"jacobi.chunk", "stencil.exchange", "fusion.12", "copy-start",
                            "#odd"}


def _torch_style_events():
    """A Kineto-shaped trace: host ranges, ops and runtime calls beside the
    device timeline (kernels, a copy, a set, the range's device span)."""
    return [
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)", "ts": 0.0, "dur": 5000.0,
         "pid": "Spans", "tid": "PyTorch Profiler"},
        {"ph": "X", "cat": "user_annotation", "name": "jacobi.chunk", "ts": 100.0,
         "dur": 900.0, "pid": 7, "tid": 7},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 110.0, "dur": 20.0,
         "pid": 7, "tid": 7},
        {"ph": "X", "cat": "python_function", "name": "loop", "ts": 105.0, "dur": 800.0,
         "pid": 7, "tid": 7},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 120.0, "dur": 5.0,
         "pid": 7, "tid": 7, "args": {"correlation": 11}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 130.0, "dur": 5.0,
         "pid": 7, "tid": 7, "args": {"correlation": 12}},
        {"ph": "X", "cat": "kernel",
         "name": "void jacobi_multistep_kernel<3, float>(float const*, float*, Geom)",
         "ts": 200.0, "dur": 612.5, "pid": 0, "tid": 7, "args": {"correlation": 11}},
        {"ph": "X", "cat": "kernel", "name": "jacobi_sweep_kernel(Tasks, int)", "ts": 820.0,
         "dur": 590.25, "pid": 0, "tid": 7, "args": {"correlation": 12}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)",
         "ts": 1500.0, "dur": 30.0, "pid": 0, "tid": 7, "args": {"correlation": 13}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "ts": 1540.0, "dur": 2.0,
         "pid": 0, "tid": 7, "args": {"correlation": 14}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "jacobi.chunk", "ts": 200.0,
         "dur": 1210.25, "pid": 0, "tid": 7},
        {"ph": "f", "cat": "ac2g", "name": "", "ts": 120.0, "pid": 0, "tid": 7, "id": 11},
    ]


def test_torch_style_dump_counts_only_device_categories(tmp_path):
    _write(str(tmp_path / "plugins" / "profile" / "r" / "h.1.trace.json"), _torch_style_events())
    got = xprof.range_seconds(str(tmp_path))
    assert got == pytest.approx({
        "jacobi.chunk": 1210.25e-6,
        "void jacobi_multistep_kernel<3, float>(float const*, float*, Geom)": 612.5e-6,
        "jacobi_sweep_kernel(Tasks, int)": 590.25e-6,
        "Memcpy DtoD (Device -> Device)": 30e-6,
        "Memset (Device)": 2e-6,
    }, rel=1e-12)
    # the host range, ops, runtime calls and the window never count
    for host in ("aten::copy_", "loop", "cudaLaunchKernel", "PyTorch Profiler (0)"):
        assert host not in got
    assert xprof.range_seconds(str(tmp_path), ["jacobi.chunk"]) == pytest.approx(
        {"jacobi.chunk": 1210.25e-6}, rel=1e-12)
    ev = xprof.device_events(str(tmp_path))
    assert [e["cat"] for e in ev] == ["kernel", "kernel", "gpu_memcpy", "gpu_memset"]
    assert ev[0]["dur"] == 612.5 and ev[1]["ts"] == 820.0


def test_torch_style_range_without_device_span_by_correlation(tmp_path):
    """No gpu_user_annotation: the range's device span is that of the work
    its host interval launched (correlation ids), first start to last end;
    work launched outside the range does not count."""
    evs = [e for e in _torch_style_events() if e["cat"] != "gpu_user_annotation"]
    evs.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2000.0,
                "dur": 5.0, "pid": 7, "tid": 7, "args": {"correlation": 15}})
    evs.append({"ph": "X", "cat": "kernel", "name": "fill_rows(Runs)", "ts": 2100.0,
                "dur": 40.0, "pid": 0, "tid": 7, "args": {"correlation": 15}})
    _write(str(tmp_path / "h.trace.json"), evs)
    got = xprof.range_seconds(str(tmp_path), ["jacobi.chunk", "fill_rows(Runs)"])
    assert got == pytest.approx({"jacobi.chunk": (820.0 + 590.25 - 200.0) * 1e-6,
                                 "fill_rows(Runs)": 40e-6}, rel=1e-12)


def test_real_cpu_capture_has_no_device_seconds(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("jacobi.chunk"):
            a = torch.ones(64, 64)
            (a @ a + 1).sum()
    d = tmp_path / "plugins" / "profile" / "cpu"
    d.mkdir(parents=True)
    prof.export_chrome_trace(str(d / "host.trace.json"))
    with open(d / "host.trace.json") as f:
        cats = {e.get("cat") for e in json.load(f)["traceEvents"] if e.get("ph") == "X"}
    assert "user_annotation" in cats and "cpu_op" in cats
    assert xprof.range_seconds(str(tmp_path)) == {}
    assert xprof.range_seconds(str(tmp_path), ["jacobi.chunk"]) == {}
    assert xprof.device_events(str(tmp_path)) == []


def test_capture_on_the_cpu_yields_false_and_writes_nothing(tmp_path):
    logdir = tmp_path / "cap"
    with xprof.capture(str(logdir)) as on:
        torch.ones(8).sum()
    assert on is False
    assert not logdir.exists()
    for empty in ("", None):
        with xprof.capture(empty) as on:
            pass
        assert on is False


def test_capture_never_raises_out_of_its_gate(tmp_path, monkeypatch):
    """A profiler that fails to start leaves the run alone: the gate yields
    False, and the block's own exception still propagates."""
    import torch.profiler as tp

    monkeypatch.setattr(xprof, "_cuda_profiling", lambda: True)

    def broken(*a, **k):
        raise RuntimeError("CUPTI unavailable")

    monkeypatch.setattr(tp, "profile", broken)
    with xprof.capture(str(tmp_path / "cap")) as on:
        pass
    assert on is False
    with pytest.raises(KeyError):
        with xprof.capture(str(tmp_path / "cap")):
            raise KeyError("the run's own fault")
