"""The port's performance ledger (``stencil_tpu_torch/obs/ledger.py``)
against the JAX package's on the CPU: entries written by either package load
in the other, byte-identical lines, the same fingerprints, dedup keys,
validation verdicts and corruption refusals, appends of both packages into
one file under the shared lock, and the host fingerprint. Exact
throughout."""

import json
import os
import threading

import pytest

import stencil_tpu.obs.ledger as jled
import stencil_tpu_torch.obs.ledger as tled


def entries(mod, label="r1"):
    return [
        mod.make_entry("serve.step_p99_ms", 12.5, label=label, unit="ms", platform="cuda",
                       source="serve", config={"bucket": "32x32x32/float64/astaroth", "width": 8},
                       detail={"bucket": "32x32x32/float64/astaroth", "width": 8, "samples": 9},
                       t=1000.0),
        mod.make_entry("jacobi3d_512_mcells_per_s_per_chip", 81234.5, label=label,
                       platform="cpu", config={"size": 512, "out": "ignored", "x": None},
                       rev="abc1234", run="run-1", t=1001.0),
    ]


def test_entries_are_identical():
    assert entries(tled) == entries(jled)
    for cfg in ({}, None, {"b": 1, "a": [1, 2]}, {"metrics_out": "m", "inject": "nan@3", "a": 1}):
        assert tled.config_fingerprint(cfg) == jled.config_fingerprint(cfg)
    assert tled.VOLATILE_CONFIG_KEYS == jled.VOLATILE_CONFIG_KEYS
    assert tled.SOURCES == jled.SOURCES
    e = entries(tled)[0]
    assert tled.entry_key(e) == jled.entry_key(e)


@pytest.mark.parametrize("writer,reader", [(tled, jled), (jled, tled)],
                         ids=["port-writes", "jax-writes"])
def test_either_package_reads_the_others_ledger(tmp_path, writer, reader):
    path = str(tmp_path / "ledger.jsonl")
    assert writer.append_entries(path, entries(writer)) == 2
    assert reader.append_entries(path, entries(reader)) == 0  # dedup across packages
    assert reader.append_entries(path, entries(reader, label="r2")) == 2
    assert writer.load_ledger(path) == reader.load_ledger(path)
    assert [e["label"] for e in reader.load_ledger(path)] == ["r1", "r1", "r2", "r2"]
    assert os.path.exists(path + ".lock")  # the one lock file both packages take


def test_lines_are_byte_identical(tmp_path):
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    tled.append_entries(a, entries(tled))
    jled.append_entries(b, entries(jled))
    assert open(a).read() == open(b).read()


@pytest.mark.parametrize("bad", [
    "not json",
    json.dumps({"v": 2, "kind": "perf-ledger"}),
    json.dumps({"v": 1, "kind": "perf-ledger", "metric": "m", "value": "x", "platform": "cpu",
                "config": "c", "label": "l", "source": "serve", "t": 0}),
    json.dumps({"v": 1, "kind": "perf-ledger", "metric": "m", "value": 1.0, "platform": "cpu",
                "config": "c", "label": "l", "source": "nowhere", "t": 0}),
])
def test_corrupt_ledgers_are_refused_alike(tmp_path, bad):
    path = str(tmp_path / "ledger.jsonl")
    with open(path, "w") as f:
        f.write(bad + "\n")
    with pytest.raises(tled.LedgerError) as te:
        tled.load_ledger(path)
    with pytest.raises(jled.LedgerError) as je:
        jled.load_ledger(path)
    assert str(te.value) == str(je.value)
    with pytest.raises(tled.LedgerError):
        tled.append_entries(path, entries(tled))
    assert open(path).read() == bad + "\n"  # never clobbered


def test_validation_verdicts_match():
    good = entries(tled)[0]
    cases = [good, [], dict(good, value=float("nan")), dict(good, value=True),
             dict(good, unit=3), dict(good, detail=[1]), dict(good, metric=""),
             {k: v for k, v in good.items() if k != "t"}]
    for e in cases:
        assert tled.validate_entry(e) == jled.validate_entry(e)
    with pytest.raises(tled.LedgerError, match="invalid entry"):
        tled.append_entries("unused.jsonl", [dict(good, value=float("inf"))])


def test_concurrent_appends_from_both_packages_keep_every_entry(tmp_path):
    path = str(tmp_path / "ledger.jsonl")

    def writer(mod, tag):
        for i in range(10):
            mod.append_entries(path, [mod.make_entry("m", i, label=f"{tag}{i}", t=float(i))])

    threads = [threading.Thread(target=writer, args=(m, tag))
               for m, tag in ((tled, "t"), (jled, "j"))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    labels = sorted(e["label"] for e in jled.load_ledger(path))
    assert labels == sorted([f"t{i}" for i in range(10)] + [f"j{i}" for i in range(10)])


def test_stats_and_host_fingerprint():
    vals = [3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0]
    assert tled.trimean(vals) == jled.trimean(vals)
    assert tled.mad(vals) == jled.mad(vals)
    assert tled.host_fingerprint("cpu") == {"platform": "cpu", "device": "cpu"}
    import torch

    assert tled.host_fingerprint(torch.device("cpu"))["platform"] == "cpu"
