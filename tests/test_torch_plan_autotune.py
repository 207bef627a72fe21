"""The port's autotuner and its domain / app wiring (stencil_tpu_torch/plan/
autotune.py, probe.py, api.DistributedDomain, apps jacobi3d / astaroth /
plan_tool) against the JAX package (tests/test_plan_autotune.py): a static-
only run picks the JAX choice at the same cost; probes on ``["cpu"] * 8``
(the plain versions) then a DB hit with zero probes; a JAX-written DB
replays in the port; a corrupt DB is left untouched; a failed probe is
recorded and skipped; set_plan / autotune=True realize the choice as a
unit, an explicit partition wins; the checkpoint manifest records the plan
and the wire, and a resume under another warns; no quantities warns and
skips; the apps' --autotune / --plan-db / --metrics-out. Sizes 16^3; JAX
runs statically only. Tolerance: exact equality."""

import json
import os

import numpy as np
import pytest
import torch

import stencil_tpu.plan.autotune as jauto
import stencil_tpu_torch.plan.autotune as tauto
import stencil_tpu_torch.plan.probe as tprobe
from stencil_tpu.geometry import Radius as JRadius
from stencil_tpu_torch import DistributedDomain
from stencil_tpu_torch.apps import astaroth as tast
from stencil_tpu_torch.apps import jacobi3d as tjac
from stencil_tpu_torch.apps import plan_tool
from stencil_tpu_torch.geometry import Dim3, Radius
from stencil_tpu_torch.obs import telemetry
from stencil_tpu_torch.parallel import Method
from stencil_tpu_torch.plan import db as plandb
from stencil_tpu_torch.plan.ir import PlanChoice, PlanConfig

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8
THREE = ("axis-composed", "direct26", "remote-dma")


@pytest.mark.parametrize("grid,r,q,ndev,methods", [
    ((64, 64, 64), 2, 4, 8, THREE),
    ((64, 64, 64), 2, 4, 8, None),
    ((128, 128, 128), 1, 1, 8, None),
    ((512, 512, 512), 1, 1, 1, None),
    ((256, 256, 256), 3, 8, 1, None),
])
def test_static_only_choice_matches_jax(tmp_path, grid, r, q, ndev, methods):
    dtypes = ["float32"] * q
    t = tauto.autotune(grid, Radius.constant(r), dtypes, ndev=ndev, platform="cpu", probe=False,
                       methods=methods, db_path=str(tmp_path / "t.json"))
    jm = methods or tauto.live_methods(ndev)
    j = jauto.autotune(grid, JRadius.constant(r), dtypes, ndev=ndev, platform="cpu",
                       probe=False, methods=jm, db_path=str(tmp_path / "j.json"))
    assert t.source == j.source == "static" and t.probes_run == 0
    assert t.choice.to_json() == j.choice.to_json()
    assert t.entry["static_cost_s"] == j.entry["static_cost_s"]
    assert [c.label() for _s, c in t.ranked] == [c.label() for _s, c in j.ranked]
    assert set(c.method for _s, c in t.ranked) <= set(jm)


def test_probes_then_pure_db_hit(tmp_path):
    path = str(tmp_path / "plans.json")
    args = dict(size=(16, 16, 16), radius=Radius.constant(1), dtypes=["float32"] * 2,
                devices=CPU8, db_path=path)
    first = tauto.autotune(top_n=2, probe_iters=2, **args)
    assert not first.cache_hit and first.source == "probe"
    assert first.probes_run == 2 and first.candidates > 10
    # over positions every method is a candidate, as in the JAX package
    assert {c.method for _s, c in first.ranked} == set(THREE)
    second = tauto.autotune(**args)
    assert second.cache_hit and second.probes_run == 0 and second.choice == first.choice
    entry = plandb.lookup(plandb.load_db(path), first.config)
    assert entry["source"] == "probe" and all("trimean_s" in p for p in entry["probes"])
    assert first.config.platform == "cpu" and first.config.ndev == 8


def test_jax_written_db_replays_in_the_port(tmp_path):
    path = str(tmp_path / "plans.json")
    j = jauto.autotune((16, 16, 16), JRadius.constant(1), ["float32"], ndev=8, platform="cpu",
                       probe=False, methods=("remote-dma",), db_path=path)
    r = tjac.run(16, 16, 16, iters=2, weak=False, devices=CPU8, method=Method.REMOTE_DMA,
                 autotune=True, plan_db=path)
    res = r["domain"].autotune_result
    assert res.cache_hit and res.probes_run == 0
    assert res.choice.to_json() == j.choice.to_json()
    assert r["domain"].spec.dim == Dim3.of(j.choice.partition)


def test_db_entry_the_devices_cannot_realize_is_retuned(tmp_path, capfd):
    """The seeded AXIS_COMPOSED entry of 8 positions replays now that
    positions realize every method; asked for a set of methods without it,
    the entry is re-tuned and replaced."""
    path = str(tmp_path / "plans.json")
    assert plan_tool.main(["seed", "--db", path]) == 0
    hit = tauto.autotune((128, 128, 128), Radius.constant(2), ["float32"], ndev=8,
                         platform="cpu", probe=False, db_path=path)
    assert hit.cache_hit and hit.choice.method == "axis-composed"
    res = tauto.autotune((128, 128, 128), Radius.constant(2), ["float32"], ndev=8,
                         platform="cpu", probe=False, db_path=path, methods=("remote-dma",))
    assert not res.cache_hit and res.choice.method == "remote-dma"
    assert "re-tuning" in capfd.readouterr().err
    assert plandb.lookup(plandb.load_db(path), res.config)["source"] == "static"


def test_corrupt_db_degrades_without_clobbering(tmp_path, capfd):
    path = str(tmp_path / "plans.json")
    with open(path, "w") as f:
        f.write("{ this is not json")
    before = open(path).read()
    res = tauto.autotune((64, 64, 64), Radius.constant(2), ["float32"] * 2, ndev=8,
                         platform="cpu", probe=False, db_path=path)
    assert res.source == "static"
    assert open(path).read() == before
    assert "rejected" in capfd.readouterr().err


def test_failed_probe_is_recorded_and_skipped(monkeypatch):
    real = tprobe.probe_choice

    def flaky(config, choice, **kw):
        if choice.is_fused:
            raise RuntimeError("launch failed")
        return real(config, choice, **kw)

    monkeypatch.setattr(tprobe, "probe_choice", flaky)
    res = tauto.autotune((16, 16, 16), Radius.constant(1), ["float32"], devices=["cpu"],
                         top_n=4, probe_iters=2)
    failed = [p for p in res.probes if "error" in p]
    assert len(failed) == 1 and "launch failed" in failed[0]["error"]
    assert res.probes_run == 3 and not res.choice.is_fused


def test_probe_record_and_placement_refusal():
    cfg = PlanConfig.make(Dim3(16, 16, 16), Radius.constant(1), ["float32"], 8, "cpu")
    rec = tprobe.probe_choice(cfg, PlanChoice((2, 2, 2), "remote-dma", kernel_variant="fused"),
                              iters=3, devices=CPU8)
    assert rec["label"] == "2x2x2/remote-dma/batched/fused" and rec["trimean_s"] > 0
    assert rec["per_step_s"] == rec["trimean_s"] and rec["gb_per_s"] > 0
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        tprobe.probe_choice(cfg, PlanChoice((2, 2, 2), "remote-dma",
                                            placement=(1, 0, 2, 3, 4, 5, 6, 7)), devices=CPU8)


@pytest.mark.parametrize("kw,devices", [
    (dict(partition=(2, 2, 2), method="direct26", batch_quantities=False), ["cpu"]),
    (dict(partition=(2, 2, 2), method="remote-dma", kernel_variant="fused"), CPU8),
    (dict(partition=(1, 2, 4), method="remote-dma"), CPU8),
    (dict(partition=(1, 1, 1), method="remote-dma", kernel_variant="fused"), ["cpu"]),
])
def test_domain_set_plan_applies_choice(kw, devices):
    choice = PlanChoice(**kw)
    dd = DistributedDomain(16, 16, 16, device="cpu", plan=choice.to_json())
    dd.set_devices(devices)
    dd.set_radius(1)
    dd.set_fused_exchange(not choice.is_fused)  # the choice owns the variant both ways
    dd.add_data("t", "float32")
    dd.realize()
    assert dd._method == Method(choice.method)
    assert dd._batch_quantities == choice.batch_quantities
    assert dd.halo_exchange.fused == choice.is_fused
    assert dd.spec.dim == Dim3.of(choice.partition) and dd.plan_choice == choice
    meta = dd.plan_meta()
    assert meta["tuned"] and meta["choice"] == choice.to_json()
    assert meta["host_blocks"] == [0] * len(devices)
    assert meta["key"]["ndev"] == len(devices) and meta["key"]["platform"] == "cpu"


def test_domain_refuses_hierarchy_and_placement():
    for ch in (PlanChoice((2, 2, 2), "remote-dma", hierarchy=("z", 2)),
               PlanChoice((2, 2, 2), "remote-dma", placement=(1, 0, 2, 3, 4, 5, 6, 7))):
        dd = DistributedDomain(16, 16, 16, device="cpu", plan=ch)
        dd.set_devices(CPU8)
        dd.add_data("t", "float32")
        with pytest.raises(NotImplementedError, match="queue A item 5"):
            dd.realize()


def test_domain_autotune_knob_records_result(tmp_path):
    path = str(tmp_path / "plans.json")
    doms = []
    for _ in range(2):
        dd = DistributedDomain(16, 16, 16, device="cpu", autotune=True, plan_db=path)
        dd.set_radius(1)
        dd.set_devices(CPU8)
        dd.add_data("t", "float32")
        dd.realize()
        doms.append(dd)
    a, b = doms
    assert a.autotune_result is not None and a.plan_choice == a.autotune_result.choice
    assert Dim3.of(a.plan_choice.partition) == a.spec.dim
    assert b.autotune_result.cache_hit and b.autotune_result.probes_run == 0
    assert b.plan_choice == a.plan_choice


def test_explicit_partition_beats_tuned_plan(capfd):
    dd = DistributedDomain(16, 16, 16, device="cpu",
                           plan=PlanChoice((2, 2, 2), "direct26").to_json())
    dd.set_radius(1)
    dd.set_partition((1, 2, 4))
    dd.add_data("t", "float32")
    dd.realize()
    assert dd.spec.dim == Dim3(1, 2, 4)
    assert "overrides" in capfd.readouterr().err
    assert dd._method == Method.AXIS_COMPOSED
    assert dd.plan_choice is None and not dd.plan_meta()["tuned"]


def test_ckpt_manifest_records_plan_and_wire_and_resume_warns(tmp_path, capfd):
    ck = str(tmp_path / "ck")

    def make(fused=False, wire=None):
        dd = DistributedDomain(16, 16, 16, device="cpu")
        dd.set_radius(1)
        dd.set_devices(CPU8)
        dd.set_methods(Method.REMOTE_DMA)
        dd.set_fused_exchange(fused)
        dd.set_wire_dtype(wire)
        h = dd.add_data("t", "float32")
        dd.realize()
        return dd, h

    dd, h = make()
    field = np.arange(16 ** 3, dtype=np.float32).reshape(16, 16, 16)
    dd.set_curr_global(h, field)
    dd.save_checkpoint(ck, 3, asynchronous=False)
    snaps = [e for e in os.listdir(ck) if e.startswith("step-")]
    plan = json.load(open(os.path.join(ck, snaps[0], "manifest.json")))["meta"]["plan"]
    assert plan["choice"]["method"] == "remote-dma" and plan["key"]["grid"] == [16, 16, 16]
    assert plan["wire_dtype"] is None and plan["key"]["ndev"] == 8
    capfd.readouterr()
    same, hs = make()
    assert same.restore_checkpoint(ck) == 3
    assert "exchange plan" not in capfd.readouterr().err
    np.testing.assert_array_equal(same.get_curr_global(hs), field)
    for kw, words in ((dict(fused=True), "differ"), (dict(wire="bfloat16"), "wire_dtype")):
        other, ho = make(**kw)
        assert other.restore_checkpoint(ck) == 3
        err = capfd.readouterr().err
        assert "exchange plan" in err and words in err
        np.testing.assert_array_equal(other.get_curr_global(ho), field)


def test_async_checkpoint_records_the_plan_too(tmp_path):
    ck = str(tmp_path / "ck")
    dd = DistributedDomain(16, 16, 16, device="cpu",
                           plan=PlanChoice((1, 1, 1), "remote-dma", kernel_variant="fused"))
    dd.set_radius(1)
    dd.add_data("t", "float32")
    dd.realize()
    dd.save_checkpoint(ck, 1)
    dd.finish_checkpoints()
    snap = [e for e in os.listdir(ck) if e.startswith("step-")][0]
    plan = json.load(open(os.path.join(ck, snap, "manifest.json")))["meta"]["plan"]
    assert plan["tuned"] and plan["choice"]["kernel_variant"] == "fused"


def test_autotune_without_quantities_warns_and_skips(capfd):
    dd = DistributedDomain(16, 16, 16, device="cpu", autotune=True)
    dd.set_radius(1)
    dd.realize()
    assert dd.autotune_result is None
    assert "no quantities" in capfd.readouterr().err


@pytest.mark.parametrize("devices", [None, "cpu,cpu,cpu,cpu,cpu,cpu,cpu,cpu"])
def test_jacobi3d_cli_autotune_and_attribution(tmp_path, devices, capsys):
    db, metrics = str(tmp_path / "plans.json"), str(tmp_path / "m.jsonl")
    argv = ["--x", "16", "--y", "16", "--z", "16", "--iters", "4", "--no-weak", "--autotune",
            "--plan-db", db, "--metrics-out", metrics]
    argv += ["--devices", devices, "--method", "remote-dma"] if devices else ["--device", "cpu"]
    try:
        assert tjac.main(argv) == 0
        assert tjac.main(argv) == 0
    finally:
        telemetry.configure(None)
    rows = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("jacobi3d,")]
    assert len(rows) == 2
    lines = open(metrics).readlines()
    assert telemetry.validate_jsonl(lines)[1] == []
    recs = [json.loads(ln) for ln in lines]
    hits = [r["value"] for r in recs if r["name"] == "plan.cache_hit"]
    assert hits == [0, 1]
    attrib = [r for r in recs if r["name"] == "plan.attrib.phase"]
    assert {r["phase"] for r in attrib} == {"exchange.iter", "jacobi.exchange"}
    assert all(r["fabric_platform"] == "cpu" for r in attrib)
    fps = [r for r in recs if r["name"] == "plan.fingerprint"]
    chosen = PlanChoice.from_json(plandb.load_db(db)["entries"].popitem()[1]["choice"])
    assert fps[-1]["choice"] == chosen.label() and fps[-1]["fingerprint"] == chosen.fingerprint()


def test_astaroth_autotune(tmp_path):
    db = str(tmp_path / "plans.json")
    r = tast.run(iters=1, nx=12, device="cpu", autotune=True, plan_db=db)
    res = r["domain"].autotune_result
    assert not res.cache_hit and res.probes_run == 3 and r["plan"] == res.choice.label()
    assert {c.batch_quantities for _s, c in res.ranked} == {True, False}
    again = tast.main(["1", "--nx", "12", "--device", "cpu", "--autotune", "--plan-db", db])
    assert again == 0


def test_astaroth_autotune_over_positions_keeps_the_fields(tmp_path):
    """Over 8 CPU positions the tuned plan (any method realizes over
    positions; here a thin partition that takes the serialized order) steps
    the 8 fields to the same bits as the untuned REMOTE_DMA run."""
    from stencil_tpu_torch.astaroth.integrate import FIELDS

    runs = []
    for tune in (False, True):
        r = tast.run(iters=1, nx=8, devices=CPU8, method=Method.REMOTE_DMA, autotune=tune,
                     plan_db=str(tmp_path / "plans.json") if tune else None)
        runs.append({f: r["domain"].get_curr_global(r["handles"][f]) for f in FIELDS})
        if tune:
            assert r["plan"] == r["domain"].autotune_result.choice.label()
            assert r["domain"].autotune_result.choice.method in THREE
    for f in FIELDS:
        assert runs[0][f].tobytes() == runs[1][f].tobytes(), f
