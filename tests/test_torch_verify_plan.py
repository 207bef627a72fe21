"""analysis/verify_plan on 8 CPU positions: the sweep grid and labels are
the JAX package's (sweep_configs), infeasible configs are skipped loudly
with its reasons, every method's counted checks agree with what the
exchange executed (messages and their bytes, copies to other positions,
launches per chunk; the carriers' launch counts, which only the card
counts, listed as not made), a perturbed prediction fails, a sweep that
analyzed nothing exits 2, the records are schema-valid, and AUTO_SPMD,
placements and the hierarchy raise (queue A item 5)."""

import json

import jax
import pytest
import torch

from stencil_tpu.analysis import verify_plan as jvp
from stencil_tpu_torch.analysis import verify_plan as vp
from stencil_tpu_torch.apps import lint_tool
from stencil_tpu_torch.obs import telemetry

torch.set_num_threads(2)

POS8 = ["cpu"] * 8


def test_grid_and_labels_match_jax():
    j_all = jvp.sweep_configs()  # JAX's default: every label
    assert vp.sweep_configs(methods=vp.method_labels()) == j_all
    assert vp.method_labels() == tuple(c["method"] for c in j_all[:6])
    # the port's default leaves out auto-spmd and nothing else
    assert vp.sweep_configs() == [c for c in j_all if c["method"] != "auto-spmd"]
    kw = dict(size=32, radius=1, partitions=((1, 1, 8), (2, 1, 2)),
              qsets=(("float64",), ("float32", "float64", "float64")))
    assert vp.sweep_configs(methods=vp.method_labels(), **kw) == jvp.sweep_configs(**kw)
    for bad in (["nope"], ["direct26", "x"]):
        with pytest.raises(ValueError, match="unknown method"):
            vp.sweep_configs(methods=bad)


def test_infeasible_configs_skip_loudly_as_jax():
    for cfg in (vp.sweep_configs(partitions=((2, 2, 2),), methods=("direct26",),
                                 qsets=(("float32",),))[0],
                vp.sweep_configs(radius=3, partitions=((1, 1, 8),), methods=("remote-dma",),
                                 qsets=(("float32",),))[0]):
        devs = 1 if cfg["partition"] == (2, 2, 2) else 8
        t = vp.audit_config(cfg, devices=["cpu"] * devs)
        j = jvp.audit_config(cfg, devices=jax.devices()[:devs])
        assert t.to_json() == j.to_json()
        assert t.skipped and not t.ok and t.reason


def test_every_counted_check_agrees():
    res = vp.run_sweep(vp.sweep_configs(), devices=POS8)
    assert (res["checked"], res["failed"], res["skipped"]) == (30, 0, 0)
    for v in res["verdicts"]:
        made = {c["name"]: c for c in v.checks if c["ok"] is not None}
        unmade = [c for c in v.checks if c["ok"] is None]
        assert all(c["ok"] for c in made.values()), v.to_json()
        if v.method in ("axis-composed", "direct26"):
            assert set(made) == {"messages_per_exchange", "wire_bytes"} and not unmade
            assert made["wire_bytes"]["actual"] > 0
        else:
            assert made["messages_per_exchange"]["actual"] == 0
            assert made["dma_transfers"]["actual"] > 0
            counted = (["chunk_loop_launches", "chunk_kernel_launches"]
                       if v.method == vp.PERSISTENT_METHOD_LABEL else [])
            assert [c["name"] for c in unmade] == ["carrier_launches"] + counted
            assert all("CUDA device" in c["not_made"] and c["predicted"] >= 1 for c in unmade)
        if v.method == vp.PERSISTENT_METHOD_LABEL:
            assert made["launches_per_chunk"]["actual"] == 2


def test_counts_match_the_jax_census_where_it_counts():
    """The IR both packages share: the messages the port's exchange issued
    equal the collectives JAX's census counted on the same configs."""
    cfgs = vp.sweep_configs(partitions=((2, 2, 2),), methods=("axis-composed", "direct26"),
                            qsets=(("float32",), ("float32", "float32", "float64")))
    t = vp.run_sweep(cfgs, devices=POS8)["verdicts"]
    j = jvp.run_sweep(cfgs, devices=jax.devices()[:8])["verdicts"]
    for tv, jv in zip(t, j):
        tc = {c["name"]: c for c in tv.checks}
        jc = {c["name"]: c for c in jv.checks}
        assert tc["messages_per_exchange"]["predicted"] == \
            jc["collectives_per_exchange"]["predicted"]
        assert tc["wire_bytes"]["predicted"] == jc["wire_bytes"]["predicted"]


def test_persistent_at_depth_four():
    cfg = vp.sweep_configs(size=24, radius=1, partitions=((2, 2, 2),),
                           methods=(vp.PERSISTENT_METHOD_LABEL,), qsets=(("float32",),))[0]
    cfg["k"] = 4
    v = vp.audit_config(cfg, devices=POS8)
    assert v.ok, v.to_json()
    checks = {c["name"]: c for c in v.checks}
    assert checks["launches_per_chunk"]["actual"] == 2
    # on the card: the sel fill's 3 B6 phases, then one B9 launch for each
    # of the two chunks
    assert checks["chunk_loop_launches"]["predicted"] == 3 + 2
    assert checks["chunk_kernel_launches"]["predicted"] == 2


def test_chunk_loop_launches_on_the_card():
    """The card's persistent loop: the sel fill, then a launch a chunk, the
    deep exchange's carriers before each on an uneven partition; the JAX
    unit stays 2 a chunk."""
    from stencil_tpu_torch.domain.grid import GridSpec
    from stencil_tpu_torch.geometry import Dim3, Radius
    from stencil_tpu_torch.plan.ir import build_plan

    for size, fill, per in ((24, 3, 1), (25, 3, 4)):
        spec = GridSpec(Dim3(size, size, size), Dim3(2, 2, 2), Radius.constant(2))
        plan = build_plan(spec, (2, 2, 2), "remote-dma", persistent=True)
        assert plan.carrier_launches([1], 1) == fill
        assert [plan.chunk_loop_launches(c) for c in (1, 2)] == [fill + per, fill + 2 * per]
        assert plan.launches_per_chunk(4) == 2
    with pytest.raises(ValueError, match="persistent"):
        build_plan(spec, (2, 2, 2), "remote-dma").chunk_loop_launches(1)


@pytest.mark.parametrize("knob,hits", [
    ("perturb_collectives", {"axis-composed", "direct26", "remote-dma", vp.FUSED_METHOD_LABEL,
                             vp.PERSISTENT_METHOD_LABEL}),
    ("perturb_wire", {"axis-composed", "direct26"}),
    ("perturb_dmas", {"remote-dma", vp.FUSED_METHOD_LABEL, vp.PERSISTENT_METHOD_LABEL}),
])
def test_a_perturbed_prediction_fails(knob, hits):
    res = vp.run_sweep(vp.sweep_configs(qsets=(("float32",),)), devices=POS8, **{knob: 1})
    assert {v.method for v in res["verdicts"] if not v.ok} == hits
    assert res["failed"] == 2 * len(hits)


def test_nothing_analyzed_exits_2(capsys):
    assert lint_tool.main(["verify-plan", "--cpu", "1"]) == 2
    assert "nothing analyzed" in capsys.readouterr().err
    assert lint_tool.main(["verify-plan", "--cpu", "8", "--methods", "direct26",
                           "--quantities", "f32"]) == 0
    assert lint_tool.main(["verify-plan", "--cpu", "8", "--methods", "direct26",
                           "--quantities", "f32", "--perturb-wire", "1"]) == 1


def test_records_are_schema_valid(tmp_path, capsys):
    out = tmp_path / "m.jsonl"
    try:
        assert lint_tool.main(["verify-plan", "--cpu", "8", "--methods", "remote-dma",
                               "--json", "--metrics-out", str(out)]) == 0
    finally:
        telemetry.configure()
    doc = json.loads(capsys.readouterr().out)
    assert doc["kind"] == "plan-sweep" and doc["checked"] == 6 and doc["failed"] == 0
    assert set(doc["verdicts"][0]) == set(jvp.Verdict("l", "m").to_json())
    lines = out.read_text().splitlines()
    n_ok, errs = telemetry.validate_jsonl(lines)
    assert errs == [] and n_ok == len(lines)
    names = [json.loads(ln)["name"] for ln in lines]
    assert names.count("analysis.plan_verdict") == 6 and names[-1] == "analysis.plan_sweep"


def test_time_sweep_reports_a_band():
    cfgs = vp.sweep_configs(partitions=((2, 2, 2),), methods=("remote-dma",),
                            qsets=(("float32",),))
    res = vp.run_time_sweep(cfgs, devices=POS8, iters=3)
    (v,) = res["verdicts"]
    assert v.checks[0]["name"] == "predicted_s_within_band"
    assert "measured band" in v.checks[0]["actual"]


def test_auto_spmd_placements_and_hierarchy_raise():
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        vp.run_sweep(vp.sweep_configs(methods=("auto-spmd",)), devices=POS8)
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        lint_tool.main(["verify-plan", "--cpu", "8", "--methods", "auto-spmd"])
    for flag in ("--placements", "--hierarchy"):
        with pytest.raises(NotImplementedError, match="queue A item 5"):
            lint_tool.main(["verify-plan", "--cpu", "8", flag, "2"])


@pytest.mark.parametrize("method", ["axis-composed", "direct26"])
def test_uneven_messages_and_bytes_agree(method):
    """On an uneven partition (17^3) the messages and the bytes the
    exchange counted from its boxes' shapes equal the IR's."""
    cfgs = vp.sweep_configs(size=17, partitions=((2, 2, 2), (1, 2, 4)), methods=(method,),
                            qsets=(("float32",), ("float32", "float32", "float64")))
    for cfg in cfgs:
        v = vp.audit_config(cfg, devices=POS8)
        assert v.ok and [c["name"] for c in v.checks] == ["messages_per_exchange",
                                                          "wire_bytes"], v.to_json()
