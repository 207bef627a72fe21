"""The port's static cost model (stencil_tpu_torch/plan/cost.py) and the plan
vocabulary of plan/ir.py against the JAX package's on the CPU platform: the
same candidates enumerate, the same ones are feasible, and rank gives the
same labels in the same order with the same seconds (the arithmetic is the
same Python), over AXIS_COMPOSED, DIRECT26 and REMOTE_DMA at the configs of
tests/test_plan_cost.py and a few more (one device, oversubscription, k up
to 4 with the persistent variant, mixed dtypes). Plus scale_radius,
default_choice, PlanChoice's JSON / label / fingerprint, and the "cuda"
platform's own pricing. Pure Python: no device, no compilation.
Tolerance: exact equality."""

import pytest

import stencil_tpu.plan.autotune as jauto
import stencil_tpu.plan.cost as jcost
import stencil_tpu.plan.ir as jir
import stencil_tpu_torch.plan.autotune as tauto
import stencil_tpu_torch.plan.cost as tcost
import stencil_tpu_torch.plan.ir as tir
from stencil_tpu.geometry import Dim3 as JDim3, Radius as JRadius
from stencil_tpu_torch.geometry import Dim3, Radius

METHODS = ("axis-composed", "direct26", "remote-dma")

# (dtypes, grid, radius, ndev, ks, oversubscribe)
CONFIGS = [
    (["float32"] * 3 + ["float64"] * 2, (64, 64, 64), 2, 8, (1,), (1,)),
    (["float64", "float32", "int32", "float32"], (64, 64, 64), 2, 8, (1,), (1,)),
    (["float32"] * 4, (128, 128, 128), 2, 8, (1,), (1,)),
    (["float32"] * 2, (64, 64, 64), 1, 8, (1, 2), (1,)),
    (["float32"], (8, 8, 8), 2, 8, (1,), (1,)),
    (["float32"], (64, 64, 64), 2, 8, (1,), (1, 2)),
    (["float32"], (512, 512, 512), 1, 8, (1, 2, 4), (1,)),
    (["float32"], (512, 512, 512), 1, 1, (1,), (1,)),
    (["float64"] * 8, (256, 256, 256), 3, 1, (1,), (1,)),
    (["float32"] * 4, (96, 64, 48), 1, 4, (1, 3), (1, 2)),
]


def configs(dtypes, grid, r, ndev, platform="cpu"):
    return (tir.PlanConfig.make(Dim3.of(grid), Radius.constant(r), dtypes, ndev, platform),
            jir.PlanConfig.make(JDim3.of(grid), JRadius.constant(r), dtypes, ndev, platform))


def tchoice(j):
    return tir.PlanChoice.from_json(j.to_json())


@pytest.mark.parametrize("dtypes,grid,r,ndev,ks,over", CONFIGS)
def test_enumerate_and_rank_match_jax(dtypes, grid, r, ndev, ks, over):
    tc, jc = configs(dtypes, grid, r, ndev)
    assert tc.key() == jc.key()
    tcands = tcost.enumerate_candidates(tc, methods=METHODS, ks=ks, oversubscribe=over)
    jcands = jcost.enumerate_candidates(jc, methods=METHODS, ks=ks, oversubscribe=over)
    assert [c.to_json() for c in tcands] == [c.to_json() for c in jcands]
    for t, j in zip(tcands, jcands):
        tf, jf = tcost.feasible(tc, t), jcost.feasible(jc, j)
        assert (tf is None) == (jf is None), t.label()
        if tf is not None:
            assert (tuple(tf[1]), tuple(tf[2])) == (tuple(jf[1]), tuple(jf[2]))
    tr, jr = tcost.rank(tc, tcands), jcost.rank(jc, jcands)
    assert [ch.label() for _c, ch in tr] == [ch.label() for _c, ch in jr]
    for (t, _), (j, _) in zip(tr, jr):
        assert (t.total_s, t.exchange_s, t.collectives, t.wire_bytes, t.local_bytes,
                t.compute_overhead_s, t.dmas) == (j.total_s, j.exchange_s, j.collectives,
                                                  j.wire_bytes, j.local_bytes,
                                                  j.compute_overhead_s, j.dmas)


@pytest.mark.parametrize("cal", [
    {"permute_overhead_s": {"axis-composed": 5e-4}},
    {"remote_dma": {"cpu_emulation_overhead_s": 1e-3}, "wire_bytes_per_s": 1e9},
    {"cell_update_s": 3e-9, "variant_factor": {"fused": 0.5}},
])
def test_calibration_overrides_match_jax(cal):
    tc, jc = configs(["float32"] * 4, (128, 128, 128), 2, 8)
    tr = tcost.rank(tc, tcost.enumerate_candidates(tc, ks=(1, 2)), cal)
    jr = jcost.rank(jc, jcost.enumerate_candidates(jc, methods=METHODS, ks=(1, 2)), cal)
    assert [(c.total_s, ch.label()) for c, ch in tr] == [(c.total_s, ch.label()) for c, ch in jr]


def test_default_methods_are_the_planned_three():
    tc, jc = configs(["float32"], (64, 64, 64), 2, 8)
    assert tcost.PLANNED_METHODS == METHODS
    assert [c.label() for c in tcost.enumerate_candidates(tc)] == \
        [c.label() for c in jcost.enumerate_candidates(jc, methods=METHODS)]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcost.score(tc, tir.PlanChoice((2, 2, 2), "auto-spmd"))
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        tcost.enumerate_candidates(tc, hierarchy_hosts=2)


def test_uniform_links_place_identity_and_others_raise():
    tc, jc = configs(["float32"], (64, 64, 64), 2, 8)
    import numpy as np

    uniform = np.ones((8, 8)) - np.eye(8)
    assert [c.label() for c in tcost.enumerate_candidates(tc, link_costs=uniform)] == \
        [c.label() for c in jcost.enumerate_candidates(jc, methods=METHODS,
                                                       link_costs=uniform)]
    assert tcost.solve_placement(np.ones((8, 8)), uniform) is None
    skewed = uniform.copy()
    skewed[0, 7] = skewed[7, 0] = 5.0
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        tcost.enumerate_candidates(tc, link_costs=skewed)
    spec, md, _ = tcost.feasible(tc, tir.PlanChoice((2, 2, 2), "axis-composed"))
    jspec, jmd, _ = jcost.feasible(jc, jir.PlanChoice((2, 2, 2), "axis-composed"))
    w, jw = tcost.placement_wire_matrix(spec, md), jcost.placement_wire_matrix(jspec, jmd)
    assert (w == jw).all()
    f = (1, 0, 2, 3, 4, 5, 6, 7)
    assert tcost.placement_cost(w, skewed, f) == jcost.placement_cost(jw, skewed, f)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_scale_radius_matches_jax(k):
    t = Radius.face_edge_corner(2, 1, 0)
    j = JRadius.face_edge_corner(2, 1, 0)
    ts, js = tcost.scale_radius(t, k), jcost.scale_radius(j, k)
    assert tir.radius_dirs(ts) == jir.radius_dirs(js)
    assert (ts is t) == (k == 1)


@pytest.mark.parametrize("grid,r,ndev", [((64, 64, 64), 2, 8), ((512, 512, 512), 1, 1),
                                         ((96, 64, 48), 1, 6), ((256, 256, 256), 3, 4)])
def test_default_choice_matches_jax(grid, r, ndev):
    tc, jc = configs(["float32"] * 2, grid, r, ndev)
    assert tauto.default_choice(tc).to_json() == jauto.default_choice(jc).to_json()


@pytest.mark.parametrize("kw", [
    dict(partition=(2, 2, 2), method="axis-composed"),
    dict(partition=(1, 1, 8), method="remote-dma", kernel_variant="fused"),
    dict(partition=(2, 2, 2), method="remote-dma", multistep_k=4,
         kernel_variant="persistent", batch_quantities=False),
    dict(partition=(2, 2, 2), method="remote-dma", placement=(1, 0, 2, 3, 4, 5, 6, 7)),
    dict(partition=(4, 2, 1), method="axis-composed", hierarchy=("x", 2),
         host_placement=(1, 0)),
])
def test_plan_choice_json_label_fingerprint_match_jax(kw):
    t, j = tir.PlanChoice(**kw), jir.PlanChoice(**kw)
    assert t.to_json() == j.to_json()
    assert (t.label(), t.fingerprint()) == (j.label(), j.fingerprint())
    assert (t.is_fused, t.is_persistent, t.is_placed, t.is_hierarchical) == \
        (j.is_fused, j.is_persistent, j.is_placed, j.is_hierarchical)
    assert tir.PlanChoice.from_json(j.to_json()) == t
    # the absent-field defaults of an old entry
    old = {"partition": list(kw["partition"]), "method": kw["method"]}
    assert tir.PlanChoice.from_json(old).to_json() == jir.PlanChoice.from_json(old).to_json()


def test_placement_and_hierarchy_checks_match_jax():
    for p, n in (((0, 1, 2), 3), ((1, 1, 0), 3), ((0, 1), 3), ("ab", 2), (None, 4)):
        assert tir.validate_placement(p, n) == jir.validate_placement(p, n)
    for h, md in ((("z", 2), (2, 2, 2)), (("w", 2), (2, 2, 2)), (("x", 3), (2, 2, 2)),
                  (("y", 0), (2, 2, 2)), (None, (1, 1, 1))):
        assert tir.validate_hierarchy(h, md) == jir.validate_hierarchy(h, md)
    dirs = jir.radius_dirs(JRadius.face_edge_corner(3, 2, 1))
    assert tir.radius_dirs(tir.radius_from_dirs(dirs)) == dirs


def test_cuda_platform_prices_with_the_fitted_row():
    """A "cuda" config merges the card's fitted row over the CPU constants:
    a remote-dma copy costs its ``dma_overhead_s`` and no launch term is
    added; the CPU constants stay the JAX package's."""
    tc, _ = configs(["float32"], (512, 512, 512), 1, 8, "cuda")
    row = tcost.PLATFORM_CALIBRATION["cuda"]["calibration"]
    cal = tcost.platform_calibration("cuda")
    assert cal["remote_dma"]["dma_overhead_s"] == row["remote_dma"]["dma_overhead_s"]
    assert tcost.platform_calibration("cpu") == tcost.DEFAULT_CALIBRATION
    for key in ("permute_overhead_s", "local_bytes_per_s", "cell_update_s"):
        assert tcost.DEFAULT_CALIBRATION[key] == jcost.DEFAULT_CALIBRATION[key]
    bw = cal["remote_dma"]["wire_bytes_per_s"]
    for part in ((2, 2, 2), (1, 1, 8), (1, 4, 2)):
        c = tcost.score(tc, tir.PlanChoice(part, "remote-dma"))
        assert c.dmas == 3  # B6 or B4, one launch an axis
        want = (c.dmas * cal["remote_dma"]["dma_overhead_s"]
                + (c.wire_bytes + c.local_bytes) / bw)
        assert c.exchange_s == pytest.approx(want, rel=1e-12)
    assert tcost.score(tc, tir.PlanChoice((2, 2, 2), "remote-dma", kernel_variant="fused")).dmas == 1
    # the permute methods keep the CPU per-collective constants on the card;
    # the fitted rate prices their bytes
    t1, _ = configs(["float32"] * 2, (64, 64, 64), 1, 1, "cuda")
    c = tcost.score(t1, tir.PlanChoice((1, 1, 1), "direct26"))
    want = (c.collectives * cal["permute_overhead_s"]["direct26"]
            + c.wire_bytes / cal["wire_bytes_per_s"] + c.local_bytes / cal["local_bytes_per_s"])
    assert c.exchange_s == want
    assert tcost.default_provenance("cuda") == tcost.PLATFORM_CALIBRATION["cuda"]["provenance"]
    assert tcost.default_provenance("cpu") == "modeled(default)"
    # no TPU-modeled constant and no DCN row in the port's copy
    assert "dcn" not in tcost.DEFAULT_CALIBRATION
    assert "dma_overhead_s" not in tcost.DEFAULT_CALIBRATION["remote_dma"]
    assert "launch_overhead_s" not in tcost.DEFAULT_CALIBRATION["persistent"]


@pytest.mark.parametrize("size,part,devices,nq,batch,fused", [
    ((16, 16, 16), (1, 1, 1), 1, 1, True, False),
    ((16, 16, 16), (1, 1, 1), 1, 20, True, True),
    ((16, 16, 16), (1, 1, 1), 1, 3, False, False),
    ((16, 16, 16), (2, 2, 2), 8, 1, True, False),
    ((16, 16, 16), (1, 1, 8), 8, 2, True, False),
    ((16, 16, 16), (1, 4, 2), 8, 3, False, False),
    ((16, 16, 16), (2, 2, 2), 8, 2, False, True),
    ((16, 16, 16), (2, 2, 2), 4, 9, True, False),
    ((16, 16, 16), (2, 2, 2), 1, 1, True, False),
    ((17, 16, 16), (2, 2, 2), 8, 1, True, True),
])
def test_carrier_launches_count_the_exchange_calls(monkeypatch, size, part, devices, nq,
                                                   batch, fused):
    """``ExchangePlan.carrier_launches`` (the card's copy count) equals the
    kernel wrapper calls one REMOTE_DMA exchange makes, counted on the CPU
    by wrapping the wrappers (B6, B7, B4)."""
    import torch

    from stencil_tpu_torch import DistributedDomain
    from stencil_tpu_torch.ops import fused_stencil, halo_fill, remote_dma
    from stencil_tpu_torch.parallel import Method, exchange

    calls = []

    def counting(mod, name):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, **k: calls.append(name) or real(*a, **k))

    counting(remote_dma, "remote_axis")
    counting(remote_dma, "self_fill")
    counting(exchange, "self_fill")
    counting(fused_stencil, "fused_exchange")
    assert tir.FILL_GROUP == halo_fill.MAX_FILL_GROUP
    dd = DistributedDomain(*size, device="cpu")
    if devices > 1:
        dd.set_devices(["cpu"] * devices)
    dd.set_partition(part)
    dd.set_radius(1)
    dd.set_methods(Method.REMOTE_DMA)
    dd.set_quantity_batching(batch)
    dd.set_fused_exchange(fused)
    for i in range(nq):
        dd.add_data(f"q{i}", "float32" if i % 3 else "float64")
    dd.realize()
    calls.clear()
    dd.exchange()
    groups = {}
    for dt in dd._dtype_names():
        groups[dt] = groups.get(dt, 0) + 1
    carriers = list(groups.values()) if batch else [1] * nq
    assert dd.halo_exchange.plan.carrier_launches(carriers, len(groups)) == len(calls), calls
    assert torch.is_tensor(next(iter(dd.curr_state().values()))) == (devices == 1)
