"""The port's plan DB (stencil_tpu_torch/plan/db.py) against the JAX
package's (tests/test_plan_db.py): a DB saved by either package loads in the
other and replays its entry (and its fitted calibration row); the corrupt,
wrong-kind, future, tampered, mis-keyed, v0 and v0-garbage files get the
same verdicts from both; prune and the save guard agree. No device, no JAX
compilation. Tolerance: exact equality."""

import json
import os

import pytest

import stencil_tpu.plan.db as jdb
import stencil_tpu_torch.plan.db as tdb
from stencil_tpu.geometry import Dim3 as JDim3, Radius as JRadius
from stencil_tpu.plan.ir import PlanChoice as JChoice, PlanConfig as JConfig
from stencil_tpu_torch.geometry import Dim3, Radius
from stencil_tpu_torch.plan.ir import PlanChoice, PlanConfig


def tconfig(q=4, grid=(64, 64, 64), platform="cpu", ndev=8):
    return PlanConfig.make(Dim3.of(grid), Radius.constant(2), ["float32"] * q, ndev, platform)


def jconfig(q=4, grid=(64, 64, 64), platform="cpu", ndev=8):
    return JConfig.make(JDim3.of(grid), JRadius.constant(2), ["float32"] * q, ndev, platform)


CHOICES = [dict(partition=(2, 2, 2), method="axis-composed"),
           dict(partition=(1, 1, 8), method="remote-dma", kernel_variant="fused"),
           dict(partition=(2, 2, 2), method="remote-dma", multistep_k=2,
                kernel_variant="persistent", batch_quantities=False)]


@pytest.mark.parametrize("kw", CHOICES)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_db_interchanges_both_ways(tmp_path, kw, writer):
    path = str(tmp_path / "plans.json")
    w, cfg, choice = ((jdb, jconfig(), JChoice(**kw)) if writer == "jax"
                      else (tdb, tconfig(), PlanChoice(**kw)))
    db = w.empty_db()
    w.record(db, w.make_entry(cfg, choice, "probe", static_cost_s=1e-3, measured_s=2.5e-3,
                              probes=[{"label": choice.label(), "trimean_s": 2.5e-3}]))
    w.record_calibration(db, "cpu", {"calibration": {"wire_bytes_per_s": 1e9},
                                     "provenance": "fitted(n=3, r2=0.900)", "n": 3, "r2": 0.9})
    w.save_db(path, db)
    for reader, rcfg in ((tdb, tconfig()), (jdb, jconfig())):
        loaded = reader.load_db(path)
        entry = reader.lookup(loaded, rcfg)
        assert entry is not None and entry["choice"] == choice.to_json()
        assert entry["measured_s"] == 2.5e-3 and entry["source"] == "probe"
        assert reader.lookup_calibration(loaded, "cpu")["calibration"] == \
            {"wire_bytes_per_s": 1e9}
        assert reader.lookup(loaded, rcfg.__class__.make(
            (64, 64, 64) if reader is tdb else JDim3(64, 64, 64),
            Radius.constant(2) if reader is tdb else JRadius.constant(2),
            ["float32"] * 4, 8, "cuda")) is None
    # the port re-saves the JAX file without changing a byte of its meaning
    tdb.save_db(path, tdb.load_db(path))
    assert jdb.load_db(path) == tdb.load_db(path)


def test_foreign_platform_rows_load_but_never_match(tmp_path):
    path = str(tmp_path / "plans.json")
    db = jdb.empty_db()
    for platform in ("tpu", "gpu"):
        jdb.record(db, jdb.make_entry(jconfig(platform=platform), JChoice((2, 2, 2),
                                                                          "auto-spmd"), "probe"))
    jdb.save_db(path, db)
    loaded = tdb.load_db(path)
    assert len(loaded["entries"]) == 2
    for platform in ("cpu", "cuda"):
        assert tdb.lookup(loaded, tconfig(platform=platform)) is None


def verdict(mod, path):
    try:
        mod.load_db(path)
    except mod.PlanDBError as e:
        return ("error", type(e).__name__, str(e).split(":")[0])
    return ("ok",)


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)


def _torn(path):
    jdb.save_db(path, jdb.empty_db())
    with open(path, "r+") as f:
        f.truncate(10)


def _tampered(path, field):
    db = jdb.empty_db()
    jdb.record(db, jdb.make_entry(jconfig(), JChoice((2, 2, 2), "axis-composed"), "probe"))
    jdb.save_db(path, db)
    raw = json.load(open(path))
    key = next(iter(raw["entries"]))
    if field == "method":
        raw["entries"][key]["choice"]["method"] = "warp-drive"
    elif field == "key":
        raw["entries"]["{}"] = raw["entries"].pop(key)
    elif field == "placement":
        raw["entries"][key]["choice"]["placement"] = [0, 0, 1, 2, 3, 4, 5, 6]
    elif field == "calibration":
        raw["calibrations"] = {"cpu": {"calibration": {}, "provenance": "", "n": 1, "r2": "x"}}
    _write(path, raw)


CASES = {
    "missing": lambda p: None,
    "torn": _torn,
    "wrong kind": lambda p: _write(p, {"v": 1, "kind": "not-a-plan-db", "entries": {}}),
    "future": lambda p: _write(p, {"v": 99, "kind": jdb.DB_KIND, "entries": {}}),
    "tampered method": lambda p: _tampered(p, "method"),
    "key mismatch": lambda p: _tampered(p, "key"),
    "bad placement": lambda p: _tampered(p, "placement"),
    "bad calibration row": lambda p: _tampered(p, "calibration"),
    "v0 flat": lambda p: _write(p, {jconfig().key(): JChoice((2, 2, 2),
                                                             "axis-composed").to_json()}),
    "v0 garbage": lambda p: _write(p, {"some": "junk"}),
}


def untimed(db):
    """``db`` without the entries' ``written_t`` (a migration stamps now)."""
    return {**db, "entries": {k: {f: v for f, v in e.items() if f != "written_t"}
                              for k, e in db["entries"].items()}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_verdicts_as_jax(tmp_path, case):
    path = str(tmp_path / "plans.json")
    CASES[case](path)
    assert verdict(tdb, path) == verdict(jdb, path)
    if verdict(tdb, path) == ("ok",):
        assert untimed(tdb.load_db(path)) == untimed(jdb.load_db(path))
    if case == "v0 flat":
        entry = tdb.lookup(tdb.load_db(path), tconfig())
        assert entry["source"] == "legacy"
        assert PlanChoice.from_json(entry["choice"]) == PlanChoice((2, 2, 2), "axis-composed")


def test_atomic_save_and_guards(tmp_path):
    path = str(tmp_path / "plans.json")
    db = tdb.empty_db()
    tdb.record(db, tdb.make_entry(tconfig(), PlanChoice((2, 2, 2), "axis-composed"), "probe"))
    tdb.save_db(path, db)
    assert not [e for e in os.listdir(tmp_path) if e.startswith(".tmp-")]
    with pytest.raises(tdb.PlanDBError, match="refusing"):
        tdb.save_db(str(tmp_path / "x.json"), {"v": 1, "kind": "nope", "entries": {}})
    with pytest.raises(ValueError, match="unknown plan source"):
        tdb.make_entry(tconfig(), PlanChoice((2, 2, 2), "axis-composed"), "guess")
    with pytest.raises(tdb.PlanDBError, match="refusing"):
        tdb.record_calibration(db, "cuda", {"calibration": {}, "provenance": "p", "n": 1,
                                            "r2": 0.5})


def test_prune_matches_jax():
    dbs = []
    for mod, cfg, ch in ((tdb, tconfig, PlanChoice), (jdb, jconfig, JChoice)):
        db = mod.empty_db()
        mod.record(db, mod.make_entry(cfg(q=1), ch((2, 2, 2), "axis-composed"), "seed"))
        mod.record(db, mod.make_entry(cfg(q=2), ch((2, 2, 2), "axis-composed"), "probe"))
        mod.record(db, mod.make_entry(cfg(q=2, platform="cuda"), ch((2, 2, 2), "remote-dma"),
                                      "probe"))
        with pytest.raises(ValueError, match="filter"):
            mod.prune_db(db)
        dbs.append((mod.prune_db(db, source="seed"), mod.prune_db(db, platform="cuda"),
                    mod.prune_db(db, older_than_s=3600.0), sorted(db["entries"])))
    assert dbs[0] == dbs[1] == (1, 1, 0, dbs[0][3])
