"""plan-tool: inspect, seed, prune, calibrate and run the exchange-plan DB.

The port's counterpart of ``stencil_tpu.apps.plan_tool``:

- ``show``        every tuned entry (config -> choice, provenance);
- ``explain``     one config's DB entry, static ranking and the chosen plan's
                  ExchangePlan IR (``--placement``: its block -> device
                  table under uniform link costs);
- ``prune``       drop entries by platform / source / age;
- ``seed``        insert the JAX package's recorded CPU-mesh verdicts;
- ``autotune``    tune one config now on ``--device`` or ``--devices`` (a DB
                  hit runs zero probes and says so);
- ``calibrate``   fit constants from a run's attribution records
                  (``plan.attrib.phase``) and install the fitted row in the
                  DB, e.g. ``--platform cuda --from-metrics M.jsonl`` for the
                  card's row;
- ``calibration`` show / diff the installed rows against the platform's
                  constants.

Everything but ``autotune`` runs without a device (the cost model is pure
geometry, the fit pure stdlib).

Usage: python -m stencil_tpu_torch.apps.plan_tool explain --x 128 --y 128 --z 128
           --radius 2 --quantities 4 --ndev 8
       python -m stencil_tpu_torch.apps.plan_tool autotune --db plans.json
           --devices cpu,cpu,cpu,cpu,cpu,cpu,cpu,cpu --x 24 --y 24 --z 24
       python -m stencil_tpu_torch.apps.plan_tool calibrate --db plans.json
           --platform cuda --from-metrics run.jsonl
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

from ..plan import db as plandb
from ..plan.ir import PlanChoice, PlanConfig


def _add_config_flags(p) -> None:
    p.add_argument("--x", type=int, default=24)
    p.add_argument("--y", type=int, default=24)
    p.add_argument("--z", type=int, default=24)
    p.add_argument("--radius", type=int, default=2, help="uniform radius of the config key")
    p.add_argument("--quantities", type=int, default=1)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--ndev", type=int, default=8, help="mesh positions of the config key")
    p.add_argument("--platform", default="cpu", help="'cpu' or 'cuda'")


def _config_from(args) -> PlanConfig:
    from ..geometry import Dim3, Radius

    return PlanConfig.make(Dim3(args.x, args.y, args.z), Radius.constant(args.radius),
                           [args.dtype] * args.quantities, args.ndev, args.platform)


def _entry_row(key: str, entry: dict) -> str:
    cfg = json.loads(key)
    choice = PlanChoice.from_json(entry["choice"])
    g = cfg["grid"]
    qs = ",".join(f"{n}x{dt}" for dt, n in cfg["quantities"])
    measured = entry.get("measured_s")
    return (f"{g[0]}x{g[1]}x{g[2]},{qs},{cfg['ndev']},{cfg['platform']},{choice.label()},"
            f"{entry.get('source')},{'' if measured is None else f'{measured:.6f}'}")


def cmd_show(args) -> int:
    db = plandb.load_db(args.db)
    print("grid,quantities,ndev,platform,choice,source,measured_s")
    for key in sorted(db["entries"]):
        print(_entry_row(key, db["entries"][key]))
    print(f"# {len(db['entries'])} entries")
    return 0


def cmd_explain(args) -> int:
    from ..plan.cost import default_provenance, enumerate_candidates, feasible, rank
    from ..plan.ir import build_plan

    config = _config_from(args)
    print(f"config key: {config.key()}")
    entry = None
    calibration = None
    cal_note = default_provenance(config.platform)
    if args.db:
        db = plandb.load_db(args.db)
        entry = plandb.lookup(db, config)
        cal_row = plandb.lookup_calibration(db, args.platform)
        if cal_row is not None:
            calibration = cal_row["calibration"]
            cal_note = str(cal_row.get("provenance", "fitted"))
    if entry is not None:
        print(f"DB entry: {PlanChoice.from_json(entry['choice']).label()} (source "
              f"{entry['source']}, measured_s {entry.get('measured_s')})")
    else:
        print("DB entry: none (an --autotune run would probe)")
    ranked = rank(config, enumerate_candidates(config), calibration)
    print(f"static ranking ({len(ranked)} feasible candidates; calibration: {cal_note}):")
    for cost, choice in ranked[: args.top]:
        extra = f" dmas={cost.dmas}" if choice.method == "remote-dma" else ""
        print(f"  {choice.label():45s} {cost.total_s * 1e3:9.3f} ms/step  "
              f"permutes={cost.collectives} wire={cost.wire_bytes}{extra}")
    if args.method:
        best = next((ch for _c, ch in ranked if ch.method == args.method), None)
        if best is None:
            print(f"no feasible {args.method} candidate for this config")
            return 1
    else:
        best = (PlanChoice.from_json(entry["choice"]) if entry is not None
                else ranked[0][1] if ranked else None)
    if best is not None:
        feas = feasible(config, best)
        if feas is not None:
            spec, mesh_dim, resident = feas
            plan = build_plan(spec, mesh_dim, best.method, best.batch_quantities, resident,
                              wire_dtype=args.wire_dtype or None)
            print("plan IR of the " + (f"requested {args.method}" if args.method
                                       else "DB" if entry is not None else "best static")
                  + " choice:")
            print(plan.describe())
            if args.placement:
                _explain_placement(args, config, best, spec, mesh_dim)
    return 0


def _explain_placement(args, config, choice, spec, mesh_dim) -> None:
    """The ``explain --placement`` table: the choice's block -> device
    assignment and the per-pair wire bytes x link cost. The port's
    positions share one card, so the links are uniform and every placement
    prices as identity; a non-uniform ``--link-costs`` matrix raises
    (ROADMAP.md queue A item 5)."""
    import numpy as np

    from ..geometry import Dim3
    from ..plan.cost import placement_cost, placement_wire_matrix, uniform_link_costs

    md = Dim3.of(mesh_dim)
    n = md.flatten()
    w = placement_wire_matrix(spec, md, per_cell_bytes=sum(config.itemsizes()))
    link = np.ones((n, n))
    np.fill_diagonal(link, 0.0)
    if args.link_costs:
        with open(args.link_costs) as fh:
            link = np.asarray(json.load(fh), dtype=np.float64)
        if link.shape != (n, n):
            raise SystemExit(f"--link-costs matrix is {link.shape}; the mesh has {n} positions")
        if not uniform_link_costs(link):
            raise NotImplementedError(
                "placement over non-uniform link costs (positions on distinct devices): "
                "ROADMAP.md queue A item 5")
    f = list(choice.placement) if choice.placement is not None else list(range(n))
    print(f"placement ({'tuned' if choice.placement is not None else 'identity'}; link costs: "
          "uniform, every position on one card):")
    for i in range(n):
        iz, rem = divmod(i, md.x * md.y)
        iy, ix = divmod(rem, md.x)
        print(f"  mesh ({ix},{iy},{iz}) -> device {f[i]}")
    print("per-pair wire-bytes x link-cost (placed devices):")
    print("  pair(mesh),devices,wire_bytes,link_cost,product")
    for a in range(n):
        for b in range(n):
            if b <= a or (w[a, b] == 0 and w[b, a] == 0):
                continue
            wb = w[a, b] + w[b, a]
            lc = link[f[a], f[b]]
            print(f"  {a}-{b},{f[a]}-{f[b]},{int(wb)},{lc:g},{wb * lc:g}")
    print(f"total modeled wire cost: placed {placement_cost(w, link, f):g} vs identity "
          f"{placement_cost(w, link):g} (identity-equivalent)")


def cmd_prune(args) -> int:
    db = plandb.load_db(args.db)
    n = plandb.prune_db(db, platform=args.platform or None, source=args.source or None,
                        older_than_s=(args.older_than_days * 86400.0
                                      if args.older_than_days is not None else None))
    plandb.save_db(args.db, db)
    print(f"pruned {n} entries ({len(db['entries'])} remain)")
    return 0


# The JAX package's recorded CPU-mesh verdicts (128^3, radius 2, fp32, 2x2x2
# on its 8-device CPU mesh): axis-composed with batching won each measured
# comparison there. The port runs AXIS_COMPOSED over positions too, so an
# entry seeded for a platform replays there with zero probes; on the card
# that method is copies between positions, host-bound (PERF.md, PR 30).
_SEED_ROWS = (
    (1, 8.85e-3, "round 10: Q=1 batched == per-quantity (same program)"),
    (4, 26.2e-3, "round 7/10: per-quantity 37.4 ms (1.43x); direct26 "
                 "4.2x slower on 1.9x fewer bytes; manual over auto ~4%"),
    (8, 42.9e-3, "round 10: per-quantity 70.6 ms (1.65x); astaroth "
                 "8-field exchange 1.46x by the same mechanism"),
)


def cmd_seed(args) -> int:
    from ..geometry import Dim3, Radius

    db = plandb.load_db(args.db)
    n = 0
    for q, measured_s, note in _SEED_ROWS:
        config = PlanConfig.make(Dim3(128, 128, 128), Radius.constant(2), ["float32"] * q, 8,
                                 args.platform)
        if plandb.lookup(db, config) is not None and not args.force:
            continue
        choice = PlanChoice(partition=(2, 2, 2), method="axis-composed", batch_quantities=True)
        plandb.record(db, plandb.make_entry(config, choice, "seed", measured_s=measured_s,
                                            note=f"BASELINE.md recorded verdict — {note}"))
        n += 1
    plandb.save_db(args.db, db)
    print(f"seeded {n} entries into {args.db} ({len(db['entries'])} total)")
    return 0


def cmd_calibrate(args) -> int:
    """Fit a calibration row from attribution records (a metrics JSONL or a
    ledger) and install it in the plan DB for ``--platform``."""
    from ..obs import telemetry
    from ..plan import calibrate as cal
    from ..plan.cost import platform_calibration

    if bool(args.from_metrics) == bool(args.from_ledger):
        raise SystemExit("calibrate needs exactly one evidence source: --from-metrics "
                         "METRICS.jsonl or --from-ledger LEDGER.jsonl")
    if args.from_metrics:
        with open(args.from_metrics) as f:
            lines = f.readlines()
        _n_ok, errs = telemetry.validate_jsonl(lines)
        if errs:
            raise SystemExit(f"{args.from_metrics}: {len(errs)} schema-invalid records (first: "
                             f"{errs[0]}) - refusing to fit from a corrupt metrics file")
        samples = cal.samples_from_records([json.loads(ln) for ln in lines if ln.strip()])
        src = args.from_metrics
    else:
        from ..obs.ledger import load_ledger

        samples = cal.samples_from_ledger(load_ledger(args.from_ledger))
        src = args.from_ledger
    if args.phase:
        # one phase is one measurement population
        want = set(args.phase)
        samples = [s for s in samples if s.phase in want]
        if not samples:
            raise SystemExit(f"no attribution samples match --phase {sorted(want)} in {src}")
    try:
        row = cal.fit(samples, platform=args.platform)
    except cal.CalibrationError as e:
        raise SystemExit(f"calibration fit refused: {e}")
    db = plandb.load_db(args.db)
    plandb.record_calibration(db, args.platform, row)
    plandb.save_db(args.db, db)
    print(f"fitted {args.platform} calibration from {len(samples)} samples ({src}) -> {args.db}")
    print(f"provenance: {row['provenance']}"
          + ("" if row["bandwidth_fit"] else "  [bandwidth pinned at the platform's value: the "
                                             "samples share one (collectives, bytes) point]"))
    for name, fitted, base_v in cal.diff_rows(row, platform_calibration(args.platform)):
        print(f"  {name:45s} {fitted:.6e}  (default {base_v:.6e}, {fitted / base_v:.2f}x)")
    if args.metrics_out:
        rec = telemetry.configure(metrics_out=args.metrics_out, app="plan_tool",
                                  run_id=args.run_id or None, config=vars(args))
        rec.meta("calibration.fitted", platform=args.platform, n=int(row["n"]),
                 provenance=row["provenance"], r2=float(row["r2"]))
        rec.close()
    return 0


def cmd_calibration(args) -> int:
    """``show``: the DB's fitted rows. ``diff``: fitted constants against
    the platform's defaults, one line per constant."""
    from ..plan import calibrate as cal
    from ..plan.cost import platform_calibration

    db = plandb.load_db(args.db)
    cals = db.get("calibrations") or {}
    if args.action == "show":
        if not cals:
            print("no fitted calibrations (the platforms' defaults apply)")
            return 0
        print("platform,provenance,n,r2,bandwidth_fit")
        for platform in sorted(cals):
            row = cals[platform]
            print(f"{platform},{row['provenance']},{row['n']},{row['r2']:.4f},"
                  f"{row.get('bandwidth_fit', False)}")
        return 0
    platforms = [args.platform] if args.platform else sorted(cals)
    if not platforms:
        print("no fitted calibrations to diff (the platforms' defaults apply)")
        return 0
    for platform in platforms:
        row = cals.get(platform)
        if row is None:
            print(f"{platform}: no fitted row (the platform's defaults apply)")
            continue
        print(f"{platform} ({row['provenance']}):")
        print("  constant,fitted,default,ratio")
        for name, fitted, base_v in cal.diff_rows(row, platform_calibration(platform)):
            print(f"  {name},{fitted:.6e},{base_v:.6e},{fitted / base_v:.3f}")
    return 0


def cmd_autotune(args) -> int:
    from ..geometry import Dim3, Radius
    from ..obs import telemetry
    from ..plan.autotune import autotune
    from ..plan.cost import DEFAULT_VARIANTS, PLANNED_METHODS
    from ..plan.ir import FUSED_VARIANT, PERSISTENT_VARIANT
    from ._bench_common import finish_metrics, start_metrics

    start_metrics(args, "plan_tool")
    methods = tuple(t for t in args.methods.split(",") if t) or None
    for m in methods or ():
        if m not in PLANNED_METHODS:
            raise SystemExit(f"unknown method {m!r} (choose from {PLANNED_METHODS})")
    if args.variants:
        variants = []
        for t in (s.strip() for s in args.variants.split(",") if s.strip()):
            if t == "none":
                variants.append(None)
            elif t in (FUSED_VARIANT, PERSISTENT_VARIANT):
                variants.append(t)
            else:
                raise SystemExit(f"unknown kernel variant {t!r} (choose from "
                                 f"'{FUSED_VARIANT}', '{PERSISTENT_VARIANT}', 'none')")
        variants = tuple(variants)
    else:
        variants = DEFAULT_VARIANTS
    ks = tuple(int(t) for t in args.ks.split(",") if t.strip()) or (1,)
    if any(k < 1 for k in ks):
        raise SystemExit(f"--ks depths must be >= 1, got {ks}")
    devices = (args.devices.split(",") if args.devices
               else [args.device] if args.device else None)
    res = autotune(Dim3(args.x, args.y, args.z), Radius.constant(args.radius),
                   [args.dtype] * args.quantities, devices=devices, db_path=args.db or None,
                   top_n=args.top_n, probe_iters=args.probe_iters, probe=not args.no_probe,
                   force=args.force, methods=methods, ks=ks, variants=variants)
    print(f"chosen: {res.choice.label()}")
    print(f"source: {res.source}  cache_hit: {res.cache_hit}  probes_run: {res.probes_run}  "
          f"candidates: {res.candidates}")
    for p in res.probes:
        if "trimean_s" in p:
            print(f"  probe {p['label']:45s} {p['trimean_s'] * 1e3:9.3f} ms")
        else:
            print(f"  probe {p['label']:45s} FAILED: {p.get('error')}")
    finish_metrics(telemetry.get())
    return 0


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description="exchange-plan DB tool")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("show", help="list tuned entries")
    sp.add_argument("--db", required=True)

    sp = sub.add_parser("explain", help="DB entry + static ranking + plan IR of one config")
    sp.add_argument("--db", default="")
    sp.add_argument("--top", type=int, default=8)
    sp.add_argument("--method", default="", choices=("",) + plandb.METHODS,
                    help="dump this method's plan IR instead of the ranked best")
    sp.add_argument("--wire-dtype", default="",
                    help="render the plan's wire bytes under this wire dtype (e.g. bfloat16)")
    sp.add_argument("--placement", action="store_true",
                    help="also render the block -> device table and the per-pair wire bytes "
                         "x link costs")
    sp.add_argument("--link-costs", default="",
                    help="JSON ndev x ndev link-cost matrix for --placement (uniform only: "
                         "positions on distinct devices are not ported)")
    _add_config_flags(sp)

    sp = sub.add_parser("prune", help="drop entries by filter")
    sp.add_argument("--db", required=True)
    sp.add_argument("--platform", default="")
    sp.add_argument("--source", default="", choices=("",) + plandb.SOURCES)
    sp.add_argument("--older-than-days", type=float, default=None)

    sp = sub.add_parser("seed", help="insert the JAX package's recorded CPU verdicts")
    sp.add_argument("--db", required=True)
    sp.add_argument("--platform", default="cpu")
    sp.add_argument("--force", action="store_true",
                    help="overwrite existing entries at the seed keys")

    sp = sub.add_parser("calibrate", help="fit constants from attribution records and "
                                          "install them in the DB")
    sp.add_argument("--db", required=True)
    sp.add_argument("--from-metrics", default="",
                    help="metrics JSONL with plan.attrib.phase records (a --metrics-out file)")
    sp.add_argument("--from-ledger", default="",
                    help="a ledger with plan.attrib.* entries (one trimean per run and phase)")
    sp.add_argument("--phase", action="append", default=None,
                    help="fit only samples of this phase (repeatable)")
    sp.add_argument("--platform", default="cpu",
                    help="platform the fitted row serves ('cpu' or 'cuda')")
    sp.add_argument("--metrics-out", default="",
                    help="also append a calibration.fitted telemetry record here")
    sp.add_argument("--run-id", default="")

    sp = sub.add_parser("calibration", help="show or diff the DB's fitted calibrations")
    sp.add_argument("action", choices=("show", "diff"))
    sp.add_argument("--db", required=True)
    sp.add_argument("--platform", default="", help="restrict diff to one platform")

    sp = sub.add_parser("autotune", help="tune one config now")
    sp.add_argument("--db", default="")
    sp.add_argument("--device", default=None,
                    help="torch device of the probes (default: the current CUDA device)")
    sp.add_argument("--devices", default="",
                    help="comma list of torch devices, one mesh position each (repeats "
                         "allowed, e.g. cuda:0,cuda:0)")
    sp.add_argument("--top-n", type=int, default=3)
    sp.add_argument("--probe-iters", type=int, default=4)
    sp.add_argument("--no-probe", action="store_true", help="static ranking only")
    sp.add_argument("--force", action="store_true", help="re-tune through an existing entry")
    sp.add_argument("--methods", default="",
                    help="comma list restricting the searched methods (default: what the "
                         "devices realize)")
    sp.add_argument("--variants", default="",
                    help="comma list of kernel variants: 'fused', 'persistent' (needs --ks "
                         "depths >= 2), 'none'; default: the plain program plus remote-dma's "
                         "fused (and, when --ks reach 2, persistent) variant")
    sp.add_argument("--ks", default="1", help="comma list of temporal depths to search")
    _add_config_flags(sp)
    from ._bench_common import add_metrics_flags

    add_metrics_flags(sp)
    args = p.parse_args(argv)
    return {"show": cmd_show, "explain": cmd_explain, "prune": cmd_prune, "seed": cmd_seed,
            "calibrate": cmd_calibrate, "calibration": cmd_calibration,
            "autotune": cmd_autotune}[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
