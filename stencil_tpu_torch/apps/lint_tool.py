"""lint_tool — the analysis front end (stencil_tpu_torch/analysis/).

The port's counterpart of ``stencil_tpu.apps.lint_tool``. Subcommands,
with perf_tool's gate semantics (exit 1 on new findings / failed checks,
exit 2 when nothing was analyzed — a validate-nothing run must never read
as a pass):

- ``lint``        AST lint of the port's own contracts (astlint.py):
                  rule registry, inline ``# lint: disable=<rule>``
                  suppressions, the committed fingerprint baseline
                  (``stencil_tpu_torch/analysis/lint-baseline.json``).
                  ``--changed`` restricts to ``git diff --name-only``
                  files (the fast pre-commit path). Default paths:
                  ``stencil_tpu_torch/`` and ``chip_smoke.py``.
- ``verify-plan`` the ExchangePlan IR against what the port executed
                  (verify_plan.py): per-config message, byte, copy and
                  launch checks; infeasible configs (plan/cost.feasible)
                  are skipped loudly, an all-skipped sweep exits 2.
                  ``--methods auto-spmd``, ``--placements`` and
                  ``--hierarchy`` raise (ROADMAP.md queue A item 5).
- ``jit-audit``   step-loop audit (jit_audit.py): first-use work and, on
                  the card, host syncs after warm-up in the jacobi chunk
                  loop; ``--inject recompile|host-sync`` are the
                  must-fail fixtures.
- ``all``         the full suite.

``--json`` prints one machine-readable document; ``--metrics-out``
records the schema-valid ``analysis.*`` telemetry vocabulary.

Devices: on the card by default (verify-plan over 8 positions of the
current CUDA device, jit-audit on one block); ``--devices D,...`` names
positions, ``--cpu N`` takes N CPU positions (the JAX package's N
virtual CPU devices).

Usage:
  python -m stencil_tpu_torch.apps.lint_tool lint
  python -m stencil_tpu_torch.apps.lint_tool lint --changed
  python -m stencil_tpu_torch.apps.lint_tool verify-plan --cpu 8
  python -m stencil_tpu_torch.apps.lint_tool jit-audit --cpu 8
  python -m stencil_tpu_torch.apps.lint_tool all --cpu 8 --json
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_BASELINE = os.path.join("stencil_tpu_torch", "analysis", "lint-baseline.json")


def _parse_partitions(text: str) -> List[tuple]:
    out = []
    for tok in text.split(","):
        tok = tok.strip()
        if not tok:
            continue
        parts = tok.split("x")
        if len(parts) != 3 or not all(p.isdigit() and int(p) >= 1
                                      for p in parts):
            raise ValueError(f"bad partition {tok!r} (want e.g. 2x2x2)")
        out.append(tuple(int(p) for p in parts))
    if not out:
        raise ValueError("empty partition list")
    return out


def _parse_qsets(text: str) -> List[tuple]:
    """``f32,f32+f64`` -> [("float32",), ("float32", "float64")]."""
    names = {"f32": "float32", "f64": "float64", "float32": "float32",
             "float64": "float64"}
    out = []
    for group in text.split(","):
        group = group.strip()
        if not group:
            continue
        dts = []
        for tok in group.split("+"):
            tok = tok.strip()
            if tok not in names:
                raise ValueError(f"bad dtype {tok!r} (known: "
                                 f"{', '.join(sorted(set(names)))})")
            dts.append(names[tok])
        out.append(tuple(dts))
    if not out:
        raise ValueError("empty quantity list")
    return out


def changed_files(root: str) -> List[str]:
    """Python files touched vs HEAD (staged + unstaged) plus untracked —
    the pre-commit scope. Raises RuntimeError when git is unusable."""
    files = set()
    for args in (["git", "diff", "--name-only", "HEAD"],
                 ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            p = subprocess.run(args, cwd=root, capture_output=True,
                               text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"{' '.join(args)}: {e}")
        if p.returncode != 0:
            raise RuntimeError(
                f"{' '.join(args)} failed: {p.stderr.strip()[:200]}")
        files.update(ln.strip() for ln in p.stdout.splitlines()
                     if ln.strip())
    return sorted(
        f for f in files
        if f.endswith(".py") and os.path.exists(os.path.join(root, f)))


def cmd_lint(args) -> int:
    from ..analysis import astlint

    root = args.root or REPO_ROOT
    if args.list_rules:
        for name in sorted(astlint.RULES):
            r = astlint.RULES[name]
            print(f"{name:24s} [{r.severity}] {r.doc}")
        return 0
    rules = ([t.strip() for t in args.rules.split(",") if t.strip()]
             if args.rules else None)
    if args.changed:
        try:
            paths = changed_files(root)
        except RuntimeError as e:
            print(f"[lint] --changed: {e}", file=sys.stderr)
            return 2
        if not paths:
            print("[lint] --changed: no changed Python files — "
                  "nothing to lint")
            return 0
    else:
        paths = args.paths or list(astlint.DEFAULT_PATHS)
    # expand once; lint_paths on the explicit file list is per-file
    # stats, not a second recursive walk
    files = astlint.iter_py_files(paths, root)
    try:
        findings, errors = astlint.lint_paths(files, repo_root=root,
                                              rules=rules)
    except ValueError as e:
        print(f"[lint] {e}", file=sys.stderr)
        return 2
    n_files = len(files)
    if n_files == 0:
        if args.changed:
            # an all-tests (or all-excluded) change set is a legitimately
            # empty input for the pre-commit hook, not a mistyped path
            print("[lint] --changed: every changed file is outside the "
                  "lint scope — nothing to lint")
            return 0
        print(f"[lint] no Python files under {paths!r} — nothing "
              "analyzed", file=sys.stderr)
        return 2

    baseline_path = args.baseline or os.path.join(root, DEFAULT_BASELINE)
    try:
        baseline = astlint.load_baseline(baseline_path)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"[lint] bad baseline {baseline_path}: {e}", file=sys.stderr)
        return 2
    new = [f for f in findings if f.fingerprint not in baseline]
    baselined = [f for f in findings if f.fingerprint in baseline]

    if args.write_baseline:
        astlint.write_baseline(baseline_path, findings)
        print(f"[lint] baseline rewritten: {len(findings)} fingerprint(s) "
              f"-> {baseline_path}")

    rec = _metrics(args, "lint_tool")
    if rec.enabled:
        rec.meta("analysis.lint", findings=len(findings), new=len(new),
                 baselined=len(baselined), files=n_files)

    if args.json:
        print(json.dumps({
            "kind": "lint-report", "files": n_files,
            "findings": [f.to_json() for f in new],
            "baselined": len(baselined), "new": len(new),
            "errors": errors,
        }, indent=1, sort_keys=True))
    else:
        for f in new:
            print(f.render())
        for e in errors:
            print(f"[lint] ERROR {e}", file=sys.stderr)
        print(f"[lint] {n_files} file(s): {len(new)} new finding(s), "
              f"{len(baselined)} baselined")
    if errors:
        # an unparseable file is an analysis failure, not a pass
        return 1
    return 1 if new else 0


def cmd_verify_plan(args) -> int:
    from ..analysis import verify_plan as vp

    try:
        methods = ([t.strip() for t in args.methods.split(",") if t.strip()]
                   if args.methods else None)
        configs = vp.sweep_configs(
            size=args.size, radius=args.radius,
            partitions=_parse_partitions(args.partitions),
            methods=methods, qsets=_parse_qsets(args.quantities))
    except ValueError as e:
        print(f"[verify-plan] {e}", file=sys.stderr)
        return 2
    for flag in ("placements", "hierarchy"):
        if getattr(args, flag, 0):
            raise NotImplementedError(f"verify-plan --{flag}: ROADMAP.md queue A item 5")
    rec = _metrics(args, "lint_tool")
    devices = _devices(args, "verify-plan")
    res = vp.run_sweep(configs, devices=devices,
                       perturb_collectives=args.perturb_collectives,
                       perturb_wire=args.perturb_wire,
                       perturb_dmas=args.perturb_dmas, rec=rec)
    if getattr(args, "time", 0):
        calibration = None
        if getattr(args, "time_db", ""):
            import torch

            from ..plan import db as plandb

            db = plandb.load_db(args.time_db)
            row = plandb.lookup_calibration(db, torch.device(devices[0]).type)
            if row is not None:
                calibration = row["calibration"]
        # the timed grid is deliberately small (first partition, one
        # f32 quantity, the base methods): it judges seconds, and
        # wall-clock per config is iters x a real exchange
        tconfigs = vp.sweep_configs(
            size=args.size, radius=args.radius,
            partitions=_parse_partitions(args.partitions)[:1],
            methods=methods, qsets=(("float32",),))
        tres = vp.run_time_sweep(tconfigs, devices=devices, iters=args.time,
                                 calibration=calibration,
                                 rel_tol=args.time_rel_tol,
                                 slow_s=args.time_slow, rec=rec)
        res = {
            "verdicts": res["verdicts"] + tres["verdicts"],
            "checked": res["checked"] + tres["checked"],
            "failed": res["failed"] + tres["failed"],
            "skipped": res["skipped"] + tres["skipped"],
        }
    verdicts = res["verdicts"]
    if args.json:
        print(json.dumps({
            "kind": "plan-sweep",
            "verdicts": [v.to_json() for v in verdicts],
            "checked": res["checked"], "failed": res["failed"],
            "skipped": res["skipped"],
        }, indent=1, sort_keys=True))
    else:
        for v in verdicts:
            if v.skipped:
                print(f"SKIP {v.label}: {v.reason}")
            elif v.ok:
                print(f"ok   {v.label}")
            else:
                bad = [c for c in v.checks if c["ok"] is False]
                detail = "; ".join(
                    f"{c['name']} predicted {c['predicted']} != "
                    f"actual {c['actual']}" for c in bad) or v.reason
                print(f"FAIL {v.label}: {detail}")
            for c in v.checks:
                if c["ok"] is None:
                    print(f"     not made: {c['name']} (predicted {c['predicted']}): "
                          f"{c['not_made']}")
        print(f"[verify-plan] {res['checked']} checked, "
              f"{res['failed']} failed, {res['skipped']} skipped")
    if res["checked"] == 0:
        print("[verify-plan] nothing analyzed: every sweep config was "
              "infeasible for this host (device count / radius "
              "constraints via plan/cost.feasible) — not a pass",
              file=sys.stderr)
        return 2
    return 1 if res["failed"] else 0


def cmd_jit_audit(args) -> int:
    from ..analysis import jit_audit as ja

    rec = _metrics(args, "lint_tool")
    try:
        r = ja.run_audit(size=args.size, iters=args.iters,
                         chunk=args.chunk, inject=args.inject or None,
                         devices=_devices(args, "jit-audit"), rec=rec)
    except ValueError as e:
        print(f"[jit-audit] {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(r.to_json(), indent=1, sort_keys=True))
    else:
        verdict = "PASS" if r.ok else "FAIL"
        print(f"[jit-audit] {verdict}: {r.steps} step(s) in {r.chunks} "
              f"chunk(s); {r.recompiles} post-warmup first-use event(s) "
              f"{r.first_use}, {len(r.transfer_trips)} host sync(s) caught "
              f"({r.warmup_compiles} warmup first-use events)")
        for t in r.transfer_trips:
            print(f"  host sync: {t}")
        for n in r.not_made:
            print(f"  not made: {n['check']}: {n['reason']}")
    return 0 if r.ok else 1


def cmd_all(args) -> int:
    rcs = {}
    print("== lint ==")
    rcs["lint"] = cmd_lint(args)
    print("== verify-plan ==")
    rcs["verify-plan"] = cmd_verify_plan(args)
    print("== jit-audit ==")
    rcs["jit-audit"] = cmd_jit_audit(args)
    print("[all] " + "  ".join(f"{k}: rc={v}" for k, v in rcs.items()))
    if any(rc == 1 for rc in rcs.values()):
        return 1
    if any(rc == 2 for rc in rcs.values()):
        return 2
    return 0


def _metrics(args, app: str):
    from ._bench_common import start_metrics

    return start_metrics(args, app)


def _devices(args, cmd: str):
    """The positions of ``--cpu N`` / ``--devices``; None for the card's
    default (``verify_plan.default_positions`` for verify-plan, the
    current CUDA device for jit-audit)."""
    if getattr(args, "cpu", 0):
        return ["cpu"] * args.cpu
    if getattr(args, "devices", ""):
        return args.devices.split(",")
    if cmd == "verify-plan":
        from ..analysis.verify_plan import default_positions

        return default_positions()
    return None


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="lint_tool",
        description="analysis: the port's lint, the plan IR against the executed "
                    "exchanges, the step loop's first-use work and host syncs")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, backend=False):
        sp.add_argument("--json", action="store_true",
                        help="machine-readable output")
        sp.add_argument(
            "--metrics-out",
            default=os.environ.get("STENCIL_METRICS_OUT", ""),
            help="append analysis.* telemetry records here (schema "
                 "obs/telemetry.py; report --validate gates them)")
        sp.add_argument("--run-id", default="")
        if backend:
            sp.add_argument("--cpu", type=int, default=0,
                            help="run on N CPU positions (the JAX package's N virtual "
                                 "CPU devices)")
            sp.add_argument("--devices", default="",
                            help="comma-separated positions, e.g. cuda:0,cuda:0 "
                                 "(default: the card)")

    def lint_flags(sp):
        sp.add_argument("paths", nargs="*",
                        help="files/dirs to lint (default: stencil_tpu_torch/ "
                             "and chip_smoke.py)")
        sp.add_argument("--changed", action="store_true",
                        help="lint only `git diff --name-only` files "
                             "(+ untracked) — the pre-commit path")
        sp.add_argument("--baseline", default="",
                        help=f"fingerprint baseline file (default "
                             f"{DEFAULT_BASELINE} under the repo root)")
        sp.add_argument("--write-baseline", action="store_true",
                        help="rewrite the baseline with the current "
                             "findings (atomic)")
        sp.add_argument("--rules", default="",
                        help="comma-separated rule subset")
        sp.add_argument("--list-rules", action="store_true")
        sp.add_argument("--root", default="",
                        help="repo root (default: autodetected)")

    def plan_flags(sp):
        sp.add_argument("--size", type=int, default=16)
        sp.add_argument("--radius", type=int, default=2)
        sp.add_argument("--partitions", default="2x2x2,1x2x4")
        sp.add_argument("--methods", default="",
                        help="comma-separated method subset (default: every "
                             "label but auto-spmd, which raises)")
        sp.add_argument("--quantities", default="f32,f32+f32+f32,"
                                                "f32+f32+f64",
                        help="comma-separated quantity groups, dtypes "
                             "joined by + (e.g. f32,f32+f64)")
        sp.add_argument("--perturb-collectives", type=int, default=0,
                        help="offset the IR's message prediction "
                             "(the auditor must TRIP — the proof knob)")
        sp.add_argument("--perturb-wire", type=int, default=0)
        sp.add_argument("--perturb-dmas", type=int, default=0)
        sp.add_argument("--hierarchy", type=int, default=0,
                        help="the JAX package's hierarchical (DCN) audit over N "
                             "hosts: raises (ROADMAP.md queue A item 5)")
        sp.add_argument("--placements", type=int, default=0,
                        help="the JAX package's placement audit: raises "
                             "(ROADMAP.md queue A item 5)")
        sp.add_argument("--time", type=int, default=0,
                        help="ALSO time N exchange iterations per method "
                             "on the first partition (single-f32 grid) "
                             "and judge the cost model's predicted "
                             "seconds against the measured trimean±MAD "
                             "band — the calibration drift sentinel (0 = off)")
        sp.add_argument("--time-db", default="",
                        help="plan DB whose fitted calibration row for the "
                             "platform prices the --time predictions (default: "
                             "the platform's row of plan/cost)")
        sp.add_argument("--time-rel-tol", type=float, default=0.75,
                        help="--time band floor as a fraction of the "
                             "measured trimean (default 0.75 — wide: a "
                             "few in-process samples judge multiple-x "
                             "staleness, not 5%% drift; keep it < 1 or "
                             "an under-prediction can never trip)")
        sp.add_argument("--time-slow", type=float, default=0.0,
                        help="sleep this many seconds inside one timed "
                             "iteration (the --time auditor must TRIP — "
                             "the proof knob, like --perturb-*)")

    def audit_flags(sp):
        sp.add_argument("--size", type=int, default=16)
        sp.add_argument("--iters", type=int, default=10)
        sp.add_argument("--chunk", type=int, default=4)
        sp.add_argument("--inject", default="",
                        choices=["", "recompile", "host-sync"],
                        help="deliberately-bad fixtures: skip warming "
                             "the tail chunk size / pull a scalar "
                             "inside the guarded region — the audit must FAIL "
                             "(host-sync: where the check is made)")

    sp = sub.add_parser("lint", help="AST lint of the port's contracts")
    lint_flags(sp)
    common(sp)

    sp = sub.add_parser("verify-plan",
                        help="ExchangePlan IR vs the executed exchanges")
    plan_flags(sp)
    common(sp, backend=True)

    sp = sub.add_parser("jit-audit",
                        help="first-use/host-sync audit of the step loop")
    audit_flags(sp)
    common(sp, backend=True)

    sp = sub.add_parser("all", help="the full suite")
    lint_flags(sp)
    plan_flags(sp)
    # jit-audit's --size collides with verify-plan's; `all` shares one
    # --size (16 suits both) and dedicated iters/chunk/inject knobs
    sp.add_argument("--iters", type=int, default=10)
    sp.add_argument("--chunk", type=int, default=4)
    sp.add_argument("--inject", default="")
    common(sp, backend=True)

    args = p.parse_args(argv)

    if args.cmd == "lint":
        return cmd_lint(args)
    if args.cmd == "verify-plan":
        return cmd_verify_plan(args)
    if args.cmd == "jit-audit":
        return cmd_jit_audit(args)
    if args.cmd == "all":
        return cmd_all(args)
    raise AssertionError(args.cmd)


if __name__ == "__main__":
    raise SystemExit(main())
