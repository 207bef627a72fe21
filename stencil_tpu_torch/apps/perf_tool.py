"""perf_tool -- the performance ledger's CLI: ingest, trend, diff, gate, drift, render.

The port's counterpart of ``stencil_tpu.apps.perf_tool``, with the same
output byte for byte and the same exit codes, over the same v1 ledger files
(``obs/ledger.py`` is the storage + ingest library). Rounds of
BENCH/MULTICHIP payloads and metrics-JSONL gauge trimeans land as keyed
ledger entries, and this tool turns the accumulated history into

- ``trend``:  per-leg tables across round labels (value, delta vs prev);
- ``diff``:   one label vs another, per leg;
- ``gate``:   the regression sentinel: a new measurement must sit inside
  its leg's trimean +- MAD tolerance band (per-leg thresholds
  configurable; direction-aware: a throughput leg trips LOW, a seconds
  leg trips HIGH); exits 1 with a named-leg verdict, 2 on a usage error
  or when nothing was judged;
- ``drift``:  the calibration drift sentinel: the installed cost-model
  calibration's per-phase predictions must sit inside the measured
  attribution samples' trimean +- MAD band (``obs/attribution.judge_drift``,
  the same band formula as ``gate``); exits 1 naming the phase;
- ``render``: a markdown dashboard for CI artifacts;
- ``ingest``: map payload files into the ledger (``--legacy`` for the
  committed BENCH_r0*/MULTICHIP_r0* shapes; metrics JSONL and live bench
  payloads are auto-detected).

The band and direction rules are ``obs/live.base_metric`` and
``default_direction``, shared with the in-run sentinel. Nothing here
touches a device.

Usage:
  python -m stencil_tpu_torch.apps.perf_tool ingest --ledger LEDGER.jsonl --legacy BENCH_r0*.json MULTICHIP_r0*.json
  python -m stencil_tpu_torch.apps.perf_tool trend --ledger LEDGER.jsonl [--metric LEG ...]
  python -m stencil_tpu_torch.apps.perf_tool gate --ledger LEDGER.jsonl --metric LEG [--label L] [--rel-tol 0.1]
  python -m stencil_tpu_torch.apps.perf_tool drift --metrics metrics.jsonl
  python -m stencil_tpu_torch.apps.perf_tool render --ledger LEDGER.jsonl --out dashboard.md
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from ..obs import ledger
from .report import _rows_to_table
# the band/direction semantics are shared with the IN-run sentinel
# (obs/live.py is the one authority; this module applies them to the
# cross-run ledger, live.py to streaming chunk latencies)
from ..obs.live import base_metric, default_direction  # noqa: F401


_ROUND_LABEL_RE = re.compile(r"^r(\d+)$")


def order_key(e: dict) -> Tuple:
    """Round ordering within a trend group.

    ``rNN`` round labels order by their round NUMBER — a round
    BACKFILLED after later rounds (``ingest --legacy BENCH_r03.json``
    stamps r03 with today's ``t``) keeps its round position instead of
    becoming the trend's "latest" and the gate's default judged label.
    Every other label (live ``bench-<timestamp>`` appends, gate ``runN``
    labels, ad-hoc ingests) orders by measurement time AFTER the rNN
    prehistory — plain lexicographic label order would sort the default
    bench label ("b" < "r") before r01, hiding a freshly appended
    regression from the no-``--label`` gate entirely."""
    m = _ROUND_LABEL_RE.match(e["label"])
    if m:
        return (0, int(m.group(1)), e["t"], e["label"])
    return (1, e["t"], e["label"])


def groups(entries: Sequence[dict],
           metrics: Optional[Sequence[str]] = None,
           platform: Optional[str] = None) -> Dict[Tuple, List[dict]]:
    """Fold entries into trend groups keyed by (metric, platform,
    config fingerprint), each round-ordered via :func:`order_key`.

    Platform-"unknown" entries of a metric (outage rounds — the bench harness
    cannot know the platform of a run that produced no payload, cf. the
    BENCH_r03 zero) join EVERY platform-tagged group of that metric, so
    the trend shows the zero / the rc=1 inside the real trajectory
    instead of an isolated single-entry group nobody reads. They stand
    alone only when no platform-tagged group of the metric exists
    (e.g. the MULTICHIP docs, which are all "unknown")."""
    out: Dict[Tuple, List[dict]] = {}
    wild: Dict[str, List[dict]] = {}
    for e in entries:
        if metrics and e["metric"] not in metrics and \
                base_metric(e["metric"]) not in metrics:
            continue
        if e["platform"] == "unknown" and platform != "unknown":
            wild.setdefault(e["metric"], []).append(e)
            continue
        if platform and e["platform"] != platform:
            continue
        out.setdefault((e["metric"], e["platform"], e["config"]), []).append(e)
    for metric, es in wild.items():
        keys = [k for k in out if k[0] == metric]
        if keys:
            for k in keys:
                out[k].extend(es)
        else:
            # no platform-tagged group to join — the entries stand alone,
            # INCLUDING under a --platform filter (an all-unknown metric
            # may well belong to the filtered platform; hiding it would
            # silently un-judge e.g. multichip_dryrun_ok under
            # `gate --platform tpu`)
            for e in es:
                out.setdefault((metric, "unknown", e["config"]), []).append(e)
    for v in out.values():
        v.sort(key=order_key)
    return out


def _fmt(v: float) -> str:
    return f"{v:.6g}"


# -- trend / diff -------------------------------------------------------------


def trend_tables(entries: Sequence[dict],
                 metrics: Optional[Sequence[str]] = None,
                 platform: Optional[str] = None,
                 markdown: bool = False) -> str:
    """Per-leg trajectory across labels: value, unit, platform, rev, and
    the ratio against the previous round of the same leg."""
    gs = groups(entries, metrics, platform)
    if not gs:
        return ("_no ledger entries match_" if markdown
                else "# no ledger entries match")
    lines: List[str] = []
    for (metric, plat, cfg), es in sorted(gs.items()):
        title = f"{metric} · {plat} · cfg {cfg}"
        lines.append(f"\n**{title}**" if markdown else f"# {title}")
        rows = []
        prev: Optional[float] = None
        for e in es:
            delta = "-" if prev in (None, 0) else f"{e['value'] / prev:.3f}x"
            rows.append([e["label"], _fmt(e["value"]), e.get("unit") or "-",
                         e.get("rev") or "-", e["source"], delta])
            prev = e["value"]
        lines += _rows_to_table(
            ["label", "value", "unit", "rev", "source", "vs_prev"],
            rows, markdown)
    return "\n".join(lines).lstrip("\n")


def trend_json(entries: Sequence[dict],
               metrics: Optional[Sequence[str]] = None,
               platform: Optional[str] = None,
               gate_args: Optional[dict] = None) -> dict:
    """Machine-readable trend: the per-leg trajectory PLUS each leg's
    sentinel verdict, as one JSON document — so CI archives the trend as
    an artifact instead of scraping the markdown table. Same grouping/
    ordering as :func:`trend_tables`; verdicts come from
    :func:`evaluate_gate` with default (or ``gate_args``) thresholds on
    each leg's newest label."""
    gs = groups(entries, metrics, platform)
    verdicts = {
        (v["metric"], v["platform"], v["config"]): v
        for v in evaluate_gate(entries, metrics=metrics, platform=platform,
                               **(gate_args or {}))
    }
    legs = []
    for (metric, plat, cfg), es in sorted(gs.items()):
        points = []
        prev: Optional[float] = None
        for e in es:
            points.append({
                "label": e["label"],
                "value": e["value"],
                "unit": e.get("unit"),
                "rev": e.get("rev"),
                "source": e["source"],
                "t": e["t"],
                "vs_prev": (e["value"] / prev
                            if prev not in (None, 0) else None),
            })
            prev = e["value"]
        legs.append({
            "metric": metric,
            "platform": plat,
            "config": cfg,
            "points": points,
            "verdict": verdicts.get((metric, plat, cfg)),
        })
    return {"kind": "perf-trend", "v": 1,
            "n_entries": len(entries), "legs": legs}


def diff_tables(entries: Sequence[dict], label_a: str, label_b: str,
                markdown: bool = False) -> str:
    """Leg-by-leg comparison of two labels (ratio = B / A)."""
    rows = []
    for (metric, plat, cfg), es in sorted(groups(entries).items()):
        a = [e for e in es if e["label"] == label_a]
        b = [e for e in es if e["label"] == label_b]
        if not a or not b:
            continue
        va, vb = a[-1]["value"], b[-1]["value"]
        rows.append([metric, plat, _fmt(va), _fmt(vb),
                     f"{vb / va:.3f}" if va else "-"])
    if not rows:
        return (f"_no legs present under both {label_a!r} and {label_b!r}_"
                if markdown else
                f"# no legs present under both {label_a!r} and {label_b!r}")
    head = [f"**{label_a} vs {label_b}**"] if markdown else \
        [f"# {label_a} vs {label_b}"]
    return "\n".join(head + _rows_to_table(
        ["metric", "platform", label_a, label_b, "ratio"], rows, markdown))


# -- the regression sentinel --------------------------------------------------


def load_leg_config(path: Optional[str]) -> dict:
    if not path:
        return {}
    with open(path) as f:
        cfg = json.load(f)
    if not isinstance(cfg, dict):
        raise ValueError(f"leg config {path} must be a JSON object")
    return cfg


def evaluate_gate(entries: Sequence[dict], *,
                  metrics: Optional[Sequence[str]] = None,
                  label: Optional[str] = None,
                  mad_k: float = 3.0, rel_tol: float = 0.05,
                  abs_tol: float = 0.0, min_history: int = 1,
                  leg_config: Optional[dict] = None,
                  platform: Optional[str] = None) -> List[dict]:
    """The sentinel: per leg, the newest measurement (or the entries of
    ``label``) is judged against the tolerance band of its history —
    center = trimean, half-width = max(mad_k * MAD, rel_tol * |trimean|,
    abs_tol). Direction-aware (a throughput leg only trips when it falls
    BELOW the band; a seconds leg when it rises above; ``"both"``
    available per leg). Returns one verdict dict per (leg, platform,
    config) group; ``status`` is ``pass`` / ``fail`` / ``skip``."""
    leg_config = leg_config or {}
    verdicts: List[dict] = []
    for (metric, plat, cfg), es in sorted(
            groups(entries, metrics, platform).items()):
        over = dict(leg_config.get("*", {}))
        over.update(leg_config.get(base_metric(metric), {}))
        over.update(leg_config.get(metric, {}))
        k = float(over.get("mad_k", mad_k))
        rtol = float(over.get("rel_tol", rel_tol))
        atol = float(over.get("abs_tol", abs_tol))
        need = int(over.get("min_history", min_history))
        lbl = label or es[-1]["label"]
        new = [e["value"] for e in es if e["label"] == lbl]
        hist = [e["value"] for e in es if e["label"] != lbl]
        v = {"metric": metric, "platform": plat, "config": cfg,
             "label": lbl, "n_history": len(hist)}
        if not new:
            v.update(status="skip", reason=f"no entries labeled {lbl!r}")
            verdicts.append(v)
            continue
        value = ledger.trimean(new)
        v["value"] = value
        if len(hist) < need:
            v.update(status="skip",
                     reason=f"history {len(hist)} < min_history {need}")
            verdicts.append(v)
            continue
        center = ledger.trimean(hist)
        tol = max(k * ledger.mad(hist), rtol * abs(center), atol)
        direction = over.get("direction") or default_direction(
            metric, es[-1].get("unit"))
        lo, hi = center - tol, center + tol
        bad_low = value < lo and direction in ("higher", "both")
        bad_high = value > hi and direction in ("lower", "both")
        v.update(center=center, tol=tol, lo=lo, hi=hi, direction=direction)
        if bad_low or bad_high:
            v.update(status="fail",
                     reason=("regressed below" if bad_low else
                             "regressed above")
                     + f" the band [{_fmt(lo)}, {_fmt(hi)}]")
        else:
            v.update(status="pass", reason="within band")
        verdicts.append(v)
    return verdicts


def gate_report(verdicts: Sequence[dict]) -> str:
    lines = []
    for v in verdicts:
        band = (f" band=[{_fmt(v['lo'])}, {_fmt(v['hi'])}]"
                f" center={_fmt(v['center'])} ({v['direction']})"
                if "center" in v else "")
        val = f" value={_fmt(v['value'])}" if "value" in v else ""
        lines.append(
            f"GATE {v['status'].upper()} {v['metric']} [{v['platform']}"
            f"/{v['config']}] label={v['label']}{val}{band}"
            f" n_history={v['n_history']}: {v['reason']}")
    return "\n".join(lines)


# -- markdown dashboard -------------------------------------------------------


def render_dashboard(entries: Sequence[dict], *, gate_args: dict = None,
                     source: str = "") -> str:
    """The CI-artifact dashboard: latest values, sentinel verdicts, and
    every leg's trend table, as one markdown document."""
    gs = groups(entries)
    lines = ["# Performance dashboard", ""]
    labels = sorted({e["label"] for e in entries})
    lines.append(f"{len(entries)} ledger entries · {len(gs)} legs · "
                 f"labels: {', '.join(labels) or '-'}"
                 + (f" · source `{source}`" if source else ""))
    lines += ["", "## Latest", ""]
    rows = []
    for (metric, plat, cfg), es in sorted(gs.items()):
        e = es[-1]
        prev = es[-2]["value"] if len(es) > 1 else None
        rows.append([metric, plat, e["label"], _fmt(e["value"]),
                     e.get("unit") or "-",
                     f"{e['value'] / prev:.3f}x" if prev else "-"])
    lines += _rows_to_table(
        ["metric", "platform", "label", "value", "unit", "vs_prev"],
        rows, markdown=True)
    verdicts = evaluate_gate(entries, **(gate_args or {}))
    judged = [v for v in verdicts if v["status"] != "skip"]
    if judged:
        lines += ["", "## Regression sentinel", ""]
        vr = [[v["metric"], v["platform"], v["label"], v["status"],
               v["reason"]] for v in judged]
        lines += _rows_to_table(
            ["metric", "platform", "label", "status", "verdict"],
            vr, markdown=True)
    lines += ["", "## Trends", "",
              trend_tables(entries, markdown=True)]
    return "\n".join(lines) + "\n"


# -- ingest -------------------------------------------------------------------

# the literal "r" is required: every committed round file is _rNN, and a
# loose _<digits> match would turn e.g. bench_128.json into round "r128" —
# which order_key then sorts into the rNN prehistory as the newest round
_LABEL_RE = re.compile(r"_r(\d+)\.\w+$")


def _label_from_filename(path: str) -> Optional[str]:
    m = _LABEL_RE.search(os.path.basename(path))
    return f"r{int(m.group(1)):02d}" if m else None


def ingest_file(path: str, *, label: Optional[str] = None,
                platform: str = "unknown", rev: Optional[str] = None,
                spans: bool = False) -> List[dict]:
    """Map one file into ledger entries, auto-detecting its shape:
    a legacy BENCH wrapper ({"n", "rc", "parsed"}), a legacy MULTICHIP
    doc ({"n_devices", "ok"}), a live bench payload ({"metric",
    "value"}), or a telemetry metrics JSONL."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None
    if isinstance(doc, dict) and {"run", "proc", "kind", "name"} <= set(doc):
        # a single-line metrics JSONL parses as ONE dict — it is still a
        # telemetry record stream, not a payload doc
        doc = None
    if isinstance(doc, dict):
        if "parsed" in doc or ("n" in doc and "tail" in doc):
            return ledger.entries_from_legacy_bench(
                doc, label=label or _label_from_filename(path), rev=rev)
        if "n_devices" in doc:
            lbl = label or _label_from_filename(path)
            if lbl is None:
                raise ValueError(
                    f"{path}: a MULTICHIP doc carries no round number — "
                    "pass --label or keep the _rNN filename")
            return ledger.entries_from_legacy_multichip(doc, label=lbl,
                                                        rev=rev)
        if "metric" in doc and "value" in doc:
            return ledger.entries_from_bench_payload(
                doc, label=label or _label_from_filename(path)
                or "adhoc", rev=rev)
        raise ValueError(f"{path}: unrecognized payload shape "
                         f"(keys {sorted(doc)[:6]})")
    # not one JSON object: treat as telemetry metrics JSONL
    from ..obs import telemetry

    records = []
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}:{i}: unparseable JSON ({e})")
        errs = telemetry.validate_record(rec)
        if errs:
            raise ValueError(f"{path}:{i}: {errs[0]}")
        records.append(rec)
    return ledger.entries_from_metrics_records(
        records, label=label, platform=platform, rev=rev, spans=spans)


# -- CLI ----------------------------------------------------------------------


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        description="performance ledger: ingest, trend, diff, gate, render")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, markdown=False):
        sp.add_argument("--ledger", required=True, help="ledger JSONL path")
        if markdown:
            # only the table subcommands have a plain-text/markdown split;
            # gate output is line-oriented and render is always markdown
            sp.add_argument("--markdown", action="store_true")

    sp = sub.add_parser("ingest", help="map payload files into the ledger")
    sp.add_argument("--ledger", required=True)
    sp.add_argument("paths", nargs="+")
    sp.add_argument("--legacy", action="store_true",
                    help="committed BENCH_r0*/MULTICHIP_r0* shapes (label "
                         "inferred from the round number/filename)")
    sp.add_argument("--label", default="",
                    help="round label for the new entries (default: "
                         "inferred per file)")
    sp.add_argument("--platform", default="unknown",
                    help="platform tag for metrics-JSONL ingest")
    sp.add_argument("--rev", default="",
                    help="git revision to stamp (default: none for "
                         "--legacy, the repo's HEAD otherwise)")
    sp.add_argument("--spans", action="store_true",
                    help="also ingest span trimeans from metrics JSONL "
                         "(as <name>.trimean_s)")

    sp = sub.add_parser("trend", help="per-leg trajectory across labels")
    common(sp, markdown=True)
    sp.add_argument("--metric", action="append", default=[])
    sp.add_argument("--platform", default="")
    sp.add_argument("--json", action="store_true",
                    help="machine-readable output (per-leg trajectory + "
                         "sentinel verdicts) instead of tables — the "
                         "CI-artifact shape")
    sp.add_argument("--out", default="",
                    help="with --json, also write the document here")

    sp = sub.add_parser("diff", help="one label vs another, per leg")
    common(sp, markdown=True)
    sp.add_argument("--a", required=True)
    sp.add_argument("--b", required=True)

    sp = sub.add_parser("gate", help="regression sentinel (exit 1 on trip)")
    common(sp)
    sp.add_argument("--metric", action="append", default=[],
                    help="leg(s) to judge (default: every leg)")
    sp.add_argument("--label", default="",
                    help="label under judgment (default: each leg's newest)")
    sp.add_argument("--platform", default="")
    sp.add_argument("--mad-k", type=float, default=3.0,
                    help="band half-width in MADs (default 3)")
    sp.add_argument("--rel-tol", type=float, default=0.05,
                    help="band half-width floor as a fraction of the "
                         "history trimean (default 0.05)")
    sp.add_argument("--abs-tol", type=float, default=0.0)
    sp.add_argument("--min-history", type=int, default=1,
                    help="history entries required before judging "
                         "(fewer = skip, not fail)")
    sp.add_argument("--leg-config", default="",
                    help="JSON of per-leg overrides: {leg: {rel_tol, mad_k, "
                         "abs_tol, direction, min_history}}; '*' sets "
                         "defaults")

    sp = sub.add_parser(
        "drift",
        help="calibration drift sentinel: judge the installed "
             "calibration's predictions against a run's measured "
             "attribution samples (exit 1 naming the drifted phase)")
    sp.add_argument("--metrics", required=True,
                    help="metrics JSONL with plan.attrib.phase records "
                         "(a --metrics-out file)")
    sp.add_argument("--phase", action="append", default=[],
                    help="phase(s) to judge (default: every attributed "
                         "phase)")
    sp.add_argument("--mad-k", type=float, default=3.0,
                    help="band half-width in MADs of the measured "
                         "samples (default 3 — the gate's band)")
    sp.add_argument("--rel-tol", type=float, default=0.05,
                    help="band half-width floor as a fraction of the "
                         "measured trimean (default 0.05; raise for "
                         "noisy CPU fabrics — but keep it < 1, or a "
                         "prediction far BELOW the measured center can "
                         "never trip)")
    sp.add_argument("--abs-tol", type=float, default=0.0)

    sp = sub.add_parser("render", help="markdown dashboard for CI artifacts")
    common(sp)
    sp.add_argument("--out", default="", help="also write the dashboard here")

    args = p.parse_args(argv)

    if args.cmd == "drift":
        # ledger-free like ingest: the evidence is one run's metrics
        # file; the band authority is obs/attribution.judge_drift — the
        # same trimean±max(k·MAD, rtol·|center|, atol) formula
        # evaluate_gate applies to ledger history
        if not os.path.exists(args.metrics):
            print(f"[perf] no such metrics file: {args.metrics}",
                  file=sys.stderr)
            return 2
        from ..obs import telemetry
        from ..obs.attribution import judge_drift, phases_from_records

        records: List[dict] = []
        with open(args.metrics) as f:
            for i, line in enumerate(f, 1):
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError as e:
                    print(f"[perf] {args.metrics}:{i}: unparseable JSON "
                          f"({e})", file=sys.stderr)
                    return 2
                errs = telemetry.validate_record(rec)
                if errs:
                    print(f"[perf] {args.metrics}:{i}: {errs[0]}",
                          file=sys.stderr)
                    return 2
                records.append(rec)
        phases = phases_from_records(records)
        if args.phase:
            phases = {k: v for k, v in phases.items() if k in args.phase}
        if not phases:
            print("[perf] drift judged nothing (no plan.attrib.phase "
                  "records match)", file=sys.stderr)
            return 2
        drifted: List[str] = []
        for phase, g in sorted(phases.items()):
            v = judge_drift(phase, g["predicted_s"], g["samples"],
                            mad_k=args.mad_k, rel_tol=args.rel_tol,
                            abs_tol=args.abs_tol)
            status = "PASS" if v.ok else "FAIL"
            print(f"DRIFT {status} [{g['method']}] {v.describe()} "
                  f"calibration={g['provenance'] or 'modeled(default)'}")
            if not v.ok:
                drifted.append(phase)
        if drifted:
            print(f"[perf] CALIBRATION DRIFT: {', '.join(drifted)} — "
                  "refit with `plan_tool calibrate`", file=sys.stderr)
            return 1
        return 0

    if args.cmd == "ingest":
        if args.label and len(args.paths) > 1:
            # one label across files: same-keyed entries (same metric/
            # platform/config/rev) dedup to the FIRST file's value
            print(f"[perf] WARNING: one --label {args.label!r} across "
                  f"{len(args.paths)} files — entries sharing a key keep "
                  f"only the first file's value (use per-file labels to "
                  f"ingest repeat runs of one config)", file=sys.stderr)
        rev = args.rev or (None if args.legacy else ledger.git_rev(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))))
        entries: List[dict] = []
        for path in args.paths:
            got = ingest_file(path, label=args.label or None,
                              platform=args.platform, rev=rev,
                              spans=args.spans)
            print(f"[perf] {path}: {len(got)} entries")
            entries.extend(got)
        n = ledger.append_entries(args.ledger, entries)
        print(f"[perf] appended {n} new entries to {args.ledger} "
              f"({len(entries) - n} already present)")
        return 0

    if not os.path.exists(args.ledger):
        # load_ledger maps absence to an empty ledger (right for a first
        # append) — but a READ of a mistyped path must fail, not render
        # an empty trend/dashboard with rc 0 and keep CI green
        print(f"[perf] no such ledger: {args.ledger}", file=sys.stderr)
        return 2
    entries = ledger.load_ledger(args.ledger)
    if args.cmd == "trend":
        if args.json:
            if args.markdown:
                print("# --json ignores --markdown", file=sys.stderr)
            doc = trend_json(entries, args.metric or None,
                             args.platform or None)
            text = json.dumps(doc, indent=1, sort_keys=True)
            print(text)
            if args.out:
                with open(args.out, "w") as f:
                    f.write(text + "\n")
            return 0
        if args.out:
            print("# trend --out requires --json", file=sys.stderr)
        print(trend_tables(entries, args.metric or None,
                           args.platform or None, markdown=args.markdown))
        return 0
    if args.cmd == "diff":
        print(diff_tables(entries, args.a, args.b, markdown=args.markdown))
        return 0
    if args.cmd == "gate":
        try:
            leg_cfg = load_leg_config(args.leg_config or None)
        except (OSError, json.JSONDecodeError, ValueError) as e:
            # a usage error must not read as a regression trip: exit 2
            # with a message, the mistyped---ledger-path discipline
            print(f"[perf] bad --leg-config: {e}", file=sys.stderr)
            return 2
        verdicts = evaluate_gate(
            entries, metrics=args.metric or None, label=args.label or None,
            mad_k=args.mad_k, rel_tol=args.rel_tol, abs_tol=args.abs_tol,
            min_history=args.min_history, leg_config=leg_cfg,
            platform=args.platform or None)
        print(gate_report(verdicts))
        failed = [v for v in verdicts if v["status"] == "fail"]
        judged = [v for v in verdicts if v["status"] == "pass"] + failed
        if failed:
            print(f"[perf] GATE TRIPPED: "
                  f"{', '.join(v['metric'] for v in failed)}",
                  file=sys.stderr)
            return 1
        if not judged:
            print("[perf] gate judged nothing (no history / no matching "
                  "entries)", file=sys.stderr)
            return 2
        return 0
    if args.cmd == "render":
        text = render_dashboard(entries, source=args.ledger)
        print(text)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text)
        return 0
    raise AssertionError(args.cmd)


if __name__ == "__main__":
    raise SystemExit(main())
