"""report -- aggregate telemetry metrics JSONL into trimean tables.

The port's counterpart of ``stencil_tpu.apps.report``, with the same output
byte for byte and the same exit codes. It consumes the one-JSON-object-per-
line files the apps write via ``--metrics-out`` (schema v1:
``stencil_tpu_torch/obs/telemetry.py``, which either package writes and
reads), across any number of files/processes/runs, and reports:

- spans: per-name count / min / trimean / max seconds
  (``utils/statistics.Statistics``, the reference's canonical trimean,
  bin/statistics.hpp:17);
- counters: the static byte/count truth with cross-record consistency
  flagged;
- gauges: per-name trimean (throughputs, timer buckets);
- an optional vs-baseline delta against a JSON file of recorded numbers
  (BASELINE.json / a bench payload / any flat {name: number} map).

``--validate`` makes it the CI schema gate: every line must parse and
satisfy the telemetry schema, or the exit code is 1 (``--ledger`` extends
the same gate to a performance-ledger file, ``obs/ledger.py`` schema).
``--trace-out`` exports the records as a Chrome-trace/Perfetto timeline
(``obs/trace_export.py``); ``--follow`` re-reads growing metrics files and
re-renders the tables in place (add ``--heartbeat`` or set
``STENCIL_HEARTBEAT_FILE`` to also show a heartbeat file's freshness: only
its mtime is read); ``--status`` renders a run-status snapshot
(``obs/status.py``). Nothing here touches a device.

Usage:
  python -m stencil_tpu_torch.apps.report m1.jsonl [m2.jsonl ...] [--markdown]
  python -m stencil_tpu_torch.apps.report metrics.jsonl --validate
  python -m stencil_tpu_torch.apps.report metrics.jsonl --baseline BASELINE.json
  python -m stencil_tpu_torch.apps.report metrics.jsonl --trace-out trace.json
  python -m stencil_tpu_torch.apps.report metrics.jsonl --follow
  python -m stencil_tpu_torch.apps.report --status status.json [--follow]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

from ..obs import telemetry
# the heartbeat file a supervised run touches; --follow reads only its mtime
from ..obs.watchdog import HEARTBEAT_FILE_ENV
from ..utils.statistics import Statistics


def load(paths: List[str]) -> Tuple[List[dict], List[str]]:
    """Read + schema-validate records from JSONL files.

    Returns (valid records, error strings); invalid lines are reported,
    not silently dropped into the aggregate.
    """
    records: List[dict] = []
    errors: List[str] = []
    for path in paths:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError as e:
                    errors.append(f"{path}:{i}: unparseable JSON ({e})")
                    continue
                errs = telemetry.validate_record(rec)
                if errs:
                    errors.extend(f"{path}:{i}: {e}" for e in errs)
                else:
                    records.append(rec)
    return records, errors


def _agg_key(rec: dict) -> str:
    """Aggregation key: the record name, split per exchange method when a
    ``method`` tag is present — a method-ablation run intentionally emits
    different census/byte/timing values per method, and folding them under
    one name would mix timings and false-positive the DISAGREE flag. The
    ``batched`` tag splits the same way: a quantity-batching A/B run emits
    both legs' truths (e.g. ``exchange.permutes_per_quantity`` 6/Q vs 6),
    and averaging them would read as neither. ``mode`` is the campaign
    A/B's tag (``campaign.step_latency_s`` carries batched AND sequential
    samples in one ab run — a folded p99 would describe neither leg)."""
    # ``wire`` splits the bf16/fp8-on-the-wire A/B (bench_exchange
    # --wire-ab): the compressed and native legs' timings/census differ
    # by design. ``variant`` splits the kernel-variant legs the same way
    # (the fused compute+exchange A/B: a fused.overlap_fraction or
    # exchange.trimean_s folded across variants would describe neither).
    # ``priority`` splits the serving daemon's per-class latency gauges
    # (serve.p99_ms): a folded p99 would average high and low lanes into
    # a number that describes neither class's SLO
    name = rec["name"]
    tags = [str(rec[t])
            for t in ("method", "batched", "mode", "wire", "variant",
                      "priority")
            if t in rec]
    if tags:
        return f"{name}[{','.join(tags)}]"
    return name


def aggregate(records: List[dict]) -> dict:
    """Fold records into per-name statistics (per-method names when
    tagged, see :func:`_agg_key`).

    Spans and gauges aggregate across processes AND runs (each sample
    keeps equal weight — the reference trimean discipline). Counters are
    static truths PER CONFIGURATION — one key can legitimately carry
    several distinct values (a radius sweep in one run, multiple runs
    appended to one file), so the table shows the distinct set as a range
    rather than presuming agreement.
    """
    spans: Dict[str, Statistics] = {}
    span_phase: Dict[str, str] = {}
    gauges: Dict[str, Statistics] = {}
    counters: Dict[str, dict] = {}
    runs, procs, apps = set(), set(), set()
    for rec in records:
        runs.add(rec["run"])
        procs.add(rec["proc"])
        if "app" in rec:
            apps.add(rec["app"])
        kind, name = rec["kind"], _agg_key(rec)
        if kind == "span":
            spans.setdefault(name, Statistics()).insert(rec["seconds"])
            if "phase" in rec:
                span_phase[name] = rec["phase"]
        elif kind == "gauge":
            gauges.setdefault(name, Statistics()).insert(rec["value"])
        elif kind == "counter":
            c = counters.setdefault(
                name, {"n": 0, "value": set(), "bytes": set()}
            )
            c["n"] += 1
            if "value" in rec:
                c["value"].add(rec["value"])
            if "bytes" in rec:
                c["bytes"].add(rec["bytes"])
    return {
        "spans": spans,
        "span_phase": span_phase,
        "gauges": gauges,
        "counters": counters,
        "runs": sorted(runs),
        "procs": sorted(procs),
        "apps": sorted(apps),
        "n_records": len(records),
    }


def _fmt_set(s: set) -> str:
    if not s:
        return "-"
    if len(s) == 1:
        return str(next(iter(s)))
    return f"{min(s)}..{max(s)} ({len(s)} distinct)"


def _rows_to_table(header: List[str], rows: List[List[str]],
                   markdown: bool) -> List[str]:
    if markdown:
        out = ["| " + " | ".join(header) + " |",
               "|" + "|".join("---" for _ in header) + "|"]
        out += ["| " + " | ".join(r) + " |" for r in rows]
        return out
    out = [",".join(header)]
    out += [",".join(r) for r in rows]
    return out


def tables(agg: dict, markdown: bool = False, p99: bool = False) -> str:
    """The human/CI-facing report: spans, counters, gauges.

    ``p99`` adds a tail-latency column to the span tables (linear-
    interpolated 99th percentile, utils/statistics.percentile) — central
    tendency alone hides exactly what a multi-tenant latency story is
    about."""
    lines: List[str] = []
    head = (
        f"{agg['n_records']} records · runs={len(agg['runs'])} "
        f"procs={agg['procs']} apps={','.join(agg['apps']) or '-'}"
    )
    lines.append(("### metrics report\n" + head) if markdown else "# " + head)

    if agg["spans"]:
        rows = [
            [name, agg["span_phase"].get(name, "-"), str(st.count()),
             f"{st.min():.6f}", f"{st.trimean():.6f}", f"{st.max():.6f}"]
            + ([f"{st.percentile(99):.6f}"] if p99 else [])
            for name, st in sorted(agg["spans"].items())
        ]
        lines.append("" if markdown else "# spans")
        if markdown:
            lines.append("**spans**")
        lines += _rows_to_table(
            ["span", "phase", "n", "min_s", "trimean_s", "max_s"]
            + (["p99_s"] if p99 else []),
            rows, markdown)

    if agg["counters"]:
        rows = [
            [name, str(c["n"]), _fmt_set(c["value"]), _fmt_set(c["bytes"])]
            for name, c in sorted(agg["counters"].items())
        ]
        lines.append("" if markdown else "# counters")
        if markdown:
            lines.append("**counters**")
        lines += _rows_to_table(["counter", "n", "value", "bytes"],
                                rows, markdown)

    if agg["gauges"]:
        rows = [
            [name, str(st.count()), f"{st.trimean():.6g}"]
            for name, st in sorted(agg["gauges"].items())
        ]
        lines.append("" if markdown else "# gauges")
        if markdown:
            lines.append("**gauges**")
        lines += _rows_to_table(["gauge", "n", "trimean"], rows, markdown)
    return "\n".join(lines)


def _flatten_numeric(obj, prefix: str = "") -> Dict[str, float]:
    """Dotted-path map of every numeric leaf in a baseline JSON — accepts
    BASELINE.json, a bench.py payload ({"metric": ..., "value": ...}), or
    any flat {name: number} map."""
    out: Dict[str, float] = {}
    if isinstance(obj, dict):
        if isinstance(obj.get("metric"), str) and isinstance(
                obj.get("value"), (int, float)):
            out[obj["metric"]] = float(obj["value"])
        for k, v in obj.items():
            out.update(_flatten_numeric(v, f"{prefix}{k}." if prefix or k else ""))
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        if prefix:
            out[prefix[:-1]] = float(obj)
    return out


def baseline_delta(agg: dict, baseline: dict,
                   markdown: bool = False) -> str:
    """Gauge-vs-baseline ratios for every gauge whose name matches a
    numeric baseline entry (exact name, or last dotted component).

    When two baseline keys share a leaf name, the leaf match is
    AMBIGUOUS: the row is flagged instead of silently ratio-ing against
    whichever key flattened first (an exact full-name match is still
    unambiguous and unaffected)."""
    flat = _flatten_numeric(baseline)
    by_leaf: Dict[str, List[Tuple[str, float]]] = {}
    for k, v in flat.items():
        by_leaf.setdefault(k.split(".")[-1], []).append((k, v))
    rows: List[List[str]] = []
    for name, st in sorted(agg["gauges"].items()):
        match: Optional[Tuple[str, float]] = None
        if name in flat:
            match = (name, flat[name])
        else:
            cands = by_leaf.get(name.split(".")[-1], [])
            if len(cands) > 1:
                rows.append([name, f"{st.trimean():.6g}", "-", "AMBIGUOUS",
                             ";".join(sorted(k for k, _v in cands))])
                continue
            if cands:
                match = cands[0]
        if match is None or match[1] == 0:
            continue
        key, base = match
        rows.append([name, f"{st.trimean():.6g}", f"{base:.6g}",
                     f"{st.trimean() / base:.3f}", key])
    if not rows:
        return ("_no gauge matches a numeric baseline entry_" if markdown
                else "# vs-baseline: no gauge matches a numeric baseline entry")
    lines = ["**vs baseline**"] if markdown else ["# vs baseline"]
    lines += _rows_to_table(
        ["gauge", "trimean", "baseline", "ratio", "baseline_key"],
        rows, markdown)
    return "\n".join(lines)


def _heartbeat_line(hb_path: Optional[str]) -> str:
    """One status line from a heartbeat file's mtime, the freshness signal
    a supervisor reads."""
    if not hb_path:
        return "heartbeat: (no heartbeat file)"
    try:
        age = time.time() - os.stat(hb_path).st_mtime
    except OSError:
        return f"heartbeat: {hb_path} missing (child not started?)"
    return f"heartbeat: {age:.1f}s ago ({hb_path})"


def follow(paths: List[str], *, interval_s: float = 2.0, count: int = 0,
           markdown: bool = False, p99: bool = False,
           heartbeat: Optional[str] = None, out=None) -> int:
    """Live tail: re-read the (growing) metrics files every
    ``interval_s`` and re-render the span/gauge tables in place.

    Files that do not exist yet are simply waited for (a run-status view
    usually starts before the run). ``count`` bounds the redraws (0 =
    until interrupted — the normal interactive mode)."""
    out = out or sys.stdout
    hb = heartbeat or os.environ.get(HEARTBEAT_FILE_ENV) or None
    it = 0
    # ^C is the documented way OUT of the live view — it must exit
    # cleanly wherever it lands (with big files most wall time is in
    # load/aggregate/render, not the sleep)
    try:
        while True:
            it += 1
            have = [p for p in paths if os.path.exists(p)]
            try:
                records, errors = load(have)
            except OSError as e:
                # a file can vanish between the exists() filter and open()
                # (a supervisor's retry ladder rotates child logs) — wait for
                # the next redraw instead of dying mid-view
                records, errors = [], [str(e)]
            body = (tables(aggregate(records), markdown=markdown, p99=p99)
                    if records
                    else f"(waiting for records in {', '.join(paths)})")
            if getattr(out, "isatty", lambda: False)():
                out.write("\x1b[2J\x1b[H")  # clear + home: render in place
            stamp = time.strftime("%H:%M:%S")
            out.write(f"-- follow #{it} @ {stamp} · "
                      f"{len(have)}/{len(paths)} file(s) · "
                      f"{len(errors)} schema error(s) · "
                      f"{_heartbeat_line(hb)}\n")
            out.write(body + "\n")
            out.flush()
            if count and it >= count:
                return 0
            time.sleep(interval_s)
    except KeyboardInterrupt:
        return 0


def follow_status(path: str, *, interval_s: float = 2.0, count: int = 0,
                  once: bool = False, out=None) -> int:
    """The top-like run-status view: render the atomic snapshot file
    (obs/status.py) once, or re-render it in place every ``interval_s``
    (``--follow``). A missing/unparseable file is waited for — the view
    usually starts before the run."""
    from ..obs import status as status_mod

    out = out or sys.stdout
    it = 0
    try:
        while True:
            it += 1
            doc = status_mod.read_status(path)
            if doc is None:
                body = f"(waiting for a status snapshot at {path})"
            else:
                errs = status_mod.validate_status(doc)
                body = status_mod.render_status(doc)
                if errs:
                    body += f"\n({len(errs)} schema issue(s): {errs[0]})"
            if once:
                out.write(body + "\n")
                return 0 if doc is not None else 1
            if getattr(out, "isatty", lambda: False)():
                out.write("\x1b[2J\x1b[H")
            out.write(f"-- status #{it} @ {time.strftime('%H:%M:%S')} · "
                      f"{path}\n{body}\n")
            out.flush()
            if count and it >= count:
                return 0
            time.sleep(interval_s)
    except KeyboardInterrupt:
        return 0


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        description="aggregate telemetry metrics JSONL into trimean tables")
    p.add_argument("paths", nargs="*", help="metrics JSONL file(s)")
    p.add_argument("--markdown", action="store_true",
                   help="markdown tables instead of CSV")
    p.add_argument("--p99", action="store_true",
                   help="add a p99 tail-latency column to the span tables "
                        "(the campaign latency legs' statistic)")
    p.add_argument("--baseline", default="",
                   help="JSON of recorded numbers for a vs-baseline delta")
    p.add_argument("--validate", action="store_true",
                   help="schema-gate mode: exit 1 on any invalid line")
    p.add_argument("--ledger", default="",
                   help="also validate this performance-ledger file "
                        "(obs/ledger.py schema) in --validate mode")
    p.add_argument("--trace-out", default="",
                   help="export the records as a Chrome-trace/Perfetto "
                        "timeline JSON (one lane per (run, proc); fault/"
                        "ckpt markers as instant events)")
    p.add_argument("--follow", action="store_true",
                   help="live tail: re-read growing metrics files and "
                        "re-render in place")
    p.add_argument("--status", default="",
                   help="top-like reader of a run-status snapshot file "
                        "(obs/status.py; written per chunk by the guarded "
                        "loop's --status-file): renders once, or in place "
                        "with --follow")
    p.add_argument("--interval", type=float, default=2.0,
                   help="--follow redraw period in seconds")
    p.add_argument("--follow-count", type=int, default=0,
                   help="stop --follow after N redraws (0 = until ^C)")
    p.add_argument("--heartbeat", default="",
                   help="heartbeat file whose freshness --follow "
                        "shows (default: $STENCIL_HEARTBEAT_FILE)")
    p.add_argument("--out", default="", help="also write the report here")
    args = p.parse_args(argv)

    # single-purpose modes ignore the other output flags — say so instead
    # of silently producing no artifact
    def _warn_ignored(mode: str, flags: List[Tuple[str, object]]) -> None:
        ignored = [name for name, val in flags if val]
        if ignored:
            print(f"# {mode} mode ignores {', '.join(ignored)}",
                  file=sys.stderr)

    if args.status:
        _warn_ignored("--status", [("--validate", args.validate),
                                   ("--ledger", args.ledger),
                                   ("--trace-out", args.trace_out),
                                   ("--baseline", args.baseline),
                                   ("--out", args.out),
                                   ("metrics paths", args.paths)])
        return follow_status(args.status, interval_s=args.interval,
                             count=args.follow_count,
                             once=not args.follow)
    if not args.paths:
        p.error("at least one metrics JSONL path is required "
                "(or --status FILE)")
    if args.follow:
        _warn_ignored("--follow", [("--validate", args.validate),
                                   ("--ledger", args.ledger),
                                   ("--trace-out", args.trace_out),
                                   ("--baseline", args.baseline),
                                   ("--out", args.out)])
        return follow(args.paths, interval_s=args.interval,
                      count=args.follow_count, markdown=args.markdown,
                      p99=args.p99, heartbeat=args.heartbeat or None)
    if args.validate:
        _warn_ignored("--validate", [("--trace-out", args.trace_out),
                                     ("--baseline", args.baseline),
                                     ("--out", args.out)])

    records, errors = load(args.paths)
    if errors:
        for e in errors:
            print(f"SCHEMA: {e}")
    if args.validate:
        ledger_msg = ""
        if args.ledger:
            from ..obs import ledger as ledger_mod

            try:
                if not os.path.exists(args.ledger):
                    # load_ledger treats a missing file as an empty ledger
                    # (fine for a first append) — but a GATE asked to
                    # validate a path that is not there must fail, not
                    # silently validate nothing
                    raise ledger_mod.LedgerError(
                        f"{args.ledger}: no such ledger file")
                n_led = len(ledger_mod.load_ledger(args.ledger))
                ledger_msg = f", ledger: {n_led} valid entries"
            except ledger_mod.LedgerError as e:
                print(f"SCHEMA: LEDGER: {e}")
                errors.append(f"LEDGER: {e}")
                ledger_msg = ", ledger: INVALID"
        print(f"{len(records)} valid records, {len(errors)} schema errors"
              + ledger_msg)
        return 1 if errors or not records else 0

    # past this point nothing reads the ledger — a CI line that forgot
    # --validate must hear that its ledger check did not happen
    _warn_ignored("report", [("--ledger", args.ledger)])

    if args.trace_out:
        from ..obs import trace_export

        n_ev = trace_export.write_trace(args.trace_out, records)
        print(f"# trace: {n_ev} events -> {args.trace_out}")

    agg = aggregate(records)
    text = tables(agg, markdown=args.markdown, p99=args.p99)
    if args.baseline:
        with open(args.baseline) as f:
            text += "\n" + baseline_delta(agg, json.load(f),
                                          markdown=args.markdown)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
