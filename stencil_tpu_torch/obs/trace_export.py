"""Trace timeline export: telemetry JSONL -> Chrome-trace/Perfetto JSON.

The port's own copy of ``stencil_tpu.obs.trace_export`` (pure stdlib, so it
is copied, not imported; it reads the port's schema-v1 records as they
are). ``apps/report.py`` aggregates spans into trimean tables, good for
"how fast" and useless for "what happened when". This module converts the
same metrics records into the Chrome trace-event format (loadable in
Perfetto / ``chrome://tracing``), so a self-healing run's story (step
chunks, health checks, an injected fault, the backoff, the rollback, the
checkpoint saves) reads as ONE timeline:

- one lane per ``(run, proc)``: each run becomes a trace "process" (pid)
  named after its run id + app, each process index a thread (tid) within
  it;
- spans become complete (``ph: "X"``) duration events; emission time ``t``
  is a span's END, so the event starts at ``t - seconds``;
- gauges, counters, and heartbeats become counter (``ph: "C"``) tracks;
- the fault/recovery/checkpoint vocabulary (``fault.injected``,
  ``health.fault``, ``recover.rollback``, ``ckpt.save``, ...) ALSO lands as
  instant events (``ph: "i"``, process-scoped) so the markers are visible
  at timeline zoom even where a span would be a sliver.

Timestamps are microseconds relative to the earliest event (the original
unix time survives in each event's ``args.t``). :func:`validate_trace` is
the schema authority: events sorted by ``ts``, ``X`` events with
non-negative ``dur``, any ``B``/``E`` pairs balanced per lane.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

# Records whose occurrence matters at timeline zoom: each also becomes an
# instant marker (spans additionally keep their X duration event).
MARKER_NAMES = frozenset({
    "fault.injected",
    "health.fault",
    "recover.fault",
    "recover.rollback",
    "recover.aborted",
    "ckpt.save",
    "ckpt.save_skipped",
    "ckpt.restore",
    "ckpt.resumed_from_step",
    # the live-observability vocabulary (obs/live.py + campaign SLO):
    # in-run anomaly detect/clear, deadline violations, replan triggers
    "anomaly.detected",
    "anomaly.cleared",
    "slo.violation",
    "replan.requested",
    # the drift sentinel's alarm (obs/attribution.emit_drift): the
    # installed calibration's prediction fell out of the measured band
    "calibration.drift",
})

_LANE_TAGS = ("app", "phase", "method", "batched", "iters", "step",
              "fault_kind", "quantity", "from_step", "to_step", "reason",
              "seconds", "value", "bytes", "seq", "unit",
              "metric", "tenant", "deadline_ms", "p99_ms", "lane",
              # the attribution/drift vocabulary (obs/attribution.py):
              # the marker args must carry the evidence the alarm is about
              "predicted_s", "measured_s", "residual", "collectives",
              "wire_bytes", "provenance", "band_lo", "band_hi",
              "kernel_variant")


def _args(rec: dict) -> dict:
    out = {k: rec[k] for k in _LANE_TAGS if k in rec}
    out["t"] = rec["t"]
    return out


def to_trace(records: Sequence[dict]) -> dict:
    """Convert schema-valid telemetry records into a Chrome trace object
    (``{"traceEvents": [...], "displayTimeUnit": "ms"}``)."""
    # lane assignment: pid per run (ordered by first appearance), tid = proc
    pids: Dict[str, int] = {}
    run_app: Dict[str, str] = {}
    lanes: set = set()
    t0: Optional[float] = None
    for r in records:
        run = r["run"]
        if run not in pids:
            pids[run] = len(pids) + 1
        if r.get("app") and run not in run_app:
            run_app[run] = r["app"]
        lanes.add((run, r["proc"]))
        start = r["t"] - r["seconds"] if r["kind"] == "span" else r["t"]
        t0 = start if t0 is None else min(t0, start)
    t0 = t0 or 0.0

    def us(t: float) -> float:
        return round((t - t0) * 1e6, 3)

    events: List[dict] = []
    for run, pid in pids.items():
        name = f"run {run}" + (f" ({run_app[run]})" if run in run_app else "")
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "ts": 0, "args": {"name": name}})
    for run, proc in sorted(lanes, key=lambda x: (pids[x[0]], x[1])):
        events.append({"ph": "M", "name": "thread_name", "pid": pids[run],
                       "tid": proc, "ts": 0,
                       "args": {"name": f"proc {proc}"}})

    for r in records:
        pid, tid = pids[r["run"]], r["proc"]
        kind, name = r["kind"], r["name"]
        if kind == "span":
            events.append({
                "ph": "X", "name": name, "cat": r.get("phase", "span"),
                "ts": us(r["t"] - r["seconds"]),
                "dur": round(r["seconds"] * 1e6, 3),
                "pid": pid, "tid": tid, "args": _args(r),
            })
        elif kind == "gauge":
            events.append({
                "ph": "C", "name": name, "cat": r.get("phase", "gauge"),
                "ts": us(r["t"]), "pid": pid, "tid": tid,
                "args": {"value": r["value"]},
            })
        elif kind == "counter":
            args = {}
            if "value" in r:
                args["value"] = r["value"]
            if "bytes" in r:
                args["bytes"] = r["bytes"]
            events.append({
                "ph": "C", "name": name, "cat": r.get("phase", "counter"),
                "ts": us(r["t"]), "pid": pid, "tid": tid, "args": args,
            })
        elif kind == "heartbeat":
            events.append({
                "ph": "C", "name": "heartbeat", "cat": "heartbeat",
                "ts": us(r["t"]), "pid": pid, "tid": tid,
                "args": {"value": r.get("seq", 0)},
            })
        elif kind == "meta" and name == "plan.attrib.phase":
            # predicted-vs-measured as PAIRED counter tracks per phase:
            # two flat-vs-jittering lines whose gap IS the calibration
            # residual, readable at a glance next to the span lanes
            for fld in ("predicted_s", "measured_s"):
                if isinstance(r.get(fld), (int, float)):
                    events.append({
                        "ph": "C", "name": f"plan.attrib.{r['phase']}.{fld}",
                        "cat": r.get("phase", "attrib"),
                        "ts": us(r["t"]), "pid": pid, "tid": tid,
                        "args": {"value": r[fld]},
                    })
        if name in MARKER_NAMES:
            # the marker lands at the record's emission time (a span's END
            # — for ckpt.save that is the moment the snapshot was durable)
            events.append({
                "ph": "i", "s": "p", "name": name,
                "cat": r.get("phase", "marker"), "ts": us(r["t"]),
                "pid": pid, "tid": tid, "args": _args(r),
            })

    meta = [e for e in events if e["ph"] == "M"]
    rest = sorted((e for e in events if e["ph"] != "M"),
                  key=lambda e: (e["ts"], e["pid"], e["tid"]))
    return {
        "traceEvents": meta + rest,
        "displayTimeUnit": "ms",
        "otherData": {"t0_unix_s": t0, "runs": {r: p for r, p in pids.items()}},
    }


def validate_trace(obj) -> List[str]:
    """Schema violations of a trace object (empty = valid): the checks
    the tests and CI gate rely on — parseable structure, monotonically
    sorted timestamps, complete ``X`` events with non-negative ``dur``,
    balanced ``B``/``E`` pairs per (pid, tid) lane."""
    errs: List[str] = []
    if not isinstance(obj, dict) or not isinstance(obj.get("traceEvents"), list):
        return ["trace must be an object with a traceEvents list"]
    last_ts = None
    open_stacks: Dict[Tuple, List[str]] = {}
    for i, e in enumerate(obj["traceEvents"]):
        if not isinstance(e, dict):
            errs.append(f"event {i}: not an object")
            continue
        ph = e.get("ph")
        if not isinstance(e.get("name"), str) or not e["name"]:
            errs.append(f"event {i}: missing name")
        if ph not in ("M", "X", "B", "E", "i", "I", "C"):
            errs.append(f"event {i}: unsupported ph {ph!r}")
            continue
        if ph == "M":
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"event {i}: ts must be a non-negative number")
            continue
        if last_ts is not None and ts < last_ts:
            errs.append(f"event {i}: ts {ts} not sorted (prev {last_ts})")
        last_ts = ts
        if "pid" not in e or "tid" not in e:
            errs.append(f"event {i}: missing pid/tid lane")
            continue
        lane = (e["pid"], e["tid"])
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"event {i}: X event needs non-negative dur")
        elif ph == "B":
            open_stacks.setdefault(lane, []).append(e["name"])
        elif ph == "E":
            stack = open_stacks.get(lane) or []
            if not stack:
                errs.append(f"event {i}: E without matching B on lane {lane}")
            else:
                stack.pop()
    for lane, stack in open_stacks.items():
        if stack:
            errs.append(f"lane {lane}: unclosed B event(s) {stack}")
    return errs


def write_trace(path: str, records: Sequence[dict]) -> int:
    """Export ``records`` to ``path``; returns the event count. Refuses
    to write a trace that fails its own validator."""
    trace = to_trace(records)
    errs = validate_trace(trace)
    if errs:
        raise ValueError(f"refusing to write an invalid trace: {errs[0]}")
    # Perfetto/chrome://tracing parse STRICT JSON: a NaN gauge from a
    # degenerate run must fail here, not produce an unloadable file
    try:
        text = json.dumps(trace, allow_nan=False)
    except ValueError:
        raise ValueError("refusing to write a non-strict-JSON trace "
                         "(NaN/Infinity in some event's value or args)")
    with open(path, "w") as f:
        f.write(text + "\n")
    return len(trace["traceEvents"])
