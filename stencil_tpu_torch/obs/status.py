"""Run-status snapshots: one atomic JSON file that always says "now".

The port's own copy of ``stencil_tpu.obs.status`` (pure stdlib, schema v1
unchanged, so either package reads the other's file). The metrics JSONL is
an append-only event log; this is the O(1) complement, one small document
rewritten once per chunk through tmp + fsync + atomic rename (a reader never
sees a torn snapshot), holding what an operator polls for:

- current step / target iters, per-step latency and throughput;
- health counts (checks, faults, rollbacks) from the guarded loop;
- the live sentinel's anomaly state (active excursions and totals);
- per-lane tenant states in a campaign, and the serving daemon's queue.

Status document (schema v1)::

    {"v": 1, "kind": "run-status", "run": str|null, "app": str|null,
     "t": unix seconds of the last update,
     "step": int?, "iters": int?, "outcome": str?,
     "per_step_s": float?, "steps_per_s": float?,
     "health": {"checks": int, "faults": int, "rollbacks": int}?,
     "anomalies": {"active": [...], "detected": int, "cleared": int}?,
     "lanes": [{"lane": int, "tenant": str|null, "step": int?,
                "steps": int?, "p50_ms": float?, "p99_ms": float?,
                "deadline_ms": float?, "slo": "ok"|"violated"|null}]?,
     "slo": {"violations": [tid, ...]}?,
     "queue": {"depth": int, "admitted": int, "rejected": int,
               "backfills": int, ...}?}

``apps/report --status`` is the reader, and :func:`render_status` the
top-like rendering it prints. The liveness of a supervised run is the
heartbeat file (``obs/watchdog``), which the status snapshot does not
replace.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import List, Optional

STATUS_VERSION = 1
STATUS_KIND = "run-status"


def write_status(path: str, doc: dict) -> None:
    """Atomically replace ``path`` with ``doc`` (tmp + fsync + rename —
    the ledger discipline: a poll never reads a torn snapshot)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".tmp-{os.path.basename(path)}-{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, default=str)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_status(path: str) -> Optional[dict]:
    """The snapshot, or None when missing/unparseable (a reader polls —
    absence means the run has not started or the file moved)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return doc if isinstance(doc, dict) else None


def validate_status(doc) -> List[str]:
    """Schema violations of one status document (empty = valid v1)."""
    if not isinstance(doc, dict):
        return [f"not an object: {type(doc).__name__}"]
    errs: List[str] = []
    if doc.get("v") != STATUS_VERSION:
        errs.append(f"unknown status version {doc.get('v')!r}")
    if doc.get("kind") != STATUS_KIND:
        errs.append(f"unknown kind {doc.get('kind')!r}")
    if not isinstance(doc.get("t"), (int, float)):
        errs.append("t must be a number")
    for fld in ("run", "app", "outcome"):
        if doc.get(fld) is not None and not isinstance(doc[fld], str):
            errs.append(f"{fld} must be a string or null")
    for fld in ("step", "iters"):
        v = doc.get(fld)
        if v is not None and (isinstance(v, bool) or not isinstance(v, int)):
            errs.append(f"{fld} must be an integer where present")
    for fld in ("per_step_s", "steps_per_s"):
        v = doc.get(fld)
        if v is not None and not isinstance(v, (int, float)):
            errs.append(f"{fld} must be a number where present")
    h = doc.get("health")
    if h is not None:
        if not isinstance(h, dict):
            errs.append("health must be an object")
        else:
            for fld in ("checks", "faults", "rollbacks"):
                if not isinstance(h.get(fld), int):
                    errs.append(f"health.{fld} must be an integer")
    a = doc.get("anomalies")
    if a is not None:
        if not isinstance(a, dict) or not isinstance(a.get("active"), list):
            errs.append("anomalies must be an object with an 'active' list")
        else:
            for fld in ("detected", "cleared"):
                if not isinstance(a.get(fld), int):
                    errs.append(f"anomalies.{fld} must be an integer")
            for i, ev in enumerate(a["active"]):
                if not isinstance(ev, dict) or not ev.get("metric"):
                    errs.append(f"anomalies.active[{i}] must name a metric")
    lanes = doc.get("lanes")
    if lanes is not None:
        if not isinstance(lanes, list):
            errs.append("lanes must be a list")
        else:
            for i, ln in enumerate(lanes):
                if not isinstance(ln, dict) or not isinstance(
                        ln.get("lane"), int):
                    errs.append(f"lanes[{i}] must carry an integer 'lane'")
                elif ln.get("slo") not in (None, "ok", "violated"):
                    errs.append(f"lanes[{i}].slo must be ok/violated/null")
    s = doc.get("slo")
    if s is not None and (not isinstance(s, dict)
                          or not isinstance(s.get("violations"), list)):
        errs.append("slo must be an object with a 'violations' list")
    q = doc.get("queue")
    if q is not None:
        if not isinstance(q, dict):
            errs.append("queue must be an object")
        else:
            for fld in ("depth", "admitted", "rejected", "backfills"):
                v = q.get(fld)
                if isinstance(v, bool) or not isinstance(v, int):
                    errs.append(f"queue.{fld} must be an integer")
            # capacity-engine counters (additive, optional: older
            # daemons never wrote them)
            for fld in ("preempted", "resized", "width"):
                v = q.get(fld)
                if v is not None and (isinstance(v, bool)
                                      or not isinstance(v, int)):
                    errs.append(f"queue.{fld} must be an integer")
    return errs


class StatusWriter:
    """The writer side: a persistent document merged per update and
    atomically flushed — the guarded loop updates step/health/anomalies,
    the campaign driver updates lanes/slo, and every update rewrites the
    ONE file (last-writer-wins per section is exactly right: each
    section has one owner)."""

    def __init__(self, path: str, *, app: Optional[str] = None,
                 run: Optional[str] = None, clock=time.time):
        self.path = path
        self._clock = clock
        self.doc: dict = {
            "v": STATUS_VERSION,
            "kind": STATUS_KIND,
            "run": run,
            "app": app,
            "t": clock(),
        }

    def set(self, **fields) -> dict:
        """Merge the given (non-None) fields WITHOUT flushing — for a
        section owner that runs inside someone else's update cycle (the
        campaign driver stages lanes/slo in ``on_chunk``; the guarded
        loop's per-chunk :meth:`update` flushes everything in ONE
        atomic write instead of two fsync+rename cycles per chunk)."""
        for k, v in fields.items():
            if v is not None:
                self.doc[k] = v
        return self.doc

    def update(self, **fields) -> dict:
        """Merge the given (non-None) fields, stamp ``t``, flush. A
        write failure is logged to the doc, never raised — status is
        evidence, not the measurement."""
        for k, v in fields.items():
            if v is not None:
                self.doc[k] = v
        self.doc["t"] = self._clock()
        try:
            write_status(self.path, self.doc)
        except OSError:
            pass  # a torn-down status dir must not crash the run
        return self.doc


def _age(t: float) -> str:
    age = time.time() - t
    return f"{age:.1f}s ago" if age >= 0 else "in the future?"


def render_status(doc: dict, now: Optional[float] = None) -> str:
    """The top-like rendering of a snapshot (what the JAX package's
    ``report --status`` prints)."""
    lines: List[str] = []
    head = f"run {doc.get('run') or '-'}"
    if doc.get("app"):
        head += f" ({doc['app']})"
    step, iters = doc.get("step"), doc.get("iters")
    if step is not None:
        head += f" · step {step}"
        if iters:
            head += f"/{iters} ({100.0 * step / iters:.0f}%)"
    per = doc.get("per_step_s")
    if isinstance(per, (int, float)) and math.isfinite(per):
        head += f" · {per:.6g} s/step"
        if per > 0:
            head += f" · {1.0 / per:.4g} steps/s"
    if doc.get("outcome"):
        head += f" · outcome={doc['outcome']}"
    if isinstance(doc.get("t"), (int, float)):
        head += f" · updated {_age(doc['t'])}"
    lines.append(head)
    h = doc.get("health")
    a = doc.get("anomalies")
    parts = []
    if isinstance(h, dict):
        parts.append(f"health: checks={h.get('checks', 0)} "
                     f"faults={h.get('faults', 0)} "
                     f"rollbacks={h.get('rollbacks', 0)}")
    if isinstance(a, dict):
        parts.append(f"anomalies: {len(a.get('active') or [])} active, "
                     f"{a.get('detected', 0)} detected, "
                     f"{a.get('cleared', 0)} cleared")
    if parts:
        lines.append(" · ".join(parts))
    q = doc.get("queue")
    if isinstance(q, dict):
        qline = (f"queue: depth={q.get('depth', 0)} "
                 f"admitted={q.get('admitted', 0)} "
                 f"rejected={q.get('rejected', 0)} "
                 f"backfills={q.get('backfills', 0)}")
        if isinstance(q.get("deferred"), int):
            qline += f" deferred={q['deferred']}"
        if isinstance(q.get("retired"), int):
            qline += f" retired={q['retired']}"
        if isinstance(q.get("width"), int):
            qline += f" width={q['width']}"
        if isinstance(q.get("preempted"), int) and q["preempted"]:
            qline += f" preempted={q['preempted']}"
        if isinstance(q.get("resized"), int) and q["resized"]:
            qline += f" resized={q['resized']}"
        lines.append(qline)
    for ev in (a or {}).get("active") or []:
        lines.append(
            f"  ANOMALY {ev.get('metric')} since step {ev.get('step')}: "
            f"value {ev.get('value')} outside "
            f"[{ev.get('lo')}, {ev.get('hi')}] ({ev.get('direction')})")
    slo = doc.get("slo")
    if isinstance(slo, dict) and slo.get("violations"):
        lines.append(f"SLO violations: {', '.join(slo['violations'])}")
    lanes = doc.get("lanes")
    if lanes:
        lines.append("lanes:")
        lines.append("  lane  tenant        step/steps  p50_ms    p99_ms"
                     "    deadline_ms  slo")
        for ln in lanes:
            def fnum(v):
                return f"{v:.4g}" if isinstance(v, (int, float)) else "-"

            steps = (f"{ln.get('step', '-')}/{ln.get('steps', '-')}"
                     if ln.get("tenant") else "-")
            lines.append(
                f"  {ln.get('lane', '-'):<5} "
                f"{(ln.get('tenant') or '(dead)'):<13} "
                f"{steps:<11} "
                f"{fnum(ln.get('p50_ms')):<9} "
                f"{fnum(ln.get('p99_ms')):<9} "
                f"{fnum(ln.get('deadline_ms')):<12} "
                f"{ln.get('slo') or '-'}")
    return "\n".join(lines)
