"""File-drop job intake: ``jobs/incoming/*.json`` -> claimed or quarantined.

The port's counterpart of ``stencil_tpu.serve.intake``. The serving
daemon's wire protocol is a directory (a socket front-end would write the
same files). A producer drops one JSON document per job, ATOMICALLY (write
a tmp file in the same directory, then rename — the daemon must never read
a half-written job; ``apps/serve_loadgen.py`` is the reference writer). The daemon claims a job by renaming it into
``jobs/claimed/`` — rename is atomic on POSIX, so two pollers can race
and exactly one wins; a claimed file is never re-read, which is what
makes "never re-run a retired job" crash-safe end to end.

Malformed or duplicate jobs must never kill the daemon: they are
quarantined LOUDLY into ``jobs/bad/`` next to a ``<name>.reason.txt``
explaining the rejection, and the daemon emits a schema-valid
``serve.rejected`` record — the operator greps the reason file, the
dashboard counts the record, and serving continues.

Job document::

    {"job": "j-0001",              # unique id (becomes the tenant id)
     "size": 16 | [16, 16, 16],    # per-tenant box (x, y, z)
     "steps": 8,                   # tenant steps to run
     "tenant": "alice",            # owner for quotas (default: the job id)
     "workload": "jacobi",         # campaign WORKLOADS key
     "dtype": "float32", "seed": 0,
     "deadline_ms": 5.0,           # per-step p99 SLO (admission-priced)
     "priority": "high"|"normal"|"low"}
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..campaign.driver import WORKLOADS, TenantJob

# priority classes: lower rank schedules first; reordering applies to
# QUEUED jobs only — a running lane is never preempted (structural: the
# queue holds only unscheduled jobs)
PRIORITIES = {"high": 0, "normal": 1, "low": 2}
DTYPES = ("float32", "float64")

_REQUIRED = ("job", "size", "steps")
_KNOWN = _REQUIRED + ("tenant", "workload", "dtype", "seed", "deadline_ms",
                      "priority")


@dataclass
class ServeJob(TenantJob):
    """A :class:`TenantJob` plus its serving identity: the owning tenant
    (quota accounting), priority class, and admission sequence number
    (the FIFO tiebreak). Slots, lanes, backfill and snapshots see it as
    a plain TenantJob."""

    owner: str = ""
    priority: str = "normal"
    seq: int = 0
    # when the LIVE queue admitted the job (the aging clock's zero);
    # None until queued. Deliberately absent from spec_doc: a revived
    # job's wait restarts — aging measures THIS daemon's debt to it.
    admit_t: Optional[float] = None

    def order_key(self) -> Tuple[int, float, int]:
        """The LIVE queue's scheduling order: priority class, then
        deadline (tightest first — deadline-sorted bucket packing),
        then admission order."""
        d = (float(self.deadline_ms) if self.deadline_ms is not None
             else math.inf)
        return (PRIORITIES.get(self.priority, PRIORITIES["normal"]), d,
                self.seq)

    def spec_doc(self) -> dict:
        """The normalized job document (serve-state.json's ``spec`` —
        a revived daemon rebuilds the job from exactly this)."""
        return {
            "job": self.tid, "size": list(self.size), "steps": self.steps,
            "tenant": self.owner, "workload": self.workload,
            "dtype": self.dtype, "seed": self.seed,
            "deadline_ms": self.deadline_ms, "priority": self.priority,
        }


def validate_job(doc) -> List[str]:
    """Schema violations of one job document (empty = admissible shape).
    The single authority — intake, tests, and the loadgen writer agree
    through this."""
    if not isinstance(doc, dict):
        return [f"not an object: {type(doc).__name__}"]
    errs: List[str] = []
    for fld in _REQUIRED:
        if fld not in doc:
            errs.append(f"missing required field {fld!r}")
    unknown = sorted(set(doc) - set(_KNOWN))
    if unknown:
        errs.append(f"unknown fields {unknown}")
    jid = doc.get("job")
    if "job" in doc and (not isinstance(jid, str) or not jid
                         or "/" in jid or jid.startswith(".")):
        errs.append(f"job must be a non-empty path-safe string, got {jid!r}")
    size = doc.get("size")
    if "size" in doc:
        if isinstance(size, int) and not isinstance(size, bool):
            size = [size, size, size]
        if (not isinstance(size, (list, tuple)) or len(size) != 3
                or any(isinstance(v, bool) or not isinstance(v, int)
                       or v < 1 for v in size)):
            errs.append(f"size must be a positive int or [x, y, z], "
                        f"got {doc.get('size')!r}")
    steps = doc.get("steps")
    if "steps" in doc and (isinstance(steps, bool)
                           or not isinstance(steps, int) or steps < 1):
        errs.append(f"steps must be a positive integer, got {steps!r}")
    wl = doc.get("workload", "jacobi")
    if wl not in WORKLOADS:
        errs.append(f"unknown workload {wl!r} (known: {sorted(WORKLOADS)})")
    dt = doc.get("dtype", "float32")
    if dt not in DTYPES:
        errs.append(f"unknown dtype {dt!r} (known: {list(DTYPES)})")
    seed = doc.get("seed", 0)
    if isinstance(seed, bool) or not isinstance(seed, int):
        errs.append(f"seed must be an integer, got {seed!r}")
    tenant = doc.get("tenant")
    if tenant is not None and (not isinstance(tenant, str) or not tenant):
        errs.append(f"tenant must be a non-empty string, got {tenant!r}")
    dl = doc.get("deadline_ms")
    if dl is not None and (isinstance(dl, bool)
                           or not isinstance(dl, (int, float))
                           or not math.isfinite(dl) or dl <= 0):
        errs.append(f"deadline_ms must be a positive finite number, "
                    f"got {dl!r}")
    pri = doc.get("priority", "normal")
    if pri not in PRIORITIES:
        errs.append(f"unknown priority {pri!r} "
                    f"(known: {sorted(PRIORITIES)})")
    return errs


def job_from_doc(doc: dict, seq: int) -> ServeJob:
    """Build the queue entry from a VALIDATED job document."""
    size = doc["size"]
    if isinstance(size, int):
        size = [size, size, size]
    jid = doc["job"]
    return ServeJob(
        tid=jid,
        size=(int(size[0]), int(size[1]), int(size[2])),
        steps=int(doc["steps"]),
        dtype=doc.get("dtype", "float32"),
        seed=int(doc.get("seed", 0)),
        workload=doc.get("workload", "jacobi"),
        deadline_ms=(float(doc["deadline_ms"])
                     if doc.get("deadline_ms") is not None else None),
        owner=doc.get("tenant") or jid,
        priority=doc.get("priority", "normal"),
        seq=int(seq),
    )


class Intake:
    """The daemon side of the file-drop protocol: claim-by-rename from
    ``jobs/incoming/``, quarantine-with-reason into ``jobs/bad/``."""

    def __init__(self, serve_dir: str):
        self.incoming = os.path.join(serve_dir, "jobs", "incoming")
        self.claimed = os.path.join(serve_dir, "jobs", "claimed")
        self.bad = os.path.join(serve_dir, "jobs", "bad")
        for d in (self.incoming, self.claimed, self.bad):
            os.makedirs(d, exist_ok=True)

    def poll(self) -> List[Tuple[str, Optional[dict], List[str]]]:
        """Claim every currently-visible job file, oldest first. Returns
        ``[(claimed_path, doc | None, parse_errors), ...]`` — a doc of
        None means the file was not valid JSON (truncated drop, not an
        atomic writer); schema judgment is the admission layer's."""
        try:
            names = [n for n in os.listdir(self.incoming)
                     if n.endswith(".json") and not n.startswith(".")]
        except OSError:
            return []
        entries = []
        for n in names:
            src = os.path.join(self.incoming, n)
            try:
                entries.append((os.stat(src).st_mtime, n, src))
            except OSError:
                continue  # raced away
        out: List[Tuple[str, Optional[dict], List[str]]] = []
        for _, n, src in sorted(entries):
            dst = os.path.join(self.claimed, n)
            try:
                os.replace(src, dst)  # the atomic claim
            except OSError:
                continue  # another claimer won
            try:
                with open(dst) as f:
                    doc = json.load(f)
            except json.JSONDecodeError as e:
                out.append((dst, None, [f"not valid JSON: {e}"]))
                continue
            except OSError as e:
                out.append((dst, None, [f"unreadable: {e}"]))
                continue
            out.append((dst, doc if isinstance(doc, dict)
                        else None,
                        [] if isinstance(doc, dict)
                        else [f"not a JSON object: {type(doc).__name__}"]))
        return out

    def quarantine(self, claimed_path: str, reason: str) -> str:
        """Move a claimed file into ``jobs/bad/`` with a reason file —
        the loud half of "never kill the daemon". Returns the bad path."""
        name = os.path.basename(claimed_path)
        dst = os.path.join(self.bad, name)
        if os.path.exists(dst):  # a replayed file name: keep both
            stem, ext = os.path.splitext(name)
            i = 1
            while os.path.exists(dst):
                dst = os.path.join(self.bad, f"{stem}.{i}{ext}")
                i += 1
        try:
            os.replace(claimed_path, dst)
        except OSError:
            dst = claimed_path  # leave it claimed; the reason still lands
        try:
            with open(dst + ".reason.txt", "w") as f:
                f.write(reason.rstrip() + "\n")
        except OSError:
            pass  # quarantine is evidence, not the measurement
        return dst
