"""The serving daemon's durable queue+lane state: ``serve-state.json``.

The port's counterpart of ``stencil_tpu.serve.state``, writing and reading
the same document. One small atomic JSON document (the ledger/status write discipline:
tmp + fsync + rename — a reader or a reviving daemon NEVER sees a torn
file) recording every job the daemon has ever accepted and where it
stands. The revival contract rides on it: a daemon killed mid-serve is
restarted (by a supervisor), reads this file, re-queues every
``queued``/``deferred``/``running`` job (running ones resume from their
newest tenant snapshot — bit-identical by the ckpt contract) and NEVER
re-runs a ``done``/``fault``/``rejected`` one.

State document (schema v1)::

    {"v": 1, "kind": "serve-state",
     "t": unix seconds of the last write,
     "draining": bool,
     "counters": {"admitted": int, "rejected": int, "deferred": int,
                  "backfills": int, "retired": int},
     "jobs": {jid: {"state": "queued"|"deferred"|"running"|"done"|
                             "fault"|"rejected",
                    "steps_done": int, "owner": str, "priority": str,
                    "seq": int, "spec": {...the normalized job doc...},
                    "reason": str?}}}

PURE STDLIB: a supervisor (or a human's ``jq``) must be able to read the
file without the package.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

STATE_VERSION = 1
STATE_KIND = "serve-state"

# the full job lifecycle; the first three are "live" (a revived daemon
# owes them work), the last three are terminal (never re-run)
JOB_STATES = ("queued", "deferred", "running", "done", "fault", "rejected")
LIVE_STATES = ("queued", "deferred", "running")
COUNTERS = ("admitted", "rejected", "deferred", "backfills", "retired")


def make_state() -> dict:
    """A fresh v1 state document."""
    return {
        "v": STATE_VERSION,
        "kind": STATE_KIND,
        "t": 0.0,
        "draining": False,
        "counters": {k: 0 for k in COUNTERS},
        "jobs": {},
    }


def write_state(path: str, doc: dict) -> None:
    """Atomically replace ``path`` with ``doc``, stamping ``t`` (tmp +
    fsync + rename: a crash between admissions never tears the queue)."""
    doc["t"] = time.time()
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".tmp-{os.path.basename(path)}-{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_state(path: str) -> Optional[dict]:
    """The state document, or None when missing/unparseable (a fresh
    daemon starts empty; a torn file is impossible by the atomic-write
    discipline, so unparseable means "not ours")."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return doc if isinstance(doc, dict) else None


def validate_state(doc) -> List[str]:
    """Schema violations of one state document (empty = valid v1)."""
    if not isinstance(doc, dict):
        return [f"not an object: {type(doc).__name__}"]
    errs: List[str] = []
    if doc.get("v") != STATE_VERSION:
        errs.append(f"unknown state version {doc.get('v')!r}")
    if doc.get("kind") != STATE_KIND:
        errs.append(f"unknown kind {doc.get('kind')!r}")
    if not isinstance(doc.get("t"), (int, float)):
        errs.append("t must be a number")
    if not isinstance(doc.get("draining"), bool):
        errs.append("draining must be a boolean")
    c = doc.get("counters")
    if not isinstance(c, dict):
        errs.append("counters must be an object")
    else:
        for fld in COUNTERS:
            v = c.get(fld)
            if isinstance(v, bool) or not isinstance(v, int):
                errs.append(f"counters.{fld} must be an integer")
    jobs = doc.get("jobs")
    if not isinstance(jobs, dict):
        errs.append("jobs must be an object")
        return errs
    for jid, j in jobs.items():
        if not isinstance(j, dict):
            errs.append(f"jobs[{jid}] must be an object")
            continue
        if j.get("state") not in JOB_STATES:
            errs.append(f"jobs[{jid}].state {j.get('state')!r} is not one "
                        f"of {JOB_STATES}")
        sd = j.get("steps_done")
        if isinstance(sd, bool) or not isinstance(sd, int):
            errs.append(f"jobs[{jid}].steps_done must be an integer")
        for fld in ("owner", "priority"):
            if not isinstance(j.get(fld), str):
                errs.append(f"jobs[{jid}].{fld} must be a string")
        seq = j.get("seq")
        if isinstance(seq, bool) or not isinstance(seq, int):
            errs.append(f"jobs[{jid}].seq must be an integer")
        if j.get("state") != "rejected" and not isinstance(
                j.get("spec"), dict):
            errs.append(f"jobs[{jid}].spec must be an object")
    return errs
