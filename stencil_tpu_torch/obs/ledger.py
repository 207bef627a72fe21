"""The performance ledger: append-only, cross-run measurement evidence.

The port's own copy of ``stencil_tpu.obs.ledger`` (pure stdlib, so it is
copied, not imported). Every recorded measurement is one schema-validated
JSON line in a ledger file, keyed by::

    (metric, platform, config fingerprint, git rev, round/label)

The format is the JAX package's v1, byte for byte, so either package reads
and appends to the other's file. Entry schema (one JSON object per line)::

    {"v": 1, "kind": "perf-ledger",
     "metric":   str,          # e.g. serve.step_p99_ms
     "value":    finite float,
     "unit":     str | null,
     "platform": str,          # "cuda" | "cpu" | "tpu" | "unknown" | ...
     "config":   str,          # config fingerprint (config_fingerprint())
     "rev":      str | null,   # git revision of the measured tree
     "label":    str,          # round/run label
     "source":   "bench" | "legacy-bench" | "legacy-multichip"
               | "metrics" | "manual" | "serve",
     "t":        unix seconds,
     "run":      str | null,   # telemetry run id where applicable
     "detail":   object?}      # free-form provenance

Write discipline: the whole file is rewritten through tmp + fsync + atomic
rename under an exclusive ``<path>.lock`` flock (a crash never leaves a torn
line; concurrent appenders serialize), existing lines are preserved
verbatim, corrupt or future-versioned ledgers are rejected loudly
(:class:`LedgerError`), and appends dedup on :func:`entry_key`.

:func:`host_fingerprint` names what measured an entry: the platform and,
on the card, its name (``torch.cuda.get_device_name``). The serving layer
writes it into its entries' ``detail``. The JAX module's ingest of bench
payloads and metrics files belongs to ``apps/perf_tool``, which is not
ported yet (ROADMAP.md queue A item 4).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import subprocess
import time
from typing import Iterable, List, Optional, Sequence, Tuple

try:
    import fcntl  # POSIX; absent on Windows: appends degrade to unlocked
except ImportError:  # pragma: no cover
    fcntl = None

SCHEMA_VERSION = 1
LEDGER_KIND = "perf-ledger"
SOURCES = ("bench", "legacy-bench", "legacy-multichip", "metrics", "manual", "serve")
_TMP_PREFIX = ".tmp-"


class LedgerError(ValueError):
    """Corrupt, unparseable, or future-versioned ledger."""


# -- robust stats ---------------------------------------------------------------


def _quantile(sorted_v: Sequence[float], q: float) -> float:
    if len(sorted_v) == 1:
        return sorted_v[0]
    pos = q * (len(sorted_v) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(sorted_v) - 1)
    frac = pos - lo
    return sorted_v[lo] * (1 - frac) + sorted_v[hi] * frac


def trimean(values: Iterable[float]) -> float:
    """Tukey's trimean (Q1 + 2*Q2 + Q3) / 4 over interpolated quantiles."""
    v = sorted(float(x) for x in values)
    if not v:
        raise ValueError("trimean of an empty sample")
    return (_quantile(v, 0.25) + 2 * _quantile(v, 0.5) + _quantile(v, 0.75)) / 4


def mad(values: Iterable[float]) -> float:
    """Median absolute deviation."""
    v = sorted(float(x) for x in values)
    if not v:
        raise ValueError("MAD of an empty sample")
    med = _quantile(v, 0.5)
    return _quantile(sorted(abs(x - med) for x in v), 0.5)


# -- entries ----------------------------------------------------------------------


# Keys that change how a run was observed or perturbed, never what it
# measured: two runs of one program land under one fingerprint.
VOLATILE_CONFIG_KEYS = frozenset({
    "metrics_out", "metrics_dma", "run_id", "out", "prefix", "ckpt_dir",
    "campaign_dir", "plan_db", "inject", "resume", "paraview",
    "paraview_every", "checkpoint_period",
    "status_file", "live_sentinel", "live_config", "deadline_ms",
})


def config_fingerprint(config: Optional[dict]) -> str:
    """12-hex fingerprint of a canonicalized config dict (sorted keys;
    None-valued and :data:`VOLATILE_CONFIG_KEYS` dropped)."""
    clean = {k: v for k, v in sorted((config or {}).items())
             if v is not None and k not in VOLATILE_CONFIG_KEYS}
    blob = json.dumps(clean, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def host_fingerprint(device) -> dict:
    """``{"platform", "device"}`` of a torch device: ``"cuda"`` and the
    card's name (``torch.cuda.get_device_name``), or ``"cpu"`` and
    ``"cpu"``. Imports torch only when asked about a card."""
    kind = getattr(device, "type", str(device).split(":")[0])
    if kind != "cuda":
        return {"platform": kind, "device": kind}
    import torch

    return {"platform": "cuda", "device": torch.cuda.get_device_name(device)}


def make_entry(metric: str, value: float, *, label: str,
               unit: Optional[str] = None, platform: str = "unknown",
               config: Optional[dict] = None, rev: Optional[str] = None,
               source: str = "manual", run: Optional[str] = None,
               t: Optional[float] = None,
               detail: Optional[dict] = None) -> dict:
    """Build one v1 ledger entry; ``config`` is fingerprinted."""
    e = {
        "v": SCHEMA_VERSION,
        "kind": LEDGER_KIND,
        "metric": metric,
        "value": float(value),
        "unit": unit,
        "platform": platform,
        "config": config if isinstance(config, str) else config_fingerprint(config),
        "rev": rev,
        "label": label,
        "source": source,
        "t": time.time() if t is None else float(t),
        "run": run,
    }
    if detail:
        e["detail"] = detail
    return e


def entry_key(e: dict) -> Tuple[str, str, str, str, str]:
    """The identity under which entries dedup and trend-group."""
    return (e["metric"], e["platform"], e["config"], e.get("rev") or "", e["label"])


def validate_entry(e) -> List[str]:
    """Schema violations of one entry (empty = valid v1)."""
    if not isinstance(e, dict):
        return [f"not an object: {type(e).__name__}"]
    errs: List[str] = []
    v = e.get("v")
    if isinstance(v, int) and v > SCHEMA_VERSION:
        # refuse future schemas outright: a downgrade must not reinterpret
        return [f"ledger schema v{v} is newer than this build's v{SCHEMA_VERSION}"]
    if v != SCHEMA_VERSION:
        errs.append(f"unknown schema version {v!r}")
    if e.get("kind") != LEDGER_KIND:
        errs.append(f"unknown kind {e.get('kind')!r}")
    for fld in ("metric", "platform", "config", "label"):
        if not isinstance(e.get(fld), str) or not e.get(fld):
            errs.append(f"{fld} must be a non-empty string")
    val = e.get("value")
    if isinstance(val, bool) or not isinstance(val, (int, float)):
        errs.append("value must be a number")
    elif not math.isfinite(val):
        errs.append("value must be finite (strict-JSON ledger)")
    if not isinstance(e.get("t"), (int, float)):
        errs.append("t must be a number")
    for fld in ("unit", "rev", "run"):
        if e.get(fld) is not None and not isinstance(e[fld], str):
            errs.append(f"{fld} must be a string or null")
    if e.get("source") not in SOURCES:
        errs.append(f"unknown source {e.get('source')!r}")
    if "detail" in e and not isinstance(e["detail"], dict):
        errs.append("detail must be an object where present")
    return errs


# -- file I/O ---------------------------------------------------------------------


def _read_ledger(path: str) -> Tuple[List[dict], List[str]]:
    """(validated entries, raw stripped lines) in one pass."""
    if not os.path.exists(path):
        return [], []
    entries: List[dict] = []
    raw: List[str] = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                e = json.loads(line)
            except json.JSONDecodeError as exc:
                raise LedgerError(f"{path}:{i}: unparseable JSON ({exc})")
            errs = validate_entry(e)
            if errs:
                raise LedgerError(f"{path}:{i}: {errs[0]}"
                                  + (f" (+{len(errs) - 1} more)" if len(errs) > 1 else ""))
            entries.append(e)
            raw.append(line)
    return entries, raw


def load_ledger(path: str) -> List[dict]:
    """Parse and validate every line; a missing file is []. Any unparseable
    or schema-invalid line raises :class:`LedgerError`: a corrupt ledger
    never silently shrinks into a shorter history."""
    return _read_ledger(path)[0]


@contextlib.contextmanager
def _ledger_lock(path: str):
    """Exclusive flock on ``<path>.lock`` for the append's read-modify-write
    (the JAX package's lock file, so appenders of both packages serialize).
    Best-effort where flock is unavailable."""
    if fcntl is None:
        yield
        return
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd = os.open(path + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)  # releases the flock


def append_entries(path: str, entries: Sequence[dict], dedup: bool = True) -> int:
    """Append validated entries atomically; returns the number written.
    Existing lines are kept verbatim; with ``dedup`` entries whose
    :func:`entry_key` already exists are skipped. Appending to a corrupt
    ledger raises instead of clobbering it."""
    for e in entries:
        errs = validate_entry(e)
        if errs:
            raise LedgerError(f"refusing to append invalid entry: {errs[0]} "
                              f"({e.get('metric')!r})")
    with _ledger_lock(path):
        return _append_locked(path, entries, dedup)


def _append_locked(path: str, entries: Sequence[dict], dedup: bool) -> int:
    existing, existing_raw = _read_ledger(path)  # raises on corruption
    seen = {entry_key(e) for e in existing}
    new_lines: List[str] = []
    for e in entries:
        k = entry_key(e)
        if dedup and k in seen:
            continue
        seen.add(k)
        new_lines.append(json.dumps(e, sort_keys=True))
    if not new_lines:
        return 0
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f"{_TMP_PREFIX}{os.path.basename(path)}-{os.getpid()}")
    with open(tmp, "w") as f:
        for ln in existing_raw + new_lines:
            f.write(ln + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return len(new_lines)


def git_rev(cwd: Optional[str] = None) -> Optional[str]:
    """Short git revision of ``cwd`` (best-effort; None outside a repo)."""
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=cwd,
                             capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    rev = out.stdout.strip()
    return rev if out.returncode == 0 and rev else None
