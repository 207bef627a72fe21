"""On-disk plan DB: tuned exchange plans keyed by canonical config.

The port's own copy of ``stencil_tpu.plan.db``, schema, version,
validation, migration and calibration rows unchanged, so a DB written by
either package loads in the other. ``autotune`` stores each winning
:class:`~.ir.PlanChoice` under its :class:`~.ir.PlanConfig` key, so a later
run replays it with zero probes (the ``plan.cache_hit`` gauge says so).
Keys carry the platform: the port's configs are ``"cpu"`` or ``"cuda"``, so
an entry or calibration row the JAX package wrote for ``"tpu"`` or
``"gpu"`` loads and survives a rewrite but never matches a port config.

Format: one JSON file, schema v1, validated like the metrics JSONL
(one schema authority, :func:`validate_db`):

    {"v": 1, "kind": "stencil-plan-db",
     "entries": {"<canonical config key>": {
        "config":   {...PlanConfig.to_json()...},
        "choice":   {...PlanChoice.to_json()...},
        "source":   "probe" | "static" | "seed" | "legacy",
        "static_cost_s": float | null,
        "measured_s":    float | null,     # per-exchange trimean (probe/seed)
        "probes":   [{"label": ..., "trimean_s": ...}, ...],
        "written_t": float,
        "note":     str | null}},
     "calibrations": {"<platform>": {        # optional; absent = defaults
        "calibration": {...score() override...},
        "provenance": "fitted(n=…, r2=…)", "n": int, "r2": float, ...}}}

Writes are tmp + fsync + atomic rename (a crash never leaves a torn DB);
corrupt or future-versioned files are rejected (:class:`PlanDBError`),
never emptied; the legacy layout (v0: a flat ``{key: choice}`` mapping) is
migrated forward on load.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

from ..geometry import Dim3
from .ir import METHODS, PlanChoice, PlanConfig, validate_hierarchy, validate_placement

DB_VERSION = 1
DB_KIND = "stencil-plan-db"
SOURCES = ("probe", "static", "seed", "legacy")
_TMP_PREFIX = ".tmp-"


class PlanDBError(ValueError):
    """Corrupt, unparseable, or future-versioned plan DB."""


def empty_db() -> dict:
    return {"v": DB_VERSION, "kind": DB_KIND, "entries": {}}


def make_entry(config: PlanConfig, choice: PlanChoice, source: str,
               static_cost_s: Optional[float] = None,
               measured_s: Optional[float] = None,
               probes: Optional[list] = None,
               note: Optional[str] = None) -> dict:
    if source not in SOURCES:
        raise ValueError(f"unknown plan source {source!r} "
                         f"(known: {', '.join(SOURCES)})")
    return {
        "config": config.to_json(),
        "choice": choice.to_json(),
        "source": source,
        "static_cost_s": static_cost_s,
        "measured_s": measured_s,
        "probes": list(probes or []),
        "written_t": time.time(),
        "note": note,
    }


def validate_entry(key: str, entry) -> List[str]:
    errs: List[str] = []
    if not isinstance(entry, dict):
        return [f"entry {key!r} is not an object"]
    try:
        cfg = PlanConfig.from_json(entry["config"])
    except (KeyError, TypeError, ValueError) as e:
        return [f"entry {key!r}: bad config ({e})"]
    if cfg.key() != key:
        errs.append(f"entry {key!r}: key does not match its config "
                    f"(canonical {cfg.key()!r})")
    try:
        choice = PlanChoice.from_json(entry["choice"])
    except (KeyError, TypeError, ValueError) as e:
        return errs + [f"entry {key!r}: bad choice ({e})"]
    if choice.method not in METHODS:
        errs.append(f"entry {key!r}: unknown method {choice.method!r}")
    if len(choice.partition) != 3 or any(
            not isinstance(p, int) or p < 1 for p in choice.partition):
        errs.append(f"entry {key!r}: partition must be 3 positive ints")
    if choice.multistep_k < 1:
        errs.append(f"entry {key!r}: multistep_k must be >= 1")
    # placement rides schema v1: an ABSENT field is the identity
    # assignment (every pre-placement entry — legacy v0 migrations
    # included — deserializes to None and replays unchanged); a present
    # one must be a permutation of the config's mesh positions
    perr = validate_placement(choice.placement, cfg.ndev)
    if perr is not None:
        errs.append(f"entry {key!r}: {perr}")
    # hierarchy/host_placement ride the same absent-field migration:
    # every pre-hierarchy entry deserializes to None (flat) and replays
    # unchanged; a present hierarchy must be a valid (axis, hosts) split
    # of the choice's partition, a present host_placement a permutation
    # of range(hosts)
    if choice.hierarchy is not None:
        px, py, pz = choice.partition
        herr = validate_hierarchy(choice.hierarchy, Dim3(px, py, pz))
        if herr is not None:
            errs.append(f"entry {key!r}: {herr}")
    if choice.host_placement is not None:
        hp = list(choice.host_placement)
        hosts = choice.hierarchy[1] if choice.hierarchy is not None else None
        if hosts is None:
            errs.append(f"entry {key!r}: host_placement without hierarchy")
        elif sorted(hp) != list(range(hosts)):
            errs.append(f"entry {key!r}: host_placement {hp} is not a "
                        f"permutation of range({hosts})")
    if entry.get("source") not in SOURCES:
        errs.append(f"entry {key!r}: unknown source {entry.get('source')!r}")
    for fld in ("static_cost_s", "measured_s"):
        v = entry.get(fld)
        if v is not None and not isinstance(v, (int, float)):
            errs.append(f"entry {key!r}: {fld} must be numeric or null")
    return errs


def validate_calibration_row(platform: str, row) -> List[str]:
    """Violations of one fitted-calibration row (``calibrations``
    section). The row is what :func:`.calibrate.fit`
    returns: the score() override dict plus its fit provenance."""
    pfx = f"calibration {platform!r}"
    if not isinstance(row, dict):
        return [f"{pfx} is not an object"]
    errs: List[str] = []
    if not isinstance(row.get("calibration"), dict):
        errs.append(f"{pfx}: missing calibration override dict")
    if not isinstance(row.get("provenance"), str) or not row.get("provenance"):
        errs.append(f"{pfx}: provenance must be a non-empty string")
    n = row.get("n")
    if not isinstance(n, int) or isinstance(n, bool) or n < 2:
        errs.append(f"{pfx}: n must be an int >= 2 (a fit from fewer "
                    "samples is refused at fit time, never persisted)")
    if not isinstance(row.get("r2"), (int, float)):
        errs.append(f"{pfx}: r2 must be numeric")
    return errs


def validate_db(obj) -> List[str]:
    """Schema violations of a parsed DB (empty = valid v1)."""
    if not isinstance(obj, dict):
        return [f"not an object: {type(obj).__name__}"]
    errs: List[str] = []
    if obj.get("kind") != DB_KIND:
        errs.append(f"unknown kind {obj.get('kind')!r}")
    if obj.get("v") != DB_VERSION:
        errs.append(f"unknown schema version {obj.get('v')!r}")
    entries = obj.get("entries")
    if not isinstance(entries, dict):
        errs.append("entries must be an object")
        return errs
    for key, entry in entries.items():
        errs.extend(validate_entry(key, entry))
    # "calibrations" rides schema v1 the way placement rides entries: an
    # ABSENT section is "no fitted rows, DEFAULT_CALIBRATION applies"
    # (every pre-observatory DB loads unchanged); a present one maps
    # platform -> fitted row
    if "calibrations" in obj:
        cals = obj["calibrations"]
        if not isinstance(cals, dict):
            errs.append("calibrations must be an object")
        else:
            for platform, row in cals.items():
                errs.extend(validate_calibration_row(platform, row))
    return errs


def migrate_db(obj: dict) -> dict:
    """Bring a stale-schema DB forward to v1.

    Known legacy layout (v0, the pre-schema prototype): a flat
    ``{config-key: choice-json}`` mapping with no version envelope. Its
    entries become v1 entries with ``source="legacy"`` and no recorded
    cost — a lookup hit still replays them, and ``plan_tool prune
    --source legacy`` clears them once re-tuned. Anything newer than
    DB_VERSION is refused (a downgrade must not silently rewrite a
    future DB)."""
    if not isinstance(obj, dict):
        raise PlanDBError(f"plan DB is not an object: {type(obj).__name__}")
    v = obj.get("v")
    if v == DB_VERSION and obj.get("kind") == DB_KIND:
        return obj
    if isinstance(v, int) and v > DB_VERSION:
        raise PlanDBError(
            f"plan DB schema v{v} is newer than this build's v{DB_VERSION}"
        )
    if "v" not in obj and "kind" not in obj:
        # v0 flat mapping: every value must parse as a choice
        entries = {}
        for key, val in obj.items():
            try:
                cfg = PlanConfig.from_json(json.loads(key))
                choice = PlanChoice.from_json(val)
            except (KeyError, TypeError, ValueError,
                    json.JSONDecodeError) as e:
                raise PlanDBError(f"legacy plan DB entry {key!r}: {e}")
            entries[cfg.key()] = make_entry(
                cfg, choice, "legacy", note="migrated from v0 flat layout"
            )
        return {"v": DB_VERSION, "kind": DB_KIND, "entries": entries}
    raise PlanDBError(
        f"unrecognized plan DB envelope (v={obj.get('v')!r}, "
        f"kind={obj.get('kind')!r})"
    )


def load_db(path: str) -> dict:
    """Parse + migrate + validate; missing file -> empty DB. Corruption
    raises :class:`PlanDBError` — callers decide whether to degrade
    (autotune warns and runs un-persisted) or fail (the CI gate)."""
    if not os.path.exists(path):
        return empty_db()
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise PlanDBError(f"unreadable plan DB {path}: {e}")
    obj = migrate_db(obj)
    errs = validate_db(obj)
    if errs:
        raise PlanDBError(
            f"invalid plan DB {path}: {errs[0]}"
            + (f" (+{len(errs) - 1} more)" if len(errs) > 1 else "")
        )
    return obj


def save_db(path: str, db: dict) -> None:
    """Atomic write: tmp + fsync + rename (ckpt rename discipline)."""
    errs = validate_db(db)
    if errs:
        raise PlanDBError(f"refusing to write invalid plan DB: {errs[0]}")
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f"{_TMP_PREFIX}{os.path.basename(path)}-{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(db, f, indent=1, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def lookup(db: dict, config: PlanConfig) -> Optional[dict]:
    """The entry tuned for ``config`` (exact canonical-key match)."""
    return db["entries"].get(config.key())


def record(db: dict, entry: dict) -> dict:
    """Insert/replace ``entry`` under its config's canonical key."""
    key = PlanConfig.from_json(entry["config"]).key()
    db["entries"][key] = entry
    return entry


def record_calibration(db: dict, platform: str, row: dict) -> dict:
    """Install/replace the fitted calibration row for ``platform``."""
    errs = validate_calibration_row(platform, row)
    if errs:
        raise PlanDBError(f"refusing to record calibration: {errs[0]}")
    db.setdefault("calibrations", {})[platform] = row
    return row


def lookup_calibration(db: dict, platform: str) -> Optional[dict]:
    """The fitted calibration row for ``platform``, or None (the
    absent-section default: DEFAULT_CALIBRATION, provenance modeled)."""
    return (db.get("calibrations") or {}).get(platform)


def prune_db(db: dict, platform: Optional[str] = None,
             source: Optional[str] = None,
             older_than_s: Optional[float] = None) -> int:
    """Drop entries matching every given filter; returns the count.
    At least one filter is required — "prune everything" must be an
    explicit ``source=...``/``platform=...`` decision, not a default."""
    if platform is None and source is None and older_than_s is None:
        raise ValueError("prune_db requires at least one filter")
    now = time.time()
    doomed = []
    for key, entry in db["entries"].items():
        if platform is not None and entry["config"].get("platform") != platform:
            continue
        if source is not None and entry.get("source") != source:
            continue
        if older_than_s is not None and (
                now - entry.get("written_t", 0)) < older_than_s:
            continue
        doomed.append(key)
    for key in doomed:
        del db["entries"][key]
    return len(doomed)
