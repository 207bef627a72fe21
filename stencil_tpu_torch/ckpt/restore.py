"""Validate and read back snapshots: the read side.

The port's own copy of ``stencil_tpu.ckpt.restore``. A snapshot stores
per-block compute interiors plus a manifest; nothing in it presumes the
restoring run's partition or device, and the format is the JAX package's,
so either package restores the other's snapshots bit for bit
(:func:`assemble_global` is pure numpy).

Validation layers (cheap to deep): :func:`validate_manifest` (schema),
:func:`validate_snapshot` (files present, byte counts, SHA-256 unless
``deep=False``, blocks tile the global grid), and :func:`find_resume`, the
auto-resume policy: snapshots newest step first, the first valid (and
``accept``-ed) one wins. :func:`quarantine_snapshot` renames a bad snapshot
aside so it is never rescanned.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional, Tuple

import numpy as np

from ..obs import telemetry
from ..utils import logging as log
from .snapshot import (
    LATEST_NAME,
    MANIFEST_NAME,
    MANIFEST_VERSION,
    _sha256,
    _write_latest,
    list_snapshots,
    read_latest,
    step_of,
)

#: Prefix of quarantined snapshot dirs — ``list_snapshots``/``find_resume``
#: never look at them again (``step_of`` only parses ``step-`` names).
QUARANTINE_PREFIX = "quarantine-"


def load_manifest(snapshot_dir: str) -> dict:
    """Parse ``manifest.json`` (raises OSError/ValueError on a bad one)."""
    with open(os.path.join(snapshot_dir, MANIFEST_NAME)) as f:
        m = json.load(f)
    if not isinstance(m, dict):
        raise ValueError(f"manifest is not an object: {snapshot_dir}")
    return m


def validate_manifest(m: dict) -> List[str]:
    """Structural schema check; returns the list of violations."""
    errs: List[str] = []
    if not isinstance(m, dict):
        return ["manifest is not an object"]
    if m.get("v") != MANIFEST_VERSION:
        errs.append(f"unknown manifest version {m.get('v')!r}")
    if m.get("kind") != "stencil-ckpt":
        errs.append(f"unknown manifest kind {m.get('kind')!r}")
    if not isinstance(m.get("step"), int) or m.get("step", -1) < 0:
        errs.append("step must be a non-negative integer")
    for key in ("global", "partition"):
        v = m.get(key)
        if not (isinstance(v, dict)
                and all(isinstance(v.get(a), int) and v.get(a, 0) >= 1
                        for a in ("x", "y", "z"))):
            errs.append(f"{key} must map x/y/z to positive integers")
    qs = m.get("quantities")
    if not (isinstance(qs, list) and qs
            and all(isinstance(q, dict) and q.get("name") and q.get("dtype")
                    for q in qs)):
        errs.append("quantities must be a non-empty list of {name, dtype}")
    fs = m.get("files")
    if not (isinstance(fs, list) and fs):
        errs.append("files must be a non-empty list")
    else:
        for i, fe in enumerate(fs):
            if not (isinstance(fe, dict) and fe.get("path")
                    and isinstance(fe.get("bytes"), int)
                    and isinstance(fe.get("sha256"), str)
                    and isinstance(fe.get("block"), list)
                    and isinstance(fe.get("origin"), list)
                    and isinstance(fe.get("size"), list)):
                errs.append(f"files[{i}] missing path/bytes/sha256/block/"
                            "origin/size")
    return errs


def validate_snapshot(snapshot_dir: str, deep: bool = True) -> List[str]:
    """Full integrity check of one snapshot directory.

    Returns the list of problems (empty = valid): manifest schema, every
    payload present with the recorded byte count (and SHA-256 when
    ``deep``), and the blocks exactly tiling the recorded global grid.
    """
    try:
        m = load_manifest(snapshot_dir)
    except (OSError, ValueError) as e:
        return [f"unreadable manifest: {e}"]
    errs = validate_manifest(m)
    if errs:
        return errs
    g = m["global"]
    cover = np.zeros((g["z"], g["y"], g["x"]), dtype=np.uint8)
    for fe in m["files"]:
        path = os.path.join(snapshot_dir, fe["path"])
        try:
            nbytes = os.path.getsize(path)
        except OSError:
            errs.append(f"missing payload {fe['path']}")
            continue
        if nbytes != fe["bytes"]:
            errs.append(
                f"payload {fe['path']} is {nbytes} bytes, manifest says "
                f"{fe['bytes']} (truncated?)"
            )
            continue
        if deep and _sha256(path) != fe["sha256"]:
            errs.append(f"payload {fe['path']} SHA-256 mismatch")
            continue
        o, s = fe["origin"], fe["size"]
        cover[o[2]:o[2] + s[2], o[1]:o[1] + s[1], o[0]:o[0] + s[0]] += 1
    if not errs:
        if cover.min() < 1:
            errs.append("blocks do not cover the global grid")
        if cover.max() > 1:
            errs.append("blocks overlap")
    return errs


def find_resume(
    ckpt_dir: str, deep: bool = True, accept=None
) -> Optional[Tuple[str, dict]]:
    """Locate the newest VALID snapshot — the auto-resume policy.

    Candidates are tried newest-step-first — NOT ``LATEST`` first: a
    crash between publishing a snapshot and moving the pointer leaves an
    intact step newer than ``LATEST``, and resuming from the pointer
    would silently discard it (``LATEST`` is the durability floor, not
    the ceiling). ``accept(manifest) -> list-of-problems`` (e.g.
    :func:`check_compatible` curried on the target domain) extends the
    fallback to snapshots that are intact but unusable HERE — a valid
    snapshot from a different domain shape must not shadow an older
    compatible one. Returns (snapshot_dir, manifest) or None when
    nothing usable exists.
    """
    if not os.path.isdir(ckpt_dir):
        return None
    candidates = list(reversed(list_snapshots(ckpt_dir)))
    latest = read_latest(ckpt_dir)
    if latest and latest not in candidates:
        log.warn(f"ckpt: {LATEST_NAME} names missing snapshot {latest}")
    for name in candidates:
        snap = os.path.join(ckpt_dir, name)
        errs = validate_snapshot(snap, deep=deep)
        if errs:
            log.warn(
                f"ckpt: skipping invalid snapshot {name}: {errs[0]}"
                + (f" (+{len(errs)-1} more)" if len(errs) > 1 else "")
            )
            continue
        manifest = load_manifest(snap)
        if accept is not None:
            errs = accept(manifest)
            if errs:
                log.warn(f"ckpt: skipping incompatible snapshot {name}: "
                         f"{errs[0]}")
                continue
        return snap, manifest
    return None


def quarantine_snapshot(ckpt_dir: str, name: str,
                        reason: str = "") -> Optional[str]:
    """Rename an invalid/poisoned snapshot aside (``quarantine-<name>-…``)
    so :func:`find_resume` stops re-validating — and re-warning about —
    it on every restart, while the bytes stay on disk as post-mortem
    evidence. If ``LATEST`` named the quarantined snapshot, the pointer
    is repointed at the newest remaining snapshot (or removed when none
    is left — ``LATEST`` must never dangle *because of us*).

    Returns the quarantine directory, or None when ``name`` does not
    exist under ``ckpt_dir``.
    """
    src = os.path.join(ckpt_dir, name)
    if not os.path.isdir(src):
        return None
    stamp = time.strftime("%Y%m%dT%H%M%S")
    dest = os.path.join(ckpt_dir, f"{QUARANTINE_PREFIX}{name}-{stamp}")
    n = 0
    while os.path.exists(dest):  # same-second double quarantine
        n += 1
        dest = os.path.join(
            ckpt_dir, f"{QUARANTINE_PREFIX}{name}-{stamp}-{n}")
    os.rename(src, dest)
    try:  # best-effort breadcrumb for the post-mortem reader
        with open(os.path.join(dest, "QUARANTINED.txt"), "w") as f:
            f.write(f"quarantined {time.strftime('%Y-%m-%dT%H:%M:%S')}: "
                    f"{reason or 'failed validation'}\n")
    except OSError:
        pass
    if read_latest(ckpt_dir) == name:
        remaining = list_snapshots(ckpt_dir)
        if remaining:
            _write_latest(ckpt_dir, remaining[-1])
        else:
            try:
                os.remove(os.path.join(ckpt_dir, LATEST_NAME))
            except OSError:
                pass
    log.warn(f"ckpt: quarantined snapshot {name} -> "
             f"{os.path.basename(dest)}"
             + (f" ({reason})" if reason else ""))
    telemetry.get().counter("ckpt.quarantined", value=1, phase="ckpt",
                            snapshot=name, reason=reason or None)
    return dest


def assemble_global(
    snapshot_dir: str, manifest: dict, name: str, dtype=None
) -> np.ndarray:
    """Reassemble one quantity's global interior [z,y,x] from the saved
    blocks (pure numpy)."""
    g = manifest["global"]
    want = {q["name"]: q["dtype"] for q in manifest["quantities"]}
    if name not in want:
        raise KeyError(
            f"quantity {name!r} not in snapshot (has {sorted(want)})"
        )
    out = np.empty((g["z"], g["y"], g["x"]),
                   dtype=dtype or np.dtype(want[name]))
    for fe in manifest["files"]:
        with np.load(os.path.join(snapshot_dir, fe["path"])) as z:
            block = z[name]
        o, s = fe["origin"], fe["size"]
        if block.shape != (s[2], s[1], s[0]):
            raise ValueError(
                f"payload {fe['path']}[{name}] shape {block.shape} != "
                f"manifest size {(s[2], s[1], s[0])}"
            )
        out[o[2]:o[2] + s[2], o[1]:o[1] + s[1], o[0]:o[0] + s[0]] = block
    return out


def check_compatible(manifest: dict, size, names, dtypes) -> List[str]:
    """Elasticity rules: what MUST match between snapshot and the target
    domain (everything else — partition, mesh, device count, radius,
    alignment — may differ). Returns the list of mismatches."""
    errs: List[str] = []
    g = manifest["global"]
    if (g["x"], g["y"], g["z"]) != (size.x, size.y, size.z):
        errs.append(
            f"global size mismatch: snapshot ({g['x']},{g['y']},{g['z']}) "
            f"vs domain ({size.x},{size.y},{size.z})"
        )
    have = {q["name"]: q["dtype"] for q in manifest["quantities"]}
    want = dict(zip(names, dtypes))
    if set(have) != set(want):
        errs.append(
            f"quantity set mismatch: snapshot {sorted(have)} vs domain "
            f"{sorted(want)}"
        )
    else:
        for n in sorted(want):
            if np.dtype(have[n]) != np.dtype(want[n]):
                errs.append(
                    f"dtype mismatch for {n!r}: snapshot {have[n]} vs "
                    f"domain {want[n]} (bit-exact restore requires equal "
                    "dtypes)"
                )
    return errs
