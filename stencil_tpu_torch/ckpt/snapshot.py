"""Sharded, crash-safe snapshots of grid state: the write side.

The port's own copy of ``stencil_tpu.ckpt.snapshot`` (``restore.py`` is the
read side). The on-disk format is the JAX package's, byte for byte in its
arrays and manifest, so a snapshot written by either package restores in
the other. What one snapshot ``<ckpt_dir>/step-<k>/`` contains:

- ``block_z_y_x.npz`` per partition block: one array per quantity holding
  that block's compute interior (no halos, no alignment pad: halos are
  rebuilt after restore, and the halo contents of the two packages' paths
  may differ without changing a snapshot);
- ``manifest.json``: schema version, step, global/partition geometry,
  radius, quantity names + dtypes, and per-file byte counts + SHA-256.

Crash-safety (the SCR/Orbax rename protocol): payloads and manifest are
written into ``<ckpt_dir>/.tmp-...`` and fsync'd; the tmp dir is renamed to
``step-<k>`` and the parent fsync'd; only then is ``LATEST`` replaced (tmp +
rename), so it never names a partial snapshot; retention prunes the oldest
snapshots beyond ``keep``, never the one ``LATEST`` names.

Not carried over yet (ROADMAP.md queue A item 6): the asynchronous
double-buffered writer (``AsyncCheckpointer``); the port writes
synchronously, from host copies the caller makes.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Dict, List, Optional

import numpy as np

from ..obs import telemetry
from ..utils import logging as log

MANIFEST_VERSION = 1
MANIFEST_NAME = "manifest.json"
LATEST_NAME = "LATEST"
PAYLOAD_FORMAT = "npz-v1"
_TMP_PREFIX = ".tmp-"


def snapshot_name(step: int) -> str:
    return f"step-{step:08d}"


def step_of(name: str) -> Optional[int]:
    """Parse a snapshot dir name back to its step (None if not one)."""
    base = os.path.basename(os.path.normpath(name))
    if not base.startswith("step-"):
        return None
    try:
        return int(base[len("step-"):], 10)
    except ValueError:
        return None


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # e.g. a platform without O_RDONLY dirs; rename is still atomic
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _radius_dirs(radius) -> List[List[int]]:
    """Serialize a Radius as [[dx,dy,dz,r], ...] (saver-side record only —
    restore uses the *target* domain's radius)."""
    return [[d[0], d[1], d[2], r] for d, r in sorted(radius._r.items())]


def write_snapshot(
    ckpt_dir: str,
    step: int,
    spec,
    host_state: Dict[str, np.ndarray],
    dtypes: Optional[Dict[str, str]] = None,
    keep: int = 3,
    extra_meta: Optional[dict] = None,
) -> str:
    """Write one durable snapshot; returns the final snapshot directory.

    ``host_state`` maps quantity name -> host (numpy) copy of the stacked
    array (``(bz,by,bx,pz,py,px)``). ``dtypes`` pins the manifest dtype per
    quantity (defaults to each array's dtype).
    """
    rec = telemetry.get()
    t0 = time.perf_counter()
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, snapshot_name(step))
    tmp = os.path.join(ckpt_dir, f"{_TMP_PREFIX}{snapshot_name(step)}-{os.getpid()}")
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    off = spec.compute_offset()
    names = sorted(host_state)
    files = []
    total_bytes = 0
    for iz in range(spec.dim.z):
        for iy in range(spec.dim.y):
            for ix in range(spec.dim.x):
                o = spec.block_origin((ix, iy, iz))
                s = spec.block_size((ix, iy, iz))
                payload = {}
                for name in names:
                    arr = host_state[name]
                    payload[name] = np.ascontiguousarray(
                        arr[
                            iz, iy, ix,
                            off.z : off.z + s.z,
                            off.y : off.y + s.y,
                            off.x : off.x + s.x,
                        ]
                    )
                fname = f"block_{iz}_{iy}_{ix}.npz"
                fpath = os.path.join(tmp, fname)
                with open(fpath, "wb") as f:
                    np.savez(f, **payload)
                    f.flush()
                    os.fsync(f.fileno())
                nbytes = os.path.getsize(fpath)
                total_bytes += nbytes
                files.append(
                    {
                        "path": fname,
                        "bytes": nbytes,
                        "sha256": _sha256(fpath),
                        "block": [ix, iy, iz],
                        "origin": [o.x, o.y, o.z],
                        "size": [s.x, s.y, s.z],
                    }
                )

    g, d = spec.global_size, spec.dim
    manifest = {
        "v": MANIFEST_VERSION,
        "kind": "stencil-ckpt",
        "payload": PAYLOAD_FORMAT,
        "step": int(step),
        "written_t": time.time(),
        "global": {"x": g.x, "y": g.y, "z": g.z},
        "partition": {"x": d.x, "y": d.y, "z": d.z},
        "radius": _radius_dirs(spec.radius),
        "quantities": [
            {
                "name": name,
                "dtype": str((dtypes or {}).get(name, host_state[name].dtype)),
            }
            for name in names
        ],
        "files": files,
    }
    if extra_meta:
        manifest["meta"] = extra_meta
    mpath = os.path.join(tmp, MANIFEST_NAME)
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())

    # atomic publish: rename the complete dir into place, then the pointer.
    # An existing snapshot of the same step is MOVED aside first (rename,
    # not rmtree): deleting it before the replacement lands would reopen
    # the exact crash window the rename protocol closes — a kill between
    # the two renames leaves the old state on disk (as an ignored .tmp-
    # dir) instead of losing the newest durable step outright.
    displaced = None
    if os.path.isdir(final):
        displaced = os.path.join(
            ckpt_dir, f"{_TMP_PREFIX}{snapshot_name(step)}-old-{os.getpid()}"
        )
        if os.path.isdir(displaced):
            shutil.rmtree(displaced)
        os.rename(final, displaced)
    os.rename(tmp, final)
    _fsync_dir(ckpt_dir)
    if displaced is not None:
        shutil.rmtree(displaced, ignore_errors=True)
    _write_latest(ckpt_dir, snapshot_name(step))
    prune(ckpt_dir, keep=keep)

    rec.emit("span", "ckpt.write", phase="ckpt",
             seconds=time.perf_counter() - t0, step=int(step))
    rec.counter("ckpt.bytes_written", bytes=total_bytes, phase="ckpt",
                step=int(step))
    rec.counter("ckpt.files_written", value=len(files), phase="ckpt",
                step=int(step))
    log.debug(f"checkpoint step {step}: {len(files)} files, "
              f"{total_bytes} bytes -> {final}")
    return final


def _write_latest(ckpt_dir: str, name: str) -> None:
    tmp = os.path.join(ckpt_dir, f"{_TMP_PREFIX}LATEST-{os.getpid()}")
    with open(tmp, "w") as f:
        f.write(name + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(ckpt_dir, LATEST_NAME))
    _fsync_dir(ckpt_dir)


def read_latest(ckpt_dir: str) -> Optional[str]:
    """The snapshot name ``LATEST`` points at (None when absent/empty)."""
    try:
        with open(os.path.join(ckpt_dir, LATEST_NAME)) as f:
            name = f.read().strip()
    except OSError:
        return None
    return name or None


def list_snapshots(ckpt_dir: str) -> List[str]:
    """Snapshot dir names under ``ckpt_dir``, oldest step first. Tmp dirs
    (in-flight or crashed writes) are never listed."""
    try:
        entries = os.listdir(ckpt_dir)
    except OSError:
        return []
    out = [
        e for e in entries
        if step_of(e) is not None and os.path.isdir(os.path.join(ckpt_dir, e))
    ]
    return sorted(out, key=step_of)


def prune(ckpt_dir: str, keep: int) -> List[str]:
    """Delete the oldest snapshots beyond ``keep`` (``keep <= 0`` keeps
    everything); never the one LATEST names. Stale ``.tmp-`` leftovers
    from crashed writers (dirs AND files — the LATEST tmp is a file) are
    garbage-collected either way. Returns the removed snapshot names."""
    removed: List[str] = []
    if keep > 0:
        snaps = list_snapshots(ckpt_dir)
        latest = read_latest(ckpt_dir)
        excess = len(snaps) - keep
        for name in snaps:
            if excess <= 0:
                break
            if name == latest:
                continue
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
            removed.append(name)
            excess -= 1
    for e in os.listdir(ckpt_dir) if os.path.isdir(ckpt_dir) else []:
        if e.startswith(_TMP_PREFIX):
            p = os.path.join(ckpt_dir, e)
            try:
                age = time.time() - os.stat(p).st_mtime
            except OSError:
                continue
            if age > 3600:  # only stale ones: a live writer owns recent tmps
                if os.path.isdir(p):
                    shutil.rmtree(p, ignore_errors=True)
                else:
                    try:
                        os.remove(p)
                    except OSError:
                        pass
    return removed
