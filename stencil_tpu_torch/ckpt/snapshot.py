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

:class:`AsyncCheckpointer` writes in the background: the device-to-host
copy (:func:`host_snapshot`) happens on the caller's thread, so the state
may change right after; hashing, serializing and fsync happen on a writer
thread, one write in flight at a time.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
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


def host_snapshot(spec, arrays: Dict[str, "object"]) -> Dict[str, np.ndarray]:
    """The device-to-host side of a save: each quantity as a host copy of
    its stacked ``(bz, by, bx, pz, py, px)`` array. A quantity is a stacked
    tensor, or a mesh's list of ``(1, 1, 1, pz, py, px)`` blocks in flat
    position order (x fastest). After it returns the caller may overwrite
    the device buffers."""
    out = {}
    for name, a in arrays.items():
        if isinstance(a, (list, tuple)):
            out[name] = np.stack([b.detach().cpu().numpy().reshape(b.shape[-3:])
                                  for b in a]).reshape(spec.stacked_shape_zyx())
        else:
            # a copy even of a CPU tensor, which .cpu() would hand back as is
            out[name] = a.detach().to("cpu", copy=True).numpy()
    return out


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


class AsyncCheckpointer:
    """Double-buffered asynchronous snapshot writer.

    ``save(spec, arrays, step)`` copies the device state to the host on the
    caller's thread (after that the step loop may overwrite the buffers) and
    hands it to a writer thread. At most one write is in flight; a save
    issued while one is pending blocks until the previous write is durable.
    ``flush()`` waits for the in-flight write; ``close()`` flushes and stops
    the thread.

    A failed write is logged and re-raised from the *next*
    ``save``/``flush``/``close``: checkpointing never tears down the step
    loop mid-flight, and a persistent failure does not stay silent.
    """

    def __init__(self, ckpt_dir: str, keep: int = 3,
                 dtypes: Optional[Dict[str, str]] = None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.dtypes = dict(dtypes or {})
        self._pending: Optional[tuple] = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)
        self._stop = False
        self.last_step: Optional[int] = None
        self._thread = threading.Thread(
            target=self._run, name="stencil-ckpt-writer", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            with self._lock:
                while self._pending is None and not self._stop:
                    self._work.wait()
                if self._pending is None and self._stop:
                    return
                spec, host_state, step, extra_meta = self._pending
            try:
                write_snapshot(self.ckpt_dir, step, spec, host_state,
                               dtypes=self.dtypes, keep=self.keep,
                               extra_meta=extra_meta)
                err = None
            except BaseException as e:  # surfaced on the next save/flush
                err = e
            with self._lock:
                if err is None:
                    self.last_step = step
                else:
                    self._error = err
                    log.warn(f"async checkpoint write failed: {err}")
                self._pending = None
                self._idle.notify_all()

    def _raise_pending_error(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, spec, arrays: Dict[str, "object"], step: int,
             extra_meta: Optional[dict] = None) -> None:
        """Snapshot ``arrays`` (name -> stacked tensor or mesh blocks) at
        ``step``; ``extra_meta`` lands under the manifest's ``meta`` key."""
        with telemetry.get().span("ckpt.save", phase="ckpt", step=int(step)):
            host_state = host_snapshot(spec, arrays)
            with self._lock:
                while self._pending is not None:
                    self._idle.wait()
                self._raise_pending_error()
                self._pending = (spec, host_state, step, extra_meta)
                self._work.notify()

    def flush(self) -> None:
        """Block until the in-flight write (if any) is durable."""
        with self._lock:
            while self._pending is not None:
                self._idle.wait()
            self._raise_pending_error()

    def close(self) -> None:
        """Flush, stop the writer thread, and raise a pending write error."""
        with self._lock:
            while self._pending is not None:
                self._idle.wait()
            self._stop = True
            self._work.notify()
        self._thread.join(timeout=60)
        with self._lock:
            self._raise_pending_error()
