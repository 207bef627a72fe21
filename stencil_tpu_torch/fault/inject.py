"""Deterministic, seeded fault injection: prove the recovery paths fire.

The port's counterpart of ``stencil_tpu.fault.inject``: the same spec
grammar, the same seeded placement and the same ``describe()`` records, so
one spec string schedules the same faults in either package. Every firing
emits a ``fault.injected`` telemetry record.

Activation: the apps' ``--inject SPEC`` flag, or the
``STENCIL_FAULT_INJECT`` env var (flag wins). Placement randomness is
seeded from ``STENCIL_FAULT_SEED`` (default 0).

Spec grammar: comma/semicolon-separated items of ``kind@step[:k=v...]``:

- ``nan@K`` / ``inf@K``: burst a small cube of NaN/Inf into one block's
  interior when the run crosses step K (options ``q=NAME``, ``cells=C``).
- ``halo@K``: NaN into the boundary slab of one block that the next
  exchange sends, a corrupted halo payload.
- ``ckpt-truncate@K``: truncate the newest snapshot's first payload (the
  recovery must fall back to the previous good snapshot).
- ``stall@K``: stop beating the heartbeat (its thread too) and sleep until
  a watchdog kills the run.
- ``crash@K[:rc=N]``: ``os._exit(rc)`` (default rc 7).
- ``slow@K[:seconds=S]``: one sleep of S seconds (default 1.0).

``repeat=N`` or ``repeat=always`` re-fires an injection each time the run
crosses its step again (after a rollback), and ``tenant=ID`` pins it to one
tenant of a campaign (``campaign/inject.py``; steps are tenant-relative
there). State kinds write into the state's tensors in place; a mesh
quantity (a list of per-position blocks) is written in the block of the
chosen position.
"""

from __future__ import annotations

import os
import random
import re
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..obs import telemetry
from ..utils import logging as log

ENV_SPEC = "STENCIL_FAULT_INJECT"
ENV_SEED = "STENCIL_FAULT_SEED"

STATE_KINDS = ("nan", "inf", "halo")
KINDS = STATE_KINDS + ("ckpt-truncate", "stall", "crash", "slow")

_ITEM_RE = re.compile(r"^([a-z0-9-]+)@(\d+)((?::[a-z_]+=[^:]+)*)$")


@dataclass
class Injection:
    """One scheduled fault."""

    kind: str
    step: int
    quantity: Optional[str] = None
    cells: int = 2        # burst cube side length
    rc: int = 7           # crash exit code
    seconds: float = 1.0  # slow-phase sleep
    repeat: int = 1       # firings allowed; -1 = every crossing
    tenant: Optional[str] = None  # campaign lane targeting (campaign/inject)
    fired: int = 0

    def due(self, prev_step: int, step: int) -> bool:
        if not (prev_step < self.step <= step):
            return False
        return self.repeat < 0 or self.fired < self.repeat

    def describe(self) -> dict:
        d = {"kind": self.kind, "step": self.step, "fired": self.fired}
        if self.quantity:
            d["quantity"] = self.quantity
        if self.repeat != 1:
            d["repeat"] = self.repeat
        if self.tenant:
            d["tenant"] = self.tenant
        return d


def parse_spec(spec: str) -> List[Injection]:
    """Parse an injection spec string (raises ValueError with the
    offending item on any grammar error — a mistyped injection must
    never silently run the campaign un-faulted)."""
    out: List[Injection] = []
    for raw in re.split(r"[;,]", spec or ""):
        item = raw.strip()
        if not item:
            continue
        m = _ITEM_RE.match(item)
        if not m:
            raise ValueError(
                f"bad fault spec {item!r} (want kind@step[:key=val...])")
        kind, step, opts = m.group(1), int(m.group(2)), m.group(3)
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} (have {KINDS})")
        if step < 1:
            # firing requires prev_step < step with prev_step >= 0, so a
            # step-0 injection can never fire — the campaign would run
            # un-faulted while claiming to be injected
            raise ValueError(
                f"fault step must be >= 1 in {item!r} (step 0 can never "
                "fire: injections land when the run crosses their step)")
        inj = Injection(kind=kind, step=step)
        for kv in filter(None, opts.split(":")):
            k, v = kv.split("=", 1)
            if k in ("q", "quantity"):
                inj.quantity = v
            elif k == "cells":
                inj.cells = int(v)
            elif k == "rc":
                inj.rc = int(v)
            elif k == "seconds":
                inj.seconds = float(v)
            elif k == "repeat":
                inj.repeat = -1 if v in ("always", "-1") else int(v)
            elif k == "tenant":
                # campaign lane targeting (stencil_tpu/campaign/inject.py):
                # pins the injection to one tenant's lane; the single-domain
                # FaultPlan ignores it (one domain IS the only tenant)
                inj.tenant = v
            else:
                raise ValueError(f"unknown fault option {k!r} in {item!r}")
        out.append(inj)
    return out


class FaultPlan:
    """The active injection schedule of one run.

    The loop engine (recover.run_guarded) calls :meth:`fire_due` at every
    chunk boundary with the step interval just executed; injections whose
    step lies inside fire exactly once (unless ``repeat``).
    """

    def __init__(self, injections: Sequence[Injection], seed: int = 0):
        self.injections = list(injections)
        self.seed = int(seed)

    @classmethod
    def from_spec(cls, spec: Optional[str] = None,
                  seed: Optional[int] = None) -> Optional["FaultPlan"]:
        """Build a plan from an explicit spec, falling back to the
        ``STENCIL_FAULT_INJECT`` env var; None when nothing is scheduled."""
        if spec is None:
            spec = os.environ.get(ENV_SPEC, "")
        injections = parse_spec(spec)
        if not injections:
            return None
        if seed is None:
            seed = int(os.environ.get(ENV_SEED, "0") or 0)
        return cls(injections, seed=seed)

    def steps(self) -> List[int]:
        """Every scheduled step — chunk plans break here so injections
        land at their exact step regardless of chunking."""
        return sorted({i.step for i in self.injections})

    def describe(self) -> List[dict]:
        return [i.describe() for i in self.injections]

    # -- firing ---------------------------------------------------------------
    def fire_due(self, state: Dict[str, "object"], prev_step: int,
                 step: int, spec=None, ckpt_dir: Optional[str] = None,
                 ckpt_flush=None):
        """Apply every injection scheduled in ``(prev_step, step]`` to
        ``state`` (a ``{name: stacked tensor or mesh blocks}`` dict);
        returns the (possibly corrupted) state. Non-state kinds act on the
        process / the checkpoint dir instead. State kinds write into the
        state's tensors in place. ``ckpt_flush`` drains an async checkpoint
        writer before disk-level injections, so "the newest snapshot" is
        deterministic, not a race with the writer thread."""
        for inj in self.injections:
            if not inj.due(prev_step, step):
                continue
            inj.fired += 1
            if inj.kind == "ckpt-truncate" and ckpt_flush is not None:
                ckpt_flush()
            state = self._apply(inj, state, spec, ckpt_dir)
        return state

    def _rng(self, inj: Injection) -> random.Random:
        # keyed on (seed, kind, step) ONLY — never the firing count: a
        # repeated injection (repeat=, or re-crossed after a rollback)
        # must corrupt the SAME cells every time, or "deterministic"
        # stops meaning anything (and a re-fire could land somewhere the
        # workload heals, e.g. jacobi's fixed-temperature sphere cells)
        return random.Random(repr((self.seed, inj.kind, inj.step)))

    def _record(self, inj: Injection, **extra) -> None:
        telemetry.get().meta(
            "fault.injected", fault_kind=inj.kind, step=int(inj.step),
            phase="fault", **extra)

    def _apply(self, inj: Injection, state, spec, ckpt_dir):
        if inj.kind in ("nan", "inf"):
            return self._corrupt_block(inj, state, spec)
        if inj.kind == "halo":
            return self._corrupt_halo(inj, state, spec)
        if inj.kind == "ckpt-truncate":
            target = truncate_newest_payload(ckpt_dir) if ckpt_dir else None
            self._record(inj, target=target)
            if target is None:
                log.warn(f"fault: ckpt-truncate@{inj.step} found no snapshot "
                         "to truncate")
            else:
                log.warn(f"fault: truncated checkpoint payload {target}")
            return state
        if inj.kind == "slow":
            self._record(inj, seconds=inj.seconds)
            log.warn(f"fault: slow@{inj.step} sleeping {inj.seconds:g}s")
            time.sleep(inj.seconds)
            return state
        if inj.kind == "stall":
            self._record(inj)
            log.warn(f"fault: stall@{inj.step}: sleeping until a watchdog "
                     "kills this run")
            # stop beating, the heartbeat thread included: a sleeping
            # interpreter still runs that thread, and a supervisor must see
            # the wedge this injection stands for
            telemetry.get().stop_heartbeat()
            # sleep in slices so an unsupervised run can be interrupted
            for _ in range(3600):
                time.sleep(1.0)
            return state
        if inj.kind == "crash":
            self._record(inj, rc=inj.rc)
            log.warn(f"fault: crash@{inj.step}: os._exit({inj.rc})")
            os._exit(inj.rc)
        raise AssertionError(f"unhandled fault kind {inj.kind}")

    # -- state corruption -----------------------------------------------------
    def _pick_quantity(self, inj: Injection, state, rng) -> str:
        names = sorted(state)
        if inj.quantity is not None:
            if inj.quantity in state:
                return inj.quantity
            log.warn(f"fault: quantity {inj.quantity!r} not in state "
                     f"{names}; picking deterministically")
        return rng.choice(names)

    def _corrupt_block(self, inj: Injection, state, spec):
        """NaN/Inf burst: a ``cells``-sided cube inside one block's
        compute interior (seed-deterministic block + offset), in place."""
        rng = self._rng(inj)
        name = self._pick_quantity(inj, state, rng)
        val = float("nan") if inj.kind == "nan" else float("inf")
        arr = state[name]
        if spec is None:
            # spec-less (unit-test) path: corrupt the first cells of the
            # flattened array
            n = max(1, min(inj.cells, arr.numel()))
            arr.view(-1)[0:n] = val
            self._record(inj, quantity=name, cells=n)
            return state
        d, off = spec.dim, spec.compute_offset()
        bi = (rng.randrange(d.x), rng.randrange(d.y), rng.randrange(d.z))
        sz = spec.block_size(bi)
        c = max(1, min(inj.cells, sz.x, sz.y, sz.z))
        x0 = off.x + rng.randrange(sz.x - c + 1)
        y0 = off.y + rng.randrange(sz.y - c + 1)
        z0 = off.z + rng.randrange(sz.z - c + 1)
        blk = _block(arr, bi, d)
        if blk is not None:  # None: another process's position, which poisons it
            blk[z0:z0 + c, y0:y0 + c, x0:x0 + c] = val
        self._record(inj, quantity=name, cells=c ** 3,
                     block=list(bi), origin=[x0, y0, z0])
        log.warn(f"fault: {inj.kind}@{inj.step} burst {c}^3 cells into "
                 f"{name!r} block {bi}")
        return state

    def _corrupt_halo(self, inj: Injection, state, spec):
        """Corrupted-halo-payload model: NaN into the interior boundary slab
        the next exchange sends, so the corruption propagates as a bad halo
        payload would."""
        rng = self._rng(inj)
        name = self._pick_quantity(inj, state, rng)
        if spec is None:
            return self._corrupt_block(inj, state, spec)
        r = 0
        for dx, dy, dz in ((0, 0, 1), (0, 1, 0), (1, 0, 0)):
            r = spec.radius.dir(dx, dy, dz)
            if r > 0:
                axis = (dx, dy, dz)
                break
        if r <= 0:
            log.warn("fault: halo injection on a radius-0 domain degrades "
                     "to an interior burst")
            return self._corrupt_block(inj, state, spec)
        d, off = spec.dim, spec.compute_offset()
        bi = (rng.randrange(d.x), rng.randrange(d.y), rng.randrange(d.z))
        sz = spec.block_size(bi)
        c = max(1, min(inj.cells, sz.x, sz.y, sz.z))
        # the high-side boundary slab along the chosen axis
        zsl = slice(off.z, off.z + c)
        ysl = slice(off.y, off.y + c)
        xsl = slice(off.x, off.x + c)
        if axis == (0, 0, 1):
            zsl = slice(off.z + sz.z - r, off.z + sz.z)
        elif axis == (0, 1, 0):
            ysl = slice(off.y + sz.y - r, off.y + sz.y)
        else:
            xsl = slice(off.x + sz.x - r, off.x + sz.x)
        blk = _block(state[name], bi, d)
        if blk is not None:
            blk[zsl, ysl, xsl] = float("nan")
        self._record(inj, quantity=name, block=list(bi),
                     axis=list(axis), radius=r)
        log.warn(f"fault: halo@{inj.step} corrupted the boundary slab of "
                 f"{name!r} block {bi} along axis {axis}")
        return state


def _block(arr, bi, dim):
    """Block ``bi`` (x, y, z) of a quantity as a ``(pz, py, px)`` view: of a
    stacked ``(bz, by, bx, pz, py, px)`` tensor, or of a mesh's list of
    ``(1, 1, 1, pz, py, px)`` blocks (flat position order, x fastest;
    None at another process's position: every rank draws the same block,
    and its owner writes it)."""
    if isinstance(arr, (list, tuple)):
        b = arr[bi[0] + dim.x * (bi[1] + dim.y * bi[2])]
        return None if b is None else b[0, 0, 0]
    return arr[bi[2], bi[1], bi[0]]


def truncate_newest_payload(ckpt_dir: str, nbytes: int = 16) -> Optional[str]:
    """Truncate the newest snapshot's first payload file (the
    ``ckpt-truncate`` injection body; also handy for tests). Returns the
    truncated path, or None when no snapshot exists."""
    from ..ckpt import list_snapshots, load_manifest

    snaps = list_snapshots(ckpt_dir)
    if not snaps:
        return None
    snap = os.path.join(ckpt_dir, snaps[-1])
    try:
        m = load_manifest(snap)
        path = os.path.join(snap, m["files"][0]["path"])
        with open(path, "r+b") as f:
            f.truncate(nbytes)
    except (OSError, ValueError, KeyError, IndexError) as e:
        log.warn(f"fault: could not truncate a payload under {snap}: {e}")
        return None
    return path
