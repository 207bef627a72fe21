"""Deterministic fault injection scoped to one tenant lane.

The port's counterpart of ``stencil_tpu.campaign.inject``: the seeded
registry of ``fault/inject.py`` adapted to a batch slot. The spec grammar is
unchanged plus ``tenant=ID``, which pins an injection to one tenant's lane
(``nan@3:tenant=t2:repeat=always`` is the campaign eviction test's whole
script). Steps are TENANT-relative, so an injection follows its tenant
wherever the packer placed it and whenever it entered the slot.

Only the state kinds make sense per lane: ``nan``/``inf`` burst a
``cells``-sided cube into the target tenant's compute interior (placement
seeded on (seed, kind, step, tenant) only, so a re-fire after a rollback
corrupts the same cells, and the same cells as the JAX package's), written
into the live slot tensor in place; ``slow`` sleeps. Process-wide kinds are
rejected at construction.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..fault.inject import FaultPlan, Injection
from ..obs import telemetry
from ..utils import logging as log

SLOT_KINDS = ("nan", "inf", "slow")


class SlotInjector:
    """The active per-lane injection schedule of one batch slot.

    Duck-type compatible with ``fault.inject.FaultPlan`` where
    ``fault/recover.run_guarded`` touches it (``steps()``,
    ``fire_due(state, prev, step, spec=, ckpt_dir=)``).
    ``lanes_fn()`` returns the driver's live lane table (objects with
    ``idx``, ``tenant`` (``.tid``) and the slot/tenant step anchors), so
    backfills and evictions retarget injections without rewiring.
    """

    def __init__(self, plan: FaultPlan, spec, lanes_fn: Callable[[], Sequence],
                 known_tenants: Optional[Sequence[str]] = None):
        bad = [i.kind for i in plan.injections if i.kind not in SLOT_KINDS]
        if bad:
            raise ValueError(
                f"campaign injection supports kinds {SLOT_KINDS}, got "
                f"{sorted(set(bad))} (process-wide kinds cannot be scoped "
                "to one tenant lane)")
        if known_tenants is not None:
            missing = [i.tenant for i in plan.injections
                       if i.tenant and i.tenant not in known_tenants]
            if missing:
                raise ValueError(
                    f"campaign injection targets unknown tenant(s) "
                    f"{sorted(set(missing))}")
        self.plan = plan
        self.spec = spec
        self._lanes_fn = lanes_fn

    @property
    def seed(self) -> int:
        return self.plan.seed

    def describe(self) -> List[dict]:
        return self.plan.describe()

    # -- lane resolution ------------------------------------------------------
    def _lane_for(self, inj: Injection):
        lanes = [l for l in self._lanes_fn() if l.tenant is not None]
        if not lanes:
            return None
        if inj.tenant is not None:
            for l in lanes:
                if l.tenant.tid == inj.tenant:
                    return l
            return None  # target not resident (evicted / not packed yet)
        # untargeted: deterministic seeded choice among resident tenants
        rng = random.Random(repr((self.seed, inj.kind, inj.step)))
        tid = rng.choice(sorted(l.tenant.tid for l in lanes))
        return next(l for l in lanes if l.tenant.tid == tid)

    def _slot_step(self, inj: Injection, lane) -> int:
        return lane.start_slot_step + (inj.step - lane.start_tenant_step)

    def steps(self) -> List[int]:
        """Slot-step breakpoints for ``chunk_plan`` — injections must land
        at their exact tenant step regardless of chunking. Exhausted
        injections and unresolvable targets are excluded (a re-entered
        segment must not warn about steps that already fired)."""
        out = set()
        for inj in self.plan.injections:
            if inj.repeat >= 0 and inj.fired >= inj.repeat:
                continue
            lane = self._lane_for(inj)
            if lane is None:
                continue
            out.add(self._slot_step(inj, lane))
        return sorted(out)

    # -- firing ---------------------------------------------------------------
    def fire_due(self, state: Dict[str, "object"], prev_step: int,
                 step: int, spec=None, ckpt_dir=None, ckpt_flush=None):
        for inj in self.plan.injections:
            if inj.repeat >= 0 and inj.fired >= inj.repeat:
                continue
            lane = self._lane_for(inj)
            if lane is None:
                continue
            due_at = self._slot_step(inj, lane)
            if not (prev_step < due_at <= step):
                continue
            inj.fired += 1
            state = self._apply(inj, state, lane)
        return state

    def _apply(self, inj: Injection, state, lane):
        rec = telemetry.get()
        if inj.kind == "slow":
            rec.meta("fault.injected", fault_kind=inj.kind,
                     step=int(inj.step), phase="fault",
                     tenant=lane.tenant.tid, lane=lane.idx,
                     seconds=inj.seconds)
            log.warn(f"fault: slow@{inj.step} (tenant {lane.tenant.tid}) "
                     f"sleeping {inj.seconds:g}s")
            time.sleep(inj.seconds)
            return state
        # nan/inf: a cells^3 burst inside the tenant's compute interior,
        # written into the live slot tensor in place —
        # placement keyed on (seed, kind, step, tenant) only, so a re-fire
        # after rollback corrupts the SAME cells (fault/inject.py rule)
        rng = random.Random(
            repr((self.seed, inj.kind, inj.step, lane.tenant.tid)))
        names = sorted(state)
        name = inj.quantity if inj.quantity in state else rng.choice(names)
        val = float("nan") if inj.kind == "nan" else float("inf")
        b, off = self.spec.base, self.spec.compute_offset()
        c = max(1, min(inj.cells, b.x, b.y, b.z))
        x0 = off.x + rng.randrange(b.x - c + 1)
        y0 = off.y + rng.randrange(b.y - c + 1)
        z0 = off.z + rng.randrange(b.z - c + 1)
        state[name][lane.idx, z0:z0 + c, y0:y0 + c, x0:x0 + c] = val
        rec.meta("fault.injected", fault_kind=inj.kind, step=int(inj.step),
                 phase="fault", quantity=name, cells=c ** 3,
                 tenant=lane.tenant.tid, lane=lane.idx,
                 origin=[x0, y0, z0])
        log.warn(f"fault: {inj.kind}@{inj.step} burst {c}^3 cells into "
                 f"{name!r} of tenant {lane.tenant.tid} (lane {lane.idx})")
        return state
