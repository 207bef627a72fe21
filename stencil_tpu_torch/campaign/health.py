"""Per-lane numerical health for batched tenant slots.

The port's counterpart of ``stencil_tpu.campaign.health``. The
single-domain :class:`~stencil_tpu_torch.fault.health.HealthGuard` reduces
every quantity to one (all-finite, max|u|) pair; in a slot one tenant's NaN
must never condemn its B-1 siblings, so :class:`SlotHealthGuard` reduces
per lane: each quantity of ``{name: (B, ...)}`` yields ``(B,)`` finite flags
and ``(B,)`` max magnitudes, one launch of the health-reduction kernel on
the card (``ops/health_reduce``, one slot a lane) whose ``(2, Q, B)``
result reaches the host in one copy. A failed check raises
:class:`TenantFault` naming the tenant, its lane and its tenant-relative
step: what the campaign driver's eviction dispatches on.

Dead lanes (padding when the queue drained, or a just-evicted position) are
skipped: their zeros are trivially healthy, and nothing is ever attributed
to them.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..fault.health import DIVERGENCE, NONFINITE, HealthGuard, NumericalFault
from ..obs import telemetry
from ..ops.health_reduce import health_reduce


class TenantFault(NumericalFault):
    """A :class:`NumericalFault` attributed to one tenant lane.

    ``step`` (the base class field) is the SLOT step the failed check
    observed, which ``fault.recover.run_guarded`` keys its rollback budget
    on; ``tenant_step`` is the tenant-relative step (lanes backfilled
    mid-slot run offset from the slot clock)."""

    def __init__(self, kind: str, quantity: str, step: int, *, lane: int,
                 tenant: str, tenant_step: int,
                 value: Optional[float] = None):
        super().__init__(kind, quantity, step, value=value)
        self.lane = int(lane)
        self.tenant = str(tenant)
        self.tenant_step = int(tenant_step)


class SlotHealthGuard(HealthGuard):
    """Per-lane health check over ``{name: (B, ...)}`` slot state.

    ``bind(active_fn, tenant_step_fn)`` installs the driver's live lane view:
    ``active_fn(lane) -> tenant id | None`` and ``tenant_step_fn(lane,
    slot_step) -> tenant step``; the callables read the driver's mutable
    lane table, so nothing is re-bound on backfill."""

    def __init__(self, every: int = 1, max_abs: Optional[float] = None):
        super().__init__(every=every, max_abs=max_abs)
        self._active_fn: Callable[[int], Optional[str]] = lambda lane: None
        self._tstep_fn: Callable[[int, int], int] = lambda lane, step: step

    def bind(self, active_fn, tenant_step_fn) -> None:
        self._active_fn = active_fn
        self._tstep_fn = tenant_step_fn

    @staticmethod
    def _reduce(state) -> torch.Tensor:
        """``(2, Q, B)`` float32: per quantity (sorted by name) and lane,
        all-finite (1.0 / 0.0) and max |u|."""
        return health_reduce([[state[n]] for n in sorted(state)], per_lane=True)

    def check(self, state, step: int) -> None:
        """Run the per-lane reduction; raise :class:`TenantFault` for the
        first unhealthy ACTIVE lane (lowest lane index: the deterministic
        order eviction evidence relies on)."""
        if not state:
            return
        rec = telemetry.get()
        self.checks += 1
        with rec.span("health.check", phase="health", step=int(step),
                      quantities=len(state)):
            finite, amax = self._reduce(state).cpu().numpy()
        names = sorted(state)
        for b in range(finite.shape[1]):
            tid = self._active_fn(b)
            if tid is None:
                continue  # dead/padding lane: nothing to attribute
            for i, name in enumerate(names):
                kind = None
                if not finite[i, b]:
                    kind = NONFINITE
                elif (self.max_abs is not None
                      and float(amax[i, b]) > self.max_abs):
                    kind = DIVERGENCE
                if kind is None:
                    continue
                value = float(amax[i, b])
                value = value if math.isfinite(value) else None
                tstep = int(self._tstep_fn(b, int(step)))
                rec.meta("health.fault", fault_kind=kind, quantity=name,
                         step=int(step), value=value, ceiling=self.max_abs,
                         tenant=tid, lane=b, tenant_step=tstep)
                raise TenantFault(kind, name, int(step), lane=b, tenant=tid,
                                  tenant_step=tstep, value=value)
