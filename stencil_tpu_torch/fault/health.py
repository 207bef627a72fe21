"""In-loop numerical health guard: one isfinite / max|u| reduction.

The port's counterpart of ``stencil_tpu.fault.health``: the detection layer
of the fault stack (``inject.py`` manufactures faults, ``recover.py`` rolls
them back). The guard never touches the step program: it is a separate
reduction over the state between chunks (the JAX package runs it as one
fused XLA program). On the card it is one launch of the hand-written
health-reduction kernel for every quantity of the state
(``ops/health_reduce``); on the CPU, torch passes. Its result comes to the
host in one copy per check. Each check is a ``health.check`` span, so its
cost is in the metrics file.

A state maps each quantity name to its tensor, or, on a mesh of block
positions, to the list of its blocks (one per position), which the check
reads as one quantity.

A failed check raises :class:`NumericalFault` naming the quantity, the step
and the kind (``nonfinite`` | ``divergence``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..obs import telemetry
from ..ops.health_reduce import health_reduce

#: NumericalFault kinds, in the order the checks run.
NONFINITE = "nonfinite"
DIVERGENCE = "divergence"


class NumericalFault(RuntimeError):
    """An in-band numerical fault: non-finite values or a blown ceiling.

    Carries the offending ``quantity`` name, the ``step`` the failed check
    observed, the fault ``kind``, and (when finite) the observed ``value``
    (max |u| of the quantity).
    """

    def __init__(self, kind: str, quantity: str, step: int,
                 value: Optional[float] = None):
        self.kind = kind
        self.quantity = quantity
        self.step = int(step)
        self.value = value
        what = ("non-finite values" if kind == NONFINITE
                else f"max|u| = {value:g} over the divergence ceiling")
        super().__init__(
            f"numerical fault [{kind}] in quantity {quantity!r} at step "
            f"{step}: {what}")


def finite_and_max(x: torch.Tensor, dims=None):
    """``(all finite, max |x|)`` of ``x`` over every element (``dims`` None)
    or per leading index (``dims`` not None), both float32 on ``x``'s
    device: the health-reduction kernel on CUDA, its plain version on the
    CPU. float32 is enough for the ceiling verdict: a float64 magnitude that
    overflows the cast reads as inf, which any ceiling calls divergence.
    Integer tensors are trivially healthy."""
    out = health_reduce([[x]], per_lane=dims is not None)
    return out[0, 0], out[1, 0]


def _groups(state):
    """The check's tensor groups of a state, one per quantity (sorted by
    name): a tensor, or a mesh quantity's blocks."""
    return [list(v) if isinstance(v, (list, tuple)) else [v]
            for v in (state[n] for n in sorted(state))]


class HealthGuard:
    """Periodic health check over a ``{name: tensor}`` state.

    ``every`` is the check cadence in steps (the loop engine calls
    :meth:`due` at chunk boundaries); ``max_abs`` adds the optional
    divergence ceiling on top of the isfinite sweep.
    """

    def __init__(self, every: int = 1, max_abs: Optional[float] = None):
        self.every = max(1, int(every))
        self.max_abs = float(max_abs) if max_abs else None
        self.checks = 0

    @staticmethod
    def _reduce(state) -> torch.Tensor:
        """``(2, Q)`` float32: per quantity (sorted by name) all-finite
        (1.0 / 0.0) and max |u|, in one launch on the card."""
        return health_reduce(_groups(state))

    def due(self, prev_step: int, step: int) -> bool:
        """True when a check boundary (a multiple of ``every``) lies in
        ``(prev_step, step]``."""
        return step // self.every > prev_step // self.every

    def check(self, state: Dict[str, torch.Tensor], step: int) -> None:
        """Run the reduction; raise :class:`NumericalFault` on the first
        unhealthy quantity (a ``health.fault`` record lands first)."""
        if not state:
            return
        rec = telemetry.get()
        self.checks += 1
        with rec.span("health.check", phase="health", step=int(step),
                      quantities=len(state)):
            finite, amax = self._reduce(state).cpu().numpy()
        for i, name in enumerate(sorted(state)):
            kind = None
            if not finite[i]:
                kind = NONFINITE
            elif self.max_abs is not None and float(amax[i]) > self.max_abs:
                kind = DIVERGENCE
            if kind is None:
                continue
            value = float(amax[i])
            value = value if math.isfinite(value) else None
            rec.meta("health.fault", fault_kind=kind, quantity=name,
                     step=int(step), value=value, ceiling=self.max_abs)
            raise NumericalFault(kind, name, step, value=value)
