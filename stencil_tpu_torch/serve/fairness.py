"""Weighted fairness and elastic slot width: the capacity policies.

The port's counterpart of ``stencil_tpu.serve.fairness``. Two small, pure policy objects the scheduler consults at chunk and slot
boundaries — no devices, no state files, fully simulable in tests:

- :class:`FairnessPolicy` replaces the strict priority sort with
  STRIDE-style weighted shares plus deadline-aware aging. Every class
  carries a virtual "pass" that advances by ``1/weight`` per job served;
  the class with the lowest pass leads the next slot, so over a
  sustained backlog each class's served share converges to its weight
  fraction — doubling a weight can only raise that share (the monotone
  property). Aging handles urgency the
  shares cannot: a job's EFFECTIVE rank decays from its class rank
  toward 0 at ``1/aging_s`` per second (the queue's sort key), and a job
  that has waited longer than ``aging_s * (rank + 1)`` becomes URGENT —
  it overrides the stride choice outright, which is the hard bound on
  ``low`` wait under sustained ``high`` load. Sustained pressure thus
  degrades ``low`` p99 smoothly (shares), never to infinity (aging).
- :class:`WidthPolicy` owns the elastic slot width: a power-of-two
  ladder from ``slot_min`` to ``slot_max``. Quantized widths keep the
  CompileCache hot — every depth maps to one of O(log) ladder rungs, so
  a surge compiles each (bucket, width) program once and reuses it for
  every later slot at that rung. ``slot_min == slot_max`` is the
  fixed-width daemon, bit for bit.

A running lane is still never reordered — both policies only ever judge
QUEUED jobs; preemption (scheduler.py) is a separate, priced decision.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional, Sequence

from .intake import PRIORITIES, ServeJob

# served-share weights: high jobs earn 8x low's share under backlog
DEFAULT_WEIGHTS = {"high": 8.0, "normal": 4.0, "low": 1.0}

# class names in urgency order (index == priority rank)
CLASS_ORDER = tuple(sorted(PRIORITIES, key=PRIORITIES.__getitem__))


class FairnessPolicy:
    """Stride-scheduled weighted shares with deadline-aware aging.

    ``weights`` maps class name -> positive share weight (missing
    classes default to :data:`DEFAULT_WEIGHTS`); ``aging_s`` is the
    seconds of waiting that promote a job by one full priority class
    (0 disables aging); ``clock`` is injectable for deterministic
    tests."""

    def __init__(self, weights: Optional[Dict[str, float]] = None, *,
                 aging_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        w = dict(DEFAULT_WEIGHTS)
        for k, v in (weights or {}).items():
            if k not in PRIORITIES:
                raise ValueError(f"unknown priority class {k!r} "
                                 f"(known: {sorted(PRIORITIES)})")
            v = float(v)
            if not math.isfinite(v) or v <= 0:
                raise ValueError(f"weight for {k!r} must be positive "
                                 f"and finite, got {v!r}")
            w[k] = v
        self.weights = {c: float(w[c]) for c in CLASS_ORDER}
        self.aging_s = float(aging_s)
        self.clock = clock
        self._pass: Dict[str, float] = {c: 0.0 for c in CLASS_ORDER}
        self._backlogged: set = set()
        self.served: Dict[str, int] = {c: 0 for c in CLASS_ORDER}

    # -- per-job urgency -------------------------------------------------------
    @staticmethod
    def base_rank(job: ServeJob) -> int:
        return PRIORITIES.get(job.priority, PRIORITIES["normal"])

    def wait_s(self, job: ServeJob, now: Optional[float] = None) -> float:
        t = getattr(job, "admit_t", None)
        if t is None:
            return 0.0
        return max(0.0, (self.clock() if now is None else now) - t)

    def effective_rank(self, job: ServeJob,
                       now: Optional[float] = None) -> float:
        """Aged urgency: the class rank decayed toward 0 by waiting —
        one full class per ``aging_s`` seconds queued."""
        r = float(self.base_rank(job))
        if self.aging_s > 0:
            r = max(0.0, r - self.wait_s(job, now) / self.aging_s)
        return r

    def queue_key(self, job: ServeJob, now: Optional[float] = None):
        """The live queue's sort key under this policy: aged rank, then
        deadline (tightest first), then admission order."""
        d = (float(job.deadline_ms) if job.deadline_ms is not None
             else math.inf)
        return (self.effective_rank(job, now), d, job.seq)

    def urgent(self, job: ServeJob, now: Optional[float] = None) -> bool:
        """The hard starvation bound: true once the job has waited past
        ``aging_s * (rank + 1)`` — it then overrides the stride shares
        and leads the next slot unconditionally."""
        return (self.aging_s > 0
                and self.wait_s(job, now)
                > self.aging_s * (self.base_rank(job) + 1))

    # -- stride shares ---------------------------------------------------------
    def note_backlog(self, classes_present: Sequence[str]) -> None:
        """Classic stride re-entry: a class entering backlog advances to
        the minimum pass among the classes already backlogged, so an
        absent class cannot bank credit and then monopolize."""
        present = {c for c in classes_present if c in self._pass}
        newly = present - self._backlogged
        if newly:
            floor = min((self._pass[c] for c in present - newly),
                        default=0.0)
            for c in newly:
                self._pass[c] = max(self._pass[c], floor)
        self._backlogged = present

    def lead_class(self,
                   classes_present: Sequence[str]) -> Optional[str]:
        """The class entitled to the next slot: lowest pass wins, ties
        broken by urgency rank (high first)."""
        present = [c for c in CLASS_ORDER if c in classes_present]
        if not present:
            return None
        return min(present,
                   key=lambda c: (self._pass[c], PRIORITIES[c]))

    def charge(self, priority: str, n: int = 1) -> None:
        """Account ``n`` served jobs to a class: its pass advances by
        ``n/weight``. Negative ``n`` refunds (a parked job was charged
        at pack time but not actually served to completion)."""
        c = priority if priority in self._pass else "normal"
        self._pass[c] += n / self.weights[c]
        self.served[c] = self.served.get(c, 0) + n

    def snapshot(self) -> dict:
        """The policy's state for telemetry records and summaries."""
        return {"pass": {c: round(v, 6) for c, v in self._pass.items()},
                "served": dict(self.served),
                "weights": dict(self.weights),
                "aging_s": self.aging_s}


class WidthPolicy:
    """Elastic slot width over a power-of-two ladder.

    ``choose(depth)`` returns the smallest ladder width that covers the
    queue depth, clamped to ``slot_max`` — a deterministic, quantized
    map from demand to batch size, so the CompileCache holds one program
    per (bucket, rung) and a surge never compiles per-depth."""

    def __init__(self, slot_min: int, slot_max: int):
        slot_min, slot_max = int(slot_min), int(slot_max)
        if slot_min < 1 or slot_max < slot_min:
            raise ValueError(
                f"need 1 <= slot_min <= slot_max, got "
                f"[{slot_min}, {slot_max}]")
        self.slot_min = slot_min
        self.slot_max = slot_max
        widths: List[int] = []
        w = slot_min
        while w < slot_max:
            widths.append(w)
            w *= 2
        widths.append(slot_max)
        self.widths = tuple(widths)

    @property
    def fixed(self) -> bool:
        return self.slot_min == self.slot_max

    def choose(self, depth: int) -> int:
        for w in self.widths:
            if w >= depth:
                return w
        return self.slot_max
