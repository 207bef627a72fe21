"""Mid-run plan hot-swap: the consumer of ``replan.requested``.

The port's own copy of ``stencil_tpu.plan.replan``. The live sentinel
(``obs/live.py``) fires ``replan.requested`` through its ``on_replan`` hook;
a :class:`ReplanController` latches the request there (cheap, never
raising), and the guarded loop (``fault/recover.run_guarded``) finishes its
chunk, then asks the controller to swap:

1. ``retune_fn()`` re-runs the autotuner (``plan/autotune.autotune`` with
   ``force=True``) and returns the winning :class:`~.ir.PlanChoice`;
2. ``apply_fn(choice, state)`` installs it, typically through
   :meth:`DistributedDomain.replan` (gather, re-realize, re-scatter, one
   exchange), and returns the state to continue with (or None to keep the
   caller's);
3. the swap records ``replan.applied`` with the old and new labels and the
   static model's predicted gain, and resets the sentinel's windows;
4. any exception in retune or apply records ``replan.rejected`` and the run
   continues on the old plan.

A retune that returns the current choice is a rejected no-op, and a swap
budget (``max_swaps``) stops a plan from flapping. The campaign driver runs
the same controller between slots. The state across a swap is bit-identical:
the swap is the elastic checkpoint restore without the disk.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from ..utils import logging as log

REPLAN_APPLIED = "replan.applied"
REPLAN_REJECTED = "replan.rejected"


class ReplanController:
    """Latches ``replan.requested`` events and performs the plan swap
    between chunks.

    - ``retune_fn() -> PlanChoice`` re-runs the autotuner and returns
      the plan to install;
    - ``apply_fn(choice, state) -> state | None`` installs it (None
      keeps the caller's state object — the campaign's between-slot
      swap has no state to transform);
    - ``current_choice`` is what the run is executing now (a retune
      that returns it is a rejected no-op, not a swap);
    - ``sentinel`` (optional) gets ``reset()`` after an applied swap;
    - ``config``/``calibration``/``link_costs`` (optional) let the
      controller attach the static model's predicted gain
      (old modeled total / new modeled total) to ``replan.applied``;
    - ``max_swaps`` bounds the run's swap budget: a plan oscillation
      must converge, not flap — beyond the budget further requests are
      rejected loudly.
    """

    def __init__(
        self,
        retune_fn: Callable[[], object],
        apply_fn: Callable[[object, Optional[Dict]], Optional[Dict]],
        *,
        current_choice=None,
        sentinel=None,
        config=None,
        calibration: Optional[dict] = None,
        link_costs=None,
        max_swaps: int = 3,
        rec=None,
    ):
        self.retune_fn = retune_fn
        self.apply_fn = apply_fn
        self.current_choice = current_choice
        self.sentinel = sentinel
        self.config = config
        self.calibration = calibration
        self.link_costs = link_costs
        self.max_swaps = int(max_swaps)
        self._rec = rec
        self.swaps = 0
        self.rejected = 0
        self._pending: Optional[dict] = None

    def _recorder(self):
        if self._rec is not None:
            return self._rec
        from ..obs import telemetry

        return telemetry.get()

    # -- the sentinel hook ----------------------------------------------------
    def request(self, event: dict) -> None:
        """The ``LiveSentinel(on_replan=...)`` hook: latch the request.
        Cheap and non-throwing by contract — the swap itself runs later,
        between chunks, where a rebuild cannot tear a step."""
        self._pending = dict(event or {})

    @property
    def pending(self) -> bool:
        return self._pending is not None

    # -- the swap -------------------------------------------------------------
    def _modeled_gain(self, old, new) -> Optional[float]:
        if self.config is None or old is None or new is None:
            return None
        try:
            from .cost import score

            so = score(self.config, old, self.calibration,
                       link_costs=self.link_costs)
            sn = score(self.config, new, self.calibration,
                       link_costs=self.link_costs)
            if so is None or sn is None or sn.total_s <= 0:
                return None
            return so.total_s / sn.total_s
        except Exception:  # the gain is garnish, never a failure mode
            return None

    def maybe_swap(self, state: Optional[Dict], step: int) -> Optional[Dict]:
        """Perform the latched swap, if any. Returns the (possibly
        re-sharded) state to continue with, or None when the caller's
        state is unchanged — on a rejected swap the run ALWAYS continues
        on the old plan."""
        ev = self._pending
        if ev is None:
            return None
        self._pending = None
        rec = self._recorder()
        step = int(step)
        reason = str(ev.get("metric") or ev.get("reason") or "anomaly")
        old = self.current_choice
        old_label = old.label() if old is not None else "untuned"
        if self.swaps >= self.max_swaps:
            self.rejected += 1
            rec.meta(REPLAN_REJECTED, step=step, phase="plan",
                     reason=f"swap budget ({self.max_swaps}) exhausted",
                     old=old_label, trigger=reason)
            log.warn(f"replan: swap budget ({self.max_swaps}) exhausted; "
                     "continuing on the current plan")
            return None
        t0 = time.perf_counter()
        try:
            new = self.retune_fn()
            if new is None:
                raise ValueError("retune returned no choice")
            if old is not None and new == old:
                self.rejected += 1
                rec.meta(REPLAN_REJECTED, step=step, phase="plan",
                         reason="retune confirmed the current choice",
                         old=old_label, trigger=reason)
                log.info(f"replan: retune confirmed {old_label}; no swap")
                # the anomaly stands but the plan is already the best
                # known — reset the window so one excursion does not
                # re-request every subsequent chunk
                if self.sentinel is not None:
                    self.sentinel.reset()
                return None
            new_state = self.apply_fn(new, state)
        except Exception as e:  # noqa: BLE001 — degrade loudly, keep running
            self.rejected += 1
            rec.meta(REPLAN_REJECTED, step=step, phase="plan",
                     reason=f"{type(e).__name__}: {e}"[:400],
                     old=old_label, trigger=reason)
            log.warn(f"replan: swap failed ({type(e).__name__}: {e}); "
                     "continuing on the old plan")
            return None
        self.swaps += 1
        gain = self._modeled_gain(old, new)
        self.current_choice = new
        rec.meta(REPLAN_APPLIED, step=step, phase="plan",
                 old=old_label, new=new.label(), trigger=reason,
                 modeled_gain=gain,
                 swap_wall_s=time.perf_counter() - t0)
        log.warn(
            f"replan: APPLIED {old_label} -> {new.label()} at step {step}"
            + (f" (modeled gain {gain:.3g}x)" if gain else ""))
        if self.sentinel is not None:
            # the old window's band judged the OLD plan; restart from
            # warmup so the swap-compile spike and the new latency level
            # are learned, not condemned
            self.sentinel.reset()
        return new_state
