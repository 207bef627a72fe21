"""Rollback-with-backoff recovery: the guarded step loop.

The port's counterpart of ``stencil_tpu.fault.recover``: ``health.py``
detects, ``inject.py`` manufactures, this module recovers.
:func:`run_guarded` drives a fused-chunk step loop and, on a
:class:`~.health.NumericalFault`,

1. records the fault (``recover.fault``),
2. restores the newest valid state through the caller's restore hook,
3. health-checks the restored state too; a poisoned one is quarantined
   through the caller's hook and the next candidate is tried,
4. backs off exponentially on repeated faults at the same step, and
5. after ``max_rollbacks`` at one step (or with nothing to roll back to)
   writes a JSON evidence bundle, records ``recover.aborted`` and raises
   :class:`RecoveryExhausted`: the apps exit with :data:`FAULT_RC`.

Ordering per chunk: **step -> inject -> health check -> checkpoint**, so a
poisoned state is never persisted.

The port's kernels update their buffers in place, where JAX arrays are
immutable: a restore hook must hand back state that the next chunks may
overwrite, and keep its own copy (the campaign driver clones its stash on
the device).

Beside recovery the loop carries the live layer, as in the JAX package: a
sentinel (``obs/live.LiveSentinel``) judges each chunk's per-step latency,
a status writer (``obs/status.StatusWriter``) rewrites its snapshot every
chunk, and a hot-swap controller (``plan/replan.ReplanController``) swaps
the exchange plan between chunks when a request is latched.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..obs import FAULT_RC, telemetry
from ..utils import logging as log
from .health import HealthGuard, NumericalFault
from .inject import FaultPlan

EVIDENCE_NAME = "fault-evidence.json"
EVIDENCE_ENV = "STENCIL_FAULT_EVIDENCE"


class RecoveryExhausted(RuntimeError):
    """Recovery gave up: no checkpoint to roll back to, or the same step
    faulted more than ``max_rollbacks`` times. Apps exit
    :data:`FAULT_RC` on this."""

    def __init__(self, fault: NumericalFault, rollbacks: int,
                 evidence_path: Optional[str], reason: str):
        self.fault = fault
        self.rollbacks = rollbacks
        self.evidence_path = evidence_path
        self.reason = reason
        super().__init__(
            f"recovery exhausted after {rollbacks} rollback(s): {reason} "
            f"(last fault: {fault}; evidence: {evidence_path or 'unwritten'})"
        )


@dataclass
class RecoveryPolicy:
    """Rollback budget + backoff shape."""

    max_rollbacks: int = 3      # per fault step
    backoff_s: float = 0.25     # first-retry sleep; doubles per repeat
    backoff_max_s: float = 30.0

    def backoff(self, attempt: int) -> float:
        return min(self.backoff_max_s, self.backoff_s * (2 ** (attempt - 1)))


def chunk_plan(start: int, iters: int, chunk: int,
               every: Sequence[int] = (), at: Sequence[int] = ()) -> List[int]:
    """Fused-chunk schedule from ``start`` to ``iters``: chunks of at most
    ``chunk`` steps, additionally broken at every multiple of each nonzero
    cadence in ``every`` (checkpoint / health boundaries) and at each
    absolute step in ``at`` (injection steps — a fault must land at its
    exact step regardless of chunking)."""
    bounds = sorted(b for b in set(at) if start < b < iters)
    plan: List[int] = []
    d = start
    while d < iters:
        k = min(chunk, iters - d)
        for e in every:
            if e and e > 0:
                k = min(k, e - d % e)
        for b in bounds:
            if b > d:
                k = min(k, b - d)
                break
        plan.append(k)
        d += k
    return plan


def _crossed(prev: int, step: int, every: int) -> bool:
    return every > 0 and step // every > prev // every


def write_evidence(payload: dict, evidence_dir: Optional[str]) -> Optional[str]:
    """Persist the abort evidence bundle (best-effort: evidence must never
    mask the abort itself). ``STENCIL_FAULT_EVIDENCE`` overrides the full
    path; the default is ``<evidence_dir>/fault-evidence.json``."""
    path = os.environ.get(EVIDENCE_ENV) or os.path.join(
        evidence_dir or ".", EVIDENCE_NAME)
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, default=str)
        os.replace(tmp, path)
    except OSError as e:
        log.warn(f"fault: could not write the evidence bundle {path}: {e}")
        return None
    return path


def run_guarded(
    state: Dict[str, "object"],
    *,
    start: int,
    iters: int,
    plan_fn: Callable[[int], Sequence[int]],
    step_fn: Callable[[Dict, int], Dict],
    guard: Optional[HealthGuard] = None,
    injector: Optional[FaultPlan] = None,
    policy: Optional[RecoveryPolicy] = None,
    save_fn: Optional[Callable[[int, Dict], None]] = None,
    ckpt_every: int = 0,
    restore_fn: Optional[Callable[[], Optional[Tuple[int, Dict]]]] = None,
    quarantine_fn: Optional[Callable[[int], None]] = None,
    flush_fn: Optional[Callable[[], None]] = None,
    on_chunk: Optional[Callable[[Dict, int, float, int], Optional[Dict]]] = None,
    spec=None,
    ckpt_dir: Optional[str] = None,
    evidence_dir: Optional[str] = None,
    app: Optional[str] = None,
    sentinel=None,
    sentinel_key: str = "step.latency_s",
    status=None,
    replan=None,
    clock: Callable[[], float] = time.perf_counter,
) -> Tuple[Dict, int]:
    """Drive the step loop from ``start`` to ``iters``; returns the final
    ``(state, step)``.

    - ``plan_fn(step)`` rebuilds the fused-chunk schedule from any step
      (called again after every rollback).
    - ``step_fn(state, k)`` advances ``k`` steps and must block until the
      result is real (the engine times it).
    - ``save_fn(step, state)`` persists a checkpoint; called when a chunk
      crosses a ``ckpt_every`` boundary, strictly AFTER the health check.
    - ``restore_fn() -> (step, state) | None`` is the rollback source
      (``None`` = nothing valid left → abort).
    - ``quarantine_fn(step)`` renames a restored-but-poisoned snapshot
      aside so the next restore attempt skips it.
    - ``flush_fn()`` drains an async checkpoint writer; called before any
      read-back of the checkpoint dir (rollback restore, disk-level
      injections) so "newest snapshot" never races the writer thread.
    - ``on_chunk(state, k, per_iter_s, step)`` observes each timed chunk
      (statistics, telemetry, dumps); may return a replacement state.
    - ``sentinel`` (``obs/live.LiveSentinel``) observes each chunk's
      whole-cycle per-step latency under ``sentinel_key``: step, injection,
      health check and save, wider than the step alone, so an injected
      slowdown or a slow save shows; a detection records
      ``anomaly.detected`` / ``replan.requested`` mid-run.
    - ``status`` (``obs/status.StatusWriter``) gets an atomic snapshot per
      chunk: step, latency, health counts, anomaly state.
    - ``replan`` (``plan/replan.ReplanController``): when a request is
      latched (the sentinel's ``on_replan`` hook, or the caller), the swap
      runs after the chunk, between chunks, and may return a re-sharded
      state, which replaces ``state``; a rejected swap continues on the
      old plan.
    - ``clock`` is the engine's timer (``time.perf_counter``); a test passes
      a stand-in to drive the sentinel without wall-clock time.
    """
    rec = telemetry.get()
    policy = policy or RecoveryPolicy()
    done = int(start)
    if injector is not None:
        dead = [s for s in injector.steps() if s <= start]
        if dead:
            log.warn(f"fault: injection step(s) {dead} are <= the start "
                     f"step {start} and will never fire (resumed past "
                     "them?)")
    rollbacks: Dict[int, int] = {}
    fault_log: List[dict] = []
    health_checks = 0
    # a campaign calls run_guarded once per slot segment on one status
    # writer: the health section accumulates on what the snapshot shows
    base_health = {"checks": 0, "faults": 0, "rollbacks": 0}
    if status is not None and isinstance(status.doc.get("health"), dict):
        prev_h = status.doc["health"]
        base_health = {k: int(prev_h.get(k, 0)) for k in base_health}

    def _status_update(step: int, per: Optional[float] = None) -> None:
        if status is None:
            return
        status.update(
            step=int(step), iters=int(iters), per_step_s=per,
            steps_per_s=(1.0 / per if per and per > 0 else None),
            health={"checks": base_health["checks"] + health_checks,
                    "faults": base_health["faults"] + len(fault_log),
                    "rollbacks": base_health["rollbacks"] + sum(rollbacks.values())},
            anomalies=sentinel.summary() if sentinel is not None else None)

    def _abort(fault: NumericalFault, reason: str) -> None:
        payload = {
            "kind": "stencil-fault-evidence",
            "app": app,
            "t": time.time(),
            "rc": FAULT_RC,
            "reason": reason,
            "policy": {"max_rollbacks": policy.max_rollbacks,
                       "backoff_s": policy.backoff_s},
            "faults": fault_log,
            "rollbacks": {str(k): v for k, v in rollbacks.items()},
            "injections": injector.describe() if injector else [],
            "ckpt_dir": ckpt_dir,
            "metrics": rec.path,
        }
        path = write_evidence(payload, evidence_dir or ckpt_dir)
        rec.meta("recover.aborted", reason=reason, step=int(fault.step),
                 rollbacks=sum(rollbacks.values()), evidence=path)
        log.error(f"fault: recovery exhausted at step {fault.step} "
                  f"({reason}); evidence: {path}; exiting rc={FAULT_RC}")
        raise RecoveryExhausted(fault, sum(rollbacks.values()), path, reason)

    while True:
        plan = plan_fn(done)
        try:
            for k in plan:
                prev = done
                t0 = clock()
                state = step_fn(state, k)
                per = (clock() - t0) / k
                done = prev + k
                if injector is not None:
                    state = injector.fire_due(state, prev, done, spec=spec,
                                              ckpt_dir=ckpt_dir,
                                              ckpt_flush=flush_fn)
                save_due = (save_fn is not None and done < iters
                            and _crossed(prev, done, ckpt_every))
                if guard is not None and (guard.due(prev, done) or save_due
                                          or done >= iters):
                    # a due save forces a check even off the health cadence:
                    # a poisoned state must never become a rollback target
                    guard.check(state, step=done)
                    health_checks += 1
                if save_due:
                    save_fn(done, state)
                cycle = per
                if sentinel is not None:
                    # the whole chunk cycle per step: an injected slowdown
                    # lands here, not in `per`
                    cycle = (clock() - t0) / k
                    sentinel.observe(sentinel_key, cycle, step=done, unit="s")
                if on_chunk is not None:
                    state = on_chunk(state, k, per, done) or state
                # after on_chunk, so a section it stages rides the same write
                _status_update(done, cycle)
                if replan is not None and replan.pending:
                    # the chunk is done and its status durable: the one safe
                    # point to swap the plan (the remaining chunk sizes are
                    # step counts, valid under any plan)
                    swapped = replan.maybe_swap(state, done)
                    if swapped is not None:
                        state = swapped
            return state, done
        except NumericalFault as f:
            n = rollbacks.get(f.step, 0) + 1
            rollbacks[f.step] = n
            fault_log.append({
                "kind": f.kind, "quantity": f.quantity, "step": f.step,
                "value": f.value, "t": time.time(), "attempt": n,
            })
            rec.meta("recover.fault", fault_kind=f.kind, quantity=f.quantity,
                     step=int(f.step), attempt=n)
            log.warn(f"fault: {f} (occurrence {n} at this step)")
            if restore_fn is None:
                _abort(f, "no checkpointing configured: cannot roll back")
            if n > policy.max_rollbacks:
                _abort(f, f"max rollbacks ({policy.max_rollbacks}) exceeded "
                          f"at step {f.step}")
            backoff = policy.backoff(n)
            rec.gauge("recover.backoff_s", backoff, phase="recover",
                      step=int(f.step), unit="s")
            log.warn(f"fault: backing off {backoff:g}s before rollback "
                     f"{n}/{policy.max_rollbacks}")
            time.sleep(backoff)
            # restore; the async writer is drained first so every save
            # already handed off is visible on disk. A restored state that
            # itself fails the guard is a poisoned snapshot: quarantine it
            # and fall further back
            if flush_fn is not None:
                flush_fn()
            restored = None
            for _ in range(policy.max_rollbacks + 8):
                found = restore_fn()
                if found is None:
                    _abort(f, "no valid checkpoint to roll back to")
                rstep, rstate = found
                try:
                    if guard is not None:
                        guard.check(rstate, step=rstep)
                except NumericalFault as g:
                    if quarantine_fn is None:
                        _abort(g, f"restored snapshot (step {rstep}) is "
                                  "poisoned and quarantine is unavailable")
                    log.warn(f"fault: restored step {rstep} is poisoned "
                             f"({g.kind} in {g.quantity!r}); quarantining")
                    quarantine_fn(rstep)
                    continue
                restored = (rstep, rstate)
                break
            if restored is None:
                _abort(f, "every restore candidate was poisoned")
            rstep, state = restored
            rec.counter("recover.rollback", value=1, phase="recover",
                        from_step=int(done), to_step=int(rstep),
                        fault_step=int(f.step))
            log.warn(f"fault: rolled back from step {done} to checkpointed "
                     f"step {rstep}")
            done = rstep
            _status_update(done)  # the snapshot shows the rollback
