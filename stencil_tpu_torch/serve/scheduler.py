"""The always-on scheduler: continuous batching over the campaign driver.

The port's counterpart of ``stencil_tpu.serve.scheduler``.
:class:`ServeScheduler` subclasses :class:`~..campaign.driver.
CampaignDriver` and overrides its serving hooks — the batch campaign's
machinery (bucketed slots, guarded segments, eviction, per-tenant
snapshots) is reused verbatim; what changes is WHERE jobs come from and
WHEN they may enter:

- **Live intake.** ``_refresh_queue`` (called by the driver before every
  backfill scan and once per chunk) claims ``jobs/incoming/`` drops,
  runs admission, and grows the LIVE queue — so a job that arrives
  while a slot is mid-flight lands in the very next freed lane, with no
  slot-wide barrier. That is the continuous-batching extension: the
  driver's backfill path, promoted from drain-time to steady-state.
- **Deadline-sorted packing.** Baseline slot selection is
  :func:`~.queue.pick_serve_slot`: the most urgent queued job names the
  bucket, same-bucket jobs fill the slot tightest-deadline-first. With
  the CAPACITY ENGINE on (packing / fairness / elastic width — see
  below), selection is :func:`~.packer.pack_serve_slot` instead.
- **Capacity engine** (all opt-in; the bare constructor is the
  fixed-slot scheduler, which is also the A/B baseline):
  ``slot_min``/``slot_max`` make the slot width ELASTIC — each slot is
  sized to its bucket's queue depth on a power-of-two ladder
  (:class:`~.fairness.WidthPolicy`), a mid-slot surge GROWS the running
  slot by parking it at a chunk boundary (bit-identical snapshots) and
  re-forming it wider, and the pricer learns per-(bucket, width) cost
  rows so a B=64 slot is never priced with B=8 p99s. ``fairness`` swaps
  the strict priority sort for stride-weighted shares with
  deadline-aware aging (:class:`~.fairness.FairnessPolicy`) — sustained
  ``high`` load degrades ``low`` smoothly instead of starving it.
  ``packing`` scores every contender bucket by ledger-priced throughput
  and deadline slack (:func:`~.packer.pack_serve_slot`). ``preempt``
  lets a queued ``high`` job whose completion budget cannot survive
  waiting out the running slot PARK that slot mid-flight — priced
  against the victims' resume cost, so a preemption that buys less than
  it spends is vetoed (``serve.preempt_veto``), and thrashing is
  structurally impossible. Every decision lands as a schema-valid
  record: ``serve.packed``, ``serve.resized``, ``serve.preempted``,
  ``serve.preempt_veto``.
- **SLO pressure.** ``_observe_chunk`` prices every chunk into the
  :class:`~.admission.BucketPricer`; when a queued or running job's
  deadline falls under the bucket's online p99, the scheduler emits a
  first-class ``replan.requested`` (reason ``slo-pressure``) and, when a
  plan hot-swap is attached (``replan``), latches it for the next slot
  boundary.
- **Result streaming.** ``_on_result`` writes ``results/<job>.json``
  atomically the moment a tenant retires (or faults out), emits
  ``serve.retired``, and promotes deferred jobs into freed quota.
- **Drain + revival.** ``request_drain`` (the SIGTERM handler's one
  call) parks every live lane as a revivable snapshot at the next
  segment boundary; ``serve-state.json`` (serve/state.py, atomic)
  always knows which jobs are owed work, so a killed-and-revived
  daemon resumes admitted-but-unserved jobs and never re-runs retired
  ones.

A slot runs on the driver's one device. The driver's ``sentinel`` and
``status`` (``obs/live``, ``obs/status``) watch the slots as in the JAX
package, the status file carrying the daemon's ``queue`` section.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Tuple

from ..campaign.driver import CampaignDriver, TenantResult
from ..obs import ledger as ledger_mod
from ..obs.ledger import host_fingerprint
from ..obs import telemetry
from ..utils import logging as log
from ..utils.statistics import percentile
from . import state as state_mod
from .admission import AdmissionController, BucketPricer, bucket_label
from .fairness import FairnessPolicy, WidthPolicy
from .intake import Intake, ServeJob, job_from_doc, validate_job
from .packer import pack_serve_slot
from .queue import ServeQueue, pick_serve_slot


class ServeScheduler(CampaignDriver):
    """A persistent :class:`CampaignDriver` fed by file-drop intake.

    ``serve_dir`` owns the whole service: ``jobs/`` (intake),
    ``campaign/`` (slot machinery + tenant snapshots), ``results/``
    (streamed per-tenant results), ``serve-state.json``. ``quota`` is
    the per-tenant cap on live jobs (0 = unlimited);
    ``admission_ledger`` seeds deadline pricing and receives the run's
    per-bucket p99 back at exit; ``max_idle_s`` > 0 exits after that
    long with an empty queue (0 = serve until drained by signal);
    ``max_wall_s`` > 0 is a total-budget self-drain. The other keywords
    go to :class:`CampaignDriver` (``device=``: the card unless "cpu")."""

    def __init__(self, serve_dir: str, slot_size: int, *,
                 quota: int = 0, admission_ledger: Optional[str] = None,
                 poll_s: float = 0.2, max_idle_s: float = 0.0,
                 max_wall_s: float = 0.0,
                 slot_min: Optional[int] = None,
                 slot_max: Optional[int] = None,
                 packing: bool = False, preempt: bool = False,
                 fairness: bool = False,
                 fair_weights: Optional[Dict[str, float]] = None,
                 aging_s: float = 30.0,
                 preempt_cost_chunks: float = 1.0, **kw):
        kw.setdefault("resume", True)  # revival is the serving default
        super().__init__([], slot_size,
                         os.path.join(serve_dir, "campaign"), **kw)
        self.serve_dir = serve_dir
        self.results_dir = os.path.join(serve_dir, "results")
        self.state_path = os.path.join(serve_dir, "serve-state.json")
        self.intake = Intake(serve_dir)
        self.pricer = BucketPricer(admission_ledger)
        self.admission = AdmissionController(quota=quota, pricer=self.pricer)
        self.admission_ledger = admission_ledger or None
        self.poll_s = max(0.01, float(poll_s))
        self.max_idle_s = float(max_idle_s)
        self.max_wall_s = float(max_wall_s)
        # -- the capacity engine (all OFF by default: the bare
        # constructor is the fixed-slot scheduler, the A/B baseline;
        # apps/serve.py turns the engine on) -------------------------------
        self.width_policy = WidthPolicy(
            slot_size if slot_min is None else slot_min,
            slot_size if slot_max is None else slot_max)
        self.fairness = (FairnessPolicy(fair_weights, aging_s=aging_s)
                         if fairness else None)
        self.packing = bool(packing)
        self.preempt = bool(preempt)
        self.preempt_cost_chunks = float(preempt_cost_chunks)
        self.queue = ServeQueue(policy=self.fairness)
        self.state = state_mod.make_state()
        self.results: Dict[str, TenantResult] = {}
        self._deferred: List[ServeJob] = []
        self._jobs_by_id: Dict[str, ServeJob] = {}
        self._running: set = set()
        self._drain = False
        self._drain_reason = ""
        self._pressure_sent: set = set()
        self._all_lat: List[float] = []
        self._retired_run = 0
        self._seq = 0
        self._last_bucket: Optional[Tuple] = None
        # capacity-engine state: the park reason distinguishes a
        # capacity park (preempt/resize — the serve loop continues) from
        # a drain (it exits); preemption latches once per slot and per
        # vetoed beneficiary so the per-chunk check is not a siren
        self._park_reason: Optional[str] = None
        self._preempt_for: Optional[str] = None
        self._preempted_this_slot = False
        self._preempt_vetoed: set = set()
        self._preemptions = 0
        self._resizes = 0
        self._last_width: Dict[str, int] = {}
        self._lat_by_pri: Dict[str, List[float]] = {}

    # -- drain (the SIGTERM handler calls exactly this) -----------------------
    def request_drain(self, reason: str) -> None:
        """Stop claiming intake, park live lanes at the next segment
        boundary, persist everything, exit cleanly. Signal-safe: plain
        assignments only — the serve loop does the work."""
        self._drain = True
        if not self._drain_reason:
            self._drain_reason = str(reason)

    # -- durable state --------------------------------------------------------
    def _flush_state(self) -> None:
        self.state["draining"] = self._drain
        state_mod.write_state(self.state_path, self.state)

    def _counters(self) -> dict:
        return self.state["counters"]

    def queue_stat(self) -> dict:
        """The status snapshot's ``queue`` section (obs/status.py)."""
        c = self._counters()
        return {
            "depth": len(self.queue),
            "admitted": c["admitted"],
            "rejected": c["rejected"],
            "backfills": c["backfills"],
            "deferred": len(self._deferred),
            "retired": c["retired"],
            "preempted": self._preemptions,
            "resized": self._resizes,
            "width": int(self._cur_width),
        }

    def _live_by_owner(self) -> Dict[str, int]:
        """Live (queued + running) job counts per owning tenant — the
        quota denominator. Deferred jobs do not count (a tenant's own
        holding pen must not block its promotions)."""
        live: Dict[str, int] = {}
        for j in self.state["jobs"].values():
            if j["state"] in ("queued", "running"):
                live[j["owner"]] = live.get(j["owner"], 0) + 1
        return live

    # -- revival --------------------------------------------------------------
    def _revive(self) -> int:
        """Load serve-state.json and re-queue every job the previous
        daemon still owed work: queued/running -> the live queue
        (running tenants resume from their newest snapshot — the ckpt
        bit-identity contract), deferred -> the holding pen. Terminal
        jobs (done/fault/rejected) are never touched."""
        doc = state_mod.read_state(self.state_path)
        if doc is None:
            return 0
        errs = state_mod.validate_state(doc)
        if errs:
            raise ValueError(
                f"corrupt serve-state at {self.state_path}: "
                + "; ".join(errs[:3]))
        self.state = doc
        n = 0
        jobs = sorted(doc["jobs"].items(),
                      key=lambda kv: kv[1].get("seq", 0))
        for jid, j in jobs:
            self._seq = max(self._seq, int(j.get("seq", 0)) + 1)
            if j["state"] not in state_mod.LIVE_STATES:
                continue
            job = job_from_doc(j["spec"], int(j.get("seq", 0)))
            n += 1
            if j["state"] == "deferred":
                self._deferred.append(job)
                self._register(job)
            else:
                j["state"] = "queued"  # running-at-crash resumes
                self._enqueue(job, revived=True)
        if n:
            telemetry.get().meta(
                "serve.revived", jobs=n, queued=len(self.queue),
                deferred=len(self._deferred))
            log.info(f"serve: revived {n} unserved job(s) from "
                     f"{self.state_path}")
        self._promote()
        return n

    # -- admission ------------------------------------------------------------
    def _next_seq(self) -> int:
        s = self._seq
        self._seq += 1
        return s

    def _register(self, job: ServeJob) -> None:
        self._jobs_by_id[job.tid] = job
        self.jobs.append(job)  # driver-level registry (injector, summary)

    def _enqueue(self, job: ServeJob, *, revived: bool = False,
                 promoted: bool = False) -> None:
        self.queue.admit(job)
        if job.tid not in self._jobs_by_id:
            self._register(job)
        st = self.state["jobs"].setdefault(job.tid, {
            "steps_done": 0, "owner": job.owner, "priority": job.priority,
            "seq": job.seq, "spec": job.spec_doc(),
        })
        st["state"] = "queued"
        if not revived:
            self._counters()["admitted"] += 1
            telemetry.get().meta(
                "serve.admitted", job=job.tid, tenant=job.owner,
                priority=job.priority, seq=job.seq,
                deadline_ms=job.deadline_ms, promoted=promoted,
                bucket=bucket_label(job.bucket()))

    def _quarantine(self, path: str, jid: str, reason: str) -> None:
        bad = self.intake.quarantine(path, reason)
        self._counters()["rejected"] += 1
        telemetry.get().meta("serve.rejected", job=jid, reason=reason,
                             file=bad)
        log.warn(f"serve: REJECTED job {jid!r}: {reason} "
                 f"(quarantined: {bad})")

    def _admit_one(self, path: str, doc, errs: List[str]) -> None:
        stem = os.path.splitext(os.path.basename(path))[0]
        if doc is None or errs:
            self._quarantine(path, stem, "; ".join(errs) or "unreadable")
            return
        verrs = validate_job(doc)
        jid = doc.get("job") if isinstance(doc.get("job"), str) else None
        if verrs:
            self._quarantine(path, jid or stem, "; ".join(verrs))
            return
        prior = self.state["jobs"].get(jid)
        if prior is not None:
            self._quarantine(
                path, jid,
                f"duplicate job id {jid!r} (already {prior['state']}); "
                "a replayed job is never re-run")
            return
        job = job_from_doc(doc, self._next_seq())
        # price the slot width this job would actually run at (the
        # elastic ladder rung covering its bucket's depth + itself)
        depth = 1 + sum(1 for q in self.queue.jobs()
                        if q.bucket() == job.bucket())
        verdict, reason = self.admission.decide(
            job, self._live_by_owner(),
            width_hint=self.width_policy.choose(depth))
        if verdict == "reject":
            self.state["jobs"][jid] = {
                "state": "rejected", "steps_done": 0, "owner": job.owner,
                "priority": job.priority, "seq": job.seq, "reason": reason,
            }
            self._quarantine(path, jid, reason)
            return
        if verdict == "defer":
            self._deferred.append(job)
            self._register(job)
            self.state["jobs"][jid] = {
                "state": "deferred", "steps_done": 0, "owner": job.owner,
                "priority": job.priority, "seq": job.seq,
                "spec": job.spec_doc(), "reason": reason,
            }
            self._counters()["deferred"] += 1
            telemetry.get().meta("serve.deferred", job=jid, reason=reason)
            log.info(f"serve: deferred job {jid!r}: {reason}")
            return
        self._enqueue(job)

    def _promote(self) -> bool:
        """Move deferred jobs whose owner has quota headroom into the
        queue (priority/deadline order) — the QUEUES-not-rejects half of
        quota exhaustion."""
        changed = False
        live = self._live_by_owner()
        for job in sorted(self._deferred, key=ServeJob.order_key):
            q = self.admission.quota
            if q and live.get(job.owner, 0) >= q:
                continue
            self._deferred.remove(job)
            live[job.owner] = live.get(job.owner, 0) + 1
            self._enqueue(job, promoted=True)
            changed = True
        return changed

    # -- the driver's serving hooks -------------------------------------------
    def _refresh_queue(self, queue) -> None:
        """The steady-state intake pump (driver calls: per chunk, before
        every backfill scan). Draining stops claiming — undropped jobs
        stay in ``incoming/`` for the next daemon."""
        if self._drain:
            return
        polled = self.intake.poll()
        if not polled and not self._deferred:
            return
        for path, doc, errs in polled:
            self._admit_one(path, doc, errs)
        promoted = self._promote()
        if polled or promoted:
            self._flush_state()
            telemetry.get().gauge("serve.queue_depth",
                                  float(len(self.queue)), phase="serve")

    def _observe_chunk(self, bucket, per: float, done_now: int) -> None:
        self.pricer.observe(bucket, per, width=self._cur_width)
        self._all_lat.append(per)
        # every live lane stepped together, so the chunk's per-step wall
        # is a sample for each lane's priority class — the split
        # report.py folds by the `priority` tag
        for lane in self._cur_lanes:
            if lane.tenant is not None:
                pri = getattr(lane.tenant, "priority", "normal")
                self._lat_by_pri.setdefault(pri, []).append(per)
        self._check_pressure(bucket, done_now)
        self._maybe_resize(bucket, done_now)
        self._maybe_preempt(bucket, done_now)
        if self.status is not None:
            # staged; run_guarded's per-chunk update flushes atomically
            self.status.set(queue=self.queue_stat())

    def _check_pressure(self, bucket, done_now: int) -> None:
        """Deadline-at-risk -> a first-class replan trigger: any queued
        or RUNNING job of this bucket whose deadline sits under the
        online p99 latches the ReplanController (once per bucket per
        swap window — pressure is a condition, not a siren)."""
        label = bucket_label(bucket)
        if label in self._pressure_sent:
            return
        priced = self.pricer.price(bucket)
        if priced is None:
            return
        p99_ms, source = priced
        candidates = list(self.queue) + [
            self._jobs_by_id[t] for t in sorted(self._running)
            if t in self._jobs_by_id]
        at_risk = sorted(j.tid for j in candidates
                         if j.bucket() == bucket and j.deadline_ms is not None
                         and float(j.deadline_ms) < p99_ms)
        if not at_risk:
            return
        self._pressure_sent.add(label)
        telemetry.get().meta(
            "replan.requested", reason="slo-pressure", step=int(done_now),
            bucket=label, p99_ms=float(p99_ms), jobs=at_risk,
            priced_from=source)
        log.warn(f"serve: SLO PRESSURE on bucket {label}: p99 "
                 f"{p99_ms:.4g} ms puts {at_risk} at deadline risk "
                 "(replan requested)")
        if self.replan is not None:
            self.replan.request({"metric": "slo-pressure", "bucket": label,
                                 "p99_ms": float(p99_ms),
                                 "step": int(done_now), "jobs": at_risk})

    # -- chunk-boundary capacity decisions ------------------------------------
    def _live_lanes(self) -> list:
        return [l for l in self._cur_lanes if l.tenant is not None]

    def _slot_remaining_ms(self, bucket,
                           done_now: int) -> Optional[Tuple[float, str]]:
        """The RUNNING slot's priced remaining wall ``(ms, source)``, or
        None when the pricer has no row — capacity decisions never
        guess."""
        lanes = self._live_lanes()
        if not lanes:
            return None
        priced = self.pricer.price(bucket, width=self._cur_width)
        if priced is None:
            return None
        p99_ms, source = priced
        rem = max(l.tenant.steps - l.tenant_step(done_now) for l in lanes)
        return max(0, rem) * p99_ms, source

    def _maybe_resize(self, bucket, done_now: int) -> None:
        """GROW the running slot mid-flight: when the same-bucket
        backlog would fill a larger ladder rung AND the priced remaining
        wall amortizes the park/revive, park the slot (bit-identical
        snapshots) so the next pack re-forms it wider. Shrinking needs
        no park — the next slot simply chooses a smaller rung."""
        if (self.width_policy.fixed or self._drain
                or self._park_reason is not None):
            return
        lanes = self._live_lanes()
        if not lanes or self._cur_width >= self.width_policy.slot_max:
            return
        queued_same = sum(1 for j in self.queue.jobs()
                          if j.bucket() == bucket)
        depth = len(lanes) + queued_same
        want = self.width_policy.choose(depth)
        # grow only when the backlog would otherwise cost at least one
        # whole extra slot at the current width
        if want <= self._cur_width or queued_same < self._cur_width:
            return
        rem = self._slot_remaining_ms(bucket, done_now)
        if rem is None:
            return  # unpriced growth is a guess — decline
        rem_ms, source = rem
        priced = self.pricer.price(bucket, width=self._cur_width)
        cost_ms = self.preempt_cost_chunks * self.chunk * priced[0]
        if rem_ms <= cost_ms:
            return  # the slot is nearly done; let it finish
        self._park_reason = "resize"
        self._resizes += 1
        telemetry.get().meta(
            "serve.resized", bucket=bucket_label(bucket),
            from_width=int(self._cur_width), to_width=int(want),
            reason="grow", depth=int(depth), remaining_ms=float(rem_ms),
            cost_ms=float(cost_ms), priced_from=source)
        log.info(f"serve: RESIZE bucket {bucket_label(bucket)} "
                 f"B={self._cur_width} -> {want} (depth {depth}, "
                 f"remaining {rem_ms:.4g} ms > resize cost "
                 f"{cost_ms:.4g} ms)")

    def _maybe_preempt(self, bucket, done_now: int) -> None:
        """Park the running slot for a queued ``high`` deadline job of a
        DIFFERENT bucket that cannot make its completion budget waiting
        in queue — but only when the wait avoided exceeds the victims'
        priced resume cost, so thrashing is structurally impossible
        (each preemption must buy more than it spends, and at most one
        fires per slot)."""
        if (not self.preempt or self._drain
                or self._park_reason is not None
                or self._preempted_this_slot):
            return
        cands = [j for j in self.queue.jobs()
                 if j.priority == "high" and j.deadline_ms is not None
                 and j.bucket() != bucket
                 and j.tid not in self._preempt_vetoed]
        if not cands:
            return
        rem = self._slot_remaining_ms(bucket, done_now)
        if rem is None:
            return  # unpriced victims: preemption never guesses
        rem_ms, source = rem
        victims = [l.tenant for l in self._live_lanes()]
        if any(getattr(v, "priority", "normal") == "high"
               for v in victims):
            return  # only a strictly lower-value lane-set is parkable
        victim_p99 = self.pricer.price(bucket, width=self._cur_width)[0]
        resume_cost_ms = (self.preempt_cost_chunks * self.chunk
                          * victim_p99 * len(victims))
        rec = telemetry.get()
        for j in sorted(cands, key=lambda j: (float(j.deadline_ms)
                                              * j.steps, j.seq)):
            jw = self.width_policy.choose(1)
            priced_j = self.pricer.price(j.bucket(), width=jw)
            if priced_j is None:
                continue  # can't price the beneficiary either
            budget_ms = float(j.deadline_ms) * j.steps
            wait_budget_ms = budget_ms - priced_j[0] * j.steps
            if rem_ms <= wait_budget_ms:
                continue  # feasible in queue — no preemption needed
            gain_ms = rem_ms - max(0.0, wait_budget_ms)
            if gain_ms <= resume_cost_ms:
                self._preempt_vetoed.add(j.tid)
                rec.meta("serve.preempt_veto", job=j.tid,
                         bucket=bucket_label(j.bucket()),
                         victim_bucket=bucket_label(bucket),
                         gain_ms=float(gain_ms),
                         resume_cost_ms=float(resume_cost_ms),
                         remaining_ms=float(rem_ms), priced_from=source)
                log.info(f"serve: preempt VETO for {j.tid}: gain "
                         f"{gain_ms:.4g} ms <= victim resume cost "
                         f"{resume_cost_ms:.4g} ms")
                continue
            self._park_reason = "preempt"
            self._preempt_for = j.tid
            self._preempted_this_slot = True
            self._preemptions += 1
            rec.meta("serve.preempted", job=j.tid,
                     bucket=bucket_label(j.bucket()),
                     victim_bucket=bucket_label(bucket),
                     victims=sorted(v.tid for v in victims),
                     gain_ms=float(gain_ms),
                     resume_cost_ms=float(resume_cost_ms),
                     remaining_ms=float(rem_ms), priced_from=source)
            log.warn(f"serve: PREEMPT slot bucket "
                     f"{bucket_label(bucket)} for high job {j.tid}: "
                     f"waiting {rem_ms:.4g} ms breaks its budget "
                     f"{budget_ms:.4g} ms (gain {gain_ms:.4g} ms > "
                     f"resume cost {resume_cost_ms:.4g} ms)")
            return

    def _mark_running(self, job: ServeJob) -> None:
        self._running.add(job.tid)
        st = self.state["jobs"].get(job.tid)
        if st is not None:
            st["state"] = "running"

    def _backfill_gate(self, bucket) -> bool:
        """The aging bound's second half: packing alone cannot bound a
        different-bucket job's wait when a same-bucket stream keeps the
        slot alive via backfill — so once any queued job is URGENT
        (waited past ``aging_s * (rank + 1)``) and belongs to another
        bucket, freed lanes stop refilling, the slot drains, and the
        next pack's aging override serves the overdue job."""
        if self.fairness is None:
            return True
        now = self.fairness.clock()
        return not any(j.bucket() != bucket
                       for j in self.queue.jobs(now)
                       if self.fairness.urgent(j, now))

    def _on_backfill(self, job, lane_idx: int, slot_step: int) -> None:
        self._counters()["backfills"] += 1
        if self.fairness is not None:
            # a backfilled job was never packed: charge its class here
            self.fairness.charge(getattr(job, "priority", "normal"))
        self._mark_running(job)
        self._flush_state()

    def _on_result(self, r: TenantResult) -> None:
        """Stream the result the moment it exists: atomic
        ``results/<job>.json``, a ``serve.retired`` record, quota
        promotion, durable state."""
        self._running.discard(r.tid)
        st = self.state["jobs"].get(r.tid)
        if st is not None:
            st["state"] = r.outcome  # "done" | "fault"
            st["steps_done"] = int(r.steps)
        self._counters()["retired"] += 1
        self._retired_run += 1
        job = self._jobs_by_id.get(r.tid)
        self._write_result_doc(r, job)
        telemetry.get().meta(
            "serve.retired", job=r.tid, outcome=r.outcome,
            steps=int(r.steps), snapshot_dir=r.snapshot_dir,
            tenant=job.owner if job is not None else r.tid)
        self._promote()
        self._flush_state()

    def _write_result_doc(self, r: TenantResult,
                          job: Optional[ServeJob]) -> None:
        doc = {
            "v": 1, "kind": "serve-result", "job": r.tid,
            "tenant": job.owner if job is not None else r.tid,
            "outcome": r.outcome, "steps": int(r.steps),
            "snapshot_dir": r.snapshot_dir, "evidence": r.evidence,
            "t": time.time(),
        }
        os.makedirs(self.results_dir, exist_ok=True)
        tmp = os.path.join(self.results_dir,
                           f".tmp-{r.tid}.json-{os.getpid()}")
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1)
                f.write("\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.results_dir,
                                         f"{r.tid}.json"))
        except OSError:
            pass  # streaming is evidence; the snapshot dir is the truth

    def _segment_end(self, slot_step: int, end: int) -> int:
        # chunk-granular segments: the park check (and backfill scan)
        # runs every fused chunk, so SIGTERM drains at the next chunk
        # boundary instead of waiting out a whole tenant's remaining
        # steps — drain latency is one chunk, bounded and small
        return min(end, slot_step + self.chunk)

    def _should_park(self) -> bool:
        # drain parks to EXIT; a capacity park (preempt/resize) parks to
        # re-form the slot — the serve loop continues
        return self._drain or self._park_reason is not None

    def _on_park(self, job, tenant_step: int) -> None:
        self._running.discard(job.tid)
        st = self.state["jobs"].get(job.tid)
        if st is not None:
            st["state"] = "queued"
            st["steps_done"] = int(tenant_step)
        # back into the live queue: the in-memory view must agree with
        # the durable state (the drain log and summary count it as owed)
        self.queue.admit(job)
        if self.fairness is not None:
            # parked, not served: refund the share charged at pack time
            self.fairness.charge(getattr(job, "priority", "normal"), -1)
        telemetry.get().meta("serve.parked", job=job.tid,
                             step=int(tenant_step),
                             reason=self._park_reason or "drain")
        log.info(f"serve: parked job {job.tid} at step {tenant_step} "
                 f"({self._park_reason or 'drain'}, revivable)")

    # -- the serve loop -------------------------------------------------------
    def serve(self) -> dict:
        rec = telemetry.get()
        os.makedirs(self.campaign_dir, exist_ok=True)
        os.makedirs(self.results_dir, exist_ok=True)
        revived = self._revive()
        # the summary reports THIS run; the state counters (and the
        # status queue section) stay cumulative across revivals
        c0 = dict(self._counters())
        results = self.results
        lat: List[float] = []
        cell_steps = 0
        wall = 0.0
        slot_idx = 0
        t0 = time.perf_counter()
        idle_since: Optional[float] = None
        self._flush_state()
        if self.status is not None:
            self.status.update(queue=self.queue_stat())
        while True:
            if (self.max_wall_s > 0
                    and time.perf_counter() - t0 >= self.max_wall_s):
                self.request_drain("max-wall")
            self._refresh_queue(self.queue)
            if self._drain:
                break
            if not self.queue:
                now = time.monotonic()
                if idle_since is None:
                    idle_since = now
                if (self.max_idle_s > 0
                        and now - idle_since >= self.max_idle_s):
                    break
                if self.status is not None:
                    self.status.update(queue=self.queue_stat())
                time.sleep(self.poll_s)
                continue
            idle_since = None
            engine = (self.packing or self.fairness is not None
                      or not self.width_policy.fixed)
            if engine:
                plan = pack_serve_slot(self.queue, self.width_policy,
                                       pricer=self.pricer,
                                       fairness=self.fairness)
                bucket, picked, width = plan.bucket, plan.picked, plan.width
                label = bucket_label(bucket)
                prev_w = self._last_width.get(label)
                if prev_w is not None and prev_w != width:
                    self._resizes += 1
                    rec.meta("serve.resized", bucket=label,
                             from_width=int(prev_w), to_width=int(width),
                             reason=("shrink" if width < prev_w
                                     else "grow"),
                             depth=len(picked) + len(self.queue))
                self._last_width[label] = width
                rec.meta(
                    "serve.packed", bucket=label, width=int(width),
                    jobs=[j.tid for j in picked], lead=plan.lead,
                    reason=plan.reason, candidates=plan.candidates,
                    fairness=(self.fairness.snapshot()
                              if self.fairness is not None else None))
                rec.gauge("serve.slot_width", float(width), phase="serve",
                          bucket=label)
            else:
                bucket, picked = pick_serve_slot(self.queue,
                                                 self.slot_size)
                width = self.slot_size
            self._last_bucket = bucket
            for j in picked:
                self._mark_running(j)
            self._flush_state()
            stats = self._run_slot(slot_idx, bucket, picked, self.queue,
                                   results, width=width)
            lat.extend(stats["latency_samples"])
            cell_steps += stats["cell_steps"]
            wall += stats["wall_s"]
            slot_idx += 1
            if self._park_reason is not None:
                # a capacity park, not a drain: the parked jobs are back
                # in the queue; the next pack re-forms the slot (wider,
                # or around the preempting high job)
                self._park_reason = None
                self._preempt_for = None
                self._preempted_this_slot = False
                self._preempt_vetoed.clear()
            if self.replan is not None and self.replan.pending:
                # between slots — the campaign's swap boundary; a swap
                # re-arms the per-bucket pressure latch
                self.replan.maybe_swap(None, slot_idx)
                self._pressure_sent.clear()

        outcome = "drained" if self._drain else "idle"
        if self._drain:
            rec.meta("serve.drain", reason=self._drain_reason or "requested",
                     queued=len(self.queue), deferred=len(self._deferred))
            log.info(f"serve: drained ({self._drain_reason}): "
                     f"{len(self.queue)} queued + {len(self._deferred)} "
                     "deferred job(s) persisted for revival")
        if self.admission_ledger:
            host = host_fingerprint(self.device)
            entries = self.pricer.ledger_entries(
                platform=host["platform"], label=rec.run_id or "serve",
                device=host["device"])
            if entries:
                ledger_mod.append_entries(self.admission_ledger, entries)
        total_wall = time.perf_counter() - t0
        tph = (self._retired_run / total_wall * 3600.0
               if total_wall > 0 else 0.0)
        p50 = percentile(self._all_lat, 50) if self._all_lat else None
        p99 = percentile(self._all_lat, 99) if self._all_lat else None
        if self._retired_run and rec.enabled:
            rec.gauge("serve.tenants_per_hour", tph, phase="serve")
        if p99 is not None and rec.enabled:
            rec.gauge("serve.p99_ms", p99 * 1e3, phase="serve", unit="ms")
        # the per-class split: a folded p99 averages high and low lanes
        # into a number that describes neither; report.py keeps these
        # separate via the `priority` tag
        p99_by_pri = {pri: percentile(v, 99) * 1e3
                      for pri, v in sorted(self._lat_by_pri.items()) if v}
        if rec.enabled:
            for pri, v_ms in p99_by_pri.items():
                rec.gauge("serve.p99_ms", v_ms, phase="serve", unit="ms",
                          priority=pri)
        c = self._counters()
        summary = {
            "outcome": outcome,
            "revived": revived,
            "slots": slot_idx,
            "retired": self._retired_run,
            "admitted": c["admitted"] - c0["admitted"],
            "rejected": c["rejected"] - c0["rejected"],
            "deferred": c["deferred"] - c0["deferred"],
            "backfills": c["backfills"] - c0["backfills"],
            "queued_remaining": len(self.queue) + len(self._deferred),
            "tenants_per_hour": tph,
            "p50_step_s": p50,
            "p99_step_s": p99,
            "p99_ms_by_priority": p99_by_pri,
            "preemptions": self._preemptions,
            "resizes": self._resizes,
            "fairness": (self.fairness.snapshot()
                         if self.fairness is not None else None),
            "evicted": sorted(t for t, r in results.items()
                              if r.outcome == "fault"),
            "slo_violations": sorted(self._slo_violated),
            "anomalies": (self.sentinel.detected_total
                          if self.sentinel is not None else 0),
            "cell_steps": cell_steps,
            "step_wall_s": wall,
            "total_wall_s": total_wall,
            "aggregate_mcells_per_s": (cell_steps / wall / 1e6
                                       if wall > 0 else 0.0),
            "cache": self.cache.stats(),
            "results": results,
        }
        self._flush_state()
        if self.status is not None:
            self.status.update(outcome=outcome, queue=self.queue_stat())
        return summary
