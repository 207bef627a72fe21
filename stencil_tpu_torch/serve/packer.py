"""Cross-bucket slot packing: score (bucket, width, jobs) and choose.

The port's counterpart of ``stencil_tpu.serve.packer``. The fixed-slot
daemon forms slots with :func:`~.queue.pick_serve_slot`: the queue head
names the bucket, full stop. A mixed queue fragments under that rule —
the head's bucket may hold two jobs while another bucket could fill a
slot. :func:`pack_serve_slot` replaces it with a scored packing pass:

1. **Entitlement.** The fairness policy (stride shares + aging) names
   the class entitled to the slot; an URGENT job (waited past the aging
   bound) forces its bucket outright. Without a policy, the strict
   queue head leads — the fixed-slot order.
2. **Candidates.** Every bucket holding a job of the entitled class is
   a contender. Each gets its elastic width (``WidthPolicy.choose``
   against its own depth) and its prefix of queued jobs.
3. **Score.** Contenders are ranked by ledger-priced throughput (picked
   jobs per priced millisecond of slot wall), then fill fraction, then
   the lead job's queue key — so a mixed queue packs into fewer, fuller,
   faster slots, and the tie falls back to urgency order.
4. **Deadline slack veto.** If the winner's priced wall would push a
   losing contender's tightest completion budget negative while that
   contender, served first, leaves the winner feasible, the loser is
   promoted — packing never manufactures an SLO miss it can see.

The decision is returned whole (:class:`SlotPlan`, including the scored
candidate table) so the scheduler can emit it as one schema-valid
``serve.packed`` record naming what was chosen and why. Picked jobs are
removed from the queue in place and charged to their classes' stride
passes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .admission import BucketPricer, bucket_label
from .fairness import FairnessPolicy, WidthPolicy
from .intake import PRIORITIES, ServeJob
from .queue import ServeQueue


@dataclass
class SlotPlan:
    """One packing decision: the slot to form and the evidence for it."""

    bucket: Tuple
    width: int
    picked: List[ServeJob]
    reason: str          # "throughput" | "aging-override" | "deadline-slack"
    lead: str            # job id whose entitlement led the choice
    candidates: List[dict] = field(default_factory=list)


def _group_by_bucket(jobs: List[ServeJob]):
    groups: Dict[Tuple, List[ServeJob]] = {}
    order: List[Tuple] = []
    for j in jobs:
        b = j.bucket()
        if b not in groups:
            groups[b] = []
            order.append(b)
        groups[b].append(j)
    return groups, order


def _slot_wall_ms(cand: dict) -> Optional[float]:
    if cand["p99_ms"] is None:
        return None
    return cand["p99_ms"] * max(j.steps for j in cand["picked"])


def _tightest_slack_ms(cand: dict, wait_ms: float) -> Optional[float]:
    """Min completion slack over the candidate's deadline jobs if its
    slot starts after ``wait_ms`` (budget = deadline_ms * steps — the
    per-step SLO rolled up to the whole job)."""
    if cand["p99_ms"] is None:
        return None
    slacks = [
        float(j.deadline_ms) * j.steps
        - (wait_ms + cand["p99_ms"] * j.steps)
        for j in cand["picked"] if j.deadline_ms is not None
    ]
    return min(slacks) if slacks else None


def pack_serve_slot(queue: ServeQueue, width_policy: WidthPolicy, *,
                    pricer: Optional[BucketPricer] = None,
                    fairness: Optional[FairnessPolicy] = None,
                    now: Optional[float] = None) -> Optional[SlotPlan]:
    """Form the next slot from the LIVE queue. Removes the picked jobs
    in place (the queue stays live for mid-slot backfill) and charges
    them to the fairness shares. Returns None on an empty queue."""
    if fairness is not None and now is None:
        now = fairness.clock()
    jobs = queue.jobs(now)
    if not jobs:
        return None
    groups, order = _group_by_bucket(jobs)

    # 1. entitlement: who leads the slot
    reason = "throughput"
    forced: Optional[Tuple] = None
    if fairness is not None:
        classes = {j.priority if j.priority in PRIORITIES else "normal"
                   for j in jobs}
        fairness.note_backlog(classes)
        overdue = [j for j in jobs if fairness.urgent(j, now)]
        if overdue:
            lead = min(overdue, key=lambda j: j.seq)  # oldest admitted
            forced = lead.bucket()
            reason = "aging-override"
        else:
            c_star = fairness.lead_class(classes)
            lead = next(j for j in jobs if (j.priority
                                            if j.priority in PRIORITIES
                                            else "normal") == c_star)
    else:
        lead = jobs[0]

    # 2. contenders: the forced bucket, or every bucket holding a job
    # of the entitled class (strict head-rank ties without a policy)
    if forced is not None:
        contenders = [forced]
    elif fairness is not None:
        contenders = [b for b in order
                      if any(j.priority == lead.priority
                             for j in groups[b])]
    else:
        lead_rank = PRIORITIES.get(lead.priority, PRIORITIES["normal"])
        contenders = [b for b in order
                      if PRIORITIES.get(groups[b][0].priority,
                                        PRIORITIES["normal"]) <= lead_rank]

    # 3. score: priced throughput, fill, lead urgency
    cands: List[dict] = []
    for b in contenders:
        g = groups[b]
        width = width_policy.choose(len(g))
        picked = g[:width]
        p99_ms = None
        source = None
        if pricer is not None:
            priced = pricer.price(b, width=width)
            if priced is not None:
                p99_ms, source = priced
        wall = p99_ms * max(j.steps for j in picked) if p99_ms else None
        cands.append({
            "bucket": b, "label": bucket_label(b), "width": width,
            "picked": picked, "p99_ms": p99_ms, "priced_from": source,
            "throughput": (len(picked) / wall) if wall else 0.0,
            "fill": len(picked) / float(width),
        })

    def urgency(c):
        j = c["picked"][0]
        return (fairness.queue_key(j, now) if fairness is not None
                else j.order_key())

    cands.sort(key=lambda c: (-c["throughput"], -c["fill"], urgency(c),
                              c["label"]))
    best = cands[0]

    # 4. deadline slack veto
    if len(cands) > 1:
        wall = _slot_wall_ms(best)
        if wall is not None:
            for c in cands[1:]:
                s_wait = _tightest_slack_ms(c, wall)
                if s_wait is None or s_wait >= 0:
                    continue
                c_wall = _slot_wall_ms(c)
                s_best = _tightest_slack_ms(best, c_wall or 0.0)
                if s_best is None or s_best >= 0:
                    best = c
                    reason = "deadline-slack"
                    break

    for j in best["picked"]:
        queue.remove(j)
        if fairness is not None:
            fairness.charge(j.priority)
    table = [{"label": c["label"], "width": c["width"],
              "jobs": len(c["picked"]), "p99_ms": c["p99_ms"],
              "throughput": c["throughput"], "fill": c["fill"]}
             for c in cands]
    return SlotPlan(bucket=best["bucket"], width=best["width"],
                    picked=best["picked"], reason=reason,
                    lead=lead.tid, candidates=table)
