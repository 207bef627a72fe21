"""The LIVE priority queue and the deadline-sorted slot packer.

The port's counterpart of ``stencil_tpu.serve.queue``. The batch driver's queue is a deque fixed at launch; this one grows
while slots run. It keeps the driver's backfill protocol — iteration
and ``remove`` — so ``CampaignDriver``'s backfill closure pulls from it
unchanged, but its iteration ORDER is the serving policy: priority
class, then deadline (tightest first), then admission order. Because
the queue holds only unscheduled jobs, priority reordering can only
ever affect QUEUED tenants — a running lane is structurally
unpreemptable.

:func:`pick_serve_slot` is :func:`~..campaign.driver.pick_slot`'s
serving twin: the head (most urgent job) names the bucket, same-bucket
jobs fill the slot in queue order — deadline-sorted bucket packing. It
removes the picked jobs IN PLACE so the queue object stays live for
mid-slot backfill.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

from .intake import ServeJob


class ServeQueue:
    """A small always-sorted job list (serving queues are tens of jobs;
    sort-on-access keeps every scan trivially in policy order).

    With no ``policy`` the order is :meth:`ServeJob.order_key` — strict
    priority. A :class:`~.fairness.FairnessPolicy` makes
    the order TIME-DEPENDENT (aged rank decays while a job waits), so
    the queue re-sorts on access rather than only on admit; admission
    also stamps ``job.admit_t``, the aging clock's zero."""

    def __init__(self, policy=None):
        self._items: List[ServeJob] = []
        self._policy = policy

    def _sort(self, now=None) -> None:
        if self._policy is not None:
            self._items.sort(
                key=lambda j: self._policy.queue_key(j, now))
        else:
            self._items.sort(key=ServeJob.order_key)

    def admit(self, job: ServeJob) -> None:
        if self._policy is not None and job.admit_t is None:
            job.admit_t = self._policy.clock()
        self._items.append(job)
        self._sort()

    def remove(self, job: ServeJob) -> None:
        self._items.remove(job)

    def peek(self) -> ServeJob:
        if not self._items:
            raise RuntimeError("peek on an empty serve queue")
        self._sort()
        return self._items[0]

    def jobs(self, now=None) -> List[ServeJob]:
        self._sort(now)
        return list(self._items)

    def __iter__(self) -> Iterator[ServeJob]:
        return iter(self.jobs())

    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)


def pick_serve_slot(queue: ServeQueue,
                    slot_size: int) -> Tuple[Tuple, List[ServeJob]]:
    """Pop the next slot's jobs from the LIVE queue: the most urgent
    job's bucket, same-bucket jobs pulled in queue order (priority,
    deadline, arrival) until the slot fills. Returns ``(bucket,
    picked)``; the queue keeps everything else."""
    bucket = queue.peek().bucket()
    picked = [j for j in queue if j.bucket() == bucket][:slot_size]
    for j in picked:
        queue.remove(j)
    return bucket, picked
