"""Admission control: quotas, priority classes, priced deadline rejection.

The port's counterpart of ``stencil_tpu.serve.admission``, priced from the
port's ledger (``obs/ledger``, the JAX package's file format). Three verdicts, in judgment order:

- **reject** — the job's per-step ``deadline_ms`` is infeasible against
  the bucket's known p99 step latency. The pricing comes from the
  :class:`BucketPricer`: ONLINE samples once the daemon has stepped the
  bucket (the driver's per-chunk wall times), seeded from the
  performance LEDGER's per-bucket entries before that (metric
  ``serve.step_p99_ms``, ``detail.bucket`` keyed — the daemon writes
  them back at drain, so pricing survives restarts). A rejection always
  NAMES its price and source. No price -> no rejection: admission never
  guesses.
- **defer** — the owning tenant is at its quota of live (queued +
  running) jobs. Quota exhaustion QUEUES, it never rejects: the job
  waits in a holding pen and is promoted the moment one of the
  tenant's jobs retires.
- **admit** — into the LIVE priority queue.

Priority classes reorder only QUEUED jobs (the queue's order key); a
running lane is never preempted — structurally, because admission and
the queue only ever see unscheduled jobs.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

from ..obs import ledger as ledger_mod
from ..utils.statistics import percentile
from .intake import ServeJob

# the ledger metric carrying a bucket's p99 per-step latency prior
# (milliseconds); detail.bucket holds the bucket label
LEDGER_METRIC = "serve.step_p99_ms"


def bucket_label(bucket) -> str:
    """``(size, dtype, workload) -> "16x16x16/float32/jacobi"`` — the
    human- and ledger-facing bucket key."""
    (size, dtype, workload) = bucket
    x, y, z = size
    return f"{x}x{y}x{z}/{dtype}/{workload}"


class BucketPricer:
    """Per-bucket p99 step latency: online samples first, ledger priors
    until the daemon has its own evidence.

    Rows are keyed ``(bucket_label, width | None)``: every observation
    lands in the bucket AGGREGATE (width None) and, when the slot width
    is known, in a per-width row — elastic slots honestly cost more per
    step at larger B, and the pricer must stop pricing a B=64 slot with
    B=8 p99s. ``price(bucket, width=W)`` answers from the most specific
    row it has (online W, online aggregate, ledger W, ledger
    aggregate); both granularities write back to the ledger at drain
    (``detail.width`` marks the per-width rows)."""

    def __init__(self, ledger_path: Optional[str] = None, *,
                 window: int = 256, min_samples: int = 3):
        self.ledger_path = ledger_path or None
        self.window = int(window)
        self.min_samples = max(1, int(min_samples))
        self._online: Dict[Tuple[str, Optional[int]], deque] = {}
        self._prior: Dict[Tuple[str, Optional[int]],
                          Tuple[float, str, float]] = {}
        if self.ledger_path:
            # a corrupt ledger raises (LedgerError is a ValueError):
            # silently pricing from nothing would admit infeasible work
            for e in ledger_mod.load_ledger(self.ledger_path):
                if e.get("metric") != LEDGER_METRIC:
                    continue
                det = e.get("detail") or {}
                b = det.get("bucket")
                if not isinstance(b, str):
                    continue
                w = det.get("width")
                k = (b, int(w) if isinstance(w, int) else None)
                prev = self._prior.get(k)
                if prev is None or e.get("t", 0) >= prev[2]:
                    self._prior[k] = (
                        float(e["value"]),
                        f"ledger {self.ledger_path} [{e.get('label')}]",
                        e.get("t", 0))

    def observe(self, bucket, per_step_s: float, *,
                width: Optional[int] = None) -> None:
        """One chunk's per-step wall time for ``bucket`` (seconds),
        optionally attributed to the slot width that produced it."""
        label = bucket_label(bucket)
        keys = [(label, None)]
        if width:
            keys.append((label, int(width)))
        for k in keys:
            self._online.setdefault(
                k, deque(maxlen=self.window)).append(float(per_step_s))

    def price(self, bucket, *,
              width: Optional[int] = None) -> Optional[Tuple[float, str]]:
        """``(p99_ms, source)`` for the bucket (most width-specific row
        first), or None (unknown — the daemon has never stepped the
        shape and the ledger is silent)."""
        label = bucket_label(bucket)
        keys = ([(label, int(width)), (label, None)] if width
                else [(label, None)])
        for k in keys:
            samples = self._online.get(k)
            if samples and len(samples) >= self.min_samples:
                at = f" at B={k[1]}" if k[1] else ""
                return (percentile(samples, 99) * 1e3,
                        f"online p99 over {len(samples)} chunks{at}")
        for k in keys:
            prior = self._prior.get(k)
            if prior is not None:
                return (prior[0], prior[1])
        return None

    def ledger_entries(self, *, platform: str, label: str,
                       device: Optional[str] = None) -> List[dict]:
        """One ledger entry per online-priced (bucket, width) row —
        appended at drain so the NEXT daemon prices admission (and
        widths) before its first step. ``device`` (the card's name)
        joins each entry's detail, never its config fingerprint."""
        out = []
        for (b, w), samples in sorted(
                self._online.items(),
                key=lambda kv: (kv[0][0], kv[0][1] or 0)):
            if len(samples) < self.min_samples:
                continue
            det = {"bucket": b, "samples": len(samples)}
            if device:
                det["device"] = device
            cfg = {"bucket": b}
            if w is not None:
                det["width"] = w
                cfg["width"] = w
            out.append(ledger_mod.make_entry(
                LEDGER_METRIC, percentile(samples, 99) * 1e3,
                label=label, unit="ms", platform=platform, source="serve",
                config=cfg, detail=det))
        return out


class AdmissionController:
    """The verdict function. ``quota`` is the per-tenant cap on LIVE
    (queued + running) jobs; 0 = unlimited."""

    def __init__(self, *, quota: int = 0,
                 pricer: Optional[BucketPricer] = None):
        if quota < 0:
            raise ValueError(f"quota must be >= 0, got {quota}")
        self.quota = int(quota)
        self.pricer = pricer

    def decide(self, job: ServeJob, live_by_owner: Dict[str, int], *,
               width_hint: Optional[int] = None) -> Tuple[str, str]:
        """``("admit" | "defer" | "reject", reason)``. Infeasibility is
        judged before quota — a doomed job must not occupy a quota
        slot waiting to be doomed. ``width_hint`` is the slot width the
        scheduler would run the job at (elastic daemons price the B the
        job will actually see, not the aggregate)."""
        if job.deadline_ms is not None and self.pricer is not None:
            priced = self.pricer.price(job.bucket(), width=width_hint)
            if priced is not None:
                p99_ms, source = priced
                if float(job.deadline_ms) < p99_ms:
                    return ("reject",
                            f"deadline {job.deadline_ms:g} ms infeasible: "
                            f"bucket {bucket_label(job.bucket())} p99 is "
                            f"{p99_ms:.4g} ms ({source})")
        if self.quota and live_by_owner.get(job.owner, 0) >= self.quota:
            return ("defer",
                    f"tenant {job.owner} at quota "
                    f"({live_by_owner.get(job.owner, 0)}/{self.quota} "
                    "live jobs); queued for promotion")
        return ("admit", "")
