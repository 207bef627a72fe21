"""serve — the always-on campaign serving daemon on one GPU.

The port's counterpart of ``stencil_tpu.apps.serve``, the CLI over
``stencil_tpu_torch/serve/``: point it at a ``--serve-dir`` and it serves
until drained. Producers drop job JSONs into ``<serve-dir>/jobs/incoming/``
(atomically: a tmp file, then a rename; ``apps/serve_loadgen.py`` is the
reference producer), the daemon admits them against per-tenant ``--quota``
and ledger-priced deadlines, packs batch slots through the capacity engine
(stride-weighted fairness with aging, scored cross-bucket packing, elastic
slot width over ``--slot-min``/``--slot-max``, priced chunk-boundary
preemption; each defeatable with ``--no-fairness`` / ``--no-packing`` /
``--no-preempt``, fixed width by default), backfills retired lanes from the
live queue mid-slot, and streams each result into
``<serve-dir>/results/<job>.json`` the moment the tenant retires. Jacobi and
Astaroth jobs are served (the campaign's workloads); on the card their
slots step through the hand-written kernels, on ``--device cpu`` through
their plain versions.

Lifecycle:

- **SIGTERM** drains gracefully: intake stops, live lanes park as revivable
  snapshots at the next segment boundary, the queue persists to
  ``serve-state.json``, the daemon exits 0.
- **SIGKILL / crash** loses nothing: restart the same command and the
  daemon revives every admitted-but-unserved job from ``serve-state.json``
  (running jobs resume from their newest snapshot), never re-runs a retired
  job, and quarantines replayed job files as duplicates.
  ``STENCIL_SERVE_KILL_AFTER_RETIRE=N`` dies with rc 17 after the Nth
  retirement, to prove it.
- ``--max-idle-s`` / ``--max-wall-s`` bound a run; 0 means serve until
  drained.

``--device`` takes the place of the JAX app's ``--cpu N``: a slot lives on
one device. ``--replan``, ``--plan-db`` and the live-observability flags
(``--status-file``, ``--live-sentinel``, ``--live-config``) raise until
``plan/replan``, ``obs/status`` and ``obs/live`` are ported (ROADMAP.md
queue A item 4).

Usage: python -m stencil_tpu_torch.apps.serve --serve-dir /srv/stencil \\
           --slot 4 --quota 2 --max-idle-s 30 --metrics-out serve.jsonl
(``--device cpu`` serves on the CPU.)
"""

from __future__ import annotations

import argparse
import json
import os
import signal
from typing import Optional

from ..obs import telemetry
from ..utils import logging as log

# the kill hook: after the Nth tenant retires (serve-state.json durable, the
# result streamed) die hard with rc 17 (the checkpoint kill hook's rc:
# "killed on purpose, revive me")
KILL_ENV = "STENCIL_SERVE_KILL_AFTER_RETIRE"


def parse_weights(spec: str) -> dict:
    """``--fair-weights`` as ``{class: weight}`` (``CLASS=WEIGHT`` commas);
    raises ValueError on a malformed entry."""
    weights = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad --fair-weights entry {part!r} (want CLASS=WEIGHT)")
        k, v = part.split("=", 1)
        weights[k.strip()] = float(v)
    return weights


def build_scheduler(args, weights: dict):
    from ..serve import ServeScheduler

    return ServeScheduler(
        args.serve_dir, args.slot,
        quota=args.quota, admission_ledger=args.admission_ledger or None,
        poll_s=args.poll_s, max_idle_s=args.max_idle_s, max_wall_s=args.max_wall_s,
        slot_min=args.slot_min or None, slot_max=args.slot_max or None,
        packing=not args.no_packing, preempt=not args.no_preempt,
        fairness=not args.no_fairness, fair_weights=weights or None,
        aging_s=args.aging_s, preempt_cost_chunks=args.preempt_cost_chunks,
        device=args.device, chunk=args.chunk,
        ckpt_every=args.ckpt_every, ckpt_keep=args.ckpt_keep,
        health_every=args.health_every, max_abs=args.max_abs or None,
        max_rollbacks=args.max_rollbacks, rollback_backoff=args.rollback_backoff)


def install_kill_hook(sched) -> None:
    """Arm the kill hook when the env var names a retirement count."""
    kill_after = int(os.environ.get(KILL_ENV, "0") or 0)
    if kill_after <= 0:
        return
    orig = sched._on_result

    def killing(r):
        orig(r)
        if sched._retired_run >= kill_after:
            log.warn(f"{KILL_ENV}: dying after {sched._retired_run} retirement(s)")
            os._exit(17)

    sched._on_result = killing


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="always-on campaign serving daemon (one GPU)")
    p.add_argument("--serve-dir", required=True,
                   help="service root: jobs/{incoming,claimed,bad}, campaign/ (slots + "
                        "tenant snapshots), results/, serve-state.json")
    p.add_argument("--slot", type=int, default=4,
                   help="batch-slot size B (lanes per program); with --slot-min/--slot-max "
                        "only the elastic ladder's default")
    p.add_argument("--slot-min", type=int, default=0,
                   help="elastic width floor: each slot is sized to its bucket's queue depth "
                        "on a power-of-two ladder from --slot-min to --slot-max (0 = --slot, "
                        "i.e. fixed width)")
    p.add_argument("--slot-max", type=int, default=0,
                   help="elastic width ceiling; a mid-slot surge grows the running slot at a "
                        "chunk boundary (park, re-form, revive; bit-identical) (0 = --slot)")
    p.add_argument("--fair-weights", default="",
                   help="served-share weights as CLASS=WEIGHT commas, e.g. "
                        "'high=8,normal=4,low=1' (the default)")
    p.add_argument("--aging-s", type=float, default=30.0,
                   help="seconds of queue wait that promote a job one priority class; a job "
                        "waiting past aging_s*(rank+1) leads the next slot outright (0 = no "
                        "aging)")
    p.add_argument("--no-fairness", action="store_true",
                   help="strict priority order: no weighted shares, no aging")
    p.add_argument("--no-packing", action="store_true",
                   help="head-of-queue bucket selection instead of the scored cross-bucket "
                        "packing pass")
    p.add_argument("--no-preempt", action="store_true",
                   help="never park a running slot for an infeasible high arrival")
    p.add_argument("--preempt-cost-chunks", type=float, default=1.0,
                   help="priced resume cost per victim, in chunks of its bucket's p99; "
                        "preemption (and mid-slot growth) fires only when the priced gain "
                        "exceeds it")
    p.add_argument("--chunk", type=int, default=2, help="steps per guarded chunk")
    p.add_argument("--quota", type=int, default=0,
                   help="per-tenant cap on live (queued+running) jobs; an over-quota job is "
                        "DEFERRED and promoted when one of the tenant's jobs retires "
                        "(0 = unlimited)")
    p.add_argument("--admission-ledger", default="",
                   help="performance ledger (obs/ledger.py) seeding per-bucket p99 deadline "
                        "pricing; the daemon appends its own serve.step_p99_ms entries back "
                        "at exit")
    p.add_argument("--poll-s", type=float, default=0.2, help="idle intake poll interval")
    p.add_argument("--max-idle-s", type=float, default=0.0,
                   help="exit after this long with an empty queue (0 = serve until drained)")
    p.add_argument("--max-wall-s", type=float, default=0.0,
                   help="total wall budget; reaching it drains gracefully (0 = unbounded)")
    p.add_argument("--ckpt-every", type=int, default=2,
                   help="checkpoint every active lane every N slot steps, the revival "
                        "substrate (0 = only final/park snapshots)")
    p.add_argument("--ckpt-keep", type=int, default=3)
    p.add_argument("--health-every", type=int, default=0,
                   help="per-lane health-check cadence in slot steps (default: every chunk)")
    p.add_argument("--max-abs", type=float, default=0.0,
                   help="divergence ceiling on max|u| (0 = none)")
    p.add_argument("--max-rollbacks", type=int, default=2)
    p.add_argument("--rollback-backoff", type=float, default=0.05)
    p.add_argument("--replan", action="store_true",
                   help="between-slot plan hot-swap (not ported yet: raises)")
    p.add_argument("--plan-db", default="",
                   help="plan DB the --replan re-tune persists into (not ported yet: raises)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of the slots (default: the current CUDA device; 'cpu' "
                        "runs the plain versions)")
    p.add_argument("--metrics-out", default="",
                   help="append the run's telemetry records (JSON lines) to this file")
    p.add_argument("--run-id", default="", help="telemetry run id (default: generated)")
    p.add_argument("--status-file", default="",
                   help="atomic run-status snapshot (not ported yet: raises)")
    p.add_argument("--live-sentinel", action="store_true",
                   help="in-run anomaly detection (not ported yet: raises)")
    p.add_argument("--live-config", default="",
                   help="sentinel knobs as JSON (not ported yet: raises)")
    return p


def main(argv: Optional[list] = None) -> int:
    p = parser()
    args = p.parse_args(argv)
    unported = [f for f, on in (("--replan", args.replan), ("--plan-db", args.plan_db),
                                ("--status-file", args.status_file),
                                ("--live-sentinel", args.live_sentinel),
                                ("--live-config", args.live_config)) if on]
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: the plan hot-swap, status file and live sentinel are not "
            "ported yet (ROADMAP.md queue A item 4)")
    try:
        weights = parse_weights(args.fair_weights)
    except ValueError as e:
        p.error(str(e))
    rec = telemetry.configure(metrics_out=args.metrics_out or None, app="serve",
                              run_id=args.run_id or None, config=vars(args))
    sched = build_scheduler(args, weights)
    install_kill_hook(sched)
    # SIGTERM = drain: stop claiming, park lanes at the next segment
    # boundary, persist the queue, exit 0
    signal.signal(signal.SIGTERM, lambda signum, frame: sched.request_drain("sigterm"))

    summary = sched.serve()
    out = {"app": "serve", "serve_dir": args.serve_dir, "slot": args.slot,
           "quota": args.quota, "devices": 1, "device": str(sched.device)}
    out.update({k: v for k, v in summary.items() if k != "results"})
    if isinstance(out.get("tenants_per_hour"), float):
        out["tenants_per_hour"] = round(out["tenants_per_hour"], 3)
    print(json.dumps(out, default=str))
    rec.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
