"""campaign — multi-tenant batched serving of many small domains on one GPU.

The port's counterpart of ``stencil_tpu.apps.campaign``: queue N tenant jobs
(independent periodic boxes of one ``--workload``: jacobi heat, or 8-field
Astaroth MHD; seeded per-tenant initial fields), serve
them in fixed-size batch slots under one program per shape bucket
(``--mode batched``), one at a time through the single-domain machinery
(``--mode sequential``), or both back to back with the ratio and an optional
bit-parity check (``--mode ab``).

Prints ONE JSON summary line (aggregate Mcells/s, p50/p99 per-tenant step
latency, evictions, compile-cache hits) and records the same as gauges when
``--metrics-out`` is set.

Fault handling rides the driver: ``--inject nan@3:tenant=t1:repeat=always``
drives one tenant to the rc-43 ``fault`` outcome. It is evicted (its lane
backfilled from the queue) while its siblings keep stepping, and its
evidence bundle and last healthy snapshot land under
``<campaign-dir>/tenants/t1/``; ``--resume`` on the same ``--campaign-dir``
revives it.

Usage: python -m stencil_tpu_torch.apps.campaign --tenants 64 --slot 64 \\
           --size 32 --steps 6 --chunk 3 --mode ab --check-parity
(``--device cpu`` runs the kernels' plain versions on the CPU; ``--dtype
float64`` steps float64 tenants, on the card through the kernels' float64
forms; ``--workload astaroth`` serves ``--mode batched`` only, as in the JAX
app: its sequential baseline is a B=1 slot through the driver).

On the card the kernels are built (or loaded) before anything is timed:
the line's ``build_s`` is that set-up, and no mode's step times hold it.

The live layer rides the batched driver, as in the JAX app:
``--live-sentinel`` (``--live-config``) judges each slot's chunk latencies
per shape bucket, ``--status-file`` rewrites the lane table and SLO
verdicts every chunk, and ``--replan`` (with the sentinel and a
``--plan-db``) re-tunes the bucket's exchange plan statically at the next
slot boundary when the sentinel requests it and stores it in the DB: the
slot programs are bucket-keyed, so the swap is the DB install.

The JAX app's ``--use-pallas`` is not ported: here the device decides (the
card runs the hand-written kernels, the CPU the plain versions). ``--cpu``
gives way to ``--device``.
"""

from __future__ import annotations

import argparse
import json
import math
import tempfile
import time
from typing import Optional

from ..api import resolve_device
from ..campaign import CampaignDriver, CompileCache, TenantJob, run_sequential
from ..obs import telemetry
from ..ops import _native
from ..utils import logging as log


def _finite_gauge(rec, name: str, value: float, **tags) -> None:
    if value is not None and math.isfinite(value):
        rec.gauge(name, value, **tags)


def _round6(value: float):
    """None for a non-finite sample, so the summary line stays strict JSON."""
    return round(value, 6) if math.isfinite(value) else None


def parse_deadlines(spec: str) -> dict:
    """``--deadline-ms`` grammar: a bare number applies to every tenant
    (``"50"``), comma-separated ``tid=ms`` pairs pin individual tenants
    (``"t1=0.5,t3=100"``); ``*=ms`` mixes a default with overrides. Raises
    ValueError on anything else."""
    out: dict = {}
    if not spec:
        return out
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if "=" in item:
            tid, ms = item.split("=", 1)
            out[tid.strip()] = float(ms)
        else:
            out["*"] = float(item)
    for tid, ms in out.items():
        if not math.isfinite(ms) or ms <= 0:
            raise ValueError(f"deadline for {tid!r} must be a positive "
                             f"finite number of ms, got {ms!r}")
    return out


def build_jobs(args) -> list:
    deadlines = parse_deadlines(args.deadline_ms)
    return [
        TenantJob(f"t{i}", (args.size, args.size, args.size), args.steps,
                  args.dtype, seed=args.init_seed + i, workload=args.workload,
                  deadline_ms=deadlines.get(f"t{i}", deadlines.get("*")))
        for i in range(args.tenants)
    ]


def build_kernels(device) -> float:
    """Build (or load) every hand-written kernel for ``device`` before any
    mode is timed; returns the seconds it took (0 on the CPU, which runs the
    plain versions). Without it the first timed chunk of the first mode
    would hold the nvcc build."""
    if resolve_device(device).type != "cuda":
        return 0.0
    t0 = time.perf_counter()
    _native.lib("jacobi_sweep")  # builds and loads every library of csrc/
    return time.perf_counter() - t0


def run_modes(args, campaign_dir: str, sentinel=None, status=None) -> dict:
    """Run the modes ``args.mode`` names, the kernel build first and on its
    own (``build_s``); returns the summary line's dict, with the driver
    summaries under ``"_sequential"`` and ``"_batched"`` (left out of the
    printed line). ``sentinel`` and ``status`` ride the batched driver;
    ``args.replan`` (with a sentinel) swaps plans between its slots."""
    jobs = build_jobs(args)
    rec = telemetry.get()
    out: dict = {
        "app": "campaign", "mode": args.mode, "tenants": args.tenants,
        "slot": args.slot, "size": args.size, "steps": args.steps,
        "dtype": args.dtype, "workload": args.workload, "devices": 1,
        "campaign_dir": campaign_dir,
        "build_s": round(build_kernels(args.device), 3),
    }

    seq = None
    if args.mode in ("sequential", "ab"):
        seq = run_sequential(jobs, device=args.device, chunk=args.chunk)
        out["sequential_mcells_per_s"] = round(seq["aggregate_mcells_per_s"], 3)
        out["sequential_p50_step_s"] = _round6(seq["p50_step_s"])
        out["sequential_p99_step_s"] = _round6(seq["p99_step_s"])
        _finite_gauge(rec, "campaign.sequential_mcells_per_s",
                      seq["aggregate_mcells_per_s"], phase="step")
        _finite_gauge(rec, "campaign.sequential_p50_step_s", seq["p50_step_s"],
                      phase="step", unit="s")
        _finite_gauge(rec, "campaign.sequential_p99_step_s", seq["p99_step_s"],
                      phase="step", unit="s")
        out["_sequential"] = seq

    bat = None
    if args.mode in ("batched", "ab"):
        controller = None
        if getattr(args, "replan", False) and sentinel is not None:
            controller = slot_replan(args, sentinel)
        elif getattr(args, "replan", False):
            log.warn("campaign: --replan needs --live-sentinel; ignoring")
        drv = CampaignDriver(
            jobs, args.slot, campaign_dir, device=args.device, chunk=args.chunk,
            ckpt_every=args.ckpt_every, ckpt_keep=args.ckpt_keep,
            health_every=args.health_every, max_abs=args.max_abs or None,
            max_rollbacks=args.max_rollbacks, rollback_backoff=args.rollback_backoff,
            inject=args.inject or None, inject_seed=args.inject_seed,
            resume=args.resume, cache=CompileCache(), sentinel=sentinel, status=status,
            replan=controller)
        bat = drv.run()
        if controller is not None:
            out["replans_applied"] = controller.swaps
            out["replans_rejected"] = controller.rejected
        out["batched_mcells_per_s"] = round(bat["aggregate_mcells_per_s"], 3)
        out["batched_p50_step_s"] = _round6(bat["p50_step_s"])
        out["batched_p99_step_s"] = _round6(bat["p99_step_s"])
        out["slots"] = bat["slots"]
        out["evicted"] = bat["evicted"]
        out["slo_violations"] = bat["slo_violations"]
        out["anomalies"] = bat["anomalies"]
        out["cache"] = bat["cache"]
        _finite_gauge(rec, "campaign.batched_mcells_per_s",
                      bat["aggregate_mcells_per_s"], phase="step")
        _finite_gauge(rec, "campaign.batched_p50_step_s", bat["p50_step_s"],
                      phase="step", unit="s")
        _finite_gauge(rec, "campaign.batched_p99_step_s", bat["p99_step_s"],
                      phase="step", unit="s")
        out["_batched"] = bat

    if args.mode == "ab":
        ratio = (bat["aggregate_mcells_per_s"] / seq["aggregate_mcells_per_s"]
                 if seq["aggregate_mcells_per_s"] > 0 else 0.0)
        out["batched_over_sequential"] = round(ratio, 3)
        _finite_gauge(rec, "campaign.batched_over_sequential", ratio, phase="step")
        if args.check_parity:
            mismatches = []
            for tid, br in bat["results"].items():
                if br.outcome != "done":
                    continue  # evicted tenants diverge by construction
                sr = seq["results"].get(tid)
                if sr is None or sr.final.tobytes() != br.final.tobytes():
                    mismatches.append(tid)
            out["parity"] = "ok" if not mismatches else "MISMATCH"
            out["parity_mismatches"] = mismatches
            if mismatches:
                log.error(f"campaign: batched results differ from sequential for "
                          f"{mismatches}")
    return out


def slot_replan(args, sentinel):
    """The campaign's between-slot swap: a latched ``replan.requested``
    re-tunes the bucket's exchange-plan config (statically, with
    ``force=True``: a slot must not stall on probes) and stores it in
    ``--plan-db``, where every later plan consumer replays it. The slot
    programs are bucket-keyed, so the apply is the DB install."""
    from ..campaign.driver import WORKLOADS
    from ..geometry import Dim3, Radius
    from ..plan.replan import ReplanController

    wl = WORKLOADS[args.workload]
    nq = len(wl.quantity_names(args.dtype))
    device = resolve_device(args.device)

    def retune_fn():
        from ..plan.autotune import autotune

        return autotune(Dim3(args.size, args.size, args.size),
                        Radius.constant(wl.default_radius), [args.dtype] * nq,
                        devices=[device], db_path=args.plan_db or None, probe=False,
                        force=True).choice

    controller = ReplanController(retune_fn, lambda choice, st: None, sentinel=sentinel)
    sentinel.on_replan = controller.request
    return controller


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="multi-tenant batched campaign driver (one GPU)")
    p.add_argument("--tenants", type=int, default=8, help="number of queued tenant jobs")
    p.add_argument("--slot", type=int, default=4,
                   help="batch-slot size B: tenants stepped together (padded with dead "
                        "tenants when the queue drains)")
    p.add_argument("--size", type=int, default=16, help="per-tenant cubic domain edge")
    p.add_argument("--steps", type=int, default=6, help="steps per tenant")
    p.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    p.add_argument("--workload", choices=["jacobi", "astaroth"], default="jacobi",
                   help="tenant physics: jacobi (single-quantity heat) or astaroth (8-field "
                        "MHD through the batched RK3 step); astaroth serves --mode batched "
                        "only (its sequential baseline is a B=1 slot)")
    p.add_argument("--chunk", type=int, default=2, help="steps per guarded chunk")
    p.add_argument("--mode", choices=["batched", "sequential", "ab"], default="batched",
                   help="ab = sequential baseline then batched, with their ratio")
    p.add_argument("--check-parity", action="store_true",
                   help="(ab) exit 1 unless every completed tenant's final field is "
                        "bit-identical between modes")
    p.add_argument("--campaign-dir", default="",
                   help="per-tenant durable state root (default: a fresh temp dir)")
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="checkpoint every active lane every N slot steps (0 = only "
                        "final/eviction snapshots)")
    p.add_argument("--ckpt-keep", type=int, default=3)
    p.add_argument("--resume", action="store_true",
                   help="pack tenants from their newest valid snapshot (revives "
                        "evicted tenants)")
    p.add_argument("--health-every", type=int, default=0,
                   help="per-lane health-check cadence in slot steps (default: every "
                        "chunk)")
    p.add_argument("--max-abs", type=float, default=0.0,
                   help="divergence ceiling on max|u| (0 = none)")
    p.add_argument("--max-rollbacks", type=int, default=2,
                   help="rollbacks per faulting step before the tenant is EVICTED with "
                        "the rc-43 evidence bundle")
    p.add_argument("--rollback-backoff", type=float, default=0.05)
    p.add_argument("--inject", default="",
                   help="per-tenant fault spec, e.g. 'nan@3:tenant=t1:repeat=always'")
    p.add_argument("--inject-seed", type=int, default=0)
    p.add_argument("--init-seed", type=int, default=0,
                   help="tenant i's initial field is seeded init-seed + i")
    p.add_argument("--deadline-ms", default="",
                   help="per-step latency SLO: a bare number for all tenants, 'tid=ms' "
                        "pairs for individuals ('t1=0.5,t3=100')")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the current CUDA device; 'cpu' runs the "
                        "plain versions)")
    p.add_argument("--metrics-out", default="",
                   help="append the run's telemetry records (JSON lines) to this file")
    p.add_argument("--replan", action="store_true",
                   help="between-slot plan hot-swap (needs --live-sentinel, batched/ab "
                        "mode): a latched replan.requested re-tunes the bucket's exchange "
                        "plan at the next slot boundary and stores it in --plan-db "
                        "(replan.applied / replan.rejected records)")
    p.add_argument("--plan-db", default="", help="plan DB the --replan re-tune stores into")
    from ._bench_common import add_live_flags

    add_live_flags(p)
    return p


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    """The CLI's arguments, validated (``--deadline-ms`` must parse and name
    known tenants)."""
    p = parser()
    args = p.parse_args(argv)
    try:
        deadlines = parse_deadlines(args.deadline_ms)
    except ValueError as e:
        p.error(f"bad --deadline-ms: {e}")
    if args.workload == "astaroth" and args.mode != "batched":
        p.error("--workload astaroth serves --mode batched only (the sequential baseline "
                "is a B=1 slot through the driver)")
    unknown = sorted(set(deadlines) - {f"t{i}" for i in range(args.tenants)} - {"*"})
    if unknown:
        p.error(f"--deadline-ms names unknown tenant(s) {unknown} "
                f"(tenants are t0..t{args.tenants - 1})")
    if args.mode == "sequential":
        # the live layer rides the guarded batched driver
        if args.live_sentinel:
            p.error("--live-sentinel rides the batched driver; --mode sequential runs "
                    "outside it (use batched or ab)")
        if args.replan:
            p.error("--replan swaps plans at slot boundaries of the batched driver; --mode "
                    "sequential has none (use batched or ab)")
        if args.status_file:
            log.warn("campaign: --status-file/STENCIL_STATUS_FILE is ignored in --mode "
                     "sequential (status snapshots ride the guarded batched driver)")
            args.status_file = ""
    if args.replan and not args.plan_db:
        p.error("--replan stores the re-tuned plan into --plan-db; pass one (the swap "
                "would otherwise install nothing)")
    from ._bench_common import canonicalize_live_config

    try:
        canonicalize_live_config(args)
    except (OSError, ValueError) as e:
        p.error(f"bad --live-config: {e}")
    return args


def main(argv: Optional[list] = None) -> int:
    from ._bench_common import finish_live, make_live

    args = parse_args(argv)
    rec = telemetry.configure(metrics_out=args.metrics_out or None, app="campaign",
                              config=vars(args))
    sentinel, status = make_live(args, rec, "campaign")
    campaign_dir = args.campaign_dir or tempfile.mkdtemp(prefix="campaign-")
    out = run_modes(args, campaign_dir, sentinel=sentinel, status=status)
    print(json.dumps({k: v for k, v in out.items() if not k.startswith("_")}, default=str))
    # gauge=False: the driver's run() recorded live.anomaly_count
    finish_live(rec, sentinel, status, outcome="done", gauge=False)
    telemetry.get().close()
    return 1 if out.get("parity") == "MISMATCH" else 0


if __name__ == "__main__":
    raise SystemExit(main())
