"""jacobi3d — 7-point Jacobi heat diffusion on one GPU.

``run(..., partition=(px, py, pz))`` splits the domain into a partition,
uniform or uneven (trailing blocks one cell smaller where the count does
not divide an axis), with every block on the one GPU (as in the JAX app,
the CLI has no flag for it). ``run(..., devices=[...])`` (CLI ``--devices
cuda:0,cuda:0,...``) runs a mesh of one block position per entry, repeats
allowed (the reference's ``set_gpus({0,0})``), weak-scaled by their number
as in the JAX app, by any method, AXIS_COMPOSED by default as in the JAX
app: the overlap step (one sweep of every position on the pre-exchange
state, the exchange by copies between positions, one launch of every
position's shells), without overlap the exchange of the multi-position
axes and a sweep, with ``deep_halo`` >= 2 one multistep launch over every
position a pass; DIRECT26 (``--direct26``) the exchange and one sweep a
step; REMOTE_DMA the remote-dma exchange and one sweep, with
``kernel_variant="fused"`` one fused step launch per step over every
position, with ``"persistent"`` one chunk launch per ``deep_halo`` steps.
Under ``apps/launch_multiprocess`` each rank steps its own positions, every
method and variant included (one launch per rank over its positions); rank
0 prints the row, with the method run. A device count such as 6 at
``--no-weak`` splits 512^3 unevenly, (3,2,1) with x blocks of 171/171/170:
every method and variant runs it (AXIS_COMPOSED by the JAX package's
dynamic-shell step, fused by the host-orchestrated schedule, as in the JAX
package; persistent by the chunk kernel's uneven form).

The port's counterpart of ``stencil_tpu.apps.jacobi3d`` (reference:
bin/jacobi3d.cu): a hot and a cold sphere fixed in a periodic box,
6-neighbour averaging, and a one-line CSV result:

  jacobi3d,<method>,<processes>,<devices>,<x>,<y>,<z>,<exchBytes>,<minIter>,<trimeanIter>

The iteration schedule is the JAX app's: one warm-up chunk that advances the
state, then chunks of ``chunk`` steps (a short last chunk keeps the total at
``iters``), each timed on the host clock up to a device synchronize; the
per-iteration statistic is each chunk's mean, trimean'd over chunks.

The loop runs under the fault layer's guarded engine (``fault.run_guarded``):
per chunk, step -> injection -> health check -> checkpoint, and a numerical
fault rolls back to the newest valid snapshot with backoff
(``--health-every``, ``--max-abs``, ``--max-rollbacks``,
``--rollback-backoff``, ``--inject`` or ``STENCIL_FAULT_INJECT``); ``main``
exits 43 (``FAULT_RC``) with an evidence file when recovery gives up.
``--ckpt-dir`` / ``--ckpt-every`` / ``--ckpt-keep`` write snapshots in the JAX
package's format (asynchronously; the final state at ``iters`` always) and
``--resume`` continues from the newest one. One schedule (``chunk_plan``,
broken at checkpoint, health and injection steps) drives warm-up and the
timed loop. Warm-up runs each chunk size of the schedule from both orders
of the two buffers and puts the state back
(``ops/jacobi.warm_jacobi_loops``), so no timed chunk uploads a kernel
table; without a checkpoint dir one chunk then advances the state, as in
the JAX app, and with one nothing does, so a checkpointed run is
step-exact. ``STENCIL_CKPT_KILL_AFTER_SAVE=K`` kills the
run (rc 17) right after the first snapshot at a step >= K is durable.

Usage: python -m stencil_tpu_torch.apps.jacobi3d --x 512 --y 512 --z 512 --iters 5
(``--device cpu`` runs the plain PyTorch versions of the kernels on the CPU).
``--direct26`` exchanges by the reference's 26 per-direction messages
(``--method`` overrides it), then sweeps every block in one launch.
``--multistep-rows R`` is the JAX app's strip height of the multistep: on
the card the multistep kernel's tile height, so only the height its depth
is built for is accepted. ``--prefix P`` writes the domain's plan files
(``P``plan_0.txt, ``P``mat_npy_loadtxt.txt) at realize.
``--method remote-dma`` with ``--kernel-variant fused`` (or ``--fused``) runs
one fused step kernel per step; ``--kernel-variant persistent --deep-halo K``
runs one whole-chunk kernel per K steps over radius-K halos. ``--wire-dtype
bfloat16`` (or ``float16``, or any fp8 or fp4 format the JAX package takes,
``ops/halo_fill.WIRE_FORMATS``) narrows the halo messages that cross
between mesh positions, in the plain and the fused mesh paths (a no-op on
one device; the persistent variant over a mesh refuses it).

The planner and the live layer, as in the JAX app: ``--autotune`` (with
``--plan-db PATH``) tunes the exchange plan at realize() over the run's
device or ``--devices`` positions (``plan/autotune.py``: a DB hit replays
with zero probes), and the loops are built from the plan applied, so a tuned
fused choice steps by the fused kernel. ``--metrics-out`` records telemetry,
ending with the exchange's attribution (``plan.attrib.phase``, phase
``jacobi.exchange``) and the plan's ``plan.fingerprint``.
``--live-sentinel`` (``--live-config``) judges each chunk's step latency,
``--status-file`` rewrites a snapshot every chunk, and ``--replan`` (with the
sentinel; ``--replan-probe`` probes the re-tune) hot-swaps the plan between
chunks through ``DistributedDomain.replan`` when the sentinel requests it.

``--paraview`` writes the JAX app's ParaView dumps under ``--prefix``
(``DistributedDomain.write_paraview``): ``jacobi3d_init`` and
``jacobi3d_final``, and with ``--paraview-every N`` (which makes the chunk
one step unless ``chunk`` is given) ``jacobi3d_<step>`` every N steps.
"""

from __future__ import annotations

import argparse
import math
import os
import time
from typing import Optional

import torch

from ..api import DistributedDomain
from ..fault import (FAULT_RC, FaultPlan, HealthGuard, RecoveryExhausted, RecoveryPolicy,
                     chunk_plan, run_guarded)
from ..geometry import Dim3, prime_factors
from ..obs import telemetry
from ..ops.halo_fill import WIRE_FORMATS
from ..ops.jacobi import INIT_TEMP, make_jacobi_loop, sphere_sel_blocks, warm_jacobi_loops
from ..parallel import distributed
from ..parallel.exchange import Method
from ..utils import logging as log
from ..utils import timer
from ..utils.statistics import Statistics
from ..utils.sync import hard_sync


def weak_scale(x: int, y: int, z: int, num_subdomains: int) -> Dim3:
    """Grow the domain to keep points/subdomain constant: multiply prime
    factors of N into the smallest axis (reference: bin/jacobi3d.cu:190-205)."""
    for pf in prime_factors(num_subdomains):
        if x <= y and x <= z:
            x *= pf
        elif y <= z:
            y *= pf
        else:
            z *= pf
    return Dim3(x, y, z)


def run(
    x: int,
    y: int,
    z: int,
    iters: int = 5,
    overlap: bool = True,
    method: Method = Method.AXIS_COMPOSED,
    device=None,
    weak: bool = True,
    warmup: int = 1,
    chunk: Optional[int] = None,
    deep_halo: int = 1,
    fused: bool = False,
    kernel_variant: Optional[str] = None,
    partition=None,
    devices=None,
    wire_dtype: Optional[str] = None,
    dtype: str = "float32",
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    ckpt_keep: int = 3,
    resume: bool = False,
    health_every: int = 0,
    max_abs: Optional[float] = None,
    max_rollbacks: int = 3,
    rollback_backoff: float = 0.25,
    inject: Optional[str] = None,
    prefix: str = "",
    paraview: bool = False,
    paraview_every: int = -1,
    multistep_rows: Optional[int] = None,
    autotune: bool = False,
    plan_db: Optional[str] = None,
    sentinel=None,
    status=None,
    replan: bool = False,
    replan_probe: bool = False,
) -> dict:
    """Run jacobi3d on one device and return the result row (plus the
    realized ``domain`` and the temperature ``handle``).

    ``partition`` (blocks along x, y, z; default one block) splits the
    domain into a partition, uniform or uneven, whose blocks all sit on
    the device.
    ``overlap`` picks the multi-block step's structure (and lets the
    multistep engage there); on a single block every axis wraps inside the
    kernels and no exchange runs, so there is nothing to overlap.
    ``deep_halo`` realizes radius-``deep_halo`` halos (full radius, not
    tight-x, as the JAX app does off the TPU) and, when >= 2, caps the
    multistep depth (or pins the persistent chunk depth) at it.
    ``kernel_variant`` ("fused" or "persistent"; ``fused=True`` is the
    older spelling of the former) selects a ``Method.REMOTE_DMA`` kernel
    variant, as in the JAX app. ``devices`` (a list of torch devices,
    which may repeat one card) runs a mesh of that many block positions,
    one block each (``DistributedDomain.set_devices``), and grows the
    domain by their number when ``weak``; it takes any method (a kernel
    variant with ``Method.REMOTE_DMA``). ``wire_dtype`` narrows the halo
    messages crossing between positions (``DistributedDomain.set_wire_dtype``).
    ``dtype`` ("float32" or "float64") is the temperature field's type: a
    float64 field steps through the kernels' float64 forms on every path
    but the fused and persistent variants, which are float32 as in the JAX
    package (no CLI flag: the JAX app steps float32).

    The guarded loop (see the module docstring): ``health_every`` (0 = off)
    and ``max_abs`` set the health check, ``max_rollbacks`` and
    ``rollback_backoff`` the recovery policy, ``inject`` the fault
    schedule (default: the ``STENCIL_FAULT_INJECT`` env var);
    ``ckpt_dir`` with ``ckpt_every`` (0 = only the final state) and
    ``ckpt_keep`` the snapshots, ``resume`` the restart from the newest
    one. Raises :class:`~stencil_tpu_torch.fault.RecoveryExhausted` when
    recovery gives up. ``prefix`` (``DistributedDomain.set_output_prefix``)
    makes realize() write the domain's plan files under it, and names the
    ParaView dumps: ``paraview`` writes ``{prefix}jacobi3d_init`` and
    ``{prefix}jacobi3d_final``, and with ``paraview_every`` > 0 also
    ``{prefix}jacobi3d_<step>`` every that many steps (one-step chunks
    unless ``chunk`` is given), as the JAX app does;
    ``multistep_rows`` goes to ``make_jacobi_loop``.

    ``autotune`` tunes the exchange plan at realize() (``plan_db`` the plan
    DB), over ``devices`` or the one device; the row's method and kernel
    variant are then the tuned plan's. ``sentinel`` (``obs/live.
    LiveSentinel``) and ``status`` (``obs/status.StatusWriter``) go to the
    guarded loop; ``replan`` (with a sentinel) hot-swaps the plan when the
    sentinel requests it, re-tuning through ``plan_db`` statically, or with
    probes under ``replan_probe``. With the recorder enabled the run ends
    with the exchange's attribution and the plan's fingerprint."""
    if fused and kernel_variant is None:
        kernel_variant = "fused"
    if kernel_variant == "fused":
        fused = True
    elif kernel_variant == "persistent" and deep_halo < 2:
        raise ValueError(
            "kernel_variant='persistent' is the whole-chunk temporal "
            "fusion: it needs --deep-halo >= 2 (the chunk depth k; the "
            "domain realizes radius*k halos)")
    elif kernel_variant not in (None, "fused", "persistent"):
        raise ValueError(
            f"unknown kernel_variant {kernel_variant!r}: valid values are "
            "'fused' and 'persistent'")
    if devices is not None and device is not None:
        raise ValueError("pass device= or devices=, not both")
    procs = distributed.process_count()
    if devices is None and device is None and procs > 1:
        devices = distributed.default_positions()
    devices = list(devices) if devices is not None else None
    # positions of the run: every process's (a collective across processes)
    n = distributed.position_count(len(devices) if devices else 1)
    size = weak_scale(x, y, z, n) if weak else Dim3(x, y, z)
    dd = DistributedDomain(size.x, size.y, size.z,
                           device=devices[0] if devices else device)
    if devices:
        dd.set_devices(devices)
    dd.set_radius(deep_halo)
    dd.set_methods(method)
    dd.set_fused_exchange(fused)
    dd.set_persistent_exchange(kernel_variant == "persistent")
    if wire_dtype:
        dd.set_wire_dtype(wire_dtype)
    if partition is not None:
        dd.set_partition(partition)
    if prefix:
        dd.set_output_prefix(prefix)
    if autotune:
        # partition x method x batching x variant from the DB or by probes;
        # an explicit partition still wins (realize() warns)
        dd.enable_autotune(db_path=plan_db)
    h = dd.add_data("temperature", dtype)
    dd.realize()
    dev = dd.device
    if dd.plan_choice is not None:
        # the tuned plan labels the row, and its variant picks the loops
        method = dd._method
        kernel_variant = dd.plan_choice.kernel_variant
    rec = telemetry.get()

    # init: uniform lukewarm field (reference: bin/jacobi3d.cu:18-27)
    with rec.span("jacobi.init", phase="init"):
        init = dd.get_curr(h)
        if dd.mesh is None:
            init.fill_(INIT_TEMP)
        else:
            for b in init:
                if b is not None:  # None: another process's position
                    b.fill_(INIT_TEMP)
        sel = sphere_sel_blocks(dd.spec, dd.mesh or dev)

    if paraview:
        dd.write_paraview(prefix + "jacobi3d_init")

    # checkpoint/restart: a resume replaces the fresh init with the newest
    # valid snapshot's state, elastically (another partition or package)
    start = 0
    if ckpt_dir and resume:
        from ._bench_common import resume_from_checkpoint

        start = resume_from_checkpoint(dd, ckpt_dir, iters)
    kill_after = int(os.environ.get("STENCIL_CKPT_KILL_AFTER_SAVE", "-1") or -1)

    def save_ckpt(step: int, state) -> None:
        dd.set_curr(h, state)
        dd.save_checkpoint(ckpt_dir, step, keep=ckpt_keep)
        if 0 <= kill_after <= step:
            # the injected-kill hook: die hard right after this snapshot is
            # durable; the revival must continue from it, not from step 0
            dd.finish_checkpoints()
            log.warn(f"STENCIL_CKPT_KILL_AFTER_SAVE: dying after step {step}")
            os._exit(17)

    curr, nxt = dd.get_curr(h), dd.get_next(h)
    stepwise = paraview and paraview_every > 0
    if chunk is None:
        chunk = 1 if stepwise else min(iters, 10)
    chunk = min(chunk, iters)
    tk = deep_halo if deep_halo >= 2 else None
    loops = {}

    def get_loop(k: int):
        if k not in loops:
            loops[k] = make_jacobi_loop(dd.halo_exchange, k, overlap=overlap, temporal_k=tk,
                                        multistep_rows=multistep_rows)
        return loops[k]

    guard = HealthGuard(every=health_every, max_abs=max_abs) if health_every > 0 else None
    injector = FaultPlan.from_spec(inject)

    # the exact chunk sizes the loop will run (checkpoint and health
    # boundaries clamp them; injections land at their exact step): one
    # schedule drives warm-up and the timed loop
    def plan_fn(s: int):
        return chunk_plan(s, iters, chunk,
                          every=(ckpt_every if (ckpt_dir and ckpt_every > 0) else 0,
                                 health_every if guard is not None else 0),
                          at=injector.steps() if injector is not None else ())

    with rec.span("jacobi.warmup", phase="compile", iters=warmup * chunk):
        if warmup:
            # each distinct chunk size of the schedule from both buffer
            # orders on the state's own buffers (the kernels' tables are
            # kept by address), the state put back
            warm_jacobi_loops(get_loop, dict.fromkeys(plan_fn(start)), curr, nxt, sel)
        if not ckpt_dir:
            # then warm-up advances the state, as in the JAX app; a
            # checkpointed run is step-exact (save at k, resume, continue to
            # n == an uninterrupted run to n), so it never advances here
            loop = get_loop(chunk)
            for _ in range(warmup):
                curr, nxt = loop(curr, nxt, sel)
        hard_sync(dev)

    # the loop writes in place and swaps (curr, scratch): each chunk's
    # result is the state, its other buffer the next scratch; a rollback
    # hands back a restored curr and the scratch stays
    iter_time = Statistics()

    def step_fn(st, k):
        nonlocal nxt
        with timer.trace_range("jacobi.chunk"):
            c, nxt = get_loop(k)(st["temperature"], nxt, sel)
            hard_sync(dev)
        return {"temperature": c}

    def on_chunk(st, k, per, done_now):
        iter_time.insert(per)
        rec.emit("span", "jacobi.iter", phase="step", seconds=per, iters=k)
        if stepwise and done_now % paraview_every == 0:
            dd.set_curr(h, st["temperature"])
            dd.write_paraview(f"{prefix}jacobi3d_{done_now}")

    save_fn = restore_fn = quarantine_fn = flush_fn = None
    if ckpt_dir:
        if ckpt_every > 0:
            save_fn = lambda s, st: save_ckpt(s, st["temperature"])  # noqa: E731
        flush_fn = dd.flush_checkpoints

        def restore_fn():
            s = dd.restore_checkpoint(ckpt_dir)
            return None if s is None else (s, {"temperature": dd.get_curr(h)})

        def quarantine_fn(s):
            from ..ckpt import quarantine_snapshot, snapshot_name

            quarantine_snapshot(ckpt_dir, snapshot_name(s),
                                reason="restored state failed health check")

    # the mid-run hot-swap: the sentinel's replan.requested latches the
    # controller, which re-tunes and installs the new plan between chunks
    # through DistributedDomain.replan (bit for bit); the loops are rebuilt
    # from the plan installed
    controller = None
    if replan and sentinel is None:
        log.warn("--replan needs --live-sentinel (replan.requested is the trigger); ignoring")
    elif replan:
        from ..plan.ir import PlanChoice, PlanConfig
        from ..plan.replan import ReplanController

        def retune_fn():
            from ..plan.autotune import autotune as _plan_autotune

            return _plan_autotune(dd.size, dd.radius, [dtype], devices=devices or [dev],
                                  db_path=plan_db, probe=replan_probe, force=True).choice

        def apply_replan(choice, st):
            nonlocal sel, nxt
            dd.set_curr(h, st["temperature"])
            dd.replan(choice)
            loops.clear()  # the old plan's loops are stale
            sel = sphere_sel_blocks(dd.spec, dd.mesh or dev)
            nxt = dd.get_next(h)
            return {"temperature": dd.get_curr(h)}

        controller = ReplanController(
            retune_fn, apply_replan, sentinel=sentinel,
            current_choice=PlanChoice.from_json(dd.plan_meta()["choice"]),
            config=PlanConfig.make(dd.size, dd.radius, [dtype], n, dev.type))
        sentinel.on_replan = controller.request

    loop_t0 = time.perf_counter()
    state, done = run_guarded(
        {"temperature": curr}, start=start, iters=iters, plan_fn=plan_fn, step_fn=step_fn,
        guard=guard, injector=injector,
        policy=RecoveryPolicy(max_rollbacks=max_rollbacks, backoff_s=rollback_backoff),
        save_fn=save_fn, ckpt_every=ckpt_every, restore_fn=restore_fn,
        quarantine_fn=quarantine_fn, flush_fn=flush_fn, on_chunk=on_chunk, spec=dd.spec,
        ckpt_dir=ckpt_dir, app="jacobi3d", sentinel=sentinel, status=status,
        replan=controller)
    # the whole loop's wall clock, including what the per-chunk times leave
    # out: health checks, saves, injected faults, backoff and rollbacks
    loop_wall_s = time.perf_counter() - loop_t0
    curr = state["temperature"]
    if controller is not None and controller.swaps:
        # the row describes the plan that finished the run
        method = dd._method
        kernel_variant = dd.plan_choice.kernel_variant
    if ckpt_dir:
        if done > start or start == 0:
            # the final state is always durable (step == iters)
            save_ckpt(iters, curr)
        # a resume past the end ran nothing: the durable snapshot already
        # covers this run, and is never re-labelled as step `iters`
        dd.finish_checkpoints()
    dd.set_curr(h, curr)
    dd.set_next(h, nxt)
    if paraview:
        dd.write_paraview(prefix + "jacobi3d_final")
    if rec.enabled:
        attribute_exchange(dd, h, chunk, rec, devices or [dev])

    if iter_time.count() == 0:
        log.info(f"resume found step {start} >= iters {iters}; no timed work")
        iter_time.insert(float("inf"))
    cells = size.flatten()
    trimean = iter_time.trimean()
    if rec.enabled:
        # the JAX app's closing records, under its names
        rec.gauge("jacobi.loop_wall_s", loop_wall_s, phase="step", unit="s")
        rec.gauge("jacobi.mcells_per_s", cells / trimean / 1e6, phase="step")
        rec.gauge("jacobi.mcells_per_s_per_dev", cells / trimean / 1e6 / n, phase="step")
        if math.isfinite(trimean):  # inf would serialize as non-strict JSON
            rec.gauge("jacobi.iter_trimean_s", trimean, phase="step", unit="s")
        rec.counter("jacobi.exchange_bytes", bytes=dd.exchange_bytes_for_method(method),
                    phase="exchange", method=method.value)
    return {
        "app": "jacobi3d",
        "method": method.value,
        "processes": procs,
        "devices": n,
        "device_list": ([str(d) for d in dd.mesh.devices] if dd.mesh is not None
                        else [str(dev)]),
        "x": size.x,
        "y": size.y,
        "z": size.z,
        "exchange_bytes": dd.exchange_bytes_for_method(method),
        "iter_min_s": iter_time.min(),
        "iter_trimean_s": trimean,
        "mcells_per_s": cells / trimean / 1e6,
        "mcells_per_s_per_dev": cells / trimean / 1e6 / n,
        "overlap": overlap,
        "temporal_k": get_loop(chunk).temporal_k,
        "kernel_variant": kernel_variant,
        "loop_wall_s": loop_wall_s,
        "health_checks": guard.checks if guard is not None else 0,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "domain": dd,
        "handle": h,
    }


def attribute_exchange(dd, h, chunk: int, rec, devices) -> None:
    """The run's epilogue under a recorder: time the exchange alone on the
    final state (3 samples of up to 10 back-to-back exchanges; an exchange
    leaves exchanged data as it is), record each against the cost model's
    prediction for the applied plan (``plan.attrib.phase``, phase
    ``jacobi.exchange``, priced by the tuned calibration when there is one)
    and the plan's ``plan.fingerprint``."""
    from ..obs import attribution
    from ..plan.ir import PlanChoice, PlanConfig
    from .machine_info import fabric_fingerprint

    state = {h.idx: dd.get_curr(h)}
    n_ex = max(1, min(chunk, 10))
    exch_loop = dd.halo_exchange.make_loop(n_ex)
    with rec.span("jacobi.exchange_warmup", phase="compile"):
        exch_loop(state)
        hard_sync(dd.device)
    samples = []
    for _ in range(3):
        t0 = time.perf_counter()
        exch_loop(state)
        hard_sync(dd.device)
        per = (time.perf_counter() - t0) / n_ex
        samples.append(per)
        rec.emit("span", "jacobi.exchange", phase="exchange", seconds=per, iters=n_ex)
    pm = dd.plan_meta()
    choice = PlanChoice.from_json(pm["choice"])
    config = PlanConfig.from_json(pm["key"])
    tuned = dd.autotune_result
    attribution.attribute_and_judge(
        rec, config, choice, samples, phase="jacobi.exchange",
        calibration=tuned.calibration if tuned is not None else None,
        kernel_variant=choice.kernel_variant,
        fabric=fabric_fingerprint(devices=devices))
    from ..plan.cost import default_provenance

    rec.meta("plan.fingerprint", fingerprint=choice.fingerprint(), choice=choice.label(),
             calibration=(tuned.calibration_provenance if tuned is not None
                          else default_provenance(config.platform)))


def csv_row(r: dict) -> str:
    return (
        f"jacobi3d,{r['method']},{r['processes']},{r['devices']},"
        f"{r['x']},{r['y']},{r['z']},{r['exchange_bytes']},"
        f"{r['iter_min_s']:.6f},{r['iter_trimean_s']:.6f}"
    )


def add_guard_flags(p: argparse.ArgumentParser) -> None:
    """The checkpoint, health and fault-injection flags of jacobi3d and
    astaroth, as in the JAX apps."""
    p.add_argument("--ckpt-dir", type=str, default="",
                   help="write checkpoint snapshots here (per-block npz + manifest, "
                        "crash-safe; the JAX package's format)")
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="checkpoint every N steps (0 = only the final state; needs --ckpt-dir)")
    p.add_argument("--ckpt-keep", type=int, default=3,
                   help="retention: keep the newest N snapshots")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest valid snapshot under --ckpt-dir when one "
                        "exists (fresh start otherwise)")
    p.add_argument("--health-every", type=int, default=0,
                   help="numerical health check every N steps (one kernel launch on the "
                        "card); a fault rolls back to the newest valid snapshot (0 = off)")
    p.add_argument("--max-abs", type=float, default=0.0,
                   help="with --health-every, also fault when any quantity's max|u| "
                        "exceeds this ceiling (0 = no ceiling)")
    p.add_argument("--max-rollbacks", type=int, default=3,
                   help="rollbacks allowed per faulting step before the run exits 43 "
                        "with a fault-evidence.json bundle")
    p.add_argument("--rollback-backoff", type=float, default=0.25,
                   help="first-retry backoff seconds (doubles per repeated fault)")
    p.add_argument("--inject", type=str, default="",
                   help="deterministic fault injection, e.g. 'nan@3,crash@5:rc=7' "
                        "(fault/inject.py; default: the STENCIL_FAULT_INJECT env var)")


def guard_kwargs(args) -> dict:
    """``run`` keyword arguments of the flags :func:`add_guard_flags` adds."""
    return dict(ckpt_dir=args.ckpt_dir or None, ckpt_every=args.ckpt_every,
                ckpt_keep=args.ckpt_keep, resume=args.resume,
                health_every=args.health_every, max_abs=args.max_abs or None,
                max_rollbacks=args.max_rollbacks, rollback_backoff=args.rollback_backoff,
                inject=args.inject or None)


def main(argv: Optional[list] = None) -> int:
    # a launch of several processes (apps/launch_multiprocess) joins its group
    distributed.maybe_init_from_env()
    p = argparse.ArgumentParser(description="3D Jacobi heat diffusion (one GPU)")
    p.add_argument("--x", type=int, default=512)
    p.add_argument("--y", type=int, default=512)
    p.add_argument("--z", type=int, default=512)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--no-overlap", action="store_true",
                   help="disable interior/exterior overlap (no effect on one block)")
    p.add_argument("--no-weak", action="store_true", help="fixed total domain (strong)")
    p.add_argument("--deep-halo", type=int, default=1,
                   help="realize radius-K halos; K >= 2 also pins the "
                        "multistep depth (or the persistent chunk depth) to K")
    p.add_argument("--direct26", action="store_true", help="use 26 per-direction messages")
    p.add_argument("--method", choices=[m.value for m in Method], default=None,
                   help="exchange strategy (default axis-composed; overrides --direct26)")
    p.add_argument("--fused", action="store_true",
                   help="the fused compute+exchange variant of --method "
                        "remote-dma: one kernel per step hands off every "
                        "direction's halo and sweeps")
    p.add_argument("--kernel-variant", choices=["fused", "persistent"], default=None,
                   help="remote-dma kernel variant: 'fused' = --fused; "
                        "'persistent' = one kernel per k-step chunk over "
                        "radius-k halos, k = --deep-halo (>= 2 required)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the current CUDA device; "
                        "'cpu' runs the plain PyTorch versions)")
    p.add_argument("--devices", type=str, default=None,
                   help="comma list of torch devices, one block position each, "
                        "repeats allowed (e.g. cuda:0,cuda:0); any method")
    p.add_argument("--wire-dtype", type=str, default="",
                   help="on-the-wire halo compression, one of "
                        f"{', '.join(WIRE_FORMATS)} (float32 narrows float64 "
                        "data only): wire-crossing exchange carriers narrow to "
                        "this format (LOSSY — halos round to the wire precision)")
    p.add_argument("--prefix", type=str, default="",
                   help="prefix of the files the run writes: the domain's plan files "
                        "(plan_0.txt, mat_npy_loadtxt.txt) at realize and the ParaView "
                        "dumps")
    p.add_argument("--paraview", action="store_true",
                   help="write ParaView dumps of the initial and final state")
    p.add_argument("--paraview-every", type=int, default=-1,
                   help="with --paraview, also dump every N iterations")
    p.add_argument("--multistep-rows", type=int, default=None,
                   help="the multistep's strip height: on the card its tile height, so only "
                        "a height the kernel is built for at the chosen depth is accepted "
                        "(a warning when the multistep does not engage)")
    p.add_argument("--autotune", action="store_true",
                   help="choose the exchange plan (partition x method x quantity batching x "
                        "kernel variant) with the plan/ autotuner: a plan-DB hit replays with "
                        "zero probes, a miss probes the top static candidates")
    p.add_argument("--plan-db", type=str, default="",
                   help="on-disk plan DB (JSON) for --autotune and --replan")
    p.add_argument("--replan", action="store_true",
                   help="mid-run plan hot-swap (needs --live-sentinel): on replan.requested "
                        "the plan is re-tuned and installed between chunks "
                        "(replan.applied / replan.rejected records)")
    p.add_argument("--replan-probe", action="store_true",
                   help="with --replan, refine the re-tune with measured probes "
                        "(default: static ranking only)")
    add_guard_flags(p)
    from ._bench_common import (add_live_flags, add_metrics_flags, canonicalize_live_config,
                                finish_live, finish_metrics, make_live, start_metrics)

    add_live_flags(p)
    add_metrics_flags(p)
    args = p.parse_args(argv)
    try:
        canonicalize_live_config(args)
    except (OSError, ValueError) as e:
        p.error(f"bad --live-config: {e}")
    if args.fused and args.kernel_variant == "persistent":
        p.error("--fused conflicts with --kernel-variant persistent "
                "(mutually exclusive kernel variants)")
    if args.device and args.devices:
        p.error("--device conflicts with --devices")
    rec = start_metrics(args, "jacobi3d")
    sentinel, status = make_live(args, rec, "jacobi3d")
    try:
        r = run(args.x, args.y, args.z, iters=args.iters, overlap=not args.no_overlap,
                method=Method(args.method) if args.method
                else (Method.DIRECT26 if args.direct26 else Method.AXIS_COMPOSED),
                device=args.device, weak=not args.no_weak, deep_halo=args.deep_halo,
                fused=args.fused, kernel_variant=args.kernel_variant,
                devices=args.devices.split(",") if args.devices else None,
                wire_dtype=args.wire_dtype or None, prefix=args.prefix,
                paraview=args.paraview, paraview_every=args.paraview_every,
                multistep_rows=args.multistep_rows, autotune=args.autotune,
                plan_db=args.plan_db or None, sentinel=sentinel, status=status,
                replan=args.replan, replan_probe=args.replan_probe, **guard_kwargs(args))
    except RecoveryExhausted as e:
        # the evidence bundle is on disk; the distinct rc tells a revival
        # ladder "numerics broken" from a crash
        log.error(f"jacobi3d: {e}")
        finish_live(rec, sentinel, status, outcome="fault")
        finish_metrics(rec)
        return FAULT_RC
    finish_live(rec, sentinel, status, outcome="done")
    finish_metrics(rec)
    if distributed.process_index() == 0:
        print(csv_row(r))
    log.info(f"mcells/s = {r['mcells_per_s']:.1f} ({r['mcells_per_s_per_dev']:.1f}/device) "
             f"on {r['device']}, kernel variant {r['kernel_variant']}, k={r['temporal_k']}")
    log.info(timer.report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
