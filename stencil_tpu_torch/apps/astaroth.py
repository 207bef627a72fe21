"""astaroth — the MHD mini-app on one GPU, weak-scaled over resident blocks
or over a mesh of block positions.

The port's counterpart of ``stencil_tpu.apps.astaroth`` (reference:
astaroth/astaroth.cu): 8 fields in double precision (the reference's type;
``--f32`` for single), radius-3 halos, per iteration one exchange and 3 RK3
substeps, buffers swapped per iteration, dt = 1e-8. Init: hash-random
everything, constant 0.5 lnrho, radial-explosion velocity
(astaroth.cu:493-520). Output row as in the reference (astaroth.cu:672-679):

  <processes>,<nx>,<ny>,<nz>,<iter trimean s>,<exch trimean s>

``run(partition=(px, py, pz))`` (no CLI flag, as in jacobi3d) weak-scales
the run as the JAX app does over its devices (``decompose_zyx(len(devices))``,
``stencil_tpu/apps/astaroth.py:127-137``): the global size is the conf's
extents times the partition, and every block of it is resident on the one
GPU, so ``partition=(2, 2, 2)`` is the JAX app's 8-device run (and
``(1, 1, 2)``, ``(1, 2, 2)`` its 2- and 4-device runs). The processes
column reports the block count, as the JAX app's 8-device row reports 8;
nx/ny/nz stay the conf's per-block extents.

``run(devices=[...], method=Method.REMOTE_DMA)`` (CLI ``--devices
cuda:0,cuda:0,...``, which takes REMOTE_DMA) is the JAX app's multi-device
run itself: the conf's extents times ``decompose_zyx(len(devices))``, one
block a position of a mesh that may name one card several times (the
reference's ``set_gpus({0,0})``), exchanged by B6 over the 8 fields and
stepped by the substep's positions form, every position in one launch a
stage (``astaroth/integrate.py``). Its row is the JAX app's for the same
device count: ``devices`` counts the positions, ``processes`` is 1 (one
process drives them, as ``jax.process_count()`` on the JAX app's host), and
the CSV's first column is the device count, as the JAX app's. The
reductions run over every position's block; the guarded engine's flags run
over the mesh state, as jacobi3d's do.

The schedule is the JAX app's: one untimed warm-up chunk that advances the
state, then chunks of ``chunk`` iterations (``iters`` rounded up to a chunk
multiple), each timed on the host clock up to a device synchronize. The
exchange share is timed as the JAX app times its fused path: a standalone
``exchange_loop(1)`` after every chunk (one exchange per iteration; 3 with
``swap_per_substep``), which leaves exchanged fields unchanged.

The 8 fields are the guarded state of jacobi3d's engine
(``fault.run_guarded``; the same ``--ckpt-*``, ``--resume``,
``--health-every``, ``--max-abs``, ``--max-rollbacks``,
``--rollback-backoff`` and ``--inject`` flags; exit 43 when recovery gives
up). As in the JAX app the engine runs when a health check or an injection
is configured (its schedule is ``chunk_plan``, broken at checkpoint, health
and injection steps); otherwise the fixed-chunk loop runs, saving at the
first chunk end past each ``ckpt_every`` multiple. The final state is
always saved with a checkpoint dir, and warm-up then runs on copies.

Usage: python -m stencil_tpu_torch.apps.astaroth 10 [--nx 256] [--f32]
[--devices cuda:0,cuda:0] (``--device cpu --nx 16`` runs the plain PyTorch
versions on the CPU, ``--devices cpu,cpu --nx 16`` a mesh of them).

``--per-quantity-exchange`` turns quantity batching off
(``DistributedDomain.set_quantity_batching``): every field's slabs move on
their own instead of one packed carrier for the 8 fields; the cells are the
same. ``--kernel-variant shift|ring`` names the TPU substep kernel's
sliding-window discipline; both give the same bits there, and the port's one
substep kernel serves both (the run's row records the choice).
``--no-pallas`` asks for the unfused substep path: on the CPU that is the
path that runs (the plain PyTorch version), and on the card the port has
none, so it raises rather than fall back.

``--autotune`` (with ``--plan-db PATH``) tunes the 8-field exchange's plan
at realize() as the JAX app does (``plan/autotune.py``: on one device over
AXIS_COMPOSED, DIRECT26 and REMOTE_DMA with quantity batching on and off,
over ``--devices`` positions over REMOTE_DMA's partitions and variants; a
DB hit replays with zero probes); the step is built on the plan applied.

Not carried over yet (ROADMAP.md): positions on distinct GPUs (a mesh
names one card), ``--trivial`` / ``--random`` placement and the ParaView
dumps. Non-periodic boundaries are ``astaroth.boundconds``, which the app
never calls, as in the JAX package and the reference.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch

from ..api import DistributedDomain, resolve_device
from ..astaroth.config import load_config
from ..astaroth.init import const_init, hash_init, radial_explosion_init
from ..astaroth.integrate import FIELDS, make_astaroth_step
from ..astaroth.reductions import Reductions
from ..fault import (FAULT_RC, FaultPlan, HealthGuard, RecoveryExhausted, RecoveryPolicy,
                     chunk_plan, run_guarded)
from ..geometry import Dim3, prime_factors
from ..parallel import Method
from ..utils import logging as log
from ..utils import timer
from ..utils.statistics import Statistics
from ..utils.sync import hard_sync
from .jacobi3d import add_guard_flags, guard_kwargs

DEFAULT_CONF = os.path.join(os.path.dirname(__file__), "..", "astaroth", "astaroth.conf")


def decompose_zyx(p: int) -> Dim3:
    """Split device count over axes, z first (reference: astaroth.cu:263-276)."""
    x = y = z = 1
    for pf in prime_factors(p):
        if z <= y and z <= x:
            z *= pf
        elif y <= x:
            y *= pf
        else:
            x *= pf
    return Dim3(x, y, z)


def init_fields(dd: DistributedDomain, handles: dict, info, dtype: str) -> None:
    """The reference init (astaroth.cu:493-520) into the domain's curr
    tensors: hash-random entropy and vector potential, constant 0.5 lnrho,
    radial-explosion velocity."""
    size = dd.size
    np_dtype = np.dtype(dtype)
    ds = (info.real_params["AC_dsx"], info.real_params["AC_dsy"],
          info.real_params["AC_dsz"])
    h = hash_init(size, dtype=np_dtype)  # coordinate-determined, same per field
    for name in ("entropy", "ax", "ay", "az"):
        dd.set_curr_global(handles[name], h)
    dd.set_curr_global(handles["lnrho"], const_init(size, 0.5, dtype=np_dtype))
    uux, uuy, uuz = radial_explosion_init(size, ds=ds, dtype=np_dtype)
    dd.set_curr_global(handles["uux"], uux)
    dd.set_curr_global(handles["uuy"], uuy)
    dd.set_curr_global(handles["uuz"], uuz)


KERNEL_VARIANTS = ("shift", "ring")


def make_domain(info, dtype: str = "float64", device=None, partition=None,
                batch_quantities: bool = True, devices=None, method=Method.AXIS_COMPOSED,
                autotune: bool = False, plan_db: Optional[str] = None):
    """A realized domain with the 8 fields at radius 3, initialised as the
    reference does; returns ``(dd, handles)``. Its size is the config's
    extents times ``partition`` (blocks along x, y, z, all resident on one
    GPU; default one block), or with ``devices`` times
    ``decompose_zyx(len(devices))``, one block a position of a mesh over
    them; ``batch_quantities`` as ``DistributedDomain.set_quantity_batching``,
    ``method`` as ``set_methods``; ``autotune`` (``plan_db``) as
    ``enable_autotune``, whose tuned plan then owns the method, batching
    and partition (an explicit ``partition`` still wins, with a warning)."""
    if devices is not None and (device is not None or partition is not None):
        raise ValueError("pass devices= alone, not with device= or partition=")
    devices = list(devices) if devices is not None else None
    if devices:
        d3 = decompose_zyx(len(devices))
    else:
        d3 = Dim3.of(partition) if partition is not None else decompose_zyx(1)
    size = Dim3(info.int_params["AC_nx"] * d3.x, info.int_params["AC_ny"] * d3.y,
                info.int_params["AC_nz"] * d3.z)
    dd = DistributedDomain(size.x, size.y, size.z,
                           device=devices[0] if devices else device)
    dd.set_radius(3)
    dd.set_methods(method)
    if devices:
        dd.set_devices(devices)
    elif d3.flatten() > 1:
        dd.set_partition(d3)
    dd.set_quantity_batching(batch_quantities)
    if autotune:
        dd.enable_autotune(db_path=plan_db)
    handles = {name: dd.add_data(name, dtype) for name in FIELDS}
    dd.realize()
    init_fields(dd, handles, info, dtype)
    return dd, handles


def load(conf: str = DEFAULT_CONF, nx: Optional[int] = None):
    """The config, with ``nx`` (when given) overriding AC_n{x,y,z}."""
    info, ok = load_config(conf)
    if not ok:
        log.debug(f"config has uninitialized values: {info.uninitialized()[:5]}")
    if nx is not None:
        info.int_params["AC_nx"] = info.int_params["AC_ny"] = info.int_params["AC_nz"] = nx
        info.update_builtin_params()
    return info


def run(
    iters: int = 10,
    conf: str = DEFAULT_CONF,
    nx: Optional[int] = None,
    dtype: str = "float64",
    no_compute: bool = False,
    overlap: bool = True,
    swap_per_substep: bool = False,
    reductions: bool = False,
    dt: float = 1e-8,
    chunk: int = 1,
    device=None,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    ckpt_keep: int = 3,
    resume: bool = False,
    health_every: int = 0,
    max_abs: Optional[float] = None,
    max_rollbacks: int = 3,
    rollback_backoff: float = 0.25,
    inject: Optional[str] = None,
    partition=None,
    batch_quantities: bool = True,
    kernel_variant: Optional[str] = None,
    use_pallas: Optional[bool] = None,
    devices=None,
    method: Method = Method.AXIS_COMPOSED,
    autotune: bool = False,
    plan_db: Optional[str] = None,
) -> dict:
    """Run ``iters`` iterations (plus one untimed warm-up chunk) and return
    the timing row, the domain and its handles. ``partition`` (blocks
    along x, y, z) weak-scales the conf's extents over that many resident
    blocks on one device; ``devices`` (torch devices, repeats allowed, with
    ``method=Method.REMOTE_DMA``) over a mesh of that many block positions
    (see the module docstring). The checkpoint,
    health and injection arguments are jacobi3d's; raises
    :class:`~stencil_tpu_torch.fault.RecoveryExhausted` when recovery gives
    up. ``batch_quantities``, ``kernel_variant`` ("shift", the default, or
    "ring") and ``use_pallas`` (False: the unfused path, which runs only on
    the CPU) are the JAX app's (see the module docstring). ``autotune``
    and ``plan_db`` tune the exchange plan at realize(); the row's
    ``plan`` names the choice applied (None untuned)."""
    variant = kernel_variant or "shift"
    if variant not in KERNEL_VARIANTS:
        raise ValueError(f"unknown kernel_variant {kernel_variant!r}: valid values are "
                         f"{', '.join(KERNEL_VARIANTS)}")
    if use_pallas is False and resolve_device(devices[0] if devices else device).type == "cuda":
        raise NotImplementedError(
            "use_pallas=False (--no-pallas) asks for the unfused substep path, which the "
            "port has only on the CPU: on a CUDA device the substep is the hand-written "
            "kernel (csrc/astaroth_substep.cu), and the plain PyTorch version runs only on "
            "CPU tensors; pass device='cpu' for the unfused path")
    info = load(conf, nx)
    dd, handles = make_domain(info, dtype, device, partition, batch_quantities, devices,
                              method, autotune=autotune, plan_db=plan_db)
    if dd.plan_choice is not None:
        batch_quantities = dd.plan_choice.batch_quantities
    dev = dd.device
    curr = {name: dd.get_curr(handles[name]) for name in FIELDS}
    nxt = {name: dd.get_next(handles[name]) for name in FIELDS}

    iter_time = Statistics()
    exch_time = Statistics()
    if no_compute:
        if ckpt_dir:
            log.warn("--ckpt-dir ignored with --no-compute (a pure-exchange benchmark "
                     "has no state worth resuming)")
        # pure exchange, 3 per iteration (reference --no-compute flag)
        loop = dd.halo_exchange.make_loop(3)
        curr = loop(curr)
        hard_sync(dev)
        for _ in range(iters):
            t0 = time.perf_counter()
            curr = loop(curr)
            hard_sync(dev)
            dt_iter = time.perf_counter() - t0
            iter_time.insert(dt_iter)
            exch_time.insert(dt_iter)
    else:
        start = 0
        if ckpt_dir and resume:
            from ._bench_common import resume_from_checkpoint

            start = resume_from_checkpoint(dd, ckpt_dir, iters)
            curr = {name: dd.get_curr(handles[name]) for name in FIELDS}

        def save_ckpt(step_no: int, state) -> None:
            for name in FIELDS:
                dd.set_curr(handles[name], state[name])
            dd.save_checkpoint(ckpt_dir, step_no, keep=ckpt_keep)

        chunk = max(1, min(chunk, iters))
        steps = {}

        def get_step(k: int):
            # the guarded schedule may carry chunk sizes besides `chunk`
            if k not in steps:
                steps[k] = make_astaroth_step(dd.halo_exchange, info, dt=dt, overlap=overlap,
                                              swap_per_substep=swap_per_substep, iters=k,
                                              dtype=dtype)
            return steps[k]

        with timer.timed("astaroth.warmup"):
            if ckpt_dir:
                # a checkpointed run is step-exact: warm up on copies
                get_step(chunk)(_copy(curr), _copy(nxt))
            else:
                curr, nxt = get_step(chunk)(curr, nxt)
            hard_sync(dev)
        exch_loop = dd.halo_exchange.make_loop(3 if swap_per_substep else 1)

        def exchange_share(st):
            t0 = time.perf_counter()
            with timer.trace_range("astaroth.exchange"):
                st = exch_loop(st)
                hard_sync(dev)
            exch_time.insert(time.perf_counter() - t0)
            return st

        guard = HealthGuard(every=health_every, max_abs=max_abs) if health_every > 0 else None
        injector = FaultPlan.from_spec(inject)
        done = start
        if guard is not None or injector is not None:
            def plan_fn(s: int):
                return chunk_plan(s, iters, chunk,
                                  every=(ckpt_every if (ckpt_dir and ckpt_every > 0) else 0,
                                         health_every if guard is not None else 0),
                                  at=injector.steps() if injector is not None else ())

            def step_fn(st, k):
                nonlocal nxt
                with timer.trace_range("astaroth.chunk"):
                    c, nxt = get_step(k)(st, nxt)
                    hard_sync(dev)
                return c

            def on_chunk(st, k, per, done_now):
                for _ in range(k):
                    iter_time.insert(per)
                return exchange_share(st)

            save_fn = restore_fn = quarantine_fn = flush_fn = None
            if ckpt_dir:
                if ckpt_every > 0:
                    save_fn = save_ckpt
                flush_fn = dd.flush_checkpoints

                def restore_fn():
                    s = dd.restore_checkpoint(ckpt_dir)
                    return None if s is None else (
                        s, {name: dd.get_curr(handles[name]) for name in FIELDS})

                def quarantine_fn(s):
                    from ..ckpt import quarantine_snapshot, snapshot_name

                    quarantine_snapshot(ckpt_dir, snapshot_name(s),
                                        reason="restored state failed health check")

            curr, done = run_guarded(
                curr, start=start, iters=iters, plan_fn=plan_fn, step_fn=step_fn, guard=guard,
                injector=injector,
                policy=RecoveryPolicy(max_rollbacks=max_rollbacks, backoff_s=rollback_backoff),
                save_fn=save_fn, ckpt_every=ckpt_every, restore_fn=restore_fn,
                quarantine_fn=quarantine_fn, flush_fn=flush_fn, on_chunk=on_chunk,
                spec=dd.spec, ckpt_dir=ckpt_dir, app="astaroth")
        else:
            step = get_step(chunk)
            next_ckpt = ((start // ckpt_every + 1) * ckpt_every
                         if ckpt_dir and ckpt_every > 0 else None)
            while done < iters:
                t0 = time.perf_counter()
                with timer.trace_range("astaroth.chunk"):
                    curr, nxt = step(curr, nxt)
                    hard_sync(dev)
                per = (time.perf_counter() - t0) / chunk
                for _ in range(chunk):
                    iter_time.insert(per)
                done += chunk
                if next_ckpt is not None and next_ckpt <= done < iters:
                    save_ckpt(done, curr)
                    next_ckpt = (done // ckpt_every + 1) * ckpt_every
                curr = exchange_share(curr)
        if ckpt_dir:
            if done > start or start == 0:
                save_ckpt(done, curr)  # the final state is always durable
            # a resume that found nothing left to run never re-labels the
            # existing (possibly further-along) snapshot
            dd.finish_checkpoints()
    iters_run = iter_time.count()
    if not no_compute:
        if iters_run == 0:
            log.info(f"resume found step {start} >= iters {iters}; no timed work")
            iter_time.insert(float("inf"))
            exch_time.insert(float("inf"))

    for name in FIELDS:
        dd.set_curr(handles[name], curr[name])
        dd.set_next(handles[name], nxt[name])

    trimean = iter_time.trimean()
    cells = dd.size.flatten()
    result = {
        # a resident run stands in for the JAX app's run over one device a
        # block; a mesh run is that run, one process driving its positions
        "processes": 1 if dd.mesh is not None else dd.spec.num_blocks(),
        "devices": len(dd.mesh) if dd.mesh is not None else 1,
        "partition": dd.spec.dim,
        "nx": info.int_params["AC_nx"],
        "ny": info.int_params["AC_ny"],
        "nz": info.int_params["AC_nz"],
        "global": dd.size,
        "dtype": dtype,
        "kernel_variant": variant,
        "batch_quantities": batch_quantities,
        "plan": dd.plan_choice.label() if dd.plan_choice is not None else None,
        "iter_trimean_s": trimean,
        "exch_trimean_s": exch_time.trimean(),
        "iters_run": iters_run,
        "mcells_per_s": cells / trimean / 1e6,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "domain": dd,
        "handles": handles,
        "info": info,
    }
    if reductions:
        red = Reductions(dd.halo_exchange)
        result["reductions"] = {
            "lnrho": red.scal(dd.get_curr(handles["lnrho"])),
            "uu": red.vec(dd.get_curr(handles["uux"]), dd.get_curr(handles["uuy"]),
                          dd.get_curr(handles["uuz"])),
        }
    return result


def csv_row(r: dict) -> str:
    """The reference's row; its first column is the JAX app's device count:
    a mesh's positions, or the blocks of a resident run."""
    return (
        f"{max(r['processes'], r['devices'])},{r['nx']},{r['ny']},{r['nz']},"
        f"{r['iter_trimean_s']:e},{r['exch_trimean_s']:e}"
    )


def _copy(state: dict) -> dict:
    """A copy of a field dict (tensors, or a mesh's lists of them)."""
    return {k: [t.clone() for t in v] if isinstance(v, list) else v.clone()
            for k, v in state.items()}


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description="Astaroth MHD mini-app (one GPU; a mesh of "
                                            "block positions with --devices)")
    p.add_argument("iters", type=int, nargs="?", default=10)
    p.add_argument("--conf", default=DEFAULT_CONF)
    p.add_argument("--nx", type=int, default=None, help="override AC_n{x,y,z}")
    p.add_argument("--f32", action="store_true", help="float32 fields")
    p.add_argument("--f64", action="store_true",
                   help="float64 fields (the default; the reference's type)")
    p.add_argument("--reductions", action="store_true", help="print field reductions")
    p.add_argument("--no-compute", action="store_true", help="time the exchange alone")
    p.add_argument("--no-overlap", action="store_true",
                   help="disable interior/exterior overlap (no effect on one block "
                        "or an uneven partition)")
    p.add_argument("--chunk", type=int, default=1,
                   help="iterations per timed chunk (a final partial chunk "
                        "still runs a full chunk)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the current CUDA device; "
                        "'cpu' runs the plain PyTorch versions)")
    p.add_argument("--devices", type=str, default=None,
                   help="comma list of torch devices, one block position each, repeats "
                        "allowed (e.g. cuda:0,cuda:0): the domain grows by "
                        "decompose_zyx(count), exchanged by remote-dma")
    p.add_argument("--no-pallas", action="store_true",
                   help="the unfused substep path: the plain PyTorch version on the CPU; "
                        "the card has no unfused path, so there it raises")
    p.add_argument("--per-quantity-exchange", action="store_true",
                   help="disable quantity batching: one carrier per field per phase "
                        "instead of one packed carrier for all 8 fields (the A/B baseline)")
    p.add_argument("--kernel-variant", choices=KERNEL_VARIANTS, default=None,
                   help="the substep kernel's sliding-window discipline of the TPU kernel, "
                        "'shift' (default) or 'ring': the same bits, one kernel on the card")
    p.add_argument("--autotune", action="store_true",
                   help="choose the exchange plan (partition x method x quantity batching) "
                        "with the plan/ autotuner; a plan-DB hit replays with zero probes")
    p.add_argument("--plan-db", type=str, default="", help="on-disk plan DB (JSON) for --autotune")
    add_guard_flags(p)
    args = p.parse_args(argv)
    if args.f32 and args.f64:
        p.error("--f32 and --f64 exclude each other")
    if args.device and args.devices:
        p.error("--device conflicts with --devices")
    try:
        r = run(iters=args.iters, conf=args.conf, nx=args.nx,
                dtype="float32" if args.f32 else "float64", no_compute=args.no_compute,
                overlap=not args.no_overlap, reductions=args.reductions,
                chunk=args.chunk, device=args.device,
                devices=args.devices.split(",") if args.devices else None,
                method=Method.REMOTE_DMA if args.devices else Method.AXIS_COMPOSED,
                batch_quantities=not args.per_quantity_exchange,
                kernel_variant=args.kernel_variant,
                use_pallas=False if args.no_pallas else None, autotune=args.autotune,
                plan_db=args.plan_db or None, **guard_kwargs(args))
    except RecoveryExhausted as e:
        log.error(f"astaroth: {e}")
        return FAULT_RC
    print(csv_row(r))
    log.info(f"{r['dtype']} on {r['device']}: {r['iter_trimean_s'] * 1e3:.4f} ms/iter, "
             f"{r['mcells_per_s']:.1f} Mcells/s, kernel variant {r['kernel_variant']}, "
             f"quantity batching {'on' if r['batch_quantities'] else 'off'}")
    log.info(timer.report())
    for k, v in r.get("reductions", {}).items():
        log.info(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
