"""What the port's apps share around a run (the port's own copy of
``stencil_tpu.apps._bench_common``): the metrics flags, the live flags (the
in-run sentinel and the status file), the resume policy,
:func:`coord_state` (the coordinate fields the method ablation compares
bit for bit), and :func:`time_exchange`, the timed exchange loop the bench
apps and the plan probes measure with."""

from __future__ import annotations

import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..obs import telemetry
from ..utils import logging as log
from ..utils.statistics import Statistics
from ..utils.sync import hard_sync


def add_metrics_flags(p) -> None:
    """``--metrics-out`` (telemetry JSONL) and ``--run-id``."""
    p.add_argument("--metrics-out", default=os.environ.get("STENCIL_METRICS_OUT", ""),
                   help="append telemetry records (one JSON object per line; schema "
                        "stencil_tpu_torch/obs/telemetry.py) to this file")
    p.add_argument("--run-id", default="", help="telemetry run id (default: generated)")


def start_metrics(args, app: str) -> "telemetry.Recorder":
    """Install the process-default recorder from parsed flags; the run's
    argv config is its first record, so a metrics file describes itself."""
    return telemetry.configure(metrics_out=getattr(args, "metrics_out", "") or None, app=app,
                               run_id=getattr(args, "run_id", "") or None, config=vars(args))


def finish_metrics(rec: "telemetry.Recorder") -> None:
    """Close the recorder's sink (a no-op on a disabled recorder)."""
    if rec.enabled:
        rec.close()


def add_live_flags(p) -> None:
    """The live flags of the guarded apps: an in-run anomaly sentinel over
    the chunk-cycle step latency, and an atomic run-status snapshot."""
    p.add_argument("--status-file", default=os.environ.get("STENCIL_STATUS_FILE", ""),
                   help="rewrite an atomic run-status snapshot here every chunk (step, "
                        "throughput, health counts, anomalies)")
    p.add_argument("--live-sentinel", action="store_true",
                   help="in-run anomaly detection: judge each chunk's per-step latency "
                        "against a streaming trimean+-MAD band (obs/live.py); excursions "
                        "record anomaly.detected / replan.requested mid-run")
    p.add_argument("--live-config", default="",
                   help="sentinel knobs as JSON (inline '{...}' or a file path): "
                        "{\"*\": {window, min_history, mad_k, rel_tol, abs_tol, direction, "
                        "clear_after}, \"<key>\": {...}}")


def load_live_config(value: str) -> dict:
    """Parse ``--live-config``: inline JSON or a JSON file path. Raises
    OSError / ValueError, which the apps turn into an argparse error."""
    if not value:
        return {}
    if value.lstrip()[:1] in ("{", "["):
        text = value
    else:
        with open(value) as f:
            text = f.read()
    cfg = json.loads(text)
    if not isinstance(cfg, dict):
        raise ValueError("--live-config must be a JSON object")
    from ..obs.live import validate_config

    errs = validate_config(cfg)
    if errs:
        raise ValueError("; ".join(errs))
    return cfg


def canonicalize_live_config(args) -> dict:
    """Validate ``--live-config`` at parse time and rewrite the flag to
    canonical inline JSON, so what was validated is what runs."""
    cfg = load_live_config(getattr(args, "live_config", ""))
    args.live_config = json.dumps(cfg) if cfg else ""
    return cfg


def make_live(args, rec: "telemetry.Recorder", app: str):
    """``(sentinel, status writer)`` from parsed flags; None for each flag
    not given."""
    sentinel = status = None
    if getattr(args, "live_sentinel", False):
        from ..obs.live import LiveSentinel

        sentinel = LiveSentinel(load_live_config(getattr(args, "live_config", "")), rec=rec)
    if getattr(args, "status_file", ""):
        from ..obs.status import StatusWriter

        status = StatusWriter(args.status_file, app=app, run=rec.run_id)
    return sentinel, status


def finish_live(rec: "telemetry.Recorder", sentinel, status, outcome: Optional[str] = None,
                gauge: bool = True) -> None:
    """The live epilogue: the run's anomaly count as the
    ``live.anomaly_count`` gauge, and the final snapshot's outcome."""
    if gauge and sentinel is not None and rec.enabled:
        rec.gauge("live.anomaly_count", float(sentinel.detected_total), phase="live")
    if status is not None:
        status.update(outcome=outcome,
                      anomalies=sentinel.summary() if sentinel is not None else None)


def resume_from_checkpoint(dd, ckpt_dir: str, iters: int) -> int:
    """The apps' resume policy (jacobi3d, astaroth): restore the newest
    valid compatible snapshot, warn when it lies beyond the run's target
    (and never re-label it, so step accounting stays truthful), record the
    resumed-from-step gauge, and return the start step (0 = fresh start)."""
    restored = dd.restore_checkpoint(ckpt_dir)
    if restored is None:
        return 0
    if restored > iters:
        log.warn(f"checkpoint step {restored} is beyond the target {iters}; "
                 "nothing to run and the snapshot is NOT relabeled")
    start = min(restored, iters)
    telemetry.get().gauge("ckpt.resumed_from_step", start, phase="ckpt")
    log.info(f"resuming from checkpointed step {start}")
    return start


def fabric(devices) -> dict:
    """What measured a sample: the platform, the mesh positions and, on the
    card, its name (the attribution records' ``fabric_*`` fields)."""
    dev = torch.device(devices[0])
    out = {"platform": dev.type, "positions": len(devices)}
    if dev.type == "cuda":
        out["card"] = torch.cuda.get_device_name(dev)
    return out


def coord_state(dd, quantities: int):
    """Deterministic per-quantity coordinate fields on a realized domain
    (value = z*1e6 + y*1e3 + x + quantity index, float32): the bit-for-bit
    agreement fixture of the method ablation, the JAX package's
    ``coord_state`` on the port's layout (a stacked tensor, or a mesh's
    per-position stacks)."""
    from ..parallel.exchange import shard_blocks

    g = dd.spec.global_size
    coord = (np.arange(g.z)[:, None, None] * 1_000_000.0
             + np.arange(g.y)[None, :, None] * 1_000.0
             + np.arange(g.x)[None, None, :]).astype(np.float32)
    return {i: shard_blocks(coord + i, dd.spec, dd.mesh or dd.device) for i in range(quantities)}


def time_exchange(size, radius, iters: int, method=None, devices: Optional[Sequence] = None,
                  placement=None, quantities: int = 4, dtype: str = "float32", chunk: int = 10,
                  prefix: str = "", batch_quantities: bool = True, partition=None,
                  wire_dtype=None, fused: bool = False, hierarchy=None) -> dict:
    """Realize a domain of ``quantities`` quantities on ``devices`` (one
    device, or a mesh of positions; default the current CUDA device) and
    time ``iters`` exchanges in chunks of ``chunk``, after one warm-up call
    of every chunk size: on the card by CUDA events around each chunk, on
    the CPU by the host clock. ``partition``, ``batch_quantities``,
    ``wire_dtype`` (the narrowed wire between positions) and ``fused``
    configure the domain as the bench apps and plan probes need; ``prefix``
    makes realize() write the plan files under it. ``placement`` and
    ``hierarchy`` (a placed mesh, a two-level transport) raise
    NotImplementedError: positions on distinct GPUs are ROADMAP.md queue A
    item 5. With the recorder enabled it records each chunk
    (``exchange.iter``), its attribution against the cost model
    (``plan.attrib.phase``), the plan's fingerprint and the trimean and
    GB/s gauges. Returns the stats and the ``domain`` (drop it to free its
    memory)."""
    from ..api import DistributedDomain
    from ..parallel.exchange import Method

    if placement is not None or hierarchy is not None:
        raise NotImplementedError(
            "time_exchange: placement= and hierarchy= need positions on distinct GPUs "
            "(ROADMAP.md queue A item 5)")
    method = method or Method.AXIS_COMPOSED
    devices = list(devices) if devices is not None else [None]
    dd = DistributedDomain(size.x, size.y, size.z, device=devices[0])
    if len(devices) > 1:
        dd.set_devices(devices)
    dd.set_radius(radius)
    dd.set_methods(method)
    dd.set_quantity_batching(batch_quantities)
    dd.set_fused_exchange(fused)
    if wire_dtype:
        dd.set_wire_dtype(wire_dtype)
    if partition is not None:
        dd.set_partition(partition)
    if prefix:
        dd.set_output_prefix(prefix)
    for i in range(quantities):
        dd.add_data(f"d{i}", dtype)
    dd.realize()
    dev = dd.device
    rec = telemetry.get()
    itemsizes = [torch.empty((), dtype=getattr(torch, dtype)).element_size()] * quantities
    state = dd.curr_state()
    chunk = max(1, min(chunk, iters))
    sizes = {chunk} | ({iters % chunk} if iters % chunk else set())
    loops = {k: dd.halo_exchange.make_loop(k) for k in sizes}
    # the wire and variant tags keep an A/B run's legs apart in aggregation
    tags = {"wire": str(wire_dtype)} if wire_dtype else {}
    if fused:
        tags["variant"] = "fused"
    with rec.span("exchange.warmup", phase="compile", method=method.value,
                  batched=batch_quantities, **tags):
        for fn in loops.values():
            state = fn(state)
        hard_sync(dev)
    stats = Statistics()
    samples = []
    done = 0
    card = dev.type == "cuda"
    while done < iters:
        k = min(chunk, iters - done)
        if card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state = loops[k](state)
            end.record()
            end.synchronize()
            per = start.elapsed_time(end) / 1e3 / k
        else:
            t0 = time.perf_counter()
            state = loops[k](state)
            per = (time.perf_counter() - t0) / k
        stats.insert(per)
        samples.append(per)
        rec.emit("span", "exchange.iter", phase="exchange", seconds=per, iters=k,
                 method=method.value, batched=batch_quantities, **tags)
        done += k
    logical = dd.halo_exchange.bytes_logical(itemsizes)
    if rec.enabled:
        from ..obs import attribution
        from ..plan.cost import default_provenance
        from ..plan.ir import PlanChoice, PlanConfig

        pm = dd.plan_meta()
        pchoice = PlanChoice.from_json(pm["choice"])
        pconfig = PlanConfig.from_json(pm["key"])
        attribution.attribute_and_judge(
            rec, pconfig, pchoice, samples, phase="exchange.iter",
            kernel_variant="fused" if fused else None,
            fabric=fabric(dd.mesh.devices if dd.mesh is not None else [dev]))
        rec.meta("plan.fingerprint", fingerprint=pchoice.fingerprint(), choice=pchoice.label(),
                 calibration=default_provenance(pconfig.platform), **tags)
        rec.gauge("exchange.trimean_s", stats.trimean(), phase="exchange", unit="s",
                  method=method.value, batched=batch_quantities, **tags)
        rec.gauge("exchange.gb_per_s", logical / stats.trimean() / 1e9, phase="exchange",
                  method=method.value, batched=batch_quantities, **tags)
    return {
        "domain": dd,
        "stats": stats,
        "trimean_s": stats.trimean(),
        "min_s": stats.min(),
        "bytes_logical": logical,
        "bytes_moved": dd.halo_exchange.bytes_moved(itemsizes),
        "gb_per_s": logical / stats.trimean() / 1e9,
        "local_size": dd.spec.base,
        "devices": len(devices),
    }
