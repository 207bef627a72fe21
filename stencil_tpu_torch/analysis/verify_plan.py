"""ExchangePlan IR against what the port executed: the conformance auditor.

The port's counterpart of ``stencil_tpu.analysis.verify_plan``. The IR
(``plan/ir.py``) *predicts* what an exchange moves, and the autotuner ranks
candidates on those predictions without running them. The JAX package
holds them to the compiled HLO's collective census; the port has no
compiled program to read, so it holds them to what its exchanges and
kernel wrappers count as they issue their work (never recomputed from the
plan). For a grid of partition x method x dtype x Q configs it realizes
each exchange, runs it once and checks:

- ``messages_per_exchange``: the IR's ``collectives_per_exchange`` (the
  messages between blocks) against the messages the exchange issued
  (``HaloExchange.last_message_count``: a rolled resident slab per phase
  side and carrier, a direct26 box per direction and carrier). The port
  runs AXIS_COMPOSED and DIRECT26 over a mesh of one block a position, as
  the JAX package does over its devices (``parallel/mesh_exchange``: a
  message is a round of copies between positions; on one block the
  exchange issues none). REMOTE_DMA issues none: its copies are kernel
  launches.
- ``wire_bytes`` (AXIS_COMPOSED, DIRECT26): the IR's bytes between blocks
  against the bytes of the halo boxes those messages wrote
  (``HaloExchange.last_message_bytes``).
- ``dma_transfers`` (REMOTE_DMA): ``dmas_per_exchange x positions``
  against the slabs the carrier sent to another position
  (``last_transfer_count``), over a mesh of one block a position.
- ``carrier_launches`` (REMOTE_DMA, on the card): the IR's
  ``ExchangePlan.carrier_launches`` against the launches the B4, B6 and B7
  wrappers counted. On the CPU their plain versions run and nothing
  launches, so the verdict lists this check as not made, with the reason.
- ``launches_per_chunk`` (``remote-dma+persistent``, at depth ``k``, 2 by
  default as in the JAX package, on the CPU): the IR's
  ``launches_per_chunk(k)`` (deep exchange + chunk program) against the
  dispatches a two-chunk loop tallied as it issued them
  (``ex.last_launches_per_chunk``), as the JAX package reads them. The
  card runs another unit, so there the check is listed as not made and
  the loop's kernel launches are counted instead:
- ``chunk_loop_launches`` and ``chunk_kernel_launches`` (the persistent
  loop, on the card): the IR's ``chunk_loop_launches(chunks)`` (the
  ``sel`` fill, then one chunk-kernel launch a chunk, after the deep
  exchange where the partition is uneven) against the launches the B4,
  B6, B7 and B9 wrappers counted during the loop, and the chunks against
  B9's own count.

A check this platform cannot make is listed in the verdict as not made
(``ok`` None, with ``not_made``), never as passed; ``Verdict.ok`` holds
the checks made.

The grid, labels, feasibility skips (``plan/cost.feasible``), the
``perturb_*`` knobs and the verdict JSON are the JAX package's. The default
methods leave out AUTO_SPMD, and an auto-spmd config raises
NotImplementedError (ROADMAP.md queue A item 5); the JAX package's
placement and hierarchy sweeps need positions on distinct devices and
hosts, the same item. :func:`run_time_sweep` times the exchanges and
judges the cost model's predicted seconds (the ``"cuda"`` row on the card,
the CPU constants on the CPU) against the measured band.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..obs import telemetry

DEFAULT_PARTITIONS: Tuple[Tuple[int, int, int], ...] = ((2, 2, 2), (1, 2, 4))
DEFAULT_QSETS: Tuple[Tuple[str, ...], ...] = (
    ("float32",),
    ("float32", "float32", "float32"),
    ("float32", "float32", "float64"),
)
DEFAULT_SIZE = 16
DEFAULT_RADIUS = 2
DEFAULT_POSITIONS = 8

FUSED_METHOD_LABEL = "remote-dma+fused"
PERSISTENT_METHOD_LABEL = "remote-dma+persistent"

_LATER = "ROADMAP.md queue A item 5"


@dataclass
class Verdict:
    """One config's audit outcome. ``checks`` rows are
    ``{name, predicted, actual, ok}`` (a check not made has ``ok`` None and
    its reason under ``not_made``); ``skipped`` configs carry the
    infeasibility reason instead."""

    label: str
    method: str
    ok: bool = True
    skipped: bool = False
    reason: str = ""
    checks: List[dict] = field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "kind": "plan-verdict", "label": self.label,
            "method": self.method, "ok": self.ok,
            "skipped": self.skipped, "reason": self.reason,
            "checks": self.checks,
        }


def method_labels() -> Tuple[str, ...]:
    """Every label the JAX package's grid takes: the IR's methods and the
    two kernel-variant labels."""
    from ..plan.ir import METHODS

    return tuple(METHODS) + (FUSED_METHOD_LABEL, PERSISTENT_METHOD_LABEL)


def default_methods() -> Tuple[str, ...]:
    """The labels the port audits by default: all but AUTO_SPMD."""
    from ..plan.cost import PLANNED_METHODS

    return tuple(PLANNED_METHODS) + (FUSED_METHOD_LABEL, PERSISTENT_METHOD_LABEL)


def sweep_configs(
    size: int = DEFAULT_SIZE,
    radius: int = DEFAULT_RADIUS,
    partitions: Sequence[Tuple[int, int, int]] = DEFAULT_PARTITIONS,
    methods: Optional[Sequence[str]] = None,
    qsets: Sequence[Sequence[str]] = DEFAULT_QSETS,
) -> List[dict]:
    """The sweep grid as plain dicts (label, size, radius, partition,
    method, dtypes), the JAX package's. Default methods:
    :func:`default_methods`."""
    known = method_labels()
    methods = list(methods or default_methods())
    unknown = sorted(set(methods) - set(known))
    if unknown:
        raise ValueError(f"unknown method(s): {', '.join(unknown)} "
                         f"(known: {', '.join(known)})")
    out = []
    for part in partitions:
        for dtypes in qsets:
            for method in methods:
                px, py, pz = part
                short = "+".join(
                    f"{n}x{dt.replace('float', 'f')}"
                    for dt, n in sorted(
                        {d: list(dtypes).count(d) for d in set(dtypes)}
                        .items()))
                out.append({
                    "label": f"{size}^3/{px}x{py}x{pz}/{method}/{short}",
                    "size": int(size), "radius": int(radius),
                    "partition": tuple(part), "method": method,
                    "dtypes": tuple(dtypes),
                })
    return out


def default_positions() -> list:
    """The positions an audit runs on by default: 8 on the current CUDA
    device (the JAX package audits over its 8 virtual devices); raises
    without one (pass ``["cpu"] * 8``)."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass devices=['cpu'] * 8 for CPU "
                           "positions")
    return [torch.device("cuda", torch.cuda.current_device())] * DEFAULT_POSITIONS


def _check(checks: List[dict], name: str, predicted, actual) -> bool:
    ok = predicted == actual
    checks.append({"name": name, "predicted": predicted,
                   "actual": actual, "ok": ok})
    return ok


def _not_made(checks: List[dict], name: str, predicted, reason: str) -> None:
    checks.append({"name": name, "predicted": predicted, "actual": None,
                   "ok": None, "not_made": reason})


def _launch_count() -> int:
    """Launches of the exchange carriers so far: B4's fills, B6, B7."""
    from ..ops.fused_stencil import fused_exchange
    from ..ops.halo_fill import self_fill
    from ..ops.remote_dma import remote_axis

    return self_fill.launches + remote_axis.launches + fused_exchange.launches


def _chunk_launch_count() -> int:
    from ..ops.persistent_stencil import persistent_jacobi, persistent_jacobi_mesh

    return persistent_jacobi.launches + persistent_jacobi_mesh.launches


def _realize(cfg: dict, devices, v: Verdict):
    """``(plan, config, choice, exchange, state, nblocks)`` of one config,
    or None with ``v`` marked skipped: the plan is the IR of the config on
    one block a position (``plan/cost.feasible``), the exchange the port's
    realization of it."""
    import numpy as np
    import torch

    from ..geometry import Dim3, Radius
    from ..parallel import DeviceMesh, HaloExchange, Method, shard_blocks
    from ..plan.cost import feasible
    from ..plan.ir import (AUTO_SPMD, FUSED_VARIANT, PERSISTENT_VARIANT, REMOTE_DMA,
                           PlanChoice, PlanConfig, build_plan)

    fused = cfg["method"] == FUSED_METHOD_LABEL
    persistent = cfg["method"] == PERSISTENT_METHOD_LABEL
    method = REMOTE_DMA if (fused or persistent) else cfg["method"]
    if method == AUTO_SPMD:
        raise NotImplementedError(f"auto-spmd exchanges: {_LATER}")
    size, dtypes = cfg["size"], list(cfg["dtypes"])
    radius = Radius.constant(cfg["radius"])
    nblocks = cfg["partition"][0] * cfg["partition"][1] * cfg["partition"][2]
    if nblocks > len(devices):
        v.skipped = True
        v.ok = False
        v.reason = (f"partition {cfg['partition']} needs {nblocks} "
                    f"devices; {len(devices)} available")
        return None
    dev0 = torch.device(devices[0])
    config = PlanConfig.make(Dim3(size, size, size), radius, dtypes, nblocks, dev0.type)
    k = int(cfg.get("k", 2)) if persistent else 1
    choice = PlanChoice(
        partition=cfg["partition"], method=method,
        kernel_variant=(PERSISTENT_VARIANT if persistent
                        else FUSED_VARIANT if fused else None),
        # persistent IS temporal fusion: feasible() scales the realized
        # radius to radius*k, the deep halo the audited exchange stages
        multistep_k=k)
    feas = feasible(config, choice)
    if feas is None:
        v.skipped = True
        v.ok = False
        v.reason = (f"infeasible for this config (plan/cost.feasible: "
                    f"partition {cfg['partition']} with radius "
                    f"{cfg['radius']} on {nblocks} device(s))")
        return None
    spec, mesh_dim, _resident = feas
    plan = build_plan(spec, mesh_dim, method, fused=fused, persistent=persistent)
    mesh = DeviceMesh(spec.dim, devices[:nblocks]) if nblocks > 1 else None
    ex = HaloExchange(spec, Method(method), fused=fused, persistent=persistent, mesh=mesh)
    g = spec.global_size
    base = np.arange(g.x * g.y * g.z, dtype=np.float64).reshape(g.z, g.y, g.x)
    state = {i: shard_blocks((base + i).astype(dt), spec, mesh or dev0)
             for i, dt in enumerate(dtypes)}
    return plan, config, choice, ex, state, nblocks


def audit_config(cfg: dict, devices=None,
                 perturb_collectives: int = 0,
                 perturb_wire: int = 0,
                 perturb_dmas: int = 0) -> Verdict:
    """Run one config's exchange once and hold the IR's predictions to
    what it executed (see the module docstring). Feasibility goes through
    ``plan/cost.feasible``: an infeasible config returns a skipped verdict
    with the reason, never a traceback."""
    import numpy as np
    import torch

    from ..plan.ir import REMOTE_DMA

    devices = list(devices) if devices is not None else default_positions()
    v = Verdict(label=cfg["label"], method=cfg["method"])
    got = _realize(cfg, devices, v)
    if got is None:
        return v
    plan, _config, choice, ex, state, nblocks = got
    card = torch.device(devices[0]).type == "cuda"
    dtypes = list(cfg["dtypes"])
    nq = len(dtypes)
    ngroups = len(set(dtypes))
    itemsizes = [np.dtype(d).itemsize for d in dtypes]
    floating = [bool(np.issubdtype(np.dtype(d), np.floating)) for d in dtypes]

    predicted_msgs = plan.collectives_per_exchange(nq, ngroups) + perturb_collectives
    predicted_wire = plan.wire_bytes(itemsizes, floating=floating) + perturb_wire
    predicted_dmas = plan.dmas_per_exchange(nq, ngroups) + perturb_dmas

    launches0 = _launch_count()
    ex(state)
    launched = _launch_count() - launches0
    ok = _check(v.checks, "messages_per_exchange", predicted_msgs, ex.last_message_count)
    if choice.method != REMOTE_DMA:
        ok &= _check(v.checks, "wire_bytes", predicted_wire, ex.last_message_bytes)
    else:
        ok &= _check(v.checks, "dma_transfers", predicted_dmas * nblocks,
                     ex.last_transfer_count)
        carriers = [dtypes.count(d) for d in sorted(set(dtypes))]
        predicted_launches = plan.carrier_launches(carriers, ngroups)
        if card:
            ok &= _check(v.checks, "carrier_launches", predicted_launches, launched)
        else:
            _not_made(v.checks, "carrier_launches", predicted_launches,
                      "the kernel wrappers count launches on a CUDA device only; on the "
                      "CPU their plain versions run and nothing launches")
        if choice.is_persistent:
            from ..ops.jacobi import make_jacobi_loop
            from ..ops.persistent_stencil import chunk_schedule
            from ..parallel import shard_blocks

            k = choice.multistep_k
            iters = 2 * k  # two chunks of depth k
            loop = make_jacobi_loop(ex, iters, standard_spheres=False, temporal_k=k)
            g = ex.spec.global_size
            sel = shard_blocks(np.zeros((g.z, g.y, g.x), dtype=np.int32), ex.spec,
                               ex.mesh or torch.device(devices[0]))
            curr = state[0]
            nxt = ([torch.zeros_like(b) for b in curr] if isinstance(curr, list)
                   else torch.zeros_like(curr))
            chunks = len(chunk_schedule(iters, k))
            launches0, chunks0 = _launch_count(), _chunk_launch_count()
            loop(curr, nxt, sel)
            b9 = _chunk_launch_count() - chunks0
            launched = _launch_count() - launches0 + b9
            if card:
                _not_made(v.checks, "launches_per_chunk", plan.launches_per_chunk(k),
                          "the JAX unit (deep exchange + chunk program) is not what the card "
                          "runs: its kernel launches are checked as chunk_loop_launches")
                ok &= _check(v.checks, "chunk_loop_launches",
                             plan.chunk_loop_launches(chunks), launched)
                ok &= _check(v.checks, "chunk_kernel_launches", chunks, b9)
            else:
                ok &= _check(v.checks, "launches_per_chunk", plan.launches_per_chunk(k),
                             ex.last_launches_per_chunk)
                for name, predicted in (("chunk_loop_launches", plan.chunk_loop_launches(chunks)),
                                        ("chunk_kernel_launches", chunks)):
                    _not_made(v.checks, name, predicted,
                              "the kernel wrappers count launches on a CUDA device only; on "
                              "the CPU their plain versions run and nothing launches")
    v.ok = bool(ok)
    return v


def _sweep(configs, audit, rec) -> Dict:
    """Audit every config (``audit(cfg) -> Verdict``), emitting the
    ``analysis.*`` vocabulary; an auditor crash is a FAILED config."""
    from ..plan.ir import AUTO_SPMD

    if any(cfg["method"] == AUTO_SPMD for cfg in configs):
        raise NotImplementedError(f"auto-spmd exchanges: {_LATER}")
    verdicts: List[Verdict] = []
    for cfg in configs:
        with rec.span("analysis.verify_plan", phase="analysis", method=cfg["method"]):
            try:
                v = audit(cfg)
            except Exception as e:  # an auditor crash is a FAILED config
                v = Verdict(label=cfg["label"], method=cfg["method"], ok=False,
                            reason=f"{type(e).__name__}: {e}")
        verdicts.append(v)
        rec.meta("analysis.plan_verdict", method=v.method, ok=int(v.ok), label=v.label,
                 skipped=int(v.skipped), reason=v.reason or None)
        if not v.ok and not v.skipped:
            rec.counter("analysis.plan_mismatch", value=1, phase="analysis", method=v.method)
    checked = [v for v in verdicts if not v.skipped]
    failed = [v for v in checked if not v.ok]
    skipped = [v for v in verdicts if v.skipped]
    rec.meta("analysis.plan_sweep", checked=len(checked), failed=len(failed),
             skipped=len(skipped))
    return {"verdicts": verdicts, "checked": len(checked), "failed": len(failed),
            "skipped": len(skipped)}


def run_sweep(configs: Sequence[dict], devices=None,
              perturb_collectives: int = 0, perturb_wire: int = 0,
              perturb_dmas: int = 0,
              rec: Optional["telemetry.Recorder"] = None) -> Dict:
    """Audit every config; returns ``{verdicts, checked, failed,
    skipped}`` and emits the ``analysis.*`` telemetry vocabulary when a
    recorder is attached. An auto-spmd config raises NotImplementedError."""
    rec = rec or telemetry.get()
    devices = list(devices) if devices is not None else default_positions()
    return _sweep(configs, lambda cfg: audit_config(
        cfg, devices=devices, perturb_collectives=perturb_collectives,
        perturb_wire=perturb_wire, perturb_dmas=perturb_dmas), rec)


def audit_time(cfg: dict, devices=None, iters: int = 6,
               calibration: Optional[dict] = None,
               mad_k: float = 3.0, rel_tol: float = 0.75,
               rec: Optional["telemetry.Recorder"] = None,
               slow_s: float = 0.0) -> Verdict:
    """Time one config's exchange and judge the cost model's PREDICTION
    against the measured samples' band (``obs/attribution.judge_drift``):
    the platform's row prices it (``"cuda"`` on the card), or
    ``calibration``. ``rel_tol`` is wide (0.75): a handful of samples
    judges multiple-x staleness, not 5% drift. ``slow_s`` sleeps inside
    ONE timed iteration, the proof knob that the timed auditor trips."""
    import time as _time

    from ..obs import attribution
    from ..utils.sync import hard_sync

    rec = rec or telemetry.get()
    devices = list(devices) if devices is not None else default_positions()
    v = Verdict(label=cfg["label"], method=cfg["method"])
    got = _realize(cfg, devices, v)
    if got is None:
        return v
    _plan, config, choice, ex, state, _nblocks = got
    pred = attribution.predict_exchange(config, choice, calibration)
    if pred is None:
        v.skipped = True
        v.ok = False
        v.reason = "cost model prices this choice as infeasible"
        return v
    dev = ex.mesh.device if ex.mesh is not None else next(iter(state.values())).device
    ex(state)  # warm outside the timed window
    hard_sync(dev)
    samples: List[float] = []
    for i in range(max(2, iters)):
        t0 = _time.perf_counter()
        ex(state)
        hard_sync(dev)
        if slow_s and i == 0:
            _time.sleep(slow_s)  # the seeded-staleness proof knob
        samples.append(_time.perf_counter() - t0)
        attribution.emit_phase(rec, pred, samples[-1], phase="stencil.exchange",
                               kernel_variant=choice.kernel_variant)
    dv = attribution.judge_drift("stencil.exchange", pred.predicted_s, samples,
                                 mad_k=mad_k, rel_tol=rel_tol)
    attribution.emit_drift(rec, dv)
    v.checks.append({
        "name": "predicted_s_within_band",
        "predicted": f"{dv.predicted_s:.3e}s",
        "actual": f"measured band [{dv.lo:.3e}, {dv.hi:.3e}] "
                  f"(center {dv.center:.3e}s, n={dv.n})",
        "ok": dv.ok,
    })
    v.ok = bool(dv.ok)
    if not dv.ok:
        v.reason = dv.describe()
    return v


def run_time_sweep(configs: Sequence[dict], devices=None,
                   iters: int = 6, calibration: Optional[dict] = None,
                   mad_k: float = 3.0, rel_tol: float = 0.75,
                   slow_s: float = 0.0,
                   rec: Optional["telemetry.Recorder"] = None) -> Dict:
    """Timed-audit every config; the result and records of
    :func:`run_sweep`."""
    rec = rec or telemetry.get()
    devices = list(devices) if devices is not None else default_positions()
    return _sweep(configs, lambda cfg: audit_time(
        cfg, devices=devices, iters=iters, calibration=calibration, mad_k=mad_k,
        rel_tol=rel_tol, rec=rec, slow_s=slow_s), rec)

