"""The partition/method autotuner: static rank -> probe the top N -> persist.

The port's own copy of ``stencil_tpu.plan.autotune``. One call answers
"which exchange plan should this config run?": the plan DB
(``plan/db.py``) first, where a hit replays the stored choice with zero
probes; else the cost model ranks the candidates (``plan/cost.py``), the
top ``top_n`` are timed (``plan/probe.py``), and the winner is stored.
The telemetry says which path ran: the ``plan.cache_hit`` gauge (1 on a DB
hit), the ``plan.probes_run`` counter, the ``plan.candidates`` gauge and the
``plan.chosen`` meta with the choice and its provenance.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import torch

from ..geometry import Dim3, Radius
from ..utils import logging as log
from . import db as plandb
from .cost import DEFAULT_VARIANTS, default_provenance, enumerate_candidates, rank
from .ir import AXIS_COMPOSED, DIRECT26, REMOTE_DMA, PlanChoice, PlanConfig

# what the port's exchange realizes: every method on one device and over a
# mesh of positions (parallel/exchange.py), as the JAX package's autotune
# offers every method over devices; never AUTO_SPMD
ONE_DEVICE_METHODS = (AXIS_COMPOSED, DIRECT26, REMOTE_DMA)
MESH_METHODS = (AXIS_COMPOSED, DIRECT26, REMOTE_DMA)


@dataclass
class AutotuneResult:
    config: PlanConfig
    choice: PlanChoice
    source: str                 # 'db' | 'probe' | 'static'
    cache_hit: bool
    probes_run: int
    candidates: int
    entry: Optional[dict] = None
    ranked: List[Tuple[object, PlanChoice]] = field(default_factory=list)
    probes: List[dict] = field(default_factory=list)
    # what priced the ranking: the override (None = the platform's
    # constants) and its provenance, stamped into plan.chosen
    calibration: Optional[dict] = None
    calibration_provenance: str = "modeled(default)"


def default_choice(config: PlanConfig) -> PlanChoice:
    """What a plan-less realize() of the JAX package does: NodePartition's
    min-interface split over the devices, AXIS_COMPOSED, batching on."""
    from ..geometry import NodePartition

    d = NodePartition(Dim3.of(config.grid), config.radius_obj(), 1, config.ndev).dim()
    return PlanChoice(partition=(d.x, d.y, d.z), method=AXIS_COMPOSED, batch_quantities=True)


def live_methods(ndev: int) -> Tuple[str, ...]:
    """The methods a domain over ``ndev`` positions realizes: AXIS_COMPOSED,
    DIRECT26 and REMOTE_DMA, on one device and over a mesh. Never AUTO_SPMD
    (ROADMAP.md queue A item 5)."""
    return ONE_DEVICE_METHODS if ndev == 1 else MESH_METHODS


def autotune(size, radius: Radius, dtypes: Sequence[str], ndev: Optional[int] = None,
             devices=None, db_path: Optional[str] = None, platform: Optional[str] = None,
             top_n: int = 3, probe_iters: int = 4, probe: bool = True, force: bool = False,
             methods: Optional[Sequence[str]] = None, ks: Sequence[int] = (1,),
             variants: Sequence[Optional[str]] = DEFAULT_VARIANTS,
             calibration: Optional[dict] = None, link_costs=None, rec=None) -> AutotuneResult:
    """Choose (and store) the exchange plan for one config.

    ``devices`` are the probes' devices: one, or a mesh of positions (a list
    that may name one card several times); ``ndev`` is their number and
    ``platform`` their ``torch.device(...).type`` ("cuda" or "cpu"). With
    neither ``devices`` nor ``ndev``/``platform`` the current CUDA device
    is used. ``methods`` defaults to what the devices realize
    (:func:`live_methods`): AXIS_COMPOSED, DIRECT26 and REMOTE_DMA, on one
    device and over a mesh; never AUTO_SPMD.

    ``probe=False`` ranks statically only (no device work); ``force=True``
    re-tunes through an existing entry and replaces it. A corrupt DB is
    reported and left as it is: the tuning runs, nothing is stored. A DB
    entry whose method is not among ``methods`` is re-tuned and replaced. A
    fitted calibration row in the DB for this platform prices the ranking
    unless ``calibration`` is given. ``link_costs`` is None for positions on
    one card (uniform links; placement is identity); there is one host, so
    no hierarchical candidate is enumerated."""
    from ..obs import telemetry

    rec = rec or telemetry.get()
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        ndev = len(devices)
        platform = platform or devices[0].type
    if ndev is None or platform is None:
        from ..api import resolve_device

        dev = resolve_device(None)
        if devices is None:
            devices = [dev]
        ndev = ndev if ndev is not None else 1
        platform = platform or dev.type
    if methods is None:
        methods = live_methods(ndev)
    config = PlanConfig.make(size, radius, dtypes, ndev, platform)

    db = None
    db_ok = False
    if db_path:
        try:
            db = plandb.load_db(db_path)
            db_ok = True
        except plandb.PlanDBError as e:
            log.warn(f"plan DB {db_path} rejected ({e}); tuning without persistence - fix or "
                     "remove the file")
    cal_provenance = (default_provenance(platform) if calibration is None
                      else str(calibration.get("provenance", "override")))
    if calibration is None and db is not None:
        cal_row = plandb.lookup_calibration(db, platform)
        if cal_row is not None:
            calibration = cal_row["calibration"]
            cal_provenance = str(cal_row.get("provenance", "fitted"))
            log.info(f"plan calibration: {cal_provenance} (from {db_path})")
    if db is not None and not force:
        entry = plandb.lookup(db, config)
        if entry is not None and entry["choice"].get("method") not in methods:
            # e.g. an entry of a method the caller left out: tune, and
            # replace it
            log.warn(f"plan DB entry {PlanChoice.from_json(entry['choice']).label()} uses a "
                     f"method these devices do not realize ({', '.join(methods)}); re-tuning")
            entry = None
        if entry is not None:
            choice = PlanChoice.from_json(entry["choice"])
            rec.gauge("plan.cache_hit", 1, phase="plan")
            rec.counter("plan.probes_run", value=0, phase="plan")
            rec.meta("plan.chosen", choice=entry["choice"], source="db",
                     db_source=entry.get("source"), key=config.key(),
                     calibration=cal_provenance)
            log.info(f"plan DB hit: {choice.label()} (tuned by {entry.get('source')}) - "
                     "zero probes")
            return AutotuneResult(config=config, choice=choice, source="db", cache_hit=True,
                                  probes_run=0, candidates=0, entry=entry,
                                  calibration=calibration,
                                  calibration_provenance=cal_provenance)

    with rec.span("plan.autotune", phase="plan"):
        candidates = enumerate_candidates(config, methods=methods, ks=ks, variants=variants,
                                          link_costs=link_costs)
        ranked = rank(config, candidates, calibration, link_costs=link_costs)
        if not ranked:
            raise ValueError(f"no feasible exchange plan for {config.key()} - grid too small "
                             f"for every partition of {config.ndev} positions?")
        rec.gauge("plan.candidates", len(ranked), phase="plan")
        probes: List[dict] = []
        measured = None
        if probe:
            from .probe import refine

            if devices is None:
                from ..api import resolve_device

                devices = [resolve_device("cpu" if platform == "cpu" else None)] * ndev
            measured, probes = refine(config, ranked, top_n=top_n, iters=probe_iters,
                                      devices=devices)
        n_probes = sum(1 for p in probes if "trimean_s" in p)
        rec.counter("plan.probes_run", value=n_probes, phase="plan")
        rec.gauge("plan.cache_hit", 0, phase="plan")
        if measured is not None:
            choice, source = measured, "probe"
            measured_s = min(p["trimean_s"] for p in probes
                             if "trimean_s" in p and p["label"] == choice.label())
        else:
            choice, source = ranked[0][1], "static"
            measured_s = None
        static_cost = next((c.total_s for c, ch in ranked if ch == choice), None)
        rec.meta("plan.chosen", choice=choice.to_json(), source=source, key=config.key(),
                 calibration=cal_provenance)
        log.info(f"plan autotuned: {choice.label()} via {source} ({n_probes} probes over "
                 f"{len(ranked)} candidates)")

    entry = plandb.make_entry(config, choice, source, static_cost_s=static_cost,
                              measured_s=measured_s, probes=probes)
    if db is not None and db_ok:
        plandb.record(db, entry)
        plandb.save_db(db_path, db)
    return AutotuneResult(config=config, choice=choice, source=source, cache_hit=False,
                          probes_run=n_probes, candidates=len(ranked), entry=entry,
                          ranked=ranked, probes=probes, calibration=calibration,
                          calibration_provenance=cal_provenance)
