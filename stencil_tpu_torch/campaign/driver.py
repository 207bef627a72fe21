"""Multi-tenant batched campaigns: one program, many small domains.

The port's counterpart of ``stencil_tpu.campaign.driver``. Floods of small
independent periodic boxes of one workload (jacobi heat, or 8-field
Astaroth MHD) are served in fixed-size batch slots:

- **Queue -> slots.** Tenant jobs queue FIFO; the driver packs them into
  slots of ``slot_size`` lanes, bucketed by shape (grid, dtype, workload):
  a slot's program depends only on its bucket. When the queue drains below
  a full slot, the empty lanes are dead tenants (zeros, never attributed).
- **Batched stepping.** A slot's state is one ``(B, pz, py, px)`` stack per
  quantity on the driver's device. Jacobi tenants step through
  ``ops/jacobi.make_batched_jacobi_loop`` (on the card one launch of the
  tenant-form sweep kernel per step); Astaroth tenants through
  ``astaroth/integrate.make_batched_astaroth_step`` (on the card, per step,
  3 launches of the fill's tenant form and 3 of the substep kernel's tenant
  table). Each tenant is its own periodic box, nothing crosses the tenant
  axis, and one program serves every same-shape slot through the
  :class:`~.compile_cache.CompileCache`.
- **Guarded slots.** Each slot segment runs through
  ``fault/recover.run_guarded`` with a per-lane
  :class:`~.health.SlotHealthGuard` and an optional
  :class:`~.inject.SlotInjector`. A transient fault rolls the whole slot
  back to the last health-checked stash (deterministic recompute keeps every
  lane bit-identical); a tenant that exhausts ``max_rollbacks`` is EVICTED
  with the rc-43 evidence bundle, its last healthy state written as a
  revivable snapshot, its lane backfilled from the queue (or dead), and the
  survivors resume from the stash, finishing bit-identical to an uninjected
  campaign.
- **Per-tenant durable state.** Every tenant owns a snapshot dir
  ``<campaign_dir>/tenants/<tid>`` (``ckpt/``, the JAX package's format);
  completion and eviction always write a snapshot, and ``resume=True``
  packs a tenant from its newest valid one.

The port's kernels write in place where JAX arrays are immutable, so three
things the JAX driver gets from immutability are explicit here: the
rollback stash is a clone on the device (a stash that shared tensors with
the live state would be overwritten by the next chunk), a restore hands
back a fresh clone of it, and the workload carries each quantity's
(curr, scratch) pair and swaps it (after an odd number of steps the new
curr is the old scratch tensor). Injections and backfills write into the
live slot tensors in place.

:func:`run_sequential` serves the same jobs one tenant at a time through
``DistributedDomain`` + ``make_jacobi_loop`` on the same device: the A/B
baseline (aggregate Mcells/s and p50/p99 per-step latency).

Entry points run on the current CUDA device unless ``device="cpu"`` is
passed. ``batch_devices`` is not carried over (a slot lives on one device).
The live sentinel, status file and plan hot-swap wait for ``obs/live``,
``obs/status`` and ``plan/replan`` (ROADMAP.md queue A item 4): the
driver's ``sentinel``, ``status`` and ``replan`` stay None, so a serving
layer's guards read as in the JAX package.
"""

from __future__ import annotations

import os
import shutil
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api import DistributedDomain, resolve_device
from ..ckpt import assemble_global, check_compatible, find_resume, write_snapshot
from ..domain.grid import GridSpec
from ..fault import RecoveryExhausted, RecoveryPolicy, chunk_plan, run_guarded
from ..fault.inject import FaultPlan
from ..geometry import Dim3, Radius
from ..obs import FAULT_RC, telemetry
from ..ops.jacobi import (INIT_TEMP, make_batched_jacobi_loop, make_jacobi_loop, sphere_sel,
                          sphere_sel_blocks)
from ..parallel.exchange import Method
from ..plan.ir import PlanConfig
from ..utils import logging as log
from ..utils.statistics import percentile
from ..utils.sync import hard_sync
from .compile_cache import CompileCache, cache_key
from .health import SlotHealthGuard, TenantFault
from .inject import SlotInjector

QUANTITY = "temperature"


@dataclass
class TenantJob:
    """One queued simulation: an independent periodic box of one workload:
    ``"jacobi"`` (single-quantity heat) or ``"astaroth"`` (8-field MHD
    through ``make_batched_astaroth_step``)."""

    tid: str
    size: Tuple[int, int, int]      # (x, y, z)
    steps: int
    dtype: str = "float32"
    seed: int = 0
    workload: str = "jacobi"
    # Optional per-step latency SLO (milliseconds): while the tenant's lane
    # is live, its online p99 step latency is tracked against it and a
    # breach emits one `slo.violation` record. Never joins the bucket.
    deadline_ms: Optional[float] = None

    def bucket(self) -> Tuple[Tuple[int, int, int], str, str]:
        """The shape bucket: jobs in one slot share it."""
        return (tuple(int(v) for v in self.size), str(self.dtype),
                str(self.workload))


@dataclass
class TenantResult:
    tid: str
    outcome: str                    # "done" | "fault"
    steps: int                      # tenant steps completed
    snapshot_dir: str
    evidence: Optional[str] = None
    final: Optional[np.ndarray] = None   # global [z,y,x] interior ("done",
    #                                      the workload's first quantity)
    finals: Optional[Dict[str, np.ndarray]] = None  # every quantity ("done")


@dataclass
class Lane:
    """One slot position: which tenant occupies it and the step anchors
    mapping the slot clock to the tenant clock (backfilled lanes run offset
    from the slot's step counter)."""

    idx: int
    tenant: Optional[TenantJob] = None
    start_slot_step: int = 0
    start_tenant_step: int = 0

    def tenant_step(self, slot_step: int) -> int:
        return self.start_tenant_step + (slot_step - self.start_slot_step)

    def end_slot_step(self) -> int:
        if self.tenant is None:
            raise RuntimeError("end_slot_step on an empty (dead) lane")
        return self.start_slot_step + (self.tenant.steps
                                       - self.start_tenant_step)


def tenant_init_field(job: TenantJob) -> np.ndarray:
    """The one authority for a tenant's initial temperature field
    (``[z, y, x]``): the jacobi lukewarm baseline plus a seeded perturbation,
    the JAX package's field bit for bit. The driver, the sequential
    baseline, revival and the parity tests all regenerate step 0 from
    this."""
    x, y, z = job.size
    rng = np.random.RandomState(job.seed & 0x7FFFFFFF)
    f = INIT_TEMP + 0.05 * rng.standard_normal((z, y, x))
    return f.astype(job.dtype)


def astaroth_init_state(job: TenantJob) -> Dict[str, np.ndarray]:
    """The one authority for an astaroth tenant's step-0 fields: small
    seeded perturbations per field, lnrho offset to a positive density (the
    JAX package's fields bit for bit)."""
    from ..astaroth.integrate import FIELDS

    x, y, z = job.size
    rng = np.random.RandomState((job.seed ^ 0x5A57A407) & 0x7FFFFFFF)
    state = {}
    for k in FIELDS:
        f = rng.standard_normal((z, y, x)) * 0.05
        if k == "lnrho":
            f = f + 0.5
        state[k] = f.astype(job.dtype)
    return state


class _JacobiWorkload:
    """Single-quantity periodic heat."""

    default_radius = 1
    needs_sel = True

    def quantity_names(self, job_dtype: str):
        return [QUANTITY]

    def init_state(self, job: TenantJob) -> Dict[str, np.ndarray]:
        return {QUANTITY: tenant_init_field(job)}

    def build_loop(self, spec, iters: int, device):
        return make_batched_jacobi_loop(spec, iters, device=device)

    def step(self, loop, state: Dict, scratch: Dict, sel) -> Dict:
        """Advance the slot. ``scratch`` holds the other buffer of each
        quantity's (curr, scratch) pair and is updated in place: the loop
        writes into it, so the pair swaps with every step."""
        c, scratch[QUANTITY] = loop(state[QUANTITY], scratch[QUANTITY], sel)
        return {QUANTITY: c}


class _AstarothWorkload:
    """8-field MHD tenants through ``make_batched_astaroth_step``: no sel (no
    sphere sources), radius 3 (6th-order cross stencils), one reference
    swap-per-iteration RK3 step per slot step, the conf read from the
    port's own ``astaroth/astaroth.conf`` with the tenant's extents."""

    default_radius = 3
    needs_sel = False
    dt = 1e-8

    def quantity_names(self, job_dtype: str):
        from ..astaroth.integrate import FIELDS

        return list(FIELDS)

    def init_state(self, job: TenantJob) -> Dict[str, np.ndarray]:
        return astaroth_init_state(job)

    def _info(self, spec):
        from ..astaroth import config as ac_config

        conf = os.path.join(os.path.dirname(__file__), "..", "astaroth", "astaroth.conf")
        info, _ok = ac_config.load_config(conf)
        b = spec.base
        info.int_params["AC_nx"] = int(b.x)
        info.int_params["AC_ny"] = int(b.y)
        info.int_params["AC_nz"] = int(b.z)
        info.update_builtin_params()
        return info

    def build_loop(self, spec, iters: int, device):
        from ..astaroth.integrate import make_batched_astaroth_step

        return make_batched_astaroth_step(spec, self._info(spec), dt=self.dt, iters=iters,
                                          device=device)

    def step(self, loop, state: Dict, scratch: Dict, sel) -> Dict:
        """Advance the slot; ``scratch`` (every field's other buffer) is
        updated in place to the pair's new out buffers."""
        curr, out = loop(state, scratch)
        curr = dict(curr)  # after an odd number of steps it is ``scratch`` itself
        scratch.update(out)
        return curr


WORKLOADS = {"jacobi": _JacobiWorkload(), "astaroth": _AstarothWorkload()}


def _clone(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {name: t.clone() for name, t in state.items()}


def _host(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {name: t.cpu().numpy() for name, t in state.items()}


def pick_slot(queue: deque,
              slot_size: int) -> Tuple[Tuple, List[TenantJob], deque]:
    """Pop the next slot's jobs: the queue head's bucket, same-bucket jobs
    pulled forward FIFO until the slot fills. Returns ``(bucket, picked,
    remaining-queue)``: the one packing policy, shared by the driver and
    the :func:`plan_slots` preview."""
    bucket = queue[0].bucket()
    picked: List[TenantJob] = []
    rest: List[TenantJob] = []
    for j in queue:
        if j.bucket() == bucket and len(picked) < slot_size:
            picked.append(j)
        else:
            rest.append(j)
    return bucket, picked, deque(rest)


def plan_slots(jobs: Sequence[TenantJob],
               slot_size: int) -> List[Tuple[Tuple, List[str]]]:
    """Deterministic packing preview: ``[(bucket, [tids...]), ...]`` in the
    order the driver forms slots (:func:`pick_slot`). Pure: no device, no
    state."""
    queue = deque(jobs)
    out: List[Tuple[Tuple, List[str]]] = []
    while queue:
        bucket, picked, queue = pick_slot(queue, slot_size)
        out.append((bucket, [j.tid for j in picked]))
    return out


def _check_workloads(jobs: Sequence[TenantJob]) -> None:
    for j in jobs:
        if j.workload not in WORKLOADS:
            raise ValueError(f"tenant {j.tid}: unknown workload {j.workload!r} "
                             f"(known: {sorted(WORKLOADS)})")


class CampaignDriver:
    """Serve a queue of tenant jobs through fixed-size batch slots on one
    device (default: the current CUDA device)."""

    def __init__(
        self,
        jobs: Sequence[TenantJob],
        slot_size: int,
        campaign_dir: str,
        *,
        device=None,
        radius: Optional[int] = None,
        chunk: int = 2,
        ckpt_every: int = 0,
        ckpt_keep: int = 3,
        health_every: int = 0,
        max_abs: Optional[float] = None,
        max_rollbacks: int = 2,
        rollback_backoff: float = 0.05,
        inject: Optional[str] = None,
        inject_seed: int = 0,
        resume: bool = False,
        cache: Optional[CompileCache] = None,
        slo_min_samples: int = 3,
    ):
        if slot_size < 1:
            raise ValueError(f"slot_size must be >= 1, got {slot_size}")
        tids = [j.tid for j in jobs]
        if len(set(tids)) != len(tids):
            raise ValueError("tenant ids must be unique")
        _check_workloads(jobs)
        self.jobs = list(jobs)
        self.slot_size = int(slot_size)
        self.campaign_dir = campaign_dir
        self.device = resolve_device(device)
        # None = the workload's default radius
        self.radius = None if radius is None else int(radius)
        self.chunk = max(1, int(chunk))
        self.ckpt_every = int(ckpt_every)
        self.ckpt_keep = int(ckpt_keep)
        self.health_every = int(health_every) or self.chunk
        self.max_abs = max_abs
        self.policy = RecoveryPolicy(max_rollbacks=max_rollbacks,
                                     backoff_s=rollback_backoff)
        self.inject_spec = inject or None
        self.inject_seed = inject_seed
        self.resume = bool(resume)
        self.cache = cache if cache is not None else CompileCache()
        # the live sentinel, status writer and plan hot-swap (ROADMAP.md
        # queue A item 4): None until obs/live, obs/status and plan/replan
        # are ported
        self.sentinel = None
        self.status = None
        self.replan = None
        # a tenant's online p99 is judged against its deadline only once this
        # many latency samples exist (one cold chunk must not condemn a tenant)
        self.slo_min_samples = max(1, int(slo_min_samples))
        self._lane_lat: Dict[str, deque] = {}
        self._slo_violated: set = set()
        # the running slot's lanes and width, published for a serving
        # layer's chunk-boundary capacity decisions
        self._cur_lanes: List[Lane] = []
        self._cur_width: int = self.slot_size

    # -- serving extension points ---------------------------------------------
    # A serving layer subclasses the driver and overrides these hooks; the
    # batch campaign is the degenerate case (a queue fixed at launch). Every
    # hook sits at a point the slot machinery already treats as safe.

    def _refresh_queue(self, queue) -> None:
        """Grow ``queue`` IN PLACE from an external intake. Called before
        every backfill scan and once per chunk, so a job admitted here lands
        in a running slot's next freed lane."""

    def _observe_chunk(self, bucket, per: float, done_now: int) -> None:
        """Per-chunk serving observation; ``per`` is the chunk's per-step
        wall."""

    def _publish(self, results: Dict[str, "TenantResult"],
                 r: "TenantResult") -> None:
        """The one place a tenant's terminal result lands: every retire /
        evict / revived-complete path funnels through here."""
        results[r.tid] = r
        self._on_result(r)

    def _on_result(self, r: "TenantResult") -> None:
        """A tenant result was just published."""

    def _on_backfill(self, job: "TenantJob", lane_idx: int,
                     slot_step: int) -> None:
        """A queued tenant just took over a freed lane mid-slot."""

    def _backfill_gate(self, bucket) -> bool:
        """May a freed lane refill from the queue right now? A serving layer
        vetoes (False) to let the slot drain for an overdue job of another
        bucket."""
        return True

    def _segment_end(self, slot_step: int, end: int) -> int:
        """Cap a guarded segment's end step (must return in
        ``(slot_step, end]``); the batch campaign runs each segment to the
        earliest lane event."""
        return end

    def _should_park(self) -> bool:
        """True = stop the slot at the next segment boundary and park every
        live lane as a revivable snapshot (graceful drain)."""
        return False

    def _on_park(self, job: "TenantJob", tenant_step: int) -> None:
        """A live lane was parked at ``tenant_step`` (snapshot durable)."""

    # -- per-tenant durable state ---------------------------------------------
    def tenant_dir(self, tid: str) -> str:
        return os.path.join(self.campaign_dir, "tenants", tid)

    def _write_tenant_snapshot(self, job: TenantJob, spec: GridSpec,
                               lane_state: Dict[str, np.ndarray],
                               step: int) -> None:
        p = spec.padded()
        arrs = {name: np.ascontiguousarray(a.reshape(1, 1, 1, p.z, p.y, p.x))
                for name, a in lane_state.items()}
        write_snapshot(self.tenant_dir(job.tid), step, spec, arrs,
                       dtypes={name: job.dtype for name in arrs},
                       keep=self.ckpt_keep)

    def _resume_tenant(self, job: TenantJob
                       ) -> Optional[Tuple[int, Dict[str, np.ndarray]]]:
        """The newest valid compatible snapshot of a revived tenant:
        ``(tenant_step, {quantity: global [z,y,x]})`` or None (fresh)."""
        if not self.resume:
            return None
        names = WORKLOADS[job.workload].quantity_names(job.dtype)
        x, y, z = job.size
        found = find_resume(
            self.tenant_dir(job.tid),
            accept=lambda m: check_compatible(
                m, Dim3(x, y, z), names, [job.dtype] * len(names)))
        if found is None:
            return None
        snap, manifest = found
        g = {name: assemble_global(snap, manifest, name, dtype=job.dtype)
             for name in names}
        log.info(f"campaign: revived tenant {job.tid} from step "
                 f"{manifest['step']} ({snap})")
        return int(manifest["step"]), g

    # -- programs ---------------------------------------------------------------
    def _loop(self, spec: GridSpec, bucket, iters: int, batch: Optional[int] = None):
        (size, dtype, workload) = bucket
        wl = WORKLOADS[workload]
        b = int(batch) if batch else self.slot_size
        nq = len(wl.quantity_names(dtype))
        cfg = PlanConfig.make(Dim3(*size), spec.radius, [dtype] * nq, 1,
                              self.device.type)
        # the JAX package's key: `pallas` says whether the slot program
        # runs the hand-written kernel (here: on the card), `devices` lists
        # the device ids; batch= keys the slot width
        key = cache_key(cfg, workload=f"{workload}-batched", batch=b,
                        iters=int(iters), pallas=self.device.type == "cuda",
                        devices=[self.device.index or 0])
        return self.cache.get(key, lambda: wl.build_loop(spec, iters, self.device))

    # -- the campaign -------------------------------------------------------------
    def run(self) -> dict:
        rec = telemetry.get()
        os.makedirs(self.campaign_dir, exist_ok=True)
        queue = deque(self.jobs)
        results: Dict[str, TenantResult] = {}
        lat: List[float] = []        # per-chunk per-step wall samples
        cell_steps = 0
        wall = 0.0
        slot_idx = 0
        t0 = time.perf_counter()
        while queue:
            bucket, picked, queue = pick_slot(queue, self.slot_size)
            stats = self._run_slot(slot_idx, bucket, picked, queue, results)
            lat.extend(stats["latency_samples"])
            cell_steps += stats["cell_steps"]
            wall += stats["wall_s"]
            slot_idx += 1
        agg = cell_steps / wall / 1e6 if wall > 0 else 0.0
        summary = {
            "results": results,
            "tenants": len(self.jobs),
            "slots": slot_idx,
            "cell_steps": cell_steps,
            "step_wall_s": wall,
            "total_wall_s": time.perf_counter() - t0,
            "aggregate_mcells_per_s": agg,
            "p50_step_s": percentile(lat, 50) if lat else float("nan"),
            "p99_step_s": percentile(lat, 99) if lat else float("nan"),
            "evicted": sorted(t for t, r in results.items()
                              if r.outcome == "fault"),
            "slo_violations": sorted(self._slo_violated),
            "cache": self.cache.stats(),
        }
        rec.meta("campaign.summary", slots=slot_idx,
                 tenants=len(self.jobs), evicted=len(summary["evicted"]),
                 slo_violations=len(summary["slo_violations"]),
                 cache_hits=self.cache.hits, cache_misses=self.cache.misses)
        return summary

    def _run_slot(self, slot_idx: int, bucket, initial: List[TenantJob],
                  queue: deque, results: Dict[str, TenantResult],
                  width: Optional[int] = None) -> dict:
        """Run one slot. ``width`` overrides ``slot_size`` for this slot
        only (an elastic serving layer sizes slots to its queue)."""
        rec = telemetry.get()
        dev = self.device
        (size, dtype, workload) = bucket
        wl = WORKLOADS[workload]
        names = wl.quantity_names(dtype)
        radius = self.radius if self.radius is not None else wl.default_radius
        x, y, z = size
        cells = x * y * z
        # the kernel takes offsets and strides: no tile padding on either device
        spec = GridSpec(Dim3(x, y, z), Dim3(1, 1, 1), Radius.constant(radius),
                        aligned=False)
        p = spec.padded()
        off = spec.compute_offset()
        B = int(width) if width else self.slot_size
        inner = (slice(off.z, off.z + z), slice(off.y, off.y + y), slice(off.x, off.x + x))

        # jacobi: the standard hot/cold spheres, one copy per tenant (the
        # kernel reads a (B, pz, py, px) sel, as the TPU kernel does);
        # astaroth has no source geometry
        sel = None
        if wl.needs_sel:
            sel_np = np.zeros((p.z, p.y, p.x), np.int32)
            sel_np[inner] = sphere_sel((x, y, z))
            sel = torch.from_numpy(sel_np).to(dev).expand(B, -1, -1, -1).contiguous()

        lanes = [Lane(i) for i in range(B)]
        self._cur_lanes = lanes
        self._cur_width = B

        def interior(padded: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
            return {name: np.ascontiguousarray(a[inner]) for name, a in padded.items()}

        def lane_init(job: TenantJob) -> Tuple[int, Dict[str, np.ndarray]]:
            revived = self._resume_tenant(job)
            t0_step, g = revived if revived is not None else (0, wl.init_state(job))
            padded = {}
            for name in names:
                a = np.zeros((p.z, p.y, p.x), dtype)
                a[inner] = g[name]
                padded[name] = a
            return t0_step, padded

        def finish_revived(job: TenantJob, padded) -> None:
            """A tenant revived at or past its target: report it done."""
            fins = interior(padded)
            self._publish(results, TenantResult(
                job.tid, "done", job.steps, self.tenant_dir(job.tid),
                final=fins[names[0]], finals=fins))

        curr_np = {name: np.zeros((B, p.z, p.y, p.x), dtype) for name in names}
        for i, job in enumerate(initial):
            t0_step, padded = lane_init(job)
            if t0_step >= job.steps:
                finish_revived(job, padded)  # the lane waits for a backfill
                continue
            lanes[i].tenant = job
            lanes[i].start_slot_step = 0
            lanes[i].start_tenant_step = t0_step
            for name in names:
                curr_np[name][i] = padded[name]
        curr = {name: torch.from_numpy(a).to(dev) for name, a in curr_np.items()}
        scratch = {name: torch.zeros_like(t) for name, t in curr.items()}
        del curr_np

        guard = SlotHealthGuard(every=self.health_every, max_abs=self.max_abs)
        guard.bind(
            lambda lane: (lanes[lane].tenant.tid
                          if lanes[lane].tenant is not None else None),
            lambda lane, step: lanes[lane].tenant_step(step))
        injector = None
        if self.inject_spec:
            plan = FaultPlan.from_spec(self.inject_spec, seed=self.inject_seed)
            if plan is not None:
                injector = SlotInjector(plan, spec, lambda: lanes,
                                        known_tenants=[j.tid for j in self.jobs])
        rec.meta("campaign.slot", slot=slot_idx,
                 tenants=[l.tenant.tid for l in lanes if l.tenant],
                 bucket={"size": list(size), "dtype": dtype, "workload": workload},
                 devices=1, width=B)

        def backfill(lane: Lane, slot_step: int, state: Dict):
            """Replace a retired/evicted lane from the queue (same bucket
            only) or mark it dead (zeros), writing the lane of every
            quantity of ``state`` in place; returns ``state``."""
            self._refresh_queue(queue)
            job = None
            if self._backfill_gate(bucket):
                for cand in list(queue):
                    if cand.bucket() == bucket:
                        job = cand
                        queue.remove(cand)
                        break
            if job is None:
                lane.tenant = None
                for name in names:
                    state[name][lane.idx] = 0
                return state
            t0_step, padded = lane_init(job)
            if t0_step >= job.steps:
                finish_revived(job, padded)
                return backfill(lane, slot_step, state)
            lane.tenant = job
            lane.start_slot_step = slot_step
            lane.start_tenant_step = t0_step
            rec.meta("campaign.backfill", tenant=job.tid, lane=lane.idx,
                     slot=slot_idx, slot_step=int(slot_step))
            self._on_backfill(job, lane.idx, int(slot_step))
            for name in names:
                state[name][lane.idx] = torch.from_numpy(padded[name])
            return state

        # -- the guarded slot loop -------------------------------------------
        slot_step = 0
        stash: Tuple[int, dict] = (0, {})  # taken at each segment start
        lat: List[float] = []
        cell_steps = 0
        wall = 0.0

        def step_fn(st, k):
            loop = self._loop(spec, bucket, k, B)
            out = wl.step(loop, st, scratch, sel)
            hard_sync(dev)
            return out

        def lane_stats(lane: Lane):
            """(p50_ms, p99_ms) of the lane's tenant over its online latency
            window, or (None, None) before any sample."""
            if lane.tenant is None:
                return None, None
            samples = self._lane_lat.get(lane.tenant.tid)
            if not samples:
                return None, None
            return percentile(samples, 50) * 1e3, percentile(samples, 99) * 1e3

        def check_slo(done_now: int) -> None:
            """Judge every live lane's online p99 against its deadline; a
            breach emits one slo.violation per tenant."""
            for l in lanes:
                job = l.tenant
                if job is None or job.deadline_ms is None:
                    continue
                samples = self._lane_lat.get(job.tid)
                if (not samples or len(samples) < self.slo_min_samples
                        or job.tid in self._slo_violated):
                    continue
                p50_ms, p99_ms = lane_stats(l)
                if p99_ms > job.deadline_ms:
                    self._slo_violated.add(job.tid)
                    rec.meta("slo.violation", tenant=job.tid,
                             step=int(l.tenant_step(done_now)), lane=l.idx,
                             slot=slot_idx, phase="slo",
                             deadline_ms=float(job.deadline_ms),
                             p99_ms=p99_ms, p50_ms=p50_ms, samples=len(samples))
                    log.warn(f"campaign: SLO VIOLATION tenant {job.tid} (lane {l.idx}): "
                             f"online p99 {p99_ms:.3g} ms > deadline "
                             f"{job.deadline_ms:g} ms")

        def on_chunk(st, k, per, done_now):
            nonlocal cell_steps, wall
            n_active = sum(1 for l in lanes if l.tenant is not None)
            lat.append(per)
            cell_steps += k * n_active * cells
            wall += per * k
            rec.gauge("campaign.step_latency_s", per, phase="step",
                      unit="s", mode="batched", slot=slot_idx, iters=k)
            # every live lane stepped together: the chunk's per-step wall is
            # each live tenant's sample
            for l in lanes:
                if l.tenant is not None:
                    self._lane_lat.setdefault(
                        l.tenant.tid, deque(maxlen=256)).append(per)
            self._refresh_queue(queue)
            self._observe_chunk(bucket, per, done_now)
            check_slo(done_now)

        def save_fn(s, st):
            nonlocal stash
            stash = (s, _clone(st))
            host = _host(st)
            for l in lanes:
                if l.tenant is None:
                    continue
                self._write_tenant_snapshot(
                    l.tenant, spec, {name: host[name][l.idx] for name in names},
                    l.tenant_step(s))

        def restore_fn():
            s, st = stash
            return s, _clone(st)

        while any(l.tenant is not None for l in lanes):
            if self._should_park():
                # graceful drain: every live lane's current state becomes a
                # revivable snapshot and the slot ends here
                host = _host(curr)
                for l in lanes:
                    if l.tenant is None:
                        continue
                    tstep = l.tenant_step(slot_step)
                    self._write_tenant_snapshot(
                        l.tenant, spec, {name: host[name][l.idx] for name in names}, tstep)
                    self._on_park(l.tenant, tstep)
                    l.tenant = None
                break
            end = min(l.end_slot_step() for l in lanes if l.tenant is not None)
            end = self._segment_end(slot_step, end)
            state = dict(curr)
            stash = (slot_step, _clone(state))

            def plan_fn(s):
                return chunk_plan(
                    s, end, self.chunk, every=(self.ckpt_every, guard.every),
                    at=injector.steps() if injector is not None else ())

            try:
                state, done = run_guarded(
                    state, start=slot_step, iters=end, plan_fn=plan_fn,
                    step_fn=step_fn, guard=guard, injector=injector,
                    policy=self.policy,
                    save_fn=save_fn if self.ckpt_every > 0 else None,
                    ckpt_every=self.ckpt_every, restore_fn=restore_fn,
                    on_chunk=on_chunk, spec=None, ckpt_dir=self.campaign_dir,
                    evidence_dir=self.campaign_dir, app="campaign")
            except RecoveryExhausted as e:
                curr = self._evict(e, spec, lanes, stash, backfill, results, slot_idx, names)
                slot_step = stash[0]
                continue
            slot_step = done
            curr = dict(state)
            # the segment end passed a health check (run_guarded checks at
            # done >= iters): retire every lane whose tenant is complete
            host = _host(curr)
            for l in lanes:
                if l.tenant is None or l.tenant_step(slot_step) < l.tenant.steps:
                    continue
                job = l.tenant
                lane_host = {name: host[name][l.idx] for name in names}
                self._write_tenant_snapshot(job, spec, lane_host, job.steps)
                fins = interior(lane_host)
                self._publish(results, TenantResult(
                    job.tid, "done", job.steps, self.tenant_dir(job.tid),
                    final=fins[names[0]], finals=fins))
                rec.meta("campaign.retire", tenant=job.tid, step=int(job.steps),
                         lane=l.idx, slot=slot_idx)
                curr = backfill(l, slot_step, curr)

        self._cur_lanes = []
        return {"latency_samples": lat, "cell_steps": cell_steps, "wall_s": wall}

    def _evict(self, e: RecoveryExhausted, spec: GridSpec, lanes: List[Lane], stash,
               backfill, results, slot_idx: int, names: Sequence[str]):
        """The rc-43 eviction path: evidence moves to the tenant dir, the
        tenant's last healthy state becomes a revivable snapshot, the lane
        is backfilled, and the slot resumes from (a clone of) the stash."""
        rec = telemetry.get()
        f = e.fault
        if not isinstance(f, TenantFault):
            raise e  # unattributable: nothing sane to evict
        lane = lanes[f.lane]
        if lane.tenant is None or lane.tenant.tid != f.tenant:
            raise e  # the lane moved under us: refuse to evict blindly
        job = lane.tenant
        tdir = self.tenant_dir(job.tid)
        os.makedirs(tdir, exist_ok=True)
        evidence = None
        if e.evidence_path and os.path.isfile(e.evidence_path):
            evidence = os.path.join(tdir, "fault-evidence.json")
            shutil.move(e.evidence_path, evidence)
        sstep, sstate = stash
        host = _host(sstate)
        healthy_tstep = lane.tenant_step(sstep)
        # revivable: persist the last health-checked state before the lane
        # is overwritten by the backfill
        self._write_tenant_snapshot(
            job, spec, {name: host[name][lane.idx] for name in names}, healthy_tstep)
        self._publish(results, TenantResult(job.tid, "fault", healthy_tstep, tdir,
                                            evidence=evidence))
        rec.meta("campaign.evict", tenant=job.tid, step=int(f.tenant_step),
                 lane=lane.idx, slot=slot_idx, rc=FAULT_RC,
                 healthy_step=int(healthy_tstep), evidence=evidence)
        log.warn(f"campaign: evicted tenant {job.tid} (lane {lane.idx}) after "
                 f"{e.rollbacks} rollback(s) at tenant step {f.tenant_step}; slot "
                 f"resumes from step {sstep}")
        return backfill(lane, sstep, _clone(sstate))


# -- the sequential baseline ---------------------------------------------------


def run_sequential(jobs: Sequence[TenantJob], *, device=None, radius: int = 1,
                   chunk: int = 2, cache: Optional[CompileCache] = None,
                   kernel_variant: Optional[str] = None,
                   temporal_k: Optional[int] = None) -> dict:
    """Serve the same jobs one tenant at a time through the standard
    single-domain machinery (``DistributedDomain`` + ``make_jacobi_loop``)
    on ``device`` (default: the current CUDA device): the A/B baseline of
    the batched driver. One domain and loop are reused per shape bucket;
    timing covers the stepping loop (each chunk up to a device synchronize),
    and per-chunk per-step latencies feed the same p50/p99 statistics.

    ``kernel_variant`` selects the REMOTE_DMA variant of the tenant domains:
    ``"fused"`` (one fused step kernel per step) or ``"persistent"`` (one
    whole-chunk kernel per ``temporal_k``-step chunk over radius
    ``radius * temporal_k`` halos; needs ``temporal_k >= 2``)."""
    if kernel_variant not in (None, "fused", "persistent"):
        raise ValueError(f"unknown kernel_variant {kernel_variant!r}: valid values are "
                         "'fused' and 'persistent'")
    if kernel_variant == "persistent" and (temporal_k is None or temporal_k < 2):
        raise ValueError("kernel_variant='persistent' needs temporal_k >= 2 (the chunk "
                         f"depth; got {temporal_k!r})")
    for j in jobs:
        if j.workload != "jacobi":
            raise NotImplementedError(
                f"run_sequential serves jacobi tenants only (tenant {j.tid} is "
                f"{j.workload!r}); the astaroth sequential baseline is a B=1 slot through "
                "the batched driver")
    dev = resolve_device(device)
    cache = cache if cache is not None else CompileCache()
    rec = telemetry.get()
    results: Dict[str, TenantResult] = {}
    lat: List[float] = []
    cell_steps = 0
    wall = 0.0
    t0 = time.perf_counter()

    by_bucket: Dict[Tuple, List[TenantJob]] = {}
    for j in jobs:
        by_bucket.setdefault(j.bucket(), []).append(j)

    for bucket, bucket_jobs in by_bucket.items():
        (size, dtype, _workload) = bucket
        x, y, z = size
        cells = x * y * z
        dd = DistributedDomain(x, y, z, device=dev)
        if kernel_variant == "persistent":
            dd.set_radius(radius * temporal_k)
            dd.set_methods(Method.REMOTE_DMA)
            dd.set_persistent_exchange(True)
        elif kernel_variant == "fused":
            dd.set_radius(radius)
            dd.set_methods(Method.REMOTE_DMA)
            dd.set_fused_exchange(True)
        else:
            dd.set_radius(radius)
        h = dd.add_data(QUANTITY, dtype)
        dd.realize()
        sel = sphere_sel_blocks(dd.spec, dev)
        cfg = PlanConfig.make(Dim3(x, y, z), dd.spec.radius, [dtype], 1, dev.type)

        def loop_for(k, dd=dd, cfg=cfg):
            key = cache_key(cfg, workload="jacobi-sequential", iters=int(k),
                            partition=[dd.spec.dim.x, dd.spec.dim.y, dd.spec.dim.z],
                            devices=[dev.index or 0], variant=kernel_variant or "")
            return cache.get(key, lambda: make_jacobi_loop(dd.halo_exchange, k,
                                                           temporal_k=temporal_k))

        for job in bucket_jobs:
            dd.set_curr_global(h, tenant_init_field(job))
            c = dd.get_curr(h)
            n2 = torch.zeros_like(c)
            done = 0
            for k in chunk_plan(0, job.steps, chunk):
                loop = loop_for(k)
                t1 = time.perf_counter()
                c, n2 = loop(c, n2, sel)
                hard_sync(dev)
                per = (time.perf_counter() - t1) / k
                done += k
                lat.append(per)
                cell_steps += k * cells
                wall += per * k
                rec.gauge("campaign.step_latency_s", per, phase="step",
                          unit="s", mode="sequential", iters=k)
            dd.set_curr(h, c)
            fin = np.ascontiguousarray(dd.get_curr_global(h))
            results[job.tid] = TenantResult(job.tid, "done", done, "", final=fin,
                                            finals={QUANTITY: fin})

    agg = cell_steps / wall / 1e6 if wall > 0 else 0.0
    return {
        "results": results,
        "tenants": len(jobs),
        "slots": 0,
        "cell_steps": cell_steps,
        "step_wall_s": wall,
        "total_wall_s": time.perf_counter() - t0,
        "aggregate_mcells_per_s": agg,
        "p50_step_s": percentile(lat, 50) if lat else float("nan"),
        "p99_step_s": percentile(lat, 99) if lat else float("nan"),
        "evicted": [],
        "cache": cache.stats(),
    }
