"""Measured refinement: time the top static candidates, briefly.

The port's own copy of ``stencil_tpu.plan.probe``. The static model
(``plan/cost.py``) orders the search space; a probe buys the truth for the
few candidates that matter by timing each one's exchange program with
``apps/_bench_common.time_exchange`` on the caller's devices (one device,
or a mesh of positions on one card): its partition, method, quantity
batching, and the radius times its temporal depth k (a k-step multistep
exchanges radius*k halos once per k steps, so the per-step cost is
trimean / k). On the card the probes run the exchange kernels: the fills
(B4) on one device, the axis carrier (B6) over a mesh, the fused exchange
carrier (B7) for a fused candidate over a mesh. The persistent variant's
exchange is the deep-halo plain program at radius*k, which is what the
scaled-radius probe times.

Each probe realizes its own domain; it is dropped, and on the card the
allocator's cache emptied, before the next probe, so that candidates do
not stack up in device memory. A probe that raises is recorded as failed
(its error kept in the record) and skipped, as in the JAX package: the
record is the evidence, and nothing falls back.
"""

from __future__ import annotations

import gc
import time
from typing import List, Optional, Sequence, Tuple

import torch

from ..geometry import Dim3
from .cost import scale_radius
from .ir import PlanChoice, PlanConfig


def probe_choice(config: PlanConfig, choice: PlanChoice, iters: int = 4, devices=None,
                 chunk: Optional[int] = None) -> dict:
    """Time one candidate's exchange; returns a probe record (label,
    trimean_s, per_step_s, gb_per_s). Raises on a candidate the devices
    cannot realize (callers filter with ``cost.feasible`` first); a
    placement or hierarchy raises as at realize()."""
    from ..apps._bench_common import time_exchange
    from ..obs import telemetry
    from ..parallel.exchange import Method

    choice.realizable()
    # the dominant dtype at the full quantity count: mixed-dtype configs
    # group per dtype either way
    dtype = max(config.quantities, key=lambda t: (t[1], t[0]))[0]
    radius = scale_radius(config.radius_obj(), choice.multistep_k)
    rec = telemetry.get()
    label = choice.label()
    t0 = time.perf_counter()
    try:
        with rec.span("plan.probe", phase="plan", plan=label):
            r = time_exchange(Dim3.of(config.grid), radius, iters, method=Method(choice.method),
                              devices=devices, quantities=config.num_quantities, dtype=dtype,
                              chunk=chunk if chunk is not None else min(iters, 5),
                              batch_quantities=choice.batch_quantities,
                              partition=choice.partition, fused=choice.is_fused)
        trimean, gbs = r["trimean_s"], r["gb_per_s"]
    finally:
        r = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    rec.gauge("plan.probe_trimean_s", trimean, phase="plan", unit="s", plan=label)
    return {"label": label, "choice": choice.to_json(), "trimean_s": trimean,
            "per_step_s": trimean / choice.multistep_k, "gb_per_s": gbs, "iters": iters,
            "wall_s": time.perf_counter() - t0}


def refine(config: PlanConfig, ranked: Sequence[Tuple[object, PlanChoice]], top_n: int = 3,
           iters: int = 4, devices=None) -> Tuple[Optional[PlanChoice], List[dict]]:
    """Probe the ``top_n`` cheapest static candidates; returns (the measured
    winner by per-step seconds, the probe records). A probe that raises is
    recorded with its error and skipped."""
    from ..utils import logging as log

    probes: List[dict] = []
    best: Optional[PlanChoice] = None
    best_s = float("inf")
    for _cost, choice in list(ranked)[:top_n]:
        try:
            p = probe_choice(config, choice, iters=iters, devices=devices)
        except Exception as e:  # noqa: BLE001 - recorded as evidence, then the next candidate
            log.warn(f"plan probe {choice.label()} failed: {type(e).__name__}: {e}")
            probes.append({"label": choice.label(), "choice": choice.to_json(),
                           "error": f"{type(e).__name__}: {e}"[:400]})
            continue
        probes.append(p)
        if p["per_step_s"] < best_s:
            best_s = p["per_step_s"]
            best = choice
    return best, probes
