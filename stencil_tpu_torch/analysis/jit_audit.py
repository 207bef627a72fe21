"""Step-loop audit: no first-use work and no host syncs after warm-up.

The port's counterpart of ``stencil_tpu.analysis.jit_audit``. The two
silent performance bugs of a step loop:

1. **work that should have happened once, inside the timed region** — in
   the JAX package an XLA compile of a chunk size the warm-up missed. The
   port's counterpart is its first-use work (``ops/_native.first_use``): a
   kernel or host library build or load, a table upload (a
   ``_native.kept`` / ``device_table`` miss), a CUDA-graph capture, and
   the build of a step loop for a chunk size the warm-up missed. The audit
   counts all of it after warm-up; one is a "recompile".
2. **a host sync** — a stray ``.item()`` / ``float()`` / ``.cpu()`` pulls
   a value mid-loop, and the card idles while the host waits. On the card
   each audited chunk runs under ``torch.cuda.set_sync_debug_mode("error")``,
   which raises at any synchronizing call; the loop's ONE sanctioned sync
   (``utils/sync.hard_sync``, per chunk) runs outside it. The CPU has no
   such mode: there the verdict lists the host-sync check as not made,
   with the reason, and never as passed.

The audited loop is the real thing: a jacobi domain built through
``DistributedDomain`` (one block, or a mesh of ``devices`` positions by
``Method.REMOTE_DMA``), stepped by ``ops/jacobi.make_jacobi_loop`` chunks
of the ``fault/recover.chunk_plan`` schedule, and warmed as jacobi3d
warms them (``ops/jacobi.warm_jacobi_loops``: each distinct chunk size
from both orders of the loop's two buffers, whose addresses key the
kernels' tables, the state put back). ``inject="recompile"``
leaves the tail chunk size cold, and ``inject="host-sync"`` pulls a
scalar inside the guarded region; both must FAIL the audit on the card
(the host-sync one only where the check is made).

Results land as the schema-valid ``analysis.jit_audit`` telemetry record;
the CLI front end is ``lint_tool jit-audit``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..obs import telemetry

INJECT_MODES = ("recompile", "host-sync")


@dataclass
class AuditResult:
    """``recompiles`` is the first-use work after warm-up (by kind in
    ``first_use``); ``transfer_trips`` the host syncs the debug mode
    caught; ``not_made`` the checks this platform cannot make, each with
    its reason. ``ok`` holds only the checks made."""

    ok: bool
    recompiles: int
    transfer_trips: List[str] = field(default_factory=list)
    steps: int = 0
    chunks: int = 0
    warmup_compiles: int = 0
    inject: Optional[str] = None
    first_use: Dict[str, int] = field(default_factory=dict)
    not_made: List[dict] = field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "kind": "jit-audit", "ok": self.ok,
            "recompiles": self.recompiles,
            "transfer_trips": self.transfer_trips,
            "steps": self.steps, "chunks": self.chunks,
            "warmup_compiles": self.warmup_compiles,
            "inject": self.inject,
            "first_use": self.first_use,
            "not_made": self.not_made,
        }


def _first_use() -> Dict[str, int]:
    from ..ops import _native

    return dict(_native.first_use)


def run_audit(size: int = 16, iters: int = 10, chunk: int = 4,
              inject: Optional[str] = None, devices=None,
              rec: Optional["telemetry.Recorder"] = None) -> AuditResult:
    """Audit the jacobi guarded chunk loop of a ``size``^3 domain:
    ``devices`` None runs one block on the current CUDA device, one entry
    one block on that device, several a mesh of positions (REMOTE_DMA).

    Warm-up is jacobi3d's (``ops/jacobi.warm_jacobi_loops`` over every
    distinct chunk size of the plan) and the sanctioned sync once; then the
    audited chunks run, each under the sync debug mode on the card, and
    any first-use work or caught sync fails the audit."""
    if inject is not None and inject not in INJECT_MODES:
        raise ValueError(f"unknown inject mode {inject!r} "
                         f"(known: {', '.join(INJECT_MODES)})")
    import torch

    from ..api import DistributedDomain
    from ..fault.recover import chunk_plan
    from ..ops.jacobi import INIT_TEMP, make_jacobi_loop, sphere_sel_blocks, warm_jacobi_loops
    from ..parallel.exchange import Method
    from ..utils.sync import hard_sync

    rec = rec or telemetry.get()
    devices = list(devices) if devices is not None else [None]
    dd = DistributedDomain(size, size, size, device=devices[0])
    dd.set_radius(1)
    if len(devices) > 1:
        dd.set_devices(devices)
        dd.set_methods(Method.REMOTE_DMA)
    h = dd.add_data("temperature")
    dd.realize()
    dev = dd.device
    card = dev.type == "cuda"
    curr, nxt = dd.get_curr(h), dd.get_next(h)
    for b in (curr if isinstance(curr, list) else [curr]):
        b.fill_(INIT_TEMP)
    sel = sphere_sel_blocks(dd.spec, dd.mesh or dev)

    chunk = max(1, min(chunk, iters))
    plan = chunk_plan(0, iters, chunk)
    loops = {}

    def get_loop(k: int):
        if k not in loops:
            loops[k] = make_jacobi_loop(dd.halo_exchange, k)
        return loops[k]

    # warm-up: every distinct chunk size of the plan, UNLESS the injected
    # recompile leaves the tail size cold
    warm_sizes = list(dict.fromkeys(plan))
    if inject == "recompile":
        warm_sizes = warm_sizes[:1]
        if len(set(plan)) < 2:
            raise ValueError(
                f"inject='recompile' needs a chunk plan with >= 2 "
                f"distinct sizes; iters={iters} chunk={chunk} gives "
                f"{plan} — pick iters not divisible by chunk")
    c0 = _first_use()
    with rec.span("analysis.jit_warmup", phase="compile"):
        warm_jacobi_loops(get_loop, warm_sizes, curr, nxt, sel)
        hard_sync(dev)
    warmup_compiles = sum(_first_use().values()) - sum(c0.values())

    not_made = []
    if not card:
        not_made.append({
            "check": "host-sync",
            "reason": f"no sync debug mode on {dev.type}: torch.cuda.set_sync_debug_mode "
                      "catches host syncs on a CUDA device only; the check needs the card"})
    trips: List[str] = []
    base = _first_use()
    done = 0
    with rec.span("analysis.jit_audit_loop", phase="step"):
        for i, k in enumerate(plan):
            loop = get_loop(k)
            if card:
                torch.cuda.set_sync_debug_mode("error")
            try:
                curr, nxt = loop(curr, nxt, sel)
                if inject == "host-sync" and i == 1:
                    # the injected bug: a mid-loop scalar pull (the .item()
                    # class), which the debug mode catches on the card
                    first = curr[0] if isinstance(curr, list) else curr
                    float(first[(0,) * first.dim()])
            except RuntimeError as e:
                msg = str(e)
                if not (card and "synchroniz" in msg):
                    raise
                trips.append(f"chunk {i} (k={k}): {msg.splitlines()[0][:200]}")
                continue  # the chunk is evidence; keep auditing
            finally:
                if card:
                    torch.cuda.set_sync_debug_mode("default")
            hard_sync(dev)  # the ONE sanctioned sync, outside the guard
            done += k
    after = _first_use()
    first_use = {kind: after[kind] - base[kind] for kind in after}
    recompiles = sum(first_use.values())

    ok = recompiles == 0 and not trips
    result = AuditResult(ok=ok, recompiles=recompiles, transfer_trips=trips, steps=done,
                         chunks=len(plan), warmup_compiles=warmup_compiles, inject=inject,
                         first_use=first_use, not_made=not_made)
    rec.meta("analysis.jit_audit", ok=int(ok), recompiles=int(recompiles),
             transfers=len(trips), steps=done, inject=inject,
             not_made=",".join(n["check"] for n in not_made) or None)
    return result
