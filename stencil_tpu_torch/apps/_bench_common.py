"""What the port's apps share around a run (the port's own copy of the
part of ``stencil_tpu.apps._bench_common`` that the guarded apps use).

The metrics and live-monitoring flags of the JAX module wait for the
watchdog, the sentinel and the status file (ROADMAP.md queue A item 4).
"""

from __future__ import annotations

from ..obs import telemetry
from ..utils import logging as log


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
