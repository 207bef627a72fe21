"""Phase timers and profiler range annotations.

The port's counterpart of ``stencil_tpu.utils.timer`` (reference:
include/stencil/rt.hpp:9-36, include/stencil/timer.hpp:44-47, the NVTX
ranges throughout src/stencil.cu). Accumulated wall-clock buckets replace
the global ``timers::cudaRuntime`` counters; the profiler range is
``torch.profiler.record_function``, which shows in ``torch.profiler``
traces (and as an NVTX range under ``emit_nvtx``).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

# global accumulated seconds per named bucket (reference: timer.hpp:44-47)
buckets: dict[str, float] = defaultdict(float)


@contextlib.contextmanager
def timed(bucket: str):
    """Accumulate elapsed wall time into ``buckets[bucket]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        buckets[bucket] += time.perf_counter() - t0


@contextlib.contextmanager
def trace_range(name: str):
    """Named profiler range (the reference's nvtxRangePush/Pop)."""
    with torch.profiler.record_function(name):
        yield


def cuda_time_ms(fn, reps: int, warmup: int = 2, graph: bool = False) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back calls:
    CUDA events around the batch, after ``warmup`` calls. With ``graph``
    the ``reps`` calls are captured once into a CUDA graph and the replay
    is timed, so host-side launch overhead (Python, argument checks) drops
    out and only device time remains."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    run = lambda: [fn() for _ in range(reps)]  # noqa: E731
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def report() -> str:
    """One-line bucket summary, the analogue of the reference's exit print
    of timers::cudaRuntime/timers::mpi (reference: bin/jacobi3d.cu:397-398)."""
    if not buckets:
        return "timers: (empty)"
    parts = [f"{k}={v:.3f}s" for k, v in sorted(buckets.items())]
    return "timers: " + " ".join(parts)
