"""Attribute DEVICE time to the named ranges from a profiler capture.

The port's counterpart of ``stencil_tpu.obs.xprof``. Host-side spans
(``obs/attribution.py``) time the dispatch side of an exchange; on the card
the interesting seconds are on the device, and a ``torch.profiler``
capture (Kineto over CUPTI) records them, tagged with the very
``timer.trace_range`` names the host spans use, since ``trace_range`` is
``torch.profiler.record_function``. This module turns one capture
directory into device seconds per range name (and per kernel name).

Parsing is pure stdlib (gzip + json) over the Chrome-trace JSON the
capture writes under ``<logdir>/plugins/profile/<run>/``
(``*.trace.json`` / ``*.trace.json.gz``; a bare directory of dumps is read
too): complete-event ("X") durations summed per event name, with an
``#...#`` argument suffix folded away ("stencil.exchange#fused=...#" counts
as "stencil.exchange"). Durations are microseconds and may be floats.

What counts as device time. The JAX module sums EVERY complete event, since
on a TPU dump each one is a device op; such a dump carries no ``cat``, and
it is read the same way here. A torch trace holds host events as well:
``user_annotation`` (a ``record_function`` range on the host), ``cpu_op``,
``cuda_runtime``, ``python_function`` and one whole-window ``Trace`` event.
Where an event carries a ``cat``, only the device categories count
(:data:`DEVICE_CATEGORIES`): the device work (``kernel``, ``gpu_memcpy``,
``gpu_memset``) under its kernel's name, and ``gpu_user_annotation``, a
range's span on the device timeline, under the range's name. Where a torch
trace has a host range and no ``gpu_user_annotation`` of that name, the
range's device span comes from correlation: the device work whose launch
(the ``cuda_runtime`` event with the same ``args.correlation``) lies
inside the host range's interval, from the first such event's start to
the last one's end, as ``gpu_user_annotation`` spans it. The port's kernels
are C entries launched through ctypes; CUPTI records them all the same
(cooperative launches and CUDA-graph replays too), under their demangled
``__global__`` signatures (``void (anonymous
namespace)::jacobi_multistep_kernel<3, float>(...)``).

``capture()`` is the collection side: a contextmanager around a
``torch.profiler`` capture of host and device activity that degrades to a
no-op (yields False, writes nothing) unless a CUDA device is visible and
the profiler supports CUDA activity (a CPU capture attributes nothing the
host spans don't already have).
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import socket
import tempfile
import time
from typing import Dict, Iterator, List, Optional, Sequence

TRACE_GLOBS = ("*.trace.json.gz", "*.trace.json")

# the device timeline's categories in a torch (Kineto) trace: the work, and
# a range's span over it
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
DEVICE_CATEGORIES = DEVICE_WORK + ("gpu_user_annotation",)
HOST_RANGE = "user_annotation"
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def _iter_trace_files(logdir: str) -> Iterator[str]:
    # the capture nests runs under plugins/profile/<run>/; accept a bare
    # directory of dumps too so tests can synthesize one
    roots = [logdir, os.path.join(logdir, "plugins", "profile")]
    seen = set()
    for root in roots:
        for pat in TRACE_GLOBS:
            for path in sorted(glob.glob(os.path.join(root, pat)) +
                               glob.glob(os.path.join(root, "*", pat))):
                if path not in seen:
                    seen.add(path)
                    yield path


def _load_trace(path: str) -> dict:
    if path.endswith(".gz"):
        with gzip.open(path, "rt", encoding="utf-8") as f:
            return json.load(f)
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _base_name(name: str) -> str:
    # annotations may carry #key=value# arg blocks; fold them
    i = name.find("#")
    return name[:i] if i > 0 else name


def _complete_events(logdir: str) -> Iterator[List[dict]]:
    """Each readable dump's complete events with a positive duration."""
    for path in _iter_trace_files(logdir):
        try:
            doc = _load_trace(path)
        except (OSError, ValueError):
            continue  # a truncated dump attributes nothing
        yield [ev for ev in (doc.get("traceEvents") or [])
               if isinstance(ev, dict) and ev.get("ph") == "X"
               and isinstance(ev.get("dur"), (int, float)) and ev["dur"] > 0]


def _correlated_spans(events: List[dict], names) -> Dict[str, float]:
    """Device seconds of each host range (``user_annotation``) named in
    ``names`` that has no device-side span: the span of the device work
    launched inside it, found by correlation id."""
    events = [ev for ev in events if isinstance(ev.get("ts"), (int, float))]
    launch_ts = {}
    for ev in events:
        if ev.get("cat") in LAUNCH_CATEGORIES:
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = ev["ts"]
    work = []
    for ev in events:
        if ev.get("cat") in DEVICE_WORK:
            t = launch_ts.get((ev.get("args") or {}).get("correlation"))
            if t is not None:
                work.append((t, ev["ts"], ev["ts"] + ev["dur"]))
    out: Dict[str, float] = {}
    for ev in events:
        if ev.get("cat") != HOST_RANGE:
            continue
        name = _base_name(str(ev.get("name", "")))
        if name not in names:
            continue
        lo, hi = ev["ts"], ev["ts"] + ev["dur"]
        inside = [(s, e) for t, s, e in work if lo <= t <= hi]
        if inside:
            span = max(e for _s, e in inside) - min(s for s, _e in inside)
            out[name] = out.get(name, 0.0) + span / 1e6
    return out


def range_seconds(logdir: str,
                  names: Optional[Sequence[str]] = None
                  ) -> Dict[str, float]:
    """Total device seconds per named range (and per kernel, in a torch
    trace) across every trace dump under ``logdir``. ``names`` filters to
    the names of interest (None = all). Durations are Chrome-trace
    microseconds."""
    want = set(names) if names is not None else None
    totals: Dict[str, float] = {}
    for events in _complete_events(logdir):
        device_ranges = set()
        host_ranges = set()
        for ev in events:
            name = _base_name(str(ev.get("name", "")))
            if not name or (want is not None and name not in want):
                continue
            cat = ev.get("cat")
            if cat:
                if cat == HOST_RANGE:
                    host_ranges.add(name)
                if cat not in DEVICE_CATEGORIES:
                    continue
                if cat == "gpu_user_annotation":
                    device_ranges.add(name)
            totals[name] = totals.get(name, 0.0) + ev["dur"] / 1e6
        missing = host_ranges - device_ranges
        if missing:
            for name, s in _correlated_spans(events, missing).items():
                totals[name] = totals.get(name, 0.0) + s
    return totals


def device_events(logdir: str) -> List[dict]:
    """The device work (kernels, copies, sets) of every torch trace under
    ``logdir``, each ``{"name", "cat", "ts", "dur"}`` in microseconds;
    ``name`` is the kernel's demangled name."""
    out: List[dict] = []
    for events in _complete_events(logdir):
        out.extend({"name": str(ev.get("name", "")), "cat": ev["cat"], "ts": ev["ts"],
                    "dur": ev["dur"]}
                   for ev in events if ev.get("cat") in DEVICE_WORK
                   and isinstance(ev.get("ts"), (int, float)))
    return out


def _cuda_profiling() -> bool:
    try:
        import torch
        from torch.profiler import ProfilerActivity

        return (torch.cuda.is_available()
                and ProfilerActivity.CUDA in torch.profiler.supported_activities())
    except Exception:
        return False


@contextlib.contextmanager
def capture(logdir: Optional[str]):
    """Programmatic profiler capture, gated: yields True when a trace is
    actually being recorded (a visible CUDA device and a profiler with
    CUDA activity), False otherwise; callers decide whether to parse
    ``logdir`` after. The dump lands under ``logdir/plugins/profile/<run>/``
    once the block ends.

    Never raises out of the gate: a broken profiler must not take the run
    it was meant to observe down with it."""
    prof = None
    if logdir and _cuda_profiling():
        try:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
        except Exception:
            prof = None
    if prof is None:
        yield False
        return
    try:
        yield True
    finally:
        try:
            import torch

            torch.cuda.synchronize()
            prof.stop()
            root = os.path.join(logdir, "plugins", "profile")
            os.makedirs(root, exist_ok=True)
            run_dir = tempfile.mkdtemp(prefix=time.strftime("%Y_%m_%d_%H_%M_%S_"), dir=root)
            prof.export_chrome_trace(os.path.join(
                run_dir, f"{socket.gethostname()}.{os.getpid()}.trace.json"))
        except Exception:
            pass
