"""Structured telemetry: spans, counters, gauges and metas, one JSON object
per line.

The port's own copy of the part of ``stencil_tpu.obs.telemetry`` that the
campaign, fault, checkpoint and compile-cache layers record through. The
record schema is the JAX package's v1, so a metrics file of either package
validates under both. Every line carries:

- ``v``:     schema version (1)
- ``run``:   run id (shared by every record of one measurement run)
- ``proc``:  process index (0: the port runs one process per device)
- ``kind``:  ``span`` | ``counter`` | ``gauge`` | ``meta`` | ``heartbeat``
- ``name``:  record name (e.g. ``campaign.evict``, ``compile.build_s``)
- ``t``:     unix wall time of emission

plus per kind: spans carry ``seconds``; counters an integer ``value`` and/or
``bytes``; gauges a numeric ``value``; heartbeats an integer ``seq``; metas
are free-form. :func:`validate_record` is the schema authority, and
:data:`NAME_FIELDS` types the payload of the names the fault and campaign
layers emit.

Spans ride ``utils.timer.timed`` (the global buckets) and
``timer.trace_range`` (a ``torch.profiler`` range of the same name).

Not carried over: the watchdog heartbeat file and thread (the supervisor is
not ported), and the census, exchange-truth and DMA-traffic records, which
read XLA HLO and Mosaic lowerings that have no counterpart here.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import uuid
from typing import Iterable, List, Optional, Tuple

from ..utils import timer

SCHEMA_VERSION = 1
KINDS = ("span", "counter", "gauge", "meta", "heartbeat")
REQUIRED_KEYS = ("v", "run", "proc", "kind", "name", "t")

# The typed payload of the fault / health / recover / checkpoint records, the
# multi-tenant layer's campaign.* / compile.* / slo.* vocabulary and the
# serving layer's replan.requested and serve.*, as the JAX package's schema
# types them.
NAME_FIELDS = {
    "fault.injected": (("fault_kind", str), ("step", int)),
    "health.fault": (("fault_kind", str), ("quantity", str), ("step", int)),
    "health.check": (("step", int),),
    "recover.fault": (("fault_kind", str), ("step", int)),
    "recover.rollback": (("from_step", int), ("to_step", int),
                         ("fault_step", int)),
    "recover.aborted": (("reason", str), ("step", int)),
    "ckpt.save_skipped": (("reason", str),),
    "campaign.slot": (("slot", int),),
    "campaign.retire": (("tenant", str), ("step", int), ("lane", int)),
    "campaign.backfill": (("tenant", str), ("lane", int)),
    "campaign.evict": (("tenant", str), ("step", int), ("rc", int)),
    "campaign.step_latency_s": (("mode", str),),
    "campaign.summary": (("slots", int), ("tenants", int)),
    "compile.cache_hit": (("key", str),),
    "compile.build": (("key", str),),
    "compile.build_s": (("key", str),),
    "slo.violation": (("tenant", str), ("step", int)),
    "replan.requested": (("reason", str), ("step", int)),
    # the serving vocabulary (serve/): admission verdicts, result streaming,
    # drain / park / revival, and the capacity engine's decisions
    "serve.admitted": (("job", str),),
    "serve.rejected": (("job", str), ("reason", str)),
    "serve.deferred": (("job", str), ("reason", str)),
    "serve.retired": (("job", str), ("outcome", str)),
    "serve.parked": (("job", str), ("step", int)),
    "serve.drain": (("reason", str),),
    "serve.revived": (("jobs", int),),
    "serve.packed": (("bucket", str), ("width", int)),
    "serve.preempted": (("job", str), ("gain_ms", float), ("resume_cost_ms", float)),
    "serve.preempt_veto": (("job", str), ("gain_ms", float), ("resume_cost_ms", float)),
    "serve.resized": (("from_width", int), ("to_width", int), ("reason", str)),
}


def new_run_id() -> str:
    return time.strftime("%Y%m%dT%H%M%S") + "-" + uuid.uuid4().hex[:8]


class Recorder:
    """One measurement run's telemetry channel.

    ``sink`` is a path (opened for append) or a file-like object, or None:
    a disabled recorder writes nothing but still accumulates the timer
    buckets of its spans.
    """

    def __init__(self, sink=None, run_id: Optional[str] = None,
                 app: Optional[str] = None, clock=time.time):
        self.run_id = run_id or new_run_id()
        self.app = app
        self._clock = clock
        self._owns_sink = isinstance(sink, (str, os.PathLike))
        # the JSONL file this recorder appends to, when it opened one
        self.path = os.fspath(sink) if self._owns_sink else None
        self._sink = open(sink, "a", buffering=1) if self._owns_sink else sink
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        """True when records are actually written somewhere."""
        return self._sink is not None

    def emit(self, kind: str, name: str, *, phase: Optional[str] = None,
             **fields) -> dict:
        """Build one record and write it to the sink; returns the record.
        Fields whose value is None are left out."""
        rec = {"v": SCHEMA_VERSION, "run": self.run_id, "proc": 0,
               "kind": kind, "name": name, "t": self._clock()}
        if self.app:
            rec["app"] = self.app
        if phase is not None:
            rec["phase"] = phase
        rec.update((k, v) for k, v in fields.items() if v is not None)
        if self._sink is not None:
            line = json.dumps(rec, default=str)
            with self._lock:
                self._sink.write(line + "\n")
                self._sink.flush()
        return rec

    @contextlib.contextmanager
    def span(self, name: str, phase: Optional[str] = None,
             bucket: Optional[str] = None, **tags):
        """Timed region: timer bucket + profiler range + one span record,
        emitted even when the body raises (the failed span is evidence)."""
        t0 = time.perf_counter()
        try:
            with timer.timed(bucket or name), timer.trace_range(name):
                yield
        finally:
            self.emit("span", name, phase=phase,
                      seconds=time.perf_counter() - t0, **tags)

    def counter(self, name: str, value: Optional[int] = None,
                bytes: Optional[int] = None, phase: Optional[str] = None,
                **tags) -> dict:
        return self.emit("counter", name, phase=phase, value=value,
                         bytes=bytes, **tags)

    def gauge(self, name: str, value: float, phase: Optional[str] = None,
              unit: Optional[str] = None, **tags) -> dict:
        return self.emit("gauge", name, phase=phase, value=value, unit=unit,
                         **tags)

    def meta(self, name: str, **fields) -> dict:
        return self.emit("meta", name, **fields)

    def close(self) -> None:
        if self._owns_sink and self._sink is not None:
            try:
                self._sink.close()
            finally:
                self._sink = None


# -- the process-default recorder --------------------------------------------

_recorder: Optional[Recorder] = None


def configure(metrics_out: Optional[str] = None, app: Optional[str] = None,
              run_id: Optional[str] = None,
              config: Optional[dict] = None) -> Recorder:
    """Install the process-default recorder (what ``--metrics-out`` wires);
    its first record is the run's ``config`` meta, so every metrics file
    describes itself."""
    global _recorder
    if _recorder is not None:
        _recorder.close()
    _recorder = Recorder(sink=metrics_out or None, app=app, run_id=run_id)
    if config:
        clean = {k: v for k, v in config.items()
                 if isinstance(v, (str, int, float, bool, type(None)))}
        _recorder.meta("config", config=clean)
    return _recorder


def get() -> Recorder:
    """The process-default recorder (a disabled one before configure())."""
    global _recorder
    if _recorder is None:
        _recorder = Recorder(sink=None)
    return _recorder


def enabled() -> bool:
    return _recorder is not None and _recorder.enabled


# -- schema validation ---------------------------------------------------------


def validate_record(rec) -> List[str]:
    """Return the list of schema violations (empty = valid v1 record)."""
    errs: List[str] = []
    if not isinstance(rec, dict):
        return [f"not an object: {type(rec).__name__}"]
    for k in REQUIRED_KEYS:
        if k not in rec:
            errs.append(f"missing required key {k!r}")
    if errs:
        return errs
    if rec["v"] != SCHEMA_VERSION:
        errs.append(f"unknown schema version {rec['v']!r}")
    if not isinstance(rec["run"], str) or not rec["run"]:
        errs.append("run must be a non-empty string")
    if not isinstance(rec["proc"], int):
        errs.append("proc must be an int")
    if not isinstance(rec["name"], str) or not rec["name"]:
        errs.append("name must be a non-empty string")
    if not isinstance(rec["t"], (int, float)):
        errs.append("t must be a number")
    kind = rec["kind"]
    if kind not in KINDS:
        errs.append(f"unknown kind {kind!r}")
    elif kind == "span":
        if not isinstance(rec.get("seconds"), (int, float)):
            errs.append("span requires numeric 'seconds'")
    elif kind == "counter":
        if not isinstance(rec.get("value"), int) and not isinstance(
                rec.get("bytes"), int):
            errs.append("counter requires integer 'value' and/or 'bytes'")
    elif kind == "gauge":
        if not isinstance(rec.get("value"), (int, float)):
            errs.append("gauge requires numeric 'value'")
    elif kind == "heartbeat":
        if not isinstance(rec.get("seq"), int):
            errs.append("heartbeat requires integer 'seq'")
    if "bytes" in rec and not isinstance(rec["bytes"], int):
        errs.append("'bytes' must be an integer where present")
    for fld, typ in NAME_FIELDS.get(rec["name"], ()):
        v = rec.get(fld)
        if not isinstance(v, typ) or (typ is int and isinstance(v, bool)):
            errs.append(f"{rec['name']} requires {typ.__name__} {fld!r}")
    return errs


def validate_jsonl(lines: Iterable[str]) -> Tuple[int, List[str]]:
    """Validate an iterable of JSONL lines; returns (n_valid, errors)."""
    n_ok = 0
    errors: List[str] = []
    for i, line in enumerate(lines, 1):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            errors.append(f"line {i}: unparseable JSON ({e})")
            continue
        errs = validate_record(rec)
        if errs:
            errors.extend(f"line {i}: {e}" for e in errs)
        else:
            n_ok += 1
    return n_ok, errors
