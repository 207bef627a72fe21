"""The in-run sentinel: streaming trimean +- MAD anomaly detection.

The port's own copy of ``stencil_tpu.obs.live``: a run notices that it got
slow while it is still running. Per metric key a bounded window of recent
healthy samples (:class:`OnlineWindow`); the band is ``trimean(window) +-
max(mad_k * MAD, rel_tol * |trimean|, abs_tol)`` (its low edge
ratio-symmetric, see :meth:`OnlineWindow.band`); a seconds-suffixed key
trips only high, a throughput key only low (:func:`default_direction`).
Nothing is judged before ``min_history`` samples; non-finite samples are
dropped; anomalous samples stay out of the window, so a sustained anomaly
cannot normalise itself away; an open anomaly clears after
``clear_after`` in-band samples and then re-arms.

:class:`LiveSentinel` keeps the windows and emits ``anomaly.detected``,
``anomaly.cleared`` and, on every detection, ``replan.requested``, handing
the event to its ``on_replan`` hook (``plan/replan.ReplanController.
request``), which never raises into the run. ``fault/recover.run_guarded``
feeds it each chunk's per-step latency, and ``obs/status.py`` snapshots
its state.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Callable, Dict, List, Optional

from ..utils import logging as log
from .ledger import mad, trimean

ANOMALY_DETECTED = "anomaly.detected"
ANOMALY_CLEARED = "anomaly.cleared"
REPLAN_REQUESTED = "replan.requested"

# Units/suffixes where smaller is better (times, rc codes); everything
# else (throughputs, ratios, ok flags) defaults to higher-is-better.
_LOWER_UNITS = ("s", "ms", "us", "rc")
_LOWER_SUFFIXES = ("_s", "_ms", "_seconds", "_iter_ms", ".rc")


def base_metric(name: str) -> str:
    """Strip the report-style ``[method,batched]`` tag suffix so per-leg
    threshold config matches the logical leg name."""
    return name.split("[", 1)[0]


def default_direction(metric: str, unit: Optional[str]) -> str:
    m = base_metric(metric)
    # throughput names ("..._gb_per_s", "mcells_per_s") end in "_s" too —
    # the rate test must run before the seconds-suffix test
    if m.endswith("_per_s") or m.endswith("_per_dev"):
        return "higher"
    if (unit or "") in _LOWER_UNITS or m.endswith(_LOWER_SUFFIXES):
        return "lower"
    return "higher"


class OnlineWindow:
    """One metric key's bounded recent-history window + anomaly state.

    ``observe(value, step)`` returns an event dict when the sample
    transitions the anomaly state (``"detected"`` / ``"cleared"``), else
    None. The window holds only finite, in-band samples, so eviction
    keeps the band anchored on recent *healthy* history.
    """

    def __init__(self, key: str, *, window: int = 64, min_history: int = 4,
                 mad_k: float = 4.0, rel_tol: float = 3.0,
                 abs_tol: float = 0.0, direction: str = "",
                 clear_after: int = 2, unit: Optional[str] = None):
        if window < max(1, int(min_history)):
            # a ValueError, not an assert: under -O an assert vanishes
            # and the window could never reach min_history — a sentinel
            # that silently cannot fire
            raise ValueError(f"{key}: window {window} cannot hold "
                             f"min_history {min_history}")
        self.key = key
        self.unit = unit
        self.samples: deque = deque(maxlen=int(window))
        self.min_history = int(min_history)
        self.mad_k = float(mad_k)
        self.rel_tol = float(rel_tol)
        self.abs_tol = float(abs_tol)
        self.direction = direction or default_direction(key, unit)
        self.clear_after = max(1, int(clear_after))
        self.active: Optional[dict] = None  # the open anomaly, if any
        self.detected = 0
        self.cleared = 0
        self._streak = 0  # consecutive in-band samples while active

    def band(self):
        """(center, lo, hi) of the current window, or None in warmup.

        The high edge is the cross-run band formula. The LOW
        edge's relative component is ratio-symmetric —
        ``center·rel_tol/(1+rel_tol)``, i.e. ``lo >= center/(1+rel_tol)``
        — because with the wide default band (rel_tol 3) the additive
        form would put ``lo`` below zero for every positive-valued
        metric, and a "higher"-direction key (a throughput collapse)
        could then never trip. At cross-run tolerances
        (rel_tol ~0.05) the two forms agree to within 0.3%."""
        if len(self.samples) < self.min_history:
            return None
        center = trimean(self.samples)
        spread = self.mad_k * mad(self.samples)
        tol_hi = max(spread, self.rel_tol * abs(center), self.abs_tol)
        rel_lo = abs(center) * self.rel_tol / (1.0 + self.rel_tol)
        tol_lo = max(spread, rel_lo, self.abs_tol)
        return center, center - tol_lo, center + tol_hi

    def observe(self, value: float, step: int) -> Optional[dict]:
        v = float(value)
        if not math.isfinite(v):
            return None  # dropped at insertion — the metrics-ingest rule
        b = self.band()
        if b is None:
            # warmup: below min_history nothing is judged, ever
            self.samples.append(v)
            return None
        center, lo, hi = b
        bad = ((v < lo and self.direction in ("higher", "both"))
               or (v > hi and self.direction in ("lower", "both")))
        if bad:
            self._streak = 0
            if self.active is None:
                self.active = {
                    "metric": self.key, "step": int(step), "value": v,
                    "center": center, "lo": lo, "hi": hi,
                    "direction": self.direction,
                }
                self.detected += 1
                return dict(self.active, event="detected")
            # still anomalous: extend the open anomaly, do not re-emit
            self.active["last_step"] = int(step)
            self.active["last_value"] = v
            return None
        self.samples.append(v)
        if self.active is not None:
            self._streak += 1
            if self._streak >= self.clear_after:
                ev = {"event": "cleared", "metric": self.key,
                      "step": int(step), "value": v,
                      "since_step": self.active["step"]}
                self.active = None
                self._streak = 0
                self.cleared += 1
                return ev
        return None


def validate_config(config: dict) -> List[str]:
    """Violations of a LiveSentinel config (empty = valid) — checked at
    CLI parse time so a bad knob is an argparse error, not a traceback
    after device set-up (or a window that silently can never fire)."""
    errs: List[str] = []
    if not isinstance(config, dict):
        return [f"config must be an object, not {type(config).__name__}"]
    for key, over in config.items():
        if not isinstance(over, dict):
            errs.append(f"{key!r}: overrides must be an object")
            continue
        unknown = sorted(set(over) - set(LiveSentinel._KNOBS))
        if unknown:
            errs.append(f"{key!r}: unknown knob(s) {unknown}")
        for k in ("window", "min_history", "clear_after"):
            v = over.get(k)
            if v is not None and (isinstance(v, bool)
                                  or not isinstance(v, int) or v < 1):
                errs.append(f"{key!r}: {k} must be a positive integer")
        for k in ("mad_k", "rel_tol", "abs_tol"):
            v = over.get(k)
            if v is not None and (isinstance(v, bool)
                                  or not isinstance(v, (int, float))
                                  or not math.isfinite(v) or v < 0):
                errs.append(f"{key!r}: {k} must be a finite number >= 0")
        d = over.get("direction")
        if d is not None and d not in ("", "higher", "lower", "both"):
            errs.append(f"{key!r}: direction must be higher/lower/both")
        # the relation check runs over the MERGED knobs ("*" defaults
        # cascade under per-key overrides, exactly as _window applies
        # them) so a split like {"*": {min_history: 8}, k: {window: 2}}
        # is caught here, not at the first mid-run observe()
        star = config.get("*") if isinstance(config.get("*"), dict) else {}
        merged = {"window": 64, "min_history": 4}
        merged.update({k: v for k, v in star.items() if k in merged})
        merged.update({k: v for k, v in over.items() if k in merged})
        if (isinstance(merged["window"], int)
                and isinstance(merged["min_history"], int)
                and merged["window"] < max(1, merged["min_history"])):
            errs.append(f"{key!r}: window {merged['window']} cannot hold "
                        f"min_history {merged['min_history']}")
    return errs


class LiveSentinel:
    """Per-key online windows + the telemetry/replan emission policy.

    ``config`` follows the JAX package's ``--leg-config`` shape:
    ``{"*": {...defaults...}, "<key>": {...overrides...}}`` with the
    knobs window/min_history/mad_k/rel_tol/abs_tol/direction/clear_after;
    a tagged key (``step.latency_s[16x16x16]``) inherits its
    :func:`base_metric` overrides like the cross-run gate does.

    Every detection also emits ``replan.requested`` (unless
    ``replan=False``) and invokes ``on_replan(event)`` when given — the
    mid-run plan hot-swap's trigger (``plan/replan.ReplanController``
    latches the request here and performs the swap between guarded-loop
    chunks); the default is record + log, never an exception (a broken
    replan hook must not kill the measurement).
    """

    _KNOBS = ("window", "min_history", "mad_k", "rel_tol", "abs_tol",
              "direction", "clear_after")

    def __init__(self, config: Optional[dict] = None, *, rec=None,
                 replan: bool = True,
                 on_replan: Optional[Callable[[dict], None]] = None):
        self.config = dict(config or {})
        self._rec = rec
        self.replan = bool(replan)
        self.on_replan = on_replan
        self.windows: Dict[str, OnlineWindow] = {}
        # detect/clear history of windows dropped by reset() — run
        # totals must survive a plan hot-swap's window reset
        self._retired_detected = 0
        self._retired_cleared = 0

    def _recorder(self):
        if self._rec is not None:
            return self._rec
        from . import telemetry

        return telemetry.get()

    def _window(self, key: str, unit: Optional[str]) -> OnlineWindow:
        w = self.windows.get(key)
        if w is None:
            over = dict(self.config.get("*", {}))
            over.update(self.config.get(base_metric(key), {}))
            over.update(self.config.get(key, {}))
            kw = {k: over[k] for k in self._KNOBS if k in over}
            w = self.windows[key] = OnlineWindow(key, unit=unit, **kw)
        return w

    def observe(self, key: str, value: float, *, step: int,
                unit: Optional[str] = None, **tags) -> Optional[dict]:
        """Feed one sample; emit the vocabulary on a state transition."""
        ev = self._window(key, unit).observe(value, step)
        if ev is None:
            return None
        rec = self._recorder()
        if ev["event"] == "detected":
            rec.meta(ANOMALY_DETECTED, metric=key, step=ev["step"],
                     value=ev["value"], center=ev["center"], lo=ev["lo"],
                     hi=ev["hi"], direction=ev["direction"], phase="live",
                     **tags)
            log.warn(
                f"live: ANOMALY {key} at step {ev['step']}: "
                f"{ev['value']:.6g} outside [{ev['lo']:.6g}, "
                f"{ev['hi']:.6g}] ({ev['direction']})")
            if self.replan:
                rec.meta(REPLAN_REQUESTED, reason=f"anomaly:{key}",
                         step=ev["step"], metric=key, phase="live")
                log.warn(f"live: replan requested (anomaly in {key}"
                         + ("; hot-swap hook attached)"
                            if self.on_replan is not None
                            else "; no hot-swap hook — recorded only)"))
                if self.on_replan is not None:
                    try:
                        self.on_replan(dict(ev))
                    except Exception as e:  # the hook must never kill a run
                        log.warn(f"live: replan hook failed: {e}")
        else:
            rec.meta(ANOMALY_CLEARED, metric=key, step=ev["step"],
                     value=ev["value"], since_step=ev["since_step"],
                     phase="live", **tags)
            log.warn(f"live: anomaly in {key} cleared at step {ev['step']} "
                     f"(open since step {ev['since_step']})")
        return ev

    def reset(self, key: Optional[str] = None) -> None:
        """Drop the window(s) — ALL of them, or one key's — so judgment
        restarts from warmup. The plan hot-swap calls this after
        ``replan.applied``: the old window's band describes the OLD
        compiled plan's latencies, and judging the new plan (plus its
        one-time swap-compile spike) against it would re-trip the
        sentinel on the first post-swap chunk. Detected/cleared totals
        are preserved — they are run history, not window state."""
        doomed = (list(self.windows.values()) if key is None
                  else [w for k, w in self.windows.items() if k == key])
        for w in doomed:
            self._retired_detected += w.detected
            self._retired_cleared += w.cleared
        if key is None:
            self.windows.clear()
        else:
            self.windows.pop(key, None)

    # -- state for status snapshots -------------------------------------------
    @property
    def detected_total(self) -> int:
        return (self._retired_detected
                + sum(w.detected for w in self.windows.values()))

    @property
    def cleared_total(self) -> int:
        return (self._retired_cleared
                + sum(w.cleared for w in self.windows.values()))

    def active(self) -> List[dict]:
        return [dict(w.active) for w in self.windows.values()
                if w.active is not None]

    def summary(self) -> dict:
        """The ``anomalies`` section of a status snapshot."""
        return {
            "active": self.active(),
            "detected": self.detected_total,
            "cleared": self.cleared_total,
        }
