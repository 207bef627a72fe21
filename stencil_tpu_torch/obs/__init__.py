"""Observability: the structured telemetry of the port (:mod:`.telemetry`),
the cross-run performance ledger and its ingest (:mod:`.ledger`, which also
prices the serving daemon's admission), the timeline export of a metrics
file (:mod:`.trace_export`), device seconds per named range from a
``torch.profiler`` capture (:mod:`.xprof`), the attribution of measured
exchanges to the cost model (:mod:`.attribution`), the in-run sentinel
(:mod:`.live`), the run-status snapshot (:mod:`.status`) and the
supervisor of stall-prone children with its heartbeat contract
(:mod:`.watchdog`). The CLIs over them are ``apps/report`` and
``apps/perf_tool``.

:data:`FAULT_RC` is the exit code of a run whose recovery gave up
(:mod:`.watchdog` owns it, with the heartbeat env names): distinct from a
crash, a stall kill and the checkpoint kill hook's 17, so a revival ladder
can tell "numerics are broken" from "process died".
"""

from .watchdog import FAULT_RC, HEARTBEAT_FILE_ENV, HEARTBEAT_INTERVAL_ENV  # noqa: F401
