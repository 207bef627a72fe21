"""Observability: the structured telemetry of the port (:mod:`.telemetry`).

:data:`FAULT_RC` is the exit code of a run whose recovery gave up (the
JAX package keeps it in ``obs/watchdog.py``, whose supervisor is not
ported): distinct from a crash, a stall kill and the checkpoint kill hook's
17, so a revival ladder can tell "numerics are broken" from "process died".
"""

FAULT_RC = 43
