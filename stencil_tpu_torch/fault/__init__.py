"""Self-healing runs: detect, inject, recover.

The port's counterpart of ``stencil_tpu.fault``:

- :mod:`health`  -- the numerical health guard: one isfinite / max|u|
  reduction over the state every ``health_every`` steps, raising a typed
  :class:`NumericalFault`.
- :mod:`inject`  -- deterministic, seeded fault injection in the JAX
  package's spec grammar, every firing a ``fault.injected`` record.
- :mod:`recover` -- the rollback-with-backoff engine :func:`run_guarded`,
  which after ``max_rollbacks`` aborts with :data:`FAULT_RC` and a JSON
  evidence bundle.
"""

from .health import DIVERGENCE, NONFINITE, HealthGuard, NumericalFault  # noqa: F401
from .inject import FaultPlan, Injection, parse_spec  # noqa: F401
from .recover import (  # noqa: F401
    EVIDENCE_NAME,
    FAULT_RC,
    RecoveryExhausted,
    RecoveryPolicy,
    chunk_plan,
    run_guarded,
    write_evidence,
)
