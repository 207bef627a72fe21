"""Static and runtime analysis of the port's own contracts (the port's copy
of ``stencil_tpu.analysis``):

- :mod:`.astlint` — an AST-walking lint engine with the port's rules
  (pure-stdlib file-path-loaded modules, the telemetry name vocabulary,
  the tmp+fsync+rename atomic-write protocol, ``assert``-for-validation
  in public APIs, unprefixed ``{placeholder}`` strings at raise/log
  sites, host syncs in the step loops and kernel wrappers);
- :mod:`.verify_plan` — the ExchangePlan IR against what the port
  executed: sweeps partition x method x dtype x Q configs and holds the
  IR's message, byte, copy and launch predictions to the counts the
  exchanges and kernel wrappers keep as they issue their work;
- :mod:`.jit_audit` — the step-loop audit: the guarded chunk loop run
  after its warm-up, failing on any first-use work (a kernel build, a
  table upload, a graph capture, a loop build) and, on the card, on any
  host sync (``torch.cuda.set_sync_debug_mode``).

Front end: ``python -m stencil_tpu_torch.apps.lint_tool {lint,verify-plan,
jit-audit,all}``.
"""

from .astlint import (  # noqa: F401
    Finding,
    RULES,
    lint_paths,
    load_baseline,
    write_baseline,
)
