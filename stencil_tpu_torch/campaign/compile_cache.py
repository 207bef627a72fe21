"""Shape-bucketed program cache: the serving asset of the campaign layer.

The port's counterpart of ``stencil_tpu.campaign.compile_cache``. A slot's
program depends only on the shape of the work (tenant grid, radius, dtype,
slot width, chunk length, device), never on which tenants occupy it. In the
port a "program" is the step loop together with its first-use kernel build
(``ops._native`` compiles the CUDA sources on first use); on the CPU it is
the loop alone. Every lookup records a ``compile.cache_hit`` gauge (1/0),
and every miss wraps its build in a ``compile.build`` span and a
``compile.build_s`` gauge, so "the second slot rebuilt nothing" is a
telemetry fact.

Keys are :meth:`plan.ir.PlanConfig.key` extended with the campaign-shape
fields; the string equals the JAX package's for the same config and extras.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict

from ..obs import telemetry


def cache_key(config, **extra) -> str:
    """Canonical string key: a ``plan.ir.PlanConfig`` plus campaign-shape
    extras (``batch=``, ``iters=``, ``workload=``, ...). Sorted-key compact
    JSON, like ``PlanConfig.key()``."""
    obj = dict(config.to_json())
    obj.update(extra)
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


class CompileCache:
    """In-process program cache with hit/build telemetry.

    ``get(key, build)`` returns the cached program for ``key`` or builds it
    with ``build()``. ``built_keys`` lists every key that caused a build, in
    order.
    """

    def __init__(self):
        self._progs: Dict[str, Any] = {}
        self.hits = 0
        self.misses = 0
        self.built_keys: list = []

    def __len__(self) -> int:
        return len(self._progs)

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "programs": len(self._progs)}

    def get(self, key: str, build: Callable[[], Any]):
        rec = telemetry.get()
        hit = key in self._progs
        if hit:
            self.hits += 1
        else:
            self.misses += 1
            self.built_keys.append(key)
            t0 = time.perf_counter()
            with rec.span("compile.build", phase="compile", key=key):
                self._progs[key] = build()
            rec.gauge("compile.build_s", time.perf_counter() - t0,
                      phase="compile", unit="s", key=key)
        rec.gauge("compile.cache_hit", 1 if hit else 0, phase="compile",
                  key=key)
        return self._progs[key]
