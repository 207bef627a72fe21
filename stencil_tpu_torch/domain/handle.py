"""Typed handle naming one quantity within a domain.

The port's own copy of ``stencil_tpu.domain.handle`` (reference:
include/stencil/local_domain.cuh:18-26). The handle carries the quantity's
slot index, a human-readable name, and its dtype name (``"float32"``, ...).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DataHandle:
    idx: int
    name: str = ""
    dtype: str = "float32"

    def __repr__(self) -> str:
        return f"DataHandle({self.idx}, {self.name!r}, {self.dtype})"
