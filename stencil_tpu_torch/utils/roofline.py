"""The least time an H100 could take for a kernel's work.

Peaks are the H100 SXM data sheet's: HBM3 bandwidth, and the fp32 and fp64
rates outside the tensor cores. A bound is the larger of the bytes over
the bandwidth and the operations over the peak of their type.
"""

from __future__ import annotations

import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_FP64_PER_S = 34e12


def peak_flops(dtype) -> float:
    """Operations per second outside the tensor cores for ``dtype``."""
    return PEAK_FP64_PER_S if dtype == torch.float64 else PEAK_FP32_PER_S


def bound_ms(nbytes: float, flops: float, dtype=torch.float32):
    """(ms, "bytes" | "operations"): the larger of the two floors."""
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = flops / peak_flops(dtype) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")
