"""The least time an H100 could take for a kernel's work.

Peaks are the H100 SXM data sheet's: HBM3 bandwidth, and the fp32 and fp64
rates outside the tensor cores. A bound is the larger of the bytes over
the bandwidth and the operations over the peak of their type.

The data sheet's rates count a fused multiply-add as two operations. A
kernel built with ``-fmad=false`` (the port's kernels are, to round as
their plain versions do) issues every add and multiply as an instruction
of its own, so its arithmetic cannot go faster than :func:`issue_ms`: one
instruction per lane and clock, over 132 SMs of 64 fp64 or 128 fp32
lanes at the 1.98 GHz an H100 SXM's SMs hold under load.
"""

from __future__ import annotations

import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_FP64_PER_S = 34e12

SMS = 132
LANES_PER_SM = {torch.float64: 64, torch.float32: 128}
SM_CLOCK_HZ = 1.98e9


def peak_flops(dtype) -> float:
    """Operations per second outside the tensor cores for ``dtype``."""
    return PEAK_FP64_PER_S if dtype == torch.float64 else PEAK_FP32_PER_S


def bound_ms(nbytes: float, flops: float, dtype=torch.float32):
    """(ms, "bytes" | "operations"): the larger of the two floors."""
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = flops / peak_flops(dtype) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def issue_ms(ops: float, dtype=torch.float32) -> float:
    """The least ms in which the card issues ``ops`` unfused arithmetic
    instructions of ``dtype`` (fp32 or fp64), one per lane and clock."""
    return ops / (SMS * LANES_PER_SM[dtype] * SM_CLOCK_HZ) * 1e3
