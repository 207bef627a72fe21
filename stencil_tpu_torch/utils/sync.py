"""Device synchronization for timing.

PyTorch returns from a CUDA launch before the device finishes, so a host
clock around device work measures the enqueue unless the work ends in a
synchronize. On the CPU every op has finished when it returns."""

from __future__ import annotations

import torch


def hard_sync(device) -> None:
    """Block until every queued op on ``device`` has finished."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
