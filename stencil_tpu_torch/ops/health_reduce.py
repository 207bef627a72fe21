"""The numerical health check as one kernel launch: all-finite and max |x|.

The port's counterpart of the reduction in ``stencil_tpu.fault.health``
(``HealthGuard._build``, one fused XLA program; no Pallas builder). For each
output slot it computes whether every element of the slot's tensors is
finite, and max |x| taken in the input's type and cast to float32 (NaN
propagates as ``amax`` does). Integer tensors are trivially healthy
(1.0, 0.0) and are not read.

- :func:`health_reduce` is the wrapper. ``groups`` is one list of tensors
  per quantity: one tensor for a quantity of one block or of residents,
  every position's block for a quantity on a mesh. Without ``per_lane``
  each group is one slot, and the result is ``(2, Q)``; with it each
  tensor is a ``(B, ...)`` stack whose B lanes are B slots, and the result
  is ``(2, Q, B)``. CPU tensors take :func:`finite_and_max_plain`; CUDA
  tensors launch ``csrc/health_reduce.cu`` once for the whole check, or
  raise. Launches are counted in ``health_reduce.launches``.
- :func:`work_list` is what the kernel is told: every tensor (or every
  lane of a stack) cut into tasks of at most :data:`TASK_BYTES`, each row
  ``(address, elements, element bytes, slot)``. It is pure Python, so the
  CPU tests hold it to the plain version slot for slot.
- :func:`finite_and_max_plain` is the same check as torch passes
  (``isfinite``, ``all``, ``abs``, ``amax``).

The work list's device copy and the accumulators the launch folds into are
kept per device, state addresses and shapes (``_native.kept``), so a check
costs one launch and one ``(2, slots)`` copy to the host.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from . import _native

#: bytes of one task of the work list (``csrc/health_reduce.cu`` TASK_BYTES)
TASK_BYTES = 1 << 17


def finite_and_max_plain(x: torch.Tensor, dims=None):
    """``(all finite, max |x|)`` of ``x`` over every element (``dims`` None)
    or per leading index (``dims`` not None), both float32 on ``x``'s
    device; integer tensors are trivially healthy. Plain PyTorch."""
    shape = () if dims is None else x.shape[:1]
    if not x.is_floating_point():
        return (torch.ones(shape, device=x.device), torch.zeros(shape, device=x.device))
    flat = x.reshape(-1) if dims is None else x.reshape(x.shape[0], -1)
    d = 0 if dims is None else 1
    return (torch.isfinite(flat).all(d).float(), flat.abs().amax(d).float())


def work_list(entries) -> np.ndarray:
    """``(tasks, 4)`` int64 rows ``(address, elements, element bytes,
    slot)``. ``entries`` holds ``(address, run, element bytes, slot,
    lanes)``: ``lanes`` consecutive runs of ``run`` elements from
    ``address``, run ``r`` folding into slot ``slot + r``. Each run is cut
    into tasks of at most :data:`TASK_BYTES`."""
    rows = [np.zeros((0, 4), np.int64)]
    for addr, run, esize, slot, lanes in entries:
        per = TASK_BYTES // esize
        chunks = -(-run // per)
        r = np.repeat(np.arange(lanes, dtype=np.int64), chunks)
        start = np.tile(np.arange(chunks, dtype=np.int64) * per, lanes)
        rows.append(np.stack([addr + (r * run + start) * esize, np.minimum(per, run - start),
                              np.full_like(r, esize), slot + r], 1))
    return np.concatenate(rows)


def _entries(groups, per_lane: bool, lanes: int) -> List[tuple]:
    """The work list's entries of ``groups``: one per floating tensor."""
    out = []
    for q, group in enumerate(groups):
        for t in group:
            if t.is_floating_point() and t.numel():
                out.append((t.data_ptr(), t.numel() // lanes, t.element_size(),
                            q * lanes, lanes))
    return out


def _check(groups: Sequence[Sequence[torch.Tensor]], per_lane: bool) -> torch.device:
    if not groups or not all(groups):
        raise ValueError("health_reduce needs at least one tensor in every group")
    ts = [t for g in groups for t in g]
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"health_reduce: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError("health_reduce: tensors must be contiguous")
        if t.is_floating_point() and t.element_size() not in (4, 8):
            raise ValueError(f"health_reduce reads float32 or float64, not {t.dtype}")
    if per_lane:
        lanes = {t.shape[0] if t.dim() else None for t in ts}
        if len(lanes) != 1 or None in lanes:
            raise ValueError(f"per-lane stacks must share their leading extent, not {lanes}")
    return dev


def _joined(group: Sequence[torch.Tensor], per_lane: bool) -> torch.Tensor:
    """A group's tensors as one: flattened (per lane) and concatenated."""
    if len(group) == 1:
        return group[0]
    if per_lane:
        return torch.cat([t.reshape(t.shape[0], -1) for t in group], 1)
    return torch.cat([t.reshape(-1) for t in group])


def health_reduce(groups: Sequence[Sequence[torch.Tensor]], per_lane: bool = False):
    """``(2, Q)`` float32 (``(2, Q, B)`` with ``per_lane``): per group of
    tensors (per lane), all-finite (1.0 / 0.0) and max |x|, on the tensors'
    device. See the module docstring."""
    dev = _check(groups, per_lane)
    lanes = groups[0][0].shape[0] if per_lane else 1
    if dev.type == "cpu":
        finite, amax = zip(*(finite_and_max_plain(_joined(g, per_lane), 1 if per_lane else None)
                             for g in groups))
        return torch.stack([torch.stack(finite), torch.stack(amax)])
    if dev.type != "cuda":
        raise ValueError(f"health_reduce runs on cuda or cpu tensors, not {dev}")
    nslots = len(groups) * lanes
    shape = (2, len(groups), lanes) if per_lane else (2, len(groups))
    key = (str(dev), "health", per_lane,
           tuple(tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in g) for g in groups))
    table, ntasks = _native.kept(key, lambda: _table(_entries(groups, per_lane, lanes), dev))
    if not ntasks:  # integer quantities only: nothing to read
        return torch.stack([torch.ones(shape, device=dev), torch.zeros(shape, device=dev)])
    scratch = _native.kept((str(dev), "health_scratch", nslots),
                           lambda: torch.zeros(nslots + 1, dtype=torch.int64, device=dev))
    out = torch.empty((2, nslots), dtype=torch.float32, device=dev)
    rc = _native.lib("health_reduce").health_reduce_launch(
        table.data_ptr(), ntasks, scratch.data_ptr(), nslots, out.data_ptr(), dev.index or 0,
        _native.stream_ptr(dev))
    _native.check(rc, "health_reduce")
    health_reduce.launches += 1
    return out.view(shape)


health_reduce.launches = 0


def _table(entries, dev):
    """``(device table, tasks)`` of ``entries``' work list."""
    rows = work_list(entries)
    return torch.from_numpy(rows).to(dev), len(rows)


def health_bytes(groups) -> int:
    """Bytes one check must read: every floating element once."""
    return sum(t.numel() * t.element_size() for g in groups for t in g if t.is_floating_point())
