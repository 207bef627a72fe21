"""Williamson RK3 integration and the Astaroth step on one block.

The port's counterpart of ``stencil_tpu.astaroth.integrate`` (reference:
astaroth/integration.cuh:14-49 ``rk3_integrate``; astaroth/kernels.cu:62-87
``integrate_substep``; astaroth/astaroth.cu:551-663 iteration structure).

This slice runs one block on one device, with every axis wrapping onto
itself: the JAX package's fused path on a single block. Per iteration, in
the reference's swap-per-iteration mode, one exchange fills the halos
(three self-fill launches carrying all 8 fields each), then three substep
launches run RK3 stages 0, 1 and 2, then the buffers swap once
(``stencil_tpu/astaroth/integrate.py:413-418``). With
``swap_per_substep=True`` every stage gets its own exchange and swap
(textbook low-storage RK3, ``:374-383``).

The in buffers stay constant across the three stages of an iteration, so
all three compute the same rate field; the three kernel passes are kept
all the same, because they are the work the reference performs.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..geometry import Rect3
from ..ops.astaroth_substep import FIELDS, RK3_ALPHA, RK3_BETA, require_supported, substep
from .config import AcMeshInfo
from .equations import Constants, continuity, entropy, induction, momentum
from .fd import field_data


def rk3_integrate(step_number: int, state_previous, state_current, rate_of_change, dt):
    """One low-storage RK3 stage (reference: integration.cuh:14-38).

    ``state_previous`` is the out-buffer value (the previous stage's
    output), ``state_current`` the in-buffer value."""
    beta = RK3_BETA[step_number]
    if step_number == 0:
        return state_current + beta * rate_of_change * dt
    alpha = RK3_ALPHA[step_number]
    prev_beta = RK3_BETA[step_number - 1]
    return state_current + beta * (
        alpha / prev_beta * (state_current - state_previous) + rate_of_change * dt
    )


def _rect_slices(rect: Rect3):
    return (..., slice(rect.lo.z, rect.hi.z), slice(rect.lo.y, rect.hi.y),
            slice(rect.lo.x, rect.hi.x))


def integrate_region(substep: int, rect: Rect3, inv_ds, c: Constants, dt,
                     curr: Dict[str, torch.Tensor], out: Dict[str, torch.Tensor]):
    """Integrate one region: read the curr fields' derivatives over
    ``rect`` and RK3-update the region of the out tensors in place
    (reference: solve<step>, user_kernels.h:437-469). Returns ``out``."""
    lnrho = field_data(curr["lnrho"], rect, inv_ds)
    uu = tuple(field_data(curr[k], rect, inv_ds) for k in ("uux", "uuy", "uuz"))
    aa = tuple(field_data(curr[k], rect, inv_ds) for k in ("ax", "ay", "az"))
    ss = field_data(curr["entropy"], rect, inv_ds)

    sl = _rect_slices(rect)
    rates = {"lnrho": continuity(uu, lnrho)}
    ind = induction(c, uu, aa)
    mom = momentum(c, uu, lnrho, ss, aa)
    for i, k in enumerate(("ax", "ay", "az")):
        rates[k] = ind[i]
    for i, k in enumerate(("uux", "uuy", "uuz")):
        rates[k] = mom[i]
    rates["entropy"] = entropy(c, ss, uu, lnrho, aa)
    for k in FIELDS:
        out[k][sl] = rk3_integrate(substep, out[k][sl], curr[k][sl], rates[k], dt)
    return out


def inv_ds_of(info: AcMeshInfo):
    rp = info.real_params
    return (rp["AC_inv_dsx"], rp["AC_inv_dsy"], rp["AC_inv_dsz"])


def make_astaroth_step(ex, info: AcMeshInfo, dt: float = 1e-8, overlap: bool = True,
                       swap_per_substep: bool = False, iters: int = 1,
                       dtype="float32"):
    """Build ``fn(curr, nxt) -> (curr, nxt)`` over dicts of stacked field
    tensors keyed by :data:`FIELDS`: ``iters`` iterations of an exchange
    and three RK3 substep launches on a one-block domain. The tensors are
    updated in place (the returned dicts are the same tensors, swapped).
    dt = 1e-8 is the reference program's (astaroth.cu:578).

    ``overlap`` is accepted with the JAX semantics and, as in the JAX
    package's fused path on one block, changes nothing: no shell depends
    on another block's halo."""
    spec = ex.spec
    require_supported(spec, getattr(torch, dtype) if isinstance(dtype, str) else dtype)
    inv_ds = inv_ds_of(info)
    c = Constants.from_info(info)
    p = spec.padded()

    def run_kernel(s, curr, out):
        substep(tuple(curr[k].view(p.z, p.y, p.x) for k in FIELDS),
                tuple(out[k].view(p.z, p.y, p.x) for k in FIELDS),
                spec, c, inv_ds, s, dt)

    def iteration(curr, out):
        if swap_per_substep:
            for s in range(3):
                ex(curr)
                run_kernel(s, curr, out)
                curr, out = out, curr
            return curr, out
        ex(curr)
        for s in range(3):
            run_kernel(s, curr, out)
        return out, curr  # one swap per iteration (astaroth.cu:642-648)

    def fn(curr, out):
        for _ in range(iters):
            curr, out = iteration(curr, out)
        return curr, out

    return fn
