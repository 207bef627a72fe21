"""Williamson RK3 integration and the Astaroth step on one device.

The port's counterpart of ``stencil_tpu.astaroth.integrate`` (reference:
astaroth/integration.cuh:14-49 ``rk3_integrate``; astaroth/kernels.cu:62-87
``integrate_substep``; astaroth/astaroth.cu:551-663 iteration structure).

The domain is one block, or a partition whose blocks all sit on the device
(resident, uniform or uneven), exchanged by the domain's ``HaloExchange``.
Per iteration, in the reference's swap-per-iteration mode, one exchange
fills the halos, three RK3 stages run, then the buffers swap once
(``stencil_tpu/astaroth/integrate.py:413-418``). Each stage is one launch
of the substep kernel over every block's compute region at its own extent
(``ops.astaroth_substep.substep_tasks`` over ``compute_tasks``; one task on
one block). With ``overlap`` (the default) on a uniform
partition of several blocks the JAX package's hoisted dataflow runs, in
stream order (``:383-412``): stage 0 over every block from the
pre-exchange halos, the exchange, every block's 6 exterior shells
re-integrated at stage 0 from the exchanged halos (one launch; stage 0
never reads ``out``, so rewriting those cells is exact), then stages 1 and
2: 4 launches an iteration. Without overlap, on one block and on an uneven
partition (the JAX package's serialized path for uneven residents,
``:214-215, 303``), the exchange runs first, then the 3 stages. With
``swap_per_substep=True`` every stage gets its own exchange and swap
(textbook low-storage RK3, ``:374-383``). Everything runs on PyTorch's
current stream; the exchange on a second stream beside stage 0, which is
what the hoisted order is for, is later speed work (ROADMAP.md).

The in buffers stay constant across the three stages of an iteration, so
all three compute the same rate field; the three kernel passes are kept
all the same, because they are the work the reference performs.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..geometry import Rect3
from ..ops.astaroth_substep import (FIELDS, RK3_ALPHA, RK3_BETA, compute_tasks,
                                    require_supported, shell_tasks, substep_tasks)
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
    and three RK3 stages, each one substep launch over every block (see the
    module docstring for the order, and the stage-0 shell launch of the
    overlap iteration). The tensors are updated in place (the returned
    dicts are the same tensors, swapped). dt = 1e-8 is the reference
    program's (astaroth.cu:578).

    ``overlap`` has the JAX semantics: on one block, and on an uneven
    partition, it changes nothing (the JAX package's fused path on one
    block has no shell that depends on another block's halo; uneven
    residents take its serialized path). A mesh of positions raises."""
    spec = ex.spec
    require_supported(spec, getattr(torch, dtype) if isinstance(dtype, str) else dtype)
    if ex.on_mesh:
        raise NotImplementedError(
            "astaroth over a mesh of block positions is not ported yet (ROADMAP.md queue B "
            "item 5); realize the partition resident on one device")
    inv_ds = inv_ds_of(info)
    c = Constants.from_info(info)
    hoisted = overlap and spec.is_uniform() and spec.num_blocks() > 1
    full, shells = compute_tasks(spec), shell_tasks(spec)

    def run_kernel(s, curr, out, tasks=full):
        substep_tasks(tuple(curr[k] for k in FIELDS), tuple(out[k] for k in FIELDS),
                      spec, tasks, c, inv_ds, s, dt)

    def iteration(curr, out):
        if swap_per_substep:
            for s in range(3):
                ex(curr)
                run_kernel(s, curr, out)
                curr, out = out, curr
            return curr, out
        if hoisted:
            # stage 0 from the pre-exchange halos, then its shells again
            # from the exchanged ones
            run_kernel(0, curr, out)
            ex(curr)
            run_kernel(0, curr, out, shells)
        else:
            ex(curr)
            run_kernel(0, curr, out)
        for s in (1, 2):
            run_kernel(s, curr, out)
        return out, curr  # one swap per iteration (astaroth.cu:642-648)

    def fn(curr, out):
        for _ in range(iters):
            curr, out = iteration(curr, out)
        return curr, out

    return fn
