"""Williamson RK3 integration and the Astaroth step.

The port's counterpart of ``stencil_tpu.astaroth.integrate`` (reference:
astaroth/integration.cuh:14-49 ``rk3_integrate``; astaroth/kernels.cu:62-87
``integrate_substep``; astaroth/astaroth.cu:551-663 iteration structure).

The domain is one block, a partition whose blocks all sit on the device
(resident, uniform or uneven), or a mesh of block positions (one block a
position, or each position's stack of residents; uniform or uneven),
exchanged by the domain's ``HaloExchange`` (on a mesh of one block a
position AXIS_COMPOSED's copies between positions or REMOTE_DMA's B6 axis
carrier over the 8 fields, B4 on an axis of one position; over more blocks
than positions REMOTE_DMA). Over positions of several processes each rank
steps its own positions (the field dicts hold None at the others'); see
"Across processes" below. Per iteration,
in the reference's swap-per-iteration mode, one exchange fills the halos,
three RK3 stages run, then the buffers swap once
(``stencil_tpu/astaroth/integrate.py:413-418``). Each stage is one launch
of the substep kernel over every block's compute region at its own extent
(``ops.astaroth_substep.substep_tasks`` over ``compute_tasks``; one task on
one block; on a mesh ``substep_positions`` over ``position_compute_tasks``,
every position in one launch, as the JAX package runs its substep inside
``shard_map`` on every device, ``:312-330, 489-496``). With ``overlap``
(the default) on a uniform partition of several blocks the JAX package's
hoisted dataflow runs, in stream order (``:383-412``): stage 0 over every
block from the pre-exchange halos, the exchange, every block's 6 exterior
shells re-integrated at stage 0 from the exchanged halos (one launch;
stage 0 never reads ``out``, so rewriting those cells is exact), then
stages 1 and 2: 4 launches an iteration. Without overlap, on one block and
on an uneven partition (the JAX package's serialized path for uneven
residents, ``:214-215, 303``; on an uneven mesh of one block a position
the JAX package re-integrates dynamic-offset shells, ``:402-413,
452-465``, which gives the same cells, since stage 0 never reads ``out``),
the exchange runs first, then the 3 stages. With ``swap_per_substep=True``
every stage gets its own exchange and swap
(textbook low-storage RK3, ``:374-383``). Everything runs on PyTorch's
current stream; the exchange on a second stream beside stage 0, which is
what the hoisted order is for, is later speed work (ROADMAP.md).

:func:`make_fused_astaroth_loop` is the JAX package's fused REMOTE_DMA
iteration: the hoisted order with B7's 26-direction exchange
(``HaloExchange(Method.REMOTE_DMA, fused=True)``) between stage 0 and its
shells, on uniform partitions of one block a position.

:func:`make_batched_astaroth_step` is the multi-tenant campaign's step:
``(B, pz, py, px)`` stacks of independent one-block tenants, each wrapping
its own halos. Per iteration the tenant fill of ``curr`` (B4's tenant form,
x -> y -> z, 3 launches for the 8 fields) and the 3 stages, each one launch
of B5's tenant form over every tenant, then one swap.

Across processes. Every stage launch covers this rank's positions
(``positions=`` of ``position_compute_tasks``), and the exchange fills
their halos: on the CPU by gloo, on the card by pulls through CUDA IPC
after the handshakes of ``parallel/ipc.PhaseOrder`` (one an axis phase with
that axis's ring neighbours for AXIS_COMPOSED and B6, one with every rank
the messages cross to for B7). A stage writes ``out``, whose compute cells
the neighbours pulled in the previous exchange (it was ``curr`` then). In
the serial and swap orders the exchange before the stage holds a handshake
with every rank that pulled from this one (its ring neighbours on each
axis that crosses), recorded after that pull, so the stage waits for it
and needs nothing more. In the hoisted order (the overlap step and the
fused loop) stage 0 comes before the exchange, so it follows a handshake of
its own with every rank the messages cross to
(``PhaseOrder.before_all``, as jacobi's sweep before its exchange). That
handshake also follows this iteration's writes of ``curr``'s compute cells
(the previous stages), which the exchange then reads. Handshakes an
iteration: the crossing axes in the serial order, three times that in the
swap order, one more in the hoisted order, and two in the fused loop. Two
exchanges of one buffer back to back (the app's exchange alone after a
chunk, then a serial iteration's) rewrite each halo with the value it
already holds, so a neighbour's read of it in between is harmless.

The in buffers stay constant across the three stages of an iteration, so
all three compute the same rate field; the three kernel passes are kept
all the same, because they are the work the reference performs.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..api import resolve_device
from ..geometry import Dim3, Rect3
from ..ops.astaroth_substep import (FIELDS, RK3_ALPHA, RK3_BETA, compute_tasks,
                                    position_compute_tasks, position_shell_tasks,
                                    require_supported, shell_tasks, substep_positions,
                                    substep_tasks, tenant_tasks)
from ..ops.halo_fill import wrap_fill_tenants
from ..parallel.exchange import Method
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
    tensors keyed by :data:`FIELDS` (on a mesh, of lists of per-position
    stacks): ``iters`` iterations of an exchange and three RK3 stages, each
    one substep launch over every block (see the module docstring for the
    order, and the stage-0 shell launch of the overlap iteration). The
    tensors are updated in place (the returned dicts are the same tensors,
    swapped). dt = 1e-8 is the reference program's (astaroth.cu:578).

    ``overlap`` has the JAX semantics: on one block it changes nothing (the
    JAX package's fused path on one block has no shell that depends on
    another block's halo), and an uneven partition, resident or over a mesh,
    takes the serialized order (the cells of the JAX package's
    dynamic-offset shells), as does a partition whose blocks have no
    interior (an extent within the radius of both sides, which a tuned plan
    may pick); the two orders give the same bits."""
    spec = ex.spec
    require_supported(spec, getattr(torch, dtype) if isinstance(dtype, str) else dtype)
    r, b = spec.radius, spec.base
    interior = all(n > lo + hi for n, lo, hi in ((b.x, r.x(-1), r.x(1)), (b.y, r.y(-1), r.y(1)),
                                                 (b.z, r.z(-1), r.z(1))))
    hoisted = overlap and spec.is_uniform() and spec.num_blocks() > 1 and interior
    return _make_loop(ex, info, dt, iters, "swap" if swap_per_substep
                      else "hoisted" if hoisted else "serial")


def make_fused_astaroth_loop(ex, info: AcMeshInfo, iters: int = 1, dt: float = 1e-8,
                             dtype="float32"):
    """The fused REMOTE_DMA Astaroth iteration, the counterpart of the JAX
    package's ``make_fused_astaroth_loop``: ``loop(curr, out) -> (curr,
    out)`` over field dicts, ``iters`` iterations of the hoisted order
    with the fused exchange: stage 0 over every block from the pre-exchange
    halos, the exchange of ``ex`` (``HaloExchange(Method.REMOTE_DMA,
    fused=True)``: B7's 26 direction boxes over the 8 fields on a mesh,
    whose cross-derivative pencils read the edge and corner halos it
    moves), stage 0 again over every block's exterior shells, stages 1 and
    2, one swap. In place, like :func:`make_astaroth_step`, whose overlap
    step it equals cell for cell. Uniform partitions of one block a
    position only, as in the JAX package (ValueError otherwise); across
    processes B7's cross-process form, each rank's stages over its own
    positions (see the module docstring)."""
    spec, r = ex.spec, ex.spec.radius
    if ex.method != Method.REMOTE_DMA or not ex.fused:
        raise ValueError("make_fused_astaroth_loop needs HaloExchange(Method.REMOTE_DMA, "
                         "fused=True)")
    if min(r.x(-1), r.x(1), r.y(-1), r.y(1), r.z(-1), r.z(1)) < 3:
        raise ValueError("astaroth needs face radius >= 3 (6th-order stencils; the fused "
                         "path keeps inline halos)")
    if not spec.is_uniform() or ex.oversubscribed:
        raise ValueError("the fused astaroth loop takes uniform single-resident partitions "
                         "(uneven and oversubscribed ones stay on the composed paths)")
    require_supported(spec, getattr(torch, dtype) if isinstance(dtype, str) else dtype)
    return _make_loop(ex, info, dt, iters, "hoisted")


def _make_loop(ex, info: AcMeshInfo, dt: float, iters: int, order: str):
    """``fn(curr, out)``: ``iters`` iterations in ``order``: "hoisted"
    (stage 0, the exchange, stage 0's shells, stages 1-2), "serial" (the
    exchange, stages 0-2) or "swap" (an exchange, a stage and a swap, three
    times); each stage one substep launch over every block's compute region
    (``full``) or exterior shells (``shells``) of the domain's stacks, or
    on a mesh of its per-position lists."""
    spec, inv_ds, c = ex.spec, inv_ds_of(info), Constants.from_info(info)
    if ex.on_mesh:
        # this process's positions (every position in one process)
        locs = ex.mesh.local_positions()
        kernel = substep_positions
        full = position_compute_tasks(spec, ex.resident, locs)
        shells = position_shell_tasks(spec, ex.resident, locs)
    else:
        kernel, full, shells = substep_tasks, compute_tasks(spec), shell_tasks(spec)
    # across processes on the card: the hoisted stage 0 overwrites the
    # buffer the neighbours pulled from in the previous exchange, and no
    # handshake of that exchange orders it after their pulls
    handshake = ex.on_mesh and ex.mesh.multi_process and ex.peers is not None

    def run(s, curr, out, tasks):
        kernel(tuple(curr[k] for k in FIELDS), tuple(out[k] for k in FIELDS), spec, tasks, c,
               inv_ds, s, dt)

    def iteration(curr, out):
        if order == "swap":
            for s in range(3):
                ex(curr)
                run(s, curr, out, full)
                curr, out = out, curr
            return curr, out
        if order == "hoisted":
            # stage 0 from the pre-exchange halos, then its shells again
            # from the exchanged ones
            if handshake:
                ex.peers.order.before_all()
            run(0, curr, out, full)
            ex(curr)
            run(0, curr, out, shells)
        else:
            ex(curr)
            run(0, curr, out, full)
        for s in (1, 2):
            run(s, curr, out, full)
        return out, curr  # one swap per iteration (astaroth.cu:642-648)

    def fn(curr, out):
        for _ in range(iters):
            curr, out = iteration(curr, out)
        return curr, out

    return fn


def make_batched_astaroth_step(spec, info: AcMeshInfo, dt: float = 1e-8, iters: int = 1,
                               device=None):
    """The multi-tenant batched Astaroth iteration: ``fn(curr, out) ->
    (curr, out)`` over dicts of ``(B, pz, py, px)`` stacked tenant fields
    keyed by :data:`FIELDS`, each tenant an independent one-block periodic
    MHD box. The counterpart of the JAX package's
    ``make_batched_astaroth_step``.

    ``spec`` describes one tenant (``GridSpec(size, Dim3(1, 1, 1),
    Radius.constant(3))``); the leading axis stacks B tenants. Per iteration
    the reference swap-per-iteration structure runs once: the periodic
    self-wrap of every tenant (``halo_fill.wrap_fill_tenants``: composed x
    -> y -> z, so the 6th-order cross stencils see the edge and corner halos
    of a one-block exchange), stages 0-2 over every tenant's compute region
    from the filled ``curr``, and one swap. On the card that is 3 fill
    launches and 3 substep launches (:func:`tenant_tasks`, one per
    ``MAX_TASKS`` tenants); on the CPU the plain fill and
    ``integrate_region``. The step runs on ``device`` (default: the current
    CUDA device) and refuses tensors elsewhere; it updates in place, like
    every loop of the port (the returned dicts are the same tensors,
    swapped)."""
    r = spec.radius
    if spec.dim != Dim3(1, 1, 1):
        raise ValueError(f"batched tenants are single-block domains; got partition {spec.dim}")
    if min(r.x(-1), r.x(1), r.y(-1), r.y(1), r.z(-1), r.z(1)) < 3:
        raise ValueError("astaroth needs face radius >= 3 (6th-order stencils)")
    dev = resolve_device(device)
    inv_ds = inv_ds_of(info)
    c = Constants.from_info(info)
    tables = {}  # the task list per stack height

    def iteration(curr, out):
        c8, o8 = tuple(curr[k] for k in FIELDS), tuple(out[k] for k in FIELDS)
        wrap_fill_tenants(spec, c8)
        b = c8[0].shape[0]
        tasks = tables.get(b) or tables.setdefault(b, tenant_tasks(spec, b))
        for s in range(3):
            substep_tasks(c8, o8, spec, tasks, c, inv_ds, s, dt)
        return out, curr  # one swap per iteration (astaroth.cu:642-648)

    def fn(curr, out):
        bad = [str(t.device) for t in (*curr.values(), *out.values()) if t.device != dev]
        if bad:
            raise ValueError(f"batched astaroth step built for {dev}; operands on {bad}")
        for _ in range(iters):
            curr, out = iteration(curr, out)
        return curr, out

    return fn
