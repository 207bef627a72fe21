"""Static exchange-plan cost model: rank candidates without running them.

The port's own copy of ``stencil_tpu.plan.cost``. :func:`score` prices one
:class:`~.ir.PlanChoice` for one :class:`~.ir.PlanConfig` from the
ExchangePlan IR alone: collectives, DMA copies, wire and local bytes fall
out of the phase list (``plan/ir.py``), and per-unit constants turn them
into seconds. These are RANKING constants: the model orders the search
space, and the measured probes (``plan/probe.py``) pick among its top.

Whose numbers, by platform (``config.platform``):

- ``"cpu"``: the JAX package's CPU ranking constants, unchanged
  (:data:`DEFAULT_CALIBRATION`: the per-collective overheads and wire rate
  it recorded on its 8-device CPU mesh, and its CPU prices of a remote-dma
  copy and a launch). They are not the port's timings; they are kept so
  that a ranking on the CPU equals the JAX package's, candidate for
  candidate and second for second.
- ``"cuda"``: the same model with the H100 row of
  :data:`PLATFORM_CALIBRATION` merged over the CPU constants. That row
  was fitted on the card by this package's own ``plan/calibrate.fit``
  from the probe and attribution records of ``chip_smoke.py`` phase 18
  (its provenance names the card, its power limit, the sample count and
  r²). On the card a REMOTE_DMA exchange's copies are the kernel launches
  it issues (``ExchangePlan.carrier_launches``: B6's axis phases, B7's one
  launch, B4's fills): each costs the fitted ``dma_overhead_s``, and every
  byte it moves, crossing or local (all positions share the card's
  memory), the fitted ``remote_dma.wire_bytes_per_s``; no launch term is
  added beside them. The other methods keep the CPU per-collective
  constants (the fit prices only the methods it saw), as the JAX
  package's did on a TPU config; the fitted rate prices their bytes.

The JAX package's TPU-modeled constants (its remote-dma copy and launch
prices for ``"tpu"``) and its DCN row are not carried: no config of the
port has that platform. Hierarchical candidates and the placement search
over non-uniform links wait for ROADMAP.md queue A item 5; with uniform
link costs (every set of positions on one card) placement solves to
identity, as in the JAX package. AUTO_SPMD has no geometry here (item 5),
so the port enumerates AXIS_COMPOSED, DIRECT26 and REMOTE_DMA
(:data:`PLANNED_METHODS`) and raises for an auto-spmd choice.

Pure Python over the IR: enumerating hundreds of candidates costs
milliseconds and touches no device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..domain.grid import GridSpec
from ..geometry import DIRECTIONS_26, Dim3, Radius, halo_extent, stack_residents
from .ir import (
    AUTO_SPMD,
    AXIS_COMPOSED,
    DIRECT26,
    FUSED_VARIANT,
    PERSISTENT_VARIANT,
    REMOTE_DMA,
    PlanChoice,
    PlanConfig,
    build_plan,
    validate_placement,
)

# the methods the port's exchange realizes (AUTO_SPMD: queue A item 5)
PLANNED_METHODS = (AXIS_COMPOSED, DIRECT26, REMOTE_DMA)

# The JAX package's CPU ranking constants (its module docstring gives their
# provenance: censuses and wall clocks of its 8-device CPU mesh), unchanged.
DEFAULT_CALIBRATION: Dict[str, object] = {
    "permute_overhead_s": {
        AXIS_COMPOSED: 6.6e-4,
        DIRECT26: 1.76e-3,
        AUTO_SPMD: 7.3e-4,
    },
    "wire_bytes_per_s": 3.9e8,
    "local_bytes_per_s": 4.0e9,
    # per-cell update cost of the multistep's redundant compute
    "cell_update_s": 1.0e-9,
    # relative compute factor per kernel variant (unknown -> 1.0)
    "variant_factor": {},
    # a remote-dma copy on the CPU: a host-orchestrated copy
    "remote_dma": {
        "cpu_emulation_overhead_s": 4.0e-3,
        "wire_bytes_per_s": 3.9e8,
    },
    # a program launch on the CPU (persistent: 2 a chunk, plain: 2 a step)
    "persistent": {
        "cpu_dispatch_s": 2.0e-4,
    },
}

# Fitted per-platform rows, merged over DEFAULT_CALIBRATION for a config
# of that platform. "cuda": plan/calibrate.fit's row on an NVIDIA H100 80GB
# HBM3 at a 700.00 W power limit, as `plan_tool calibrate --platform cuda
# --from-metrics` wrote it from chip_smoke.py phase 18's metrics of its
# 8-position runs (63 timed exchanges of 512^3 over 8 positions: B6 + B4
# plain and B7 fused, each sample's copy count its kernel launches). The
# low r2 says the launches and bytes explain about half of the spread.
PLATFORM_CALIBRATION: Dict[str, dict] = {
    "cuda": {
        "calibration": {
            "remote_dma": {"dma_overhead_s": 4.231548167628088e-05,
                           "wire_bytes_per_s": 140895095983.10233},
            "wire_bytes_per_s": 140895095983.10233,
        },
        "provenance": "fitted(n=63, r2=0.556) on NVIDIA H100 80GB HBM3, 700.00 W",
        "n": 63,
        "r2": 0.5556425355770875,
        "card": "NVIDIA H100 80GB HBM3, 700.00 W",
    },
}


def platform_calibration(platform: str) -> Dict[str, object]:
    """DEFAULT_CALIBRATION with ``platform``'s fitted row merged over it:
    what :func:`score` prices a config of that platform with before any
    caller override."""
    cal = dict(DEFAULT_CALIBRATION)
    row = PLATFORM_CALIBRATION.get(platform)
    return merge_calibration(cal, row["calibration"]) if row else cal


def default_provenance(platform: str) -> str:
    """Provenance of what prices ``platform`` before any override: its
    fitted row's, or ``"modeled(default)"`` (the CPU constants)."""
    row = PLATFORM_CALIBRATION.get(platform)
    return str(row["provenance"]) if row else "modeled(default)"


def merge_calibration(base: dict, override: Optional[dict]) -> dict:
    """``override`` over ``base``: dict-valued keys (per-method overheads,
    the remote_dma row) merge per entry, so a partial override keeps the
    defaults of everything it does not name."""
    cal = dict(base)
    for k, v in (override or {}).items():
        if isinstance(v, dict) and isinstance(cal.get(k), dict):
            cal[k] = {**cal[k], **v}
        else:
            cal[k] = v
    return cal


@dataclass(frozen=True)
class PlanCost:
    """Static score of one candidate, per simulation step."""

    total_s: float          # the ranking key
    exchange_s: float       # one exchange's predicted wall clock
    collectives: int        # permutes per exchange
    wire_bytes: int         # bytes crossing between positions per exchange
    local_bytes: int        # bytes moved within a position per exchange
    compute_overhead_s: float  # the multistep's redundant compute per step
    dmas: int = 0           # REMOTE_DMA's copies (on "cuda": its kernel launches)


def scale_radius(radius: Radius, k: int) -> Radius:
    """The radius a temporal-depth-k multistep realizes: every direction's
    halo scaled by k, so one exchange feeds k steps."""
    if k == 1:
        return radius
    out = Radius.constant(0)
    for d, r in radius._r.items():
        out.set_dir(d, r * k)
    return out


# -- placement: the wire matrix and the QAP's cost --------------------------------


def placement_wire_matrix(spec: GridSpec, mesh_dim, per_cell_bytes: int = 1):
    """Pairwise wire volume between mesh positions (row-major z, y, x): every
    active direction's halo of every block, attributed to its (sender,
    receiver) positions; self-wrap and resident-internal traffic excluded."""
    import numpy as np

    md = Dim3.of(mesh_dim)
    if spec.dim.x % md.x or spec.dim.y % md.y or spec.dim.z % md.z:
        raise ValueError(f"mesh {md} does not divide partition {spec.dim}")
    c = Dim3(spec.dim.x // md.x, spec.dim.y // md.y, spec.dim.z // md.z)
    n = md.flatten()
    m = np.zeros((n, n), dtype=np.float64)

    def slot(b: Dim3) -> int:
        return (b.x // c.x) + (b.y // c.y) * md.x + (b.z // c.z) * md.x * md.y

    for iz in range(spec.dim.z):
        for iy in range(spec.dim.y):
            for ix in range(spec.dim.x):
                src = Dim3(ix, iy, iz)
                sz = spec.block_size(src)
                for d in DIRECTIONS_26:
                    if spec.radius.dir(-d) == 0:
                        continue
                    dst = (src + d).wrap(spec.dim)
                    if dst == src:
                        continue
                    ss, ds = slot(src), slot(dst)
                    if ss == ds:
                        continue
                    m[ss, ds] += halo_extent(-d, sz, spec.radius).flatten() * per_cell_bytes
    return m


def placement_cost(w, link_costs, placement=None) -> float:
    """``sum_ab w[a,b] * link[f[a],f[b]]`` with ``0 * inf == 0``;
    ``placement=None`` is the identity assignment."""
    import numpy as np

    w = np.asarray(w, dtype=np.float64)
    d = np.asarray(link_costs, dtype=np.float64)
    f = np.arange(w.shape[0]) if placement is None else np.asarray(placement, dtype=np.intp)
    dperm = d[np.ix_(f, f)]
    prod = w * dperm
    prod[(w == 0) | (dperm == 0)] = 0.0
    return float(prod.sum())


def uniform_link_costs(link_costs) -> bool:
    """True when every off-diagonal link costs the same: placement is then
    cost-neutral and identity is optimal."""
    import numpy as np

    d = np.asarray(link_costs, dtype=np.float64)
    n = d.shape[0]
    if n < 2:
        return True
    off = d[~np.eye(n, dtype=bool)]
    return bool(np.all(off == off[0]))


def solve_placement(w, link_costs) -> Optional[Tuple[int, ...]]:
    """The optimal placement for (wire volumes, link costs), or None when
    identity is optimal: always None for uniform links, which every set of
    positions on one card has. Non-uniform links need the QAP solver of
    ``parallel/qap``, which waits with positions on distinct devices for
    ROADMAP.md queue A item 5."""
    if uniform_link_costs(link_costs):
        return None
    raise NotImplementedError(
        "placement over non-uniform link costs: the QAP solver (parallel/qap) is "
        "ROADMAP.md queue A item 5")


def feasible(config: PlanConfig, choice: PlanChoice) -> Optional[Tuple]:
    """``(spec, mesh_dim, resident)`` when the candidate can realize on this
    config, else None: the JAX package's constraints, unchanged (the block
    count a multiple of ``ndev``, residents stacked z-heaviest, no block
    thinner than the radius times k; fused REMOTE_DMA only at k == 1,
    persistent REMOTE_DMA only at k >= 2, both single-resident; a placement
    a permutation of the positions; a hierarchy infeasible on any config
    without hosts, which the port never enumerates)."""
    if validate_placement(choice.placement, config.ndev) is not None:
        return None
    if choice.kernel_variant == FUSED_VARIANT:
        if choice.method != REMOTE_DMA or choice.multistep_k != 1:
            return None
    if choice.kernel_variant == PERSISTENT_VARIANT:
        if choice.method != REMOTE_DMA or choice.multistep_k < 2:
            return None
    dim = Dim3.of(choice.partition)
    g = Dim3.of(config.grid)
    if g.x < dim.x or g.y < dim.y or g.z < dim.z:
        return None
    nb = dim.flatten()
    if nb % config.ndev:
        return None
    radius = scale_radius(config.radius_obj(), choice.multistep_k)
    try:
        spec = GridSpec(g, dim, radius)
    except (AssertionError, ValueError):
        return None
    c = nb // config.ndev
    if c == 1:
        mesh_dim = dim
    else:
        try:
            mesh_dim = stack_residents(dim, c)
        except ValueError:
            return None
    for sizes, rm, rp in ((spec.sizes_x, radius.x(-1), radius.x(1)),
                          (spec.sizes_y, radius.y(-1), radius.y(1)),
                          (spec.sizes_z, radius.z(-1), radius.z(1))):
        if min(sizes) < max(rm, rp):
            return None  # the halo would span several blocks
    resident = Dim3(dim.x // mesh_dim.x, dim.y // mesh_dim.y, dim.z // mesh_dim.z)
    if choice.kernel_variant in (FUSED_VARIANT, PERSISTENT_VARIANT) and resident != Dim3(1, 1, 1):
        return None  # the fused and persistent kernels are single-resident
    if choice.hierarchy is not None:
        return None  # no host structure to split over (queue A item 5)
    if choice.host_placement is not None:
        return None
    return spec, mesh_dim, resident


def score(config: PlanConfig, choice: PlanChoice, calibration: Optional[dict] = None,
          link_costs=None) -> Optional[PlanCost]:
    """Static per-step cost of one candidate (None when infeasible), a
    function of the dtype multiset only. ``calibration`` overrides the
    platform's constants (:func:`platform_calibration`) per entry.
    ``link_costs`` scales the wire term of a placed choice by its QAP cost
    ratio against identity (1 for uniform links)."""
    cal = merge_calibration(platform_calibration(config.platform), calibration)
    feas = feasible(config, choice)
    if feas is None:
        return None
    spec, mesh_dim, resident = feas
    fused = choice.kernel_variant == FUSED_VARIANT
    persistent = choice.kernel_variant == PERSISTENT_VARIANT
    plan = build_plan(spec, mesh_dim, choice.method, batch_quantities=choice.batch_quantities,
                      resident=resident, fused=fused, persistent=persistent)
    itemsizes = config.itemsizes()
    nq = config.num_quantities
    ngroups = config.dtype_group_count
    collectives = plan.collectives_per_exchange(nq, ngroups)
    wire = plan.wire_bytes(itemsizes, floating=config.floating_flags())
    local = plan.local_bytes(itemsizes)
    card = config.platform == "cuda"
    if card:
        carriers = ([n for _dt, n in config.quantities] if choice.batch_quantities
                    else [1] * nq)
        dmas = plan.carrier_launches(carriers, ngroups)
    else:
        dmas = plan.dmas_per_exchange(nq, ngroups)
    pratio = 1.0
    if link_costs is not None and choice.placement is not None and wire:
        w = placement_wire_matrix(spec, mesh_dim)
        base = placement_cost(w, link_costs)
        if base > 0:
            pratio = placement_cost(w, link_costs, choice.placement) / base
    launch_s = 0.0
    if choice.method == REMOTE_DMA and not card:
        launch_s = plan.launches_per_chunk(choice.multistep_k) * cal["persistent"]["cpu_dispatch_s"]
    local_s = local / cal["local_bytes_per_s"]
    if choice.method == REMOTE_DMA:
        rd = cal["remote_dma"]
        per_dma = rd["dma_overhead_s"] if card else rd["cpu_emulation_overhead_s"]
        bw = rd.get("wire_bytes_per_s", cal["wire_bytes_per_s"])
        wire_s = wire / bw * pratio
        if card:  # a local byte moves through the same memory as a crossing one
            local_s = local / bw
    if fused:
        # the fused substep runs max(interior compute, wire) + boundary
        # compute: only the wire time the interior does not hide is charged
        b = spec.base
        r0 = config.radius_obj()
        shrink = [(rm + rp) if n > 1 else 0 for n, rm, rp in (
            (mesh_dim.x, r0.x(-1), r0.x(1)), (mesh_dim.y, r0.y(-1), r0.y(1)),
            (mesh_dim.z, r0.z(-1), r0.z(1)))]
        interior_cells = (max(0, b.x - shrink[0]) * max(0, b.y - shrink[1])
                          * max(0, b.z - shrink[2]))
        interior_s = interior_cells * nq * cal["cell_update_s"]
        exchange_s = dmas * per_dma + max(0.0, wire_s - interior_s) + local_s + launch_s
    elif choice.method == REMOTE_DMA:
        exchange_s = dmas * per_dma + wire_s + local_s + launch_s
    else:
        overhead = cal["permute_overhead_s"][choice.method]
        exchange_s = (collectives * overhead + wire / cal["wire_bytes_per_s"] * pratio
                      + local / cal["local_bytes_per_s"])
    k = choice.multistep_k
    compute_overhead_s = 0.0
    if k > 1:
        # deep halos trade exchanges for redundant edge compute: on average
        # a (k-1)/2 radius-deep shell over every block face
        b = spec.base
        r0 = config.radius_obj()
        rbar = (r0.x(-1) + r0.x(1) + r0.y(-1) + r0.y(1) + r0.z(-1) + r0.z(1)) / 6.0
        surface = 2 * (b.x * b.y + b.x * b.z + b.y * b.z) * spec.num_blocks()
        extra_cells = surface * rbar * (k - 1) / 2.0
        compute_overhead_s = extra_cells * nq * cal["cell_update_s"]
    vf = cal["variant_factor"].get(choice.kernel_variant, 1.0)
    total = exchange_s / k + compute_overhead_s * vf
    return PlanCost(total_s=total, exchange_s=exchange_s, collectives=collectives,
                    wire_bytes=wire, local_bytes=local, compute_overhead_s=compute_overhead_s,
                    dmas=dmas)


def candidate_partitions(config: PlanConfig,
                         oversubscribe: Sequence[int] = (1,)) -> List[Tuple[int, int, int]]:
    """All (px, py, pz) block grids of ``ndev * c`` blocks (c in
    ``oversubscribe``), in a fixed order; :func:`score` filters them."""
    out = []
    for c in oversubscribe:
        n = config.ndev * c
        for px in range(1, n + 1):
            if n % px:
                continue
            nyz = n // px
            for py in range(1, nyz + 1):
                if nyz % py:
                    continue
                out.append((px, py, nyz // py))
    return out


# the default kernel-variant set, compared by identity: it grows REMOTE_DMA
# by its fused variant (and its persistent one when ks reach 2); an
# explicit list, (None,) included, is taken as given
DEFAULT_VARIANTS: Tuple[Optional[str], ...] = (None,)


def enumerate_candidates(config: PlanConfig, methods: Iterable[str] = PLANNED_METHODS,
                         batch_options: Iterable[bool] = (True, False),
                         ks: Iterable[int] = (1,),
                         variants: Iterable[Optional[str]] = DEFAULT_VARIANTS,
                         oversubscribe: Sequence[int] = (1,), link_costs=None,
                         hierarchy_hosts: Optional[int] = None) -> List[PlanChoice]:
    """The search space: partition x method x quantity batching x temporal
    depth k x kernel variant, in the JAX package's order. Batching branches
    only with several quantities. With the default variant set REMOTE_DMA
    also branches on its fused variant, and on its persistent one when
    ``ks`` reach 2. ``link_costs`` adds each single-resident partition's
    solved placement beside identity (none for uniform links).
    ``hierarchy_hosts`` above 1 raises: hierarchical candidates are
    ROADMAP.md queue A item 5."""
    if hierarchy_hosts is not None and hierarchy_hosts > 1:
        raise NotImplementedError(
            f"hierarchical candidates over {hierarchy_hosts} hosts: ROADMAP.md queue A item 5")
    if config.num_quantities <= 1:
        batch_options = (True,)
    default_variants = variants is DEFAULT_VARIANTS
    ks = tuple(ks)
    placed_by_part: Dict[Tuple[int, int, int], Optional[Tuple[int, ...]]] = {}

    def placed_for(part) -> Optional[Tuple[int, ...]]:
        if link_costs is None:
            return None
        if part not in placed_by_part:
            placed_by_part[part] = None
            feas = feasible(config, PlanChoice(partition=part, method=AXIS_COMPOSED))
            if feas is not None and feas[2] == Dim3(1, 1, 1):
                placed_by_part[part] = solve_placement(
                    placement_wire_matrix(feas[0], feas[1]), link_costs)
        return placed_by_part[part]

    def variant_list(method) -> List[Optional[str]]:
        vlist = list(variants)
        if method == REMOTE_DMA and default_variants:
            if FUSED_VARIANT not in vlist:
                vlist.append(FUSED_VARIANT)
            if PERSISTENT_VARIANT not in vlist and any(k >= 2 for k in ks):
                vlist.append(PERSISTENT_VARIANT)
        return vlist

    out = []
    for part in candidate_partitions(config, oversubscribe):
        placed = placed_for(part)
        placements = (None,) if placed is None else (None, placed)
        for method in methods:
            vlist = variant_list(method)
            for batch in batch_options:
                for k in ks:
                    for variant in vlist:
                        for placement in placements:
                            out.append(PlanChoice(partition=part, method=method,
                                                  batch_quantities=batch, multistep_k=k,
                                                  kernel_variant=variant, placement=placement))
    return out


def rank(config: PlanConfig, candidates: Iterable[PlanChoice],
         calibration: Optional[dict] = None,
         link_costs=None) -> List[Tuple[PlanCost, PlanChoice]]:
    """Feasible candidates, cheapest first; ties break on the label, so the
    order is total and deterministic."""
    scored = []
    for choice in candidates:
        c = score(config, choice, calibration, link_costs=link_costs)
        if c is not None:
            scored.append((c, choice))
    scored.sort(key=lambda t: (t[0].total_s, t[1].label()))
    return scored
