"""Astaroth MHD mini-app — the "joint stencils over multiple data types"
workload (reference: astaroth/ in socal-ucr/stencil, a trimmed copy of the
Astaroth magnetohydrodynamics code driven by the halo-exchange library).

The port's counterpart of ``stencil_tpu.astaroth``: eight fields (lnrho,
uux/y/z, ax/y/z, entropy) in fp64 (the reference's type) or fp32, radius-3
halos, 6th-order centered finite differences and Williamson RK3 low-storage
integration. One block, or every block of a partition resident on one GPU;
the RK3 stage runs on the hand-written kernel of ``ops/astaroth_substep``.
``boundconds`` holds the reference's (unused) non-periodic boundaries."""

from .config import AcMeshInfo, load_config
from .fd import FieldData, field_data
from .integrate import integrate_region, make_astaroth_step, rk3_integrate

__all__ = [
    "AcMeshInfo",
    "FieldData",
    "field_data",
    "integrate_region",
    "load_config",
    "make_astaroth_step",
    "rk3_integrate",
]
