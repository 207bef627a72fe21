"""Multi-tenant batched campaigns on one device.

The port's counterpart of ``stencil_tpu.campaign``: ``driver.CampaignDriver``
packs queued tenant jobs into fixed-size batch slots, steps each slot as one
``(B, z, y, x)`` stack per quantity (on the card, jacobi: one tenant-form
sweep launch a step; astaroth: 3 tenant-form fill and 3 substep launches a
step) through ``fault/recover.run_guarded`` (per-lane health, rc-43 eviction with
backfill, per-tenant ``ckpt/`` snapshots), and ``compile_cache`` makes the
one-program-many-slots economics measurable. ``run_sequential`` is the
one-tenant-at-a-time jacobi baseline. ``serve/`` turns the driver into the
always-on daemon.

The user-facing surface is ``apps/campaign.py``. It exports what the JAX
package's ``campaign`` does, except ``batch_devices``: a slot lives on one
device.
"""

from .compile_cache import CompileCache, cache_key  # noqa: F401
from .driver import (  # noqa: F401
    WORKLOADS,
    CampaignDriver,
    Lane,
    TenantJob,
    TenantResult,
    astaroth_init_state,
    plan_slots,
    run_sequential,
    tenant_init_field,
)
from .health import SlotHealthGuard, TenantFault  # noqa: F401
from .inject import SlotInjector  # noqa: F401
