"""Exchange planning: the ExchangePlan IR (:mod:`ir`), the static cost model
(:mod:`cost`), the on-disk plan DB (:mod:`db`), the calibration fit
(:mod:`calibrate`), measured probes (:mod:`probe`), the autotuner
(:mod:`autotune`) and the mid-run hot-swap (:mod:`replan`).

Only :mod:`ir` is imported here (pure geometry); import the tuner explicitly
(``from stencil_tpu_torch.plan.autotune import autotune``).
"""

from .ir import (
    AXIS_COMPOSED,
    FUSED_VARIANT,
    PERSISTENT_VARIANT,
    REMOTE_DMA,
    ExchangePlan,
    PlanChoice,
    PlanConfig,
    build_plan,
    validate_placement,
)

__all__ = ["AXIS_COMPOSED", "FUSED_VARIANT", "PERSISTENT_VARIANT", "REMOTE_DMA",
           "ExchangePlan", "PlanChoice", "PlanConfig", "build_plan", "validate_placement"]
