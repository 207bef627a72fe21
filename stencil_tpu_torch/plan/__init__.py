from .ir import (
    AXIS_COMPOSED,
    FUSED_VARIANT,
    PERSISTENT_VARIANT,
    REMOTE_DMA,
    ExchangePlan,
    build_plan,
)

__all__ = ["AXIS_COMPOSED", "FUSED_VARIANT", "PERSISTENT_VARIANT", "REMOTE_DMA",
           "ExchangePlan", "build_plan"]
