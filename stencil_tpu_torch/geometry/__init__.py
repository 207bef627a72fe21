from .dim3 import CORNER_DIRS, DIRECTIONS_26, Dim3, EDGE_DIRS, FACE_DIRS
from .numeric import div_ceil, prime_factors
from .partition import NodePartition, RankPartition, decompose_zy, stack_residents
from .radius import Radius
from .rect3 import Rect3
from .region import (
    compute_offset,
    exterior_regions,
    halo_extent,
    halo_pos,
    halo_rect,
    interior_region,
    raw_size,
)

__all__ = [
    "CORNER_DIRS",
    "DIRECTIONS_26",
    "Dim3",
    "EDGE_DIRS",
    "FACE_DIRS",
    "NodePartition",
    "RankPartition",
    "Radius",
    "Rect3",
    "compute_offset",
    "decompose_zy",
    "div_ceil",
    "exterior_regions",
    "halo_extent",
    "halo_pos",
    "halo_rect",
    "interior_region",
    "prime_factors",
    "raw_size",
    "stack_residents",
]
