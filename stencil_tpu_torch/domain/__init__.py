from .block import LocalBlock, block_compute_slices, block_rect_slices
from .grid import GridSpec
from .handle import DataHandle

__all__ = ["DataHandle", "GridSpec", "LocalBlock", "block_compute_slices", "block_rect_slices"]
