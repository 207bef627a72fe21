from .grid import GridSpec
from .handle import DataHandle

__all__ = ["DataHandle", "GridSpec"]
