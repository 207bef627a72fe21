"""stencil_tpu_torch — the PyTorch/CUDA port of stencil_tpu for NVIDIA H100.

A periodic, halo-padded 3D grid of quantities with the jacobi3d and
Astaroth MHD workloads on top, running on hand-written Hopper kernels
(``csrc/``, built on first use with ``nvcc``). Entry points run on the GPU
unless the caller passes ``device="cpu"``, which runs the kernels' plain
PyTorch versions.

The port covers one block on one device so far: ``DistributedDomain`` with
a (1,1,1) partition, the self-wrap halo exchange, jacobi3d
(``apps.jacobi3d``) and the Astaroth mini-app (``astaroth``,
``apps.astaroth``).
"""

from .api import DistributedDomain, resolve_device
from .domain import DataHandle, GridSpec
from .geometry import (
    DIRECTIONS_26,
    Dim3,
    NodePartition,
    RankPartition,
    Radius,
    Rect3,
    decompose_zy,
)
from .parallel import HaloExchange, Method

__all__ = [
    "DIRECTIONS_26",
    "DataHandle",
    "Dim3",
    "DistributedDomain",
    "GridSpec",
    "HaloExchange",
    "Method",
    "NodePartition",
    "RankPartition",
    "Radius",
    "Rect3",
    "decompose_zy",
    "resolve_device",
]
