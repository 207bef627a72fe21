"""The neighbour topology of the partition grid, and the link costs.

The port's counterpart of ``stencil_tpu.parallel.topology`` (reference:
include/stencil/topology.hpp:9-30, src/topology.cpp): periodic boundaries
only, as in the reference, where a non-periodic one is fatal.

:func:`link_cost_matrix` is what the placement search prices wire volume
against: ``device_topo.distance_matrix`` of the positions, the locality
ladder (a position and itself 0.1, positions of one process 1.0, or their
``nvidia-smi topo`` distance on distinct cards, positions of distinct
processes or emulated hosts 7.0).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Sequence

from ..geometry import Dim3
from .device_topo import distance_matrix, host_assignment, host_groups, virtual_hosts  # noqa: F401


class Boundary(enum.Enum):
    NONE = 0
    PERIODIC = 1


@dataclass(frozen=True)
class Neighbor:
    index: Dim3
    exists: bool


class Topology:
    def __init__(self, extent, boundary: Boundary = Boundary.PERIODIC):
        if boundary != Boundary.PERIODIC:
            raise ValueError("only periodic boundaries are supported (as in the reference)")
        self.extent = Dim3.of(extent)
        self.boundary = boundary

    def get_neighbor(self, index, direction) -> Neighbor:
        idx = Dim3.of(index)
        d = Dim3.of(direction)
        if not (abs(d.x) <= 1 and abs(d.y) <= 1 and abs(d.z) <= 1):
            raise ValueError(f"direction components must be in {{-1, 0, 1}}; got {d}")
        return Neighbor(index=(idx + d).wrap(self.extent), exists=True)


def link_cost_matrix(positions: Sequence):
    """Per-position-pair link cost (lower is faster) for the placement
    search: :func:`device_topo.distance_matrix` of ``positions`` (torch
    devices, or the global ``parallel.distributed.Position`` list of a
    run of several processes)."""
    return distance_matrix(positions)
