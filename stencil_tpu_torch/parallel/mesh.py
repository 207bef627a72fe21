"""A mesh of block positions: the partition grid laid onto devices.

The port's counterpart of ``stencil_tpu.parallel.mesh`` (``grid_mesh``,
``mesh_dim``). A :class:`DeviceMesh` holds one block per position (or a
stack of resident blocks per position, ``parallel.exchange.position_blocks``;
the exchange then runs a mesh of every block); position
``(ix, iy, iz)`` has flat index ``ix + dx * (iy + dy * iz)`` (z slowest, x
fastest), the order of the JAX package's ``grid_mesh`` device array and of
the stacked block layout ``(bz, by, bx, pz, py, px)``. Each position's
block is its own allocation on that position's device.

A device may be named by several positions: the reference's
``dd.set_gpus({0,0})`` (stencil.hpp:154), which forces several subdomains
onto one GPU to exercise the distributed paths, and what the JAX package's
tests do with 8 virtual CPU devices. The port's exchanges run a mesh only
when every position sits on one device (:attr:`DeviceMesh.one_device`);
positions on distinct GPUs (peer access, event waits between phases) are
ROADMAP.md queue A item 5.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import torch

from ..geometry import Dim3

# (axis name, index of the axis in a position tuple (ix, iy, iz))
_AXIS_INDEX = {"x": 0, "y": 1, "z": 2}


class DeviceMesh:
    """``dim`` (positions along x, y, z) and one torch device per position,
    in flat position order (x fastest)."""

    def __init__(self, dim, devices: Sequence):
        self.dim = Dim3.of(dim)
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        if len(self.devices) != self.dim.flatten():
            raise ValueError(f"mesh {self.dim} needs {self.dim.flatten()} devices, "
                             f"got {len(self.devices)}")
        self._destinations: Dict[tuple, Tuple[int, ...]] = {}

    def __len__(self) -> int:
        return len(self.devices)

    def position(self, i: int) -> Tuple[int, int, int]:
        """``(ix, iy, iz)`` of flat index ``i``."""
        d = self.dim
        return (i % d.x, (i // d.x) % d.y, i // (d.x * d.y))

    def index(self, pos) -> int:
        """Flat index of position ``(ix, iy, iz)``."""
        d = self.dim
        ix, iy, iz = pos
        return ix + d.x * (iy + d.y * iz)

    def positions(self) -> Iterator[Tuple[int, int, int]]:
        for i in range(len(self)):
            yield self.position(i)

    def ring(self, axis: str) -> int:
        """Positions along ``axis``."""
        return (self.dim.x, self.dim.y, self.dim.z)[_AXIS_INDEX[axis]]

    def shifted(self, pos, step) -> Tuple[int, int, int]:
        """``pos + step`` (a (dx, dy, dz) offset), wrapped on every axis."""
        d = (self.dim.x, self.dim.y, self.dim.z)
        return tuple((p + s) % n for p, s, n in zip(pos, step, d))

    def destinations(self, step) -> Tuple[int, ...]:
        """Flat index of position + ``step`` (wrapped) for each position, in
        flat order; kept per step, since the kernels' wrappers ask on every
        launch."""
        step = tuple(step)
        if step not in self._destinations:
            self._destinations[step] = tuple(self.index(self.shifted(p, step))
                                             for p in self.positions())
        return self._destinations[step]

    def ring_neighbors(self, pos, axis: str) -> Tuple[Tuple[int, int, int], Tuple[int, int, int]]:
        """``(backward, forward)``: the positions one step toward -axis and
        +axis on ``axis``'s periodic ring (``pos`` itself on a ring of one)."""
        step = [0, 0, 0]
        step[_AXIS_INDEX[axis]] = 1
        fwd = self.shifted(pos, step)
        bwd = self.shifted(pos, [-s for s in step])
        return bwd, fwd

    @property
    def one_device(self) -> bool:
        """Every position on one device (the same CUDA index, or the CPU)."""
        return all(d == self.devices[0] for d in self.devices)

    @property
    def device(self) -> torch.device:
        """The one device of a :attr:`one_device` mesh."""
        if not self.one_device:
            raise NotImplementedError(
                f"positions on distinct devices {sorted({str(d) for d in self.devices})}: "
                "peer access and event waits between phases are ROADMAP.md queue A item 5")
        return self.devices[0]

