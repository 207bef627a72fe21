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
tests do with 8 virtual CPU devices.

The positions may belong to several processes (``parallel/distributed``):
built from the global ``Position`` list, each position has its owner rank,
host and card UUID (:meth:`DeviceMesh.owner`, :meth:`DeviceMesh.is_local`,
:meth:`DeviceMesh.local_positions`). This process's own positions must
share one device (:attr:`DeviceMesh.one_device`, :attr:`DeviceMesh.device`
keep their meaning for them). Another rank's positions must sit on the
same card (same host and UUID; their halos move through CUDA IPC,
``parallel/ipc``) or, on the CPU, anywhere (gloo). A position on another
card or another host, and local positions on distinct GPUs (peer access
and NCCL between GPUs), are ROADMAP.md queue A item 5.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import torch

from ..geometry import Dim3

# (axis name, index of the axis in a position tuple (ix, iy, iz))
_AXIS_INDEX = {"x": 0, "y": 1, "z": 2}


class DeviceMesh:
    """``dim`` (positions along x, y, z) and one torch device per position,
    in flat position order (x fastest): torch devices (every position this
    process's), or the global ``parallel.distributed.Position`` list of a
    run of several processes."""

    def __init__(self, dim, devices: Sequence):
        from .distributed import Position, process_index

        self.dim = Dim3.of(dim)
        entries = list(devices)
        if len(entries) != self.dim.flatten():
            raise ValueError(f"mesh {self.dim} needs {self.dim.flatten()} devices, "
                             f"got {len(entries)}")
        self.rank = process_index()
        if entries and all(isinstance(e, Position) for e in entries):
            self.devices: List[torch.device] = [torch.device(e.device) for e in entries]
            self.owners = tuple(e.process_index for e in entries)
            self.hosts = tuple(e.host for e in entries)
            self.uuids = tuple(e.uuid for e in entries)
        else:
            self.devices = [torch.device(d) for d in entries]
            self.owners = (self.rank,) * len(entries)
            self.hosts = self.uuids = (None,) * len(entries)
        self._local = tuple(i for i, o in enumerate(self.owners) if o == self.rank)
        if not self._local:
            raise ValueError(f"process {self.rank} owns no position of the mesh")
        if self.multi_process:
            self._check_reach()
        self._destinations: Dict[tuple, Tuple[int, ...]] = {}

    def _check_reach(self) -> None:
        """Another rank's position must be on this process's card (same
        host and UUID) or, with CPU positions, anywhere."""
        i0 = self._local[0]
        kind = self.devices[i0].type
        for i, (dev, host, uuid) in enumerate(zip(self.devices, self.hosts, self.uuids)):
            if dev.type != kind:
                raise ValueError(f"position {i} is on {dev}, this process's on {kind}")
            if kind == "cuda" and (host, uuid) != (self.hosts[i0], self.uuids[i0]):
                raise NotImplementedError(
                    f"position {i} (process {self.owners[i]}) is on card {uuid} of host {host}, "
                    f"not on this process's card {self.uuids[i0]} of {self.hosts[i0]}: "
                    "positions on another card or host (peer access, NCCL between GPUs) are "
                    "ROADMAP.md queue A item 5")

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

    def owner(self, i: int) -> int:
        """The rank that owns flat position ``i``."""
        return self.owners[i]

    def is_local(self, i: int) -> bool:
        """Flat position ``i`` belongs to this process."""
        return self.owners[i] == self.rank

    def local_positions(self) -> Tuple[int, ...]:
        """This process's flat positions, ascending."""
        return self._local

    @property
    def multi_process(self) -> bool:
        """Some position belongs to another process."""
        return len(self._local) != len(self.devices)

    def neighbour_ranks(self, axis: str) -> Tuple[int, ...]:
        """The other ranks that own a ring neighbour of one of this
        process's positions along ``axis`` (the same set sends to this
        process: a periodic ring is symmetric)."""
        out = set()
        for i in self._local:
            for q in self.ring_neighbors(self.position(i), axis):
                out.add(self.owners[self.index(q)])
        out.discard(self.rank)
        return tuple(sorted(out))

    def message_ranks(self, steps) -> Tuple[int, ...]:
        """The other ranks that own position + s or position - s of one of
        this process's positions, for each (dx, dy, dz) step ``s``: the
        ranks its messages along ``steps`` come from or go to (symmetric
        whatever ``steps`` holds)."""
        out = set()
        for i in self._local:
            pos = self.position(i)
            for s in steps:
                for sign in (1, -1):
                    out.add(self.owners[self.index(self.shifted(pos, [sign * c for c in s]))])
        out.discard(self.rank)
        return tuple(sorted(out))

    @property
    def one_device(self) -> bool:
        """Every position of this process on one device (the same CUDA
        index, or the CPU)."""
        d0 = self.devices[self._local[0]]
        return all(self.devices[i] == d0 for i in self._local)

    @property
    def device(self) -> torch.device:
        """The one device of this process's positions (:attr:`one_device`)."""
        if not self.one_device:
            raise NotImplementedError(
                f"positions on distinct devices "
                f"{sorted({str(self.devices[i]) for i in self._local})}: peer access and event "
                "waits between GPUs are ROADMAP.md queue A item 5")
        return self.devices[self._local[0]]

