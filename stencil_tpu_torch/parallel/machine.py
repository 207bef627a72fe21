"""Machine — the inventory of one node: its process, its host and the
devices of a run's positions.

The port's counterpart of ``stencil_tpu.parallel.machine`` (reference:
machine.hpp:106-140, src/machine.cpp:72-147). A position names a torch
device; its facts come from ``torch.cuda.get_device_properties`` (name, SM
count, memory, compute capability) on the card. No NVML binding is
installed, and none can be. A CPU position stands for one virtual CPU
device of the JAX package's mesh (``device_topo``), so its index is its
position. Distances come from ``device_topo``.

In a process group of several ranks (``parallel/distributed``) the
inventory is global: each rank names its own positions, and the list is
their all-gather in rank order, each row with its owning process; the
hostnames are gathered as the reference's MPI_Gather does
(src/machine.cpp:85-101), by ``all_gather_object``.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import distributed
from .device_topo import bandwidth_matrix, distance_matrix


@dataclass(frozen=True)
class DeviceInfo:
    """One position's inventory row: the JAX package's fields (``kind`` is
    the card's name, ``device_kind`` in the records; a GPU has no torus
    coordinates or core index, the TPU fields) and, on the card, the SM
    count, memory and compute capability."""

    index: int
    platform: str
    kind: str
    process_index: int
    sm_count: Optional[int] = None
    memory_bytes: Optional[int] = None
    capability: Optional[Tuple[int, int]] = None


def default_positions() -> List[torch.device]:
    """Every CUDA device of the process; raises without one (pass CPU
    positions, ``["cpu"] * n``, to run on the CPU)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device is visible; pass devices=['cpu'] * n for CPU "
                           "positions")
    return [torch.device("cuda", i) for i in range(n)]


def device_info(position: int, dev: torch.device, process: int = 0) -> DeviceInfo:
    """The inventory row of position ``position`` on ``dev``, owned by
    process ``process`` (whose card this process reads: one card is shared
    by the processes of one host)."""
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        props = torch.cuda.get_device_properties(index)
        return DeviceInfo(index=index, platform="cuda", kind=props.name, process_index=process,
                          sm_count=props.multi_processor_count,
                          memory_bytes=props.total_memory,
                          capability=(props.major, props.minor))
    return DeviceInfo(index=position, platform=dev.type, kind=dev.type, process_index=process)


@dataclass
class Machine:
    """The inventory of this process's host and its positions' devices."""

    process_index: int
    process_count: int
    hostnames: Dict[int, str]  # process -> hostname
    devices: List[DeviceInfo] = field(default_factory=list)
    positions: list = field(default_factory=list, repr=False)

    @classmethod
    def detect(cls, devices: Optional[Sequence] = None) -> "Machine":
        """The machine of ``devices`` (this process's positions: torch
        devices or their names; default every CUDA device). With several
        processes, every rank's positions in rank order (a collective)."""
        local = ([torch.device(d) for d in devices] if devices is not None
                 else default_positions())
        if distributed.process_count() == 1:
            return cls(process_index=0, process_count=1, hostnames=_gather_hostnames(),
                       devices=[device_info(i, d) for i, d in enumerate(local)],
                       positions=local)
        glob = distributed.global_positions(local)
        return cls(process_index=distributed.process_index(),
                   process_count=distributed.process_count(), hostnames=_gather_hostnames(),
                   devices=[device_info(p.index, torch.device(p.device), p.process_index)
                            for p in glob],
                   positions=glob)

    def num_nodes(self) -> int:
        return len(set(self.hostnames.values())) if self.hostnames else 1

    def hostname_of_device(self, info: DeviceInfo) -> str:
        return self.hostnames.get(info.process_index, "?")

    def devices_of_process(self, process: int) -> List[DeviceInfo]:
        return [d for d in self.devices if d.process_index == process]

    def distance_matrix(self) -> np.ndarray:
        return distance_matrix(self.positions)

    def bandwidth_matrix(self) -> np.ndarray:
        return bandwidth_matrix(self.positions)

    def summary(self) -> str:
        """Human-readable dump (the machine-info print,
        reference: bin/machine_info.cu:49-75)."""
        lines = [
            f"machine: {self.num_nodes()} node(s), {self.process_count} "
            f"process(es), {len(self.devices)} device(s)"
        ]
        for p in sorted({d.process_index for d in self.devices}):
            lines.append(f"  process {p} on {self.hostnames.get(p, '?')}:")
            for d in self.devices_of_process(p):
                extra = ""
                if d.capability is not None:
                    extra = (f" sm_{d.capability[0]}{d.capability[1]} {d.sm_count} SMs "
                             f"{d.memory_bytes / 2**30:.1f} GiB")
                lines.append(f"    device {d.index}: {d.platform} ({d.kind}){extra}")
        return "\n".join(lines)


def _gather_hostnames() -> Dict[int, str]:
    """The hostname of every process (the reference's MPI_Gather,
    src/machine.cpp:85-101); with one process, this host's."""
    own = socket.gethostname()
    if distributed.process_count() == 1:
        return {0: own}
    names = [None] * distributed.process_count()
    torch.distributed.all_gather_object(names, own)
    return dict(enumerate(names))
