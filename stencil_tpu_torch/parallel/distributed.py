"""Several processes: the process group, and the global list of positions.

The port's counterpart of ``stencil_tpu.parallel.distributed`` (the
reference's MPI bootstrap and ``MpiTopology.colocated``,
mpi_topology.hpp:20-30, :95). Every process of a run calls
:func:`init_distributed` (or :func:`maybe_init_from_env`) before it
realizes a domain; the group is ``torch.distributed`` over gloo, given its
address (``tcp://<coordinator>``), its size and the rank of the process.
The launcher (``apps/launch_multiprocess``, the counterpart of
``scripts/launch_multiprocess.sh``) sets the same environment variables as
the JAX package's: ``STENCIL_COORDINATOR``, ``STENCIL_NUM_PROCESSES``,
``STENCIL_PROCESS_ID`` and ``STENCIL_LOCAL_CPU_DEVICES`` (CPU positions a
process); on the card it sets ``STENCIL_LOCAL_CUDA_POSITIONS``, the
positions a process puts on its current CUDA device.

A process names its own positions (torch devices, as ``set_devices``
takes them); :func:`global_positions` is the all-gather, in rank order, of
every process's positions, each a :class:`Position` with its owner, host
and, on the card, the card's UUID. That is the JAX package's global device
order (process 0's devices first), which ``DeviceMesh`` lays onto the
partition x fastest, so flat position ``i`` belongs to the rank whose slice
of the list holds ``i``.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..utils.logging import process_index  # noqa: F401  (this process's rank, 0 without a group)

COORDINATOR_ENV = "STENCIL_COORDINATOR"
NUM_PROCESSES_ENV = "STENCIL_NUM_PROCESSES"
PROCESS_ID_ENV = "STENCIL_PROCESS_ID"
LOCAL_CPU_ENV = "STENCIL_LOCAL_CPU_DEVICES"
LOCAL_CUDA_ENV = "STENCIL_LOCAL_CUDA_POSITIONS"

# CPU positions a process holds (init_distributed's local_cpu_devices)
_local_cpu = 0


@dataclass(frozen=True)
class Position:
    """One block position of the global list: its flat index, the rank
    that owns it, its host, its torch device (as that rank names it) and,
    for a CUDA position, the card's UUID."""

    index: int
    process_index: int
    host: str
    device: str
    uuid: Optional[str] = None


def _group_up() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Processes of the run (1 without a process group)."""
    return torch.distributed.get_world_size() if _group_up() else 1


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_cpu_devices: int = 0) -> Tuple[int, int]:
    """Join the run's gloo process group; returns ``(rank, world)``. Every
    argument falls back to its ``STENCIL_*`` environment variable;
    ``coordinator`` is ``host:port`` of rank 0. ``local_cpu_devices`` = N
    gives this process N CPU positions (:func:`default_positions`)."""
    global _local_cpu
    coordinator = coordinator or os.environ.get(COORDINATOR_ENV)
    if num_processes is None and os.environ.get(NUM_PROCESSES_ENV):
        num_processes = int(os.environ[NUM_PROCESSES_ENV])
    if process_id is None and os.environ.get(PROCESS_ID_ENV):
        process_id = int(os.environ[PROCESS_ID_ENV])
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs the coordinator, the process count and this "
                         f"process's rank (or {COORDINATOR_ENV}, {NUM_PROCESSES_ENV} and "
                         f"{PROCESS_ID_ENV})")
    _local_cpu = int(local_cpu_devices)
    if not _group_up():
        torch.distributed.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                             world_size=int(num_processes),
                                             rank=int(process_id))
    return process_index(), process_count()


def maybe_init_from_env() -> bool:
    """Join the process group when the launch environment is set (by
    ``apps/launch_multiprocess`` or a cluster launcher), else do nothing;
    returns whether it joined. The apps call it at the top of ``main``, so
    one CLI runs in one process or several."""
    if not os.environ.get(COORDINATOR_ENV):
        return False
    init_distributed(local_cpu_devices=int(os.environ.get(LOCAL_CPU_ENV, "0") or 0))
    return True


def default_positions() -> List[torch.device]:
    """This process's positions when the caller names none: its CPU
    positions (``local_cpu_devices`` / ``STENCIL_LOCAL_CPU_DEVICES``), or
    ``STENCIL_LOCAL_CUDA_POSITIONS`` positions on the current CUDA device,
    or that device alone; raises without one."""
    ncpu = _local_cpu or int(os.environ.get(LOCAL_CPU_ENV, "0") or 0)
    if ncpu:
        return [torch.device("cpu")] * ncpu
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; give the process CPU positions "
                           f"({LOCAL_CPU_ENV}, or init_distributed(local_cpu_devices=N))")
    dev = torch.device("cuda", torch.cuda.current_device())
    return [dev] * max(1, int(os.environ.get(LOCAL_CUDA_ENV, "1") or 1))


def card_uuid(dev: torch.device) -> Optional[str]:
    """The UUID of a CUDA position's card (None for the CPU)."""
    if dev.type != "cuda":
        return None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return str(torch.cuda.get_device_properties(index).uuid)


def global_positions(local: Sequence) -> List[Position]:
    """Every process's positions, in rank order: the all-gather of each
    rank's ``local`` positions (torch devices or their names), each with its
    owner, host and card UUID. Collective: every rank of the group calls it."""
    own = [(socket.gethostname(), str(torch.device(d)), card_uuid(torch.device(d)))
           for d in local]
    if process_count() == 1:
        gathered = [own]
    else:
        gathered = [None] * process_count()
        torch.distributed.all_gather_object(gathered, own)
    out: List[Position] = []
    for rank, entries in enumerate(gathered):
        for host, dev, uuid in entries:
            out.append(Position(len(out), rank, host, dev, uuid))
    return out


def colocated_devices(positions: Sequence[Position]) -> Dict[int, List[Position]]:
    """Positions grouped by owning process (the reference's
    ``MpiTopology.colocated``, mpi_topology.hpp:95)."""
    groups: Dict[int, List[Position]] = {}
    for p in positions:
        groups.setdefault(p.process_index, []).append(p)
    return groups


def local_devices(positions: Optional[Sequence[Position]] = None) -> List[Position]:
    """This process's own positions of ``positions`` (default: the global
    list of every rank's :func:`default_positions`, a collective)."""
    if positions is None:
        positions = global_positions(default_positions())
    return colocated_devices(positions).get(process_index(), [])


def position_count(local: int) -> int:
    """Positions of the run: the sum of every rank's ``local`` count
    (collective when several processes run)."""
    if process_count() == 1:
        return int(local)
    counts = [None] * process_count()
    torch.distributed.all_gather_object(counts, int(local))
    return sum(counts)
