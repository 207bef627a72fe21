"""Device-interconnect distances of one node.

The port's counterpart of ``stencil_tpu.parallel.device_topo`` for one
process (reference: include/stencil/gpu_topology.hpp,
src/gpu_topology.cpp:22-95: NVLink, then the PCIe common-ancestor ladder,
distances 0.1-7.0, bandwidth = 1/distance).

A position names a torch device. The JAX package's ladder is kept:
:data:`DIST_SELF` for a device and itself, :data:`DIST_SAME_PROCESS`
between devices of one process, :data:`DIST_REMOTE` across processes.

- Positions that name the same CUDA device are at :data:`DIST_SELF`: the
  one-card mesh (several positions on ``cuda:0``) moves its halos inside
  that card's memory.
- Distinct CUDA devices of the node take their distance from ``nvidia-smi
  topo -m`` (:func:`parse_topo_matrix`), each link label mapped onto the
  reference's ladder (:data:`LINK_DISTANCE`): NVLink 1.0 (the JAX
  package's same-process distance), then PIX, PXB, PHB and NODE, and SYS
  (across the CPU sockets) at 7.0 (its remote distance). No NVML binding
  is installed, so the tool's text is the source.
- A CPU position stands for one virtual CPU device of the JAX package's
  mesh (what the tests hold the port to), so two CPU positions are
  distinct devices of one process, :data:`DIST_SAME_PROCESS` apart.
- Positions of distinct hosts (:func:`host_assignment`: the owning
  process of a ``parallel.distributed.Position``, or the emulated host of
  the virtual-host knob) are :data:`DIST_REMOTE` apart, as in the JAX
  package: on one card too, since a position in another process moves its
  halos through CUDA IPC and an event handshake.

The virtual-host knob (``STENCIL_VIRTUAL_HOSTS=N``) splits the index-sorted
position list into N emulated hosts, as the JAX package's does.
"""

from __future__ import annotations

import os
import re
import subprocess
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

DIST_SELF = 0.1
DIST_SAME_PROCESS = 1.0
DIST_REMOTE = 7.0

VIRTUAL_HOSTS_ENV = "STENCIL_VIRTUAL_HOSTS"

# ``nvidia-smi topo -m`` link labels on the reference's ladder
# (src/gpu_topology.cpp:22-27): NV<n> bonded NVLinks, PIX one PCIe bridge,
# PXB several, PHB the PCIe host bridge, NODE host bridges within a NUMA
# node, SYS across NUMA nodes.
LINK_DISTANCE: Dict[str, float] = {
    "X": DIST_SELF, "NV": DIST_SAME_PROCESS, "PIX": 3.0, "PXB": 4.0, "PHB": 5.0,
    "NODE": 6.0, "SYS": DIST_REMOTE,
}

_ANSI = re.compile(r"\x1b\[[0-9;]*m")


def link_distance(label: str) -> float:
    """The ladder distance of one ``nvidia-smi topo -m`` cell."""
    label = label.strip()
    key = "NV" if re.fullmatch(r"NV\d+", label) else label
    if key not in LINK_DISTANCE:
        raise ValueError(f"unknown nvidia-smi topo link label {label!r} "
                         f"(known: {', '.join(sorted(LINK_DISTANCE))}, NV<n>)")
    return LINK_DISTANCE[key]


def parse_topo_matrix(text: str) -> np.ndarray:
    """The GPU-to-GPU distance matrix of ``nvidia-smi topo -m`` output: the
    header names the ``GPU<i>`` columns, each ``GPU<i>`` row gives its links
    in that order (NIC columns and the affinity columns after them are
    ignored)."""
    lines = [_ANSI.sub("", ln) for ln in text.splitlines()]
    # the header is indented; each row starts at its GPU<i> label
    header = next((ln for ln in lines if ln[:1].isspace() and "GPU0" in ln.split()), None)
    if header is None:
        raise ValueError("no GPU column header in the nvidia-smi topo output")
    cols = [t for t in header.split() if re.fullmatch(r"GPU\d+", t)]
    n = len(cols)
    rows = {}
    for ln in lines:
        toks = ln.split()
        if (not ln[:1].isspace() and toks and re.fullmatch(r"GPU\d+", toks[0])
                and len(toks) > n):
            rows[toks[0]] = [link_distance(t) for t in toks[1:n + 1]]
    missing = [c for c in cols if c not in rows]
    if missing:
        raise ValueError(f"nvidia-smi topo output lacks the rows of {', '.join(missing)}")
    return np.array([rows[c] for c in cols], dtype=np.float64)


def nvidia_smi_topo() -> str:
    """``nvidia-smi topo -m``'s text; raises when the tool fails."""
    try:
        p = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True,
                           timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"nvidia-smi topo -m: {e}") from e
    if p.returncode != 0:
        raise RuntimeError(f"nvidia-smi topo -m failed (rc {p.returncode}): "
                           f"{p.stderr.strip()[:200]}")
    return p.stdout


def _smi_index(index: int) -> int:
    """nvidia-smi's GPU number of torch's CUDA device ``index`` (through
    ``CUDA_VISIBLE_DEVICES`` when it lists numbers)."""
    vis = [t.strip() for t in os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",") if t.strip()]
    if vis and all(t.isdigit() for t in vis) and index < len(vis):
        return int(vis[index])
    return index


def virtual_hosts() -> int:
    """The ``STENCIL_VIRTUAL_HOSTS`` count (0: the knob is off)."""
    raw = os.environ.get(VIRTUAL_HOSTS_ENV, "").strip()
    if not raw:
        return 0
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(f"{VIRTUAL_HOSTS_ENV}={raw!r} is not an integer host count")
    return max(0, n)


def _device(p) -> torch.device:
    return torch.device(getattr(p, "device", p))


def host_assignment(positions: Sequence, hosts: Optional[int] = None) -> List[int]:
    """Each position's host index. With N virtual hosts (``hosts``, by
    default the knob) the index-sorted list splits into N contiguous
    segments, so a permutation never moves a position to another emulated
    host; with the knob off a position's host is its owning process (a
    ``parallel.distributed.Position``), 0 for a bare torch device."""
    n = len(positions)
    h = virtual_hosts() if hosts is None else int(hosts)
    if h > 0:
        if n % h:
            raise ValueError(f"{h} virtual hosts do not divide {n} devices")
        ids = [getattr(p, "index", i) for i, p in enumerate(positions)]
        rank = {pid: r for r, pid in enumerate(sorted(ids))}
        return [rank[pid] * h // n for pid in ids]
    return [int(getattr(p, "process_index", 0)) for p in positions]


def host_groups(positions: Sequence, hosts: Optional[int] = None) -> List[list]:
    """Positions grouped by host (ascending host index)."""
    groups: dict = {}
    for p, hidx in zip(positions, host_assignment(positions, hosts)):
        groups.setdefault(hidx, []).append(p)
    return [groups[k] for k in sorted(groups)]


def distance_matrix(positions: Sequence, topo: Optional[str] = None) -> np.ndarray:
    """Distances between ``positions`` (torch devices, their names, or
    ``parallel.distributed.Position`` entries). ``topo`` is ``nvidia-smi
    topo -m``'s text, read from the tool only when two positions of one
    host name distinct CUDA devices."""
    devs = [_device(p) for p in positions]
    assign = host_assignment(positions)
    n = len(devs)
    m = np.zeros((n, n), dtype=np.float64)
    links = None
    for i, a in enumerate(devs):
        for j, b in enumerate(devs):
            if i == j:
                m[i, j] = DIST_SELF
            elif assign[i] != assign[j]:
                m[i, j] = DIST_REMOTE
            elif a.type == "cuda" and b.type == "cuda":
                ia, ib = a.index or 0, b.index or 0
                if ia == ib:
                    m[i, j] = DIST_SELF
                else:
                    if links is None:
                        links = parse_topo_matrix(topo if topo is not None else nvidia_smi_topo())
                    m[i, j] = links[_smi_index(ia), _smi_index(ib)]
            else:
                m[i, j] = DIST_SAME_PROCESS
    return m


def bandwidth_matrix(positions: Sequence, topo: Optional[str] = None) -> np.ndarray:
    """bandwidth = 1/distance (reference: src/gpu_topology.cpp:95)."""
    return 1.0 / distance_matrix(positions, topo)

