"""machine-info — print the device inventory and the link matrices of a
run's positions.

The port's counterpart of ``stencil_tpu.apps.machine_info`` (reference:
bin/machine_info.cu:49-75, machine.hpp:106-140): the Machine model (the
node, its process, one device row per position: on the card its name, SM
count, memory and compute capability) plus the distance and bandwidth
matrices the placement layer reads (``parallel/device_topo``), and the
default partition the framework would choose for these positions
(``NodePartition`` hosts x positions per host).

``--json`` writes the inventory as telemetry records, one JSON object per
line (``machine``, ``machine.device``, ``machine.fabric``,
``machine.partition``, ``machine.distance_matrix``,
``machine.bandwidth_matrix``), which ``apps/report --validate`` accepts.

:func:`fabric_fingerprint` is the fabric a measurement ran on, which the
attribution records carry as ``fabric_*`` fields (the JAX package's keys).

Positions: every CUDA device by default; ``--devices cuda:0,cuda:0`` names
them (a device may repeat: a mesh of positions on one card); ``--cpu N``
takes N CPU positions, the JAX package's N virtual CPU devices.

Usage: python -m stencil_tpu_torch.apps.machine_info [--cpu 8 | --devices D,...]
           [--size 256] [--json]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np

from ..geometry import Dim3, NodePartition, Radius
from ..obs import telemetry
from ..parallel.device_topo import VIRTUAL_HOSTS_ENV
from ..parallel.machine import Machine


def run(devices=None, size: int = 256, radius: int = 1) -> dict:
    """The inventory, matrices and default partition of ``devices``
    (positions; default every CUDA device)."""
    m = Machine.detect(devices)
    n = len(m.devices)
    hosts = max(1, m.process_count)
    part = NodePartition(Dim3(size, size, size), Radius.constant(radius), hosts,
                         max(1, n // hosts))
    return {
        "machine": m,
        "dist": m.distance_matrix(),
        "bw": m.bandwidth_matrix(),
        "partition": part.dim(),
        "size": size,
    }


def fabric_fingerprint(machine: Optional[Machine] = None, devices=None) -> dict:
    """The scalar identity of the fabric a measurement ran on: process
    count, host count, device count (a position of a mesh counts as a
    device, as each virtual device does in the JAX package's mesh), the
    platform (the torch device type) and the virtual-host knob if set. The
    attribution records (``obs/attribution.emit_phase``) embed these as
    ``fabric_*`` fields, so a fitted calibration row can be traced to the
    fabric whose constants it encodes."""
    m = machine if machine is not None else Machine.detect(devices)
    platform = m.devices[0].platform if m.devices else "unknown"
    return {
        "processes": int(m.process_count),
        "hosts": int(m.num_nodes()),
        "devices": len(m.devices),
        "platform": str(platform),
        "virtual_hosts": os.environ.get(VIRTUAL_HOSTS_ENV, ""),
    }


def report(r: dict) -> str:
    m: Machine = r["machine"]
    with np.printoptions(precision=2, suppress=True, linewidth=200):
        return "\n".join(
            [
                m.summary(),
                f"default partition for {r['size']}^3: {r['partition']} "
                "(hosts x devices/host min-interface split)",
                "distance matrix (hops; self=0.1, remote=7.0):",
                str(r["dist"]),
                "bandwidth matrix (1/distance):",
                str(r["bw"]),
            ]
        )


def emit_records(r: dict, rec: "telemetry.Recorder") -> list:
    """The inventory as telemetry records (one JSON object per line in the
    sink): the machine-readable analogue of the reference's NVML dump."""
    m: Machine = r["machine"]
    out = [rec.meta(
        "machine",
        nodes=m.num_nodes(),
        processes=m.process_count,
        devices=len(m.devices),
        hostnames={str(k): v for k, v in sorted(m.hostnames.items())},
    )]
    for d in m.devices:
        out.append(rec.meta(
            "machine.device",
            index=d.index,
            platform=d.platform,
            device_kind=d.kind,
            process=d.process_index,
            sm_count=d.sm_count,
            memory_bytes=d.memory_bytes,
            capability=list(d.capability) if d.capability is not None else None,
        ))
    out.append(rec.meta("machine.fabric", **fabric_fingerprint(m)))
    part = r["partition"]
    out.append(rec.meta(
        "machine.partition",
        dim=[part.x, part.y, part.z],
        size=r["size"],
    ))
    out.append(rec.meta("machine.distance_matrix", matrix=np.asarray(r["dist"]).tolist()))
    out.append(rec.meta("machine.bandwidth_matrix", matrix=np.asarray(r["bw"]).tolist()))
    return out


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description="device inventory and link matrices")
    p.add_argument("--size", type=int, default=256, help="domain for the partition hint")
    p.add_argument("--radius", type=int, default=1)
    g = p.add_mutually_exclusive_group()
    g.add_argument("--cpu", type=int, default=0, help="N CPU positions (virtual devices)")
    g.add_argument("--devices", default="",
                   help="comma-separated positions, e.g. cuda:0,cuda:0 (default: every "
                        "CUDA device)")
    p.add_argument("--json", action="store_true",
                   help="emit the inventory as telemetry JSONL on stdout "
                        "(and to --metrics-out when given) instead of text")
    from ._bench_common import add_metrics_flags, start_metrics

    add_metrics_flags(p)
    args = p.parse_args(argv)
    devices = (["cpu"] * args.cpu if args.cpu
               else args.devices.split(",") if args.devices else None)
    rec = start_metrics(args, "machine_info")
    r = run(devices, size=args.size, radius=args.radius)
    if args.json:
        stdout_rec = telemetry.Recorder(sink=sys.stdout, app="machine_info", run_id=rec.run_id)
        emit_records(r, stdout_rec)
        if rec.enabled:
            emit_records(r, rec)
        return 0
    if rec.enabled:
        emit_records(r, rec)
    print(report(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
