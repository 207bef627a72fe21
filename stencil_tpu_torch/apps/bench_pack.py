"""bench-pack -- halo pack/unpack primitive throughput per direction.

The port's counterpart of ``stencil_tpu.apps.bench_pack`` (reference:
bin/bench_pack.cu): for each of the 26 directions, time gathering the halo
region into a flat buffer and scattering it back. The JAX version's pack is
``lax`` slicing + reshape and its unpack ``dynamic_update_slice``, fused
by XLA in a loop on one device, not a Pallas kernel; here they are torch
indexing on the same device: a strided copy of the region into a flat
buffer (pack), and the buffer plus one written back into the region
(unpack), with the buffer's first cell added to an accumulator, as the
JAX loop body does. On the card each iteration is three launches of
torch's own kernels; on the CPU the same ops run on the host.

Usage: python -m stencil_tpu_torch.apps.bench_pack --x 512 --y 512 --z 512 --iters 50
       python -m stencil_tpu_torch.apps.bench_pack --x 64 --y 64 --z 64 --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from ..api import resolve_device
from ..geometry import DIRECTIONS_26, Dim3, Radius, halo_rect, raw_size
from ..utils.sync import hard_sync


def region(rect):
    """The (z, y, x) slices of ``rect`` in a padded block."""
    return (slice(rect.lo.z, rect.hi.z), slice(rect.lo.y, rect.hi.y),
            slice(rect.lo.x, rect.hi.x))


def pack(arr: torch.Tensor, rect, buf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather ``rect`` of ``arr`` into the flat buffer ``buf`` (a new one
    when omitted); returns it."""
    src = arr[region(rect)]
    if buf is None:
        buf = torch.empty(src.numel(), dtype=arr.dtype, device=arr.device)
    buf.view(src.shape).copy_(src)
    return buf


def pack_fn(rect, iters):
    """``fn(arr, acc) -> (arr, acc)``: ``iters`` times pack ``rect`` of
    ``arr``, write the buffer plus one back into it (in place) and add the
    buffer's first cell to the 0-d accumulator ``acc`` (in place)."""
    zyx = region(rect)
    ext = rect.extent()
    bufs = {}

    def fn(arr, acc):
        key = (arr.device, arr.dtype)
        if key not in bufs:
            bufs[key] = torch.empty(ext.flatten(), dtype=arr.dtype, device=arr.device)
        buf = bufs[key]
        dst = arr[zyx]
        for _ in range(iters):
            pack(arr, rect, buf)  # pack: gather to a flat buffer
            torch.add(buf.view(dst.shape), 1, out=dst)  # unpack
            acc.add_(buf[0])
        return arr, acc

    return fn


def run(x, y, z, radius=3, iters=50, device=None):
    """One row per direction of the 26: its halo rect's bytes (fp32), the
    seconds of one pack + unpack and the GB/s of both (2x the bytes), timed
    after one warm call of the same loop: by CUDA events on the card
    (default: the current CUDA device), by the host clock on the CPU."""
    dev = resolve_device(device)
    r = Radius.constant(radius)
    size = Dim3(x, y, z)
    padded = raw_size(size, r)
    arr = torch.zeros((padded.z, padded.y, padded.x), dtype=torch.float32, device=dev)
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    rows = []
    for d in DIRECTIONS_26:
        rect = halo_rect(d, size, r, halo=True)
        bytes_ = rect.extent().flatten() * 4
        fn = pack_fn(rect, iters)
        arr, acc = fn(arr, acc)  # warm
        hard_sync(dev)
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            arr, acc = fn(arr, acc)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3 / iters
        else:
            t0 = time.perf_counter()
            arr, acc = fn(arr, acc)
            dt = (time.perf_counter() - t0) / iters
        rows.append({
            "dir": (d.x, d.y, d.z),
            "bytes": bytes_,
            "s_per_op": dt,
            "gb_per_s": 2 * bytes_ / dt / 1e9,  # pack + unpack traffic
        })
    return rows


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description="halo pack/unpack primitive benchmark")
    p.add_argument("--x", type=int, default=512)
    p.add_argument("--y", type=int, default=512)
    p.add_argument("--z", type=int, default=512)
    p.add_argument("--radius", type=int, default=3)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device; 'cpu' runs on the host)")
    from ._bench_common import add_metrics_flags, finish_metrics, start_metrics
    add_metrics_flags(p)
    args = p.parse_args(argv)
    rec = start_metrics(args, "bench_pack")
    print("dir,bytes,s/op,GB/s")
    for row in run(args.x, args.y, args.z, radius=args.radius, iters=args.iters,
                   device=args.device):
        d = row["dir"]
        print(f"({d[0]} {d[1]} {d[2]}),{row['bytes']},{row['s_per_op']:e},{row['gb_per_s']:.2f}")
        rec.gauge("bench_pack.gb_per_s", row["gb_per_s"], phase="compute",
                  dir=f"{d[0]},{d[1]},{d[2]}", bytes=row["bytes"])
    finish_metrics(rec)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
