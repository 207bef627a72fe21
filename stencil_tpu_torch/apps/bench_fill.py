"""bench_fill — time the self-fill kernel per axis on one GPU.

  python -m stencil_tpu_torch.apps.bench_fill [--reps 20]

Prints a line naming the card (``nvidia-smi`` name and power limit), then
one JSON line per (case, axis) for three cases: the 512^3 radius-3 exchange
of four fp32 quantities (x, y, z), its (1,1,2) z-stack form (x, y) and
Astaroth's 256^3 radius-3 layout of eight fp64 fields (x, y, z). Each line
holds:

- ``ms``: device ms per launch, CUDA-graph replay of ``--reps`` launches on
  one set of quantities (the halos partly stay in the 50 MB L2);
- ``ms_cold``: the same, alternating two sets of quantities between
  launches, so each launch finds its halos evicted from L2;
- ``copy_ms``: ``Tensor.copy_`` of the same slabs (two per quantity), the
  PyTorch yardstick, replayed like ``ms``;
- ``bound_ms``: the halo bytes (each read once, written once) over the
  memory rate; ``sector_ms``: the 32-byte sectors those bytes lie in, over
  the same rate (for x, the floor of a fill of row ends);
- ``vec``: the words per access that ``halo_fill.fill_layout`` chose.

Then, for each case with an x axis whose rows start on a 32-byte sector,
one ``sector_probe`` line of ``sector_probe.cu``'s probes on a new set of
that case's quantities, each timed like ``ms`` beside the fill's own
``fill_ms`` on the same set, all in turns (fill, probes, probes in reverse,
fill; the mean of each pair): ``read_ms``, the fill's loads alone (every
source word of both row ends, walked as the fill walks them);
``write_ms``, whole-sector stores alone to the 32-byte sectors that hold
its halos; and three other bodies for the same fill, each first held
``torch.equal`` to the kernel's fill: ``row_ms`` (one thread per row),
``smem_ms`` (a tile of rows' end sectors staged through shared memory,
stored back whole) and ``shuffle_ms`` (the same staged through registers
by warp shuffles).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
from typing import Callable, Dict, Optional

import torch

from ..domain import GridSpec
from ..geometry import Dim3, Radius
from ..ops import _native, halo_fill
from ..utils.roofline import bound_ms
from ..utils.timer import cuda_time_ms

# (label, size, partition, radius, quantities, dtype, axes)
CASES = (
    ("512^3 r3 x4 fp32", 512, (1, 1, 1), 3, 4, torch.float32, ("x", "y", "z")),
    ("512^3 (1,1,2) r3 x4 fp32 z-stack", 512, (1, 1, 2), 3, 4, torch.float32, ("x", "y")),
    ("256^3 r3 x8 fp64 (astaroth)", 256, (1, 1, 1), 3, 8, torch.float64, ("x", "y", "z")),
)


def copy_slabs(qs, spec: GridSpec, axis: str) -> None:
    """The fill of ``axis`` by ``Tensor.copy_``: two slab copies per
    quantity, the yardstick one PyTorch call per slab gives."""
    o, n, rm, rp = halo_fill.axis_geom(spec, axis)
    for b in qs:
        b[halo_fill._axis_slice(b, axis, o - rm, o)].copy_(
            b[halo_fill._axis_slice(b, axis, o + n - rm, o + n)])
        b[halo_fill._axis_slice(b, axis, o + n, o + n + rp)].copy_(
            b[halo_fill._axis_slice(b, axis, o, o + rp)])


PROBE_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sector_probe.cu")
PROBES = ("read", "write", "row", "smem", "shuffle")  # sector_probe.cu's modes 0-4


def sector_probes(qs, spec: GridSpec) -> Dict[str, Callable]:
    """Launches of ``sector_probe.cu`` over the x fill of ``qs`` by name
    (see the module note), or none when a row does not start on a 32-byte
    sector."""
    o, n, rm, rp = halo_fill.axis_geom(spec, "x")
    item, px = qs[0].element_size(), spec.padded().x
    if (px * item) % halo_fill.SECTOR_BYTES or any(
            q.data_ptr() % halo_fill.SECTOR_BYTES for q in qs):
        return {}
    fn = _native.build(PROBE_SRC, "sector_probe").sector_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    w, s = item // 4, halo_fill.SECTOR_BYTES // 4  # 4-byte words per element, per sector
    fill = [o * w, n * w, rm * w, rp * w]
    sources = [(o + n - rm) * w, rm * w, o * w, rp * w]
    sectors = []
    for lo, hi in ((o - rm, o + rp), (o + n - rm, o + n + rp)):
        a, b = lo * w // s * s, -(-hi * w // s) * s
        sectors += [a, b - a]
    dev = qs[0].device
    sink = torch.zeros(1, dtype=torch.int32, device=dev)

    def probe(mode, spans):
        def run(blocks=qs):
            rc = fn((ctypes.c_void_p * len(blocks))(*[q.data_ptr() for q in blocks]),
                    len(blocks), blocks[0].numel() // px, px * w,
                    (ctypes.c_longlong * 8)(*spans, *fill), mode, sink.data_ptr(),
                    _native.stream_ptr(dev))
            _native.check(rc, f"sector_probe {PROBES[mode]}")
        return run

    return {name: probe(mode, sources if name == "read" else sectors)
            for mode, name in enumerate(PROBES)}


def case_spec(size: int, partition, radius: int) -> GridSpec:
    return GridSpec(Dim3(size, size, size), Dim3(*partition), Radius.constant(radius))


def quantities(spec: GridSpec, nq: int, dtype, gen, dev):
    """``nq`` random quantities, each a contiguous stack of the spec's
    resident blocks (a z-stack when the partition is (1,1,c))."""
    p = spec.padded()
    return [torch.rand((spec.num_blocks(), p.z, p.y, p.x), generator=gen, device=dev,
                       dtype=dtype) for _ in range(nq)]


def measure(label: str, spec: GridSpec, nq: int, dtype, axes, gen, dev, reps: int = 20):
    """One dict per axis of ``spec`` (see the module note), over two sets
    of ``nq`` :func:`quantities`."""
    zs = spec.num_blocks()
    sets = [quantities(spec, nq, dtype, gen, dev) for _ in range(2)]
    item = sets[0][0].element_size()
    rows = []
    for axis in axes:
        turn = [0]

        def alternate():
            halo_fill.self_fill(sets[turn[0] % 2], spec, axis, z_stack=zs)
            turn[0] += 1

        lay = halo_fill.fill_layout(spec, axis, item, zs)
        nbytes = nq * zs * halo_fill.fill_bytes(spec, axis, item)
        rows.append({
            "kernel": "self_fill", "case": label, "axis": axis, "z_stack": zs, "vec": lay.vec,
            "bytes": nbytes, "bound_ms": bound_ms(nbytes, 0)[0],
            "sector_ms": bound_ms(nq * halo_fill.fill_sector_bytes(lay, item), 0)[0],
            "copy_ms": cuda_time_ms(lambda: copy_slabs(sets[0], spec, axis), reps, graph=True),
            "ms": cuda_time_ms(lambda: halo_fill.self_fill(sets[0], spec, axis, z_stack=zs),
                               reps, graph=True),
            "ms_cold": cuda_time_ms(alternate, reps, graph=True)})
    del sets
    torch.cuda.empty_cache()
    return rows


def probe_x(label: str, spec: GridSpec, nq: int, dtype, gen, dev, reps: int = 20):
    """The ``sector_probe`` dict of one case (see the module note), or None
    when its rows do not start on a sector. Raises if a probe's fill
    differs from the kernel's."""
    zs = spec.num_blocks()
    qs = quantities(spec, nq, dtype, gen, dev)
    probes = sector_probes(qs, spec)
    if not probes:
        return None
    want = halo_fill.self_fill([q.clone() for q in qs], spec, "x", z_stack=zs)
    for name in ("row", "smem", "shuffle"):
        got = [q.clone() for q in qs]
        probes[name](got)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError(f"sector_probe {name} on {label}: fill != self_fill")
    runs = {"fill": lambda: halo_fill.self_fill(qs, spec, "x", z_stack=zs), **probes}
    times = {}
    for name in list(runs) + list(runs)[::-1]:  # in turns, each way once
        times.setdefault(name, []).append(cuda_time_ms(runs[name], reps, graph=True))
    row = {"kernel": "sector_probe", "case": label, "axis": "x",
           **{f"{name}_ms": sum(t) / len(t) for name, t in times.items()}}
    del qs, want, got
    torch.cuda.empty_cache()
    return row


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description="time the self-fill kernel per axis on one GPU")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_fill needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    print(json.dumps({"card": card(), "torch": torch.__version__}), flush=True)
    for label, size, part, r, nq, dtype, axes in CASES:
        spec = case_spec(size, part, r)
        for row in measure(label, spec, nq, dtype, axes, gen, dev, args.reps):
            print(json.dumps(row), flush=True)
        row = probe_x(label, spec, nq, dtype, gen, dev, args.reps) if "x" in axes else None
        if row is not None:
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
