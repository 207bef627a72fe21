"""bench_kernels — time each CUDA kernel of the port alone on one GPU.

  python -m stencil_tpu_torch.apps.bench_kernels --size 512 --ks 2,4,6,8,10

Prints one JSON line per measurement, after a line naming the card
(``nvidia-smi`` name and power limit):

- ``jacobi_sweep``: one step at size^3, radius 1 (the jacobi3d layout);
- ``jacobi_multistep`` at each depth k: ms per launch, ms per step, and the
  resident blocks per SM its shared memory allows;
- ``self_fill`` per axis: one launch filling both sides for four fp32
  quantities at radius 3 (the exchange benchmark's layout).

Times are CUDA-event means over back-to-back launches replayed from a CUDA
graph (device time, no host launch overhead) after a warm-up; inputs are
random, made from ``--seed``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from typing import Optional

import torch

from ..domain import GridSpec
from ..geometry import Dim3, Radius
from ..ops import _native, halo_fill
from ..ops import stencil_kernels as sk
from ..ops.jacobi import sphere_sel
from ..parallel import shard_blocks
from ..utils.timer import cuda_time_ms


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description="time the port's CUDA kernels on one GPU")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--ks", type=str, default="2,4,6,8,10")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    n = args.size
    print(json.dumps({"card": card(), "torch": torch.__version__}), flush=True)

    spec = GridSpec(Dim3(n, n, n), Dim3(1, 1, 1), Radius.constant(1))
    pd = spec.padded()
    curr = torch.rand((1, 1, 1, pd.z, pd.y, pd.x), generator=gen, device=dev)
    nxt = torch.zeros_like(curr)
    sel = shard_blocks(sphere_sel(spec.global_size), spec, dev)
    ms = cuda_time_ms(lambda: sk.sweep(curr, nxt, sel, spec), args.reps, graph=True)
    print(json.dumps({"kernel": "jacobi_sweep", "size": n, "ms": ms}), flush=True)

    lib = _native.lib("jacobi_multistep")
    for k in (int(v) for v in args.ks.split(",")):
        blocks = ctypes.c_int(0)
        _native.check(lib.jacobi_multistep_blocks_per_sm(k, ctypes.byref(blocks)),
                      "jacobi_multistep_blocks_per_sm")
        ms = cuda_time_ms(lambda: sk.multistep(curr, nxt, spec, k), max(2, args.reps // 2),
                          warmup=1, graph=True)
        print(json.dumps({"kernel": "jacobi_multistep", "size": n, "k": k, "ms": ms,
                          "ms_per_step": ms / k, "blocks_per_sm": blocks.value,
                          "smem_bytes": sk.multistep_smem_bytes(k),
                          "zchunks": sk.multistep_zchunks(spec, k)}), flush=True)
    del curr, nxt, sel

    spec3 = GridSpec(Dim3(n, n, n), Dim3(1, 1, 1), Radius.constant(3))
    pd = spec3.padded()
    qs = [torch.rand((1, 1, 1, pd.z, pd.y, pd.x), generator=gen, device=dev) for _ in range(4)]
    for axis in halo_fill.AXIS_ORDER:
        ms = cuda_time_ms(lambda: halo_fill.self_fill(qs, spec3, axis), args.reps * 2,
                          graph=True)
        print(json.dumps({"kernel": "self_fill", "size": n, "radius": 3, "quantities": 4,
                          "axis": axis, "ms": ms,
                          "bytes": 4 * halo_fill.fill_bytes(spec3, axis, 4)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
