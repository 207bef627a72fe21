"""bench_headline — the port's headline leg: guarded jacobi3d 512^3 on one GPU.

The port's counterpart of the headline leg of the JAX package's
``bench.py`` (``bench.py:113-163``): ``jacobi3d.run(512, 512, 512,
iters=3 * 360, weak=False, warmup=1, chunk=360, health_every=360)`` on one
device, one health check per chunk, the per-step statistic the trimean of
the chunks' means (``utils/statistics``). At k=3 a chunk is 120 multistep
launches and one launch of the health kernel.

With ``STENCIL_BENCH_CKPT_DIR`` set, the leg is durable per chunk: it
checkpoints into ``<dir>/jacobi512`` every chunk, ``--resume`` continues a
killed run from its newest snapshot, and a resume that finds the leg already
complete (nothing left to time) measures it again from a fresh start. A run
whose recovery gives up exits 43 (``FAULT_RC``).

It prints one JSON line:

  {"metric": "jacobi3d_512_mcells_per_s_per_gpu", "value": ..., "unit":
   "Mcells/s", "iter_trimean_s": ..., "loop_wall_s": ..., "health_checks":
   ..., "device": <name>, "power_limit": <nvidia-smi>}

Usage: python -m stencil_tpu_torch.apps.bench_headline [--resume]
(``--device cpu --size 24 --chunk 3`` runs the same leg small on the CPU,
through the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from typing import Optional

from ..fault import FAULT_RC, RecoveryExhausted
from . import jacobi3d


def power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reports it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def run(size: int = 512, chunk: int = 360, resume: bool = False, device=None,
        ckpt_root: Optional[str] = None) -> dict:
    """The headline leg's result row (``jacobi3d.run``'s), 3 chunks of
    ``chunk`` steps at ``size``^3, a health check per chunk; with
    ``ckpt_root``, durable per chunk under ``<ckpt_root>/jacobi<size>``."""
    ckpt_dir = os.path.join(ckpt_root, f"jacobi{size}") if ckpt_root else None
    kw = dict(iters=3 * chunk, weak=False, warmup=1, chunk=chunk, device=device,
              ckpt_dir=ckpt_dir, ckpt_every=chunk if ckpt_dir else 0, health_every=chunk)
    r = jacobi3d.run(size, size, size, resume=resume and ckpt_dir is not None, **kw)
    if ckpt_dir and not math.isfinite(r["iter_trimean_s"]):
        # an earlier run finished the leg (its snapshot is at the last step)
        # but its timings are gone: measure again from a fresh start
        print("bench_headline: the resumed leg was complete; measuring again",
              file=sys.stderr, flush=True)
        r = jacobi3d.run(size, size, size, resume=False, **kw)
    return r


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description="the port's headline leg (guarded jacobi3d)")
    p.add_argument("--resume", action="store_true",
                   help="with STENCIL_BENCH_CKPT_DIR, continue from the newest snapshot")
    p.add_argument("--size", type=int, default=512, help="cube edge (default 512)")
    p.add_argument("--chunk", type=int, default=360, help="steps per chunk (default 360)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the current CUDA device; 'cpu' runs the "
                        "plain PyTorch versions)")
    args = p.parse_args(argv)
    try:
        r = run(args.size, args.chunk, args.resume, args.device,
                os.environ.get("STENCIL_BENCH_CKPT_DIR") or None)
    except RecoveryExhausted as e:
        print(f"bench_headline: the leg faulted beyond recovery: {e}", file=sys.stderr,
              flush=True)
        return FAULT_RC
    print(json.dumps({
        "metric": f"jacobi3d_{args.size}_mcells_per_s_per_gpu",
        "value": r["mcells_per_s_per_dev"], "unit": "Mcells/s",
        "iter_trimean_s": r["iter_trimean_s"], "loop_wall_s": r["loop_wall_s"],
        "health_checks": r["health_checks"], "device": r["device"],
        "power_limit": power_limit() if r["device"] != "cpu" else None,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
