"""Launch an N-process run of one of the port's apps on one machine.

The port's counterpart of ``scripts/launch_multiprocess.sh`` (the
reference's launch scripts, README.md:131-168): every process runs
``python -m <module> [args]`` with the same environment variables as the
JAX script sets, ``STENCIL_COORDINATOR`` (``localhost:<free port>``),
``STENCIL_NUM_PROCESSES`` and ``STENCIL_PROCESS_ID``, so the app's
``parallel.distributed.maybe_init_from_env()`` joins a gloo group. Each
process gets ``<positions-per-proc>`` block positions: with ``--cpu``, CPU
positions (``STENCIL_LOCAL_CPU_DEVICES``); on the card, positions on its
current CUDA device, ``cuda:0`` (``STENCIL_LOCAL_CUDA_POSITIONS``). On the
card the kernels are built once, before the ranks start, so that they load
one build.

The launcher waits for every rank up to ``--timeout`` seconds. When a rank
fails or the time runs out it kills the others and exits non-zero (the
failing rank's code, or 124 on the time limit).

Usage:
  python -m stencil_tpu_torch.apps.launch_multiprocess [--cpu] [--timeout S] \\
      <nprocs> <positions-per-proc> <module> [args...]
Example (2 processes x 4 positions of the card, jacobi3d by remote-dma):
  python -m stencil_tpu_torch.apps.launch_multiprocess 2 4 stencil_tpu_torch.apps.jacobi3d \\
      --method remote-dma --x 256 --y 256 --z 256 --iters 10
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
from typing import List, Optional

from ..parallel.distributed import (COORDINATOR_ENV, LOCAL_CPU_ENV, LOCAL_CUDA_ENV,
                                    NUM_PROCESSES_ENV, PROCESS_ID_ENV)

TIMEOUT_RC = 124


def free_port() -> int:
    """A TCP port of localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank: int, nprocs: int, positions: int, port: int, cpu: bool) -> dict:
    """The environment of rank ``rank``."""
    env = dict(os.environ)
    env.update({COORDINATOR_ENV: f"localhost:{port}", NUM_PROCESSES_ENV: str(nprocs),
                PROCESS_ID_ENV: str(rank)})
    env.pop(LOCAL_CPU_ENV, None)
    env.pop(LOCAL_CUDA_ENV, None)
    env[LOCAL_CPU_ENV if cpu else LOCAL_CUDA_ENV] = str(positions)
    return env


def launch(nprocs: int, positions: int, module: str, args: List[str], cpu: bool = False,
           timeout: float = 600.0, build: bool = True, stdout=None, stderr=None) -> int:
    """Run ``python -m module args`` as ``nprocs`` ranks of ``positions``
    positions each; returns 0 when every rank exits 0, else the first
    failing rank's code (``TIMEOUT_RC`` on the time limit), after killing
    the ranks still running. ``stdout`` / ``stderr`` go to every rank
    (default: this process's)."""
    if nprocs < 1 or positions < 1:
        raise ValueError(f"need at least one process and position, got {nprocs} x {positions}")
    if build and not cpu:
        from ..ops import _native

        _native.build_all()
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-m", module, *args],
                              env=rank_env(r, nprocs, positions, port, cpu),
                              stdout=stdout, stderr=stderr)
             for r in range(nprocs)]
    deadline = time.monotonic() + timeout
    rc = 0
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                rc = bad[0]
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                rc = TIMEOUT_RC
                print(f"launch_multiprocess: {module} did not finish in {timeout:.0f} s",
                      file=sys.stderr)
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    if rc:
        print(f"launch_multiprocess: {module} failed (rc {rc}); the other ranks were stopped",
              file=sys.stderr)
    return rc


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description="run an app as several processes on one machine")
    p.add_argument("--cpu", action="store_true",
                   help="CPU positions (default: positions on the current CUDA device)")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds the ranks may take before they are killed")
    p.add_argument("nprocs", type=int)
    p.add_argument("positions", type=int, help="block positions a process")
    p.add_argument("module", help="python module to run with -m")
    p.add_argument("args", nargs=argparse.REMAINDER)
    a = p.parse_args(argv)
    return launch(a.nprocs, a.positions, a.module, a.args, cpu=a.cpu, timeout=a.timeout)


if __name__ == "__main__":
    raise SystemExit(main())
