"""bench_host — the host's share of the mesh exchange carriers on one GPU.

  python -m stencil_tpu_torch.apps.bench_host --reps 100

At config 2 (256^3 over (2,2,2) mesh positions of one card, radius 2, four
fp32 quantities), prints one JSON line after a line naming the card
(``nvidia-smi`` name and power limit):

- ``host_us remote_axis <axis>`` and ``host_us fused_exchange``: the host's
  microseconds per wrapper call (``ops/remote_dma.remote_axis`` per phase,
  ``ops/fused_stencil.fused_exchange``), from the call's entry to the
  kernel's enqueue, the median of 5 rounds of ``--reps`` back-to-back calls
  (the launches queue on the card, which is not waited for inside a round);
- ``exchange_ms remote_axis`` and ``exchange_ms fused_exchange``: one
  exchange through ``DistributedDomain.exchange_loop`` over 50 exchanges by
  CUDA events, the median of 5 rounds (``exchange_ms_all``: every round).

The carriers' device time per launch is ``bench_kernels``'; the gap between
an exchange and its launches' device time is the host's. Inputs are zero
fields: the host's work does not read them.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Optional

import torch

from ..api import DistributedDomain
from ..ops import fused_stencil as fst
from ..ops import remote_dma as rdma
from ..parallel import DeviceMesh, Method
from . import bench_fill


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description="time the exchange carriers' host work on one GPU")
    p.add_argument("--reps", type=int, default=100)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_host needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    print(json.dumps({"card": bench_fill.card(), "torch": torch.__version__}), flush=True)
    mesh = DeviceMesh((2, 2, 2), [dev] * 8)
    out = {}
    for fused in (False, True):
        name = "fused_exchange" if fused else "remote_axis"
        dd = DistributedDomain(256, 256, 256)
        dd.set_radius(2)
        dd.set_methods(Method.REMOTE_DMA)
        dd.set_devices([dev] * 8)
        dd.set_fused_exchange(fused)
        for i in range(4):
            dd.add_data(f"q{i}", "float32")
        dd.realize()
        st = dd.curr_state()
        groups = [[st[k][i] for k in st] for i in range(len(mesh))]
        plan = dd.halo_exchange.plan
        if fused:
            calls = [(name, lambda: fst.fused_exchange(groups, dd.spec, plan, mesh))]
        else:
            calls = [(f"{name} {ph.axis}", lambda ph=ph: rdma.remote_axis(groups, dd.spec, ph, mesh))
                     for ph in plan.remote_phases if ph.active]
        for label, fn in calls:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            rounds = []
            for _ in range(5):
                t0 = time.perf_counter()
                for _ in range(args.reps):
                    fn()
                rounds.append((time.perf_counter() - t0) / args.reps * 1e6)
                torch.cuda.synchronize()
            out[f"host_us {label}"] = statistics.median(rounds)
        loop = dd.exchange_loop(50)
        loop(dd.curr_state())
        torch.cuda.synchronize()
        rounds = []
        for _ in range(5):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            loop(dd.curr_state())
            b.record()
            b.synchronize()
            rounds.append(a.elapsed_time(b) / 50)
        out[f"exchange_ms {name}"] = statistics.median(rounds)
        out[f"exchange_ms_all {name}"] = rounds
        del dd, st, groups
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
