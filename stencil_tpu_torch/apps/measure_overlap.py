"""measure_overlap -- does the overlapped step actually hide the exchange?

The port's counterpart of ``stencil_tpu.apps.measure_overlap`` (reference:
bin/measure_buf_exchange.cu:10-19, which timed a spin kernel concurrent
with peer copies). Four timed variants of the same jacobi workload on the
same domain:

- ``compute``:  the full sweep, no exchange at all (the compute floor)
- ``exchange``: the exchange only (the communication cost)
- ``serial``:   exchange, then the full sweep (``make_jacobi_loop(...,
                overlap=False)``)
- ``overlap``:  the overlapped step (``overlap=True``: on a multi-block
                partition the sweep of pre-exchange data, the exchange, then
                the shells re-swept from the exchanged halos)

Reported: ``hidden = t_serial - t_overlap`` (the exchange time the
overlapped structure recovers) and ``hidden_frac = hidden / t_exchange``
(1.0 = the exchange fully hidden; <= 0 = the structure hides nothing).
Each variant is timed as the JAX tool times it: the host clock around
whole chunks of ``iters`` steps, after one warm chunk, the device
synchronized at both ends.

Where it runs. With ``devices`` of several entries (a mesh of positions,
which may name one card several times) the port exchanges by REMOTE_DMA,
the only method it runs on a mesh, where the JAX run uses its default
method over its devices; REMOTE_DMA's loop is exchange-then-sweep either
way, so there ``serial`` and ``overlap`` time the same schedule. With one
device (default: the current CUDA device) the domain is one block, as in
the JAX tool. The port runs the exchange and the sweeps on one stream, so
nothing runs concurrently with the exchange: expect ``hidden_frac`` <= 0.
The JAX ``--pallas`` flag is not ported: the device decides (the card
runs the hand-written kernels, the CPU their plain versions), as for the
campaign app's ``--use-pallas``. ``--trace DIR`` records one overlapped
chunk through ``obs/xprof.capture`` (a ``torch.profiler`` capture; on a
machine with no CUDA device nothing is written); read its device seconds
with ``obs/xprof.range_seconds(DIR)``.

CSV: devices,x,y,z,radius,iters,compute_s,exchange_s,serial_s,overlap_s,
hidden_s,hidden_frac

Usage: python -m stencil_tpu_torch.apps.measure_overlap --cpu 8 --x 64
       python -m stencil_tpu_torch.apps.measure_overlap --devices cuda:0,cuda:0 --x 256 --no-weak
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

from ..api import DistributedDomain
from ..geometry import Dim3
from ..ops.jacobi import INIT_TEMP, _sel_ranges, _sweep_step, make_jacobi_loop, sphere_sel_blocks
from ..parallel.exchange import Method
from ..utils import logging as log
from ..utils import timer
from ..utils.statistics import Statistics
from ..utils.sync import hard_sync
from .jacobi3d import weak_scale


def _compute_only_loop(dd: DistributedDomain, iters: int, sel):
    """The full-region sweep with NO exchange (the compute floor): each
    step sweeps every block's compute region reading its halos as they
    stand."""
    step = _sweep_step(dd.halo_exchange, _sel_ranges(dd.halo_exchange, True))

    def many(curr, nxt):
        for _ in range(iters):
            curr, nxt = step(curr, nxt, sel), curr
        return curr, nxt

    return many


def _time(fn, state, rounds: int, bucket: str, dev):
    state = fn(*state) if isinstance(state, tuple) else fn(state)
    hard_sync(dev)
    st = Statistics()
    for _ in range(rounds):
        t0 = time.perf_counter()
        with timer.timed(bucket):
            state = fn(*state) if isinstance(state, tuple) else fn(state)
            hard_sync(dev)
        st.insert(time.perf_counter() - t0)
    return st.trimean(), state


def run(
    x: int = 64,
    y: int = 64,
    z: int = 64,
    radius: int = 1,
    iters: int = 10,
    rounds: int = 3,
    devices=None,
    weak: bool = True,
    trace_dir: str = "",
) -> dict:
    """The four variants on ``devices`` (a list: one device, or the
    positions of a mesh; default the current CUDA device), the domain grown
    by their number when ``weak``. Returns the row (and the ``domain``)."""
    from ..obs import xprof

    devices = list(devices) if devices is not None else [None]
    n = len(devices)
    size = weak_scale(x, y, z, n) if weak else Dim3(x, y, z)

    dd = DistributedDomain(size.x, size.y, size.z, device=devices[0])
    dd.set_radius(radius)
    if n > 1:
        dd.set_devices(devices)
        dd.set_methods(Method.REMOTE_DMA)
    h = dd.add_data("temperature", "float32")
    dd.realize()
    dev = dd.device
    curr, nxt = dd.get_curr(h), dd.get_next(h)
    for b in (curr if isinstance(curr, list) else [curr]):
        b.fill_(INIT_TEMP)
    sel = sphere_sel_blocks(dd.spec, dd.mesh or dev)

    ex = dd.halo_exchange
    t_comp, (curr, nxt) = _time(
        _compute_only_loop(dd, iters, sel), (curr, nxt), rounds, "overlap.compute", dev)
    t_exch, state = _time(ex.make_loop(iters), {0: curr}, rounds, "overlap.exchange", dev)
    curr = state[0]
    serial_fn = make_jacobi_loop(ex, iters, overlap=False)
    t_serial, (curr, nxt) = _time(
        lambda c, x_: serial_fn(c, x_, sel), (curr, nxt), rounds, "overlap.serial", dev)
    overlap_fn = make_jacobi_loop(ex, iters, overlap=True)
    t_overlap, (curr, nxt) = _time(
        lambda c, x_: overlap_fn(c, x_, sel), (curr, nxt), rounds, "overlap.overlap", dev)

    if trace_dir:
        with xprof.capture(trace_dir) as tracing:
            with timer.trace_range("overlap.overlap"):
                curr, nxt = overlap_fn(curr, nxt, sel)
                hard_sync(dev)
        if tracing:
            log.info(f"profiler trace written under {trace_dir}")
        else:
            log.warn(f"--trace {trace_dir}: no CUDA profiler on this machine; nothing written")
    dd.set_curr(h, curr)
    dd.set_next(h, nxt)

    hidden = t_serial - t_overlap
    hidden_frac = hidden / t_exch if t_exch > 0 else 0.0
    return {
        "devices": n,
        "x": size.x,
        "y": size.y,
        "z": size.z,
        "radius": radius,
        "iters": iters,
        "compute_s": t_comp,
        "exchange_s": t_exch,
        "serial_s": t_serial,
        "overlap_s": t_overlap,
        "hidden_s": hidden,
        "hidden_frac": hidden_frac,
        "domain": dd,
    }


def csv_row(r: dict) -> str:
    return (
        f"measure_overlap,{r['devices']},{r['x']},{r['y']},{r['z']},{r['radius']},"
        f"{r['iters']},{r['compute_s']:.6f},{r['exchange_s']:.6f},"
        f"{r['serial_s']:.6f},{r['overlap_s']:.6f},{r['hidden_s']:.6f},"
        f"{r['hidden_frac']:.3f}"
    )


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description="comm/compute overlap measurement")
    p.add_argument("--x", type=int, default=64)
    p.add_argument("--y", type=int, default=64)
    p.add_argument("--z", type=int, default=64)
    p.add_argument("--radius", type=int, default=1)
    p.add_argument("--iters", type=int, default=10, help="iterations per timed chunk")
    p.add_argument("--rounds", type=int, default=3, help="timed chunks per variant")
    p.add_argument("--no-weak", action="store_true")
    p.add_argument("--trace", type=str, default="",
                   help="write a torch.profiler trace of one overlapped chunk here")
    p.add_argument("--cpu", type=int, default=0,
                   help="run on N CPU positions (1: one CPU device)")
    p.add_argument("--devices", type=str, default=None,
                   help="comma list of torch devices, one block position each, repeats "
                        "allowed (e.g. cuda:0,cuda:0), as jacobi3d's --devices")
    from ._bench_common import add_metrics_flags, finish_metrics, start_metrics
    add_metrics_flags(p)
    args = p.parse_args(argv)
    if args.cpu and args.devices:
        p.error("pass --cpu or --devices, not both")
    devices = ["cpu"] * args.cpu if args.cpu else (
        args.devices.split(",") if args.devices else None)
    rec = start_metrics(args, "measure_overlap")
    r = run(
        args.x, args.y, args.z,
        radius=args.radius,
        iters=args.iters,
        rounds=args.rounds,
        devices=devices,
        weak=not args.no_weak,
        trace_dir=args.trace,
    )
    print(csv_row(r))
    log.info(
        f"exchange {r['exchange_s']*1e3:.2f} ms/chunk, hidden "
        f"{r['hidden_s']*1e3:.2f} ms ({r['hidden_frac']*100:.0f}% of exchange)"
    )
    log.info(timer.report())
    for key in ("compute_s", "exchange_s", "serial_s", "overlap_s", "hidden_s"):
        rec.gauge(f"overlap.{key}", r[key], phase="step", unit="s")
    rec.gauge("overlap.hidden_frac", r["hidden_frac"], phase="step")
    finish_metrics(rec)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
