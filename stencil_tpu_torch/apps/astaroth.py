"""astaroth — the MHD mini-app on one GPU.

The port's counterpart of ``stencil_tpu.apps.astaroth`` (reference:
astaroth/astaroth.cu): 8 fields in double precision (the reference's type;
``--f32`` for single), radius-3 halos, per iteration one exchange and 3 RK3
substeps, buffers swapped per iteration, dt = 1e-8. Init: hash-random
everything, constant 0.5 lnrho, radial-explosion velocity
(astaroth.cu:493-520). Output row as in the reference (astaroth.cu:672-679):

  <devices>,<nx>,<ny>,<nz>,<iter trimean s>,<exch trimean s>

The schedule is the JAX app's: one untimed warm-up chunk that advances the
state, then chunks of ``chunk`` iterations (``iters`` rounded up to a chunk
multiple), each timed on the host clock up to a device synchronize. The
exchange share is timed as the JAX app times its fused path: a standalone
``exchange_loop(1)`` after every chunk (one exchange per iteration; 3 with
``swap_per_substep``), which leaves exchanged fields unchanged.

Usage: python -m stencil_tpu_torch.apps.astaroth 10 [--nx 256] [--f32]
(``--device cpu --nx 16`` runs the plain PyTorch versions on the CPU).

Not carried over yet (ROADMAP.md queue A): the multi-device decomposition,
boundary conditions other than periodic, checkpoints, health checks, fault
injection, autotuning, the kernel-variant flag and the ParaView dumps.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch

from ..api import DistributedDomain
from ..astaroth.config import load_config
from ..astaroth.init import const_init, hash_init, radial_explosion_init
from ..astaroth.integrate import FIELDS, make_astaroth_step
from ..astaroth.reductions import Reductions
from ..geometry import Dim3, prime_factors
from ..utils import logging as log
from ..utils import timer
from ..utils.statistics import Statistics
from ..utils.sync import hard_sync

DEFAULT_CONF = os.path.join(os.path.dirname(__file__), "..", "astaroth", "astaroth.conf")


def decompose_zyx(p: int) -> Dim3:
    """Split device count over axes, z first (reference: astaroth.cu:263-276)."""
    x = y = z = 1
    for pf in prime_factors(p):
        if z <= y and z <= x:
            z *= pf
        elif y <= x:
            y *= pf
        else:
            x *= pf
    return Dim3(x, y, z)


def init_fields(dd: DistributedDomain, handles: dict, info, dtype: str) -> None:
    """The reference init (astaroth.cu:493-520) into the domain's curr
    tensors: hash-random entropy and vector potential, constant 0.5 lnrho,
    radial-explosion velocity."""
    size = dd.size
    np_dtype = np.dtype(dtype)
    ds = (info.real_params["AC_dsx"], info.real_params["AC_dsy"],
          info.real_params["AC_dsz"])
    h = hash_init(size, dtype=np_dtype)  # coordinate-determined, same per field
    for name in ("entropy", "ax", "ay", "az"):
        dd.set_curr_global(handles[name], h)
    dd.set_curr_global(handles["lnrho"], const_init(size, 0.5, dtype=np_dtype))
    uux, uuy, uuz = radial_explosion_init(size, ds=ds, dtype=np_dtype)
    dd.set_curr_global(handles["uux"], uux)
    dd.set_curr_global(handles["uuy"], uuy)
    dd.set_curr_global(handles["uuz"], uuz)


def make_domain(info, dtype: str = "float64", device=None):
    """A realized one-GPU domain of the config's size with the 8 fields at
    radius 3, initialised as the reference does; returns ``(dd, handles)``."""
    d3 = decompose_zyx(1)
    size = Dim3(info.int_params["AC_nx"] * d3.x, info.int_params["AC_ny"] * d3.y,
                info.int_params["AC_nz"] * d3.z)
    dd = DistributedDomain(size.x, size.y, size.z, device=device)
    dd.set_radius(3)
    handles = {name: dd.add_data(name, dtype) for name in FIELDS}
    dd.realize()
    init_fields(dd, handles, info, dtype)
    return dd, handles


def load(conf: str = DEFAULT_CONF, nx: Optional[int] = None):
    """The config, with ``nx`` (when given) overriding AC_n{x,y,z}."""
    info, ok = load_config(conf)
    if not ok:
        log.debug(f"config has uninitialized values: {info.uninitialized()[:5]}")
    if nx is not None:
        info.int_params["AC_nx"] = info.int_params["AC_ny"] = info.int_params["AC_nz"] = nx
        info.update_builtin_params()
    return info


def run(
    iters: int = 10,
    conf: str = DEFAULT_CONF,
    nx: Optional[int] = None,
    dtype: str = "float64",
    no_compute: bool = False,
    overlap: bool = True,
    swap_per_substep: bool = False,
    reductions: bool = False,
    dt: float = 1e-8,
    chunk: int = 1,
    device=None,
) -> dict:
    """Run ``iters`` iterations (plus one untimed warm-up chunk) on one
    device and return the timing row, the domain and its handles."""
    info = load(conf, nx)
    dd, handles = make_domain(info, dtype, device)
    dev = dd.device
    curr = {name: dd.get_curr(handles[name]) for name in FIELDS}
    nxt = {name: dd.get_next(handles[name]) for name in FIELDS}

    iter_time = Statistics()
    exch_time = Statistics()
    if no_compute:
        # pure exchange, 3 per iteration (reference --no-compute flag)
        loop = dd.halo_exchange.make_loop(3)
        curr = loop(curr)
        hard_sync(dev)
        for _ in range(iters):
            t0 = time.perf_counter()
            curr = loop(curr)
            hard_sync(dev)
            dt_iter = time.perf_counter() - t0
            iter_time.insert(dt_iter)
            exch_time.insert(dt_iter)
    else:
        chunk = max(1, min(chunk, iters))
        step = make_astaroth_step(dd.halo_exchange, info, dt=dt, overlap=overlap,
                                  swap_per_substep=swap_per_substep, iters=chunk,
                                  dtype=dtype)
        with timer.timed("astaroth.warmup"):
            curr, nxt = step(curr, nxt)
            hard_sync(dev)
        exch_loop = dd.halo_exchange.make_loop(3 if swap_per_substep else 1)
        done = 0
        while done < iters:
            t0 = time.perf_counter()
            with timer.trace_range("astaroth.chunk"):
                curr, nxt = step(curr, nxt)
                hard_sync(dev)
            per = (time.perf_counter() - t0) / chunk
            for _ in range(chunk):
                iter_time.insert(per)
            done += chunk
            t0 = time.perf_counter()
            with timer.trace_range("astaroth.exchange"):
                curr = exch_loop(curr)
                hard_sync(dev)
            exch_time.insert(time.perf_counter() - t0)

    for name in FIELDS:
        dd.set_curr(handles[name], curr[name])
        dd.set_next(handles[name], nxt[name])

    trimean = iter_time.trimean()
    cells = dd.size.flatten()
    result = {
        "processes": 1,
        "devices": 1,
        "nx": info.int_params["AC_nx"],
        "ny": info.int_params["AC_ny"],
        "nz": info.int_params["AC_nz"],
        "global": dd.size,
        "dtype": dtype,
        "iter_trimean_s": trimean,
        "exch_trimean_s": exch_time.trimean(),
        "iters_run": iter_time.count(),
        "mcells_per_s": cells / trimean / 1e6,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "domain": dd,
        "handles": handles,
        "info": info,
    }
    if reductions:
        red = Reductions(dd.halo_exchange)
        result["reductions"] = {
            "lnrho": red.scal(dd.get_curr(handles["lnrho"])),
            "uu": red.vec(dd.get_curr(handles["uux"]), dd.get_curr(handles["uuy"]),
                          dd.get_curr(handles["uuz"])),
        }
    return result


def csv_row(r: dict) -> str:
    return (
        f"{r['devices']},{r['nx']},{r['ny']},{r['nz']},"
        f"{r['iter_trimean_s']:e},{r['exch_trimean_s']:e}"
    )


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description="Astaroth MHD mini-app (one GPU)")
    p.add_argument("iters", type=int, nargs="?", default=10)
    p.add_argument("--conf", default=DEFAULT_CONF)
    p.add_argument("--nx", type=int, default=None, help="override AC_n{x,y,z}")
    p.add_argument("--f32", action="store_true", help="float32 fields")
    p.add_argument("--f64", action="store_true",
                   help="float64 fields (the default; the reference's type)")
    p.add_argument("--reductions", action="store_true", help="print field reductions")
    p.add_argument("--no-compute", action="store_true", help="time the exchange alone")
    p.add_argument("--no-overlap", action="store_true",
                   help="disable interior/exterior overlap (no effect on one block)")
    p.add_argument("--chunk", type=int, default=1,
                   help="iterations per timed chunk (a final partial chunk "
                        "still runs a full chunk)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the current CUDA device; "
                        "'cpu' runs the plain PyTorch versions)")
    args = p.parse_args(argv)
    if args.f32 and args.f64:
        p.error("--f32 and --f64 exclude each other")
    r = run(iters=args.iters, conf=args.conf, nx=args.nx,
            dtype="float32" if args.f32 else "float64", no_compute=args.no_compute,
            overlap=not args.no_overlap, reductions=args.reductions,
            chunk=args.chunk, device=args.device)
    print(csv_row(r))
    log.info(f"{r['dtype']} on {r['device']}: {r['iter_trimean_s'] * 1e3:.4f} ms/iter, "
             f"{r['mcells_per_s']:.1f} Mcells/s")
    log.info(timer.report())
    for k, v in r.get("reductions", {}).items():
        log.info(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
