"""bench-exchange -- radius-shape sweep + method ablation of the halo exchange.

The port's counterpart of ``stencil_tpu.apps.bench_exchange`` (reference:
bin/bench_exchange.cu): five radius shapes (+x-leaning, x-only, faces-only,
face+edge, uniform) at a fixed per-run extent, reporting trimean seconds
and aggregate B/s, with the JAX app's rows and CSV.

``compare_methods``/``ablate`` row out the exchange strategies on the
uniform shape, in the JAX harness's order: composed full-extent slabs,
exact-extent per-direction messages (direct26), ``auto-spmd`` and
kernel-initiated copies (remote-dma). Where the port runs them:

- over a partition resident on one device (:data:`RESIDENT_PARTITION`,
  (2, 2, 2), where the JAX harness spreads the same blocks
  over its 8 devices) axis-composed, direct26 and remote-dma all run;
- over a mesh of positions (``devices=`` of several entries) only
  remote-dma runs; every other method is reported with the JAX harness's
  own ``# skipping <method>: <reason>`` line;
- auto-spmd (the SPMD partitioner's exchange) is always skipped:
  ROADMAP.md queue A item 5.

The JAX ``ablate`` fills its census columns (``cp_count``, ``cp_bytes``,
``other_collectives``) from the compiled HLO. The port has no HLO, so the
columns come from the port's plan IR for the plan the JAX run executes,
one block a position (:func:`census_columns`): the collectives an exchange
issues (``ExchangePlan.collectives_per_exchange``) and, for a collective
method, their bytes (``ExchangePlan.wire_bytes``); remote-dma moves its
bytes by kernel copies that no census sees (0, 0), and nothing else is
ever issued (0). ``--ablate`` asserts every method that ran produces
bit-identical halos. ``wire_ab``'s byte columns read the executed plan's
``wire_bytes`` likewise, and ``wire_gate`` reads each wire format's bytes
and mantissa bits from ``ops/halo_fill.WIRE_FORMATS``.

Entry points run on the current CUDA device unless given CPU positions
(``--cpu N``: N positions on the CPU, the counterpart of the JAX app's N
virtual CPU devices; ``--cpu 1`` is one CPU device). ``--virtual-hosts``
needs positions on distinct hosts and raises (ROADMAP.md queue A item 5).

Usage: python -m stencil_tpu_torch.apps.bench_exchange --x 256 --y 256 --z 256 --iters 30
       python -m stencil_tpu_torch.apps.bench_exchange --ablate
       python -m stencil_tpu_torch.apps.bench_exchange --cpu 8 --method remote-dma --x 32 --y 32 --z 32
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from ..geometry import Dim3, Radius
from ..obs import telemetry
from ..parallel.exchange import Method, join_positions
from ._bench_common import add_metrics_flags, coord_state, start_metrics, time_exchange

# ablation order (the JAX harness's): manual composed, manual direct,
# partitioner-synthesized, kernel-initiated
ABLATE_ORDER = ("axis-composed", "direct26", "auto-spmd", "remote-dma")
ABLATE_METHODS = (Method.AXIS_COMPOSED, Method.DIRECT26, Method.REMOTE_DMA)
NOT_PORTED = {
    "auto-spmd": "the SPMD partitioner's exchange is not ported (ROADMAP.md queue A item 5)",
}

# the ablation's partition on one device: the JAX harness's 8 devices' blocks
RESIDENT_PARTITION = (2, 2, 2)


def sweep_radii(face: int = 2, edge: int = 1):
    """The five shapes of the reference sweep (bin/bench_exchange.cu:126-195)."""
    px = Radius.constant(0)
    px.set_dir((1, 0, 0), face)

    x_only = Radius.constant(0)
    x_only.set_dir((1, 0, 0), face)
    x_only.set_dir((-1, 0, 0), face)

    faces = Radius.constant(0)
    faces.set_face(face)

    face_edge = Radius.constant(face)
    face_edge.set_corner(edge)

    uniform = Radius.constant(2)
    return [
        (f"px/{face}", px),
        (f"x/{face}", x_only),
        (f"faces/{face}", faces),
        (f"face&edge/{face}/{edge}", face_edge),
        ("uniform/2", uniform),
    ]


def run(x, y, z, iters=30, quantities=4, devices=None, method=Method.AXIS_COMPOSED,
        chunk=10, wire_dtype=None):
    """The radius sweep: one row per shape of :func:`sweep_radii`."""
    rows = []
    for name, radius in sweep_radii():
        r = time_exchange(
            Dim3(x, y, z), radius, iters, method=method, devices=devices,
            quantities=quantities, chunk=chunk, wire_dtype=wire_dtype,
        )
        rows.append({
            "config": f"{x}-{y}-{z}/{name}",
            "bytes": r["bytes_logical"],
            "trimean_s": r["trimean_s"],
            "bytes_per_s": r["bytes_logical"] / r["trimean_s"],
        })
    return rows


def _one_device(devices) -> bool:
    return devices is None or len(list(devices)) == 1


def compare_methods(x, y, z, iters=30, quantities=4, devices=None, radius=2,
                    methods=ABLATE_ORDER):
    """The exchange strategies at a uniform radius, in ``methods`` order
    (names or :class:`Method`), over :data:`RESIDENT_PARTITION` on one
    device or over the mesh of ``devices``; a method the port does not run
    there is reported as skipped."""
    rows = []
    for m in methods:
        name = getattr(m, "value", m)
        if name in NOT_PORTED:
            print(f"# skipping {name}: {NOT_PORTED[name]}")
            continue
        try:
            r = time_exchange(
                Dim3(x, y, z), Radius.constant(radius), iters, method=Method(name),
                devices=devices, quantities=quantities,
                partition=RESIDENT_PARTITION if _one_device(devices) else None,
            )
        except (ValueError, NotImplementedError) as e:
            # a method constraint (block size < radius, a method the port
            # does not run on a mesh) reports the skip instead of crashing
            print(f"# skipping {name}: {e}")
            continue
        rows.append({
            "config": f"{x}-{y}-{z}/method={name}",
            "bytes": r["bytes_logical"],
            "trimean_s": r["trimean_s"],
            "bytes_per_s": r["bytes_logical"] / r["trimean_s"],
            "domain": r["domain"],
        })
    return rows


def census_columns(dd, quantities: int, itemsize: int = 4):
    """``(cp_count, cp_bytes, other_collectives)`` of one exchange of
    ``dd``'s method, batching and wire, from the plan IR of the run the JAX
    harness compiles: the same partition with one block a position."""
    from ..plan.ir import build_plan

    ex = dd.halo_exchange
    plan = build_plan(dd.spec, dd.spec.dim, ex.method, batch_quantities=ex.batch_quantities,
                      wire_dtype=ex.wire_dtype)
    count = plan.collectives_per_exchange(quantities, 1)
    nbytes = 0 if ex.method == Method.REMOTE_DMA else plan.wire_bytes([itemsize] * quantities)
    return count, nbytes, 0


def ablate(x, y, z, iters=30, quantities=4, devices=None, radius=2):
    """Run the methods back to back at a uniform radius: wall-clock, the
    census columns (:func:`census_columns`) and a bit-for-bit agreement
    check of one exchange on coordinate fields.

    Returns ``(rows, agree)``; each row carries ``cp_count``/``cp_bytes``
    and ``other_collectives``. Bitwise agreement across all methods is only
    guaranteed at a uniform radius: under anisotropic gating DIRECT26 skips
    inactive directions that the composed full-extent slabs incidentally
    fill."""
    rows = compare_methods(x, y, z, iters=iters, quantities=quantities, devices=devices,
                           radius=radius)
    rec = telemetry.get()
    outs = {}
    for row in rows:
        dd = row.pop("domain")
        ex = dd.halo_exchange
        state = coord_state(dd, quantities)
        row["cp_count"], row["cp_bytes"], row["other_collectives"] = census_columns(
            dd, quantities)
        out = ex(state)
        outs[row["config"]] = np.stack([_host(out[i], dd.spec) for i in sorted(out)])
    vals = list(outs.values())
    agree = all(np.array_equal(vals[0], v) for v in vals[1:])
    if rec.enabled:
        rec.gauge("ablate.bit_for_bit_agreement", int(agree), phase="verify")
    return rows, agree


def _host(q, spec) -> np.ndarray:
    """One quantity on the host in the stacked layout: a stacked tensor, or
    a mesh's per-position stacks joined."""
    return (join_positions(q, spec) if isinstance(q, list) else q).cpu().numpy()


def batched_ab(x, y, z, iters=30, quantities=(1, 4, 8), devices=None, radius=2,
               partition=None):
    """Quantity-batching A/B: at each Q, time the batched exchange (one
    packed carrier per same-dtype group) against the per-quantity one on
    the same domain shape, with both plans' census columns and a
    field-for-field bit-parity check of one exchange on coordinate fields.
    On one device ``partition`` defaults to :data:`RESIDENT_PARTITION`.

    Returns ``(rows, q_independent, parity)``: ``q_independent`` is True iff
    the batched collective count is the same at every Q; ``parity`` is
    True iff batched and per-quantity results agree bitwise at every Q."""
    if partition is None and _one_device(devices):
        partition = RESIDENT_PARTITION
    rec = telemetry.get()
    rows = []
    batched_counts = {}
    parity = True
    for q in quantities:
        outs = {}
        for batched in (True, False):
            r = time_exchange(Dim3(x, y, z), Radius.constant(radius), iters, devices=devices,
                              quantities=q, batch_quantities=batched, partition=partition)
            dd = r["domain"]
            state = coord_state(dd, q)
            cp_count, cp_bytes, other = census_columns(dd, q)
            label = "batched" if batched else "per-quantity"
            rows.append({
                "config": f"{x}-{y}-{z}/q={q}/{label}",
                "bytes": r["bytes_logical"],
                "trimean_s": r["trimean_s"],
                "bytes_per_s": r["bytes_logical"] / r["trimean_s"],
                "cp_count": cp_count,
                "cp_bytes": cp_bytes,
                "other_collectives": other,
            })
            if batched:
                batched_counts[q] = cp_count
            out = dd.halo_exchange(state)
            outs[batched] = np.stack([_host(out[i], dd.spec) for i in sorted(out)])
        if not np.array_equal(outs[True], outs[False]):
            parity = False
    q_independent = len(set(batched_counts.values())) == 1
    if rec.enabled:
        rec.gauge("batched_ab.q_independent", int(q_independent), phase="verify")
        rec.gauge("batched_ab.bit_for_bit_agreement", int(parity), phase="verify")
    return rows, q_independent, parity


def wire_gate(wire: str):
    """(byte-ratio threshold, relative error bound) the wire A/B gates one
    format on, derived from the format itself so every tier shares one
    rule: the on-wire byte reduction must reach 95% of the ideal
    fp32-native ratio (bf16 -> 1.9x, the fp8 tier -> 3.8x), and the
    measured max relative error must sit within the format's rounding
    half-ulp, 2^-(mantissa bits incl. implicit) (bf16 -> 2^-8,
    float8_e4m3fn -> 2^-4). The bytes and mantissa bits come from
    ``ops/halo_fill.WIRE_FORMATS``, the port's format table."""
    from ..ops.halo_fill import WIRE_FORMATS, wire_name

    fmt = WIRE_FORMATS[wire_name(wire)]
    ratio_thr = 0.95 * (4.0 / fmt.itemsize)
    rel_bound = 2.0 ** -(fmt.mant + 1)
    return ratio_thr, rel_bound


def wire_ab(x, y, z, iters=30, quantities=4, devices=None, radius=2, wire="bfloat16",
            method=Method.AXIS_COMPOSED, partition=None, fused: bool = False):
    """Wire-compression A/B: the same exchange with native carriers vs
    ``wire``-narrowed ones, reporting the on-wire byte reduction and the
    measured error the narrowing pays for it. ``fused`` A/Bs the fused
    exchange carrier instead (REMOTE_DMA only). A wire narrows only what
    crosses between positions, so the A/B means something over a mesh of
    positions (``devices=``), where the port exchanges by REMOTE_DMA.

    Narrow-range formats (float8_e4m3fn tops out at 448 and maps overflow to
    NaN) get the coordinate fixture scaled into their finite range first.

    Bytes are the executed plan's ``wire_bytes`` (the cells crossing
    between positions at the wire's width); ``cp_count`` is the plan's
    collectives (0 for REMOTE_DMA). Error gauges (vs the full-precision
    leg, on coordinate fields): ``wire_ab.max_abs_err``,
    ``wire_ab.max_rel_err`` and ``wire_ab.max_ulp_err`` (float32 ULPs
    between the two results). Returns ``(rows, bytes_ratio, err)``."""
    from ..ops.halo_fill import WIRE_FORMATS, wire_name

    if getattr(method, "value", method) == "auto-spmd":
        raise ValueError(
            "--wire-ab has no meaning for auto-spmd: the partitioner owns "
            "the schedule and packs no carriers to compress"
        )
    rec = telemetry.get()
    rows = []
    outs = {}
    wire_bytes = {}
    # narrow-range formats: scale the coordinate fixture so no halo value
    # exceeds the format's finite range (overflow is NaN there)
    peak = (z - 1) * 1e6 + (y - 1) * 1e3 + (x - 1) + quantities
    fin_max = float(WIRE_FORMATS[wire_name(wire)].top)
    scale = min(1.0, fin_max / (2.0 * peak))
    for wd in (None, wire):
        r = time_exchange(Dim3(x, y, z), Radius.constant(radius), iters, method=method,
                          devices=devices, quantities=quantities, wire_dtype=wd,
                          partition=partition, fused=fused)
        dd = r["domain"]
        ex = dd.halo_exchange
        state = coord_state(dd, quantities)
        if scale < 1.0:
            state = {k: ([b * torch.tensor(scale, dtype=b.dtype) for b in v]
                         if isinstance(v, list) else v * torch.tensor(scale, dtype=v.dtype))
                     for k, v in state.items()}
        wire_bytes[wd] = ex.plan.wire_bytes([4] * quantities)
        cp = (ex.plan.collectives_per_exchange(quantities, 1), wire_bytes[wd])
        label = f"wire={wd or 'native'}"
        rows.append({
            "config": f"{x}-{y}-{z}/q={quantities}/{label}",
            "bytes": r["bytes_logical"],
            "trimean_s": r["trimean_s"],
            "bytes_per_s": r["bytes_logical"] / r["trimean_s"],
            "cp_count": cp[0],
            "cp_bytes": cp[1],
            "other_collectives": 0,
        })
        out = ex(state)
        outs[wd] = np.stack([_host(out[i], dd.spec) for i in sorted(out)])
    ratio = wire_bytes[None] / wire_bytes[wire] if wire_bytes[wire] else 0.0
    a, b = outs[None].astype(np.float32), outs[wire].astype(np.float32)
    abs_err = float(np.max(np.abs(a - b)))
    rel_err = float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1.0)))
    # ULP distance in float32: adjacent-representable steps between the two
    # results (monotone int reinterpretation; same-sign values here)
    ai = a.view(np.int32).astype(np.int64)
    bi = b.view(np.int32).astype(np.int64)
    ulp_err = float(np.max(np.abs(ai - bi)))
    err = {"max_abs_err": abs_err, "max_rel_err": rel_err, "max_ulp_err": ulp_err}
    if rec.enabled:
        rec.gauge("wire_ab.bytes_ratio", ratio, phase="verify", wire=wire)
        rec.gauge("wire_ab.max_abs_err", abs_err, phase="verify", wire=wire)
        rec.gauge("wire_ab.max_rel_err", rel_err, phase="verify", wire=wire)
        rec.gauge("wire_ab.max_ulp_err", ulp_err, phase="verify", wire=wire)
    return rows, ratio, err


def report_header() -> str:
    return "config,bytes,trimean (s),B/s"


def report_row(row: dict) -> str:
    return f"{row['config']},{row['bytes']},{row['trimean_s']:e},{row['bytes_per_s']:e}"


def ablate_header() -> str:
    return "config,bytes,trimean (s),B/s,collective-permutes,cp bytes,other collectives"


def ablate_row(row: dict) -> str:
    return (
        f"{report_row(row)},{row['cp_count']},{row['cp_bytes']},"
        f"{row['other_collectives']}"
    )


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description="halo exchange radius-shape sweep")
    p.add_argument("--x", type=int, default=256)
    p.add_argument("--y", type=int, default=256)
    p.add_argument("--z", type=int, default=256)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--method", choices=[m.value for m in Method],
                   default=Method.AXIS_COMPOSED.value,
                   help="exchange strategy for the radius sweep")
    p.add_argument("--methods", action="store_true",
                   help="also compare the strategies (pack ablation)")
    p.add_argument("--ablate", action="store_true",
                   help="run ONLY the method ablation, with census columns and a "
                        "bit-for-bit agreement gate (exit 1 on disagreement or a "
                        "skipped method)")
    p.add_argument("--quantities", default="",
                   help="quantity count for the sweeps (single int; default 4), or a "
                        "comma list of Qs for --batched-ab (default 1,4,8)")
    p.add_argument("--batched-ab", action="store_true",
                   help="run ONLY the quantity-batching A/B: batched vs per-quantity "
                        "carriers at each Q with census columns; exit 1 unless the "
                        "batched collective count is Q-independent and results agree "
                        "bit-for-bit")
    p.add_argument("--partition", default="",
                   help="force the partition grid as XxYxZ (e.g. 2x2x2) for "
                        "--batched-ab / --wire-ab")
    p.add_argument("--wire-ab", action="store_true",
                   help="run ONLY the narrowed-wire A/B: native vs --wire-dtype "
                        "carriers, with on-wire byte columns and the measured max "
                        "abs/rel/ulp error vs full precision; exit 1 unless the byte "
                        "reduction and the error meet the format's gate")
    p.add_argument("--wire-dtype", default="",
                   help="wire format (bfloat16, float16, the fp8 and fp4 formats of "
                        "ops/halo_fill.WIRE_FORMATS): the radius sweep runs with it "
                        "on; --wire-ab A/Bs it against native (default bfloat16 there)")
    p.add_argument("--fused", action="store_true",
                   help="use the fused exchange carrier (REMOTE_DMA kernel_variant="
                        "fused) for --wire-ab")
    p.add_argument("--cpu", type=int, default=0,
                   help="run on N CPU positions (1: one CPU device)")
    p.add_argument("--virtual-hosts", type=int, default=0,
                   help="emulate N hosts: needs positions on distinct hosts (not "
                        "ported: ROADMAP.md queue A item 5)")
    add_metrics_flags(p)
    args = p.parse_args(argv)
    if args.virtual_hosts:
        raise NotImplementedError(
            "--virtual-hosts: positions on distinct hosts are ROADMAP.md queue A item 5")
    devices = ["cpu"] * args.cpu if args.cpu else None
    start_metrics(args, "bench_exchange")
    qs = [int(t) for t in str(args.quantities).split(",") if t.strip()]
    partition = tuple(int(t) for t in args.partition.split("x")) if args.partition else None
    if args.wire_ab:
        if len(qs) > 1:
            p.error("--wire-ab takes a single --quantities value")
        wire = args.wire_dtype or "bfloat16"
        rows, ratio, err = wire_ab(
            args.x, args.y, args.z, iters=args.iters, quantities=qs[0] if qs else 4,
            devices=devices, wire=wire, method=Method(args.method), partition=partition,
            fused=args.fused,
        )
        print(ablate_header())
        for row in rows:
            print(ablate_row(row))
        print(f"# on-wire byte reduction ({wire}): {ratio:.3f}x")
        print(f"# max abs err {err['max_abs_err']:.6g}  max rel err "
              f"{err['max_rel_err']:.3e}  max f32-ulp err "
              f"{err['max_ulp_err']:.0f}")
        # the format's gate (wire_gate), and an UNCHANGED collective count:
        # the narrowing must never change what moves, only how wide
        ratio_thr, rel_bound = wire_gate(wire)
        count_ok = len({row["cp_count"] for row in rows}) == 1
        ok = ratio >= ratio_thr and err["max_rel_err"] <= rel_bound and count_ok
        print(f"# wire A/B gate (>={ratio_thr:g}x bytes, rel err <= "
              f"{rel_bound:g}, count unchanged): "
              f"{'PASS' if ok else 'FAIL'}")
        return 0 if ok else 1
    if args.batched_ab:
        rows, q_indep, parity = batched_ab(
            args.x, args.y, args.z, iters=args.iters,
            quantities=tuple(qs) if qs else (1, 4, 8), devices=devices, partition=partition,
        )
        print(ablate_header())
        for row in rows:
            print(ablate_row(row))
        print(f"# batched permute count Q-independent: "
              f"{'PASS' if q_indep else 'FAIL'}")
        print(f"# batched vs per-quantity bit-for-bit: "
              f"{'PASS' if parity else 'FAIL'}")
        return 0 if q_indep and parity else 1
    if len(qs) > 1:
        # a silent truncation to qs[0] would print plausible rows for a
        # configuration the user did not ask for
        p.error("a comma list of --quantities requires --batched-ab")
    nq = qs[0] if qs else 4
    if args.ablate:
        rows, agree = ablate(args.x, args.y, args.z, iters=args.iters, quantities=nq,
                             devices=devices)
        print(ablate_header())
        for row in rows:
            print(ablate_row(row))
        print(f"# bit-for-bit agreement: {'PASS' if agree else 'FAIL'}")
        return 0 if agree and len(rows) == len(ABLATE_METHODS) else 1
    print(report_header())
    for row in run(args.x, args.y, args.z, iters=args.iters, method=Method(args.method),
                   quantities=nq, devices=devices, wire_dtype=args.wire_dtype or None):
        print(report_row(row))
    if args.methods:
        for row in compare_methods(args.x, args.y, args.z, iters=args.iters, quantities=nq,
                                   devices=devices):
            row.pop("domain", None)
            print(report_row(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
