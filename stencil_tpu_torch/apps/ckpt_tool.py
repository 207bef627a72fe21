"""ckpt_tool — inspect / validate / diff checkpoint snapshots.

The port's own copy of ``stencil_tpu.apps.ckpt_tool``: the operator's window
into the checkpoint format (``ckpt/``), which both packages write, so it
reads the snapshots of either:

- ``inspect PATH``   print a snapshot's manifest summary (PATH may be a
                     snapshot dir or a checkpoint dir — the latter
                     resolves through ``LATEST``).
- ``validate PATH``  full integrity check (manifest schema, payload byte
                     counts + SHA-256, block coverage); ``--all`` checks
                     every snapshot under a checkpoint dir. Exit 1 on any
                     problem — this is the CI gate. ``--quarantine``
                     renames invalid snapshots aside (``quarantine-*``)
                     so auto-resume stops rescanning them on every
                     restart.
- ``diff A B``       compare two snapshots' metadata; ``--data``
                     additionally reassembles every quantity's global
                     interior from both and requires bit-equality (the
                     save->kill->resume == uninterrupted proof in CI).
                     Exit 1 on any difference.

Host-only (numpy and the standard library): no device is touched.

Usage: python -m stencil_tpu_torch.apps.ckpt_tool validate runs/ckpt
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np

from ..ckpt import (
    LATEST_NAME,
    assemble_global,
    list_snapshots,
    load_manifest,
    read_latest,
    validate_snapshot,
)


def resolve_snapshot(path: str) -> str:
    """PATH -> snapshot dir: either PATH is one (has a manifest) or it is
    a checkpoint dir whose LATEST/newest snapshot is taken."""
    if os.path.isfile(os.path.join(path, "manifest.json")):
        return path
    latest = read_latest(path)
    if latest and os.path.isdir(os.path.join(path, latest)):
        return os.path.join(path, latest)
    snaps = list_snapshots(path)
    if snaps:
        return os.path.join(path, snaps[-1])
    raise SystemExit(f"ckpt_tool: no snapshot found at {path}")


def _summary(snap: str, m: dict) -> str:
    g, p = m["global"], m["partition"]
    nbytes = sum(f["bytes"] for f in m["files"])
    qs = ", ".join(f"{q['name']}:{q['dtype']}" for q in m["quantities"])
    return (
        f"{snap}\n"
        f"  step      {m['step']}\n"
        f"  global    ({g['x']},{g['y']},{g['z']})  "
        f"partition ({p['x']},{p['y']},{p['z']})\n"
        f"  quantities {qs}\n"
        f"  files     {len(m['files'])}  bytes {nbytes}\n"
    )


def cmd_inspect(args) -> int:
    snap = resolve_snapshot(args.path)
    m = load_manifest(snap)
    if args.json:
        print(json.dumps(m, indent=1))
    else:
        print(_summary(snap, m), end="")
    return 0


def cmd_validate(args) -> int:
    targets: List[str] = []
    if args.all:
        snaps = list_snapshots(args.path)
        if not snaps:
            print(f"ckpt_tool: no snapshots under {args.path}")
            return 1
        targets = [os.path.join(args.path, s) for s in snaps]
    else:
        targets = [resolve_snapshot(args.path)]
    rc = 0
    for snap in targets:
        errs = validate_snapshot(snap, deep=not args.shallow)
        if errs:
            rc = 1
            print(f"INVALID {snap}")
            for e in errs:
                print(f"  - {e}")
            if args.quarantine:
                from ..ckpt import quarantine_snapshot

                ckpt_dir, name = os.path.split(os.path.normpath(snap))
                dest = quarantine_snapshot(ckpt_dir or ".", name,
                                           reason=errs[0])
                if dest:
                    print(f"  quarantined -> {os.path.basename(dest)}")
        else:
            print(f"ok {snap}")
    if args.all:
        latest = read_latest(args.path)
        if latest and not os.path.isdir(os.path.join(args.path, latest)):
            print(f"INVALID {LATEST_NAME} -> missing snapshot {latest}")
            rc = 1
    return rc


def _meta_diffs(a: dict, b: dict) -> List[str]:
    out = []
    for key in ("v", "payload", "global", "partition"):
        if a.get(key) != b.get(key):
            out.append(f"{key}: {a.get(key)!r} != {b.get(key)!r}")
    qa = {q["name"]: q["dtype"] for q in a["quantities"]}
    qb = {q["name"]: q["dtype"] for q in b["quantities"]}
    if qa != qb:
        out.append(f"quantities: {qa!r} != {qb!r}")
    if a["step"] != b["step"]:
        out.append(f"step: {a['step']} != {b['step']}")
    return out


def cmd_diff(args) -> int:
    sa, sb = resolve_snapshot(args.a), resolve_snapshot(args.b)
    ma, mb = load_manifest(sa), load_manifest(sb)
    diffs = _meta_diffs(ma, mb)
    if getattr(args, "elastic", False):
        # elastic comparison: the two snapshots may legitimately live on
        # different partitions of the SAME global grid (a mesh-reshape
        # resume, or a mid-run plan hot-swap) — the claim under test is
        # the assembled payload, so a partition-only meta delta is not a
        # difference. Grid/quantity/step deltas still are.
        diffs = [d for d in diffs if not d.startswith("partition")]
    # data comparison only makes sense on a shared grid + quantity set
    comparable = not any(d.startswith(("global", "quantities")) for d in diffs)
    if args.data and comparable:
        for q in ma["quantities"]:
            name = q["name"]
            ga = assemble_global(sa, ma, name)
            gb = assemble_global(sb, mb, name)
            if ga.dtype != gb.dtype:
                diffs.append(f"data[{name}]: dtype {ga.dtype} != {gb.dtype}")
            elif not np.array_equal(ga, gb, equal_nan=True):
                n = int(np.sum(ga != gb))
                with np.errstate(invalid="ignore"):
                    mx = float(np.nanmax(np.abs(
                        ga.astype(np.float64) - gb.astype(np.float64))))
                diffs.append(
                    f"data[{name}]: {n} differing cells, max |delta| {mx:g}"
                )
    elif args.data:
        diffs.append("data: skipped (grids/quantity sets differ)")
    if diffs:
        print(f"DIFFER {sa} vs {sb}")
        for d in diffs:
            print(f"  - {d}")
        return 1
    print(f"identical {sa} == {sb}"
          + (" (bit-exact payloads)" if args.data else " (metadata)"))
    return 0


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        description="inspect / validate / diff checkpoint snapshots"
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    pi = sub.add_parser("inspect", help="print a snapshot's manifest summary")
    pi.add_argument("path")
    pi.add_argument("--json", action="store_true",
                    help="dump the full manifest as JSON")
    pi.set_defaults(fn=cmd_inspect)
    pv = sub.add_parser("validate", help="integrity-check snapshot(s)")
    pv.add_argument("path")
    pv.add_argument("--all", action="store_true",
                    help="validate every snapshot under a checkpoint dir")
    pv.add_argument("--shallow", action="store_true",
                    help="skip SHA-256 (byte counts + coverage only)")
    pv.add_argument("--quarantine", action="store_true",
                    help="rename invalid snapshots aside (quarantine-*) so "
                         "auto-resume stops rescanning them on every "
                         "restart; the bytes stay on disk as evidence")
    pv.set_defaults(fn=cmd_validate)
    pd = sub.add_parser("diff", help="compare two snapshots")
    pd.add_argument("a")
    pd.add_argument("b")
    pd.add_argument("--elastic", action="store_true",
                    help="ignore partition-shape meta deltas: compare "
                         "two partitions of the same global grid (a "
                         "mesh-reshape resume or a mid-run plan "
                         "hot-swap) by their assembled payloads")
    pd.add_argument("--data", action="store_true",
                    help="also require bit-exact payload equality")
    pd.set_defaults(fn=cmd_diff)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
