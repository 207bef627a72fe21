"""serve_loadgen — seeded Poisson open-loop load for the serving daemon.

The port's copy of the JAX repo's ``scripts/serve_loadgen.py`` (kept inside
the package; it is stdlib only and imports nothing of either package), the
reference producer for the file-drop intake protocol
(``stencil_tpu_torch/serve/intake.py``): one JSON document per job, written
ATOMICALLY (tmp file in the same directory, then rename — the daemon must
never see a half-written job), dropped into ``<serve-dir>/jobs/incoming/``
with exponential inter-arrival gaps (open loop: the generator never waits
for the daemon, which is what makes the daemon's admission control the
thing under test, not the producer's backpressure).

Everything is seeded: job ids, owners, priorities, deadlines and the
arrival gaps all come from one ``random.Random(seed)``, so the same seed
replays the same offered load, the same jobs as the JAX script's. ``--rate
0`` drops the whole batch immediately (the pre-loaded-queue mode).

Usage: python -m stencil_tpu_torch.apps.serve_loadgen --serve-dir /srv/stencil \
           --jobs 16 --rate 4 --seed 7 --tenants 3
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

PRIORITIES = ("high", "normal", "low")


def parse_mix(spec: str):
    """``--mix`` entries: comma-separated ``SIZE[/DTYPE[/WORKLOAD]]``
    where SIZE is ``N`` (cubic) or ``XxYxZ``. Each job draws one entry
    from the seeded rng, so a mixed-shape/dtype offered load replays
    exactly. Returns ``[(size, dtype, workload), ...]``."""
    out = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split("/")
        if len(parts) > 3:
            raise ValueError(f"bad --mix entry {entry!r} "
                             "(want SIZE[/DTYPE[/WORKLOAD]])")
        dims = parts[0].lower().split("x")
        if len(dims) not in (1, 3) or not all(
                d.isdigit() and int(d) >= 1 for d in dims):
            raise ValueError(f"bad --mix size {parts[0]!r} "
                             "(want N or XxYxZ)")
        size = ([int(dims[0])] * 3 if len(dims) == 1
                else [int(d) for d in dims])
        dtype = parts[1] if len(parts) > 1 else "float32"
        if dtype not in ("float32", "float64"):
            raise ValueError(f"bad --mix dtype {dtype!r}")
        workload = parts[2] if len(parts) > 2 else "jacobi"
        if workload not in ("jacobi", "astaroth"):
            raise ValueError(f"bad --mix workload {workload!r}")
        out.append((size, dtype, workload))
    if not out:
        raise ValueError("--mix named no entries")
    return out


def burst_gaps(gaps, on_s: float, off_s: float):
    """Reshape Poisson arrival gaps into an on/off duty cycle: arrivals
    keep their seeded order and in-burst spacing, but any arrival that
    would land in an OFF window slides to the start of the next ON
    window — a deterministic transform of the same seeded gap list."""
    period = on_s + off_s
    out = []
    t = 0.0
    prev = 0.0
    for g in gaps:
        t += g
        phase = t % period
        if phase >= on_s:  # lands in the quiet half: slide to next burst
            t += period - phase
        out.append(t - prev)
        prev = t
    return out


def drop_job(incoming: str, doc: dict) -> str:
    """Atomically drop one job document (the intake write contract)."""
    name = f"{doc['job']}.json"
    tmp = os.path.join(incoming, f".tmp-{name}-{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    dst = os.path.join(incoming, name)
    os.replace(tmp, dst)
    return dst


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="seeded Poisson open-loop job generator for the "
                    "serving daemon")
    p.add_argument("--serve-dir", required=True,
                   help="the daemon's service root (jobs land in "
                        "<serve-dir>/jobs/incoming/)")
    p.add_argument("--jobs", type=int, default=8,
                   help="number of jobs to drop")
    p.add_argument("--rate", type=float, default=4.0,
                   help="mean arrival rate in jobs/s (Poisson: "
                        "exponential gaps); 0 = drop everything at once")
    p.add_argument("--seed", type=int, default=0,
                   help="seeds ids, owners, priorities AND arrival gaps "
                        "— the same seed replays the same offered load")
    p.add_argument("--tenants", type=int, default=2,
                   help="owners drawn uniformly from tenant-0..N-1")
    p.add_argument("--size", type=int, default=12,
                   help="per-job cubic domain edge")
    p.add_argument("--steps", type=int, default=4,
                   help="steps per job")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--workload", default="jacobi",
                   choices=["jacobi", "astaroth"])
    p.add_argument("--deadline-ms", type=float, default=0.0,
                   help="per-step p99 SLO stamped on every job "
                        "(0 = no deadline)")
    p.add_argument("--mixed-priority", action="store_true",
                   help="draw priorities high/normal/low (seeded) instead "
                        "of all-normal")
    p.add_argument("--mix", default="",
                   help="multi-shape/dtype job mix: comma-separated "
                        "SIZE[/DTYPE[/WORKLOAD]] entries (SIZE = N or "
                        "XxYxZ), e.g. '12,16/float64'; each job draws "
                        "one entry (seeded) — overrides --size/--dtype/"
                        "--workload")
    p.add_argument("--burst", default="",
                   help="on/off duty-cycle arrivals as ON_S,OFF_S "
                        "seconds, e.g. '1,2': the seeded Poisson gaps "
                        "are reshaped so every arrival lands in an ON "
                        "window — bursty offered load, same determinism "
                        "(needs --rate > 0)")
    p.add_argument("--prefix", default="j",
                   help="job id prefix (ids are <prefix>-<seed>-<i>; two "
                        "generators with different seeds never collide)")
    args = p.parse_args(argv)
    if args.jobs < 1:
        p.error(f"--jobs must be >= 1, got {args.jobs}")
    if args.rate < 0:
        p.error(f"--rate must be >= 0, got {args.rate}")
    mix = None
    if args.mix:
        try:
            mix = parse_mix(args.mix)
        except ValueError as e:
            p.error(str(e))
    burst = None
    if args.burst:
        parts = args.burst.split(",")
        try:
            on_s, off_s = (float(parts[0]), float(parts[1]))
        except (IndexError, ValueError):
            p.error(f"bad --burst {args.burst!r} (want ON_S,OFF_S)")
        if on_s <= 0 or off_s < 0:
            p.error(f"--burst needs ON_S > 0 and OFF_S >= 0, "
                    f"got {args.burst!r}")
        if args.rate <= 0:
            p.error("--burst shapes arrival times; it needs --rate > 0")
        burst = (on_s, off_s)

    incoming = os.path.join(args.serve_dir, "jobs", "incoming")
    os.makedirs(incoming, exist_ok=True)
    rng = random.Random(args.seed)
    # draw EVERY gap up front so --mix/--burst never perturb the seeded
    # per-job draws (ids, owners, priorities stay replay-identical)
    gaps = [0.0 if i == 0 else rng.expovariate(args.rate)
            if args.rate > 0 else 0.0 for i in range(args.jobs)]
    if burst is not None:
        gaps = burst_gaps(gaps, burst[0], burst[1])
    t0 = time.perf_counter()
    dropped = []
    for i in range(args.jobs):
        if args.rate > 0 and gaps[i] > 0:
            time.sleep(gaps[i])
        size, dtype, workload = (
            rng.choice(mix) if mix is not None
            else ([args.size] * 3, args.dtype, args.workload))
        doc = {
            "job": f"{args.prefix}-{args.seed}-{i:04d}",
            "size": size,
            "steps": args.steps,
            "dtype": dtype,
            "workload": workload,
            "seed": rng.randrange(1 << 20),
            "tenant": f"tenant-{rng.randrange(args.tenants)}",
            "priority": (rng.choice(PRIORITIES) if args.mixed_priority
                         else "normal"),
        }
        if args.deadline_ms > 0:
            doc["deadline_ms"] = args.deadline_ms
        path = drop_job(incoming, doc)
        print(f"[loadgen] dropped {os.path.basename(path)} "
              f"(tenant={doc['tenant']}, priority={doc['priority']})",
              file=sys.stderr, flush=True)
        dropped.append(doc["job"])
    print(json.dumps({
        "app": "serve_loadgen", "dropped": len(dropped), "seed": args.seed,
        "rate_per_s": args.rate, "wall_s": round(time.perf_counter() - t0, 3),
        "first": dropped[0], "last": dropped[-1],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
