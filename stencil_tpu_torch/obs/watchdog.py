"""The revival watcher: supervise stall-prone measurement children.

The port's own copy of ``stencil_tpu.obs.watchdog``. A long measurement on
the card can wedge (a kernel that never returns, a CUDA call that blocks)
or die mid-run; the reference keeps its campaigns alive with babysitting
shell scripts. This module is that logic made reusable and testable.

Two layers:

- :func:`supervise` — run ONE child under two deadlines: a total wall
  budget (``timeout_s``) and an optional heartbeat deadline
  (``heartbeat_timeout_s``). The supervisor hands the child a heartbeat
  file path via the ``STENCIL_HEARTBEAT_FILE`` env var; the child's
  telemetry recorder (``obs/telemetry.Recorder``) touches that file on
  every record and from a background thread. A fresh file mtime is a
  beat; staleness beyond the deadline is a STALL (killed early, long
  before the total budget), process exit is ok/crash, budget exhaustion
  is a TIMEOUT. Heartbeats catch hard wedges (a native call that stops
  the interpreter also stops the beat thread); a wedge that keeps the
  interpreter breathing still falls to the total budget — the two
  deadlines are deliberately layered.
- :class:`Revival` — a bounded-budget ladder of such attempts with
  backoff, a result parser, and per-attempt log archiving, so a
  launcher's entry point is a plan (name, cmd, timeout) list instead of copy-pasted
  subprocess plumbing.

This module is PURE STDLIB and must stay importable without torch or the
rest of the package: a supervisor loads it by file path (``importlib``) so
that the parent process never initializes CUDA, whose init is one of the
wedges being supervised. ``analysis/astlint``'s ``pure-stdlib`` rule holds
it to that.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

# Contract with obs/telemetry (the writer side): the child process touches
# the file named by this env var; only the mtime matters.
HEARTBEAT_FILE_ENV = "STENCIL_HEARTBEAT_FILE"
HEARTBEAT_INTERVAL_ENV = "STENCIL_HEARTBEAT_INTERVAL_S"

# Outcomes, in the order the layered deadlines fire.
OK = "ok"
CRASH = "crash"          # child exited nonzero on its own
STALL = "stall"          # heartbeat went stale; child was killed
TIMEOUT = "timeout"      # total budget exhausted; child was killed
NO_RESULT = "no-result"  # exited 0 but the parser found no payload
FAULT = "fault"          # child aborted via the fault/recovery ladder

# Contract with fault/recover (which imports THIS constant through
# obs/__init__; watchdog.py must stay importable without the package): a
# child that exhausted its rollback budget exits with this rc, distinct from
# a stall kill (rc None), a generic crash, and the ckpt kill hook's 17, so
# the revival ladder can tell "numerics are broken" from "process died".
FAULT_RC = 43


@dataclass
class Attempt:
    """One supervised child run, as archived evidence."""

    name: str
    outcome: str
    rc: Optional[int]  # None when the supervisor killed the child
    seconds: float
    stdout: str
    stderr_tail: str
    log_path: Optional[str] = None  # archived combined log, if archiving
    metrics_log_path: Optional[str] = None  # archived metrics JSONL (evidence)
    heartbeat_note: Optional[dict] = None  # last beat's JSON payload (stalls)

    def summary(self) -> dict:
        return {
            "name": self.name,
            "outcome": self.outcome,
            "rc": self.rc,
            "seconds": round(self.seconds, 1),
            "log": self.log_path,
            "metrics": self.metrics_log_path,
        }


def _mtime(path: str) -> Optional[float]:
    try:
        return os.stat(path).st_mtime
    except OSError:
        return None


def read_heartbeat_note(path: str) -> Optional[dict]:
    """The beat file's optional JSON payload (telemetry writes
    ``{"t", "step"?, "span"?}``) — None for a missing file or a
    non-JSON body (a hand-touched beat is still a valid beat: liveness
    is mtime-only by contract, the payload is a bonus)."""
    try:
        with open(path) as f:
            note = json.loads(f.read(4096))
    except (OSError, ValueError):
        return None
    return note if isinstance(note, dict) else None


def format_heartbeat_note(note: Optional[dict]) -> str:
    """One human phrase from a beat payload: "at step 412 in exchange"."""
    if not note:
        return ""
    parts = []
    if isinstance(note.get("step"), int):
        parts.append(f"at step {note['step']}")
    if isinstance(note.get("span"), str) and note["span"]:
        parts.append(f"in {note['span']}")
    return " ".join(parts)


def _kill(proc: subprocess.Popen, grace_s: float) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=grace_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        try:
            proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            pass  # unreapable; the OS keeps the zombie, we keep the budget


def supervise(
    cmd: Sequence[str],
    *,
    timeout_s: float,
    heartbeat_timeout_s: Optional[float] = None,
    first_beat_grace_s: Optional[float] = None,
    env: Optional[dict] = None,
    name: str = "child",
    poll_s: float = 0.25,
    archive_dir: Optional[str] = None,
    kill_grace_s: float = 5.0,
    cwd: Optional[str] = None,
    stderr_tail_bytes: int = 4000,
    fault_rc: Optional[int] = FAULT_RC,
    metrics_path: Optional[str] = None,
) -> Attempt:
    """Run ``cmd`` under the layered deadlines and return the Attempt.

    stdout/stderr go to temp FILES, not pipes: a child killed mid-write
    loses pipe buffers, but file contents survive the kill.
    ``heartbeat_timeout_s=None`` disables stall detection (total budget
    only). ``first_beat_grace_s`` is the deadline for the FIRST beat
    (interpreter, torch import and CUDA init are slow on small hosts); it
    defaults to ``max(heartbeat_timeout_s, 60)``.

    A child exit code equal to ``fault_rc`` is classified as the FAULT
    outcome (the fault/recovery ladder's rollback-exhausted abort) rather
    than a generic CRASH. On any non-OK outcome, when archiving is on and
    the child wrote a metrics JSONL (``metrics_path``, defaulting to the
    ``STENCIL_METRICS_OUT`` / ``STENCIL_BENCH_METRICS_OUT`` entries of
    the child's env), the metrics file is archived next to the log — a
    post-mortem gets telemetry, not just stdout.
    """
    env = dict(env if env is not None else os.environ)
    if metrics_path is None:
        metrics_path = (env.get("STENCIL_METRICS_OUT")
                        or env.get("STENCIL_BENCH_METRICS_OUT"))
    hb_dir = None
    hb_path = None
    if heartbeat_timeout_s is not None:
        hb_dir = tempfile.mkdtemp(prefix="stencil-hb-")
        hb_path = os.path.join(hb_dir, "beat")
        env[HEARTBEAT_FILE_ENV] = hb_path
        # overwrite, never setdefault: a nested supervision must beat at
        # THIS deadline's cadence, not an outer (possibly slower) one's
        env[HEARTBEAT_INTERVAL_ENV] = str(max(0.2, heartbeat_timeout_s / 4))
        if first_beat_grace_s is None:
            first_beat_grace_s = max(heartbeat_timeout_s, 60.0)

    t0 = time.monotonic()
    outcome = OK
    rc: Optional[int] = None
    hb_note: Optional[dict] = None
    with tempfile.TemporaryFile(mode="w+") as out, \
            tempfile.TemporaryFile(mode="w+") as err:
        proc = subprocess.Popen(cmd, stdout=out, stderr=err, env=env, cwd=cwd)
        try:
            while True:
                rc = proc.poll()
                if rc is not None:
                    if rc == 0:
                        outcome = OK
                    elif fault_rc is not None and rc == fault_rc:
                        outcome = FAULT
                    else:
                        outcome = CRASH
                    break
                elapsed = time.monotonic() - t0
                if elapsed > timeout_s:
                    outcome = TIMEOUT
                    print(
                        f"[watchdog] {name} timed out after {elapsed:.0f}s "
                        f"(budget {timeout_s:.0f}s); killing",
                        file=sys.stderr, flush=True,
                    )
                    _kill(proc, kill_grace_s)
                    break
                if hb_path is not None:
                    mt = _mtime(hb_path)
                    now = time.time()
                    stale = (
                        (mt is None and elapsed > first_beat_grace_s)
                        or (mt is not None and now - mt > heartbeat_timeout_s)
                    )
                    if stale:
                        outcome = STALL
                        age = "never beat" if mt is None else f"{now - mt:.0f}s stale"
                        # quote the beat payload's progress note so the
                        # report says WHERE, not just how stale
                        hb_note = read_heartbeat_note(hb_path)
                        where = format_heartbeat_note(hb_note)
                        print(
                            f"[watchdog] {name} stalled"
                            + (f" {where}" if where else "")
                            + f" (heartbeat {age}, "
                            f"deadline {heartbeat_timeout_s:.0f}s) after "
                            f"{elapsed:.0f}s; killing",
                            file=sys.stderr, flush=True,
                        )
                        _kill(proc, kill_grace_s)
                        break
                time.sleep(poll_s)
        finally:
            if proc.poll() is None:
                _kill(proc, kill_grace_s)
        seconds = time.monotonic() - t0
        out.seek(0)
        stdout = out.read()
        err.seek(0)
        stderr = err.read()

    if hb_dir is not None:
        for p in (hb_path, hb_dir):
            try:
                os.remove(p) if p == hb_path else os.rmdir(p)
            except OSError:
                pass

    att = Attempt(
        name=name,
        outcome=outcome,
        rc=rc,
        seconds=seconds,
        stdout=stdout,
        stderr_tail=stderr[-stderr_tail_bytes:],
        log_path=None,
        heartbeat_note=hb_note,
    )
    if archive_dir:
        # sub-second suffix: back-to-back retries of one name must not
        # overwrite each other's archived evidence
        stamp = (time.strftime("%Y%m%dT%H%M%S")
                 + f"-{time.time_ns() % 10**6:06d}")
        try:
            os.makedirs(archive_dir, exist_ok=True)
            att.log_path = os.path.join(archive_dir, f"{name}-{stamp}.log")
            with open(att.log_path, "w") as f:
                f.write(f"# attempt={name} outcome={outcome} rc={rc} "
                        f"seconds={seconds:.1f}\n")
                f.write("# --- stdout ---\n")
                f.write(stdout)
                f.write("\n# --- stderr ---\n")
                f.write(stderr)
        except OSError as e:  # archiving must never eat the measurement
            print(f"[watchdog] log archive failed: {e}", file=sys.stderr)
            att.log_path = None
        # evidence bundle: on a bad outcome, the child's metrics JSONL is
        # archived beside the log (a copy, not a move — a later resumed
        # child may still be appending to the live file)
        if (outcome != OK and metrics_path
                and os.path.isfile(metrics_path)):
            try:
                dest = os.path.join(archive_dir,
                                    f"{name}-{stamp}.metrics.jsonl")
                shutil.copyfile(metrics_path, dest)
                att.metrics_log_path = dest
            except OSError as e:
                print(f"[watchdog] metrics archive failed: {e}",
                      file=sys.stderr)
    return att


@dataclass
class Revival:
    """A bounded-budget retry ladder over supervised children.

    ``parse(stdout) -> payload | None`` extracts the measurement result;
    an attempt that exits 0 without a parseable payload is recorded as
    ``no-result`` (the ladder continues). The overall budget is the
    Revival's, not per-attempt: ``attempt()`` clamps each timeout to the
    time remaining and refuses attempts shorter than ``min_attempt_s``.
    """

    budget_s: float
    parse: Callable[[str], Optional[object]]
    archive_dir: Optional[str] = None
    min_attempt_s: float = 10.0
    attempts: List[Attempt] = field(default_factory=list)
    _t0: float = field(default_factory=time.monotonic)

    def remaining(self) -> float:
        return self.budget_s - (time.monotonic() - self._t0)

    def attempt(
        self,
        name: str,
        cmd: Sequence[str],
        *,
        timeout_s: float,
        heartbeat_timeout_s: Optional[float] = None,
        first_beat_grace_s: Optional[float] = None,
        env: Optional[dict] = None,
        cwd: Optional[str] = None,
        floor_timeout_s: float = 0.0,
    ) -> Optional[object]:
        """Run one rung of the ladder; return the parsed payload or None.

        ``floor_timeout_s`` guarantees a minimal try even when the budget
        is spent (the last-resort fallback must not be starved of its
        shot at producing the result line)."""
        timeout_s = max(floor_timeout_s, min(timeout_s, self.remaining()))
        if timeout_s < self.min_attempt_s:
            return None
        att = supervise(
            cmd,
            timeout_s=timeout_s,
            heartbeat_timeout_s=heartbeat_timeout_s,
            first_beat_grace_s=first_beat_grace_s,
            env=env,
            name=name,
            archive_dir=self.archive_dir,
            cwd=cwd,
        )
        payload = self.parse(att.stdout) if att.stdout else None
        if payload is None and att.outcome == OK:
            att.outcome = NO_RESULT
        self.attempts.append(att)
        if payload is None:
            print(
                f"[watchdog] {name} produced no result "
                f"(outcome={att.outcome}, rc={att.rc}); stderr tail:\n"
                f"{att.stderr_tail[-2000:]}",
                file=sys.stderr, flush=True,
            )
        return payload

    def backoff(self, seconds: float, floor_s: float = 0.0) -> None:
        """Sleep between rungs, never past the budget (keep ``floor_s`` in
        reserve for the remaining rungs)."""
        time.sleep(min(seconds, max(0.0, self.remaining() - floor_s)))

    def report(self) -> List[dict]:
        return [a.summary() for a in self.attempts]
