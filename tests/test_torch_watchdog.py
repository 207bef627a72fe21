"""The port's obs/watchdog held to stencil_tpu.obs.watchdog on the same
child scripts: ok, crash, timeout, stall, never-beaten grace, FAULT_RC and
the archived evidence, and the Revival ladder; the port's telemetry
heartbeats (the recorder's thread, its note of the last step) feed the
supervisor; the module loads by file path with no package around it.

Every supervised child runs under its own wall budget (``timeout_s``), and
the heartbeat deadlines leave seconds of margin: a stalled child sleeps
300 s, so only the deadline under test can end it."""

import importlib.util
import json
import os
import sys
import textwrap

import pytest

from stencil_tpu.obs import watchdog as jwd
from stencil_tpu_torch.obs import FAULT_RC, telemetry
from stencil_tpu_torch.obs import watchdog as twd

PY = sys.executable
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# beats the heartbeat file three times, then wedges far past any deadline
STALL_CHILD = textwrap.dedent(
    """
    import os, time
    hb = os.environ["STENCIL_HEARTBEAT_FILE"]
    for _ in range(3):
        with open(hb, "w") as f:
            f.write(str(time.time()))
        time.sleep(0.2)
    print("beaten; wedging now", flush=True)
    time.sleep(300)
    """
)

# (name, child argv, supervise kwargs)
CASES = [
    ("ok", [PY, "-c", "print('RESULT 42')"], dict(timeout_s=60)),
    ("crash", [PY, "-c", "import sys; sys.exit(3)"], dict(timeout_s=60)),
    ("timeout", [PY, "-c", "import time; print('partial', flush=True); time.sleep(300)"],
     dict(timeout_s=2.0, poll_s=0.1)),
    ("stall", [PY, "-c", STALL_CHILD],
     dict(timeout_s=120, heartbeat_timeout_s=1.5, first_beat_grace_s=60, poll_s=0.1)),
    ("never-beaten", [PY, "-c", "import time; time.sleep(300)"],
     dict(timeout_s=120, heartbeat_timeout_s=60, first_beat_grace_s=1.5, poll_s=0.1)),
    ("fault", [PY, "-c", "import sys; sys.exit(43)"], dict(timeout_s=60)),
    ("fault-off", [PY, "-c", "import sys; sys.exit(43)"], dict(timeout_s=60, fault_rc=None)),
]


@pytest.mark.parametrize("name,cmd,kw", CASES, ids=[c[0] for c in CASES])
def test_supervise_matches_jax(tmp_path, name, cmd, kw):
    got = {}
    for label, wd in (("jax", jwd), ("port", twd)):
        att = wd.supervise(cmd, name=name, archive_dir=str(tmp_path / label), **kw)
        got[label] = att
        assert att.log_path and os.path.exists(att.log_path)
        assert att.summary()["outcome"] == att.outcome
    j, t = got["jax"], got["port"]
    assert (t.outcome, t.rc) == (j.outcome, j.rc)
    assert t.stdout == j.stdout
    expect = {"ok": twd.OK, "crash": twd.CRASH, "timeout": twd.TIMEOUT, "stall": twd.STALL,
              "never-beaten": twd.STALL, "fault": twd.FAULT, "fault-off": twd.CRASH}[name]
    assert t.outcome == expect
    if name in ("stall", "never-beaten"):
        assert t.seconds < 60  # the heartbeat deadline fired, not the budget
    if name == "timeout":
        assert "partial" in open(t.log_path).read()  # file-backed, survives the kill


def test_constants_match_jax():
    assert (twd.FAULT_RC, twd.HEARTBEAT_FILE_ENV, twd.HEARTBEAT_INTERVAL_ENV) == (
        jwd.FAULT_RC, jwd.HEARTBEAT_FILE_ENV, jwd.HEARTBEAT_INTERVAL_ENV)
    assert FAULT_RC == twd.FAULT_RC == 43
    for k in ("OK", "CRASH", "STALL", "TIMEOUT", "NO_RESULT", "FAULT"):
        assert getattr(twd, k) == getattr(jwd, k)
    for note in (None, {}, {"step": 412, "span": "exchange"}, {"step": "x", "span": ""},
                 {"span": "jacobi.iter"}):
        assert twd.format_heartbeat_note(note) == jwd.format_heartbeat_note(note)


def test_read_heartbeat_note_matches_jax(tmp_path):
    for i, body in enumerate(('{"t": 1.0, "step": 3}', "not json", "[1, 2]", "")):
        p = tmp_path / f"beat{i}"
        p.write_text(body)
        assert twd.read_heartbeat_note(str(p)) == jwd.read_heartbeat_note(str(p))
    assert twd.read_heartbeat_note(str(tmp_path / "missing")) is None


def test_archives_metrics_evidence_as_jax(tmp_path):
    child = ("import os, sys\n"
             "open(os.environ['STENCIL_METRICS_OUT'], 'w').write('{\"fake\": 1}\\n')\n"
             "sys.exit(43)\n")
    for label, wd in (("jax", jwd), ("port", twd)):
        env = dict(os.environ, STENCIL_METRICS_OUT=str(tmp_path / f"{label}.jsonl"))
        att = wd.supervise([PY, "-c", child], timeout_s=60, env=env, name="evidence",
                           archive_dir=str(tmp_path / label))
        assert att.outcome == wd.FAULT
        assert att.metrics_log_path.endswith(".metrics.jsonl")
        assert open(att.metrics_log_path).read() == '{"fake": 1}\n'
        ok = wd.supervise([PY, "-c", "print('fine')"], timeout_s=60, env=env,
                          name="healthy", archive_dir=str(tmp_path / label))
        assert ok.outcome == wd.OK and ok.metrics_log_path is None


def _parse_result(stdout):
    for line in stdout.splitlines():
        if line.startswith("RESULT "):
            try:
                return json.loads(line[len("RESULT "):])
            except json.JSONDecodeError:
                return None
    return None


def test_revival_ladder_matches_jax(tmp_path):
    """Stall detected -> killed -> retried -> payload, both attempts
    reported and archived; the no-result rung and the budget refusal."""
    reports = {}
    for label, wd in (("jax", jwd), ("port", twd)):
        rev = wd.Revival(budget_s=120, parse=_parse_result, archive_dir=str(tmp_path / label),
                         min_attempt_s=1.0)
        assert rev.attempt("stall-rung", [PY, "-c", STALL_CHILD], timeout_s=60,
                           heartbeat_timeout_s=1.5, first_beat_grace_s=60) is None
        assert rev.attempt("good-rung", [PY, "-c", "print('RESULT {\"value\": 7}')"],
                           timeout_s=30) == {"value": 7}
        assert rev.attempt("empty", [PY, "-c", "print('nothing')"], timeout_s=30) is None
        assert all(a.log_path and os.path.exists(a.log_path) for a in rev.attempts)
        reports[label] = [(r["name"], r["outcome"], r["rc"]) for r in rev.report()]
        spent = wd.Revival(budget_s=0.0, parse=_parse_result)
        assert spent.attempt("refused", [PY, "-c", "print(1)"], timeout_s=30) is None
        assert spent.attempts == []
        assert spent.attempt("floored", [PY, "-c", "print('RESULT {\"v\": 1}')"],
                             timeout_s=30, floor_timeout_s=30.0) == {"v": 1}
    assert reports["port"] == reports["jax"] == [
        ("stall-rung", "stall", None), ("good-rung", "ok", 0), ("empty", "no-result", 0)]


def test_port_telemetry_heartbeats_feed_the_watchdog(tmp_path):
    """The port's recorder keeps a healthy child alive under a tight
    deadline: configure() starts the beat thread, which beats through a
    2.5 s silent stretch against a 1.5 s deadline, and the note quotes the
    last step the loop reported."""
    child = textwrap.dedent(
        """
        import json, os, time
        from stencil_tpu_torch.obs import telemetry
        rec = telemetry.configure(app="hb-child")
        rec.note_step(7)
        time.sleep(2.5)
        rec.heartbeat()
        print("NOTE", open(os.environ["STENCIL_HEARTBEAT_FILE"]).read().strip(), flush=True)
        """
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    att = twd.supervise([PY, "-c", child], timeout_s=180, heartbeat_timeout_s=1.5,
                        first_beat_grace_s=150, poll_s=0.1, name="telemetry-child", env=env,
                        cwd=REPO)
    assert att.outcome == twd.OK, (att.outcome, att.stderr_tail)
    note = json.loads(att.stdout.split("NOTE ", 1)[1])
    assert note["step"] == 7 and isinstance(note["t"], float)


def test_stopped_heartbeat_is_a_stall(tmp_path):
    """stop_heartbeat (fault/inject's stall@K) beats once more with the note
    of where it stopped, then stops the thread and the per-record beats:
    the supervisor kills the child as a stall and quotes the step."""
    child = textwrap.dedent(
        """
        import time
        from stencil_tpu_torch.obs import telemetry
        rec = telemetry.configure(app="stall-child")
        rec.note_step(3)
        rec.stop_heartbeat()
        for _ in range(300):
            rec.meta("config", config={})
            time.sleep(1.0)
        """
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    att = twd.supervise([PY, "-c", child], timeout_s=180, heartbeat_timeout_s=2.0,
                        first_beat_grace_s=150, poll_s=0.1, name="stall-child", env=env,
                        cwd=REPO)
    assert att.outcome == twd.STALL and att.seconds < 90
    assert att.heartbeat_note["step"] == 3
    assert twd.format_heartbeat_note(att.heartbeat_note) == "at step 3"


def test_recorder_without_supervisor_does_not_beat(tmp_path, monkeypatch):
    monkeypatch.delenv(twd.HEARTBEAT_FILE_ENV, raising=False)
    rec = telemetry.Recorder(sink=str(tmp_path / "m.jsonl"))
    assert rec.start_heartbeat_thread() is False
    rec.heartbeat()  # a record, no file
    rec.close()
    recs = [json.loads(ln) for ln in open(tmp_path / "m.jsonl")]
    assert [(r["kind"], r["name"], r["seq"]) for r in recs] == [("heartbeat", "hb", 1)]
    assert telemetry.validate_record(recs[0]) == []


def test_loads_by_file_path_without_the_package():
    """A supervisor loads obs/watchdog.py by path, with no package context
    and without importing torch."""
    path = os.path.join(REPO, "stencil_tpu_torch", "obs", "watchdog.py")
    code = textwrap.dedent(
        f"""
        import importlib.util, sys
        spec = importlib.util.spec_from_file_location("wd", {path!r})
        wd = importlib.util.module_from_spec(spec)
        sys.modules["wd"] = wd  # dataclasses resolve their module by name
        spec.loader.exec_module(wd)
        assert "torch" not in sys.modules and "stencil_tpu_torch" not in sys.modules
        print(wd.FAULT_RC, wd.supervise([sys.executable, "-c", "pass"], timeout_s=60).outcome)
        """
    )
    import subprocess

    p = subprocess.run([PY, "-c", code], capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.split() == ["43", "ok"]
    assert importlib.util.find_spec("stencil_tpu_torch.obs.watchdog") is not None
