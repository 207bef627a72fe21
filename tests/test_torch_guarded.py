"""The guarded main path of the port (jacobi3d and astaroth under
fault.run_guarded, with DistributedDomain's checkpoints and health check)
against the JAX package's apps on the CPU, as tests/test_fault_e2e.py and
tests/test_ckpt_resume.py pin the JAX side:

- an injected NaN is caught, rolled back to the newest snapshot and
  recomputed: the run ends bit-identical to its clean run and to the JAX
  app's guarded run with the same flags, on one block, on a (2,2,2)
  resident partition and on a mesh of 2 positions, and no durable snapshot
  is poisoned (the check precedes every save);
- a truncated newest snapshot falls back to the one before;
- exhaustion exits 43 with an evidence bundle; a max-abs ceiling fires;
- astaroth's 8-field rollback is within 1e-10 (fp64) of the JAX app's;
- a child killed right after a durable snapshot resumes from it and ends
  equal to an uninterrupted run; the headline leg runs small, and resumes;
- ckpt_tool's validate and diff agree with the JAX tool's.

Tolerance: bit-exact for jacobi, 1e-10 for astaroth in fp64."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import stencil_tpu.apps.astaroth as jasta
import stencil_tpu.apps.ckpt_tool as jtool
import stencil_tpu.apps.jacobi3d as japp
import stencil_tpu.parallel as jpar
import stencil_tpu_torch.apps.astaroth as tasta
import stencil_tpu_torch.apps.bench_headline as headline
import stencil_tpu_torch.apps.ckpt_tool as ttool
import stencil_tpu_torch.apps.jacobi3d as tapp
import stencil_tpu_torch.parallel as tpar
from stencil_tpu_torch.astaroth.integrate import FIELDS
from stencil_tpu_torch.ckpt import assemble_global, find_resume, list_snapshots, load_manifest
from stencil_tpu_torch.fault import FAULT_RC, RecoveryExhausted

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 24
LAYOUTS = {
    "one-block": (dict(device="cpu"), dict(devices=jax.devices()[:1])),
    "resident-2x2x2": (dict(device="cpu", partition=(2, 2, 2), deep_halo=2),
                       dict(devices=jax.devices()[:1], partition=(2, 2, 2), deep_halo=2)),
    "mesh-2": (dict(devices=["cpu"] * 2, method=tpar.Method.REMOTE_DMA),
               dict(devices=jax.devices()[:2], method=jpar.Method.REMOTE_DMA)),
}


def guarded(run, tmp, sub, layout_kw, **kw):
    kw.setdefault("iters", 6)
    kw.setdefault("ckpt_every", 2)
    kw.setdefault("health_every", 2)
    return run(SIZE, SIZE, SIZE, weak=False, warmup=1, ckpt_dir=os.path.join(str(tmp), sub),
               rollback_backoff=0.01, **layout_kw, **kw)


def final(r):
    return r["domain"].get_curr_global(r["handle"])


def durable_snapshots_finite(ckpt_dir):
    names = list_snapshots(ckpt_dir)
    assert names
    for name in names:
        snap = os.path.join(ckpt_dir, name)
        arr = assemble_global(snap, load_manifest(snap), "temperature")
        assert np.isfinite(arr).all(), f"poisoned snapshot {name}"


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_jacobi_rollback_matches_clean_run_and_jax(tmp_path, layout, capsys):
    tkw, jkw = LAYOUTS[layout]
    clean = final(guarded(tapp.run, tmp_path, "clean", tkw))
    capsys.readouterr()
    r = guarded(tapp.run, tmp_path, "port", tkw, inject="nan@3")
    assert "rolled back from step 4 to checkpointed step 2" in capsys.readouterr().err
    want = final(guarded(japp.run, tmp_path, "jax", jkw, inject="nan@3"))
    assert np.isfinite(clean).all()
    np.testing.assert_array_equal(final(r), clean)
    np.testing.assert_array_equal(final(r), want)
    assert r["health_checks"] >= 4 and r["loop_wall_s"] > 0
    durable_snapshots_finite(os.path.join(str(tmp_path), "port"))
    # each package's final snapshot holds the same field
    for sub in ("port", "jax"):
        snap, m = find_resume(os.path.join(str(tmp_path), sub))
        assert m["step"] == 6
        np.testing.assert_array_equal(assemble_global(snap, m, "temperature"), clean)


def test_jacobi_truncated_newest_snapshot_falls_back(tmp_path, capsys):
    """ckpt-truncate@5 spoils the step-4 snapshot right before the step-5
    fault: the rollback skips it to step 2 and the run ends as the clean
    one."""
    kw = LAYOUTS["one-block"][0]
    clean = final(guarded(tapp.run, tmp_path, "clean", kw))
    capsys.readouterr()
    r = guarded(tapp.run, tmp_path, "ck", kw, inject="ckpt-truncate@5,nan@5")
    err = capsys.readouterr().err
    assert "skipping invalid snapshot step-00000004" in err
    assert "to checkpointed step 2" in err
    np.testing.assert_array_equal(final(r), clean)
    want = guarded(japp.run, tmp_path, "jax", LAYOUTS["one-block"][1],
                   inject="ckpt-truncate@5,nan@5")
    np.testing.assert_array_equal(final(r), final(want))


def test_jacobi_exhaustion_and_divergence(tmp_path, monkeypatch, capsys):
    ck = str(tmp_path / "ck")
    rc = tapp.main(["--x", "16", "--y", "16", "--z", "16", "--no-weak", "--iters", "6",
                    "--device", "cpu", "--ckpt-dir", ck, "--ckpt-every", "2",
                    "--health-every", "2", "--inject", "nan@3:repeat=always",
                    "--max-rollbacks", "1", "--rollback-backoff", "0.01"])
    assert rc == FAULT_RC == 43
    ev = json.load(open(os.path.join(ck, "fault-evidence.json")))
    assert ev["rc"] == 43 and ev["app"] == "jacobi3d"
    assert sum(ev["rollbacks"].values()) == 2 and "max rollbacks (1)" in ev["reason"]
    # a ceiling below the initial temperature faults at the first check;
    # with no checkpoints there is nothing to roll back to
    monkeypatch.setenv("STENCIL_FAULT_EVIDENCE", str(tmp_path / "evidence.json"))
    with pytest.raises(RecoveryExhausted) as ei:
        tapp.run(12, 12, 12, iters=4, weak=False, device="cpu", health_every=2, max_abs=1e-3)
    assert ei.value.fault.kind == "divergence"
    assert "cannot roll back" in ei.value.reason
    assert os.path.isfile(str(tmp_path / "evidence.json"))


def test_env_activation_and_domain_health_check(tmp_path, monkeypatch, capsys):
    """STENCIL_FAULT_INJECT / STENCIL_FAULT_SEED schedule the faults of a run
    given no --inject, as in the JAX package; DistributedDomain.check_health
    names the faulting quantity as the JAX domain's does."""
    from stencil_tpu.api import DistributedDomain as JDomain
    from stencil_tpu.fault import NumericalFault as JFault
    from stencil_tpu_torch import DistributedDomain
    from stencil_tpu_torch.fault import NumericalFault

    kw = LAYOUTS["one-block"][0]
    clean = final(guarded(tapp.run, tmp_path, "clean", kw))
    monkeypatch.setenv("STENCIL_FAULT_INJECT", "nan@3")
    monkeypatch.setenv("STENCIL_FAULT_SEED", "5")
    capsys.readouterr()
    r = guarded(tapp.run, tmp_path, "env", kw)
    assert "rolled back from step 4 to checkpointed step 2" in capsys.readouterr().err
    np.testing.assert_array_equal(final(r), clean)
    monkeypatch.delenv("STENCIL_FAULT_INJECT")
    g = np.full((8, 10, 12), 0.5)
    g[3, 4, 5] = np.inf
    faults = []
    for dd, devs in ((DistributedDomain(12, 10, 8, device="cpu"), None),
                     (JDomain(12, 10, 8), jax.devices()[:1])):
        if devs:
            dd.set_devices(devs)
        dd.set_radius(1)
        ha, hb = dd.add_data("a", "float32"), dd.add_data("b", "float64")
        dd.realize()
        dd.set_curr_global(ha, np.zeros_like(g))
        dd.set_curr_global(hb, g)
        with pytest.raises((NumericalFault, JFault)) as ei:
            dd.check_health(step=7)
        faults.append((ei.value.kind, ei.value.quantity, ei.value.step))
        dd.set_curr_global(hb, np.full_like(g, -3.0))
        dd.check_health()
        with pytest.raises((NumericalFault, JFault)) as ei:
            dd.check_health(max_abs=2.0)
        faults.append((ei.value.kind, ei.value.quantity, ei.value.value))
    assert faults[:2] == faults[2:] == [("nonfinite", "b", 7), ("divergence", "b", 3.0)]


def test_astaroth_rollback_matches_jax(tmp_path, capsys):
    kw = dict(iters=3, nx=12, dtype="float64", chunk=1, ckpt_every=1, health_every=1,
              inject="nan@2:q=lnrho", rollback_backoff=0.01, dt=1e-5)
    got = tasta.run(device="cpu", ckpt_dir=str(tmp_path / "port"), **kw)
    assert "rolled back from step 2 to checkpointed step 1" in capsys.readouterr().err
    want = jasta.run(devices=jax.devices()[:1], ckpt_dir=str(tmp_path / "jax"), **kw)
    clean = tasta.run(device="cpu", nx=12, iters=3, chunk=1, dt=1e-5,
                      ckpt_dir=str(tmp_path / "clean"))
    for k in FIELDS:
        a = got["domain"].get_curr_global(got["handles"][k])
        b = want["domain"].get_curr_global(want["handles"][k])
        assert np.isfinite(a).all(), k
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10, err_msg=k)
        np.testing.assert_array_equal(a, clean["domain"].get_curr_global(clean["handles"][k]))
    assert got["iters_run"] == 3
    assert [load_manifest(os.path.join(str(tmp_path / "port"), n))["step"]
            for n in list_snapshots(str(tmp_path / "port"))] == [1, 2, 3]


def _jacobi_child(ckpt_dir, resume=False, kill_after=None, iters=4):
    cmd = [sys.executable, "-m", "stencil_tpu_torch.apps.jacobi3d", "--device", "cpu",
           "--x", "16", "--y", "12", "--z", "12", "--no-weak", "--iters", str(iters),
           "--ckpt-dir", ckpt_dir, "--ckpt-every", "2"] + (["--resume"] if resume else [])
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("STENCIL_CKPT_KILL_AFTER_SAVE", None)
    if kill_after is not None:
        env["STENCIL_CKPT_KILL_AFTER_SAVE"] = str(kill_after)
    return subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=280)


def test_killed_child_resumes_from_checkpoint(tmp_path):
    ck, ref = str(tmp_path / "ck"), str(tmp_path / "ref")
    p1 = _jacobi_child(ck, kill_after=2)
    assert p1.returncode == 17, p1.stderr
    found = find_resume(ck)
    assert found is not None and found[1]["step"] == 2
    p2 = _jacobi_child(ck, resume=True)
    assert p2.returncode == 0, p2.stderr
    assert "resuming from checkpointed step 2" in p2.stderr
    assert p2.stdout.strip().splitlines()[-1].startswith("jacobi3d,")
    assert find_resume(ck)[1]["step"] == 4
    assert _jacobi_child(ref).returncode == 0
    # the resumed run's final snapshot is bit-equal to the uninterrupted one's
    assert ttool.main(["diff", "--data", ck, ref]) == 0


def test_headline_leg_small_and_resumed(tmp_path, monkeypatch, capsys):
    assert headline.main(["--device", "cpu", "--size", "16", "--chunk", "3"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["metric"] == "jacobi3d_16_mcells_per_s_per_gpu" and row["unit"] == "Mcells/s"
    assert row["value"] > 0 and row["health_checks"] == 3 and row["device"] == "cpu"
    assert row["loop_wall_s"] > 0 and row["iter_trimean_s"] > 0
    monkeypatch.setenv("STENCIL_BENCH_CKPT_DIR", str(tmp_path))
    for _ in range(2):  # a fresh leg, then a resume that finds it complete
        assert headline.main(["--device", "cpu", "--size", "16", "--chunk", "3",
                              "--resume"]) == 0
        row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert np.isfinite(row["iter_trimean_s"]) and row["health_checks"] == 3
    assert find_resume(str(tmp_path / "jacobi16"))[1]["step"] == 9


def test_ckpt_tool_agrees_with_jax_tool(tmp_path, capsys):
    """validate and diff --data of the two tools on a port snapshot, a JAX
    snapshot of the same run, and a truncated one."""
    kw = dict(iters=4, ckpt_every=2, health_every=0)
    guarded(tapp.run, tmp_path, "port", LAYOUTS["one-block"][0], **kw)
    guarded(japp.run, tmp_path, "jax", LAYOUTS["one-block"][1], **kw)
    port, jaxd = str(tmp_path / "port"), str(tmp_path / "jax")
    bad = os.path.join(port, list_snapshots(port)[0])
    with open(os.path.join(bad, load_manifest(bad)["files"][0]["path"]), "r+b") as f:
        f.truncate(10)
    for argv in (["validate", "--all", port], ["validate", "--all", jaxd],
                 ["validate", bad], ["diff", "--data", port, jaxd],
                 ["diff", "--data", port, os.path.join(jaxd, list_snapshots(jaxd)[0])],
                 ["inspect", port]):
        rc_t = ttool.main(argv)
        out_t = capsys.readouterr().out
        rc_j = jtool.main(argv)
        out_j = capsys.readouterr().out
        assert (rc_t, out_t) == (rc_j, out_j), argv
    assert ttool.main(["validate", bad]) == 1 and ttool.main(["diff", "--data", port, jaxd]) == 0
