"""The port's checkpoints (stencil_tpu_torch/ckpt/) against the JAX
package's: a snapshot written by either package restores bit-identically
through the other (tenant snapshots as the campaign writes them, a
multi-block partition, and a DistributedDomain's asynchronous save restored
by the other package's domain onto another partition), manifests validate
under both, and the filesystem protocol (rename, LATEST, retention,
validation, quarantine) behaves as in tests/test_ckpt.py. Mostly bare
GridSpecs and numpy state; the domains run on the CPU."""

import os
import shutil

import numpy as np
import pytest

import stencil_tpu.ckpt as jckpt
import stencil_tpu.domain.grid as jgrid
import stencil_tpu.geometry as jgeo
import stencil_tpu_torch.ckpt as tckpt
import stencil_tpu_torch.domain.grid as tgrid
import stencil_tpu_torch.geometry as tgeo
from stencil_tpu_torch.ckpt import (QUARANTINE_PREFIX, find_resume, list_snapshots, load_manifest,
                                    quarantine_snapshot, read_latest, snapshot_name, step_of,
                                    validate_snapshot, write_snapshot)
from stencil_tpu_torch.ckpt.snapshot import _write_latest

PKGS = {"port": (tckpt, tgrid, tgeo), "jax": (jckpt, jgrid, jgeo)}


def spec_of(pkg, size, part, radius=1, aligned=True):
    _, grid, geo = PKGS[pkg]
    return grid.GridSpec(geo.Dim3(*size), geo.Dim3(*part), geo.Radius.constant(radius),
                         aligned=aligned)


def host_state(spec, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return {"q": rng.rand(*spec.stacked_shape_zyx()).astype(dtype)}


def interior(spec, state):
    """The global [z,y,x] interior of a stacked host state."""
    g, off = spec.global_size, spec.compute_offset()
    out = np.empty((g.z, g.y, g.x), state.dtype)
    for iz in range(spec.dim.z):
        for iy in range(spec.dim.y):
            for ix in range(spec.dim.x):
                o, s = spec.block_origin((ix, iy, iz)), spec.block_size((ix, iy, iz))
                out[o.z:o.z + s.z, o.y:o.y + s.y, o.x:o.x + s.x] = state[
                    iz, iy, ix, off.z:off.z + s.z, off.y:off.y + s.y, off.x:off.x + s.x]
    return out


def domain_of(pkg, size, part, dtype):
    """A realized radius-1 domain of ``pkg`` on one CPU device with every
    block of ``part`` resident, and its ``temperature`` handle."""
    from stencil_tpu.api import DistributedDomain as JDomain
    from stencil_tpu_torch import DistributedDomain

    dd = DistributedDomain(*size, device="cpu") if pkg == "port" else JDomain(*size)
    dd.set_radius(1)
    dd.set_partition(part)
    if pkg == "jax":
        import jax

        dd.set_devices(jax.devices()[:1])
    h = dd.add_data("temperature", np.dtype(dtype).name)
    dd.realize()
    return dd, h


@pytest.mark.parametrize("via", ["files", "domain"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("size,part,aligned", [((12, 10, 8), (1, 1, 1), False),
                                               ((16, 12, 8), (2, 2, 1), True)])
@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_snapshots_restore_across_packages(tmp_path, writer, reader, size, part, aligned, dtype,
                                           via):
    """``files``: the one-block unaligned case is a campaign tenant's
    snapshot; the reader's find_resume (with the campaign driver's compatibility
    check) and assemble_global give back the writer's interior bit for bit,
    and the manifest validates under both packages. ``domain``: the
    writer's DistributedDomain.save_checkpoint (the asynchronous writer)
    and the reader's restore_checkpoint onto another partition (elastic:
    one block <-> residents)."""
    d = str(tmp_path)
    if via == "domain":
        g = np.random.RandomState(5).rand(*size[::-1]).astype(dtype)
        wdd, wh = domain_of(writer, size, part, dtype)
        wdd.set_curr_global(wh, g)
        wdd.save_checkpoint(d, 2, keep=3)
        wdd.finish_checkpoints()
        rdd, rh = domain_of(reader, size, (1, 1, 2) if part == (1, 1, 1) else (1, 1, 1), dtype)
        assert rdd.restore_checkpoint(d) == 2
        assert rdd.get_curr_global(rh).tobytes() == g.tobytes()
        snap = os.path.join(d, snapshot_name(2))
        assert tckpt.validate_snapshot(snap) == jckpt.validate_snapshot(snap) == []
        return
    wspec = spec_of(writer, size, part, aligned=aligned)
    state = host_state(wspec, 3, dtype)
    PKGS[writer][0].write_snapshot(d, 2, wspec, {"temperature": state["q"]},
                                   dtypes={"temperature": np.dtype(dtype).name}, keep=3)
    ck, _, geo = PKGS[reader]
    found = ck.find_resume(d, accept=lambda m: ck.check_compatible(
        m, geo.Dim3(*size), ["temperature"], [np.dtype(dtype).name]))
    assert found is not None
    snap, manifest = found
    assert manifest["step"] == 2
    assert tckpt.validate_snapshot(snap) == jckpt.validate_snapshot(snap) == []
    assert tckpt.validate_manifest(manifest) == jckpt.validate_manifest(manifest) == []
    got = ck.assemble_global(snap, manifest, "temperature", dtype=np.dtype(dtype))
    assert got.dtype == np.dtype(dtype)
    assert got.tobytes() == interior(wspec, state["q"]).tobytes()
    # a different size or dtype is refused by both packages alike
    for c in (tckpt, jckpt):
        assert c.check_compatible(manifest, geo.Dim3(*size), ["temperature"], ["float16"])


def test_manifests_of_both_packages_agree(tmp_path):
    """The same state written by each package: identical manifests apart
    from the write time, identical payload arrays."""
    ms = {}
    for pkg in PKGS:
        spec = spec_of(pkg, (8, 6, 4), (2, 1, 1))
        snap = PKGS[pkg][0].write_snapshot(str(tmp_path / pkg), 7, spec, host_state(spec),
                                           keep=1)
        ms[pkg] = (snap, load_manifest(snap))
    (ps, pm), (js, jm) = ms["port"], ms["jax"]
    for m in (pm, jm):
        m.pop("written_t")
        for fe in m["files"]:
            fe.pop("sha256"), fe.pop("bytes")  # zip entries carry their write time
    assert pm == jm
    for fe in pm["files"]:
        a, b = np.load(os.path.join(ps, fe["path"])), np.load(os.path.join(js, fe["path"]))
        assert a["q"].tobytes() == b["q"].tobytes()


# -- the filesystem protocol, as tests/test_ckpt.py pins it --------------------------


def small_spec():
    return spec_of("port", (8, 6, 4), (2, 1, 1))


def test_write_protocol_latest_and_retention(tmp_path):
    spec = small_spec()
    d = str(tmp_path)
    for step in (1, 2, 3, 4, 5):
        write_snapshot(d, step, spec, host_state(spec, step), keep=3)
    assert list_snapshots(d) == [snapshot_name(s) for s in (3, 4, 5)]
    assert read_latest(d) == snapshot_name(5)
    assert step_of(snapshot_name(5)) == 5
    for s in (3, 4, 5):
        assert validate_snapshot(os.path.join(d, snapshot_name(s))) == []


def test_rewrite_same_step_never_deletes_before_publish(tmp_path):
    spec = small_spec()
    d = str(tmp_path)
    write_snapshot(d, 2, spec, host_state(spec, 1), keep=3)
    old = np.load(os.path.join(d, snapshot_name(2), "block_0_0_0.npz"))["q"]
    write_snapshot(d, 2, spec, host_state(spec, 9), keep=3)
    new = np.load(os.path.join(d, snapshot_name(2), "block_0_0_0.npz"))["q"]
    assert not np.array_equal(old, new)
    assert validate_snapshot(os.path.join(d, snapshot_name(2))) == []
    assert list_snapshots(d) == [snapshot_name(2)]
    assert not [e for e in os.listdir(d) if e.startswith(".tmp-")]


def test_truncated_missing_and_corrupt_payloads(tmp_path):
    spec = small_spec()
    d = str(tmp_path)
    write_snapshot(d, 1, spec, host_state(spec, 1), keep=5)
    write_snapshot(d, 2, spec, host_state(spec, 2), keep=5)
    with open(os.path.join(d, snapshot_name(2), "block_0_0_0.npz"), "r+b") as f:
        f.truncate(10)
    errs = validate_snapshot(os.path.join(d, snapshot_name(2)))
    assert errs and "truncated" in errs[0]
    assert find_resume(d)[1]["step"] == 1
    assert read_latest(d) == snapshot_name(2)

    snap = write_snapshot(d, 3, spec, host_state(spec), keep=5)
    os.remove(os.path.join(snap, "block_0_0_1.npz"))
    assert any("missing payload" in e for e in validate_snapshot(snap))
    snap4 = write_snapshot(d, 4, spec, host_state(spec), keep=5)
    path = os.path.join(snap4, "block_0_0_0.npz")
    with open(path, "r+b") as f:  # same size, flipped bytes
        f.seek(os.path.getsize(path) // 2)
        f.write(b"\xff\xff\xff\xff")
    assert any("SHA-256 mismatch" in e for e in validate_snapshot(snap4))
    assert validate_snapshot(snap4, deep=False) == []


def test_resume_ignores_tmp_dirs_and_lagging_or_dangling_latest(tmp_path):
    spec = small_spec()
    d = str(tmp_path)
    write_snapshot(d, 1, spec, host_state(spec, 1), keep=5)
    os.makedirs(os.path.join(d, ".tmp-step-00000099-123"))
    assert list_snapshots(d) == [snapshot_name(1)]
    write_snapshot(d, 2, spec, host_state(spec, 2), keep=5)
    _write_latest(d, snapshot_name(1))  # a crash between publish and pointer
    assert find_resume(d)[1]["step"] == 2
    shutil.rmtree(os.path.join(d, snapshot_name(2)))
    assert find_resume(d)[1]["step"] == 1


def test_manifest_contents(tmp_path):
    spec = small_spec()
    m = load_manifest(write_snapshot(str(tmp_path), 7, spec, host_state(spec), keep=1))
    assert m["v"] == 1 and m["kind"] == "stencil-ckpt" and m["step"] == 7
    assert m["global"] == {"x": 8, "y": 6, "z": 4}
    assert m["partition"] == {"x": 2, "y": 1, "z": 1}
    assert [q["name"] for q in m["quantities"]] == ["q"]
    assert len(m["files"]) == spec.num_blocks()
    for fe in m["files"]:
        ix, iy, iz = fe["block"]
        s = spec.block_size((ix, iy, iz))
        assert fe["bytes"] > 0 and len(fe["sha256"]) == 64 and fe["size"] == [s.x, s.y, s.z]


def test_quarantine_invalid_snapshot(tmp_path):
    spec = small_spec()
    d = str(tmp_path)
    write_snapshot(d, 1, spec, host_state(spec, 1), keep=5)
    write_snapshot(d, 2, spec, host_state(spec, 2), keep=5)
    with open(os.path.join(d, snapshot_name(2), "block_0_0_0.npz"), "r+b") as f:
        f.truncate(10)
    assert quarantine_snapshot(d, snapshot_name(2), reason="truncated") is not None
    assert list_snapshots(d) == [snapshot_name(1)]
    qdirs = [e for e in os.listdir(d) if e.startswith(QUARANTINE_PREFIX)]
    assert len(qdirs) == 1 and snapshot_name(2) in qdirs[0]
    assert os.path.isfile(os.path.join(d, qdirs[0], "QUARANTINED.txt"))
    assert read_latest(d) == snapshot_name(1)
    assert find_resume(d)[1]["step"] == 1
    assert quarantine_snapshot(d, snapshot_name(1), reason="test") is not None
    assert read_latest(d) is None and find_resume(d) is None
    assert quarantine_snapshot(d, snapshot_name(9)) is None
