"""DistributedDomain.write_paraview held to stencil_tpu's byte for byte on
the same state: one block, (2,2,2) and uneven residents, 8 positions, with
and without zero_nans, fp32 and fp64 quantities; the C++ writer
(csrc_host/paraview.cpp) held to its plain Python row loop on values that
stress the float formatting; and the apps' flags: jacobi3d --paraview
(--paraview-every) against the JAX app's files, astaroth --paraview-init /
--paraview-final."""

import os

import jax
import numpy as np
import pytest
import torch

from stencil_tpu.api import DistributedDomain as JaxDomain
from stencil_tpu.apps import jacobi3d as jax_jacobi3d
from stencil_tpu_torch import DistributedDomain
from stencil_tpu_torch.apps import astaroth, jacobi3d
from stencil_tpu_torch.ops import _native
from stencil_tpu_torch.utils import paraview

torch.set_num_threads(2)


def _field(shape, seed, dtype):
    g = np.random.default_rng(seed).standard_normal(shape).astype(dtype)
    g.flat[1] = np.nan
    g.flat[5] = np.inf
    g.flat[7] = -np.inf
    g.flat[9] = -0.0
    g.flat[11] = 1e-30
    return g


def _files(d, prefix):
    return sorted(f for f in os.listdir(d) if f.startswith(prefix + "_"))


# (label, size (x, y, z), JAX devices, port positions, partition)
LAYOUTS = [
    ("one-block", (9, 8, 7), 1, None, (1, 1, 1)),
    ("residents-222", (10, 8, 6), 1, None, (2, 2, 2)),
    ("uneven-residents", (13, 11, 9), 1, None, (2, 2, 2)),
    ("positions-8", (10, 8, 6), 8, 8, (2, 2, 2)),
]


@pytest.mark.parametrize("zero_nans", [False, True])
@pytest.mark.parametrize("label,size,jdev,tpos,part", LAYOUTS, ids=[c[0] for c in LAYOUTS])
def test_files_match_jax(tmp_path, monkeypatch, label, size, jdev, tpos, part, zero_nans):
    x, y, z = size
    fields = {"t": _field((z, y, x), 1, np.float32), "e": _field((z, y, x), 2, np.float64)}
    jd = JaxDomain(x, y, z)
    jd.set_devices(jax.devices()[:jdev])
    jd.set_partition(part)
    jd.set_radius(1)
    jh = {n: jd.add_data(n, str(f.dtype)) for n, f in fields.items()}
    jd.realize()
    td = DistributedDomain(x, y, z, device="cpu")
    if tpos:
        td.set_devices(["cpu"] * tpos)
        from stencil_tpu_torch.parallel import Method

        td.set_methods(Method.REMOTE_DMA)
    td.set_partition(part)
    td.set_radius(1)
    th = {n: td.add_data(n, str(f.dtype)) for n, f in fields.items()}
    td.realize()
    for n, f in fields.items():
        jd.set_curr_global(jh[n], f)
        td.set_curr_global(th[n], f)
    jd.write_paraview(str(tmp_path / "jax"), zero_nans=zero_nans)
    td.write_paraview(str(tmp_path / "port"), zero_nans=zero_nans)
    monkeypatch.setattr(paraview, "write", paraview.write_plain)
    td.write_paraview(str(tmp_path / "plain"), zero_nans=zero_nans)
    jf = _files(tmp_path, "jax")
    assert len(jf) == np.prod(part)
    assert [f.replace("jax", "port") for f in jf] == _files(tmp_path, "port")
    for f in jf:
        want = (tmp_path / f).read_bytes()
        assert (tmp_path / f.replace("jax", "port")).read_bytes() == want, f
        assert (tmp_path / f.replace("jax", "plain")).read_bytes() == want, f
    first = (tmp_path / jf[0]).read_text().splitlines()
    assert first[0] == "Z,Y,X,t,e"
    assert ("nan" in "".join(first)) != zero_nans


def test_native_writer_equals_plain(tmp_path):
    rng = np.random.RandomState(9)
    q = rng.randn(3, 4, 5).astype(np.float32).astype(np.float64)
    for i, v in enumerate([2.0, -0.0, 1e-12, -123456789.0, 0.0001, 1e10, 5e9, 1e16,
                           9.999999e15, 1.5e-5, 1e-4 / 3, np.nan, np.inf, -np.inf, 5e-324,
                           1.7976931348623157e308, 0.1, 1 / 3]):
        q.flat[i] = v
    q32 = rng.randn(3, 4, 5).astype(np.float32)
    for name, qs in (("mixed", [q, q32]), ("one", [q32]), ("none", [])):
        paraview.write(str(tmp_path / f"n_{name}"), "Z,Y,X", (7, 8, 9), (3, 4, 5), qs)
        paraview.write_plain(str(tmp_path / f"p_{name}"), "Z,Y,X", (7, 8, 9), (3, 4, 5), qs)
        assert (tmp_path / f"n_{name}").read_bytes() == (tmp_path / f"p_{name}").read_bytes()
    assert (tmp_path / "n_one").read_text().splitlines()[1].startswith("7,8,9,")


def test_writer_builds_into_the_build_dir():
    lib = _native.build_host("paraview")
    assert hasattr(lib, "stencil_paraview_write")
    assert _native.build_host("paraview") is lib  # built and loaded once
    built = [f for f in os.listdir(_native.BUILD_DIR) if f.startswith("libparaview-")]
    assert built


def test_writer_failure_raises(tmp_path):
    with pytest.raises(OSError, match="failed rc=-1"):
        paraview.write(str(tmp_path / "no" / "such" / "dir"), "Z,Y,X", (0, 0, 0), (1, 1, 1),
                       [np.zeros((1, 1, 1))])


def test_jacobi3d_flags_match_the_jax_app(tmp_path):
    """jacobi3d --paraview --paraview-every 2 writes the JAX app's files
    (init, every second step, final), byte for byte."""
    assert jacobi3d.main(["--x", "12", "--y", "10", "--z", "8", "--iters", "4", "--no-weak",
                          "--device", "cpu", "--paraview", "--paraview-every", "2",
                          "--prefix", str(tmp_path / "t_")]) == 0
    jax_jacobi3d.run(12, 10, 8, iters=4, weak=False, devices=jax.devices()[:1], paraview=True,
                     paraview_every=2, prefix=str(tmp_path / "j_"))
    jf = sorted(f for f in os.listdir(tmp_path) if f.startswith("j_jacobi3d"))
    assert jf == ["j_jacobi3d_2_0.txt", "j_jacobi3d_4_0.txt", "j_jacobi3d_final_0.txt",
                  "j_jacobi3d_init_0.txt"]
    for f in jf:
        assert (tmp_path / ("t_" + f[2:])).read_bytes() == (tmp_path / f).read_bytes(), f


def test_jacobi3d_paraview_over_positions(tmp_path, monkeypatch):
    r = jacobi3d.run(8, 8, 8, iters=2, weak=False, devices=["cpu"] * 8,
                     method=jacobi3d.Method.REMOTE_DMA, paraview=True,
                     prefix=str(tmp_path / "m_"))
    monkeypatch.setattr(paraview, "write", paraview.write_plain)
    r["domain"].write_paraview(str(tmp_path / "p"))
    for i in range(8):
        assert (tmp_path / f"m_jacobi3d_final_{i}.txt").read_bytes() == \
            (tmp_path / f"p_{i}.txt").read_bytes()


def test_astaroth_flags(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert astaroth.main(["1", "--nx", "8", "--device", "cpu", "--paraview-init",
                          "--paraview-final"]) == 0
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".txt")) == [
        "final_0.txt", "init_0.txt"]
    r = astaroth.run(iters=1, nx=8, device="cpu", paraview_final=True,
                     prefix=str(tmp_path / "a_"))
    monkeypatch.setattr(paraview, "write", paraview.write_plain)
    r["domain"].write_paraview(str(tmp_path / "plain"))
    text = (tmp_path / "a_final_0.txt").read_bytes()
    assert text == (tmp_path / "plain_0.txt").read_bytes()
    lines = text.decode().splitlines()
    assert lines[0] == "Z,Y,X,lnrho,uux,uuy,uuz,ax,ay,az,entropy"
    assert len(lines) == 8 ** 3 + 1
