"""The Astaroth app over a mesh of block positions, in the port against
the JAX app's multi-device run on its 8 virtual CPU devices: ``run(devices=
["cpu"] * 8, method=REMOTE_DMA, nx=8, reductions=True)`` against
``run(devices=jax.devices()[:8], nx=8, reductions=True)`` (cells, the row's
devices and processes columns, the CSV row, the reductions); the
reductions over the mesh's blocks against the JAX reductions on its 8
devices; the CLI's ``--devices``; a guarded mesh run whose rollback ends
equal to the clean run; the exchange alone; and the refusals. Tolerances
and inputs as in ``test_torch_astaroth_mesh.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stencil_tpu.apps.astaroth as japp
import stencil_tpu_torch.apps.astaroth as tapp
from stencil_tpu.astaroth.reductions import Reductions as JReductions
from stencil_tpu.parallel import HaloExchange as JHaloExchange
from stencil_tpu_torch import HaloExchange
from stencil_tpu_torch.astaroth.integrate import FIELDS
from stencil_tpu_torch.astaroth.reductions import Reductions
from stencil_tpu_torch.geometry import Dim3
from stencil_tpu_torch.parallel import DeviceMesh, Method, split_positions
from test_torch_astaroth_mesh import jax_mesh
from test_torch_astaroth_resident import TOL, specs

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8


def test_app_on_8_positions_matches_jax_app():
    """16^3 over 8 positions of 8^3 at dt 1e-5 (the hash init's
    cancellation, ``test_torch_astaroth.py``), 2 iterations and the
    warm-up: every cell within 1e-10, the reductions, and the row: 8
    devices, 1 process, the CSV's first four columns the JAX app's."""
    got = tapp.run(devices=CPU8, method=Method.REMOTE_DMA, nx=8, iters=2, dt=1e-5,
                   reductions=True)
    want = japp.run(iters=2, nx=8, devices=jax.devices()[:8], dt=1e-5, reductions=True)
    assert got["global"] == Dim3(16, 16, 16) and tuple(want["global"]) == (16, 16, 16)
    assert (got["devices"], got["processes"]) == (want["devices"], want["processes"]) == (8, 1)
    assert tapp.csv_row(got).split(",")[:4] == japp.csv_row(want).split(",")[:4] == \
        ["8", "8", "8", "8"]
    assert len(got["domain"].mesh) == 8 and got["iters_run"] == 2
    for k in FIELDS:
        a = got["domain"].get_curr_global(got["handles"][k])
        b = want["domain"].get_curr_global(want["handles"][k])
        np.testing.assert_allclose(a, b, err_msg=k, **TOL[np.float64])
    for q in ("lnrho", "uu"):
        for stat, v in want["reductions"][q].items():
            assert got["reductions"][q][stat] == pytest.approx(v, rel=1e-10, abs=1e-300), (q, stat)


def test_app_on_2_positions_is_the_resident_run():
    """``devices`` of 2 grows the domain by decompose_zyx(2) = (1,1,2), as
    the JAX app does; its cells are the (1,1,2) resident run's, and its
    reductions within 1e-12 of them."""
    kw = dict(nx=8, iters=2, dt=1e-5, reductions=True)
    got = tapp.run(devices=["cpu"] * 2, method=Method.REMOTE_DMA, **kw)
    res = tapp.run(device="cpu", partition=(1, 1, 2), **kw)
    assert got["global"] == Dim3(8, 8, 16) and got["domain"].spec.dim == Dim3(1, 1, 2)
    assert tapp.csv_row(got).split(",")[:4] == tapp.csv_row(res).split(",")[:4] == \
        ["2", "8", "8", "8"]
    for k in FIELDS:
        np.testing.assert_array_equal(got["domain"].get_curr_global(got["handles"][k]),
                                      res["domain"].get_curr_global(res["handles"][k]))
    for q in ("lnrho", "uu"):  # the sums add the positions' partial sums
        for stat, v in res["reductions"][q].items():
            assert got["reductions"][q][stat] == pytest.approx(v, rel=1e-12), (q, stat)


@pytest.mark.parametrize("size", [(16, 16, 16), (19, 18, 16)], ids=["uniform", "uneven"])
def test_reductions_over_positions_match_jax(size):
    """Scalar and vector reductions over the 8 positions' blocks, with
    garbage in the halos, pad and (uneven) dead tails, against the JAX
    reductions over its 8 devices."""
    ts, js = specs(size, (2, 2, 2))
    mesh, jm = DeviceMesh(Dim3(2, 2, 2), CPU8), jax_mesh((2, 2, 2))
    rng = np.random.RandomState(7)
    arrs = [rng.randn(*ts.stacked_shape_zyx()) * 10 for _ in range(3)]
    red = Reductions(HaloExchange(ts, Method.REMOTE_DMA, mesh=mesh))
    jex = JHaloExchange(js, jm)
    jred = JReductions(jex)
    pos = [split_positions(torch.from_numpy(a), ts, mesh) for a in arrs]
    jarr = [jax.device_put(jnp.asarray(a), jex.sharding()) for a in arrs]
    got = {"s": red.scal(pos[0]), "v": red.vec(*pos)}
    want = {"s": jred.scal(jarr[0]), "v": jred.vec(*jarr)}
    for q in ("s", "v"):
        for stat, v in want[q].items():
            assert got[q][stat] == pytest.approx(v, rel=1e-12), (q, stat)


def test_cli_devices(capsys):
    assert tapp.main(["2", "--nx", "8", "--devices", "cpu,cpu", "--reductions"]) == 0
    row = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert row[:4] == ["2", "8", "8", "8"] and float(row[4]) > 0
    with pytest.raises(SystemExit):
        tapp.main(["2", "--nx", "8", "--devices", "cpu,cpu", "--device", "cpu"])


def test_guarded_mesh_rollback_matches_clean_run(tmp_path, capsys):
    """A NaN injected at step 2 of a run over 8 positions rolls back to the
    step-1 snapshot and the run ends bit-equal to the clean one."""
    kw = dict(devices=CPU8, method=Method.REMOTE_DMA, nx=8, iters=3, chunk=1, dt=1e-5)
    got = tapp.run(ckpt_dir=str(tmp_path / "g"), ckpt_every=1, health_every=1,
                   inject="nan@2:q=lnrho", rollback_backoff=0.01, **kw)
    assert "rolled back from step 2 to checkpointed step 1" in capsys.readouterr().err
    clean = tapp.run(ckpt_dir=str(tmp_path / "c"), **kw)
    assert got["iters_run"] == 3 and got["devices"] == 8
    for k in FIELDS:
        a = got["domain"].get_curr_global(got["handles"][k])
        assert np.isfinite(a).all(), k
        np.testing.assert_array_equal(a, clean["domain"].get_curr_global(clean["handles"][k]))


def test_no_compute_and_resume_over_positions(tmp_path):
    """The exchange alone over the mesh, and a run resumed from the mesh
    run's final snapshot continues it."""
    r = tapp.run(devices=CPU8, method=Method.REMOTE_DMA, nx=8, iters=2, no_compute=True)
    assert r["iter_trimean_s"] > 0 and r["exch_trimean_s"] > 0
    kw = dict(devices=CPU8, method=Method.REMOTE_DMA, nx=8, dt=1e-5, chunk=1,
              ckpt_dir=str(tmp_path / "k"))
    tapp.run(iters=2, **kw)
    resumed = tapp.run(iters=3, resume=True, **kw)
    assert resumed["iters_run"] == 1


def test_app_mesh_refusals(monkeypatch):
    """``devices`` with ``partition`` or ``device`` raise. The app's default
    method over ``devices`` is now the JAX app's, AXIS_COMPOSED (copies
    between positions), and its fields equal the REMOTE_DMA run's. Over
    positions of several processes the step runs on this rank's positions:
    rank 0's step of a mesh split over 2 ranks, its exchange's messages
    already in the halos, equals the one-process step there and leaves the
    other rank's positions alone (the spawn across processes is
    ``test_torch_astaroth_multiprocess.py``)."""
    with pytest.raises(ValueError, match="devices= alone"):
        tapp.run(devices=CPU8, method=Method.REMOTE_DMA, nx=8, iters=1, partition=(2, 2, 2))
    with pytest.raises(ValueError, match="devices= alone"):
        tapp.run(devices=CPU8, method=Method.REMOTE_DMA, nx=8, iters=1, device="cpu")
    runs = [tapp.run(devices=CPU8, nx=8, iters=1, chunk=1, **kw)
            for kw in ({}, dict(method=Method.REMOTE_DMA))]
    assert runs[0]["domain"].halo_exchange.method == Method.AXIS_COMPOSED
    for k in FIELDS:
        a, b = (r["domain"].get_curr_global(r["handles"][k]) for r in runs)
        np.testing.assert_array_equal(a, b, err_msg=k)
    from stencil_tpu_torch.astaroth.integrate import make_astaroth_step
    from stencil_tpu_torch.domain import GridSpec
    from stencil_tpu_torch.geometry import Radius
    from stencil_tpu_torch.parallel.distributed import Position

    mesh = DeviceMesh((2, 2, 2), [Position(i, i // 4, "h", "cpu") for i in range(8)])
    assert mesh.multi_process and mesh.local_positions() == (0, 1, 2, 3)
    spec = GridSpec(Dim3(16, 16, 16), Dim3(2, 2, 2), Radius.constant(3))
    ex = HaloExchange(spec, Method.AXIS_COMPOSED, mesh=mesh)
    moved = []
    # the messages over gloo: already in the halos (the one-process exchange below)
    monkeypatch.setattr(type(ex._remote), "_gloo_round",
                        lambda self, state, keys, rnd: moved.append(rnd.step))
    one_ex = HaloExchange(spec, Method.AXIS_COMPOSED, mesh=DeviceMesh((2, 2, 2), CPU8))
    curr = {k: split_positions(torch.from_numpy(np.random.RandomState(i).rand(
        *spec.stacked_shape_zyx()) * 0.1 + (0.5 if k == "lnrho" else 0.0)), spec, one_ex.mesh)
            for i, k in enumerate(FIELDS)}
    one_ex(curr)
    nxt = {k: [torch.zeros_like(b) for b in v] for k, v in curr.items()}
    want = make_astaroth_step(one_ex, tapp.load(nx=8), dt=1e-5, overlap=False, dtype="float64")(
        {k: [b.clone() for b in v] for k, v in curr.items()},
        {k: [b.clone() for b in v] for k, v in nxt.items()})[0]
    mine = {k: [b if i < 4 else None for i, b in enumerate(v)] for k, v in curr.items()}
    got = make_astaroth_step(ex, tapp.load(nx=8), dt=1e-5, overlap=False, dtype="float64")(
        mine, {k: [b if i < 4 else None for i, b in enumerate(v)] for k, v in nxt.items()})[0]
    assert moved == [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
    for k in FIELDS:
        assert got[k][4:] == [None] * 4
        for i in range(4):
            assert torch.equal(got[k][i], want[k][i]), (k, i)
