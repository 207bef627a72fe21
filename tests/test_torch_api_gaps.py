"""The small API and app surface carried over from the JAX package, in the
port against it on the CPU: ``domain.LocalBlock`` (tests/test_local_block.py's
cases, and a JAX block carried across), ``DistributedDomain.run_exchanges``,
``write_plan`` and ``set_output_prefix`` (byte-identical files, direct26 and
resident partitions included), jacobi3d's ``--prefix`` and
``--multistep-rows``, ``set_quantity_batching`` with astaroth's
``--per-quantity-exchange``, and astaroth's ``--kernel-variant`` and
``--no-pallas``. Inputs are numpy arrays from a seed with explicit dtypes.
Tolerance: bit-exact, and byte-identical files."""

import filecmp

import jax
import numpy as np
import pytest
import torch

import stencil_tpu.api as japi
import stencil_tpu.domain as jdom
import stencil_tpu.geometry as jgeo
import stencil_tpu.parallel as jpar
import stencil_tpu_torch.apps.astaroth as tast
import stencil_tpu_torch.apps.jacobi3d as tapp
import stencil_tpu_torch.geometry as tgeo
import stencil_tpu_torch.ops.jacobi as tjac
import stencil_tpu_torch.parallel as tpar
from stencil_tpu_torch import DistributedDomain
from stencil_tpu_torch.convert import block_from_jax
from stencil_tpu_torch.domain import LocalBlock, block_compute_slices, block_rect_slices

torch.set_num_threads(2)


def asym(geo):
    r = geo.Radius.constant(0)
    r.set_dir((1, 0, 0), 2)
    r.set_dir((-1, 0, 0), 1)
    return r


# -- LocalBlock -------------------------------------------------------------------------

@pytest.mark.parametrize("size,rad", [((3, 4, 5), "asym"), ((30, 40, 50), 4), ((4, 4, 4), 1)])
def test_local_block_geometry_matches_jax(size, rad):
    """raw_size, compute slices and every direction's halo and interior-edge
    region."""
    tr, jr = ((asym(tgeo), asym(jgeo)) if rad == "asym"
              else (tgeo.Radius.constant(rad), jgeo.Radius.constant(rad)))
    t = LocalBlock(size, (0, 0, 0), tr, device="cpu")
    j = jdom.LocalBlock(size, (0, 0, 0), jr)
    assert t.raw_size().as_tuple() == j.raw_size().as_tuple()
    assert t.compute_slices() == j.compute_slices() == block_compute_slices(size, tr)
    for d in tgeo.DIRECTIONS_26:
        for halo in (True, False):
            a, b = t.halo_region(d, halo), j.halo_region((d.x, d.y, d.z), halo)
            assert (a.lo.as_tuple(), a.hi.as_tuple()) == (b.lo.as_tuple(), b.hi.as_tuple())
            assert block_rect_slices(a) == jdom.block_rect_slices(b)


def test_local_block_data_matches_jax():
    """tests/test_local_block.py's data cases: curr != next, the swap, the
    region and interior copies to the host, per-quantity dtypes."""
    b = LocalBlock((3, 4, 5), (0, 0, 0), asym(tgeo), device="cpu")
    h = b.add_data("q", "float32")
    b.realize()
    assert tuple(b.get_curr(h).shape) == (5, 4, 6) and b.get_curr(h).device.type == "cpu"
    c2 = b.get_curr(h).clone()
    c2[0, 0, 0] = 1.0
    b.set_curr(h, c2)
    assert float(b.get_curr(h)[0, 0, 0]) == 1.0 and float(b.get_next(h)[0, 0, 0]) == 0.0
    with pytest.raises(ValueError, match="padded"):
        b.set_curr(h, torch.zeros(4, 4, 6))
    b.swap()
    assert float(b.get_next(h)[0, 0, 0]) == 1.0
    t = LocalBlock((4, 4, 4), (0, 0, 0), tgeo.Radius.constant(1), device="cpu")
    j = jdom.LocalBlock((4, 4, 4), (0, 0, 0), jgeo.Radius.constant(1))
    ht, hj = t.add_data(), j.add_data()
    t.realize()
    j.realize()
    arr = np.arange(6 * 6 * 6, dtype=np.float32).reshape(6, 6, 6)
    t.set_curr(ht, torch.from_numpy(arr.copy()))
    j.set_curr(hj, jax.numpy.asarray(arr))
    rect = tgeo.Rect3(tgeo.Dim3(1, 1, 1), tgeo.Dim3(5, 5, 5))
    jrect = jgeo.Rect3(jgeo.Dim3(1, 1, 1), jgeo.Dim3(5, 5, 5))
    np.testing.assert_array_equal(t.region_to_host(ht, rect), j.region_to_host(hj, jrect))
    np.testing.assert_array_equal(t.interior_to_host(ht), j.interior_to_host(hj))
    np.testing.assert_array_equal(t.quantity_to_host(ht), j.quantity_to_host(hj))
    m = LocalBlock((4, 4, 4), (0, 0, 0), tgeo.Radius.constant(1), device="cpu")
    hs = [m.add_data("f", "float32"), m.add_data("d", "float64"), m.add_data("i", "int32")]
    m.realize()
    assert [m.get_curr(x).dtype for x in hs] == [torch.float32, torch.float64, torch.int32]
    assert [x.dtype for x in hs] == ["float32", "float64", "int32"] and m.num_data() == 3
    with pytest.raises(RuntimeError, match="after realize"):
        m.add_data("late")


def test_local_block_from_jax():
    """A realized JAX block with random curr and next arrays carried across:
    the same geometry, quantities and arrays."""
    rng = np.random.RandomState(8)
    j = jdom.LocalBlock((5, 6, 7), (10, 0, 3), asym(jgeo))
    hs = [j.add_data("a", "float32"), j.add_data("b", "float64")]
    j.realize()
    for h in hs:
        shape = j.raw_size().as_tuple()[::-1]
        j.set_curr(h, jax.numpy.asarray(rng.rand(*shape).astype(h.dtype)))
        j.set_next(h, jax.numpy.asarray(rng.rand(*shape).astype(h.dtype)))
    t = block_from_jax(j, "cpu")
    assert t.origin.as_tuple() == (10, 0, 3) and t.raw_size().as_tuple() == j.raw_size().as_tuple()
    for th, jh in zip(t.handles(), j.handles()):
        assert (th.name, th.dtype) == (jh.name, jh.dtype)
        np.testing.assert_array_equal(t.quantity_to_host(th), j.quantity_to_host(jh))
        np.testing.assert_array_equal(t.quantity_to_host(th, curr=False),
                                      j.quantity_to_host(jh, curr=False))


# -- run_exchanges, write_plan, set_output_prefix ------------------------------------------

DOMAINS = {"one-block": ((12, 16, 20), None, "axis-composed", 1, ["float32"]),
           "resident-direct26": ((12, 16, 20), (2, 2, 2), "direct26", 2, ["float32", "float64"]),
           "uneven-composed": ((13, 16, 21), (3, 1, 2), "axis-composed", 1, ["float32"]),
           "uneven-direct26": ((13, 16, 21), (2, 1, 2), "direct26", 1, ["float64", "float32"])}


def domains(name, tmp_path=None):
    """The port's domain on the CPU and the JAX package's on one CPU device,
    realized with the same partition, radius, method and quantities (and,
    with ``tmp_path``, an output prefix under it for each)."""
    size, part, method, r, dtypes = DOMAINS[name]
    out = []
    for pkg, dd in (("t", DistributedDomain(*size, device="cpu")), ("j", japi.DistributedDomain(*size))):
        dd.set_radius(r)
        dd.set_methods((tpar if pkg == "t" else jpar).Method(method))
        if pkg == "j":
            dd.set_devices(jax.devices()[:1])
        if part is not None:
            dd.set_partition(part)
        if tmp_path is not None:
            (tmp_path / pkg).mkdir()
            dd.set_output_prefix(str(tmp_path / pkg) + "/")
        for i, dt in enumerate(dtypes):
            dd.add_data(f"q{i}", dt)
        dd.realize()
        out.append(dd)
    return out


@pytest.mark.parametrize("name", sorted(DOMAINS))
def test_write_plan_is_byte_identical(name, tmp_path):
    """``set_output_prefix`` before realize writes the plan and the block
    matrix at realize in each package; ``write_plan`` writes them again on
    demand: the same bytes."""
    t, j = domains(name, tmp_path)
    for f in ("plan_0.txt", "mat_npy_loadtxt.txt"):
        assert filecmp.cmp(tmp_path / "t" / f, tmp_path / "j" / f, shallow=False), f
    t.write_plan(str(tmp_path / "again_"))
    assert filecmp.cmp(tmp_path / "again_plan_0.txt", tmp_path / "j" / "plan_0.txt",
                       shallow=False)


@pytest.mark.parametrize("name", ["resident-direct26", "uneven-composed"])
def test_run_exchanges_matches_jax(name):
    """3 exchanges of a random state: every cell of every quantity, and the
    exchange count."""
    t, j = domains(name)
    rng = np.random.RandomState(2)
    for i, dt in enumerate(DOMAINS[name][4]):
        arr = rng.rand(*t.spec.stacked_shape_zyx()).astype(dt)
        t._curr[i] = torch.from_numpy(arr.copy())
        j._curr[i] = jax.device_put(arr, j.sharding())
    t.run_exchanges(3)
    j.run_exchanges(3)
    for i in t._curr:
        np.testing.assert_array_equal(t._curr[i].numpy(), np.asarray(j._curr[i]))
    assert t.num_exchanges == j.num_exchanges == 3


def test_jacobi3d_prefix_writes_the_plan(tmp_path):
    """``--prefix`` reaches ``set_output_prefix``: the run's plan files equal
    the JAX package's ``write_plan`` of the same domain."""
    assert tapp.main(["--x", "16", "--y", "16", "--z", "16", "--iters", "2", "--no-weak",
                      "--device", "cpu", "--direct26", "--prefix", str(tmp_path / "t_")]) == 0
    j = japi.DistributedDomain(16, 16, 16)
    j.set_radius(1)
    j.set_methods(jpar.Method.DIRECT26)
    j.set_devices(jax.devices()[:1])
    j.add_data("temperature", "float32")
    j.realize()
    j.write_plan(str(tmp_path / "j_"))
    for f in ("plan_0.txt", "mat_npy_loadtxt.txt"):
        assert filecmp.cmp(tmp_path / f"t_{f}", tmp_path / f"j_{f}", shallow=False), f


# -- quantity batching ---------------------------------------------------------------------

def test_quantity_batching_knob_reaches_the_exchange():
    """``set_quantity_batching`` reaches the realized exchange and its plan
    (``pack_groups``), as in the JAX package; default on."""
    for enabled in (True, False):
        t = DistributedDomain(8, 8, 8, device="cpu")
        j = japi.DistributedDomain(8, 8, 8)
        for dd in (t, j):
            dd.set_radius(1)
            dd.set_partition((2, 2, 2))
            if not enabled:
                dd.set_quantity_batching(False)
            dd.add_data("a")
            dd.add_data("b", "float64")
        j.set_devices(jax.devices()[:1])
        t.realize()
        j.realize()
        assert t.halo_exchange.batch_quantities is j.halo_exchange.batch_quantities is enabled
        assert t.halo_exchange.plan.pack_groups == j.halo_exchange.plan.pack_groups


@pytest.mark.parametrize("method", ["axis-composed", "direct26", "remote-dma"])
def test_batched_exchange_equals_per_quantity(method):
    """Batched and per-quantity exchanges of 4 quantities (two dtypes) on a
    resident (2,1,2) partition give the same cells, and the JAX package's."""
    size = (12, 16, 20)
    outs = []
    rng = np.random.RandomState(6)
    spec = None
    arrays = None
    for batch in (True, False):
        dd = DistributedDomain(*size, device="cpu")
        dd.set_radius(2)
        dd.set_partition((2, 1, 2))
        dd.set_methods(tpar.Method(method))
        dd.set_quantity_batching(batch)
        for dt in ("float32", "float64", "float32", "float32"):
            dd.add_data("", dt)
        dd.realize()
        spec = dd.spec
        if arrays is None:
            arrays = [rng.rand(*spec.stacked_shape_zyx()).astype(t.numpy().dtype)
                      for t in dd._curr.values()]
        for i, a in enumerate(arrays):
            dd._curr[i] = torch.from_numpy(a.copy())
        dd.exchange()
        outs.append([t.numpy() for t in dd._curr.values()])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_astaroth_per_quantity_exchange(capsys):
    """``--per-quantity-exchange`` gives the batched run's fields bit for
    bit over resident blocks, and the row and log record it."""
    a = tast.run(iters=1, nx=8, device="cpu", partition=(1, 1, 2))
    b = tast.run(iters=1, nx=8, device="cpu", partition=(1, 1, 2), batch_quantities=False)
    assert a["batch_quantities"] and not b["batch_quantities"]
    assert not b["domain"].halo_exchange.batch_quantities
    for name, h in a["handles"].items():
        assert torch.equal(a["domain"].get_curr(h), b["domain"].get_curr(b["handles"][name]))
    assert tast.main(["1", "--nx", "8", "--device", "cpu", "--per-quantity-exchange"]) == 0


# -- jacobi3d --multistep-rows -------------------------------------------------------------

def test_multistep_rows_legal_heights_are_bit_identical():
    """A height the kernel is built for changes nothing: the loop equals the
    default loop; the heights are the kernel's tile heights (32 rows at k <=
    3 in both dtypes, 16 and 8 deeper)."""
    heights = tjac.multistep_heights()
    assert heights[(3, "float32")] == heights[(3, "float64")] == 32
    assert heights[(4, "float32")] == 16 and heights[(4, "float64")] == 8
    got = tapp.run(16, 16, 16, iters=6, weak=False, device="cpu", multistep_rows=32)
    want = tapp.run(16, 16, 16, iters=6, weak=False, device="cpu")
    assert got["temporal_k"] == want["temporal_k"] == 3
    np.testing.assert_array_equal(got["domain"].get_curr_global(got["handle"]),
                                  want["domain"].get_curr_global(want["handle"]))


def test_multistep_rows_refuses_unbuilt_heights():
    with pytest.raises(ValueError, match=r"multistep_rows=8 illegal for k=3.*\[32\].*k=4 float32: 16"):
        tapp.run(16, 16, 16, iters=6, weak=False, device="cpu", multistep_rows=8)
    with pytest.raises(SystemExit):
        tapp.main(["--multistep-rows", "x"])


def test_multistep_rows_warns_when_not_engaged(capsys):
    """The JAX package's warning when the multistep does not engage (here
    direct26, which never takes it); the run goes on."""
    r = tapp.run(16, 16, 16, iters=2, weak=False, device="cpu", method=tpar.Method.DIRECT26,
                 multistep_rows=32)
    assert r["temporal_k"] == 0
    assert "multistep_rows=32 ignored" in capsys.readouterr().err


def test_jacobi3d_cli_multistep_rows(capsys):
    assert tapp.main(["--x", "16", "--y", "16", "--z", "16", "--iters", "6", "--no-weak",
                      "--device", "cpu", "--multistep-rows", "32"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("jacobi3d,axis-composed")


# -- astaroth --kernel-variant and --no-pallas ------------------------------------------------

def test_astaroth_kernel_variants_are_one_kernel():
    """'shift' and 'ring' give the same bits (one substep kernel serves
    both), the row records the choice, 'shift' is the default."""
    a = tast.run(iters=1, nx=8, device="cpu", kernel_variant="ring")
    b = tast.run(iters=1, nx=8, device="cpu")
    assert (a["kernel_variant"], b["kernel_variant"]) == ("ring", "shift")
    for name, h in a["handles"].items():
        assert torch.equal(a["domain"].get_curr(h), b["domain"].get_curr(b["handles"][name]))
    with pytest.raises(ValueError, match="unknown kernel_variant"):
        tast.run(iters=1, nx=8, device="cpu", kernel_variant="roll")
    assert tast.main(["1", "--nx", "8", "--device", "cpu", "--kernel-variant", "ring"]) == 0


def test_astaroth_no_pallas(monkeypatch):
    """On the CPU the unfused path is the one that runs (the same bits as
    the default); on a CUDA device it raises and names why, never falling
    back."""
    a = tast.run(iters=1, nx=8, device="cpu", use_pallas=False)
    b = tast.run(iters=1, nx=8, device="cpu")
    for name, h in a["handles"].items():
        assert torch.equal(a["domain"].get_curr(h), b["domain"].get_curr(b["handles"][name]))
    assert tast.main(["1", "--nx", "8", "--device", "cpu", "--no-pallas"]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(NotImplementedError, match="unfused substep path.*only on the CPU"):
        tast.run(iters=1, nx=8, device="cuda:0", use_pallas=False)
