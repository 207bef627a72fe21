"""The bench apps against the JAX package: bench_pack's rows and gathered
buffers, bench_exchange's sweep rows (the port over 8 CPU positions by
REMOTE_DMA, the JAX app on 8 virtual devices), the ablation's halos against
the JAX HaloExchange on the JAX ``coord_state`` with its census columns,
``wire_gate`` for every wire format, and measure_overlap's row and keys.
No assertion here compares wall times."""

import jax
import numpy as np
import pytest
import torch

from stencil_tpu.apps import _bench_common as jax_bc
from stencil_tpu.apps import bench_exchange as jax_be
from stencil_tpu.apps import bench_pack as jax_bp
from stencil_tpu.apps import measure_overlap as jax_mo
from stencil_tpu_torch.apps import _bench_common as bc
from stencil_tpu_torch.apps import bench_exchange as be
from stencil_tpu_torch.apps import bench_pack as bp
from stencil_tpu_torch.apps import measure_overlap as mo
from stencil_tpu_torch.geometry import DIRECTIONS_26, Dim3, Radius, halo_rect, raw_size
from stencil_tpu_torch.ops.halo_fill import WIRE_FORMATS
from stencil_tpu_torch.parallel import Method

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8


# -- bench_pack -----------------------------------------------------------------


def test_bench_pack_rows_equal_the_jax_rows():
    got = bp.run(16, 16, 16, radius=2, iters=2, device="cpu")
    want = jax_bp.run(16, 16, 16, radius=2, iters=1)
    assert [(r["dir"], r["bytes"]) for r in got] == [(r["dir"], r["bytes"]) for r in want]
    assert all(r["s_per_op"] > 0 and r["gb_per_s"] > 0 for r in got)
    face = next(r for r in got if r["dir"] == (1, 0, 0))
    assert face["bytes"] == 2 * 16 * 16 * 4


@pytest.mark.parametrize("d", DIRECTIONS_26, ids=lambda d: f"{d.x}{d.y}{d.z}")
def test_bench_pack_buffers_equal_the_jax_slices(d):
    """The flat buffer of one direction's halo rect equals the JAX slice's
    reshape; two pack/unpack iterations leave the same array and
    accumulator as the JAX loop, from the same random field."""
    r = Radius.constant(2)
    size = Dim3(16, 16, 16)
    p = raw_size(size, r)
    rect = halo_rect(d, size, r, halo=True)
    rng = np.random.default_rng(d.x + 3 * d.y + 9 * d.z + 13)
    arr = rng.standard_normal((p.z, p.y, p.x)).astype(np.float32)
    zyx = bp.region(rect)
    np.testing.assert_array_equal(bp.pack(torch.from_numpy(arr), rect).numpy(),
                                  arr[zyx].reshape(-1))
    a_t, acc_t = bp.pack_fn(rect, 2)(torch.from_numpy(arr.copy()), torch.zeros(()))
    a_j, acc_j = jax_bp.pack_fn(rect, 2)(jax.numpy.asarray(arr), np.float32(0))
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    assert float(acc_t) == float(acc_j)


# -- bench_exchange -------------------------------------------------------------


def test_bench_exchange_sweep_rows_equal_the_jax_rows():
    got = be.run(16, 16, 16, iters=2, devices=CPU8, method=Method.REMOTE_DMA)
    want = jax_be.run(16, 16, 16, iters=2, devices=jax.devices()[:8])
    assert [(r["config"], r["bytes"]) for r in got] == [(r["config"], r["bytes"]) for r in want]
    assert all(r["trimean_s"] > 0 for r in got)
    assert [r["config"].split("/")[1] for r in got] == ["px", "x", "faces", "face&edge",
                                                        "uniform"]


@pytest.fixture(scope="module")
def jax_halos():
    """The JAX HaloExchange of the JAX coord_state, 16^3 r2 x4 over its 8
    devices (one compile), in the stacked layout."""
    from stencil_tpu.api import DistributedDomain

    dd = DistributedDomain(16, 16, 16)
    dd.set_radius(2)
    dd.set_devices(jax.devices()[:8])
    for i in range(4):
        dd.add_data(f"d{i}", "float32")
    dd.realize()
    assert tuple(dd.spec.dim) == (2, 2, 2)
    out = dd.halo_exchange(jax_bc.coord_state(dd, 4))
    return np.stack([np.asarray(jax.device_get(out[i])) for i in sorted(out)])


def test_ablate_over_residents(jax_halos, capsys):
    rows = be.compare_methods(16, 16, 16, iters=2, quantities=4, devices=["cpu"])
    assert "# skipping auto-spmd:" in capsys.readouterr().out
    assert [r["config"].split("method=")[1] for r in rows] == ["axis-composed", "direct26",
                                                               "remote-dma"]
    for row in rows:
        dd = row.pop("domain")
        assert tuple(dd.spec.dim) == (2, 2, 2) and dd.mesh is None
        out = dd.halo_exchange(bc.coord_state(dd, 4))
        got = np.stack([out[i].numpy() for i in sorted(out)])
        np.testing.assert_array_equal(got, jax_halos, err_msg=row["config"])


def test_ablate_census_columns(capsys):
    rows, agree = be.ablate(16, 16, 16, iters=2, quantities=4, devices=["cpu"])
    capsys.readouterr()
    assert agree
    by = {r["config"].split("method=")[1]: r for r in rows}
    assert by["axis-composed"]["cp_count"] == 6
    assert by["direct26"]["cp_count"] == 26
    assert by["remote-dma"]["cp_count"] == 0 and by["remote-dma"]["cp_bytes"] == 0
    assert all(r["other_collectives"] == 0 for r in rows)
    assert all(r["cp_bytes"] > 0 for r in rows if "remote-dma" not in r["config"])
    assert len({r["bytes"] for r in rows}) == 1
    assert be.ablate_row(rows[0]).count(",") == be.ablate_header().count(",")
    assert be.ablate_header() == jax_be.ablate_header()


def test_ablate_over_positions_skips_as_the_jax_harness(capsys):
    """Over 8 positions every method the port has runs (AXIS_COMPOSED and
    DIRECT26 by copies between positions, REMOTE_DMA by its carrier) and
    the halos agree bit for bit; auto-spmd is skipped with the JAX
    harness's line."""
    rows, agree = be.ablate(16, 16, 16, iters=2, quantities=2, devices=CPU8)
    out = capsys.readouterr().out
    assert "# skipping auto-spmd: " in out
    for name in ("axis-composed", "direct26"):
        assert f"# skipping {name}: " not in out
    assert [r["config"].split("method=")[1] for r in rows] == ["axis-composed", "direct26",
                                                               "remote-dma"] and agree
    by = {r["config"].split("method=")[1]: r for r in rows}
    assert [by[m]["cp_count"] for m in ("axis-composed", "direct26", "remote-dma")] == [6, 26, 0]
    assert by["remote-dma"]["cp_bytes"] == 0 and by["direct26"]["cp_bytes"] > 0


def test_batched_ab_over_residents(capsys):
    rows, q_indep, parity = be.batched_ab(16, 16, 16, iters=2, quantities=(1, 3),
                                          devices=["cpu"])
    assert q_indep and parity
    assert [r["cp_count"] for r in rows] == [6, 6, 6, 18]


@pytest.mark.parametrize("wire", sorted(WIRE_FORMATS))
def test_wire_gate_equals_the_jax_thresholds(wire):
    assert be.wire_gate(wire) == jax_be.wire_gate(wire)


def test_wire_ab_over_positions():
    rows, ratio, err = be.wire_ab(16, 16, 16, iters=2, quantities=2, devices=CPU8,
                                  method=Method.REMOTE_DMA, wire="bfloat16")
    thr, bound = be.wire_gate("bfloat16")
    assert ratio == 2.0 >= thr and 0 < err["max_rel_err"] <= bound
    assert [r["config"] for r in rows] == ["16-16-16/q=2/wire=native",
                                          "16-16-16/q=2/wire=bfloat16"]


def test_bench_exchange_cli(capsys):
    assert be.main(["--cpu", "1", "--x", "16", "--y", "16", "--z", "16", "--iters", "2",
                    "--ablate"]) == 0  # every method the port runs on residents agrees
    out = capsys.readouterr().out
    assert out.splitlines()[1] == be.ablate_header()
    assert out.rstrip().endswith("# bit-for-bit agreement: PASS")
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        be.main(["--virtual-hosts", "2"])
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        bc.time_exchange(Dim3(8, 8, 8), Radius.constant(1), 1, devices=["cpu"],
                         placement=(0,))


# -- measure_overlap --------------------------------------------------------------


def test_measure_overlap_csv_row_equals_the_jax_row():
    rng = np.random.default_rng(5)
    r = {"devices": 8, "x": 16, "y": 16, "z": 32, "radius": 1, "iters": 10}
    for k in ("compute_s", "exchange_s", "serial_s", "overlap_s", "hidden_s", "hidden_frac"):
        r[k] = float(rng.uniform(-1e-3, 1e-2))
    assert mo.csv_row(r) == jax_mo.csv_row(r)


JAX_RUN_KEYS = {"devices", "x", "y", "z", "radius", "iters", "compute_s", "exchange_s",
                "serial_s", "overlap_s", "hidden_s", "hidden_frac", "domain"}


def test_measure_overlap_run_over_positions(tmp_path):
    r = mo.run(8, 8, 8, iters=2, rounds=2, devices=CPU8, trace_dir=str(tmp_path / "tr"))
    assert set(r) == JAX_RUN_KEYS
    assert (r["devices"], r["x"], r["y"], r["z"]) == (8, 16, 16, 16)
    for k in ("compute_s", "exchange_s", "serial_s", "overlap_s"):
        assert r[k] > 0
    assert mo.csv_row(r).startswith("measure_overlap,8,16,16,16,1,2,")
    assert not (tmp_path / "tr").exists()  # no CUDA profiler here: nothing written


def test_measure_overlap_keys_are_the_jax_runs():
    """JAX_RUN_KEYS is the JAX run's return dict (one compile per variant
    at 8^3 on one virtual device)."""
    r = jax_mo.run(8, 8, 8, iters=1, rounds=1, devices=jax.devices()[:1])
    assert set(r) == JAX_RUN_KEYS
