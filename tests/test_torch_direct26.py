"""The direct26 exchange and REMOTE_DMA on resident blocks, in the port
against the JAX package on one CPU device (``grid_mesh(Dim3(1, 1, 1))``
with a multi-block spec, the JAX package's oversubscribed layout): the plan
records (direct26 messages, their order, extents and counts; uniform,
uneven and resident), the exchange on every cell (halos and dead pad
included) for uniform, uneven, one-block, fp64 and mixed-dtype states,
batched against per-quantity, the jacobi loop and step, jacobi3d and its
CLI with ``--direct26``, and the remote-dma loop over resident blocks.
Inputs are random numpy arrays from a seed, noise in every halo and pad
cell. Tolerance: bit-exact."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import stencil_tpu.apps.jacobi3d as japp
import stencil_tpu.domain.grid as jgrid
import stencil_tpu.geometry as jgeo
import stencil_tpu.ops.jacobi as jjac
import stencil_tpu.parallel as jpar
import stencil_tpu.plan.ir as jir
import stencil_tpu_torch.apps.jacobi3d as tapp
import stencil_tpu_torch.domain.grid as tgrid
import stencil_tpu_torch.geometry as tgeo
import stencil_tpu_torch.ops.jacobi as tjac
import stencil_tpu_torch.parallel as tpar
import stencil_tpu_torch.plan.ir as tir
from stencil_tpu_torch.convert import state_from_jax, state_to_numpy

torch.set_num_threads(2)

D26_T, D26_J = tpar.Method.DIRECT26, jpar.Method.DIRECT26
RDMA_T, RDMA_J = tpar.Method.REMOTE_DMA, jpar.Method.REMOTE_DMA


def radius(geo, kind):
    """A constant radius, the asymmetric faces of tests/test_exchange.py, or
    faces and edges of 2 with the corners off."""
    if isinstance(kind, int):
        return geo.Radius.constant(kind)
    if kind == "fe":
        return geo.Radius.face_edge_corner(2, 2, 0)
    r = geo.Radius.constant(0)
    for d, v in (((-1, 0, 0), 1), ((1, 0, 0), 2), ((0, -1, 0), 3), ((0, 1, 0), 1),
                 ((0, 0, -1), 2), ((0, 0, 1), 0)):
        r.set_dir(d, v)
    return r


def specs(size, part, rad):
    return (tgrid.GridSpec(tgeo.Dim3(*size), tgeo.Dim3(*part), radius(tgeo, rad)),
            jgrid.GridSpec(jgeo.Dim3(*size), jgeo.Dim3(*part), radius(jgeo, rad)))


def one_device():
    return jpar.grid_mesh(jgeo.Dim3(1, 1, 1), jax.devices()[:1])


def noisy(jspec, dtypes, seed):
    rng = np.random.RandomState(seed)
    return {i: rng.rand(*jspec.stacked_shape_zyx()).astype(dt) for i, dt in enumerate(dtypes)}


def plain(v):
    if isinstance(v, tuple):
        return tuple(plain(e) for e in v)
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


# -- the plan ---------------------------------------------------------------------------

# tests/test_exchange.py's direct26 partitions, its asymmetric and
# corner-less radii, and the uneven ones of tests/test_exchange_batched.py
PLAN_CASES = [((8, 8, 8), (2, 2, 2), 1), ((12, 8, 10), (2, 2, 2), 3), ((8, 8, 8), (4, 2, 1), 2),
              ((16, 8, 8), (8, 1, 1), 2), ((6, 6, 6), (1, 1, 1), 2), ((10, 12, 8), (2, 2, 2), "asym"),
              ((8, 8, 8), (2, 2, 2), "fe"), ((11, 9, 13), (2, 2, 2), 2), ((13, 7, 5), (2, 2, 2), 1)]


@pytest.mark.parametrize("mesh", ["positions", "resident"])
@pytest.mark.parametrize("size,part,rad", PLAN_CASES, ids=lambda v: str(v))
def test_direct26_plan_matches_jax(size, part, rad, mesh):
    """``build_plan(..., "direct26")`` field by field (the messages'
    directions, order, extents, starts, pairs and counts), its description,
    collective counts with and without quantity batching, on one block a
    position and with every block resident on one device."""
    tspec, jspec = specs(size, part, rad)
    md = part if mesh == "positions" else (1, 1, 1)
    for batch in (True, False):
        got = tir.build_plan(tspec, md, tir.DIRECT26, batch_quantities=batch)
        want = jir.build_plan(jspec, jgeo.Dim3(*md), jir.DIRECT26, batch_quantities=batch)
        for f in dataclasses.fields(got):
            assert plain(getattr(got, f.name)) == plain(getattr(want, f.name)), f.name
        assert got.describe() == want.describe()
        assert got.phases == got.direct_phases and len(got.phases) == len(want.phases)
        for q, g in ((1, 1), (4, 2)):
            assert got.collectives_per_exchange(q, g) == want.collectives_per_exchange(q, g)
            assert got.wire_bytes([4] * q) == want.wire_bytes([4] * q)
    if mesh == "resident":
        ex = tpar.HaloExchange(tspec, D26_T)
        assert plain(ex.plan.direct_phases) == plain(want.direct_phases)


# -- the exchange -----------------------------------------------------------------------

# (the JAX package's uneven direct26 compiles for seconds a dtype group, so
# the uneven (2,2,2) and (3,1,2) splits take one fp32 quantity)
EXCHANGE_CASES = [((12, 16, 20), (2, 2, 2), 1, "f32"), ((12, 16, 20), (2, 2, 2), 1, "mixed"),
                  ((12, 16, 20), (2, 2, 2), "asym", "mixed"), ((12, 16, 21), (1, 1, 2), 2, "f32"),
                  ((12, 16, 21), (1, 1, 2), 2, "mixed"), ((11, 9, 13), (2, 2, 2), 2, "f32"),
                  ((13, 16, 20), (3, 1, 2), 1, "f32"), ((6, 6, 6), (1, 1, 1), 2, "mixed"),
                  ((8, 8, 8), (2, 2, 2), "fe", "mixed")]
STATES = {"f32": [np.float32], "f64": [np.float64],
          "mixed": [np.float32, np.float64, np.float32, np.float32]}


@functools.lru_cache(maxsize=None)
def jax_exchanged(size, part, rad, state, method):
    """JAX's exchanged state (numpy) of the noisy start state: one compile
    per case, shared by the port's batched and per-quantity exchanges."""
    _tspec, jspec = specs(size, part, rad)
    arrays = noisy(jspec, STATES[state], seed=sum(size) + len(state))
    jex = jpar.HaloExchange(jspec, one_device(), method)
    out = jex({i: jax.device_put(a, jex.sharding()) for i, a in arrays.items()})
    return arrays, {i: np.asarray(v) for i, v in out.items()}, jex


@pytest.mark.parametrize("size,part,rad,state", EXCHANGE_CASES, ids=lambda v: str(v))
def test_direct26_exchange_matches_jax(size, part, rad, state):
    """Every cell of every quantity (compute, halos and the dead pad the
    uneven form's padded writes reach) after one exchange, batched and per
    quantity, and after a second exchange; the byte accounting."""
    tspec, _jspec = specs(size, part, rad)
    arrays, want, jex = jax_exchanged(size, part, rad, state, D26_J)
    for batch in (True, False):
        tex = tpar.HaloExchange(tspec, D26_T, batch_quantities=batch)
        assert tuple(tex.resident) == tuple(jex.resident) == part
        st = state_from_jax(arrays, tspec, "cpu")
        tex(st)
        got = state_to_numpy(st)
        for i in arrays:
            assert got[i].dtype == arrays[i].dtype
            np.testing.assert_array_equal(got[i], want[i], err_msg=f"batch={batch} q={i}")
    tex.make_loop(2)(st)
    for i, v in state_to_numpy(st).items():
        np.testing.assert_array_equal(v, want[i])
    items = [a.dtype.itemsize for a in arrays.values()]
    assert tex.bytes_logical(items) == jex.bytes_logical(items)
    assert tex.bytes_moved(items) == jex.bytes_moved(items)


def test_direct26_fp64_matches_jax():
    """A float64 quantity on an uneven resident partition."""
    size, part = (12, 16, 21), (1, 1, 2)
    tspec, _ = specs(size, part, 2)
    arrays, want, _jex = jax_exchanged(size, part, 2, "f64", D26_J)
    st = state_from_jax(arrays, tspec, "cpu")
    tpar.HaloExchange(tspec, D26_T)(st)
    np.testing.assert_array_equal(state_to_numpy(st)[0], want[0])


def test_direct26_batched_is_per_quantity():
    """One carrier per same-dtype group and one per quantity move the same
    cells (no JAX: the port against itself, uniform and uneven)."""
    for size in ((12, 16, 20), (11, 9, 13)):
        tspec, jspec = specs(size, (2, 2, 2), 2)
        arrays = noisy(jspec, STATES["mixed"], seed=3)
        out = []
        for batch in (True, False):
            st = state_from_jax(arrays, tspec, "cpu")
            tpar.HaloExchange(tspec, D26_T, batch_quantities=batch)(st)
            out.append(state_to_numpy(st))
        for i in arrays:
            np.testing.assert_array_equal(out[0][i], out[1][i])


def test_direct26_refusals():
    tspec, _ = specs((16, 16, 16), (2, 2, 2), 1)
    with pytest.raises(ValueError, match="axis subsetting requires AXIS_COMPOSED"):
        tpar.HaloExchange(tspec, D26_T).exchange(torch.zeros(tspec.stacked_shape_zyx()),
                                                 axes=("z",))
    with pytest.raises(NotImplementedError, match="oversubscribed.*queue A item 5"):
        tpar.HaloExchange(tspec, D26_T, mesh=tpar.DeviceMesh((2, 2, 1), ["cpu"] * 4))
    ex = tpar.HaloExchange(tspec, D26_T, mesh=tpar.DeviceMesh((2, 2, 2), ["cpu"] * 8))
    assert ex.on_mesh and ex.last_transfer_count == 0
    with pytest.raises(ValueError, match="axis subsetting requires AXIS_COMPOSED"):
        ex.exchange({0: [torch.zeros((1, 1, 1, *tspec.block_shape_zyx())) for _ in range(8)]},
                    axes=("z",))


@pytest.mark.parametrize("size,part", [((12, 16, 20), (2, 2, 2)), ((13, 16, 20), (3, 1, 2))],
                         ids=["uniform", "uneven"])
def test_remote_dma_on_residents_matches_jax(size, part):
    """REMOTE_DMA with every block resident on one device: the axis carrier
    over every block, each a view into the stack, equal on every cell to the
    JAX package's emulation of the same exchange; nothing leaves the
    device."""
    tspec, _ = specs(size, part, 2)
    arrays, want, jex = jax_exchanged(size, part, 2, "mixed", RDMA_J)
    tex = tpar.HaloExchange(tspec, RDMA_T)
    assert tex.oversubscribed and tex.plan.remote_phases
    st = state_from_jax(arrays, tspec, "cpu")
    tex(st)
    for i, v in state_to_numpy(st).items():
        np.testing.assert_array_equal(v, want[i])
    assert tex.last_transfer_count == jex._remote.last_transfer_count == 0
    assert tex.plan.dmas_per_exchange() == 0 and tex.plan.launches_per_chunk(3) == 6


# -- the jacobi loop ----------------------------------------------------------------------

LOOP_CASES = {"uniform": ((16, 16, 16), (2, 2, 2), "float32"),
              "uneven": ((16, 16, 21), (1, 1, 2), "float32"),
              "one-block": ((16, 16, 16), (1, 1, 1), "float32"),
              "fp64": ((16, 16, 16), (2, 2, 2), "float64")}


def run_loops(case, method_t, method_j, iters=3, seed=7):
    size, part, dtype = LOOP_CASES[case]
    tspec, jspec = specs(size, part, 1)
    rng = np.random.RandomState(seed)
    shape = jspec.stacked_shape_zyx()
    arrs = {"c": rng.rand(*shape).astype(dtype), "n": rng.rand(*shape).astype(dtype),
            "s": np.asarray(jpar.exchange.shard_blocks(jjac.sphere_sel(size), jspec,
                                                       one_device()))}
    jex = jpar.HaloExchange(jspec, one_device(), method_j)
    js = {k: jax.device_put(v, jex.sharding()) for k, v in arrs.items()}
    jc, jn = jjac.make_jacobi_loop(jex, iters)(js["c"], js["n"], js["s"])
    tex = tpar.HaloExchange(tspec, method_t)
    ts = state_from_jax(arrs, tspec, "cpu")
    loop = tjac.make_jacobi_loop(tex, iters)
    tc, tn = loop(ts["c"], ts["n"], ts["s"])
    return (state_to_numpy({"c": tc, "n": tn}), {"c": np.asarray(jc), "n": np.asarray(jn)},
            loop, jspec)


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_direct26_loop_matches_jax(case):
    """3 steps: both buffers on every cell (the result's compute region; the
    other buffer is the exchanged state, halos and dead pad included); no
    multistep, as in the JAX package."""
    got, want, loop, jspec = run_loops(case, D26_T, D26_J)
    assert loop.temporal_k == 0
    np.testing.assert_array_equal(jpar.exchange.unshard_blocks(got["c"], jspec),
                                  jpar.exchange.unshard_blocks(want["c"], jspec))
    for key in ("c", "n"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_direct26_step_matches_loop():
    """``make_jacobi_step`` with direct26: the full exchange and a sweep."""
    tspec, jspec = specs((16, 16, 16), (2, 2, 2), 1)
    rng = np.random.RandomState(4)
    shape = jspec.stacked_shape_zyx()
    c = torch.from_numpy(rng.rand(*shape).astype(np.float32))
    n = torch.from_numpy(rng.rand(*shape).astype(np.float32))
    sel = tjac.sphere_sel_blocks(tspec, "cpu")
    ex = tpar.HaloExchange(tspec, D26_T)
    a = tjac.make_jacobi_step(ex)(c.clone(), n.clone(), sel)
    b = tjac.make_jacobi_loop(ex, 1)(c.clone(), n.clone(), sel)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("case", ["uniform", "uneven"])
def test_remote_dma_resident_loop_matches_jax(case):
    """The plain remote-dma loop over resident blocks: per step the axis
    carrier over every block, then one sweep of the stack."""
    got, want, loop, jspec = run_loops(case, RDMA_T, RDMA_J)
    np.testing.assert_array_equal(jpar.exchange.unshard_blocks(got["c"], jspec),
                                  jpar.exchange.unshard_blocks(want["c"], jspec))
    np.testing.assert_array_equal(got["n"], want["n"])


# -- the app ------------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_app(partition):
    return japp.run(16, 16, 16, method=D26_J, devices=jax.devices()[:1], iters=4, chunk=2,
                    weak=False, partition=partition)


@pytest.mark.parametrize("partition", [(2, 2, 2), (1, 1, 1)], ids=["222", "one-block"])
def test_jacobi3d_direct26_matches_jax_app(partition):
    want = jax_app(partition)
    got = tapp.run(16, 16, 16, method=D26_T, device="cpu", iters=4, chunk=2, weak=False,
                   partition=partition)
    np.testing.assert_array_equal(got["domain"].get_curr_global(got["handle"]),
                                  want["domain"].get_curr_global(want["handle"]))
    assert tapp.csv_row(got).split(",")[:8] == japp.csv_row(want).split(",")[:8]
    assert got["temporal_k"] == 0


def test_jacobi3d_cli_direct26(capsys):
    """``--direct26`` picks the method (``--method`` overrides it)."""
    assert tapp.main(["--x", "16", "--y", "16", "--z", "16", "--iters", "4", "--no-weak",
                      "--direct26", "--device", "cpu"]) == 0
    row = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    assert row[:8] == japp.csv_row(jax_app((1, 1, 1))).split(",")[:8]
    assert row[1] == "direct26"
    assert tapp.main(["--x", "16", "--y", "16", "--z", "16", "--iters", "2", "--no-weak",
                      "--direct26", "--method", "axis-composed", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1].split(",")[1] == "axis-composed"
