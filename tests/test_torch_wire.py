"""The narrowed wire (``wire_dtype``: bf16 on the wire and its fp8 tier) in
the port, against the JAX package on its virtual CPU devices (the other
fp8 and fp4 formats' rounding and carriers: ``test_torch_wire_formats.py``;
an oversubscribed mesh: ``test_torch_wire_oversub.py``): the rounding
of a crossing word (``halo_fill.wire_round``) against ``astype`` under
``jax.jit`` for every supported pair, edge values included; the policy and
the byte model; the axis carrier's (B6) and the fused exchange's (B7) plain
versions with a wire against the JAX REMOTE_DMA exchanges with the same
wire; jacobi3d over 8 positions with a wire, plain and fused, against the
JAX app; the no-op on one device; and the refusals. Inputs are seeded numpy
arrays (noise in every halo and pad cell, magnitudes across the wires'
ranges). Tolerance: bit-exact, NaN equal to NaN, except the pinned fp64
subnormal divergence."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import stencil_tpu.apps.jacobi3d as japp
import stencil_tpu.domain.grid as jgrid
import stencil_tpu.geometry as jgeo
import stencil_tpu.ops.halo_fill as jfill
import stencil_tpu.parallel as jpar
import stencil_tpu.plan.ir as jir
import stencil_tpu_torch.apps.jacobi3d as tapp
import stencil_tpu_torch.domain.grid as tgrid
import stencil_tpu_torch.geometry as tgeo
import stencil_tpu_torch.parallel as tpar
import stencil_tpu_torch.plan.ir as tir
from stencil_tpu.parallel.mesh import BLOCK_PSPEC
from stencil_tpu_torch.convert import mesh_state_from_jax, mesh_state_to_numpy
from stencil_tpu_torch.ops import fused_stencil as tfused
from stencil_tpu_torch.ops import halo_fill as tfill
from stencil_tpu_torch.ops import remote_dma as trdma

torch.set_num_threads(2)

F32, F64, I32 = np.float32, np.float64, np.int32
BF16, F16, FP8 = "bfloat16", "float16", "float8_e4m3fn"
RDMA_T, RDMA_J = tpar.Method.REMOTE_DMA, jpar.Method.REMOTE_DMA

# every (data, wire) pair the kernels narrow through
PAIRS = [(F32, BF16), (F32, F16), (F32, FP8), (F64, "float32"), (F64, BF16), (F64, F16),
         (F64, FP8)]

# fp8's overflow edge (448 is its largest value, 464 the tie that rounds to
# it, above it NaN), its subnormals, fp16's overflow edge, ties at 1, and the
# non-finite values
EDGES = [0.0, -0.0, 1.0, 448.0, -448.0, 460.0, 464.0, -464.0, 465.0, 480.0, 500.0, 1e30, -1e30,
         math.inf, -math.inf, math.nan, 2.0 ** -6, 2.0 ** -9, 2.0 ** -10, -(2.0 ** -10),
         3 * 2.0 ** -11, 5 * 2.0 ** -12, 65504.0, 65519.0, 65520.0, 65536.0, 1 + 2.0 ** -8,
         1 + 3 * 2.0 ** -9, 1 + 2.0 ** -4, 1 + 3 * 2.0 ** -5, 2.0 ** -24, 2.0 ** -25, 2.0 ** -14]
# values that round twice differently from once, in fp64 only
EDGES_F64 = [2.0 ** -10 + 2.0 ** -40, 1 + 2.0 ** -4 + 2.0 ** -40, 1 + 2.0 ** -11 + 2.0 ** -40,
             1 + 2.0 ** -8 + 2.0 ** -30, 448 + 16 + 2.0 ** -30, 65520 - 2.0 ** -30]


def jax_round(x: np.ndarray, wire: str) -> np.ndarray:
    return np.asarray(jax.jit(lambda a: a.astype(wire).astype(a.dtype))(jnp.asarray(x)))


def seeded(dtype, n, seed, lo, hi):
    """``n`` values of random sign and magnitude ``2 ** U(lo, hi)``."""
    rng = np.random.RandomState(seed)
    return (rng.choice([-1.0, 1.0], n) * 2.0 ** rng.uniform(lo, hi, n)).astype(dtype)


# -- the rounding -------------------------------------------------------------------

@pytest.mark.parametrize("dtype,wire", PAIRS, ids=[f"{np.dtype(d).name}-{w}" for d, w in PAIRS])
def test_wire_round_matches_jax(dtype, wire):
    """Seeded values across the data's range (fp64 kept to fp32's normal
    range, where XLA's flush cannot reach: see the subnormal test) and the
    edge values, against ``x.astype(wire).astype(x.dtype)``."""
    lo, hi = (-149, 127) if dtype == F32 else (-126, 300)
    edges = EDGES + (EDGES_F64 if dtype == F64 else [])
    x = np.concatenate([seeded(dtype, 50_000, 7, lo, hi), seeded(dtype, 50_000, 8, -30, 20),
                        np.array(edges, dtype)])
    got = tfill.wire_round(torch.from_numpy(x), wire).numpy()
    want = jax_round(x, wire)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    num = ~np.isnan(want)  # the sign of a NaN is not the rule's
    np.testing.assert_array_equal(np.signbit(got[num]), np.signbit(want[num]))
    assert (got != x).any()  # it did round


def test_wire_round_edges():
    """fp8 rounds to nearest even and overflows to NaN (torch's ``.to``
    saturates to 448); fp64 rounds once to fp8 and fp16 (torch rounds
    through fp32) and twice to bf16 (as JAX does)."""
    def r(v, dtype, wire):
        return float(tfill.wire_round(torch.tensor([v], dtype=dtype), wire)[0])

    for dtype in (torch.float32, torch.float64):
        assert r(464.0, dtype, FP8) == 448.0 and r(-464.0, dtype, FP8) == -448.0
        assert all(math.isnan(r(v, dtype, FP8)) for v in (465.0, 480.0, 1e30, math.inf, -math.inf))
        # subnormal ties to even: 2^-10 -> 0, 3 * 2^-10 -> 2^-8
        assert r(2.0 ** -10, dtype, FP8) == 0.0 and r(3 * 2.0 ** -10, dtype, FP8) == 2.0 ** -8
        assert r(3 * 2.0 ** -11, dtype, FP8) == 2.0 ** -9
        assert r(65520.0, dtype, F16) == math.inf
    assert float(torch.tensor([465.0]).to(torch.float8_e4m3fn).float()[0]) == 448.0
    assert r(2.0 ** -10 + 2.0 ** -40, torch.float64, FP8) == 2.0 ** -9
    assert r(1 + 2.0 ** -4 + 2.0 ** -40, torch.float64, FP8) == 1.125
    assert r(1 + 2.0 ** -11 + 2.0 ** -40, torch.float64, F16) == 1 + 2.0 ** -10
    assert r(1 + 2.0 ** -8 + 2.0 ** -30, torch.float64, BF16) == 1.0
    t = torch.tensor([1.5, 2.25], dtype=torch.int32)
    assert tfill.wire_round(t, BF16) is t  # an integer quantity never narrows


@pytest.mark.parametrize("wire", ["float32", BF16])
def test_fp64_subnormal_narrowing_is_kept(wire):
    """The pinned divergence: XLA on the CPU flushes an fp64 -> fp32 (or
    -> bf16, through fp32) result below fp32's least normal to zero; the
    port keeps the IEEE subnormal, as torch's conversion and the card's
    (built with -ftz=false) do. fp32 data narrowed to bf16 keeps its
    subnormals in both packages."""
    x = np.array([1e-40, -1e-40, 2.0 ** -130, -(2.0 ** -132), 1.1e-38], F64)
    got = tfill.wire_round(torch.from_numpy(x), wire).numpy()
    ieee = x.astype(F32).astype(jnp.dtype(wire)).astype(F64)
    np.testing.assert_array_equal(got, ieee)
    assert (got != 0).all()
    np.testing.assert_array_equal(jax_round(x, wire), np.zeros_like(x))
    x32 = np.array([1e-40, -3e-39, 2.0 ** -140], F32)
    np.testing.assert_array_equal(tfill.wire_round(torch.from_numpy(x32), BF16).numpy(),
                                  jax_round(x32, BF16))


# -- the policy and the byte model ---------------------------------------------------

DTYPES = ["int32", "float16", "bfloat16", "float32", "float64", "float8_e4m3fn"]
# every other floating format the JAX package narrows through, and a
# non-floating one
WIRES = DTYPES + ["float8_e5m2", "float8_e4m3fnuz", "float8_e5m2fnuz", "float8_e4m3b11fnuz",
                  "float8_e3m4", "float8_e4m3", "float8_e8m0fnu", "float4_e2m1fn", "int8"]


@pytest.mark.parametrize("native", DTYPES)
def test_wire_policy_and_itemsize_match_jax(native):
    """For data of each dtype, each wire narrows (to that format) exactly
    when JAX's ``wire_narrow_dtype`` says so, and prices a cell at JAX's
    itemsize."""
    for wire in WIRES:
        want = jfill.wire_narrow_dtype(jnp.dtype(native), wire)
        got = tfill.wire_format(getattr(torch, native), wire)
        assert (None if got is None else got.name) == \
            (None if want is None else str(want)), (native, wire)
        assert tir.wire_itemsize(wire) == jir.wire_itemsize(wire)
        if got is not None:
            assert got.itemsize == jnp.dtype(wire).itemsize
    assert tir.wire_itemsize(None) is None


def test_wire_names():
    assert tfill.wire_name(None) is None and tfill.wire_name("") is None
    assert tfill.wire_name(torch.bfloat16) == BF16 and tfill.wire_name(FP8) == FP8
    assert tfill.wire_name("float64") == "float64" and tfill.wire_name("int8") == "int8"
    # every format the JAX package narrows through has a name and a format
    # (e5m2 by the card's conversion, the others by the SOFT instantiation)
    assert tfill.wire_name("float8_e5m2") == "float8_e5m2"
    assert tfill.wire_name(torch.float8_e5m2) == "float8_e5m2"
    e5m2 = tfill.wire_format(torch.float32, "float8_e5m2")
    assert (e5m2.mant, e5m2.emin, e5m2.top, e5m2.overflow, e5m2.code) == \
        (2, -14, 57344.0, "inf", 5)
    assert tfill.wire_format(torch.float64, "float4_e2m1fn").code == tfill.SOFT_WIRE
    with pytest.raises(ValueError, match="unknown dtype"):
        tfill.wire_name("bf17")
    assert tfill.wire_format(torch.float32, "float32") is None
    assert tfill.wire_format(torch.float64, "float32").code == 4
    assert tfill.wire_format(torch.int32, FP8) is None


PLAN_KINDS = [("axis-composed", {}), ("remote-dma", {}), ("remote-dma", {"fused": True})]


@pytest.mark.parametrize("dim", [(2, 2, 2), (2, 1, 1)], ids=["222", "211"])
@pytest.mark.parametrize("wire", [BF16, FP8, "float8_e5m2", "float8_e4m3b11fnuz",
                                  "float8_e8m0fnu", "float4_e2m1fn"])
def test_plan_wire_bytes_match_jax(dim, wire):
    """Composed, remote-dma and fused plans: the fields, the description
    and the wire bytes (native, narrowed, and with an int32 quantity that
    keeps its itemsize) equal the JAX package's."""
    tspec = tgrid.GridSpec(tgeo.Dim3(16, 16, 16), tgeo.Dim3(*dim), tgeo.Radius.constant(2))
    jspec = jgrid.GridSpec(jgeo.Dim3(16, 16, 16), jgeo.Dim3(*dim), jgeo.Radius.constant(2))
    for method, kw in PLAN_KINDS:
        got = tir.build_plan(tspec, dim, method, wire_dtype=wire, **kw)
        want = jir.build_plan(jspec, dim, method, wire_dtype=wire, **kw)
        native = tir.build_plan(tspec, dim, method, **kw)
        assert got.wire_dtype == want.wire_dtype == wire and native.wire_dtype is None
        assert got.describe() == want.describe()
        for sizes, floating in (([4], None), ([4, 8], None), ([4, 8, 4], [True, True, False])):
            assert got.wire_bytes(sizes, floating) == want.wire_bytes(sizes, floating)
            assert native.wire_bytes(sizes, floating) == \
                jir.build_plan(jspec, dim, method, **kw).wire_bytes(sizes, floating)
        assert native.wire_bytes([4]) == 4 // tir.wire_itemsize(wire) * got.wire_bytes([4]) > 0
        assert got.wire_bytes([4], [False]) == native.wire_bytes([4])


# -- B6 and B7's plain versions -------------------------------------------------------

def pair(size, dim, r):
    """(port spec, JAX spec, port mesh of CPU positions, JAX mesh)."""
    n = int(np.prod(dim))
    return (tgrid.GridSpec(tgeo.Dim3(*size), tgeo.Dim3(*dim), tgeo.Radius.constant(r)),
            jgrid.GridSpec(jgeo.Dim3(*size), jgeo.Dim3(*dim), jgeo.Radius.constant(r)),
            tpar.DeviceMesh(dim, ["cpu"] * n),
            jpar.grid_mesh(jgeo.Dim3(*dim), jax.devices()[:n]))


def wide(jspec, dtypes, seed, hi=9.0):
    """Stacked fields of random sign and magnitude ``2 ** U(-12, hi)``
    (fp8's subnormals to past its overflow at 464), in every cell; an int32
    quantity random integers."""
    rng = np.random.RandomState(seed)
    shape = jspec.stacked_shape_zyx()
    out = {}
    for i, dt in enumerate(dtypes):
        if dt == I32:
            out[i] = rng.randint(-2 ** 30, 2 ** 30, shape).astype(I32)
        else:
            out[i] = (rng.standard_normal(shape) * 2.0 ** rng.uniform(-12, hi, shape)).astype(dt)
    return out


def exchange_both(size, dim, r, dtypes, wire, seed, fused=False, jmethod=RDMA_J):
    """One exchange in each package from the same state, with the wire;
    returns (port arrays, JAX arrays, start arrays, port exchange, JAX
    exchange)."""
    tspec, jspec, tmesh, jmesh = pair(size, dim, r)
    arrs = wide(jspec, dtypes, seed)
    jex = jpar.HaloExchange(jspec, jmesh, jmethod, wire_dtype=wire, fused=fused)
    jout = jex({k: jax.device_put(v, NamedSharding(jmesh, BLOCK_PSPEC)) for k, v in arrs.items()})
    tex = tpar.HaloExchange(tspec, RDMA_T, mesh=tmesh, wire_dtype=wire, fused=fused)
    st = mesh_state_from_jax(arrs, tspec, tmesh)
    tex(st)
    return (mesh_state_to_numpy(st, tspec), {k: np.asarray(v) for k, v in jout.items()}, arrs,
            tex, jex)


B6_CASES = [
    ("222-r1-f32-bf16", (2, 2, 2), 1, [F32, F32], BF16),
    ("222-r2-f32-bf16", (2, 2, 2), 2, [F32, F32], BF16),
    ("222-r1-f32-fp8", (2, 2, 2), 1, [F32, F32], FP8),
    ("222-r2-f32-fp8", (2, 2, 2), 2, [F32, F32], FP8),
    ("222-r1-f64-f32", (2, 2, 2), 1, [F64, F64], "float32"),
    ("222-r2-f64-bf16", (2, 2, 2), 2, [F64, F64], BF16),
    ("222-r2-f32-f16", (2, 2, 2), 2, [F32, F32], F16),
    ("222-r1-f32-f64-i32-bf16", (2, 2, 2), 1, [F32, F64, I32], BF16),
    ("222-r2-f64-fp8", (2, 2, 2), 2, [F64, F64], FP8),
]


@pytest.mark.parametrize("name,dim,r,dtypes,wire", B6_CASES, ids=[c[0] for c in B6_CASES])
def test_remote_axis_wire_matches_jax(name, dim, r, dtypes, wire):
    """16^3 (2,2,2), Q=2 or a dict of three dtypes: every cell of every
    quantity equals the JAX REMOTE_DMA exchange with the same wire; the
    int32 quantity is moved bit for bit; the halos did round."""
    got, want, start, tex, jex = exchange_both((16, 16, 16), dim, r, dtypes, wire, 60)
    native, _w, _s, _t, _j = exchange_both((16, 16, 16), dim, r, dtypes, None, 60)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} q{k}")
        if dtypes[k] == I32:
            np.testing.assert_array_equal(got[k], native[k])
        else:
            assert not np.array_equal(got[k], native[k], equal_nan=True), (name, k)
    assert tex.last_transfer_count == jex._remote.last_transfer_count
    assert tex.plan.wire_dtype == jex.plan.wire_dtype == wire


def test_remote_axis_wire_keeps_self_wrap_halos():
    """(2,1,1) r2: y and z have one position, so their halos are self-wrap
    fills and stay equal to the unnarrowed run over the compute-x columns
    (the x-halo columns crossed the wire in the x phase)."""
    got, want, _s, _t, _j = exchange_both((24, 20, 16), (2, 1, 1), 2, [F32, F64], BF16, 61)
    native, _w, _s2, _t2, _j2 = exchange_both((24, 20, 16), (2, 1, 1), 2, [F32, F64], None, 61)
    spec = pair((24, 20, 16), (2, 1, 1), 2)[0]
    off, b = spec.compute_offset(), spec.base
    xs = slice(off.x, off.x + b.x)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        for ys in (slice(off.y - 2, off.y), slice(off.y + b.y, off.y + b.y + 2)):
            np.testing.assert_array_equal(got[k][..., off.z:off.z + b.z, ys, xs],
                                          native[k][..., off.z:off.z + b.z, ys, xs])
        for zs in (slice(off.z - 2, off.z), slice(off.z + b.z, off.z + b.z + 2)):
            np.testing.assert_array_equal(got[k][..., zs, off.y:off.y + b.y, xs],
                                          native[k][..., zs, off.y:off.y + b.y, xs])
        x_halo = got[k][..., off.z:off.z + b.z, off.y:off.y + b.y, off.x - 2:off.x]
        assert not np.array_equal(x_halo, native[k][..., off.z:off.z + b.z, off.y:off.y + b.y,
                                                     off.x - 2:off.x])


B7_CASES = [
    ("222-r2-f32-bf16", (16, 16, 16), (2, 2, 2), 2, [F32, F32], BF16),
    ("222-r2-f32-fp8", (16, 16, 16), (2, 2, 2), 2, [F32, F32], FP8),
    ("211-r1-f64-f32", (24, 20, 16), (2, 1, 1), 1, [F64, F64], "float32"),
    ("112-r1-mixed-bf16", (16, 16, 20), (1, 1, 2), 1, [F32, F64, I32], BF16),
]


@pytest.mark.parametrize("name,size,dim,r,dtypes,wire", B7_CASES, ids=[c[0] for c in B7_CASES])
def test_fused_exchange_wire_matches_jax(name, size, dim, r, dtypes, wire):
    """The fused exchange with a wire equals the JAX fused exchange with
    the same wire, which equals JAX's composed exchange with it, on the
    cells both fill (every declared halo)."""
    got, want, _s, tex, jex = exchange_both(size, dim, r, dtypes, wire, 62, fused=True)
    _g, composed, _s2, _t, _j = exchange_both(size, dim, r, dtypes, wire, 62,
                                              jmethod=jpar.Method.AXIS_COMPOSED)
    spec = pair(size, dim, r)[0]
    off, b = spec.compute_offset(), spec.base
    box = (..., slice(off.z - r, off.z + b.z + r), slice(off.y - r, off.y + b.y + r),
           slice(off.x - r, off.x + b.x + r))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} q{k}")
        np.testing.assert_array_equal(want[k][box], composed[k][box], err_msg=f"{name} q{k}")
    assert tex.last_transfer_count == jex._remote.last_transfer_count


# -- jacobi3d over the mesh, and the no-op on one device -------------------------------

@functools.lru_cache(maxsize=None)
def jax_app(variant, wire, layout="mesh"):
    kw = dict(iters=5, chunk=2, weak=False, wire_dtype=wire)
    if variant:
        kw["kernel_variant"] = variant
        kw["deep_halo"] = 2 if variant == "persistent" else 1
    if layout == "mesh":
        return japp.run(16, 16, 16, devices=jax.devices()[:8], method=RDMA_J, **kw)
    if layout == "resident":
        return japp.run(16, 16, 16, devices=jax.devices()[:1], partition=(2, 2, 2), deep_halo=2,
                        **kw)
    return japp.run(16, 16, 16, devices=jax.devices()[:1], method=RDMA_J, **kw)


def field(r):
    return r["domain"].get_curr_global(r["handle"])


@pytest.mark.parametrize("wire", [BF16, FP8, "float8_e5m2"])
@pytest.mark.parametrize("variant", [None, "fused"], ids=["plain", "fused"])
def test_jacobi3d_mesh_wire_matches_jax_app(variant, wire):
    """16^3 over 8 positions, 5 steps in chunks of 2 after a warm-up chunk:
    the gathered field equals the JAX app's with the same wire, and
    differs from the unnarrowed run."""
    kw = dict(iters=5, chunk=2, weak=False, devices=["cpu"] * 8, method=RDMA_T)
    if variant:
        kw["kernel_variant"] = variant
    got = tapp.run(16, 16, 16, wire_dtype=wire, **kw)
    np.testing.assert_array_equal(field(got), field(jax_app(variant, wire)))
    assert got["domain"].halo_exchange.wire_dtype == wire
    assert not np.array_equal(field(got), field(tapp.run(16, 16, 16, **kw)))


NOOP = {"resident": dict(device="cpu", partition=(2, 2, 2), deep_halo=2),
        "one-block-plain": dict(device="cpu", method=RDMA_T),
        "one-block-fused": dict(device="cpu", method=RDMA_T, kernel_variant="fused"),
        "one-block-persistent": dict(device="cpu", method=RDMA_T, kernel_variant="persistent",
                                     deep_halo=2)}


@pytest.mark.parametrize("layout", sorted(NOOP))
def test_wire_is_a_no_op_on_one_device(layout):
    """Nothing crosses on one device: the run with a wire equals the one
    without, and the JAX app's one-device run with the wire."""
    kw = dict(iters=5, chunk=2, weak=False, **NOOP[layout])
    got = tapp.run(16, 16, 16, wire_dtype=BF16, **kw)
    np.testing.assert_array_equal(field(got), field(tapp.run(16, 16, 16, **kw)))
    variant = kw.get("kernel_variant")
    want = jax_app(variant, BF16, "resident" if layout == "resident" else "one")
    np.testing.assert_array_equal(field(got), field(want))


def test_persistent_mesh_wire_raises():
    spec = tgrid.GridSpec(tgeo.Dim3(16, 16, 16), tgeo.Dim3(2, 2, 2), tgeo.Radius.constant(2))
    with pytest.raises(NotImplementedError, match="diverges"):
        tpar.HaloExchange(spec, RDMA_T, mesh=tpar.DeviceMesh((2, 2, 2), ["cpu"] * 8),
                          persistent=True, wire_dtype=FP8)
    with pytest.raises(NotImplementedError, match="Design divergences"):
        tapp.run(16, 16, 16, iters=2, weak=False, devices=["cpu"] * 8, method=RDMA_T,
                 kernel_variant="persistent", deep_halo=2, wire_dtype=BF16)


def test_jacobi3d_cli_wire_dtype(capsys):
    argv = ["--x", "16", "--y", "16", "--z", "16", "--iters", "5", "--no-weak", "--method",
            "remote-dma", "--devices", ",".join(["cpu"] * 8), "--wire-dtype", BF16]
    assert tapp.main(argv) == 0
    row = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    want = japp.run(16, 16, 16, devices=jax.devices()[:8], method=RDMA_J, iters=5, weak=False,
                    wire_dtype=BF16)
    assert row[:8] == japp.csv_row(want).split(",")[:8]
    # a format the card does not convert runs too (the SOFT instantiation on
    # the card; its plain version here), as the JAX app does
    assert tapp.main(argv[:-1] + ["float8_e4m3b11fnuz"]) == 0
    row = capsys.readouterr().out.strip().splitlines()[-1].split(",")
    want = japp.run(16, 16, 16, devices=jax.devices()[:8], method=RDMA_J, iters=5, weak=False,
                    wire_dtype="float8_e4m3b11fnuz")
    assert row[:8] == japp.csv_row(want).split(",")[:8]
    with pytest.raises(ValueError, match="unknown dtype"):
        tapp.main(argv[:-1] + ["bf17"])
