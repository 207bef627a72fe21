"""Every floating wire format the JAX package narrows through beyond bf16,
fp16, fp8 e4m3fn and fp32 (``float8_e5m2``, ``float8_e4m3fnuz``,
``float8_e5m2fnuz``, ``float8_e4m3b11fnuz``, ``float8_e3m4``,
``float8_e4m3``, ``float8_e8m0fnu``, ``float4_e2m1fn``), in the port
(``ops/halo_fill.WIRE_FORMATS``, ``wire_round``) against the JAX package
on its virtual CPU devices: the rounding of fp32 and fp64 words against
``jax.jit(lambda a: a.astype(w).astype(a.dtype))`` over a sweep of every
exponent with the mantissas around each format's rounding point, and at
each format's edges (largest value, overflow tie, least normal,
subnormals, signed zeros, infinities, NaN, fp64 values one rounding and
two apart); each format's table row pinned to what JAX gives; and B6's
and B7's plain versions through each format on a 16^3 (2,2,2) r1 mesh of
fp32, fp64 and int32 quantities against the JAX AXIS_COMPOSED exchange
with the same wire. Inputs are seeded or enumerated numpy arrays.
Tolerance: bit-exact, NaN equal to NaN, the sign of every non-NaN value
included."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import stencil_tpu.domain.grid as jgrid
import stencil_tpu.geometry as jgeo
import stencil_tpu.parallel as jpar
import stencil_tpu_torch.domain.grid as tgrid
import stencil_tpu_torch.geometry as tgeo
import stencil_tpu_torch.parallel as tpar
from stencil_tpu.parallel.mesh import BLOCK_PSPEC
from stencil_tpu_torch.convert import mesh_state_from_jax, mesh_state_to_numpy
from stencil_tpu_torch.ops import halo_fill as tfill

torch.set_num_threads(2)

F32, F64, I32 = np.float32, np.float64, np.int32
FORMATS = ["float8_e5m2", "float8_e4m3fnuz", "float8_e5m2fnuz", "float8_e4m3b11fnuz",
           "float8_e3m4", "float8_e4m3", "float8_e8m0fnu", "float4_e2m1fn"]
CASES = [(w, d) for w in FORMATS for d in (F32, F64)]
IDS = [f"{w}-{np.dtype(d).name}" for w, d in CASES]


def jax_round(x: np.ndarray, wire: str) -> np.ndarray:
    return np.asarray(jax.jit(lambda a: a.astype(wire).astype(a.dtype))(jnp.asarray(x)))


def port_round(x: np.ndarray, wire: str) -> np.ndarray:
    return tfill.wire_round(torch.from_numpy(x), wire).numpy()


def assert_same(got: np.ndarray, want: np.ndarray, x: np.ndarray, label: str) -> None:
    """Bit-exact up to the NaN payload: NaN where NaN, equal elsewhere and
    of the same sign (zeros included)."""
    assert got.dtype == want.dtype == x.dtype
    nan = np.isnan(want)
    bad = (np.isnan(got) != nan) | (~nan & ((got != want) | (np.signbit(got) != np.signbit(want))))
    assert not bad.any(), (label, [(float(x[i]).hex(), float(want[i]), float(got[i]))
                                   for i in np.flatnonzero(bad)[:6]])


def sweep(dtype) -> np.ndarray:
    """Every exponent of fp32 (and fp64's from 2^-200 to 2^200, its
    subnormals and its largest) with both signs, each with mantissas that
    sit on, next to and across every bit position's rounding point, the
    top bits enumerated over low ends around a half, and seeded random
    ones."""
    rng = np.random.RandomState(3)
    bits = 23 if dtype == F32 else 52
    uint = np.uint32 if dtype == F32 else np.uint64
    mant = set()
    for p in range(bits):
        for base in (1 << p, 3 << p):
            mant.update(v for v in (base - 1, base, base + 1) if 0 <= v < 1 << bits)
    lo = bits - 5
    for top in range(32):
        for low in (0, 1, (1 << (lo - 1)) - 1, 1 << (lo - 1), (1 << (lo - 1)) + 1):
            mant.add((top << lo) | low)
    mant.update(int(v) for v in rng.randint(0, 1 << 30, 400).astype(np.int64) << (bits - 30))
    mant = np.array(sorted(mant), dtype=uint)
    if dtype == F32:
        exps = np.arange(256, dtype=uint)
    else:
        exps = np.concatenate([np.arange(1023 - 200, 1023 + 201), [0, 1, 2046, 2047]]).astype(uint)
    b = (exps[:, None] << uint(bits)) | mant[None, :]
    b = np.concatenate([b.ravel(), b.ravel() | uint(1 << (8 * np.dtype(dtype).itemsize - 1))])
    return b.view(dtype)


def edges(fmt) -> list:
    """A format's edge values (both signs): its largest value, the overflow
    tie above it and the tie's neighbours, twice the largest; the least
    normal and just above it; the least subnormal, its half, quarter and
    ties; half the least normal (an exponent-only format's least value);
    the tie at 1 and fp64 values 2^-40 either side of it; 0, inf, NaN."""
    e = math.floor(math.log2(fmt.top))
    tie = fmt.top + 2.0 ** (e - fmt.mant - 1)
    sub = 2.0 ** (fmt.emin - fmt.mant)
    half = 1 + 2.0 ** -(fmt.mant + 1)
    vals = [0.0, math.inf, math.nan, 1.0, 1.5, 3.0, 3.3, fmt.top, tie, math.nextafter(tie, 0.0),
            math.nextafter(tie, math.inf), 2 * fmt.top, 2.0 ** fmt.emin,
            2.0 ** fmt.emin * (1 + 2.0 ** -20), 2.0 ** (fmt.emin - 1), sub, sub / 2, sub / 4,
            1.5 * sub, 2.5 * sub, half, half + 2.0 ** -40, half - 2.0 ** -40]
    return [s * v for v in vals for s in (1.0, -1.0)]


@pytest.mark.parametrize("wire,dtype", CASES, ids=IDS)
def test_wire_round_matches_jax_everywhere(wire, dtype):
    """The sweep and the format's edges, rounded by the port's one plain
    rounding (``_round_format``, the format's parameters) and by JAX."""
    with np.errstate(over="ignore"):  # twice e8m0's largest is inf in fp32
        x = np.concatenate([sweep(dtype), np.array(edges(tfill.WIRE_FORMATS[wire]), dtype)])
    assert_same(port_round(x, wire), jax_round(x, wire), x, wire)


# the JAX package's results at each format's edges (jax 0.9.0, jit):
# (largest finite, least normal, what overflow and +inf give, what -0 gives,
# what NaN gives); "nan", "-0", "+0", "inf" and "sat" (+-largest) are rules
TABLE = {
    "float8_e5m2": (57344.0, 2.0 ** -14, "inf", "-0", "nan"),
    "float8_e4m3fnuz": (240.0, 2.0 ** -7, "nan", "+0", "nan"),
    "float8_e5m2fnuz": (57344.0, 2.0 ** -15, "nan", "+0", "nan"),
    "float8_e4m3b11fnuz": (30.0, 2.0 ** -10, "nan", "+0", "nan"),
    "float8_e3m4": (15.5, 2.0 ** -2, "inf", "-0", "nan"),
    "float8_e4m3": (240.0, 2.0 ** -6, "inf", "-0", "nan"),
    "float8_e8m0fnu": (2.0 ** 127, 2.0 ** -127, "nan", "nan", "nan"),
    "float4_e2m1fn": (6.0, 1.0, "sat", "-0", "-0"),
}


def _is(v: float, rule: str, top: float) -> bool:
    return {"nan": math.isnan(v), "inf": v == math.inf, "sat": v == top,
            "-0": v == 0 and math.copysign(1, v) < 0,
            "+0": v == 0 and math.copysign(1, v) > 0}[rule]


@pytest.mark.parametrize("wire", FORMATS)
@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_wire_format_table(wire, dtype):
    """Each format's row of the table, pinned to JAX and to the port: the
    largest finite value rounds to itself and the overflow tie above it
    overflows by the format's rule, as +inf does; the least normal
    (``2 ** emin``, or an exponent-only format's least value) is kept and
    a value a quarter of the least subnormal above zero rounds to zero
    (to the least value, or NaN in fp64, without a zero); -0 and NaN give
    the format's results."""
    fmt = tfill.WIRE_FORMATS[wire]
    top, least, over, neg_zero, nan = TABLE[wire]
    assert (fmt.top, fmt.itemsize, fmt.code == tfill.SOFT_WIRE) == \
        (top, 1, wire != "float8_e5m2")
    tie = fmt.top + 2.0 ** (math.floor(math.log2(fmt.top)) - fmt.mant - 1)
    x = np.array([top, tie, math.inf, least, -0.0, math.nan, 2.0 ** (fmt.emin - fmt.mant) / 4],
                 dtype)
    for got in (jax_round(x, wire), port_round(x, wire)):
        assert got[0] == top
        assert _is(float(got[1]), over, top) and _is(float(got[2]), over, top)
        assert got[3] == least
        assert _is(float(got[4]), neg_zero, top) and _is(float(got[5]), nan, top)
        if fmt.exp_only:
            assert got[6] == least if dtype == F32 else math.isnan(got[6])
        else:
            assert got[6] == 0
    if not fmt.exp_only:
        # the least normal is 2^emin: the quantum is 2^(emin - mant) from
        # there up to twice it, and no finer below it
        assert least == 2.0 ** fmt.emin
        sub = 2.0 ** (fmt.emin - fmt.mant)
        x = np.array([least + sub, least / 2 + 3 * sub / 8], dtype)
        for got in (jax_round(x, wire), port_round(x, wire)):
            assert got[0] == least + sub and got[1] == least / 2


@pytest.mark.parametrize("wire", FORMATS)
def test_fp64_rounds_once(wire):
    """fp64 data rounds once from its value (XLA's jit): a tie plus 2^-40
    rounds up where rounding through fp32 first would tie to even; fp32 data
    of the same value rounds down."""
    fmt = tfill.WIRE_FORMATS[wire]
    q = 2.0 ** -fmt.mant  # the quantum at 1
    x = np.array([1 + q / 2 + 2.0 ** -40, 1 + q / 2 - 2.0 ** -40, 1 + q / 2])
    once = jax_round(x, wire)
    np.testing.assert_array_equal(port_round(x, wire), once)
    # the tie itself goes to the even neighbour: 1, or 2 with no mantissa
    assert once[0] == 1 + q and once[1] == 1 and once[2] == (2 if fmt.mant == 0 else 1)
    twice = port_round(x.astype(F32), wire)
    np.testing.assert_array_equal(twice, jax_round(x.astype(F32), wire))
    assert twice[0] == twice[2]


# -- B6's and B7's plain versions through each format ------------------------------------

def _mesh_pair():
    size, dim = (16, 16, 16), (2, 2, 2)
    return (tgrid.GridSpec(tgeo.Dim3(*size), tgeo.Dim3(*dim), tgeo.Radius.constant(1)),
            jgrid.GridSpec(jgeo.Dim3(*size), jgeo.Dim3(*dim), jgeo.Radius.constant(1)),
            tpar.DeviceMesh(dim, ["cpu"] * 8), jpar.grid_mesh(jgeo.Dim3(*dim), jax.devices()[:8]))


def _fields(jspec, seed):
    """fp32 and fp64 fields of random sign and magnitude 2^U(-20, 20) (each
    format's subnormals to past its overflow) and an int32 field."""
    rng = np.random.RandomState(seed)
    shape = jspec.stacked_shape_zyx()
    wide = rng.standard_normal(shape) * 2.0 ** rng.uniform(-20, 20, shape)
    return {0: wide.astype(F32), 1: (wide * (1 + 2.0 ** -30)).astype(F64),
            2: rng.randint(-2 ** 30, 2 ** 30, shape).astype(I32)}


@pytest.mark.parametrize("wire", FORMATS)
def test_mesh_carriers_match_jax(wire):
    """B6 (the axis carrier) and B7 (the fused exchange carrier) over 8
    positions with the wire equal the JAX AXIS_COMPOSED exchange with the
    same wire on every cell the composed exchange fills (B6: every cell),
    the int32 quantity moved bit for bit; the halos did round; the
    transfer counts are the unnarrowed exchange's."""
    tspec, jspec, tmesh, jmesh = _mesh_pair()
    arrs = _fields(jspec, 80)
    jex = jpar.HaloExchange(jspec, jmesh, jpar.Method.AXIS_COMPOSED, wire_dtype=wire)
    want = {k: np.asarray(v) for k, v in jex({k: jax.device_put(
        v, NamedSharding(jmesh, BLOCK_PSPEC)) for k, v in arrs.items()}).items()}
    off, b = tspec.compute_offset(), tspec.base
    box = (..., slice(off.z - 1, off.z + b.z + 1), slice(off.y - 1, off.y + b.y + 1),
           slice(off.x - 1, off.x + b.x + 1))
    native = mesh_state_from_jax(arrs, tspec, tmesh)
    tpar.HaloExchange(tspec, tpar.Method.REMOTE_DMA, mesh=tmesh)(native)
    native = mesh_state_to_numpy(native, tspec)
    counts = {}
    for fused in (False, True):  # the unnarrowed counts (held to JAX's in test_torch_wire.py)
        ex = tpar.HaloExchange(tspec, tpar.Method.REMOTE_DMA, mesh=tmesh, fused=fused)
        ex(mesh_state_from_jax(arrs, tspec, tmesh))
        counts[fused] = ex.last_transfer_count
    for fused in (False, True):
        tex = tpar.HaloExchange(tspec, tpar.Method.REMOTE_DMA, mesh=tmesh, wire_dtype=wire,
                                fused=fused)
        st = mesh_state_from_jax(arrs, tspec, tmesh)
        tex(st)
        got = mesh_state_to_numpy(st, tspec)
        cells = (...,) if not fused else box  # B7 fills the declared halos only
        for k in want:
            g, w, n = got[k][cells], want[k][cells], native[k][cells]
            np.testing.assert_array_equal(g, w, err_msg=f"{wire} fused={fused} q{k}")
            if k == 2:
                np.testing.assert_array_equal(g, n)
            else:
                assert not np.array_equal(g, n, equal_nan=True)
        assert tex.last_transfer_count == counts[fused] > 0
        assert tex.plan.wire_dtype == wire


@pytest.mark.parametrize("wire", ["float8_e5m2", "float4_e2m1fn"])
def test_plan_tool_prices_the_format_as_jax(wire, capsys):
    """``plan_tool explain --wire-dtype`` renders the requested plan's IR
    and its wire bytes (one byte a crossing cell) as the JAX package's
    plan_tool does (the ranking above it differs by the candidates the port
    does not take: auto-spmd)."""
    import stencil_tpu.apps.plan_tool as jtool
    import stencil_tpu_torch.apps.plan_tool as ttool

    argv = ["explain", "--method", "remote-dma", "--wire-dtype", wire, "--x", "32", "--y", "32",
            "--z", "32", "--ndev", "8"]
    ir = []
    for tool in (jtool, ttool):
        assert tool.main(argv) == 0
        ir.append(capsys.readouterr().out.split("plan IR of the requested")[1])
    assert ir[0] == ir[1]
    assert f"wire bytes (1 fp32 quantity): 55296 ({wire} on the wire; 221184 native)" in ir[1]


def test_checkpoint_records_the_format_and_a_resume_under_another_warns(tmp_path, capfd):
    """The snapshot's manifest names the wire format; restoring it under
    another format (or none) warns that later halos round to the new
    one, and restores every cell; under the same format it is silent."""
    from stencil_tpu_torch import DistributedDomain

    ck = str(tmp_path / "ck")

    def make(wire):
        dd = DistributedDomain(16, 16, 16, device="cpu")
        dd.set_radius(1)
        dd.set_devices(["cpu"] * 8)
        dd.set_methods(tpar.Method.REMOTE_DMA)
        dd.set_wire_dtype(wire)
        h = dd.add_data("t", "float32")
        dd.realize()
        return dd, h

    dd, h = make("float8_e5m2")
    field = np.arange(16 ** 3, dtype=np.float32).reshape(16, 16, 16)
    dd.set_curr_global(h, field)
    dd.save_checkpoint(ck, 2, asynchronous=False)
    assert dd.plan_meta()["wire_dtype"] == "float8_e5m2"
    capfd.readouterr()
    for wire, warns in (("float8_e5m2", False), ("float4_e2m1fn", True), (None, True)):
        other, ho = make(wire)
        assert other.restore_checkpoint(ck) == 2
        err = capfd.readouterr().err
        assert ("wire_dtype float8_e5m2 -> " + str(wire) in err) == warns, err
        np.testing.assert_array_equal(other.get_curr_global(ho), field)
