"""The multistep kernel's launch shape, shared-memory budget, z-chunk rule
and depth planner, mirrored in Python (ops/stencil_kernels.py) and held to
the kernel source, for fp32 and fp64 cells (16-byte runs of 4 or 2 cells, a
tile of 256 bytes of cells); and the single-block pass's issue floor. CPU
only: the kernel itself is held to its plain version by chip_smoke.py
phases 2, 7 and 13."""

import pathlib
import re

import pytest

from stencil_tpu_torch.domain import GridSpec
from stencil_tpu_torch.geometry import Dim3, Radius
from stencil_tpu_torch.ops import stencil_kernels as sk
from stencil_tpu_torch.utils import roofline

SRC = (pathlib.Path(sk.__file__).resolve().parent.parent / "csrc" /
       "jacobi_multistep.cu").read_text()
# H100: shared memory one block may use, and an SM's, of which each
# resident block takes 1 KB for itself; threads a block may have
SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472
MAX_THREADS = 1024
KS = range(1, sk.MULTISTEP_KMAX + 1)
ITEMS = (4, 8)


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def test_constants_mirror_the_kernel_source():
    assert sk.MULTISTEP_TILE == (_const("TX_BYTES") // 4, _const("TY"))
    assert sk.MULTISTEP_TILE_Y_HI == _const("TYHI")
    assert sk.MULTISTEP_KLO == _const("KLO")
    assert sk.MULTISTEP_KMAX == _const("KMAX")
    assert sk.MULTISTEP_LOOK == _const("LOOK")
    assert sk.SMEM_LIMIT == SMEM_PER_BLOCK
    # the shape's formulas, per cell type (Shape<K, T>)
    for text in ("C = 16 / (int)sizeof(T)", "TX = TX_BYTES / (int)sizeof(T)",
                 "TYK = K <= KLO ? TY : TYHI * 4 / (int)sizeof(T)",
                 "RUNS = (C - 1 + TX + C - 1 + 2 * K + C - 1) / C", "PITCH = C * RUNS",
                 "SMEM = (long long)sizeof(T) * (PLANES * PLANE + 2 * PITCH)"):
        assert text in SRC, text


@pytest.mark.parametrize("item", ITEMS)
@pytest.mark.parametrize("k", KS)
def test_launch_shape(k, item):
    """One 16-byte run (C cells) per thread, a row of runs wide enough for
    the first tile of a row (up to C - 1 columns wider) grown by k at any
    16-byte phase, threads in whole warps; the fp64 tile is as many bytes
    wide as the fp32 one, so it has as many runs a row give or take the
    k cells of its ghost zone."""
    c = 16 // item
    sh = sk.multistep_shape(k, item)
    tx, ty = sh["tile"]
    assert tx * item == _const("TX_BYTES")
    assert ty == (_const("TY") if k <= _const("KLO") else _const("TYHI") * 4 // item)
    assert sh["rows"] == ty + 2 * k
    assert c * sh["runs"] >= (c - 1) + tx + (c - 1) + 2 * k > c * (sh["runs"] - 1)
    assert sh["pitch"] == c * sh["runs"] and sh["pitch"] * item % 16 == 0
    t = sh["threads"]
    assert t % 32 == 0 and sh["rows"] * sh["runs"] <= t < sh["rows"] * sh["runs"] + 32
    assert t <= MAX_THREADS


@pytest.mark.parametrize("item", ITEMS)
@pytest.mark.parametrize("k", KS)
def test_shared_memory_budget(k, item):
    """A guard row, the stage-0 ring of LOOK + 2 planes, two planes per
    intermediate stage and a guard row, within one block's limit, in both
    cell types."""
    sh = sk.multistep_shape(k, item)
    planes = _const("LOOK") + 2 + 2 * (k - 1)
    want = item * (planes * sh["rows"] * sh["pitch"] + 2 * sh["pitch"])
    assert sk.multistep_smem_bytes(k, item) == want <= SMEM_PER_BLOCK
    # one block of every depth fits an SM
    assert want + 1024 <= SMEM_PER_SM
    if item == 8 and k <= sk.MULTISTEP_KLO:
        # the same bytes as the fp32 tile, give or take the ghost zone's cells
        f32 = sk.multistep_smem_bytes(k, 4)
        assert 0.9 * f32 <= want <= 1.2 * f32
    if item == 8:
        # at most 512 threads at every depth: the 128-register cap
        assert sh["threads"] <= (768 if k <= sk.MULTISTEP_KLO else 512)


@pytest.mark.parametrize("size,part,k,slots,item,want", [
    ((512, 512, 512), (1, 1, 1), 3, 132, 4, 9),   # the main path: 128 tiles
    ((512, 512, 512), (2, 2, 2), 3, 132, 4, 4),   # resident deep_halo=4: 256 tiles
    ((128, 128, 128), (1, 1, 1), 3, 132, 4, 10),  # the campaign's 128^3 tenants
    ((32, 32, 32), (1, 1, 1), 3, 132, 4, 2),      # and its 32^3 tenants
    ((512, 512, 512), (1, 1, 1), 4, 132, 4, 5),
    ((32, 32, 32), (1, 1, 1), 6, 132, 4, 1),
    ((512, 512, 512), (1, 1, 1), 3, 132, 8, 8),   # fp64: 256 tiles of 32 x 32
    ((512, 512, 512), (2, 2, 2), 3, 132, 8, 4),   # fp64 residents: 512 tiles
    ((128, 128, 128), (1, 1, 1), 3, 132, 8, 10),
    ((32, 32, 32), (1, 1, 1), 3, 132, 8, 2),
])
def test_zchunks_on_the_layouts(size, part, k, slots, item, want):
    spec = GridSpec(Dim3(*size), Dim3(*part), Radius.constant(max(k, 1)))
    assert sk.multistep_zchunks(spec, k, slots, item) == want


@pytest.mark.parametrize("size,part", [((512, 512, 512), (1, 1, 1)),
                                       ((512, 512, 512), (2, 2, 2)),
                                       ((128, 128, 128), (1, 1, 1)),
                                       ((32, 32, 32), (1, 1, 1)),
                                       ((67, 45, 29), (1, 1, 1)),
                                       ((130, 70, 40), (1, 1, 1))])
@pytest.mark.parametrize("k", [1, 3, 6])
@pytest.mark.parametrize("slots", [1, 132, 264])
@pytest.mark.parametrize("item", ITEMS)
def test_zchunks_rule(size, part, k, slots, item):
    """At least one chunk, none shorter than 4k planes unless there is only
    one, every plane covered once, and no other count finishes sooner by
    the rule's own measure (every block's steps spread over the slots plus
    one block's steps)."""
    spec = GridSpec(Dim3(*size), Dim3(*part), Radius.constant(k))
    n = sk.multistep_zchunks(spec, k, slots, item)
    nz = spec.base.z
    assert 1 <= n <= max(1, nz // (4 * k))
    chunk = -(-nz // n)
    assert chunk * n >= nz and chunk * (n - 1) < nz
    tx, ty = sk.multistep_shape(k, item)["tile"]
    tiles = -(-size[0] // part[0] // tx) * -(-size[1] // part[1] // ty) * spec.num_blocks()

    def steps(m):
        per = -(-nz // m) + 2 * k
        return tiles * m * per / slots + per

    assert all(steps(n) <= steps(m) for m in range(1, max(1, nz // (4 * k)) + 1))


def test_planner_bounds():
    """The planner never exceeds KPLAN nor what was asked, and KPLAN is a
    depth the kernel takes and the loop engages (k >= 2)."""
    assert 2 <= sk.MULTISTEP_KPLAN <= sk.MULTISTEP_KMAX
    for want in range(0, 20):
        got = sk.plan_multistep_depth(want)
        assert 0 <= got <= min(want, sk.MULTISTEP_KPLAN)
        assert got == min(want, sk.MULTISTEP_KPLAN)


def test_stage_updates_and_issue_floor():
    """At 512^3 and k=3 the 64x32 tiles make 3.30 cell updates per output
    cell (1.10x the 3 of an untiled pass); 7 unfused fp32 operations each
    take the card at least 0.093 ms to issue, under the 0.3205 ms bytes
    bound of the pass."""
    spec = GridSpec(Dim3(512, 512, 512), Dim3(1, 1, 1), Radius.constant(1))
    u = sk.multistep_stage_updates(spec, 3)
    assert u == 128 * sum((64 + 2 * g) * (32 + 2 * g) * (512 + 2 * g) for g in range(3))
    assert u / 512 ** 3 == pytest.approx(3.3046, abs=1e-4)
    assert roofline.issue_ms(7 * u) == pytest.approx(0.0928, abs=1e-4)
    assert roofline.bound_ms(8 * 512 ** 3, 0)[0] == pytest.approx(0.3205, abs=1e-4)
    assert sk.multistep_stage_updates(spec, 1) == 512 ** 3


def test_kernel_note_names_what_it_replaces():
    head = SRC[:SRC.index("#include")]
    for what in ("make_pallas_jacobi_multistep", "_make_multistep_row_tiled",
                 "What bounds it on an H100", "Design"):
        assert what in head
