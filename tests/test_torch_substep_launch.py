"""The Astaroth substep kernel's launch shape, shared-memory budget and ring
schedule, mirrored in Python (ops/astaroth_substep.py) and held to the
kernel source; and the unfused issue floor of utils/roofline.py. CPU only:
the kernel itself is held to its plain version by chip_smoke.py phase 5."""

import pathlib
import re

import pytest
import torch

from stencil_tpu_torch.domain import GridSpec
from stencil_tpu_torch.geometry import Dim3, Radius
from stencil_tpu_torch.ops import astaroth_substep as asub
from stencil_tpu_torch.utils import roofline

SRC = (pathlib.Path(asub.__file__).resolve().parent.parent / "csrc" /
       "astaroth_substep.cu").read_text()
# H100: shared memory one block may use, and an SM's, of which each
# resident block takes 1 KB for itself
SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472
CELLS_256 = 256 ** 3


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _enum(name):
    body = re.sub(r"//.*", "", re.search(rf"enum {name} \{{(.*?)\}};", SRC, re.S).group(1))
    return [w for w in re.findall(r"\b([A-Z][A-Z0-9_]*)\b", body) if w != "NH"]


def test_issue_floor_of_the_fp64_stage():
    """949 unfused fp64 operations per cell at 256^3: 0.952 ms."""
    assert roofline.issue_ms(949 * CELLS_256, torch.float64) == pytest.approx(0.952, abs=5e-4)


@pytest.mark.parametrize("dtype,ms", [(torch.float64, 0.968), (torch.float32, 0.484)])
def test_issue_floor_of_the_main_path_mix(dtype, ms):
    ops = sum(asub.FLOPS_PER_CELL) / 3 * CELLS_256
    assert roofline.issue_ms(ops, dtype) == pytest.approx(ms, abs=5e-4)


def test_issue_floor_is_half_the_data_sheet_rate():
    """The data sheet counts a fused multiply-add as two operations; an
    unfused kernel issues one per lane and clock, so its floor is about
    twice bound_ms's operations floor (1.98 GHz against the boost clock)."""
    for dtype in (torch.float64, torch.float32):
        ratio = roofline.issue_ms(1e12, dtype) / roofline.bound_ms(0, 1e12, dtype)[0]
        assert 1.9 < ratio < 2.1
    assert roofline.bound_ms(0, 1e12, torch.float64)[0] > 0  # bound_ms unchanged


def test_launch_shape_mirrors_the_kernel_source():
    assert asub.TILE == (_const("BX"), _const("BY"))
    assert asub.GROUPS == len(_enum("Group"))
    assert asub.HANDOVER == len(_enum("Hand"))
    assert asub.RING_SLOTS == _const("SLOTS")
    assert asub.RING_STRIDE == _const("PSTRIDE")
    assert asub.RING_STRIDE >= (asub.TILE[0] + 2 * asub.HALO) * (asub.TILE[1] + 2 * asub.HALO)
    assert asub.RING_STRIDE * 4 % 128 == 0
    assert asub.HALO == _const("H")
    assert asub.substep_threads() == asub.GROUPS * asub.TILE[0] * asub.TILE[1]
    # one footprint cell per thread fills the ring
    footprint = (asub.TILE[0] + 2 * asub.HALO) * (asub.TILE[1] + 2 * asub.HALO)
    assert footprint <= asub.substep_threads()


@pytest.mark.parametrize("dtype,blocks", [(torch.float64, 1), (torch.float32, 2)])
def test_shared_memory_budget(dtype, blocks):
    """fp64's ring and hand-over fit one block per SM, fp32's two; the
    kernel asks ptxas for as many (min_blocks)."""
    item = torch.empty((), dtype=dtype).element_size()
    b = asub.substep_smem_bytes(item)
    assert b == (8 * asub.RING_SLOTS * asub.RING_STRIDE + asub.HANDOVER * 128) * item + 16
    assert b <= SMEM_PER_BLOCK
    assert blocks * (b + 1024) <= SMEM_PER_SM < (blocks + 1) * (b + 1024)


@pytest.mark.parametrize("size", [(256, 256, 256), (64, 64, 64), (40, 24, 20), (33, 13, 7),
                                  (200, 100, 61), (48, 40, 36), (1, 1, 1)])
@pytest.mark.parametrize("blocks_in_flight", [1, 132, 264])
def test_zchunk_covers_every_plane_once(size, blocks_in_flight):
    spec = GridSpec(Dim3(*size), Dim3(1, 1, 1), Radius.constant(3))
    zc = asub.substep_zchunk(spec, blocks_in_flight)
    # the kernel's grid: one block per tile and z chunk
    gx, gy, gz = (-(-size[0] // asub.TILE[0]), -(-size[1] // asub.TILE[1]), -(-size[2] // zc))
    assert 1 <= zc <= size[2]
    assert (gz - 1) * zc < size[2] <= gz * zc  # no empty chunk
    assert (gx - 1) * asub.TILE[0] < size[0] <= gx * asub.TILE[0]
    assert (gy - 1) * asub.TILE[1] < size[1] <= gy * asub.TILE[1]
    want = -(-blocks_in_flight * asub.WAVES // (gx * gy))
    assert gz <= max(1, min(size[2], want))


def test_zchunk_at_the_main_path_shape():
    """256^3 on 132 SMs of one fp64 block each: 512 tiles, one chunk."""
    spec = GridSpec(Dim3(256, 256, 256), Dim3(1, 1, 1), Radius.constant(3))
    assert asub.substep_zchunk(spec, 132) == 256


@pytest.mark.parametrize("z0,z1", [(0, 1), (0, 2), (3, 10), (0, 86), (86, 172)])
def test_ring_schedule(z0, z1):
    """The kernel's slots: plane zp of a chunk starting at z0 lives in slot
    (zp - z0 + H) mod SLOTS; plane z reads z-3 .. z+3 through
    slot[j] = (z - z0 + j) mod SLOTS, while plane z+4 is copied into the
    one slot that window does not use."""
    h, slots = asub.HALO, asub.RING_SLOTS

    def slot(zp):
        return (zp - z0 + h) % slots

    held = {slot(zp): zp for zp in range(z0 - h, z0 + h + 1)}
    for z in range(z0, z1):
        window = range(z - h, z + h + 1)
        assert [held[(z - z0 + j) % slots] for j in range(2 * h + 1)] == list(window)
        if z + 1 < z1:
            assert slot(z + h + 1) not in {slot(p) for p in window}
            held[slot(z + h + 1)] = z + h + 1
