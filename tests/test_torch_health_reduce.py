"""The port's health reduction (stencil_tpu_torch/ops/health_reduce.py)
against the JAX package's fused reduction (stencil_tpu.fault.health,
HealthGuard._build, and the per-lane stencil_tpu.campaign.health
SlotHealthGuard._build): the plain version over fp32 and fp64 states with
NaN, inf, -inf, subnormal and integer quantities, whole and per lane; and the
kernel's work list for a dict, a stack of lanes and a mesh state, replayed in
numpy task by task as the kernel folds it (the unsigned max of sign-cleared
bit patterns), slot for slot against the plain version. Tolerance: equal
(NaN equal to NaN)."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stencil_tpu.campaign.health as jchealth
import stencil_tpu.fault.health as jhealth
from stencil_tpu_torch.fault.health import finite_and_max
from stencil_tpu_torch.ops import _native
from stencil_tpu_torch.ops import health_reduce as hr

torch.set_num_threads(2)


def state_of(seed, dtype, shape=(4, 5, 6, 7)):
    """Four float quantities (clean, NaN and inf, -inf only, a subnormal
    maximum) and an integer one, lanes along the leading axis."""
    rng = np.random.RandomState(seed)
    clean = (rng.rand(*shape).astype(dtype) - 0.5) * 3
    bad = rng.rand(*shape).astype(dtype)
    bad[2, 1, 1, 1] = np.nan
    bad[1, 0, 2, 0] = 50.0
    bad[3, 0, 0, 0] = np.inf
    bad[0, 4, 0, 1] = np.nan
    bad[0, 3, 0, 1] = -np.inf
    neg = rng.rand(*shape).astype(dtype)
    neg[1, 1, 1, 1] = -np.inf
    tiny = np.zeros(shape, dtype)
    tiny[2, 2, 2, 2] = np.finfo(dtype).smallest_subnormal * 3
    return {"clean": clean, "bad": bad, "neg": neg, "tiny": tiny,
            "n": rng.randint(-5, 5, shape).astype(np.int32)}


def same(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def flushed(jmax, names, state, dtype, per_lane=False):
    """XLA on the CPU flushes fp32 subnormals to zero in its max, where
    torch (and the card's kernel) keep them: the one place the JAX
    reference reads otherwise, pinned here. ``jmax`` with the ``tiny``
    quantity's entry set to torch's max |x|."""
    jmax = np.array(jmax)
    t = names.index("tiny")
    if dtype == np.float32:
        assert not jmax[t].any()
        tiny = np.abs(state["tiny"])
        jmax[t] = tiny.reshape(4, -1).max(1) if per_lane else tiny.max()
    return jmax


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_matches_jax_reduction(dtype):
    state = state_of(1, dtype)
    names = sorted(state)
    jfin, jmax = jhealth.HealthGuard._build({k: jnp.asarray(v) for k, v in state.items()})
    jmax = flushed(jmax, names, state, dtype)
    got = hr.health_reduce([[torch.from_numpy(state[k])] for k in names])
    same(got[0].numpy().astype(bool), jfin)
    same(got[1], jmax)
    for i, k in enumerate(names):  # one tensor at a time
        for fin, amax in (hr.finite_and_max_plain(torch.from_numpy(state[k])),
                          finite_and_max(torch.from_numpy(state[k]))):
            same(fin, float(jfin[i]))
            same(amax, jmax[i])
    # per lane, as the campaign's SlotHealthGuard
    jfin, jmax = jchealth.SlotHealthGuard._build({k: jnp.asarray(v) for k, v in state.items()})
    jmax = flushed(jmax, names, state, dtype, per_lane=True)
    got = hr.health_reduce([[torch.from_numpy(state[k])] for k in names], per_lane=True)
    assert tuple(got.shape) == (2, len(names), 4)
    same(got[0].numpy().astype(bool), jfin)
    same(got[1], jmax)


def replay(groups, per_lane):
    """The kernel's fold, in numpy: every task of the work list read through
    its address, each element's sign-cleared pattern widened to the fp64
    pattern of the same value, an unsigned max per slot; then the last
    block's cast to (finite, float32 max)."""
    lanes = groups[0][0].shape[0] if per_lane else 1
    entries = hr._entries(groups, per_lane, lanes)
    rows = hr.work_list(entries)
    by_addr = {t.data_ptr(): t for g in groups for t in g}
    acc = np.zeros(len(groups) * lanes, np.uint64)
    covered = {addr: np.zeros(t.numel(), np.int64) for addr, t in by_addr.items()}
    for addr, count, esize, slot in rows:
        base = max(a for a in by_addr if a <= addr)
        t = by_addr[base]
        i0 = (addr - base) // esize
        assert (addr - base) % esize == 0 and i0 + count <= t.numel()
        covered[base][i0:i0 + count] += 1
        vals = np.abs(t.numpy().reshape(-1)[i0:i0 + count].astype(np.float64))
        bits = vals.view(np.uint64) & np.uint64(0x7fffffffffffffff)
        acc[slot] = max(acc[slot], bits.max(initial=0))
    for addr, c in covered.items():  # every float element read exactly once
        if by_addr[addr].is_floating_point():
            assert (c == 1).all()
        else:
            assert (c == 0).all()
    finite = (acc < np.uint64(0x7ff0000000000000)).astype(np.float32)
    amax = acc.view(np.float64).astype(np.float32)
    shape = (len(groups), lanes) if per_lane else (len(groups),)
    return np.stack([finite.reshape(shape), amax.reshape(shape)])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_work_list_replays_to_the_plain_version(dtype, monkeypatch):
    """A dict of quantities (one slot each), a stack of lanes (one slot a
    lane, lanes whose starts miss the 16-byte grid) and a mesh state (every
    position's block in its quantity's slot), with tasks small enough that
    tensors and lanes span several."""
    monkeypatch.setattr(hr, "TASK_BYTES", 256)
    state = state_of(2, dtype)
    names = sorted(state)
    cases = [
        ([[torch.from_numpy(state[k])] for k in names], False),
        ([[torch.from_numpy(state[k][:, :3, :5, :3].copy())] for k in names], True),
        ([[torch.from_numpy(np.ascontiguousarray(state[k][i:i + 1, None, None]))
           for i in range(4)] for k in ("bad", "clean", "n", "tiny")], False),
    ]
    for groups, per_lane in cases:
        want = hr.health_reduce(groups, per_lane).numpy()
        got = replay(groups, per_lane)
        same(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_work_list_rows():
    rows = hr.work_list([(4096, 3 * hr.TASK_BYTES // 4 + 5, 4, 2, 1), (1000, 10, 8, 7, 3)])
    per = hr.TASK_BYTES // 4
    np.testing.assert_array_equal(rows, [
        [4096, per, 4, 2], [4096 + hr.TASK_BYTES, per, 4, 2],
        [4096 + 2 * hr.TASK_BYTES, per, 4, 2], [4096 + 3 * hr.TASK_BYTES, 5, 4, 2],
        [1000, 10, 8, 7], [1080, 10, 8, 8], [1160, 10, 8, 9]])
    assert hr.work_list([]).shape == (0, 4)


def test_task_bytes_mirror_the_source():
    src = (pathlib.Path(_native.CSRC) / "health_reduce.cu").read_text()
    m = re.search(r"constexpr long long TASK_BYTES = 1LL << (\d+);", src)
    assert m and 1 << int(m.group(1)) == hr.TASK_BYTES


def test_wrapper_checks_operands():
    x = torch.zeros(4, 5)
    with pytest.raises(ValueError, match="float32 or float64"):
        hr.health_reduce([[x.half()]])
    with pytest.raises(ValueError, match="contiguous"):
        hr.health_reduce([[x.t()]])
    with pytest.raises(ValueError, match="leading extent"):
        hr.health_reduce([[x], [torch.zeros(3, 5)]], per_lane=True)
    with pytest.raises(ValueError, match="at least one"):
        hr.health_reduce([[x], []])
    with pytest.raises(ValueError):
        hr.health_reduce([[torch.zeros(4, 5, device="meta")]])
    # integer quantities are healthy without being read
    same(hr.health_reduce([[torch.ones(3, dtype=torch.int64)]]), [[1.0], [0.0]])
