"""Astaroth over a mesh of block positions, in the port on ``["cpu"] * n``
positions against the JAX package on ``grid_mesh(dim, jax.devices()[:n])``
(the 8 virtual CPU devices): the step on (2,2,2) over 8 positions with
overlap, without it and with ``swap_per_substep``, and in fp32; the port's
overlap step against its serialized one and against its resident step; the
positions form's plain version against the table form's; the positions
form's refusals. The mixed, oversubscribed and uneven meshes are in
``test_torch_astaroth_mesh_{mixed,uneven}.py``, the fused loop in
``_fused``, the app and the guarded run in ``_app``; they share this file's
helpers. The JAX package's mesh steps compile in 10-20 s each, so each file
compiles one JAX step per mesh and exchange mode (its serialized step is
the reference for the port's overlap and serial steps alike: the JAX
package's hoisted order re-integrates the shells at stage 0, which never
reads ``out``) and the test runner gives the files to its workers.

Inputs are made with numpy from a seed and handed to both packages; every
array carries its dtype (``jax_enable_x64`` is on). Tolerances, as in
``test_torch_astaroth.py``: fp64 relative 1e-10 (XLA may fold a divide by
a constant into a multiply, a few ulps); fp32 rtol 1e-4 / atol 1e-5 (the
JAX package's own XLA-vs-Pallas bound). The JAX side runs its XLA step (on
the CPU ``uses_pallas`` is off) over AXIS_COMPOSED, which the JAX package
pins bit-identical to its REMOTE_DMA emulation; the port's mesh exchanges
by REMOTE_DMA (B6's plain version here). On the CPU the kernel wrappers
run their plain versions; ``chip_smoke.py`` phase 17 holds the kernel to
them on the card."""

import functools

import jax
import numpy as np
import pytest
import torch

from stencil_tpu.astaroth.integrate import make_astaroth_step as jmake_step
from stencil_tpu.geometry import Dim3 as JDim3
from stencil_tpu.parallel import HaloExchange as JHaloExchange
from stencil_tpu.parallel import grid_mesh
from stencil_tpu.parallel.exchange import shard_blocks as jshard
from stencil_tpu.parallel.exchange import unshard_blocks as junshard
from stencil_tpu_torch import HaloExchange
from stencil_tpu_torch.astaroth.equations import Constants
from stencil_tpu_torch.astaroth.integrate import FIELDS, inv_ds_of, make_astaroth_step
from stencil_tpu_torch.convert import mesh_state_from_jax
from stencil_tpu_torch.geometry import Dim3
from stencil_tpu_torch.ops import astaroth_substep as tsub
from stencil_tpu_torch.parallel import DeviceMesh, Method, join_positions, unshard_blocks
from test_torch_astaroth_resident import TOL, assert_close, configs, random_fields, specs

torch.set_num_threads(2)

MODES = {"overlap": dict(overlap=True), "serial": dict(overlap=False),
         "swap": dict(swap_per_substep=True)}
SIZE = (16, 16, 16)


def jax_mesh(mesh_dim):
    n = int(np.prod(mesh_dim))
    return grid_mesh(JDim3(*mesh_dim), jax.devices()[:n])


@functools.lru_cache(maxsize=None)
def jax_run(size, part, mesh_dim, dtype=np.float64, iters=2, dt=1e-3, mode="serial"):
    """The JAX step over ``mesh_dim`` devices from :func:`random_fields`
    (zero halos): the owned cells after ``iters`` iterations in ``mode``
    ("serial", "overlap" or "swap")."""
    _, jinfo = configs(size)
    _, js = specs(size, part)
    mesh = jax_mesh(mesh_dim)
    fields = random_fields(size)
    jcurr = {k: jshard(v.astype(dtype), js, mesh) for k, v in fields.items()}
    jnxt = {k: jshard(np.zeros(size[::-1], dtype), js, mesh) for k in FIELDS}
    jstep = jmake_step(JHaloExchange(js, mesh), jinfo, dt=dt, iters=iters,
                       dtype=np.dtype(dtype).name, **MODES[mode])
    jcurr, _ = jstep(jcurr, jnxt)
    return {k: junshard(jcurr[k], js) for k in FIELDS}


def port_run(size, part, mesh_dim, mode, dtype=np.float64, iters=2, dt=1e-3):
    """The port's step over ``mesh_dim`` positions on the CPU in ``mode``
    from the same fields as :func:`jax_run`, carried across by convert;
    returns the owned cells and the step's positions state."""
    tinfo, _ = configs(size)
    ts, js = specs(size, part)
    jm = jax_mesh(mesh_dim)
    mesh = DeviceMesh(Dim3(*mesh_dim), ["cpu"] * int(np.prod(mesh_dim)))
    fields = random_fields(size)
    state = {k: np.asarray(jshard(v.astype(dtype), js, jm)) for k, v in fields.items()}
    zeros = np.asarray(jshard(np.zeros(size[::-1], dtype), js, jm))
    curr = mesh_state_from_jax(state, ts, mesh)
    nxt = mesh_state_from_jax({k: zeros for k in FIELDS}, ts, mesh)
    ex = HaloExchange(ts, Method.REMOTE_DMA, mesh=mesh)
    step = make_astaroth_step(ex, tinfo, dt=dt, iters=iters, dtype=np.dtype(dtype).name,
                              **MODES[mode])
    launches = tsub.substep_positions.launches
    curr, _ = step(curr, nxt)
    assert tsub.substep_positions.launches == launches  # plain versions on the CPU
    return {k: unshard_blocks(curr[k], ts) for k in FIELDS}, curr


def mesh_matches_jax(part, mesh_dim, mode, dtype=np.float64, jmode="serial", size=SIZE):
    """Every owned cell of the port's step over ``mesh_dim`` positions after
    2 iterations, against the JAX step in ``jmode`` on as many devices."""
    got, _ = port_run(size, part, mesh_dim, mode, dtype)
    want = jax_run(size, part, mesh_dim, dtype, mode=jmode)
    init = {k: v.astype(dtype) for k, v in random_fields(size).items()}
    assert_close(got, want, init, dtype)
    return got


@pytest.mark.parametrize("mode", ["overlap", "serial"])
def test_step_on_8_positions_matches_jax(mode):
    mesh_matches_jax((2, 2, 2), (2, 2, 2), mode)


def test_swap_per_substep_on_8_positions_matches_jax():
    mesh_matches_jax((2, 2, 2), (2, 2, 2), "swap", jmode="swap")


def test_step_f32_on_8_positions_matches_jax():
    """fp32 with overlap, within rtol 1e-4 / atol 1e-5."""
    mesh_matches_jax((2, 2, 2), (2, 2, 2), "overlap", np.float32)


def test_mesh_overlap_equals_serial_and_resident():
    """On 8 positions the hoisted order gives the serialized step's cells
    bit for bit, and both give the resident step's (the same arithmetic;
    B6's plain version and the resident roll copy the same bits)."""
    over, _ = port_run(SIZE, (2, 2, 2), (2, 2, 2), "overlap")
    serial, _ = port_run(SIZE, (2, 2, 2), (2, 2, 2), "serial")
    from test_torch_astaroth_resident import port_run as resident_run

    resident, _ = resident_run(SIZE, (2, 2, 2), "overlap")
    for k in FIELDS:
        assert np.array_equal(over[k], serial[k]), k
        assert np.array_equal(over[k], resident[k]), k


# -- the positions form's plain version and its checks -------------------------------

def _positions(spec, resident, dtype, seed):
    """8 lists of one random stack per position, values in [0, 0.1)."""
    rng = np.random.RandomState(seed)
    r, p = Dim3.of(resident), spec.padded()
    npos = tsub.position_mesh(spec, r).flatten()
    return tuple([torch.from_numpy((rng.rand(r.z, r.y, r.x, p.z, p.y, p.x) * 0.1).astype(dtype))
                  for _ in range(npos)] for _ in FIELDS)


@pytest.mark.parametrize("part,res", [((2, 2, 2), (1, 1, 1)), ((2, 2, 2), (1, 2, 2)),
                                      ((1, 1, 2), (1, 1, 1))])
@pytest.mark.parametrize("stage", [0, 1])
def test_positions_plain_is_the_table_over_the_joined_stacks(part, res, stage):
    """The positions form over a mesh's stacks gives the table form's cells
    over the same blocks joined into one stack, compute regions and (stage
    0) shells."""
    tinfo, _ = configs(SIZE)
    c, ids = Constants.from_info(tinfo), inv_ds_of(tinfo)
    ts, _ = specs((20, 18, 16), part)
    r = Dim3(*res)
    curr8, out8 = _positions(ts, r, np.float64, 1), _positions(ts, r, np.float64, 2)
    joined_c = tuple(join_positions(f, ts) for f in curr8)
    joined_o = tuple(join_positions(f, ts) for f in out8)
    kinds = [(tsub.position_compute_tasks, tsub.compute_tasks)]
    if stage == 0:
        kinds.append((tsub.position_shell_tasks, tsub.shell_tasks))
    for pos_tasks, tasks in kinds:
        tsub.substep_positions(curr8, out8, ts, pos_tasks(ts, r), c, ids, stage, 0.1)
        tsub.substep_tasks(joined_c, joined_o, ts, tasks(ts), c, ids, stage, 0.1)
        for f, (a, b) in enumerate(zip(out8, joined_o)):
            assert torch.equal(join_positions(a, ts), b), FIELDS[f]


def test_positions_form_refuses():
    tinfo, _ = configs(SIZE)
    c, ids = Constants.from_info(tinfo), inv_ds_of(tinfo)
    ts, _ = specs(SIZE, (2, 2, 2))
    one = Dim3(1, 1, 1)
    curr8, out8 = _positions(ts, one, np.float64, 1), _positions(ts, one, np.float64, 2)
    full, shells = tsub.position_compute_tasks(ts, one), tsub.position_shell_tasks(ts, one)
    launches = tsub.substep_positions.launches
    for stage in (1, 2):
        with pytest.raises(ValueError, match=f"shell task at stage {stage}"):
            tsub.substep_positions(curr8, out8, ts, shells, c, ids, stage, 0.1)
        with pytest.raises(ValueError, match="shell task"):
            tsub.substep_positions(curr8, out8, ts, full + full[:1], c, ids, stage, 0.1)
    with pytest.raises(ValueError, match="outside the mesh"):
        tsub.substep_positions(curr8, out8, ts, [(8, 0, full[0].rect)], c, ids, 0, 0.1)
    with pytest.raises(ValueError, match="outside the stacks"):
        tsub.substep_positions(curr8, out8, ts, [(0, 1, full[0].rect)], c, ids, 0, 0.1)
    with pytest.raises(ValueError, match="one stack a position"):
        tsub.substep_positions(curr8, tuple(f[:7] for f in out8), ts, full, c, ids, 0, 0.1)
    with pytest.raises(ValueError, match="do not hold"):
        tsub.substep_positions(tuple(f[:4] for f in curr8), tuple(f[:4] for f in out8), ts,
                               full[:4], c, ids, 0, 0.1)
    with pytest.raises(ValueError, match="distinct buffers"):
        tsub.substep_positions(curr8, curr8, ts, full, c, ids, 0, 0.1)
    with pytest.raises(ValueError, match=r"\(cz, cy, cx, pz, py, px\)"):
        tsub.substep_positions(tuple([t[0, 0] for t in f] for f in curr8),
                               tuple([t[0, 0] for t in f] for f in out8), ts, full, c, ids, 0,
                               0.1)
    f32 = _positions(ts, one, np.float32, 3)
    with pytest.raises(ValueError, match="one dtype"):
        tsub.substep_positions(curr8, f32, ts, full, c, ids, 0, 0.1)
    assert tsub.substep_positions.launches == launches


def test_axis_composed_over_positions_keeps_raising():
    """A mesh exchanges by REMOTE_DMA only; AXIS_COMPOSED over positions
    raises as it did (ROADMAP.md queue A item 5)."""
    ts, _ = specs(SIZE, (2, 2, 2))
    with pytest.raises(NotImplementedError, match="REMOTE_DMA only.*queue A item 5"):
        HaloExchange(ts, Method.AXIS_COMPOSED, mesh=DeviceMesh(Dim3(2, 2, 2), ["cpu"] * 8))
    assert TOL[np.float64]["rtol"] == 1e-10
