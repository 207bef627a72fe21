"""Astaroth over a partition whose blocks all sit on one device, in the port
against the JAX package on one CPU device (``grid_mesh(Dim3(1, 1, 1))``
with a multi-block spec, the JAX package's resident layout): the step on
(2,2,2) with overlap on and off and with ``swap_per_substep``, and in fp32;
the hoisted order against the serialized one. The other partitions (overlap
on and off; ``swap_per_substep`` exchanges the same way on every partition)
are in ``test_torch_astaroth_resident_{z,y,x}.py`` (with the uneven one in
``_z``), which share this file's helpers: the JAX package's compiles take
15-50 s a step, so each file compiles one step per exchange mode and the
cases are spread over files that the test runner gives to its workers. The
table form's plain version, the shells, the app, the reductions, the
boundaries, the guarded run and the refusals are in
``test_torch_astaroth_resident_app.py``.

Inputs are made with numpy from a seed and handed to both packages; every
array carries its dtype (``jax_enable_x64`` is on). Tolerances, as in
``test_torch_astaroth.py``: fp64 relative 1e-10 (XLA may fold a divide by
a constant into a multiply, a few ulps); fp32 rtol 1e-4 / atol 1e-5 (the
JAX package's own XLA-vs-Pallas bound). On the CPU the kernel wrappers run
their plain versions; ``chip_smoke.py`` phase 14 holds the kernel to them
on the card."""

import functools

import jax
import numpy as np
import pytest
import torch

import stencil_tpu.apps.astaroth as japp
import stencil_tpu.astaroth.config as jconfig
import stencil_tpu_torch.apps.astaroth as tapp
import stencil_tpu_torch.astaroth.config as tconfig
from stencil_tpu.astaroth.integrate import make_astaroth_step as jmake_step
from stencil_tpu.domain.grid import GridSpec as JGridSpec
from stencil_tpu.geometry import Dim3 as JDim3
from stencil_tpu.geometry import Radius as JRadius
from stencil_tpu.parallel import HaloExchange as JHaloExchange
from stencil_tpu.parallel import grid_mesh
from stencil_tpu.parallel.exchange import shard_blocks as jshard
from stencil_tpu.parallel.exchange import unshard_blocks as junshard
from stencil_tpu_torch import HaloExchange
from stencil_tpu_torch.astaroth.integrate import FIELDS, make_astaroth_step
from stencil_tpu_torch.convert import state_from_jax, state_to_numpy
from stencil_tpu_torch.domain import GridSpec
from stencil_tpu_torch.geometry import Dim3, Radius
from stencil_tpu_torch.ops import astaroth_substep as tsub
from stencil_tpu_torch.parallel import unshard_blocks

torch.set_num_threads(2)

TOL = {np.float64: dict(rtol=1e-10, atol=1e-12), np.float32: dict(rtol=1e-4, atol=1e-5)}
MODES = {"overlap": dict(overlap=True), "serial": dict(overlap=False),
         "swap": dict(swap_per_substep=True)}


def configs(size):
    t, _ = tconfig.load_config(tapp.DEFAULT_CONF)
    j, _ = jconfig.load_config(japp.DEFAULT_CONF)
    for info in (t, j):
        info.int_params["AC_nx"], info.int_params["AC_ny"], info.int_params["AC_nz"] = size
        info.update_builtin_params()
    return t, j


def specs(size, part, r=3):
    return (GridSpec(Dim3(*size), Dim3(*part), Radius.constant(r)),
            JGridSpec(JDim3(*size), JDim3(*part), JRadius.constant(r)))


def resident_mesh():
    """The JAX resident mesh: every block on one CPU device."""
    return grid_mesh(JDim3(1, 1, 1), jax.devices()[:1])


def random_fields(size, seed=5):
    """Random global fields (z, y, x) in float64, lnrho around 0.5."""
    rng = np.random.RandomState(seed)
    fields = {k: rng.randn(*size[::-1]) * 0.05 for k in FIELDS}
    fields["lnrho"] = fields["lnrho"] + 0.5
    return fields


@functools.lru_cache(maxsize=None)
def jax_run(size, part, dtype=np.float64, iters=2, dt=1e-3, swap=False):
    """The JAX step on its resident mesh from :func:`random_fields` (zero
    halos): the owned cells after ``iters`` iterations. Without ``swap`` it
    is the serialized step, the reference for the port's overlap and serial
    steps alike: the JAX package's overlap and serialized steps give the same
    cells bit for bit (its hoisted order re-integrates the shells at stage
    0, which never reads ``out``), and one JAX compile per partition is what
    keeps these files short."""
    _, jinfo = configs(size)
    _, js = specs(size, part)
    mesh = resident_mesh()
    fields = random_fields(size)
    jcurr = {k: jshard(v.astype(dtype), js, mesh) for k, v in fields.items()}
    jnxt = {k: jshard(np.zeros(size[::-1], dtype), js, mesh) for k in FIELDS}
    mode = dict(swap_per_substep=True) if swap else dict(overlap=False)
    jstep = jmake_step(JHaloExchange(js, mesh), jinfo, dt=dt, iters=iters,
                       dtype=np.dtype(dtype).name, **mode)
    jcurr, _ = jstep(jcurr, jnxt)
    return {k: junshard(jcurr[k], js) for k in FIELDS}


@functools.lru_cache(maxsize=None)
def port_run(size, part, mode, dtype=np.float64, iters=2, dt=1e-3):
    """The port's step on the CPU in ``mode`` (a key of :data:`MODES`) from
    the same fields as :func:`jax_run`, carried across by convert; returns
    the owned cells and the table form's launch count over the run."""
    tinfo, _ = configs(size)
    ts, js = specs(size, part)
    mesh = resident_mesh()
    fields = random_fields(size)
    state = {k: np.asarray(jshard(v.astype(dtype), js, mesh)) for k, v in fields.items()}
    zeros = np.asarray(jshard(np.zeros(size[::-1], dtype), js, mesh))
    curr = state_from_jax(state, ts, "cpu")
    nxt = state_from_jax({k: zeros for k in FIELDS}, ts, "cpu")
    step = make_astaroth_step(HaloExchange(ts), tinfo, dt=dt, iters=iters,
                              dtype=np.dtype(dtype).name, **MODES[mode])
    launches = tsub.substep_tasks.launches
    curr, nxt = step(curr, nxt)
    launched = tsub.substep_tasks.launches - launches
    back = state_to_numpy(curr)
    return {k: unshard_blocks(torch.from_numpy(back[k]), ts) for k in FIELDS}, launched


def run_both(size, part, mode, dtype=np.float64):
    """The port's step in ``mode`` and its JAX reference (2 iterations at dt
    1e-3): (port, JAX, initial) owned cells and the port's launch count."""
    got, launched = port_run(size, part, mode, dtype)
    want = jax_run(size, part, dtype, swap=mode == "swap")
    init = {k: v.astype(dtype) for k, v in random_fields(size).items()}
    return got, want, init, launched


def assert_close(got, want, init, dtype):
    for k in FIELDS:
        assert got[k].dtype == want[k].dtype == dtype, k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL[dtype])
        assert not np.array_equal(got[k], init[k]), k


def step_matches_jax(part, mode):
    """16^3 fp64 over ``part``: every owned cell after 2 iterations, within
    1e-10; on the CPU the table form runs its plain version (no launch
    counted)."""
    got, want, init, launched = run_both((16, 16, 16), part, mode)
    assert launched == 0
    assert_close(got, want, init, np.float64)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_step_matches_jax(mode):
    step_matches_jax((2, 2, 2), mode)


def test_step_f32_matches_jax():
    """fp32 over (2,2,2) with overlap, within rtol 1e-4 / atol 1e-5."""
    got, want, init, _ = run_both((16, 16, 16), (2, 2, 2), "overlap", np.float32)
    assert_close(got, want, init, np.float32)


def overlap_matches_serial(part):
    """The port's hoisted order (stage 0 from the pre-exchange halos, the
    shells again after the exchange) gives the serialized step's cells bit
    for bit: stage 0 never reads ``out``, so the shells' rewrite is exact."""
    over, _ = port_run((16, 16, 16), part, "overlap")
    serial, _ = port_run((16, 16, 16), part, "serial")
    for k in FIELDS:
        assert np.array_equal(over[k], serial[k]), k


def test_overlap_matches_serial():
    overlap_matches_serial((2, 2, 2))
