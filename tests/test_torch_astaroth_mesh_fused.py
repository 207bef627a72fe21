"""The fused REMOTE_DMA Astaroth iteration, ``make_fused_astaroth_loop``,
in the port on 8 ``"cpu"`` positions against the JAX package's on its 8
virtual CPU devices (helpers, inputs and tolerances:
``test_torch_astaroth_mesh.py``), as in ``tests/test_fused_stencil.py``'s
fused Astaroth case: 16^3 over (2,2,2), 2 iterations at dt 1e-3; the
port's fused loop also equals its composed overlap step bit for bit (the
same stages, and exchanges that copy bits); and the refusals, of the same
kinds as the JAX function's."""

import jax
import numpy as np
import pytest

from stencil_tpu.astaroth.integrate import make_fused_astaroth_loop as jmake_fused
from stencil_tpu.parallel import HaloExchange as JHaloExchange
from stencil_tpu.parallel import Method as JMethod
from stencil_tpu.parallel.exchange import shard_blocks as jshard
from stencil_tpu.parallel.exchange import unshard_blocks as junshard
from stencil_tpu_torch import HaloExchange
from stencil_tpu_torch.astaroth.integrate import FIELDS, make_fused_astaroth_loop
from stencil_tpu_torch.convert import mesh_state_from_jax
from stencil_tpu_torch.geometry import Dim3
from stencil_tpu_torch.parallel import DeviceMesh, Method, unshard_blocks
from test_torch_astaroth_mesh import SIZE, jax_mesh, port_run
from test_torch_astaroth_resident import assert_close, configs, random_fields, specs

DT = 1e-3


def _start(ts, js, jm, mesh, dtype=np.float64):
    fields = random_fields(SIZE)
    state = {k: np.asarray(jshard(v.astype(dtype), js, jm)) for k, v in fields.items()}
    zeros = np.asarray(jshard(np.zeros(SIZE[::-1], dtype), js, jm))
    return (mesh_state_from_jax(state, ts, mesh),
            mesh_state_from_jax({k: zeros for k in FIELDS}, ts, mesh))


def test_fused_loop_matches_jax_and_the_composed_step():
    tinfo, jinfo = configs(SIZE)
    ts, js = specs(SIZE, (2, 2, 2))
    jm = jax_mesh((2, 2, 2))
    fields = random_fields(SIZE)
    jcurr = {k: jshard(v, js, jm) for k, v in fields.items()}
    jout = {k: jshard(np.zeros(SIZE[::-1]), js, jm) for k in FIELDS}
    jloop = jmake_fused(JHaloExchange(js, jm, JMethod.REMOTE_DMA, fused=True), jinfo, iters=2,
                        dt=DT, dtype="float64")
    jcurr, _ = jloop(jcurr, jout)
    want = {k: junshard(jcurr[k], js) for k in FIELDS}

    mesh = DeviceMesh(Dim3(2, 2, 2), ["cpu"] * 8)
    ex = HaloExchange(ts, Method.REMOTE_DMA, mesh=mesh, fused=True)
    loop = make_fused_astaroth_loop(ex, tinfo, iters=2, dt=DT, dtype="float64")
    curr, out = loop(*_start(ts, js, jm, mesh))
    got = {k: unshard_blocks(curr[k], ts) for k in FIELDS}
    init = {k: v.astype(np.float64) for k, v in fields.items()}
    assert_close(got, want, init, np.float64)
    composed, _ = port_run(SIZE, (2, 2, 2), (2, 2, 2), "overlap")
    for k in FIELDS:
        assert np.array_equal(got[k], composed[k]), k


def test_fused_loop_on_the_mixed_mesh_equals_the_composed_step():
    """(1,1,2) over 2 positions: B7's self-wrap directions stand in for
    B4's fills; the cells are the composed overlap step's."""
    tinfo, _ = configs(SIZE)
    ts, js = specs(SIZE, (1, 1, 2))
    mesh = DeviceMesh(Dim3(1, 1, 2), ["cpu"] * 2)
    ex = HaloExchange(ts, Method.REMOTE_DMA, mesh=mesh, fused=True)
    loop = make_fused_astaroth_loop(ex, tinfo, iters=2, dt=DT, dtype="float64")
    curr, _ = loop(*_start(ts, js, jax_mesh((1, 1, 2)), mesh))
    composed, _ = port_run(SIZE, (1, 1, 2), (1, 1, 2), "overlap")
    for k in FIELDS:
        assert np.array_equal(unshard_blocks(curr[k], ts), composed[k]), k


def test_fused_loop_refuses_like_jax():
    """A non-fused exchange, a face radius under 3 and an uneven partition
    raise ValueError, as in the JAX package; an oversubscribed mesh is
    refused already by the fused exchange, in both packages."""
    tinfo, jinfo = configs(SIZE)
    ts, js = specs(SIZE, (2, 2, 2))
    mesh = DeviceMesh(Dim3(2, 2, 2), ["cpu"] * 8)
    jm = jax_mesh((2, 2, 2))
    with pytest.raises(ValueError, match="fused=True"):
        make_fused_astaroth_loop(HaloExchange(ts, Method.REMOTE_DMA, mesh=mesh), tinfo)
    with pytest.raises(ValueError, match="fused=True"):
        jmake_fused(JHaloExchange(js, jm, JMethod.AXIS_COMPOSED), jinfo)
    t2, j2 = specs(SIZE, (2, 2, 2), r=2)
    with pytest.raises(ValueError, match="radius >= 3"):
        make_fused_astaroth_loop(HaloExchange(t2, Method.REMOTE_DMA, mesh=mesh, fused=True),
                                 tinfo)
    with pytest.raises(ValueError, match="radius >= 3"):
        jmake_fused(JHaloExchange(j2, jm, JMethod.REMOTE_DMA, fused=True), jinfo)
    tu, ju = specs((19, 16, 14), (2, 2, 2))
    with pytest.raises(ValueError, match="uniform single-resident"):
        make_fused_astaroth_loop(HaloExchange(tu, Method.REMOTE_DMA, mesh=mesh, fused=True),
                                 tinfo)
    with pytest.raises(ValueError, match="uniform single-resident"):
        jmake_fused(JHaloExchange(ju, jm, JMethod.REMOTE_DMA, fused=True), jinfo)
    four = DeviceMesh(Dim3(2, 2, 1), ["cpu"] * 4)
    with pytest.raises(ValueError, match="single-resident"):
        HaloExchange(ts, Method.REMOTE_DMA, mesh=four, fused=True)
    with pytest.raises(ValueError, match="single-resident"):
        JHaloExchange(js, jax_mesh((2, 2, 1)), JMethod.REMOTE_DMA, fused=True)
    assert jax.devices()[0].platform == "cpu"
