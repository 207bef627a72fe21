"""Astaroth over a mesh of block positions with a narrowed wire: the 8
fp64 fields' halos cross between positions through an fp32 wire
(``HaloExchange(Method.REMOTE_DMA, mesh=..., wire_dtype="float32")``), in
the port on 8 ``"cpu"`` positions against the JAX package on its 8 virtual
CPU devices with the same wire (helpers, inputs and tolerances:
``test_torch_astaroth_mesh.py``; the JAX step over AXIS_COMPOSED, as
there, its fused loop over REMOTE_DMA): one iteration of ``make_astaroth_step``
(B6's axis phases, their plain version here) and one of
``make_fused_astaroth_loop`` (B7's), 16^3 over (2,2,2) at dt 1e-3, each
within fp64's relative 1e-10 of JAX, and each different from the
unnarrowed run (the wire rounded the halos). The JAX package's mesh steps
compile in 10-80 s, so this file holds these two alone."""

import numpy as np

from stencil_tpu.astaroth.integrate import make_astaroth_step as jmake_step
from stencil_tpu.astaroth.integrate import make_fused_astaroth_loop as jmake_fused
from stencil_tpu.parallel import HaloExchange as JHaloExchange
from stencil_tpu.parallel import Method as JMethod
from stencil_tpu.parallel.exchange import shard_blocks as jshard
from stencil_tpu.parallel.exchange import unshard_blocks as junshard
from stencil_tpu_torch import HaloExchange
from stencil_tpu_torch.astaroth.integrate import (FIELDS, make_astaroth_step,
                                                  make_fused_astaroth_loop)
from stencil_tpu_torch.convert import mesh_state_from_jax
from stencil_tpu_torch.geometry import Dim3
from stencil_tpu_torch.ops import remote_dma
from stencil_tpu_torch.parallel import DeviceMesh, Method, unshard_blocks
from test_torch_astaroth_mesh import SIZE, jax_mesh
from test_torch_astaroth_resident import assert_close, configs, random_fields, specs

DT, WIRE = 1e-3, "float32"


def _run(fused: bool, wire):
    """One iteration of the port's step (or fused loop) over 8 positions
    and of the JAX package's with the same exchange; returns (port cells,
    JAX cells, start fields)."""
    tinfo, jinfo = configs(SIZE)
    ts, js = specs(SIZE, (2, 2, 2))
    jm = jax_mesh((2, 2, 2))
    fields = random_fields(SIZE)
    # the JAX step exchanges per block inside its shard_map, which its
    # REMOTE_DMA emulation has no body for: AXIS_COMPOSED's, which the JAX
    # package pins bit-identical to it, carries its wire (_permute_wire)
    jmethod = JMethod.REMOTE_DMA if fused else JMethod.AXIS_COMPOSED
    jex = JHaloExchange(js, jm, jmethod, wire_dtype=wire, fused=fused)
    jcurr = {k: jshard(v, js, jm) for k, v in fields.items()}
    jnxt = {k: jshard(np.zeros(SIZE[::-1]), js, jm) for k in FIELDS}
    if fused:
        jstep = jmake_fused(jex, jinfo, iters=1, dt=DT, dtype="float64")
    else:
        jstep = jmake_step(jex, jinfo, dt=DT, iters=1, dtype="float64")
    jcurr, _ = jstep(jcurr, jnxt)
    want = {k: junshard(jcurr[k], js) for k in FIELDS}

    mesh = DeviceMesh(Dim3(2, 2, 2), ["cpu"] * 8)
    ex = HaloExchange(ts, Method.REMOTE_DMA, mesh=mesh, wire_dtype=wire, fused=fused)
    state = {k: np.asarray(jshard(v, js, jm)) for k, v in fields.items()}
    zeros = np.asarray(jshard(np.zeros(SIZE[::-1]), js, jm))
    curr = mesh_state_from_jax(state, ts, mesh)
    nxt = mesh_state_from_jax({k: zeros for k in FIELDS}, ts, mesh)
    if fused:
        step = make_fused_astaroth_loop(ex, tinfo, iters=1, dt=DT, dtype="float64")
    else:
        step = make_astaroth_step(ex, tinfo, dt=DT, iters=1, dtype="float64")
    launches = remote_dma.remote_axis.narrowed
    curr, _ = step(curr, nxt)
    assert remote_dma.remote_axis.narrowed == launches  # plain versions on the CPU
    got = {k: unshard_blocks(curr[k], ts) for k in FIELDS}
    return got, want, {k: v.astype(np.float64) for k, v in fields.items()}


def _wire_matches_jax(fused: bool) -> None:
    got, want, init = _run(fused, WIRE)
    assert_close(got, want, init, np.float64)
    mesh = DeviceMesh(Dim3(2, 2, 2), ["cpu"] * 8)
    ts, _js = specs(SIZE, (2, 2, 2))
    assert HaloExchange(ts, Method.REMOTE_DMA, mesh=mesh, wire_dtype=WIRE).plan.wire_dtype == WIRE
    native, _want, _init = _run(fused, None)
    assert any(not np.array_equal(got[k], native[k]) for k in FIELDS)


def test_step_with_an_fp32_wire_matches_jax():
    _wire_matches_jax(fused=False)


def test_fused_loop_with_an_fp32_wire_matches_jax():
    _wire_matches_jax(fused=True)
