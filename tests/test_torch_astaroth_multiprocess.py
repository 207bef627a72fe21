"""Astaroth across processes on the CPU: 2 processes x 4 positions, launched
by ``apps/launch_multiprocess`` over gloo, against the JAX app on its 8
virtual CPU devices and against the port's own one-process run over 8
positions.

The workers are this file run as a module by the launcher (``python -m
test_torch_astaroth_multiprocess astaroth <out>``, one spawn): the app
``run(iters=2, nx=8, dt=1e-5, reductions=True)`` over each rank's default
positions by AXIS_COMPOSED with overlap, without it and with
``swap_per_substep``, and by REMOTE_DMA; ``make_fused_astaroth_loop``
(B7's gloo form) over 3 iterations, the app's warm-up and 2; and the uneven
19x16x14 over (2,2,2) through ``make_astaroth_step`` in the serial order;
the guarded engine (checkpoints skipped, and a NaN injected on one rank
stopping both); and ``--autotune``'s refusal across processes. The
cycle collector is off in the workers: each domain they drop must take
its exchange and blocks with it. Rank 0 gathers every field and writes
them to ``<out>``; each rank writes its row and reductions. A second
spawn runs the app's command line (``python -m stencil_tpu_torch.apps.
astaroth 2 --nx 8 --reductions --devices cpu,cpu,cpu,cpu`` a rank). Torch
runs at one thread; each spawn has a time limit.

Tolerances: against the JAX app rtol 1e-10 / atol 1e-12 in fp64, the
reference's XLA-vs-numpy bound (``test_torch_astaroth.py``); against the
port's one-process run bit-exact (the same arithmetic in the same order,
only the halos travel another way); the reductions within rel 1e-10 of
the JAX app's (each rank sums its own positions first, so the sums' order
differs).

Without a spawn: the handshakes an iteration of each order and method on
the card, with a recording stand-in for the events and the launches; B6's
and B7's cross-process tables at Astaroth's shape (8 fp64 fields, r3)
replayed against their plain versions; and each position's init against
the global init's slices."""

import ast
import gc
import json
import os
import re
import subprocess
import sys
import time
import weakref

import jax
import numpy as np
import pytest
import torch

import stencil_tpu.apps.astaroth as japp
import stencil_tpu_torch.apps.astaroth as tapp
import stencil_tpu_torch.astaroth.init as tinit
from stencil_tpu_torch.astaroth import integrate as tint
from stencil_tpu_torch.astaroth.integrate import FIELDS
from stencil_tpu_torch.domain import GridSpec
from stencil_tpu_torch.geometry import DIRECTIONS_26, Dim3, Radius, Rect3
from stencil_tpu_torch.ops import fused_stencil as tfused
from stencil_tpu_torch.ops import remote_dma as rdma
from stencil_tpu_torch.parallel import DeviceMesh, HaloExchange, Method, distributed, ipc
from stencil_tpu_torch.plan.ir import build_plan
from test_torch_astaroth_mesh import jax_run, port_run
from test_torch_astaroth_resident import TOL, configs, random_fields

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SPAWN_TIMEOUT = 300
CPU8 = ["cpu"] * 8
# the app's runs in the spawn, by name: run()'s arguments
APP_RUNS = {"overlap": {}, "serial": dict(overlap=False), "swap": dict(swap_per_substep=True),
            "remote_dma": dict(method=Method.REMOTE_DMA)}
APP_KW = dict(iters=2, nx=8, dt=1e-5, reductions=True)
UNEVEN = (19, 16, 14)


# -- the worker (run by the launcher) ------------------------------------------------------

def worker_astaroth(out: str) -> None:
    from stencil_tpu_torch import DistributedDomain
    from stencil_tpu_torch.astaroth.integrate import make_astaroth_step, make_fused_astaroth_loop

    assert distributed.maybe_init_from_env()
    gc.disable()  # a domain dropped must go without the cycle collector
    os.chdir(out)  # what a run writes beside it (a fault's evidence) lands here
    rank = distributed.process_index()
    report = {"rank": rank, "runs": {}}
    arrays = {}

    def refs_of(dd, handles):
        """Weak references to the domain, its exchange and a local block of
        each field and buffer."""
        i = dd.mesh.local_positions()[0]
        return [weakref.ref(dd), weakref.ref(dd.halo_exchange)] + [
            weakref.ref(get(h)[i]) for h in handles.values() for get in (dd.get_curr, dd.get_next)]

    def gather(dd, handles, name, state=None):
        for k in FIELDS:
            if state is not None:
                dd.set_curr(handles[k], state[k])
            g = dd.get_curr_global(handles[k])  # a collective
            if rank == 0:
                arrays[f"{name}_{k}"] = g

    for name, kw in APP_RUNS.items():
        r = tapp.run(**APP_KW, **kw)
        dd = r["domain"]
        report["runs"][name] = {
            "row": tapp.csv_row(r), "processes": r["processes"], "devices": r["devices"],
            "global": list(r["global"]), "method": dd.halo_exchange.method.value,
            "local": list(dd.mesh.local_positions()), "iters_run": r["iters_run"],
            "reductions": r["reductions"]}
        gather(dd, r["handles"], name)
        refs = refs_of(dd, r["handles"])
        del r, dd
        report["runs"][name]["dropped"] = [w() is None for w in refs]
    # the fused loop (B7 over gloo): the app's warm-up iteration and 2 more
    info = tapp.load(nx=8)
    dd = DistributedDomain(16, 16, 16, device="cpu")
    dd.set_radius(3)
    dd.set_methods(Method.REMOTE_DMA)
    dd.set_fused_exchange(True)
    dd.set_devices(distributed.default_positions())
    hs = {k: dd.add_data(k, "float64") for k in FIELDS}
    dd.realize()
    tapp.init_fields(dd, hs, info, "float64")
    loop = make_fused_astaroth_loop(dd.halo_exchange, info, iters=3, dt=1e-5, dtype="float64")
    curr, _nxt = loop({k: dd.get_curr(h) for k, h in hs.items()},
                      {k: dd.get_next(h) for k, h in hs.items()})
    report["runs"]["fused"] = {"local": list(dd.mesh.local_positions())}
    gather(dd, hs, "fused", curr)
    refs = refs_of(dd, hs)
    del loop, curr, _nxt, dd
    report["runs"]["fused"]["dropped"] = [w() is None for w in refs]
    # the uneven partition through make_astaroth_step, serial order
    tinfo, _ = configs(UNEVEN)
    dd = DistributedDomain(*UNEVEN, device="cpu")
    dd.set_radius(3)
    dd.set_partition((2, 2, 2))
    dd.set_devices(distributed.default_positions())
    hs = {k: dd.add_data(k, "float64") for k in FIELDS}
    dd.realize()
    for k, v in random_fields(UNEVEN).items():
        dd.set_curr_global(hs[k], v)
    step = make_astaroth_step(dd.halo_exchange, tinfo, dt=1e-3, iters=2, overlap=False,
                              dtype="float64")
    curr, _nxt = step({k: dd.get_curr(h) for k, h in hs.items()},
                      {k: dd.get_next(h) for k, h in hs.items()})
    report["runs"]["uneven"] = {"uniform": dd.spec.is_uniform(),
                                "method": dd.halo_exchange.method.value}
    gather(dd, hs, "uneven", curr)
    # the guarded engine: every rank's health verdict; checkpoints skipped
    from stencil_tpu_torch.fault import RecoveryExhausted

    ck = os.path.join(out, "ckpt")
    r = tapp.run(**APP_KW, health_every=1, ckpt_dir=ck, ckpt_every=1)
    report["runs"]["guarded"] = {"snapshots": sorted(os.listdir(ck)) if os.path.isdir(ck)
                                 else []}
    gather(r["domain"], r["handles"], "guarded")
    try:
        tapp.run(iters=3, nx=8, dt=1e-5, health_every=1, inject="nan@2:q=lnrho")
        report["nan_raised"] = None
    except RecoveryExhausted as e:
        report["nan_raised"] = str(e)
    # autotune across processes keeps raising: the planner's sub-item
    try:
        tapp.run(nx=8, iters=1, autotune=True)
        report["autotune_raised"] = None
    except NotImplementedError as e:
        report["autotune_raised"] = str(e)
    if rank == 0:
        np.savez(os.path.join(out, "fields.npz"), **arrays)
    with open(os.path.join(out, f"report_{rank}.json"), "w") as f:
        json.dump(report, f)


def _spawn(args, timeout: float = SPAWN_TIMEOUT):
    """The launcher over 2 processes x 4 CPU positions running ``python -m
    <args>``; returns (rc, seconds, stdout, stderr)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    t0 = time.monotonic()
    p = subprocess.run([sys.executable, "-m", "stencil_tpu_torch.apps.launch_multiprocess",
                        "--cpu", "--timeout", str(timeout), "2", "4", *args], cwd=HERE, env=env,
                       capture_output=True, text=True, timeout=timeout + 60)
    return p.returncode, time.monotonic() - t0, p.stdout, p.stderr


# -- the spawn and its references ------------------------------------------------------------

@pytest.fixture(scope="module")
def spawn_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mp_astaroth")
    rc, _s, stdout, stderr = _spawn(["test_torch_astaroth_multiprocess", "astaroth", str(out)])
    assert rc == 0, (stdout + stderr)[-4000:]
    reports = [json.load(open(out / f"report_{r}.json")) for r in range(2)]
    return reports, dict(np.load(out / "fields.npz"))


_refs = {}


def jax_app(swap: bool):
    """The JAX app on its 8 virtual devices, once per exchange mode."""
    if ("jax", swap) not in _refs:
        r = japp.run(devices=jax.devices()[:8], swap_per_substep=swap, **APP_KW)
        _refs["jax", swap] = (r, {k: r["domain"].get_curr_global(r["handles"][k])
                                  for k in FIELDS})
    return _refs["jax", swap]


def port_app(name: str):
    """The port's one-process app run over 8 CPU positions (the fused loop's
    reference is the overlap run, which it equals cell for cell)."""
    kw = APP_RUNS["overlap" if name == "fused" else name]
    if ("port", name) not in _refs:
        r = tapp.run(devices=CPU8, **APP_KW, **kw)
        _refs["port", name] = (r, {k: r["domain"].get_curr_global(r["handles"][k])
                                   for k in FIELDS})
    return _refs["port", name]


@pytest.mark.parametrize("name", list(APP_RUNS) + ["fused"])
def test_runs_across_processes_match_jax_and_one_process(spawn_run, name):
    """Each run over 2 ranks x 4 positions: every gathered cell within
    1e-10 of the JAX app on 8 devices, and bit-equal to the port's
    one-process run over 8 positions; each rank stepped its own 4."""
    reports, arrays = spawn_run
    _jr, want = jax_app(name == "swap")
    _pr, one = port_app(name)
    for k in FIELDS:
        got = arrays[f"{name}_{k}"]
        assert got.dtype == np.float64 and got.shape == (16, 16, 16), k
        np.testing.assert_allclose(got, want[k], err_msg=k, **TOL[np.float64])
        assert np.array_equal(got, one[k]), k
    for rank, rep in enumerate(reports):
        assert rep["runs"][name]["local"] == list(range(4 * rank, 4 * rank + 4))


@pytest.mark.parametrize("name", list(APP_RUNS))
def test_row_and_reductions_across_processes(spawn_run, name):
    """The row reports 8 devices and 2 processes, its CSV's first four
    columns the JAX app's; both ranks hold the same reductions, within rel
    1e-10 of the JAX app's; autotune across processes raises on every
    rank, citing the planner's queue item."""
    reports, _arrays = spawn_run
    jr, _want = jax_app(name == "swap")
    runs = [rep["runs"][name] for rep in reports]
    assert all("queue A item 5" in (rep["autotune_raised"] or "") for rep in reports)
    method = "remote-dma" if name == "remote_dma" else "axis-composed"
    for run in runs:
        assert (run["devices"], run["processes"]) == (8, 2) and jr["devices"] == 8
        assert run["global"] == [16, 16, 16] and run["method"] == method
        assert run["row"].split(",")[:4] == japp.csv_row(jr).split(",")[:4] == ["8", "8", "8", "8"]
        assert run["iters_run"] == 2
        assert run["reductions"] == runs[0]["reductions"]
    for q in ("lnrho", "uu"):
        for stat, v in jr["reductions"][q].items():
            assert runs[0]["reductions"][q][stat] == pytest.approx(v, rel=1e-10, abs=1e-300), \
                (q, stat)


@pytest.mark.parametrize("name", list(APP_RUNS) + ["fused"])
def test_dropped_domain_releases_its_blocks_across_processes(spawn_run, name):
    """With the cycle collector off in every rank, a domain over 2 ranks
    that the run's caller drops takes its exchange and its local blocks
    with it (on the card the exchange holds every exported block, so a
    cycle through it would keep them until a collection)."""
    reports, _arrays = spawn_run
    for rep in reports:
        dropped = rep["runs"][name]["dropped"]
        assert len(dropped) == 2 + 2 * len(FIELDS) and all(dropped), dropped


def test_cli_across_processes_prints_one_row():
    """The app's normal entry point across processes: the launcher over 2
    ranks, each naming its 4 positions with --devices, runs main(), which
    joins the group; it exits 0 and rank 0 alone prints the CSV row, whose
    first four columns are the JAX app's on 8 devices; every rank logs the
    reductions of the one-process run over 8 positions, within rel 1e-10
    (the sums' order differs)."""
    rc, _s, stdout, stderr = _spawn(["stencil_tpu_torch.apps.astaroth", "2", "--nx", "8",
                                     "--reductions", "--devices", ",".join(["cpu"] * 4)])
    assert rc == 0, (stdout + stderr)[-4000:]
    rows = [line for line in stdout.splitlines() if line.count(",") == 5]
    assert len(rows) == 1, stdout
    jr, _want = jax_app(False)
    assert rows[0].split(",")[:4] == japp.csv_row(jr).split(",")[:4] == ["8", "8", "8", "8"]
    one = tapp.run(iters=2, nx=8, devices=CPU8, reductions=True)["reductions"]
    for rank in range(2):
        for q in ("lnrho", "uu"):
            logged = re.search(rf"p{rank}: {q}: (\{{[^}}]*\}})", stderr)
            assert logged, stderr[-4000:]
            got = ast.literal_eval(logged.group(1))
            for stat, v in one[q].items():
                assert got[stat] == pytest.approx(v, rel=1e-10, abs=1e-300), (rank, q, stat)


def test_guarded_run_across_processes(spawn_run, tmp_path):
    """The guarded engine over 2 ranks (a health check a chunk, checkpoints
    every chunk): its saves skip across processes, leaving no snapshot, and
    its fields are bit-equal to the same guarded run in one process (whose
    warm-up, with a checkpoint dir, leaves the state as it was, as
    across processes). A NaN that one rank's block takes at step 2 stops
    both ranks: the health verdict is every rank's."""
    reports, arrays = spawn_run
    one = tapp.run(devices=CPU8, **APP_KW, health_every=1, ckpt_dir=str(tmp_path / "c"),
                   ckpt_every=1)
    for k in FIELDS:
        assert np.array_equal(arrays[f"guarded_{k}"],
                              one["domain"].get_curr_global(one["handles"][k])), k
    msgs = [rep["nan_raised"] for rep in reports]
    for rep in reports:
        assert rep["runs"]["guarded"]["snapshots"] == []
    assert all(m is not None and "cannot roll back" in m for m in msgs)
    assert msgs[0].split("; evidence")[0] == msgs[1].split("; evidence")[0]


def test_uneven_across_processes_matches_jax_and_one_process(spawn_run):
    """19x16x14 over (2,2,2) across 2 ranks (blocks of 10/9, 8/8 and 7/7)
    through make_astaroth_step, serial: within 1e-10 of the JAX step on 8
    devices, bit-equal to the port's one-process step."""
    reports, arrays = spawn_run
    assert reports[0]["runs"]["uneven"] == {"uniform": False, "method": "axis-composed"}
    want = jax_run(UNEVEN, (2, 2, 2), (2, 2, 2), mode="serial")
    one, _ = port_run(UNEVEN, (2, 2, 2), (2, 2, 2), "serial")
    for k in FIELDS:
        got = arrays[f"uneven_{k}"]
        np.testing.assert_allclose(got, want[k], err_msg=k, **TOL[np.float64])
        assert np.array_equal(got, one[k]), k


# -- the card's handshakes, with a recording stand-in -----------------------------------------

class _Recorder:
    def __init__(self, log):
        self.log = log

    def record(self):
        self.log.append(("record",))

    def wait(self, rank):
        self.log.append(("wait", rank))

    def exchange(self, ranks):
        self.log.append(("notify", tuple(ranks)))


class _FakePeers:
    """The phase order of rank 0 of a mesh on the card; every buffer one."""

    def __init__(self, mesh, log):
        neighbours = {a: mesh.neighbour_ranks(a) for a in "xyz" if mesh.ring(a) > 1}
        rec = _Recorder(log)
        steps = [(d.x, d.y, d.z) for d in DIRECTIONS_26]
        self.order = ipc.PhaseOrder(neighbours, rec, rec, mesh.message_ranks(steps))

    def buffer_of(self, stacks):
        return (0, 0)

    def pointer(self, i, q, b):
        return 1 << 20


LAYOUTS = {"2x4": (0, 0, 0, 0, 1, 1, 1, 1), "8x1": tuple(range(8))}
# (method, order): the exchange's handshakes an iteration on each layout's
# rank 0, and the step's own (hoisted: one before stage 0)
ORDERS = [("axis-composed", "hoisted"), ("axis-composed", "serial"), ("axis-composed", "swap"),
          ("axis-composed", "exchange"), ("remote-dma", "hoisted"), ("remote-dma", "serial"),
          ("remote-dma", "swap"), ("remote-dma", "exchange"), ("fused", "hoisted"),
          ("fused", "exchange")]


def _card_step(monkeypatch, owners, method, order, log):
    """Rank 0's Astaroth step of 2 iterations over a (2,2,2) mesh on the
    card, its launches and pulls recorded in place of the kernels."""
    monkeypatch.setattr(distributed, "process_index", lambda: 0)
    positions = [distributed.Position(i, o, "h", "cuda:0", "GPU-a") for i, o in enumerate(owners)]
    mesh = DeviceMesh((2, 2, 2), positions)
    spec = GridSpec(Dim3(16, 16, 16), Dim3(2, 2, 2), Radius.constant(3))
    fused = method == "fused"
    ex = HaloExchange(spec, Method.REMOTE_DMA if fused else Method(method), mesh=mesh,
                      fused=fused)
    ex.attach_peers(_FakePeers(mesh, log))
    if method == "axis-composed":
        monkeypatch.setattr(type(ex._remote), "_pull_round",
                            lambda self, state, keys, rnd: log.append(("pull", rnd.step)))
    monkeypatch.setattr(rdma, "remote_axis_across",
                        lambda ptrs_of, nq, dtype, spec, phase, *a: log.append(
                            ("b6", phase.axis, nq)))
    monkeypatch.setattr(tfused, "fused_exchange_across",
                        lambda ptrs_of, nq, *a: log.append(("b7", nq)))
    monkeypatch.setattr(tfused, "peer_pointers", lambda stacks, peers, mesh: None)

    def stage(curr8, out8, spec, tasks, c, inv_ds, s, dt):
        kinds = {t.position for t in tasks}
        whole = all(t.rect.hi - t.rect.lo == spec.base for t in tasks)
        log.append(("stage", s, "full" if whole else "shells", tuple(sorted(kinds))))

    monkeypatch.setattr(tint, "substep_positions", stage)
    info = tapp.load(nx=8)
    if order == "exchange":  # --no-compute: 3 exchanges an iteration
        loop = ex.make_loop(3)

        def step(curr, nxt):
            for _ in range(2):
                loop(curr)
    elif fused:
        step = tint.make_fused_astaroth_loop(ex, info, iters=2, dtype="float64")
    else:
        step = tint.make_astaroth_step(ex, info, iters=2, dtype="float64",
                                       overlap=order == "hoisted", swap_per_substep=order == "swap")
    shape = spec.block_shape_zyx()
    state = [{k: [torch.zeros((1, 1, 1, *shape), dtype=torch.float64) if mesh.is_local(i)
                  else None for i in range(8)] for k in FIELDS} for _ in range(2)]
    return step, state, mesh


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("method,order", ORDERS)
def test_handshakes_an_iteration_on_the_card(monkeypatch, layout, method, order):
    """Rank 0's step on the card: every stage over its own positions only;
    in the serial and swap orders no handshake beyond the exchange's (one an
    axis phase that crosses to another rank: z on 2 x 4, x, y and z on
    8 x 1); in the hoisted order one more with every rank the messages cross
    to right before stage 0 (it overwrites the buffer they pulled from);
    the fused loop that one and B7's own. The counts an iteration: the
    crossing axes c in the serial order, 3c in the swap order, c + 1 in the
    hoisted order, 2 in the fused loop; ``--no-compute``'s 3 exchanges 3c,
    or 3 by B7 (back-to-back exchanges of one buffer rewrite each halo with
    the value it holds, so they need no handshake of their own)."""
    log = []
    step, (curr, nxt), mesh = _card_step(monkeypatch, LAYOUTS[layout], method, order, log)
    order_ = mesh.message_ranks([(d.x, d.y, d.z) for d in DIRECTIONS_26])
    step(curr, nxt)
    mine = tuple(mesh.local_positions())
    stages = [e for e in log if e[0] == "stage"]
    assert all(e[3] == mine for e in stages)
    crossing = sum(1 for a in "xyz" if mesh.neighbour_ranks(a))
    assert crossing == {"2x4": 1, "8x1": 3}[layout]
    want = {"serial": crossing, "swap": 3 * crossing, "hoisted": crossing + 1,
            "exchange": 3 * crossing}[order]
    if method == "fused":
        want = 3 if order == "exchange" else 2
    records = [i for i, e in enumerate(log) if e == ("record",)]
    assert len(records) == 2 * want
    if order == "hoisted":
        # each iteration opens with the handshake with every rank, then stage 0
        firsts = [i for i, e in enumerate(log) if e[:3] == ("stage", 0, "full")]
        for f in firsts:
            assert log[f - 2 - len(order_):f] == [("record",), ("notify", order_)] + [
                ("wait", r) for r in order_]
        assert [e[:3] for e in stages] == 2 * [("stage", 0, "full"), ("stage", 0, "shells"),
                                               ("stage", 1, "full"), ("stage", 2, "full")]
    elif order == "exchange":
        assert not stages
    else:
        # every stage follows an exchange's last move
        moves = ("pull", "b6", "b7")
        for i, e in enumerate(log):
            if e[0] == "stage" and (order == "swap" or e[1] == 0):
                assert log[i - 1][0] in moves
    carriers = [e for e in log if e[0] in ("b6", "b7")]
    assert all(e[-1] == 8 for e in carriers)  # the 8 fields, one group


# -- B6's and B7's cross-process tables at Astaroth's shape, replayed -------------------------

@pytest.mark.parametrize("owners", list(LAYOUTS.values()), ids=list(LAYOUTS))
def test_b6_tables_at_astaroth_shape_replay_to_the_plain_version(monkeypatch, owners):
    """B6's cross-process launch of each rank over 8 fp64 fields at r3 on
    (2,2,2), replayed as the kernel reads its tables: all ranks' launches
    together equal remote_axis_plain over every position, bit for bit."""
    from test_torch_multiprocess import _ReplayCard

    spec = GridSpec(Dim3(20, 18, 16), Dim3(2, 2, 2), Radius.constant(3))
    p, n, nq = spec.padded(), 8, 8
    cells, margin = p.z * p.y * p.x, 4 * p.y * p.x
    rng = np.random.RandomState(31)
    arena = torch.from_numpy(rng.rand(margin + n * nq * cells))
    got = [[arena[margin + (i * nq + q) * cells:][:cells].view(1, 1, 1, p.z, p.y, p.x)
            for q in range(nq)] for i in range(n)]
    want = [[b.clone() for b in g] for g in got]
    card = _ReplayCard(monkeypatch, arena)
    one = DeviceMesh((2, 2, 2), ["cpu"] * n)
    positions = [distributed.Position(i, o, "h", "cpu") for i, o in enumerate(owners)]
    for ph in build_plan(spec, (2, 2, 2), Method.REMOTE_DMA).remote_phases:
        rdma.remote_axis_plain(want, spec, ph, one)
        for rank in sorted(set(owners)):
            monkeypatch.setattr(distributed, "process_index", lambda rank=rank: rank)
            mesh = DeviceMesh((2, 2, 2), positions)
            rdma.remote_axis_across(lambda i: tuple(b.data_ptr() for b in got[i]), nq,
                                    torch.float64, spec, ph, mesh, torch.device("cpu"))
            assert card.calls[-1][0] == len(mesh.local_positions()) * nq
    for ga, gb in zip(got, want):
        for a, b in zip(ga, gb):
            assert torch.equal(a, b)


@pytest.mark.parametrize("owners", list(LAYOUTS.values()), ids=list(LAYOUTS))
def test_b7_tables_at_astaroth_shape_replay_to_the_plain_version(monkeypatch, owners):
    """B7's cross-process launch of each rank over 8 fp64 fields at r3 on
    (2,2,2): one pointer group a box and field for each of its receivers,
    replayed; all ranks' launches together equal fused_exchange_plain over
    every position, bit for bit."""
    from test_torch_multiprocess_variants import ReplayCard

    spec = GridSpec(Dim3(20, 18, 16), Dim3(2, 2, 2), Radius.constant(3))
    plan = build_plan(spec, (2, 2, 2), Method.REMOTE_DMA, fused=True)
    n, nq = 8, 8
    rng = np.random.RandomState(37)
    p = spec.padded()
    flat = [torch.from_numpy(rng.rand(1, 1, 1, p.z, p.y, p.x)) for _ in range(n * nq)]
    got = [flat[i * nq:(i + 1) * nq] for i in range(n)]
    want = [[b.clone() for b in g] for g in got]
    tfused.fused_exchange_plain(want, spec, plan, DeviceMesh((2, 2, 2), ["cpu"] * n))
    card = ReplayCard(monkeypatch, flat)
    positions = [distributed.Position(i, o, "h", "cpu") for i, o in enumerate(owners)]
    for rank in sorted(set(owners)):
        monkeypatch.setattr(distributed, "process_index", lambda rank=rank: rank)
        mesh = DeviceMesh((2, 2, 2), positions)
        tfused.fused_exchange_across(lambda i: tuple(b.data_ptr() for b in got[i]), nq,
                                     torch.float64, spec, plan, mesh, torch.device("cpu"))
        m = len(mesh.local_positions()) * nq
        assert card.calls[-1] == ("b7", m, len(plan.fused_phases) * m)
    for ga, gb in zip(got, want):
        for a, b in zip(ga, gb):
            assert torch.equal(a, b)


# -- the init of each position's block ------------------------------------------------------

@pytest.mark.parametrize("size,part", [((16, 16, 16), (2, 2, 2)), (UNEVEN, (2, 2, 2)),
                                       ((24, 20, 16), (3, 2, 1)), ((32, 16, 16), (4, 2, 2))],
                         ids=["uniform", "uneven", "3x2x1", "4x2x2-on-8"])
def test_init_of_each_block_is_the_global_init_sliced(monkeypatch, size, part):
    """Each block's init, made over its own global cells, equals the slice
    of the global init bit for bit, fp64 and fp32; and the app's init of a
    domain's blocks (in z slabs over the host's cores) and of a mesh's
    positions (each its own blocks, as each rank makes its own; two a
    position on the 4x2x2 partition over 8) equals the global init
    scattered, halos included."""
    spec = GridSpec(Dim3(*size), Dim3(*part), Radius.constant(3))
    ds = (0.04908738521, 0.05, 0.06)
    for dt in (np.float64, np.float32):
        whole = tapp.init_arrays(spec.global_size, ds, np.dtype(dt))
        for iz in range(part[2]):
            for iy in range(part[1]):
                for ix in range(part[0]):
                    lo = spec.block_origin((ix, iy, iz))
                    hi = lo + spec.block_size((ix, iy, iz))
                    got = tapp.init_arrays(spec.global_size, ds, np.dtype(dt), Rect3(lo, hi))
                    for k in FIELDS:
                        assert got[k].dtype == dt, k
                        assert np.array_equal(got[k], whole[k][lo.z:hi.z, lo.y:hi.y, lo.x:hi.x]), k
    assert np.array_equal(tinit.hash_init(size, region=Rect3(Dim3(0, 0, 0), Dim3(*size))),
                          tinit.hash_init(size))
    info = tapp.load(nx=8)
    ds = (info.real_params["AC_dsx"], info.real_params["AC_dsy"], info.real_params["AC_dsz"])
    whole = tapp.init_arrays(spec.global_size, ds, np.dtype("float64"))
    monkeypatch.setattr(os, "cpu_count", lambda: 20)  # several z slabs a block, ragged
    from stencil_tpu_torch import DistributedDomain
    from stencil_tpu_torch.parallel import join_positions, shard_blocks

    for devices in (["cpu"] * min(8, int(np.prod(part))), None):
        dd = DistributedDomain(*size, device="cpu")
        dd.set_radius(3)
        dd.set_partition(part)
        if devices:
            dd.set_devices(devices)
            if len(devices) < np.prod(part):  # oversubscribed: REMOTE_DMA alone moves it
                dd.set_methods(Method.REMOTE_DMA)
        hs = {k: dd.add_data(k, "float64") for k in FIELDS}
        dd.realize()
        assert (dd.mesh is not None) == bool(devices)
        tapp.init_fields(dd, hs, info, "float64")
        for k in FIELDS:
            got = dd.get_curr(hs[k])
            if devices:
                got = join_positions(got, dd.spec)
            assert torch.equal(got, shard_blocks(whole[k], dd.spec, "cpu")), k


if __name__ == "__main__":
    torch.set_num_threads(1)
    {"astaroth": worker_astaroth}[sys.argv[1]](sys.argv[2])
