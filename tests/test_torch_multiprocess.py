"""The port over several processes on the CPU: 2 processes x 4 positions,
launched by ``apps/launch_multiprocess`` over gloo, against the JAX
package on its 8 virtual CPU devices.

The workers are this file run as a module by the launcher (``python -m
test_torch_multiprocess <mode> <out>``): the groundwork (the group from
the environment, the rank order, the fingerprint, the link costs, ``proc``
on each rank's records), the exchange of ``tests/_mp_worker.py``'s config
(24x20x16, r2, the fp32 coordinate pattern) by REMOTE_DMA with each rank
checking its own halos, a mixed fp32 + fp64 dict through a bf16 wire on
an uneven 25x20x16, the fused exchange (B7) over gloo of the pattern and
of a mixed dict through bf16, the refusals, Astaroth over one position a
rank, and jacobi3d at 64^3. Rank 0 gathers
every block, halos included, and writes them to ``<out>``; the tests hold
them bit-equal to the JAX package's single-process exchange and jacobi3d.
The launcher's refusals (a failing rank, the time limit) and the phase
order of the card's exchange (a recording stand-in for the events) need
no card. Four spawns in all, torch at one thread, each under a time limit.
Tolerance: bit-exact."""

import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

import stencil_tpu.apps.jacobi3d as japp
import stencil_tpu.parallel as jpar
from stencil_tpu.api import DistributedDomain as JDomain
from stencil_tpu.geometry import NodePartition as JNodePartition
from stencil_tpu.geometry import Radius as JRadius
from stencil_tpu.parallel import device_topo as jtopo
from stencil_tpu_torch.apps import launch_multiprocess as launcher
from stencil_tpu_torch.parallel import distributed, ipc
from stencil_tpu_torch.parallel.mesh import DeviceMesh

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SPAWN_TIMEOUT = 240
RDMA_J = jpar.Method.REMOTE_DMA
JACOBI_ITERS = 4
# jacobi3d 32^3, 5 steps, in the exchange spawn: (name, method, deep_halo)
COMPOSED_RUNS = (("composed", "axis-composed", 1), ("composed_deep", "axis-composed", 2),
                 ("direct26", "direct26", 1))


def coords(shape, dtype):
    g = shape
    return (np.arange(g[0])[:, None, None] * 1000000 + np.arange(g[1])[None, :, None] * 1000
            + np.arange(g[2])[None, None, :]).astype(dtype)


# -- the workers (run by the launcher) ------------------------------------------------

def _gathered(dd, h):
    """Rank 0: every position's block with its halos, as the stacked
    (bz, by, bx, pz, py, px) array."""
    from stencil_tpu_torch.parallel.exchange import gather_positions, join_positions

    blocks = gather_positions(dd.get_curr(h), dd.mesh, dd.peers)
    return None if blocks is None else join_positions(blocks, dd.spec).numpy()


def _own_halos_ok(dd, h, g) -> int:
    """``tests/_mp_worker.py``'s check of every halo cell of this rank's
    blocks against the coordinate pattern; returns the cells checked."""
    spec, r = dd.spec, dd.spec.radius
    off = spec.compute_offset()
    checked = 0
    for i in dd.mesh.local_positions():
        pos = dd.mesh.position(i)
        blk = dd.get_curr(h)[i][0, 0, 0].numpy()
        o, s = spec.block_origin(pos), spec.block_size(pos)
        for zz in range(-r.z(-1), s.z + r.z(1)):
            for yy in range(-r.y(-1), s.y + r.y(1)):
                for xx in range(-r.x(-1), s.x + r.x(1)):
                    if 0 <= zz < s.z and 0 <= yy < s.y and 0 <= xx < s.x:
                        continue
                    gz, gy, gx = (o.z + zz) % g.z, (o.y + yy) % g.y, (o.x + xx) % g.x
                    want = gz * 1000000 + gy * 1000 + gx
                    assert blk[off.z + zz, off.y + yy, off.x + xx] == want, (i, zz, yy, xx)
                    checked += 1
    return checked


def worker_exchange(out: str) -> None:
    from stencil_tpu_torch import DistributedDomain
    from stencil_tpu_torch.apps.machine_info import fabric_fingerprint
    from stencil_tpu_torch.fault import NumericalFault
    from stencil_tpu_torch.obs import telemetry
    from stencil_tpu_torch.parallel import Method
    from stencil_tpu_torch.parallel.topology import Topology, link_cost_matrix

    assert distributed.maybe_init_from_env()
    rank, world = distributed.process_index(), distributed.process_count()
    rec = telemetry.configure(os.path.join(out, f"metrics_{rank}.jsonl"), app="mp")
    report = {"rank": rank, "world": world}
    glob = distributed.global_positions(distributed.default_positions())
    report["owners"] = [p.process_index for p in glob]
    report["local"] = [p.index for p in distributed.local_devices(glob)]
    report["colocated"] = {str(k): [p.index for p in v]
                           for k, v in distributed.colocated_devices(glob).items()}
    report["fingerprint"] = fabric_fingerprint(devices=distributed.default_positions())
    report["links"] = link_cost_matrix(glob).tolist()
    report["neighbor"] = list(Topology((2, 2, 2)).get_neighbor((1, 1, 1), (1, 0, -1)).index)

    # tests/_mp_worker.py's config, by REMOTE_DMA
    dd = DistributedDomain(24, 20, 16, device="cpu")
    dd.set_radius(2)
    dd.set_methods(Method.REMOTE_DMA)
    dd.set_devices(distributed.default_positions())
    h = dd.add_data("q", "float32")
    dd.realize()
    g = dd.size
    dd.set_curr_global(h, coords((g.z, g.y, g.x), np.float32))
    dd.exchange()
    report["halo_cells"] = _own_halos_ok(dd, h, g)
    report["dim"] = list(dd.spec.dim)
    report["mesh_owners"] = list(dd.mesh.owners)
    report["transfers"] = dd.halo_exchange.last_transfer_count
    report["local_blocks"] = sum(b is not None for b in dd.get_curr(h))
    arrays = {"coords": _gathered(dd, h)}
    report["global_equal"] = None
    glob_arr = dd.get_curr_global(h)
    if rank == 0:
        report["global_equal"] = bool(np.array_equal(glob_arr, coords((g.z, g.y, g.x),
                                                                     np.float32)))
    dd.save_checkpoint(os.path.join(out, "ckpt"), 1)
    report["restored"] = dd.restore_checkpoint(os.path.join(out, "ckpt"))
    # the health verdict is every rank's: a NaN on rank 1 faults both
    dd.check_health()
    if rank == 1:
        dd.get_curr(h)[dd.mesh.local_positions()[0]][0, 0, 0, 3, 3, 3] = float("nan")
    try:
        dd.check_health()
        report["health"] = None
    except NumericalFault as e:
        report["health"] = str(e)
    try:
        dd.replan(dd.plan_meta()["choice"])
    except NotImplementedError as e:
        report["raised_replan"] = str(e)

    # a mixed dict through a bf16 wire on an uneven partition
    md = DistributedDomain(25, 20, 16, device="cpu")
    md.set_radius(1)
    md.set_methods(Method.REMOTE_DMA)
    md.set_devices(distributed.default_positions())
    md.set_wire_dtype("bfloat16")
    a = md.add_data("a", "float32")
    b = md.add_data("b", "float64")
    md.realize()
    report["mixed_dim"] = list(md.spec.dim)
    rng = np.random.RandomState(7)
    md.set_curr_global(a, rng.rand(16, 20, 25).astype(np.float32))
    md.set_curr_global(b, rng.rand(16, 20, 25))
    md.exchange()
    arrays["mixed_a"] = _gathered(md, a)
    arrays["mixed_b"] = _gathered(md, b)

    # B7 across processes (the fused exchange over gloo): the coordinate
    # pattern, and a mixed dict through a bf16 wire
    fd = DistributedDomain(24, 20, 16, device="cpu")
    fd.set_radius(2)
    fd.set_methods(Method.REMOTE_DMA)
    fd.set_fused_exchange(True)
    fd.set_devices(distributed.default_positions())
    fh = fd.add_data("q", "float32")
    fd.realize()
    fd.set_curr_global(fh, coords((16, 20, 24), np.float32))
    fd.exchange()
    report["fused_transfers"] = fd.halo_exchange.last_transfer_count
    arrays["fused_coords"] = _gathered(fd, fh)
    fm = DistributedDomain(24, 20, 16, device="cpu")
    fm.set_radius(1)
    fm.set_methods(Method.REMOTE_DMA)
    fm.set_fused_exchange(True)
    fm.set_devices(distributed.default_positions())
    fm.set_wire_dtype("bfloat16")
    fa, fb = fm.add_data("a", "float32"), fm.add_data("b", "float64")
    fm.realize()
    rng = np.random.RandomState(8)
    fm.set_curr_global(fa, rng.rand(16, 20, 24).astype(np.float32))
    fm.set_curr_global(fb, rng.rand(16, 20, 24))
    fm.exchange()
    arrays["fused_mixed_a"] = _gathered(fm, fa)
    arrays["fused_mixed_b"] = _gathered(fm, fb)

    # AXIS_COMPOSED and DIRECT26 over gloo: the coordinate pattern at r2, a
    # mixed dict through a bf16 wire on the uneven 25x20x16, and DIRECT26's
    # uneven boxes
    report["messages"] = {}
    for name, method, wire, size, radius, dts in (
            ("composed_coords", Method.AXIS_COMPOSED, None, (24, 20, 16), 2, ["float32"]),
            ("direct26_coords", Method.DIRECT26, None, (24, 20, 16), 2, ["float32"]),
            ("composed_mixed", Method.AXIS_COMPOSED, "bfloat16", (25, 20, 16), 1,
             ["float32", "float64"]),
            ("direct26_mixed", Method.DIRECT26, None, (25, 20, 16), 1, ["float32", "float64"])):
        cd = DistributedDomain(*size, device="cpu")
        cd.set_radius(radius)
        cd.set_methods(method)
        cd.set_devices(distributed.default_positions())
        if wire:
            cd.set_wire_dtype(wire)
        chs = [cd.add_data(f"q{i}", dt) for i, dt in enumerate(dts)]
        cd.realize()
        rng = np.random.RandomState(9)
        for ch, dt in zip(chs, dts):
            cd.set_curr_global(ch, coords(size[::-1], np.float32) if name.endswith("coords")
                               else rng.rand(*size[::-1]).astype(dt))
        cd.exchange()
        report["messages"][name] = [cd.halo_exchange.last_message_count,
                                    cd.halo_exchange.last_message_bytes,
                                    cd.halo_exchange.last_transfer_count]
        for i, ch in enumerate(chs):
            arrays[f"{name}_{i}"] = _gathered(cd, ch)

    # the refusals (more blocks than positions, by REMOTE_DMA and by
    # AXIS_COMPOSED; autotune); the fused and persistent variants and
    # AXIS_COMPOSED realize, and Astaroth runs
    report["raised"] = {}
    for name, setup in (("fused", lambda d: d.set_fused_exchange(True)),
                        ("persistent", lambda d: d.set_persistent_exchange(True)),
                        ("oversubscribed", lambda d: d.set_partition((4, 2, 2))),
                        ("axis-composed", lambda d: d.set_methods(Method.AXIS_COMPOSED)),
                        ("axis-composed-oversubscribed",
                         lambda d: (d.set_methods(Method.AXIS_COMPOSED),
                                    d.set_partition((4, 2, 2)))),
                        ("autotune", lambda d: d.enable_autotune(probe=False))):
        d = DistributedDomain(16, 16, 16, device="cpu")
        d.set_radius(1)
        d.set_methods(Method.REMOTE_DMA)
        d.set_devices(distributed.default_positions())
        setup(d)
        d.add_data("t", "float32")
        try:
            d.realize()
            report["raised"][name] = None
        except NotImplementedError as e:
            report["raised"][name] = str(e)
    from stencil_tpu_torch.apps import astaroth as tast

    # Astaroth with one position a rank (the given device): it runs
    try:
        r = tast.run(nx=8, iters=1, device="cpu", dt=1e-5)
        report["raised"]["astaroth"] = None
        report["astaroth"] = [r["processes"], r["devices"], tast.csv_row(r).split(",")[:4]]
        arrays["astaroth_uux"] = r["domain"].get_curr_global(r["handles"]["uux"])
    except NotImplementedError as e:
        report["raised"]["astaroth"] = str(e)
    # jacobi3d by AXIS_COMPOSED at deep_halo 1 and 2, and by DIRECT26
    import stencil_tpu_torch.apps.jacobi3d as tapp

    for name, method, deep in COMPOSED_RUNS:
        r = tapp.run(32, 32, 32, iters=5, method=Method(method), deep_halo=deep, weak=False)
        report[f"row_{name}"] = tapp.csv_row(r)
        report[f"k_{name}"] = r["temporal_k"]
        arrays[f"jacobi_{name}"] = r["domain"].get_curr_global(r["handle"])
    notices = ipc.GlooNotices(ipc.notice_group())
    for _ in range(3):
        notices.exchange([1 - rank])
    report["notices"] = {str(k): v for k, v in notices.sent.items()}
    rec.meta("mp.done", rank=rank)
    telemetry.configure()
    if rank == 0:
        np.savez(os.path.join(out, "exchange.npz"), **arrays)
    with open(os.path.join(out, f"report_{rank}.json"), "w") as f:
        json.dump(report, f)


def worker_jacobi(out: str) -> None:
    import stencil_tpu_torch.apps.jacobi3d as tapp
    from stencil_tpu_torch.parallel import Method

    distributed.maybe_init_from_env()
    r = tapp.run(64, 64, 64, iters=JACOBI_ITERS, method=Method.REMOTE_DMA, weak=False)
    field = r["domain"].get_curr_global(r["handle"])
    if distributed.process_index() == 0:
        np.save(os.path.join(out, "jacobi.npy"), field)
        with open(os.path.join(out, "jacobi_row.txt"), "w") as f:
            f.write(tapp.csv_row(r))


def worker_fail(out: str) -> None:
    if os.environ[distributed.PROCESS_ID_ENV] == "1":
        sys.exit(3)
    time.sleep(120)


def worker_hang(out: str) -> None:
    time.sleep(120)


def _spawn(mode: str, out, timeout: float = SPAWN_TIMEOUT):
    """The launcher over 2 processes x 4 CPU positions running ``mode``;
    returns (rc, seconds, output)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    t0 = time.monotonic()
    p = subprocess.run([sys.executable, "-m", "stencil_tpu_torch.apps.launch_multiprocess",
                        "--cpu", "--timeout", str(timeout), "2", "4", "test_torch_multiprocess",
                        mode, str(out)], cwd=HERE, env=env, capture_output=True, text=True,
                       timeout=timeout + 60)
    return p.returncode, time.monotonic() - t0, p.stdout + p.stderr


# -- the tests --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def exchange_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mp_exchange")
    rc, _s, log = _spawn("exchange", out)
    assert rc == 0, log[-4000:]
    reports = [json.load(open(out / f"report_{r}.json")) for r in range(2)]
    return out, reports, dict(np.load(out / "exchange.npz"))


def _jax_domain(size, dim, radius, dtypes, wire=None, fused=False, method=RDMA_J):
    dd = JDomain(*size)
    dd.set_radius(radius)
    dd.set_methods(method)
    dd.set_devices(jax.devices()[:8])
    dd.set_partition(dim)
    dd.set_fused_exchange(fused)
    if wire:
        dd.set_wire_dtype(wire)
    hs = [dd.add_data(f"q{i}", dt) for i, dt in enumerate(dtypes)]
    dd.realize()
    return dd, hs


def test_groundwork_from_the_environment(exchange_run):
    _out, reports, _arrays = exchange_run
    for rank, rep in enumerate(reports):
        assert (rep["rank"], rep["world"]) == (rank, 2)
        # process 0's positions first, as in JAX's global device order
        assert rep["owners"] == [0] * 4 + [1] * 4
        assert rep["local"] == list(range(4 * rank, 4 * rank + 4))
        assert rep["colocated"] == {"0": [0, 1, 2, 3], "1": [4, 5, 6, 7]}
        assert rep["fingerprint"] == {"processes": 2, "hosts": 1, "devices": 8,
                                      "platform": "cpu", "virtual_hosts": ""}
        assert rep["neighbor"] == [0, 1, 0]


def test_link_costs_match_jax_distance_matrix(exchange_run):
    """2 ranks x 4 CPU positions against JAX's distance_matrix on stand-in
    devices with the same process_index."""

    class Dev:
        def __init__(self, i, proc):
            self.id, self.process_index, self.platform = i, proc, "cpu"

    want = jtopo.distance_matrix([Dev(i, i // 4) for i in range(8)])
    for rep in exchange_run[1]:
        np.testing.assert_array_equal(np.array(rep["links"]), want)


@pytest.mark.parametrize("hosts", [None, 2, 4])
def test_host_assignment_matches_jax(monkeypatch, hosts):
    """Each position's host (its process, or the virtual host of the
    index-sorted list) and the host groups, against JAX's on stand-in
    devices of the same ids and processes, in a permuted order; with the
    knob the distances follow the emulated hosts."""
    from stencil_tpu_torch.parallel import device_topo

    class Dev:
        def __init__(self, i, proc):
            self.id, self.process_index, self.platform = i, proc, "cpu"

    order = [5, 2, 7, 0, 3, 6, 1, 4]
    jdevs = [Dev(i, i // 4) for i in order]
    tpos = [distributed.Position(i, i // 4, "h", "cpu") for i in order]
    assert device_topo.host_assignment(tpos, hosts) == jtopo.host_assignment(jdevs, hosts)
    assert [[p.index for p in g] for g in device_topo.host_groups(tpos, hosts)] == \
        [[d.id for d in g] for g in jtopo.host_groups(jdevs, hosts)]
    if hosts:
        monkeypatch.setenv(device_topo.VIRTUAL_HOSTS_ENV, str(hosts))
        assert device_topo.virtual_hosts() == hosts
        np.testing.assert_array_equal(device_topo.distance_matrix(tpos),
                                      jtopo.distance_matrix(jdevs))


def test_mp_worker_config_matches_jax(exchange_run):
    """The partition is JAX's NodePartition with 2 hosts, process 0 owns the
    first 4 positions, every halo of each rank checks, and the gathered
    blocks equal JAX's single-process exchange on 8 devices."""
    _out, reports, arrays = exchange_run
    want_dim = JNodePartition((24, 20, 16), JRadius.constant(2), 2, 4).dim()
    jdd, (jh,) = _jax_domain((24, 20, 16), want_dim, 2, ["float32"])
    g = jdd.size
    jdd.set_curr_global(jh, coords((g.z, g.y, g.x), np.float32))
    jdd.exchange()
    for rep in reports:
        assert rep["dim"] == [want_dim.x, want_dim.y, want_dim.z]
        assert rep["mesh_owners"] == [0] * 4 + [1] * 4
        assert rep["halo_cells"] > 0 and rep["local_blocks"] == 4
        # one slab a side, position and dtype group on each multi-position axis
        assert rep["transfers"] == 4 * 2 * sum(n > 1 for n in rep["dim"])
    assert reports[0]["global_equal"] is True and reports[1]["global_equal"] is None
    np.testing.assert_array_equal(arrays["coords"], np.asarray(jdd.get_curr(jh)))


def test_mixed_dict_bf16_wire_uneven_matches_jax(exchange_run):
    _out, reports, arrays = exchange_run
    dim = reports[0]["mixed_dim"]
    jdd, (ja, jb) = _jax_domain((25, 20, 16), tuple(dim), 1, ["float32", "float64"],
                                wire="bfloat16")
    assert not jdd.spec.is_uniform()
    rng = np.random.RandomState(7)
    jdd.set_curr_global(ja, rng.rand(16, 20, 25).astype(np.float32))
    jdd.set_curr_global(jb, rng.rand(16, 20, 25))
    jdd.exchange()
    np.testing.assert_array_equal(arrays["mixed_a"], np.asarray(jdd.get_curr(ja)))
    np.testing.assert_array_equal(arrays["mixed_b"], np.asarray(jdd.get_curr(jb)))


def test_refusals_checkpoint_skips_and_health(exchange_run):
    out, reports, arrays = exchange_run
    for rep in reports:
        # the fused and persistent variants realize across processes; more
        # blocks than positions still raises
        assert rep["raised"]["fused"] is None and rep["raised"]["persistent"] is None
        assert "queue B item 6" in rep["raised"]["oversubscribed"]
        # AXIS_COMPOSED realizes across processes; over more blocks than
        # positions it raises. Astaroth runs, each rank's one position a
        # block of the (1,1,2) mesh
        assert rep["raised"]["axis-composed"] is None
        assert "queue A item 5" in rep["raised"]["axis-composed-oversubscribed"]
        assert rep["raised"]["astaroth"] is None
        assert rep["astaroth"] == [2, 2, ["2", "8", "8", "8"]]
        assert "queue A item 5" in rep["raised"]["autotune"]
        assert "queue A item 5" in rep["raised_replan"]
        assert rep["restored"] is None
        assert rep["health"] and "nonfinite" in rep["health"].lower()
    assert not os.path.exists(out / "ckpt") or not os.listdir(out / "ckpt")
    from stencil_tpu_torch.apps import astaroth as tast

    one = tast.run(nx=8, iters=1, devices=["cpu"] * 2, dt=1e-5)
    np.testing.assert_array_equal(arrays["astaroth_uux"],
                                  one["domain"].get_curr_global(one["handles"]["uux"]))


@pytest.mark.parametrize("case", ["fp32-r2", "mixed-bf16"])
def test_fused_exchange_over_gloo_matches_jax(exchange_run, case):
    """B7 across processes on the CPU (``fused_exchange_gloo``): the
    coordinate pattern at r2, and an fp32 + fp64 dict through a bf16 wire,
    gathered on rank 0 bit-equal to the JAX package's one-process fused
    exchange on 8 virtual devices; each rank counts the messages its own
    positions sent to another position (every direction crosses on
    (2,2,2): 26 a position)."""
    _out, reports, arrays = exchange_run
    dim = tuple(reports[0]["dim"])
    if case == "fp32-r2":
        jdd, hs = _jax_domain((24, 20, 16), dim, 2, ["float32"], fused=True)
        jdd.set_curr_global(hs[0], coords((16, 20, 24), np.float32))
        names = ["fused_coords"]
        for rep in reports:
            assert rep["fused_transfers"] == 4 * 26
    else:
        jdd, hs = _jax_domain((24, 20, 16), dim, 1, ["float32", "float64"], wire="bfloat16",
                              fused=True)
        rng = np.random.RandomState(8)
        jdd.set_curr_global(hs[0], rng.rand(16, 20, 24).astype(np.float32))
        jdd.set_curr_global(hs[1], rng.rand(16, 20, 24))
        names = ["fused_mixed_a", "fused_mixed_b"]
    jdd.exchange()
    for name, h in zip(names, hs):
        np.testing.assert_array_equal(arrays[name], np.asarray(jdd.get_curr(h)))


@pytest.mark.parametrize("name", ["composed_coords", "direct26_coords", "composed_mixed",
                                  "direct26_mixed"])
def test_composed_and_direct26_over_gloo_match_jax(exchange_run, name):
    """AXIS_COMPOSED and DIRECT26 across processes on the CPU (the messages
    by gloo ``isend``/``irecv`` of the packed carriers,
    ``parallel/mesh_exchange``): the coordinate pattern at r2, and an fp32 +
    fp64 dict on the uneven 25x20x16 (AXIS_COMPOSED through a bf16 wire),
    gathered on rank 0 bit-equal, halos included, to the JAX package's
    one-process exchange of the same method on 8 virtual devices; each rank
    counts the IR's messages and the bytes written into its own positions,
    and no remote-dma transfer."""
    _out, reports, arrays = exchange_run
    method = jpar.Method.DIRECT26 if name.startswith("direct26") else jpar.Method.AXIS_COMPOSED
    coords_case = name.endswith("coords")
    size, radius = ((24, 20, 16), 2) if coords_case else ((25, 20, 16), 1)
    dtypes = ["float32"] if coords_case else ["float32", "float64"]
    wire = "bfloat16" if name == "composed_mixed" else None
    dim = tuple(reports[0]["dim"] if coords_case else reports[0]["mixed_dim"])
    jdd, hs = _jax_domain(size, dim, radius, dtypes, wire=wire, method=method)
    rng = np.random.RandomState(9)
    for h, dt in zip(hs, dtypes):
        jdd.set_curr_global(h, coords(size[::-1], np.float32) if coords_case
                            else rng.rand(*size[::-1]).astype(dt))
    jdd.exchange()
    for i, h in enumerate(hs):
        np.testing.assert_array_equal(arrays[f"{name}_{i}"], np.asarray(jdd.get_curr(h)))
    plan = jdd.halo_exchange.plan
    want = plan.collectives_per_exchange(len(dtypes), len(set(dtypes)))
    sizes = [np.dtype(d).itemsize for d in dtypes]
    wire_bytes = plan.wire_bytes(sizes)
    counts = [rep["messages"][name] for rep in reports]
    assert all(c[0] == want and c[2] == 0 for c in counts)
    assert sum(c[1] for c in counts) == wire_bytes > 0


@pytest.mark.parametrize("name,method,deep", COMPOSED_RUNS)
def test_jacobi3d_by_composed_and_direct26_over_gloo_matches_jax(exchange_run, name, method,
                                                                 deep):
    """jacobi3d 32^3 over 2 ranks x 4 positions by AXIS_COMPOSED (the
    overlap step, and the deep-halo multistep's positions form at k = 2)
    and by DIRECT26, 5 steps after the warm-up chunk, bit-equal to the JAX
    app on 8 virtual devices; rank 0's row names the method run."""
    _out, reports, arrays = exchange_run
    want = japp.run(32, 32, 32, devices=jax.devices()[:8], method=jpar.Method(method), iters=5,
                    weak=False, deep_halo=deep)
    np.testing.assert_array_equal(arrays[f"jacobi_{name}"],
                                  want["domain"].get_curr_global(want["handle"]))
    assert reports[0][f"row_{name}"].split(",")[:4] == ["jacobi3d", method, "2", "8"]
    assert reports[0][f"k_{name}"] == (2 if deep == 2 else 0)


def test_records_carry_each_rank(exchange_run):
    out = exchange_run[0]
    for rank in range(2):
        recs = [json.loads(ln) for ln in open(out / f"metrics_{rank}.jsonl")]
        assert recs and all(r["proc"] == rank for r in recs)
        names = [r["name"] for r in recs]
        assert "ckpt.save_skipped" in names and "ckpt.restore_skipped" in names
        assert "mp.done" in names


def test_jacobi3d_under_the_launcher_matches_jax(tmp_path):
    rc, _s, log = _spawn("jacobi", tmp_path)
    assert rc == 0, log[-4000:]
    row = open(tmp_path / "jacobi_row.txt").read().split(",")
    assert row[:7] == ["jacobi3d", "remote-dma", "2", "8", "64", "64", "64"]
    want = japp.run(64, 64, 64, devices=jax.devices()[:8], method=RDMA_J, iters=JACOBI_ITERS,
                    weak=False)
    np.testing.assert_array_equal(np.load(tmp_path / "jacobi.npy"),
                                  want["domain"].get_curr_global(want["handle"]))


@pytest.mark.parametrize("mode,timeout,rc", [("fail", 60, 3), ("hang", 6, launcher.TIMEOUT_RC)])
def test_launcher_stops_every_rank(tmp_path, mode, timeout, rc):
    """A failing rank, or ranks that outlast the time limit, fail the
    launch and the other ranks are killed (the workers would sleep 120 s)."""
    got, seconds, log = _spawn(mode, tmp_path, timeout=timeout)
    assert got == rc, log[-2000:]
    assert seconds < 60


def test_positions_out_of_reach_raise():
    """A position of another rank on another card or host raises, naming
    queue A item 5; on the same card, or on the CPU, it is in reach."""
    P = distributed.Position
    same = [P(i, i // 4, "h", "cuda:0", "GPU-a") for i in range(8)]
    mesh = DeviceMesh((2, 2, 2), same)
    assert mesh.multi_process and mesh.local_positions() == (0, 1, 2, 3)
    assert [mesh.owner(i) for i in range(8)] == [0] * 4 + [1] * 4
    assert mesh.is_local(3) and not mesh.is_local(4)
    assert mesh.one_device and str(mesh.device) == "cuda:0"
    assert mesh.neighbour_ranks("z") == (1,) and mesh.neighbour_ranks("x") == ()
    fake = same[:4] + [P(i, 1, "h", "cuda:0", "GPU-b") for i in range(4, 8)]
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        DeviceMesh((2, 2, 2), fake)
    other_host = same[:4] + [P(i, 1, "h2", "cuda:0", "GPU-a") for i in range(4, 8)]
    with pytest.raises(NotImplementedError, match="another card or host"):
        DeviceMesh((2, 2, 2), other_host)
    cpu = DeviceMesh((2, 2, 2), [P(i, i // 4, f"h{i // 4}", "cpu") for i in range(8)])
    assert cpu.multi_process and cpu.local_positions() == (0, 1, 2, 3)
    with pytest.raises(ValueError, match="owns no position"):
        DeviceMesh((2, 1, 1), [P(i, 1, "h", "cpu") for i in range(2)])


class _Recorder:
    def __init__(self, log):
        self.log = log

    def record(self):
        self.log.append(("record",))

    def wait(self, rank):
        self.log.append(("wait", rank))

    def exchange(self, ranks):
        self.log.append(("notify", tuple(ranks)))


def test_phase_order_record_notify_wait_launch():
    """Each phase with neighbours in other processes: record this rank's
    event, notify them and wait for their notices, make the stream wait on
    each one's event, then launch; an axis whose neighbours are all local
    launches at once."""
    log = []
    rec = _Recorder(log)
    order = ipc.PhaseOrder({"x": (), "y": (1, 3), "z": (2,)}, rec, rec)
    ipc.ordered_phases(order, ["x", "y", "z"], lambda axis: log.append(("launch", axis)))
    assert log == [("launch", "x"),
                   ("record",), ("notify", (1, 3)), ("wait", 1), ("wait", 3), ("launch", "y"),
                   ("record",), ("notify", (2,)), ("wait", 2), ("launch", "z")]
    assert order.handshakes == 2


class _FakeIpcLib:
    """The IPC entry points of ``csrc/ipc.cu``, recorded: each open maps a
    new address."""

    def __init__(self):
        self.calls = []

    def ipc_open_mem(self, handle, ptr):
        ptr._obj.value = 0x1000 * (len(self.calls) + 1)
        self.calls.append(("open", handle))
        return 0

    def ipc_close_mem(self, ptr):
        self.calls.append(("close", ptr))
        return 0

    def ipc_event_destroy(self, ev):
        self.calls.append(("destroy", ev))
        return 0


def test_peer_mappings_counted_and_released(monkeypatch):
    """A neighbour's allocation is mapped once a process however many
    blocks use it, and unmapped by its last user; a PeerBuffers' release
    unmaps what it mapped and destroys its events."""
    lib = _FakeIpcLib()
    monkeypatch.setattr(ipc, "_lib", lambda: lib)
    monkeypatch.setattr(ipc.torch.cuda, "synchronize", lambda device=None: None)
    a, b = b"a" * ipc.HANDLE_BYTES, b"b" * ipc.HANDLE_BYTES
    base = ipc.open_mem(a)
    assert ipc.open_mem(a) == base and lib.calls == [("open", a)]
    ipc.close_mem(a)
    assert lib.calls == [("open", a)]
    ipc.close_mem(a)
    assert lib.calls == [("open", a), ("close", base)] and a not in ipc._mapped
    lib.calls.clear()
    handles = {(0, 0, 4): (a, 0), (0, 1, 4): (a, 4096), (1, 0, 4): (b, 0)}
    bases = {k: ipc.open_mem(h) for k, (h, _off) in handles.items()}
    assert [c[0] for c in lib.calls] == ["open", "open"]
    ipc._release("cpu", bases, handles, [7, 9])
    assert sorted(c for c in lib.calls if c[0] == "close") == [("close", 0x1000),
                                                               ("close", 0x2000)]
    assert lib.calls[-2:] == [("destroy", 7), ("destroy", 9)]
    assert not bases and not ipc._mapped


def test_gloo_notices_between_two_ranks(exchange_run):
    """The card's notify messages over gloo between the two ranks: each
    carries the pair's running count, checked on arrival."""
    for rep in exchange_run[1]:
        assert rep["notices"] == {str(1 - rep["rank"]): 3}


class _Addresses(dict):
    """Addresses in one CPU arena: each the arena's words from there on (a
    block's start, or an uneven ring's hi side moved either way)."""

    def __init__(self, arena):
        super().__init__()
        self.arena = arena

    def __missing__(self, addr):
        base = self.arena.data_ptr()
        assert base <= addr < base + self.arena.numel() * self.arena.element_size()
        return self.arena[(addr - base) // self.arena.element_size():]


class _ReplayCard:
    """The card of B6's cross-process launch, replayed on the CPU: the
    kernel's tables read as ``tests/test_torch_exchange_launch.py``'s
    replay reads them, every pointer a CPU block's address (what a rank's
    own block or a neighbour's mapped one is on the card)."""

    def __init__(self, monkeypatch, arena):
        from stencil_tpu_torch.ops import remote_dma as rdma

        self.blocks = _Addresses(arena)
        self.tables, self.calls = {}, []
        monkeypatch.setattr(rdma._native, "kept", lambda key, make: make())
        monkeypatch.setattr(rdma._native, "upload", self.upload)
        monkeypatch.setattr(rdma._native, "stream_ptr", lambda dev: 0)
        monkeypatch.setattr(rdma._native, "lib", lambda name: self)

    def upload(self, values, device):
        t = torch.tensor(values, dtype=torch.int64)
        self.tables[t.data_ptr()] = t.tolist()
        return t

    def remote_axis_launch(self, ptrs, m, segs, nseg, tasks, word, code, fmt, sz, sy, _stream):
        from stencil_tpu_torch.ops import row_moves as rmv
        from test_torch_exchange_launch import launch_wire, replay_tables

        table = self.tables[ptrs]
        head = (segs - ptrs) // 8
        rows = [table[i:i + rmv.MOVE_COLS] for i in range(head, len(table), rmv.MOVE_COLS)]
        assert len(rows) == nseg
        self.calls.append((m, head // 2))
        replay_tables(self.blocks, table[:head], m, rows, tasks, sz, sy, launch_wire(code, fmt))
        return 0


@pytest.mark.parametrize("size,part,owners,wire,nq", [
    ((24, 20, 16), (2, 2, 2), (0, 0, 0, 0, 1, 1, 1, 1), None, 1),
    ((24, 20, 16), (2, 2, 2), (0, 1, 2, 3, 4, 5, 6, 7), "bfloat16", 2),
    ((25, 20, 16), (3, 2, 1), (0, 0, 0, 1, 1, 1), None, 3),
    ((25, 21, 17), (3, 2, 2), (0, 1, 0, 1, 0, 1, 1, 0, 1, 0, 1, 0), "bfloat16", 1)],
    ids=["2x4", "8x1-bf16", "uneven-2x3", "uneven-scattered-bf16"])
def test_cross_process_tables_replay_to_the_plain_version(monkeypatch, size, part, owners,
                                                          wire, nq):
    """B6's cross-process form as each rank launches it (its receivers'
    rows, the senders' blocks local or mapped, the work list unpaired, an
    uneven ring's pointers moved), replayed as the kernel reads its
    tables: the launches of all ranks together equal remote_axis_plain over
    every position, every cell, through the wire; and each rank's launch
    equals remote_axis_receivers_plain of its own receivers."""
    from stencil_tpu_torch.domain import GridSpec
    from stencil_tpu_torch.geometry import Dim3, Radius
    from stencil_tpu_torch.ops import remote_dma as rdma
    from stencil_tpu_torch.parallel import Method
    from stencil_tpu_torch.plan.ir import build_plan

    spec = GridSpec(Dim3(*size), Dim3(*part), Radius.constant(1))
    p = spec.padded()
    n = spec.num_blocks()
    rng = np.random.RandomState(sum(size) + nq)
    cells, margin = p.z * p.y * p.x, 4 * p.y * p.x
    # every block in one arena, a margin before the first: the replay
    # resolves any address the tables name, moved pointers included
    arena = torch.from_numpy(rng.rand(margin + n * nq * cells).astype(np.float32))
    got = [[arena[margin + (i * nq + q) * cells:][:cells].view(1, 1, 1, p.z, p.y, p.x)
            for q in range(nq)] for i in range(n)]
    want = [[b.clone() for b in g] for g in got]
    each = [[b.clone() for b in g] for g in got]
    card = _ReplayCard(monkeypatch, arena)
    one = DeviceMesh(part, ["cpu"] * n)
    positions = [distributed.Position(i, o, "h", "cpu") for i, o in enumerate(owners)]
    for ph in build_plan(spec, part, Method.REMOTE_DMA).remote_phases:
        if not (ph.active and ph.ring > 1):
            continue
        rdma.remote_axis_plain(want, spec, ph, one, wire)
        before = [[b.clone() for b in g] for g in got]
        for rank in sorted(set(owners)):
            monkeypatch.setattr(distributed, "process_index", lambda rank=rank: rank)
            mesh = DeviceMesh(part, positions)
            rdma.remote_axis_across(lambda i: tuple(b.data_ptr() for b in got[i]), nq,
                                    torch.float32, spec, ph, mesh, torch.device("cpu"), wire)
            assert card.calls[-1][0] == len(mesh.local_positions()) * nq
            # the same rank's receivers through the plain version
            mine = [[b.clone() for b in g] for g in before]
            rdma.remote_axis_receivers_plain(mine, spec, ph, mesh, wire)
            for i in mesh.local_positions():
                for a, b in zip(mine[i], each[i]):
                    b.copy_(a)
        for ga, gb, gc in zip(got, want, each):
            for a, b, c in zip(ga, gb, gc):
                assert torch.equal(a, b) and torch.equal(a, c)


def test_launcher_environment():
    env = launcher.rank_env(1, 2, 4, 1234, cpu=True)
    assert env[distributed.COORDINATOR_ENV] == "localhost:1234"
    assert (env[distributed.NUM_PROCESSES_ENV], env[distributed.PROCESS_ID_ENV]) == ("2", "1")
    assert env[distributed.LOCAL_CPU_ENV] == "4" and distributed.LOCAL_CUDA_ENV not in env
    env = launcher.rank_env(0, 2, 3, 1234, cpu=False)
    assert env[distributed.LOCAL_CUDA_ENV] == "3" and distributed.LOCAL_CPU_ENV not in env
    with pytest.raises(ValueError):
        launcher.launch(0, 1, "x", [], cpu=True)


def test_init_needs_the_group_address(monkeypatch):
    for var in (distributed.COORDINATOR_ENV, distributed.NUM_PROCESSES_ENV,
                distributed.PROCESS_ID_ENV):
        monkeypatch.delenv(var, raising=False)
    assert distributed.maybe_init_from_env() is False
    with pytest.raises(ValueError, match="coordinator"):
        distributed.init_distributed()


if __name__ == "__main__":
    torch.set_num_threads(1)
    {"exchange": worker_exchange, "jacobi": worker_jacobi, "fail": worker_fail,
     "hang": worker_hang}[sys.argv[1]](sys.argv[2])
