"""apps/machine_info, parallel/machine and parallel/device_topo held to
stencil_tpu's on 8 virtual CPU devices (8 CPU positions in the port): the
distance and bandwidth matrices, the default partition, the inventory
records and the fabric fingerprint; the ``nvidia-smi topo -m`` parser on
recorded text; and the fabric fingerprint that a port jacobi3d run stamps
on its attribution records, key for key the JAX app's."""

import io
import json

import jax
import numpy as np
import pytest
import torch

from stencil_tpu.apps import jacobi3d as jax_jacobi3d
from stencil_tpu.apps import machine_info as jmi
from stencil_tpu.obs import telemetry as jax_telemetry
from stencil_tpu_torch.apps import jacobi3d, machine_info, report
from stencil_tpu_torch.obs import telemetry
from stencil_tpu_torch.parallel import device_topo, machine

torch.set_num_threads(2)

VOLATILE = ("run", "t", "app")

# nvidia-smi topo -m of an 8-GPU NVLink node (abridged NIC columns)
TOPO_NVLINK = """\
\t\x1b[4mGPU0\tGPU1\tGPU2\tGPU3\tGPU4\tGPU5\tGPU6\tGPU7\tNIC0\tCPU Affinity\tNUMA Affinity\tGPU NUMA ID\x1b[0m
GPU0\t X \tNV18\tNV18\tNV18\tNV18\tNV18\tNV18\tNV18\tPXB\t0-55,112-167\t0\t\tN/A
GPU1\tNV18\t X \tNV18\tNV18\tNV18\tNV18\tNV18\tNV18\tSYS\t0-55,112-167\t0\t\tN/A
GPU2\tNV18\tNV18\t X \tNV18\tNV18\tNV18\tNV18\tNV18\tSYS\t0-55,112-167\t0\t\tN/A
GPU3\tNV18\tNV18\tNV18\t X \tNV18\tNV18\tNV18\tNV18\tSYS\t0-55,112-167\t0\t\tN/A
GPU4\tNV18\tNV18\tNV18\tNV18\t X \tNV18\tNV18\tNV18\tSYS\t56-111,168-223\t1\t\tN/A
GPU5\tNV18\tNV18\tNV18\tNV18\tNV18\t X \tNV18\tNV18\tSYS\t56-111,168-223\t1\t\tN/A
GPU6\tNV18\tNV18\tNV18\tNV18\tNV18\tNV18\t X \tNV18\tSYS\t56-111,168-223\t1\t\tN/A
GPU7\tNV18\tNV18\tNV18\tNV18\tNV18\tNV18\tNV18\t X \tSYS\t56-111,168-223\t1\t\tN/A
NIC0\tPXB\tSYS\tSYS\tSYS\tSYS\tSYS\tSYS\tSYS\t X

Legend:

  X    = Self
  SYS  = Connection traversing PCIe as well as the SMP interconnect between NUMA nodes (e.g., QPI/UPI)
  NODE = Connection traversing PCIe as well as the interconnect between PCIe Host Bridges within a NUMA node
  PHB  = Connection traversing PCIe as well as a PCIe Host Bridge (typically the CPU)
  PXB  = Connection traversing multiple PCIe bridges (without traversing the PCIe Host Bridge)
  PIX  = Connection traversing at most a single PCIe bridge
  NV#  = Connection traversing a bonded set of # NVLinks
"""

# a PCIe box: every rung of the ladder
TOPO_PCIE = """\
\tGPU0\tGPU1\tGPU2\tGPU3\tGPU4\tCPU Affinity\tNUMA Affinity
GPU0\t X \tPIX\tPXB\tPHB\tSYS\t0-15\t0
GPU1\tPIX\t X \tPXB\tNODE\tSYS\t0-15\t0
GPU2\tPXB\tPXB\t X \tNODE\tSYS\t0-15\t0
GPU3\tPHB\tNODE\tNODE\t X \tSYS\t0-15\t0
GPU4\tSYS\tSYS\tSYS\tSYS\t X \t16-31\t1
"""

TOPO_ONE = "\tGPU0\tCPU Affinity\tNUMA Affinity\tGPU NUMA ID\nGPU0\t X \t0-55\t0\t\tN/A\n"


def _records(emit, r, recorder_cls):
    buf = io.StringIO()
    emit(r, recorder_cls(sink=buf, app="machine_info"))
    return [{k: v for k, v in json.loads(ln).items() if k not in VOLATILE}
            for ln in buf.getvalue().splitlines()]


@pytest.mark.parametrize("n", [1, 2, 8])
def test_matrices_partition_and_records_match_jax(n):
    j = jmi.run(devices=jax.devices()[:n], size=64, radius=2)
    t = machine_info.run(devices=["cpu"] * n, size=64, radius=2)
    np.testing.assert_array_equal(t["dist"], j["dist"])
    np.testing.assert_array_equal(t["bw"], j["bw"])
    assert t["partition"] == machine_info.Dim3(*j["partition"])
    assert _records(machine_info.emit_records, t, telemetry.Recorder) == \
        _records(jmi.emit_records, j, jax_telemetry.Recorder)
    assert machine_info.report(t) == jmi.report(j)
    for rec in _records(machine_info.emit_records, t, telemetry.Recorder):
        assert telemetry.validate_record({**rec, "run": "r", "t": 0.0}) == []


def test_fabric_fingerprint_matches_jax(monkeypatch):
    for n in (1, 8):
        assert machine_info.fabric_fingerprint(devices=["cpu"] * n) == \
            jmi.fabric_fingerprint(devices=jax.devices()[:n])
    monkeypatch.setenv("STENCIL_VIRTUAL_HOSTS", "2")
    t = machine_info.fabric_fingerprint(devices=["cpu"] * 8)
    assert t["virtual_hosts"] == "2" and set(t) == {
        "processes", "hosts", "devices", "platform", "virtual_hosts"}


def test_one_card_positions_are_self():
    """Positions that name the same card are at DIST_SELF; distinct CUDA
    devices take their nvidia-smi distance."""
    d = device_topo.distance_matrix(["cuda:0"] * 8)
    assert (d == device_topo.DIST_SELF).all()
    d = device_topo.distance_matrix(["cuda:0", "cuda:1", "cuda:0", "cuda:4"], topo=TOPO_PCIE)
    assert d.tolist() == [[0.1, 3.0, 0.1, 7.0], [3.0, 0.1, 3.0, 7.0],
                          [0.1, 3.0, 0.1, 7.0], [7.0, 7.0, 7.0, 0.1]]
    np.testing.assert_array_equal(device_topo.bandwidth_matrix(["cuda:0", "cuda:1"],
                                                               topo=TOPO_NVLINK),
                                  [[10.0, 1.0], [1.0, 10.0]])


def test_topo_parser_on_recorded_text():
    nv = device_topo.parse_topo_matrix(TOPO_NVLINK)
    assert nv.shape == (8, 8)
    assert (np.diag(nv) == device_topo.DIST_SELF).all()
    assert (nv[~np.eye(8, dtype=bool)] == device_topo.DIST_SAME_PROCESS).all()
    pc = device_topo.parse_topo_matrix(TOPO_PCIE)
    assert pc.tolist() == [[0.1, 3.0, 4.0, 5.0, 7.0], [3.0, 0.1, 4.0, 6.0, 7.0],
                           [4.0, 4.0, 0.1, 6.0, 7.0], [5.0, 6.0, 6.0, 0.1, 7.0],
                           [7.0, 7.0, 7.0, 7.0, 0.1]]
    assert device_topo.parse_topo_matrix(TOPO_ONE).tolist() == [[0.1]]
    with pytest.raises(ValueError, match="unknown nvidia-smi topo link label"):
        device_topo.parse_topo_matrix(TOPO_PCIE.replace("PIX\t X", "QPI\t X"))
    with pytest.raises(ValueError, match="lacks the rows of GPU4"):
        device_topo.parse_topo_matrix(TOPO_PCIE.rsplit("GPU4", 1)[0])
    with pytest.raises(ValueError, match="no GPU column header"):
        device_topo.parse_topo_matrix("No devices were found\n")


def test_inventory_needs_a_card_or_cpu_positions(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        machine.Machine.detect()
    m = machine.Machine.detect(["cpu"] * 3)
    assert [d.index for d in m.devices] == [0, 1, 2] and m.num_nodes() == 1
    assert m.devices[0].kind == "cpu" and m.devices[0].capability is None


def test_several_processes_raise(monkeypatch):
    """In a group of two ranks the inventory gathers every rank's positions
    and hostnames (the reference's MPI_Gather); a mesh over a position of
    the other rank on another host's card raises, naming queue A item 5
    (CPU positions anywhere are in reach)."""
    from stencil_tpu_torch.parallel import distributed
    from stencil_tpu_torch.parallel.mesh import DeviceMesh

    dist = torch.distributed
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_rank", lambda: 0)

    def gather(out, obj):
        out[0] = obj
        out[1] = "far" if isinstance(obj, str) else [("far", "cpu", None)] * 3

    monkeypatch.setattr(dist, "all_gather_object", gather)
    m = machine.Machine.detect(["cpu"])
    assert (m.process_index, m.process_count) == (0, 2)
    assert m.hostnames[1] == "far" and m.num_nodes() == 2
    assert [d.process_index for d in m.devices] == [0, 1, 1, 1]
    assert [d.index for d in m.devices] == [0, 1, 2, 3]
    d = m.distance_matrix()
    assert d[0, 1] == device_topo.DIST_REMOTE and d[1, 2] == device_topo.DIST_SAME_PROCESS
    assert len(DeviceMesh((2, 2, 1), m.positions).local_positions()) == 1
    cards = [distributed.Position(0, 0, "near", "cuda:0", "GPU-0")] + [
        distributed.Position(i, 1, "far", "cuda:0", "GPU-0") for i in (1, 2, 3)]
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        DeviceMesh((2, 2, 1), cards)


def test_cli_json_validates(tmp_path, capsys):
    out = tmp_path / "m.jsonl"
    assert machine_info.main(["--cpu", "8", "--size", "64", "--json",
                              "--metrics-out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    names = [json.loads(ln)["name"] for ln in lines]
    assert names == ["machine"] + ["machine.device"] * 8 + [
        "machine.fabric", "machine.partition", "machine.distance_matrix",
        "machine.bandwidth_matrix"]
    part = json.loads(lines[10])
    assert part["dim"] == [2, 2, 2] and part["size"] == 64
    telemetry.configure()
    assert report.main([str(out), "--validate"]) == 0
    assert machine_info.main(["--devices", "cpu,cpu", "--size", "32"]) == 0
    text = capsys.readouterr().out
    assert "machine: 1 node(s), 1 process(es), 2 device(s)" in text
    assert "default partition for 32^3: Dim3(2,1,1)" in text


def test_jacobi3d_attribution_carries_the_jax_fabric(tmp_path):
    """The fabric repair: a port jacobi3d run and a JAX jacobi3d run with
    metrics on the same config stamp the same fabric_* keys and values on
    their attribution records (the platform aside)."""
    port = str(tmp_path / "port.jsonl")
    try:
        assert jacobi3d.main(["--x", "12", "--y", "12", "--z", "12", "--iters", "4",
                              "--no-weak", "--device", "cpu", "--metrics-out", port]) == 0
    finally:
        telemetry.configure()
    jx = str(tmp_path / "jax.jsonl")
    jax_telemetry.configure(metrics_out=jx, app="jacobi3d")
    try:
        jax_jacobi3d.run(12, 12, 12, iters=4, weak=False, devices=jax.devices()[:1])
    finally:
        jax_telemetry.configure(metrics_out=None)

    def fabrics(path):
        with open(path) as f:
            recs = [r for r in map(json.loads, f) if r["name"] == "plan.attrib.phase"]
        assert recs
        return [{k: v for k, v in r.items() if k.startswith("fabric_")} for r in recs]

    t, j = fabrics(port), fabrics(jx)
    strip = lambda fs: [{k: v for k, v in f.items() if k != "fabric_platform"} for f in fs]  # noqa: E731
    assert strip(t)[0] == strip(j)[0] and all(f == t[0] for f in t)
    assert set(t[0]) == set(j[0]) == {"fabric_processes", "fabric_hosts", "fabric_devices",
                                      "fabric_platform", "fabric_virtual_hosts"}
