"""The port stands alone and runs on the GPU unless asked for the CPU:
no module of stencil_tpu_torch (nor chip_smoke.py) imports jax or
stencil_tpu; entry points without a device need CUDA; kernel wrappers take
their plain versions only through an explicit CPU branch."""

import ast
import pathlib
import re

import pytest
import torch

import stencil_tpu_torch
from stencil_tpu_torch import DistributedDomain
from stencil_tpu_torch.apps import astaroth, jacobi3d
from stencil_tpu_torch.astaroth.equations import Constants
from stencil_tpu_torch.domain import GridSpec
from stencil_tpu_torch.geometry import Dim3, Radius, Rect3
from stencil_tpu_torch.ops import (_native, astaroth_substep, fused_stencil, halo_fill,
                                   health_reduce, jacobi, persistent_stencil, remote_dma,
                                   stencil_kernels)
from stencil_tpu_torch.parallel import DeviceMesh, Method
from stencil_tpu_torch.plan.ir import build_plan

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted(p for p in (ROOT / "stencil_tpu_torch").rglob("*.py")
                    if "_build" not in p.parts) + [ROOT / "chip_smoke.py"]


def imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "stencil_tpu"), f"{path} imports {mod}"


def test_kernel_sources_present():
    csrc = pathlib.Path(stencil_tpu_torch.__file__).parent / "csrc"
    assert sorted(p.name for p in csrc.glob("*.cu")) == [
        "astaroth_substep.cu", "fused_exchange.cu", "fused_jacobi.cu", "health_reduce.cu",
        "jacobi_multistep.cu", "jacobi_sweep.cu", "persistent_jacobi.cu", "remote_axis.cu",
        "self_fill.cu"]
    assert sorted(p.stem for p in csrc.glob("*.cu")) == sorted(_native.SIGNATURES)


def test_c_entries_match_their_signatures():
    """Every C entry point _native binds exists in its source with as many
    parameters as its argtypes name."""
    for name, fns in _native.SIGNATURES.items():
        src = (pathlib.Path(_native.CSRC) / f"{name}.cu").read_text()
        found = {m.group(1): m.group(2) for m in
                 re.finditer(r'extern "C"\s+[\w\s*]+?\b(\w+)\s*\(([^)]*)\)', src)}
        for fn, (_, args) in fns.items():
            assert fn in found, f"{name}.cu has no entry {fn}"
            params = found[fn].strip()
            assert (params.count(",") + 1 if params else 0) == len(args), fn


def test_no_device_means_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedDomain(8, 8, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jacobi3d.run(8, 8, 8, iters=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        astaroth.run(iters=1, nx=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jacobi3d.run(8, 8, 8, iters=1, method=Method.REMOTE_DMA, kernel_variant="fused")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jacobi3d.run(8, 8, 8, iters=1, method=Method.REMOTE_DMA, kernel_variant="persistent",
                     deep_halo=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jacobi3d.run(8, 8, 8, iters=1, method=Method.REMOTE_DMA, devices=["cuda:0"] * 8)
    assert DistributedDomain(8, 8, 8, device="cpu").device.type == "cpu"


def _spec():
    return GridSpec(Dim3(16, 12, 10), Dim3(1, 1, 1), Radius.constant(1))


def _block(spec, dtype, device="cpu"):
    return torch.zeros(spec.stacked_shape_zyx(), dtype=dtype, device=device)


def _astaroth_spec():
    spec = GridSpec(Dim3(12, 10, 8), Dim3(1, 1, 1), Radius.constant(3))
    return spec, Constants(1.0, 0.5, 1.0, 1.3, 1.2, 1.4, 5e-3, 5e-3, 0.01)


def _fields(spec, device="cpu"):
    p = spec.padded()
    return tuple(torch.zeros((p.z, p.y, p.x), dtype=torch.float64, device=device)
                 for _ in range(8))


def test_wrappers_take_plain_versions_only_on_cpu(monkeypatch):
    spec = _spec()
    calls = []
    for mod, name in ((stencil_kernels, "sweep_plain"), (stencil_kernels, "multistep_plain"),
                      (halo_fill, "self_fill_plain"), (astaroth_substep, "substep_plain"),
                      (astaroth_substep, "substep_tasks_plain"),
                      (fused_stencil, "fused_jacobi_plain"),
                      (persistent_stencil, "persistent_jacobi_plain"),
                      (remote_dma, "remote_axis_plain"), (fused_stencil, "fused_exchange_plain"),
                      (fused_stencil, "fused_jacobi_mesh_plain"),
                      (persistent_stencil, "persistent_jacobi_mesh_plain")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: calls.append(_n))
    monkeypatch.setattr(health_reduce, "finite_and_max_plain", lambda *a, **k: calls.append(
        "finite_and_max_plain") or (torch.ones(()), torch.zeros(())))
    launches = (stencil_kernels.sweep.launches, stencil_kernels.multistep.launches,
                halo_fill.self_fill.launches, astaroth_substep.substep.launches,
                astaroth_substep.substep_tasks.launches,
                fused_stencil.fused_jacobi.launches, persistent_stencil.persistent_jacobi.launches,
                remote_dma.remote_axis.launches, fused_stencil.fused_exchange.launches,
                fused_stencil.fused_jacobi_mesh.launches,
                persistent_stencil.persistent_jacobi_mesh.launches,
                health_reduce.health_reduce.launches)
    f32 = torch.float32
    stencil_kernels.sweep(_block(spec, f32), _block(spec, f32), _block(spec, torch.int32), spec)
    stencil_kernels.multistep(_block(spec, f32), _block(spec, f32), spec, 2)
    halo_fill.self_fill([_block(spec, f32)], spec, "x")
    spec3, consts = _astaroth_spec()
    astaroth_substep.substep(_fields(spec3), _fields(spec3), spec3, consts, (1.0,) * 3, 0, 1e-3)
    tasks = astaroth_substep.compute_tasks(spec3)
    astaroth_substep.substep_tasks(_fields(spec3), _fields(spec3), spec3, tasks, consts,
                                   (1.0,) * 3, 0, 1e-3)
    plan = build_plan(spec, (1, 1, 1), Method.REMOTE_DMA, fused=True)
    fused_stencil.fused_jacobi(_block(spec, f32), _block(spec, f32), _block(spec, torch.int32),
                               spec, plan)
    spec2 = GridSpec(Dim3(16, 12, 10), Dim3(1, 1, 1), Radius.constant(2))
    persistent_stencil.persistent_jacobi(_block(spec2, f32), _block(spec2, f32),
                                         _block(spec2, torch.int32), spec2, 2)
    mspec, mesh, mplan, mblocks = _mesh_case("cpu")
    remote_dma.remote_axis(mblocks, mspec, mplan.remote_phases[0], mesh)
    fused_stencil.fused_exchange(mblocks, mspec, mplan, mesh)
    fused_stencil.fused_jacobi_mesh(*_mesh_fields(mspec, "cpu"), mspec, mplan, mesh)
    pspec, pmesh = _mesh_case("cpu", 2)[:2]
    persistent_stencil.persistent_jacobi_mesh(*_mesh_fields(pspec, "cpu"), pspec, 2, pmesh)
    health_reduce.health_reduce([[_block(spec, f32)]])
    assert calls == ["sweep_plain", "multistep_plain", "self_fill_plain", "substep_plain",
                     "substep_tasks_plain", "fused_jacobi_plain", "persistent_jacobi_plain", "remote_axis_plain",
                     "fused_exchange_plain", "fused_jacobi_mesh_plain",
                     "persistent_jacobi_mesh_plain", "finite_and_max_plain"]
    # the plain versions are not launches
    assert launches == (stencil_kernels.sweep.launches, stencil_kernels.multistep.launches,
                        halo_fill.self_fill.launches, astaroth_substep.substep.launches,
                        astaroth_substep.substep_tasks.launches,
                        fused_stencil.fused_jacobi.launches,
                        persistent_stencil.persistent_jacobi.launches,
                        remote_dma.remote_axis.launches, fused_stencil.fused_exchange.launches,
                        fused_stencil.fused_jacobi_mesh.launches,
                        persistent_stencil.persistent_jacobi_mesh.launches,
                        health_reduce.health_reduce.launches)
    # any other device is refused, never served by the plain version
    meta = [_block(spec, f32, "meta"), _block(spec, f32, "meta")]
    with pytest.raises(ValueError):
        stencil_kernels.sweep(*meta, _block(spec, torch.int32, "meta"), spec)
    with pytest.raises(ValueError):
        stencil_kernels.multistep(*meta, spec, 2)
    with pytest.raises(ValueError):
        halo_fill.self_fill(meta[:1], spec, "x")
    with pytest.raises(ValueError):
        astaroth_substep.substep(_fields(spec3, "meta"), _fields(spec3, "meta"), spec3, consts,
                                 (1.0,) * 3, 0, 1e-3)
    with pytest.raises(ValueError):
        astaroth_substep.substep_tasks(_fields(spec3, "meta"), _fields(spec3, "meta"), spec3,
                                       tasks, consts, (1.0,) * 3, 0, 1e-3)
    with pytest.raises(ValueError):
        fused_stencil.fused_jacobi(*meta, _block(spec, torch.int32, "meta"), spec, plan)
    with pytest.raises(ValueError):
        persistent_stencil.persistent_jacobi(_block(spec2, f32, "meta"), _block(spec2, f32, "meta"),
                                             _block(spec2, torch.int32, "meta"), spec2, 2)
    mspec, mesh, mplan, mblocks = _mesh_case("meta")
    with pytest.raises(ValueError):
        remote_dma.remote_axis(mblocks, mspec, mplan.remote_phases[0], mesh)
    with pytest.raises(ValueError):
        fused_stencil.fused_exchange(mblocks, mspec, mplan, mesh)
    with pytest.raises(ValueError):
        fused_stencil.fused_jacobi_mesh(*_mesh_fields(mspec, "meta"), mspec, mplan, mesh)
    pspec, pmesh = _mesh_case("meta", 2)[:2]
    with pytest.raises(ValueError):
        persistent_stencil.persistent_jacobi_mesh(*_mesh_fields(pspec, "meta"), pspec, 2, pmesh)
    with pytest.raises(ValueError):
        health_reduce.health_reduce([[_block(spec, f32, "meta")]])
    assert len(calls) == 12


def test_uneven_persistent_wrapper_takes_plain_only_on_cpu(monkeypatch):
    """The chunk kernel's uneven form (an uneven mesh) is one more branch of
    ``persistent_jacobi_mesh``: on CPU tensors its plain version, counted
    as no launch; on another device refused."""
    calls = []
    monkeypatch.setattr(persistent_stencil, "persistent_jacobi_mesh_plain",
                        lambda *a, **k: calls.append("persistent_jacobi_mesh_plain"))
    spec = GridSpec(Dim3(17, 12, 10), Dim3(2, 1, 1), Radius.constant(2))
    assert not spec.is_uniform()
    mesh = DeviceMesh((2, 1, 1), ["cpu"] * 2)
    before = (persistent_stencil.persistent_jacobi_mesh.launches,
              persistent_stencil.persistent_jacobi_mesh.uneven)
    persistent_stencil.persistent_jacobi_mesh(*_mesh_fields(spec, "cpu"), spec, 2, mesh)
    assert calls == ["persistent_jacobi_mesh_plain"]
    assert before == (persistent_stencil.persistent_jacobi_mesh.launches,
                      persistent_stencil.persistent_jacobi_mesh.uneven)
    with pytest.raises(ValueError):
        persistent_stencil.persistent_jacobi_mesh(*_mesh_fields(spec, "meta"), spec, 2,
                                                  DeviceMesh((2, 1, 1), ["meta"] * 2))
    assert len(calls) == 1


def _mesh_case(device, r=1):
    """A (2,1,1) mesh of two positions on ``device``, its fused remote-dma
    plan (whose remote phases are the plain carrier's too) and one fp32
    quantity's blocks, grouped per position."""
    spec = GridSpec(Dim3(16, 12, 10), Dim3(2, 1, 1), Radius.constant(r))
    mesh = DeviceMesh((2, 1, 1), [device] * 2)
    plan = build_plan(spec, (2, 1, 1), Method.REMOTE_DMA, fused=True)
    p = spec.padded()
    blocks = [[torch.zeros((1, 1, 1, p.z, p.y, p.x), device=device)] for _ in range(2)]
    return spec, mesh, plan, blocks


def _mesh_fields(spec, device):
    """``(currs, nxts, sels)`` of a two-position mesh of ``spec`` on ``device``."""
    p = spec.padded()
    return tuple([torch.zeros((1, 1, 1, p.z, p.y, p.x), dtype=dt, device=device)
                  for _ in range(2)] for dt in (torch.float32, torch.float32, torch.int32))


def test_wrappers_have_no_fallback():
    """No try/except in the kernel modules: a failed build or launch
    propagates instead of quietly running the plain version."""
    for mod in (stencil_kernels, halo_fill, astaroth_substep, fused_stencil, persistent_stencil,
                remote_dma, health_reduce):
        tree = ast.parse(pathlib.Path(mod.__file__).read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), mod.__name__


PLAIN = ("sweep_plain", "multistep_plain", "self_fill_plain", "substep_plain",
         "substep_tasks_plain", "fused_jacobi_plain", "persistent_jacobi_plain", "jacobi_sweep", "remote_axis_plain",
         "fused_exchange_plain", "fused_jacobi_mesh_plain", "persistent_jacobi_mesh_plain",
         "finite_and_max_plain")


def _is_cpu_test(test):
    """``<device>.type == "cpu"``."""
    return (isinstance(test, ast.Compare) and [type(o) for o in test.ops] == [ast.Eq]
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value == "cpu")


def _plain_calls(tree):
    """``(enclosing functions, call, under_cpu_branch)`` for each call of a
    plain version in ``tree``."""
    def visit(node, fns, cpu):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fns = fns + (node.name,)
        if isinstance(node, ast.Call):
            name = getattr(node.func, "id", getattr(node.func, "attr", None))
            if name in PLAIN:
                yield fns, name, cpu
        if isinstance(node, ast.If) and _is_cpu_test(node.test):
            for n in node.body:
                yield from visit(n, fns, True)
            for n in node.orelse:
                yield from visit(n, fns, cpu)
            return
        for child in ast.iter_child_nodes(node):
            yield from visit(child, fns, cpu)

    yield from visit(tree, (), False)


# plain helpers besides the plain versions: the composed fill and the
# persistent chunk body, both counterparts of JAX functions of those names
PLAIN_HELPERS = ("wrap_fill_batched", "make_persistent_chunk_body")


@pytest.mark.parametrize("path", [p for p in PORT_FILES if p.name != "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_plain_versions_called_only_from_cpu_branches(path):
    """In the package a plain version runs only inside another plain
    version or under a wrapper's explicit CPU branch: no module picks it
    for tensors on the card (the wrappers' own branches are held by
    test_wrappers_take_plain_versions_only_on_cpu)."""
    for fns, name, cpu in _plain_calls(ast.parse(path.read_text())):
        plain = any(f in PLAIN or f in PLAIN_HELPERS or f.endswith("_plain") for f in fns)
        assert cpu or plain, f"{path.name}: {'.'.join(fns)} calls {name} outside a CPU branch"


def test_wrappers_check_operands():
    spec = _spec()
    f32 = torch.float32
    c = _block(spec, f32)
    with pytest.raises(ValueError, match="distinct"):
        stencil_kernels.sweep(c, c, _block(spec, torch.int32), spec)
    with pytest.raises(ValueError, match="dtype"):
        stencil_kernels.sweep(c, _block(spec, f32), _block(spec, f32), spec)
    with pytest.raises(ValueError, match="4- or 8-byte"):
        halo_fill.self_fill([_block(spec, torch.float16)], spec, "y")
    # a multi-block partition takes the deep-halo form, which needs radius >= k
    spec2 = GridSpec(Dim3(16, 12, 10), Dim3(2, 1, 1), Radius.constant(1))
    with pytest.raises(ValueError, match="radius >= k"):
        stencil_kernels.multistep(_block(spec2, f32), _block(spec2, f32), spec2, 2)


def test_variant_wrappers_check_operands():
    spec = _spec()
    f32, i32 = torch.float32, torch.int32
    plan = build_plan(spec, (1, 1, 1), Method.REMOTE_DMA, fused=True)
    c = _block(spec, f32)
    with pytest.raises(ValueError, match="distinct"):
        fused_stencil.fused_jacobi(c, c, _block(spec, i32), spec, plan)
    with pytest.raises(ValueError, match="dtype"):
        fused_stencil.fused_jacobi(c, _block(spec, f32), _block(spec, f32), spec, plan)
    spec2 = GridSpec(Dim3(16, 12, 10), Dim3(1, 1, 1), Radius.constant(2))
    with pytest.raises(ValueError, match="k >= 2"):
        persistent_stencil.persistent_jacobi(_block(spec2, f32), _block(spec2, f32),
                                             _block(spec2, i32), spec2, 1)
    with pytest.raises(ValueError, match="radius >= 3"):
        persistent_stencil.persistent_jacobi(_block(spec2, f32), _block(spec2, f32),
                                             _block(spec2, i32), spec2, 3)
    with pytest.raises(ValueError, match="shape"):
        persistent_stencil.persistent_jacobi(c, _block(spec2, f32), _block(spec2, i32), spec2, 2)


def test_resident_forms_take_plain_versions_only_on_cpu(monkeypatch):
    """The resident forms go through the same wrappers: ``sweep_region``
    (whose plain version is ``jacobi_sweep``) and the deep-halo multistep
    take their plain versions for CPU stacks, and refuse any other
    device."""
    spec = GridSpec(Dim3(16, 12, 10), Dim3(2, 1, 1), Radius.constant(2))
    f32, i32 = torch.float32, torch.int32
    calls = []
    for mod, name in ((jacobi, "jacobi_sweep"), (stencil_kernels, "multistep_plain")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: calls.append(_n))
    before = (stencil_kernels.sweep_region.launches, stencil_kernels.multistep.launches)
    off = spec.compute_offset()
    rect = Rect3(off, off + Dim3(2, 12, 10))
    stencil_kernels.sweep_region(_block(spec, f32), _block(spec, f32), _block(spec, i32), spec,
                                 rect)
    stencil_kernels.multistep(_block(spec, f32), _block(spec, f32), spec, 2)
    assert calls == ["jacobi_sweep", "multistep_plain"]
    assert before == (stencil_kernels.sweep_region.launches, stencil_kernels.multistep.launches)
    with pytest.raises(ValueError):
        stencil_kernels.sweep_region(_block(spec, f32, "meta"), _block(spec, f32, "meta"),
                                     _block(spec, i32, "meta"), spec, rect)
    with pytest.raises(ValueError):
        stencil_kernels.multistep(_block(spec, f32, "meta"), _block(spec, f32, "meta"), spec, 2)


def test_tenant_sweep_takes_plain_version_only_on_cpu(monkeypatch):
    """The campaign's tenant-form sweep: its plain version for a CPU stack
    (not a launch), refused on any other device, operands checked."""
    spec = GridSpec(Dim3(12, 10, 8), Dim3(1, 1, 1), Radius.constant(1), aligned=False)
    p = spec.padded()

    def stack(dtype, device="cpu", b=3):
        return torch.zeros((b, p.z, p.y, p.x), dtype=dtype, device=device)

    f32, i32 = torch.float32, torch.int32
    calls = []
    monkeypatch.setattr(stencil_kernels, "sweep_plain", lambda *a, **k: calls.append(a[3:]))
    before = stencil_kernels.sweep_tenants.launches
    stencil_kernels.sweep_tenants(stack(f32), stack(f32), stack(i32), spec)
    stencil_kernels.sweep_tenants(stack(torch.float64), stack(torch.float64), stack(i32), spec)
    assert calls == [(spec,), (spec,)] and stencil_kernels.sweep_tenants.launches == before
    with pytest.raises(ValueError):
        stencil_kernels.sweep_tenants(stack(f32, "meta"), stack(f32, "meta"), stack(i32, "meta"),
                                      spec)
    for bad in ((stack(f32), stack(f32, b=2), stack(i32)),
                (stack(f32), stack(f32), stack(f32)),
                (stack(f32)[:, 1:], stack(f32), stack(i32)),
                (stack(torch.float16), stack(torch.float16), stack(i32))):
        with pytest.raises(ValueError):
            stencil_kernels.sweep_tenants(*bad, spec)
    c = stack(f32)
    with pytest.raises(ValueError, match="distinct"):
        stencil_kernels.sweep_tenants(c, c, stack(i32), spec)
    with pytest.raises(ValueError, match="single-block"):
        stencil_kernels.sweep_tenants(c, stack(f32), stack(i32),
                                      GridSpec(Dim3(24, 10, 8), Dim3(2, 1, 1), Radius.constant(1)))


def test_campaign_entry_points_default_to_cuda(monkeypatch, tmp_path):
    from stencil_tpu_torch import campaign
    from stencil_tpu_torch.apps import campaign as campaign_app

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jobs = [campaign.TenantJob("t0", (8, 8, 8), 2)]
    spec = GridSpec(Dim3(8, 8, 8), Dim3(1, 1, 1), Radius.constant(1), aligned=False)
    for call in (lambda: campaign.CampaignDriver(jobs, 1, str(tmp_path)),
                 lambda: campaign.run_sequential(jobs),
                 lambda: jacobi.make_batched_jacobi_loop(spec, 1),
                 lambda: campaign_app.main(["--tenants", "1", "--size", "8",
                                            "--campaign-dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
