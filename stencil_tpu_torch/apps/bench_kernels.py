"""bench_kernels — time each CUDA kernel of the port alone on one GPU.

  python -m stencil_tpu_torch.apps.bench_kernels --size 512 --ks 1,2,3,4,5,6 \
      --astaroth-size 256

Prints one JSON line per measurement, after a line naming the card
(``nvidia-smi`` name and power limit):

- ``jacobi_sweep`` (B1): one step at size^3, radius 1 (the jacobi3d
  layout), reading sel on every plane; and every B1 form with ``"sel":
  "planes"`` as the main paths call it, sel read on the spheres' planes
  only, beside its bytes bound with sel on those planes (``bound_ms``), the
  12-byte bound (``bound_12b_ms``) and a three-stream ``torch.add`` over as
  many cells (``add_ms``): one block, tight-x (``"form": "tight-x"``), the
  (2,2,2) r4 stack and every one of its shells in one launch
  (``jacobi_sweep_regions``), the 64-tenant slots of (size/4)^3 and 32^3,
  the eight (size/2)^3 mesh positions in one launch (``"form": "mesh
  positions"``) and the six positions of size^3 over (3,2,1) with their
  36 shells (``"form": "uneven positions"``, ``jacobi_sweep_regions``);
  with ``--b1`` only these rows and the fused step's (B8) are printed;
- ``jacobi_multistep`` at each depth k: ms per launch and per step beside
  its bytes bound (8 bytes a cell) and its unfused issue floor (7 fp32
  operations per stage update over the tiles' grown planes,
  ``stencil_kernels.multistep_stage_updates``), with the instantiation's
  registers, spill bytes and blocks per SM;
- ``self_fill`` per axis: one launch filling both sides for four fp32
  quantities at radius 3 (the exchange benchmark's layout), and over a
  (1,1,2) z-stack (x and y), each beside its bytes bound, its sector floor,
  ``Tensor.copy_`` of the same slabs and its time with the halos evicted
  from L2 (``apps/bench_fill.measure``);
- ``fused_jacobi``: one fused remote-dma step at size^3, radius 1 (the 26
  halo hand-offs and the sweep), beside its bytes bound, with the kernel's
  registers, spill bytes, blocks per SM, tiles and z chunks (timed by
  CUDA-graph replay, the cooperative launch captured whole; B1's sweep at
  the same size is the first row, ``jacobi_sweep``); then two yardsticks for
  its phases: ``self_fill`` of x for the same block (the row-end hand-offs
  of phase A's x faces) and ``torch.add`` over three padded blocks (phase
  B's two read streams and one written, at an elementwise pass's rate);
- ``persistent_jacobi`` at each depth k >= 2 of ``--ks``: one k-step chunk
  at size^3, radius k, ms per launch and per step, beside the least bytes a
  chunk must move and the bytes this design moves, with its launch shape
  (on-chip passes, threads, shared memory, blocks per SM). The cooperative
  launch is timed without a CUDA graph (CUDA events around back-to-back
  launches);
- ``astaroth_substep`` at astaroth-size^3, radius 3, in fp64 and fp32, for
  RK3 stage 0 (reads 8 fields, writes 8) and stage 1 (also reads the 8 out
  fields; stage 2 moves the same bytes), beside its bound
  (``utils.roofline.bound_ms``), its unfused issue floor
  (``utils.roofline.issue_ms``) and the instantiation's registers, spill
  bytes and blocks per SM; and its table form (``substep_tasks``) over
  the eight resident astaroth-size^3 blocks of a (2,2,2) partition (one
  launch, every block's compute region: ``"form": "residents"``) and over
  their 48 exterior shells at stage 0 (``"form": "shells"``), and its
  positions form (``substep_positions``) over 8 mesh positions of
  astaroth-size^3, each position's stacks their own allocations (one
  launch: ``"form": "positions"``) and over their 48 shells
  (``"form": "position shells"``), each beside its bound and issue floor;
  with ``--astaroth-resident`` only the substep's rows are printed;
- the resident forms, at size^3 over a (2,2,2) partition with radius-4
  halos (eight (size/2)^3 blocks on the card, jacobi3d's ``deep_halo=4``
  layout): ``jacobi_multistep`` in its deep-halo form at each k >= 2 of
  ``--ks`` (with radius-k halos at k > 4), beside one read of the blocks
  grown by k and one write of the blocks and its issue floor;
  ``jacobi_sweep_region`` on one overlap
  shell (the z-lo one) of every block; the stacked ``jacobi_sweep`` over
  all eight blocks;
- the tenant form of ``jacobi_sweep``: one step of a campaign slot of 64
  tenants of (size/4)^3 (as many cells as size^3), beside its bytes bound;
- the mesh kernels over eight block positions on the card, at size^3 over
  (2,2,2), radius 1, one fp32 quantity (jacobi3d's remote-dma mesh) and at
  (size/2)^3 over (2,2,2), radius 2, four fp32 quantities (the reference's
  config 2 when size is 512): ``remote_axis`` per axis phase and
  ``fused_exchange`` (one launch), each beside its bytes bound and its
  sector floor (``sector_ms``: the 32-byte sectors its words lie in, read
  once and written once), the x phase with its rate in padded rows per ns;
  and, as the rate yardstick, B4's x fill (``self_fill`` of x) of the same
  blocks' rows;
- the jacobi step over that mesh at size^3, one (size/2)^3 block per
  position: ``jacobi_sweep`` on one position (no wrap; the plain mesh step
  launches one per position), ``fused_jacobi_mesh`` at radius 1 (every
  position's messages and sweep in one cooperative launch, with the
  kernel's launch shape as for ``fused_jacobi``) and
  ``persistent_jacobi_mesh`` at each depth k >= 2 of ``--ks`` (radius k,
  ``sel`` halo-filled), each beside its bytes bound. The cooperative
  launches are timed without a CUDA graph, as ``persistent_jacobi`` is.

Times are CUDA-event means over back-to-back launches replayed from a CUDA
graph (device time, no host launch overhead) after a warm-up; inputs are
random, made from ``--seed``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
from typing import Optional

import torch

from ..domain import GridSpec
from ..geometry import Dim3, Radius
from ..astaroth.config import load_config
from ..astaroth.equations import Constants
from ..astaroth.integrate import inv_ds_of
from ..ops import _native, halo_fill
from ..ops import remote_dma as rdma
from ..ops import astaroth_substep as asub
from ..ops import fused_stencil as fst
from ..ops import persistent_stencil as pst
from ..ops import stencil_kernels as sk
from ..geometry import Rect3
from ..ops.jacobi import multi_block_layout, sphere_sel_blocks
from ..ops.shells import dyn_block_sizes, shell_regions
from ..parallel import DeviceMesh, HaloExchange, Method
from ..plan.ir import build_plan
from ..utils.roofline import bound_ms, issue_ms
from ..utils.timer import cuda_time_ms
from . import bench_fill


def chunk_launch_shape(k: int) -> dict:
    """The persistent chunk's launch at depth k: on-chip passes, threads per
    block, dynamic shared memory and resident blocks per SM."""
    lib = _native.lib("persistent_jacobi")
    blocks = ctypes.c_int(0)
    _native.check(lib.persistent_jacobi_blocks_per_sm(k, torch.cuda.current_device(),
                                                      ctypes.byref(blocks)),
                  "persistent_jacobi_blocks_per_sm")
    return {"passes": pst.chunk_passes(k), "threads": lib.persistent_jacobi_threads(k),
            "smem_bytes": lib.persistent_jacobi_smem_bytes(k), "blocks_per_sm": blocks.value}


def b1_row(run, nbytes, dev, reps: int) -> dict:
    """A B1 form's ms per launch (CUDA-graph replay) beside its bound with
    sel on its planes, its 12-byte bound and a three-stream ``torch.add``
    over as many cells; ``nbytes`` = ``stencil_kernels.sweep_bytes``."""
    full, ranged = nbytes
    n = full // 12
    a, b, o = (torch.rand(n, device=dev) for _ in range(3))
    add_ms = cuda_time_ms(lambda: torch.add(a, b, out=o), reps, graph=True)
    del a, b, o
    return {"ms": cuda_time_ms(run, reps, graph=True), "bound_ms": bound_ms(ranged, 0)[0],
            "bound_12b_ms": bound_ms(full, 0)[0], "add_ms": add_ms}


def sweep_forms(n: int, gen, dev, reps: int) -> None:
    """Every B1 form at the main paths' shapes, each as the main path calls
    it (sel on the spheres' planes), one JSON line each."""
    spec = GridSpec(Dim3(n, n, n), Dim3(1, 1, 1), Radius.constant(1))
    for form, sp in (("one block", spec),
                     ("tight-x", GridSpec(Dim3(n, n, n), Dim3(1, 1, 1),
                                          Radius.constant(1).without_x()))):
        pd = sp.padded()
        curr = torch.rand((1, 1, 1, pd.z, pd.y, pd.x), generator=gen, device=dev)
        nxt, sel, rg = torch.zeros_like(curr), sphere_sel_blocks(sp, dev), sk.sel_z_range(sp)
        whole = [Rect3(sp.compute_offset(), sp.compute_offset() + sp.base)]
        row = b1_row(lambda: sk.sweep(curr, nxt, sel, sp, (True,) * 3, rg),
                     sk.sweep_bytes(sp, whole, rg), dev, reps)
        print(json.dumps({"kernel": "jacobi_sweep", "form": form, "sel": "planes", "size": n,
                          **row}), flush=True)
        del curr, nxt, sel

    specr = GridSpec(Dim3(n, n, n), Dim3(2, 2, 2), Radius.constant(4))
    curr = torch.rand(specr.stacked_shape_zyx(), generator=gen, device=dev)
    nxt, sel, rg = torch.zeros_like(curr), sphere_sel_blocks(specr, dev), sk.block_sel_ranges(specr)
    wrap, _axes, shells = multi_block_layout(specr)
    whole = [Rect3(specr.compute_offset(), specr.compute_offset() + specr.base)]
    row = b1_row(lambda: sk.sweep(curr, nxt, sel, specr, wrap, rg),
                 sk.sweep_bytes(specr, whole, rg), dev, reps)
    print(json.dumps({"kernel": "jacobi_sweep", "form": "stacked", "sel": "planes", "size": n,
                      "partition": [2, 2, 2], **row}), flush=True)
    row = b1_row(lambda: sk.sweep_regions([curr], [nxt], [sel], specr, [shells], [rg]),
                 sk.sweep_bytes(specr, shells, rg), dev, reps * 2)
    print(json.dumps({"kernel": "jacobi_sweep_regions", "form": "stacked", "sel": "planes",
                      "size": n, "partition": [2, 2, 2], "radius": 4, "shells": len(shells),
                      **row}), flush=True)
    del curr, nxt, sel

    for edge in (n // 4, 32):
        spect = GridSpec(Dim3(edge, edge, edge), Dim3(1, 1, 1), Radius.constant(1),
                         aligned=False)
        pt = spect.padded()
        curr = torch.rand((64, pt.z, pt.y, pt.x), generator=gen, device=dev)
        nxt, rg = torch.zeros_like(curr), sk.sel_z_range(spect)
        sel = sphere_sel_blocks(spect, dev).view(1, pt.z, pt.y, pt.x).expand(64, -1, -1, -1)
        sel = sel.contiguous()
        whole = [Rect3(spect.compute_offset(), spect.compute_offset() + spect.base)]
        row = b1_row(lambda: sk.sweep_tenants(curr, nxt, sel, spect, rg),
                     sk.sweep_bytes(spect, whole, rg, blocks=64), dev, reps)
        print(json.dumps({"kernel": "jacobi_sweep", "form": "tenants", "sel": "planes",
                          "tenants": 64, "size": edge, "pitch": pt.x, **row}), flush=True)
        del curr, nxt, sel

    for part, label in (((2, 2, 2), "mesh positions"), ((3, 2, 1), "uneven positions")):
        specm = GridSpec(Dim3(n, n, n), Dim3(*part), Radius.constant(1))
        mesh = DeviceMesh(part, [dev] * (part[0] * part[1] * part[2]))
        bspec = specm.block_spec()
        pm = bspec.padded()
        currs = [torch.rand((1, 1, 1, pm.z, pm.y, pm.x), generator=gen, device=dev)
                 for _ in range(len(mesh))]
        nxts, sels = [torch.zeros_like(c) for c in currs], sphere_sel_blocks(specm, mesh)
        rg = [sk.block_sel_range(specm, Dim3.of(pos).z) for pos in mesh.positions()]
        whole = [Rect3(bspec.compute_offset(), bspec.compute_offset() + bspec.base)]
        nb = [sk.sweep_bytes(bspec, whole, r) for r in rg]
        row = b1_row(lambda: sk.sweep_positions(currs, nxts, sels, bspec, rg),
                     (sum(f for f, _ in nb), sum(g for _, g in nb)), dev, reps)
        print(json.dumps({"kernel": "jacobi_sweep", "form": label, "sel": "planes", "size": n,
                          "partition": list(part), "block": list(bspec.base), **row}),
              flush=True)
        if label == "uneven positions":
            rects = [shell_regions(specm, dyn_block_sizes(specm, pos), (True,) * 3)
                     for pos in mesh.positions()]
            nb = [sk.sweep_bytes(bspec, rs, r) for rs, r in zip(rects, rg)]
            row = b1_row(lambda: sk.sweep_regions(currs, nxts, sels, bspec, rects, rg),
                         (sum(f for f, _ in nb), sum(g for _, g in nb)), dev, reps * 2)
            print(json.dumps({"kernel": "jacobi_sweep_regions", "form": label, "sel": "planes",
                              "size": n, "partition": list(part),
                              "shells": sum(len(r) for r in rects), **row}), flush=True)
        del currs, nxts, sels


def astaroth_rows(na: int, gen, dev, reps: int, resident: bool = False) -> None:
    """The substep's rows (B5): one na^3 block at stages 0 and 1 in fp64 and
    fp32; with ``resident`` also its table form over the 8 resident na^3
    blocks of a (2,2,2) partition and over their 48 shells (stage 0), and
    its positions form over 8 mesh positions of na^3 and their shells."""
    info, _ = load_config(os.path.join(os.path.dirname(__file__), "..", "astaroth",
                                       "astaroth.conf"))
    consts, ids = Constants.from_info(info), inv_ds_of(info)
    speca = GridSpec(Dim3(na, na, na), Dim3(1, 1, 1), Radius.constant(3))
    specr = GridSpec(Dim3(2 * na, 2 * na, 2 * na), Dim3(2, 2, 2), Radius.constant(3))
    forms = [("one block", speca, None)]
    one = Dim3(1, 1, 1)
    if resident:
        forms += [("residents", specr, asub.compute_tasks(specr)),
                  ("shells", specr, asub.shell_tasks(specr)),
                  ("positions", specr, asub.position_compute_tasks(specr, one)),
                  ("position shells", specr, asub.position_shell_tasks(specr, one))]
    # the one-block rows first, in both dtypes, as the full run times them
    # (before the residents' 28 GB of fp64 stacks pass through the allocator)
    for form, spec, tasks in forms:
        for dtype in (torch.float64, torch.float32):
            item = torch.empty((), dtype=dtype).element_size()
            shape = spec.stacked_shape_zyx() if tasks else spec.block_shape_zyx()
            positions = form.startswith("position")
            kernel = asub.substep_positions if positions else asub.substep_tasks

            def rand():
                if positions:  # one (1, 1, 1, pz, py, px) allocation a position
                    p = spec.padded()
                    return [torch.rand((1, 1, 1, p.z, p.y, p.x), generator=gen, device=dev,
                                       dtype=dtype) * 0.1 for _ in range(spec.num_blocks())]
                return torch.rand(shape, generator=gen, device=dev, dtype=dtype) * 0.1

            curr8 = [rand() for _ in range(8)]
            out8 = [rand() for _ in range(8)]
            for stage in ((0,) if form.endswith("shells") else (0, 1)):
                if tasks is None:
                    def fn():
                        asub.substep(curr8, out8, spec, consts, ids, stage, 1e-8)
                    nbytes, cells = asub.stage_bytes(spec, item, stage), spec.base.flatten()
                    row = {}
                else:
                    def fn():
                        kernel(curr8, out8, spec, tasks, consts, ids, stage, 1e-8)
                    nbytes = asub.tasks_bytes(tasks, item, stage)
                    cells = sum((t.rect.hi - t.rect.lo).flatten() for t in tasks)
                    row = {"form": form, "tasks": len(tasks)}
                ms = cuda_time_ms(fn, reps, warmup=1, graph=True)
                flops = asub.FLOPS_PER_CELL[stage] * cells
                bound, bound_by = bound_ms(nbytes, flops, dtype)
                print(json.dumps({"kernel": "astaroth_substep", "size": na, **row,
                                  "dtype": str(dtype).replace("torch.", ""), "stage": stage,
                                  "ms": ms, "bytes": nbytes, "flops": flops, "bound_ms": bound,
                                  "bound_by": bound_by, "issue_ms": issue_ms(flops, dtype),
                                  "mcells_per_s": cells / ms / 1e3,
                                  **asub.substep_info(dev.index, item, stage, positions)}),
                      flush=True)
            del curr8, out8


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description="time the port's CUDA kernels on one GPU")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--ks", type=str,
                   default=",".join(str(k) for k in range(1, sk.MULTISTEP_KMAX + 1)))
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--astaroth-size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--b1", action="store_true",
                   help="only the sweep's (B1) forms and the fused step (B8)")
    p.add_argument("--astaroth-resident", action="store_true",
                   help="only the Astaroth substep's rows (B5): one block, its table form "
                        "over 8 residents and over their shells, and its positions form "
                        "over 8 mesh positions and their shells")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernels needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    n = args.size
    ks = [] if args.b1 else [int(v) for v in args.ks.split(",")]
    print(json.dumps({"card": bench_fill.card(), "torch": torch.__version__}), flush=True)
    if args.astaroth_resident:
        astaroth_rows(args.astaroth_size, gen, dev, args.reps, resident=True)
        return 0

    spec = GridSpec(Dim3(n, n, n), Dim3(1, 1, 1), Radius.constant(1))
    pd = spec.padded()
    curr = torch.rand((1, 1, 1, pd.z, pd.y, pd.x), generator=gen, device=dev)
    nxt = torch.zeros_like(curr)
    sel = sphere_sel_blocks(spec, dev)
    ms = cuda_time_ms(lambda: sk.sweep(curr, nxt, sel, spec), args.reps, graph=True)
    print(json.dumps({"kernel": "jacobi_sweep", "size": n, "ms": ms, **sk.sweep_info(dev.index)}),
          flush=True)
    sweep_forms(n, gen, dev, args.reps)

    for k in ks:
        ms = cuda_time_ms(lambda: sk.multistep(curr, nxt, spec, k), max(2, args.reps // 2),
                          warmup=1, graph=True)
        bound, bound_by = bound_ms(8 * n ** 3, 6 * k * n ** 3)
        print(json.dumps({"kernel": "jacobi_multistep", "size": n, "k": k, "ms": ms,
                          "ms_per_step": ms / k, "bound_ms": bound, "bound_by": bound_by,
                          "issue_ms": issue_ms(7 * sk.multistep_stage_updates(spec, k)),
                          **sk.multistep_info(dev.index, k),
                          "zchunks": sk.multistep_zchunks(
                              spec, k, sk.multistep_blocks_in_flight(dev, k))}), flush=True)
    plan = build_plan(spec, (1, 1, 1), Method.REMOTE_DMA, fused=True)
    ms = cuda_time_ms(lambda: fst.fused_jacobi(curr, nxt, sel, spec, plan), args.reps,
                      graph=True)
    bound, _ = bound_ms(12 * n ** 3, 6 * n ** 3)
    finfo = fst.fused_info(dev.index)
    in_flight = finfo["blocks_per_sm"] * torch.cuda.get_device_properties(dev).multi_processor_count
    print(json.dumps({"kernel": "fused_jacobi", "size": n, "ms": ms, "bound_ms": bound,
                      "timing": "graph", **finfo, "tiles": fst.fused_tiles(spec),
                      "zchunks": fst.fused_zchunks(spec, 1, in_flight)}), flush=True)
    # yardsticks for the fused step's two phases: B4's x fill of the same
    # block (its row-end hand-offs are phase A's x faces), and one
    # elementwise pass over three padded blocks, two read and one written
    # (phase B's three streams)
    ms = cuda_time_ms(lambda: halo_fill.self_fill([curr], spec, "x"), args.reps * 2, graph=True)
    nbytes = halo_fill.fill_bytes(spec, "x", 4)
    print(json.dumps({"kernel": "self_fill", "axis": "x", "size": n, "radius": 1,
                      "quantities": 1, "ms": ms, "bytes": nbytes,
                      "bound_ms": bound_ms(nbytes, 0)[0]}), flush=True)
    other = torch.rand(curr.shape, generator=gen, device=dev)
    ms = cuda_time_ms(lambda: torch.add(curr, other, out=nxt), args.reps, graph=True)
    nbytes = 3 * curr.numel() * curr.element_size()
    print(json.dumps({"yardstick": "torch.add", "size": n, "padded": curr.numel(), "ms": ms,
                      "bytes": nbytes, "tb_per_s": nbytes / ms / 1e9}), flush=True)
    del curr, nxt, sel, other

    for k in (k for k in ks if k >= 2):
        speck = GridSpec(Dim3(n, n, n), Dim3(1, 1, 1), Radius.constant(k))
        pd = speck.padded()
        curr = torch.rand((1, 1, 1, pd.z, pd.y, pd.x), generator=gen, device=dev)
        nxt = torch.zeros_like(curr)
        sel = sphere_sel_blocks(speck, dev)
        ms = cuda_time_ms(lambda: pst.persistent_jacobi(curr, nxt, sel, speck, k),
                          max(2, args.reps // 2), warmup=1)
        print(json.dumps({"kernel": "persistent_jacobi", "size": n, "k": k, "ms": ms,
                          "ms_per_step": ms / k,
                          "bound_ms": bound_ms(pst.chunk_bytes(speck, k), 0)[0],
                          "design_bytes_ms": bound_ms(pst.chunk_design_bytes(speck, k), 0)[0],
                          **chunk_launch_shape(k)}),
              flush=True)
        del curr, nxt, sel

    for label, part, axes in (() if args.b1 else (("one block", (1, 1, 1), halo_fill.AXIS_ORDER),
                                                  ("z-stack", (1, 1, 2), ("x", "y")))):
        rows = bench_fill.measure(f"{n}^3 {label} r3 x4 fp32", bench_fill.case_spec(n, part, 3),
                                  4, torch.float32, axes, gen, dev, args.reps * 2)
        for row in rows:
            print(json.dumps({"size": n, "partition": list(part), "radius": 3, "quantities": 4,
                              **row}), flush=True)

    # the resident forms: eight (n/2)^3 blocks with radius-4 halos (radius k
    # for the deep-halo multistep at k > 4)
    cells = n ** 3
    for k in (k for k in ks if k >= 2):
        specr = GridSpec(Dim3(n, n, n), Dim3(2, 2, 2), Radius.constant(max(4, k)))
        curr = torch.rand(specr.stacked_shape_zyx(), generator=gen, device=dev)
        nxt = torch.zeros_like(curr)
        ms = cuda_time_ms(lambda: sk.multistep(curr, nxt, specr, k), max(2, args.reps // 2),
                          warmup=1, graph=True)
        grown = specr.num_blocks() * (n // 2 + 2 * k) ** 3
        print(json.dumps({"kernel": "jacobi_multistep", "form": "deep-halo", "size": n,
                          "partition": [2, 2, 2], "radius": max(4, k), "k": k, "ms": ms,
                          "ms_per_step": ms / k,
                          "bound_ms": bound_ms(4 * (grown + cells), 6 * k * cells)[0],
                          "issue_ms": issue_ms(7 * sk.multistep_stage_updates(specr, k)),
                          **sk.multistep_info(dev.index, k, multi_block=True),
                          "zchunks": sk.multistep_zchunks(
                              specr, k, sk.multistep_blocks_in_flight(dev, k))}), flush=True)
        del curr, nxt
    specr = GridSpec(Dim3(n, n, n), Dim3(2, 2, 2), Radius.constant(4))
    curr = torch.rand(specr.stacked_shape_zyx(), generator=gen, device=dev)
    nxt = torch.zeros_like(curr)
    sel = sphere_sel_blocks(specr, dev)
    wrap, _axes, shells = multi_block_layout(specr)
    ms = cuda_time_ms(lambda: sk.sweep(curr, nxt, sel, specr, wrap), args.reps, graph=True)
    print(json.dumps({"kernel": "jacobi_sweep", "form": "stacked", "size": n,
                      "partition": [2, 2, 2], "ms": ms,
                      "bound_ms": bound_ms(12 * cells, 6 * cells)[0]}), flush=True)
    shell = shells[0]
    ms = cuda_time_ms(lambda: sk.sweep_region(curr, nxt, sel, specr, shell), args.reps * 2,
                      graph=True)
    shell_cells = shell.num_points() * specr.num_blocks()
    print(json.dumps({"kernel": "jacobi_sweep_region", "size": n, "partition": [2, 2, 2],
                      "rect": repr(shell), "ms": ms,
                      "bound_ms": bound_ms(12 * shell_cells, 6 * shell_cells)[0]}), flush=True)
    del curr, nxt, sel

    # the campaign slot: 64 tenants of (n/4)^3 (as many cells as n^3)
    spect = GridSpec(Dim3(n // 4, n // 4, n // 4), Dim3(1, 1, 1), Radius.constant(1),
                     aligned=False)
    pt = spect.padded()
    curr = torch.rand((64, pt.z, pt.y, pt.x), generator=gen, device=dev)
    nxt = torch.zeros_like(curr)
    sel = torch.randint(0, 3, curr.shape, generator=gen, device=dev, dtype=torch.int32)
    ms = cuda_time_ms(lambda: sk.sweep_tenants(curr, nxt, sel, spect), args.reps, graph=True)
    cells = 64 * spect.base.flatten()
    print(json.dumps({"kernel": "jacobi_sweep", "form": "tenants", "tenants": 64,
                      "size": n // 4, "ms": ms, "bound_ms": bound_ms(12 * cells, 6 * cells)[0]}),
          flush=True)
    del curr, nxt, sel

    # the mesh kernels: eight positions on the card, one block each
    for size, r, nq in (() if args.b1 else ((n, 1, 1), (n // 2, 2, 4))):
        specm = GridSpec(Dim3(size, size, size), Dim3(2, 2, 2), Radius.constant(r))
        mesh = DeviceMesh((2, 2, 2), [dev] * 8)
        pm = specm.padded()
        blocks = [[torch.rand((1, 1, 1, pm.z, pm.y, pm.x), generator=gen, device=dev)
                   for _ in range(nq)] for _ in range(8)]
        row = {"size": size, "partition": [2, 2, 2], "radius": r, "quantities": nq}
        # padded rows whose two ends the x phase moves, over every block
        xrows = 8 * nq * pm.z * pm.y
        for ph in build_plan(specm, (2, 2, 2), Method.REMOTE_DMA).remote_phases:
            ms = cuda_time_ms(lambda: rdma.remote_axis(blocks, specm, ph, mesh), args.reps * 2,
                              graph=True)
            nbytes = rdma.remote_axis_bytes(specm, ph, nq, 8, 4)
            sbytes = rdma.remote_axis_sector_bytes(specm, ph, nq, 8, 4)
            rate = {"rows": xrows, "rows_per_ns": xrows / ms / 1e6} if ph.axis == "x" else {}
            print(json.dumps({"kernel": "remote_axis", **row, "axis": ph.axis, "ms": ms,
                              "bytes": nbytes, "bound_ms": bound_ms(nbytes, 0)[0],
                              "sector_ms": bound_ms(sbytes, 0)[0], **rate}), flush=True)
        fplan = build_plan(specm, (2, 2, 2), Method.REMOTE_DMA, fused=True)
        ms = cuda_time_ms(lambda: fst.fused_exchange(blocks, specm, fplan, mesh), args.reps * 2,
                          graph=True)
        nbytes = fst.fused_exchange_bytes(fplan, nq, 8, 4)
        sbytes = fst.fused_exchange_sector_bytes(fplan, specm, nq, 8, 4)
        print(json.dumps({"kernel": "fused_exchange", **row, "ms": ms, "bytes": nbytes,
                          "bound_ms": bound_ms(nbytes, 0)[0], "sector_ms": bound_ms(sbytes, 0)[0]}),
              flush=True)
        # the rate yardstick: B4's x fill of the same rows (each block's own
        # x halos, the same row ends), at most MAX_FILL_GROUP blocks a launch
        flat = [b for group in blocks for b in group]
        bspec = specm.block_spec()
        ms = cuda_time_ms(lambda: [halo_fill.self_fill(flat[i:i + halo_fill.MAX_FILL_GROUP],
                                                       bspec, "x")
                                   for i in range(0, len(flat), halo_fill.MAX_FILL_GROUP)],
                          args.reps * 2, graph=True)
        print(json.dumps({"yardstick": "self_fill x", **row, "rows": xrows, "ms": ms,
                          "rows_per_ns": xrows / ms / 1e6,
                          "sector_ms": bound_ms(len(flat) * halo_fill.fill_sector_bytes(
                              halo_fill.fill_layout(bspec, "x", 4), 4), 0)[0]}), flush=True)
        del blocks, flat

    # the jacobi step over the mesh: the per-position sweep, the fused step
    # and the persistent chunk, eight (n/2)^3 blocks
    mesh = DeviceMesh((2, 2, 2), [dev] * 8)
    for r in [1] + [k for k in ks if k >= 2]:
        specm = GridSpec(Dim3(n, n, n), Dim3(2, 2, 2), Radius.constant(r))
        pm = specm.padded()
        currs, nxts = ([torch.rand((1, 1, 1, pm.z, pm.y, pm.x), generator=gen, device=dev)
                        for _ in range(8)] for _ in range(2))
        sels = sphere_sel_blocks(specm, mesh)
        row = {"size": n, "partition": [2, 2, 2], "radius": r}
        if r == 1:
            bspec, cells = specm.block_spec(), specm.base.flatten()
            ms = cuda_time_ms(lambda: sk.sweep(currs[0], nxts[0], sels[0], bspec, fst.NO_WRAP),
                              args.reps * 2, graph=True)
            print(json.dumps({"kernel": "jacobi_sweep", "form": "mesh position", "size": n // 2,
                              "ms": ms, "bound_ms": bound_ms(12 * cells, 6 * cells)[0]}),
                  flush=True)
            fplan = build_plan(specm, (2, 2, 2), Method.REMOTE_DMA, fused=True)
            ms = cuda_time_ms(lambda: fst.fused_jacobi_mesh(currs, nxts, sels, specm, fplan, mesh),
                              args.reps)
            nbytes = fst.fused_jacobi_mesh_bytes(fplan, 8, specm)
            print(json.dumps({"kernel": "fused_jacobi_mesh", **row, "ms": ms, "bytes": nbytes,
                              "bound_ms": bound_ms(nbytes, 0)[0], "timing": "events",
                              **finfo, "tiles": fst.fused_tiles(bspec),
                              "zchunks": fst.fused_zchunks(bspec, 8, in_flight)}), flush=True)
        else:
            HaloExchange(specm, Method.REMOTE_DMA, mesh=mesh)(sels)
            ms = cuda_time_ms(lambda: pst.persistent_jacobi_mesh(currs, nxts, sels, specm, r,
                                                                 mesh),
                              max(2, args.reps // 2), warmup=1)
            bspec = specm.block_spec()
            print(json.dumps({"kernel": "persistent_jacobi_mesh", **row, "k": r, "ms": ms,
                              "ms_per_step": ms / r,
                              "bound_ms": bound_ms(8 * pst.chunk_bytes(bspec, r), 0)[0],
                              "design_bytes_ms": bound_ms(8 * pst.chunk_design_bytes(bspec, r),
                                                          0)[0], **chunk_launch_shape(r)}),
                  flush=True)
        del currs, nxts, sels

    if args.b1:
        return 0
    astaroth_rows(args.astaroth_size, gen, dev, args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
